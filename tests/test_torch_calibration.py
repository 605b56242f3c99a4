"""Port parity: ``lsd_tpu_torch/calibration`` against ``lsd_tpu/calibration``
on the CPU, on the inputs of ``tests/test_calibration.py``'s twelve cases.

- The numpy-only functions (ground RANSAC, heading, Umeyama, hand-eye,
  PnP, homography, intrinsics, and the service's RPCs): within 1e-9, with
  OpenCV and (PnP, intrinsics) with the numpy fallbacks that run where
  OpenCV is missing, as on the card's machine.
- ``lidar_ground_calibration``, whose rotation goes through each package's
  float32 ``rot_between``: within 1e-5.
- ``register_calibration_interfaces`` registers the reference's names.

The service keeps its lidar-INS and lidar-IMU sessions in module-level
singletons, in both packages: every test here starts them afresh.
"""
import base64

import numpy as np
import pytest

import lsd_tpu.calibration as jcal
import lsd_tpu.runtime.interface as jiface
import lsd_tpu_torch.calibration as tcal
import lsd_tpu_torch.runtime.interface as tiface
from lsd_tpu.calibration import camera as jcam
from lsd_tpu.calibration import service as jsvc
from lsd_tpu_torch.calibration import camera as tcam
from lsd_tpu_torch import sim as tsim
from lsd_tpu_torch.calibration import service as tsvc
from lsd_tpu_torch.geometry import np_so3

ATOL, GROUND_ATOL = 1e-9, 1e-5


@pytest.fixture(autouse=True)
def _fresh_sessions():
    def reset():
        for svc in (jsvc, tsvc):
            for calib in (svc._ins_calib, svc._imu_calib):
                calib.reset([0, 0, 0, 0, 0, 0])
                calib._origin = None
            svc._panorama.update(homographies={}, cameras=[], parameters={}, image=None)
        jiface.clear_interfaces()
        tiface.clear_interfaces()
    reset()
    yield
    reset()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=0, atol=atol)


def _both(name, *args, **kw):
    return getattr(jcal, name)(*args, **kw), getattr(tcal, name)(*args, **kw)


def _rot(w):
    return np_so3.exp_so3(np.asarray(w, float))


def _tilted_ground(seed=0):
    rng = np.random.default_rng(seed)
    R = _rot([0.087, 0.0, 0.0])
    ground = np.stack([rng.uniform(-20, 20, 3000), rng.uniform(-20, 20, 3000),
                       np.full(3000, -1.8)], axis=1) @ R.T
    wall = np.stack([rng.uniform(5, 5.2, 500), rng.uniform(-5, 5, 500),
                     rng.uniform(-1.8, 3, 500)], axis=1)
    return np.concatenate([ground + rng.normal(0, 0.01, ground.shape), wall])


def test_ransac_ground_plane():
    (jn, jd, jinl), (tn, td, tinl) = _both("ransac_ground_plane", _tilted_ground())
    _close(tn, jn)
    _close(td, jd)
    assert np.array_equal(tinl, jinl) and tinl.sum() > 2500


def test_lidar_ground_calibration():
    rng = np.random.default_rng(1)
    R = _rot([0.05, -0.03, 0.0])
    ground = np.stack([rng.uniform(-20, 20, 2000), rng.uniform(-20, 20, 2000),
                       np.full(2000, -1.5)], axis=1) @ R.T
    (jT, jinfo), (tT, tinfo) = _both("lidar_ground_calibration", ground)
    assert tT.dtype == np.float64 and tT.shape == (4, 4)
    _close(tT, jT, GROUND_ATOL)
    for k in ("height", "inlier_frac", "roll", "pitch"):
        _close(tinfo[k], jinfo[k], GROUND_ATOL)
    lev = ground @ tT[:3, :3].T + tT[:3, 3]
    assert np.std(lev[:, 2]) < 0.01


def test_heading_calibration():
    traj = np.stack([np.linspace(0, 10, 50), np.linspace(0, 10, 50)], axis=1)
    j, t = _both("heading_calibration", traj)
    assert t == j
    np.testing.assert_allclose(t, np.pi / 4, atol=1e-6)


def test_align_trajectories():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(100, 3)) * 5
    dst = src @ _rot([0.2, -0.1, 0.7]).T + [3.0, -2.0, 0.5] + rng.normal(0, 0.01, src.shape)
    for with_scale in (False, True):
        (jT, js), (tT, ts) = _both("align_trajectories", src, dst, with_scale=with_scale)
        _close(tT, jT)
        _close(ts, js)


def test_hand_eye_calibration():
    rng = np.random.default_rng(3)
    X = np.eye(4)
    X[:3, :3] = _rot([0.0, 0.0, 0.5])
    X[:3, 3] = (0.8, 0.1, -0.3)
    poses_a = [np.eye(4)]
    for _ in range(30):
        d = np.eye(4)
        d[:3, :3] = _rot(rng.normal(0, 0.2, 3))
        d[:3, 3] = rng.normal(0, 0.5, 3)
        poses_a.append(poses_a[-1] @ d)
    poses_b = [np.linalg.inv(X) @ T @ X for T in poses_a]
    j, t = _both("hand_eye_calibration", poses_a, poses_b)
    _close(t, j)
    _close(t, X, 1e-6)
    with pytest.raises(ValueError):
        tcal.hand_eye_calibration(poses_a[:1], poses_b[:1])


@pytest.fixture(params=["cv2", "numpy"])
def opencv(request, monkeypatch):
    """OpenCV's solvers, or the numpy fallbacks of a machine without it."""
    if request.param == "numpy":
        monkeypatch.setattr(jcam, "HAS_CV2", False)
        monkeypatch.setattr(tcam, "HAS_CV2", False)
    return request.param


def _project(K, T, pts3):
    p = (K @ (T[:3, :3] @ pts3.T + T[:3, 3:4])).T
    return p[:, :2] / p[:, 2:3]


def test_solve_pnp(opencv):
    rng = np.random.default_rng(4)
    K = np.asarray([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = _rot([0.1, -0.2, 0.05])
    T[:3, 3] = (0.2, -0.1, 0.3)
    pts3 = rng.uniform(-3, 3, (40, 3)) + np.asarray([0, 0, 8.0])
    (jT, jrms), (tT, trms) = _both("solve_pnp", pts3, _project(K, T, pts3), K)
    _close(tT, jT)
    _close(trms, jrms)
    _close(tT, T, 1e-2)


def test_homography_dlt():
    rng = np.random.default_rng(5)
    H_gt = np.asarray([[1.1, 0.05, 20], [-0.03, 0.95, -8], [1e-4, -5e-5, 1.0]])
    src = rng.uniform(0, 640, (30, 2))
    hom = np.concatenate([src, np.ones((30, 1))], axis=1) @ H_gt.T
    j, t = _both("homography_dlt", src, hom[:, :2] / hom[:, 2:3])
    _close(t, j)
    _close(t, H_gt / H_gt[2, 2], 1e-4)


def test_calibrate_camera_intrinsics(opencv):
    K = np.asarray([[500.0, 0, 320], [0, 480, 240], [0, 0, 1]])
    board = np.stack(np.meshgrid(np.arange(7), np.arange(5), indexing="ij"),
                     axis=-1).reshape(-1, 2) * 0.05
    obj = np.concatenate([board, np.zeros((35, 1))], axis=1)
    objs, imgs = [], []
    for k in range(6):
        T = np.eye(4)
        T[:3, :3] = _rot([0.3 * np.sin(k), 0.3 * np.cos(k), 0.1 * k])
        T[:3, 3] = (0.05 * k, -0.03 * k, 1.0 + 0.1 * k)
        imgs.append(_project(K, T, obj))
        objs.append(obj)
    (jK, jd, jrms), (tK, td, trms) = _both("calibrate_camera_intrinsics", objs, imgs, (640, 480))
    _close(tK, jK)
    _close(td, jd)
    _close(trms, jrms)
    np.testing.assert_allclose(tK[0, 0], K[0, 0], rtol=0.05)


def test_trajectory_calib_keyframe_gating():
    def feed(c):
        T2 = np.eye(4)
        T2[0, 3] = 3.0
        T3 = T2.copy()
        th = np.deg2rad(20)
        T3[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        return [c.maybe_feed(T, T) for T in (np.eye(4), np.eye(4), T2, T3)]
    assert feed(tsvc._TrajectoryCalib()) == feed(jsvc._TrajectoryCalib()) == [1, 1, 2, 3]


def test_fix_to_pose():
    fixes = [dict(latitude=42.0, longitude=-83.0, altitude=10.0, heading=90.0),
             dict(latitude=42.0 + 1e-4, longitude=-83.0, altitude=12.0, heading=0.0,
                  roll=1.5, pitch=-2.0),
             {}]
    jc, tc = jsvc._TrajectoryCalib(), tsvc._TrajectoryCalib()
    for f in fixes:
        j, t = jsvc._fix_to_pose(jc, f), tsvc._fix_to_pose(tc, f)
        if j is None:
            assert t is None
        else:
            _close(t, j)


def test_lidar_deltas_and_heading():
    th = np.deg2rad(10)
    src = [[1, 0], [0, 1], [5, 5]]
    tgt = [(np.cos(th) * x - np.sin(th) * y, np.sin(th) * x + np.cos(th) * y) for x, y in src]
    for cfg in ({}, {"lidar": [{"extrinsic_parameters": [0.1, 0, 1.5, 1, 2, 3]}]}):
        for name, args in (("finetune_lidar", (0, np.eye(4).flatten().tolist())),
                           ("calibrate_heading", (src, tgt, 0))):
            jd, jcfg = getattr(jsvc, name)(
                {k: [dict(e) for e in v] for k, v in cfg.items()}, *args)
            td, tcfg = getattr(tsvc, name)(
                {k: [dict(e) for e in v] for k, v in cfg.items()}, *args)
            _close(td, jd)
            assert tcfg.keys() == jcfg.keys()
            for a, b in zip(tcfg.get("lidar", []), jcfg.get("lidar", [])):
                _close(a["extrinsic_parameters"], b["extrinsic_parameters"])


def test_positions_getters_and_ins_calibration():
    rng = np.random.default_rng(7)
    X = np.eye(4)
    X[:3, :3] = _rot([0.0, 0.0, 0.2])
    X[:3, 3] = (1.0, -0.5, 0.2)
    for k in range(12):
        T = np.eye(4)
        T[:3, :3] = _rot([0.0, 0.0, 0.3 * k])
        T[:3, 3] = rng.normal(0, 10, 3)
        for svc in (jsvc, tsvc):
            svc.feed_ins_calibration(T, X @ T)
            svc.feed_imu_calibration(T, T @ X)
    assert tsvc.lidar_ins_get_positions() == jsvc.lidar_ins_get_positions()
    assert tsvc.lidar_imu_get_positions() == jsvc.lidar_imu_get_positions()
    assert tsvc.get_position_points() == jsvc.get_position_points()
    for name in ("calibrate_lidar_ins", "calibrate_lidar_imu"):
        assert getattr(tsvc, name)() == getattr(jsvc, name)() == {"result": True}
    _close(tsvc.get_lidar_ins_transform(), jsvc.get_lidar_ins_transform())
    _close(tsvc.lidar_imu_get_imu_poses(), jsvc.lidar_imu_get_imu_poses())
    jcfg, tcfg = ({"ins": {"extrinsic_parameters": [0] * 6}} for _ in range(2))
    _close(tsvc.set_lidar_imu_extrinsics(tcfg)["ins"]["imu_extrinsic_parameters"],
           jsvc.set_lidar_imu_extrinsics(jcfg)["ins"]["imu_extrinsic_parameters"])


def test_transforms_and_projections():
    vec = [1.0, -2.0, 0.5, 3.0, -4.0, 30.0]
    _close(tsvc.get_transform(vec), jsvc.get_transform(vec))
    T = jsvc.get_transform(vec)
    _close(tsvc.get_vector_from_transform(T), jsvc.get_vector_from_transform(T))
    _close(tsvc.get_vector_from_transform(T), vec, 1e-9)
    args = (42.2936, -83.7093, 42.2940, -83.7080)
    _close(tsvc.get_projection_forward(*args), jsvc.get_projection_forward(*args))
    args = (42.2936, -83.7093, 120.0, -45.0)
    _close(tsvc.get_projection_backward(*args), jsvc.get_projection_backward(*args))
    rng = np.random.default_rng(9)
    kp0 = rng.uniform(0, 640, (12, 2))
    kp1 = kp0 * 1.05 + 10.0
    _close(tsvc.get_homography(["a", "b"], "a", "b", None, None, kp0, kp1, 0),
           jsvc.get_homography(["a", "b"], "a", "b", None, None, kp0, kp1, 0))
    assert tsvc.get_panorama() == jsvc.get_panorama() == b""


def test_register_calibration_interfaces_names():
    jsvc.register_calibration_interfaces()
    tsvc.register_calibration_interfaces()
    jnames = {n for n in jiface._registry if n.startswith("calibration.")}
    tnames = {n for n in tiface._registry if n.startswith("calibration.")}
    assert tnames == jnames and len(tnames) == 31
    assert set(tsvc._REGISTRY) == set(jsvc._REGISTRY)


def tilted_corridor_scan(roll_deg, pitch_deg, height_m, points=8192):
    """A ``CorridorSim`` sweep (lidar 1.5 m above the floor) seen by a
    lidar mounted ``height_m`` above the floor with the config rotation of
    ``roll_deg`` and ``pitch_deg``: (N, 4) float32 x y z i."""
    sim = tsim.CorridorSim(tsim.SimConfig(n_scans=1, points_per_scan=points, point_noise=0.01,
                                          seed=6))
    pts, _ = sim.scan(0.0)
    R = tsvc.cfg_to_transform(0, 0, 0, roll_deg, pitch_deg, 0)[:3, :3]
    body = pts.astype(float) + [0.0, 0.0, 1.5 - height_m]
    return np.concatenate([body @ R, np.zeros((len(pts), 1))], axis=1).astype(np.float32)


def test_calibrate_ground_through_the_registry():
    """The leveling RPC on a tilted corridor sweep, cropped to the floor
    between the walls: the same transform as the reference's, and the mount
    recovered (roll and pitch within 0.2 deg, height within 0.02 m)."""
    roll, pitch, height = 2.5, -1.8, 1.9
    payload = base64.b64encode(tilted_corridor_scan(roll, pitch, height).tobytes()).decode()
    contour = [[-15.0, -2.2], [15.0, -2.2], [15.0, 2.2], [-15.0, 2.2]]
    out = {}
    for key, svc, iface in (("jax", jsvc, jiface), ("port", tsvc, tiface)):
        svc.register_calibration_interfaces()
        cfg = {"lidar": [{"extrinsic_parameters": [0, 0, 0, 0, 0, 0]}]}
        dT, cfg = iface.call_interface("calibration.calibrate_ground", cfg, payload, contour, 0)
        out[key] = dT, cfg["lidar"][0]["extrinsic_parameters"]
    _close(out["port"][0], out["jax"][0])
    _close(out["port"][1], out["jax"][1])
    _, _, z, r, p, _ = out["port"][1]
    assert abs(r - roll) < 0.2 and abs(p - pitch) < 0.2 and abs(z - height) < 0.02, out["port"]
