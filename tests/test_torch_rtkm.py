"""Port parity: RTK-interpolated mapping and LiDAR-only odometry.

- ``RtkMapper`` as the reference's own tests drive it
  (``tests/test_rtkm.py``), and against the reference on the same fixes and
  scans: interpolated poses atol 1e-9 (float64 numpy on both sides),
  published and keyframe poses atol 1e-5 (they pass through the float32
  pose-graph solve), the same keyframes, keyframe clouds within 2 points (a
  float32 voxel mean on a voxel's edge).
- The map that the *reference's* ``RtkMapper`` saves, loaded by the port's
  ``Localizer``, which initialises on it from a hint and tracks: within
  0.15 m of the simulator's truth (the other direction, the reference on the
  port's map, is in ``test_torch_localization.py``).
- ``IcpOdometry`` against the reference over 10 scans of the reference
  test's world and size (8,192 points): poses atol 2e-3 m (8 Gauss-Newton steps a
  scan, each scan starting from the last one's rounding; measured ~1e-4),
  ``num_valid`` within 5, and the relative-motion error below that test's
  0.35 m.
"""
import numpy as np
import pytest

from lsd_tpu.slam import icp_odometry as jicp
from lsd_tpu.slam import rtkm as jrtkm
from lsd_tpu.slam.lio import LioConfig as JLioConfig
from lsd_tpu.slam.mapper import MapperConfig as JMapperConfig
from lsd_tpu_torch.geometry import np_so3
from lsd_tpu_torch.geometry.utm import UTMProjector, grid_convergence
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import icp_odometry as ticp
from lsd_tpu_torch.slam import rtkm as trtkm
from lsd_tpu_torch.slam.lio import LioConfig as TLioConfig
from lsd_tpu_torch.slam.localization import Localizer, LocalizerConfig
from lsd_tpu_torch.slam.map_io import load_map
from lsd_tpu_torch.slam.mapper import MapperConfig as TMapperConfig


def _fix(ts_us, lat, lon=-83.0, heading=0.0, alt=100.0):
    return dict(timestamp=ts_us, latitude=lat, longitude=lon, altitude=alt, heading=heading,
                pitch=0.0, roll=0.0, Status=42)


def _scan(rng, n=2048):
    pts = (rng.normal(size=(n, 3)) * [15, 15, 2]).astype(np.float32)
    stamps = rng.uniform(0, 0.1, n).astype(np.float32)
    return pts, stamps, np.ones(n, bool)


def _mappers(**kw):
    jm = jrtkm.RtkMapper(JMapperConfig(lio=JLioConfig(), **kw))
    tm = trtkm.RtkMapper(TMapperConfig(lio=TLioConfig(), **kw), device="cpu")
    return jm, tm


def test_rtkm_interpolates_and_maps_as_the_reference():
    jm, tm = _mappers(keyframe_delta_trans=1.0)
    rng = np.random.default_rng(0)
    P, S, M = _scan(rng)
    out = tm.process_scan(P, S, M, stamp_us=0)
    assert out["status"] == "waiting_rtk" and out["pose"] is None
    # drive north at ~1.1 m per 1e-5 deg, 10 Hz fixes, a slow turn and a climb
    for k in range(30):
        fix = _fix(k * 100_000, 42.0 + k * 2e-5, heading=0.3 * k, alt=100.0 + 0.01 * k)
        jm.feed_ins(fix)
        tm.feed_ins(fix)
    tm.feed_ins(_fix(5, 42.0))                      # out of order: dropped
    tm.feed_ins(dict(timestamp=4_000_000))          # no position: dropped
    assert len(tm.fix_ts) == len(jm.fix_ts) == 30
    np.testing.assert_array_equal(tm.origin_lla, jm.origin_lla)
    poses = []
    for k in range(2, 25):
        P, S, M = _scan(rng)
        jo = jm.process_scan(P, S, M, stamp_us=k * 100_000)
        to = tm.process_scan(P, S, M, stamp_us=k * 100_000)
        assert to["status"] == jo["status"] == "mapping"
        assert to["is_keyframe"] == jo["is_keyframe"]
        np.testing.assert_allclose(to["odom"], jo["odom"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(to["pose"], jo["pose"], rtol=0, atol=1e-5)
        poses.append(to["pose"])
    poses = np.stack(poses)
    d = poses[-1][:3, 3] - poses[0][:3, 3]
    assert d[1] > 40.0 and abs(d[0]) < 0.03 * d[1], d
    assert len(tm.store) == len(jm.store) >= 3 and tm.graph.num_nodes == len(tm.store)
    assert tm.sc_ids == jm.sc_ids == list(range(len(tm.store)))
    for a, b in zip(tm.store.frames, jm.store.frames):
        assert a.stamp_us == b.stamp_us and abs(len(a.cloud) - len(b.cloud)) <= 2
        np.testing.assert_allclose(a.odom, b.odom, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-5)
    # heading ~0 (NED north) -> ENU yaw ~90: body x points +y
    assert abs(poses[0][1, 0] - 1.0) < 0.05
    # outside the buffered fixes: no pose
    assert tm.process_scan(P, S, M, stamp_us=3_000_000)["status"] == "waiting_rtk"
    np.testing.assert_allclose(tm.get_timed_pose(2_450_000), jm.get_timed_pose(2_450_000),
                               atol=1e-5)


def test_rtkm_pose_matches_interpolation_midpoint_and_motion_compensates():
    _, m = _mappers()
    m.feed_ins(_fix(0, 42.0))
    m.feed_ins(_fix(200_000, 42.0 + 4e-5))
    T, T0, T1 = m.interpolate(100_000), m.interpolate(0), m.interpolate(200_000)
    np.testing.assert_allclose(T[:3, 3], 0.5 * (T0[:3, 3] + T1[:3, 3]), atol=1e-6)
    assert m.interpolate(200_001) is None and m.interpolate(-1) is None
    # a point captured at the scan's start lies one scan of travel behind in
    # the scan-end frame: 2.2 m north is -x of the body (which faces north)
    jm, tm = _mappers(keyframe_cloud_voxel=0.01)
    for mm in (jm, tm):
        mm.feed_ins(_fix(0, 42.0))
        mm.feed_ins(_fix(200_000, 42.0 + 4e-5))
    P = np.zeros((64, 3), np.float32)
    P[:, 0] = np.linspace(5, 6, 64)
    S = np.zeros(64, np.float32)
    M = np.ones(64, bool)
    tm.process_scan(P, S, M, stamp_us=0)
    jm.process_scan(P, S, M, stamp_us=0)
    step = np.linalg.norm(tm.interpolate(100_000)[:3, 3] - tm.interpolate(0)[:3, 3])
    cloud = tm.store[0].cloud
    assert len(cloud) == len(jm.store[0].cloud) == 64
    np.testing.assert_allclose(np.sort(cloud[:, 0]), np.sort(P[:, 0]) - step * (1 - 0.5 / 32),
                               atol=1e-3)
    np.testing.assert_allclose(np.sort(cloud[:, 0]), np.sort(jm.store[0].cloud[:, 0]), atol=1e-6)


@pytest.fixture(scope="module")
def ring():
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=60, points_per_scan=4096,
                              point_noise=0.01, seed=21))
    return sim, sim.generate(capacity=4096, imu_capacity=16)


def _fixes_from(sim, n, lat0=42.0, lon0=-83.0):
    """RTK fixes at the simulator's poses, every 0.1 s: positions through the
    port's UTM projection, headings NED degrees against true north (the
    grid convergence added, which the mapper takes off again), so that the
    RTK frame is the simulator's, moved to start at the first fix."""
    proj = UTMProjector()
    proj.project(lat0, lon0)
    R0, p0 = sim.pose(0.0)
    fixes = []
    for k in range(n):
        R, p = sim.pose(k * 0.1)
        lat, lon = proj.unproject(p[0] - p0[0], p[1] - p0[1])
        yaw = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
        conv = grid_convergence(proj.lon0, float(lat), float(lon))
        fixes.append(_fix(int(k * 1e5), float(lat), float(lon), heading=90.0 - yaw + conv,
                          alt=100.0 + p[2] - p0[2]))
    return fixes


def test_the_port_localizes_on_the_map_the_reference_s_rtk_mapper_saved(ring, tmp_path):
    sim, data = ring
    jm = jrtkm.RtkMapper(JMapperConfig(lio=JLioConfig(), keyframe_delta_trans=1.5,
                                       keyframe_cloud_cap=4096))
    for fix in _fixes_from(sim, 62):
        jm.feed_ins(fix)
    R0, p0 = sim.pose(0.0)
    for k, (P, S, M, _, _, _) in enumerate(data):
        out = jm.process_scan(P, S, M, stamp_us=int(k * 1e5))
        assert out["status"] == "mapping"
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = sim.pose((k + 1) * 0.1)[0], sim.pose((k + 1) * 0.1)[1] - p0
        np.testing.assert_allclose(out["odom"], T, atol=2e-3)   # the scan-end pose, interpolated
    jm.save(str(tmp_path / "j"))
    loaded = load_map(str(tmp_path / "j"))
    assert len(loaded["poses"]) == len(jm.store) > 15
    np.testing.assert_allclose(loaded["origin"][:2], [42.0, -83.0], atol=1e-9)
    # a drive from rest in the same world, in the RTK frame (the simulator's,
    # moved to start at the first fix)
    drive = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=12, points_per_scan=4096,
                                point_noise=0.01, seed=21, rest_time=0.3, ramp_time=2.0))
    loc = Localizer(str(tmp_path / "j"), LocalizerConfig(
        ndt_capacity=2 ** 13, track_capacity=2048, use_lio_odometry=False), device="cpu")
    np.testing.assert_allclose(loc.project_fix(42.0, -83.0, 100.0), [0, 0, 0], atol=1e-6)
    R, p = drive.pose(0.037)
    hint = np.eye(4)
    hint[:3, :3], hint[:3, 3] = R, p - p0 + [0.5, -0.4, 0.05]
    loc.set_init_pose(hint)
    errs = []
    for k, (P, _, M, _, _, T_gt) in enumerate(drive.generate(4096, 16, t_start=0.037)):
        t0 = 0.037 + k * 0.1
        smp = drive.imu_sample(t0)
        out = loc.process_scan(P, M, stamp_us=int(t0 * 1e6), imu_gyro=smp[1:4],
                               imu_acc=smp[4:7] * 9.81)
        assert out["status"] == ("initialized" if k == 0 else "tracking")
        # the raw sweep is matched (no stamps given), so the pose lies mid-sweep
        errs.append(min(np.linalg.norm(out["pose"][:3, 3] - (drive.pose(t0 + a)[1] - p0))
                        for a in np.linspace(0, 0.1, 11)))
    assert max(errs) < 0.15, errs


def test_icp_odometry_matches_the_reference():
    sim = CircleSim(SimConfig(radius=10.0, omega=0.15, n_scans=10, points_per_scan=8192, seed=66))
    data = sim.generate(capacity=8192, imu_capacity=16)
    kw = dict(ds_capacity=4096, map_capacity=2 ** 16, scan_voxel=0.4, map_voxel=0.4)
    jo = jicp.IcpOdometry(jicp.IcpOdometryConfig(**kw))
    to = ticp.IcpOdometry(ticp.IcpOdometryConfig(**kw), device="cpu")
    assert vars(ticp.IcpOdometryConfig()) == vars(jicp.IcpOdometryConfig())
    T0 = data[0][5]
    errs = []
    for k, (P, _, M, _, _, T_gt) in enumerate(data):
        a, b = to.process_scan(P, M), jo.process_scan(P, M)
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=2e-3, err_msg=str(k))
        assert abs(a["num_valid"] - b["num_valid"]) <= 5 and isinstance(a["num_valid"], int)
        # one scan in the map leaves its voxels too thin for a plane
        assert (a["num_valid"] > 100) == (k > 1), a["num_valid"]
        errs.append(np.linalg.norm(a["pose"][:3, 3] - (np.linalg.inv(T0) @ T_gt)[:3, 3]))
    assert np.sqrt(np.mean(np.square(errs[2:]))) < 0.35, errs
    np.testing.assert_allclose(to.prev_delta, jo.prev_delta, atol=2e-3)
    # a pose far from the map centre trims the map around it
    to.pose[:3, 3] += [100.0, 0.0, 0.0]
    before = int((to.map.keys >= 0).sum())
    to.cfg.map_radius = 20.0
    to.process_scan(*data[0][0:3:2])
    assert int((to.map.keys >= 0).sum()) < before and to.map_center[0] > 90.0
