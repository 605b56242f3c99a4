"""Port parity: point-to-plane ICP of lsd_tpu_torch against lsd_tpu on the
CPU, for both target kinds (surfel map, raw-point voxel hash map), and the
numpy-only helper modules the mapper needs, each copy against its original.

A room (ground and four walls, within 8 m of the origin so that the
5-point plane fits stay well conditioned, see tests/test_torch_hashmap.py)
is the target; the source is a 2,048-point scan of it at a known pose,
started from a pose 0.2 m and 3 degrees off.  Tolerances:
- ``(q, t)`` atol 1e-4 (20 searches and Gauss-Newton steps in float32);
- ``n_inliers`` within 1 (a residual on the gate's edge falls either way);
- ``JtJ`` rtol 1e-3 of its largest entry, ``mean_residual`` atol 1e-4 m
  (the raw-point target's plane fits differ by that much in float32);
- ``align_clouds``: the 4x4 atol 1e-3 (two passes of ICP);
- the numpy copies: equal, or atol 1e-12 where float sums are involved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.calibration import lidar as jcal
from lsd_tpu.geometry import np_so3 as jnp_so3
from lsd_tpu.io import pcd as jpcd
from lsd_tpu.ops import hashmap as jhash
from lsd_tpu.ops import surfel as jsurf
from lsd_tpu.slam import keyframe as jkf
from lsd_tpu.slam import map_io as jmio
from lsd_tpu.slam import registration as jreg
from lsd_tpu_torch import convert
from lsd_tpu_torch.calibration import lidar as tcal
from lsd_tpu_torch.geometry import np_so3 as tnp_so3
from lsd_tpu_torch.io import pcd as tpcd
from lsd_tpu_torch.ops import hashmap as thash
from lsd_tpu_torch.ops import surfel as tsurf
from lsd_tpu_torch.slam import keyframe as tkf
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.slam import registration as treg


def _room(rng, n):
    k = n // 5
    g = np.stack([rng.uniform(-8, 8, n - 4 * k), rng.uniform(-8, 8, n - 4 * k),
                  np.zeros(n - 4 * k)], 1)
    walls = []
    for axis, at in ((0, -8.0), (0, 8.0), (1, -8.0), (1, 7.0)):
        w = np.stack([rng.uniform(-8, 8, k), rng.uniform(-8, 8, k), rng.uniform(0, 3, k)], 1)
        w[:, axis] = at
        walls.append(w)
    return np.concatenate([g] + walls)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    target = (_room(rng, 16384) + rng.normal(0, 0.005, (16384, 3))).astype(np.float32)
    T_true = np.eye(4)
    T_true[:3, :3] = tnp_so3.rpy_to_matrix(0.01, -0.02, 0.3)
    T_true[:3, 3] = [1.0, -0.5, 0.2]
    world = _room(rng, 2048) + rng.normal(0, 0.005, (2048, 3))
    source = ((world - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    smask = np.arange(2048) < 2000
    T0 = T_true.copy()
    T0[:3, :3] = T_true[:3, :3] @ tnp_so3.exp_so3([0.01, -0.02, 0.05])
    T0[:3, 3] += [0.15, -0.1, 0.05]
    q0 = tnp_so3.matrix_to_quat(T0[:3, :3]).astype(np.float32)
    t0 = T0[:3, 3].astype(np.float32)
    return target, source, smask, q0, t0, T_true


def _targets(kind, target):
    tmask = np.ones(len(target), bool)
    if kind == "surfel":
        jm = jsurf.surfel_insert(jsurf.surfel_create(2 ** 14, 0.5), jnp.asarray(target),
                                 jnp.asarray(tmask))
    else:
        jm = jhash.hashmap_insert(jhash.hashmap_create(2 ** 14, 8, 0.5), jnp.asarray(target),
                                  jnp.asarray(tmask))
    # the same map in the port, carried across as a LIO state's map is
    tm = convert.lio_state_from_numpy(dict(
        nav={f: np.zeros(4 if f in ("quat", "ext_q") else 3, np.float32)
             for f in ("pos", "quat", "vel", "bg", "ba", "grav", "ext_q", "ext_t")},
        P=np.eye(24, dtype=np.float32), map=jax.device_get(jm), map_center=np.zeros(3),
        initialized=True, step_count=0), "cpu").map
    return jm, tm


@pytest.mark.parametrize("kind,kw", [
    ("surfel", dict(iters=20, plane_thresh=0.1, max_dist=0.5, min_points=4)),
    ("surfel", dict(iters=10, searches=2)),
    ("points", dict(iters=20, plane_thresh=0.1, max_dist=0.5, neighborhood=7)),
    ("points", dict(iters=6, searches=3, neighborhood=19)),
])
def test_icp_matches_reference(scene, kind, kw):
    target, source, smask, q0, t0, T_true = scene
    jm, tm = _targets(kind, target)
    jq, jt, jinfo = jreg.icp_point_to_plane(jm, jnp.asarray(source), jnp.asarray(smask),
                                            jnp.asarray(q0), jnp.asarray(t0), **kw)
    tq, tt, tinfo = treg.icp_point_to_plane(tm, torch.as_tensor(source), torch.as_tensor(smask),
                                            torch.as_tensor(q0), torch.as_tensor(t0), **kw)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert abs(float(tinfo["n_inliers"]) - float(jinfo["n_inliers"])) <= 1
    assert set(tinfo) == set(jinfo)
    for k in ("fitness", "inlier_ratio", "overlap"):
        assert float(tinfo[k]) == pytest.approx(float(jinfo[k]), abs=1e-3), k
    assert float(tinfo["mean_residual"]) == pytest.approx(float(jinfo["mean_residual"]), abs=1e-4)
    JtJ = np.asarray(jinfo["JtJ"])
    np.testing.assert_allclose(tinfo["JtJ"].numpy(), JtJ, atol=1e-3 * np.abs(JtJ).max())
    # and the alignment is right: it ends near the true pose
    if kw["iters"] >= 10:
        assert np.linalg.norm(tt.numpy() - T_true[:3, 3]) < 0.02
        assert float(tinfo["inlier_ratio"]) > 0.9 and float(tinfo["n_inliers"]) > 1000


def test_align_clouds_matches_reference(scene):
    target, source, smask, q0, t0, T_true = scene
    T0 = np.eye(4)
    T0[:3, :3] = tnp_so3.quat_to_matrix(q0)
    T0[:3, 3] = t0
    jT = jreg.align_clouds(source[smask], target, T0, voxel_size=0.5, iters=8)
    tT = treg.align_clouds(source[smask], target, T0, voxel_size=0.5, iters=8,
                           device="cpu")
    np.testing.assert_allclose(tT, jT, atol=1e-3)
    assert np.linalg.norm(tT[:3, 3] - T_true[:3, 3]) < 0.05


# ---- the numpy-only copies against their originals -----------------------


def test_np_so3_copy_matches():
    rng = np.random.default_rng(1)
    for _ in range(20):
        w = rng.normal(0, 1.5, 3)
        R = jnp_so3.exp_so3(w)
        np.testing.assert_array_equal(tnp_so3.exp_so3(w), R)
        np.testing.assert_array_equal(tnp_so3.hat(w), jnp_so3.hat(w))
        np.testing.assert_array_equal(tnp_so3.matrix_to_quat(R), jnp_so3.matrix_to_quat(R))
        q = rng.normal(size=4)
        np.testing.assert_array_equal(tnp_so3.quat_to_matrix(q), jnp_so3.quat_to_matrix(q))
        np.testing.assert_array_equal(tnp_so3.matrix_to_rpy(R), jnp_so3.matrix_to_rpy(R))
        np.testing.assert_array_equal(tnp_so3.rpy_to_matrix(*w), jnp_so3.rpy_to_matrix(*w))
        T0, T1 = np.eye(4), np.eye(4)
        T0[:3, :3], T1[:3, :3], T1[:3, 3] = R, jnp_so3.exp_so3(w + 0.3), w
        np.testing.assert_array_equal(tnp_so3.pose_interp(T0, T1, 0.3),
                                      jnp_so3.pose_interp(T0, T1, 0.3))
    np.testing.assert_array_equal(tnp_so3.exp_so3(np.zeros(3)), np.eye(3))
    # every pivot of matrix_to_quat
    for rpy in ((3.1, 0, 0), (0, 3.1, 0), (0, 0, 3.1), (0.1, 0.2, 0.3)):
        R = jnp_so3.rpy_to_matrix(*rpy)
        np.testing.assert_array_equal(tnp_so3.matrix_to_quat(R), jnp_so3.matrix_to_quat(R))


def test_keyframe_copy_matches():
    rng = np.random.default_rng(2)
    ju, tu = jkf.KeyframeUpdater(1.0, 0.2), tkf.KeyframeUpdater(1.0, 0.2)
    js, ts = jkf.KeyframeStore(), tkf.KeyframeStore()
    T = np.eye(4)
    decisions = []
    for k in range(40):
        step = np.eye(4)
        step[:3, :3] = tnp_so3.exp_so3(rng.normal(0, 0.06, 3))
        step[:3, 3] = rng.normal(0.3, 0.2, 3)
        T = T @ step
        a, b = ju.is_update(T), tu.is_update(T)
        assert a == b
        decisions.append(a)
        if a:
            cloud = rng.normal(size=(300, 4)).astype(np.float32)
            for store, mod, upd in ((js, jkf, ju), (ts, tkf, tu)):
                store.add(mod.Keyframe(id=-1, stamp_us=k, pose=T.copy(), odom=T.copy(),
                                       cloud=cloud, accum_distance=upd.accum_distance))
    assert 5 < sum(decisions) < 40 and ju.accum_distance == tu.accum_distance
    assert len(ts) == len(js) and ts[3].id == 3
    np.testing.assert_array_equal(ts.positions(), js.positions())
    assert ts.within_radius([1.0, 1.0, 0], 3.0) == js.within_radius([1.0, 1.0, 0], 3.0)
    ids = list(range(2, 8))
    np.testing.assert_array_equal(ts.merged_cloud(ids), js.merged_cloud(ids))
    np.testing.assert_array_equal(ts.merged_cloud(ids, max_points=500),
                                  js.merged_cloud(ids, max_points=500))
    np.testing.assert_array_equal(ts.merged_cloud_relative(ids, 4, max_points=700),
                                  js.merged_cloud_relative(ids, 4, max_points=700))
    assert ts.merged_cloud([]).shape == (0, 3) and ts.merged_cloud_relative([], 0).shape == (0, 3)
    ts.update_poses({1: np.eye(4), 99: np.eye(4)})
    js.update_poses({1: np.eye(4), 99: np.eye(4)})
    np.testing.assert_array_equal(ts.positions(), js.positions())
    assert tkf.KeyframeStore().positions().shape == (0, 3)
    assert tkf.KeyframeStore().within_radius([0, 0, 0], 1.0) == []


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_copy_reads_what_the_original_writes_and_back(tmp_path, binary):
    pts = np.random.default_rng(3).normal(size=(50, 4)).astype(np.float32)
    a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    jpcd.write_pcd(a, pts, binary=binary)
    tpcd.write_pcd(b, pts, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    for reader in (jpcd, tpcd):
        got, names = reader.read_pcd_fields(b)
        assert names == ["x", "y", "z", "intensity"]
        np.testing.assert_allclose(got, pts, atol=0 if binary else 1e-6)
    np.testing.assert_array_equal(tpcd.read_pcd(a), jpcd.read_pcd(a))


def test_map_io_copy_writes_the_same_map_and_loads_the_others(tmp_path):
    rng = np.random.default_rng(4)
    stamps = [1000000, 2500000, 4000000]
    poses = []
    for k in range(3):
        T = np.eye(4)
        T[:3, :3] = tnp_so3.exp_so3(rng.normal(0, 0.5, 3))
        T[:3, 3] = rng.normal(0, 5, 3)
        poses.append(T)
    clouds = [np.abs(rng.normal(size=(40 + k, 4))).astype(np.float32) % 1.0 for k in range(3)]
    edges = [(0, 1, np.linalg.inv(poses[0]) @ poses[1], np.full(6, 100.0)),
             (1, 2, np.linalg.inv(poses[1]) @ poses[2], np.arange(1.0, 7.0))]
    images = [{"cam0": b"\xff\xd8jpeg"}, {}, {}]
    args = (np.asarray([42.0, -83.0, 200.0]), stamps, poses, clouds, edges)
    kw = dict(fixed=[0], images=images, meta={"area": [], "origin_anchor_xyz": [1.0, 2.0, 3.0]})
    jdir = jmio.save_map(str(tmp_path / "j"), *args, **kw)
    tdir = tmio.save_map(str(tmp_path / "t"), *args, **kw)
    import filecmp
    cmp = filecmp.dircmp(jdir, tdir)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in cmp.subdirs.values():
        assert not sub.left_only and not sub.right_only and not sub.diff_files
    # each package loads the other's map
    a, b = jmio.load_map(str(tmp_path / "t")), tmio.load_map(str(tmp_path / "j"))
    assert a["ids"] == b["ids"] == [0, 1, 2] and a["fixed"] == b["fixed"] == [0]
    assert a["stamps"] == b["stamps"] == stamps and a["meta"] == b["meta"] == kw["meta"]
    assert a["images"] == b["images"] == images
    np.testing.assert_array_equal(a["origin"], b["origin"])
    for k in range(3):
        np.testing.assert_array_equal(a["poses"][k], b["poses"][k])
        np.testing.assert_allclose(b["poses"][k], poses[k], atol=1e-6)
        np.testing.assert_array_equal(a["clouds"][k], b["clouds"][k])
        np.testing.assert_allclose(b["clouds"][k], clouds[k], atol=1e-5)
    for ea, eb, e in zip(a["edges"], b["edges"], edges):
        assert ea[:2] == eb[:2] == e[:2]
        np.testing.assert_array_equal(ea[2], eb[2])
        np.testing.assert_allclose(eb[3], e[3], rtol=1e-6)
    # a map directory without the graph/ level loads too
    assert tmio.load_map(tdir)["ids"] == [0, 1, 2]


def test_ransac_ground_plane_copy_matches():
    rng = np.random.default_rng(5)
    ground = np.stack([rng.uniform(-10, 10, 400), rng.uniform(-10, 10, 400),
                       -1.8 + 0.02 * rng.normal(size=400)], 1)
    clutter = rng.uniform(-10, 10, (100, 3))
    pts = np.concatenate([ground, clutter]).astype(np.float32)
    jn, jd, jinl = jcal.ransac_ground_plane(pts, iters=50)
    tn, td, tinl = tcal.ransac_ground_plane(pts, iters=50)
    np.testing.assert_array_equal(tn, jn)
    assert td == jd and abs(td - 1.8) < 0.05 and tn[2] > 0.99
    np.testing.assert_array_equal(tinl, jinl)
