"""Port parity for the map tools beside the editor: ``slam/map_render.py``
(``colorize_cloud``), ``slam/mesh.py`` (``knn_mean_colors``,
``texture_mesh``) and ``slam/map_merge.py`` (``find_cross_edges``,
``merge_maps``).

- ``colorize_cloud``: equal (numpy in both); ``colorize_map`` (``cv2``'s
  JPEG decode in both) within one colour level; ``export_colmap``: the same
  files, byte for byte.  ``knn_mean_colors``: within
  1e-5 of the reference's largest colour, and ``texture_mesh`` (through the
  ``slam.texture_mesh`` interface) the same PLY bytes.
- ``merge_maps`` on ``tests/test_map_merge.py``'s two sessions (mapped once,
  by the port): the same cross edges, their transforms and the merged poses
  within 2e-3 (the ``Mapper`` parity bar), their information within 1 %;
  the GNSS-anchored merge gates the same aliased edge out and gives the
  same placement.
"""
import numpy as np
import pytest
import torch

import lsd_tpu_torch.runtime as trt
from lsd_tpu.slam import map_io as jmio
from lsd_tpu.slam import map_merge as jmerge
from lsd_tpu.slam import map_render as jrender
from lsd_tpu.slam import mesh as jmesh
from lsd_tpu_torch.io.pcd import write_pcd
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.slam import map_merge as tmerge
from lsd_tpu_torch.slam import map_render as trender
from lsd_tpu_torch.slam import mesh as tmesh
from lsd_tpu_torch.slam.lio import LioConfig, lio_init
from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
from lsd_tpu_torch.tools.profile_lio import nav_at_start

POSE_ATOL = 2e-3
K = np.asarray([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])


def test_colorize_cloud():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(500, 4)) * [5, 5, 5, 1] + [0, 0, 6, 0]
    img = rng.integers(0, 256, (240, 320, 3), np.uint8)
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    a, b = jrender.colorize_cloud(pts, img, K, T), trender.colorize_cloud(pts, img, K, T)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and b[1].sum() > 100


def _jpeg_keyframes():
    import cv2
    from lsd_tpu_torch.slam.keyframe import Keyframe
    rng = np.random.default_rng(9)
    kfs = []
    for k in range(4):
        pose = np.eye(4)
        c, sn = np.cos(0.2 * k), np.sin(0.2 * k)
        pose[:2, :2] = [[c, -sn], [sn, c]]
        pose[:2, 3] = [2.0 * k, 0.5 * k]
        cloud = (rng.normal(size=(400, 4)) * [4, 4, 2, 1] + [0, 0, 8, 0]).astype(np.float32)
        ok, jpg = cv2.imencode(".jpg", rng.integers(0, 256, (240, 320, 3), np.uint8))
        images = {"front": jpg.tobytes()} if k != 2 else {}      # one keyframe without
        kfs.append(Keyframe(id=k, stamp_us=1_000_000 + k, pose=pose, odom=pose, cloud=cloud,
                            images=images))
    return kfs


def test_colorize_map():
    kfs, T = _jpeg_keyframes(), np.eye(4)
    a = jrender.colorize_map(kfs, K, T, max_points=300)
    b = trender.colorize_map(kfs, K, T, max_points=300)
    assert a.shape == b.shape == (300, 6) and b.dtype == np.float32
    np.testing.assert_array_equal(b[:, :3], a[:, :3])
    assert np.abs(b[:, 3:] - a[:, 3:]).max() <= 1 / 255
    assert trender.colorize_map(kfs[2:3], K, T).shape == (0, 6)


def test_export_colmap(tmp_path):
    kfs, T = _jpeg_keyframes(), np.eye(4)
    T[:3, 3] = [0.1, 0.0, -0.2]
    pts = np.random.default_rng(10).random((50, 6))
    for mod, out in ((jrender, tmp_path / "jax"), (trender, tmp_path / "port")):
        mod.export_colmap(str(out), kfs, K, T, (320, 240), map_points=pts)
    names = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert names == ["cameras.txt", "images.txt", "images/000000.jpg", "images/000001.jpg",
                     "images/000003.jpg", "points3D.txt"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("n_cloud,n_query,k,q_chunk,c_chunk",
                         [(700, 37, 3, 16, 128), (3000, 513, 3, 1024, 65536), (50, 9, 5, 8, 128)])
def test_knn_mean_colors(n_cloud, n_query, k, q_chunk, c_chunk):
    rng = np.random.default_rng(n_cloud)
    cloud = rng.normal(size=(n_cloud, 3)).astype(np.float32) * 4
    rgb = rng.uniform(0, 255, (n_cloud, 3)).astype(np.float32)
    q = rng.normal(size=(n_query, 3)).astype(np.float32) * 4
    want = jmesh.knn_mean_colors(cloud, rgb, q, k=k, q_chunk=q_chunk, c_chunk=c_chunk)
    got = tmesh.knn_mean_colors(cloud, rgb, q, k=k, q_chunk=q_chunk, c_chunk=c_chunk,
                                device="cpu")
    assert got.shape == want.shape == (n_query, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_texture_mesh(tmp_path):
    rng = np.random.default_rng(3)
    cloud = np.concatenate([rng.normal(0, 2, (800, 3)), rng.uniform(0, 1, (800, 3))], axis=1)
    pcd = tmp_path / "map.pcd"
    write_pcd(str(pcd), cloud.astype(np.float32), fields=("x", "y", "z", "r", "g", "b"))
    obj = tmp_path / "mesh.obj"
    verts = rng.normal(0, 2, (30, 3))
    obj.write_text("".join("v %f %f %f\n" % tuple(v) for v in verts)
                   + "".join("f %d %d %d\n" % (i + 1, i + 2, i + 3) for i in range(0, 27, 3)))
    a = jmesh.texture_mesh(str(obj), str(pcd), str(tmp_path / "j"))
    trt.clear_interfaces()
    from lsd_tpu_torch.runtime.modules import register_static_slam_tools
    register_static_slam_tools(torch.device("cpu"))
    b = trt.call_interface("slam.texture_mesh", str(obj), str(pcd), str(tmp_path / "t"))
    trt.clear_interfaces()
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """``tests/test_map_merge.py``'s two sessions of one world, the second
    starting 2 s later, mapped by the port."""
    root = tmp_path_factory.mktemp("sessions")
    out = []
    for name, t_offset in (("a", 0.0), ("b", 2.0)):
        sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=45, points_per_scan=8192,
                                  seed=33))
        data = sim.generate(capacity=8192, imu_capacity=16, t_start=t_offset)
        m = Mapper(MapperConfig(lio=LioConfig(ds_capacity=4096, map_capacity=2 ** 16,
                                              scan_voxel=0.4, map_voxel=0.4),
                                keyframe_delta_trans=1.5, optimize_every=100),
                   nav_at_start(sim, "cpu") if t_offset == 0.0 else None, device="cpu")
        if t_offset:
            from lsd_tpu_torch.geometry import so3
            from lsd_tpu_torch.slam.state import init_state
            R, p = sim.pose(t_offset)
            f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
            m.lio_state = lio_init(m.cfg.lio, init_state(device="cpu")._replace(
                pos=f(p), quat=so3.matrix_to_quat(f(R)), vel=f(sim.velocity(t_offset))))
        for k, (P, S, M, I, IM, _) in enumerate(data):
            m.process_scan(P, S, M, I, IM, stamp_us=int((t_offset + k * 0.1) * 1e6))
        m.save(str(root / name))
        out.append(str(root / name))
    return out


def test_merge_maps(sessions, tmp_path):
    da, db = sessions
    a = jmerge.merge_maps(da, db, out_dir=str(tmp_path / "j"))
    b = tmerge.merge_maps(da, db, out_dir=str(tmp_path / "t"), device="cpu")
    assert [e[:2] for e in b["cross_edges"]] == [e[:2] for e in a["cross_edges"]]
    assert len(b["cross_edges"]) >= 2 and (a["n_a"], a["n_b"]) == (b["n_a"], b["n_b"])
    for ea, eb in zip(a["cross_edges"], b["cross_edges"]):
        np.testing.assert_allclose(eb[2], ea[2], atol=POSE_ATOL)
        np.testing.assert_allclose(eb[3], ea[3], rtol=1e-2)
    pa = np.stack([kf.pose for kf in a["store"].frames])
    pb = np.stack([kf.pose for kf in b["store"].frames])
    np.testing.assert_allclose(pb, pa, atol=POSE_ATOL)
    r = np.linalg.norm(pb[:, :2, 3], axis=1)
    assert np.all(np.abs(r - 8.0) < 1.0)
    back = jmio.load_map(str(tmp_path / "t"))
    np.testing.assert_allclose(back["poses"], tmio.load_map(str(tmp_path / "j"))["poses"],
                               atol=POSE_ATOL)


def _anchored_map(tmp_path, name, offset_xy, origin_lla, n=12):
    rng = np.random.default_rng(3)
    cloud = rng.normal(0, 5, (600, 4)).astype(np.float32)
    poses = []
    for k in range(n):
        T = np.eye(4)
        T[0, 3], T[1, 3] = offset_xy[0] + 2.0 * k, offset_xy[1]
        poses.append(T)
    edges = [(k, k + 1, np.linalg.inv(poses[k]) @ poses[k + 1], np.full(6, 1e-4))
             for k in range(n - 1)]
    d = str(tmp_path / name)
    tmio.save_map(d, np.asarray(origin_lla, float), [1_000_000 * (k + 1) for k in range(n)],
                  poses, [cloud] * n, edges, fixed=[0],
                  meta={"area": [], "origin_anchor_xyz": [0.0, 0.0, 0.0]})
    return d


def test_gnss_anchored_merge(tmp_path, monkeypatch):
    ga = _anchored_map(tmp_path, "ga", (0, 0), (40.0, 116.0, 10.0))
    gb = _anchored_map(tmp_path, "gb", (0, 0), (40.001, 116.0, 10.0))
    Ta = jmerge._gnss_expected_alignment(jmio.load_map(ga), jmio.load_map(gb))
    Tb = tmerge._gnss_expected_alignment(tmio.load_map(ga), tmio.load_map(gb))
    np.testing.assert_array_equal(Tb, Ta)
    assert abs(Tb[1, 3] - 111.0) < 1.0
    wa = _anchored_map(tmp_path, "wa", (0, 0), (40.0, 116.0, 10.0))
    wb = _anchored_map(tmp_path, "wb", (4.0, 0.0), (40.0, 116.0, 10.0))

    def aliased_edges(store_a, store_b, **kw):
        T_rel = np.linalg.inv(store_a.frames[0].pose) @ store_b.frames[0].pose
        T_rel[1, 3] += 5.0
        return [(0, 0, T_rel, np.full(6, 400.0))]
    out = []
    for mod, kw in ((jmerge, {}), (tmerge, dict(device="cpu"))):
        monkeypatch.setattr(mod, "find_cross_edges", aliased_edges)
        out.append(mod.merge_maps(wa, wb, out_dir=None, **kw))
    assert out[0]["cross_edges"] == out[1]["cross_edges"] == []
    for k in range(out[1]["n_a"] + out[1]["n_b"]):
        np.testing.assert_allclose(out[1]["builder"].node_pose(k), out[0]["builder"].node_pose(k),
                                   atol=POSE_ATOL)
    assert abs(out[1]["builder"].node_pose(out[1]["n_a"])[0, 3] - 4.0) < 0.3
