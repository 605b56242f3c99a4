"""Port parity for the map editor ``SlamModule`` serves:
``slam/map_editor.py`` (``MapEditor``), through the interface registry.
``tests/test_torch_map_tools.py`` holds the other map tools.

- ``MapEditor``: both packages' ``SlamModule`` (mapping, graph work
  synchronous) map the same 25 scans of ``tests/test_map_editor.py``'s
  world; then the same editor operations run on both through the interface
  registry.  Keyframe ids, stamps, edges, fixed flags, areas and the
  interfaces' return values are equal; poses within 2e-3 m (the ``Mapper``
  parity bar); keyframe clouds within 2 points of each other (their voxel
  downsample).  Where an operation reads the clouds (``keyframe_align``,
  the colour map), the port's keyframes first take the reference's clouds
  and poses, so that both work on the same input: the alignments then
  agree within 2e-3, the colour-map bytes (``cv2`` decodes the keyframes'
  JPEGs here, as in the reference) exactly.  Each package loads the map
  the other saved, and ``merge_map`` appends the same keyframes and edges.
"""
import os

import numpy as np
import pytest

import lsd_tpu.runtime as jrt
import lsd_tpu_torch.runtime as trt
from lsd_tpu.proto.internal import parse_pointcloud_map
from lsd_tpu.runtime.modules import SlamModule as JSlam
from lsd_tpu.slam import map_io as jmio
from lsd_tpu_torch.runtime.modules import SlamModule as TSlam
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.slam.lio import lio_init
from lsd_tpu_torch.tools.profile_lio import nav_at_start

cv2 = pytest.importorskip("cv2")

POSE_ATOL = 2e-3
K = np.asarray([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])


def _jnav(sim):
    import jax.numpy as jnp
    from lsd_tpu.geometry import so3
    from lsd_tpu.slam.state import init_state
    R, p = sim.pose(0.0)
    return init_state()._replace(pos=jnp.asarray(p, jnp.float32),
                                 quat=so3.matrix_to_quat(jnp.asarray(R, jnp.float32)),
                                 vel=jnp.asarray(sim.velocity(0.0), jnp.float32))


@pytest.fixture
def modules():
    """(reference module, port module) after the same 25 scans."""
    jrt.clear_interfaces()
    trt.clear_interfaces()
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=25, points_per_scan=4096, seed=44))
    data = sim.generate(capacity=4096, imu_capacity=16)
    out = []
    for rt, cls, kw in ((jrt, JSlam, {}), (trt, TSlam, dict(device="cpu"))):
        cfg = rt.ConfigManager().config
        cfg.slam.update(async_graph=False, async_fetch=False)
        m = cls(cfg, **kw)
        m.setup(cfg)
        eng = m.engine
        if kw:
            eng.lio_state = lio_init(eng.cfg.lio, nav_at_start(sim, "cpu"))
        else:
            eng.lio_state = eng.lio_state._replace(nav=_jnav(sim))
        for k, (P, S, M, I, IM, _) in enumerate(data):
            eng.process_scan(P, S, M, I, IM, stamp_us=int(k * 1e5))
        out.append(m)
    yield out
    jrt.clear_interfaces()
    trt.clear_interfaces()


def _both(name, *args):
    return jrt.call_interface(name, *args), trt.call_interface(name, *args)


def _meta_equal(a, b):
    assert a["edge"] == b["edge"] and a["area"] == b["area"] and a["loops"] == b["loops"]
    assert a["vertex"].keys() == b["vertex"].keys()
    for k, va in a["vertex"].items():
        vb = b["vertex"][k]
        assert (va["id"], va["fix"], va["stamps"]) == (vb["id"], vb["fix"], vb["stamps"])
        np.testing.assert_allclose(vb["pose"], va["pose"], atol=POSE_ATOL)


def _share_keyframes(jm, tm):
    for jk, tk in zip(jm.engine.store.frames, tm.engine.store.frames):
        tk.cloud, tk.pose = jk.cloud.copy(), jk.pose.copy()


def test_introspection(modules):
    jm, tm = modules
    js, ts = _both("slam.get_status")
    assert js.keys() == ts.keys() and js["num_keyframes"] == ts["num_keyframes"] >= 5
    assert (js["num_edges"], js["num_loops"]) == (ts["num_edges"], ts["num_loops"])
    assert ts["travel_distance"] == pytest.approx(js["travel_distance"], abs=1e-2)
    a, b = _both("slam.get_vertex_poses")
    assert a.keys() == b.keys()
    np.testing.assert_allclose(np.asarray(list(b.values())), np.asarray(list(a.values())),
                               atol=POSE_ATOL)
    assert _both("slam.get_edge")[0] == _both("slam.get_edge")[1]
    _meta_equal(*_both("slam.get_graph_meta"))
    for i in (0, 1, js["num_keyframes"] - 1, 999):
        pa, pb = (parse_pointcloud_map(x) for x in _both("slam.get_key_frame", i, "p"))
        assert [lp["lidar_name"] for lp in pa["lp"]] == [lp["lidar_name"] for lp in pb["lp"]]
        na, nb = (len(p["lp"][0].get("points", b"")) // 16 for p in (pa, pb))
        assert abs(na - nb) <= 2 and (na > 100 or i == 999)
        ca, cb = _both("slam.get_vertex_cloud", i)
        assert abs(len(ca) - len(cb)) <= 32 and (len(cb) > 1600 or cb == ca == b"")
    # areas
    poly = [[-100, -100, 0], [100, -100, 0], [100, 100, 0], [-100, 100, 0]]
    assert _both("slam.add_area", dict(name="keepout", type="exclude", polygon=poly)) == ("0", "0")
    assert _both("slam.add_area", dict(name="far", polygon=[[500, 500], [501, 500], [500, 501]])) \
        == ("1", "1")
    far = np.eye(4)
    far[:2, 3] = 500.2
    for T in (np.eye(4), far, np.full((4, 4), 1e4)):
        assert jm.editor.is_in_area(T) == tm.editor.is_in_area(T)
    _both("slam.del_area", "0")
    assert jm.editor.meta == tm.editor.meta and tm.editor.is_in_area(np.eye(4)) is None


def test_graph_edits(modules):
    jm, tm = modules
    meta = jrt.call_interface("slam.get_graph_meta")
    n = len(meta["vertex"])
    T0 = np.asarray(meta["vertex"]["0"]["pose"]).reshape(4, 4)
    Tn = np.asarray(meta["vertex"][str(n - 1)]["pose"]).reshape(4, 4)
    ea, eb = _both("slam.add_edge", 0, n - 1, np.linalg.inv(T0) @ Tn)
    assert ea == eb
    assert _both("slam.graph_optimize") == (None, None)
    _both("slam.set_vertex_fix", 1, True)
    _meta_equal(*_both("slam.get_graph_meta"))
    _both("slam.del_edge", ea)
    _both("slam.del_vertex", 2)
    _both("slam.del_points", {"1": [0, 1, 2], "3": [5]})
    for m in (jm, tm):
        assert len(m.engine.store) == n - 1
    T = np.asarray(jrt.call_interface("slam.get_vertex_poses")["2"]).reshape(4, 4)
    T[0, 3] += 3.0
    _both("slam.set_vertex_pose", 2, T.flatten().tolist())
    _both("slam.graph_optimize")
    _meta_equal(*_both("slam.get_graph_meta"))
    for jk, tk in zip(jm.engine.store.frames, tm.engine.store.frames):
        assert (jk.id, jk.stamp_us) == (tk.id, tk.stamp_us)
        np.testing.assert_allclose(tk.pose, jk.pose, atol=POSE_ATOL)
    assert jm.engine.sc_ids == tm.engine.sc_ids and jm.engine.loops == tm.engine.loops
    a, b = _both("slam.rotate_ground_constraint")
    assert a == b and _both("slam.get_status")[1]["ground_constraint"] == (b == "enable")


def test_align_and_color_map_on_the_same_keyframes(modules):
    jm, tm = modules
    _share_keyframes(jm, tm)
    for src, tgt in ((1, 2), (3, 1)):
        guess = np.linalg.inv(jm.engine.store[tgt].pose) @ jm.engine.store[src].pose
        a, b = _both("slam.keyframe_align", src, tgt, guess.flatten().tolist())
        np.testing.assert_allclose(b, a, atol=POSE_ATOL)
        assert np.linalg.norm((np.linalg.inv(guess) @ np.reshape(b, (4, 4)))[:3, 3]) < 1.0
    img = np.zeros((240, 320, 3), np.uint8)
    img[:, :160] = (0, 0, 255)
    img[:, 160:] = (0, 255, 0)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    cam = {"front": dict(K=K, T_cam_from_lidar=np.eye(4))}
    for m in (jm, tm):
        m.editor.camera_params = cam
        for kf in m.engine.store.frames[::2]:
            kf.images = {"front": jpg}
    for color in (False, True):
        _both("slam.set_export_map_config", -1.0, 4.0, color)
        a, b = _both("slam.get_color_map")
        assert a == b and len(parse_pointcloud_map(b)["lp"][0]["points"]) > 12 * 1000
        assert _both("slam.get_color_map") == (a, a)


def test_save_export_and_merge(modules, tmp_path):
    jm, tm = modules
    for name, m in (("j", jm), ("t", tm)):
        rt = jrt if m is jm else trt
        assert rt.call_interface("slam.save_mapping", str(tmp_path), name) == "ok"
        m.editor._save_thread.join(timeout=60)
    n = len(tm.engine.store)
    assert _both("slam.get_save_progress") == (pytest.approx(n / (n + 1) * 100.0),) * 2
    loaded = {(pkg, who): mio.load_map(str(tmp_path / who))
              for pkg, mio in (("jax", jmio), ("torch", tmio)) for who in "jt"}
    for who in "jt":
        a, b = loaded[("jax", who)], loaded[("torch", who)]
        assert a["stamps"] == b["stamps"] and len(a["stamps"]) == n
        np.testing.assert_allclose(b["poses"], a["poses"])
        assert all(np.array_equal(x, y) for x, y in zip(a["clouds"], b["clouds"]))
    np.testing.assert_allclose(loaded[("jax", "t")]["poses"], loaded[("torch", "j")]["poses"],
                               atol=POSE_ATOL)
    assert os.path.exists(tmp_path / "t" / "graph" / "graph.g2o")
    _both("slam.set_export_map_config", -100.0, 100.0, False)
    heads = [open(jrt.call_interface("slam.export_map", str(tmp_path / "j.pcd")), "rb").read(200),
             open(trt.call_interface("slam.export_map", str(tmp_path / "t.pcd")), "rb").read(200)]
    assert heads[0].split(b"\nPOINTS")[0].split(b"WIDTH")[0] == \
        heads[1].split(b"\nPOINTS")[0].split(b"WIDTH")[0]
    assert heads[1].startswith(b"# This PCD file is generated by LSD\n# GNSS Anchor")
    jrt.call_interface("slam.save_mapping", str(tmp_path), "base")
    jm.editor._save_thread.join(timeout=60)
    n = len(tm.engine.store)
    a, b = _both("slam.merge_map", str(tmp_path / "base"))
    assert a == b
    for m in (jm, tm):
        assert len(m.engine.store) == 2 * n
    _meta_equal(*_both("slam.get_graph_meta"))
