"""Port parity for ``runtime/modules.py:SlamModule``, the host code between
the sensors and the engines, driven through ``process`` on frame dicts as
the pipeline drives it.

- ``tests/test_gnss_mapping.py``'s 12-frame INS scenario (RTK-fixed status
  42 after its stable time, the fix moving north, heading 90) in both
  packages with the graph work synchronous: ``origin_lla`` equal, the GPS
  and orientation priors and every published pose within 2e-3 m (the
  ``Mapper`` parity bar of ``tests/test_torch_mapper.py``); with the
  defaults (``async_graph`` and ``async_fetch`` on), the reference test's
  own bars in the port, ``origin_lla`` equal to the reference's, and the
  odometry received on the bus by a subscriber.
- RTKM: ``slam.method: RTKM`` selects ``RtkMapper`` in both, and the
  interpolated poses agree within 1e-4 m (the RTK phase's own bar).
- Localisation on a small map the port saved, the hint given through
  ``slam.set_init_pose`` (a 4x4) or a 6-element pose range, with fixes
  (status 42, gps_var 0.25) and without, over 8 scans of a drive that
  starts at rest: the same status and interface names, poses within 1e-2 m
  and the horizontal position within 0.02 m of the truth.  Both packages
  hand the UKF the recording's accelerometer in g where it takes m/s^2
  (ROADMAP queue C): until the side LIO's increments take over, the
  prediction pulls the pose down, 0.5 m over these 8 scans, and the map
  match fights it; the packages agree within 2e-6 m but on the last scan
  with fixes, where they part by 6.0e-3 m (the ``Localizer`` parity bar of
  ``tests/test_torch_localization.py`` is 5e-3 m on a drive without that pull).
- The end of the stream: the player's re-emitted last frame drains the
  pipelined scan and is not integrated, in both.
- ``slam.restart_mapping`` empties the engine in both, and both packages
  register the same interface names in each mode.
"""
import os
import time

import numpy as np
import pytest

import lsd_tpu.comms.bus as jbus
import lsd_tpu.runtime as jrt
import lsd_tpu.runtime.interface as jif
import lsd_tpu_torch.comms.bus as tbus
import lsd_tpu_torch.runtime as trt
import lsd_tpu_torch.runtime.interface as tif
from lsd_tpu.runtime.modules import SlamModule as JSlam
from lsd_tpu_torch.comms import MessageBus
from lsd_tpu_torch.comms.messages import decode_typed
from lsd_tpu_torch.runtime.modules import SlamModule as TSlam
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam.lio import LioConfig
from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
from lsd_tpu_torch.tools.profile_lio import localization_drive, nav_at_start
from lsd_tpu_torch.tools.recording import (ORIGIN_ALT, ORIGIN_LAT, ORIGIN_LON, fix_projector,
                                           frame_dict, truth_fix)
from tests.test_io import make_frame_dict

PKGS = (("jax", jrt, JSlam, {}), ("torch", trt, TSlam, dict(device="cpu")))
POSE_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def private_buses():
    """``SlamModule`` publishes its odometry on the process's core bus, whose
    registry every process of the machine shares (other tests subscribe to
    it): while these tests run, both packages' core bus is one of this
    process's own."""
    saved = jbus.MessageBus._instance, tbus.MessageBus._instance
    name = f"test_torch_{os.getpid()}"
    jbus.MessageBus._instance, tbus.MessageBus._instance = jbus.MessageBus(name), MessageBus(name)
    yield
    jbus.MessageBus._instance, tbus.MessageBus._instance = saved


@pytest.fixture(autouse=True)
def _clean_interfaces():
    jrt.clear_interfaces()
    trt.clear_interfaces()
    yield
    jrt.clear_interfaces()
    trt.clear_interfaces()


def _module(rt, cls, kw, **slam):
    cfg = rt.ConfigManager().config
    cfg.slam.update(slam)
    m = cls(cfg, **kw)
    m.setup(cfg)
    return m


def _ins_frames():
    rng = np.random.default_rng(2)
    for k in range(12):
        d = make_frame_dict(ts=1_000_000 + k * 200_000, n=2048)
        d["points"]["0-Ouster-OS1"] = (rng.normal(size=(2048, 4)) * [10, 10, 2, 1]).astype(np.float32)
        d["ins_data"]["Status"] = 42
        d["ins_data"]["latitude"] = 42.0 + k * 2e-5     # ~1.1 m north per 1e-5 deg
        d["ins_data"]["heading"] = 90.0                  # due east (NED) -> ENU yaw 0
        yield d


def _check_reference_bars(eng):
    # the anchor is the FIRST TRUSTED fix (after the stable-time upgrade)
    np.testing.assert_allclose(eng.origin_lla[:2], [42.0, -83.0], atol=3e-4)
    assert len(eng.graph.gps) >= 1 and len(eng.graph.orient) >= 1
    assert np.all(np.isfinite(np.stack([g[1] for g in eng.graph.gps])))
    np.testing.assert_allclose(np.abs(np.asarray(eng.graph.orient[-1][1])), [1.0, 0, 0, 0],
                               atol=5e-3)


def test_ins_scenario_parity():
    runs = {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, key_frames_interval=[0.0, 0.0], async_graph=False,
                    async_fetch=False)
        poses = [m.process(d)["slam_pose"].copy() for d in _ins_frames()]
        runs[pkg] = (m.engine, np.stack(poses))
    (je, jp), (te, tp) = runs["jax"], runs["torch"]
    _check_reference_bars(te)
    np.testing.assert_array_equal(te.origin_lla, je.origin_lla)
    np.testing.assert_allclose(te.origin_anchor_xyz, je.origin_anchor_xyz, atol=POSE_ATOL)
    for name in ("gps", "orient"):
        a, b = getattr(je.graph, name), getattr(te.graph, name)
        assert [g[0] for g in a] == [g[0] for g in b] and len(b) == 3
        np.testing.assert_allclose(np.stack([g[1] for g in b]), np.stack([g[1] for g in a]),
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(np.stack([g[2] for g in b]), np.stack([g[2] for g in a]))
    np.testing.assert_allclose(tp, jp, atol=POSE_ATOL)
    np.testing.assert_allclose(te.trajectory(), je.trajectory(), atol=POSE_ATOL)


def test_ins_scenario_defaults_and_bus():
    """With the defaults the graph work runs on the mapper's worker and the
    fetch is pipelined; every pose the port publishes reaches a bus
    subscriber.  The module publishes on the core bus; here it is given a
    bus of its own, which the reference's module does not publish on."""
    got, origins = [], {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, key_frames_interval=[0.0, 0.0])
        assert m.engine.cfg.async_graph and m.engine.cfg.async_fetch
        sub = None
        if pkg == "torch":
            assert m.bus is MessageBus.core()
            m.bus = MessageBus(bus=f"slam_module_test_{os.getpid()}")
            sub = m.bus.subscribe(lambda ch, p: got.append((ch, p)))
        try:
            for d in _ins_frames():
                m.process(d)
            deadline = time.time() + 3
            while sub is not None and time.time() < deadline and len(got) < 11:
                time.sleep(0.02)
        finally:
            if sub is not None:
                sub.close()
        m.engine.flush()
        m.release()
        _check_reference_bars(m.engine)
        assert not getattr(m.engine, "worker_errors", [])
        origins[pkg] = m.engine.origin_lla
    np.testing.assert_array_equal(origins["torch"], origins["jax"])
    # the pipelined fetch publishes from the second frame on
    assert [ch for ch, _ in got] == ["slam.odometry"] * 11
    name, msg = decode_typed(got[-1][1])
    assert name == "Odometry" and msg["header"]["stamp_us"] == 1_000_000 + 11 * 200_000
    np.testing.assert_allclose(msg["pose"]["position"]["x"], m.last_pose[0, 3])


def _sim_frames(n, with_fixes):
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=n, points_per_scan=2048,
                              point_noise=0.01, seed=21))
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    frames = [frame_dict(s, 1_000_000 + k * 100_000,
                         truth_fix(sim, (k + 1) * 0.1, 1_100_000 + k * 100_000, proj, p0)
                         if with_fixes else None)
              for k, s in enumerate(sim.generate(capacity=2048, imu_capacity=16))]
    return sim, frames


def test_rtkm_selection():
    _, frames = _sim_frames(24, with_fixes=True)
    runs = {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, method="RTKM", key_frames_interval=[1.5, 0.3],
                    async_graph=False)
        assert type(m.engine).__name__ == "RtkMapper"
        runs[pkg] = (m.engine, np.stack([m.process(dict(d))["slam_pose"] for d in frames]))
    (je, jp), (te, tp) = runs["jax"], runs["torch"]
    assert len(te.store) == len(je.store) >= 4
    # poses come from the fixes: the first 10 frames wait for the status
    # machine's 1 s stable time, then follow the fixes
    assert np.abs(tp[-1, :3, 3] - tp[10, :3, 3]).max() > 1.0
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_array_equal(te.origin_lla, je.origin_lla)


def test_end_of_stream_duplicate_frame():
    _, frames = _sim_frames(8, with_fixes=False)
    runs = {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, async_graph=False, async_fetch=True)
        for d in frames:
            m.process(dict(d))
        assert len(m.engine.odometry) == 7            # one scan in flight
        out = m.process(dict(frames[-1]))             # the player re-emits the last frame
        assert len(m.engine.odometry) == 8 and m.engine.finish_pending() is None
        np.testing.assert_array_equal(out["slam_pose"], m.last_pose)
        m.process(dict(frames[3]))                    # an older frame: not integrated
        assert len(m.engine.odometry) == 8
        runs[pkg] = m.engine.trajectory()
    np.testing.assert_allclose(runs["torch"], runs["jax"], atol=POSE_ATOL)


def test_restart_mapping_and_interface_names():
    _, frames = _sim_frames(6, with_fixes=False)
    names = {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, key_frames_interval=[0.5, 0.1], async_graph=False,
                    async_fetch=False)
        for d in frames:
            m.process(dict(d))
        assert len(m.engine.store) >= 2
        names[pkg] = sorted((jif if pkg == "jax" else tif)._registry)
        old = m.engine
        assert rt.call_interface("slam.restart_mapping") == "ok"
        assert m.engine is not old and len(m.engine.store) == 0
        assert np.array_equal(m.last_pose, np.eye(4)) and m._last_ts is None
        m.process(dict(frames[0]))                    # integrates again from the start
        assert len(m.engine.odometry) == 1
    assert names["torch"] == names["jax"]
    # slam.save_map and the editor's 23, the pose getters, texture_mesh and
    # restart_mapping
    assert len([n for n in names["torch"] if n.startswith("slam.")]) == 28


@pytest.fixture(scope="module")
def small_map(tmp_path_factory):
    """A map the port's Mapper saved from 40 scans of 2,048 points of the
    8 m ring world, anchored at the fixes' datum at its first pose."""
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=40, points_per_scan=2048,
                              point_noise=0.01, seed=21))
    m = Mapper(MapperConfig(lio=LioConfig(ds_capacity=2048, map_capacity=2 ** 14,
                                          scan_voxel=0.4, map_voxel=0.4),
                            keyframe_delta_trans=1.5, optimize_every=8),
               nav_at_start(sim, "cpu"))
    for k, d in enumerate(sim.generate(capacity=2048, imu_capacity=16)):
        m.process_scan(*d[:5], stamp_us=int(k * 1e5))
    # the datum of truth_fix, paired with its map-frame position
    m.origin_lla = np.asarray([ORIGIN_LAT, ORIGIN_LON, ORIGIN_ALT])
    m.origin_anchor_xyz = sim.pose(0.0)[1]
    path = str(tmp_path_factory.mktemp("map") / "m")
    m.save(path)
    return sim, path


@pytest.mark.parametrize("hint_kind,with_fixes", [("matrix", True), ("range", False)])
def test_localization_mode(small_map, hint_kind, with_fixes):
    sim, path = small_map
    drive, scans, hint = localization_drive(sim, 8, 2048)
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    frames = [frame_dict(s, 2_000_000 + k * 100_000,
                         truth_fix(drive, 0.037 + (k + 1) * 0.1, 2_100_000 + k * 100_000,
                                   proj, p0) if with_fixes else None)
              for k, s in enumerate(scans)]
    if hint_kind == "matrix":
        arg = hint.tolist()
    else:
        from lsd_tpu_torch.geometry import np_so3
        arg = [*hint[:3, 3], *np_so3.matrix_to_rpy(hint[:3, :3])]
    runs = {}
    for pkg, rt, cls, kw in PKGS:
        m = _module(rt, cls, kw, mode="localization", map_path=path)
        assert type(m.engine).__name__ == "Localizer"
        rt.call_interface("slam.set_init_pose", arg)
        poses = [m.process(dict(d))["slam_pose"].copy() for d in frames]
        runs[pkg] = (np.stack(poses), rt.call_interface("slam.get_status"),
                     sorted((jif if pkg == "jax" else tif)._registry))
    (jp, js, jn), (tp, ts, tn) = runs["jax"], runs["torch"]
    assert ts == js == dict(initialized=True) and tn == jn
    np.testing.assert_allclose(tp, jp, atol=1e-2)
    truth = np.stack([s[5][:3, 3] for s in scans])
    assert np.linalg.norm(tp[:, :2, 3] - truth[:, :2], axis=1).max() < 0.02
