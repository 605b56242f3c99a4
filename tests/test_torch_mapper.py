"""Port parity for the slice as a whole: ``Mapper``.

Both packages' ``Mapper`` take the same 24 simulated scans (2,048 points,
``ds_capacity=1024``, ``map_capacity=2**13``) with a keyframe every 0.5 m,
PGO every 4 keyframes, GPS priors, orientation priors and the floor prior
on, and loop candidates allowed after 3 m of travel, verified against a
1 m surfel map (the sparse scans leave the default 0.25 m one empty), so
that the ScanContext query and the ICP verification run and loop edges
enter the graph.  Tolerances:
- keyframe ids and stamps: equal; keyframe poses (optimized) and the
  published trajectory atol 2e-3 m (the LIO's own parity bar is 1e-3 after
  6 scans; PGO and four times the scans on top);
- ``loop_stats``: equal (every gate decides alike);
- ``save()`` then the *other* package's ``load_map``: as many poses, the
  same edges, poses atol 1e-5 of what was saved, clouds equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.sim import CircleSim, SimConfig
from lsd_tpu.slam import map_io as jmio
from lsd_tpu.slam import mapper as jmap
from lsd_tpu.slam.lio import LioConfig as JLioConfig
from lsd_tpu.slam.state import init_state as jinit
from lsd_tpu_torch.geometry import np_so3
from lsd_tpu_torch.geometry import so3 as tso3
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.slam import mapper as tmap
from lsd_tpu_torch.slam.lio import LioConfig as TLioConfig
from lsd_tpu_torch.slam.state import init_state as tinit

N_SCANS = 24
KW = dict(keyframe_delta_trans=0.5, optimize_every=4, keyframe_cloud_cap=2048,
          loop_min_distance=3.0, loop_map_capacity=2 ** 13, loop_window=4,
          loop_map_voxel=1.0, loop_min_inliers=50, use_floor_prior=True)
LIO = dict(ds_capacity=1024, map_capacity=2 ** 13)


def _sim():
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=N_SCANS, points_per_scan=2048,
                              point_noise=0.01, seed=21))
    return sim, sim.generate(capacity=2048, imu_capacity=16)


def _drive(mapper, data, sim):
    outs = []
    rng = np.random.default_rng(0)
    for k, (P, S, M, I, IM, T_gt) in enumerate(data):
        kw = {}
        if k % 3 == 0:
            kw["gps_xyz"] = T_gt[:3, 3] + rng.normal(0, 0.05, 3)
        if k % 5 == 0:
            kw["orient_quat"] = np_so3.matrix_to_quat(T_gt[:3, :3])
        outs.append(mapper.process_scan(P, S, M, I, IM, stamp_us=int(k * 1e5), **kw))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sim, data = _sim()
    R, p = sim.pose(0.0)
    v = sim.velocity(0.0)
    jnav = jinit()._replace(pos=jnp.asarray(p, jnp.float32),
                            quat=jso3.matrix_to_quat(jnp.asarray(R, jnp.float32)),
                            vel=jnp.asarray(v, jnp.float32))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tnav = tinit(device="cpu")._replace(pos=f(p), quat=tso3.matrix_to_quat(f(R)), vel=f(v))
    jm = jmap.Mapper(jmap.MapperConfig(lio=JLioConfig(**LIO), **KW), jnav)
    tm = tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO), **KW), tnav)
    jout, tout = _drive(jm, data, sim), _drive(tm, data, sim)
    root = tmp_path_factory.mktemp("maps")
    jm.save(str(root / "j"))
    tm.save(str(root / "t"))
    return jm, tm, jout, tout, root, data


def test_config_fields_carry_over():
    jf = {f.name: f for f in dataclasses.fields(jmap.MapperConfig)}
    tf = {f.name: f for f in dataclasses.fields(tmap.MapperConfig)}
    assert list(jf) == list(tf)
    jc, tc = jmap.MapperConfig(), tmap.MapperConfig()
    for name in jf:
        if name not in ("lio", "pgo"):
            assert getattr(jc, name) == getattr(tc, name), name
    assert tuple(tc.pgo) == tuple(jc.pgo)


def test_public_methods_carry_over():
    public = lambda cls: {n for n in vars(cls) if not n.startswith("__")}
    assert public(jmap.Mapper) <= public(tmap.Mapper)


def test_same_keyframes_and_poses(runs):
    jm, tm, jout, tout, _, _ = runs
    assert len(tm.store) == len(jm.store) > 15
    assert [o["is_keyframe"] for o in tout] == [o["is_keyframe"] for o in jout]
    for jk, tk in zip(jm.store.frames, tm.store.frames):
        assert (tk.id, tk.stamp_us) == (jk.id, jk.stamp_us)
        np.testing.assert_allclose(tk.pose, jk.pose, atol=2e-3)
        np.testing.assert_allclose(tk.odom, jk.odom, atol=2e-3)
        assert abs(len(tk.cloud) - len(jk.cloud)) <= 2 and tk.cloud.shape[1] == 4
        assert tk.accum_distance == pytest.approx(jk.accum_distance, abs=1e-2)
    np.testing.assert_allclose(tm.trajectory(), jm.trajectory(), atol=2e-3)
    np.testing.assert_allclose(tm.odom2map, jm.odom2map, atol=2e-3)
    assert tm.trajectory().shape == (N_SCANS, 4, 4)


def test_same_graph_and_loop_decisions(runs):
    jm, tm, _, _, _, _ = runs
    assert tm.loop_stats == jm.loop_stats
    # the ScanContext query and the gates behind it ran
    assert sum(tm.loop_stats.values()) >= 5 and tm.loop_stats["accepted"] >= 1
    assert tm.loops == jm.loops and tm.sc_ids == jm.sc_ids
    assert int(tm.sc_db.count) == int(jm.sc_db.count) == len(tm.store)
    for name in ("se3", "gps", "floor", "orient"):
        assert len(getattr(tm.graph, name)) == len(getattr(jm.graph, name)), name
    assert len(tm.graph.gps) == 8 and len(tm.graph.orient) == 5 and len(tm.graph.floor) > 10
    for (ti, tj, tq, tt, tsi), (ji, jj, jq, jt, jsi) in zip(tm.graph.se3, jm.graph.se3):
        assert (ti, tj) == (ji, jj)
        np.testing.assert_allclose(tt, jt, atol=2e-3)
        np.testing.assert_allclose(tq, jq, atol=2e-3)
    assert tm.graph.fixed == jm.graph.fixed


def test_saved_map_loads_in_the_other_package(runs):
    jm, tm, _, _, root, _ = runs
    from_torch = jmio.load_map(str(root / "t"))          # JAX package reads the port's map
    from_jax = tmio.load_map(str(root / "j"))            # and the port reads JAX's
    n = len(tm.store)
    for loaded, mapper in ((from_torch, tm), (from_jax, jm)):
        assert len(loaded["poses"]) == n and loaded["ids"] == list(range(n))
        assert len(loaded["edges"]) == len(mapper.graph.se3) >= n - 1
        assert loaded["fixed"] == [0]
        assert loaded["stamps"] == [kf.stamp_us for kf in mapper.store.frames]
        for T, kf in zip(loaded["poses"], mapper.store.frames):
            np.testing.assert_allclose(T, kf.pose, atol=1e-5)
        for c, kf in zip(loaded["clouds"], mapper.store.frames):
            np.testing.assert_array_equal(c[:, :3], kf.cloud[:, :3])
    for a, b in zip(from_torch["poses"], from_jax["poses"]):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_get_timed_pose_matches(runs):
    jm, tm, _, _, _, _ = runs
    last = int((N_SCANS - 1) * 1e5)
    for ts in (last + 30000, last + 100000, last + 150000, last + 900000):
        np.testing.assert_allclose(tm.get_timed_pose(ts), jm.get_timed_pose(ts), atol=2e-3)
    assert tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO)),
                       device="cpu").get_timed_pose(0) is None


def test_async_fetch_and_graph_worker(runs):
    """The pipelined fetch and the background graph worker: the same
    trajectory as the synchronous run up to where they stop, a clean
    flush() and close(), and the worker thread gone."""
    _, tm_sync, _, _, _, data = runs
    sim, _ = _sim()
    R, p = sim.pose(0.0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    nav = tinit(device="cpu")._replace(pos=f(p), quat=tso3.matrix_to_quat(f(R)),
                                       vel=f(sim.velocity(0.0)))
    kw = dict(KW, async_graph=True, async_fetch=True, use_floor_prior=False)
    m = tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO), **kw), nav)
    outs = [m.process_scan(*d[:5], stamp_us=int(k * 1e5)) for k, d in enumerate(data[:10])]
    assert outs[0]["pose"] is None and outs[1]["pose"] is not None
    assert "live_pose" in outs[3] and np.isfinite(outs[3]["live_pose"]).all()
    m.flush()
    traj = m.trajectory()
    assert traj.shape == (10, 4, 4) and np.isfinite(traj).all()
    assert m.finish_pending() is None
    worker = m._worker
    m.close()
    m.close()                                            # idempotent
    assert not worker.is_alive()
    # odometry does not depend on the graph thread's timing; the published
    # pose does once a PGO has run, so compare raw odometry of keyframes
    for a, b in zip(m.store.frames, tm_sync.store.frames[:len(m.store)]):
        np.testing.assert_allclose(a.odom, b.odom, atol=1e-6)
    # the worker did every keyframe's graph work itself: it prints what a
    # job raises and goes on, so a finite trajectory alone would not show it
    assert len(m.store) == 10 and m.sc_ids == list(range(10))
    assert m.worker_errors == [] and "dropped_jobs" not in m.loop_stats
    assert any(not np.array_equal(kf.pose, kf.odom) for kf in m.store.frames)   # a PGO ran


def test_graph_worker_records_what_a_job_raises(runs, monkeypatch, capsys):
    """A job that raises on the worker thread is printed and recorded in
    ``worker_errors``; the worker goes on to the next keyframe."""
    _, _, _, _, _, data = runs
    m = tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO), async_graph=True,
                                      keyframe_cloud_cap=2048), device="cpu")
    real = m._detect_loop

    def detect(kid, desc):
        if kid == 0:
            raise RuntimeError("stand-in for a device error on the worker")
        return real(kid, desc)
    monkeypatch.setattr(m, "_detect_loop", detect)
    P, S, M, I, IM, _ = data[0]
    m.process_scan(P, S, M, I, IM, stamp_us=5)
    T = np.eye(4)
    T[0, 3] = 3.0
    m.updater.is_update(T)
    m._add_keyframe(P, M, T, 7, None)
    m.flush()
    m.close()
    assert [str(e) for e in m.worker_errors] == ["stand-in for a device error on the worker"]
    assert m.sc_ids == [1] and len(m.store) == 2
    assert "stand-in for a device error" in capsys.readouterr().err


def test_mapper_accepts_tensors_and_raw_point_keyframes(runs):
    """Scans already on the device pass through; ``_add_keyframe`` without
    pre-computed material (raw points, as a caller outside
    ``process_scan`` passes them) downsamples and describes them itself."""
    _, _, _, _, _, data = runs
    m = tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO), keyframe_cloud_cap=2048),
                    device="cpu")
    P, S, M, I, IM, _ = data[0]
    out = m.process_scan(*[torch.as_tensor(a) for a in (P, S, M, I, IM)], stamp_us=5)
    assert out["is_keyframe"] and len(m.store) == 1
    T = np.eye(4)
    T[0, 3] = 3.0
    m.updater.is_update(T)
    m._add_keyframe(P, M, T, 7, None)
    assert len(m.store) == 2 and m.store[1].cloud.shape[1] == 4 and len(m.sc_ids) == 2
    assert 100 < len(m.store[1].cloud) <= 2048


@pytest.mark.parametrize("wedged", [False, True])
def test_graph_worker_sheds_only_a_wedged_job(monkeypatch, wedged):
    """With the worker's queue full for the put's 2 s, odometry waits for a
    job that is only slow (a replay faster than the sensor) and drops the
    oldest pending job, coalescing in the new one, when the worker's job has
    run past ``WEDGED_S``."""
    import threading
    release = threading.Event()
    m = tmap.Mapper(tmap.MapperConfig(lio=TLioConfig(**LIO), async_graph=True), device="cpu")
    done = []

    def work(kid, *rest):
        if kid == 0:               # the first job: slow (2.5 s), or wedged until released
            release.wait(timeout=30.0 if wedged else 2.5)
        done.append(kid)
    monkeypatch.setattr(m, "_kf_graph_work", work)
    monkeypatch.setattr(tmap, "WEDGED_S", 0.5 if wedged else 30.0)
    try:
        for kid in range(10):      # 1 on the worker, 8 queued, 1 more
            m._enqueue_graph_job((kid, None, None, None))
    finally:
        release.set()
    m.flush()
    m.close()
    if wedged:
        assert m.loop_stats.get("dropped_jobs") == 1 and done == [0] + list(range(2, 10))
    else:
        assert "dropped_jobs" not in m.loop_stats and done == list(range(10))
