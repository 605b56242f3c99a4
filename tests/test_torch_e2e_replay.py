"""Port parity for the slice as a whole: a recording replayed through
``Perception``'s default pipeline (Source -> SLAM -> Sink), mapping.

The recording of ``tests/test_e2e_slam_replay.py`` (``CircleSim`` seed 33,
the 8 m ring at 0.8 rad/s, absolute IMU stamps, no GNSS), cut to 24 scans
of 2,048 points, written by the reference's ``FrameRecorder``.  Both
packages' ``Perception`` replay it with the LIO seeded at the simulator's
start between ``setup()`` and ``start()``, as the reference test seeds it.

- Graph work synchronous (``async_graph`` and ``async_fetch`` off): the
  trajectories within 2e-3 m of each other (the ``Mapper`` parity bar),
  the same keyframes, and every frame the sink recorded carries the pose
  the engine published for it.
- The port's defaults (both on): every scan integrated with no module
  restart and nothing raised on the graph worker, ATE < 0.3 m (the
  reference test's bar), and ``slam.save_mapping`` writes ``graph.g2o``.
"""
import os
import time

import numpy as np
import pytest

import lsd_tpu.runtime as jrt
import lsd_tpu_torch.runtime as trt
from lsd_tpu.io.recorder import FrameRecorder as JRecorder
from lsd_tpu.runtime.perception import Perception as JPerception
from lsd_tpu_torch.io.player import FramePlayer
from lsd_tpu_torch.runtime.perception import Perception as TPerception
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam.lio import lio_init
from lsd_tpu_torch.tools.profile_lio import nav_at_start
from lsd_tpu_torch.tools.recording import frame_dict
from tests.test_torch_slam_module import private_buses  # noqa: F401 (autouse)

N_SCANS, POINTS = 24, 2048


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=N_SCANS, points_per_scan=POINTS,
                              seed=33))
    data = sim.generate(capacity=POINTS, imu_capacity=16)
    rec = JRecorder(str(tmp_path_factory.mktemp("rec")))
    for k, scan in enumerate(data):
        rec.write(frame_dict(scan, 1_000_000 + k * 100_000))
    return rec.log_dir, sim, np.stack([d[5] for d in data])


def _seed_jax(engine, sim):
    import jax.numpy as jnp
    from lsd_tpu.geometry import so3
    from lsd_tpu.slam.state import init_state
    R, pos = sim.pose(0.0)
    engine.lio_state = engine.lio_state._replace(nav=init_state()._replace(
        pos=jnp.asarray(pos, jnp.float32), quat=so3.matrix_to_quat(jnp.asarray(R, jnp.float32)),
        vel=jnp.asarray(sim.velocity(0.0), jnp.float32)))


def _replay(pkg, recording, tmp_path, **slam):
    rec_dir, sim, _ = recording
    rt = jrt if pkg == "jax" else trt
    rt.clear_interfaces()
    p = JPerception() if pkg == "jax" else TPerception(device="cpu")
    cfg = p.get_config()
    cfg["pipeline"] = [["Source", "SLAM", "Sink"]]
    cfg["input"].update(mode="offline", data_path=rec_dir)
    cfg["slam"].update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3], **slam)
    cfg["system"]["record"].update(use=True, path=str(tmp_path / f"out_{pkg}"))
    p.config_manager.set_config(cfg)
    p.setup()
    slam_mod = p.module_manager.modules["SLAM"]
    eng = slam_mod.engine
    if pkg == "jax":
        _seed_jax(eng, sim)
    else:
        eng.lio_state = lio_init(eng.cfg.lio, nav_at_start(sim, eng.device))
    p.start()
    deadline = time.time() + 120
    while time.time() < deadline and len(eng.odometry) < N_SCANS:
        time.sleep(0.1)
    # let the sink take the re-emitted last frame too
    while time.time() < deadline and p.module_manager.modules["Sink"].frames < N_SCANS + 2:
        time.sleep(0.05)
    status = p.get_status()
    return p, slam_mod, eng, status


def test_parity_synchronous(recording, tmp_path):
    runs = {}
    for pkg in ("jax", "torch"):
        p, slam_mod, eng, status = _replay(pkg, recording, tmp_path, async_graph=False,
                                           async_fetch=False)
        p.release()
        assert len(eng.odometry) == N_SCANS and status["restarts"] == {}
        runs[pkg] = eng
    je, te = runs["jax"], runs["torch"]
    assert [s for s, _ in te.odometry] == [s for s, _ in je.odometry]
    np.testing.assert_allclose(te.trajectory(), je.trajectory(), atol=2e-3)
    assert [kf.stamp_us for kf in te.store.frames] == [kf.stamp_us for kf in je.store.frames]
    assert len(te.store) >= 5
    # the sink recorded every frame with the pose published for its scan
    player = FramePlayer(sorted(
        os.path.join(r, d) for r in [str(tmp_path / "out_torch")] for d in os.listdir(r)))
    seen = {}
    for k in range(len(player)):
        d = player.read_dict(k)
        seen.setdefault(d["frame_start_timestamp"], d["slam_pose"])
    assert len(seen) == N_SCANS
    np.testing.assert_array_equal(np.stack(list(seen.values())), te.trajectory())


def test_port_defaults(recording, tmp_path):
    _, _, gts = recording
    p, slam_mod, eng, status = _replay("torch", recording, tmp_path)
    try:
        assert eng.cfg.async_graph and eng.cfg.async_fetch
        assert len(eng.odometry) == N_SCANS
        assert status["status"] == "Running" and status["restarts"] == {}
        assert status["modules"]["SLAM"]["alive"]
        errs = [np.linalg.norm(T[:3, 3] - gt[:3, 3]) for (_, T), gt in zip(eng.odometry, gts)]
        ate = float(np.sqrt(np.mean(np.square(errs))))
        assert ate < 0.3, ate
        assert trt.call_interface("slam.get_status")["num_keyframes"] >= 5
        assert trt.call_interface("slam.save_mapping", str(tmp_path / "maps"), "e2e") == "ok"
        slam_mod.editor._save_thread.join(timeout=60)
        assert os.path.exists(tmp_path / "maps" / "e2e" / "graph" / "graph.g2o")
        eng.flush()
        assert eng.worker_errors == []
    finally:
        p.release()
        trt.clear_interfaces()
