"""Mapping campaign on the port: the per-session half of
``lsd_tpu/tools/campaign.py``.

- ``make_sim``: the campaign's figure-eight session simulator;
- ``make_recording``: the session streamed into a recording in the
  reference's pickle format (the same frames, byte for byte, as the
  reference writes for the same simulator);
- ``run_session``: the recording replayed through the full ``Perception``
  pipeline (Source -> SLAM -> Sink) in mapping mode on the port's device,
  scored against ground truth, the map saved through ``slam.save_mapping``.

The campaign's cross-session merge (``merge_distributed``) and its
``main`` need the distributed Schur solver of ``parallel/schur_pgo.py``,
which the port does not have yet (ROADMAP A13): ``main`` raises
``NotImplementedError`` before doing any work.
"""
from __future__ import annotations

import os
import resource
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from ..utils.device import DeviceLike

# a session with no new scan for this long is stalled: run_session stops
# waiting for it (the reference's rule)
STALL_S = 300.0


def make_sim(seed: int, laps: float, radius: float = 30.0,
             speed: float = 5.0, points: int = 16384):
    """The campaign's figure-eight session simulator."""
    from ..sim import FigureEightSim, SimConfig
    n = int((1.5 + 2.0 + 4 * np.pi * radius * laps / speed) * 10)
    return FigureEightSim(
        SimConfig(radius=radius, speed=speed, points_per_scan=points,
                  point_noise=0.01, rest_time=1.5, ramp_time=2.0, seed=seed,
                  n_scans=n),
        # per-frame fixes (the reference's InsDriver.trigger interpolates
        # a fix for EVERY frame) so keyframes always carry a GPS prior
        laps=laps, gps_noise=0.05, gps_outlier_rate=0.02, gps_hz=10.0)


def make_recording(sim, out_root: str, t_start: float = 0.0,
                   n_scans: Optional[int] = None, capacity: int = 16384,
                   gps: bool = True, progress=None) -> Dict:
    """Stream the simulated session into a reference-format recording.

    Returns dict(log_dir, gt (N,4,4), ts_us (N,), gt_path).  Idempotent: an
    existing complete recording under ``out_root`` (gt.npz + matching
    frame count) is reused."""
    import glob as _glob
    gt_prev = os.path.join(out_root, "gt.npz")
    if os.path.exists(gt_prev):
        z = np.load(gt_prev)
        log_dir = str(z["log_dir"])
        want = n_scans if n_scans is not None else len(z["gt"])
        have = len(_glob.glob(os.path.join(log_dir, "*.pkl")))
        if os.path.isdir(log_dir) and have >= want >= len(z["gt"]):
            if progress:
                progress(f"reusing existing recording ({have} frames)")
            return dict(log_dir=log_dir, gt=z["gt"], ts_us=z["ts_us"],
                        gt_path=gt_prev)
    from ..io.recorder import FrameRecorder
    cfg = sim.cfg
    period = 1.0 / cfg.scan_hz
    total = n_scans if n_scans is not None else int(sim.duration() / period)
    rec = FrameRecorder(out_root)
    gts, tss = [], []
    gt_path = os.path.join(out_root, "gt.npz")
    gps_every = max(1, int(round(cfg.scan_hz / sim.gps_hz))) if gps else 0
    for k in range(total):
        t0 = t_start + k * period
        # unique timestamps across sessions (t_start offsets B)
        ts = 1_000_000 + int(t0 * 1e6)
        pts, stamps = sim.scan(t0)
        n = min(len(pts), capacity)
        pts4 = np.concatenate([pts[:n], np.zeros((n, 1), np.float32)], 1)
        imu = sim.imu_batch(t0)
        imu_abs = np.asarray(imu, np.float64).copy()
        imu_abs[:, 0] = ts + imu_abs[:, 0] * 1e6
        ins_valid = gps and (k % gps_every == 0)
        d = dict(
            frame_start_timestamp=ts,
            frame_timestamp_monotonic=ts,
            points={"0-Custom": pts4},
            points_attr={"0-Custom": dict(
                timestamp=ts,
                points_attr=np.stack([stamps[:n], np.zeros(n, np.float32)], 1))},
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=bool(ins_valid),
            ins_data=sim.ins_sample_dict(t0, ts) if ins_valid else {},
            imu_data=imu_abs,
            motion_valid=False, timestep=int(period * 1e6))
        rec.write(d)
        R, p = sim.pose(t0 + period)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        gts.append(T)
        tss.append(ts)
        if progress and k % 500 == 0:
            progress(f"record {k}/{total}")
    gt = np.stack(gts)
    ts_us = np.asarray(tss, np.int64)
    # ground truth next to the recording, so a replay can be scored
    # without simulating again
    np.savez(gt_path, gt=gt, ts_us=ts_us, log_dir=rec.log_dir)
    return dict(log_dir=rec.log_dir, gt=gt, ts_us=ts_us, gt_path=gt_path)


def _ate(est: np.ndarray, gt: np.ndarray, warmup: int) -> float:
    """ATE RMSE after least-squares SE3 alignment (Umeyama, no scale) of
    the post-warmup positions; non-finite pairs are dropped."""
    from ..utils.metrics import ate_rmse
    return ate_rmse(est, gt, warmup)


def _abs_err(est: np.ndarray, gt: np.ndarray, warmup: int) -> float:
    """RMSE WITHOUT alignment — meaningful when GNSS anchors the map in
    the world frame."""
    from ..utils.metrics import ate_rmse
    return ate_rmse(est, gt, warmup, align="none")


def session_perception(device: DeviceLike, data_path: str, slam: Dict):
    """``Perception`` on ``device`` over the recording at ``data_path``
    through Source -> SLAM -> Sink with the INS in use, the ``slam``
    section updated from ``slam``; returns the facade after ``setup()``.
    The sink's recorder (recording off) keeps its root in the temporary
    directory."""
    from ..runtime import clear_interfaces
    from ..runtime.perception import Perception

    clear_interfaces()
    p = Perception(device=device)
    cfg = p.get_config()
    cfg["pipeline"] = [["Source", "SLAM", "Sink"]]
    cfg["input"]["mode"] = "offline"
    cfg["input"]["data_path"] = data_path
    cfg["slam"].update(slam)
    cfg["ins"]["use"] = True
    cfg["system"]["record"]["path"] = os.path.join(tempfile.gettempdir(), "lsd_tpu_records")
    p.config_manager.set_config(cfg)
    p.setup()
    return p


def run_session(rec: Dict, map_dir: str, sim, name: str,
                t_start: float = 0.0, progress=print,
                device: DeviceLike = None) -> Dict:
    """Replay a recording through the full Perception pipeline on
    ``device`` (the card unless the caller names another); returns
    metrics and saves the map."""
    import torch

    from ..geometry import so3
    from ..io.frame import IMU_CAPACITY
    from ..ops.voxelize import voxel_downsample
    from ..runtime import clear_interfaces
    from ..runtime.interface import call_interface
    from ..slam.mapper import _scan_step
    from ..slam.state import init_state
    from ..utils.device import to_device

    p = session_perception(device, rec["log_dir"],
                           dict(mode="mapping", resolution=0.4,
                                key_frames_interval=[2.0, 0.2618]))
    slam_mod = p.module_manager.modules["SLAM"]
    eng = slam_mod.engine
    dev = p.device
    # seed the LIO at the session's true initial kinematic state (a session
    # that starts mid-motion would diverge from a cold identity start)
    R0, p0 = sim.pose(t_start)
    f32 = lambda a: to_device(np.asarray(a, np.float32), dev)
    eng.lio_state = eng.lio_state._replace(
        nav=init_state(device=dev)._replace(
            pos=f32(p0), quat=so3.matrix_to_quat(f32(R0)),
            vel=f32(sim.velocity(t_start))))
    # before the clock starts, one scan step (the LIO with its fused
    # reduction, whose kernel is built here on a card, and the keyframe
    # material) and one downsample on zeros: the session's wall measures
    # the replay, not the build.  Both are pure: the engine's state is not
    # touched.
    cap = int(sim.cfg.points_per_scan)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    st_w, _, _, _ = _scan_step(
        eng.cfg.lio, eng.lio_state, z(cap, 3), z(cap), z(cap, dtype=torch.bool),
        z(IMU_CAPACITY, 7), z(IMU_CAPACITY, dtype=torch.bool), z(3), z(dtype=torch.bool),
        eng.cfg.keyframe_cloud_voxel, eng.cfg.keyframe_cloud_cap)
    _, dm = voxel_downsample(z(cap, 4), z(cap, dtype=torch.bool),
                             eng.cfg.keyframe_cloud_voxel, eng.cfg.keyframe_cloud_cap)
    torch.stack([st_w.nav.pos[0], dm[0].float()]).cpu()

    n_total = len(rec["gt"])
    t_wall0 = time.time()
    p.start()
    call_interface("player.set_rate", 1000.0)

    deadline = time.time() + max(1800.0, n_total * 0.2)
    last_n, last_change = 0, time.time()
    while time.time() < deadline and len(eng.odometry) < n_total:
        time.sleep(2.0)
        n_now = len(eng.odometry)
        if n_now != last_n:
            last_n, last_change = n_now, time.time()
            if n_now % 300 < 2:
                progress(f"{name}: {n_now}/{n_total} scans, "
                         f"{len(eng.store)} kf, {len(eng.loops)} loops")
        elif time.time() - last_change > STALL_S:
            progress(f"{name}: STALLED at {n_now}/{n_total}")
            break
    wall = time.time() - t_wall0
    n_done = len(eng.odometry)

    # final optimize + save through the reference save_mapping flow
    call_interface("slam.save_mapping", os.path.dirname(map_dir),
                   os.path.basename(map_dir))
    if hasattr(slam_mod, "editor") and getattr(slam_mod.editor, "_save_thread", None):
        slam_mod.editor._save_thread.join(timeout=600)

    est_map = np.stack([T for _, T in eng.odometry])
    gt = rec["gt"][:n_done]
    warmup = 27
    ate_map = _ate(est_map, gt, warmup)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    metrics = dict(
        name=name, scans=n_done, scans_total=n_total,
        keyframes=len(eng.store), loops=len(eng.loops),
        ate_map_m=round(ate_map, 4),
        wall_s=round(wall, 1),
        scans_per_sec=round(n_done / max(wall, 1e-9), 2),
        peak_rss_mb=round(rss_mb, 1),
        graph_nodes=eng.graph.num_nodes,
        graph_edges=len(eng.graph.se3),
        gps_priors=len(eng.graph.gps),
        loop_stats=dict(getattr(eng, "loop_stats", {})),
    )
    # keyframe-pose ATE vs ground truth: post-PGO (pose) and raw LIO
    # odometry (odom) — the before/after-loop-closure comparison
    kf_est, kf_odom, kf_gt = [], [], []
    ts_to_gt = {int(t): T for t, T in zip(rec["ts_us"], rec["gt"])}
    for kf in eng.store.frames:
        if int(kf.stamp_us) in ts_to_gt:
            kf_est.append(kf.pose)
            kf_odom.append(kf.odom)
            kf_gt.append(ts_to_gt[int(kf.stamp_us)])
    if len(kf_est) > 10:
        gts = np.stack(kf_gt)
        metrics["ate_keyframes_m"] = round(_ate(np.stack(kf_est), gts, 2), 4)
        metrics["ate_keyframes_odom_only_m"] = round(
            _ate(np.stack(kf_odom), gts, 2), 4)
        # absolute (unaligned) accuracy — the GNSS priors anchor the map
        # in the world frame
        metrics["abs_keyframes_rmse_m"] = round(
            _abs_err(np.stack(kf_est), gts, 2), 4)
    p.release()
    clear_interfaces()
    return metrics


def main(argv=None):
    raise NotImplementedError(
        "the campaign's cross-session merge runs the distributed Schur solver "
        "(parallel/schur_pgo.py), which the port does not have yet (ROADMAP A13); "
        "make_recording and run_session run one session")


if __name__ == "__main__":
    main()
