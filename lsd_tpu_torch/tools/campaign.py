"""Mapping campaign on the port (counterpart of
``lsd_tpu/tools/campaign.py``): a figure-eight town session of about a
thousand keyframes with several loops through the full pipeline, a second
overlapping session, and the two merged by the distributed Schur solver.

Flow:
  1. simulate session A (``FigureEightSim``, ``--laps`` laps) and record it
     in the reference's pickle format (``make_recording``);
  2. replay it through Source -> SLAM -> Sink (``run_session``, the
     ``Perception`` pipeline in mapping mode, in a process of its own:
     ``tools/campaign_session.py``), score it against ground truth, save
     the map;
  3. session B (offset start, fewer laps), likewise;
  4. merge A and B: cross edges found by ScanContext and ICP, the joint
     graph solved by ``parallel/schur_pgo.py:optimize_schur`` over a mesh
     (``merge_distributed``): over NCCL ranks, one per card, up to 8, on a
     host with two cards or more; else in a subprocess on 8 gloo ranks of
     the CPU (``tools/campaign_merge.py``);
  5. optionally, session A through the reference FAST-LIO2 binary of
     ``baseline_ref/`` (odometry only; ``run_reference_odometry``).

Usage:
  python -m lsd_tpu_torch.tools.campaign [--laps 5.5] [--points 16384]
      [--out DIR] [--skip-reference] [--small] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from ..utils.device import DeviceLike

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
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


def run_reference_odometry(sim, tmpdir: str) -> Optional[Dict]:
    """The same session through the reference FAST-LIO2 binary of
    ``baseline_ref/`` (odometry only: the baseline driver has no loop
    closure): dict(ate_m, per_scan_ms), or None where the binary is missing
    and cannot be built, or fails.  Cached per ``tmpdir``: the binary's
    result does not depend on the port."""
    cache = os.path.join(tmpdir, "reference_odometry.json")
    if os.path.exists(cache):
        with open(cache) as fh:
            return json.load(fh)
    bin_path = os.path.join(REPO, "baseline_ref", "fastlio_baseline")
    if not os.path.exists(bin_path):
        try:
            subprocess.run(["make", "-C", os.path.join(REPO, "baseline_ref")],
                           check=True, timeout=600, capture_output=True)
        except (OSError, subprocess.SubprocessError):
            return None
    from .export_replay import export_replay
    replay = os.path.join(tmpdir, "campaign_replay.bin")
    export_replay(replay, sim)
    traj = replay + ".traj.txt"
    try:
        out = subprocess.run([bin_path, replay, traj], check=True,
                             timeout=3600, capture_output=True, text=True)
    except (OSError, subprocess.SubprocessError):
        return None
    meas = json.loads(out.stdout.strip().splitlines()[-1])
    gt = np.load(replay + ".gt.npy")
    rows = np.loadtxt(traj)
    est = np.zeros((len(rows), 4, 4))
    est[:, :3] = rows[:, 1:].reshape(-1, 3, 4)
    est[:, 3, 3] = 1
    res = dict(ate_m=round(_ate(est, gt, 27), 4), per_scan_ms=float(meas["per_scan_ms"]))
    with open(cache, "w") as fh:
        json.dump(res, fh)
    return res


def merge_distributed(mesh, map_a: str, map_b: str, out_dir: Optional[str],
                      progress=print) -> Dict:
    """Cross-session merge whose joint graph is solved by the distributed
    Schur solver over ``mesh``; a rank function: every rank of the mesh
    calls it with the same maps (``campaign_merge.merge_ranks`` starts
    them).  Rank 0 builds the joint graph as ``slam.map_merge.merge_maps``
    builds it (that solves it once on its device) and sends it to the
    other ranks, so that all solve one graph over the mesh.  Where the
    distributed float32 solve gives non-finite poses, the single-device
    solver redoes it (``single_host_fallback``).  Rank 0 saves the merged
    map into ``out_dir``."""
    from ..parallel.mesh import broadcast_object
    from ..parallel.schur_pgo import optimize_schur
    from ..slam.map_merge import merge_maps
    from ..slam.posegraph import PgoConfig, optimize

    joint = None
    if mesh.rank == 0:
        res = merge_maps(map_a, map_b, out_dir=None, device=mesh.device)
        joint = dict(builder=res["builder"], n_a=res["n_a"], n_b=res["n_b"],
                     cross_edges=len(res["cross_edges"]))
    joint = broadcast_object(mesh, joint)
    b = joint["builder"]
    g = b.to_data(device=mesh.device)
    cfg = PgoConfig(outer_iters=8, cg_iters=80)
    t0 = time.perf_counter()
    g2, info = optimize_schur(g, mesh, cfg)
    pos, quat = g2.nodes.pos.cpu().numpy(), g2.nodes.quat.cpu().numpy()
    dt = time.perf_counter() - t0
    fallback = not (np.isfinite(pos).all() and np.isfinite(quat).all())
    if fallback:
        progress("campaign: Schur produced non-finite poses; "
                 "falling back to single-device optimize")
        g2, _ = optimize(g, cfg)
    b.update_from(g2)
    if out_dir and mesh.rank == 0:
        from ..geometry import np_so3
        from ..slam.map_io import load_map, save_map
        da, db_ = load_map(map_a), load_map(map_b)
        stamps = list(da["stamps"]) + list(db_["stamps"])
        clouds = list(da["clouds"]) + list(db_["clouds"])
        poses = [b.node_pose(k).astype(float) for k in range(b.num_nodes)]
        edges_out = []
        for (i, j, q, t, si) in b.se3:
            T = np.eye(4)
            T[:3, :3] = np_so3.quat_to_matrix(np.asarray(q))
            T[:3, 3] = t
            edges_out.append((i, j, T, np.asarray(si[:6]) ** 2))
        save_map(out_dir, da.get("origin") if da.get("origin") is not None
                 else np.zeros(3), stamps, poses, clouds, edges_out, fixed=[0])
    return dict(n_a=joint["n_a"], n_b=joint["n_b"], cross_edges=joint["cross_edges"],
                schur_devices=int(mesh.size),
                schur_wall_s=round(dt, 2),
                schur_compile_plus_first_round_s=info.get("compile_plus_first_round_s"),
                schur_solve_round_ms=info.get("solve_round_ms"),
                schur_solve_total_s=info.get("solve_total_s"),
                single_host_fallback=fallback,
                builder=b, info=info)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "lsd_campaign"))
    ap.add_argument("--laps", type=float, default=5.5)
    ap.add_argument("--laps-b", type=float, default=2.0)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--speed", type=float, default=5.0)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny smoke-scale run (testing)")
    ap.add_argument("--repeat-a", type=int, default=1,
                    help="run session A this many consecutive times; every "
                         "run's metrics are recorded under session_a_runs")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the sessions and the merge (default: the "
                         "card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    if args.small:
        args.laps, args.laps_b, args.points, args.radius = 1.0, 0.6, 4096, 12.0

    os.makedirs(args.out, exist_ok=True)
    results: Dict = dict(config=dict(laps=args.laps, points=args.points,
                                     radius=args.radius, speed=args.speed))

    def mksim(seed, laps):
        return make_sim(seed, laps, radius=args.radius, speed=args.speed,
                        points=args.points)

    def run_session_isolated(rec_root, rec, map_dir, name, laps, t_start=0.0):
        """A session replay in a process of its own, with a hard timeout
        and one retry: a hung session is killed, not the campaign."""
        jout = os.path.join(args.out, f"session_{name}.json")
        budget = int(max(1800, len(rec["gt"]) * 0.5) + 600)
        cmd = [sys.executable, "-m", "lsd_tpu_torch.tools.campaign_session",
               "--rec-root", rec_root, "--map-dir", map_dir,
               "--name", name, "--t-start", str(t_start),
               "--laps", str(laps), "--radius", str(args.radius),
               "--speed", str(args.speed), "--points", str(args.points),
               "--json-out", jout]
        if args.device:
            cmd += ["--device", args.device]
        for attempt in (1, 2):
            try:
                subprocess.run(cmd, timeout=budget, cwd=REPO, check=True)
                with open(jout) as fh:
                    return json.load(fh)
            except (OSError, subprocess.SubprocessError, ValueError) as exc:
                print(f"campaign: session {name} attempt {attempt} "
                      f"failed: {exc!r}", flush=True)
        return dict(name=name, error="session failed twice")

    t0 = time.time()
    print("campaign: generating session A recording...", flush=True)
    sim_a = mksim(7, args.laps)
    rec_root_a = os.path.join(args.out, "recA")
    rec_a = make_recording(sim_a, rec_root_a, capacity=args.points,
                           progress=lambda m: print("campaign:", m, flush=True))
    print(f"campaign: session A recorded ({len(rec_a['gt'])} scans, "
          f"{time.time() - t0:.0f}s)", flush=True)

    map_a = os.path.join(args.out, "mapA")
    runs_a = []
    for rep in range(max(1, args.repeat_a)):
        r = run_session_isolated(rec_root_a, rec_a, map_a, "A", args.laps)
        runs_a.append(r)
        print(f"campaign: A (run {rep + 1}/{args.repeat_a}):", json.dumps(r), flush=True)
    results["session_a"] = runs_a[-1]
    if len(runs_a) > 1:
        results["session_a_runs"] = [
            dict(scans_per_sec=r.get("scans_per_sec"), wall_s=r.get("wall_s"),
                 ate_map_m=r.get("ate_map_m"), loops=r.get("loops"),
                 keyframes=r.get("keyframes"))
            for r in runs_a]

    # session B: the same world (same seed), started half a lap in, on the
    # far lobe, mid-motion
    print("campaign: generating session B recording...", flush=True)
    sim_b = mksim(7, args.laps_b)
    t_off = (2 * np.pi * args.radius) / args.speed
    n_b = int(4 * np.pi * args.radius * args.laps_b / args.speed * sim_b.cfg.scan_hz)
    rec_root_b = os.path.join(args.out, "recB")
    rec_b = make_recording(sim_b, rec_root_b, t_start=t_off, capacity=args.points,
                           n_scans=n_b, progress=lambda m: print("campaign:", m, flush=True))
    map_b = os.path.join(args.out, "mapB")
    results["session_b"] = run_session_isolated(rec_root_b, rec_b, map_b, "B", args.laps_b,
                                                t_start=t_off)
    print("campaign: B:", json.dumps(results["session_b"]), flush=True)

    # the distributed merge, and the merged map's accuracy against ground
    # truth.  The Schur solver needs a mesh: NCCL ranks, one per card, where
    # the host has two cards or more; else 8 gloo ranks of the CPU in a
    # subprocess
    print("campaign: merging A+B (distributed Schur)...", flush=True)
    try:
        import torch
        merged_dir = os.path.join(args.out, "merged")
        merge_json = os.path.join(args.out, "merge.json")
        n_cards = torch.cuda.device_count()
        if args.device != "cpu" and n_cards >= 2:
            from .campaign_merge import merge_ranks
            results["merge"] = merge_ranks(map_a, map_b, merged_dir, min(n_cards, 8), "nccl")
        else:
            subprocess.run([sys.executable, "-m", "lsd_tpu_torch.tools.campaign_merge",
                            map_a, map_b, merged_dir, merge_json],
                           check=True, timeout=3600, cwd=REPO)
            with open(merge_json) as fh:
                results["merge"] = json.load(fh)
        # score the saved merged map (either path)
        from ..slam.map_io import load_map
        md = load_map(merged_dir)
        ts_to_gt = {int(t): T for t, T in zip(rec_a["ts_us"], rec_a["gt"])}
        ts_to_gt.update({int(t): T for t, T in zip(rec_b["ts_us"], rec_b["gt"])})
        est, gts = [], []
        n_dropped = 0
        for s, T in zip(md["stamps"], md["poses"]):
            if int(s) in ts_to_gt:
                T = np.asarray(T, float)
                if not np.isfinite(T).all():
                    n_dropped += 1
                    continue
                est.append(T)
                gts.append(ts_to_gt[int(s)])
        if n_dropped:
            results["merge"]["nonfinite_poses"] = n_dropped
        if len(est) > 10:
            results["merge"]["ate_merged_m"] = round(_ate(np.stack(est), np.stack(gts), 2), 4)
            results["merge"]["abs_merged_rmse_m"] = round(
                _abs_err(np.stack(est), np.stack(gts), 2), 4)
            results["merge"]["merged_nodes_scored"] = len(est)
    except Exception as exc:       # the campaign reports a failed merge and goes on
        import traceback
        traceback.print_exc()
        results["merge"] = dict(error=repr(exc))
    print("campaign: merge:", json.dumps(results["merge"]), flush=True)

    if not args.skip_reference:
        print("campaign: reference odometry baseline...", flush=True)
        ref = run_reference_odometry(mksim(7, args.laps), args.out)
        results["reference_odometry"] = ref
        print("campaign: ref:", json.dumps(ref), flush=True)

    results["total_wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(results, default=str))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(results, fh, indent=2, default=str)
    return results


if __name__ == "__main__":
    main()
