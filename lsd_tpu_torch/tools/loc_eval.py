"""Localization-mode accuracy table on the port (counterpart of
``lsd_tpu/tools/loc_eval.py``).

Long localization run against a saved map, in the reference's published
evaluation format (max/RMSE X, Y, heading vs INS ground truth): replay a
NEW session over the mapped world through the FULL pipeline in
localization mode (global reloc -> NDT/ICP tracking + UKF fusion) on the
card, with a GNSS dropout window, and score the published fused poses
against ground truth.  ``build_map`` makes the map first with the mapping
pipeline (``tools/campaign.py:run_session``).

A replay whose frames stop coming for ``campaign.STALL_S`` seconds is
scored as far as it got, as ``run_session`` does, instead of waiting for
the reference's wall-clock deadline.

Usage:
  python -m lsd_tpu_torch.tools.loc_eval --map MAP_DIR [--build-map]
      [--world fig8|route] [--laps 1.2] [--dropout 60:120] [--out loc_eval.json]
      [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from ..utils.device import DeviceLike, resolve_device


def _make_sim(world: str, laps: float, radius: float, speed: float,
              points: int, gps_noise: float, gps_outlier_rate: float):
    from ..sim import FigureEightSim, RouteSim, SimConfig

    if world == "route":
        # distinctive world: asymmetric rounded-rectangle route, no
        # self-similar twin branches — the regime of the reference's
        # published table
        probe = RouteSim(SimConfig(radius=radius, n_scans=1,
                                   points_per_scan=64, seed=7), laps=laps)
        lap_len = probe._lap_length()
        n = int((1.5 + 2.0 + lap_len * laps / speed) * 10)
        sim = RouteSim(
            SimConfig(radius=radius, speed=speed, points_per_scan=points,
                      point_noise=0.01, rest_time=1.5, ramp_time=2.0,
                      seed=7, n_scans=n),
            laps=laps, gps_noise=gps_noise,
            gps_outlier_rate=gps_outlier_rate, gps_hz=10.0)
        return sim, lap_len
    n = int((1.5 + 2.0 + 4 * np.pi * radius * laps / speed) * 10)
    sim = FigureEightSim(
        SimConfig(radius=radius, speed=speed, points_per_scan=points,
                  point_noise=0.01, rest_time=1.5, ramp_time=2.0, seed=7,
                  n_scans=n),
        laps=laps, gps_noise=gps_noise,
        gps_outlier_rate=gps_outlier_rate, gps_hz=10.0)
    return sim, 4 * np.pi * radius


def build_map(map_dir: str, world: str = "route", radius: float = 30.0,
              speed: float = 5.0, points: int = 16384,
              out_root: Optional[str] = None, progress=print,
              device: DeviceLike = None) -> Dict:
    """Map the eval world with the FULL mapping pipeline (LIO + keyframing +
    loops + PGO + save, ``campaign.run_session``) on ``device``, so the
    localization eval runs against a map made the way the reference's is
    (a prior mapping session)."""
    from .campaign import make_recording, run_session

    out_root = out_root or os.path.join(tempfile.gettempdir(), "lsd_loc_eval_map")
    map_laps = 1.15                      # close the loop + margin
    sim, lap_len = _make_sim(world, map_laps, radius, speed, points,
                             gps_noise=0.02, gps_outlier_rate=0.0)
    n_scans = int((1.5 + 2.0 + lap_len * map_laps / speed) * 10)
    rec = make_recording(sim, os.path.join(out_root, "rec_map"),
                         t_start=0.0, capacity=points, n_scans=n_scans,
                         progress=lambda m: progress("build_map: " + m))
    metrics = run_session(rec, map_dir, sim, f"{world}-map", t_start=0.0,
                          progress=lambda m: progress("build_map: " + m),
                          device=device)
    progress(f"build_map: done {metrics}")
    return metrics


def run(map_dir: str, laps: float = 1.2, radius: float = 30.0,
        speed: float = 5.0, points: int = 16384,
        dropout=(60.0, 120.0), out_root: Optional[str] = None,
        lio_fusion: bool = True, world: str = "fig8",
        gps_noise: float = 0.05, gps_outlier_rate: float = 0.02,
        progress=print, device: DeviceLike = None) -> Dict:
    from ..runtime import clear_interfaces
    from ..runtime.interface import call_interface
    from .campaign import STALL_S, make_recording, session_perception

    out_root = out_root or os.path.join(tempfile.gettempdir(), "lsd_loc_eval")
    # session over the SAME world (same seed), offset phase so it is not
    # the mapping trajectory
    sim, lap_len = _make_sim(world, laps, radius, speed, points,
                             gps_noise, gps_outlier_rate)
    t_off = lap_len / 4.0 / speed             # quarter-lap phase offset
    n_scans = int(lap_len * laps / speed * 10)
    progress(f"loc_eval: recording {n_scans} scans...")
    rec = make_recording(sim, os.path.join(out_root, "rec"), t_start=t_off,
                         capacity=points, n_scans=n_scans,
                         progress=lambda m: progress("loc_eval: " + m))

    # inject the GNSS dropout window (strip ins fixes in [t0, t1]);
    # dropout=None = continuous GNSS (the reference-table regime)
    removed = 0
    if dropout is not None:
        for k in range(n_scans):
            t = k * 0.1
            if dropout[0] <= t <= dropout[1]:
                path = os.path.join(rec["log_dir"], "%06d.pkl" % k)
                with open(path, "rb") as fh:
                    d = pickle.load(fh)
                if d.get("ins_valid"):
                    d["ins_valid"] = False
                    d["ins_data"] = {}
                    with open(path, "wb") as fh:
                        pickle.dump(d, fh,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                    removed += 1
        progress(f"loc_eval: dropped {removed} fixes in t=[{dropout[0]},"
                 f"{dropout[1]}]s")

    p = session_perception(device, rec["log_dir"],
                           dict(mode="localization", map_path=map_dir,
                                lio_fusion=bool(lio_fusion)))
    slam_mod = p.module_manager.modules["SLAM"]
    eng = slam_mod.engine

    # per-frame fused poses: sample the module's published pose by
    # timestamp (the same surface slam.get_pose serves)
    poses: Dict[int, np.ndarray] = {}
    tracking: Dict[int, bool] = {}
    orig_process = slam_mod.process

    def tap(d):
        out = orig_process(d)
        ts = d.get("frame_start_timestamp")
        if out is not None and ts is not None:
            poses[int(ts)] = np.asarray(slam_mod.last_pose, float).copy()
            # tracked vs fallback/reloc frames: the reference's published
            # table assumes continuous localization, so the tracked-only
            # slice is the comparable number
            tracking[int(ts)] = bool(getattr(eng, "initialized", False))
        return out
    slam_mod.process = tap

    t0 = time.time()
    p.start()
    call_interface("player.set_rate", 1000.0)
    deadline = time.time() + max(1800.0, n_scans * 0.3)
    last_n, last_change = 0, time.time()
    while time.time() < deadline and len(poses) < n_scans - 2:
        time.sleep(2.0)
        if len(poses) != last_n:
            last_n, last_change = len(poses), time.time()
        elif time.time() - last_change > STALL_S:
            progress(f"loc_eval: STALLED at {last_n}/{n_scans} frames")
            break
        if int(time.time() - t0) % 60 < 2:
            progress(f"loc_eval: {len(poses)}/{n_scans} frames, "
                     f"initialized={getattr(eng, 'initialized', None)}")
    wall = time.time() - t0
    p.release()
    clear_interfaces()

    # score vs ground truth (reference table: max/RMSE X, Y, heading)
    ts_to_gt = {int(t): T for t, T in zip(rec["ts_us"], rec["gt"])}
    ex, ey, eh, et, etrk = [], [], [], [], []
    init_ts = None
    for ts, T in sorted(poses.items()):
        if int(ts) not in ts_to_gt:
            continue
        gt = ts_to_gt[int(ts)]
        if np.allclose(T, np.eye(4)) and init_ts is None:
            continue                      # not yet relocalized
        if init_ts is None:
            init_ts = ts
        if ts - init_ts < 3_000_000:      # settle window after reloc
            continue
        d = T[:3, 3] - gt[:3, 3]
        yaw_e = np.degrees(np.arctan2(T[1, 0], T[0, 0])
                           - np.arctan2(gt[1, 0], gt[0, 0]))
        yaw_e = (yaw_e + 180.0) % 360.0 - 180.0
        ex.append(abs(d[0]))
        ey.append(abs(d[1]))
        eh.append(abs(yaw_e))
        et.append(ts)
        etrk.append(bool(tracking.get(int(ts), False)))
    ex, ey, eh = map(np.asarray, (ex, ey, eh))
    etrk_a = np.asarray(etrk, bool) if etrk else np.zeros(0, bool)
    rmse = lambda a: float(np.sqrt(np.mean(a ** 2))) if len(a) else None
    mx = lambda a: float(np.max(a)) if len(a) else None
    # dropout-window slice
    if dropout is not None:
        t0_us = 1_000_000 + int((t_off + dropout[0]) * 1e6)
        t1_us = 1_000_000 + int((t_off + dropout[1]) * 1e6)
        in_drop = [(t0_us <= t <= t1_us) for t in et]
        in_drop = np.asarray(in_drop, bool) if len(et) else np.zeros(0, bool)
    else:
        in_drop = np.zeros(len(et), bool)
    report = dict(
        frames_scored=len(ex), wall_s=round(wall, 1),
        reloc_latency_frames=(None if init_ts is None else
                              int((init_ts - rec["ts_us"][0]) // 100_000)),
        max_x_m=round(mx(ex), 4) if len(ex) else None,
        rmse_x_m=round(rmse(ex), 4) if len(ex) else None,
        max_y_m=round(mx(ey), 4) if len(ey) else None,
        rmse_y_m=round(rmse(ey), 4) if len(ey) else None,
        max_heading_deg=round(mx(eh), 3) if len(eh) else None,
        rmse_heading_deg=round(rmse(eh), 3) if len(eh) else None,
        dropout_window_s=list(dropout) if dropout is not None else None,
        world=world,
        rmse_x_during_dropout_m=(round(rmse(ex[in_drop]), 4)
                                 if in_drop.any() else None),
        rmse_y_during_dropout_m=(round(rmse(ey[in_drop]), 4)
                                 if in_drop.any() else None),
        # tracked-only slice (excluding reloc/fallback frames) — the
        # number comparable to the reference's continuous-localization
        # table
        frames_tracking=int(etrk_a.sum()),
        tracking_fraction=round(float(etrk_a.mean()), 3)
        if len(etrk_a) else None,
        rmse_x_tracking_m=(round(rmse(ex[etrk_a]), 4)
                           if etrk_a.any() else None),
        rmse_y_tracking_m=(round(rmse(ey[etrk_a]), 4)
                           if etrk_a.any() else None),
        max_x_tracking_m=(round(mx(ex[etrk_a]), 4)
                          if etrk_a.any() else None),
        max_y_tracking_m=(round(mx(ey[etrk_a]), 4)
                          if etrk_a.any() else None),
        rmse_heading_tracking_deg=(round(rmse(eh[etrk_a]), 3)
                                   if etrk_a.any() else None),
        max_heading_tracking_deg=(round(mx(eh[etrk_a]), 3)
                                  if etrk_a.any() else None),
    )
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", required=True)
    ap.add_argument("--laps", type=float, default=1.2)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--speed", type=float, default=5.0)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--dropout", default="60:120",
                    help="GNSS dropout window t0:t1 seconds, or 'none'")
    ap.add_argument("--world", choices=("fig8", "route"), default="fig8",
                    help="fig8 = adversarial near-symmetric world; "
                         "route = distinctive rounded-rectangle world "
                         "(the reference-table regime)")
    ap.add_argument("--build-map", action="store_true",
                    help="map the world first (full mapping pipeline) "
                         "if --map does not exist yet")
    ap.add_argument("--gps-noise", type=float, default=None,
                    help="GNSS noise sigma (default: 0.05 fig8 / "
                         "0.02 route)")
    ap.add_argument("--gps-outliers", type=float, default=None,
                    help="GNSS gross-outlier rate (default: 0.02 fig8 / "
                         "0.0 route)")
    ap.add_argument("--lio-fusion", dest="lio_fusion", action="store_true",
                    default=True,
                    help="side-running LIO odometry fusion (the default)")
    ap.add_argument("--no-lio-fusion", dest="lio_fusion",
                    action="store_false",
                    help="const-velocity/IMU prediction instead")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    dropout = (None if args.dropout.lower() in ("none", "off", "")
               else tuple(float(x) for x in args.dropout.split(":")))
    gps_noise = (args.gps_noise if args.gps_noise is not None
                 else (0.02 if args.world == "route" else 0.05))
    gps_outliers = (args.gps_outliers if args.gps_outliers is not None
                    else (0.0 if args.world == "route" else 0.02))
    if args.build_map and not os.path.isdir(
            os.path.join(args.map, "graph")):
        build_map(args.map, world=args.world, radius=args.radius,
                  speed=args.speed, points=args.points, device=device)
    out_root = os.path.join(tempfile.gettempdir(),
                            "lsd_loc_eval" if args.world == "fig8"
                            else f"lsd_loc_eval_{args.world}")
    report = run(args.map, args.laps, args.radius, args.speed, args.points,
                 dropout, out_root=out_root, lio_fusion=args.lio_fusion,
                 world=args.world, gps_noise=gps_noise,
                 gps_outlier_rate=gps_outliers, device=device)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
