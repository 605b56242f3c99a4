"""Factor-ablation diagnosis of a saved campaign map (graph debugging;
counterpart of ``lsd_tpu/tools/campaign_diag.py``, the solves on the card
unless ``--device`` names another).

Loads the saved map (keyframe poses + full SE3 edge set incl. loop edges
with their information), rebuilds the pose graph with node poses RESET to
the integrated odometry chain (consecutive SE3 edges), then optimizes
several factor subsets and scores each against the simulator ground
truth.  Separates "loop edges poison the graph" from "GNSS priors poison
the graph" from "the optimizer under-converges" in one offline pass — no
pipeline rerun.

Usage:
  python -m lsd_tpu_torch.tools.campaign_diag --map <map_dir> \
      [--laps 5.5] [--radius 30] [--speed 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..utils.device import DeviceLike, resolve_device


def rebuild(md, use_loops=True, keep_info=True):
    """Graph from saved edges; node poses = odometry-chain integration."""
    from ..slam.graph_builder import PoseGraphBuilder

    n = len(md["poses"])
    consec = {}
    loops = []
    for (i, j, T, var) in md["edges"]:
        if abs(i - j) == 1:
            consec[min(i, j)] = (i, j, T, var)
        else:
            loops.append((i, j, T, var))
    # integrate the odometry chain for initial node poses
    chain = [np.asarray(md["poses"][0], float)]
    for k in range(n - 1):
        if k in consec:
            i, j, T, var = consec[k]
            Trel = T if i == k else np.linalg.inv(T)
        else:
            # no consecutive edge (editor del-edge, or a merged-map
            # session boundary): fall back to the saved absolute poses'
            # relative transform so the diagnostic still rebuilds
            Trel = np.linalg.inv(np.asarray(md["poses"][k], float)) \
                @ np.asarray(md["poses"][k + 1], float)
        chain.append(chain[-1] @ Trel)
    b = PoseGraphBuilder()
    for k in range(n):
        b.add_node(chain[k], fixed=(k == 0))
    for (i, j, T, var) in consec.values():
        b.add_se3_edge(i, j, T, rot_info=400.0, trans_info=400.0)
    if use_loops:
        for (i, j, T, var) in loops:
            info = 1.0 / np.maximum(np.asarray(var, float), 1e-12) \
                if keep_info else np.full(6, 100.0)
            b.add_se3_edge(i, j, T, rot_info=info[:3], trans_info=info[3:])
    return b, chain, loops


def gt_for_stamps(stamps_us, laps, radius, speed, points, seed=7):
    from ..sim import FigureEightSim, SimConfig
    n = int((1.5 + 2.0 + 4 * np.pi * radius * laps / speed) * 10)
    sim = FigureEightSim(
        SimConfig(radius=radius, speed=speed, points_per_scan=points,
                  point_noise=0.01, rest_time=1.5, ramp_time=2.0, seed=seed,
                  n_scans=n), laps=laps, gps_noise=0.05,
        gps_outlier_rate=0.02, gps_hz=10.0)
    period = 1.0 / sim.cfg.scan_hz
    out = []
    for ts in stamps_us:
        t0 = (int(ts) - 1_000_000) / 1e6          # recording epoch
        R, p = sim.pose(t0 + period)              # scan-end pose
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        out.append(T)
    return np.stack(out)


def score(b, gt):
    from ..utils.metrics import ate_rmse
    est = np.stack([b.node_pose(k).astype(float)
                    for k in range(b.num_nodes)])
    return ate_rmse(est, gt, warmup=2)


def diagnose(map_dir: str, laps: float = 5.5, radius: float = 30.0,
             speed: float = 5.0, points: int = 16384, cg: int = 50,
             outer: int = 6, device: DeviceLike = None) -> dict:
    """The ablation report of the map at ``map_dir``, whose world is the
    figure-eight of ``laps``, ``radius`` and ``speed``; the solves run on
    ``device`` (the card unless the caller asks for the CPU)."""
    from ..slam.map_io import load_map
    from ..slam.posegraph import PgoConfig, optimize
    from ..utils.metrics import ate_rmse

    dev = resolve_device(device)
    md = load_map(map_dir)
    gt = gt_for_stamps(md["stamps"], laps, radius, speed, points)
    report = dict(n_nodes=len(md["poses"]),
                  n_edges=len(md["edges"]),
                  saved_poses_ate_m=round(
                      ate_rmse(np.stack([np.asarray(T, float)
                                         for T in md["poses"]]), gt, 2), 4))

    def run(tag, use_loops, keep_info, outer, cg, dcs_phi=4.0):
        b, chain, loops = rebuild(md, use_loops, keep_info)
        ate0 = score(b, gt)
        data, info = optimize(b.to_data(device=dev),
                              PgoConfig(outer_iters=outer, cg_iters=cg,
                                        dcs_phi=dcs_phi))
        b.update_from(data)
        report[tag] = dict(ate_before_m=round(ate0, 4),
                           ate_after_m=round(score(b, gt), 4),
                           n_loops=len(loops) if use_loops else 0)
        print(tag, json.dumps(report[tag]), flush=True)

    run("odom_chain_only", False, True, outer, cg)
    run("odom_plus_loops_huber_only", True, True, outer, cg, dcs_phi=0.0)
    run("odom_plus_loops_dcs", True, True, outer, cg)
    run("odom_plus_loops_dcs_fixed_info", True, False, outer, cg)
    run("odom_plus_loops_dcs_3x_iters", True, True, outer * 3, cg * 2)

    # loop-edge ground-truth consistency: how wrong is each loop edge's
    # relative transform vs ground truth?  (the definitive poison test)
    _, chain, loops = rebuild(md, True, True)
    errs = []
    for (i, j, T, var) in loops:
        gt_rel = np.linalg.inv(gt[i]) @ gt[j]
        D = np.linalg.inv(T) @ gt_rel
        errs.append((np.linalg.norm(D[:3, 3]),
                     np.degrees(np.arccos(np.clip(
                         (np.trace(D[:3, :3]) - 1) / 2, -1, 1)))))
    if errs:
        e = np.asarray(errs)
        report["loop_edge_vs_gt"] = dict(
            n=len(e),
            trans_err_med_m=round(float(np.median(e[:, 0])), 4),
            trans_err_p95_m=round(float(np.percentile(e[:, 0], 95)), 4),
            trans_err_max_m=round(float(e[:, 0].max()), 4),
            rot_err_med_deg=round(float(np.median(e[:, 1])), 3),
            rot_err_p95_deg=round(float(np.percentile(e[:, 1], 95)), 3))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", required=True)
    ap.add_argument("--laps", type=float, default=5.5)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--speed", type=float, default=5.0)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--cg", type=int, default=50)
    ap.add_argument("--outer", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device of the solves (default: the card)")
    args = ap.parse_args(argv)
    report = diagnose(args.map, args.laps, args.radius, args.speed, args.points,
                      args.cg, args.outer, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
