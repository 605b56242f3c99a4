"""Robustness / parity evaluation harness on the port (counterpart of
``lsd_tpu/tools/evaluate.py``).

Runs the port's LIO (cold start — no ground-truth seeding) on the card and,
when the baseline binary can be had, the REFERENCE FAST-LIO2 C++ build
(baseline_ref/) over the same simulated scenarios, and reports ATE RMSE +
per-scan latency side by side, in the reference's table (its ``tpu_*``
columns are the port's run here).

Scenarios:
    circle        nominal loop (rest + spin-up + cruise), cold start
    high_yaw      aggressive rotation (1.0 rad/s, tight radius)
    corridor      long corridor with door frames (mild degeneracy)
    tunnel        smooth corridor, no features (severe degeneracy along x),
                  then again with the wheelspeed velocity observation
    imu_bias      gyro + accel bias (filter must absorb via bias states)

The per-scan time includes the step's own host syncs and one fetch of the
pose and the degenerate-direction count.  The reference's compile-cache
settings and its TPU session keep-alive have no counterpart here: a run
builds the fused reduction's kernel once, at its first scan.

Usage:  python -m lsd_tpu_torch.tools.evaluate [--out EVAL.md] [--scans N]
            [--skip-reference] [--cpu]
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np

from ..utils.device import DeviceLike, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def scenarios(n_scans: int, cap: int):
    from ..sim import CircleSim, CorridorSim, SimConfig
    base = dict(n_scans=n_scans, points_per_scan=cap, point_noise=0.01,
                seed=7, rest_time=1.5, ramp_time=1.0)
    return {
        "circle": CircleSim(SimConfig(**base)),
        "high_yaw": CircleSim(SimConfig(**{**base, "omega": 1.0,
                                           "radius": 4.0, "ramp_time": 2.0})),
        "corridor": CorridorSim(SimConfig(**base)),
        "tunnel": CorridorSim(SimConfig(**{**base, "feature_density": 0.0})),
        "imu_bias": CircleSim(SimConfig(**{**base,
                                           "gyro_bias": (0.002, -0.001, 0.003),
                                           "acc_bias": (0.002, 0.001, -0.002)})),
    }


def _ate(est_T: np.ndarray, gt_T: np.ndarray, warmup: int) -> float:
    """Standard Umeyama-aligned ATE RMSE, applied identically to both
    stacks."""
    from ..utils.metrics import ate_rmse
    return ate_rmse(est_T, gt_T, warmup)


def run_tpu_lio(sim, data, warmup: int, wheelspeed: bool = False,
                device: DeviceLike = None, **cfg_over):
    """Cold-start LIO of the port on ``device`` (the card unless the caller
    names another) over the scenario; returns (ate, ms_per_scan,
    max_degen).  wheelspeed=True feeds the per-scan velocity observation
    (ref laserMapping.cpp:794-812 h_share_model_wheelspeed)."""
    import torch

    from ..slam import LioConfig, lio_init, lio_step
    from ..utils.device import fetch, to_device
    from ..utils.precision import set_slam_precision

    dev = resolve_device(device)
    set_slam_precision()
    cfg = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                    scan_voxel=0.4, map_voxel=0.4, max_iters=4, **cfg_over)
    st = lio_init(cfg, device=dev)    # cold start: identity, zero velocity
    poses, degen = [], []
    t_used = 0.0
    n_timed = 0
    period = 1.0 / sim.cfg.scan_hz
    valid = torch.ones((), dtype=torch.bool, device=dev)
    for k, (P, S, M, I, IM, _T) in enumerate(data):
        vkw = {}
        if wheelspeed:
            vel = sim.velocity((k + 1) * period).astype(np.float32)
            vkw = dict(vel_obs=to_device(vel, dev), vel_obs_valid=valid)
        t0 = time.perf_counter()
        st, info = lio_step(cfg, st, *(to_device(a, dev) for a in (P, S, M, I, IM)), **vkw)
        # ONE fetch per scan (pose and count packed into one copy): each
        # fetch waits for the card, and more than one would time the waits
        pose, n_deg = fetch(info["pose"], info["n_degenerate"])
        pose = np.asarray(pose, float)
        if k >= warmup:
            t_used += time.perf_counter() - t0
            n_timed += 1
        poses.append(pose)
        degen.append(int(n_deg))
    est = np.stack(poses)
    gt = np.stack([d[5] for d in data])
    return (_ate(est, gt, warmup), 1e3 * t_used / max(n_timed, 1),
            int(max(degen[warmup:])))   # post-warmup (first scans gate all)


def _reference_sources() -> Optional[str]:
    """The reference C++ tree that baseline_ref/Makefile builds from (its
    ``REF``), where it exists."""
    try:
        with open(os.path.join(REPO, "baseline_ref", "Makefile")) as fh:
            m = re.search(r"^REF\s*:=\s*(\S+)", fh.read(), re.M)
    except OSError:
        return None
    return m.group(1) if m and os.path.isdir(m.group(1)) else None


def run_reference(sim, warmup: int, tmpdir: str, name: str):
    """Export the scenario and run the reference FAST-LIO2 binary; returns
    (ate, ms_per_scan) or None where the binary is missing and its sources
    are not there to build it, or it fails."""
    bin_path = os.path.join(REPO, "baseline_ref", "fastlio_baseline")
    if not os.path.exists(bin_path):
        if _reference_sources() is None:
            return None
        try:
            subprocess.run(["make", "-C", os.path.join(REPO, "baseline_ref")],
                           check=True, timeout=600, capture_output=True)
        except (OSError, subprocess.SubprocessError):
            return None
    from .export_replay import export_replay
    replay = os.path.join(tmpdir, f"replay_{name}.bin")
    export_replay(replay, sim)
    traj = replay + ".traj.txt"
    try:
        out = subprocess.run([bin_path, replay, traj, str(warmup)],
                             check=True, timeout=900, capture_output=True,
                             text=True)
    except (OSError, subprocess.SubprocessError):
        return None
    meas = json.loads(out.stdout.strip().splitlines()[-1])
    gt = np.load(replay + ".gt.npy")
    rows = np.loadtxt(traj)
    est = np.zeros((len(rows), 4, 4))
    est[:, :3] = rows[:, 1:].reshape(-1, 3, 4)
    est[:, 3, 3] = 1
    return _ate(est, gt, warmup), float(meas["per_scan_ms"])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None, help="markdown output path")
    ap.add_argument("--scans", type=int, default=225)
    ap.add_argument("--points", type=int, default=2 ** 15)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--research-ablation", action="store_true",
                    help="also run each scenario with research_thresh=0 — "
                         "the sharded map-block step's semantics; the delta "
                         "is the accuracy cost of sharding")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (accuracy rows; the timings are "
                         "then the host's)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    warmup = 27          # rest (15) + ramp (10) + filter latch (2)
    rows = []
    tmpdir = os.path.join(tempfile.gettempdir(), "lsd_eval")
    os.makedirs(tmpdir, exist_ok=True)
    for name, sim in scenarios(args.scans, args.points).items():
        print(f"eval: {name}: generating...", flush=True)
        data = sim.generate(capacity=args.points, imu_capacity=16)
        print(f"eval: {name}: lio...", flush=True)
        ate, ms, max_degen = run_tpu_lio(sim, data, warmup, device=device)
        ate_nrs = None
        if args.research_ablation:
            print(f"eval: {name}: lio (no re-search)...", flush=True)
            ate_nrs, _, _ = run_tpu_lio(sim, data, warmup, device=device,
                                        research_thresh=0.0)
        ref = None
        if not args.skip_reference:
            print(f"eval: {name}: reference fastlio...", flush=True)
            ref = run_reference(sim, warmup, tmpdir, name)
        rows.append(dict(scenario=name, n_scans=len(data),
                         tpu_ate_m=round(ate, 4), tpu_ms=round(ms, 2),
                         max_degen_dirs=max_degen,
                         ref_ate_m=None if ref is None else round(ref[0], 4),
                         ref_ms=None if ref is None else round(ref[1], 2),
                         **({} if ate_nrs is None
                            else dict(tpu_ate_no_research_m=round(ate_nrs, 4)))))
        print("eval:", json.dumps(rows[-1]), flush=True)
        if name == "tunnel":
            # wheelspeed-enabled tunnel row: the velocity observation is
            # what keeps a featureless tunnel trackable; the ref column
            # carries the reference binary's UNAIDED run on the same input
            # (the exported replay has no wheelspeed channel)
            print("eval: tunnel + wheelspeed: lio...", flush=True)
            ate_w, ms_w, degen_w = run_tpu_lio(sim, data, warmup, wheelspeed=True,
                                               device=device)
            rows.append(dict(scenario="tunnel_wheelspeed",
                             n_scans=len(data),
                             tpu_ate_m=round(ate_w, 4),
                             tpu_ms=round(ms_w, 2),
                             max_degen_dirs=degen_w,
                             ref_ate_m=None if ref is None
                             else round(ref[0], 4),
                             ref_ms=None if ref is None
                             else round(ref[1], 2)))
            print("eval:", json.dumps(rows[-1]), flush=True)

    md = ["| scenario | scans | TPU ATE (m) | TPU ms/scan | degen dirs "
          "| ref ATE (m) | ref ms/scan |",
          "|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append("| {scenario} | {n_scans} | {tpu_ate_m} | {tpu_ms} | "
                  "{max_degen_dirs} | {ref_ate_m} | {ref_ms} |".format(**r))
    table = "\n".join(md)
    print(table)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(table + "\n")
    return rows


if __name__ == "__main__":
    main()
