"""Run one campaign session replay in a process of its own (counterpart
of ``lsd_tpu/tools/campaign_session.py``).

The campaign runs each session here, as a subprocess with a hard timeout,
so a hung session cannot freeze the whole campaign: the parent kills the
expired child and keeps the sessions that finished.

Usage (``tools/campaign.py`` invokes it):
  python -m lsd_tpu_torch.tools.campaign_session --rec-root RECROOT \
      --map-dir MAP --name A --t-start 0.0 --laps 5.5 --radius 30 \
      --speed 5 --points 16384 --json-out OUT.json [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rec-root", required=True,
                    help="recording root (contains gt.npz + the log dir)")
    ap.add_argument("--map-dir", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--t-start", type=float, default=0.0)
    ap.add_argument("--laps", type=float, required=True)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--speed", type=float, default=5.0)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--json-out", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    import numpy as np

    from .campaign import make_sim, run_session

    z = np.load(os.path.join(args.rec_root, "gt.npz"))
    rec = dict(log_dir=str(z["log_dir"]), gt=z["gt"], ts_us=z["ts_us"])
    sim = make_sim(7, args.laps, radius=args.radius, speed=args.speed, points=args.points)
    metrics = run_session(rec, args.map_dir, sim, args.name, t_start=args.t_start,
                          progress=lambda m: print("campaign:", m, flush=True),
                          device=args.device)
    with open(args.json_out, "w") as fh:
        json.dump(metrics, fh)
    print("campaign-session:", json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
