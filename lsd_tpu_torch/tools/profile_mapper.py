"""Where the time of the mapping path goes on the card.

    python -m lsd_tpu_torch.tools.profile_mapper [--scans 40] [--out profile_mapper_out]

Runs ``Mapper`` as ``chip_smoke.py`` drives it (``profile_lio.mapping_run``:
95 ``CircleSim`` scans of 32,768 points 1.2 times round an 8 m circle, the
LIO at ``bench.py``'s size, a keyframe every 1.5 m, PGO every 8 keyframes,
graph work synchronous).  The last ``--scans`` scans are the window: all
but its last six run under ``torch.profiler`` (host and device), the last
six have their host syncs counted; the scans before it run untraced.  The
default window covers the second pass of the start of the circle, where
loops are found, verified and optimized.  It prints, and writes as JSON:

- wall ms per scan (host clock, ending in a synchronize), the device's busy
  ms per scan and its idle share, kernel launches per scan;
- each ``lio_step/*`` and ``mapper/*`` span's calls per scan, host ms and
  kernel launches, per scan and per call;
- the kernels and the host-side operators that take the most time;
- the host syncs of the traced window's last six scans by source line,
  split into keyframe scans and the others;
- keyframes, loops and ``loop_stats`` at the end.

It needs a card; it has no CPU path.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..slam.mapper import Mapper
from ..utils.device import resolve_device
from .profile_lio import MAPPING_SCANS, _card, mapping_run, sync_sites, trace_report

SPANS = ("lio_step/", "mapper/")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--out", default="profile_mapper_out")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    n_all = MAPPING_SCANS
    if not 6 < args.scans <= n_all:
        ap.error(f"--scans must be between 7 and {n_all}")
    warm = n_all - args.scans
    _, data, nav0, cfg = mapping_run(dev, n_all)
    cap = data[0][0].shape[0]
    mapper = Mapper(cfg, nav0)

    def step(k):
        return mapper.process_scan(*data[k][:5], stamp_us=int(k * 1e5))

    for k in range(warm):
        step(k)
    torch.cuda.synchronize()
    n = args.scans - 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(warm, warm + n):
            step(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = {"keyframe": [], "other": []}
    sites_all = {}
    for k in range(warm + n, n_all):
        out, sites = sync_sites(lambda: step(k))
        syncs["keyframe" if out["is_keyframe"] else "other"].append(sum(sites.values()))
        for site, c in sites.items():
            sites_all[site] = sites_all.get(site, 0) + c
    report = dict(card=_card(), warm_scans=warm, scans=n, points_per_scan=cap,
                  **trace_report(prof, n, wall, SPANS),
                  host_syncs_per_scan={k: (float(np.mean(v)) if v else None)
                                       for k, v in syncs.items()},
                  host_sync_sites_over_6_scans=sites_all,
                  keyframes=len(mapper.store), loops=len(mapper.loops),
                  loop_stats=mapper.loop_stats)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_mapper.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
