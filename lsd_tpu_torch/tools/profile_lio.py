"""Where the time of one LIO scan step goes on the card.

    python -m lsd_tpu_torch.tools.profile_lio [--scans 10] [--out profile_lio_out]

Runs ``lio_step`` at ``bench.py``'s size (32,768-point ``CircleSim`` scans,
``ds_capacity=16384``, ``map_capacity=2**18``, 0.4 m voxels,
``max_iters=4``), warms up, then traces ``--scans`` scans with
``torch.profiler`` (host and device).  It prints, and writes as JSON with
(with ``--trace``) the Chrome trace beside it:

- wall ms per scan (host clock, ending in a synchronize), the device's
  busy ms per scan (the sum of its kernel times; one stream, so they do
  not overlap) and its idle share;
- each ``lio_step/*`` span's host ms and kernel launches per scan;
- the kernels and the host-side operators that take the most time;
- the host syncs of one scan, by the source line that caused them, less
  those the sync check reports around no work at all.

It needs a card; it has no CPU path.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..geometry import so3
from ..sim import CircleSim, SimConfig
from ..slam.lio import LioConfig, lio_init, lio_step
from ..slam.state import init_state
from ..utils.device import resolve_device

SPAN = "lio_step/"
BENCH_CFG = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                      scan_voxel=0.4, map_voxel=0.4, max_iters=4)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def _sync_sites(fn) -> dict:
    """Host syncs while fn() runs, counted by the innermost line of this
    package on the stack when each happened."""
    sites = collections.Counter()
    pkg = str(Path(__file__).resolve().parent.parent)

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)
                  and not f.filename.endswith("profile_lio.py")]
        f = frames[-1] if frames else None
        sites[f"{Path(f.filename).name}:{f.lineno}" if f else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sites.most_common())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--out", default="profile_lio_out")
    ap.add_argument("--trace", action="store_true",
                    help="also write the Chrome trace (tens of MB per scan)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    cap = 2 ** 15
    sim = CircleSim(SimConfig(n_scans=args.warm + args.scans + 1, points_per_scan=cap,
                              point_noise=0.01, seed=7))
    data = sim.generate(capacity=cap, imu_capacity=16)
    scans = [tuple(torch.as_tensor(a, device=dev) for a in d[:5]) for d in data]
    R, p = sim.pose(0.0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    nav0 = init_state(device=dev)._replace(pos=f(p), quat=so3.matrix_to_quat(f(R)),
                                           vel=f(sim.velocity(0.0)))
    cfg = BENCH_CFG
    st = lio_init(cfg, nav0)
    for scan in scans[:args.warm]:
        st, _ = lio_step(cfg, st, *scan)
    torch.cuda.synchronize()

    traced = scans[args.warm:args.warm + args.scans]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan in traced:
            st, _ = lio_step(cfg, st, *scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(traced)
    sync_sites = _sync_sites(lambda: lio_step(cfg, st, *scans[-1]))
    # what turning the sync check on and off reports with no work between
    empty_sites = _sync_sites(lambda: None)

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.key_averages()
    # the spans also appear on the device as annotations covering their
    # range; they are not kernels
    kernels = sorted((e for e in events if e.device_type == cuda
                      and not e.key.startswith(SPAN)),
                     key=lambda e: -e.self_device_time_total)
    dev_total = sum(e.self_device_time_total for e in kernels)
    host_ops = sorted((e for e in events if e.device_type == cpu
                       and not e.key.startswith(SPAN)),
                      key=lambda e: -e.self_cpu_time_total)[:25]
    # host time and kernel launches inside each span
    raw = prof.events()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in raw
              if e.device_type == cpu and e.name.startswith(SPAN)]
    spans = collections.defaultdict(lambda: dict(host_ms=0.0, launches=0.0))
    for name, a, b in ranges:
        spans[name]["host_ms"] += (b - a) / 1e3 / n
    for e in raw:
        if e.name == "cudaLaunchKernel":
            for name, a, b in ranges:
                if a <= e.time_range.start <= b:
                    spans[name]["launches"] += 1.0 / n
    wall_ms = wall / n * 1e3
    busy_ms = dev_total / 1e3 / n
    report = dict(
        card=_card(), scans=n, points_per_scan=cap,
        wall_ms_per_scan=wall_ms, device_busy_ms_per_scan=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches_per_scan=sum(e.count for e in kernels) / n,
        spans=dict(spans),
        kernels=[dict(name=e.key[:120], calls_per_scan=e.count / n,
                      device_ms_per_scan=e.self_device_time_total / 1e3 / n)
                 for e in kernels[:25]],
        host_ops=[dict(name=e.key, calls_per_scan=e.count / n,
                       self_host_ms_per_scan=e.self_cpu_time_total / 1e3 / n)
                  for e in host_ops],
        host_syncs_per_scan=sum(sync_sites.values()) - sum(empty_sites.values()),
        host_sync_sites=sync_sites, host_sync_sites_of_no_work=empty_sites,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_lio.json").write_text(json.dumps(report, indent=1))
    if args.trace:
        prof.export_chrome_trace(str(out / "profile_lio_trace.json"))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
