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
- the host syncs of one scan, by the source line that caused them.

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
from ..slam.mapper import MapperConfig
from ..slam.state import init_state
from ..utils.device import resolve_device

SPAN = "lio_step/"
BENCH_CFG = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                      scan_voxel=0.4, map_voxel=0.4, max_iters=4)
MAPPING_SCANS = 95      # 1.2 times round mapping_run's circle: the loops close after ~80


def nav_at_start(sim, dev):
    """The navigation state of ``sim``'s first pose, on ``dev``."""
    R, p = sim.pose(0.0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return init_state(device=dev)._replace(pos=f(p), quat=so3.matrix_to_quat(f(R)),
                                           vel=f(sim.velocity(0.0)))


def mapping_run(dev, n_scans=MAPPING_SCANS, points=2 ** 15, lio=BENCH_CFG, **mapper_kw):
    """The mapping path that ``chip_smoke.py`` drives and ``profile_mapper``
    traces: (sim, scans as host arrays, nav0 on ``dev``, MapperConfig).  An
    8 m circle at 0.8 rad/s (the world of the reference's mapping test), the
    LIO at ``bench.py``'s size, a keyframe every 1.5 m, PGO every 8
    keyframes; ``mapper_kw`` sets further ``MapperConfig`` fields."""
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=n_scans, points_per_scan=points,
                              point_noise=0.01, seed=21))
    data = sim.generate(capacity=points, imu_capacity=16)
    cfg = MapperConfig(lio=lio, keyframe_delta_trans=1.5, optimize_every=8, **mapper_kw)
    return sim, data, nav_at_start(sim, dev), cfg


def localization_drive(sim, n_scans: int, points: int, t_start: float = 0.037,
                       rest_time: float = 1.0, ramp_time: float = 3.0):
    """The drive that ``chip_smoke.py`` and ``profile_localizer`` give the
    localizer on ``mapping_run``'s map: (drive sim, scans as host arrays
    with the truth at each scan's end, pose hint ~1 m off).  The same world
    as ``sim``'s (same seed and radius); the vehicle stands at the start of
    the mapped circle for ``rest_time`` s, speeds up over ``ramp_time`` s to
    the mapping run's rate and cruises.  It starts at rest because the
    localizer's side-running LIO cold-starts at the identity with no
    velocity: begun at 6.4 m/s it does not converge within its 10 warm-up
    scans, in either package, and its increments then carry the filter off
    the map (``tests/test_torch_localization_cruise.py``).  With both times 0
    the drive is the mapping run's own, at cruise from the first scan.
    ``t_start`` keeps the scans off the stamps the mapping run saw."""
    c = sim.cfg
    drive = CircleSim(SimConfig(radius=c.radius, omega=c.omega, n_scans=n_scans,
                                points_per_scan=points, point_noise=c.point_noise, seed=c.seed,
                                rest_time=rest_time, ramp_time=ramp_time))
    scans = drive.generate(capacity=points, imu_capacity=16, t_start=t_start)
    R, p = drive.pose(t_start)
    hint = np.eye(4)
    hint[:3, :3], hint[:3, 3] = R, p + np.asarray([0.8, -0.5, 0.1])
    return drive, scans, hint


def drive_localizer(loc, drive, scans, t_start: float = 0.037, first: int = 0,
                    side_lio: bool = True):
    """Feed ``scans[first:]`` of ``localization_drive`` to ``loc`` as the
    runtime does (the newest IMU sample for the filter's prediction and,
    with ``side_lio``, stamps and IMU batch for the side LIO); yields
    (k, output) per scan."""
    for k in range(first, len(scans)):
        P, S, M, I, IM, _ = scans[k]
        t0 = t_start + k * 0.1
        smp = drive.imu_sample(t0)
        lio = dict(stamps=S, imu=I, imu_mask=IM) if side_lio else {}
        yield k, loc.process_scan(P, M, stamp_us=int(t0 * 1e6), imu_gyro=smp[1:4],
                                  imu_acc=smp[4:7] * 9.81, **lio)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def sync_sites(fn):
    """(fn(), host syncs while it ran by site).  A site is the innermost line
    of this package on the stack when the sync was reported or, where the
    stack holds none, its last three frames.  Only the sync report counts,
    not the notice that torch gives once per process when the mode is first
    switched on ("...is a prototype feature...")."""
    sites = collections.Counter()
    tools = str(Path(__file__).resolve().parent)
    pkg = str(Path(tools).parent)

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing cuda operation" not in str(message).lower():
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(pkg)
                and not f.filename.startswith(tools)]
        frames = ours[-1:] or stack[-3:]
        sites[" < ".join(f"{Path(f.filename).name}:{f.lineno}" + ("" if ours else f" {f.name}")
                         for f in reversed(frames))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, dict(sites.most_common())


def trace_report(prof, n: int, wall_s: float, prefixes) -> dict:
    """Per-scan numbers of a profiler trace over ``n`` scans that took
    ``wall_s`` seconds: wall and device-busy ms, idle share, launches, and
    for each ``record_function`` span whose name starts with one of
    ``prefixes`` its host ms and the kernel launches issued inside it
    (on any thread), plus the kernels and host operators that take the most
    time."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    prefixes = tuple(prefixes)
    events = prof.key_averages()
    # the spans also appear on the device as annotations covering their
    # range; they are not kernels
    kernels = sorted((e for e in events if e.device_type == cuda
                      and not e.key.startswith(prefixes)),
                     key=lambda e: -e.self_device_time_total)
    dev_total = sum(e.self_device_time_total for e in kernels)
    host_ops = sorted((e for e in events if e.device_type == cpu
                       and not e.key.startswith(prefixes)),
                      key=lambda e: -e.self_cpu_time_total)[:25]
    raw = prof.events()
    launches = np.sort(np.asarray([e.time_range.start for e in raw
                                   if e.name == "cudaLaunchKernel"], float))
    by_name = collections.defaultdict(list)
    for e in raw:
        if e.device_type == cpu and e.name.startswith(prefixes):
            by_name[e.name].append((e.time_range.start, e.time_range.end))
    spans = {}
    for name, ranges in sorted(by_name.items()):
        r = np.asarray(ranges, float)
        inside = np.searchsorted(launches, r[:, 1], "right") - np.searchsorted(launches, r[:, 0], "left")
        spans[name] = dict(calls_per_scan=len(r) / n,
                           host_ms=float((r[:, 1] - r[:, 0]).sum()) / 1e3 / n,
                           launches=float(inside.sum()) / n,
                           host_ms_per_call=float((r[:, 1] - r[:, 0]).mean()) / 1e3,
                           launches_per_call=float(inside.mean()))
    wall_ms = wall_s / n * 1e3
    busy_ms = dev_total / 1e3 / n
    return dict(
        wall_ms_per_scan=wall_ms, device_busy_ms_per_scan=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        kernel_launches_per_scan=sum(e.count for e in kernels) / n,
        spans=spans,
        kernels=[dict(name=e.key[:120], calls_per_scan=e.count / n,
                      device_ms_per_scan=e.self_device_time_total / 1e3 / n)
                 for e in kernels[:25]],
        host_ops=[dict(name=e.key, calls_per_scan=e.count / n,
                       self_host_ms_per_scan=e.self_cpu_time_total / 1e3 / n)
                  for e in host_ops])


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
    cfg = BENCH_CFG
    st = lio_init(cfg, nav_at_start(sim, dev))
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
    syncs = sync_sites(lambda: lio_step(cfg, st, *scans[-1]))[1]

    report = dict(card=_card(), scans=n, points_per_scan=cap,
                  **trace_report(prof, n, wall, (SPAN,)),
                  host_syncs_per_scan=sum(syncs.values()), host_sync_sites=syncs)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_lio.json").write_text(json.dumps(report, indent=1))
    if args.trace:
        prof.export_chrome_trace(str(out / "profile_lio_trace.json"))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
