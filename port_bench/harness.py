"""One run of one cell: ``python3 port_bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The cell's entry in ``BENCHMARK.json`` names its configuration and traffic
mix; everything else is found by name: the configuration's sizes in
``configs/<config>.json``, the mix's parameters in
``traffic/<traffic>.json`` (whose ``kind`` names the module that drives it,
``drivers/<kind>.py``), the limits of the output check in
``limits/<workload>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``.

A run: set-up (``drivers/<kind>.py`` builds the program, makes the traffic from the
seed and warms up every shape the traffic uses), then, with ``--trace 1``,
a profiled stretch, then the measured window of ``--seconds``, then the
output check against the plain reference.  The last line of standard
output is one JSON object; the numbers the check compared, each beside its
limit, end standard error and the JSON line.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "lsd_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's own start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> bool:
    """Whether JAX or the JAX package is loaded, compared by whole top-level
    names (``lsd_tpu_torch`` is not ``lsd_tpu``); says which on stderr."""
    bad = sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if bad:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
    return bool(bad)


class Cell:
    """A cell's entries and files, found by name from ``BENCHMARK.json``."""

    def __init__(self, workload: str, bench_file: Path = ROOT / "BENCHMARK.json"):
        bench = json.loads(bench_file.read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in {bench_file.name}")
        self.name = workload
        self.entry = by_name[workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())
        self.chips = int(self.entry["chips"])

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in e2e_names]


def load_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0]) if out.returncode == 0 else None
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Run:
    """What one run measured, as the per-layer readers see it.

    ``trace`` is the profiled stretch's ``trace.Trace`` over
    ``traced_items`` items (None without ``--trace 1``); ``items``,
    ``window_s`` and ``latencies_s`` are the measured window's (the
    untraced rest of the window in a traced run); ``cell`` is the
    ``Cell``; ``counts`` what ``drivers/<kind>.py`` counted from the shapes
    (``counts/``); ``device_kind`` the card's name."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.trace = None
        self.items = 0
        self.traced_items = 0
        self.window_s = 0.0
        self.latencies_s: List[float] = []
        self.counts: Dict[str, float] = {}
        self.device_kind = "cpu"

    @property
    def rate(self) -> float:
        return self.items / self.window_s


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, float), q))


END_TO_END = {
    "slam_scans_per_s": lambda r: r.rate,
    "slam_scan_ms_p95": lambda r: percentile(r.latencies_s, 95) * 1e3,
    "detect_frames_per_s": lambda r: r.rate,
}


def measure(driver, run: Run, seconds: float, trace: bool) -> Optional[dict]:
    """The profiled stretch (with ``trace``) and the window; returns the
    device entries of the trace, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import STRETCH, Trace

    prof, stretch_s = None, 0.0
    if trace:
        n = int(run.cell.traffic["traced_" + driver.unit])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_start = time.perf_counter()
            with record_function(STRETCH):
                for _ in range(n):
                    driver.step()
                torch.cuda.synchronize()
            stretch_s = time.perf_counter() - t_start
        run.traced_items = n
    # the window: every item that completes before the time is up, and the
    # one that completes across it, over the time up to that completion;
    # a traced run's stretch counts against it, the profiler's own
    # collection after the stretch does not
    left = seconds - stretch_s
    t0 = time.perf_counter()
    lat = []
    while not lat or time.perf_counter() - t0 < left:
        lat.append(driver.step())
    run.window_s = time.perf_counter() - t0
    run.items, run.latencies_s = len(lat), lat
    traced = None
    if prof is not None:
        # read once the window has closed: reading takes seconds
        run.trace = Trace.from_profiler(prof, n)
        traced = dict(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    return traced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the lsd_tpu_torch benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {cell.chips} CUDA device(s), {n} found; "
              "it never runs on the CPU", file=sys.stderr)
        return 2
    driver_mod = importlib.import_module(f"port_bench.drivers.{cell.traffic['kind']}")
    return run_cell(cell, driver_mod, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))


def run_cell(cell: Cell, driver_mod, seed: int, seconds: float, trace: bool, device,
             out=sys.stdout) -> int:
    """Set up, measure and check one run; print its result line to ``out``.
    ``device`` is the card, or the CPU in the harness's own tests."""
    import torch
    run = Run(cell)
    on_card = device.type == "cuda"
    if on_card:
        run.device_kind = torch.cuda.get_device_name(0)
    driver = driver_mod.Driver(cell, seed % 2 ** 63, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    traced = measure(driver, run, seconds, trace)
    driver.finish()                       # answers still due, untimed
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    run.counts = driver.counts()
    if forbidden_loaded():
        return 3
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    quarters = [len(q) / sum(q) for q in np.array_split(np.asarray(run.latencies_s), 4) if len(q)]
    print(f"port_bench: set-up {setup_s:.2f} s, window {run.window_s:.2f} s ({run.items} {driver.unit}; "
          f"by quarter {', '.join(f'{r:.2f}' for r in quarters)} a second), "
          f"check {time.perf_counter() - t_check:.2f} s; {driver.describe()}", file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else END_TO_END[m["name"]](run)
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=peak)
    if on_card:
        dev["power_limit_w"] = card_power_limit()
    attempted = run.traced_items + run.items + driver.attempted_outside_window
    result = dict(correct=correct, attempted=attempted,
                  failed=driver.failed, metrics=metrics, device=dev)
    if traced is not None:
        dev.update(traced)
        result["breakdown"] = dict(device_ops=[[n, s] for n, s in run.trace.device_ops()],
                                   idle_gaps=[[n, s] for n, s in run.trace.idle_gaps()])
    result["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in checks}
    if forbidden_loaded():
        return 3
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
