"""Roofline accounting for the hot stages (counterpart of
``lsd_tpu/tools/roofline.py``).

Answers, with measurements rather than wall-clock alone: how far from the
card's speed of light does each headline stage run, and which resource
binds it?

Methodology
-----------
- **Peaks are measured, not quoted**: ``measure_peaks()`` times a chain of
  large bf16 matmuls (the tensor cores' rate) and a large float32 copy-add
  (the memory rate) on the card between CUDA events.  The data sheet's
  figures are reported beside them, as data-sheet figures.
- **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode``
  (``flop_count``), which counts matrix products and convolutions only: a
  stage of gathers, scatters and element-wise work counts (nearly) 0.
- **Bytes** come from an *analytic minimum-traffic model* per stage, built
  from its access pattern (documented below): achieved GB/s = analytic
  bytes / measured time, always <= the true traffic.
- A stage whose achieved compute AND bandwidth are both far below peak is
  **latency-bound** (serialized small kernels, sort passes, sequential
  dependencies): the binding resource of most SLAM stages, fixed by
  fusing or batching, not by faster math.

``stage_report``, ``lio_traffic_model`` and ``detection_traffic_model`` are
the reference's arithmetic, unchanged (its report calls the matrix units
"MXU"; here they are the tensor cores).  ``profile_lio_phases`` times the
port's own step: its "iterate" phase is the fused reduction (kernel B1,
``ops/p2p.py:p2p_reduce``) and the degeneracy gate, not the reference's
default ``_measurement_system`` matmuls (``tools/bench_p2p.py`` times both).

    python -m lsd_tpu_torch.tools.roofline [--json] [--device cpu]
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict

from ..utils.device import DeviceLike, resolve_device

# data-sheet figures for context (per card; dense, without sparsity)
DATASHEET = {
    # NVIDIA H100 SXM5 80GB data sheet: 989 TFLOP/s bf16, 3.35 TB/s HBM3
    "H100": dict(bf16_tflops=989.0, hbm_gbps=3350.0),
    "cpu": dict(bf16_tflops=0.1, hbm_gbps=20.0),
}


def _device_kind(device: DeviceLike = None) -> str:
    import torch
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def datasheet_peaks(device: DeviceLike = None) -> Dict[str, float]:
    kind = _device_kind(device)
    for k, v in DATASHEET.items():
        if k in kind:
            return v
    return DATASHEET["cpu"]


def time_ms(fn: Callable[[], object], device: DeviceLike = None, n: int = 30,
            warm: int = 3) -> float:
    """Milliseconds per call of ``fn()`` over ``n`` calls after ``warm``:
    between two CUDA events on a card, on the host clock between two
    synchronizes elsewhere."""
    import torch
    dev = resolve_device(device)
    for _ in range(warm):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize(dev)
    with torch.cuda.device(dev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def measure_peaks(size_mm: int = 4096, size_copy_mb: int = 256,
                  inner: int = 32, device: DeviceLike = None) -> Dict[str, float]:
    """Measured peaks of one device: bf16 matmul TFLOP/s and float32 stream
    GB/s, each over ``inner`` chained launches, beside the data sheet's."""
    import torch
    dev = resolve_device(device)
    # every entry 2**-12: a @ a == a, so the chain neither grows nor decays,
    # and it launches matrix products only
    a = torch.full((size_mm, size_mm), 2.0 ** -12, dtype=torch.bfloat16, device=dev)

    def mm_chain():
        c = a
        for _ in range(inner):
            c = a @ c
        return c
    mxu_tflops = 2 * size_mm ** 3 / (time_ms(mm_chain, dev, n=1) / inner / 1e3) / 1e12

    n = size_copy_mb * 1024 * 1024 // 4
    b = torch.ones((n,), dtype=torch.float32, device=dev)

    def add_chain():
        c = b
        for _ in range(inner):
            c = c + 1.0
        return c
    hbm_gbps = 2 * n * 4 / (time_ms(add_chain, dev, n=1) / inner / 1e3) / 1e9  # read + write
    return dict(measured_mxu_tflops=round(mxu_tflops, 1),
                measured_hbm_gbps=round(hbm_gbps, 1),
                **datasheet_peaks(dev))


def stage_report(name: str, ms: float, flops: float, min_bytes: float,
                 peaks: Dict[str, float], note: str = "") -> Dict:
    """One roofline row.  ``min_bytes`` is the analytic minimum traffic."""
    t = ms / 1e3
    ach_tf = flops / t / 1e12 if t > 0 else 0.0
    ach_gb = min_bytes / t / 1e9 if t > 0 else 0.0
    p_mxu = 100.0 * ach_tf / peaks.get("measured_mxu_tflops", peaks["bf16_tflops"])
    p_hbm = 100.0 * ach_gb / peaks.get("measured_hbm_gbps", peaks["hbm_gbps"])
    if p_mxu >= p_hbm and p_mxu > 15.0:
        bound = "compute (MXU)"
    elif p_hbm > p_mxu and p_hbm > 15.0:
        bound = "memory (HBM)"
    else:
        bound = "latency (serialized small kernels / sequential deps)"
    return dict(stage=name, ms=round(ms, 3),
                gflops=round(flops / 1e9, 2),
                min_traffic_mb=round(min_bytes / 1e6, 1),
                achieved_tflops=round(ach_tf, 3),
                achieved_gbps=round(ach_gb, 1),
                pct_peak_compute=round(p_mxu, 1),
                pct_peak_bandwidth=round(p_hbm, 1),
                bound=bound, note=note)


def flop_count(fn: Callable[[], object]) -> float:
    """FLOPs of one call of ``fn()`` as ``FlopCounterMode`` counts them: matrix
    products and convolutions only (gathers, scatters, sorts and element-wise
    work count 0)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# Analytic minimum-traffic models (bytes) per stage.  f32 = 4 bytes.
# These count each tensor ONCE per necessary pass (algorithmic minimum);
# real traffic is >= this, so %-of-peak is an upper bound on efficiency.
# ---------------------------------------------------------------------------

def lio_traffic_model(cfg, raw_cap: int) -> Dict[str, float]:
    """Per-phase minimum bytes for one LIO scan step.

    Phases (mirrors slam/lio.py lio_step):
      undistort:  read raw pts+stamps, write undistorted pts
      downsample: sort-free minimum = read pts + write ds pts (the sort
                  actually moves ~log2(N) passes more)
      match:      probe-key gather (N*7 probes * P slots * 4B) + moment
                  table stack (C*10*4B read+write once) + row gather
                  (N*7*10*4B)
      iterate:    per GN iter: H rows (N*24*4B write+read) + HtH matmul
                  reads; x iters
      insert:     moment comps (N*10*4B) + scattered updates (touched
                  voxels ~N * 10 * 4B read+write)
    """
    N = cfg.ds_capacity
    C = cfg.map_capacity
    it = cfg.max_iters
    f = 4.0
    from ..ops.surfel import SURFEL_PROBES
    undistort = raw_cap * (3 + 1 + 3) * f
    downsample = raw_cap * 4 * f + N * 4 * f
    match = (N * 7 * SURFEL_PROBES * f          # key probes
             + C * 10 * f * 2                   # moments SoA->AoS stack
             + N * 7 * 10 * f)                  # moment row gather
    iterate = it * (N * 24 * f * 2 + N * 24 * f)
    insert = N * 10 * f + N * 10 * f * 2
    total = undistort + downsample + match + iterate + insert
    return dict(undistort=undistort, downsample=downsample, match=match,
                iterate=iterate, insert=insert, total=total)


def detection_traffic_model(det_cfg, n_pts: int, params_bytes: float) -> float:
    """Minimum bytes for one detection forward: points in, voxel gather,
    BEV activations through the backbone (each map read+written once per
    conv), weights once."""
    H, W = det_cfg.grid_hw
    bev = H * W * det_cfg.pillar_filters * 2    # bf16 activations
    # backbone reads/writes each stage's activation ~2x per conv layer;
    # approximate with 6 stage-sized passes (2 blocks x 3 convs)
    return n_pts * 4 * 4 + 8 * bev + params_bytes


# ---------------------------------------------------------------------------
# LIO per-phase timing
# ---------------------------------------------------------------------------

PHASES = ("propagate+undistort", "voxel_downsample", "match(surfel gather+planes)",
          "iterate(residual+HtH+gate) x1", "map_insert(scatter)")


def profile_lio_phases(cfg, st, P, S, M, I, IM, n_rep: int = 30) -> Dict[str, float]:
    """Milliseconds of each phase of the port's LIO step, run alone on the
    state's device (``time_ms``), from the building blocks ``lio_step``
    composes (``slam/lio.py``).  The "iterate" phase is one iteration of the
    port's route: the fused reduction B1 (``p2p_reduce``) and the
    degeneracy gate (``_gate_degenerate``, one launch of ``csrc/lio_gate.cu``
    on the card), not the reference's ``_measurement_system`` matmuls."""
    from ..ops.p2p import p2p_reduce
    from ..ops.surfel import surfel_insert
    from ..ops.voxelize import voxel_downsample
    from ..slam import lio as L
    from ..slam.imu import propagate, undistort
    from ..utils.precision import slam_f32

    dev = st.P.device

    @slam_f32
    def ph_prop():
        nav_prop, _P, track = propagate(st.nav, st.P, I, IM, cfg.imu_noise, cfg.acc_scale)
        return undistort(P[:, :3], S, M, nav_prop, track)

    pts_und = ph_prop()

    def ph_downsample():
        return voxel_downsample(pts_und, M, cfg.scan_voxel, cfg.ds_capacity)

    ds_pts, ds_mask = ph_downsample()
    ds_pts = ds_pts[:, :3].contiguous()

    @slam_f32
    def ph_match():
        return L._match_planes(cfg, st.nav, ds_pts, ds_mask, st.map)

    planes = ph_match()

    @slam_f32
    def ph_iterate():
        normals, dpl, _, _ = planes
        HtH, Htr, _ = p2p_reduce(ds_pts, normals, dpl, L.p2p_weight(cfg, ds_mask, planes),
                                 st.nav.rot, st.nav.ext_rot, st.nav.ext_t, st.nav.pos,
                                 cfg.max_resid, est_extrinsic=cfg.est_extrinsic)
        E, nd, _ = L._gate_degenerate(cfg, HtH)
        return E @ HtH @ E.T, E @ Htr, nd

    def ph_insert():
        return surfel_insert(st.map, ds_pts, ds_mask)

    fns = (ph_prop, ph_downsample, ph_match, ph_iterate, ph_insert)
    return {name: time_ms(fn, dev, n=n_rep) for name, fn in zip(PHASES, fns)}


def bench_scans(n_scans: int, points: int = 2 ** 15, seed: int = 7):
    """``bench.py``'s world: ``CircleSim`` scans of ``points`` points with 16
    IMU samples (host arrays)."""
    from ..sim import CircleSim, SimConfig
    sim = CircleSim(SimConfig(n_scans=n_scans, points_per_scan=points,
                              point_noise=0.01, seed=seed))
    return sim, sim.generate(capacity=points, imu_capacity=16)


def report(device: DeviceLike = None, points: int = 2 ** 15, n_rep: int = 30) -> Dict:
    """Measured peaks and the roofline rows of the LIO step and its phases
    at ``bench.py``'s shapes (``points``-point scans, 16,384 residual
    points, a 2**18 map) on ``device`` (the card unless the caller asks for
    the CPU): the step from the state after 10 scans, on the 11th, ``n_rep``
    times."""
    from ..slam import LioConfig, lio_init, lio_step
    from ..slam import lio as L
    from ..utils.device import to_device

    dev = resolve_device(device)
    peaks = measure_peaks(device=dev)
    _sim, data = bench_scans(12, points)
    cfg = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                    scan_voxel=0.4, map_voxel=0.4, max_iters=4)
    st = lio_init(cfg, device=dev)
    scans = [tuple(to_device(a, dev) for a in d[:5]) for d in data]
    for scan in scans[:10]:
        st, _info = lio_step(cfg, st, *scan)
    scan = scans[10]

    lio_ms = time_ms(lambda: lio_step(cfg, st, *scan), dev, n=n_rep)
    phases = profile_lio_phases(cfg, st, *scan, n_rep=n_rep)
    model = lio_traffic_model(cfg, points)
    # counted on the eager body: a graph's replay dispatches no operator
    lio_flops = flop_count(lambda: L._lio_step_eager(cfg, st, *scan))
    rows = [stage_report("lio_step (full)", lio_ms, lio_flops,
                         model["total"], peaks,
                         note="phases: " + ", ".join(
                             f"{k}={v:.2f}ms" for k, v in phases.items()))]
    ph_bytes = dict(zip(PHASES, [model["undistort"], model["downsample"], model["match"],
                                 model["iterate"] / cfg.max_iters, model["insert"]]))
    for k, ms in phases.items():
        rows.append(stage_report("lio/" + k, ms, 0.0, ph_bytes[k], peaks))
    return dict(device=_device_kind(dev), peaks=peaks, phases_ms=phases, rows=rows)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true", help="print JSON only")
    ap.add_argument("--points", type=int, default=2 ** 15)
    ap.add_argument("--device", default=None,
                    help="torch device to measure (default: the card)")
    args = ap.parse_args(argv)
    out = report(args.device, args.points)
    print(json.dumps(out, indent=None if args.json else 2))
    return out


if __name__ == "__main__":
    main()
