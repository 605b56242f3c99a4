"""Scale-out efficiency: measured collective volumes, measured per-rank
compute, and a projected interconnect model (counterpart of
``lsd_tpu/tools/scaling.py``).

One card is reachable here, so the wall time of a multi-card run cannot be
measured.  What CAN be measured:

  1. the one-card step time of each distributed program's compute (the
     denominator of the efficiency ratio);
  2. the per-rank compute at the 1/n shapes each rank of an n-rank group
     runs (``measure_shard_compute``: ``lio_step_batch`` at 1/n of the
     points, residual budget and map; ``measure_schur_shard_compute``: the
     Schur round of rank 0 of an n-rank plan);
  3. the exact collective BYTES each program moves per step (from the
     programs: ``parallel/sharded_map.py``, ``parallel/schur_pgo.py``), and
  4. the wall time of the map-sharded step on gloo groups of 1/2/4/8 CPU
     ranks (``measure_virtual_cpu``; an overhead trend, not an
     interconnect measurement).

The interconnect model takes a bandwidth and a per-step latency as
arguments; the default bandwidth is NVLink 4 on an H100 SXM (450 GB/s in
each direction, NVIDIA's data sheet).  Every time computed from them is a
projection, named ``projected_*``: not measured.

Usage: python -m lsd_tpu_torch.tools.scaling [--out scaling.json] [--skip-virtual] [--device cpu]
"""
from __future__ import annotations

import json
import time

import numpy as np

from ..utils.device import DeviceLike, resolve_device

NVLINK_BW = 450e9      # bytes/s per direction, NVLink 4 on an H100 SXM (data sheet)
STEP_LAT = 10e-6       # seconds per ring step, an assumption (the reference's per-hop figure)


def _ring_allreduce_time(bytes_: float, ndev: int, bw: float = NVLINK_BW,
                         lat: float = STEP_LAT) -> float:
    """2(n-1)/n * bytes over the ring + per-step latency (a projection)."""
    if ndev <= 1:
        return 0.0
    return 2.0 * (ndev - 1) / ndev * bytes_ / bw + lat * (ndev - 1)


def _projected_rows(t_single: float, comm_bytes, t_shard, bw, lat):
    out = {}
    for n in (2, 4, 8, 16):
        t_comm = sum(_ring_allreduce_time(b, n, bw, lat) for b in comm_bytes)
        t_c = (t_shard or {}).get(n, t_single / n)
        t_n = t_c + t_comm
        out[n] = dict(projected_t_comm_us=round(t_comm * 1e6, 1),
                      t_compute_ms=round(t_c * 1e3, 3),
                      compute_measured=bool(t_shard and n in t_shard),
                      projected_efficiency=round(t_single / n / t_n, 4),
                      projected_speedup=round(t_single / t_n, 2))
    return out


def lio_model(t_single: float, ds_capacity: int = 16384, iters: int = 4,
              t_shard: dict = None, bw: float = NVLINK_BW, lat: float = STEP_LAT):
    """Map-block sharded LIO step (``parallel/sharded_map.py``): per scan
    one all-reduce of the (N, 10) float32 moments and ``iters`` of
    24x24 + 24.

    ``t_shard[n]``: the MEASURED per-rank step time at 1/n shapes
    (``measure_shard_compute``).  Small per-rank shapes do not scale
    linearly (fixed launch costs), so t_shard[n] >= t_single/n; the
    t_single/n fallback (perfect splitting) is flagged per row."""
    mom_bytes = ds_capacity * 10 * 4
    hth_bytes = (24 * 24 + 24) * 4 * iters
    return dict(comm_bytes_per_scan=mom_bytes + hth_bytes,
                projected=_projected_rows(t_single, (mom_bytes, hth_bytes), t_shard, bw, lat))


def schur_model(t_single: float, n_sep: int = 64, t_shard: dict = None,
                bw: float = NVLINK_BW, lat: float = STEP_LAT):
    """Schur PGO round: one all-reduce of (S*6)^2 + S*6 float32.

    ``t_shard[n]``: the measured per-rank round at an n-rank plan
    (``measure_schur_shard_compute``)."""
    sb = ((n_sep * 6) ** 2 + n_sep * 6) * 4
    return dict(comm_bytes_per_round=sb,
                projected=_projected_rows(t_single, (sb,), t_shard, bw, lat))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lio_batch_ms(cap: int, ds: int, map_cap: int, dev, scans: int = 16, reps: int = 3) -> float:
    """Seconds per scan of ``lio_step_batch`` over ``scans`` scans at these
    shapes, ``reps`` times after one warm pass."""
    import torch

    from ..sim import CircleSim, SimConfig
    from ..slam import LioConfig, lio_init, lio_step_batch
    from ..utils.device import to_device

    sim = CircleSim(SimConfig(n_scans=scans, points_per_scan=cap, seed=7))
    data = sim.generate(capacity=cap, imu_capacity=16)
    cfg = LioConfig(ds_capacity=ds, map_capacity=map_cap, scan_voxel=0.4, map_voxel=0.4,
                    max_iters=4, research_thresh=0.0)   # as the sharded step: no re-search
    batch = [to_device(np.stack([d[i] for d in data]), dev) for i in range(5)]
    st = lio_init(cfg, device=dev)
    st, _ = lio_step_batch(cfg, st, *batch)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        st, _ = lio_step_batch(cfg, st, *batch)
    _sync(dev)
    if not bool(torch.isfinite(st.nav.pos).all()):
        raise RuntimeError("scaling: the LIO state is not finite")
    return (time.perf_counter() - t0) / (reps * scans)


def measure_shard_compute(base_points: int = 2 ** 15, base_ds: int = 16384,
                          base_map: int = 2 ** 18, ns=(2, 4, 8, 16), reps: int = 3,
                          device: DeviceLike = None) -> dict:
    """Measured per-rank compute: the LIO step on ``device`` (the card unless
    the caller asks for the CPU) at each 1/n shape (points, residual
    budget and map capacity divided by n, as each rank of an n-rank group
    runs them under point and map-block sharding); seconds per scan."""
    dev = resolve_device(device)
    return {n: _lio_batch_ms(max(base_points // n, 256), max(base_ds // n, 256),
                             max(base_map // n, 2 ** 10), dev, reps=reps) for n in ns}


def chain_graph(n_nodes: int):
    """A chain of ``n_nodes`` keyframes 1 m apart, the first fixed."""
    from ..slam.graph_builder import PoseGraphBuilder
    b = PoseGraphBuilder()
    T = np.eye(4, dtype=np.float32)
    b.add_node(T, fixed=True)
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = 1.0
    for k in range(n_nodes - 1):
        T = T @ rel
        b.add_node(T)
        b.add_se3_edge(k, k + 1, rel)
    return b


def measure_schur_shard_compute(base_nodes: int = 1024, ns=(2, 4, 8, 16), reps: int = 5,
                                device: DeviceLike = None) -> dict:
    """Per-rank Schur compute on ``device``: the round of rank 0 of an
    n-rank plan of a ``base_nodes`` chain (its 1/n of the interior nodes and
    the separator solve), in a one-rank group; seconds per round.  (The JAX
    package's tool timed ``optimize`` on a chain of base_nodes/n nodes.)"""
    import torch

    from ..parallel.mesh import single_rank
    from ..slam.posegraph import PgoConfig
    from .schur_chip_bench import rank0_round

    dev = resolve_device(device)
    graph = chain_graph(base_nodes).to_data(device=dev)
    res = {}
    with single_rank("nccl" if dev.type == "cuda" else "gloo", device=dev) as mesh:
        for n in ns:
            rnd, rows, free, _ = rank0_round(graph, n, PgoConfig(), mesh)
            step = lambda: rnd(graph.nodes, torch.ones_like(graph.gps.mask), free, *rows,
                               graph.se3, graph.gps, graph.floor, graph.orient)
            step()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            _sync(dev)
            res[n] = (time.perf_counter() - t0) / reps
    return res


def pgo_round_s(n_nodes: int = 1024, reps: int = 5, device: DeviceLike = None) -> float:
    """Seconds per Gauss-Newton round of the one-device ``optimize`` on a
    chain of ``n_nodes`` (3 rounds of 30 CG steps per solve)."""
    from ..slam.posegraph import PgoConfig, optimize
    dev = resolve_device(device)
    g = chain_graph(n_nodes).to_data(device=dev)
    pcfg = PgoConfig(outer_iters=3, cg_iters=30)
    optimize(g, pcfg)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        optimize(g, pcfg)
    _sync(dev)
    return (time.perf_counter() - t0) / (reps * pcfg.outer_iters)


def virtual_rank(mesh, cap: int, ds: int, map_cap: int, n_scans: int, reps: int) -> float:
    """One gloo rank of ``measure_virtual_cpu``: milliseconds per scan of the
    map-sharded step over ``n_scans`` scans, ``reps`` passes after one."""
    import torch

    from ..parallel.sharded_map import make_sharded_lio_step, sharded_lio_init
    from ..sim import CircleSim, SimConfig
    from ..slam.lio import LioConfig

    sim = CircleSim(SimConfig(n_scans=n_scans, points_per_scan=cap, seed=5))
    data = [tuple(torch.as_tensor(a) for a in d[:5])
            for d in sim.generate(capacity=cap, imu_capacity=16)]
    cfg = LioConfig(ds_capacity=ds, map_capacity=map_cap, scan_voxel=0.4, map_voxel=0.4,
                    research_thresh=0.0)
    step = make_sharded_lio_step(cfg, mesh)
    st = sharded_lio_init(cfg, mesh)
    for scan in data:
        st, pose = step(st, *scan)
    t0 = time.perf_counter()
    for _ in range(reps):
        for scan in data:
            st, pose = step(st, *scan)
    if not bool(torch.isfinite(pose).all()):
        raise RuntimeError("scaling: the sharded step's pose is not finite")
    return (time.perf_counter() - t0) / (reps * n_scans) * 1e3


def measure_virtual_cpu(max_dev: int = 8, cap: int = 8192, ds: int = 4096,
                        map_cap: int = 2 ** 15, n_scans: int = 4, reps: int = 3) -> dict:
    """Milliseconds per scan of the map-sharded step on gloo groups of
    1, 2, 4, ... ``max_dev`` CPU ranks (the slowest rank's figure; an
    overhead trend only: gloo's collectives here are copies between
    processes of one host)."""
    from ..parallel.mesh import run_ranks
    res = {}
    n = 1
    while n <= max_dev:
        ms = run_ranks(virtual_rank, n, (cap, ds, map_cap, n_scans, reps), backend="gloo")
        res[n] = round(max(ms), 2)
        n *= 2
    return res


def scaling_report(reps: int = 3, bw: float = NVLINK_BW, lat: float = STEP_LAT,
                   virtual: bool = True, device: DeviceLike = None) -> dict:
    """The tool's report: measured times on ``device`` (the card unless the
    caller asks for the CPU), the models' projections, and with ``virtual``
    the gloo CPU groups."""
    import torch
    from ..utils.precision import set_slam_precision

    dev = resolve_device(device)
    set_slam_precision()
    t_lio = _lio_batch_ms(2 ** 15, 16384, 2 ** 18, dev, reps=reps)
    t_pgo_round = pgo_round_s(device=dev)
    t_shard_lio = measure_shard_compute(reps=reps, device=dev)
    t_shard_schur = measure_schur_shard_compute(device=dev)
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "lio_t_single_ms": round(t_lio * 1e3, 3),
        "lio_shard_compute_ms": {k: round(v * 1e3, 3) for k, v in t_shard_lio.items()},
        "lio_scaling": lio_model(t_lio, 16384, 4, t_shard=t_shard_lio, bw=bw, lat=lat),
        "pgo_round_single_ms": round(t_pgo_round * 1e3, 3),
        "schur_shard_compute_ms": {k: round(v * 1e3, 3) for k, v in t_shard_schur.items()},
        "schur_scaling_64sep": schur_model(t_pgo_round, 64, t_shard=t_shard_schur,
                                           bw=bw, lat=lat),
        "interconnect_model": dict(
            note="projection, not measured: one card on this host",
            bw_gbps=bw / 1e9, step_lat_us=lat * 1e6),
    }
    if virtual:
        report["virtual_cpu_ms_per_scan"] = measure_virtual_cpu()
    return report


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-virtual", action="store_true")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed passes of each LIO measurement")
    ap.add_argument("--bw", type=float, default=NVLINK_BW,
                    help="bytes/s per direction of the projection (default: NVLink 4)")
    ap.add_argument("--lat", type=float, default=STEP_LAT,
                    help="seconds per ring step of the projection")
    ap.add_argument("--device", default=None,
                    help="torch device to measure (default: the card)")
    args = ap.parse_args(argv)
    report = scaling_report(args.reps, args.bw, args.lat, not args.skip_virtual, args.device)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
