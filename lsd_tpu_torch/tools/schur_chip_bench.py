"""Time the Schur merge's per-rank Gauss-Newton round at campaign shapes
on one device (counterpart of ``lsd_tpu/tools/schur_chip_bench.py``).

The campaign's distributed merge (``parallel/schur_pgo.py``) runs one
round per outer iteration on every rank: dense interior Cholesky
elimination, the separator reduction, back-substitution — block algebra
of about 900 x 900 at merge shapes.  This tool times that round on one
card:

  * a merge-shaped synthetic graph is built at the campaign's recorded
    scale (default: 1192 nodes / 432 loop+cross edges / 1173 GNSS
    priors, ``CAMPAIGN_r04.json`` merged_full), or the joint graph of two
    saved maps (``--maps A B``, through ``slam/map_merge.py:merge_maps``);
  * the ``--ndev`` partition plan (``build_plan``) fixes the per-rank
    shapes (m_int interiors, n_sep separators, local factors);
  * the same round program (``_build_round``) runs on a group of one rank
    (``parallel/mesh.py:single_rank``, NCCL on a card) fed rank 0's slice of
    that plan.  The all-reduce over one rank returns its input, and the
    separator solve runs on every rank of the real group, so the per-rank
    shapes and operations are those of the ``--ndev`` group; only the
    reduction's transfer is absent.  Its payload, one (S*6)^2 + S*6 float32
    block per round, is reported in bytes; a time derived from it is a
    projection at a bandwidth given on the command line, not a measurement.

    python -m lsd_tpu_torch.tools.schur_chip_bench [--nodes 1192] [--ndev 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

from ..utils.device import DeviceLike, resolve_device

# NVLink 4 on an H100 SXM: 450 GB/s in each direction (NVIDIA's data sheet:
# 900 GB/s bidirectional).  Only projections use it.
NVLINK_BW = 450e9


def build_merge_shaped_graph(n_nodes: int, n_loops: int, n_gps: int,
                             seed: int = 0):
    """Campaign-shaped pose graph: two odometry chains (sessions A+B)
    around a circle, loop/cross edges between revisits, GNSS priors."""
    import numpy as np

    from ..slam.graph_builder import PoseGraphBuilder

    rng = np.random.default_rng(seed)
    g = PoseGraphBuilder()
    R = 30.0
    for i in range(n_nodes):
        th = 2 * np.pi * (i / 220.0)          # ~220 nodes per lap
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:2, :2] = [[c, -s], [s, c]]
        T[0, 3] = R * np.cos(th) + rng.normal(0, 0.05)
        T[1, 3] = R * np.sin(th) + rng.normal(0, 0.05)
        g.add_node(T, fixed=(i == 0))
        if i > 0:
            T_rel = np.linalg.inv(g.node_pose(i - 1)) @ g.node_pose(i)
            g.add_se3_edge(i - 1, i, T_rel, rot_info=4e4, trans_info=4e4)
    lap = 220
    for _ in range(n_loops):
        i = int(rng.integers(0, max(n_nodes - lap, 1)))
        j = min(i + lap, n_nodes - 1)          # revisit one lap later
        T_rel = np.linalg.inv(g.node_pose(i)) @ g.node_pose(j)
        info = rng.uniform(1.0, 400.0, size=3)
        g.add_se3_edge(i, j, T_rel, rot_info=info, trans_info=info)
    for i in rng.choice(n_nodes, size=min(n_gps, n_nodes), replace=False):
        g.add_gps_prior(int(i), g.node_pose(int(i))[:3, 3]
                        + rng.normal(0, 0.02, 3), xy_only=True, info=25.0)
    return g


def rank0_round(graph, ndev: int, cfg, mesh):
    """(round function, rank 0's plan rows, free mask, plan) of ``graph``'s
    ``ndev``-rank plan, for a one-rank ``mesh``."""
    import torch

    from ..parallel.schur_pgo import _build_round, build_plan

    plan = build_plan(graph, ndev)
    n = graph.nodes.quat.shape[0]
    dev = graph.nodes.pos.device
    rnd = _build_round(mesh, cfg, plan.m_int, plan.n_sep, n)
    first = lambda a: torch.as_tensor(a[0], device=dev)
    rows = (first(plan.int_ids), first(plan.int_mask),
            torch.as_tensor(plan.sep_ids, device=dev), torch.as_tensor(plan.sep_mask, device=dev),
            first(plan.e_rows), first(plan.e_slots), first(plan.e_mask),
            first(plan.g_rows), first(plan.g_slots), first(plan.g_mask),
            first(plan.f_rows), first(plan.f_slots), first(plan.f_mask),
            first(plan.o_rows), first(plan.o_slots), first(plan.o_mask))
    free = (graph.nodes.mask & ~graph.nodes.fixed).to(torch.float32)
    return rnd, rows, free, plan


def bench(builder, ndev: int = 8, rounds: int = 10, outer_iters: int = 8,
          bw: float = NVLINK_BW, device: DeviceLike = None) -> dict:
    """Time ``rounds`` rounds of rank 0 of ``builder``'s graph's ``ndev``-rank
    plan on ``device`` (the card unless the caller asks for the CPU), in a
    one-rank group (NCCL on a card, gloo on the CPU)."""
    import numpy as np
    import torch

    from ..parallel.mesh import single_rank
    from ..slam.posegraph import PgoConfig
    from ..utils.precision import set_slam_precision

    dev = resolve_device(device)
    set_slam_precision()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    graph = builder.to_data(device=dev)
    cfg = PgoConfig(outer_iters=outer_iters, cg_iters=80)
    with single_rank("nccl" if dev.type == "cuda" else "gloo", device=dev) as mesh:
        rnd, rows, free, plan = rank0_round(graph, ndev, cfg, mesh)
        nodes, gps_on = graph.nodes, torch.ones_like(graph.gps.mask)
        step = lambda nodes, gps_on: rnd(nodes, gps_on, free, *rows, graph.se3, graph.gps,
                                         graph.floor, graph.orient)
        sync()
        t0 = time.perf_counter()
        nodes, gps_on = step(nodes, gps_on)
        sync()
        first_round_s = time.perf_counter() - t0
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            nodes, gps_on = step(nodes, gps_on)
            sync()
            times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(nodes.pos).all()):
        raise RuntimeError("schur_chip_bench: the round produced non-finite poses")

    n = graph.nodes.quat.shape[0]
    round_ms = 1e3 * float(np.median(times))
    sep_dim = plan.n_sep * 6
    allreduce_bytes = 4 * (sep_dim * sep_dim + sep_dim)
    projected_allreduce_ms = 1e3 * allreduce_bytes / bw
    return dict(
        platform=dev.type,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        n_nodes=int(n), ndev_plan=ndev,
        m_int=int(plan.m_int), n_sep=int(plan.n_sep),
        interior_dim=int(plan.m_int * 6), sep_dim=int(sep_dim),
        first_round_s=round(first_round_s, 3),
        round_ms_median=round(round_ms, 3),
        round_ms_min=round(1e3 * float(np.min(times)), 3),
        allreduce_bytes_per_round=int(allreduce_bytes),
        projection=dict(
            note="not measured: the payload over an assumed bandwidth; this host has "
                 "one device",
            bw_bytes_per_s=bw,
            projected_allreduce_ms=round(projected_allreduce_ms, 4),
            outer_iters=outer_iters,
            projected_merge_wall_s=round(first_round_s + (outer_iters - 1) * (
                round_ms + projected_allreduce_ms) / 1e3, 3)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=1192)
    ap.add_argument("--loops", type=int, default=432)
    ap.add_argument("--gps", type=int, default=1173)
    ap.add_argument("--ndev", type=int, default=8,
                    help="plan topology whose per-rank shapes to time")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--outer-iters", type=int, default=8,
                    help="campaign merge GN rounds (projection)")
    ap.add_argument("--bw", type=float, default=NVLINK_BW,
                    help="bytes/s per direction assumed by the projection "
                         "(default: NVLink 4 on an H100 SXM)")
    ap.add_argument("--device", default=None,
                    help="torch device to time (default: the card)")
    ap.add_argument("--maps", nargs=2, default=None, metavar=("A", "B"),
                    help="time the REAL campaign merge graph (two saved "
                         "map dirs, joint graph via slam.map_merge) "
                         "instead of the synthetic stand-in")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.maps:
        from ..slam.map_merge import merge_maps
        builder = merge_maps(args.maps[0], args.maps[1], out_dir=None, device=dev)["builder"]
    else:
        builder = build_merge_shaped_graph(args.nodes, args.loops, args.gps)
    out = bench(builder, args.ndev, args.rounds, args.outer_iters, args.bw, dev)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
