#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build every CUDA kernel of the LIO scan step from ``lsd_tpu_torch/csrc``
   (``nvcc`` for sm_90a) and print the build seconds.
2. Drive the LIO step (``lsd_tpu_torch.slam.lio.lio_step``, surfel map) at
   the size ``bench.py`` uses: 32,768-point ``CircleSim`` scans, 16 IMU
   samples, ``ds_capacity=16384``, ``map_capacity=2**18``, 0.4 m voxels,
   ``max_iters=4``.  After the warm-up scans, hold each kernel against its
   plain PyTorch version on the card, on the main path's own
   first-iteration inputs; check that a call is one launch, that two
   launches and a CUDA-graph replay agree bitwise; time kernel and plain
   version beside the bound and the launch floor (the device time of a
   one-element PyTorch op).
3. Set the launch counts to 0, time the main path over the timed scans,
   read the counts, and check the trajectory (finite state, ATE < 0.1 m,
   ``bench.py``'s own sanity bound) and that every kernel ran
   ``max_iters`` times per scan.
4. The mapping path at full width: ``lsd_tpu_torch.slam.mapper.Mapper`` on
   the card over 95 scans of 32,768 points 1.2 times round an 8 m circle
   (the world of the reference's own mapping test), the LIO configured as
   above, a keyframe every 1.5 m, PGO every 8 keyframes, graph work
   synchronous; then ``save()`` and ``load_map``.  Checks, the reference
   test's own bars: more than 15 keyframes, at least one accepted loop,
   trajectory RMSE against ground truth < 0.3 m, every PGO's cost finite
   and its last round's not above its first's, the loaded map whole, and the p2p
   kernel launched ``max_iters`` times per scan.  Then the same 95 scans
   with the background graph worker and the pipelined fetch, ending in a
   clean ``flush()`` and ``close()``: the worker raised nothing, dropped no
   job, added a descriptor for every keyframe, and every ScanContext query,
   ICP verification and PGO solve ran on its thread, with at least one loop
   accepted and the same trajectory bar.
5. The raw-point LIO path: 30 of phase 2's scans with
   ``map_type="points"`` (finite state, ATE < 0.1 m, the p2p kernel
   launched ``max_iters`` times per scan).

Each path starts with the launch counts at 0 and reads them at its end.  It
prints one JSON line per path, the card's name and power limit, one
``{"kernels": [...]}`` line, and as its last line ``{"ok": true, "device":
{...}}``.  It has no CPU path: without a card, or without the
``lsd_tpu_torch`` package beside it, it fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_WARM, N_BENCH = 5, 100
CAP, IMU_CAP = 2 ** 15, 16
ATE_LIMIT_M = 0.1
N_MAPPING, N_POINTS = 95, 30
MAPPING_RMSE_LIMIT_M = 0.3
PGO_COST_RTOL = 1e-4                # float32 rounding of a converged cost (save()'s solve)
SYNC_COUNT_SCANS = range(40, 46)    # mapping scans whose host syncs are counted
N_TIMING = 100                      # launches per timing (median reported)
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores

# fp32 operations per point of the fused reduction without extrinsic
# estimation (the main path's flag), counted from csrc/p2p_reduce.cu: every
# point is transformed to the world frame and gated (18 + 18 + 6 + 6 + 5 =
# 53); a point that passes the gate also builds its 6 pose Jacobian entries
# (15 + 12 = 27) and accumulates them (6 + 2 * 21 + 2 * 6 + 3 = 63, a fused
# multiply-add counted as 2).  The 57 extrinsic sums are zero and need no
# work.
P2P_OPS_GATE, P2P_OPS_VALID = 53, 53 + 27 + 63


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def time_ms(fn, n=N_TIMING):
    """Median milliseconds of ``fn()`` over n calls, each between CUDA events."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, match="", n=N_TIMING, tries=5):
    """(device ms, kernels) per ``fn()``: the summed time and the count of
    the kernels whose name contains ``match`` that n calls launch, from the
    profiler's device trace, over n.  The profiler now and then drops a
    couple of kernel records from a trace, so only a trace that holds the
    same whole number of kernels for every call counts; another is taken
    again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for k in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key]
        count = sum(e.count for e in ev)
        per_call = round(count / n)
        if per_call >= 1 and count == per_call * n:
            if k:
                log(f"the profiler dropped records of {match or 'all'!r} kernels in "
                    f"{k} trace(s), taken again")
            return sum(e.self_device_time_total for e in ev) / 1e3 / n, per_call
    fail(f"the profiler recorded {count} kernels matching {match!r} for {n} calls "
         f"in the last of {tries} traces")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_run(dev):
    """Scans on the device, the initial navigation state and the config."""
    import torch
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg, nav_at_start

    sim = CircleSim(SimConfig(n_scans=N_WARM + N_BENCH, points_per_scan=CAP,
                              point_noise=0.01, seed=7))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    nav0 = nav_at_start(sim, dev)
    scans = [tuple(torch.as_tensor(a, device=dev) for a in d[:5]) for d in data]
    gt = np.stack([d[5] for d in data])
    return cfg, nav0, scans, gt


def p2p_inputs(cfg, st, scan):
    """The fused reduction's first-iteration inputs for ``scan`` at state ``st``."""
    from lsd_tpu_torch.slam.lio import p2p_weight, scan_front
    front = scan_front(cfg, st, *scan)
    nav = front.nav_prop
    normals, dpl, _, _ = front.planes
    return (front.ds_pts, normals, dpl, p2p_weight(cfg, front.ds_mask, front.planes),
            nav.rot, nav.ext_rot, nav.ext_t, nav.pos)


def check_p2p(args, max_resid, report):
    """Hold the p2p kernel against its plain version; time both."""
    import torch
    from lsd_tpu_torch.ops.p2p import _launch, launch_shape, p2p_reduce, p2p_reduce_plain

    n_full = args[0].shape[0]
    zero_w = torch.zeros_like(args[3])
    cases = [("N=%d est_ext=0" % n_full, args, False),
             ("N=%d est_ext=1" % n_full, args, True),
             ("N=%d ragged est_ext=0" % (n_full - 37),
              tuple(a[:n_full - 37] if a.dim() and a.shape[0] == n_full else a
                    for a in args), False),
             ("N=%d ragged est_ext=1" % (n_full - 37),
              tuple(a[:n_full - 37] if a.dim() and a.shape[0] == n_full else a
                    for a in args), True),
             ("N=%d all-masked" % n_full, args[:3] + (zero_w,) + args[4:], False)]
    blocks, threads = launch_shape(args[0].device)
    if blocks == 16:
        # the 8-block cluster that a card without room for 16 falls back to
        # (called directly: these launches are not the main path's)
        cases += [(f"{name}, 8-block cluster", a, est, 8) for name, a, est in cases[:2]]
    max_err = 0.0
    for name, a, est, *cluster in cases:
        if cluster:
            call = lambda: tuple(_launch(a, max_resid, est, cluster[0]).split_with_sizes(
                (24 * 24, 24, 3)))
        else:
            call = lambda: p2p_reduce(*a, max_resid, est_extrinsic=est)
        HtH, Htr, st = call()
        HtH2, Htr2, st2 = call()
        HtH, HtH2 = HtH.view(24, 24), HtH2.view(24, 24)
        torch.cuda.synchronize()
        if not (torch.equal(HtH, HtH2) and torch.equal(Htr, Htr2) and torch.equal(st, st2)):
            fail(f"p2p_reduce {name}: two launches differ bitwise")
        rH, rr, rs = p2p_reduce_plain(*a, max_resid, est_extrinsic=est)
        err_H = float((HtH - rH).abs().max())
        err_r = float((Htr - rr).abs().max())
        tol_H = 1e-5 * float(rH.abs().max())
        tol_r = 1e-4 * max(float(rr.abs().max()), 1.0)
        nv, rnv = float(st[0]), float(rs[0])
        # n_valid is exact: the kernel, built without FMA contraction, rounds
        # each operation of the gate as the plain version does
        ok = (err_H <= tol_H and err_r <= tol_r and nv == rnv
              and abs(float(st[1]) - float(rs[1])) <= 1e-5 * abs(float(rs[1])) + 1e-6
              and abs(float(st[2]) - float(rs[2])) <= 1e-5 * abs(float(rs[2])) + 1e-6)
        log(f"p2p_reduce {name}: n_valid {nv:.0f} (plain {rnv:.0f}) "
            f"|dHtH| {err_H:.3e} <= {tol_H:.3e}, |dHtr| {err_r:.3e} <= {tol_r:.3e}, "
            f"sum|r| {float(st[1]):.6g} (plain {float(rs[1]):.6g}), bitwise repeatable")
        if not ok:
            fail(f"p2p_reduce {name}: kernel disagrees with its plain version")
        max_err = max(max_err, err_H, err_r)
    check_p2p_graph(args, max_resid)

    # times at the main path's shape and flag: device time per call of the
    # kernel (of all the plain version's kernels), and each call's time
    # between CUDA events; the launch floor is the device time of a
    # one-element op
    ms, per_call = device_ms(lambda: p2p_reduce(*args, max_resid), match="p2p_")
    if per_call != 1:
        fail(f"p2p_reduce: the profiler saw {per_call} p2p_ kernels per call, expected 1")
    plain_ms, plain_kernels = device_ms(lambda: p2p_reduce_plain(*args, max_resid))
    one = torch.zeros(1, device=args[0].device)
    floor_ms, _ = device_ms(lambda: one.add_(1.0))
    ms_8 = (device_ms(lambda: _launch(args, max_resid, False, 8), match="p2p_")[0]
            if blocks == 16 else None)
    call_ms = time_ms(lambda: p2p_reduce(*args, max_resid))
    plain_call_ms = time_ms(lambda: p2p_reduce_plain(*args, max_resid))
    n = args[0].shape[0]
    n_valid = float(p2p_reduce_plain(*args, max_resid)[2][0])
    in_bytes = n * 8 * 4 + 24 * 4                 # points, normals, d, weight; pose
    out_bytes = (24 * 24 + 24 + 3) * 4
    ops = n_valid * P2P_OPS_VALID + (n - n_valid) * P2P_OPS_GATE
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    log(f"p2p_reduce N={n}: device time per call: kernel {ms:.5f} ms ({per_call:.0f} "
        f"launch, one cluster of {blocks} blocks x {threads} threads; an 8-block "
        f"cluster: {'-' if ms_8 is None else f'{ms_8:.5f}'} ms), plain {plain_ms:.5f} ms ({plain_kernels} kernels); call time "
        f"(CUDA events, median of {N_TIMING}): kernel {call_ms:.4f} ms, plain "
        f"{plain_call_ms:.4f} ms; bound {max(t_bytes, t_ops):.6f} ms "
        f"({in_bytes + out_bytes} B, {ops:.0f} fp32 ops, {n_valid:.0f} valid); "
        f"launch floor {floor_ms:.5f} ms; no single PyTorch call computes this "
        f"function (library time: none)")
    report.update(name="p2p_reduce", route="cuda",
                  source="lsd_tpu_torch/csrc/p2p_reduce.cu",
                  replaces="lsd_tpu/ops/pallas_p2p.py:43",
                  max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  library_ms=None, floor_ms=floor_ms, call_ms=call_ms,
                  plain_call_ms=plain_call_ms, cluster_blocks=blocks, block_threads=threads,
                  ms_8_block_cluster=ms_8)


def check_p2p_graph(args, max_resid):
    """A call captured in a CUDA graph and replayed equals a direct call,
    bitwise, and the replay reads the inputs as they are at replay."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = tuple(a.clone() for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        p2p_reduce(*args, max_resid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = p2p_reduce(*args, max_resid)
    for scale in (1.0, 0.5):
        args[3].mul_(scale)
        graph.replay()
        direct = p2p_reduce(*args, max_resid)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(captured, direct)):
            fail(f"p2p_reduce: a CUDA-graph replay differs from a direct call (weights x{scale})")
    log("p2p_reduce: CUDA-graph replay equals a direct call bitwise, twice")


class EventTimer:
    """Wraps a function of ``module`` so that each call runs between two
    CUDA events; ``ms()`` gives the device-side milliseconds of each call."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.events, self.results, self.threads = [], [], []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kwargs)
        b.record()
        self.events.append((a, b))
        self.results.append(out)
        self.threads.append(threading.current_thread().name)
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def run_mapping(dev, card, lio_cfg, n_scans=N_MAPPING, points=CAP):
    """Phase 4: the mapping path; returns its report."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam import mapper as mapper_mod
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.tools.profile_lio import mapping_run, sync_sites

    t0 = time.perf_counter()
    _, data, nav0, mcfg = mapping_run(dev, n_scans, points, lio_cfg)
    log(f"mapping: made {len(data)} scans of {points} points in {time.perf_counter() - t0:.1f} s")
    mapper = mapper_mod.Mapper(mcfg, nav0)
    pgo = EventTimer(mapper_mod, "optimize")
    icp = EventTimer(mapper_mod, "icp_point_to_plane")
    syncs = {True: [], False: []}                  # by is_keyframe
    sync_sites_seen = {}
    p2p_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # scans arrive as host arrays, as the sensor delivers them
    for k, d in enumerate(data):
        step = lambda: mapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
        if k in SYNC_COUNT_SCANS:
            out, sites = sync_sites(step)
            syncs[out["is_keyframe"]].append(sum(sites.values()))
            for site, n in sites.items():
                sync_sites_seen[site] = sync_sites_seen.get(site, 0) + n
        else:
            step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p2p_reduce.launches
    if launches != lio_cfg.max_iters * n_scans:
        fail(f"mapping: p2p_reduce launched {launches} times over {n_scans} scans, "
             f"expected max_iters x scans = {lio_cfg.max_iters * n_scans}")
    loops_in_run = len(mapper.loops)
    with tempfile.TemporaryDirectory() as tmp:
        mapper.save(tmp)                           # runs one more PGO
        loaded = load_map(tmp)
    pgo.restore()
    icp.restore()
    pgo_ms, icp_ms = pgo.ms(), icp.ms()

    n_kf = len(mapper.store)
    if not n_kf > 15:
        fail(f"mapping: {n_kf} keyframes, expected more than 15")
    if mapper.loop_stats["accepted"] < 1:
        fail(f"mapping: no loop was accepted; loop_stats {mapper.loop_stats}")
    traj = mapper.trajectory()
    gt = np.stack([d[5] for d in data])
    if traj.shape != (n_scans, 4, 4) or not np.isfinite(traj).all():
        fail(f"mapping: trajectory of shape {traj.shape} is not {n_scans} finite poses")
    rmse = float(np.sqrt(np.mean(np.sum((traj[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
    if not rmse < MAPPING_RMSE_LIMIT_M:
        fail(f"mapping: trajectory RMSE {rmse} m is not below {MAPPING_RMSE_LIMIT_M} m")
    all_costs = check_pgo_costs("mapping", pgo.results, flat=(len(pgo.results) - 1,))
    if len(loaded["poses"]) != n_kf or len(loaded["edges"]) < n_kf - 1:
        fail(f"mapping: the saved map loads {len(loaded['poses'])} poses and "
             f"{len(loaded['edges'])} edges for {n_kf} keyframes")
    for T, kf in zip(loaded["poses"], mapper.store.frames):
        if not np.allclose(T, kf.pose, atol=1e-5):
            fail(f"mapping: keyframe {kf.id}'s pose does not survive save and load")
    report = dict(
        card=card, scans=n_scans, points_per_scan=points,
        ms_per_scan=dt / n_scans * 1e3, scans_per_s=n_scans / dt,
        keyframes=n_kf, loops=loops_in_run, loop_stats=mapper.loop_stats,
        rmse_m=rmse, pgo_solves=len(pgo_ms), pgo_ms_median=float(np.median(pgo_ms)),
        pgo_ms_max=float(np.max(pgo_ms)),
        pgo_costs_first_last=all_costs[:, [0, -1]].tolist(),
        icp_candidates=len(icp_ms),
        icp_ms_per_candidate=float(np.median(icp_ms)) if icp_ms else None,
        host_syncs_per_keyframe_scan=float(np.mean(syncs[True])) if syncs[True] else None,
        host_syncs_per_other_scan=float(np.mean(syncs[False])) if syncs[False] else None,
        host_sync_sites=sync_sites_seen, p2p_launches=launches,
        loaded_poses=len(loaded["poses"]), loaded_edges=len(loaded["edges"]))
    log(f"mapping, {n_scans} scans of {points} points on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, {n_kf} keyframes, {loops_in_run} loops, "
        f"loop_stats {mapper.loop_stats}, RMSE {rmse:.4f} m, PGO {len(pgo_ms)} solves "
        f"median {report['pgo_ms_median']:.1f} ms, ICP {len(icp_ms)} candidates median "
        f"{report['icp_ms_per_candidate']} ms, host syncs per scan "
        f"{report['host_syncs_per_keyframe_scan']} (keyframe) / "
        f"{report['host_syncs_per_other_scan']} (other), p2p_reduce launches {launches}")

    report["async"] = run_mapping_async(mapper_mod, mcfg, nav0, data, gt)
    return report


def check_pgo_costs(where, results, flat=()):
    """Every solve's costs are finite and its last round's is not above its
    first's; returns them as an array (one fetch).  The solves numbered in
    ``flat`` start from an optimized graph, where the cost is flat, so only
    their comparison allows float32 rounding of the sum."""
    import torch
    all_costs = torch.stack([info["costs"] for _, info in results]).cpu().numpy()
    for k, costs in enumerate(all_costs):
        rtol = PGO_COST_RTOL if k in flat else 0.0
        if not (np.isfinite(costs).all() and costs[-1] <= costs[0] * (1.0 + rtol)):
            fail(f"{where}: PGO solve {k}'s costs {costs.tolist()} are not finite and "
                 "non-increasing from first to last")
    return all_costs


def run_mapping_async(mapper_mod, mcfg, nav0, data, gt):
    """The same drive with the background graph worker and the pipelined
    fetch.  The worker prints what a job raises and goes on, and the poses
    come from the odometry thread, so a finite trajectory says nothing of
    the worker: the checks below hold it to having done every keyframe's
    graph work itself, on the card, with nothing raised and nothing dropped."""
    import dataclasses
    import torch
    n = len(data)
    t0 = time.perf_counter()
    amapper = mapper_mod.Mapper(dataclasses.replace(mcfg, async_graph=True, async_fetch=True),
                                nav0)
    timers = {name: EventTimer(mapper_mod, name)
              for name in ("optimize", "icp_point_to_plane", "sc_query")}
    for k, d in enumerate(data):
        amapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
    amapper.flush()
    dt = time.perf_counter() - t0
    for t in timers.values():
        t.restore()
    worker = amapper._worker
    amapper.close()
    if worker.is_alive():
        fail("mapping (async): the graph worker is still alive after close()")
    if amapper.worker_errors:
        fail(f"mapping (async): the graph worker's jobs raised {amapper.worker_errors!r}")
    if "dropped_jobs" in amapper.loop_stats:
        fail(f"mapping (async): graph jobs were dropped; loop_stats {amapper.loop_stats}")
    n_kf = len(amapper.store)
    if amapper.sc_ids != list(range(n_kf)):
        fail(f"mapping (async): the worker added {len(amapper.sc_ids)} descriptors for "
             f"{n_kf} keyframes")
    for name, t in timers.items():
        if not t.threads or set(t.threads) != {worker.name}:
            fail(f"mapping (async): {name} ran {len(t.threads)} times on threads "
                 f"{sorted(set(t.threads))}, expected at least once and only on {worker.name}")
    if amapper.loop_stats["accepted"] < 1:
        fail(f"mapping (async): no loop was accepted; loop_stats {amapper.loop_stats}")
    icp_poses = torch.stack([torch.cat(out[:2]) for out in timers["icp_point_to_plane"].results])
    if not bool(torch.isfinite(icp_poses).all()):
        fail("mapping (async): an ICP on the worker thread gave a non-finite pose")
    check_pgo_costs("mapping (async)", timers["optimize"].results)
    atraj = amapper.trajectory()
    if atraj.shape != (n, 4, 4) or not np.isfinite(atraj).all():
        fail(f"mapping (async): trajectory of shape {atraj.shape} is not {n} finite poses")
    rmse = float(np.sqrt(np.mean(np.sum((atraj[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
    if not rmse < MAPPING_RMSE_LIMIT_M:
        fail(f"mapping (async): trajectory RMSE {rmse} m is not below {MAPPING_RMSE_LIMIT_M} m")
    report = dict(scans=n, keyframes=n_kf, ms_per_scan=dt / n * 1e3, rmse_m=rmse,
                  loops=len(amapper.loops), loop_stats=amapper.loop_stats,
                  worker_errors=0, worker_pgo_solves=len(timers["optimize"].threads),
                  worker_icp_candidates=len(timers["icp_point_to_plane"].threads),
                  worker_sc_queries=len(timers["sc_query"].threads))
    log(f"mapping (async_graph, async_fetch), {n} scans: {report['ms_per_scan']:.2f} ms/scan, "
        f"{n_kf} keyframes and as many descriptors, {report['loops']} loops, loop_stats "
        f"{amapper.loop_stats}, RMSE {rmse:.4f} m; on the worker thread {report['worker_sc_queries']} "
        f"ScanContext queries, {report['worker_icp_candidates']} ICP verifications and "
        f"{report['worker_pgo_solves']} PGO solves, none raised, none dropped; flush() and "
        "close() returned, the worker has ended")
    return report


def run_points(dev, card, cfg, nav0, scans, gt, n_scans=N_POINTS):
    """Phase 5: the LIO step with the raw-point map; returns its report."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.lio import lio_init, lio_step
    from lsd_tpu_torch.utils.metrics import ate_rmse

    cfg = cfg._replace(map_type="points", map_capacity=2 ** 17)
    st = lio_init(cfg, nav0)
    poses = []
    p2p_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[:n_scans]:
        st, info = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p2p_reduce.launches
    if launches != cfg.max_iters * n_scans:
        fail(f"raw-point map: p2p_reduce launched {launches} times over {n_scans} scans, "
             f"expected max_iters x scans = {cfg.max_iters * n_scans}")
    if not all(bool(torch.isfinite(x).all()) for x in (*st.nav, st.P, st.map.points)):
        fail("raw-point map: the filter state is not finite")
    est = np.tile(np.eye(4), (n_scans, 1, 1))
    est[:, :3, 3] = torch.stack(poses).cpu().numpy()
    ate = ate_rmse(est, gt[:n_scans], warmup=5)
    if not ate < ATE_LIMIT_M:
        fail(f"raw-point map: ATE {ate} m is not below {ATE_LIMIT_M} m")
    report = dict(card=card, scans=n_scans, points_per_scan=scans[0][0].shape[0],
                  ms_per_scan=dt / n_scans * 1e3, ate_m=ate,
                  num_valid=int(info["num_valid"]),
                  map_voxels=int((st.map.keys >= 0).sum()), p2p_launches=launches)
    log(f"lio_step with map_type='points', {n_scans} scans on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, ATE {ate:.5f} m, num_valid "
        f"{report['num_valid']}, {report['map_voxels']} voxels, p2p_reduce launches {launches}")
    return report


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script runs only on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lsd_tpu_torch.ops.p2p import p2p_reduce
        from lsd_tpu_torch.slam.lio import lio_step
        from lsd_tpu_torch.utils import cuda_build
        from lsd_tpu_torch.utils.metrics import ate_rmse
        from lsd_tpu_torch.utils.precision import set_slam_precision
    except ImportError as exc:
        fail(f"the lsd_tpu_torch package is not beside this script ({exc})")

    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")
    set_slam_precision()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda_build.build("p2p_reduce")
    log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
    ptxas = lib.parent / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas: " + line.strip())

    # ---- 2. warm-up, then kernels against their plain versions ----------
    t0 = time.perf_counter()
    cfg, nav0, scans, gt = make_run(dev)
    log(f"made {len(scans)} scans of {CAP} points in {time.perf_counter() - t0:.1f} s")
    from lsd_tpu_torch.slam.lio import lio_init
    st = lio_init(cfg, nav0)
    poses = []
    for scan in scans[:N_WARM]:
        st, _ = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    p2p_report = {}
    check_p2p(p2p_inputs(cfg, st, scans[N_WARM]), cfg.max_resid, p2p_report)
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    sites = sync_sites(lambda: lio_step(cfg, st, *scans[N_WARM]))[1]
    syncs = sum(sites.values())
    log(f"host syncs in one lio_step: {syncs}; by site {sites}")

    # ---- 3. the main path ------------------------------------------------
    p2p_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[N_WARM:]:
        st, info = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p2p_reduce.launches
    if launches != cfg.max_iters * N_BENCH:
        fail(f"p2p_reduce launched {launches} times over {N_BENCH} scans, "
             f"expected max_iters x scans = {cfg.max_iters * N_BENCH}")
    finite = all(bool(torch.isfinite(x).all()) for x in (*st.nav, st.P))
    if not finite:
        fail("the filter state is not finite after the main path")
    est = np.tile(np.eye(4), (len(poses), 1, 1))
    est[:, :3, 3] = torch.stack(poses).cpu().numpy()
    # warm-up 22 of the timed scans, as bench.py scores its trajectory
    ate = ate_rmse(est[N_WARM:], gt[N_WARM:], warmup=22)
    if not ate < ATE_LIMIT_M:
        fail(f"ATE {ate} m is not below {ATE_LIMIT_M} m")
    log(f"lio_step, {N_BENCH} scans of {CAP} points on {card}: "
        f"{N_BENCH / dt:.2f} scans/s, {dt / N_BENCH * 1e3:.3f} ms/scan, "
        f"ATE {ate:.5f} m, num_valid {int(info['num_valid'])}, "
        f"p2p_reduce launches {launches}")

    lio_report = {"card": card, "scans": N_BENCH, "points_per_scan": CAP,
                  "scans_per_s": N_BENCH / dt, "ms_per_scan": dt / N_BENCH * 1e3,
                  "ate_m": ate, "host_syncs_per_scan": syncs}
    p2p_report["launches"] = launches
    del st

    # ---- 4. the mapping path, 5. the raw-point LIO path --------------------
    mapping_report = run_mapping(dev, card, cfg)
    p2p_report["launches_mapping"] = mapping_report["p2p_launches"]
    points_report = run_points(dev, card, cfg, nav0, scans, gt)
    p2p_report["launches_points"] = points_report["p2p_launches"]

    print(json.dumps({"lio_step": lio_report}))
    print(json.dumps({"mapping": mapping_report}))
    print(json.dumps({"lio_step_points": points_report}))
    print(card)
    print(json.dumps({"kernels": [p2p_report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
