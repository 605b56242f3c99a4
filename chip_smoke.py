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
   and its last round's not above its first's (``save()``'s solve starts
   from an optimized graph, where the float32 costs only wander: the cost
   before and after it is compared in float64; a drive's first solve, of a
   chain with no loop yet, starts at zero cost and must stay under the
   rounding floor), the loaded map whole, and
   the p2p kernel launched ``max_iters`` times per scan.  Then the same 95 scans
   with the background graph worker and the pipelined fetch, ending in a
   clean ``flush()`` and ``close()``: the worker raised nothing, dropped no
   job, added a descriptor for every keyframe, and every ScanContext query,
   ICP verification and PGO solve ran on its thread, with at least one loop
   accepted and the same trajectory bar.
5. The raw-point LIO path: 30 of phase 2's scans with
   ``map_type="points"`` (finite state, ATE < 0.1 m, the p2p kernel
   launched ``max_iters`` times per scan).
6. The localization path at full width, on the map directory phase 4 saved:
   ``lsd_tpu_torch.slam.localization.Localizer`` with ``LocalizerConfig()``
   defaults (the side LIO on: 8,192 residual points, 3 iterations; tracking
   scan downsampled to 8,192 at 0.4 m; NDT map of 2**16 slots at 1 m, surfel
   map of 2**17 at 0.5 m), a pose hint ~1 m off, then 70 scans of 32,768
   points that the mapping run did not see, from rest up to the mapping
   run's speed, each with its stamps, its 16 IMU samples and the newest
   sample, as the runtime feeds them.  Checks: initialised from the hint,
   every later scan ``tracking``, position RMSE against the simulator's
   truth after the first 3 poses < 1.0 m and the last four errors within
   0.1 m of each other (the reference test's bars), the side LIO's
   increments in use after its 10 warm-up scans, at least one recentre of
   the local map, and the p2p kernel launched 3 times per scan; the kernel
   is then held against its plain version at this path's shape too (8,192
   points, on the side LIO's own state).  Then the drive's first 25 scans
   without stamps and IMU batch (IMU-driven prediction, 15 NDT searches),
   same bars, no p2p launch.  Reported and not judged: both modes on the
   reference test's own drive, begun at the mapping run's speed (a filter
   that starts cold at 6.4 m/s is a weak spot of the reference, which the
   port reproduces), and global relocalization without a hint through
   ``Localizer.process_scan`` on a fresh localizer, for the drive's last
   scan, for the sweep a keyframe was made from and for that keyframe's
   stored cloud (the ring world is ambiguous to ScanContext).  Last, ``localize_track_step`` alone, 50 calls with a
   fetch each and 50 with one fetch at the end, which must make no host
   sync.
7. RTK mapping: ``RtkMapper`` over phase 4's scans with fixes made from the
   simulator's poses through ``geometry/utm.py`` (at least 20 keyframes,
   every scan's pose equal to its interpolated fix); and ``IcpOdometry``
   with its default config on 25 scans of 32,768 points of the reference
   test's slow 10 m circle (relative-motion ATE after the first two scans
   < 0.35 m).

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
# allowed relative rise of the float64 cost over a solve that starts from an
# optimized graph (save()'s): see check_pgo_costs.  The poses come back in
# float32, and rounding them alone moved that cost by -8.6e-5 ... +9.6e-5 in
# eight runs on an H100 80GB HBM3 at 700 W; the most it could move it is
# printed beside each reading (~1e-2).
PGO_FLAT_COST_RTOL = 1e-3
SYNC_COUNT_SCANS = range(40, 46)    # mapping scans whose host syncs are counted
N_TIMING = 100                      # launches per timing (median reported)
N_LOC, N_LOC_IMU, N_TRACK_CALLS = 70, 25, 50
LOC_T_START = 0.037                 # keeps the drive off the stamps the mapping run saw
N_LOC_CRUISE, N_LOC_CRUISE_IMU, CRUISE_T_START = 25, 15, 3.037
LOC_RMSE_LIMIT_M, LOC_TAIL_STEP_M = 1.0, 0.1
LOC_SYNC_SCANS = range(40, 46)      # localization scans whose host syncs are counted
N_ICP_ODOM, ICP_ODOM_ATE_LIMIT_M = 25, 0.35
RTK_MIN_KEYFRAMES, RTK_POSE_ATOL_M = 20, 1e-4
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


def device_ms(fn, match="", n=N_TIMING, tries=5, required=True):
    """(device ms, kernels) per ``fn()``: the summed time and the count of
    the kernels whose name contains ``match`` that n calls launch, from the
    profiler's device trace, over n.  The profiler now and then drops a
    couple of kernel records from a trace, so only a trace that holds the
    same whole number of kernels for every call counts; another is taken
    again, up to ``tries`` times.  If none is whole the run fails, or, when
    the time is not ``required``, (None, 0) is returned."""
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
    msg = (f"the profiler recorded {count} kernels matching {match!r} for {n} calls "
           f"in the last of {tries} traces")
    if required:
        fail(msg)
    log(msg + "; no device time taken")
    return None, 0


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


def compare_p2p(args, max_resid):
    """Hold the p2p kernel against its plain version on ``args``, with and
    without the extrinsic block, on a ragged length, all points masked, and
    in the 8-block cluster; returns the largest absolute error."""
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
    return max_err


def check_p2p(args, max_resid, report):
    """Hold the p2p kernel against its plain version; time both."""
    import torch
    from lsd_tpu_torch.ops.p2p import _launch, launch_shape, p2p_reduce, p2p_reduce_plain

    max_err = compare_p2p(args, max_resid)
    check_p2p_graph(args, max_resid)
    blocks, threads = launch_shape(args[0].device)

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


class CallTimer:
    """Replaces ``owner.name`` by a wrapper that times each call, until
    ``restore()``: between two CUDA events (``ms()`` then gives device-side
    milliseconds) or, with ``host=True``, on the host clock between two
    synchronizes.  Keeps each call's arguments, result and thread."""

    def __init__(self, owner, name, host=False):
        self.owner, self.name, self.fn, self.host = owner, name, getattr(owner, name), host
        self.spans, self.args, self.results, self.threads = [], [], [], []
        setattr(owner, name, self)

    def __call__(self, *args, **kwargs):
        import torch
        if self.host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.spans.append((time.perf_counter() - t0) * 1e3)
        else:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(*args, **kwargs)
            b.record()
            self.spans.append((a, b))
        self.args.append(args)
        self.results.append(out)
        self.threads.append(threading.current_thread().name)
        return out

    def restore(self):
        setattr(self.owner, self.name, self.fn)

    def ms(self):
        import torch
        if self.host:
            return list(self.spans)
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]


def run_mapping(dev, card, lio_cfg, map_dir, n_scans=N_MAPPING, points=CAP):
    """Phase 4: the mapping path, its map saved into ``map_dir``; returns
    (report, the simulator, the scans)."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam import mapper as mapper_mod
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.tools.profile_lio import mapping_run, sync_sites

    t0 = time.perf_counter()
    sim, data, nav0, mcfg = mapping_run(dev, n_scans, points, lio_cfg)
    log(f"mapping: made {len(data)} scans of {points} points in {time.perf_counter() - t0:.1f} s")
    mapper = mapper_mod.Mapper(mcfg, nav0)
    pgo = CallTimer(mapper_mod, "optimize")
    icp = CallTimer(mapper_mod, "icp_point_to_plane")
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
    mapper.save(map_dir)                           # runs one more PGO
    loaded = load_map(map_dir)
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
    all_costs = check_pgo_costs("mapping", pgo, flat=(len(pgo.results) - 1,))
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
    return report, sim, data


def pgo_cost64(graph, cfg):
    """The cost that ``optimize`` reports for ``graph`` at the poses it
    holds (robust weights taken at those poses), evaluated in float64."""
    import torch
    from lsd_tpu_torch.slam import posegraph as pg
    if bool(graph.gps.mask.any() | graph.floor.mask.any() | graph.orient.mask.any()):
        fail("pgo_cost64 sums SE3 edges only, and this graph holds a prior")
    f64 = lambda t: t.to(torch.float64)
    nodes = graph.nodes._replace(quat=f64(graph.nodes.quat), pos=f64(graph.nodes.pos))
    se3 = graph.se3._replace(q_meas=f64(graph.se3.q_meas), t_meas=f64(graph.se3.t_meas),
                             sqrt_info=f64(graph.se3.sqrt_info))
    r = pg._se3_residual(nodes, se3, torch.zeros_like(nodes.pos).repeat(1, 2))
    w = pg._huber_weights(r, cfg.huber_delta)
    if cfg.dcs_phi > 0:
        is_loop = torch.abs(se3.idx[:, 0] - se3.idx[:, 1]) > 1
        s2 = torch.clamp(2.0 * cfg.dcs_phi / (cfg.dcs_phi + torch.sum(r ** 2, dim=-1)), max=1.0)
        w = w * torch.where(is_loop, torch.sqrt(s2), 1.0)
    return float(torch.sum((r * w[:, None]) ** 2))


def pgo_rounding_floor(graph):
    """The cost that ``graph`` would show if every SE3 edge's residual were
    off by one float32 spacing at the size of its poses' coordinates: the sum
    over the edges of ``|sqrt_info|^2 * (eps * max(1, max |pos|))^2``.  A cost
    under it cannot be told from rounding."""
    import torch
    scale = max(1.0, float(graph.nodes.pos[graph.nodes.mask].abs().max()))
    info = torch.sum(graph.se3.sqrt_info[graph.se3.mask].double() ** 2)
    return float(info) * (torch.finfo(torch.float32).eps * scale) ** 2


def check_pgo_costs(where, solves, flat=()):
    """Every solve's costs are finite and its last round's is not above its
    first's; returns them as an array (one fetch).  ``solves`` is the
    ``CallTimer`` that wrapped ``optimize``.

    The solves numbered in ``flat`` start from an optimized graph.  There
    the float32 costs that ``optimize`` reports only wander: a residual is
    millimetres, the difference of poses metres from the origin whose
    float32 spacing is a micrometre, so each cost carries ~1e-3 relative
    rounding, and Gauss-Newton has no step acceptance to hide it.  Those
    solves are judged by the cost of the graph they were given and of the
    graph they returned, both evaluated in float64, which may rise by
    PGO_FLAT_COST_RTOL at most.  Beside it goes the most that rounding every
    pose to the nearest float32 could change that cost, ``sqrt(cost * floor)
    + floor / 4`` with ``floor`` from ``pgo_rounding_floor`` (half a spacing
    on every edge, all with the worst sign).

    A solve whose first cost is already under ``pgo_rounding_floor`` (the
    first of a drive: a chain of odometry edges and no loop yet, which is at
    its optimum of zero as it stands) reports rounding and nothing else.  It
    is held to staying under that floor in every round."""
    import torch
    all_costs = torch.stack([info["costs"] for _, info in solves.results]).cpu().numpy()
    for k, costs in enumerate(all_costs):
        if not np.isfinite(costs).all():
            fail(f"{where}: PGO solve {k}'s costs {costs.tolist()} are not finite")
        floor = pgo_rounding_floor(solves.args[k][0])
        if costs[0] <= floor:
            log(f"{where}: PGO solve {k} starts at its optimum: costs {costs.tolist()} "
                f"against a rounding floor of {floor:.3g}")
            if costs.max() > floor:
                fail(f"{where}: PGO solve {k} began under the rounding floor {floor:.3g} "
                     f"and left it: costs {costs.tolist()}")
            continue
        if k in flat:
            graph_in, cfg = solves.args[k]
            before, after = pgo_cost64(graph_in, cfg), pgo_cost64(solves.results[k][0], cfg)
            log(f"{where}: PGO solve {k} starts from an optimized graph: cost in float64 "
                f"{before:.8g} -> {after:.8g} (relative change {(after - before) / before:+.2e}); "
                f"as reported in float32 {costs[0]:.8g} -> {costs[-1]:.8g} "
                f"({(costs[-1] - costs[0]) / costs[0]:+.2e}, largest round-to-round swing "
                f"{np.max(np.abs(np.diff(costs))) / costs[0]:.2e}); rounding the poses to "
                f"float32 can move the float64 cost by at most "
                f"{(np.sqrt(before * floor) + floor / 4) / before:.2e} of it")
            ok = np.isfinite(after) and after <= before * (1.0 + PGO_FLAT_COST_RTOL)
        else:
            ok = costs[-1] <= costs[0]
        if not ok:
            fail(f"{where}: PGO solve {k}'s costs {costs.tolist()} do not fall from first to "
                 "last")
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
    timers = {name: CallTimer(mapper_mod, name)
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
    check_pgo_costs("mapping (async)", timers["optimize"])
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


def check_tracking(where, outs, errs, n_scans):
    """The reference test's bars on a localization drive; returns the RMSE."""
    if outs[0]["status"] != "initialized":
        fail(f"{where}: the first scan returned {outs[0]['status']!r}, not 'initialized'")
    bad = [(k, o["status"]) for k, o in enumerate(outs[1:], 1) if o["status"] != "tracking"]
    if bad or len(outs) != n_scans:
        fail(f"{where}: scans that are not 'tracking': {bad} of {len(outs)}")
    if not all(np.isfinite(o["pose"]).all() and o["pose"].shape == (4, 4) for o in outs):
        fail(f"{where}: a pose is not a finite 4x4")
    rmse = float(np.sqrt(np.mean(np.square(errs[3:]))))
    if not rmse < LOC_RMSE_LIMIT_M:
        fail(f"{where}: position RMSE {rmse} m after the first 3 poses is not below "
             f"{LOC_RMSE_LIMIT_M} m; errors {errs}")
    if not np.all(np.abs(np.diff(errs[-4:])) < LOC_TAIL_STEP_M):
        fail(f"{where}: the last four errors {errs[-4:]} differ by {LOC_TAIL_STEP_M} m or more")
    return rmse


def follow(loc, drive, scans, side_lio, t_start=LOC_T_START):
    """Feed ``scans`` of ``drive`` to ``loc``, with their stamps and IMU batch
    if ``side_lio``; returns (outputs, position errors in m (NaN where a
    scan gave no pose), host ms per scan).  With the side LIO the scan is
    undistorted to its end, so the pose is held against the truth there;
    without it the raw sweep is matched and the pose is held against the
    truth at the sweep's start, as the reference test holds it."""
    import torch
    from lsd_tpu_torch.tools.profile_lio import drive_localizer
    outs, errs, ms = [], [], []
    feed = drive_localizer(loc, drive, scans, t_start, side_lio=side_lio)
    for k in range(len(scans)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = next(feed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        truth = scans[k][5][:3, 3] if side_lio else drive.pose(t_start + k * 0.1)[1]
        outs.append(out)
        errs.append(float(np.linalg.norm(out["pose"][:3, 3] - truth))
                    if out["pose"] is not None else float("nan"))
    return outs, errs, ms


def run_localization(dev, card, map_dir, sim, map_data):
    """Phase 6: the localization path on the map phase 4 saved from the
    scans ``map_data`` of ``sim``."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam import localization as loc_mod
    from lsd_tpu_torch.tools.profile_lio import drive_localizer, localization_drive, sync_sites

    # ---- production mode: the side LIO's increments drive the filter -------
    t0 = time.perf_counter()
    # one scan more than the drive feeds: the kernel is held against its
    # plain version on it, at the side LIO's state after the drive
    drive, scans, hint = localization_drive(sim, N_LOC + 1, CAP)
    log(f"localization: made {len(scans)} scans of {CAP} points in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = loc_mod.LocalizerConfig()
    if not cfg.use_lio_odometry:
        fail("localization: LocalizerConfig() no longer runs the side LIO by default")
    t0 = time.perf_counter()
    loc = loc_mod.Localizer(map_dir, cfg)
    load_ms = (time.perf_counter() - t0) * 1e3
    loc.set_init_pose(hint)
    build = CallTimer(loc, "_build_local_map", host=True)
    reloc = CallTimer(loc, "_relocalize", host=True)
    track = CallTimer(loc_mod, "localize_track_step")
    outs, scan_ms, used, syncs, sync_sites_seen = [], [], [], {True: [], False: []}, {}
    p2p_reduce.launches = 0
    feed = drive_localizer(loc, drive, scans, LOC_T_START)
    for k in range(N_LOC):
        builds = len(build.spans)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k in LOC_SYNC_SCANS:
            (_, out), sites = sync_sites(lambda: next(feed))
            syncs[len(build.spans) > builds].append(sum(sites.values()))
            for site, n in sites.items():
                sync_sites_seen[site] = sync_sites_seen.get(site, 0) + n
        else:
            _, out = next(feed)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        used.append(k > 0 and loc.last_step_diag["has_odom"])
    launches = p2p_reduce.launches
    for timer in (track, build, reloc):
        timer.restore()
    track_ms, build_ms, reloc_ms = track.ms(), build.ms(), reloc.ms()
    if launches != cfg.lio.max_iters * N_LOC:
        fail(f"localization: p2p_reduce launched {launches} times over {N_LOC} scans, "
             f"expected the side LIO's max_iters x scans = {cfg.lio.max_iters * N_LOC}")
    errs = [float(np.linalg.norm(o["pose"][:3, 3] - s[5][:3, 3])) if o["pose"] is not None
            else float("nan") for o, s in zip(outs, scans)]
    rmse = check_tracking("localization", outs, errs, N_LOC)
    # the kernel against its plain version at the shape this path gives it:
    # the side LIO's own state after the drive, the next scan's first
    # iteration (after the count was read: these launches are not the path's)
    side_args = p2p_inputs(cfg.lio, loc._lio_state,
                           tuple(torch.as_tensor(a, device=dev) for a in scans[N_LOC][:5]))
    if side_args[0].shape[0] != cfg.lio.ds_capacity:
        fail(f"localization: the side LIO reduces {side_args[0].shape[0]} points, expected "
             f"ds_capacity = {cfg.lio.ds_capacity}")
    side_err = compare_p2p(side_args, cfg.lio.max_resid)
    # late in a long process the profiler may drop records in every trace:
    # the comparison above is the check, the device time is a reading
    side_ms, _ = device_ms(lambda: p2p_reduce(*side_args, cfg.lio.max_resid), match="p2p_",
                           required=False)
    side_call_ms = time_ms(lambda: p2p_reduce(*side_args, cfg.lio.max_resid))
    log(f"p2p_reduce at the side LIO's shape, N={cfg.lio.ds_capacity}: max abs error "
        f"{side_err:.3e}, device time per call {side_ms} ms, call time {side_call_ms:.4f} ms")
    if any(used[:10]) or not all(used[10:]):
        fail(f"localization: the side LIO's increments were used on scans "
             f"{[k for k, u in enumerate(used) if u]}, expected every scan after its 10 "
             "warm-up scans")
    if len(build_ms) < 2:
        fail(f"localization: the local map was built {len(build_ms)} times, expected the "
             "first build and at least one recentre")
    if len(track_ms) != N_LOC - 1 or len(reloc_ms) != 1:
        fail(f"localization: {len(track_ms)} track steps and {len(reloc_ms)} relocalizations "
             f"over {N_LOC} scans")
    steady = scan_ms[10:]
    report = dict(
        card=card, scans=N_LOC, points_per_scan=CAP, keyframes=len(loc.store),
        load_map_and_descriptors_ms=load_ms,
        ms_per_process_scan_median=float(np.median(steady)),
        ms_per_process_scan_min=float(np.min(steady)),
        ms_per_process_scan_max=float(np.max(steady)),
        ms_per_track_step_median=float(np.median(track_ms[9:])),
        ms_per_track_step_min=float(np.min(track_ms[9:])),
        ms_per_track_step_max=float(np.max(track_ms[9:])),
        ms_per_build_local_map=[round(x, 2) for x in build_ms],
        ms_per_relocalization=reloc_ms[0],
        host_syncs_per_process_scan=float(np.mean(syncs[False])) if syncs[False] else None,
        host_syncs_per_recentring_scan=float(np.mean(syncs[True])) if syncs[True] else None,
        host_sync_sites=sync_sites_seen, rmse_m=rmse, max_err_m=float(np.max(errs[3:])),
        recentres=len(build_ms) - 1, p2p_launches=launches,
        p2p_at_side_lio_shape=dict(n=cfg.lio.ds_capacity, max_abs_err=side_err, ms=side_ms,
                                   call_ms=side_call_ms))
    log(f"localization (side LIO on), {N_LOC} scans of {CAP} points on {card}: "
        f"{report['ms_per_process_scan_median']:.2f} ms per process_scan (median of the "
        f"{len(steady)} after warm-up; {report['ms_per_process_scan_min']:.2f}-"
        f"{report['ms_per_process_scan_max']:.2f}), track step "
        f"{report['ms_per_track_step_median']:.2f} ms, local map builds "
        f"{report['ms_per_build_local_map']} ms, relocalization from the hint "
        f"{reloc_ms[0]:.1f} ms, host syncs per process_scan "
        f"{report['host_syncs_per_process_scan']} ({report['host_syncs_per_recentring_scan']} "
        f"when it recentres), RMSE {rmse:.4f} m, {report['recentres']} recentres, "
        f"p2p_reduce launches {launches}")

    # ---- IMU-driven prediction, no stamps and no IMU batch ------------------
    loc2 = loc_mod.Localizer(map_dir, cfg)
    loc2.set_init_pose(hint)
    track = CallTimer(loc_mod, "localize_track_step")
    p2p_reduce.launches = 0
    outs2, errs2, ms2 = follow(loc2, drive, scans[:N_LOC_IMU], side_lio=False)
    track.restore()
    if p2p_reduce.launches != 0:
        fail(f"localization (IMU prediction): p2p_reduce launched {p2p_reduce.launches} times "
             "with no side LIO running")
    rmse2 = check_tracking("localization (IMU prediction)", outs2, errs2, N_LOC_IMU)
    report["imu_prediction"] = dict(
        scans=N_LOC_IMU, rmse_m=rmse2, speed_at_the_end_m_s=float(np.linalg.norm(
            drive.velocity(LOC_T_START + (N_LOC_IMU - 1) * 0.1))),
        ms_per_process_scan_median=float(np.median(ms2[1:])),
        ms_per_track_step_median=float(np.median(track.ms())))
    log(f"localization (IMU-driven prediction, 15 NDT searches), {N_LOC_IMU} scans: "
        f"{report['imu_prediction']['ms_per_process_scan_median']:.2f} ms per process_scan, "
        f"track step {report['imu_prediction']['ms_per_track_step_median']:.2f} ms, "
        f"RMSE {rmse2:.4f} m")

    # ---- both modes begun at cruise: reported, not judged -------------------
    # The reference test's own drive (at the mapping run's speed, 3.037 s
    # into the lap).  A filter that starts cold at 6.4 m/s is a known weak
    # spot of the reference that the port reproduces: the side LIO has not
    # converged when its increments come into use, and at this point count
    # the IMU-driven filter settles metres off, all the while "tracking"
    # (tests/test_torch_localization_cruise.py holds both packages to it).
    cruise, cscans, chint = localization_drive(sim, N_LOC_CRUISE, CAP, t_start=CRUISE_T_START,
                                               rest_time=0.0, ramp_time=0.0)
    report["cruise_start"] = {}
    for mode, side_lio, n in (("imu_prediction", False, N_LOC_CRUISE_IMU),
                              ("side_lio", True, N_LOC_CRUISE)):
        loc3 = loc_mod.Localizer(map_dir, cfg)
        loc3.set_init_pose(chint)
        outs3, errs3, _ = follow(loc3, cruise, cscans[:n], side_lio, t_start=CRUISE_T_START)
        statuses = [o["status"] for o in outs3]
        report["cruise_start"][mode] = dict(
            scans=n, statuses={st: statuses.count(st) for st in sorted(set(statuses))},
            err_m=[None if np.isnan(e) else round(e, 3) for e in errs3])
        log(f"localization begun at cruise, {mode}, {n} scans (not judged): "
            f"{report['cruise_start'][mode]}")

    # ---- global relocalization without a hint, through the entry point ------
    # Not judged (the ring world is ambiguous to ScanContext), but it must
    # not raise: the drive's last scan; the raw sweep a keyframe was made
    # from; and that keyframe's stored cloud, whose descriptor is in the
    # database, so that the candidate passes and the ICP check runs.
    kf = loc.store.frames[len(loc.store) // 2]
    sweep = map_data[int(round(kf.stamp_us / 1e5))]
    kf_pts = np.zeros((1 << int(np.ceil(np.log2(len(kf.cloud)))), 3), np.float32)
    kf_pts[:len(kf.cloud)] = kf.cloud[:, :3]
    report["global_relocalization"] = {}
    for name, P, M, truth in (
            ("last_scan_of_the_drive", scans[N_LOC - 1][0], scans[N_LOC - 1][2],
             scans[N_LOC - 1][5]),
            ("sweep_of_a_keyframe", sweep[0], sweep[2], sweep[5]),
            ("stored_cloud_of_that_keyframe", kf_pts, np.arange(len(kf_pts)) < len(kf.cloud),
             kf.pose)):
        fresh = loc_mod.Localizer(map_dir, cfg)
        reloc = CallTimer(fresh, "_relocalize", host=True)
        out = fresh.process_scan(P, M, stamp_us=0)
        report["global_relocalization"][name] = dict(
            points=int(M.sum()), status=out["status"], ms=reloc.ms()[0], **fresh.last_reloc,
            err_m=None if out["pose"] is None
            else float(np.linalg.norm(out["pose"][:3, 3] - truth[:3, 3])))
        log(f"global relocalization without a hint, {name} (not judged): "
            f"{report['global_relocalization'][name]}")

    # ---- the tracking step alone --------------------------------------------
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    P, S, M = (torch.as_tensor(a, device=dev) for a in scans[N_LOC - 1][:3])
    z3 = f32([0.0, 0.0, 0.0])
    args = (loc.ukf, loc.ndt_map, loc.icp_map, P, M, f32(0.1), z3, z3, z3,
            torch.zeros((), dtype=torch.bool, device=dev), f32(4.0))
    kw = dict(odom_dq=f32([1.0, 0.0, 0.0, 0.0]), odom_dt=z3, gate_t=f32(1.0),
              gate_ang=f32(0.17), gps_gate=f32(2.5), stamps=S, ukf_cfg=cfg.ukf, has_odom=True,
              ndt_searches=cfg.ndt_searches_odom, track_voxel=cfg.track_voxel,
              track_capacity=cfg.track_capacity)
    step = lambda: loc_mod.localize_track_step(*args, **kw)
    _, sites = sync_sites(step)
    if sites:
        fail(f"localize_track_step made host syncs: {sites}")

    def timed(fetch_each):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(N_TRACK_CALLS):
            pose = step()[1]
            if fetch_each:
                pose.cpu()
        pose.cpu()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / N_TRACK_CALLS
    step()
    report["track_step_alone"] = dict(calls=N_TRACK_CALLS, host_syncs=0,
                                      ms_fetch_every_call=timed(True),
                                      ms_one_fetch_at_the_end=timed(False))
    log(f"localize_track_step alone, {N_TRACK_CALLS} calls: "
        f"{report['track_step_alone']['ms_fetch_every_call']:.2f} ms per call with a fetch "
        f"each, {report['track_step_alone']['ms_one_fetch_at_the_end']:.2f} ms with one fetch "
        "at the end, 0 host syncs inside it")
    return report


def run_rtkm(dev, card, sim, data, mcfg_kw):
    """Phase 7a: RTK-interpolated mapping over phase 4's scans."""
    import torch
    from lsd_tpu_torch.geometry.utm import UTMProjector, grid_convergence
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.mapper import MapperConfig
    from lsd_tpu_torch.slam.rtkm import RtkMapper

    # fixes at the simulator's poses every 0.1 s, through the projection and
    # back: lat/lon of the pose's offset from the first, heading in NED
    # degrees against true north (the mapper takes the grid convergence off)
    proj = UTMProjector()
    proj.project(42.0, -83.0)
    _, p0 = sim.pose(0.0)
    m = RtkMapper(MapperConfig(**mcfg_kw))
    n = len(data)
    for k in range(n + 2):
        R, p = sim.pose(k * 0.1)
        lat, lon = proj.unproject(p[0] - p0[0], p[1] - p0[1])
        yaw = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
        m.feed_ins(dict(timestamp=int(k * 1e5), latitude=float(lat), longitude=float(lon),
                        altitude=100.0 + p[2] - p0[2], pitch=0.0, roll=0.0,
                        heading=90.0 - yaw + grid_convergence(proj.lon0, float(lat), float(lon))))
    p2p_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst = 0.0
    for k, d in enumerate(data):
        out = m.process_scan(d[0], d[1], d[2], stamp_us=int(k * 1e5))
        if out["pose"] is None:
            fail(f"rtkm: scan {k} got no pose ({out['status']})")
        # the scan-end pose: the fix at (k + 1) * 0.1 s, in the frame that
        # starts at the first fix
        R, p = sim.pose((k + 1) * 0.1)
        worst = max(worst, float(np.abs(out["odom"][:3, 3] - (p - p0)).max()),
                    float(np.abs(out["odom"][:3, :3] - R).max()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not worst < RTK_POSE_ATOL_M:
        fail(f"rtkm: a scan's pose is {worst} off its interpolated fix, allowed "
             f"{RTK_POSE_ATOL_M}")
    n_kf = len(m.store)
    if n_kf < RTK_MIN_KEYFRAMES or m.graph.num_nodes != n_kf or m.sc_ids != list(range(n_kf)):
        fail(f"rtkm: {n_kf} keyframes, {m.graph.num_nodes} graph nodes, {len(m.sc_ids)} "
             f"descriptors; expected at least {RTK_MIN_KEYFRAMES} of each, all equal")
    if p2p_reduce.launches != 0:
        fail(f"rtkm: p2p_reduce launched {p2p_reduce.launches} times; RTK mapping runs no LIO")
    traj = m.trajectory()
    if traj.shape != (n, 4, 4) or not np.isfinite(traj).all():
        fail(f"rtkm: trajectory of shape {traj.shape} is not {n} finite poses")
    report = dict(card=card, scans=n, points_per_scan=data[0][0].shape[0],
                  ms_per_scan=dt / n * 1e3, keyframes=n_kf, loops=len(m.loops),
                  loop_stats=m.loop_stats, max_pose_minus_fix=worst,
                  origin_lla=[float(v) for v in m.origin_lla])
    log(f"rtkm, {n} scans on {card}: {report['ms_per_scan']:.2f} ms/scan, {n_kf} keyframes, "
        f"{len(m.loops)} loops, loop_stats {m.loop_stats}, poses within {worst:.2e} of their "
        "fixes")
    return report


def run_icp_odometry(dev, card):
    """Phase 7b: LiDAR-only odometry on the reference test's world."""
    import torch
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.icp_odometry import IcpOdometry, IcpOdometryConfig
    from lsd_tpu_torch.tools.profile_lio import sync_sites

    sim = CircleSim(SimConfig(radius=10.0, omega=0.15, n_scans=N_ICP_ODOM, points_per_scan=CAP,
                              seed=66))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    odo = IcpOdometry(IcpOdometryConfig())
    T0_inv = np.linalg.inv(data[0][5])
    errs, valid, syncs = [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, d in enumerate(data):
        if k == N_ICP_ODOM - 1:
            out, sites = sync_sites(lambda: odo.process_scan(d[0], d[2]))
            syncs = sum(sites.values())
        else:
            out = odo.process_scan(d[0], d[2])
        errs.append(float(np.linalg.norm(out["pose"][:3, 3] - (T0_inv @ d[5])[:3, 3])))
        valid.append(out["num_valid"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ate = float(np.sqrt(np.mean(np.square(errs[2:]))))
    if not (np.isfinite(errs).all() and ate < ICP_ODOM_ATE_LIMIT_M):
        fail(f"icp_odometry: relative-motion ATE {ate} m after the first two scans is not "
             f"below {ICP_ODOM_ATE_LIMIT_M} m; errors {errs}")
    if syncs != 1:
        fail(f"icp_odometry: a scan made {syncs} host syncs, expected its one packed fetch: "
             f"{sites}")
    report = dict(card=card, scans=N_ICP_ODOM, points_per_scan=CAP,
                  ms_per_scan=dt / N_ICP_ODOM * 1e3, ate_m=ate, num_valid_last=valid[-1], host_syncs_per_scan=syncs)
    log(f"icp_odometry, {N_ICP_ODOM} scans of {CAP} points on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, relative-motion ATE {ate:.4f} m, num_valid "
        f"{valid[-1]}, {syncs} host sync per scan")
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
    with tempfile.TemporaryDirectory() as map_dir:
        mapping_report, map_sim, map_data = run_mapping(dev, card, cfg, map_dir)
        p2p_report["launches_mapping"] = mapping_report["p2p_launches"]
        points_report = run_points(dev, card, cfg, nav0, scans, gt)
        p2p_report["launches_points"] = points_report["p2p_launches"]
        del scans

        # ---- 6. the localization path on that map --------------------------
        loc_report = run_localization(dev, card, map_dir, map_sim, map_data)
        p2p_report["launches_localization"] = loc_report["p2p_launches"]
        side = loc_report["p2p_at_side_lio_shape"]
        p2p_report["max_abs_err"] = max(p2p_report["max_abs_err"], side["max_abs_err"])
        p2p_report["ms_at_side_lio_shape"] = side["ms"]
        p2p_report["call_ms_at_side_lio_shape"] = side["call_ms"]

    # ---- 7. RTK mapping and LiDAR-only odometry ---------------------------
    rtkm_report = run_rtkm(dev, card, map_sim, map_data,
                           dict(lio=cfg, keyframe_delta_trans=1.5, optimize_every=8))
    icp_odom_report = run_icp_odometry(dev, card)

    print(json.dumps({"lio_step": lio_report}))
    print(json.dumps({"mapping": mapping_report}))
    print(json.dumps({"lio_step_points": points_report}))
    print(json.dumps({"localization": loc_report}))
    print(json.dumps({"rtkm": rtkm_report}))
    print(json.dumps({"icp_odometry": icp_odom_report}))
    print(card)
    print(json.dumps({"kernels": [p2p_report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
