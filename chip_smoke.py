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

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  It has no CPU path:
without a card, or without the ``lsd_tpu_torch`` package beside it, it fails.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

N_WARM, N_BENCH = 5, 100
CAP, IMU_CAP = 2 ** 15, 16
ATE_LIMIT_M = 0.1
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
    from lsd_tpu_torch.geometry import so3
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig
    from lsd_tpu_torch.slam.state import init_state

    sim = CircleSim(SimConfig(n_scans=N_WARM + N_BENCH, points_per_scan=CAP,
                              point_noise=0.01, seed=7))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    R, p = sim.pose(0.0)
    nav0 = init_state(device=dev)._replace(
        pos=torch.tensor(p, dtype=torch.float32, device=dev),
        quat=so3.matrix_to_quat(torch.tensor(R, dtype=torch.float32, device=dev)),
        vel=torch.tensor(sim.velocity(0.0), dtype=torch.float32, device=dev))
    cfg = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                    scan_voxel=0.4, map_voxel=0.4, max_iters=4)
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

    print(json.dumps({"lio_step": {"card": card, "scans": N_BENCH,
                                   "points_per_scan": CAP,
                                   "scans_per_s": N_BENCH / dt,
                                   "ms_per_scan": dt / N_BENCH * 1e3,
                                   "ate_m": ate, "host_syncs_per_scan": syncs}}))
    p2p_report["launches"] = launches
    print(card)
    print(json.dumps({"kernels": [p2p_report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
