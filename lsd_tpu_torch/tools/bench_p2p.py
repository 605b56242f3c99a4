"""Time the LIO iteration's measurement reduction by both routes
(counterpart of ``lsd_tpu/tools/bench_pallas.py``).

At bench shapes (32,768-point ``CircleSim`` scans, 16,384 residual points,
a 2**18 map), on the inputs of a scan's first iteration after ``--warm``
scans, per call:

- B1, the fused reduction (``ops/p2p.py:p2p_reduce``; on a card the kernel
  ``csrc/p2p_reduce.cu``): the route ``lio_step`` takes;
- the reference's default route: ``slam/lio.py:_measurement_system``
  followed by its ``H^T W H`` and ``H^T W r`` products;
- ``p2p_reduce_plain``, the kernel's plain PyTorch version;

then the whole ``lio_step`` (with B1) per scan over ``--scans`` scans.  It
reports how far the two routes' ``H^T W H`` and ``H^T W r`` lie apart and
gates nothing on it: the reference's two routes part by centimetres over a
dozen scans.  ``lio_step`` has no switch between the routes (its
``use_pallas_p2p`` has no effect in the port).

Usage: python -m lsd_tpu_torch.tools.bench_p2p [--scans 100] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

from ..utils.device import DeviceLike, resolve_device


def reference_route(cfg, nav, ds_pts, ds_mask, m, planes):
    """The reference's default measurement reduction: the dense rows of
    ``_measurement_system``, then ``(H^T W H, H^T W r)``."""
    from ..slam.lio import _measurement_system
    H, r, valid, inv_var = _measurement_system(cfg, nav, ds_pts, ds_mask, m, planes=planes)
    Hw = H * (valid.to(ds_pts.dtype) * inv_var)[:, None]
    return H.T @ Hw, Hw.T @ r


def bench(scans: int = 100, points: int = 2 ** 15, warm: int = 5, n_rep: int = 100,
          device: DeviceLike = None) -> dict:
    """The report of the module docstring, on ``device`` (the card unless the
    caller asks for the CPU)."""
    import numpy as np
    import torch

    from ..ops.p2p import p2p_reduce, p2p_reduce_plain
    from ..slam import lio_init, lio_step
    from ..slam.lio import p2p_weight, scan_front
    from ..utils.device import to_device
    from ..utils.precision import set_slam_precision
    from .profile_lio import BENCH_CFG as cfg, nav_at_start
    from .roofline import bench_scans, time_ms

    dev = resolve_device(device)
    set_slam_precision()
    sim, data = bench_scans(warm + scans, points)
    st = lio_init(cfg, nav_at_start(sim, dev))
    inputs = [tuple(to_device(a, dev) for a in d[:5]) for d in data]
    for scan in inputs[:warm]:
        st, _ = lio_step(cfg, st, *scan)

    front = scan_front(cfg, st, *inputs[warm])
    nav = front.nav_prop
    normals, dpl, _, _ = front.planes
    args = (front.ds_pts, normals, dpl, p2p_weight(cfg, front.ds_mask, front.planes),
            nav.rot, nav.ext_rot, nav.ext_t, nav.pos)
    b1 = lambda: p2p_reduce(*args, cfg.max_resid)
    ref = lambda: reference_route(cfg, nav, front.ds_pts, front.ds_mask, st.map, front.planes)
    plain = lambda: p2p_reduce_plain(*args, cfg.max_resid)
    HtH_b1, Htr_b1, stats = b1()
    HtH_ref, Htr_ref = ref()
    gap = dict(
        hth_max_abs=float((HtH_b1 - HtH_ref).abs().max()),
        hth_rel=float((HtH_b1 - HtH_ref).abs().max() / HtH_ref.abs().max()),
        htr_max_abs=float((Htr_b1 - Htr_ref).abs().max()),
        htr_rel=float((Htr_b1 - Htr_ref).abs().max() / Htr_ref.abs().max().clamp(min=1e-30)))
    per_call = dict(b1_ms=time_ms(b1, dev, n=n_rep), reference_route_ms=time_ms(ref, dev, n=n_rep),
                    plain_ms=time_ms(plain, dev, n=n_rep))

    launches0 = p2p_reduce.launches.read()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for scan in inputs[warm:]:
        st, _ = lio_step(cfg, st, *scan)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) / scans * 1e3
    return dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        n_points=int(args[0].shape[0]), n_valid=int(stats[0]),
        per_call=per_call, routes_gap=gap,
        lio_step=dict(scans=scans, ms_per_scan=step_ms,
                      p2p_launches=p2p_reduce.launches.read() - launches0,
                      finite=bool(np.isfinite(st.nav.pos.cpu().numpy()).all())))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", type=int, default=100)
    ap.add_argument("--points", type=int, default=2 ** 15)
    ap.add_argument("--device", default=None,
                    help="torch device to time (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.scans, args.points, device=args.device)))


if __name__ == "__main__":
    main()
