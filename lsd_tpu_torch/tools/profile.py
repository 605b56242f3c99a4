"""Profiling harness: per-stage timing of a recording through the LIO step,
with an optional ``torch.profiler`` trace (counterpart of
``lsd_tpu/tools/profile.py``).

A replay-driven profile: recorded frames go through ``lio_step`` at the
bench's settings, each step ends in a synchronize of the device, and the
report gives the milliseconds of preparing a frame (host) and of the step.
With ``trace_dir`` a Chrome trace of the whole replay (host and device
activity) is written there as ``trace.json``; open it in Perfetto or
chrome://tracing.

Usage:
    python -m lsd_tpu_torch.tools.profile --recording DIR [--trace DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, List, Optional

from ..utils.device import DeviceLike, resolve_device


def profile_lio_replay(recording: str, trace_dir: Optional[str] = None,
                       max_frames: int = 100,
                       point_capacity: int = 2 ** 15,
                       device: DeviceLike = None) -> Dict[str, float]:
    """Replay up to ``max_frames`` frames of ``recording`` through the LIO
    step on ``device`` (the card unless the caller asks for the CPU).

    The IMU rows are made relative to the scan start as the runtime's SLAM
    stage makes them (``runtime/modules.py:_relative_imu``); the JAX
    package's tool divides every stamp by 1e6 from the first row, which
    reads the seconds of a converted recording as microseconds.  The first
    3 steps (the kernel's build, cuBLAS's and cuSOLVER's handles) are left
    out of the statistics when more than 6 ran."""
    import numpy as np
    import torch

    from ..io.player import FramePlayer
    from ..runtime.modules import _relative_imu
    from ..slam import LioConfig, lio_init, lio_step
    from ..utils.device import to_device

    dev = resolve_device(device)
    cfg = LioConfig(ds_capacity=16384, map_capacity=2 ** 18,
                    scan_voxel=0.4, map_voxel=0.4, max_iters=4)
    st = lio_init(cfg, device=dev)
    player = FramePlayer(recording, point_capacity=point_capacity)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities) if trace_dir else None
    t_parse: List[float] = []
    t_step: List[float] = []
    n = 0
    with prof or contextlib.nullcontext():
        for frame in player:
            if n >= max_frames or frame.scan is None:
                break
            t0 = time.perf_counter()
            pts = to_device(frame.scan.points[:, :3], dev)
            stamps = to_device(frame.scan.stamps, dev)
            mask = to_device(frame.scan.mask, dev)
            if frame.imu is not None and len(frame.imu.data):
                imu_np = _relative_imu(frame.imu.data, frame.scan.timestamp)
                imu = to_device(imu_np.astype(np.float32), dev)
                imu_mask = to_device(frame.imu.mask, dev)
            else:
                imu = torch.zeros((1, 7), dtype=torch.float32, device=dev)
                imu_mask = torch.zeros((1,), dtype=torch.bool, device=dev)
            t1 = time.perf_counter()
            st, info = lio_step(cfg, st, pts, stamps, mask, imu, imu_mask)
            sync()
            t2 = time.perf_counter()
            t_parse.append((t1 - t0) * 1000)
            t_step.append((t2 - t1) * 1000)
            n += 1
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    def stats(xs):
        xs = np.asarray(xs[3:] if len(xs) > 6 else xs)  # drop the warm-up steps
        return dict(mean=float(xs.mean()), p50=float(np.median(xs)),
                    p95=float(np.percentile(xs, 95)), max=float(xs.max()))

    report = dict(frames=n, device=str(dev),
                  host_parse_ms=stats(t_parse),
                  device_step_ms=stats(t_step))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--recording", required=True)
    ap.add_argument("--trace", default=None,
                    help="torch.profiler trace output directory")
    ap.add_argument("--max-frames", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device of the replay (default: the card)")
    args = ap.parse_args(argv)
    import json
    report = profile_lio_replay(args.recording, args.trace, args.max_frames,
                                device=args.device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
