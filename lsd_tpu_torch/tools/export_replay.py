"""Export a simulated replay into the binary format consumed by the
reference-FAST-LIO2 baseline driver (baseline_ref/driver.cpp), so the
reference C++ stack and the port can be run on IDENTICAL input (a copy of
``lsd_tpu/tools/export_replay.py``; numpy only).

Format (little-endian):
    magic   8 bytes  b"LSDR1\\0\\0\\0"
    uint32  n_scans
    per scan:
      uint64 stamp_us
      uint32 n_imu
        n_imu * 7 float64: t_abs_sec, gx, gy, gz (rad/s), ax, ay, az (m/s^2)
      uint32 n_points
        n_points * (4 float32: x y z intensity, 1 uint32: rel_stamp_us)

A sibling ``<out>.gt.npy`` stores the (N, 4, 4) ground-truth scan-end poses
for ATE scoring.
"""
from __future__ import annotations

import struct

import numpy as np

G = 9.81


def export_replay(out_path: str, sim=None, capacity: int = 2 ** 15,
                  imu_capacity: int = 16) -> str:
    from ..sim import CircleSim, SimConfig
    if sim is None:
        # 1.5 s at rest (IMU-at-rest init, e.g. FAST-LIO needs 100 samples
        # under 10 deg/s) + 1 s spin-up + 200 cruising scans
        sim = CircleSim(SimConfig(n_scans=225, points_per_scan=capacity,
                                  point_noise=0.01, seed=7,
                                  rest_time=1.5, ramp_time=1.0))
    data = sim.generate(capacity=capacity, imu_capacity=imu_capacity)
    period = 1.0 / sim.cfg.scan_hz

    gts = []
    with open(out_path, "wb") as f:
        f.write(b"LSDR1\0\0\0")
        f.write(struct.pack("<I", len(data)))
        for k, (P, S, M, I, IM, T_gt) in enumerate(data):
            t0 = k * period
            stamp_us = int(round(t0 * 1e6))
            f.write(struct.pack("<Q", stamp_us))
            imu = np.asarray(I, np.float64)[np.asarray(IM, bool)]
            # absolute stamps; drop the sample duplicated from the previous
            # scan's tail (imu_batch covers [t0, t0+period] inclusive)
            imu[:, 0] += t0
            if k > 0:
                imu = imu[1:]
            imu_out = imu.copy()
            imu_out[:, 4:7] *= G                      # g -> m/s^2
            f.write(struct.pack("<I", len(imu_out)))
            f.write(imu_out.astype("<f8").tobytes())

            pts = np.asarray(P, np.float32)[np.asarray(M, bool)]
            rel_us = (np.asarray(S, np.float32)[np.asarray(M, bool)]
                      * 1e6).astype(np.uint32)
            n = len(pts)
            rec = np.zeros((n, 5), np.float32)
            rec[:, :3] = pts[:, :3]
            # intensity column if present
            if pts.shape[1] > 3:
                rec[:, 3] = pts[:, 3]
            buf = np.zeros(n, dtype=[("xyzi", "<f4", 4), ("t", "<u4")])
            buf["xyzi"] = rec[:, :4]
            buf["t"] = rel_us
            f.write(struct.pack("<I", n))
            f.write(buf.tobytes())
            gts.append(np.asarray(T_gt, np.float64))

    np.save(out_path + ".gt.npy", np.stack(gts))
    return out_path


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("--scans", type=int, default=225)
    ap.add_argument("--points", type=int, default=2 ** 15)
    ap.add_argument("--rest", type=float, default=1.5)
    ap.add_argument("--ramp", type=float, default=1.0)
    args = ap.parse_args(argv)
    from ..sim import CircleSim, SimConfig
    sim = CircleSim(SimConfig(n_scans=args.scans,
                              points_per_scan=args.points,
                              point_noise=0.01, seed=7,
                              rest_time=args.rest, ramp_time=args.ramp))
    print(export_replay(args.out, sim, capacity=args.points))


if __name__ == "__main__":
    main()
