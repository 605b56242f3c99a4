"""NCLT dataset converter -> replayable recordings (a copy of
``lsd_tpu/tools/nclt.py`` for the port; numpy only, nothing runs on a device).

BASELINE.json evaluates on NCLT sequences; this converts the University of
Michigan NCLT distribution's native files into our (reference-compatible)
pickle recordings:

- ``velodyne_hits.bin``: stream of packets
    {u32 magic 0xAD9CAD9C, u32 num_hits, u64 utime, u32 padding,
     num_hits x {u16 x, u16 y, u16 z, u8 intensity, u8 laser}}
  with metric coords v*0.005 - 100.0 (NCLT read_vel docs).
- ``ms25.csv``: utime, mag(3), accel(3) m/s^2, gyro(3) rad/s.
- ``gps.csv``:  utime, fix_mode, num_sats, lat(rad), lon(rad), alt, ...

Hits are framed into fixed windows (default 100 ms); IMU and GPS rows are
attached to their frame.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io.recorder import FrameRecorder

MAGIC = 0xAD9CAD9C


def iter_velodyne_hits(path: str) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (utime_us, hits (N, 4) [x y z intensity]) per packet."""
    with open(path, "rb") as f:
        while True:
            head = f.read(20)
            if len(head) < 20:
                return
            magic, num_hits, utime, _pad = struct.unpack("<IIQI", head)
            if magic != MAGIC:
                # resync: scan forward one byte at a time (corrupt streams)
                f.seek(-19, os.SEEK_CUR)
                continue
            raw = f.read(num_hits * 8)
            if len(raw) < num_hits * 8:
                return
            a = np.frombuffer(raw, np.uint8).reshape(num_hits, 8)
            xyz_raw = a[:, :6].copy().view("<u2").reshape(num_hits, 3)
            pts = np.empty((num_hits, 4), np.float32)
            pts[:, :3] = xyz_raw.astype(np.float32) * 0.005 - 100.0
            pts[:, 3] = a[:, 6].astype(np.float32) / 255.0
            yield int(utime), pts


def convert_nclt(velodyne_hits: str, out_dir: str,
                 ms25_csv: Optional[str] = None,
                 gps_csv: Optional[str] = None,
                 frame_us: int = 100000,
                 max_frames: Optional[int] = None) -> str:
    imu = None
    if ms25_csv and os.path.exists(ms25_csv):
        imu = np.loadtxt(ms25_csv, delimiter=",")
    gps = None
    if gps_csv and os.path.exists(gps_csv):
        gps = np.loadtxt(gps_csv, delimiter=",")

    rec = FrameRecorder(out_dir, cfg_yaml="input:\n  mode: offline\n")
    frame_pts: List[np.ndarray] = []
    frame_start: Optional[int] = None
    prev_ts = None
    n_frames = 0

    def flush(ts: int):
        nonlocal frame_pts, prev_ts, n_frames
        if not frame_pts:
            return
        pts = np.concatenate([p for (p, _t) in frame_pts], axis=0)
        t_rel = np.concatenate([t for (_p, t) in frame_pts])
        frame_pts = []
        attr = np.zeros((len(pts), 2), np.float32)
        attr[:, 0] = t_rel
        frame = dict(
            frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
            points={"0-Custom": pts},
            points_attr={"0-Custom": dict(
                timestamp=ts, points_attr=attr)},
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=False, ins_data={}, motion_valid=False,
            timestep=(ts - prev_ts) if prev_ts else frame_us,
        )
        if imu is not None:
            sel = imu[(imu[:, 0] >= ts) & (imu[:, 0] < ts + frame_us)]
            if len(sel):
                # ms25 columns: utime, mag(1:4), accel(4:7) m/s^2, gyro(7:10)
                frame["imu_data"] = np.stack([
                    sel[:, 0], sel[:, 7], sel[:, 8], sel[:, 9],
                    sel[:, 4] / 9.81, sel[:, 5] / 9.81, sel[:, 6] / 9.81],
                    axis=1)
        if gps is not None:
            sel = gps[(gps[:, 0] >= ts) & (gps[:, 0] < ts + frame_us)]
            if len(sel):
                row = sel[0]
                frame["ins_valid"] = True
                frame["ins_data"] = dict(
                    timestamp=int(row[0]),
                    latitude=float(np.rad2deg(row[3])),
                    longitude=float(np.rad2deg(row[4])),
                    altitude=float(row[5]),
                    heading=0.0, pitch=0.0, roll=0.0,
                    Ve=0.0, Vn=0.0, Vu=0.0,
                    Status=int(row[1]),
                    gyro_x=0.0, gyro_y=0.0, gyro_z=0.0,
                    acc_x=0.0, acc_y=0.0, acc_z=1.0)
        rec.write(frame)
        prev_ts = ts
        n_frames += 1

    for utime, pts in iter_velodyne_hits(velodyne_hits):
        if frame_start is None:
            frame_start = utime
        if utime - frame_start >= frame_us:
            flush(frame_start)
            frame_start = utime
            if max_frames is not None and n_frames >= max_frames:
                return rec.log_dir
        # per-point capture times from the packet utime: NCLT has no
        # per-hit stamps, but packet granularity (~75 packets/rev)
        # restores motion undistortion within the frame
        t_rel = np.full(len(pts), (utime - frame_start) / 1e6, np.float32)
        frame_pts.append((pts, t_rel))
    flush(frame_start if frame_start is not None else 0)
    return rec.log_dir
