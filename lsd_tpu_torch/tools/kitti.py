"""Public-dataset converters -> replayable recordings (a copy of
``lsd_tpu/tools/kitti.py`` for the port; numpy only, nothing runs on a device).

The reference converts public benchmarks (KITTI/ULHK/UTBM rosbags) into its
pickle replay format via tools/rosbag_to_pkl (config_kitti.yaml etc.).
ROS is not available here, so we convert the native KITTI disk layouts
directly into the same recording format our FramePlayer (and the
reference's player) replays:

- KITTI odometry: sequences/NN/velodyne/*.bin + times.txt
- KITTI raw OXTS: oxts/data/*.txt (lat lon alt roll pitch yaw ... ax ay az
  wx wy wz ...) -> ins_data + imu_data
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ..io.recorder import FrameRecorder


def _read_velodyne_bin(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _oxts_row_to_ins(ts_us: int, row: np.ndarray) -> Dict:
    # KITTI oxts fields: lat lon alt roll pitch yaw vn ve vf vl vu
    # ax ay az af al au wx wy wz wf wl wu pos_acc vel_acc navstat numsats ...
    return dict(
        timestamp=ts_us,
        latitude=float(row[0]), longitude=float(row[1]), altitude=float(row[2]),
        roll=float(np.rad2deg(row[3])), pitch=float(np.rad2deg(row[4])),
        heading=float((90.0 - np.rad2deg(row[5])) % 360.0),  # ENU yaw -> NED heading
        Vn=float(row[6]), Ve=float(row[7]), Vu=float(row[10]),
        acc_x=float(row[11] / 9.81), acc_y=float(row[12] / 9.81),
        acc_z=float(row[13] / 9.81),
        gyro_x=float(row[17]), gyro_y=float(row[18]), gyro_z=float(row[19]),
        Status=int(row[23]) if len(row) > 23 else 4,
    )


def convert_kitti_odometry(seq_dir: str, out_dir: str,
                           lidar_name: str = "0-Custom",
                           max_frames: Optional[int] = None) -> str:
    """KITTI odometry sequence dir -> recording dir; returns the log dir."""
    bins = sorted(glob.glob(os.path.join(seq_dir, "velodyne", "*.bin")))
    times_f = os.path.join(seq_dir, "times.txt")
    times = (np.loadtxt(times_f) if os.path.exists(times_f)
             else np.arange(len(bins)) * 0.1)
    times = np.atleast_1d(times)
    rec = FrameRecorder(out_dir, cfg_yaml="input:\n  mode: offline\n")
    n = len(bins) if max_frames is None else min(len(bins), max_frames)
    for k in range(n):
        pts = _read_velodyne_bin(bins[k])
        ts = int(times[k] * 1e6) + 1  # strictly positive
        rec.write(dict(
            frame_start_timestamp=ts,
            frame_timestamp_monotonic=ts,
            points={lidar_name: pts},
            points_attr={lidar_name: dict(
                timestamp=ts, points_attr=np.zeros((len(pts), 2), np.float32))},
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=False, ins_data={}, motion_valid=False,
            timestep=int((times[k] - times[k - 1]) * 1e6) if k else 100000,
        ))
    return rec.log_dir


def convert_kitti_raw_oxts(raw_dir: str, out_dir: str,
                           lidar_subdir: str = "velodyne_points",
                           max_frames: Optional[int] = None) -> str:
    """KITTI raw drive dir (with velodyne_points/ + oxts/) -> recording."""
    bins = sorted(glob.glob(os.path.join(raw_dir, lidar_subdir, "data", "*.bin")))
    oxts = sorted(glob.glob(os.path.join(raw_dir, "oxts", "data", "*.txt")))
    ts_file = os.path.join(raw_dir, lidar_subdir, "timestamps.txt")
    if os.path.exists(ts_file):
        import datetime
        stamps = []
        with open(ts_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                dt = datetime.datetime.fromisoformat(line[:26])
                stamps.append(int(dt.timestamp() * 1e6))
    else:
        stamps = [int(k * 1e5) + 1 for k in range(len(bins))]
    rec = FrameRecorder(out_dir, cfg_yaml="input:\n  mode: offline\n")
    n = len(bins) if max_frames is None else min(len(bins), max_frames)
    prev_ts = None
    for k in range(n):
        pts = _read_velodyne_bin(bins[k])
        ts = stamps[k]
        frame = dict(
            frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
            points={"0-Custom": pts},
            points_attr={"0-Custom": dict(
                timestamp=ts, points_attr=np.zeros((len(pts), 2), np.float32))},
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=False, ins_data={}, motion_valid=False,
            timestep=(ts - prev_ts) if prev_ts else 100000,
        )
        if k < len(oxts):
            row = np.loadtxt(oxts[k])
            ins = _oxts_row_to_ins(ts, row)
            frame["ins_valid"] = True
            frame["ins_data"] = ins
            frame["imu_data"] = np.asarray(
                [[ts, ins["gyro_x"], ins["gyro_y"], ins["gyro_z"],
                  ins["acc_x"], ins["acc_y"], ins["acc_z"]]], np.float64)
        rec.write(frame)
        prev_ts = ts
    return rec.log_dir
