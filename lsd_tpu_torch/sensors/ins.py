"""INS/IMU motion tracking: pose interpolation + per-frame motion
(a copy of ``lsd_tpu/sensors/ins.py`` for the port).

Re-derivation of the reference's INS driver core semantics
(sensor_driver/ins_driver/src/ins_driver.cpp trigger/getMotion:236-312):
buffer GNSS/INS fixes and IMU samples; on each frame ``trigger(ts)``
returns the interpolated absolute pose, the relative motion since the last
trigger (the ego-motion 4x4 used for tracker compensation and multi-frame
point accumulation), and the IMU window covering the frame.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from ..geometry import np_so3
from ..geometry.utm import UTMProjector

# This module is host-side sensor plumbing that runs on receive threads —
# pure numpy on purpose: tensor ops here would launch tiny device work per
# fix.


def ins_fix_to_pose(fix: Dict, projector: UTMProjector) -> np.ndarray:
    """GPCHC-style fix dict -> 4x4 pose in the projector's metric frame.
    Heading is NED-clockwise degrees (reference convention)."""
    x, y = projector.project(fix["latitude"], fix["longitude"])
    z = fix.get("altitude", 0.0)
    yaw = np.deg2rad(90.0 - fix.get("heading", 0.0))  # NED heading -> ENU yaw
    pitch = np.deg2rad(fix.get("pitch", 0.0))
    roll = np.deg2rad(fix.get("roll", 0.0))
    T = np.eye(4)
    T[:3, :3] = np_so3.rpy_to_matrix(roll, pitch, yaw)
    T[:3, 3] = (float(np.ravel(x)[0]), float(np.ravel(y)[0]), float(z))
    return T


class InsMotionTracker:
    def __init__(self, buffer_s: float = 2.0):
        self.buffer_us = int(buffer_s * 1e6)
        self.fixes: Deque[Tuple[int, np.ndarray, Dict]] = deque()
        self.imu: Deque[np.ndarray] = deque()   # rows [ts_us, gx, gy, gz, ax, ay, az]
        self.projector = UTMProjector()
        self.last_trigger: Optional[Tuple[int, np.ndarray]] = None

    # feeding ------------------------------------------------------------
    def feed_fix(self, fix: Dict) -> None:
        ts = int(fix["timestamp"])
        T = ins_fix_to_pose(fix, self.projector)
        self.fixes.append((ts, T, fix))
        self._trim(ts)

    def feed_imu(self, ts_us: int, gyro, accel) -> None:
        self.imu.append(np.asarray([ts_us, *gyro, *accel], float))
        while self.imu and self.imu[0][0] < ts_us - self.buffer_us:
            self.imu.popleft()

    def _trim(self, now_us: int) -> None:
        while self.fixes and self.fixes[0][0] < now_us - self.buffer_us:
            self.fixes.popleft()

    # query --------------------------------------------------------------
    def pose_at(self, ts_us: int) -> Optional[np.ndarray]:
        if len(self.fixes) < 1:
            return None
        ts_arr = [f[0] for f in self.fixes]
        if ts_us <= ts_arr[0]:
            return self.fixes[0][1]
        if ts_us >= ts_arr[-1]:
            return self.fixes[-1][1]
        import bisect
        i = bisect.bisect_right(ts_arr, ts_us) - 1
        t0, T0, _ = self.fixes[i]
        t1, T1, _ = self.fixes[i + 1]
        a = (ts_us - t0) / max(t1 - t0, 1)
        return np_so3.pose_interp(T0, T1, float(a))

    def trigger(self, ts_us: int) -> Dict:
        """Per-frame query (ref trigger/getMotion): returns dict with
        pose (4x4 or None), motion (4x4 relative previous trigger, in the
        PREVIOUS body frame), motion_valid, imu (M, 7) window rows."""
        pose = self.pose_at(ts_us)
        motion = np.eye(4)
        motion_valid = False
        prev_ts = self.last_trigger[0] if self.last_trigger is not None else None
        if pose is not None and self.last_trigger is not None:
            t_prev, T_prev = self.last_trigger
            motion = np.linalg.inv(T_prev) @ pose
            motion_valid = True
        if pose is not None:
            self.last_trigger = (ts_us, pose.copy())
        # IMU window spans the frame interval (prev trigger -> now)
        t_lo = prev_ts if prev_ts is not None else ts_us - 200000
        window = [r for r in self.imu if t_lo <= r[0] <= ts_us]
        imu = np.stack(window) if window else np.zeros((0, 7))
        return dict(pose=pose, motion=motion, motion_valid=motion_valid, imu=imu)
