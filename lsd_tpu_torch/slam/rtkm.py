"""RTK-interpolated mapping (counterpart of ``lsd_tpu/slam/rtkm.py``): no
LiDAR odometry at all.  Every scan's pose is interpolated between buffered
RTK/INS fixes projected into a local UTM frame, points are
motion-compensated between the scan-start and scan-end interpolated poses
(numpy, float64 poses), and keyframes feed the SAME pose-graph backend as
the LIO mapper on its device (keyframe downsample, ScanContext loops, ICP
verification, PGO, save).

Used when a survey-grade INS is trusted more than scan matching (open
highways, feature-poor lots) or when no usable IMU exists for FAST-LIO.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..geometry import np_so3
from ..geometry.utm import UTMProjector, grid_convergence
from ..utils.device import DeviceLike
from .mapper import Mapper, MapperConfig


class RtkMapper(Mapper):
    """Mapper whose front-end is RTK pose interpolation instead of LIO."""

    def __init__(self, cfg: MapperConfig = MapperConfig(), device: DeviceLike = None):
        super().__init__(cfg, device=device)
        self.projector = UTMProjector()
        self.fix_ts: list = []          # sorted us stamps
        self.fix_T: list = []           # matching 4x4 poses (local frame)
        self.origin_fix: Optional[Dict] = None
        self._xy0 = None

    # ------------------------------------------------------------------
    def feed_ins(self, fix: Dict) -> None:
        """Buffer one RTK fix: dict with timestamp (us), latitude,
        longitude, altitude, heading (NED deg), pitch, roll (deg)."""
        if not fix.get("latitude"):
            return
        if self.origin_fix is None:
            self.origin_fix = dict(fix)
            self.origin_lla = np.asarray([
                float(fix["latitude"]), float(fix["longitude"]),
                float(fix.get("altitude", 0.0))])
            x0, y0 = self.projector.project(fix["latitude"], fix["longitude"])
            self._xy0 = (float(np.ravel(x0)[0]), float(np.ravel(y0)[0]))
        T = self._fix_to_T(fix)
        ts = int(fix["timestamp"])
        if self.fix_ts and ts <= self.fix_ts[-1]:
            return
        self.fix_ts.append(ts)
        self.fix_T.append(T)
        # bound the buffer to the last ~30 s
        while len(self.fix_ts) > 2 and self.fix_ts[-1] - self.fix_ts[0] > 30e6:
            self.fix_ts.pop(0)
            self.fix_T.pop(0)

    def _fix_to_T(self, fix: Dict) -> np.ndarray:
        x, y = self.projector.project(fix["latitude"], fix["longitude"])
        x = float(np.ravel(x)[0]) - self._xy0[0]
        y = float(np.ravel(y)[0]) - self._xy0[1]
        z = float(fix.get("altitude", 0.0)) - float(
            self.origin_fix.get("altitude", 0.0))
        # NED heading corrected by the UTM grid convergence
        conv = grid_convergence(self.projector.lon0,
                                float(fix["latitude"]),
                                float(fix["longitude"]))
        yaw = np.deg2rad(90.0 - (float(fix.get("heading", 0.0)) - conv))
        T = np.eye(4)
        T[:3, :3] = np_so3.rpy_to_matrix(
            np.deg2rad(float(fix.get("roll", 0.0))),
            np.deg2rad(float(fix.get("pitch", 0.0))), yaw)
        T[:3, 3] = (x, y, z)
        return T

    def interpolate(self, ts_us: int) -> Optional[np.ndarray]:
        """Pose at ts_us between buffered fixes."""
        if len(self.fix_ts) < 2:
            return None
        ts = np.asarray(self.fix_ts)
        if ts_us < ts[0] or ts_us > ts[-1]:
            return None
        i = int(np.searchsorted(ts, ts_us))
        i = max(1, min(i, len(ts) - 1))
        a = (ts_us - ts[i - 1]) / max(ts[i] - ts[i - 1], 1)
        return np_so3.pose_interp(self.fix_T[i - 1], self.fix_T[i], float(a))

    # ------------------------------------------------------------------
    def process_scan(self, points, stamps, mask, imu=None, imu_mask=None,
                     stamp_us: int = 0, gps_xyz=None, images=None,
                     scan_period: float = 0.1, **_ignored) -> Dict:
        """Feed one scan; pose comes purely from RTK interpolation."""
        T0 = self.interpolate(int(stamp_us))
        T1 = self.interpolate(int(stamp_us + scan_period * 1e6)) \
            if T0 is not None else None
        if T0 is None:
            return dict(pose=None, is_keyframe=False, loop=None,
                        status="waiting_rtk")
        odom_pose = T0 if T1 is None else T1   # scan-END pose, like LIO

        pts = np.asarray(points, np.float32)[:, :3]
        msk = np.asarray(mask, bool)
        if T1 is not None:
            # motion compensation: blend each point's capture pose between
            # T0 and T1 by its relative stamp, express in the END frame
            s = np.clip(np.asarray(stamps, np.float32) / scan_period, 0, 1)
            T_end_inv = np.linalg.inv(odom_pose)
            # bucket the blend (32 steps) like the sim for vector speed
            und = pts.copy()
            bucket = np.minimum((s * 32).astype(int), 31)
            for bkt in range(32):
                sel = msk & (bucket == bkt)
                if not np.any(sel):
                    continue
                Tb = T_end_inv @ np_so3.pose_interp(
                    T0, T1, (bkt + 0.5) / 32.0)
                und[sel] = pts[sel] @ Tb[:3, :3].T + Tb[:3, 3]
            pts = und

        self._track = dict(stamp_us=stamp_us, t=np.zeros(0),
                           quat=np.zeros((0, 4)), pos=np.zeros((0, 3)),
                           vel=(odom_pose[:3, 3] - T0[:3, 3]) /
                           max(scan_period, 1e-3),
                           end_pose=odom_pose)
        is_kf = self.updater.is_update(odom_pose)
        loop = None
        if is_kf:
            pts4 = np.concatenate(
                [pts, np.zeros((len(pts), 1), np.float32)], 1)
            loop = self._add_keyframe(pts4, msk, odom_pose, stamp_us,
                                      gps_xyz, images=images)
        pose = self.odom2map @ odom_pose
        self.odometry.append((stamp_us, pose))
        return dict(pose=pose, odom=odom_pose, is_keyframe=is_kf,
                    loop=loop, status="mapping")
