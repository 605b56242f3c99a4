"""Keyframe selection + host-side keyframe store (numpy only; a copy of
``lsd_tpu/slam/keyframe.py``).

Mirrors the reference's KeyframeUpdater gating (slam/backend/hdl_graph_slam
include/hdl_graph_slam/keyframe_updater.hpp:21-60 — accumulate distance &
angle since the last keyframe, promote when either exceeds its threshold)
and the MapManager's keyframe bookkeeping (slam/map_manager.py add_key_frame).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


class KeyframeUpdater:
    def __init__(self, delta_trans: float = 2.0, delta_angle: float = 0.2618):
        self.delta_trans = delta_trans
        self.delta_angle = delta_angle
        self.prev_pose: Optional[np.ndarray] = None
        self.accum_distance = 0.0

    def is_update(self, pose: np.ndarray) -> bool:
        pose = np.asarray(pose, float)
        if self.prev_pose is None:
            self.prev_pose = pose
            return True
        delta = np.linalg.inv(self.prev_pose) @ pose
        dt = float(np.linalg.norm(delta[:3, 3]))
        # rotation angle from trace
        c = (np.trace(delta[:3, :3]) - 1.0) / 2.0
        da = float(np.arccos(np.clip(c, -1.0, 1.0)))
        if dt < self.delta_trans and da < self.delta_angle:
            return False
        self.accum_distance += dt
        self.prev_pose = pose
        return True


@dataclasses.dataclass
class Keyframe:
    id: int
    stamp_us: int
    pose: np.ndarray                 # current (optimized) pose
    odom: np.ndarray                 # raw odometry pose at creation
    cloud: np.ndarray                # (N, 4) float32, downsampled
    images: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    accum_distance: float = 0.0


class KeyframeStore:
    """Ordered keyframe list with pose updates and neighborhood queries."""

    def __init__(self):
        self.frames: List[Keyframe] = []

    def add(self, kf: Keyframe) -> int:
        kf.id = len(self.frames)
        self.frames.append(kf)
        return kf.id

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> Keyframe:
        return self.frames[i]

    def positions(self) -> np.ndarray:
        if not self.frames:
            return np.zeros((0, 3))
        return np.stack([kf.pose[:3, 3] for kf in self.frames])

    def within_radius(self, center, radius: float) -> List[int]:
        pos = self.positions()
        if not len(pos):
            return []
        d = np.linalg.norm(pos[:, :2] - np.asarray(center)[None, :2], axis=1)
        return [int(i) for i in np.flatnonzero(d < radius)]

    def update_poses(self, poses: Dict[int, np.ndarray]) -> None:
        for i, T in poses.items():
            if 0 <= i < len(self.frames):
                self.frames[i].pose = np.asarray(T, float)

    def merged_cloud(self, ids, max_points: Optional[int] = None) -> np.ndarray:
        """World-frame concatenation of the given keyframes' clouds."""
        clouds = []
        for i in ids:
            kf = self.frames[i]
            pts = kf.cloud[:, :3] @ kf.pose[:3, :3].T + kf.pose[:3, 3]
            clouds.append(pts.astype(np.float32))
        if not clouds:
            return np.zeros((0, 3), np.float32)
        out = np.concatenate(clouds, axis=0)
        if max_points is not None and len(out) > max_points:
            sel = np.random.default_rng(0).choice(len(out), max_points, replace=False)
            out = out[sel]
        return out

    def merged_cloud_relative(self, ids, ref_id: int,
                              max_points: Optional[int] = None) -> np.ndarray:
        """Concatenate keyframe clouds in keyframe ``ref_id``'s SENSOR frame,
        posing each by the raw ODOMETRY-relative transform ref^-1 * odom_i.

        For a contiguous keyframe window this is rigid and immune to pose-
        graph deformation: loop verification against it measures pure sensor
        geometry, so a previous bad optimization cannot contaminate new loop
        edges (campaign r3: world-frame targets mixed inconsistently-dragged
        poses and biased every subsequent edge)."""
        ref_inv = np.linalg.inv(self.frames[ref_id].odom)
        clouds = []
        for i in ids:
            kf = self.frames[i]
            T = ref_inv @ kf.odom
            pts = kf.cloud[:, :3] @ T[:3, :3].T + T[:3, 3]
            clouds.append(pts.astype(np.float32))
        if not clouds:
            return np.zeros((0, 3), np.float32)
        out = np.concatenate(clouds, axis=0)
        if max_points is not None and len(out) > max_points:
            sel = np.random.default_rng(0).choice(len(out), max_points,
                                                  replace=False)
            out = out[sel]
        return out
