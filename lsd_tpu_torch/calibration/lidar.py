"""LiDAR self-calibration: ground plane + heading (counterpart of
``lsd_tpu/calibration/lidar.py``).

Ground RANSAC estimates roll/pitch/z so the ground becomes z=0 (the
mapper's floor prior uses the fit too); heading calibration takes the yaw
of a straight-line drive.  Host numpy, apart from ``rot_between``, which
runs in float32 torch on the CPU as the reference runs its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..geometry import np_so3


def ransac_ground_plane(points: np.ndarray, iters: int = 100,
                        inlier_thresh: float = 0.1,
                        seed: int = 0) -> Tuple[np.ndarray, float, np.ndarray]:
    """Fit the dominant ground plane: returns (normal (3,), d, inlier mask)
    with the plane n.p + d = 0, normal pointing up (+z)."""
    pts = np.asarray(points, float).reshape(-1, points.shape[-1])[:, :3]
    rng = np.random.default_rng(seed)
    best_inliers = np.zeros(len(pts), bool)
    best = (np.asarray([0.0, 0, 1.0]), 0.0)
    for _ in range(iters):
        idx = rng.choice(len(pts), 3, replace=False)
        p0, p1, p2 = pts[idx]
        n = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(n)
        if norm < 1e-9:
            continue
        n = n / norm
        d = -np.dot(n, p0)
        dist = np.abs(pts @ n + d)
        inl = dist < inlier_thresh
        if inl.sum() > best_inliers.sum():
            best_inliers = inl
            best = (n, d)
    # refine with least squares on inliers
    inl = pts[best_inliers]
    if len(inl) >= 3:
        c = inl.mean(axis=0)
        u, s, vt = np.linalg.svd(inl - c)
        n = vt[2]
        d = -np.dot(n, c)
        if n[2] < 0:
            n, d = -n, -d
        best = (n, d)
        best_inliers = np.abs(pts @ n + d) < inlier_thresh
    return best[0], best[1], best_inliers


def lidar_ground_calibration(points: np.ndarray,
                             sensor_height_hint: Optional[float] = None
                             ) -> Tuple[np.ndarray, dict]:
    """Estimate the transform leveling the lidar to the ground.

    Returns (T 4x4, info): applying T makes the detected ground plane z=0
    with the lidar at its measured height.
    """
    import torch

    # imported here: slam/mapper.py imports this module
    from ..slam.imu import rot_between
    n, d, inliers = ransac_ground_plane(points)
    R = rot_between(torch.as_tensor(n, dtype=torch.float32),
                    torch.tensor([0.0, 0.0, 1.0])).numpy()
    height = float(d)  # distance of origin to plane along normal = |d| when |n|=1
    T = np.eye(4)
    T[:3, :3] = R
    T[2, 3] = height if sensor_height_hint is None else sensor_height_hint
    rpy = np_so3.matrix_to_rpy(np.asarray(R, float))
    return T, dict(normal=n, height=height, inlier_frac=float(inliers.mean()),
                   roll=float(rpy[0]), pitch=float(rpy[1]))


def heading_calibration(trajectory_xy: np.ndarray) -> float:
    """Yaw offset between the sensor x-axis and driving direction, from a
    straight-line drive.  Returns yaw (rad) to apply so that forward motion
    is +x."""
    xy = np.asarray(trajectory_xy, float).reshape(-1, 2)
    d = xy[-1] - xy[0]
    return float(np.arctan2(d[1], d[0]))
