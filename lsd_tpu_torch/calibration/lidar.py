"""LiDAR self-calibration: the ground-plane fit.

A copy of ``ransac_ground_plane`` from ``lsd_tpu/calibration/lidar.py``
(numpy only): the mapper's floor prior needs it.  The rest of that module
(ground and heading calibration) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
