"""Map colouration: sample camera colours for LiDAR points (the part of
``lsd_tpu/slam/map_render.py`` that ``slam/map_editor.py`` uses, copied for
the port; numpy only).

Re-derivation of the reference's map render stack
(slam/localization/map_render/map_render.cpp — project keyframe camera
images onto the map cloud for an RGB map).  The reference module also
builds a whole RGB map from JPEG keyframes (``colorize_map``) and writes a
COLMAP model (``export_colmap``); neither is on the runtime's path, and the
card's machine has no ``cv2`` to decode the JPEGs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def project_points(points_cam: np.ndarray, K: np.ndarray,
                   image_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Project camera-frame points -> (uv (N,2), valid mask)."""
    z = points_cam[:, 2]
    valid = z > 0.1
    zs = np.where(valid, z, 1.0)
    u = K[0, 0] * points_cam[:, 0] / zs + K[0, 2]
    v = K[1, 1] * points_cam[:, 1] / zs + K[1, 2]
    W, H = image_size
    valid &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return np.stack([u, v], axis=-1), valid


def colorize_cloud(points_lidar: np.ndarray, image_bgr: np.ndarray,
                   K: np.ndarray, T_cam_from_lidar: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample RGB for lidar-frame points from one camera image.

    Returns (rgb (N, 3) float [0,1], valid (N,)).
    """
    T = np.asarray(T_cam_from_lidar, float)
    pc = points_lidar[:, :3] @ T[:3, :3].T + T[:3, 3]
    H, W = image_bgr.shape[:2]
    uv, valid = project_points(pc, np.asarray(K, float), (W, H))
    ui = np.clip(uv[:, 0].astype(int), 0, W - 1)
    vi = np.clip(uv[:, 1].astype(int), 0, H - 1)
    bgr = image_bgr[vi, ui].astype(np.float32) / 255.0
    rgb = bgr[:, ::-1]
    return np.where(valid[:, None], rgb, 0.0), valid
