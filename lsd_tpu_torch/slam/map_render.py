"""Map colouration + COLMAP export (counterpart of
``lsd_tpu/slam/map_render.py``; numpy only).

Re-derivation of the reference's map render stack
(slam/localization/map_render/map_render.cpp — project keyframe camera
images onto the map cloud for an RGB map — and colmap_utils.cpp — export
the keyframe graph as a COLMAP text model for external reconstruction
tooling).  ``colorize_map`` decodes the keyframes' JPEGs with ``cv2`` and
raises where it is not installed (the card's machine has none), as the
reference does; ``cv2`` is imported on first use, so that importing the
port loads no OpenCV.  ``export_colmap`` decodes nothing and runs anywhere.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..geometry import np_so3

HAS_CV2 = importlib.util.find_spec("cv2") is not None


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


def colorize_map(keyframes: Sequence, K: np.ndarray,
                 T_cam_from_lidar: np.ndarray, camera_name: str = "front",
                 max_points: Optional[int] = None) -> np.ndarray:
    """Build a world-frame RGB map cloud (M, 6) [xyz rgb] from keyframes
    carrying JPEG images (Keyframe.images[camera_name])."""
    if not HAS_CV2:
        raise RuntimeError("cv2 unavailable")
    import cv2
    out = []
    for kf in keyframes:
        jpg = kf.images.get(camera_name)
        if jpg is None:
            continue
        img = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            continue
        rgb, valid = colorize_cloud(kf.cloud[:, :3], img, K, T_cam_from_lidar)
        pts_w = kf.cloud[valid, :3] @ kf.pose[:3, :3].T + kf.pose[:3, 3]
        out.append(np.concatenate([pts_w, rgb[valid]], axis=1))
    if not out:
        return np.zeros((0, 6), np.float32)
    cloud = np.concatenate(out, axis=0).astype(np.float32)
    if max_points is not None and len(cloud) > max_points:
        sel = np.random.default_rng(0).choice(len(cloud), max_points, replace=False)
        cloud = cloud[sel]
    return cloud


def export_colmap(out_dir: str, keyframes: Sequence, K: np.ndarray,
                  T_cam_from_lidar: np.ndarray, image_size: Tuple[int, int],
                  camera_name: str = "front",
                  map_points: Optional[np.ndarray] = None) -> str:
    """Write a COLMAP text model (cameras.txt / images.txt / points3D.txt)
    plus the keyframe images (ref colmap_utils.cpp)."""

    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    W, H = image_size
    K = np.asarray(K, float)

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[fx fy cx cy]\n")
        f.write("1 PINHOLE %d %d %.6f %.6f %.6f %.6f\n"
                % (W, H, K[0, 0], K[1, 1], K[0, 2], K[1, 2]))

    Tcl = np.asarray(T_cam_from_lidar, float)
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n#\n")
        img_id = 1
        for kf in keyframes:
            jpg = kf.images.get(camera_name)
            if jpg is None:
                continue
            # COLMAP wants world->camera
            T_wc = kf.pose @ np.linalg.inv(Tcl)     # camera pose in world
            T_cw = np.linalg.inv(T_wc)
            q = np_so3.matrix_to_quat(T_cw[:3, :3])
            t = T_cw[:3, 3]
            name = "%06d.jpg" % kf.id
            with open(os.path.join(img_dir, name), "wb") as imf:
                imf.write(jpg)
            f.write("%d %.8f %.8f %.8f %.8f %.6f %.6f %.6f 1 %s\n\n"
                    % (img_id, q[0], q[1], q[2], q[3], t[0], t[1], t[2], name))
            img_id += 1

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        if map_points is not None:
            for i, p in enumerate(np.asarray(map_points)):
                rgb = (p[3:6] * 255).astype(int) if p.shape[0] >= 6 else (128, 128, 128)
                f.write("%d %.6f %.6f %.6f %d %d %d 0.0\n"
                        % (i + 1, p[0], p[1], p[2], rgb[0], rgb[1], rgb[2]))
    return out_dir
