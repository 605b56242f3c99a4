"""Camera-lidar late fusion of 3D object lists.

A numpy and scipy copy of ``lsd_tpu/detection/camera_fusion.py``; the port
imports nothing of the JAX package.

Re-derivation of the reference's rule-based post-fusion
(docs/detect.md:72-80):
  1. project lidar 3D boxes to the image with the lidar->camera extrinsic
     and intrinsics, compute 2D IoU against camera objects
  2. Hungarian matching -> matched / unmatch_camera / unmatch_lidar
  3. matched: keep the lidar 3D box; confidence = mean(lidar, camera)
     + 0.2 * IoU
  4. unmatch_lidar: average confidence with the mono3D heatmap response at
     the projected center
  5. output = matched + unmatch_camera + unmatch_lidar
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def _box3d_corners(box: np.ndarray) -> np.ndarray:
    """(7,) [x y z l w h yaw] -> (8, 3) corners (lidar frame, z up)."""
    x, y, z, l, w, h, yaw = box[:7]
    c, s = np.cos(yaw), np.sin(yaw)
    dx = np.asarray([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    dy = np.asarray([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    dz = np.asarray([-1, -1, -1, -1, 1, 1, 1, 1]) * h / 2
    cx = x + dx * c - dy * s
    cy = y + dx * s + dy * c
    return np.stack([cx, cy, z + dz], axis=1)


def project_box_to_image(box: np.ndarray, V2C: np.ndarray,
                         K: np.ndarray, image_hw: Tuple[int, int]
                         ) -> Optional[np.ndarray]:
    """3D box -> [x1 y1 x2 y2] image rect, or None if behind the camera."""
    corners = _box3d_corners(np.asarray(box, float))
    pc = corners @ V2C[:3, :3].T + V2C[:3, 3]
    if np.all(pc[:, 2] <= 0.1):
        return None
    pc = pc[pc[:, 2] > 0.1]
    uv = pc[:, :2] * (1.0 / pc[:, 2:3])
    u = K[0, 0] * uv[:, 0] + K[0, 2]
    v = K[1, 1] * uv[:, 1] + K[1, 2]
    H, W = image_hw
    rect = np.asarray([u.min(), v.min(), u.max(), v.max()])
    if rect[2] < 0 or rect[3] < 0 or rect[0] > W or rect[1] > H:
        return None
    rect[0::2] = np.clip(rect[0::2], 0, W)
    rect[1::2] = np.clip(rect[1::2], 0, H)
    if rect[2] - rect[0] < 1 or rect[3] - rect[1] < 1:
        return None
    return rect


def iou_2d(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return float(inter / max(area_a + area_b - inter, 1e-9))


def fuse_camera_lidar(lidar_objs: List[Dict], camera_objs: List[Dict],
                      V2C: np.ndarray, K: np.ndarray,
                      image_hw: Tuple[int, int] = (384, 640),
                      heat: Optional[np.ndarray] = None,
                      heat_stride: int = 4,
                      iou_thresh: float = 0.3) -> List[Dict]:
    """Fuse per the reference's rules.  Objects carry 'box' (7,), 'score',
    'label'; camera objects additionally 'rect' [x1 y1 x2 y2] (or a camera
    -frame 'box' that gets projected)."""
    lid_rects = [project_box_to_image(o["box"], V2C, K, image_hw)
                 for o in lidar_objs]
    cam_rects = []
    for o in camera_objs:
        if "rect" in o and o["rect"] is not None:
            cam_rects.append(np.asarray(o["rect"], float))
        else:
            cam_rects.append(project_box_to_image(
                o["box"], np.eye(4), K, image_hw))

    nl, nc = len(lidar_objs), len(camera_objs)
    iou = np.zeros((nl, nc))
    for i, lr in enumerate(lid_rects):
        if lr is None:
            continue
        for j, cr in enumerate(cam_rects):
            if cr is None:
                continue
            iou[i, j] = iou_2d(lr, cr)

    matched_l, matched_c = set(), set()
    out: List[Dict] = []
    if nl and nc:
        ri, cj = linear_sum_assignment(-iou)
        for i, j in zip(ri, cj):
            if iou[i, j] < iou_thresh:
                continue
            o = dict(lidar_objs[i])
            o["score"] = float((lidar_objs[i]["score"] +
                                camera_objs[j]["score"]) / 2 +
                               0.2 * iou[i, j])
            o["fused"] = "matched"
            out.append(o)
            matched_l.add(i)
            matched_c.add(j)

    for i, o in enumerate(lidar_objs):
        if i in matched_l:
            continue
        o = dict(o)
        if heat is not None and lid_rects[i] is not None:
            r = lid_rects[i]
            u = int((r[0] + r[2]) / 2 / heat_stride)
            v = int((r[1] + r[3]) / 2 / heat_stride)
            H, W = heat.shape[:2]
            if 0 <= v < H and 0 <= u < W:
                o["score"] = float((o["score"] + float(heat[v, u].max())) / 2)
        o["fused"] = "unmatch_lidar"
        out.append(o)

    for j, o in enumerate(camera_objs):
        if j in matched_c:
            continue
        o = dict(o)
        o["fused"] = "unmatch_camera"
        out.append(o)
    return out
