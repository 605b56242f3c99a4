"""Camera mono3D inference for the live pipeline (counterpart of
``lsd_tpu/detection/mono3d_infer.py``).

A camera frame (JPEG bytes or an H x W x 3 uint8 array) -> the port's
``Mono3D`` on the card -> camera-frame 3D boxes -> lidar-frame objects and
image rects for ``detection.camera_fusion.fuse_camera_lidar``.  The box
geometry (``cam_rect``, ``cam_box_to_lidar``) is a numpy copy of the
reference's.  ``Mono3DInfer.detect`` uploads the image as uint8 (pinned,
asynchronous), resizes it on the device as ``cv2.resize`` does
(``utils.image.resize_linear``), runs the float32 model (its width and
class count from the checkpoint unless ``mcfg`` is given; TF32 off:
``utils.precision.set_slam_precision`` in the constructor), the decode and
the heat map's sigmoid, and fetches everything in one packed copy.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import load_camera_params
from ..models.mono3d import Mono3D, Mono3DConfig, decode_mono3d, maps_hwc
from ..models.params_io import load_params
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.image import load_image, resize_linear
from ..utils.precision import set_slam_precision
from ..utils.spans import span


def shipped_mono3d_weights() -> Optional[str]:
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "weights", "mono3d.msgpack")
    return p if os.path.exists(p) else None


def _cam_box_corners(box: np.ndarray) -> np.ndarray:
    """Camera-frame (7,) [x y z l w h yaw_cam] -> (8, 3) corners.
    Camera frame: x right, y down, z forward; yaw in the x-z ground plane."""
    x, y, z, l, w, h, yaw = box[:7]
    dx = np.asarray([l, l, -l, -l, l, l, -l, -l]) / 2
    dz = np.asarray([w, -w, -w, w, w, -w, -w, w]) / 2
    dy = np.asarray([h, h, h, h, -h, -h, -h, -h]) / 2
    c, s = np.cos(yaw), np.sin(yaw)
    rx = c * dx + s * dz
    rz = -s * dx + c * dz
    return np.stack([x + rx, y + dy, z + rz], 1)


def cam_rect(box: np.ndarray, K: np.ndarray,
             image_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """Project a camera-frame box to its image-plane rect (or None)."""
    P = _cam_box_corners(np.asarray(box, float))
    P = P[P[:, 2] > 0.1]
    if len(P) < 2:
        return None
    u = K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2]
    v = K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2]
    H, W = image_hw
    rect = np.asarray([u.min(), v.min(), u.max(), v.max()])
    if rect[2] < 0 or rect[3] < 0 or rect[0] > W or rect[1] > H:
        return None
    rect[0::2] = np.clip(rect[0::2], 0, W)
    rect[1::2] = np.clip(rect[1::2], 0, H)
    if rect[2] - rect[0] < 1 or rect[3] - rect[1] < 1:
        return None
    return rect


def cam_box_to_lidar(box_cam: np.ndarray, C2V: np.ndarray) -> np.ndarray:
    """Camera-frame (7,) -> lidar-frame (7,) [x y z l w h yaw] via the
    camera->lidar extrinsic C2V (4x4)."""
    b = np.asarray(box_cam, float)
    ctr = C2V[:3, :3] @ b[:3] + C2V[:3, 3]
    # length-axis direction in camera coords (x-z plane): (cos, 0, -sin)
    d_cam = np.asarray([np.cos(b[6]), 0.0, -np.sin(b[6])])
    d_l = C2V[:3, :3] @ d_cam
    yaw_l = float(np.arctan2(d_l[1], d_l[0]))
    return np.asarray([ctr[0], ctr[1], ctr[2], b[3], b[4], b[5], yaw_l],
                      np.float32)


class Mono3DInfer:
    """Camera frame -> camera-frame mono3D -> lidar-frame object list."""

    def __init__(self, weights: Optional[str] = None, score_thresh: float = 0.3,
                 max_objects: int = 32, mcfg: Optional[Mono3DConfig] = None,
                 device: DeviceLike = None):
        self.score_thresh = float(score_thresh)
        self.max_objects = int(max_objects)
        self.device = resolve_device(device)
        weights = weights or shipped_mono3d_weights()
        if not weights:
            raise ValueError(
                "mono3d enabled but no weights configured and no shipped "
                "checkpoint (weights/mono3d.msgpack) — refusing to serve a "
                "random-init model")
        self.cfg = mcfg or Mono3DConfig()
        set_slam_precision()           # the model is float32: no TF32 on the card
        model = Mono3D(self.cfg)
        # a checkpoint that does not describe the config raises ValueError
        load_camera_params(model, load_params(weights))
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _prep(self, image, K: np.ndarray):
        """The camera frame at the model's input size, (H, W, 3) float32 in
        [0, 1] on the device, and the intrinsic scaled to match; (None,
        None) for bytes that do not decode."""
        with span("camera/prep"):
            img = load_image(image, rgb=True)
            if img is None:
                return None, None
            H, W = self.cfg.image_hw
            h0, w0 = img.shape[:2]
            Ks = np.asarray(K, float).copy()
            img = to_device(img, self.device)
            if (h0, w0) != (H, W):
                img = resize_linear(img, (H, W))
                Ks[0] *= W / w0
                Ks[1] *= H / h0
            if img.dtype != torch.float32:
                img = img.float() / 255.0
            return img, Ks

    @torch.inference_mode()
    def _predict(self, img: torch.Tensor, Ks: np.ndarray):
        """Model, decode and the heat map's sigmoid, on the device:
        (boxes, scores, labels, valid, heat)."""
        with span("camera/mono3d"):
            preds = maps_hwc(self.model(img.permute(2, 0, 1)[None]))
        with span("camera/decode"):
            out = decode_mono3d(preds, to_device(np.asarray(Ks, np.float32), self.device),
                                self.max_objects, self.cfg.stride)
            return (*out, torch.sigmoid(preds["heat"]))

    def detect(self, image, K: np.ndarray, C2V: Optional[np.ndarray] = None) -> Dict:
        """image: JPEG bytes or an H x W x 3 array; K: its intrinsic.

        Returns dict(camera_objs=[{box (camera frame), rect, score, label,
        source, box_lidar (with C2V)}], heat (Hh, Wh, C), K_scaled)."""
        img, Ks = self._prep(image, K)
        if img is None:
            return dict(camera_objs=[], heat=None, K_scaled=None)
        out_d = self._predict(img, Ks)
        with span("camera/fetch"):
            boxes, scores, labels, valid, heat = fetch(*out_d)
        out: List[Dict] = []
        for i in range(len(boxes)):
            if not valid[i] or scores[i] < self.score_thresh:
                continue
            rect = cam_rect(boxes[i], Ks, self.cfg.image_hw)
            if rect is None:
                continue
            o = dict(box=boxes[i].astype(np.float32), rect=rect, score=float(scores[i]),
                     label=int(labels[i]), source="camera")
            if C2V is not None:
                o["box_lidar"] = cam_box_to_lidar(boxes[i], C2V)
            out.append(o)
        return dict(camera_objs=out, heat=heat, K_scaled=Ks)
