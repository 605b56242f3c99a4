"""Camera frames for the camera models: decode and resize.

- ``load_image``: a frame's image as an H x W x 3 uint8 array.  The
  reference's frames carry JPEG bytes (``d["image"][name]``); those are
  decoded with OpenCV, imported at that moment, and a missing OpenCV is an
  error that says so, never an empty result.  An array passes through.
- ``resize_linear``: ``cv2.resize(img, (W, H))`` with ``INTER_LINEAR`` on
  uint8, in integer tensor ops on the image's device.  OpenCV's 8-bit path
  is fixed point: per output column the source columns x0, x1 and weights
  c0 + c1 = 2048 (c1 = round(a * 2048) of the fraction a of the half-pixel
  source position, computed in float32; indices clamped at the borders,
  where a is 0); rows h = x[x0] c0 + x[x1] c1 in int32; then the vertical
  step of its vector code, ((h0 >> 4) c0 >> 16) + ((h1 >> 4) c1 >> 16),
  plus 2, shifted right by 2.  This is OpenCV's result bit for bit on
  downscales (1920 x 1080 to 640 x 384 and 320 x 256 among them); on an
  upscale it is off by one level at ~0.2 % of pixels.  Float images are
  resized by float bilinear interpolation with half-pixel centres, as
  OpenCV resizes them.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch.nn import functional as F

from .device import to_device

_COEF_ONE = 2048                       # OpenCV's INTER_RESIZE_COEF_SCALE


def load_image(image: Union[bytes, bytearray, np.ndarray, torch.Tensor], rgb: bool):
    """``image`` as an H x W x 3 array or tensor: JPEG (or PNG) bytes are
    decoded (BGR, or RGB with ``rgb``), None if they do not decode; an array
    or a tensor is returned as it is."""
    if not isinstance(image, (bytes, bytearray)):
        return image
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError("decoding a compressed camera image needs OpenCV (cv2), which "
                           "is not installed; pass the image as an H x W x 3 uint8 array") from exc
    img = cv2.imdecode(np.frombuffer(bytes(image), np.uint8), cv2.IMREAD_COLOR)
    if img is not None and rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def _taps(src: int, dst: int) -> np.ndarray:
    """(4, dst) int32: source indices i0, i1 and fixed-point weights c0, c1
    of each of ``dst`` outputs along an axis of ``src`` inputs."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    out = (i0 < 0) | (i0 >= src - 1)
    f[out] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    c1 = np.rint(f * np.float32(_COEF_ONE)).astype(np.int32)
    return np.stack([i0, np.minimum(i0 + 1, src - 1), _COEF_ONE - c1, c1]).astype(np.int32)


def resize_linear(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``img`` (h, w, 3) resized to ``hw`` = (H, W) as ``cv2.resize(img,
    (W, H))`` resizes it; uint8 in fixed point, float in float."""
    H, W = hw
    if img.dtype != torch.uint8:
        x = img.permute(2, 0, 1)[None].float()
        return F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    x0, x1, a0, a1 = to_device(_taps(img.shape[1], W), img.device).unbind(0)
    y0, y1, b0, b1 = to_device(_taps(img.shape[0], H), img.device).unbind(0)
    x = img.to(torch.int32)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]     # (h, W, 3)
    v = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return ((v + 2) >> 2).clamp_(0, 255).to(torch.uint8)
