"""Monocular 3D detector (counterpart of ``lsd_tpu/models/mono3d.py:31-141``).

A Darknet-style body of 3x3 convolutions without bias, GroupNorm
(``min(16, ch)`` groups, eps 1e-6) and SiLU, down to stride 16 and back to
stride 4 by nearest-neighbour upsampling and skip concatenation, then five
1x1 heads per stride-4 cell: ``heat`` (one logit per class; its bias starts
at -4.6), ``offset`` (2), ``depth`` (1, z = 1/sigmoid(d) - 1), ``dims``
(3, log l w h) and ``rot`` (2, sin and cos of the observation angle).
float32 throughout, as the reference serves it; on a card the caller turns
TF32 off (``utils.precision.set_slam_precision``).

The module names follow the flax tree (``ConvBlock_k``, ``ResBlock_k``,
``Conv_k``), so ``convert.camera_params_from_flax`` moves a checkpoint by
name.  Three places where flax and PyTorch differ and the port follows flax:

- a strided 3x3 conv pads "SAME": 0 before and 1 after on an even side
  (``bev_backbone._same_pad``);
- ``jax.image.resize(..., "nearest")`` samples at half-pixel centres, as
  ``nearest-exact`` does (``nearest`` agrees only at integer ratios);
- the "SAME" max-pool of ``_nms_heat`` pads with -inf, as ``max_pool2d``.

``Mono3D`` takes (N, 3, H, W) images in [0, 1] and returns (N, c, H/4, W/4)
maps; ``maps_hwc`` gives one image's maps in the reference's (H, W, c)
layout, which ``decode_mono3d`` takes.

Training (``lsd_tpu/models/mono3d.py:144-207``): ``make_mono3d_targets``
is a numpy copy (the datasets draw the targets on the host);
``mono3d_loss`` takes (H, W, c) maps, or (B, H, W, c) with one loss per
image, each normalised by its own positives and centre cells.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.iou3d import top_k
from .bev_backbone import _same_pad
from .vfe import NORM_EPS

# sigmoid(-4.6) ~ 0.01: the initial bias of the first 1x1 head
HEAT_BIAS = -4.6
HEADS = (("heat", None), ("offset", 2), ("depth", 1), ("dims", 3), ("rot", 2))


class Mono3DConfig(NamedTuple):
    image_hw: Tuple[int, int] = (384, 640)
    num_classes: int = 4          # vehicle, pedestrian, cyclist, cone
    stride: int = 4
    max_objects: int = 64
    base_ch: int = 32


class ConvBlock(nn.Module):
    """3x3 conv ("SAME", no bias) -> GroupNorm -> SiLU, in float32."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_ch, ch, 3, stride=stride, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(16, ch), ch, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(_same_pad(x, 3, self.stride), self.Conv_0.weight, None, self.stride)
        return F.silu(self.GroupNorm_0(x))


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(ch, ch // 2)
        self.ConvBlock_1 = ConvBlock(ch // 2, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBlock_1(self.ConvBlock_0(x))


class Mono3D(nn.Module):
    def __init__(self, cfg: Mono3DConfig = Mono3DConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.base_ch
        self.ConvBlock_0 = ConvBlock(3, c, 2)              # /2
        self.ConvBlock_1 = ConvBlock(c, c * 2, 2)          # /4
        self.ResBlock_0 = ResBlock(c * 2)
        self.ConvBlock_2 = ConvBlock(c * 2, c * 4, 2)      # /8
        self.ResBlock_1 = ResBlock(c * 4)
        self.ResBlock_2 = ResBlock(c * 4)
        self.ConvBlock_3 = ConvBlock(c * 4, c * 8, 2)      # /16
        self.ResBlock_3 = ResBlock(c * 8)
        self.ConvBlock_4 = ConvBlock(c * 8 + c * 4, c * 4)  # back at /8
        self.ConvBlock_5 = ConvBlock(c * 4 + c * 2, c * 2)  # back at /4
        for k, (_, ch) in enumerate(HEADS):
            setattr(self, f"Conv_{k}", nn.Conv2d(c * 2, ch or cfg.num_classes, 1))

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (N, 3, H, W) float32 in [0, 1] -> maps (N, c, H/4, W/4)."""
        x = self.ConvBlock_1(self.ConvBlock_0(image))
        d4 = x = self.ResBlock_0(x)
        d8 = x = self.ResBlock_2(self.ResBlock_1(self.ConvBlock_2(x)))
        x = self.ResBlock_3(self.ConvBlock_3(x))
        x = F.interpolate(x, size=d8.shape[-2:], mode="nearest-exact")
        x = self.ConvBlock_4(torch.cat([x, d8], dim=1))
        x = F.interpolate(x, size=d4.shape[-2:], mode="nearest-exact")
        feat = self.ConvBlock_5(torch.cat([x, d4], dim=1))
        return {name: getattr(self, f"Conv_{k}")(feat) for k, (name, _) in enumerate(HEADS)}


def maps_hwc(preds: Dict[str, torch.Tensor], i: int = 0) -> Dict[str, torch.Tensor]:
    """Image ``i``'s maps of a batch of (N, c, H, W) maps, each (H, W, c)."""
    return {k: v[i].permute(1, 2, 0) for k, v in preds.items()}


def init_camera_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Fill ``model`` (``Mono3D`` or ``Yolo2D``) as flax initialises the
    reference's: kernels from a LeCun normal (variance 1/fan_in, truncated
    at two standard deviations), biases 0 but the first 1x1 head's
    ``HEAT_BIAS``, norm scales 1.  The numbers differ from flax's."""
    trunc_std = 0.87962566103423978          # std of the standard normal cut at +-2
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.fill_(HEAT_BIAS if name == "Conv_0.bias" else 0.0)
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                std = math.sqrt(1.0 / p[0].numel()) / trunc_std
                p.copy_(nn.init.trunc_normal_(torch.empty(p.shape), std=std, a=-2.0 * std,
                                              b=2.0 * std, generator=generator))


def _nms_heat(heat: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool peaks of an (H, W, C) map; other cells -inf."""
    m = F.max_pool2d(heat.permute(2, 0, 1)[None], 3, stride=1, padding=1)[0].permute(1, 2, 0)
    return torch.where(torch.abs(heat - m) < 1e-6, heat, -torch.inf)


def decode_mono3d(preds: Dict[str, torch.Tensor], intrinsic: torch.Tensor,
                  max_objects: int = 64, stride: int = 4):
    """(H, W, c) maps + camera intrinsic (3, 3) -> camera-frame boxes.

    Returns (boxes (K, 7) [x y z l w h yaw_cam], scores (K,), labels (K,),
    valid (K,)).  Camera frame: x right, y down, z forward; yaw in the x-z
    ground plane, from the observation angle and the ray's direction.  The
    top K runs over the peaks flattened in (H, W, C) order, ties in index
    order as ``jax.lax.top_k`` gives them."""
    heat = torch.sigmoid(preds["heat"])
    H, W, C = heat.shape
    scores, idx = top_k(_nms_heat(heat).reshape(-1), max_objects)
    labels = idx % C
    cell = idx // C
    cy = (cell // W).float()
    cx = (cell % W).float()

    off = preds["offset"].reshape(-1, 2)[cell]
    u = (cx + torch.sigmoid(off[:, 0])) * stride
    v = (cy + torch.sigmoid(off[:, 1])) * stride
    z = 1.0 / torch.sigmoid(preds["depth"].reshape(-1)[cell]) - 1.0
    dims = torch.exp(torch.clamp(preds["dims"].reshape(-1, 3)[cell], -3.0, 3.0))
    rot = preds["rot"].reshape(-1, 2)[cell]
    alpha = torch.atan2(rot[:, 0], rot[:, 1])

    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx0, cy0 = intrinsic[0, 2], intrinsic[1, 2]
    X = (u - cx0) * z / fx
    Y = (v - cy0) * z / fy
    yaw = alpha + torch.atan2(X, z)
    boxes = torch.stack([X, Y, z, dims[:, 0], dims[:, 1], dims[:, 2], yaw], dim=1)
    valid = torch.isfinite(scores) & (scores > 0.0) & (z > 0.1) & (z < 200.0)
    return boxes, torch.where(valid, scores, 0.0), labels, valid


def make_mono3d_targets(cfg: Mono3DConfig, boxes_cam: np.ndarray,
                        labels: np.ndarray, intrinsic: np.ndarray) -> dict:
    """Ground-truth camera-frame boxes -> training target maps.

    boxes_cam (K, 7) [x y z l w h yaw_cam]; Gaussian heatmap splats at the
    projected centers + regression targets at the center cell.
    """
    H = cfg.image_hw[0] // cfg.stride
    W = cfg.image_hw[1] // cfg.stride
    heat = np.zeros((H, W, cfg.num_classes), np.float32)
    offset = np.zeros((H, W, 2), np.float32)
    depth = np.zeros((H, W, 1), np.float32)
    dims = np.zeros((H, W, 3), np.float32)
    rot = np.zeros((H, W, 2), np.float32)
    mask = np.zeros((H, W), bool)

    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx0, cy0 = intrinsic[0, 2], intrinsic[1, 2]
    for b, lab in zip(np.asarray(boxes_cam), np.asarray(labels)):
        x, y, z, l, w, h, yaw = b
        if z <= 0.1:
            continue
        u = (fx * x / z + cx0) / cfg.stride
        v = (fy * y / z + cy0) / cfg.stride
        ci, cj = int(v), int(u)
        if not (0 <= ci < H and 0 <= cj < W):
            continue
        # Gaussian radius scaled by projected size
        r = max(2, int(0.5 * fx * l / z / cfg.stride))
        ys, xs = np.ogrid[-ci:H - ci, -cj:W - cj]
        g = np.exp(-(xs * xs + ys * ys) / (2 * (r / 3.0) ** 2 + 1e-6))
        heat[:, :, int(lab)] = np.maximum(heat[:, :, int(lab)], g)
        offset[ci, cj] = [u - cj, v - ci]
        depth[ci, cj, 0] = z
        dims[ci, cj] = np.log(np.maximum([l, w, h], 1e-3))
        alpha = yaw - np.arctan2(x, z)
        rot[ci, cj] = [np.sin(alpha), np.cos(alpha)]
        mask[ci, cj] = True
    return dict(heat=heat, offset=offset, depth=depth, dims=dims, rot=rot,
                mask=mask)


def mono3d_loss(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Focal heatmap loss + masked L1 regression losses over (H, W, c)
    maps (``maps_hwc``), or (B, H, W, c) for one loss per image."""
    hwc = (-3, -2, -1)
    heat = torch.sigmoid(preds["heat"])
    gt = targets["heat"]
    pos = (gt > 0.999).float()
    neg_w = torch.pow(1.0 - gt, 4.0)
    eps = 1e-6
    pos_loss = -torch.log(heat + eps) * torch.pow(1 - heat, 2.0) * pos
    neg_loss = -torch.log(1 - heat + eps) * torch.pow(heat, 2.0) * neg_w * (1 - pos)
    n_pos = torch.clamp(torch.sum(pos, hwc), min=1.0)
    l_heat = (torch.sum(pos_loss, hwc) + torch.sum(neg_loss, hwc)) / n_pos

    m = targets["mask"][..., None].float()
    nm = torch.clamp(torch.sum(m, hwc), min=1.0)
    l_off = torch.sum(torch.abs(torch.sigmoid(preds["offset"]) - targets["offset"]) * m, hwc) / nm
    z_pred = 1.0 / torch.sigmoid(preds["depth"]) - 1.0
    l_depth = torch.sum(torch.abs(z_pred - targets["depth"]) * m, hwc) / nm
    l_dims = torch.sum(torch.abs(preds["dims"] - targets["dims"]) * m, hwc) / nm
    l_rot = torch.sum(torch.abs(preds["rot"] - targets["rot"]) * m, hwc) / nm
    total = l_heat + l_off + l_depth + 2.0 * l_dims + l_rot
    return total, dict(heat=l_heat, offset=l_off, depth=l_depth, dims=l_dims, rot=l_rot)
