"""Anchor-free 2D detector for traffic lights (counterpart of
``lsd_tpu/models/yolo2d.py``).

Seven ConvBlocks (3x3 conv with bias, GroupNorm, SiLU) in bf16, down to
stride 16, then float32 1x1 heads: ``obj`` (1; its bias starts at -4.6),
``cls`` (one per class) and ``box`` (4, log-scale l t r b).  bf16 is
rounded where flax rounds it: the input is cast to bf16; each convolution
and, after it, its bias addition round to bf16 (``vfe.conv2d``); GroupNorm
takes its statistics in float32 and casts its output to bf16; SiLU is
``x * (1 / (1 + exp(-x)))`` with every operation rounded to bf16, as
``nn.silu`` lowers on bf16 (one fused rounding differs at 40 % of values);
the heads promote the features to float32 and keep float32 kernels.
Module names follow the flax tree, as in ``models/mono3d.py``.

``decode_yolo2d`` takes one image's maps in the reference's (H, W, c)
layout (``mono3d.maps_hwc``); ``nms_2d`` is the greedy axis-aligned sweep
over the 64 candidates, on the device, with no host sync.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..ops.iou3d import top_k
from .bev_backbone import _same_pad
from .vfe import NORM_EPS, conv2d, group_norm


class Yolo2DConfig(NamedTuple):
    num_classes: int = 8         # traffic-light colour x pictogram combinations
    channels: Tuple[int, ...] = (16, 32, 64, 128)
    stride: int = 16             # total output stride
    max_boxes: int = 64


class ConvBlock(nn.Module):
    """3x3 conv ("SAME", with bias) -> GroupNorm -> SiLU, in bf16."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_ch, ch, 3, stride=stride)
        self.GroupNorm_0 = nn.GroupNorm(min(16, ch), ch, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.Conv_0, _same_pad(x, 3, self.stride), torch.bfloat16)
        x = group_norm(self.GroupNorm_0, x, torch.bfloat16)
        # out of place: autograd keeps exp's result for the backward
        return torch.reciprocal(torch.exp(-x) + 1.0) * x


class Yolo2D(nn.Module):
    def __init__(self, cfg: Yolo2DConfig = Yolo2DConfig()):
        super().__init__()
        self.cfg = cfg
        c0, c1, c2, c3 = cfg.channels
        plan = ((3, c0, 2), (c0, c1, 2), (c1, c1, 1), (c1, c2, 2), (c2, c2, 1), (c2, c3, 2),
                (c3, c3, 1))
        for k, (cin, cout, s) in enumerate(plan):
            setattr(self, f"ConvBlock_{k}", ConvBlock(cin, cout, s))
        self.n_blocks = len(plan)
        self.Conv_0 = nn.Conv2d(c3, 1, 1)                  # obj
        self.Conv_1 = nn.Conv2d(c3, cfg.num_classes, 1)    # cls
        self.Conv_2 = nn.Conv2d(c3, 4, 1)                  # box

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (N, 3, H, W) float in [0, 1] -> float32 maps (N, c, H/16, W/16)."""
        x = image.to(torch.bfloat16)
        for k in range(self.n_blocks):
            x = getattr(self, f"ConvBlock_{k}")(x)
        return dict(obj=conv2d(self.Conv_0, x, torch.float32),
                    cls=conv2d(self.Conv_1, x, torch.float32),
                    box=conv2d(self.Conv_2, x, torch.float32))


def decode_yolo2d(preds: Dict[str, torch.Tensor], stride: int = 16, max_boxes: int = 64):
    """(H, W, c) maps -> (boxes_xyxy (K, 4), scores (K,), labels (K,),
    mask (K,)): the top K of obj x cls flattened in (H, W, C) order, ties in
    index order."""
    obj = torch.sigmoid(preds["obj"][..., 0])
    cls = torch.sigmoid(preds["cls"])
    H, W, C = cls.shape
    scores, idx = top_k((obj[..., None] * cls).reshape(-1), max_boxes)
    c = idx % C
    pix = idx // C
    yy = (pix // W).float()
    xx = (pix % W).float()
    ltrb = torch.exp(torch.clamp(preds["box"].reshape(-1, 4)[pix], -8, 8)) * stride
    cxp = (xx + 0.5) * stride
    cyp = (yy + 0.5) * stride
    boxes = torch.stack([cxp - ltrb[:, 0], cyp - ltrb[:, 1],
                         cxp + ltrb[:, 2], cyp + ltrb[:, 3]], dim=-1)
    return boxes, scores, c, scores > 0.0


def nms_2d(boxes: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
           iou_thresh: float = 0.5) -> torch.Tensor:
    """Greedy axis-aligned NMS over the (already top-K) candidates: the keep
    mask (K,).  Candidates go in descending score (masked ones last, ties in
    index order, a stable sort); one is kept if it is valid and no kept one
    before it overlaps it by more than ``iou_thresh``.  K dependent steps,
    each one dot product of a column of the overlap matrix with the keep
    vector, read on the device: no host sync."""
    k = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    iw = torch.clamp(torch.minimum(x2[:, None], x2[None, :])
                     - torch.maximum(x1[:, None], x1[None, :]), min=0)
    ih = torch.clamp(torch.minimum(y2[:, None], y2[None, :])
                     - torch.maximum(y1[:, None], y1[None, :]), min=0)
    inter = iw * ih
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-6)

    order = torch.sort(-torch.where(mask, scores, -torch.inf), stable=True)[1]
    # sup[j, i]: j comes before i and overlaps it past the threshold
    sup = ((iou[order][:, order] > iou_thresh)
           & torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)).float()
    valid = mask[order].float()
    keep = torch.zeros(k, device=boxes.device)
    hits = torch.empty((), device=boxes.device)
    for i in range(k):
        torch.dot(sup[:, i], keep, out=hits)
        torch.mul(valid[i], hits < 0.5, out=keep[i])
    return torch.zeros(k, dtype=torch.bool, device=boxes.device).scatter(0, order, keep > 0.5)
