"""CenterPoint heads and box decoding (counterpart of
``lsd_tpu/models/center_head.py``).

``CenterHead`` maps BEV features (N, C, H, W) to six prediction maps
(heatmap, centre offset, z, log-dims, sin/cos heading, freespace
segmentation); each head's last 1x1 conv runs in float32 (float64 in a
float64 twin), the rest in ``dtype``.  ``decode_boxes`` takes the maps in the reference's (H, W, C)
layout: the top-K runs over the heatmap flattened as (H, W, C), so
``index % C`` is the class.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from .iou3d import top_k
from .vfe import conv2d

# head (the reference's module prefix) -> (its map's name, its channels;
# None: one per class)
HEADS = dict(hm=("heatmap", None), offset=("offset", 2), z=("z", 1), dim=("dim", 3),
             rot=("rot", 2), seg=("seg", 1))
# sigmoid(-4.6) ~ 0.01: the heatmap's initial bias
HEATMAP_BIAS = -4.6


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 3, head_ch: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.shared = nn.Conv2d(in_channels, head_ch, 3, padding=1)
        self.heads = nn.ModuleDict({
            name: nn.ModuleDict(dict(conv1=nn.Conv2d(head_ch, head_ch, 3, padding=1),
                                     out=nn.Conv2d(head_ch, ch or num_classes, 1)))
            for name, (_, ch) in HEADS.items()})

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (N, C, H, W) -> dict of float32 prediction maps (N, c, H, W)."""
        shared = torch.relu(conv2d(self.shared, x, self.dtype, padding=1))
        out, out_dtype = {}, torch.promote_types(self.dtype, torch.float32)
        for name, head in self.heads.items():
            h = torch.relu(conv2d(head["conv1"], shared, self.dtype, padding=1))
            out[HEADS[name][0]] = conv2d(head["out"], h, out_dtype)
        return out


def decode_boxes(preds: Dict[str, torch.Tensor], voxel_size, pc_range, stride: int = 1,
                 max_boxes: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K decode of (H, W, C) maps: (boxes (K, 7), scores (K,), labels
    (K,), mask (K,)); boxes in world metres (x y z dx dy dz heading),
    OpenPCDet convention.

    Empty cells all carry one logit (zero input, one bias), so the top K
    holds exact ties below the thresholds; ``ops.iou3d.top_k`` orders them
    by index, as ``jax.lax.top_k`` does."""
    hm = torch.sigmoid(preds["heatmap"].float())
    H, W, C = hm.shape
    scores, idx = top_k(hm.reshape(-1), max_boxes)
    cls = idx % C
    pix = idx // C
    yy = (pix // W).float()
    xx = (pix % W).float()

    def gather_map(m, ch):
        return m.reshape(-1, m.shape[-1])[pix, ch].float()

    ox = gather_map(preds["offset"], 0)
    oy = gather_map(preds["offset"], 1)
    z = gather_map(preds["z"], 0)
    dx = torch.exp(gather_map(preds["dim"], 0))
    dy = torch.exp(gather_map(preds["dim"], 1))
    dz = torch.exp(gather_map(preds["dim"], 2))
    rot = torch.atan2(gather_map(preds["rot"], 0), gather_map(preds["rot"], 1))

    vx, vy = voxel_size[0] * stride, voxel_size[1] * stride
    x = (xx + ox) * vx + pc_range[0]
    y = (yy + oy) * vy + pc_range[1]
    boxes = torch.stack([x, y, z, dx, dy, dz, rot], dim=-1)
    return boxes, scores, cls, scores > 0.0
