"""Dense BEV backbone (counterpart of ``lsd_tpu/models/bev_backbone.py``).

Stages of stride-2 residual blocks, each brought back to the stride of the
first stage (a 3x3 conv where it already is, else a transposed conv with
kernel = stride) and concatenated.  Tensors are (N, C, H, W).

Two places where flax and PyTorch differ and the port follows flax:

- A strided 3x3 conv pads "SAME" as flax does: for stride 2 on an even
  input that is 0 before and 1 after (output (0, 0) is centred on input
  (1, 1)), not PyTorch's symmetric ``padding=1``.  ``_same_pad`` computes
  it from the input's size.
- flax's ``ConvTranspose`` does not flip its kernel; ``nn.ConvTranspose2d``
  places taps as a flipped kernel would.  ``convert.detector_params_*``
  flips both spatial axes when moving weights between the two.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .vfe import NORM_EPS, conv2d, group_norm, lowered


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` (N, C, H, W) padded as flax's ``padding="SAME"`` pads it."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):               # F.pad lists W first
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv0 = nn.Conv2d(in_ch, ch, 3, stride=stride)
        self.norm0 = nn.GroupNorm(min(32, ch), ch, eps=NORM_EPS)
        self.conv1 = nn.Conv2d(ch, ch, 3)
        self.norm1 = nn.GroupNorm(min(32, ch), ch, eps=NORM_EPS)
        self.shortcut = (nn.Conv2d(in_ch, ch, 1, stride=stride)
                         if stride != 1 or in_ch != ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(self.conv0, _same_pad(x, 3, self.stride), self.dtype)
        y = torch.relu(group_norm(self.norm0, y, self.dtype))
        y = conv2d(self.conv1, y, self.dtype, padding=1)
        y = group_norm(self.norm1, y, self.dtype)
        if self.shortcut is not None:
            x = conv2d(self.shortcut, x, self.dtype)
        return torch.relu(x + y)


class BEVBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int] = (1, 2, 2),
                 channels: Sequence[int] = (64, 128, 256), strides: Sequence[int] = (1, 2, 2),
                 up_channels: Sequence[int] = (128, 128, 128),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        blocks, ups, self.stage_ends = [], [], []
        total_stride, ch_in = 1, in_channels
        for i, (n, ch, st) in enumerate(zip(layer_nums, channels, strides)):
            blocks.append(ResBlock(ch_in, ch, stride=st, dtype=dtype))
            blocks += [ResBlock(ch, ch, dtype=dtype) for _ in range(n - 1)]
            self.stage_ends.append(len(blocks))
            total_stride *= st
            up = total_stride // strides[0]
            ups.append(nn.ConvTranspose2d(ch, up_channels[i], up, stride=up) if up > 1
                       else nn.Conv2d(ch, up_channels[i], 3, padding=1))
            ch_in = ch
        self.blocks, self.ups = nn.ModuleList(blocks), nn.ModuleList(ups)
        self.out_channels = sum(up_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) -> BEV features (N, sum(up_channels), H/s0, W/s0)
        at the stride s0 of the first stage, in ``dtype``."""
        outs, k = [], 0
        for up, end in zip(self.ups, self.stage_ends):
            for block in self.blocks[k:end]:
                x = block(x)
            k = end
            if isinstance(up, nn.ConvTranspose2d):
                outs.append(F.conv_transpose2d(lowered(x.to(self.dtype)), lowered(up.weight.to(self.dtype)),
                                               up.bias.to(self.dtype), up.stride))
            else:
                outs.append(conv2d(up, x, self.dtype, padding=1))
        return torch.cat(outs, dim=1)
