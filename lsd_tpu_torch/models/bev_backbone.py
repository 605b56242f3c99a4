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

``BaseBEVResBackbone`` is OpenPCDet's, as DSVT-Pillar publishes it:
``BasicBlock``s (3x3 convolutions without bias, each followed by BatchNorm
(eps 1e-3), PyTorch's symmetric padding, a 1x1 convolution and BatchNorm as
the shortcut of every stage's first block), and every up path a transposed
convolution of kernel and stride its ratio (1x1 at stride 1), BatchNorm
and ReLU.  The norms serve in eval mode, folded into the convolutions once
by ``fold``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .vfe import NORM_EPS, conv2d, fold_batchnorm, group_norm

BN_EPS = 1e-3


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
                outs.append(F.conv_transpose2d(x.to(self.dtype), up.weight.to(self.dtype),
                                               up.bias.to(self.dtype), up.stride))
            else:
                outs.append(conv2d(up, x, self.dtype, padding=1))
        return torch.cat(outs, dim=1)


class FoldedConv(nn.Module):
    """A convolution without bias (transposed with ``transposed``) followed
    by eval-mode BatchNorm2d, served as one convolution of weights folded
    and cast to ``dtype`` by ``fold`` (non-persistent buffers)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, transposed: bool = False):
        super().__init__()
        self.stride, self.transposed = stride, transposed
        self.padding = 0 if transposed else k // 2
        cls = nn.ConvTranspose2d if transposed else nn.Conv2d
        self.conv = cls(cin, cout, k, stride=stride, padding=self.padding, bias=False)
        self.norm = nn.BatchNorm2d(cout, eps=BN_EPS)

    def fold(self, dtype: torch.dtype) -> None:
        w, b = fold_batchnorm(self.conv.weight, None, self.norm, out_dim=int(self.transposed))
        self.register_buffer("w", w.detach().to(dtype), persistent=False)
        self.register_buffer("b", b.detach().to(dtype), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.w.dtype)
        if self.transposed:
            return F.conv_transpose2d(x, self.w, self.b, self.stride)
        return F.conv2d(x, self.w, self.b, self.stride, self.padding)


class BasicBlock(nn.Module):
    """OpenPCDet's ``BasicBlock``: conv BN ReLU, conv BN, the shortcut
    (``downsample``: a 1x1 conv and BN), add, ReLU."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv0 = FoldedConv(in_ch, ch, 3, stride)
        self.conv1 = FoldedConv(ch, ch, 3)
        self.shortcut = FoldedConv(in_ch, ch, 1, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.conv0(x)))
        return torch.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class BaseBEVResBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int], channels: Sequence[int],
                 strides: Sequence[int], up_channels: Sequence[int]):
        """``layer_nums``: the blocks of each stage (OpenPCDet's ``LAYER_NUMS``
        counts the blocks after the first: pass 1 + n)."""
        super().__init__()
        blocks, ups, self.stage_ends = [], [], []
        total_stride, ch_in = 1, in_channels
        for n, ch, st, up_ch in zip(layer_nums, channels, strides, up_channels):
            blocks.append(BasicBlock(ch_in, ch, st, downsample=True))
            blocks += [BasicBlock(ch, ch) for _ in range(n - 1)]
            self.stage_ends.append(len(blocks))
            total_stride *= st
            up = total_stride // strides[0]
            ups.append(FoldedConv(ch, up_ch, up, up, transposed=True))
            ch_in = ch
        self.blocks, self.ups = nn.ModuleList(blocks), nn.ModuleList(ups)
        self.out_channels = sum(up_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) -> BEV features (N, sum(up_channels), H/s0, W/s0)
        in the folded weights' dtype."""
        outs, k = [], 0
        for up, end in zip(self.ups, self.stage_ends):
            for block in self.blocks[k:end]:
                x = block(x)
            k = end
            outs.append(torch.relu(up(x)))
        return torch.cat(outs, dim=1)
