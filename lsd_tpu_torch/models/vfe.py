"""Voxel and pillar feature encoders (counterpart of ``lsd_tpu/models/vfe.py``).

- ``PillarVFE`` (``:29-58``): PointNet-style pillar encoder; points are
  augmented with their offsets from the pillar's mean and centre, go
  through Linear -> LayerNorm -> ReLU, and are max-pooled over the
  pillar's valid points.
- ``scatter_to_bev`` (``:127-138``) and ``scatter_to_bev_s2d``
  (``:101-124``): pillar features into a dense BEV image, the second
  space-to-depth (pillar (y, x) into coarse cell (y//f, x//f), channel
  group (y%f)*f + x%f) for the 0.1 m capacity.
- ``MeanVFE``, ``scatter_to_voxel_bev`` and ``VoxelHeightEncoder``
  (``:19-26, 61-98``): the ``encoder="voxel"`` branch.
- ``DynPillarVFE`` (no counterpart): DSVT-Pillar's dynamic pillar encoder,
  OpenPCDet's ``DynPillarVFE`` with its two ``PFNLayerV2`` layers: a max
  over all of a pillar's points (``ops/voxelize.py:pillarize_dynamic``).
  Its Linear layers are ``FoldedLinear``: eval-mode BatchNorm folded into
  the weights once, by ``fold``, before the model serves.

The scatters return (H, W, C) images, the reference's layout; the
detector views them as (1, C, H, W) in channels-last memory, which costs
no copy.  ``dtype`` is the compute type (bf16 by default, as the
reference's); parameters stay float32.  Norm statistics are taken in
float32 (in float64 for a float64 twin, ``at_least_float32``) and ``eps``
is flax's 1e-6.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

NORM_EPS = 1e-6
# point columns the encoders take: x y z intensity
POINT_FEATURES = 4


class MeanVFE(nn.Module):
    """Average point features per voxel."""

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
        # voxels (V, P, C); num_points (V,)
        s = torch.sum(voxels, dim=1)
        return s / torch.clamp(num_points[:, None].to(voxels.dtype), min=1.0)


class PillarVFE(nn.Module):
    def __init__(self, num_filters: int = 64,
                 voxel_size: Tuple[float, float, float] = (0.32, 0.32, 6.0),
                 pc_range: Tuple[float, ...] = (-51.2, -51.2, -3.0, 51.2, 51.2, 3.0),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.voxel_size, self.pc_range, self.dtype = tuple(voxel_size), tuple(pc_range), dtype
        # the point's columns, its offset from the pillar's mean (3) and centre (2)
        self.linear = nn.Linear(POINT_FEATURES + 5, num_filters)
        self.norm = nn.LayerNorm(num_filters, eps=NORM_EPS)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        """voxels (V, P, 4) [x y z intensity]; coords (V, 3) [z y x grid]
        -> (V, num_filters) in ``dtype``."""
        V, P, _ = voxels.shape
        npts = torch.clamp(num_points[:, None, None].to(voxels.dtype), min=1.0)
        pmask = (torch.arange(P, device=voxels.device)[None, :] < num_points[:, None])[..., None]

        mean_xyz = torch.sum(voxels[..., :3], dim=1, keepdim=True) / npts
        f_cluster = voxels[..., :3] - mean_xyz
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        cx = (coords[:, 2:3].to(voxels.dtype) + 0.5) * vx + self.pc_range[0]
        cy = (coords[:, 1:2].to(voxels.dtype) + 0.5) * vy + self.pc_range[1]
        f_center = voxels[..., :2] - torch.stack([cx, cy], dim=-1).reshape(V, 1, 2)

        # the raw x, y, z enter the Linear layer in ``dtype`` as in the reference,
        # and the bias is added to its rounded result
        feats = torch.cat([voxels, f_cluster, f_center], dim=-1) * pmask
        w = self.linear
        x = F.linear(feats.to(self.dtype), w.weight.to(self.dtype)) + w.bias.to(self.dtype)
        x = F.layer_norm(at_least_float32(x), x.shape[-1:], self.norm.weight, self.norm.bias,
                         NORM_EPS).to(self.dtype)
        x = torch.relu(x)
        x = torch.where(pmask, x, -torch.inf)
        x = torch.amax(x, dim=1)
        return torch.where(torch.isfinite(x), x, 0.0)


def fold_batchnorm(weight: torch.Tensor, bias, norm: nn.modules.batchnorm._BatchNorm,
                   out_dim: int = 0):
    """(weight, bias) of a layer followed by ``norm`` in eval mode, as one
    layer, float32: the scale ``gamma / sqrt(var + eps)`` multiplies the
    weight along its output axis ``out_dim`` (1 for a transposed conv)."""
    scale = norm.weight / torch.sqrt(norm.running_var + norm.eps)
    shape = [1] * weight.dim()
    shape[out_dim] = -1
    b = norm.bias - norm.running_mean * scale
    if bias is not None:
        b = b + bias * scale
    return weight * scale.reshape(shape), b


class FoldedLinear(nn.Module):
    """A Linear layer, with ``bn`` followed by eval-mode BatchNorm1d, that
    serves as one Linear of weights folded and cast to ``dtype`` by
    ``fold`` (non-persistent buffers: the checkpoint keeps the layers as
    published)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, bn: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=bias)
        self.norm = nn.BatchNorm1d(cout, eps=eps) if bn else None

    def fold(self, dtype: torch.dtype) -> None:
        w, b = self.linear.weight, self.linear.bias
        if self.norm is not None:
            w, b = fold_batchnorm(w, b, self.norm)
        self.register_buffer("w", w.detach().to(dtype), persistent=False)
        self.register_buffer("b", None if b is None else b.detach().to(dtype), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


class DynPillarVFE(nn.Module):
    """Dynamic pillar encoder (OpenPCDet ``DynPillarVFE``, ``NUM_FILTERS``
    [f, f]): each point's 4 columns, its offset from its pillar's mean (3)
    and from the pillar's centre (x, y; z from the middle of the z range)
    go through Linear 10 -> f/2, BN, ReLU; each point's result joined to
    its pillar's max is f wide; then Linear f -> f, BN, ReLU and a max over
    all of the pillar's points.  Offsets in float32, the layers in
    ``dtype``."""

    def __init__(self, num_filters: int = 192,
                 voxel_size: Tuple[float, float, float] = (0.32, 0.32, 6.0),
                 pc_range: Tuple[float, ...] = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.voxel_size, self.pc_range, self.dtype = tuple(voxel_size), tuple(pc_range), dtype
        self.pfn0 = FoldedLinear(POINT_FEATURES + 6, num_filters // 2, bias=False, bn=True,
                                 eps=1e-3)
        self.pfn1 = FoldedLinear(num_filters, num_filters, bias=False, bn=True, eps=1e-3)

    def forward(self, points: torch.Tensor, seg: torch.Tensor, cells: torch.Tensor,
                rows: int) -> torch.Tensor:
        """points (N, 4) in pillar order, seg (N,) their pillar rows (``rows``
        for none), cells (N, 2) [y, x] -> (rows, num_filters) in ``dtype``
        (0 for an empty row)."""
        xyz = points[:, :3]
        sums = xyz.new_zeros(rows + 1, 3).index_add_(0, seg, xyz)
        cnt = xyz.new_zeros(rows + 1).index_add_(0, seg, xyz.new_ones(xyz.shape[0]))
        mean = sums / torch.clamp(cnt, min=1.0)[:, None]
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.pc_range[:3]
        centre = torch.stack([cells[:, 1].to(xyz.dtype) * vx + (vx / 2 + x0),
                              cells[:, 0].to(xyz.dtype) * vy + (vy / 2 + y0),
                              xyz.new_full((xyz.shape[0],), vz / 2 + z0)], dim=-1)
        feats = torch.cat([points[:, :POINT_FEATURES], xyz - mean[seg], xyz - centre], dim=-1)
        x = torch.relu(self.pfn0(feats.to(self.dtype)))
        idx = seg[:, None].expand(-1, x.shape[1])
        # ReLU outputs are >= 0: a max that starts from 0 is the pillar's max
        pmax = x.new_zeros(rows + 1, x.shape[1]).scatter_reduce_(0, idx, x, "amax")
        x = torch.relu(self.pfn1(torch.cat([x, pmax[seg]], dim=-1)))
        idx = seg[:, None].expand(-1, x.shape[1])
        return x.new_zeros(rows + 1, x.shape[1]).scatter_reduce_(0, idx, x, "amax")[:rows]


def _scatter_rows(features: torch.Tensor, flat: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, C): features summed into the rows ``flat`` names; ``flat ==
    rows`` is a trash row, dropped."""
    out = features.new_zeros(rows + 1, features.shape[-1])
    return out.index_add_(0, flat, features)[:rows]


def scatter_to_bev(features: torch.Tensor, coords: torch.Tensor, vmask: torch.Tensor,
                   grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Pillar features (V, C) to a dense BEV image (H, W, C); coords are
    (V, 3) [z, y, x]; invalid pillars are dropped."""
    H, W = grid_hw
    flat = torch.where(vmask, coords[:, 1] * W + coords[:, 2], H * W)
    return _scatter_rows(features, flat, H * W).reshape(H, W, features.shape[-1])


def scatter_to_bev_s2d(features: torch.Tensor, coords: torch.Tensor, vmask: torch.Tensor,
                       grid_hw: Tuple[int, int], factor: int) -> torch.Tensor:
    """FINE pillar features (V, C) space-to-depth into a coarse BEV image
    (H/f, W/f, f*f*C): pillar (y, x) lands in coarse cell (y//f, x//f),
    channel group (y%f)*f + (x%f).  coords are (V, 3) [z, y, x] in FINE
    grid units."""
    H, W = grid_hw
    f = int(factor)
    Hc, Wc = H // f, W // f
    C = features.shape[-1]
    yc, xc = coords[:, 1] // f, coords[:, 2] // f
    grp = (coords[:, 1] % f) * f + (coords[:, 2] % f)
    flat = torch.where(vmask, (yc * Wc + xc) * (f * f) + grp, Hc * Wc * f * f)
    return _scatter_rows(features, flat, Hc * Wc * f * f).reshape(Hc, Wc, f * f * C)


def scatter_to_voxel_bev(features: torch.Tensor, coords: torch.Tensor, vmask: torch.Tensor,
                         grid_hw: Tuple[int, int], grid_z: int) -> torch.Tensor:
    """3D-voxel features (V, C) into a height-compressed BEV image
    (H, W, Z*C): each z-bin becomes a channel group.  coords are (V, 3)
    [z, y, x]."""
    H, W = grid_hw
    C = features.shape[-1]
    flat = torch.where(vmask, (coords[:, 1] * W + coords[:, 2]) * grid_z + coords[:, 0],
                       H * W * grid_z)
    return _scatter_rows(features, flat, H * W * grid_z).reshape(H, W, grid_z * C)


class VoxelHeightEncoder(nn.Module):
    """A height-compressed ``MeanVFE`` volume (N, Z*C, H, W) lifted to
    backbone channels by a 1x1 conv, GroupNorm and ReLU."""

    def __init__(self, in_channels: int, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, num_filters, 1)
        # groups must divide the channels: gcd(32, filters) (48 -> 16 groups)
        self.norm = nn.GroupNorm(math.gcd(32, num_filters), num_filters, eps=NORM_EPS)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        """vol (1, Z*C, H, W) -> (1, num_filters, H, W).  The reference
        normalises the unbatched (H, W, C) image, and flax's GroupNorm takes
        the first axis for the batch: the statistics are per BEV row, here
        too."""
        x = conv2d(self.conv, vol, self.dtype)
        rows = group_norm(self.norm, x.permute(2, 1, 0, 3), self.dtype)   # (H, C, 1, W)
        return torch.relu(rows.permute(2, 1, 0, 3))


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, padding=0) -> torch.Tensor:
    """``conv`` applied in ``dtype`` (input, weight and bias cast to it, as a
    flax module with that ``dtype`` does); ``padding`` as ``F.conv2d``.  As
    in flax, the bias is added to the convolution's result in ``dtype``
    (in bf16: rounded twice, not once)."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    padding) + conv.bias.to(dtype)[:, None, None]


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is if it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm with float32 statistics (float64 for float64), the result in
    ``dtype``."""
    return F.group_norm(at_least_float32(x), norm.num_groups, norm.weight, norm.bias,
                        norm.eps).to(dtype)
