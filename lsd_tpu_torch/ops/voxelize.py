"""Voxel-grid downsample (counterpart of ``lsd_tpu/ops/voxelize.py:26-68``).

Static shapes and validity masks as in the reference.  The output lists one
mean point per occupied voxel in sorted-key order, the reference's order.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT_SENTINEL = 2 ** 31 - 1


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the reference's int32 math)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def voxel_keys(points: torch.Tensor, mask: torch.Tensor, voxel_size,
               origin=None, grid: int = 2048) -> torch.Tensor:
    """Quantize points to a flat int32 voxel key; invalid points -> INT_SENTINEL.

    ``grid`` bounds each axis to [-grid/2, grid/2) voxels around origin;
    out-of-range points are treated as invalid.  The key is computed in
    int32 and wraps exactly as the reference's does (grid**3 > 2**31), so
    the sort order matches.
    """
    if origin is not None:
        points = points - origin
    c = torch.floor(points[..., :3] / voxel_size).to(torch.int32).to(torch.int64) + grid // 2
    in_range = torch.all((c >= 0) & (c < grid), dim=-1)
    key = _wrap_int32((c[..., 0] * grid + c[..., 1]) * grid + c[..., 2])
    return torch.where(mask & in_range, key, INT_SENTINEL)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep one (mean) point per occupied voxel.

    points: (N, D>=3) with leading xyz; extra features are averaged too.
    Returns (out_points (capacity, D), out_mask (capacity,)).  Voxels past
    ``capacity`` (in key order) are dropped, as in the reference.
    """
    n, d = points.shape
    keys = voxel_keys(points, mask, voxel_size)
    keys_s, order = torch.sort(keys, stable=True)
    pts_s = points[order]

    first = torch.ones_like(keys_s, dtype=torch.bool)
    first[1:] = keys_s[1:] != keys_s[:-1]
    first = first & (keys_s != INT_SENTINEL)
    # segment id per sorted point, capped to capacity; overflow slot = capacity
    seg = torch.cumsum(first, 0) - 1
    seg = torch.where(keys_s == INT_SENTINEL, capacity, torch.clamp(seg, max=capacity))

    sums = points.new_zeros(capacity + 1, d).index_add_(0, seg, pts_s)[:capacity]
    cnts = points.new_zeros(capacity + 1).index_add_(
        0, seg, points.new_ones(n))[:capacity]
    out_mask = cnts > 0
    out = sums / torch.clamp(cnts[:, None], min=1.0)
    return torch.where(out_mask[:, None], out, 0.0), out_mask
