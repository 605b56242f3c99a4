"""Voxelization (counterpart of ``lsd_tpu/ops/voxelize.py``).

- ``voxel_downsample`` (``:26-68``): one mean point per occupied voxel, in
  sorted-key order, the reference's order.
- ``voxelize_dynamic`` (``:71-129``): points grouped into a fixed budget of
  voxels (pillars) of a fixed number of points each, for the detector.
- ``pillarize_dynamic`` (no counterpart): points grouped into a fixed budget
  of pillars with no cap on the points a pillar, for DSVT-Pillar's dynamic
  pillar encoder (``models/vfe.py:DynPillarVFE``).

Static shapes and validity masks as in the reference; no host sync.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import to_device

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


def voxelize_dynamic(points: torch.Tensor, mask: torch.Tensor, voxel_size, pc_range,
                     max_voxels: int, max_points_per_voxel: int):
    """Group points into voxels for the detector's encoders.

    points: (N, D), xyz + features.  voxel_size: (3,), pc_range: (6,)
    [xmin ymin zmin xmax ymax zmax], host numbers.

    Returns:
      voxels   (max_voxels, max_points_per_voxel, D)
      coords   (max_voxels, 3) int32, the z, y, x grid index
      num_pts  (max_voxels,) int32
      vmask    (max_voxels,) bool

    Voxels are numbered in key order (z, then y, then x).  A voxel keeps its
    first ``max_points_per_voxel`` points in input order (a stable sort),
    which is the order the reference's sort keeps on the CPU; voxels past
    ``max_voxels`` are dropped.  The grid cell is ``floor((p - min) / size)``
    with a float32 divide, as in the reference.
    """
    n, d = points.shape
    V, P = max_voxels, max_points_per_voxel
    vs = np.asarray(voxel_size, np.float32)
    pr = np.asarray(pc_range, np.float32)
    gsz = np.floor((pr[3:] - pr[:3]) / vs + np.float32(0.5)).astype(np.int64)
    # one upload: grid minimum, voxel size, grid size (exact in float32)
    consts = to_device(np.stack([pr[:3], vs, gsz.astype(np.float32)]), points.device,
                       points.dtype)

    def cells(p):
        return torch.floor((p[:, :3] - consts[0]) / consts[1]).to(torch.int32)

    c = cells(points)
    in_range = torch.all((c >= 0) & (c < consts[2]), dim=-1) & mask
    key = (c[:, 2] * int(gsz[1]) + c[:, 1]) * int(gsz[0]) + c[:, 0]
    key = torch.where(in_range, key, INT_SENTINEL)

    key_s, order = torch.sort(key, stable=True)
    pts_s = points[order]
    c_s = cells(pts_s)
    idx = torch.arange(n, device=points.device)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    valid_s = key_s != INT_SENTINEL
    first = first & valid_s
    seg = torch.cumsum(first, 0) - 1                       # voxel index per point
    start = torch.cummax(torch.where(first, idx, -1), 0).values
    rank = idx - torch.clamp(start, min=0)
    keep = valid_s & (seg < V) & (rank < P)

    seg_c = torch.where(keep, seg, V)
    flat = seg_c * P + torch.where(keep, rank, 0)
    voxels = points.new_zeros(V * P + P, d).index_add_(
        0, flat, torch.where(keep[:, None], pts_s, 0.0))[:V * P].reshape(V, P, d)
    num_pts = torch.zeros(V + 1, dtype=torch.int32, device=points.device).index_add_(
        0, seg_c, keep.to(torch.int32))[:V]
    coords_zyx = torch.stack([c_s[:, 2], c_s[:, 1], c_s[:, 0]], dim=-1)
    coords = torch.zeros(V + 1, 3, dtype=torch.int32, device=points.device).scatter_reduce_(
        0, seg_c[:, None].expand(n, 3),
        torch.where((keep & first)[:, None], coords_zyx, -1), reduce="amax")[:V]
    return voxels, coords, num_pts, num_pts > 0


def pillarize_dynamic(points: torch.Tensor, mask: torch.Tensor, voxel_size, pc_range,
                      max_pillars: int):
    """Group points into pillars with no cap on the points a pillar, as
    OpenPCDet's ``DynPillarVFE`` groups them: a point belongs to the pillar
    ``floor((p - min) / size)`` of its x and y (float32 divide) where both
    lie inside the grid; z is not checked.

    points: (N, D) xyz + features; voxel_size (3,), pc_range (6,), host
    numbers.  Returns, with P = ``max_pillars``:
      order   (N,) the points in pillar order (a stable sort by pillar key)
      seg     (N,) the pillar row of each point of ``points[order]``; P for
              a point outside the grid, masked, or in a pillar past P
      cells   (N, 2) int32 [y, x] cell of each point of ``points[order]``
      coords  (P, 3) int32 [z, y, x] of each pillar (z is 0)
      pmask   (P,) bool, the pillars the frame fills
      found   () int64, the pillars the frame has (more than P: some dropped)

    Pillars are numbered in key order (y, then x); no host sync."""
    n = points.shape[0]
    P = int(max_pillars)
    vs = np.asarray(voxel_size, np.float32)
    pr = np.asarray(pc_range, np.float32)
    gsz = np.floor((pr[3:5] - pr[:2]) / vs[:2] + np.float32(0.5)).astype(np.int64)
    consts = to_device(np.stack([pr[:2], vs[:2], gsz.astype(np.float32)]), points.device,
                       points.dtype)
    c = torch.floor((points[:, :2] - consts[0]) / consts[1]).to(torch.int32)
    in_range = torch.all((c >= 0) & (c < consts[2]), dim=-1) & mask
    key = torch.where(in_range, c[:, 1] * int(gsz[0]) + c[:, 0], INT_SENTINEL)
    key_s, order = torch.sort(key, stable=True)
    cells = c[order].flip(-1)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= key_s != INT_SENTINEL
    seg = torch.cumsum(first, 0) - 1
    seg = torch.where((key_s != INT_SENTINEL) & (seg < P), seg, P)
    zyx = torch.cat([torch.zeros_like(cells[:, :1]), cells], dim=-1)
    coords = torch.zeros(P + 1, 3, dtype=torch.int32, device=points.device).index_put_(
        (torch.where(first, seg, P),), zyx)[:P]
    found = first.sum()
    pmask = torch.arange(P, device=points.device) < found
    return order, seg, cells, coords, pmask, found
