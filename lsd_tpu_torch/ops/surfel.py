"""Surfel voxel map: per-voxel Gaussian moments, planes from statistics.

Counterpart of ``lsd_tpu/ops/surfel.py``.  Each voxel of an open-addressed
hash table accumulates second-order moments of the points inserted into it;
a query merges the moments of its voxel and the 6 face neighbours and takes
the smallest eigenvector of the merged covariance as the plane normal.

Layout differs from the reference in one way: the reference keeps 10 (C,)
moment arrays and 3 (C,) coord arrays as tuples (an XLA-on-TPU scatter fast
path); here they are one (10, C) and one (3, C) tensor, so an insert is one
``index_add_`` and a query one gather.  ``convert.py`` maps between the two.
Moment rows: [n, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz], relative to
each voxel's centre.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device
from .hashmap import _content_key, _probe_find, _slot_hash

_INT32_MAX = 2 ** 31 - 1


class SurfelMap(NamedTuple):
    keys: torch.Tensor      # (C,) int32 content key, -1 empty
    coords: torch.Tensor    # (3, C) int32 voxel coords
    moments: torch.Tensor   # (10, C) f32 moment sums
    voxel_size: torch.Tensor  # () f32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def surfel_create(capacity: int = 2 ** 17, voxel_size: float = 0.5,
                  device: DeviceLike = None) -> SurfelMap:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    dev = resolve_device(device)
    return SurfelMap(
        keys=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        coords=torch.zeros((3, capacity), dtype=torch.int32, device=dev),
        moments=torch.zeros((10, capacity), dtype=torch.float32, device=dev),
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=dev),
    )


_ALLOC_ROUNDS = 2
# probe window shared by insert (allocation candidates) and match (lookup);
# the table runs at low load factor, so keep map_capacity >= 4x voxels
SURFEL_PROBES = 2


def surfel_insert(m: SurfelMap, points: torch.Tensor, mask: torch.Tensor) -> SurfelMap:
    """Scatter-add masked points (N, 3) into voxel moment accumulators.

    One gather reads all SURFEL_PROBES candidate keys per point; a point
    takes its voxel's existing slot or claims the first empty candidate.
    Races between points claiming one slot are settled by a scatter-min of
    the point index (lowest index wins), over _ALLOC_ROUNDS rounds; losers
    resolve in the next round through the refreshed keys.
    """
    n = points.shape[0]
    cap = m.capacity
    dev = points.device
    coords = torch.floor(points / m.voxel_size).to(torch.int32)
    ck = _content_key(coords)
    h0 = _slot_hash(coords, cap)
    probe = torch.arange(SURFEL_PROBES, dtype=torch.int32, device=dev)
    cand = ((h0[:, None] + probe) & (cap - 1)).long()          # (N, P)

    # keys and coords as one int32 table with a spare column at index cap:
    # writes of points that did not win a slot land there and are dropped
    # (the reference's ``mode="drop"`` scatter)
    tbl = torch.cat([
        torch.cat([m.keys[None], m.coords], 0),
        m.keys.new_zeros(4, 1)], 1)                               # (4, cap+1)
    new_rows = torch.cat([ck[None], coords.T], 0)                 # (4, N)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    claim = torch.full((cap,), _INT32_MAX, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    big = SURFEL_PROBES + 1
    for _ in range(_ALLOC_ROUNDS):
        kc = tbl[0][cand]                                         # (N, P)
        match_pos = torch.where(kc == ck[:, None], probe, big).amin(1)
        found = match_pos < SURFEL_PROBES
        hit = torch.gather(cand, 1, match_pos.clamp(max=SURFEL_PROBES - 1)[:, None].long())[:, 0]
        slot = torch.where((slot < 0) & found, hit, slot)
        # allocate: first empty candidate for still-unresolved points
        empty_pos = torch.where(kc < 0, probe, big).amin(1)
        need = mask & (slot < 0) & (empty_pos < SURFEL_PROBES)
        tgt = torch.gather(cand, 1, empty_pos.clamp(max=SURFEL_PROBES - 1)[:, None].long())[:, 0]
        claim.scatter_reduce_(0, torch.where(need, tgt, cap - 1),
                              torch.where(need, idx, _INT32_MAX), "amin")
        won = need & (claim[tgt] == idx)
        tbl[:, torch.where(won, tgt, cap)] = new_rows
        slot = torch.where(won, tgt, slot)

    ok = mask & (slot >= 0)
    center = (coords.to(torch.float32) + 0.5) * m.voxel_size
    off = points - center                                          # |off| <= voxel/2*sqrt3
    ox, oy, oz = off[:, 0], off[:, 1], off[:, 2]
    comps = torch.stack([torch.ones_like(ox), ox, oy, oz,
                         ox * ox, oy * oy, oz * oz, ox * oy, ox * oz, oy * oz])
    # points without a slot add 0 to slot 0 (no-op) instead of being dropped
    moments = m.moments.index_add(1, torch.where(ok, slot, 0),
                                  torch.where(ok, comps, 0.0))
    return m._replace(keys=tbl[0, :cap], coords=tbl[1:, :cap], moments=moments)


def surfel_trim(m: SurfelMap, center: torch.Tensor, radius: float) -> SurfelMap:
    vc = (m.coords.to(torch.float32) + 0.5) * m.voxel_size        # (3, C)
    keep = (m.keys >= 0) & torch.all(torch.abs(vc - center[:, None]) <= radius, 0)
    return m._replace(keys=torch.where(keep, m.keys, -1),
                      moments=torch.where(keep, m.moments, 0.0))


def _smallest_eigvec_3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched closed-form smallest eigenpair of symmetric (..., 3, 3).

    Returns (eigvec unit, lam_min, lam_mid).  Trigonometric Cardano for the
    eigenvalues; eigenvector from the cross product of two rows of
    (A - lam I), picking the largest cross product for stability.
    """
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 ** 2 + b11 ** 2 + b22 ** 2 + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-20))
    # det(B)/2 with B = (A - qI)/p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    lam2 = q + 2.0 * p * torch.cos(phi)                         # largest
    lam1 = 3.0 * q - lam0 - lam2

    # eigenvector for lam0: null space of (A - lam0 I)
    c0 = torch.stack([a00 - lam0, a01, a02], dim=-1)
    c1 = torch.stack([a01, a11 - lam0, a12], dim=-1)
    c2 = torch.stack([a02, a12, a22 - lam0], dim=-1)
    v01 = torch.linalg.cross(c0, c1)
    v02 = torch.linalg.cross(c0, c2)
    v12 = torch.linalg.cross(c1, c2)
    n01 = torch.sum(v01 ** 2, -1, keepdim=True)
    n02 = torch.sum(v02 ** 2, -1, keepdim=True)
    n12 = torch.sum(v12 ** 2, -1, keepdim=True)
    v = torch.where(n01 >= torch.maximum(n02, n12), v01,
                    torch.where(n02 >= n12, v02, v12))
    v = v / torch.sqrt(torch.clamp(torch.sum(v ** 2, -1, keepdim=True), min=1e-20))
    return v, lam0, lam1


def _face_offsets(device: torch.device) -> torch.Tensor:
    """(7, 3) int32: centre, then +x, -x, +y, -y, +z, -z (the reference's
    ``_FACE_OFFSETS`` order), built on the device without a host copy."""
    e = torch.eye(3, dtype=torch.int32, device=device)
    return torch.cat([torch.zeros_like(e[:1]),
                      torch.stack([e, -e], 1).reshape(6, 3)])


def surfel_neighborhood_moments(m: SurfelMap, queries: torch.Tensor) -> torch.Tensor:
    """Summed neighbourhood moments (N, 10) in each query's voxel-centre frame."""
    offs = _face_offsets(queries.device)
    base = torch.floor(queries / m.voxel_size).to(torch.int32)
    ncoords = base[:, None, :] + offs[None, :, :]                 # (N, 7, 3)
    slots = _probe_find(m.keys, ncoords, m.capacity, num_probes=SURFEL_PROBES)
    ok_slot = slots >= 0
    mom = m.moments[:, slots.clamp(min=0).long()] * ok_slot.to(torch.float32)  # (10, N, 7)

    # translate each neighbour's moments to the QUERY voxel centre frame:
    # offset d = neighbour_centre - query_centre = face_offset * voxel
    d = offs.to(torch.float32) * m.voxel_size                    # (7, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    cnt, s1x, s1y, s1z = mom[0], mom[1], mom[2], mom[3]
    sxx, syy, szz, sxy, sxz, syz = mom[4], mom[5], mom[6], mom[7], mom[8], mom[9]
    # S2' = S2 + d s1^T + s1 d^T + n d d^T  (per component)
    sxx = sxx + 2 * dx * s1x + cnt * dx * dx
    syy = syy + 2 * dy * s1y + cnt * dy * dy
    szz = szz + 2 * dz * s1z + cnt * dz * dz
    sxy = sxy + dx * s1y + dy * s1x + cnt * dx * dy
    sxz = sxz + dx * s1z + dz * s1x + cnt * dx * dz
    syz = syz + dy * s1z + dz * s1y + cnt * dy * dz
    s1x = s1x + cnt * dx
    s1y = s1y + cnt * dy
    s1z = s1z + cnt * dz
    # merge the 7 neighbours
    return torch.stack([cnt, s1x, s1y, s1z, sxx, syy, szz, sxy, sxz, syz],
                       dim=-1).sum(1)


def planes_from_moments(merged: torch.Tensor, queries: torch.Tensor,
                        voxel_size, qmask: torch.Tensor,
                        plane_thresh: float = 0.1, min_points: int = 6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane extraction from summed neighbourhood moments (N, 10)."""
    base = torch.floor(queries / voxel_size).to(torch.int32)
    N_ = merged[..., 0]
    S1 = merged[..., 1:4]
    Sxx, Syy, Szz = merged[..., 4], merged[..., 5], merged[..., 6]
    Sxy, Sxz, Syz = merged[..., 7], merged[..., 8], merged[..., 9]

    Nc = torch.clamp(N_, min=1.0)
    mean = S1 / Nc[:, None]
    mx, my, mz = mean[:, 0], mean[:, 1], mean[:, 2]
    cov = torch.stack([
        torch.stack([Sxx / Nc - mx ** 2, Sxy / Nc - mx * my, Sxz / Nc - mx * mz], -1),
        torch.stack([Sxy / Nc - mx * my, Syy / Nc - my ** 2, Syz / Nc - my * mz], -1),
        torch.stack([Sxz / Nc - mx * mz, Syz / Nc - my * mz, Szz / Nc - mz ** 2], -1),
    ], -2)

    normal, lam0, lam1 = _smallest_eigvec_3x3(cov)
    # plane in world coords: mean is relative to the query voxel centre
    center = (base.to(torch.float32) + 0.5) * voxel_size
    mean_w = mean + center
    dpl = -torch.sum(normal * mean_w, -1)

    rms = torch.sqrt(torch.clamp(lam0, min=0.0))
    valid = (qmask & (N_ >= min_points) & (rms < plane_thresh)
             & (lam1 > 4.0 * torch.clamp(lam0, min=1e-9))
             & torch.all(torch.isfinite(normal), -1))
    normal = torch.where(valid[:, None], normal, 0.0)
    dpl = torch.where(valid, dpl, 0.0)
    return normal, dpl, valid, torch.where(valid, rms, 0.0)


def surfel_match(m: SurfelMap, queries: torch.Tensor, qmask: torch.Tensor,
                 plane_thresh: float = 0.1, min_points: int = 6
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane (normals, d, valid, rms) per query from merged neighbourhood moments.

    The plane is n.x + d = 0 in world coords; valid requires enough points
    and RMS plane thickness below ``plane_thresh``.
    """
    merged = surfel_neighborhood_moments(m, queries)
    return planes_from_moments(merged, queries, m.voxel_size, qmask,
                               plane_thresh, min_points)
