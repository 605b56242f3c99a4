"""Fixed-capacity voxel hash map: the raw-point LIO local map, and the hash
primitives the surfel map shares (counterpart of ``lsd_tpu/ops/hashmap.py``).

An open-addressed hash table of voxels, each holding up to K map points, as
a structure of arrays.  All operations are static-shape and functional
(they return a new map):

- ``hashmap_insert``: batch insert a (masked) downsampled scan
- ``hashmap_knn``:    for each query point, gather candidates from the
                      neighbour voxels and return the k nearest
- ``hashmap_trim``:   drop voxels outside a box around the sensor

Slot placement decides map parity, so keys, coords, counts and stored
points are bit-exact with the reference.  The reference hashes in uint32;
PyTorch's uint32 support is partial (and more so on CUDA), so the
arithmetic here runs in int64 holding values in [0, 2**32) and masks back
to 32 bits after every multiply and shift.  Multiplies are split into
16-bit halves so no int64 product ever overflows.  Slot allocation races
are settled by integer scatter-min, which is order-free, so the integers
are the same on the CPU and on CUDA.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .voxelize import _wrap_int32

NUM_PROBES = 8
_M32 = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32) held in int64, c a uint32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash_coords(coords: torch.Tensor, seed: int) -> torch.Tensor:
    """Mix integer voxel coords (..., 3) into a uint32 value (int64 tensor).

    ``& 0xFFFFFFFF`` on the int64 coords is the reference's
    ``astype(uint32)``: two's-complement wrap for negative coords.
    """
    c = coords.to(torch.int64) & _M32
    h = _fmix32(c[..., 0] ^ seed)
    h = _fmix32(h ^ c[..., 1])
    h = _fmix32(h ^ c[..., 2])
    return h


def _slot_hash(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    return (_hash_coords(coords, 0x9E3779B9) & (capacity - 1)).to(torch.int32)


def _content_key(coords: torch.Tensor) -> torch.Tensor:
    # non-negative int32; -1 stays "empty"
    return (_hash_coords(coords, 0x85EBCA77) & 0x3FFFFFFF).to(torch.int32)


def _probe_find(keys: torch.Tensor, coords: torch.Tensor, capacity: int,
                num_probes: int = NUM_PROBES) -> torch.Tensor:
    """Find the existing slot for voxel coords (..., 3); -1 if absent."""
    h0 = _slot_hash(coords, capacity)
    ck = _content_key(coords)
    found = torch.full_like(h0, -1)
    for p in range(num_probes):
        slot = (h0 + p) & (capacity - 1)
        match = keys[slot.long()] == ck
        found = torch.where((found < 0) & match, slot, found)
    return found


class VoxelHashMap(NamedTuple):
    keys: torch.Tensor      # (C,) int32 content key, -1 = empty
    coords: torch.Tensor    # (C, 3) int32 voxel integer coords (for trim/export)
    points: torch.Tensor    # (C, K, 3) f32 stored points (map frame)
    counts: torch.Tensor    # (C,) int32 valid points per voxel
    voxel_size: torch.Tensor  # () f32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def points_per_voxel(self) -> int:
        return self.points.shape[1]


def hashmap_create(capacity: int = 2 ** 17, points_per_voxel: int = 8,
                   voxel_size: float = 0.5, device: DeviceLike = None) -> VoxelHashMap:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    dev = resolve_device(device)
    return VoxelHashMap(
        keys=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        coords=torch.zeros((capacity, 3), dtype=torch.int32, device=dev),
        points=torch.zeros((capacity, points_per_voxel, 3), dtype=torch.float32, device=dev),
        counts=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        voxel_size=torch.full((), voxel_size, dtype=torch.float32, device=dev),
    )


def hashmap_insert(m: VoxelHashMap, points: torch.Tensor, mask: torch.Tensor) -> VoxelHashMap:
    """Insert masked points (N, 3) into the map."""
    n = points.shape[0]
    cap = m.capacity
    K = m.points_per_voxel
    dev = points.device
    coords = torch.floor(points / m.voxel_size).to(torch.int32)
    ck = _content_key(coords)

    # --- sort by voxel, find unique representatives ---
    # the reference's key is int32 arithmetic and wraps for large coords
    c = coords.to(torch.int64)
    sort_key = torch.where(mask, _wrap_int32((c[:, 0] * 2048 + c[:, 1]) * 2048 + c[:, 2]),
                           _INT32_MAX)
    sk_s, order = torch.sort(sort_key, stable=True)     # stable, as jnp.argsort
    coords_s, pts_s, mask_s, ck_s = coords[order], points[order], mask[order], ck[order]
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk_s[1:] != sk_s[:-1]
    first = first & mask_s
    # index of each point's voxel representative, and its rank behind it
    start = torch.cummax(torch.where(first, idx, -1), 0).values.clamp(min=0)
    rank = idx - start

    # --- allocate/find a slot per unique voxel (race-free via scatter-min) ---
    # keys and coords carry one spare row at index cap: writes of points that
    # did not win a slot land there (the reference's ``mode="drop"`` scatter)
    h0 = _slot_hash(coords_s, cap)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    keys = torch.cat([m.keys, m.keys.new_zeros(1)])
    coords_tbl = torch.cat([m.coords, m.coords.new_zeros(1, 3)])
    claim_tbl = torch.full((cap,), _INT32_MAX, dtype=torch.int64, device=dev)
    for p in range(NUM_PROBES):
        cand = ((h0 + p) & (cap - 1)).long()
        need = first & (slot < 0)
        existing = keys[cand]
        slot = torch.where(need & (existing == ck_s), cand, slot)
        # claim empty candidate slots; min point-index wins the race
        want = need & (existing < 0)
        claim_tbl.scatter_reduce_(0, torch.where(want, cand, cap - 1),
                                  torch.where(want, idx, _INT32_MAX), "amin")
        won = want & (claim_tbl[cand] == idx)
        slot = torch.where(won, cand, slot)
        tgt = torch.where(won, cand, cap)
        keys[tgt] = ck_s
        coords_tbl[tgt] = coords_s
        # stale claim_tbl entries only refer to slots that just became
        # occupied (every claimed empty slot gets exactly one winner), so no
        # reset between rounds is needed.

    # broadcast the representative's slot to all points of the voxel
    pslot = slot[start]
    ok = mask_s & (pslot >= 0)

    # --- append points, bounded by per-voxel capacity K ---
    pos = m.counts[pslot.clamp(min=0)] + rank
    ok = ok & (pos < K)
    flat = torch.where(ok, pslot * K + pos, cap * K)
    new_pts = torch.cat([m.points.reshape(cap * K, 3), m.points.new_zeros(1, 3)])
    new_pts[flat] = pts_s
    added = m.counts.new_zeros(cap + 1).index_add_(
        0, torch.where(ok, pslot, cap), ok.to(torch.int32))[:cap]
    return m._replace(keys=keys[:cap], coords=coords_tbl[:cap],
                      points=new_pts[:cap * K].reshape(cap, K, 3),
                      counts=m.counts + added)


def hashmap_trim(m: VoxelHashMap, center: torch.Tensor, radius: float) -> VoxelHashMap:
    """Free voxels outside an axis-aligned box of half-width ``radius``."""
    vc = (m.coords.to(torch.float32) + 0.5) * m.voxel_size
    keep = torch.all(torch.abs(vc - center) <= radius, dim=-1) & (m.keys >= 0)
    return m._replace(keys=torch.where(keep, m.keys, -1),
                      counts=torch.where(keep, m.counts, 0))


def _neighbor_offsets(neighborhood: int) -> np.ndarray:
    full = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    if neighborhood == 27:
        offs = full
    elif neighborhood == 19:   # center + 6 faces + 12 edges (no corners)
        offs = [o for o in full if abs(o[0]) + abs(o[1]) + abs(o[2]) <= 2]
    elif neighborhood == 7:    # center + 6 faces
        offs = [o for o in full if abs(o[0]) + abs(o[1]) + abs(o[2]) <= 1]
    else:
        raise ValueError(f"neighborhood must be 7, 19 or 27, got {neighborhood}")
    return np.asarray(offs, np.int32)


@functools.lru_cache(maxsize=None)
def _neighbor_offsets_on(neighborhood: int, device: torch.device) -> torch.Tensor:
    """The offsets as a tensor, uploaded once per device."""
    return torch.as_tensor(_neighbor_offsets(neighborhood), device=device)


def hashmap_knn(m: VoxelHashMap, queries: torch.Tensor, qmask: torch.Tensor, k: int = 5,
                neighborhood: int = 19) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest map points for each query (N, 3) from the neighbor voxels.
    Returns (neighbors (N, k, 3), valid (N, k)).

    Equal distances (and the ``inf`` of rows with fewer than k candidates)
    are ordered by candidate index, as the reference's ``top_k`` orders
    them; ``torch.topk`` promises no order, so this sorts stably."""
    n = queries.shape[0]
    K = m.points_per_voxel
    base = torch.floor(queries / m.voxel_size).to(torch.int32)

    offsets = _neighbor_offsets_on(neighborhood, queries.device)
    nb = offsets.shape[0]
    ncoords = base[:, None, :] + offsets[None, :, :]             # (N, nb, 3)
    slots = _probe_find(m.keys, ncoords, m.capacity)             # (N, nb)
    valid_slot = slots >= 0
    sl = slots.clamp(min=0).long()
    cand = m.points[sl]                                          # (N, nb, K, 3)
    ccnt = m.counts[sl]                                          # (N, nb)
    cmask = ((torch.arange(K, device=queries.device)[None, None, :] < ccnt[:, :, None])
             & valid_slot[:, :, None])

    cand = cand.reshape(n, nb * K, 3)
    cmask = cmask.reshape(n, nb * K)
    d2 = torch.sum((cand - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(cmask, d2, torch.inf)
    d2_s, order = torch.sort(d2, dim=1, stable=True)
    idx = order[:, :k]                                           # (N, k)
    nbrs = torch.gather(cand, 1, idx[:, :, None].expand(n, k, 3))
    valid = torch.isfinite(d2_s[:, :k]) & qmask[:, None]
    return nbrs, valid
