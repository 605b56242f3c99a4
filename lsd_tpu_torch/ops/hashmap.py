"""Voxel hash primitives (counterpart of ``lsd_tpu/ops/hashmap.py:38-113``).

Slot placement decides map parity, so these are bit-exact with the
reference.  The reference hashes in uint32; PyTorch's uint32 support is
partial (and more so on CUDA), so the arithmetic here runs in int64 holding
values in [0, 2**32) and masks back to 32 bits after every multiply and
shift.  Multiplies are split into 16-bit halves so no int64 product ever
overflows.
"""
from __future__ import annotations

import torch

NUM_PROBES = 8
_M32 = 0xFFFFFFFF


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
