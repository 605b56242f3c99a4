"""ScanContext place recognition: polar BEV descriptors (counterpart of
``lsd_tpu/slam/scancontext.py``).

Each scan becomes a (rings x sectors) max-height image in polar BEV; a
rotation-invariant "ring key" (per-ring occupancy mean) prunes candidates;
the full descriptor distance is the best column-shifted cosine distance,
which also yields a yaw estimate.

The database is a fixed-capacity array; candidate search and the shift
search are batched matmuls and reductions over the whole DB, so no KD-tree
is needed at these sizes (thousands of keyframes).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device

NUM_RING = 20
NUM_SECTOR = 60
MAX_RADIUS = 80.0


class ScanContextDB(NamedTuple):
    desc: torch.Tensor      # (C, R, S)
    ring_key: torch.Tensor  # (C, R)
    count: torch.Tensor     # () int32
    mask: torch.Tensor      # (C,)

    @property
    def capacity(self) -> int:
        return self.desc.shape[0]


def sc_db_create(capacity: int = 4096, rings: int = NUM_RING,
                 sectors: int = NUM_SECTOR, device: DeviceLike = None) -> ScanContextDB:
    dev = resolve_device(device)
    return ScanContextDB(
        desc=torch.zeros((capacity, rings, sectors), dtype=torch.float32, device=dev),
        ring_key=torch.zeros((capacity, rings), dtype=torch.float32, device=dev),
        count=torch.tensor(0, dtype=torch.int32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def make_descriptor(points: torch.Tensor, mask: torch.Tensor,
                    rings: int = NUM_RING, sectors: int = NUM_SECTOR,
                    max_radius: float = MAX_RADIUS) -> torch.Tensor:
    """Polar BEV max-height descriptor (rings, sectors).

    Heights are shifted by +2 m like the reference (lidar above ground) so
    ground returns produce positive cells.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) + math.pi
    ring = torch.clamp((r / max_radius * rings).to(torch.int32), 0, rings - 1)
    sector = torch.clamp((theta / (2 * math.pi) * sectors).to(torch.int32), 0, sectors - 1)
    ok = mask & (r < max_radius)
    flat = torch.where(ok, ring * sectors + sector, rings * sectors).long()
    # one spare cell takes the masked points; cells start at 0, so the max
    # also clamps negative heights as the reference does afterwards
    desc = points.new_zeros(rings * sectors + 1)
    desc.scatter_reduce_(0, flat, torch.where(ok, z + 2.0, -torch.inf), "amax")
    return desc[:-1].reshape(rings, sectors)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant per-ring occupancy mean."""
    return torch.mean((desc > 0).to(desc.dtype), dim=-1)


def sc_db_add_batch(db: ScanContextDB, descs: torch.Tensor,
                    mask: torch.Tensor) -> ScanContextDB:
    """Append the masked ones of K descriptors in order (the map load path
    rebuilds the whole DB at startup)."""
    cap = db.capacity
    pos = db.count + torch.cumsum(mask.to(torch.int32), 0) - 1
    # a spare row at index cap takes the masked-out descriptors
    tgt = torch.where(mask, pos % cap, cap).long()
    spare = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    desc, rk, used = spare(db.desc), spare(db.ring_key), spare(db.mask)
    desc[tgt] = descs
    rk[tgt] = ring_key(descs)
    used[tgt] = True
    return db._replace(desc=desc[:cap], ring_key=rk[:cap],
                       count=db.count + mask.to(torch.int32).sum(), mask=used[:cap])


def sc_db_add(db: ScanContextDB, desc: torch.Tensor) -> ScanContextDB:
    i = (db.count % db.capacity).long()[None]
    return db._replace(desc=db.desc.index_copy(0, i, desc[None]),
                       ring_key=db.ring_key.index_copy(0, i, ring_key(desc)[None]),
                       count=db.count + 1,
                       mask=db.mask.index_fill(0, i, True))


def _shifted_distance(q: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-over-shifts cosine distance between descriptors + best shift.

    q (R, S); d (..., R, S).  Columns are compared with cosine similarity,
    averaged over non-empty columns.
    """
    S = q.shape[-1]
    # roll q by every shift: (S, R, S)
    qs = torch.stack([torch.roll(q, s, dims=-1) for s in range(S)])
    dd = d if d.dim() == 3 else d[None]
    # (S_shift, R, S) x (C, R, S) column-wise cosine
    num = torch.einsum("krs,crs->cks", qs, dd)
    qn = torch.linalg.norm(qs, dim=1)                         # (S, S)
    dn = torch.linalg.norm(dd, dim=1)                         # (C, S)
    valid = (qn > 1e-6)[None] & (dn[:, None, :] > 1e-6)
    cos = torch.where(valid, num / torch.clamp(qn[None] * dn[:, None, :], min=1e-9), 0.0)
    ncol = torch.clamp(valid.sum(-1), min=1)
    d_shift = 1.0 - cos.sum(-1) / ncol                        # (C, S)
    dist, best = torch.min(d_shift, dim=-1)                   # first minimum
    return (dist, best) if d.dim() == 3 else (dist[0], best[0])


def sc_query(db: ScanContextDB, desc: torch.Tensor, num_candidates: int = 10,
             exclude_recent: int = 50) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Find the best match in the DB for ``desc``.

    Returns (best_index, distance, yaw_rad), all on the DB's device.
    best_index is -1 when no entry qualifies; the caller thresholds
    ``distance``; the ``exclude_recent`` newest entries are skipped (they
    are trivially similar: same spot).
    """
    qk = ring_key(desc)
    dk = torch.linalg.norm(db.ring_key - qk[None, :], dim=-1)
    recent = torch.arange(db.capacity, device=dk.device) >= (db.count - exclude_recent)
    dk = torch.where(db.mask & ~recent, dk, torch.inf)
    # the nearest ring keys, equal ones by lower index (the reference's
    # top_k order; torch.topk promises none)
    cand = torch.sort(dk, stable=True).indices[:num_candidates]

    dists, shifts = _shifted_distance(desc, db.desc[cand])
    dists = torch.where(torch.isfinite(dk[cand]), dists, torch.inf)
    # gathers, not ``x[b]``: indexing with a 0-dim tensor reads it on the host
    b = torch.argmin(dists)[None]
    dist, shift, best = dists[b][0], shifts[b][0], cand[b][0]
    best_idx = torch.where(torch.isfinite(dist), best, -1)
    yaw = shift.to(torch.float32) / db.desc.shape[-1] * 2 * math.pi
    # shifts > half-circle mean negative yaw
    yaw = torch.where(yaw > math.pi, yaw - 2 * math.pi, yaw)
    return best_idx, dist, yaw
