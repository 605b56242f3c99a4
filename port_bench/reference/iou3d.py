"""Rotated 3D box IoU / GIoU and BEV NMS (counterpart of
``lsd_tpu/ops/iou3d.py:21-181``).

Rotated-rectangle overlap by vertex enumeration: the corners of each box
inside the other and the edge-edge intersections (24 candidates), sorted
by angle about their centroid (invalid ones at +inf, last) and summed with
the shoelace formula; all pairs at once, as tensor ops.  Boxes are (x, y,
z, dx, dy, dz, heading), OpenPCDet convention, heading about +z.

``nms_bev`` is the reference's greedy sweep over the top ``max_keep``
candidates in score order.  Nothing here makes a host sync.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV corners, CCW."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, r = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    c, s = torch.cos(r), torch.sin(r)
    lx = torch.stack([dx, dx, -dx, -dx], dim=-1) * 0.5
    ly = torch.stack([-dy, dy, dy, -dy], dim=-1) * 0.5
    cx = x[..., None] + lx * c[..., None] - ly * s[..., None]
    cy = y[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _ensure_ccw(corners: torch.Tensor) -> torch.Tensor:
    """Corner order made CCW (inside = left of every edge)."""
    area2 = ((corners[..., 1, 0] - corners[..., 0, 0]) * (corners[..., 2, 1] - corners[..., 0, 1])
             - (corners[..., 2, 0] - corners[..., 0, 0]) * (corners[..., 1, 1] - corners[..., 0, 1]))
    return torch.where((area2 >= 0)[..., None, None], corners, corners.flip(-2))


def _inside_quad(quads: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """CCW quads (..., 4, 2) x points (..., P, 2) -> (..., P) inside flags."""
    d = torch.roll(quads, -1, dims=-2) - quads                  # (..., 4, 2)
    rel = pts[..., :, None, :] - quads[..., None, :, :]          # (..., P, 4, 2)
    cross = d[..., None, :, 0] * rel[..., 1] - d[..., None, :, 1] * rel[..., 0]
    return torch.all(cross >= -1e-6, dim=-1)


def _pair_overlap_bev(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Overlap areas of BEV rectangles given as CCW corners (..., 4, 2)
    each, broadcast against each other."""
    c1, c2 = torch.broadcast_tensors(c1, c2)
    a_in = _inside_quad(c2, c1)                                 # (..., 4)
    b_in = _inside_quad(c1, c2)
    a0, b0 = c1, c2
    da = (torch.roll(c1, -1, dims=-2) - a0)[..., :, None, :]     # (..., 4, 1, 2)
    db = (torch.roll(c2, -1, dims=-2) - b0)[..., None, :, :]     # (..., 1, 4, 2)
    rel = b0[..., None, :, :] - a0[..., :, None, :]              # (..., 4, 4, 2)
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    par = torch.abs(denom) < 1e-9
    safe = torch.where(par, 1.0, denom)
    t = (rel[..., 0] * db[..., 1] - rel[..., 1] * db[..., 0]) / safe
    u = (rel[..., 0] * da[..., 1] - rel[..., 1] * da[..., 0]) / safe
    hit = ~par & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    inter = a0[..., :, None, :] + t[..., None] * da              # (..., 4, 4, 2)

    lead = c1.shape[:-2]
    pts = torch.cat([c1, c2, inter.reshape(*lead, 16, 2)], dim=-2)      # (..., 24, 2)
    valid = torch.cat([a_in, b_in, hit.reshape(*lead, 16)], dim=-1)
    cnt = valid.sum(-1)
    w = valid.to(c1.dtype)
    center = (pts * w[..., None]).sum(-2) / torch.clamp(cnt, min=1)[..., None]
    ang = torch.atan2(pts[..., 1] - center[..., None, 1], pts[..., 0] - center[..., None, 0])
    ang = torch.where(valid, ang, torch.inf)                     # invalid sort last
    order = torch.sort(ang, dim=-1, stable=True).indices
    sorted_pts = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    # padding slots := the first vertex: their cross terms vanish and the
    # closing edge (last valid -> first) comes from the roll
    slot = torch.arange(24, device=c1.device)
    sorted_pts = torch.where((slot < cnt[..., None])[..., None], sorted_pts,
                             sorted_pts[..., :1, :])
    nxt = torch.roll(sorted_pts, -1, dims=-2)
    cross = sorted_pts[..., 0] * nxt[..., 1] - nxt[..., 0] * sorted_pts[..., 1]
    area = 0.5 * torch.abs(cross.sum(-1))
    return torch.where(cnt >= 3, area, 0.0)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV overlap areas: (N, 7) x (M, 7) -> (N, M)."""
    ca = _ensure_ccw(_box_corners_bev(boxes_a))
    cb = _ensure_ccw(_box_corners_bev(boxes_b))
    return _pair_overlap_bev(ca[:, None], cb[None, :])


def _z_extents(boxes_a, boxes_b):
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    overlap = torch.clamp(torch.minimum(za2[:, None], zb2[None, :])
                          - torch.maximum(za1[:, None], zb1[None, :]), min=0.0)
    hull = torch.maximum(za2[:, None], zb2[None, :]) - torch.minimum(za1[:, None], zb1[None, :])
    return overlap, hull


def _volumes(boxes_a, boxes_b):
    va = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vb = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return va + vb


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU (N, M)."""
    zo, _ = _z_extents(boxes_a, boxes_b)
    inter = boxes_overlap_bev(boxes_a, boxes_b) * zo
    return inter / torch.clamp(_volumes(boxes_a, boxes_b) - inter, min=1e-6)


def boxes_giou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU3D, IoU - (hull - union) / hull, with the axis-aligned
    box around both boxes' BEV corners as the hull's footprint."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    ca = _box_corners_bev(boxes_a)
    cb = _box_corners_bev(boxes_b)
    hmin = torch.minimum(ca.amin(1)[:, None, :], cb.amin(1)[None, :, :])
    hmax = torch.maximum(ca.amax(1)[:, None, :], cb.amax(1)[None, :, :])
    hull_bev = torch.prod(torch.clamp(hmax - hmin, min=0.0), dim=-1)
    zo, zh = _z_extents(boxes_a, boxes_b)
    inter = overlap_bev * zo
    hull = hull_bev * zh
    union = _volumes(boxes_a, boxes_b) - inter
    iou = inter / torch.clamp(union, min=1e-6)
    return iou - (hull - union) / torch.clamp(hull, min=1e-6)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-D ``x`` and their indices, ties in index order
    as ``jax.lax.top_k`` gives them (``torch.topk`` leaves their order
    open): a stable descending sort."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
            iou_thresh: float = 0.1, max_keep: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS over the top ``max_keep`` candidates by score, with
    3D IoU as the reference computes it.  Returns (keep_idx (k,), keep_mask
    (k,)), k = min(max_keep, N).

    Candidate i is kept if it is valid and no kept candidate before it
    overlaps it by more than ``iou_thresh``: k dependent steps, each a
    product of one column of the overlap matrix with the keep vector, read
    on the device (no host sync)."""
    k = min(max_keep, boxes.shape[0])
    s = torch.where(mask, scores, -torch.inf)
    top_s, top_i = top_k(s, k)
    cand = boxes[top_i]
    valid = torch.isfinite(top_s).float()
    # sup[j, i]: j comes before i and overlaps it past the threshold
    sup = ((boxes_iou3d(cand, cand) > iou_thresh)
           & torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)).float()
    keep = torch.zeros(k, device=boxes.device)
    hits = torch.empty((), device=boxes.device)
    for i in range(k):
        torch.dot(sup[:, i], keep, out=hits)
        torch.mul(valid[i], hits < 0.5, out=keep[i])
    return top_i, keep > 0.5
