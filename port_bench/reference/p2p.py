"""The plain PyTorch form of the fused point-to-plane reduction (B1):
(HtH (24, 24), Htr (24,), stats = [n_valid, sum |r|, sum w])."""
from __future__ import annotations

from typing import Tuple

import torch

_ACTIVE = (slice(0, 6), slice(18, 24))   # Jacobian rows 0:6 and 6:12 in the 24-dim layout


def _scatter_24(G: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    HtH = G.new_zeros(24, 24)
    Htr = g.new_zeros(24)
    for a, sa in enumerate(_ACTIVE):
        Htr[sa] = g[6 * a:6 * a + 6]
        for b, sb in enumerate(_ACTIVE):
            HtH[sa, sb] = G[6 * a:6 * a + 6, 6 * b:6 * b + 6]
    return HtH, Htr


def p2p_reduce_plain(pts_l: torch.Tensor, normals: torch.Tensor, d: torch.Tensor,
                     weight: torch.Tensor, R: torch.Tensor, Re: torch.Tensor,
                     te: torch.Tensor, pos: torch.Tensor, max_resid: float,
                     est_extrinsic: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused reduction (the CPU path and the
    reference the kernel is held to).

    The per-point arithmetic is written out element by element in the same
    order as the kernel, so the two round alike and the validity gate
    decides the same points.
    """
    x, y, z = pts_l[:, 0], pts_l[:, 1], pts_l[:, 2]
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    est = 1.0 if est_extrinsic else 0.0
    pbx = Re[0, 0] * x + Re[0, 1] * y + Re[0, 2] * z + te[0]
    pby = Re[1, 0] * x + Re[1, 1] * y + Re[1, 2] * z + te[1]
    pbz = Re[2, 0] * x + Re[2, 1] * y + Re[2, 2] * z + te[2]
    pwx = R[0, 0] * pbx + R[0, 1] * pby + R[0, 2] * pbz + pos[0]
    pwy = R[1, 0] * pbx + R[1, 1] * pby + R[1, 2] * pbz + pos[1]
    pwz = R[2, 0] * pbx + R[2, 1] * pby + R[2, 2] * pbz + pos[2]
    r = nx * pwx + ny * pwy + nz * pwz + d
    ar = torch.abs(r)
    # FAST-LIO validity gate: s = 1 - 0.9 |r| / sqrt(|p_l|) > 0.9
    pnorm = torch.sqrt(x * x + y * y + z * z)
    s = 1.0 - 0.9 * ar / torch.sqrt(torch.clamp(pnorm, min=1e-3))
    valid = (weight > 0.0) & (s > 0.9) & (ar < max_resid)
    w = torch.where(valid, weight, 0.0)

    nRx = nx * R[0, 0] + ny * R[1, 0] + nz * R[2, 0]
    nRy = nx * R[0, 1] + ny * R[1, 1] + nz * R[2, 1]
    nRz = nx * R[0, 2] + ny * R[1, 2] + nz * R[2, 2]
    nRRex = nRx * Re[0, 0] + nRy * Re[1, 0] + nRz * Re[2, 0]
    nRRey = nRx * Re[0, 1] + nRy * Re[1, 1] + nRz * Re[2, 1]
    nRRez = nRx * Re[0, 2] + nRy * Re[1, 2] + nRz * Re[2, 2]
    J = torch.stack([
        nx, ny, nz,
        -(nRy * pbz - nRz * pby), -(nRz * pbx - nRx * pbz), -(nRx * pby - nRy * pbx),
        -(nRRey * z - nRRez * y) * est, -(nRRez * x - nRRex * z) * est,
        -(nRRex * y - nRRey * x) * est,
        nRx * est, nRy * est, nRz * est], dim=1)                # (N, 12)
    # zero invalid rows so non-finite values of skipped points cannot leak
    Jw = torch.where(valid[:, None], J * w[:, None], 0.0)
    J = torch.where(valid[:, None], J, 0.0)
    rv = torch.where(valid, r, 0.0)
    HtH, Htr = _scatter_24(Jw.T @ J, Jw.T @ rv)
    vf = valid.to(r.dtype)
    stats = torch.stack([vf.sum(), (vf * ar).sum(), w.sum()])
    return HtH, Htr, stats
