"""Batched plane fitting + point-to-plane residuals (counterpart of
``lsd_tpu/ops/planefit.py``).

For every scan point, fit a plane to its k map neighbours by solving the
normal equations of A n = -1, check inlier consistency, and emit the unit
normal and offset.  Fully vectorized over the scan.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fit_planes(neighbors: torch.Tensor, valid: torch.Tensor, inlier_thresh: float = 0.1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit a plane n.x + d = 0 (|n| = 1) per query.

    neighbors: (N, k, 3); valid: (N, k).
    Returns (normals (N, 3), d (N,), ok (N,)) where ok requires all valid
    neighbors within ``inlier_thresh`` of the plane and >= 3 valid points.
    """
    w = valid.to(neighbors.dtype)
    # Solve (A^T W A) n = -A^T W 1
    AtA = torch.einsum("nki,nkj,nk->nij", neighbors, neighbors, w)
    Atb = -torch.einsum("nki,nk->ni", neighbors, w)
    AtA = AtA + 1e-4 * torch.eye(3, dtype=neighbors.dtype, device=neighbors.device)
    # solve_ex: no status check on the host (no sync, no raise on a singular
    # member); what a near-singular system leaves is sanitized below
    n_raw = torch.linalg.solve_ex(AtA, Atb[..., None]).result[..., 0]   # n_raw.x + 1 = 0
    finite = torch.all(torch.isfinite(n_raw), dim=-1)
    n_raw = torch.where(finite[..., None], n_raw, 0.0)
    norm = torch.linalg.norm(n_raw, dim=-1)
    normals = n_raw / torch.clamp(norm, min=1e-9)[..., None]
    d = torch.where(norm > 1e-9, 1.0 / torch.clamp(norm, min=1e-9), 0.0)

    resid = torch.abs(torch.einsum("nki,ni->nk", neighbors, normals) + d[:, None])
    ok = ((torch.sum(valid, dim=-1) >= 3) & finite & (norm > 1e-6)
          & torch.all(torch.where(valid, resid <= inlier_thresh, True), dim=-1))
    normals = torch.where(ok[..., None], normals, 0.0)
    d = torch.where(ok, d, 0.0)
    return normals, d, ok


def point_to_plane(points_world: torch.Tensor, normals: torch.Tensor, d: torch.Tensor
                   ) -> torch.Tensor:
    """Signed distance of world-frame points (N, 3) to planes (n, d)."""
    return torch.einsum("ni,ni->n", points_world, normals) + d
