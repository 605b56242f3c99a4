"""Scan registration: point-to-plane ICP as fixed-count Gauss-Newton
(counterpart of ``lsd_tpu/slam/registration.py:30-148,314-353``).

``icp_point_to_plane`` aligns a source scan to a target map, either a
``SurfelMap`` (merged neighbourhood moments) or a ``VoxelHashMap`` (kNN +
5-point plane fits): the loop-closure verifier.  It optimizes a 6-dof
right-perturbation twist with fixed iteration counts (static shapes;
convergence is monitored via the returned fitness) and makes no host sync.
The reference's NDT half (``NdtMap``, ``ndt_build``, ``ndt_align``) belongs
to the localization slice and is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import np_so3, so3
from ..ops.hashmap import hashmap_knn
from ..ops.planefit import fit_planes
from ..ops.surfel import SurfelMap, surfel_create, surfel_insert, surfel_match
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.precision import slam_f32


def _apply(q, t, pts):
    return so3.quat_rotate(q[None, :], pts) + t


def _gn_system(source, mask, q, t, normals, d, ok, max_dist):
    """Residuals and Jacobian rows [dr/dtheta, dr/dt] (right-perturbed
    rotation) of the points inside the gate: (H (N, 6), r*w (N,), w (N,))."""
    pw = _apply(q, t, source)
    r = torch.einsum("ni,ni->n", pw, normals) + d
    w = (mask & ok & (torch.abs(r) < max_dist)).to(source.dtype)
    nR = normals @ so3.quat_to_matrix(q)
    H = torch.cat([-torch.linalg.cross(nR, source), normals], dim=-1) * w[:, None]
    return H, r * w, w


@slam_f32
def icp_point_to_plane(target, source: torch.Tensor, mask: torch.Tensor,
                       q0: torch.Tensor, t0: torch.Tensor, iters: int = 10,
                       plane_thresh: float = 0.2, max_dist: float = 1.0,
                       neighborhood: int = 19,
                       searches: Optional[int] = None,
                       min_points: int = 6
                       ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Refine (q0, t0) so that source points fit target planes.

    target: VoxelHashMap (kNN + 5-point plane fit) or SurfelMap (merged
    neighborhood moments, much cheaper lookups).

    The expensive plane search runs ``searches`` times (default: every
    iteration, exact classic ICP); between searches, ``iters // searches``
    Gauss-Newton iterations re-linearize against the fixed plane set.
    Callers with tight priors pass searches=1-2 to amortize the dominant
    search cost; association is stable under mm-cm per-iteration motion.

    Returns (q, t, info) with info = dict(fitness=inlier fraction, JtJ,
    mean_residual, last_delta, n_inliers, inlier_ratio, overlap), all
    tensors on the source's device.
    """
    searches = iters if searches is None else max(1, min(searches, iters))
    inner = max(1, iters // searches)
    dtype, dev = source.dtype, source.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def find_planes(q, t):
        pw = _apply(q, t, source)
        if isinstance(target, SurfelMap):
            normals, d, ok, _rms = surfel_match(target, pw, mask, plane_thresh,
                                                min_points=min_points)
        else:
            nbrs, nvalid = hashmap_knn(target, pw, mask, k=5, neighborhood=neighborhood)
            normals, d, ok = fit_planes(nbrs, nvalid, plane_thresh)
        return normals, d, ok

    q, t = q0, t0
    for _ in range(searches):
        normals, d, ok = find_planes(q, t)
        n_planes = torch.sum((mask & ok).to(dtype))
        for _ in range(inner):
            H, rw, w = _gn_system(source, mask, q, t, normals, d, ok, max_dist)
            A = H.T @ H
            # Levenberg damping + trust region: sparse scans leave near-null
            # directions (ground-only patches), and an undamped GN step runs
            # tens of meters along them; damping relative to diag(A) keeps
            # the conditioned directions exact while bounding the null ones
            A = A + 1e-3 * torch.diag(torch.diagonal(A)) + 1e-6 * eye6
            b = H.T @ rw
            dx = -torch.linalg.solve_ex(A, b).result
            rot_n = torch.linalg.norm(dx[:3])
            t_n = torch.linalg.norm(dx[3:])
            scale = torch.clamp(torch.minimum(0.3 / torch.clamp(rot_n, min=1e-9),
                                              1.0 / torch.clamp(t_n, min=1e-9)), max=1.0)
            dx = dx * scale
            q = so3.quat_normalize(so3.quat_mul(q, so3.quat_from_rotvec(dx[:3])))
            t = t + dx[3:]
            n_valid, sum_abs_r = torch.sum(w), torch.sum(torch.abs(rw))
            last_delta = torch.linalg.norm(dx)
    # final-iterate Gauss-Newton normal matrix: the 6-dof constraint
    # stiffness of this alignment ([rot, trans] rows, world basis at the
    # source pose).  Directions the target geometry does not constrain
    # (sliding along a corridor, yaw on a ground-only patch) show up as
    # near-zero eigenvalues; callers derive per-axis edge information
    # from it.
    H_f, _, _ = _gn_system(source, mask, q, t, normals, d, ok, max_dist)
    JtJ = H_f.T @ H_f

    n_total = torch.clamp(torch.sum(mask.to(dtype)), min=1.0)
    info = dict(fitness=n_valid / n_total,
                JtJ=JtJ,
                mean_residual=sum_abs_r / torch.clamp(n_valid, min=1.0),
                last_delta=last_delta,
                # coverage-independent quality: of the source points whose
                # neighborhood has a target plane, what fraction aligned?
                # (fitness mixes alignment with map coverage: a local
                # target map caps it at the overlap fraction)
                n_inliers=n_valid,
                inlier_ratio=n_valid / torch.clamp(n_planes, min=1.0),
                overlap=n_planes / n_total)
    return q, t, info


# --------------------------------------------------------------------------
# host convenience: pad a raw cloud, align one raw cloud onto another


def pad_pow2(pts: np.ndarray, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A raw (N, >=3) numpy cloud as (points (cap, 3), mask (cap,)) on
    ``device``, cap the next power of two, so that clouds of nearby sizes
    share their shapes."""
    cap = 1 << int(np.ceil(np.log2(max(len(pts), 2))))
    buf = np.zeros((cap, 3), np.float32)
    buf[:len(pts)] = pts[:, :3]
    msk = np.zeros(cap, bool)
    msk[:len(pts)] = True
    return to_device(buf, device), to_device(msk, device)


def align_clouds(source: np.ndarray, target: np.ndarray, T0: np.ndarray,
                 voxel_size: float = 0.5, iters: int = 15,
                 device: DeviceLike = None) -> np.ndarray:
    """Point-to-plane ICP between two raw (N, 3) numpy clouds with an
    initial-guess 4x4; returns the refined 4x4 mapping source -> target
    frame.  Runs on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    TP, TM = pad_pow2(np.asarray(target, np.float32), dev)
    SP, SM = pad_pow2(np.asarray(source, np.float32), dev)
    cap = max(2 ** 14, 2 * int(TM.shape[0]))
    T0 = np.asarray(T0, float).reshape(4, 4)
    q = to_device(np_so3.matrix_to_quat(T0[:3, :3]), dev, torch.float32)
    t = to_device(T0[:3, 3], dev, torch.float32)
    # coarse-to-fine: single scans are sparse (~1 pt per fine voxel), so
    # a fine-only surfel map yields noise planes and ICP wanders; a 2x
    # coarse pass locks the bulk alignment first (min_points=4 accepts
    # the thin single-scan neighborhoods at both scales)
    for vox, it in ((2.0 * voxel_size, max(4, iters // 2)),
                    (voxel_size, iters)):
        m = surfel_create(capacity=cap, voxel_size=vox, device=dev)
        m = surfel_insert(m, TP, TM)
        q, t, _ = icp_point_to_plane(m, SP, SM, q, t, iters=it, min_points=4)
    qt = torch.cat([q, t]).cpu().numpy()
    T = np.eye(4)
    T[:3, :3] = np_so3.quat_to_matrix(qt[:4])
    T[:3, 3] = qt[4:]
    return T
