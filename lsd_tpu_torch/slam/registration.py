"""Scan registration: point-to-plane ICP and NDT as fixed-count
Gauss-Newton (counterpart of ``lsd_tpu/slam/registration.py``).

- ``icp_point_to_plane`` aligns a source scan to a target map, either a
  ``SurfelMap`` (merged neighbourhood moments) or a ``VoxelHashMap`` (kNN +
  5-point plane fits): the loop-closure verifier and the localizer's
  refinement stage.
- ``NdtMap`` + ``ndt_build`` + ``ndt_align``: per-voxel Gaussian statistics
  and P2D-NDT alignment, the localization matcher.

Both optimize a 6-dof right-perturbation twist with fixed iteration counts
(static shapes; convergence is monitored via the returned fitness), and
none of them makes a host sync.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import np_so3, so3
from ..ops.hashmap import _content_key, _probe_find, _slot_hash, hashmap_knn
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
# NDT

_INT32_MAX = 2 ** 31 - 1


class NdtMap(NamedTuple):
    keys: torch.Tensor        # (C,) int32, -1 empty
    mean: torch.Tensor        # (C, 3)
    cov_inv: torch.Tensor     # (C, 3, 3) regularized inverse covariance
    counts: torch.Tensor      # (C,) int32
    voxel_size: torch.Tensor  # () f32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def _ndt_slots(points: torch.Tensor, mask: torch.Tensor, voxel_size: torch.Tensor,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys (C,) int32, slot (N,) int64, -1 where a point found none):
    resolve every point's voxel to a slot with the same probing scheme as
    the hash map.  Integer scatter-min settles the races, so the result is
    the reference's exactly, on the CPU and on the card."""
    n = points.shape[0]
    dev = points.device
    coords = torch.floor(points / voxel_size).to(torch.int32)
    h0 = _slot_hash(coords, capacity)
    ck = _content_key(coords)
    idx = torch.arange(n, device=dev)
    # keys carries one spare row at index capacity: the writes of points
    # that did not win a slot land there
    keys = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    claim = torch.full((capacity,), _INT32_MAX, dtype=torch.int64, device=dev)
    for p in range(8):
        cand = ((h0 + p) & (capacity - 1)).long()
        need = mask & (slot < 0)
        want = need & (keys[cand] < 0)
        # a point that wants no slot scatters INT32_MAX into the last one
        claim.scatter_reduce_(0, torch.where(want, cand, capacity - 1),
                              torch.where(want, idx, _INT32_MAX), "amin")
        won = want & (claim[cand] == idx)
        keys[torch.where(won, cand, capacity)] = ck
        # match against the UPDATED keys so same-round losers land in the
        # slot their sibling point just claimed (all points of a voxel share
        # ck and the same probe sequence)
        slot = torch.where(need & (keys[cand] == ck), cand, slot)
    return keys[:capacity], slot


def _eigh_sym3(A: torch.Tensor, sweeps: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of symmetric 3x3 matrices (N, 3, 3) by cyclic
    Jacobi rotations: (eigenvalues (N, 3) in no particular order,
    eigenvectors (N, 3, 3) as columns), A = V diag(lam) V^T.

    Written out in tensor ops so that it makes no host sync and needs no
    solver library: ``torch.linalg.eigh`` checks its status on the host,
    and on the card its batched path (cuSOLVER's ``XsyevBatched``) refused
    the second call of a process at 65,536 matrices.  Convergence is
    quadratic: three sweeps take random 3x3 covariances to float32
    rounding, five are run."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = A[:, p, q]
            zero = apq == 0
            tau = (A[:, q, q] - A[:, p, p]) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(1.0 + t * t)
            sn = t * c
            J = torch.eye(3, dtype=A.dtype, device=A.device).repeat(A.shape[0], 1, 1)
            J[:, p, p], J[:, q, q], J[:, p, q], J[:, q, p] = c, c, sn, -sn
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def ndt_build(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
              capacity: int = 2 ** 15) -> NdtMap:
    """Build per-voxel Gaussian statistics from a (masked) map cloud, on
    the points' device.

    ``keys``, ``counts`` and every point's slot equal the reference's; the
    eigen-decomposition of the voxel covariances is ``_eigh_sym3``.  The
    sums are float scatter-adds: on CUDA their order, and so their last
    bits, vary from run to run.  The covariance ``s2/n - mean mean^T``
    cancels in float32 far from the origin, so ``cov_inv`` agrees with
    another build only loosely (to a few 1e-3 relative near the eigenvalue
    floor at 20 m range); ``mean`` agrees tightly."""
    dev, dtype = points.device, points.dtype
    vs = torch.full((), voxel_size, dtype=torch.float32, device=dev)
    keys, slot = _ndt_slots(points, mask, vs, capacity)

    ok = mask & (slot >= 0)
    seg = torch.where(ok, slot, capacity)
    ones = ok.to(dtype)
    pm = points * ones[:, None]
    cnt = points.new_zeros(capacity + 1).index_add_(0, seg, ones)[:capacity]
    s1 = points.new_zeros(capacity + 1, 3).index_add_(0, seg, pm)[:capacity]
    s2 = points.new_zeros(capacity + 1, 3, 3).index_add_(
        0, seg, points[:, :, None] * pm[:, None, :])[:capacity]
    n_div = torch.clamp(cnt, min=1.0)
    mean = s1 / n_div[:, None]
    cov = s2 / n_div[:, None, None] - mean[:, :, None] * mean[:, None, :]
    # Regularize like ndt_omp: floor covariance eigenvalues so thin (planar)
    # voxels keep a usable basin: without this a wall voxel has ~cm normal
    # stddev and any decimeter offset is >10 sigma, zeroing the score.
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    lam, V = _eigh_sym3(cov)
    floor = torch.clamp(1e-2 * lam.max(dim=-1, keepdim=True).values, min=(0.1 * vs) ** 2)
    lam_c = torch.maximum(lam, floor)
    cov_inv = (V / lam_c[:, None, :]) @ V.transpose(-1, -2)
    good = cnt >= 4
    keys = torch.where(good, keys, -1)  # only well-populated voxels participate
    return NdtMap(keys=keys, mean=mean, cov_inv=cov_inv, counts=cnt.to(torch.int32),
                  voxel_size=vs)


@slam_f32
def ndt_align(m: NdtMap, source: torch.Tensor, mask: torch.Tensor,
              q0: torch.Tensor, t0: torch.Tensor, iters: int = 30,
              outlier_ratio: float = 0.55,
              searches: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """P2D-NDT: iterated Gauss-Newton ascent on the Gaussian-mixture score
    (Magnusson's d1/d2 form, as in ndt_omp).

    The voxel assignment is piecewise-constant, so only the smooth
    first-order surrogate H = sum w_i g_i g_i^T is used (the exact Hessian
    steps erratically through assignment changes).  Converges steadily from
    up-to-half-voxel offsets; use the LIO/UKF prediction as q0/t0.

    Like icp_point_to_plane, the expensive association (hash probe +
    mean/cov gathers over every point) runs ``searches`` times (default:
    every iteration, exact classic NDT); between searches,
    ``iters // searches`` GN iterations re-linearize against the frozen
    voxel assignment.  Tracking callers (cm-scale prior motion per
    iteration, voxels 1 m) pass searches=3-5: the assignment is stable at
    that scale.

    The per-point Jacobian of the world point with respect to the
    right-perturbation twist is the closed form [-R [p]x, I], which the
    reference gets by forward-mode differentiation at xi = 0.  Makes no host
    sync.  Returns (q, t, info) with info = dict(score, matched_frac,
    last_delta), tensors on the source's device.
    """
    searches = iters if searches is None else max(1, min(searches, iters))
    inner = max(1, iters // searches)
    dtype, dev = source.dtype, source.device
    # Magnusson mixture constants (ndt_omp computeDerivatives), computed on
    # the device from the map's voxel size
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (m.voxel_size ** 3)
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    d2 = -2.0 * torch.log((-torch.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    cap = m.capacity
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def associate(q, t):
        """Probe + gather per-point voxel Gaussians (the expensive half);
        also returns the world points it probed with."""
        pw = _apply(q, t, source)
        coords = torch.floor(pw / m.voxel_size).to(torch.int32)
        # low load factor: 3 probes cover essentially every voxel
        slot = _probe_find(m.keys, coords, cap, num_probes=3)
        ok = mask & (slot >= 0)
        sl = slot.clamp(min=0).long()
        return pw, m.mean[sl], m.cov_inv[sl], ok

    def mahalanobis(pw, mean_g, ci):
        """(ci (pw - mean), squared Mahalanobis distance) per point."""
        dxv = pw - mean_g
        v = torch.einsum("ni,nij->nj", dxv, ci)
        return v, torch.sum(v * dxv, dim=-1)

    q, t = q0, t0
    for _ in range(searches):
        _, mean_g, ci, ok = associate(q, t)
        for _ in range(inner):
            v, md = mahalanobis(_apply(q, t, source), mean_g, ci)
            e = torch.exp(-0.5 * d2 * md)
            # per-point score gradients (N, 6): v^T [-R [p]x, I]
            gi = torch.cat([torch.linalg.cross(source, v @ so3.quat_to_matrix(q)), v], dim=-1)
            w = torch.where(ok, torch.abs(d1) * d2 * e, 0.0)
            H = gi.T @ (gi * w[:, None]) + 1e-3 * eye6
            # ds_i/dxi = d1 * d2 * e_i * gi_i, from the same gathered values
            g = torch.sum(torch.where(ok, d1 * d2 * e, 0.0)[:, None] * gi, dim=0)
            # the score is a sum of positive Gaussian bumps (-d1 > 0): ASCEND it
            dx = torch.clamp(torch.linalg.solve_ex(H, g).result, -0.5, 0.5)
            q = so3.quat_normalize(so3.quat_mul(q, so3.quat_from_rotvec(dx[:3])))
            t = t + dx[3:]
            last_delta = torch.linalg.norm(dx)
    # final score at the converged pose (fresh association)
    pw_f, mean_g, ci, ok = associate(q, t)
    _, md_f = mahalanobis(pw_f, mean_g, ci)
    score = torch.sum(torch.where(ok, -d1 * torch.exp(-0.5 * d2 * md_f), 0.0))
    n_ok = torch.clamp(torch.sum(ok.to(torch.float32)), min=1.0)
    info = dict(score=-score / n_ok,
                matched_frac=n_ok / torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0),
                last_delta=last_delta)
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
