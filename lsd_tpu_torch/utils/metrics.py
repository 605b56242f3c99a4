"""Trajectory accuracy metrics (numpy only).

A copy of ``umeyama_align`` and ``ate_rmse`` from ``lsd_tpu/utils/metrics.py``.
``ate_rmse`` is the standard ATE: RMSE of positions after a least-squares
rigid alignment (Umeyama, no scale).  ``umeyama_align`` is total: it drops
non-finite pairs, scale-normalizes the cross-covariance before the SVD and
falls back to an identity rotation with a centroid shift where LAPACK fails.
"""
from __future__ import annotations

import numpy as np


def umeyama_align(P: np.ndarray, Q: np.ndarray):
    """Least-squares rigid transform (R, t) minimizing |R P + t - Q|.

    Total function: non-finite correspondence pairs are dropped; if fewer
    than 3 finite pairs remain or the SVD cannot converge on the (scale-
    normalized) cross-covariance, returns the identity rotation with a
    centroid-matching translation instead of raising.
    """
    P = np.asarray(P, float)
    Q = np.asarray(Q, float)
    ok = np.isfinite(P).all(axis=1) & np.isfinite(Q).all(axis=1)
    P, Q = P[ok], Q[ok]
    if len(P) < 3:
        t = (Q.mean(0) - P.mean(0)) if len(P) else np.zeros(3)
        return np.eye(3), np.where(np.isfinite(t), t, 0.0)
    mp, mq = P.mean(0), Q.mean(0)
    H = (P - mp).T @ (Q - mq)
    # scale-normalize: the rotation only depends on H's direction, and
    # |H| ~ N * extent^2 overflows f64 for large diverged trajectories
    s = np.max(np.abs(H))
    if not np.isfinite(s) or s <= 0.0:
        return np.eye(3), mq - mp
    try:
        U, _S, Vt = np.linalg.svd(H / s)
    except np.linalg.LinAlgError:
        return np.eye(3), mq - mp
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = mq - R @ mp
    return R, t


def ate_rmse(est_T: np.ndarray, gt_T: np.ndarray, warmup: int = 0,
             align: str = "umeyama") -> float:
    """ATE RMSE of (N,4,4) pose arrays after alignment.

    align: "umeyama" (standard), "first" (single-pose at ``warmup``), or
    "none" (absolute error — meaningful for GNSS-anchored maps).
    Non-finite pose pairs are excluded from the score (they still count
    against the caller; inspect the trajectory for NaNs separately)."""
    n = min(len(est_T), len(gt_T))
    P = np.asarray(est_T)[warmup:n, :3, 3]
    Q = np.asarray(gt_T)[warmup:n, :3, 3]
    ok = np.isfinite(P).all(axis=1) & np.isfinite(Q).all(axis=1)
    if align == "umeyama":
        R, t = umeyama_align(P[ok], Q[ok])
        err = np.linalg.norm(P[ok] @ R.T + t - Q[ok], axis=1)
    elif align == "first":
        A = gt_T[warmup] @ np.linalg.inv(est_T[warmup])
        e = np.einsum("ij,njk->nik", A, np.asarray(est_T)[warmup:n])
        err = np.linalg.norm(e[:, :3, 3] - Q, axis=1)[ok]
    else:
        err = np.linalg.norm(P - Q, axis=1)[ok]
    if len(err) == 0:
        return float("nan")
    return float(np.sqrt(np.mean(err ** 2)))
