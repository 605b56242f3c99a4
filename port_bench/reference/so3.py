"""SO(3) manifold operations in PyTorch.

Counterpart of ``lsd_tpu/geometry/so3.py``.  Rotations are 3x3 matrices or
unit quaternions in (w, x, y, z) order; every function is batched over
leading dimensions and keeps the reference's small-angle guards, so the
two packages agree to float32 rounding on the same inputs.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = True) -> torch.Tensor:
    """Norm with a well-defined (zero) gradient at v = 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + 1e-18)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, safe at 0."""
    small = torch.abs(x) < 1e-5
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def _cosc(x: torch.Tensor) -> torch.Tensor:
    """(1-cos(x))/x^2, safe at 0."""
    x2 = x * x
    small = torch.abs(x) < 1e-4
    return torch.where(small, 0.5 - x2 / 24.0,
                       (1.0 - torch.cos(x)) / torch.where(small, torch.ones_like(x2), x2))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: rotation vector (..., 3) -> rotation matrix (..., 3, 3)."""
    t = _safe_norm(w)[..., None]          # (..., 1, 1)
    W = hat(w)
    return _eye3(w) + _sinc(t) * W + _cosc(t) * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3)."""
    return rotvec_from_quat(matrix_to_quat(R))


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): J_l(w) such that exp(w + dw) ~ exp(J_l dw) exp(w)."""
    theta = _safe_norm(w)[..., None]
    W = hat(w)
    t2 = theta * theta
    a = _cosc(theta)  # (1-cos)/t^2
    # (t - sin t)/t^3, safe at 0
    small = torch.abs(theta) < 1e-4
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, torch.ones_like(t2), t2 * theta))
    return _eye3(w) + a * W + b * (W @ W)


def inv_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta = _safe_norm(w)[..., None]
    W = hat(w)
    t2 = theta * theta
    one = torch.ones_like(theta)
    # 1/t^2 - (1+cos t)/(2 t sin t), with series 1/12 + t^2/720 near 0
    small = torch.abs(theta) < 1e-4
    cot_term = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 / torch.where(small, one, t2))
        - (1.0 + torch.cos(theta))
        / torch.where(small, one, 2.0 * theta * torch.sin(theta)),
    )
    return _eye3(w) - 0.5 * W + cot_term * (W @ W)


# ----------------------------- quaternions (w, x, y, z) ---------------------


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = _safe_norm(q)
    q = q / torch.clamp(n, min=_EPS)
    # canonicalize sign (w >= 0) so log is the short way around
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_from_rotvec(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    half = theta / 2.0
    k = 0.5 * _sinc(half)  # sin(t/2)/t
    return torch.cat([torch.cos(half), k * w], dim=-1)


def rotvec_from_quat(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, v = q[..., :1], q[..., 1:]
    sin_half = _safe_norm(v)
    half = torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-7, 2.0 / torch.clamp(w, min=0.5),
                        2.0 * half / torch.clamp(sin_half, min=_EPS))
    return scale * v


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free via selecting the max-trace variant."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions (unnormalized), one per "pivot".
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)          # first max, as jnp.argmax
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 pivots, 4)
    gidx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cand, -2, gidx)[..., 0, :]
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternion q (..., 4)."""
    qv = q[..., 1:]
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    lin = (1.0 - t) * q0 + t * q1  # fallback for tiny angles
    w0 = torch.sin((1.0 - t) * theta) / torch.clamp(sin_theta, min=_EPS)
    w1 = torch.sin(t * theta) / torch.clamp(sin_theta, min=_EPS)
    out = torch.where(sin_theta < 1e-6, lin, w0 * q0 + w1 * q1)
    return quat_normalize(out)


# ----------------------------- Euler (roll, pitch, yaw) ---------------------
# R = Rz(yaw) @ Ry(pitch) @ Rx(roll), angles in radians (the reference's INS
# frame convention).


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def matrix_to_rpy(R: torch.Tensor) -> torch.Tensor:
    sy = -R[..., 2, 0]
    cy = torch.sqrt(torch.clamp(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2, min=1e-12))
    pitch = torch.atan2(sy, cy)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)
