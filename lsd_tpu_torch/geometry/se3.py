"""SE(3) rigid transforms in PyTorch (counterpart of ``lsd_tpu/geometry/se3.py``).

Poses are 4x4 homogeneous matrices, batchable as (..., 4, 4).
"""
from __future__ import annotations

import torch

from . import so3


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device (no host-to-device copy per call)
    bottom = R.new_zeros(*batch, 1, 4)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    return T1 @ T2


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) = [rho, phi] -> SE(3) matrix (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3.exp_so3(phi)
    V = so3.left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return make_pose(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> twist (..., 6) = [rho, phi]."""
    phi = so3.log_so3(T[..., :3, :3])
    Vinv = so3.inv_left_jacobian(phi)
    rho = (Vinv @ T[..., :3, 3, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose (..., 4, 4) to points (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def relative_pose(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """T_a^-1 @ T_b — pose of b expressed in frame a."""
    return inverse(T_a) @ T_b


def pose_interp(T0: torch.Tensor, T1: torch.Tensor, t) -> torch.Tensor:
    """Interpolate between two poses: slerp rotation, lerp translation."""
    q0 = so3.matrix_to_quat(T0[..., :3, :3])
    q1 = so3.matrix_to_quat(T1[..., :3, :3])
    q = so3.quat_slerp(q0, q1, t)
    p = (1.0 - t) * T0[..., :3, 3] + t * T1[..., :3, 3]
    return make_pose(so3.quat_to_matrix(q), p)
