"""ESIKF navigation state on the manifold (counterpart of ``lsd_tpu/slam/state.py``).

The nominal state carries quaternions; the error state is a 24-vector:

    [0:3]   dp      position
    [3:6]   dtheta  rotation (so3, right-multiplied: R <- R Exp(dtheta))
    [6:9]   dv      velocity
    [9:12]  dbg     gyro bias
    [12:15] dba     accel bias
    [15:18] dg      gravity
    [18:21] dthe    lidar->IMU extrinsic rotation
    [21:24] dte     lidar->IMU extrinsic translation
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, so3
from ..utils.device import DeviceLike, resolve_device

ERR_DIM = 24
IDX_P = slice(0, 3)
IDX_R = slice(3, 6)
IDX_V = slice(6, 9)
IDX_BG = slice(9, 12)
IDX_BA = slice(12, 15)
IDX_G = slice(15, 18)
IDX_ER = slice(18, 21)
IDX_ET = slice(21, 24)

GRAVITY = 9.81


class NavState(NamedTuple):
    pos: torch.Tensor    # (3,)
    quat: torch.Tensor   # (4,) wxyz, world <- body
    vel: torch.Tensor    # (3,)
    bg: torch.Tensor     # (3,)
    ba: torch.Tensor     # (3,)
    grav: torch.Tensor   # (3,) world gravity vector (~ [0, 0, -9.81])
    ext_q: torch.Tensor  # (4,) lidar -> IMU rotation
    ext_t: torch.Tensor  # (3,) lidar -> IMU translation

    @property
    def rot(self) -> torch.Tensor:
        return so3.quat_to_matrix(self.quat)

    @property
    def ext_rot(self) -> torch.Tensor:
        return so3.quat_to_matrix(self.ext_q)

    def pose_matrix(self) -> torch.Tensor:
        return se3.make_pose(self.rot, self.pos)


def init_state(dtype=torch.float32, device: DeviceLike = None) -> NavState:
    dev = resolve_device(device)

    def vec(*v):
        return torch.tensor(v, dtype=dtype, device=dev)
    return NavState(
        pos=vec(0.0, 0.0, 0.0),
        quat=vec(1.0, 0.0, 0.0, 0.0),
        vel=vec(0.0, 0.0, 0.0),
        bg=vec(0.0, 0.0, 0.0),
        ba=vec(0.0, 0.0, 0.0),
        grav=vec(0.0, 0.0, -GRAVITY),
        ext_q=vec(1.0, 0.0, 0.0, 0.0),
        ext_t=vec(0.0, 0.0, 0.0),
    )


def boxplus(x: NavState, dx: torch.Tensor) -> NavState:
    """x ⊞ dx with right-perturbation on rotations."""
    return NavState(
        pos=x.pos + dx[IDX_P],
        quat=so3.quat_normalize(so3.quat_mul(x.quat, so3.quat_from_rotvec(dx[IDX_R]))),
        vel=x.vel + dx[IDX_V],
        bg=x.bg + dx[IDX_BG],
        ba=x.ba + dx[IDX_BA],
        grav=x.grav + dx[IDX_G],
        ext_q=so3.quat_normalize(so3.quat_mul(x.ext_q, so3.quat_from_rotvec(dx[IDX_ER]))),
        ext_t=x.ext_t + dx[IDX_ET],
    )


def boxminus(x: NavState, y: NavState) -> torch.Tensor:
    """x ⊟ y: the error that takes y to x."""
    dq = so3.quat_mul(so3.quat_conj(y.quat), x.quat)
    dqe = so3.quat_mul(so3.quat_conj(y.ext_q), x.ext_q)
    return torch.cat([
        x.pos - y.pos,
        so3.rotvec_from_quat(dq),
        x.vel - y.vel,
        x.bg - y.bg,
        x.ba - y.ba,
        x.grav - y.grav,
        so3.rotvec_from_quat(dqe),
        x.ext_t - y.ext_t,
    ])
