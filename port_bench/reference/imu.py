"""IMU forward propagation, covariance propagation and scan undistortion.

Counterpart of ``lsd_tpu/slam/imu.py``.  The reference's masked
``lax.scan`` over the fixed-capacity IMU batch is a Python loop here over
the (at most 16) samples, with the same masking: a masked-out sample leaves
state and covariance as they were.

Conventions:
- IMU samples: (M, 7) [t_sec, gx, gy, gz, ax, ay, az]; gyro rad/s, accel in
  g-units scaled by ``acc_scale`` to m/s^2.
- Timestamps are seconds relative to scan start.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import so3
from .device import DeviceLike, resolve_device
from .state import (ERR_DIM, GRAVITY, IDX_BA, IDX_BG, IDX_G, IDX_P, IDX_R,
                    IDX_V, NavState, init_state)


class ImuNoise(NamedTuple):
    gyr: float = 1e-3      # rad/s/sqrt(s)
    acc: float = 1e-2      # m/s^2/sqrt(s)
    bg_walk: float = 1e-5
    ba_walk: float = 1e-4


def _step_F(R: torch.Tensor, w: torch.Tensor, a: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Discrete error-state transition for one IMU interval."""
    F = torch.eye(ERR_DIM, dtype=R.dtype, device=R.device)
    I3 = torch.eye(3, dtype=R.dtype, device=R.device)
    F[IDX_P, IDX_V] = I3 * dt
    F[IDX_R, IDX_R] = so3.exp_so3(-w * dt)
    F[IDX_R, IDX_BG] = -I3 * dt
    F[IDX_V, IDX_R] = -R @ so3.hat(a) * dt
    F[IDX_V, IDX_BA] = -R * dt
    F[IDX_V, IDX_G] = I3 * dt
    return F


def _process_noise(noise: ImuNoise, like: torch.Tensor) -> torch.Tensor:
    Qd = torch.zeros(ERR_DIM, dtype=like.dtype, device=like.device)
    Qd[IDX_R] = noise.gyr ** 2
    Qd[IDX_V] = noise.acc ** 2
    Qd[IDX_BG] = noise.bg_walk ** 2
    Qd[IDX_BA] = noise.ba_walk ** 2
    return torch.diag(Qd)


def propagate(state: NavState, P: torch.Tensor, imu: torch.Tensor, imu_mask: torch.Tensor,
              noise: ImuNoise, acc_scale: float = GRAVITY
              ) -> Tuple[NavState, torch.Tensor, dict]:
    """Propagate state and covariance through the IMU batch.

    Returns (state_end, P_end, track) where ``track`` holds per-sample
    poses for undistortion: t (M,), quat (M, 4), pos (M, 3), vel (M, 3).
    """
    dtype = P.dtype
    imu = imu.to(dtype)
    t = imu[:, 0]
    dts = torch.diff(t, prepend=t[:1])  # first sample gets dt=0
    dts = torch.where(imu_mask, torch.clamp(dts, 0.0, 0.1), 0.0)
    Q = _process_noise(noise, P)

    st = state
    quats, poss, vels = [], [], []
    for k in range(imu.shape[0]):
        dt, meas, m = dts[k], imu[k], imu_mask[k]
        w = meas[1:4] - st.bg
        a = meas[4:7] * acc_scale - st.ba
        R = st.rot

        new_quat = so3.quat_normalize(so3.quat_mul(st.quat, so3.quat_from_rotvec(w * dt)))
        acc_w = (R @ a) + st.grav
        new_vel = st.vel + acc_w * dt
        new_pos = st.pos + st.vel * dt + 0.5 * acc_w * dt * dt

        F = _step_F(R, w, a, dt)
        newP = F @ P @ F.T + Q * dt

        st = st._replace(quat=torch.where(m, new_quat, st.quat),
                         vel=torch.where(m, new_vel, st.vel),
                         pos=torch.where(m, new_pos, st.pos))
        P = torch.where(m, newP, P)
        quats.append(st.quat)
        poss.append(st.pos)
        vels.append(st.vel)

    track = dict(t=t, quat=torch.stack(quats), pos=torch.stack(poss),
                 vel=torch.stack(vels), mask=imu_mask)
    return st, P, track


def undistort(points: torch.Tensor, stamps: torch.Tensor, mask: torch.Tensor,
              state_end: NavState, track: dict) -> torch.Tensor:
    """Motion-compensate scan points to the scan-end lidar frame.

    points are in the lidar frame at their own capture time; returns points
    in the lidar frame at scan end (backward propagation along the
    per-IMU-sample pose track).
    """
    t = track["t"]
    tmask = track["mask"]
    n_valid = torch.clamp(tmask.to(torch.int64).sum(), min=1)
    # invalid imu slots -> +inf so searchsorted ignores them
    t_search = torch.where(tmask, t, torch.inf).contiguous()
    idx = torch.clamp(torch.searchsorted(t_search, stamps.contiguous(), right=True) - 1,
                      0, t.shape[0] - 1)
    idx0 = torch.minimum(idx, n_valid - 1)
    idx1 = torch.minimum(idx + 1, n_valid - 1)

    t0, t1 = t[idx0], t[idx1]
    alpha = torch.where(t1 > t0, (stamps - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0)
    alpha = torch.clamp(alpha, 0.0, 1.0)

    q = so3.quat_slerp(track["quat"][idx0], track["quat"][idx1], alpha[:, None])
    p = (1 - alpha[:, None]) * track["pos"][idx0] + alpha[:, None] * track["pos"][idx1]

    Re = so3.quat_to_matrix(state_end.ext_q)
    te = state_end.ext_t
    # lidar -> world at capture time: x_w = R(t) (Re x + te) + p(t)
    xb = points @ Re.T + te
    xw = so3.quat_rotate(q, xb) + p
    # world -> lidar at scan end
    xb_end = (xw - state_end.pos) @ state_end.rot
    x_l_end = (xb_end - te) @ Re
    return torch.where(mask[:, None], x_l_end, 0.0)


def rot_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking unit vector a to unit vector b."""
    a = a / torch.clamp(torch.linalg.norm(a), min=1e-9)
    b = b / torch.clamp(torch.linalg.norm(b), min=1e-9)
    v = torch.linalg.cross(a, b)
    c = torch.dot(a, b)
    s2 = torch.dot(v, v)
    V = so3.hat(v)
    # Rodrigues with k = (1-c)/s^2; identity / flip for parallel vectors
    k = torch.where(s2 < 1e-12, 0.0, (1.0 - c) / torch.clamp(s2, min=1e-12))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    R = eye + V + k * (V @ V)
    return torch.where(c < -1.0 + 1e-8, -eye, R)


def static_init(imu_samples, device: DeviceLike = None) -> Tuple[NavState, float]:
    """Initialize attitude and gyro bias from a stationary IMU window.

    Gyro mean -> bg, accel mean direction -> initial roll/pitch (gravity
    alignment), |mean accel| -> acc scale.  Returns (state, acc_scale).
    """
    if isinstance(imu_samples, torch.Tensor):
        dev = imu_samples.device
    else:
        dev = resolve_device(device)
    imu_samples = torch.as_tensor(imu_samples, dtype=torch.float32, device=dev)
    mean_gyr = imu_samples[:, 1:4].mean(0)
    mean_acc = imu_samples[:, 4:7].mean(0)
    acc_norm = torch.linalg.norm(mean_acc)
    acc_scale = GRAVITY / torch.clamp(acc_norm, min=1e-6)
    up = torch.zeros(3, dtype=torch.float32, device=dev)
    up[2] = 1.0
    R0 = rot_between(mean_acc / torch.clamp(acc_norm, min=1e-9), up)
    st = init_state(device=dev)._replace(bg=mean_gyr, quat=so3.matrix_to_quat(R0))
    return st, float(acc_scale)
