"""IMU forward propagation, covariance propagation and scan undistortion.

Counterpart of ``lsd_tpu/slam/imu.py``.  The reference's masked
``lax.scan`` over the fixed-capacity IMU batch is one launch of the
hand-written CUDA kernel ``csrc/imu_propagate.cu`` for CUDA tensors and a
Python loop over the (at most 64) samples for CPU tensors
(``propagate_plain``, the version the kernel is held to), with the same
masking: a masked-out sample leaves state and covariance as they were.

Conventions:
- IMU samples: (M, 7) [t_sec, gx, gy, gz, ax, ay, az]; gyro rad/s, accel in
  g-units scaled by ``acc_scale`` to m/s^2.
- Timestamps are seconds relative to scan start.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..geometry import so3
from ..utils import cuda_build
from ..utils.device import DeviceLike, resolve_device
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


def propagate_plain(state: NavState, P: torch.Tensor, imu: torch.Tensor,
                    imu_mask: torch.Tensor, noise: ImuNoise, acc_scale: float = GRAVITY
                    ) -> Tuple[NavState, torch.Tensor, dict]:
    """Plain PyTorch version of ``propagate`` (the CPU path and the version
    the kernel is held to): one step of small ops per IMU slot."""
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


MAX_SLOTS = 64                    # the kernel's largest IMU batch (io/frame.py:IMU_CAPACITY)
_STATE = (("pos", 3), ("quat", 4), ("vel", 3), ("bg", 3), ("ba", 3), ("grav", 3))


def _check_f32(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"propagate: {name} is on {t.device}, expected {device}")
    if t.dtype is not torch.float32:
        raise TypeError(f"propagate: {name} must be float32, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"propagate: {name} has shape {tuple(t.shape)}, expected {shape}")


def _check_args(state: NavState, P: torch.Tensor, imu: torch.Tensor,
                imu_mask: torch.Tensor) -> None:
    """Raise, naming the argument, for what the kernel does not take."""
    dev = P.device
    _check_f32("P", P, (ERR_DIM, ERR_DIM), dev)
    for name, n in _STATE:
        _check_f32(f"state.{name}", getattr(state, name), (n,), dev)
    for name, t in (("imu", imu), ("imu_mask", imu_mask)):
        if t.device != dev:
            raise ValueError(f"propagate: {name} is on {t.device}, expected {dev}")
    if imu.dim() != 2 or imu.shape[1] != 7 or not imu.dtype.is_floating_point:
        raise ValueError(f"propagate: imu has shape {tuple(imu.shape)} and dtype {imu.dtype}, "
                         "expected (M, 7) floating-point rows [t, gyro, accel]")
    m = imu.shape[0]
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"propagate: imu has {m} slots, expected 1 to {MAX_SLOTS}")
    if imu_mask.dtype is not torch.bool or imu_mask.shape != (m,):
        raise ValueError(f"propagate: imu_mask has shape {tuple(imu_mask.shape)} and dtype "
                         f"{imu_mask.dtype}, expected ({m},) torch.bool, one flag per imu slot")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("imu_propagate")
    lib.imu_propagate_launch.restype = ctypes.c_int
    lib.imu_propagate_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
        + [ctypes.c_float] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def propagate(state: NavState, P: torch.Tensor, imu: torch.Tensor, imu_mask: torch.Tensor,
              noise: ImuNoise, acc_scale: float = GRAVITY
              ) -> Tuple[NavState, torch.Tensor, dict]:
    """Propagate state and covariance through the IMU batch.

    state's vectors and P (24, 24) are float32 on one device; imu (M, 7)
    rows [t, gyro, accel] (cast to float32 as the plain version casts them)
    and imu_mask (M,) bool, 1 <= M <= 64.  Returns (state_end, P_end,
    track) where ``track`` holds per-sample poses for undistortion: t (M,),
    quat (M, 4), pos (M, 3), vel (M, 3).  On CUDA, P_end, state_end's
    quat, pos and vel and the track's are views of one buffer that the
    kernel's one launch fills.
    """
    _check_args(state, P, imu, imu_mask)
    dev = P.device
    if dev.type == "cpu":
        return propagate_plain(state, P, imu, imu_mask, noise, acc_scale)
    if dev.type != "cuda":
        raise ValueError(f"propagate: unsupported device {dev}")
    imu = imu.to(torch.float32)
    m = imu.shape[0]
    out = torch.empty(ERR_DIM * ERR_DIM + 10 + 10 * m, dtype=torch.float32, device=dev)
    # P is read through its strides: the LIO step's comes out of an inverse
    # column-major, and a copy would be a launch of its own
    vecs = [t.contiguous() for t in (state.quat, state.pos, state.vel, state.bg, state.ba,
                                      state.grav)]
    rows = [t.contiguous() for t in (imu, imu_mask)]
    err = _library().imu_propagate_launch(
        *[t.data_ptr() for t in vecs], P.data_ptr(), *P.stride(),
        *[t.data_ptr() for t in rows], m, noise.gyr ** 2, noise.acc ** 2,
        noise.bg_walk ** 2, noise.ba_walk ** 2, float(acc_scale), out.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"propagate: kernel launch failed with CUDA error {err}")
    P_end, quat, pos, vel, tq, tp, tv = out.split_with_sizes(
        (ERR_DIM * ERR_DIM, 4, 3, 3, 4 * m, 3 * m, 3 * m))
    track = dict(t=imu[:, 0], quat=tq.view(m, 4), pos=tp.view(m, 3), vel=tv.view(m, 3),
                 mask=imu_mask)
    return (state._replace(quat=quat, pos=pos, vel=vel), P_end.view(ERR_DIM, ERR_DIM), track)


propagate.launches = cuda_build.LaunchCount("imu_propagate")   # counted on the device


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
