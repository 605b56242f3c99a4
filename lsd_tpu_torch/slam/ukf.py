"""Unscented Kalman filter pose tracker for map-based localization
(counterpart of ``lsd_tpu/slam/ukf.py``).

A 23-dim UKF whose state stacks position, velocity, quaternion (as 4 plain
components, re-normalized after every mean), IMU biases, angular velocity,
and the IMU-mount quaternion; prediction is either a constant-velocity
model, which coasts rotation through the angular velocity state between
NDT fixes, or IMU-driven, or driven by an odometry increment; correction
observes the NDT pose [p, q] or a GNSS position.  State (23,):

    [0:3] p, [3:6] v, [6:10] q (wxyz), [10:13] bg, [13:16] ba,
    [16:19] w (angular velocity, body), [19:23] q_imu (IMU mount)

The filter is tiny (47 sigma points x 23 dims): the reference maps its
process model over the sigma points, here the model is written once for the
whole (47, 23) batch.  No function makes a host sync: the Cholesky factor
and the gain come from ``cholesky_ex`` and ``solve_ex``, which leave their
status on the device.  Where the reference's Cholesky would return NaN (a
covariance that is not positive definite), the factor's lower triangle is
set to NaN here too, so a broken filter shows as a non-finite state in both
packages and never as an exception.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import se3, so3
from ..utils.device import DeviceLike, resolve_device
from ..utils.precision import slam_f32

DIM = 23
OBS_DIM = 7
GRAVITY = 9.81


class UkfState(NamedTuple):
    x: torch.Tensor   # (23,)
    P: torch.Tensor   # (23, 23)


class UkfConfig(NamedTuple):
    # alpha=1 (lambda=0) keeps all sigma weights positive: the textbook
    # alpha=1e-3 gives weight_0 ~ -1e6, which destroys PSD-ness in f32
    alpha: float = 1.0
    beta: float = 2.0
    kappa: float = 0.0
    q_pos: float = 1e-4
    q_vel: float = 0.5
    q_quat: float = 1e-4
    q_bias: float = 1e-6
    q_angvel: float = 0.5
    q_mount: float = 1e-8     # IMU mount quat is essentially constant
    r_pos: float = 0.01       # NDT position noise (m^2-ish)
    r_quat: float = 0.001


def ukf_init(pose: Optional[torch.Tensor] = None, device: DeviceLike = None) -> UkfState:
    """Initial state at ``pose`` (4, 4), on its device; without a pose, at
    the identity on ``device`` (CUDA unless named)."""
    dev = pose.device if pose is not None else resolve_device(device)
    x = torch.zeros(DIM, dtype=torch.float32, device=dev)
    x[6] = 1.0
    x[19] = 1.0
    if pose is not None:
        x[0:3] = pose[:3, 3]
        x[6:10] = so3.matrix_to_quat(pose[:3, :3])
    P = torch.eye(DIM, dtype=torch.float32, device=dev) * 0.01
    P[19:23, 19:23] = torch.eye(4, device=dev) * 1e-6   # mount known a priori
    return UkfState(x=x, P=P)


class _Constants(NamedTuple):
    lam: float
    wm: torch.Tensor        # (47,) mean weights
    wc: torch.Tensor        # (47,) covariance weights
    Qd: torch.Tensor        # (23, 23) process noise, const-velocity and IMU models
    Qd_odom: torch.Tensor   # (23, 23) process noise, odometry model
    R: torch.Tensor         # (7, 7) noise of the pose observation
    eye: torch.Tensor       # (23, 23)
    gravity: torch.Tensor   # (3,)


@functools.lru_cache(maxsize=None)
def _constants(cfg: UkfConfig, device: torch.device) -> _Constants:
    """The filter's constant tensors on ``device``, made once per config
    and read-only."""
    lam = cfg.alpha ** 2 * (DIM + cfg.kappa) - DIM
    wm = np.full(2 * DIM + 1, 1.0 / (2 * (DIM + lam)), np.float32)
    wm[0] = lam / (DIM + lam)
    wc = wm.copy()
    wc[0] += 1.0 - cfg.alpha ** 2 + cfg.beta

    def qd(pos, quat):
        return np.concatenate([np.full(3, pos), np.full(3, cfg.q_vel), np.full(4, quat),
                               np.full(6, cfg.q_bias), np.full(3, cfg.q_angvel),
                               np.full(4, cfg.q_mount)]).astype(np.float32)
    R = np.diag(np.concatenate([np.full(3, cfg.r_pos), np.full(4, cfg.r_quat)])).astype(np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    # odometry increments are cm-accurate: much tighter process noise than
    # the const-velocity model on position/attitude
    return _Constants(lam, t(wm), t(wc), torch.diag(t(qd(cfg.q_pos, cfg.q_quat))),
                      torch.diag(t(qd(1e-4, 1e-5))), t(R),
                      torch.eye(DIM, dtype=torch.float32, device=device),
                      t([0.0, 0.0, -GRAVITY]))


def _sigma_points(x, P, cfg: UkfConfig):
    c = _constants(cfg, x.device)
    A = (DIM + c.lam) * (P + 1e-9 * c.eye)
    S, status = torch.linalg.cholesky_ex(0.5 * (A + A.T))
    S = torch.tril(torch.where(status == 0, S, torch.nan))   # see the module docstring
    pts = torch.cat([x[None, :], x[None, :] + S.T, x[None, :] - S.T], dim=0)
    return pts, c


def _normalize_quat(x):
    q = so3.quat_normalize(x[..., 6:10])
    qm = so3.quat_normalize(x[..., 19:23])
    return torch.cat([x[..., 0:6], q, x[..., 10:19], qm], dim=-1)


def _hemi_align(Q):
    """Flip each row of (S, 4) onto the hemisphere of row 0.

    quat_normalize canonicalizes the sign to w >= 0, so propagated sigma
    points whose w component straddles zero (yaw near 180 deg) come back
    on opposite sides of the quaternion double cover; the linear
    mean/covariance then measures the ~2|q| artificial spread and the
    attitude covariance explodes within a few frames.  Aligning hemispheres
    before the moment computation removes the artifact; the covariance
    is invariant under a global sign flip, so the returned state can
    still be canonicalized."""
    s = torch.where(Q @ Q[0] < 0, -1.0, 1.0)
    return Q * s[:, None]


def _sigma_moments(pred, wm, wc):
    """Mean + covariance of propagated sigma points with double-cover-
    safe quaternion handling: hemisphere-align, magnitude-normalize the
    mean (no sign canonicalization: that would flip the mean off the
    aligned rows), moments, then canonicalize the returned mean."""
    pred = torch.cat([pred[:, 0:6], _hemi_align(pred[:, 6:10]), pred[:, 10:19],
                      _hemi_align(pred[:, 19:23])], dim=1)
    mean = wm @ pred
    nq = torch.linalg.norm(mean[6:10])
    nm = torch.linalg.norm(mean[19:23])
    mean = torch.cat([mean[0:6], mean[6:10] * (1.0 / torch.clamp(nq, min=1e-9)), mean[10:19],
                      mean[19:23] * (1.0 / torch.clamp(nm, min=1e-9))])
    d = pred - mean[None, :]
    P = (d * wc[:, None]).T @ d
    return _normalize_quat(mean), P


def _finish_predict(pts, p_new, v_new, q_new, w_new, c: _Constants, Qd, dt) -> UkfState:
    pred = torch.cat([p_new, v_new, q_new, pts[:, 10:16], w_new, pts[:, 19:23]], dim=1)
    mean, P = _sigma_moments(pred, c.wm, c.wc)
    P = P + Qd * torch.clamp(dt, min=1e-3) + 1e-6 * c.eye
    return UkfState(x=mean, P=0.5 * (P + P.T))


@slam_f32
def ukf_predict(st: UkfState, dt: torch.Tensor, cfg: UkfConfig = UkfConfig(),
                imu_gyro: Optional[torch.Tensor] = None,
                imu_acc: Optional[torch.Tensor] = None) -> UkfState:
    """Propagate sigma points with const-velocity (+optional IMU) model."""
    pts, c = _sigma_points(st.x, st.P, cfg)
    v, q = pts[:, 3:6], so3.quat_normalize(pts[:, 6:10])
    if imu_gyro is not None:
        # rotate raw IMU rates/accels through the mount quaternion
        q_imu = so3.quat_normalize(pts[:, 19:23])
        w = so3.quat_rotate(q_imu, imu_gyro - pts[:, 10:13])
        a = so3.quat_rotate(q_imu, imu_acc - pts[:, 13:16])
        v_new = v + (so3.quat_rotate(q, a) + c.gravity) * dt
    else:
        # constant-velocity coasting including rotation: the angular
        # velocity state keeps the attitude turning between NDT fixes
        w = pts[:, 16:19]
        v_new = v
    q_new = so3.quat_normalize(so3.quat_mul(q, so3.quat_from_rotvec(w * dt)))
    return _finish_predict(pts, pts[:, 0:3] + v * dt, v_new, q_new, w, c, c.Qd, dt)


@slam_f32
def ukf_predict_odom(st: UkfState, dquat: torch.Tensor, dtrans: torch.Tensor,
                     dt: torch.Tensor, cfg: UkfConfig = UkfConfig()) -> UkfState:
    """Odometry-driven prediction: right-compose a measured body-frame
    SE3 increment (dquat, dtrans) into every sigma point.

    Full LiDAR-inertial odometry keeps running during localization and the
    filter coasts on it between and through map-match observations, instead
    of the blind constant-velocity model, which loses the vehicle wherever
    the map match goes ambiguous (a crossing, a GNSS dropout)."""
    pts, c = _sigma_points(st.x, st.P, cfg)
    n = pts.shape[0]
    q = so3.quat_normalize(pts[:, 6:10])
    step_w = so3.quat_rotate(q, dtrans[None, :])
    q_new = so3.quat_normalize(so3.quat_mul(q, dquat))
    inv_dt = 1.0 / torch.clamp(dt, min=1e-3)
    w_new = (so3.rotvec_from_quat(dquat) * inv_dt).expand(n, 3)
    return _finish_predict(pts, pts[:, 0:3] + step_w, step_w * inv_dt, q_new, w_new,
                           c, c.Qd_odom, dt)


def _correct(st: UkfState, pts, c: _Constants, Z, z, R) -> UkfState:
    """Kalman update of ``st`` from the sigma points' observations Z
    (S, m), the measurement z (m,) and its noise R (m, m)."""
    wm, wc = c.wm, c.wc
    z_mean = wm @ Z
    dz = Z - z_mean[None, :]
    dx = pts - st.x[None, :]
    S = (dz * wc[:, None]).T @ dz + R
    C = (dx * wc[:, None]).T @ dz
    K = torch.linalg.solve_ex(S.T, C.T).result.T
    x_new = _normalize_quat(st.x + K @ (z - z_mean))
    P_new = st.P - K @ S @ K.T + 1e-6 * c.eye
    return UkfState(x=x_new, P=0.5 * (P_new + P_new.T))


@slam_f32
def ukf_correct(st: UkfState, obs_pos: torch.Tensor, obs_quat: torch.Tensor,
                cfg: UkfConfig = UkfConfig()) -> UkfState:
    """Observe [p, q] from the NDT matcher."""
    pts, c = _sigma_points(st.x, st.P, cfg)
    # align observation quaternion sign with the state mean
    obs_quat = torch.where(torch.dot(obs_quat, st.x[6:10]) < 0, -obs_quat, obs_quat)
    # hemisphere-align the observation quats (same double-cover hazard
    # as _sigma_moments: quat_normalize sign-canonicalizes, and sigma
    # points straddling w=0 land on opposite covers)
    Zq = _hemi_align(so3.quat_normalize(pts[:, 6:10]))
    obs_quat = torch.where(torch.dot(obs_quat, Zq[0]) < 0, -obs_quat, obs_quat)
    Z = torch.cat([pts[:, 0:3], Zq], dim=1)
    return _correct(st, pts, c, Z, torch.cat([obs_pos, obs_quat]), c.R)


def ukf_pose(st: UkfState) -> torch.Tensor:
    return se3.make_pose(so3.quat_to_matrix(st.x[6:10]), st.x[0:3])


@slam_f32
def ukf_correct_position(st: UkfState, obs_pos: torch.Tensor,
                         r_pos: torch.Tensor) -> UkfState:
    """Position observation (GNSS fix projected into the map frame).

    r_pos is the XY measurement variance (m^2): large for single-point
    fixes, small for RTK; the Z axis is always near-unconstrained
    (variance 1e4): GNSS altitude lives on a different datum than the
    map's z, and a tight 3D correction drags the filter's height off the
    map, collapsing the scan match (mapping likewise constrains XY only).

    As in the reference, the sigma points are drawn with the default
    ``UkfConfig()``, whatever config the caller's other steps use."""
    pts, c = _sigma_points(st.x, st.P, UkfConfig())
    R = torch.diag(torch.stack([r_pos, r_pos, torch.full_like(r_pos, 1e4)]))
    return _correct(st, pts, c, pts[:, 0:3], obs_pos, R)
