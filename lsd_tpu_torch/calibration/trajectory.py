"""Trajectory-based extrinsic calibration (lidar-INS / lidar-IMU); a copy
of ``lsd_tpu/calibration/trajectory.py`` (numpy only).

Re-derivation of the reference's trajectory-alignment calibrations
(sensor_driver/calibration/lidar_ins/aligner.cpp — NLOPT pose alignment;
sensor_driver/calibration/lidar_imu/calib_lidar_imu.cpp — GICP odometry vs
IMU orientation hand-eye):

- ``align_trajectories``: Umeyama similarity/rigid alignment of two
  position tracks (evaluation + GNSS anchor alignment),
- ``hand_eye_calibration``: solve R_x from relative-rotation pairs
  A_i X = X B_i (quaternion least squares) and t_x linear LS —
  the lidar->body extrinsic from synchronized odometries.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..geometry import np_so3


def align_trajectories(src: np.ndarray, dst: np.ndarray,
                       with_scale: bool = False) -> Tuple[np.ndarray, float]:
    """Umeyama: find T (4x4) [and scale] minimizing |dst - s R src - t|."""
    src = np.asarray(src, float).reshape(-1, 3)
    dst = np.asarray(dst, float).reshape(-1, 3)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    X, Y = src - mu_s, dst - mu_d
    cov = Y.T @ X / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    scale = float((D * np.diag(S)).sum() / (X ** 2).sum() * len(src)) if with_scale else 1.0
    t = mu_d - scale * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return T, scale


def _quat_mult_matrix_left(q):
    w, x, y, z = q
    return np.asarray([[w, -x, -y, -z],
                       [x, w, -z, y],
                       [y, z, w, -x],
                       [z, -y, x, w]])


def _quat_mult_matrix_right(q):
    w, x, y, z = q
    return np.asarray([[w, -x, -y, -z],
                       [x, w, z, -y],
                       [y, -z, w, x],
                       [z, y, -x, w]])


def hand_eye_calibration(poses_a: Sequence[np.ndarray],
                         poses_b: Sequence[np.ndarray]) -> np.ndarray:
    """Solve X from A_i X = X B_i over synchronized pose tracks.

    poses_a: sensor-A odometry (e.g. body/IMU poses), poses_b: sensor-B
    odometry (e.g. lidar poses); X maps B's frame into A's
    (T_a_b).  Rotation via the classic quaternion nullspace method,
    translation via stacked linear LS.
    """
    if len(poses_a) < 2 or len(poses_a) != len(poses_b):
        raise ValueError("hand_eye_calibration needs >= 2 synchronized poses "
                         f"(got {len(poses_a)} / {len(poses_b)})")
    A_rel, B_rel = [], []
    for k in range(len(poses_a) - 1):
        A_rel.append(np.linalg.inv(poses_a[k]) @ poses_a[k + 1])
        B_rel.append(np.linalg.inv(poses_b[k]) @ poses_b[k + 1])

    # rotation: sum_i |L(qa_i) - R(qb_i)| q = 0
    M = np.zeros((4, 4))
    for Ta, Tb in zip(A_rel, B_rel):
        qa = np_so3.matrix_to_quat(Ta[:3, :3])
        qb = np_so3.matrix_to_quat(Tb[:3, :3])
        C = _quat_mult_matrix_left(qa) - _quat_mult_matrix_right(qb)
        M += C.T @ C
    w, V = np.linalg.eigh(M)
    qx = V[:, 0]
    if qx[0] < 0:
        qx = -qx
    Rx = np_so3.quat_to_matrix(qx)

    # translation: (R_a - I) t_x = R_x t_b - t_a
    rows, rhs = [], []
    for Ta, Tb in zip(A_rel, B_rel):
        rows.append(Ta[:3, :3] - np.eye(3))
        rhs.append(Rx @ Tb[:3, 3] - Ta[:3, 3])
    Acat = np.concatenate(rows, axis=0)
    bcat = np.concatenate(rhs, axis=0)
    tx, *_ = np.linalg.lstsq(Acat, bcat, rcond=None)
    X = np.eye(4)
    X[:3, :3] = Rx
    X[:3, 3] = tx
    return X
