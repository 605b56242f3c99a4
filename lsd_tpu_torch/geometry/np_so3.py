"""Host-side numpy rotation helpers (mirrors geometry.so3 semantics).

A copy of ``lsd_tpu/geometry/np_so3.py``.  For host plumbing (graph
building, sensor threads, file IO) that must not touch the device: a
per-item tensor op there costs a kernel launch, and reading its result a
host sync.  Quaternions are (w, x, y, z), matching geometry.so3.
"""
from __future__ import annotations

import numpy as np


def rpy_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (reference Utils.cpp convention)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.asarray([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd-style."""
    R = np.asarray(R, float)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                        (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.asarray([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                        (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.asarray([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                        0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.asarray([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                        (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, float) / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vector (3,) -> matrix (3, 3)."""
    w = np.asarray(w, float)
    th = np.linalg.norm(w)
    if th < 1e-10:
        W = hat(w)
        return np.eye(3) + W + 0.5 * (W @ W)
    k = w / th
    K = hat(k)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def hat(w: np.ndarray) -> np.ndarray:
    return np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                      float)


def matrix_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of rpy_to_matrix: returns (roll, pitch, yaw) radians."""
    sy = -R[2, 0]
    cy = np.sqrt(max(R[0, 0] ** 2 + R[1, 0] ** 2, 1e-12))
    return np.asarray([np.arctan2(R[2, 1], R[2, 2]), np.arctan2(sy, cy),
                       np.arctan2(R[1, 0], R[0, 0])])


def pose_interp(T0: np.ndarray, T1: np.ndarray, a: float) -> np.ndarray:
    """Slerp rotation + lerp translation between 4x4 poses."""
    q0 = matrix_to_quat(T0[:3, :3])
    q1 = matrix_to_quat(T1[:3, :3])
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 1 - 1e-6:
        q = q0 + a * (q1 - q0)
    else:
        th = np.arccos(np.clip(d, -1, 1))
        q = (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(q)
    T[:3, 3] = (1 - a) * T0[:3, 3] + a * T1[:3, 3]
    return T
