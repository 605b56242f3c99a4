"""Camera calibration: intrinsics, PnP, panorama homography (counterpart of
``lsd_tpu/calibration/camera.py``).

Re-derivation of the reference's camera calibrations
(calibration/camera_calibration/calib.py chessboard intrinsics,
calibration/lidar_camera/calib.py PnP extrinsics,
calibration/panorama_camera/calib.py homography stitching).  Uses OpenCV
where it is installed, with numpy DLT fallbacks where it is not (the card's
machine has none).  ``cv2`` is imported on first use, so that importing the
port loads no OpenCV.
"""
from __future__ import annotations

import importlib.util
from typing import Optional, Sequence, Tuple

import numpy as np

HAS_CV2 = importlib.util.find_spec("cv2") is not None


def calibrate_camera_intrinsics(object_points: Sequence[np.ndarray],
                                image_points: Sequence[np.ndarray],
                                image_size: Tuple[int, int]):
    """Chessboard intrinsics (ref camera_calibration/calib.py:79).

    object_points: list of (N,3) board coords; image_points: list of (N,2).
    Returns (K 3x3, dist (5,), rms).
    """
    if HAS_CV2:
        import cv2
        objp = [np.asarray(o, np.float32) for o in object_points]
        imgp = [np.asarray(i, np.float32).reshape(-1, 1, 2) for i in image_points]
        rms, K, dist, rvecs, tvecs = cv2.calibrateCamera(
            objp, imgp, image_size, None, None)
        return np.asarray(K), np.asarray(dist).reshape(-1), float(rms)
    # Zhang's method via homographies (planar boards, z=0)
    Hs = [homography_dlt(o[:, :2], i) for o, i in zip(object_points, image_points)]

    def v_ij(H, i, j):
        return np.asarray([
            H[0, i] * H[0, j], H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j], H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j], H[2, i] * H[2, j]])
    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.stack(V))
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = np.sqrt(lam / B11)
    beta = np.sqrt(lam * B11 / (B11 * B22 - B12 ** 2))
    gamma = -B12 * alpha ** 2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha ** 2 / lam
    K = np.asarray([[alpha, gamma, u0], [0, beta, v0], [0, 0, 1.0]])
    return K, np.zeros(5), 0.0


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography src (N,2) -> dst (N,2) (panorama stitching core)."""
    src = np.asarray(src, float).reshape(-1, 2)
    dst = np.asarray(dst, float).reshape(-1, 2)
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def solve_pnp(object_points: np.ndarray, image_points: np.ndarray,
              K: np.ndarray, dist: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, float]:
    """Lidar->camera extrinsic from 3D-2D correspondences
    (ref lidar_camera/calib.py:38 cv2.solvePnP).  Returns (T 4x4, reproj rms)."""
    obj = np.asarray(object_points, np.float32).reshape(-1, 3)
    img = np.asarray(image_points, np.float32).reshape(-1, 2)
    if HAS_CV2:
        import cv2
        ok, rvec, tvec = cv2.solvePnP(obj, img.reshape(-1, 1, 2), np.asarray(K, np.float64),
                                      np.zeros(5) if dist is None else np.asarray(dist, np.float64),
                                      flags=cv2.SOLVEPNP_ITERATIVE)
        R, _ = cv2.Rodrigues(rvec)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = tvec.reshape(3)
        proj, _ = cv2.projectPoints(obj, rvec, tvec, np.asarray(K, np.float64),
                                    np.zeros(5) if dist is None else np.asarray(dist, np.float64))
        rms = float(np.sqrt(np.mean(np.sum((proj.reshape(-1, 2) - img) ** 2, -1))))
        return T, rms
    # DLT fallback: P = K [R|t] from 3D-2D via linear system + orthogonalize
    A = []
    for (X, Y, Z), (u, v) in zip(obj, img):
        A.append([X, Y, Z, 1, 0, 0, 0, 0, -u * X, -u * Y, -u * Z, -u])
        A.append([0, 0, 0, 0, X, Y, Z, 1, -v * X, -v * Y, -v * Z, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    P = Vt[-1].reshape(3, 4)
    M = np.linalg.inv(np.asarray(K, float)) @ P
    scale = np.mean([np.linalg.norm(M[:, i]) for i in range(3)])
    M = M / scale
    U, _, Vt2 = np.linalg.svd(M[:, :3])
    R = U @ Vt2
    if np.linalg.det(R) < 0:
        R, M = -R, -M
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = M[:, 3]
    Kh = np.asarray(K, float)
    pr = (Kh @ (R @ obj.T + M[:, 3:4])).T
    pr = pr[:, :2] / pr[:, 2:3]
    rms = float(np.sqrt(np.mean(np.sum((pr - img) ** 2, -1))))
    return T, rms
