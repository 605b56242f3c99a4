"""Calibration interface registry: the `calibration.*` RPC surface
(counterpart of ``lsd_tpu/calibration/service.py``; host numpy).

Re-derivation of the reference's calibration facade
(calibration/calibration.py register_interface list +
calibration/calibration_server.py JSON-RPC methods) on our own solvers:
ground RANSAC leveling, 2D similarity heading alignment, PnP
lidar-camera, chessboard intrinsics, UTM projections, Umeyama/hand-eye
lidar-INS/IMU trajectory calibration, and DLT panorama homographies.
The lidar-INS and lidar-IMU sessions and the panorama are module-level
state, as in the reference: one calibration session per process.

Config conventions match the reference: `extrinsic_parameters` is
[x, y, z, roll, pitch, yaw] with angles in DEGREES and the rotation built
as Rz(yaw) @ Rx(pitch) @ Ry(roll) (slam/common/slam_utils.cpp:89-96).
"""
from __future__ import annotations

import base64
import threading
from typing import List, Optional

import numpy as np

from ..geometry.utm import latlon_to_utm, utm_to_latlon, utm_zone
from ..runtime.interface import register_interface

DEG = np.pi / 180.0


# --------------------------------------------------------------------------
# transform <-> cfg vector (reference RPYT convention)


def cfg_to_transform(x, y, z, roll, pitch, yaw) -> np.ndarray:
    """[x,y,z,roll,pitch,yaw] (deg) -> 4x4; R = Rz(yaw) Rx(pitch) Ry(roll)."""
    a, b, c = yaw * DEG, pitch * DEG, roll * DEG
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    Rz = np.asarray([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
    Rx = np.asarray([[1.0, 0, 0], [0, cb, -sb], [0, sb, cb]])
    Ry = np.asarray([[cc, 0, sc], [0, 1.0, 0], [-sc, 0, cc]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Rx @ Ry
    T[:3, 3] = (x, y, z)
    return T


def transform_to_cfg(T: np.ndarray) -> List[float]:
    """4x4 -> [x,y,z,roll,pitch,yaw] (deg), inverting cfg_to_transform's
    ZXY euler composition."""
    T = np.asarray(T, float).reshape(4, 4)
    R = T[:3, :3]
    pitch = np.arcsin(np.clip(R[2, 1], -1.0, 1.0))
    roll = np.arctan2(-R[2, 0], R[2, 2])
    yaw = np.arctan2(-R[0, 1], R[1, 1])
    return [float(T[0, 3]), float(T[1, 3]), float(T[2, 3]),
            float(roll / DEG), float(pitch / DEG), float(yaw / DEG)]


# --------------------------------------------------------------------------
# geometry helpers


def _decode_points(points) -> np.ndarray:
    """Web payloads ship points as base64 float32 xyzi (ref
    calibration.py calibrate_ground)."""
    if isinstance(points, str):
        return np.frombuffer(base64.b64decode(points),
                             np.float32).reshape(-1, 4)
    return np.asarray(points, np.float32).reshape(-1, 4)


def _crop_to_polygon(points: np.ndarray, contour) -> np.ndarray:
    poly = np.asarray(contour, float).reshape(-1, 2)
    if len(poly) < 3:
        return points
    x, y = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        cond = (yi > y) != (yj > y)
        xx = (xj - xi) * (y - yi) / (yj - yi + 1e-30) + xi
        inside ^= cond & (x < xx)
        j = i
    return points[inside]


def _rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rodrigues rotation taking unit-ish vector a onto b."""
    a = np.asarray(a, float); a /= np.linalg.norm(a)
    b = np.asarray(b, float); b /= np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.asarray([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * ((1 - c) / (s * s))


def _similarity_2d(p0s, p1s) -> np.ndarray:
    """Least-squares 2D rigid transform p0 -> p1 from clicked pairs (the
    reference's heading-alignment math, lidar_calibration align_points)."""
    A, b = [], []
    for p0, p1 in zip(p0s, p1s):
        x0, y0 = float(p0[0]), float(p0[1])
        A.append([x0, -y0, 1, 0]); b.append(float(p1[0]))
        A.append([y0, x0, 0, 1]); b.append(float(p1[1]))
    x = np.linalg.pinv(np.asarray(A, float)) @ np.asarray(b, float)
    cs, sn, dx, dy = x
    nrm = max(np.hypot(cs, sn), 1e-12)   # project onto a true rotation
    cs, sn = cs / nrm, sn / nrm
    T = np.eye(4)
    T[:2, :2] = [[cs, -sn], [sn, cs]]
    T[:2, 3] = (dx, dy)
    return T


# --------------------------------------------------------------------------
# stateful lidar-INS / lidar-IMU calibration sessions


class _TrajectoryCalib:
    """Collects synchronized (lidar pose, reference pose) pairs during a
    drive and solves the extrinsic by trajectory alignment (the role of
    sensor_driver/calibration lidar_ins aligner / lidar_imu calibrator)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset([0, 0, 0, 0, 0, 0])

    def reset(self, extrinsic_cfg) -> None:
        with self._lock:
            self.extrinsic = cfg_to_transform(*[float(v) for v in extrinsic_cfg][:6])
            self.lidar_poses: List[np.ndarray] = []
            self.ref_poses: List[np.ndarray] = []
            self.result: Optional[np.ndarray] = None

    def feed(self, lidar_pose, ref_pose) -> int:
        with self._lock:
            self.lidar_poses.append(np.asarray(lidar_pose, float).reshape(4, 4))
            self.ref_poses.append(np.asarray(ref_pose, float).reshape(4, 4))
            return len(self.lidar_poses)

    def maybe_feed(self, lidar_pose, ref_pose, min_dist: float = 2.0,
                   min_rot_deg: float = 15.0) -> int:
        """Keyframe-gated feed (ref InsCalib.is_keyframe: 5 m / 30 deg —
        we gate tighter since the solver benefits from more pairs)."""
        T = np.asarray(lidar_pose, float).reshape(4, 4)
        with self._lock:
            if self.lidar_poses:
                last = self.lidar_poses[-1]
                d = np.linalg.norm(T[:3, 3] - last[:3, 3])
                cosang = (np.trace(last[:3, :3].T @ T[:3, :3]) - 1) / 2
                ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
                if d < min_dist and ang < min_rot_deg:
                    return len(self.lidar_poses)
            self.lidar_poses.append(T)
            self.ref_poses.append(np.asarray(ref_pose, float).reshape(4, 4))
            return len(self.lidar_poses)

    def positions(self) -> np.ndarray:
        with self._lock:
            if not self.lidar_poses:
                return np.zeros((0, 3), np.float32)
            return np.stack([T[:3, 3] for T in self.lidar_poses]).astype(np.float32)

    def ref_positions(self) -> np.ndarray:
        with self._lock:
            if not self.ref_poses:
                return np.zeros((0, 3), np.float32)
            return np.stack([T[:3, 3] for T in self.ref_poses]).astype(np.float32)

    def calibrate(self, hand_eye: bool = False) -> Optional[np.ndarray]:
        from .trajectory import align_trajectories, hand_eye_calibration
        with self._lock:
            if len(self.lidar_poses) < 3:
                return None
            if hand_eye:
                T = hand_eye_calibration(self.ref_poses, self.lidar_poses)
            else:
                T, _ = align_trajectories(
                    np.stack([p[:3, 3] for p in self.lidar_poses]),
                    np.stack([p[:3, 3] for p in self.ref_poses]))
            self.result = np.asarray(T, float)
            return self.result


_ins_calib = _TrajectoryCalib()
_imu_calib = _TrajectoryCalib()
_panorama = dict(homographies={}, cameras=[], parameters={}, image=None)


# --------------------------------------------------------------------------
# interface implementations (names/signatures match the reference's
# calibration.py registrations)


def get_projection_forward(lat0, lon0, lat1, lon1):
    zone = utm_zone(lon0)
    x0, y0, _ = latlon_to_utm(lat0, lon0, zone)
    x1, y1, _ = latlon_to_utm(lat1, lon1, zone)
    return [float(x1 - x0), float(y1 - y0)]


def get_projection_backward(lat0, lon0, x, y):
    zone = utm_zone(lon0)
    x0, y0, _ = latlon_to_utm(lat0, lon0, zone)
    lat, lon = utm_to_latlon(x0 + float(x), y0 + float(y), zone)
    return [float(lat), float(lon)]


def get_transform(extrinsic_parameters):
    return cfg_to_transform(
        *[float(v) for v in extrinsic_parameters][:6]).flatten().tolist()


def get_vector_from_transform(transform):
    return transform_to_cfg(np.asarray(transform, float).reshape(4, 4))


def _lidar_entry(config, index):
    """Lidar config entry or None (replay sessions may have no live
    lidar list; the solvers still return their correction)."""
    lidars = config.get("lidar") or []
    i = int(index)
    return lidars[i] if 0 <= i < len(lidars) else None


def _apply_lidar_delta(config, index, dT) -> None:
    entry = _lidar_entry(config, index)
    if entry is None:
        return
    T = cfg_to_transform(*entry.get("extrinsic_parameters",
                                    [0, 0, 0, 0, 0, 0]))
    entry["extrinsic_parameters"] = transform_to_cfg(dT @ T)


def finetune_lidar(config, lidarIndex, transform):
    dT = np.asarray(transform, float).reshape(4, 4)
    _apply_lidar_delta(config, lidarIndex, dT)
    return dT.flatten().tolist(), config


def calibrate_ground(config, points, contour, key):
    """Level the lidar: RANSAC the ground inside the drawn polygon, rotate
    its normal onto +z and move the plane to z=0."""
    from .lidar import ransac_ground_plane
    pts = _decode_points(points)[:, :3]
    crop = _crop_to_polygon(pts, contour)
    if len(crop) < 10:
        return np.eye(4).flatten().tolist(), config
    n, d, _ = ransac_ground_plane(crop)
    dT = np.eye(4)
    dT[:3, :3] = _rot_between(n, [0.0, 0.0, 1.0])
    dT[2, 3] = float(d)   # plane n.p + d = 0 -> origin height |d|
    _apply_lidar_delta(config, key, dT)
    return dT.flatten().tolist(), config


def calibrate_heading(config, source, target, key):
    dT = _similarity_2d(np.asarray(source, float).reshape(-1, 2)[:, :2],
                        np.asarray(target, float).reshape(-1, 2)[:, :2])
    _apply_lidar_delta(config, key, dT)
    return dT.flatten().tolist(), config


def _camera_index(config, cameraName):
    for i, cam in enumerate(config.get("camera", [])):
        if cam.get("name") == cameraName:
            return i
    return None


def finetune_camera(config, cameraName, transform):
    i = _camera_index(config, cameraName)
    if i is None:
        return np.eye(4).flatten().tolist(), config
    T = cfg_to_transform(*config["camera"][i]["extrinsic_parameters"])
    dT = np.asarray(transform, float).reshape(4, 4)
    T = dT @ T
    config["camera"][i]["extrinsic_parameters"] = transform_to_cfg(T)
    return T.flatten().tolist(), config


def calibrate_lidar_camera(config, pointsLidar, pointsCamera, cameraName):
    from .camera import solve_pnp
    i = _camera_index(config, cameraName)
    if i is None:
        return np.eye(4).flatten().tolist(), config
    intr = config["camera"][i].get("intrinsic_parameters", [600, 600, 320, 240])
    K = np.asarray([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    dist = np.asarray(intr[4:9], float) if len(intr) >= 9 else None
    try:
        T, _ = solve_pnp(np.asarray(pointsLidar, float).reshape(-1, 3),
                         np.asarray(pointsCamera, float).reshape(-1, 2), K, dist)
        config["camera"][i]["extrinsic_parameters"] = transform_to_cfg(T)
    except Exception:
        T = np.eye(4)
    return np.asarray(T).flatten().tolist(), config


def find_corners(imageData, cameraName, config):
    """Chessboard corner detection on a base64 JPEG (ref
    camera_calibration detect_checkborad)."""
    try:
        import cv2
    except ImportError:
        return {"result": False, "corners": []}
    raw = base64.b64decode(imageData) if isinstance(imageData, str) else bytes(imageData)
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_GRAYSCALE)
    if img is None:
        return {"result": False, "corners": []}
    pattern = (int(config.get("width", 9)), int(config.get("height", 6)))
    ok, corners = cv2.findChessboardCorners(img, pattern)
    if not ok:
        return {"result": False, "corners": []}
    corners = cv2.cornerSubPix(
        img, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
    return {"result": True, "corners": corners.reshape(-1, 2).tolist()}


def calibrate_camera(od_config, pointsCamera, cameraName, config):
    from .camera import calibrate_camera_intrinsics
    i = _camera_index(od_config, cameraName)
    if i is None:
        return {"result": False}, od_config
    pattern = (int(config.get("width", 9)), int(config.get("height", 6)))
    square = float(config.get("size", 0.05))
    board = np.zeros((pattern[0] * pattern[1], 3), np.float32)
    board[:, :2] = np.mgrid[0:pattern[0], 0:pattern[1]].T.reshape(-1, 2) * square
    img_pts = [np.asarray(p, np.float32).reshape(-1, 2) for p in pointsCamera]
    obj_pts = [board] * len(img_pts)
    size = (int(config.get("image_width", 1280)),
            int(config.get("image_height", 720)))
    K, dist, rms = calibrate_camera_intrinsics(obj_pts, img_pts, size)
    od_config["camera"][i]["intrinsic_parameters"] = [
        float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]),
        *[float(d) for d in np.asarray(dist).reshape(-1)[:5]]]
    return {"result": True, "rms": float(rms)}, od_config


def get_calibrate_camera(config, do_distort=False):
    """Latest frame serialized with raw images for the calibration UI."""
    from ..proto.detection import serialize_detection
    from ..runtime.interface import call_interface, has_interface
    frame = (call_interface("databank.get_latest")
             if has_interface("databank.get_latest") else None)
    if frame is None:
        return b""
    return serialize_detection(dict(
        timestamp=frame.get("frame_start_timestamp", 0),
        objects=[], images=frame.get("image") or {}), include_points=False)


# lidar-INS ------------------------------------------------------------------

def _fix_to_pose(calib, ins) -> Optional[np.ndarray]:
    """INS fix dict -> 4x4 pose in a local UTM frame anchored at the
    calibrator's first fix (ref InsCalib get_transform_from_rtk)."""
    lat, lon = ins.get("latitude"), ins.get("longitude")
    if not lat or not lon:
        return None
    e, n, zone = latlon_to_utm(float(lat), float(lon))
    origin = getattr(calib, "_origin", None)
    if origin is None or origin[2] != zone:
        calib._origin = (float(np.ravel(e)[0]), float(np.ravel(n)[0]), zone,
                         float(ins.get("altitude", 0.0) or 0.0))
        origin = calib._origin
    T = np.eye(4)
    yaw = np.deg2rad(90.0 - float(ins.get("heading", 0.0) or 0.0))
    T[:3, :3] = cfg_to_transform(
        0, 0, 0, float(ins.get("roll", 0.0) or 0.0),
        float(ins.get("pitch", 0.0) or 0.0), np.degrees(yaw))[:3, :3]
    T[0, 3] = float(np.ravel(e)[0]) - origin[0]
    T[1, 3] = float(np.ravel(n)[0]) - origin[1]
    T[2, 3] = float(ins.get("altitude", 0.0) or 0.0) - origin[3]
    return T


def _live_pull(calib) -> None:
    """Pull one (SLAM pose, INS pose) pair from the running session and
    keyframe-gate it into the calibrator.  The reference's InsCalib pulls
    sink.get_proto_http on every UI poll of get-position-points
    (calibration/ins_calibration/calib.py getPositionPoints); here the
    poll of the same route does the pull through the interface registry."""
    from ..runtime.interface import call_interface, has_interface
    if not (has_interface("slam.get_pose")
            and has_interface("databank.get_latest")):
        return
    frame = call_interface("databank.get_latest") or {}
    if not frame.get("ins_valid"):
        return
    ref_T = _fix_to_pose(calib, frame.get("ins_data") or {})
    if ref_T is None:
        return
    lidar_T = np.asarray(call_interface("slam.get_pose"),
                         float).reshape(4, 4)
    calib.maybe_feed(lidar_T, ref_T)


def restart_lidar_ins_calibration(config):
    _ins_calib.reset(config["ins"]["extrinsic_parameters"])
    _ins_calib._origin = None


def feed_ins_calibration(lidar_pose, ins_pose):
    return _ins_calib.feed(lidar_pose, ins_pose)


def get_position_points():
    from ..proto.internal import serialize_pointcloud_map
    _live_pull(_ins_calib)
    pos = _ins_calib.positions()
    pts = np.concatenate([pos, np.zeros((len(pos), 1), np.float32)], axis=1) \
        if len(pos) else np.zeros((0, 4), np.float32)
    return serialize_pointcloud_map({"position_points": pts})


def calibrate_lidar_ins():
    T = _ins_calib.calibrate(hand_eye=False)
    return {"result": T is not None}


def lidar_ins_get_positions():
    """JSON-friendly trajectory pair for the built-in calibration UI (the
    proto route /v1/get-position-points carries the same lidar positions
    for the reference UI)."""
    _live_pull(_ins_calib)
    return dict(lidar=_ins_calib.positions().tolist(),
                ref=_ins_calib.ref_positions().tolist())


def lidar_imu_get_positions():
    _live_pull(_imu_calib)
    return dict(lidar=_imu_calib.positions().tolist(),
                ref=_imu_calib.ref_positions().tolist())


def get_lidar_ins_calibration():
    n = len(_ins_calib.lidar_poses)
    return dict(points=n, calibrated=_ins_calib.result is not None)


def get_lidar_ins_transform():
    T = _ins_calib.result if _ins_calib.result is not None else _ins_calib.extrinsic
    return np.asarray(T, float).flatten().tolist()


def set_lidar_ins_transform(config, transform):
    T = np.asarray(transform, float).reshape(4, 4)
    config["ins"]["extrinsic_parameters"] = transform_to_cfg(T)
    _ins_calib.reset(config["ins"]["extrinsic_parameters"])
    return {"result": True}, config


# lidar-IMU ------------------------------------------------------------------

def restart_lidar_imu_calibration(config):
    _imu_calib.reset(config["ins"]["extrinsic_parameters"])
    _imu_calib._origin = None


def feed_imu_calibration(lidar_pose, imu_pose):
    return _imu_calib.feed(lidar_pose, imu_pose)


def get_imu_position_points(config=None):
    from ..proto.internal import serialize_pointcloud_map
    _live_pull(_imu_calib)
    pos = _imu_calib.positions()
    pts = np.concatenate([pos, np.zeros((len(pos), 1), np.float32)], axis=1) \
        if len(pos) else np.zeros((0, 4), np.float32)
    return serialize_pointcloud_map({"imu_position_points": pts})


def calibrate_lidar_imu():
    T = _imu_calib.calibrate(hand_eye=True)
    return {"result": T is not None}


def lidar_imu_get_lidar_poses():
    return [T.flatten().tolist() for T in _imu_calib.lidar_poses]


def lidar_imu_get_imu_poses():
    return [T.flatten().tolist() for T in _imu_calib.ref_poses]


def set_lidar_imu_extrinsics(config):
    T = _imu_calib.result if _imu_calib.result is not None else np.eye(4)
    config["ins"]["imu_extrinsic_parameters"] = transform_to_cfg(T)
    return config


# panorama -------------------------------------------------------------------

def get_homography(cameras, name0, name1, image0, image1, kpoint0, kpoint1,
                   order):
    from .camera import homography_dlt
    H = homography_dlt(np.asarray(kpoint0, float).reshape(-1, 2),
                       np.asarray(kpoint1, float).reshape(-1, 2))
    _panorama["homographies"][(str(name0), str(name1))] = H
    _panorama["cameras"] = list(cameras) if cameras else _panorama["cameras"]
    _panorama["parameters"] = dict(order=order)
    return H.flatten().tolist()


def get_panorama():
    """Latest stitched panorama JPEG bytes (empty until two camera images
    and a homography are available)."""
    try:
        import cv2
    except ImportError:
        return b""
    from ..runtime.interface import call_interface, has_interface
    frame = (call_interface("databank.get_latest")
             if has_interface("databank.get_latest") else None)
    images = (frame or {}).get("image") or {}
    if len(images) < 2 or not _panorama["homographies"]:
        return b""
    (n0, n1), H = next(iter(_panorama["homographies"].items()))
    if n0 not in images or n1 not in images:
        n0, n1 = list(images)[:2]
    im0 = cv2.imdecode(np.frombuffer(bytes(images[n0]), np.uint8), 1)
    im1 = cv2.imdecode(np.frombuffer(bytes(images[n1]), np.uint8), 1)
    if im0 is None or im1 is None:
        return b""
    h, w = im0.shape[:2]
    canvas = cv2.warpPerspective(im1, np.asarray(H, float), (w * 2, h))
    canvas[:, :w] = np.maximum(canvas[:, :w], im0)
    ok, buf = cv2.imencode(".jpg", canvas)
    return buf.tobytes() if ok else b""


def set_panorama_config(config):
    config.setdefault("panorama_camera", {})
    config["panorama_camera"]["sensor_input"] = _panorama["cameras"]
    config["panorama_camera"]["parameters"] = _panorama["parameters"]
    return {"result": True}, config


# --------------------------------------------------------------------------

_REGISTRY = {
    "calibration.get_projection_forward": get_projection_forward,
    "calibration.get_projection_backward": get_projection_backward,
    "calibration.get_transform": get_transform,
    "calibration.get_vector_from_transform": get_vector_from_transform,
    "calibration.finetune_lidar": finetune_lidar,
    "calibration.calibrate_ground": calibrate_ground,
    "calibration.calibrate_heading": calibrate_heading,
    "calibration.finetune_camera": finetune_camera,
    "calibration.calibrate_lidar_camera": calibrate_lidar_camera,
    "calibration.find_corners": find_corners,
    "calibration.calibrate_camera": calibrate_camera,
    "calibration.get_calibrate_camera": get_calibrate_camera,
    "calibration.restart_lidar_ins_calibration": restart_lidar_ins_calibration,
    "calibration.feed_ins_calibration": feed_ins_calibration,
    "calibration.get_position_points": get_position_points,
    "calibration.calibrate_lidar_ins": calibrate_lidar_ins,
    "calibration.get_lidar_ins_calibration": get_lidar_ins_calibration,
    "calibration.get_lidar_ins_transform": get_lidar_ins_transform,
    "calibration.lidar_ins_get_positions": lidar_ins_get_positions,
    "calibration.lidar_imu_get_positions": lidar_imu_get_positions,
    "calibration.set_lidar_ins_transform": set_lidar_ins_transform,
    "calibration.restart_lidar_imu_calibration": restart_lidar_imu_calibration,
    "calibration.feed_imu_calibration": feed_imu_calibration,
    "calibration.get_imu_position_points": get_imu_position_points,
    "calibration.calibrate_lidar_imu": calibrate_lidar_imu,
    "calibration.lidar_imu_get_lidar_poses": lidar_imu_get_lidar_poses,
    "calibration.lidar_imu_get_imu_poses": lidar_imu_get_imu_poses,
    "calibration.set_lidar_imu_extrinsics": set_lidar_imu_extrinsics,
    "calibration.get_homography": get_homography,
    "calibration.get_panorama": get_panorama,
    "calibration.set_panorama_config": set_panorama_config,
}


def register_calibration_interfaces() -> None:
    for name, fn in _REGISTRY.items():
        register_interface(name, fn)
