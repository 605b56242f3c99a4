"""ROS-like typed messages for the bus (ZCM type system replacement)
(a copy of ``lsd_tpu/comms/messages.py`` for the port).

The reference generates a ROS-compatible type system from .zcm definitions
(sensor_driver/common_lib/logging/message/*.zcm: std_msgs, geometry_msgs,
nav_msgs, sensor_msgs).  Here the same message shapes are schema dicts over
our protobuf wire codec (proto/wire.py) — compact, versionless, and
decodable by trial like the reference's TViz sniffing
(web_backend/message_server.py:204-214).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..proto.wire import decode_message, encode_message

HEADER = {1: ("seq", "uint32", False), 2: ("stamp_us", "uint64", False),
          3: ("frame_id", "string", False)}
VEC3 = {1: ("x", "double", False), 2: ("y", "double", False), 3: ("z", "double", False)}
QUAT = {1: ("w", "double", False), 2: ("x", "double", False),
        3: ("y", "double", False), 4: ("z", "double", False)}
POSE = {1: ("position", VEC3, False), 2: ("orientation", QUAT, False)}
TWIST = {1: ("linear", VEC3, False), 2: ("angular", VEC3, False)}

ODOMETRY = {1: ("header", HEADER, False), 2: ("pose", POSE, False),
            3: ("twist", TWIST, False)}
PATH = {1: ("header", HEADER, False), 2: ("poses", POSE, True)}
IMU = {1: ("header", HEADER, False), 2: ("orientation", QUAT, False),
       3: ("angular_velocity", VEC3, False), 4: ("linear_acceleration", VEC3, False)}
NAVSATFIX = {1: ("header", HEADER, False), 2: ("latitude", "double", False),
             3: ("longitude", "double", False), 4: ("altitude", "double", False),
             5: ("status", "int32", False)}
POINTCLOUD = {1: ("header", HEADER, False), 2: ("num_points", "uint32", False),
              3: ("data", "bytes", False)}   # float32 xyzi

TYPES = dict(Odometry=ODOMETRY, Path=PATH, Imu=IMU, NavSatFix=NAVSATFIX,
             PointCloud=POINTCLOUD)


def encode_typed(type_name: str, msg: Dict) -> bytes:
    """Frame: [1-byte type tag][payload] so sniffing is exact."""
    tag = list(TYPES).index(type_name)
    return bytes([tag]) + encode_message(TYPES[type_name], msg)


def decode_typed(data: bytes) -> Tuple[str, Dict]:
    tag = data[0]
    name = list(TYPES)[tag]
    return name, decode_message(TYPES[name], data[1:])


def sniff_type(data: bytes) -> Optional[str]:
    if not data:
        return None
    tag = data[0]
    names = list(TYPES)
    if tag >= len(names):
        return None
    try:
        decode_message(TYPES[names[tag]], data[1:])
        return names[tag]
    except Exception:
        return None


# convenience builders -------------------------------------------------------

def _np_matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Pure-numpy Shepperd (keeps the bus importable without jax/device)."""
    m = np.asarray(R, float)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.asarray([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                        (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.asarray([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                        (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
        q = np.asarray([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                        0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
        q = np.asarray([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                        (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def odometry_msg(stamp_us: int, T: np.ndarray, vel=None, frame_id: str = "map") -> bytes:
    q = _np_matrix_to_quat(T[:3, :3])
    t = np.asarray(T[:3, 3], float)
    v = np.zeros(3) if vel is None else np.asarray(vel, float)
    return encode_typed("Odometry", dict(
        header=dict(seq=0, stamp_us=int(stamp_us), frame_id=frame_id),
        pose=dict(position=dict(x=t[0], y=t[1], z=t[2]),
                  orientation=dict(w=q[0], x=q[1], y=q[2], z=q[3])),
        twist=dict(linear=dict(x=v[0], y=v[1], z=v[2]),
                   angular=dict(x=0.0, y=0.0, z=0.0))))


def imu_msg(stamp_us: int, gyro, accel) -> bytes:
    g, a = np.asarray(gyro, float), np.asarray(accel, float)
    return encode_typed("Imu", dict(
        header=dict(seq=0, stamp_us=int(stamp_us), frame_id="imu"),
        orientation=dict(w=1.0, x=0.0, y=0.0, z=0.0),
        angular_velocity=dict(x=g[0], y=g[1], z=g[2]),
        linear_acceleration=dict(x=a[0], y=a[1], z=a[2])))


def pointcloud_msg(stamp_us: int, points: np.ndarray, frame_id: str = "lidar") -> bytes:
    pts = np.asarray(points, np.float32).reshape(-1, points.shape[-1])[:, :4]
    return encode_typed("PointCloud", dict(
        header=dict(seq=0, stamp_us=int(stamp_us), frame_id=frame_id),
        num_points=len(pts), data=pts.tobytes()))
