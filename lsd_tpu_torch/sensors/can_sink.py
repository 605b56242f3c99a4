"""CAN output quantization: detected objects -> CAN frame payloads
(a copy of ``lsd_tpu/sensors/can_sink.py`` for the port).

Re-derivation of the reference's CAN sink (module/sink/can_sink.py:6-120
quantization_status / quantization_obstacle_a/b/c): fixed-point packing of
status + per-obstacle A/B/C messages with the same scales and bit layouts
so downstream ECUs decode identically.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np


def _q(v: float, lo: float, hi: float, scale: float) -> int:
    return int(round(min(max(v, lo), hi) / scale))


def encode_status(num_obstacles: int, timestamp_us: int) -> bytes:
    ts = int(timestamp_us / 1000) % 256
    rel = int(time.time() * 1000) % 256
    return bytes([num_obstacles & 0xFF, ts, rel, 1, 1, 0, 0, 0])


def encode_obstacle_a(obj_id: int, x: float, y: float, z: float,
                      vx: float, obj_type: int, state: int, valid: bool) -> bytes:
    bx = _q(x, -127.93, 127.93, 0.0625)
    by = _q(y, -127.93, 127.93, 0.0625)
    bz = _q(z, -7.93, 7.93, 0.0625)
    vv = _q(vx, -127.93, 127.93, 0.0625)
    labels = min(max(int(obj_type), 0), 7)
    st = min(max(int(state), 0), 7)
    ov = 1 if valid else 2
    return bytes([
        obj_id % 256,
        bx & 0xFF,
        ((by & 0x0F) << 4) | ((bx & 0x0F00) >> 8),
        (by & 0x0FF0) >> 4,
        bz & 0xFF,
        vv & 0xFF,
        ((labels & 0x07) << 5) | ((vv & 0x0F00) >> 8),
        ((ov & 0x03) << 5) | (st & 0x07),
    ])


def decode_can_obstacle_a(frame: bytes) -> Dict:
    """Inverse of encode_obstacle_a (for receivers/tests)."""
    d = bytes(frame)
    bx = ((d[2] & 0x0F) << 8) | d[1]
    by = (d[3] << 4) | ((d[2] & 0xF0) >> 4)
    bz = d[4]
    vv = ((d[6] & 0x0F) << 8) | d[5]

    def s12(v):
        return v - 4096 if v >= 2048 else v

    def s8(v):
        return v - 256 if v >= 128 else v

    return dict(id=d[0],
                x=s12(bx) * 0.0625, y=s12(by) * 0.0625, z=s8(bz) * 0.0625,
                vx=s12(vv) * 0.0625,
                type=(d[6] >> 5) & 0x07,
                valid=((d[7] >> 5) & 0x03) == 1,
                state=d[7] & 0x07)


def encode_obstacle_b(l: float, w: float, h: float, conf: float, age: int) -> bytes:
    return bytes([
        _q(l, 0.0, 30.6, 0.12) & 0xFF,
        _q(w, 0.0, 12.75, 0.05) & 0xFF,
        _q(h, 0.0, 12.75, 0.05) & 0xFF,
        min(max(int(age), 0), 255),
        min(max(int(conf * 100), 0), 100),
        0, 0, 0,
    ])


def encode_obstacle_c(heading_rad: float, angle_rate: float, accel_x: float) -> bytes:
    ar = _q(angle_rate / math.pi * 180.0, -327.68, 327.67, 0.01)
    ax = _q(accel_x, -14.97, 14.97, 0.03)
    hd = heading_rad / math.pi * 180.0
    hd = hd - 360.0 if hd > 180.0 else (hd + 360.0 if hd < -180.0 else hd)
    hq = _q(hd, -327.68, 327.67, 0.01)
    return bytes([
        ar & 0xFF, (ar >> 8) & 0xFF,
        ax & 0xFF, ((ax >> 8) & 0x03),
        hq & 0xFF, (hq >> 8) & 0xFF,
        0, 0,
    ])


def encode_can_frames(result: Dict) -> List[Tuple[int, bytes]]:
    """Full frame set for one detection result: status + A/B/C per object
    (ids 0x500 status, then 0x501+3k like the reference's sequential ids)."""
    objs = result.get("objects", [])
    frames = [(0x500, encode_status(len(objs), result.get("timestamp", 0)))]
    for k, o in enumerate(objs):
        b = np.asarray(o["box"], float)
        v = np.asarray(o.get("velocity", [0, 0, 0]), float)
        base = 0x501 + 3 * k
        frames.append((base, encode_obstacle_a(
            int(o["id"]), b[0], b[1], b[2], v[0], int(o.get("label", 0)) + 1,
            3 if np.linalg.norm(v[:2]) > 0.5 else 1, bool(o.get("valid", True)))))
        frames.append((base + 1, encode_obstacle_b(
            b[3], b[4], b[5], float(o.get("score", 0.0)), int(o.get("age", 1)))))
        frames.append((base + 2, encode_obstacle_c(b[6], 0.0, 0.0)))
    return frames
