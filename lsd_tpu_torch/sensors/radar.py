"""ARS408 radar CAN parsing
(a copy of ``lsd_tpu/sensors/radar.py`` for the port).

Re-derivation of the reference's radar driver
(sensor_driver/radar_driver/src/radar_driver.cpp canParse_ARS408:124-183):
frame ids 0x60A (object-list header: flush frame), 0x60B (tracked object
position/velocity), 0x60D (acceleration/class/orientation/size), with the
bit unpackings of the ARS408 CAN matrix.  Pure-python parse over
(can_id, 8-byte payload) tuples — SocketCAN plumbs in via ``can_bus.py`` or
any CAN reader.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RadarObject:
    id: int
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    vx: float = 0.0
    vy: float = 0.0
    ax: float = 0.0
    ay: float = 0.0
    yaw_deg: float = 0.0
    length: float = 0.0
    width: float = 0.0
    type: int = 0           # 0 unknown / 1 vehicle / 2 pedestrian / 3 cyclist


class Ars408Parser:
    def __init__(self, extrinsic: Optional[np.ndarray] = None):
        self.extrinsic = np.eye(4) if extrinsic is None else np.asarray(extrinsic, float)
        self.current: Dict[int, RadarObject] = {}
        self.frame_start_us = 0

    def feed(self, can_id: int, data: bytes) -> Optional[Tuple[int, List[RadarObject]]]:
        """Feed one CAN frame; returns (stamp_us, objects) when an object
        list completes (on the next 0x60A header), else None."""
        d = bytes(data) + b"\x00" * (8 - len(data))
        if can_id == 0x60A:
            out = None
            if self.current:
                out = (self.frame_start_us, list(self.current.values()))
                self.current = {}
            self.frame_start_us = int(time.time() * 1e6)
            return out
        if can_id == 0x60B:
            oid = d[0]
            o = self.current.setdefault(oid, RadarObject(id=oid))
            x = (d[1] * 32 + ((d[2] & 0xF8) >> 3)) * 0.2 - 500.0
            y = ((d[2] & 0x07) * 256 + d[3]) * 0.2 - 204.6
            p = self.extrinsic[:3, :3] @ np.asarray([x, y, 0.0]) + self.extrinsic[:3, 3]
            o.x, o.y, o.z = float(p[0]), float(p[1]), float(p[2])
            vx = (d[4] * 4 + ((d[5] & 0xC0) >> 6)) * 0.25 - 128.0
            vy = ((d[5] & 0x3F) * 8 + ((d[6] & 0xE0) >> 5)) * 0.25 - 64.0
            v = self.extrinsic[:3, :3] @ np.asarray([vx, vy, 0.0])
            o.vx, o.vy = float(v[0]), float(v[1])
            return None
        if can_id == 0x60D:
            oid = d[0]
            o = self.current.setdefault(oid, RadarObject(id=oid))
            o.ax = (d[1] * 8 + ((d[2] & 0xE0) >> 5)) * 0.01 - 10.0
            o.ay = ((d[2] & 0x1F) * 16 + ((d[3] & 0xF0) >> 4)) * 0.01 - 2.5
            t = d[3] & 0x07
            o.type = {1: 1, 2: 1, 4: 3, 5: 3, 3: 2}.get(t, 0)
            o.yaw_deg = (d[4] * 4 + ((d[5] & 0xC0) >> 6)) * 0.4 - 180.0
            o.length = d[6] * 0.2
            o.width = d[7] * 0.2
            return None
        return None


def encode_ars408_object(o: RadarObject) -> List[Tuple[int, bytes]]:
    """Inverse of the parse (for tests/replay): object -> 0x60B + 0x60D."""
    x_raw = int(round((o.x + 500.0) / 0.2))
    y_raw = int(round((o.y + 204.6) / 0.2))
    vx_raw = int(round((o.vx + 128.0) / 0.25))
    vy_raw = int(round((o.vy + 64.0) / 0.25))
    b60b = bytes([
        o.id & 0xFF,
        (x_raw >> 5) & 0xFF,
        ((x_raw & 0x1F) << 3) | ((y_raw >> 8) & 0x07),
        y_raw & 0xFF,
        (vx_raw >> 2) & 0xFF,
        ((vx_raw & 0x03) << 6) | ((vy_raw >> 3) & 0x3F),
        (vy_raw & 0x07) << 5,
        0,
    ])
    ax_raw = int(round((o.ax + 10.0) / 0.01))
    ay_raw = int(round((o.ay + 2.5) / 0.01))
    t_inv = {1: 1, 2: 3, 3: 4, 0: 0}[o.type]
    ang_raw = int(round((o.yaw_deg + 180.0) / 0.4))
    b60d = bytes([
        o.id & 0xFF,
        (ax_raw >> 3) & 0xFF,
        ((ax_raw & 0x07) << 5) | ((ay_raw >> 4) & 0x1F),
        ((ay_raw & 0x0F) << 4) | (t_inv & 0x07),
        (ang_raw >> 2) & 0xFF,
        (ang_raw & 0x03) << 6,
        int(round(o.length / 0.2)) & 0xFF,
        int(round(o.width / 0.2)) & 0xFF,
    ])
    return [(0x60B, b60b), (0x60D, b60d)]
