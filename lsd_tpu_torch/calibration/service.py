"""Calibration vectors of the config (counterpart of
``lsd_tpu/calibration/service.py:28-44``; the RPC surface is not ported).

Config convention, the reference's: ``extrinsic_parameters`` is [x, y, z,
roll, pitch, yaw] with angles in degrees and the rotation built as
Rz(yaw) @ Rx(pitch) @ Ry(roll).
"""
from __future__ import annotations

import numpy as np

DEG = np.pi / 180.0


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
