"""Localization output: fused pose -> GPCHC over UDP + bus odometry
(a copy of ``lsd_tpu/slam/loc_output.py`` for the port).

Re-derivation of the reference's localization output thread
(slam/src/slam.cpp runLocalizationThread:419-510): take the fused map pose,
convert back to lat/lon via the map origin's UTM anchor, format a GPCHC
sentence and send it over UDP (the reference's downstream consumers speak
GPCHC; tools/recv_sample/recv_localization_udp.cpp receives it), plus a
bus ``slam.odometry`` publish for TViz.  Includes the RTK-passthrough
fallback: when the localizer has no valid pose, the raw INS fix is
forwarded unchanged (ref slam.cpp:440-455).
"""
from __future__ import annotations

import socket
from typing import Dict, Optional

import numpy as np

from ..geometry import np_so3
from ..geometry.utm import UTMProjector
from ..io.gpchc import format_gpchc


class LocalizationOutput:
    def __init__(self, dest: str = "127.0.0.1", port: int = 19001,
                 origin_lla: Optional[np.ndarray] = None):
        self.dest = (dest, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.projector = UTMProjector()
        if origin_lla is not None and np.ravel(origin_lla)[0] != 0:
            o = np.ravel(origin_lla)
            self.projector.project(float(o[0]), float(o[1]))  # anchor at origin
        self.origin_alt = float(np.ravel(origin_lla)[2]) if origin_lla is not None \
            and len(np.ravel(origin_lla)) > 2 else 0.0

    def emit(self, stamp_us: int, pose: Optional[np.ndarray],
             ins_fix: Optional[Dict] = None, status: int = 4) -> Optional[str]:
        """Send one GPCHC out; returns the sentence (None if nothing sent)."""
        if pose is None:
            if ins_fix is None:
                return None
            # RTK passthrough fallback
            sentence = format_gpchc(ins_fix)
        else:
            if self.projector.origin is None:
                return None   # no geo anchor: metric-only map
            lat, lon = self.projector.unproject(pose[0, 3], pose[1, 3])
            rpy = np_so3.matrix_to_rpy(pose[:3, :3])
            heading = (90.0 - np.rad2deg(float(rpy[2]))) % 360.0
            sentence = format_gpchc(dict(
                timestamp=stamp_us,
                latitude=float(np.ravel(lat)[0]), longitude=float(np.ravel(lon)[0]),
                altitude=self.origin_alt + float(pose[2, 3]),
                heading=heading, pitch=float(np.rad2deg(rpy[1])),
                roll=float(np.rad2deg(rpy[0])),
                Status=status))
        try:
            self.sock.sendto(sentence.encode(), self.dest)
        except OSError:
            pass
        try:
            from ..comms import MessageBus
            from ..comms.messages import odometry_msg
            if pose is not None:
                MessageBus.core().publish("slam.odometry", odometry_msg(stamp_us, pose))
        except Exception:
            pass
        return sentence
