"""RoboSense DIFOP (device info) packet parsing
(a copy of ``lsd_tpu/io/rs_difop.py`` for the port).

The RS-Helios / RS-Helios-16P / RS-32 / RS-Ruby family streams a 1248-byte
DIFOP packet on the data port + 1 carrying, among device state, the
per-unit factory angle calibration: 32 (sign, value) vertical and
horizontal entries in centidegrees.  The reference loads these at runtime
to correct each channel's beam direction (sensor_driver/lidar_driver/
src/rs_decode_difop.cpp Decode/decodeDifopCommon + DecoderBase.h
ChanAngles::loadFromDifop:683-716).  This is the exact-per-unit-angle
path previously stubbed by factory-default ladders.

Offsets below follow the packed RSHELIOSDifopPkt layout
(DecoderBase.h:446-468 under #pragma pack(1)):

    0    id[8]                  (0xA5 leading byte is the sanity check)
    8    rpm (u16 BE)
    10   eth (22)
    32   fov start/end (u16 BE x2, centidegrees)
    38   phase_lock_angle
    40   version (23)
    63   reserved2[229]
    292  sn(6) zero_cali(2) return_mode(1)
    301  time_info(12) status(24) reserved3(5) diagno(40)
    382  gprmc[86]
    468  vert_angle_cali[32]  {sign u8, value u16 BE}
    564  horiz_angle_cali[32] {sign u8, value u16 BE}
    660  reserved4[586] tail(2)   -> 1248 total
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

HELIOS_DIFOP_LEN = 1248
_VERT_OFF = 468
_HORIZ_OFF = 564
_N_CHANNELS = 32


def _angles_at(pkt: bytes, off: int, n: int) -> Optional[np.ndarray]:
    vals = np.zeros(n, np.int32)
    for i in range(n):
        sign, value = struct.unpack_from(">BH", pkt, off + 3 * i)
        if sign == 0xFF:          # uninitialized flash block
            return None
        v = -value if sign != 0 else value
        if not (-9000 <= v < 9000):   # reference angleCheck gate
            return None
        vals[i] = v
    return vals


def parse_rs_difop(pkt: bytes, n_lasers: int = 32) -> Optional[Dict]:
    """Parse one Helios-layout DIFOP packet.

    Returns dict(rpm, fov_start_deg, fov_end_deg, return_mode,
    vert_cd, horiz_cd) with angles in centidegrees (int32 arrays of
    n_lasers entries), or None if the packet fails validation.
    """
    if len(pkt) < HELIOS_DIFOP_LEN or pkt[0] != 0xA5:
        return None
    rpm = struct.unpack_from(">H", pkt, 8)[0] or 600
    fov_start, fov_end = struct.unpack_from(">HH", pkt, 32)
    return_mode = pkt[300]
    vert = _angles_at(pkt, _VERT_OFF, _N_CHANNELS)
    horiz = _angles_at(pkt, _HORIZ_OFF, _N_CHANNELS)
    if vert is None or horiz is None:
        return None
    return dict(rpm=int(rpm),
                fov_start_deg=fov_start / 100.0,
                fov_end_deg=fov_end / 100.0,
                return_mode=int(return_mode),
                vert_cd=vert[:n_lasers],
                horiz_cd=horiz[:n_lasers])


def build_rs_difop(vert_cd, horiz_cd, rpm: int = 600,
                   fov=(0.0, 360.0), return_mode: int = 0) -> bytes:
    """Serialize a Helios-layout DIFOP packet (test vectors + the packet
    relay path; inverse of parse_rs_difop)."""
    pkt = bytearray(HELIOS_DIFOP_LEN)
    pkt[0:8] = bytes([0xA5, 0xFF, 0x00, 0x5A, 0x11, 0x11, 0x55, 0x55])
    struct.pack_into(">H", pkt, 8, int(rpm))
    struct.pack_into(">HH", pkt, 32, int(fov[0] * 100), int(fov[1] * 100))
    pkt[300] = return_mode & 0xFF
    vert = np.zeros(_N_CHANNELS, np.int32)
    horiz = np.zeros(_N_CHANNELS, np.int32)
    vert[:len(vert_cd)] = np.asarray(vert_cd, np.int32)
    horiz[:len(horiz_cd)] = np.asarray(horiz_cd, np.int32)
    for off, arr in ((_VERT_OFF, vert), (_HORIZ_OFF, horiz)):
        for i, v in enumerate(arr):
            struct.pack_into(">BH", pkt, off + 3 * i,
                             1 if v < 0 else 0, abs(int(v)))
    struct.pack_into(">H", pkt, HELIOS_DIFOP_LEN - 2, 0x0FF0)
    return bytes(pkt)
