"""Binary INS/IMU wire parsers: BDDB0B (DY5711-class INS) and Livox IMU
(a copy of ``lsd_tpu/io/ins_binary.py`` for the port).

Re-derivations of the reference's binary protocol handlers
(sensor_driver/ins_driver/src/ins_driver.cpp parseBDDB0B:537-603 and
parseLivoxImu:628-653; packet layout cpp_utils/Types.h DY5711Pkt /
LivoxLidarEthernetImuPacket).  Both produce the same fix-dict schema as
``parse_gpchc`` so downstream (InsMotionTracker, SLAM feeds, GPCHC relay)
is protocol-agnostic.

BDDB0B frame (63 bytes, little-endian, packed):
  0xBD 0xDB 0x0B | roll pitch yaw (i16, x360/32768 deg)
  | gyro xyz (i16, x300/32768 deg/s) | acc xyz (i16, x12/32768 g)
  | lat lon (i32, 1e-7 deg) | alt (i32, mm) | n/e/d vel (i16, x100/32768)
  | status u8 | 6 reserved | polling_data 3x i16 | gps_time u32
  | polling_type u8 | xor of bytes 0..56 | gps_week u32 | xor byte
"""
from __future__ import annotations

import struct
import time
from typing import Dict, Optional, Tuple

_BDDB0B_LEN = 63
_HDR = b"\xbd\xdb\x0b"
_S16 = 360.0 / 32768.0
_GYRO = 300.0 / 32768.0
_ACC = 12.0 / 32768.0
_VEL = 100.0 / 32768.0


def parse_bddb0b(buf: bytes, position_type: int = 0,
                 timestamp_us: Optional[int] = None
                 ) -> Tuple[Optional[Dict], bytes, int]:
    """Extract one fix from a byte stream.

    Returns (fix_or_None, remaining_buffer, position_type).  The stream may
    start mid-frame; bytes before the first 0xBDDB0B header are discarded.
    ``position_type`` carries the most recent polled RTK status across
    frames (the device multiplexes it through polling_data, ref :596-600).
    """
    idx = buf.find(_HDR)
    if idx < 0:
        return None, buf[-2:], position_type
    buf = buf[idx:]
    if len(buf) < _BDDB0B_LEN:
        return None, buf, position_type

    frame = buf[:_BDDB0B_LEN]
    checksum = 0
    for b in frame[:57]:
        checksum ^= b
    if frame[57] != checksum:
        # corrupt frame: skip the header and rescan
        return None, buf[3:], position_type

    (roll, pitch, yaw, gx, gy, gz, ax, ay, az,
     lat, lon, alt, n_vel, e_vel, d_vel, status) = struct.unpack(
        "<9h3i3hB", frame[3:40])
    polling = struct.unpack("<3h", frame[46:52])
    polling_type = frame[56]
    if polling_type == 32:
        position_type = int(polling[0])

    ts = timestamp_us if timestamp_us is not None else int(time.time() * 1e6)
    fix = dict(
        timestamp=ts,
        heading=yaw * _S16, pitch=pitch * _S16, roll=roll * _S16,
        gyro_x=gx * _GYRO, gyro_y=gy * _GYRO, gyro_z=gz * _GYRO,
        acc_x=ax * _ACC, acc_y=ay * _ACC, acc_z=az * _ACC,
        latitude=lat * 1e-7, longitude=lon * 1e-7, altitude=alt * 1e-3,
        Ve=e_vel * _VEL, Vn=n_vel * _VEL, Vu=d_vel * _VEL,
        baseline=0.0, NSV1=0, NSV2=0, Status=position_type, age=0,
        Warnning=0,
    )
    # the device interleaves 58-byte bodies (gps_week/xor tail belongs to
    # the NEXT frame's preamble on this unit — ref erases 58, :602)
    return fix, buf[58:], position_type


def parse_livox_imu(pkt: bytes, timestamp_us: Optional[int] = None
                    ) -> Optional[Dict]:
    """Livox ethernet IMU packet (60 bytes): 28-byte header {u8 version,
    u16 length, u16 time_interval, u16 dot_num, u16 udp_cnt, u8 frame_cnt,
    u8 data_type(0=IMU), u8 time_type, 12 reserved, u32 crc} + u64
    timestamp + 6 x f32 (gyro rad/s, accel g).  Produces a gyro/accel-only
    fix (attitude/position zeroed) like the reference (:640-648)."""
    if len(pkt) != 60:
        return None
    data_type = pkt[10]
    if data_type != 0:
        return None
    gx, gy, gz, ax, ay, az = struct.unpack("<6f", pkt[36:60])
    ts = timestamp_us if timestamp_us is not None else int(time.time() * 1e6)
    rad2deg = 180.0 / 3.141592653589793
    return dict(
        timestamp=ts,
        heading=0.0, pitch=0.0, roll=0.0,
        gyro_x=gx * rad2deg, gyro_y=gy * rad2deg, gyro_z=gz * rad2deg,
        acc_x=ax, acc_y=ay, acc_z=az,
        latitude=0.0, longitude=0.0, altitude=0.0,
        Ve=0.0, Vn=0.0, Vu=0.0,
        baseline=0.0, NSV1=0, NSV2=0, Status=0, age=0, Warnning=0,
        imu_only=True,
    )


def format_bddb0b(fix: Dict) -> bytes:
    """Inverse of parse_bddb0b (testing + relay)."""
    frame = bytearray(_BDDB0B_LEN)
    frame[0:3] = _HDR
    struct.pack_into(
        "<9h3i3hB", frame, 3,
        int(round(fix.get("roll", 0.0) / _S16)),
        int(round(fix.get("pitch", 0.0) / _S16)),
        int(round(fix.get("heading", 0.0) / _S16)),
        int(round(fix.get("gyro_x", 0.0) / _GYRO)),
        int(round(fix.get("gyro_y", 0.0) / _GYRO)),
        int(round(fix.get("gyro_z", 0.0) / _GYRO)),
        int(round(fix.get("acc_x", 0.0) / _ACC)),
        int(round(fix.get("acc_y", 0.0) / _ACC)),
        int(round(fix.get("acc_z", 0.0) / _ACC)),
        int(round(fix.get("latitude", 0.0) / 1e-7)),
        int(round(fix.get("longitude", 0.0) / 1e-7)),
        int(round(fix.get("altitude", 0.0) / 1e-3)),
        int(round(fix.get("Vn", 0.0) / _VEL)),
        int(round(fix.get("Ve", 0.0) / _VEL)),
        int(round(fix.get("Vu", 0.0) / _VEL)),
        int(fix.get("Status", 0)) & 0xFF,
    )
    struct.pack_into("<3h", frame, 46, int(fix.get("Status", 0)), 0, 0)
    frame[56] = 32  # polling_type: RTK status in polling_data[0]
    checksum = 0
    for b in frame[:57]:
        checksum ^= b
    frame[57] = checksum
    return bytes(frame)
