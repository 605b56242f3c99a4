"""GPCHC NMEA-style INS sentence parse/format
(a copy of ``lsd_tpu/io/gpchc.py`` for the port).

The reference speaks GPCHC on its INS serial/UDP path
(sensor_driver/ins_driver/src/ins_driver.cpp parseGPCHC :483-535) and emits
fused GPCHC from the localization output thread (slam/src/slam.cpp:419-510).
Field order: $GPCHC,week,sow,heading,pitch,roll,gx,gy,gz,ax,ay,az,
lat,lon,alt,Ve,Vn,Vu,V,NSV1,NSV2,Status,age,warning*CS
"""
from __future__ import annotations

from typing import Dict, Optional

GPS_EPOCH_OFFSET_US = 315964800 * 1000000  # GPS epoch (1980-01-06) vs unix
LEAP_SECONDS_US = 18 * 1000000


def _checksum(body: str) -> int:
    cs = 0
    for ch in body:
        cs ^= ord(ch)
    return cs


def parse_gpchc(sentence: str) -> Optional[Dict]:
    sentence = sentence.strip()
    if not sentence.startswith("$GPCHC"):
        return None
    body, _, _cs = sentence[1:].partition("*")
    parts = body.split(",")
    if len(parts) < 23:
        return None
    try:
        week, sow = int(parts[1]), float(parts[2])
        ts_us = GPS_EPOCH_OFFSET_US + week * 7 * 86400 * 1000000 + int(sow * 1e6) - LEAP_SECONDS_US
        return dict(
            timestamp=ts_us,
            heading=float(parts[3]), pitch=float(parts[4]), roll=float(parts[5]),
            gyro_x=float(parts[6]), gyro_y=float(parts[7]), gyro_z=float(parts[8]),
            acc_x=float(parts[9]), acc_y=float(parts[10]), acc_z=float(parts[11]),
            latitude=float(parts[12]), longitude=float(parts[13]), altitude=float(parts[14]),
            Ve=float(parts[15]), Vn=float(parts[16]), Vu=float(parts[17]),
            Status=int(parts[21]) if parts[21] else 0,
            Sensor="GNSS",
        )
    except (ValueError, IndexError):
        return None


def format_gpchc(ins: Dict) -> str:
    ts = int(ins.get("timestamp", 0))
    gps_us = ts - GPS_EPOCH_OFFSET_US + LEAP_SECONDS_US
    week = gps_us // (7 * 86400 * 1000000)
    sow = (gps_us - week * 7 * 86400 * 1000000) / 1e6
    ve, vn, vu = ins.get("Ve", 0.0), ins.get("Vn", 0.0), ins.get("Vu", 0.0)
    speed = (ve * ve + vn * vn + vu * vu) ** 0.5
    body = (
        "GPCHC,%d,%.3f,%.2f,%.2f,%.2f,%.4f,%.4f,%.4f,%.4f,%.4f,%.4f,"
        "%.8f,%.8f,%.3f,%.3f,%.3f,%.3f,%.3f,0,0,%d,0,0"
        % (week, sow,
           ins.get("heading", 0.0), ins.get("pitch", 0.0), ins.get("roll", 0.0),
           ins.get("gyro_x", 0.0), ins.get("gyro_y", 0.0), ins.get("gyro_z", 0.0),
           ins.get("acc_x", 0.0), ins.get("acc_y", 0.0), ins.get("acc_z", 0.0),
           ins.get("latitude", 0.0), ins.get("longitude", 0.0), ins.get("altitude", 0.0),
           ve, vn, vu, speed,
           ins.get("Status", 0))
    )
    return "$%s*%02X" % (body, _checksum(body))
