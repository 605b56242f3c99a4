"""ctypes bindings for the native sensor-ingest runtime (a copy of
``lsd_tpu/native/__init__.py`` for the port, but for where the library is
built: see ``_build``).

The library is the repo's ``native/src/lsd_native.cpp``, compiled on first
use with the compiler, flags and source fingerprint of ``native/Makefile``
(g++ is in the image; pybind11 is not, so the C API + ctypes is the binding
layer).  Provides:

- ``UdpReceiver``     — kernel-socket capture thread + SPSC packet ring
                        (per-port packet size; Ouster needs ~12.6 KB slots)
- ``decode_vlp16`` / ``decode_rs16`` / ``decode_livox`` / ``decode_ouster``
  / ``decode_custom`` — vendor packet batches -> (N, 4) float32 (see
  DECODERS registry keyed by cfg lidar names)
- ``points_postprocess`` — extrinsic transform + range/exclude filter

(ref: sensor_driver/lidar_driver + network_driver, SURVEY.md N1/N6)
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_MAX_PACKET = 2048
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _src_sha() -> str:
    """The Makefile's source fingerprint (``LSD_SRC_SHA``)."""
    h = hashlib.sha256()
    for name in ("lsd_native.cpp", "ring_buffer.h"):
        with open(os.path.join(_NATIVE_DIR, "src", name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _cpu_flags() -> str:
    """The host CPU's feature flags: the Makefile builds with
    ``-march=native``, so a library is only good on a CPU like the one that
    built it."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def library_path() -> str:
    """Where the library for the current sources and this host's CPU lives:
    ``lsd_tpu_torch/_build/native/<key>/liblsd_native.so``."""
    with open(os.path.join(_NATIVE_DIR, "Makefile"), "rb") as f:
        makefile = f.read()
    key = hashlib.sha256((_src_sha() + _cpu_flags()).encode() + makefile).hexdigest()[:16]
    return os.path.join(BUILD_DIR, key, "liblsd_native.so")


def _build() -> str:
    """Build the library unless it exists; returns its path.

    ``native/Makefile`` is run with its ``TARGET`` pointed at a temporary
    name in the build directory, which is then renamed into place, under an
    exclusive ``flock`` of ``BUILD_DIR/.lock``: several processes (test
    workers) may ask at once, and none loads a half-written file.
    ``native/liblsd_native.so``, which the reference package rebuilds
    whenever its fingerprint differs, is never written.  A failed build
    raises."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return path
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
            os.close(fd)
            proc = subprocess.run(["make", "-C", _NATIVE_DIR, "-B", f"TARGET={tmp}"],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError("building native/src/lsd_native.cpp failed:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.lsd_src_sha.restype = ctypes.c_char_p
            if lib.lsd_src_sha().decode() != _src_sha():
                raise RuntimeError("the native library's fingerprint does not "
                                   "match native/src")
            lib.lsd_udp_open.argtypes = [ctypes.c_uint16, ctypes.c_uint32]
            lib.lsd_udp_open.restype = ctypes.c_int
            lib.lsd_udp_close.argtypes = [ctypes.c_int]
            lib.lsd_udp_pop.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int]
            lib.lsd_udp_pop.restype = ctypes.c_int
            lib.lsd_udp_stats.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.lsd_udp_stats.restype = ctypes.c_uint64
            lib.lsd_udp_relay.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_uint16]
            lib.lsd_udp_relay.restype = ctypes.c_int
            lib.lsd_decode_vlp16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_vlp16.restype = ctypes.c_int
            lib.lsd_decode_custom.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_uint32,
                                              ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_void_p]
            lib.lsd_decode_custom.restype = ctypes.c_int
            lib.lsd_decode_rs16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_uint32,
                                            ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_rs16.restype = ctypes.c_int
            lib.lsd_decode_livox.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p]
            lib.lsd_decode_livox.restype = ctypes.c_int
            lib.lsd_decode_ouster.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_uint32,
                                              ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_int]
            lib.lsd_decode_ouster.restype = ctypes.c_int
            lib.lsd_decode_lsc16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_lsc16.restype = ctypes.c_int
            lib.lsd_decode_rs32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_uint32,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_rs32.restype = ctypes.c_int
            lib.lsd_decode_rs_ruby.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_rs_ruby.restype = ctypes.c_int
            lib.lsd_decode_rs_helios.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_rs_helios.restype = ctypes.c_int
            lib.lsd_decode_rs_m1.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_rs_m1.restype = ctypes.c_int
            lib.lsd_decode_ouster_v3.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int]
            lib.lsd_decode_ouster_v3.restype = ctypes.c_int
            lib.lsd_points_postprocess.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            lib.lsd_points_postprocess.restype = ctypes.c_int
            _lib = lib
    return _lib


class UdpReceiver:
    def __init__(self, port: int, max_packet: int = _MAX_PACKET):
        self.lib = get_lib()
        self.max_packet = int(max_packet)
        self.port = int(port)
        self.handle = self.lib.lsd_udp_open(port, self.max_packet)
        if self.handle < 0:
            raise OSError(f"failed to open UDP port {port}: {self.handle}")

    def pop(self, max_packets: int = 256) -> Tuple[np.ndarray, np.ndarray]:
        buf = np.zeros((max_packets, self.max_packet), np.uint8)
        lens = np.zeros(max_packets, np.uint32)
        n = self.lib.lsd_udp_pop(self.handle, buf.ctypes.data, lens.ctypes.data,
                                 max_packets)
        return buf[:max(n, 0)], lens[:max(n, 0)]

    def stats(self) -> Tuple[int, int]:
        dropped = ctypes.c_uint64(0)
        received = self.lib.lsd_udp_stats(self.handle, ctypes.byref(dropped))
        return int(received), int(dropped.value)

    def start_relay(self, dest_ip: str, dest_port: int) -> None:
        """Mirror every received datagram to dest (the reference's
        'package transfer', lidar_driver.cpp startPackageTransfer)."""
        rc = self.lib.lsd_udp_relay(self.handle, dest_ip.encode(),
                                    int(dest_port))
        if rc != 0:
            raise OSError(f"relay to {dest_ip}:{dest_port} failed ({rc})")

    def stop_relay(self) -> None:
        self.lib.lsd_udp_relay(self.handle, b"", 0)

    def close(self) -> None:
        if self.handle >= 0:
            self.lib.lsd_udp_close(self.handle)
            self.handle = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_vlp16(packets: np.ndarray, lens: np.ndarray,
                 max_points: int = 60000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_vlp16(packets.ctypes.data, lens.ctypes.data,
                             len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                             out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_custom(packets: np.ndarray, lens: np.ndarray,
                  max_points: int = 200000) -> Tuple[np.ndarray, int]:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    stamp = ctypes.c_uint64(0)
    n = lib.lsd_decode_custom(packets.ctypes.data, lens.ctypes.data,
                              len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                              out.ctypes.data, max_points, ctypes.byref(stamp))
    return out[:max(n, 0)], int(stamp.value)


def decode_rs16(packets: np.ndarray, lens: np.ndarray,
                max_points: int = 60000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_rs16(packets.ctypes.data, lens.ctypes.data,
                            len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                            out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_livox(packets: np.ndarray, lens: np.ndarray,
                 max_points: int = 200000) -> Tuple[np.ndarray, int]:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    stamp = ctypes.c_uint64(0)
    n = lib.lsd_decode_livox(packets.ctypes.data, lens.ctypes.data,
                             len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                             out.ctypes.data, max_points, ctypes.byref(stamp))
    return out[:max(n, 0)], int(stamp.value)


def ouster_beam_tables(n_beams: int = 64, fov_deg: float = 45.0):
    """Default uniform beam tables (real sensors supply these in their
    metadata JSON; pass those instead for calibrated output)."""
    alt = np.linspace(fov_deg / 2, -fov_deg / 2, n_beams).astype(np.float32)
    az = np.zeros(n_beams, np.float32)
    return alt, az


def decode_ouster(packets: np.ndarray, lens: np.ndarray,
                  beam_alt_deg: Optional[np.ndarray] = None,
                  beam_az_deg: Optional[np.ndarray] = None,
                  n_beams: int = 64, max_points: int = 200000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    if beam_alt_deg is None or beam_az_deg is None:
        beam_alt_deg, beam_az_deg = ouster_beam_tables(n_beams)
    alt = np.ascontiguousarray(beam_alt_deg, np.float32)
    az = np.ascontiguousarray(beam_az_deg, np.float32)
    n_beams = len(alt)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_ouster(packets.ctypes.data, lens.ctypes.data,
                              len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                              n_beams, alt.ctypes.data, az.ctypes.data,
                              out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_lsc16(packets: np.ndarray, lens: np.ndarray,
                 max_points: int = 60000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_lsc16(packets.ctypes.data, lens.ctypes.data,
                             len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                             out.ctypes.data, max_points)
    return out[:max(n, 0)]


def _int_table(t) -> Tuple[Optional[np.ndarray], Optional[int]]:
    if t is None:
        return None, None
    arr = np.ascontiguousarray(t, np.int32)
    return arr, arr.ctypes.data


def decode_rs32(packets: np.ndarray, lens: np.ndarray,
                vert_cd=None, horiz_cd=None,
                max_points: int = 120000) -> np.ndarray:
    """vert_cd/horiz_cd: optional per-channel calibration, centidegrees."""
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    v_arr, v_ptr = _int_table(vert_cd)
    h_arr, h_ptr = _int_table(horiz_cd)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_rs32(packets.ctypes.data, lens.ctypes.data,
                            len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                            v_ptr, h_ptr, out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_rs_ruby(packets: np.ndarray, lens: np.ndarray,
                   vert_cd=None, horiz_cd=None,
                   max_points: int = 200000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    v_arr, v_ptr = _int_table(vert_cd)
    h_arr, h_ptr = _int_table(horiz_cd)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_rs_ruby(packets.ctypes.data, lens.ctypes.data,
                               len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                               v_ptr, h_ptr, out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_rs_helios(packets: np.ndarray, lens: np.ndarray,
                     n_lasers: int = 32, vert_cd=None, horiz_cd=None,
                     max_points: int = 120000) -> np.ndarray:
    """n_lasers 32 (Helios) or 16 (Helios-16P).  Exact per-unit angles come
    from the sensor's DIFOP stream (port+1); pass them via vert_cd/horiz_cd
    in centidegrees, else factory-default ladders are used."""
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    v_arr, v_ptr = _int_table(vert_cd)
    h_arr, h_ptr = _int_table(horiz_cd)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_rs_helios(packets.ctypes.data, lens.ctypes.data,
                                 len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                                 n_lasers, v_ptr, h_ptr,
                                 out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_rs_m1(packets: np.ndarray, lens: np.ndarray,
                 max_points: int = 120000) -> np.ndarray:
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_rs_m1(packets.ctypes.data, lens.ctypes.data,
                             len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                             out.ctypes.data, max_points)
    return out[:max(n, 0)]


def decode_ouster_v3(packets: np.ndarray, lens: np.ndarray,
                     rings: int = 128,
                     beam_alt_deg: Optional[np.ndarray] = None,
                     beam_az_deg: Optional[np.ndarray] = None,
                     beam_to_lidar_mm: float = 15.806,
                     z_offset: float = 0.0,
                     max_points: int = 300000) -> np.ndarray:
    """RNG19_RFL8_SIG16_NIR16 (v3 firmware) single-return profile."""
    lib = get_lib()
    packets = np.ascontiguousarray(packets, np.uint8)
    lens = np.ascontiguousarray(lens, np.uint32)
    if beam_alt_deg is None or beam_az_deg is None:
        beam_alt_deg, beam_az_deg = ouster_beam_tables(rings)
    alt = np.ascontiguousarray(beam_alt_deg, np.float32)
    az = np.ascontiguousarray(beam_az_deg, np.float32)
    rings = len(alt)
    out = np.zeros((max_points, 4), np.float32)
    n = lib.lsd_decode_ouster_v3(packets.ctypes.data, lens.ctypes.data,
                                 len(lens), packets.shape[1] if packets.ndim == 2 else _MAX_PACKET,
                                 rings, alt.ctypes.data, az.ctypes.data,
                                 beam_to_lidar_mm, z_offset,
                                 out.ctypes.data, max_points)
    return out[:max(n, 0)]


OUSTER_PACKET_BYTES = {64: 16 * (16 + 64 * 12 + 4),
                       128: 16 * (16 + 128 * 12 + 4)}
OUSTER_V3_PACKET_BYTES = {32: 32 + 16 * (12 + 32 * 12),
                          64: 32 + 16 * (12 + 64 * 12),
                          128: 32 + 16 * (12 + 128 * 12)}

# Max UDP payload per decoder (receiver ring slot size); anything absent
# fits the 2048-byte default.
DECODER_MAX_PACKET = {
    "Ouster-OS1": OUSTER_PACKET_BYTES[64] + 64,
    "Ouster-OS1-128": OUSTER_PACKET_BYTES[128] + 64,
    "Ouster-OS2-128": OUSTER_PACKET_BYTES[128] + 64,
    "Ouster-OS1-32-v3": OUSTER_V3_PACKET_BYTES[32] + 64,
    "Ouster-OS1-64-v3": OUSTER_V3_PACKET_BYTES[64] + 64,
    "Ouster-OS1-128-v3": OUSTER_V3_PACKET_BYTES[128] + 64,
    "Custom": 65536,
}

# Registry keyed by the reference's cfg lidar names
# (cfg/board_cfg_all.yaml lidar_all; lidar_driver.h:38-52 LidarType).
DECODERS = {
    "VLP-16": lambda pk, ln: (decode_vlp16(pk, ln), 0),
    "LS-C-16": lambda pk, ln: (decode_lsc16(pk, ln), 0),
    "RS-16": lambda pk, ln: (decode_rs16(pk, ln), 0),
    "RS-32": lambda pk, ln: (decode_rs32(pk, ln), 0),
    "RS-Ruby-Lite": lambda pk, ln: (decode_rs_ruby(pk, ln), 0),
    "RS-Helios": lambda pk, ln: (decode_rs_helios(pk, ln, n_lasers=32), 0),
    "RS-Helios-16P": lambda pk, ln: (decode_rs_helios(pk, ln, n_lasers=16), 0),
    "RS-M1": lambda pk, ln: (decode_rs_m1(pk, ln), 0),
    "Livox-Mid-360": lambda pk, ln: decode_livox(pk, ln),
    "Ouster-OS1": lambda pk, ln: (decode_ouster(pk, ln, n_beams=64), 0),
    "Ouster-OS1-128": lambda pk, ln: (decode_ouster(pk, ln, n_beams=128), 0),
    "Ouster-OS2-128": lambda pk, ln: (decode_ouster(pk, ln, n_beams=128), 0),
    "Ouster-OS1-32-v3": lambda pk, ln: (decode_ouster_v3(pk, ln, rings=32), 0),
    "Ouster-OS1-64-v3": lambda pk, ln: (decode_ouster_v3(pk, ln, rings=64), 0),
    "Ouster-OS1-128-v3": lambda pk, ln: (decode_ouster_v3(pk, ln, rings=128), 0),
    "Custom": lambda pk, ln: decode_custom(pk, ln),
}


def points_postprocess(points: np.ndarray, T: Optional[np.ndarray] = None,
                       range_min: float = 0.0, range_max: float = 1e9,
                       exclude_box: Optional[np.ndarray] = None) -> np.ndarray:
    lib = get_lib()
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 4).copy()
    # keep array refs alive across the call (ctypes.data alone does not)
    T_arr = np.ascontiguousarray(T, np.float32) if T is not None else None
    E_arr = (np.ascontiguousarray(exclude_box, np.float32)
             if exclude_box is not None else None)
    n = lib.lsd_points_postprocess(
        pts.ctypes.data, len(pts),
        T_arr.ctypes.data if T_arr is not None else None,
        range_min, range_max,
        E_arr.ctypes.data if E_arr is not None else None)
    return pts[:max(n, 0)]
