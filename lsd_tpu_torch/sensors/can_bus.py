"""SocketCAN transport (Linux AF_CAN raw sockets, no extra deps)
(a copy of ``lsd_tpu/sensors/can_bus.py`` for the port).

The reference reads the ARS408 radar and writes detection obstacle
frames over SocketCAN (hardware/can/, module/sink/can_sink.py).  Python's
stdlib socket supports AF_CAN directly; this module wraps it with the
classic CAN frame layout:

    struct can_frame { u32 can_id; u8 can_dlc; u8 pad[3]; u8 data[8]; }

packed natively as "=IB3x8s" (16 bytes).
"""
from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

CAN_FRAME_FMT = "=IB3x8s"
CAN_FRAME_SIZE = struct.calcsize(CAN_FRAME_FMT)
CAN_EFF_FLAG = 0x80000000


def pack_frame(can_id: int, data: bytes) -> bytes:
    data = bytes(data)[:8]
    return struct.pack(CAN_FRAME_FMT, can_id, len(data),
                       data + b"\x00" * (8 - len(data)))


def unpack_frame(frame: bytes) -> Tuple[int, bytes]:
    can_id, dlc, data = struct.unpack(CAN_FRAME_FMT, frame[:CAN_FRAME_SIZE])
    return can_id, data[:dlc]


def can_available() -> bool:
    return hasattr(socket, "AF_CAN")


class CanSocket:
    """Raw SocketCAN endpoint bound to an interface (can0, vcan0, ...)."""

    def __init__(self, interface: str = "can0", timeout: float = 0.05):
        if not can_available():
            raise OSError("SocketCAN (AF_CAN) unsupported on this platform")
        self.interface = interface
        self.sock = socket.socket(socket.AF_CAN, socket.SOCK_RAW,
                                  socket.CAN_RAW)
        self.sock.bind((interface,))
        self.sock.settimeout(timeout)

    def send(self, can_id: int, data: bytes) -> None:
        self.sock.send(pack_frame(can_id, data))

    def read(self, max_frames: int = 64) -> List[Tuple[int, bytes]]:
        """Drain up to max_frames pending frames; non-blocking-ish."""
        out = []
        for _ in range(max_frames):
            try:
                raw = self.sock.recv(CAN_FRAME_SIZE)
            except (socket.timeout, BlockingIOError):
                break
            except OSError:
                break
            if len(raw) >= CAN_FRAME_SIZE:
                out.append(unpack_frame(raw))
        return out

    def close(self) -> None:
        self.sock.close()

    # the RadarSource takes a `can_reader` callable
    def __call__(self) -> List[Tuple[int, bytes]]:
        return self.read()


def open_can_reader(interface: str) -> Optional[CanSocket]:
    """Best-effort open for source modules: None when the interface or
    AF_CAN is unavailable (mirrors the reference's graceful sensor
    degradation)."""
    try:
        return CanSocket(interface)
    except OSError:
        return None
