"""Raw serial port via termios — the INS vendor transport
(a copy of ``lsd_tpu/sensors/serial_port.py`` for the port).

Re-derivation of the reference's serial ingest
(sensor_driver/ins_driver/src/ins_driver.cpp:385-438: open at 230400,
append available bytes to a parse buffer, reopen on error) without
pyserial (not in the image): POSIX termios + os file descriptors.
"""
from __future__ import annotations

import os
import select
import termios
from typing import Optional

_BAUD = {
    9600: termios.B9600,
    19200: termios.B19200,
    38400: termios.B38400,
    57600: termios.B57600,
    115200: termios.B115200,
    230400: termios.B230400,
    460800: getattr(termios, "B460800", termios.B230400),
    921600: getattr(termios, "B921600", termios.B230400),
}


class SerialPort:
    """8N1 raw-mode serial port with timeout reads."""

    def __init__(self, device: str, baud: int = 230400,
                 timeout_s: float = 0.1):
        self.device = device
        self.baud = baud
        self.timeout_s = timeout_s
        self.fd: Optional[int] = None

    def open(self) -> None:
        fd = os.open(self.device, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        attrs = termios.tcgetattr(fd)
        iflag, oflag, cflag, lflag, ispeed, ospeed, cc = attrs
        speed = _BAUD.get(self.baud, termios.B230400)
        # raw mode: no echo/canonical/signals, 8 data bits, no parity,
        # 1 stop bit, no flow control
        iflag &= ~(termios.IGNBRK | termios.BRKINT | termios.PARMRK |
                   termios.ISTRIP | termios.INLCR | termios.IGNCR |
                   termios.ICRNL | termios.IXON | termios.IXOFF)
        oflag &= ~termios.OPOST
        lflag &= ~(termios.ECHO | termios.ECHONL | termios.ICANON |
                   termios.ISIG | termios.IEXTEN)
        cflag &= ~(termios.CSIZE | termios.PARENB | termios.CSTOPB)
        cflag |= termios.CS8 | termios.CREAD | termios.CLOCAL
        cc[termios.VMIN] = 0
        cc[termios.VTIME] = 0
        termios.tcsetattr(fd, termios.TCSANOW,
                          [iflag, oflag, cflag, lflag, speed, speed, cc])
        termios.tcflush(fd, termios.TCIOFLUSH)
        self.fd = fd

    @property
    def is_open(self) -> bool:
        return self.fd is not None

    def read(self, max_bytes: int = 4096) -> bytes:
        """Block up to timeout_s for data; returns b'' on timeout."""
        if self.fd is None:
            raise OSError("serial port not open")
        r, _, _ = select.select([self.fd], [], [], self.timeout_s)
        if not r:
            return b""
        try:
            return os.read(self.fd, max_bytes)
        except BlockingIOError:
            return b""

    def write(self, data: bytes) -> int:
        if self.fd is None:
            raise OSError("serial port not open")
        return os.write(self.fd, data)

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()
