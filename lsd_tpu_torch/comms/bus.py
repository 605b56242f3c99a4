"""Local pub/sub message bus — the ZeroCM replacement (a copy of
``lsd_tpu/comms/bus.py`` for the port, but for the registry's place: see
``_registry_dir``).

The reference's observability backbone is ZeroCM over ``ipc://zcm_core``
(sensor_driver/common_lib/logging/InterProcess.{h,cpp}, PUBLISH_MSG macro):
every native/python component publishes typed messages (imu_raw, ins_raw,
slam.odometry, ...) and TViz subscribes to ``.*``.

Transport here: broker-less loopback UDP fan-out.  Each subscriber binds
its own ephemeral 127.0.0.1 port and registers it in a filesystem registry
(the temporary directory, keyed by bus name + pid); publishers scan the registry (cached) and
send a copy to every live subscriber — the same N-consumer delivery model
as zcm's udpm, but containers-safe (multicast loopback often isn't
routable in sandboxes).  Datagrams: [u16 channel_len][channel utf8][payload].
"""
from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import time
from typing import Callable, List, Optional

DEFAULT_BUS = "core"


def _registry_dir(bus: str) -> str:
    """``lsd_tpu_bus_<bus>`` in the temporary directory: ``/tmp``, as the
    reference has it, unless ``TMPDIR`` names another."""
    d = os.path.join(tempfile.gettempdir(), f"lsd_tpu_bus_{bus}")
    os.makedirs(d, exist_ok=True)
    return d


class Publisher:
    def __init__(self, bus: str = DEFAULT_BUS):
        self.bus = bus
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._lock = threading.Lock()
        self._targets: List[int] = []
        self._scan_time = 0.0

    def _scan(self) -> List[int]:
        now = time.monotonic()
        if now - self._scan_time < 0.5 and self._targets:
            return self._targets
        targets = []
        d = _registry_dir(self.bus)
        for name in os.listdir(d):
            try:
                pid_s, port_s = name.split("_")
                pid, port = int(pid_s), int(port_s)
            except ValueError:
                continue
            try:
                os.kill(pid, 0)
            except (ProcessLookupError, PermissionError):
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass
                continue
            targets.append(port)
        self._targets = targets
        self._scan_time = now
        return targets

    def publish(self, channel: str, payload: bytes) -> None:
        ch = channel.encode()
        msg = struct.pack("<H", len(ch)) + ch + bytes(payload)
        with self._lock:
            for port in self._scan():
                try:
                    self.sock.sendto(msg, ("127.0.0.1", port))
                except OSError:
                    pass

    def invalidate(self) -> None:
        self._scan_time = 0.0


class Subscriber:
    """Wildcard subscriber: callback(channel, payload) on its own thread."""

    def __init__(self, callback: Callable[[str, bytes], None],
                 bus: str = DEFAULT_BUS):
        self.callback = callback
        self.bus = bus
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._reg = os.path.join(_registry_dir(bus), f"{os.getpid()}_{self.port}")
        with open(self._reg, "w") as f:
            f.write("")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="BusSub",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < 2:
                continue
            (ln,) = struct.unpack_from("<H", data, 0)
            if 2 + ln > len(data):
                continue
            channel = data[2:2 + ln].decode(errors="replace")
            self.callback(channel, data[2 + ln:])

    def close(self) -> None:
        self._stop.set()
        self._thread.join(1.0)
        self.sock.close()
        try:
            os.unlink(self._reg)
        except OSError:
            pass


class MessageBus:
    """Singleton-ish convenience wrapper (ref get_core())."""

    _instance: Optional["MessageBus"] = None
    _lock = threading.Lock()

    def __init__(self, bus: str = DEFAULT_BUS):
        self.name = bus
        self.pub = Publisher(bus)
        self.enabled = True

    @classmethod
    def core(cls) -> "MessageBus":
        with cls._lock:
            if cls._instance is None:
                cls._instance = MessageBus()
            return cls._instance

    def set_enabled(self, on: bool) -> None:
        """Runtime toggle (ref perception.py ipc_enable / set_core_enable)."""
        self.enabled = bool(on)

    def publish(self, channel: str, payload: bytes) -> None:
        if self.enabled:
            self.pub.publish(channel, payload)

    def subscribe(self, callback) -> Subscriber:
        sub = Subscriber(callback, bus=self.name)
        self.pub.invalidate()   # pick up the new subscriber immediately
        return sub
