"""``ipc://`` pub/sub transport (a copy of ``lsd_tpu/comms/zcm_ipc.py``
for the port) — the reference's ZCM core address
(sensor_driver/common_lib/logging/InterProcess.h:63-74 runs the singleton
core on ``ipc://zcm_core``; the InsDriver→SLAM fast path similarly uses a
unix socket, ins_driver.cpp:59).

TPU-native equivalent: AF_UNIX datagram sockets carrying the SAME
LCM/ZCM LC02/LC03 framing as the UDPM transport (comms/zcm_udpm.py), so a
channel's bytes are identical on either transport.  Fan-out works like
UDPM multicast: every subscriber binds its own abstract-namespace socket
and registers in a directory file; publishers send one datagram per
subscriber (local unix datagrams are ~1 µs; the reference pays the same
O(subscribers) inside zeromq's pub socket).

Address form: ``ipc://zcm_core`` (any name; becomes an abstract-namespace
prefix on Linux, so no filesystem cleanup is needed).
"""
from __future__ import annotations

import json
import os
import socket
import tempfile
import threading
import uuid
from typing import Callable, Optional

from .zcm_udpm import _Reassembler, decode_datagram, encode_fragments, encode_short

_MTU = 60000     # unix datagrams comfortably carry much more than UDP


def _registry_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"lsd_ipc_{name}.json")


class ZcmIpcTransport:
    """Publish/subscribe over unix-domain datagrams with ZCM framing."""

    def __init__(self, address: str = "ipc://zcm_core"):
        assert address.startswith("ipc://")
        self.name = address[len("ipc://"):]
        self.seq = 0
        self._lock = threading.Lock()
        self.tx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.rx: Optional[socket.socket] = None
        self._rx_addr: Optional[str] = None
        self._rx_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._reasm = _Reassembler()
        self._handler: Optional[Callable[[str, bytes], None]] = None

    # --- subscriber registry (directory file of abstract addresses) -----
    def _subscribers(self):
        try:
            with open(_registry_path(self.name)) as f:
                return [a for a in json.load(f) if a != self._rx_addr]
        except (OSError, ValueError):
            return []

    def _register(self, addr: str) -> None:
        path = _registry_path(self.name)
        subs = []
        try:
            with open(path) as f:
                subs = json.load(f)
        except (OSError, ValueError):
            pass
        # drop dead registrations
        alive = []
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        for a in subs:
            try:
                probe.sendto(b"", "\0" + a)
                alive.append(a)
            except OSError:
                pass
        probe.close()
        alive.append(addr)
        tmp = path + f".{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(alive, f)
        os.replace(tmp, path)

    # --- publish ---------------------------------------------------------
    def publish(self, channel: str, payload: bytes) -> None:
        with self._lock:
            seq = self.seq
            self.seq += 1
        if len(payload) + len(channel) + 9 <= _MTU:
            grams = [encode_short(seq, channel, payload)]
        else:
            grams = list(encode_fragments(seq, channel, payload,
                                          mtu=_MTU))
        for addr in self._subscribers():
            try:
                for g in grams:
                    self.tx.sendto(g, "\0" + addr)
            except OSError:
                pass          # dead subscriber; pruned at next register

    # --- subscribe --------------------------------------------------------
    def start_receiver(self, handler: Callable[[str, bytes], None]) -> str:
        self._handler = handler
        self._rx_addr = f"lsd_ipc_{self.name}_{uuid.uuid4().hex[:12]}"
        self.rx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.rx.bind("\0" + self._rx_addr)
        self.rx.settimeout(0.25)
        self._register(self._rx_addr)
        self._stop.clear()
        self._rx_thread = threading.Thread(target=self._rx_loop,
                                           name="zcm-ipc-rx", daemon=True)
        self._rx_thread.start()
        return self._rx_addr

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self.rx.recvfrom(_MTU + 4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                continue
            parsed = decode_datagram(data)
            if parsed is None:
                continue
            if parsed[0] == "short":
                _, _seq, channel, payload = parsed
                out = (channel, payload)
            else:
                out = self._reasm.feed("ipc", parsed)
            if out is not None and self._handler is not None:
                self._handler(out[0], out[1])

    def close(self) -> None:
        self._stop.set()
        if self._rx_thread is not None:
            self._rx_thread.join(1.0)
            self._rx_thread = None
        if self.rx is not None:
            self.rx.close()
            self.rx = None
        self.tx.close()


def make_transport(address: str, **kw):
    """Transport factory: ``ipc://...`` or ``udpm:...``/``udp:...``
    (reference: ZCM core URL selection, InterProcess.cpp)."""
    if address.startswith("ipc://"):
        return ZcmIpcTransport(address)
    from .zcm_udpm import ZcmUdpmTransport
    return ZcmUdpmTransport(address, **kw)
