"""ZCM/LCM UDPM wire transport
(a copy of ``lsd_tpu/comms/zcm_udpm.py`` for the port).

The reference's pub/sub backbone is ZeroCM (SURVEY.md N5), whose UDPM
transport inherits the LCM wire format: little short messages in one
datagram (magic 'LC02'), larger ones fragmented (magic 'LC03').  This
module speaks that exact format so our bus interoperates with stock
LCM/ZCM tooling (lcm-spy, zcm-spy, the reference's TViz subscribers)
over the standard multicast group — or plain UDP for tests.

Frame layouts (network byte order):

    short:    u32 magic=0x4C433032 | u32 seq | channel\\0 | payload
    fragment: u32 magic=0x4C433033 | u32 seq | u32 msg_size |
              u32 fragment_offset | u16 fragment_no | u16 fragments |
              channel\\0 (fragment 0 only) | data

Reference: lcm/lcm_udpm.c in the LCM project (public wire contract);
the reference vendors ZCM with the same transport
(sensor_driver/common_lib/logging/InterProcess.cpp zcm url udpm://).
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

MAGIC_SHORT = 0x4C433032
MAGIC_FRAG = 0x4C433033
DEFAULT_GROUP = "239.255.76.67"
DEFAULT_PORT = 7667
_MTU = 1400


def encode_short(seq: int, channel: str, payload: bytes) -> bytes:
    return (struct.pack(">II", MAGIC_SHORT, seq & 0xFFFFFFFF)
            + channel.encode() + b"\x00" + payload)


def encode_fragments(seq: int, channel: str, payload: bytes,
                     mtu: int = _MTU):
    """-> list of fragment datagrams for a large message."""
    ch = channel.encode() + b"\x00"
    first_cap = mtu - 20 - len(ch)
    rest_cap = mtu - 20
    n_frags = 1
    if len(payload) > first_cap:
        n_frags = 1 + -(-(len(payload) - first_cap) // rest_cap)
    out = []
    off = 0
    for k in range(n_frags):
        cap = first_cap if k == 0 else rest_cap
        chunk = payload[off:off + cap]
        hdr = struct.pack(">IIIIHH", MAGIC_FRAG, seq & 0xFFFFFFFF,
                          len(payload), off, k, n_frags)
        out.append(hdr + (ch if k == 0 else b"") + chunk)
        off += len(chunk)
    return out


def decode_datagram(data: bytes):
    """-> ('short', seq, channel, payload) |
          ('frag', seq, msg_size, offset, frag_no, n_frags, channel|None,
           chunk) | None."""
    if len(data) < 8:
        return None
    magic, seq = struct.unpack_from(">II", data, 0)
    if magic == MAGIC_SHORT:
        z = data.index(b"\x00", 8)
        return ("short", seq, data[8:z].decode(), data[z + 1:])
    if magic == MAGIC_FRAG:
        if len(data) < 20:
            return None
        msg_size, off, frag_no, n_frags = struct.unpack_from(">IIHH", data, 8)
        body = data[20:]
        channel = None
        if frag_no == 0:
            z = body.index(b"\x00")
            channel = body[:z].decode()
            body = body[z + 1:]
        return ("frag", seq, msg_size, off, frag_no, n_frags, channel, body)
    return None


class _Reassembler:
    """Per-sender fragment reassembly (keyed by (addr, seq))."""

    def __init__(self, max_pending: int = 16):
        self.pending: Dict[Tuple, Dict] = {}
        self.max_pending = max_pending

    def feed(self, addr, parsed) -> Optional[Tuple[str, bytes]]:
        (_, seq, msg_size, off, frag_no, n_frags, channel, chunk) = parsed
        key = (addr, seq)
        st = self.pending.get(key)
        if st is None:
            if len(self.pending) >= self.max_pending:
                self.pending.pop(next(iter(self.pending)))
            st = dict(buf=bytearray(msg_size), got=0, n=n_frags,
                      channel=None)
            self.pending[key] = st
        if channel is not None:
            st["channel"] = channel
        st["buf"][off:off + len(chunk)] = chunk
        st["got"] += 1
        if st["got"] >= st["n"] and st["channel"] is not None:
            del self.pending[key]
            return st["channel"], bytes(st["buf"])
        return None


class ZcmUdpmTransport:
    """Publish/subscribe over the LCM/ZCM UDPM wire format.

    address: "udpm:239.255.76.67:7667" joins the standard multicast
    group; "udp:HOST:PORT" sends plain unicast datagrams (tests, and
    point-to-point bridging to the reference's receivers).
    """

    def __init__(self, address: str = f"udpm:{DEFAULT_GROUP}:{DEFAULT_PORT}",
                 ttl: int = 0, recv_port: Optional[int] = None):
        kind, host, port = self._parse(address)
        self.kind, self.group, self.port = kind, host, int(port)
        self.seq = 0
        self._lock = threading.Lock()
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if kind == "udpm":
            self.tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                               ttl)
            self.tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                               1)
        self.rx: Optional[socket.socket] = None
        self._rx_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._handler: Optional[Callable[[str, bytes], None]] = None
        self._reasm = _Reassembler()
        self._recv_port = recv_port

    @staticmethod
    def _parse(address: str):
        kind, rest = address.split(":", 1)
        host, port = rest.rsplit(":", 1)
        return kind, host, port

    # --- publish --------------------------------------------------------
    def publish(self, channel: str, payload: bytes) -> None:
        with self._lock:
            seq = self.seq
            self.seq += 1
        dest = (self.group, self.port)
        if len(payload) + len(channel) + 9 <= _MTU:
            self.tx.sendto(encode_short(seq, channel, payload), dest)
        else:
            for frag in encode_fragments(seq, channel, payload):
                self.tx.sendto(frag, dest)

    # --- subscribe ------------------------------------------------------
    def start_receiver(self, handler: Callable[[str, bytes], None]) -> int:
        self._handler = handler
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        port = self._recv_port if self._recv_port is not None else self.port
        if self.kind == "udpm":
            self.rx.bind(("", port))
            mreq = socket.inet_aton(self.group) + socket.inet_aton("0.0.0.0")
            self.rx.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                               mreq)
        else:
            self.rx.bind((self.group, port))
            port = self.rx.getsockname()[1]
        self.rx.settimeout(0.2)
        self._stop.clear()
        self._rx_thread = threading.Thread(target=self._rx_loop,
                                           name="ZcmUdpmRx", daemon=True)
        self._rx_thread.start()
        return port

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self.rx.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            parsed = decode_datagram(data)
            if parsed is None:
                continue
            if parsed[0] == "short":
                self._handler(parsed[2], parsed[3])
            else:
                done = self._reasm.feed(addr, parsed)
                if done is not None:
                    self._handler(done[0], done[1])

    def close(self) -> None:
        self._stop.set()
        if self._rx_thread:
            self._rx_thread.join(1.0)
            self._rx_thread = None
        if self.rx:
            self.rx.close()
            self.rx = None
        self.tx.close()


def bridge_bus_to_udpm(bus, transport: ZcmUdpmTransport):
    """Forward every MessageBus publish out over UDPM (the reference's
    ZCM broadcast role); returns the subscription for later close."""
    return bus.subscribe(lambda channel, payload:
                         transport.publish(channel, payload))
