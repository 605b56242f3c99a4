"""Radar and INS source modules
(a copy of ``lsd_tpu/runtime/aux_sources.py`` for the port).

Re-derivations of module/source/radar_data_manager.py and
ins_data_manager.py: the radar source drains CAN frames (from any reader
callable — SocketCAN, replay, or test feeds) through the ARS408 parser;
the INS source ingests GPCHC sentences over UDP (the reference's INS
relay/vendor transport), tracks fixes+IMU, and contributes
ins_data/imu_data/motion to frames via ``trigger``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


from ..io.gpchc import parse_gpchc
from ..sensors.ins import InsMotionTracker
from ..sensors.radar import Ars408Parser, RadarObject
from .interface import register_interface
from .pipeline import Module


class RadarSource(Module):
    """Drains (can_id, data) frames from a reader into tracked radar
    object lists (frame dict key 'radar': {name: [objects]})."""

    def __init__(self, cfg, can_reader: Optional[Callable] = None):
        super().__init__("RadarSource")
        self.parser = Ars408Parser()
        self.can_reader = can_reader     # callable -> list[(can_id, bytes)]
        self.latest: Optional[Tuple[int, List[RadarObject]]] = None
        register_interface("radar.get_status",
                           lambda: dict(objects=len(self.latest[1]) if self.latest else 0))

    def feed(self, can_id: int, data: bytes) -> None:
        out = self.parser.feed(can_id, data)
        if out is not None:
            self.latest = out

    def get_data(self) -> Optional[Dict]:
        if self.can_reader is not None:
            for (cid, data) in self.can_reader():
                self.feed(cid, data)
        if self.latest is None:
            time.sleep(0.05)
            return None
        stamp, objs = self.latest
        self.latest = None
        ts = int(time.monotonic() * 1e6)
        return dict(frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
                    points={}, points_attr={}, image={}, image_param={},
                    lidar_valid=False, image_valid=False, radar_valid=True,
                    ins_valid=False, ins_data={}, motion_valid=False,
                    radar={"ARS408": [vars(o) for o in objs]},
                    timestep=100000, _source="RadarSource")


class InsSource(Module):
    """INS ingest (GPCHC over UDP or serial; BDDB0B binary; Livox IMU) +
    per-frame motion trigger.

    Other sources call ``trigger(ts)`` (exported interface ins.trigger) to
    stamp their frames with pose/motion/imu — the reference's InsDriver
    trigger semantics (ins_driver.cpp:258-312).  The serial transport
    mirrors ins_driver.cpp:385-438 (raw termios, reopen on error); binary
    frames are detected per chunk so GPCHC/BDDB0B units work unconfigured."""

    def __init__(self, cfg, port: int = 0, device: str = "",
                 baud: int = 230400):
        super().__init__("InsSource")
        self.tracker = InsMotionTracker()
        self.sock: Optional[socket.socket] = None
        ins_cfg = getattr(cfg, "ins", {})
        self.port = int(getattr(ins_cfg, "port", port) or port)
        self.device = str(getattr(ins_cfg, "device", device) or device)
        self.baud = int(getattr(ins_cfg, "baud", baud) or baud)
        self.serial = None
        self._rx_thread: Optional[threading.Thread] = None
        self._stop_rx = threading.Event()
        self._bin_buf = b""
        self._position_type = 0
        self.last_fix: Optional[Dict] = None
        register_interface("ins.trigger", self.trigger)
        register_interface("ins.get_status",
                           lambda: dict(valid=self.last_fix is not None,
                                        **{k: self.last_fix.get(k, 0) if self.last_fix else 0
                                           for k in ("latitude", "longitude", "heading")}))

    def setup(self, cfg) -> None:
        if self.port:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind(("0.0.0.0", self.port))
            self.sock.settimeout(0.2)
            self.port = self.sock.getsockname()[1]
            self._stop_rx.clear()
            self._rx_thread = threading.Thread(target=self._rx_loop,
                                               name="InsRx", daemon=True)
            self._rx_thread.start()
        elif self.device:
            from ..sensors.serial_port import SerialPort
            self.serial = SerialPort(self.device, self.baud)
            self._stop_rx.clear()
            self._rx_thread = threading.Thread(target=self._serial_loop,
                                               name="InsSerialRx", daemon=True)
            self._rx_thread.start()

    def release(self) -> None:
        self._stop_rx.set()
        if self._rx_thread:
            self._rx_thread.join(1.0)
            self._rx_thread = None
        if self.sock:
            self.sock.close()
            self.sock = None
        if self.serial:
            self.serial.close()
            self.serial = None

    def _rx_loop(self) -> None:
        while not self._stop_rx.is_set():
            try:
                data, _ = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            self.feed_bytes(data)

    def _serial_loop(self) -> None:
        # reopen-on-error loop (ref ins_driver.cpp:390-396)
        while not self._stop_rx.is_set():
            if not self.serial.is_open:
                try:
                    self.serial.open()
                except OSError:
                    time.sleep(1.0)
                    continue
            try:
                data = self.serial.read()
            except OSError:
                self.serial.close()
                continue
            if data:
                self.feed_bytes(data)

    def feed_bytes(self, data: bytes) -> None:
        """Protocol sniffing: Livox IMU (exactly 60-byte datagram), BDDB0B
        binary stream, or ASCII GPCHC lines."""
        from ..io.ins_binary import parse_bddb0b, parse_livox_imu
        if len(data) == 60:
            fix = parse_livox_imu(data)
            if fix is not None:
                self.feed_fix(fix)
                return
        if b"\xbd\xdb\x0b" in data or self._bin_buf:
            self._bin_buf += data
            while True:
                fix, self._bin_buf, self._position_type = parse_bddb0b(
                    self._bin_buf, self._position_type)
                if fix is None:
                    break
                self.feed_fix(fix)
            if len(self._bin_buf) > 4096:
                self._bin_buf = self._bin_buf[-256:]
            return
        for line in data.decode(errors="replace").splitlines():
            self.feed_sentence(line)

    def feed_fix(self, fix: Dict) -> None:
        if not fix.get("imu_only"):
            self.tracker.feed_fix(fix)
        self.tracker.feed_imu(fix["timestamp"],
                              [fix["gyro_x"], fix["gyro_y"], fix["gyro_z"]],
                              [fix["acc_x"], fix["acc_y"], fix["acc_z"]])
        if not fix.get("imu_only"):
            self.last_fix = fix

    def feed_sentence(self, sentence: str) -> None:
        fix = parse_gpchc(sentence)
        if fix is None:
            return
        # feed_fix publishes last_fix only after the tracker ingested it —
        # consumers poll last_fix as the readiness signal (setting it
        # earlier races trigger())
        self.feed_fix(fix)

    def trigger(self, ts_us: int) -> Dict:
        out = self.tracker.trigger(int(ts_us))
        out["ins_data"] = self.last_fix or {}
        out["ins_valid"] = self.last_fix is not None
        return out

    def get_data(self) -> Optional[Dict]:
        # INS is a service source (triggered by others); emit a liveness
        # frame at low rate so the pipeline can carry standalone INS data
        time.sleep(0.1)
        if self.last_fix is None:
            return None
        ts = int(time.monotonic() * 1e6)
        trig = self.trigger(ts)
        return dict(frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
                    points={}, points_attr={}, image={}, image_param={},
                    lidar_valid=False, image_valid=False, radar_valid=False,
                    ins_valid=trig["ins_valid"], ins_data=trig["ins_data"],
                    imu_data=trig["imu"], motion_t=trig["motion"],
                    motion_valid=trig["motion_valid"],
                    timestep=100000, _source="InsSource")
