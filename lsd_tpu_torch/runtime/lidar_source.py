"""Live LiDAR source: native UDP capture -> scan assembly -> frame dicts
(a copy of ``lsd_tpu/runtime/lidar_source.py`` for the port).

Re-derivation of the reference's online lidar path (module/source/
lidar_data_manager.py over sensor_driver/lidar_driver: per-sensor UDP
capture thread, packet decode, scan framing, range/exclude filtering,
extrinsic transform).  Packet capture runs in the C++ receiver
(``native/``); this module assembles scans at a fixed frame period (the
reference frames by azimuth wrap or timer depending on vendor — timer
framing is vendor-neutral) and merges multiple sensors into one frame dict.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .pipeline import Module


class LidarUnit:
    def __init__(self, name: str, port: int, decoder: str,
                 extrinsic: Optional[np.ndarray] = None,
                 range_min: float = 0.5, range_max: float = 150.0,
                 exclude_box: Optional[np.ndarray] = None,
                 max_points: int = 200000):
        from .. import native
        self.name = f"{port}-{decoder}" if name is None else name
        self.decoder_name = decoder
        self.decode = native.DECODERS[decoder]
        self.rx = native.UdpReceiver(
            port, max_packet=native.DECODER_MAX_PACKET.get(decoder, 2048))
        self.native = native
        self.extrinsic = (np.asarray(extrinsic, np.float32)
                          if extrinsic is not None else None)
        self.range_min = range_min
        self.range_max = range_max
        self.exclude_box = (np.asarray(exclude_box, np.float32)
                            if exclude_box is not None else None)
        self.max_points = max_points
        self._chunks: List[np.ndarray] = []
        # RoboSense mechanical units stream per-unit factory angle
        # calibration as DIFOP packets on the data port + 1; once one
        # validates, rebind the decoder with the exact tables
        # (ref rs_decode_difop.cpp ReceiveDifop/Decode)
        self._difop_rx = None
        self.difop_loaded = False
        n_lasers = {"RS-32": 32, "RS-Ruby-Lite": 128,
                    "RS-Helios": 32, "RS-Helios-16P": 16}.get(decoder)
        if n_lasers is not None:
            self._difop_n = n_lasers
            try:
                from ..io.rs_difop import HELIOS_DIFOP_LEN
                self._difop_rx = native.UdpReceiver(
                    port + 1, max_packet=HELIOS_DIFOP_LEN + 64)
            except OSError:
                self._difop_rx = None

    def _poll_difop(self) -> None:
        from ..io.rs_difop import parse_rs_difop
        pk, lens = self._difop_rx.pop(8)
        for buf, ln in zip(pk, lens):
            info = parse_rs_difop(bytes(buf[:ln]), n_lasers=self._difop_n)
            if info is None:
                continue
            vert, horiz = info["vert_cd"], info["horiz_cd"]
            nat, name = self.native, self.decoder_name
            if name == "RS-32":
                self.decode = lambda p, l: (nat.decode_rs32(
                    p, l, vert_cd=vert, horiz_cd=horiz), 0)
            elif name == "RS-Ruby-Lite":
                self.decode = lambda p, l: (nat.decode_rs_ruby(
                    p, l, vert_cd=vert, horiz_cd=horiz), 0)
            else:   # RS-Helios / RS-Helios-16P
                self.decode = lambda p, l: (nat.decode_rs_helios(
                    p, l, n_lasers=self._difop_n,
                    vert_cd=vert, horiz_cd=horiz), 0)
            self.difop_loaded = True
            self._difop_rx.close()
            self._difop_rx = None
            return

    def poll(self) -> None:
        """Drain pending packets into the current scan accumulation."""
        if self._difop_rx is not None:
            self._poll_difop()
        while True:
            pk, lens = self.rx.pop(256)
            if not len(lens):
                return
            pts, _stamp = self.decode(pk, lens)
            if len(pts):
                self._chunks.append(pts)

    def frame(self) -> np.ndarray:
        """Close the current scan: filtered, transformed (N, 4)."""
        if not self._chunks:
            return np.zeros((0, 4), np.float32)
        pts = np.concatenate(self._chunks, axis=0)[: self.max_points]
        self._chunks = []
        return self.native.points_postprocess(
            pts, T=self.extrinsic, range_min=self.range_min,
            range_max=self.range_max, exclude_box=self.exclude_box)

    def close(self) -> None:
        self.rx.close()
        if self._difop_rx is not None:
            self._difop_rx.close()
            self._difop_rx = None


class LidarSource(Module):
    """Online source module: one frame dict per scan period, merging all
    configured lidars (cfg.lidar: [{name, port, decoder/type, ...}])."""

    def __init__(self, cfg):
        super().__init__("Source")
        self.cfg = cfg
        self.units: List[LidarUnit] = []
        self.period = 1.0 / float(getattr(getattr(cfg, "input", {}), "scan_hz", 10.0))
        self._next_t = None

    def setup(self, cfg) -> None:
        for lc in cfg.lidar:
            lc = dict(lc)
            self.units.append(LidarUnit(
                name=lc.get("name"),
                port=int(lc["port"]),
                decoder=lc.get("decoder", lc.get("type", "Custom")),
                extrinsic=lc.get("extrinsic"),
                range_min=float(lc.get("range_min", 0.5)),
                range_max=float(lc.get("range_max", 150.0)),
                exclude_box=lc.get("exclude_box")))
        from .interface import register_interface
        register_interface("lidar.start_package_transfer",
                           self.start_package_transfer)
        register_interface("lidar.stop_package_transfer",
                           self.stop_package_transfer)
        self.logger.info("online lidar source: %d unit(s)",
                         len(self.units))

    def start_package_transfer(self, dest: str) -> None:
        """Mirror every sensor's raw packet stream to `dest` (same ports;
        ref lidar_driver startPackageTransfer, used to feed a second
        host's preview)."""
        for u in self.units:
            u.rx.start_relay(dest, u.rx.port)

    def stop_package_transfer(self) -> None:
        for u in self.units:
            u.rx.stop_relay()

    def release(self) -> None:
        for u in self.units:
            u.close()
        self.units = []

    def get_data(self) -> Optional[Dict]:
        if not self.units:
            time.sleep(0.1)
            return None
        now = time.monotonic()
        if self._next_t is None:
            self._next_t = now + self.period
        # poll packets until the frame period elapses
        while time.monotonic() < self._next_t:
            for u in self.units:
                u.poll()
            time.sleep(0.002)
        self._next_t += self.period

        ts = int(time.monotonic() * 1e6)
        points = {}
        points_attr = {}
        for u in self.units:
            pts = u.frame()
            if len(pts) == 0:
                continue
            points[u.name] = pts
            points_attr[u.name] = dict(
                timestamp=ts, points_attr=np.zeros((len(pts), 2), np.float32))
        if not points:
            return None
        return dict(
            frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
            points=points, points_attr=points_attr,
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=False, ins_data={}, motion_valid=False,
            timestep=int(self.period * 1e6), _source="Source")
