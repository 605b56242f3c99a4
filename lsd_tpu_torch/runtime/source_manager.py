"""Multi-sensor source façade (a copy of ``lsd_tpu/runtime/source_manager.py``
for the port).

Re-derivation of module/source/source_manager.py: one "Source" module
that owns the player (offline) or the per-sensor sub-sources (online) —
lidar UDP capture, cameras, radar CAN, INS — and merges their per-frame
contributions into a single data_dict per frame period, stamped with
`frame_timestamp_monotonic` and `timestep` (source_manager.get_data:66-91).

The main sensor is the lidar when configured (its scan framing paces the
pipeline); otherwise the camera; otherwise a wall-clock ticker. The INS
is a service source: each frame calls `trigger(ts)` for the interpolated
pose / motion / IMU batch (the reference InsDriver trigger semantics).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from .modules import PlayerSource
from .pipeline import Module


class SourceManager(Module):
    def __init__(self, cfg):
        super().__init__("Source")
        self.cfg = cfg
        self.offline = getattr(getattr(cfg, "input", None), "mode",
                               "offline") == "offline"
        self.player: Optional[PlayerSource] = None
        self.lidar = None
        self.camera = None
        self.radar = None
        self.ins = None
        if self.offline:
            self.player = PlayerSource(cfg)
        self.period = 1.0 / float(getattr(getattr(cfg, "input", {}),
                                          "scan_hz", 10.0))
        self._next_t = None

    # ------------------------------------------------------------------
    def setup(self, cfg) -> None:
        if self.offline:
            self.player.setup(cfg)
            return
        if getattr(cfg, "lidar", None):
            from .lidar_source import LidarSource
            self.lidar = LidarSource(cfg)
            self.lidar.setup(cfg)
        if getattr(cfg, "camera", None):
            from .camera_source import CameraSource
            self.camera = CameraSource(cfg)
            self.camera.setup(cfg)
        radar_cfg = getattr(cfg, "radar", None)
        if radar_cfg and any(r.get("use", True) if isinstance(r, dict)
                             else True for r in radar_cfg):
            from .aux_sources import RadarSource
            reader = None
            device = next((r.get("device") for r in radar_cfg
                           if isinstance(r, dict) and r.get("device")), None)
            if device:
                from ..sensors.can_bus import open_can_reader
                reader = open_can_reader(str(device))
            self.radar = RadarSource(cfg, can_reader=reader)
            self.radar.setup(cfg)
        ins_cfg = getattr(cfg, "ins", None)
        if ins_cfg is not None and getattr(ins_cfg, "use", False):
            from .aux_sources import InsSource
            self.ins = InsSource(cfg)
            self.ins.setup(cfg)

    def release(self) -> None:
        for sub in (self.player, self.lidar, self.camera, self.radar,
                    self.ins):
            if sub is not None:
                sub.release()

    # ------------------------------------------------------------------
    def get_data(self) -> Optional[Dict]:
        if self.offline:
            return self.player.get_data()

        if self.lidar is not None:
            d = self.lidar.get_data()
            if d is None:
                return None
        else:
            # no lidar: wall-clock framing
            now = time.monotonic()
            if self._next_t is None:
                self._next_t = now
            wait = self._next_t - now
            if wait > 0:
                time.sleep(wait)
            self._next_t = (self._next_t or now) + self.period
            ts = int(time.monotonic() * 1e6)
            d = dict(frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
                     points={}, points_attr={}, image={}, image_param={},
                     lidar_valid=False, image_valid=False, radar_valid=False,
                     ins_valid=False, ins_data={}, motion_valid=False,
                     timestep=int(self.period * 1e6), _source="Source")

        ts = d["frame_start_timestamp"]
        # cameras: grab the freshest frame from every unit inline (no
        # per-camera pacing — the main sensor paces)
        if self.camera is not None:
            for u in self.camera.units:
                jpg = u.grab()
                if jpg is not None:
                    d["image"][u.name] = jpg
                    d["image_param"][u.name] = u.params()
            d["image_valid"] = bool(d["image"])
        # radar: drain whatever arrived during this frame period
        if self.radar is not None:
            if self.radar.can_reader is not None:
                for (cid, data) in self.radar.can_reader():
                    self.radar.feed(cid, data)
            if self.radar.latest is not None:
                _, objs = self.radar.latest
                self.radar.latest = None
                d["radar"] = {"ARS408": [vars(o) for o in objs]}
                d["radar_valid"] = True
        # INS: per-frame trigger -> interpolated pose + motion + imu batch
        if self.ins is not None:
            trig = self.ins.trigger(ts)
            d["ins_valid"] = trig["ins_valid"]
            d["ins_data"] = trig["ins_data"]
            d["imu_data"] = trig.get("imu")
            d["motion_t"] = trig.get("motion")
            d["motion_valid"] = trig.get("motion_valid", False)
        d["_source"] = "Source"
        return d
