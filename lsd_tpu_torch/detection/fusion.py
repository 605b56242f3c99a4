"""Timestamp-aligned fusion of detection streams
(a copy of ``lsd_tpu/detection/fusion.py`` for the port).

Re-derivation of sensor_fusion/fusion.py:3-59 — merge asynchronous result
streams (LiDAR objects, camera trafficlights) onto a common frame by
timestamp proximity, carrying the freshest compatible auxiliary result.
"""
from __future__ import annotations

from typing import Dict, Optional


class FrameFusion:
    def __init__(self, max_age_us: int = 500000):
        self.max_age_us = max_age_us
        self.last_aux: Optional[Dict] = None

    def push_aux(self, result: Dict) -> None:
        """Feed an auxiliary-stream result (e.g. trafficlight)."""
        self.last_aux = result

    def fuse(self, main: Dict) -> Dict:
        """Attach the freshest auxiliary result to the main frame result."""
        out = dict(main)
        ts = int(main.get("timestamp", 0))
        if self.last_aux is not None:
            age = abs(ts - int(self.last_aux.get("timestamp", 0)))
            if age <= self.max_age_us:
                for k, v in self.last_aux.items():
                    if k not in ("timestamp",):
                        out.setdefault(k, v)
        return out
