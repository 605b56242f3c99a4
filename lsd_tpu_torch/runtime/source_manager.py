"""Multi-sensor source facade (counterpart of
``lsd_tpu/runtime/source_manager.py``): its offline branch.

Re-derivation of module/source/source_manager.py: one "Source" module
that owns the player (offline) or the per-sensor sub-sources (online).
Offline, every frame comes from the recording through ``PlayerSource``.
The online branch (LiDAR UDP capture, cameras, radar CAN, INS, merged into
one frame dict per period) needs ``lidar_source``, ``camera_source`` and
``aux_sources``, which the port does not have yet (ROADMAP A12c): asking
for it raises.
"""
from __future__ import annotations

from typing import Dict, Optional

from .modules import PlayerSource
from .pipeline import Module


class SourceManager(Module):
    def __init__(self, cfg):
        super().__init__("Source")
        self.cfg = cfg
        self.offline = getattr(getattr(cfg, "input", None), "mode",
                               "offline") == "offline"
        if not self.offline:
            raise NotImplementedError(
                "lsd_tpu_torch has no online sources yet (lidar_source, "
                "camera_source, aux_sources: ROADMAP A12c); set input.mode "
                "to 'offline' and replay a recording")
        self.player = PlayerSource(cfg)

    def setup(self, cfg) -> None:
        self.player.setup(cfg)

    def release(self) -> None:
        self.player.release()

    def get_data(self) -> Optional[Dict]:
        return self.player.get_data()
