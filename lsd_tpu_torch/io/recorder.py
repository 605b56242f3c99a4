"""Frame recorder — writes the reference's recording format
(a copy of ``lsd_tpu/io/recorder.py`` for the port).

Mirrors module/sink/frame_sink.py: per-frame pickles named ``%06d.pkl`` in a
timestamped directory, with the active config snapshotted as ``cfg.yaml`` and
optional loop rotation (evict oldest directories when disk budget exceeded,
frame_sink.py:51-61,116-126).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
from typing import Dict, Optional


class FrameRecorder:
    def __init__(self, root: str, cfg_yaml: Optional[str] = None,
                 frames_per_log: int = 18000, max_logs: Optional[int] = None):
        self.root = root
        self.cfg_yaml = cfg_yaml
        self.frames_per_log = frames_per_log
        self.max_logs = max_logs
        self.log_dir: Optional[str] = None
        self.count = 0
        os.makedirs(root, exist_ok=True)

    def _new_log_dir(self) -> str:
        name = datetime.datetime.now().strftime("%Y-%m%d-%H%M-%S")
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)
        if self.cfg_yaml:
            with open(os.path.join(path, "cfg.yaml"), "w") as f:
                f.write(self.cfg_yaml)
        self._evict()
        return path

    def _evict(self) -> None:
        if self.max_logs is None:
            return
        logs = sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))
        while len(logs) >= self.max_logs:
            shutil.rmtree(os.path.join(self.root, logs.pop(0)), ignore_errors=True)

    def write(self, frame_dict: Dict) -> str:
        if self.log_dir is None or self.count >= self.frames_per_log:
            self.log_dir = self._new_log_dir()
            self.count = 0
        path = os.path.join(self.log_dir, "%06d.pkl" % self.count)
        with open(path, "wb") as f:
            f.write(pickle.dumps(frame_dict, protocol=pickle.HIGHEST_PROTOCOL))
        self.count += 1
        return path
