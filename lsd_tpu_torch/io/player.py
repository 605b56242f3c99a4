"""Offline replay of recorded frame pickles
(a copy of ``lsd_tpu/io/player.py`` for the port).

Reads the reference's on-disk recording format (directories of ``%06d.pkl``
frame dicts plus a ``cfg.yaml`` snapshot, written by
module/sink/frame_sink.py:168-192) and yields normalized frame dicts /
typed Frames.  Normalization mirrors the legacy-format fixups of
module/source/player_data_manager.py:148-191 (parse_pickle) so old
recordings replay identically here and in the reference.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np

from .frame import Frame, frame_from_dict


def normalize_frame_dict(d: Dict) -> Dict:
    """Apply the reference's legacy-format normalizations in place."""
    if "frame_timestamp_monotonic" not in d:
        d["frame_timestamp_monotonic"] = d["frame_start_timestamp"]

    if "points_attr" not in d:
        d["points_attr"] = {}
        for name, data in d.get("points", {}).items():
            d["points_attr"][name] = dict(
                timestamp=d["frame_start_timestamp"],
                points_attr=np.zeros((data.shape[0], 2), dtype=np.float32),
            )

    # Ouster device renames (legacy "<idx>Ouster-OSx" -> "<idx>-Ouster-OSx")
    for name in list(d.get("points", {}).keys()):
        for model in ("Ouster-OS1", "Ouster-OS2"):
            if model in name and not name.startswith(name[0] + "-"):
                new = name[0] + "-" + model
                d["points"][new] = d["points"].pop(name)
                if name in d.get("points_attr", {}):
                    d["points_attr"][new] = d["points_attr"].pop(name)

    for _, param in d.get("image_param", {}).items():
        if "timestamp" not in param:
            param["timestamp"] = d["frame_start_timestamp"] + 100000

    if "pose" in d and "area" not in d["pose"]:
        d["pose"]["area"] = None

    if d.get("ins_valid") and "imu_data" not in d and "ins_data" in d:
        i = d["ins_data"]
        d["imu_data"] = np.asarray([[i["timestamp"], i["gyro_x"], i["gyro_y"], i["gyro_z"],
                                     i["acc_x"], i["acc_y"], i["acc_z"]]], dtype=np.float64)

    if "ins_data" in d and d["ins_data"] is not None:
        d["ins_data"].setdefault("Sensor", "GNSS")

    if "motion_valid" not in d:
        d["motion_valid"] = d.get("ins_valid", False)

    d["lidar_valid"] = bool(d.get("points"))
    return d


class FramePlayer:
    """Sequential reader over one or more recording directories."""

    def __init__(self, paths, point_capacity: Optional[int] = None):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                self.files.extend(sorted(glob.glob(os.path.join(p, "*.pkl"))))
            else:
                self.files.append(str(p))
        self.point_capacity = point_capacity
        self.index = 0

    def __len__(self) -> int:
        return len(self.files)

    def seek(self, idx: int) -> None:
        self.index = max(0, min(idx, len(self.files) - 1))

    def read_dict(self, idx: int) -> Dict:
        with open(self.files[idx], "rb") as f:
            return normalize_frame_dict(pickle.loads(f.read()))

    def __iter__(self) -> Iterator[Frame]:
        for i in range(self.index, len(self.files)):
            yield frame_from_dict(self.read_dict(i), self.point_capacity)

    def iter_dicts(self) -> Iterator[Dict]:
        for i in range(self.index, len(self.files)):
            yield self.read_dict(i)
