"""Trafficlight detection post-processing + map-based light selection.

A numpy copy of ``lsd_tpu/detection/trafficlight.py``; the port imports
nothing of the JAX package.

Re-derivation of the reference's trafficlight pipeline
(sensor_inference/trafficlight_infer.py:19-83 + utils/
trafficlight_post_process.py + utils/parse_map.py:7-55): the camera
detector proposes light boxes with color/pictogram classes; the HD map
supplies known light positions; the vehicle pose selects which lights are
relevant (distance + field-of-view + projection into the image), and
detections are matched to map lights by projected proximity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# class id -> (color, pictogram) following proto enums
# Color: RED=0 GREEN=1 YELLOW=2 OFF=3 / Pictogram: OTHER=0 UP=1 LEFT=2 RIGHT=3
CLASS_TABLE = [
    (0, 0), (1, 0), (2, 0), (3, 0),   # plain red/green/yellow/off
    (0, 2), (1, 2),                   # left-arrow red/green
    (0, 1), (1, 1),                   # up-arrow red/green
]


@dataclasses.dataclass
class MapLight:
    name: str
    position: np.ndarray        # (3,) world


def select_lights(pose: np.ndarray, lights: Sequence[MapLight],
                  K: np.ndarray, T_cam_from_world: Optional[np.ndarray] = None,
                  image_size=(1920, 1080), max_distance: float = 120.0
                  ) -> List[Dict]:
    """Pick map lights visible from the current pose and project them.

    pose: vehicle 4x4 in world; T_cam_from_world optional explicit camera
    extrinsic (defaults to camera at vehicle pose).  Returns
    [{name, uv, distance}] sorted by distance.
    """
    Tcw = np.linalg.inv(pose) if T_cam_from_world is None else np.asarray(T_cam_from_world)
    W, H = image_size
    out = []
    for l in lights:
        pc = Tcw[:3, :3] @ np.asarray(l.position, float) + Tcw[:3, 3]
        # camera convention: x right, y down, z forward (vehicle x forward ->
        # treat vehicle frame: forward = +x). Accept either by checking both.
        depth = pc[0] if abs(pc[0]) > abs(pc[2]) else pc[2]
        if depth <= 1.0 or depth > max_distance:
            continue
        if abs(pc[0]) > abs(pc[2]):
            cam = np.asarray([-pc[1], -pc[2], pc[0]])  # vehicle -> camera axes
        else:
            cam = pc
        uv_h = np.asarray(K, float) @ cam
        uv = uv_h[:2] / uv_h[2]
        if not (0 <= uv[0] < W and 0 <= uv[1] < H):
            continue
        out.append(dict(name=l.name, uv=uv, distance=float(depth)))
    return sorted(out, key=lambda d: d["distance"])


def match_detections(map_lights: List[Dict], boxes: np.ndarray,
                     scores: np.ndarray, labels: np.ndarray,
                     keep: np.ndarray, max_pixel_dist: float = 150.0
                     ) -> List[Dict]:
    """Associate detector boxes to selected map lights -> Trafficlight dicts
    (proto schema: id/pictogram/color/confidence/name)."""
    out = []
    boxes = np.asarray(boxes, float)
    centers = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                        (boxes[:, 1] + boxes[:, 3]) / 2], axis=-1)
    used = set()
    for li, ml in enumerate(map_lights):
        best, best_d = -1, max_pixel_dist
        for k in range(len(boxes)):
            if not keep[k] or k in used:
                continue
            d = float(np.linalg.norm(centers[k] - ml["uv"]))
            if d < best_d:
                best, best_d = k, d
        if best < 0:
            continue
        used.add(best)
        color, pict = CLASS_TABLE[int(labels[best]) % len(CLASS_TABLE)]
        out.append(dict(id=li, color=color, pictogram=pict,
                        confidence=float(scores[best]), name=ml["name"]))
    return out


# ---------------------------------------------------------------------------
# HD-map loading (OpenDRIVE .xodr signals + GNSS anchor sidecar)


def parse_xodr_signals(file_path: str,
                       name_pattern: str = r"Signal_.Light") -> List[MapLight]:
    """Extract trafficlight signals from an OpenDRIVE map.

    Re-derivation of the reference's map loader (sensor_inference/utils/
    parse_map.py:7-39): every <road><signals><signal> whose name matches
    the pattern contributes its <positionInertial> as a world-frame light;
    name/width/height/orientation userData entries are carried in `attrs`.
    """
    import os
    import re
    import xml.etree.ElementTree as ET

    lights: List[MapLight] = []
    if not os.path.exists(file_path):
        return lights
    root = ET.parse(file_path).getroot()
    for road in root.findall("road"):
        for signals in road.findall("signals"):
            for signal in signals.findall("signal"):
                if not re.match(name_pattern, signal.attrib.get("name", "")):
                    continue
                pos_el = signal.find("positionInertial")
                if pos_el is None:
                    continue
                pos = np.asarray([float(pos_el.attrib.get(k, 0.0))
                                  for k in ("x", "y", "z")])
                name = signal.attrib.get("id", "")
                attrs: Dict[str, str] = {}
                for user in signal.findall("userData"):
                    code = user.attrib.get("code", "")
                    attrs[code] = user.attrib.get("value", "")
                    if code == "name":
                        name = attrs[code]
                light = MapLight(name=name, position=pos)
                light.attrs = attrs          # optional metadata
                lights.append(light)
    return lights


def parse_map_anchor(file_path: str) -> Optional[Dict[str, float]]:
    """GNSS anchor sidecar: 'lat lon alt yaw pitch roll' on one line
    (ref parse_map.py parse_anchor:41-55)."""
    import os
    if not os.path.exists(file_path):
        return None
    with open(file_path) as f:
        vals = f.readline().split()
    keys = ("lat", "lon", "alt", "yaw", "pitch", "roll")
    return {k: float(v) for k, v in zip(keys, vals)}
