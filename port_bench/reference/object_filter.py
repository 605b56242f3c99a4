"""Output object filtering: class enables + ROI polygons.

A numpy-only copy of ``lsd_tpu/detection/object_filter.py``; the port imports
nothing of the JAX package.

Re-derivation of module/detect/object_filter.py:46-88 — per-class
enable/disable plus include/exclude regions of interest.  Point-in-polygon
is a vectorized numpy ray cast (no shapely dependency).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """(N, 2) x (V, 2) -> (N,) bool, even-odd rule."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), bool)
    v = np.asarray(poly, float)
    j = len(v) - 1
    for i in range(len(v)):
        xi, yi = v[i]
        xj, yj = v[j]
        crosses = ((yi > y) != (yj > y)) & \
                  (x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi)
        inside ^= crosses
        j = i
    return inside


class ObjectFilter:
    def __init__(self, class_enabled: Optional[Sequence[bool]] = None,
                 include_polygons: Optional[List[np.ndarray]] = None,
                 exclude_polygons: Optional[List[np.ndarray]] = None):
        self.class_enabled = class_enabled
        self.include = [np.asarray(p, float) for p in (include_polygons or [])]
        self.exclude = [np.asarray(p, float) for p in (exclude_polygons or [])]

    def filter(self, result: Dict) -> Dict:
        objs = result.get("objects", [])
        keep = []
        for o in objs:
            if self.class_enabled is not None:
                lbl = int(o["label"])
                if lbl < len(self.class_enabled) and not self.class_enabled[lbl]:
                    continue
            xy = np.asarray(o["box"][:2], float)[None, :]
            if self.include and not any(points_in_polygon(xy, p)[0] for p in self.include):
                continue
            if any(points_in_polygon(xy, p)[0] for p in self.exclude):
                continue
            keep.append(o)
        out = dict(result)
        out["objects"] = keep
        return out
