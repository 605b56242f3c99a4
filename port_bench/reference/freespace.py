"""Freespace (BEV drivable-area) output path.

A numpy-only copy of ``lsd_tpu/detection/freespace.py``; the port imports
nothing of the JAX package.

The reference's detection model carries a BEV segmentation head
(sensor_inference/pytorch_model/object_model/segment_head_bev.py) whose
grid is shipped as a ``Freespace`` protobuf (proto/detection.proto
FreespaceInfo/Freespace; serialized in proto_serialize.py).  This converts
our CenterHead ``seg`` logits map into the same wire structure.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def seg_to_freespace(seg_logits: np.ndarray, pc_range, cell_resolution: float,
                     threshold: float = 0.5, z_min: float = -0.5,
                     z_max: float = 2.0) -> Dict:
    """seg_logits (H, W) or (H, W, 1) -> Freespace dict for
    proto.detection.serialize_detection."""
    seg = np.asarray(seg_logits, np.float32)
    if seg.ndim == 3:
        seg = seg[..., 0]
    prob = 1.0 / (1.0 + np.exp(-seg))
    cells = (prob >= threshold).astype(np.uint8)
    H, W = cells.shape
    return dict(
        x_min=float(pc_range[0]), x_max=float(pc_range[3]),
        y_min=float(pc_range[1]), y_max=float(pc_range[4]),
        z_min=float(z_min), z_max=float(z_max),
        resolution=float(cell_resolution),
        x_num=int(W), y_num=int(H),
        cells=cells.tobytes(),
    )
