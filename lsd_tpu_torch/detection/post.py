"""Detection post-processing: per-class thresholds, then one class-agnostic
NMS with a fixed output budget (counterpart of ``lsd_tpu/detection/post.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.iou3d import nms_bev
from ..utils.device import to_device
from ..utils.spans import span


class PostProcessConfig(NamedTuple):
    score_thresh: Tuple[float, ...] = (0.3, 0.35, 0.35)   # per class
    nms_iou: float = 0.1
    max_objects: int = 128


def postprocess(cfg: PostProcessConfig, boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K, 7), (K,), (K,) int, (K,) -> the top ``max_objects`` after the
    thresholds and NMS: (boxes, scores, labels, keep)."""
    with span("detect/nms"):
        table = to_device(np.asarray(cfg.score_thresh, np.float32), scores.device)
        thresh = table[torch.clamp(labels, 0, len(cfg.score_thresh) - 1)]
        ok = mask & (scores >= thresh)
        idx, keep = nms_bev(boxes, scores, ok, cfg.nms_iou, cfg.max_objects)
        return boxes[idx], scores[idx], labels[idx], keep
