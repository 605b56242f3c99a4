"""Detection average precision (counterpart of ``lsd_tpu/detection/eval.py:24-170``).

- ``ap_3d``            single-class average precision at a 3D-IoU threshold
                       (greedy highest-score-first matching per frame,
                       all-point interpolation)
- ``ap_2d``            the same over axis-aligned xyxy image boxes
                       (``:97-136``, the camera and traffic-light metric)
- ``evaluate_frames``  per-class AP over a sequence of frames

3D boxes are [x, y, z, dx, dy, dz, heading] rows; their IoU is the port's
``ops/iou3d.boxes_iou3d``, taken on the CPU (the numbers are host data).
The MOT metrics are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.iou3d import boxes_iou3d


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return boxes_iou3d(f(a), f(b)).numpy()


def _iou2d_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Axis-aligned xyxy IoU (camera 2D detection)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return (inter / np.clip(area_a[:, None] + area_b[None, :] - inter,
                            1e-6, None)).astype(np.float32)


def _ap(pred_boxes, pred_scores, gt_boxes, iou_thresh: float, width: int, iou_matrix
        ) -> Dict[str, float]:
    """AP over a sequence of frames of ``width``-wide box rows, matched by
    ``iou_matrix``: greedy highest-score-first matching per frame at the
    IoU gate; the area under the interpolated precision-recall curve.
    Returns dict(ap, precision@all, recall@all, n_gt, n_pred)."""
    records: List[Tuple[float, bool]] = []      # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        pb = np.asarray(pb, np.float32).reshape(-1, width)
        ps = np.asarray(ps, np.float32).reshape(-1)
        gb = np.asarray(gb, np.float32).reshape(-1, width)
        n_gt += len(gb)
        if not len(pb):
            continue
        order = np.argsort(-ps)
        iou = iou_matrix(pb, gb)
        taken = np.zeros(len(gb), bool)
        for i in order:
            j = -1
            if len(gb):
                cand = np.where(~taken, iou[i], -1.0)
                j = int(cand.argmax())
                if cand[j] < iou_thresh:
                    j = -1
            if j >= 0:
                taken[j] = True
                records.append((float(ps[i]), True))
            else:
                records.append((float(ps[i]), False))
    if not records or n_gt == 0:
        return dict(ap=0.0, precision=0.0, recall=0.0, n_gt=n_gt,
                    n_pred=len(records))
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([not r[1] for r in records])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # all-point interpolation: precision envelope integrated over recall
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    ap = float(np.sum(np.diff(np.concatenate([[0.0], recall])) * prec_env))
    return dict(ap=ap, precision=float(precision[-1]),
                recall=float(recall[-1]), n_gt=int(n_gt),
                n_pred=len(records))


def ap_3d(pred_boxes: Sequence[np.ndarray], pred_scores: Sequence[np.ndarray],
          gt_boxes: Sequence[np.ndarray], iou_thresh: float = 0.7
          ) -> Dict[str, float]:
    """AP over a sequence of frames (lists index frames) of 3D boxes at a
    3D-IoU gate.  Returns dict(ap, precision@all, recall@all, n_gt, n_pred)."""
    return _ap(pred_boxes, pred_scores, gt_boxes, iou_thresh, 7, _iou_matrix)


def ap_2d(pred_boxes: Sequence[np.ndarray], pred_scores: Sequence[np.ndarray],
          gt_boxes: Sequence[np.ndarray], iou_thresh: float = 0.5
          ) -> Dict[str, float]:
    """2D AP over frames of xyxy boxes (the camera/trafficlight metric);
    same greedy matching + all-point interpolation as ap_3d."""
    return _ap(pred_boxes, pred_scores, gt_boxes, iou_thresh, 4, _iou2d_matrix)


def evaluate_frames(frames: Sequence[Dict], iou_thresh: Dict[int, float]
                    | float = 0.7) -> Dict[int, Dict[str, float]]:
    """Per-class AP over frames of {boxes, scores, labels, gt_boxes,
    gt_labels}.  iou_thresh may be per-class (WOD uses 0.7 vehicle /
    0.5 pedestrian + cyclist)."""
    labels = set()
    for f in frames:
        labels |= set(np.asarray(f.get("gt_labels", []), np.int64).tolist())
        labels |= set(np.asarray(f.get("labels", []), np.int64).tolist())
    out = {}
    for lbl in sorted(labels):
        pb, ps, gb = [], [], []
        for f in frames:
            pl = np.asarray(f.get("labels", []), np.int64)
            gl = np.asarray(f.get("gt_labels", []), np.int64)
            boxes = np.asarray(f.get("boxes", np.zeros((0, 7)))).reshape(-1, 7)
            scores = np.asarray(f.get("scores", np.zeros(0))).reshape(-1)
            gts = np.asarray(f.get("gt_boxes", np.zeros((0, 7)))).reshape(-1, 7)
            pb.append(boxes[pl == lbl] if len(boxes) else boxes)
            ps.append(scores[pl == lbl] if len(scores) else scores)
            gb.append(gts[gl == lbl] if len(gts) else gts)
        t = iou_thresh.get(lbl, 0.7) if isinstance(iou_thresh, dict) \
            else iou_thresh
        out[int(lbl)] = ap_3d(pb, ps, gb, iou_thresh=t)
    return out
