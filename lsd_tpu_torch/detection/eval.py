"""Detection average precision (counterpart of ``lsd_tpu/detection/eval.py:24-170``).

- ``ap_3d``            single-class average precision at a 3D-IoU threshold
                       (greedy highest-score-first matching per frame,
                       all-point interpolation)
- ``ap_2d``            the same over axis-aligned xyxy image boxes
                       (``:97-136``, the camera and traffic-light metric)
- ``evaluate_frames``  per-class AP over a sequence of frames
- ``evaluate_mot``     AB3DMOT-style MOTA/MOTP and their averages over 40
                       score thresholds (``:172-246``)

3D boxes are [x, y, z, dx, dy, dz, heading] rows; their IoU is the port's
``ops/iou3d.boxes_iou3d``, taken on the CPU (the numbers are host data)
unless ``evaluate_mot`` is given another device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.iou3d import boxes_iou3d
from ..utils.device import DeviceLike, resolve_device, to_device


def _iou_matrix(a: np.ndarray, b: np.ndarray, device: DeviceLike = "cpu") -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    dev = resolve_device(device)
    f = lambda x: to_device(np.asarray(x, np.float32), dev)
    return boxes_iou3d(f(a), f(b)).cpu().numpy()


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


# ---------------------------------------------------------------------------
# MOT metrics (AB3DMOT protocol)


def _mot_once(frames: Sequence[Dict], score_thresh: float,
              iou_gate: float, device: DeviceLike = "cpu") -> Dict[str, float]:
    """One MOTA/MOTP pass at a track-score threshold.

    frames: {track_ids, boxes, scores, gt_ids, gt_boxes} per frame.
    """
    n_gt = 0
    misses = 0
    false_pos = 0
    id_switches = 0
    tp = 0
    iou_sum = 0.0
    last_match: Dict[int, int] = {}             # gt id -> track id
    for f in frames:
        gt_ids = np.asarray(f.get("gt_ids", []), np.int64).reshape(-1)
        gt_boxes = np.asarray(f.get("gt_boxes", np.zeros((0, 7)))).reshape(-1, 7)
        tids = np.asarray(f.get("track_ids", []), np.int64).reshape(-1)
        boxes = np.asarray(f.get("boxes", np.zeros((0, 7)))).reshape(-1, 7)
        scores = np.asarray(f.get("scores", np.ones(len(tids)))).reshape(-1)
        keep = scores >= score_thresh
        tids, boxes = tids[keep], boxes[keep]
        n_gt += len(gt_ids)
        iou = _iou_matrix(gt_boxes, boxes, device)
        # greedy matching, as the reference (AB3DMOT uses Hungarian; greedy
        # at an IoU gate is equivalent for well-separated objects)
        matched_g = np.zeros(len(gt_ids), bool)
        matched_t = np.zeros(len(tids), bool)
        pairs = []
        if iou.size:
            order = np.dstack(np.unravel_index(
                np.argsort(-iou, axis=None), iou.shape))[0]
            for g, t in order:
                if iou[g, t] < iou_gate:
                    break
                if matched_g[g] or matched_t[t]:
                    continue
                matched_g[g] = matched_t[t] = True
                pairs.append((int(gt_ids[g]), int(tids[t]),
                              float(iou[g, t])))
        for gid, tid, v in pairs:
            tp += 1
            iou_sum += v
            if gid in last_match and last_match[gid] != tid:
                id_switches += 1
            last_match[gid] = tid
        misses += int((~matched_g).sum())
        false_pos += int((~matched_t).sum())
    mota = 1.0 - (misses + false_pos + id_switches) / max(n_gt, 1)
    motp = iou_sum / max(tp, 1)
    recall = tp / max(n_gt, 1)
    return dict(mota=mota, motp=motp, recall=recall, ids=id_switches,
                misses=misses, false_pos=false_pos, n_gt=n_gt, tp=tp)


def evaluate_mot(frames: Sequence[Dict], iou_gate: float = 0.5,
                 n_recall_steps: int = 40, device: DeviceLike = "cpu") -> Dict[str, float]:
    """AB3DMOT-style summary: sweep score thresholds over the recall
    range, average MOTA (clamped at 0, scaled by recall — the sAMOTA
    variant simplification) and MOTP.  The IoUs are taken on ``device``."""
    base = _mot_once(frames, score_thresh=-np.inf, iou_gate=iou_gate, device=device)
    scores = np.concatenate([np.asarray(f.get("scores",
                                              np.ones(len(f.get("track_ids", [])))),
                                        np.float32).reshape(-1)
                             for f in frames]) if frames else np.zeros(0)
    if not len(scores):
        return dict(amota=0.0, amotp=0.0, **base)
    thresholds = np.quantile(scores, np.linspace(0.0, 1.0, n_recall_steps,
                                                 endpoint=False))
    motas, motps = [], []
    for t in thresholds:
        m = _mot_once(frames, score_thresh=float(t), iou_gate=iou_gate, device=device)
        motas.append(max(m["mota"], 0.0))
        motps.append(m["motp"])
    return dict(amota=float(np.mean(motas)), amotp=float(np.mean(motps)),
                **base)
