"""Training of the traffic-light 2D detector (counterpart of
``lsd_tpu/training/yolo.py:121-271``).

Targets match ``decode_yolo2d``: the cell holding a box's centre is
positive, ``obj`` 1 there, ``cls`` one-hot, ``box`` the log of the
l, t, r, b distances over the stride.  The reference draws them with a
``lax.scan`` over the boxes in order: ``obj`` and ``cls`` by max, ``box``
by a set that the last valid box of a cell wins, masked boxes without
effect.  ``make_yolo_targets`` does the same in one pass over all boxes
on the device: scatter-max for ``obj`` and ``cls`` and
``models.detector.last_wins`` for ``box``.

``yolo_loss`` writes out optax's ``sigmoid_binary_cross_entropy``
(``-y log_sigmoid(x) - (1 - y) log_sigmoid(-x)``) and ``huber_loss``
(``0.5 min(|e|, d)^2 + d (|e| - min(|e|, d))``, d = 1) in their forms.

``YoloTrainer`` trains the port's ``Yolo2D`` (bf16 blocks, float32 heads,
TF32 off for them) on ``camera_data.SyntheticTrafficLightDataset``'s
scenes with the reference's optax chain (clipping at 10, AdamW with weight
decay 1e-4, 100 warmup steps, cosine to ``total_steps``); ``evaluate`` is
``camera_data.yolo2d_frames`` and ``yolo2d_ap`` (decode, ``nms_2d``, AP at
IoU 0.5).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..convert import camera_params_to_flax, load_camera_params
from ..models.detector import as_batch, last_wins
from ..models.mono3d import init_camera_params
from ..models.params_io import load_params, save_params
from ..models.yolo2d import Yolo2D, Yolo2DConfig
from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger
from ..utils.precision import set_slam_precision
from ..utils.spans import span
from .camera_data import yolo2d_ap, yolo2d_frames
from .trainer import Batch, StepTrainer


def make_yolo_targets(cfg: Yolo2DConfig, hw: Tuple[int, int], gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(G, 4) xyxy pixel boxes, labels and mask, or (B, G, ...) -> maps at
    the stride: obj (h, w), cls (h, w, C), box (h, w, 4), with a leading
    B for a batch."""
    one, (gt_boxes, gt_labels, gt_mask) = as_batch(gt_boxes, gt_labels, gt_mask)
    s, C = cfg.stride, cfg.num_classes
    h, w = hw[0] // s, hw[1] // s
    B = gt_boxes.shape[0]
    b = gt_boxes
    cx, cy = (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2
    gx = torch.clamp(torch.div(cx, s, rounding_mode="floor").long(), 0, w - 1)
    gy = torch.clamp(torch.div(cy, s, rounding_mode="floor").long(), 0, h - 1)
    cxp, cyp = (gx + 0.5) * s, (gy + 0.5) * s
    ltrb = torch.stack([cxp - b[..., 0], cyp - b[..., 1], b[..., 2] - cxp, b[..., 3] - cyp], -1)
    enc = torch.log(torch.clamp(ltrb, min=1e-3) / s)

    cells = h * w
    lab = gt_labels.long()
    upd = gt_mask.float()
    flat = torch.where(gt_mask, gy * w + gx, cells)               # masked boxes: a trash row
    obj = torch.zeros(B, cells + 1, device=b.device).scatter_reduce(1, flat, upd, "amax")
    # a label out of range is dropped, as an out-of-bounds scatter is in JAX
    in_range = gt_mask & (lab >= 0) & (lab < C)
    flat_c = torch.where(in_range, (gy * w + gx) * C + lab, cells * C)
    cls = torch.zeros(B, cells * C + 1, device=b.device).scatter_reduce(1, flat_c, upd, "amax")
    winner = last_wins(flat, cells + 1)[:, :cells]
    box = torch.gather(enc, 1, winner.clamp(min=0)[..., None].expand(-1, -1, 4))
    out = dict(obj=obj[:, :cells].reshape(B, h, w),
               cls=cls[:, :cells * C].reshape(B, h, w, C),
               box=torch.where(winner[..., None] >= 0, box, 0.0).reshape(B, h, w, 4))
    return {k: v[0] for k, v in out.items()} if one else out


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.minimum(abs_errors, torch.full_like(abs_errors, delta))
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def yolo_loss(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Focal-weighted objectness BCE over every cell, class BCE and Huber
    box loss at the positives, over (h, w, c) maps (``maps_hwc``) or
    (B, h, w, c) for one loss per image."""
    hwc = (-3, -2, -1)
    obj_t = targets["obj"]
    pos = obj_t > 0
    n_pos = torch.clamp(torch.sum(pos, (-2, -1)).float(), min=1.0)
    obj_p = preds["obj"][..., 0].float()
    p = torch.sigmoid(obj_p)
    bce = sigmoid_binary_cross_entropy(obj_p, obj_t)
    focal = torch.where(pos, (1 - p) ** 2, p ** 2) * bce
    l_obj = torch.sum(focal, (-2, -1)) / n_pos
    l_cls = torch.sum(torch.where(
        pos[..., None], sigmoid_binary_cross_entropy(preds["cls"].float(), targets["cls"]),
        0.0), hwc) / n_pos
    l_box = torch.sum(torch.where(
        pos[..., None], huber_loss(preds["box"].float(), targets["box"]), 0.0), hwc) / n_pos
    loss = l_obj + l_cls + 2.0 * l_box
    return loss, dict(obj=l_obj, cls=l_cls, box=l_box)


class YoloTrainer(StepTrainer):
    def __init__(self, cfg: Yolo2DConfig = Yolo2DConfig(num_classes=4),
                 hw: Tuple[int, int] = (256, 320), lr: float = 1e-3,
                 total_steps: int = 2000, seed: int = 0, device: DeviceLike = None):
        self.cfg, self.hw = cfg, hw
        self.device = resolve_device(device)
        set_slam_precision()            # the float32 heads without TF32
        self.logger = get_logger("train_yolo")
        model = Yolo2D(cfg)
        init_camera_params(model, torch.Generator().manual_seed(seed))
        self._start(model, lr, 100, total_steps, 1e-4, 10.0)

    def loss_on_batch(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with span("train/forward"):
            preds = self.model(batch["image"].permute(0, 3, 1, 2))
        with span("train/loss"):
            targets = make_yolo_targets(self.cfg, self.hw, batch["gt_boxes"],
                                        batch["gt_labels"], batch["gt_mask"])
            losses, aux = yolo_loss({k: v.permute(0, 2, 3, 1) for k, v in preds.items()},
                                    targets)
            return losses.mean(), {k: v.mean() for k, v in aux.items()}

    def evaluate(self, batches, score_thresh: float = 0.3, iou_thresh: float = 0.5) -> Dict:
        """2D AP through decode + NMS (the deployment path)."""
        frames = yolo2d_frames(self.model, batches, self.device, score_thresh)
        return yolo2d_ap(frames, self.cfg.num_classes, iou_thresh)

    def save(self, path: str) -> str:
        return save_params(path, camera_params_to_flax(self.model))

    def load(self, path: str) -> None:
        load_camera_params(self.model, load_params(path))
