"""Detection trainer (counterpart of ``lsd_tpu/training/trainer.py:29-192``).

``Trainer`` trains the port's ``CenterPointDetector`` as the reference
trains its own: the network in its compute type (bf16 by default, as
served; float32 parameters), targets drawn on the device
(``models.detector.make_target_maps`` and ``make_seg_target``), the loss of
each frame normalised on its own and their mean taken, and the optax chain
of the reference (``training.optim.ClippedAdamW``).  One step makes no host
sync: the batch goes up through pinned memory, and the loss is read back
only every ``log_every`` steps.  Spans ``train/forward``, ``train/loss``,
``train/backward`` and ``train/optim`` mark its parts for the profiler.

``evaluate`` scores AP through the deployment path (decode,
``postprocess``, ``detection.eval.evaluate_frames``) and the freespace
head's IoU against the geometric labels; ``save`` and ``load`` read and
write the reference's flax-msgpack checkpoints, so the reference's
``load_params`` reads what the port saves and the reverse.

The reference's ``mesh`` (data parallelism over a device mesh) is not here:
the trainer runs on one ``device`` (ROADMAP A13).  ``TrainerConfig`` keeps
the reference's fields, ``mesh_axis`` among them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..convert import detector_params_from_flax, detector_params_to_flax
from ..detection.eval import evaluate_frames
from ..detection.post import PostProcessConfig, postprocess
from ..models.detector import (CenterPointDetector, DetectorConfig, detection_loss,
                               init_detector_params, make_seg_target, make_target_maps)
from ..models.params_io import load_params, save_params
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.log import get_logger
from ..utils.precision import set_slam_precision
from .optim import ClippedAdamW

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 10.0
    mesh_axis: str = "dp"       # the reference's data-parallel axis (ROADMAP A13)
    log_every: int = 20


class StepTrainer:
    """What the three trainers share: the step (forward and loss of a
    subclass's ``loss_on_batch``, backward, optimizer) and the loop."""

    model: torch.nn.Module
    opt: ClippedAdamW
    device: torch.device
    logger = None

    def _start(self, model: torch.nn.Module, lr: float, warmup_steps: int, total_steps: int,
               weight_decay: float, grad_clip: float) -> None:
        self.model = model.to(self.device)
        self.opt = ClippedAdamW(self.model.named_parameters(), lr, warmup_steps, total_steps,
                                weight_decay, grad_clip)
        self.step = 0

    def loss_on_batch(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def upload(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: to_device(v, self.device) for k, v in batch.items()}

    def train_step(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One update from a batch already on the device: (loss, aux) as
        0-dim tensors on the device."""
        loss, aux = self.loss_on_batch(batch)
        with record_function("train/backward"):
            loss.backward()
        with record_function("train/optim"):
            self.opt.step()
            self.opt.zero_grad()
        self.step += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def fit(self, batches, log_every: int = 50) -> Dict:
        """Train on ``batches`` (dicts of numpy arrays), logging the loss every
        ``log_every`` steps: {steps, final_loss}."""
        final, _ = self._loop(batches, log_every)
        return dict(steps=self.step, final_loss=final)

    def _loop(self, batches, log_every: int,
              after_step: Optional[Callable[[], None]] = None) -> Tuple[float, list]:
        t0 = time.monotonic()
        history, loss = [], None
        for batch in batches:
            loss, _ = self.train_step(self.upload(batch))
            if self.step % log_every == 0:
                lf = float(loss)
                history.append(lf)
                self.logger.info("step %d loss %.4f (%.1f steps/s)", self.step, lf,
                                 self.step / (time.monotonic() - t0))
            if after_step is not None:
                after_step()
        return (float("nan") if loss is None else float(loss)), history


class Trainer(StepTrainer):
    """``dtype`` is the network's compute type: bf16 as served; float32
    builds the twin that the parity checks train, and float64 (with
    ``model.double()``) a reference for float32's own rounding."""

    def __init__(self, det_cfg: DetectorConfig = DetectorConfig(),
                 cfg: TrainerConfig = TrainerConfig(), device: DeviceLike = None,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        self.det_cfg, self.cfg = det_cfg, cfg
        self.device = resolve_device(device)
        # the heads' last convolutions are float32, as served: no TF32
        set_slam_precision()
        self.logger = get_logger("train")
        model = CenterPointDetector(det_cfg, dtype=dtype)
        init_detector_params(model, torch.Generator().manual_seed(seed))
        self._start(model, cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.weight_decay,
                    cfg.grad_clip)

    def loss_on_batch(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The batch's mean loss, each frame's loss normalised on its own."""
        cfg = self.det_cfg
        with record_function("train/forward"):
            preds = self.model.forward_batch(batch["points"], batch["mask"])
        with record_function("train/loss"):
            targets = make_target_maps(cfg, batch["gt_boxes"], batch["gt_labels"],
                                       batch["gt_mask"])
            targets["seg"], targets["seg_mask"] = make_seg_target(cfg, batch["points"],
                                                                  batch["mask"])
            losses, aux = detection_loss(preds, targets)
            return losses.mean(), {k: v.mean() for k, v in aux.items()}

    def fit(self, batches: Iterator[Dict[str, np.ndarray]], eval_batches: Optional[list] = None,
            eval_every: int = 0, ckpt_path: Optional[str] = None) -> Dict:
        def after_step():
            if eval_every and eval_batches and self.step % eval_every == 0:
                self.logger.info("step %d eval %s", self.step, self.evaluate(eval_batches))
                if ckpt_path:
                    self.save(ckpt_path)
                    self.logger.info("checkpoint -> %s", ckpt_path)
        final, history = self._loop(batches, self.cfg.log_every, after_step)
        return dict(steps=self.step, final_loss=final, history=history)

    @torch.inference_mode()
    def evaluate(self, batches, score_thresh: float = 0.3,
                 iou_thresh: Union[float, Dict[int, float]] = 0.5) -> Dict:
        """AP through the deployment decode + NMS path, and the freespace
        head's IoU against the geometric drivable-area labels.
        ``iou_thresh`` is one gate or one per class label (a class it does
        not name is gated at 0.7, as ``evaluate_frames`` does)."""
        cfg, model, dev = self.det_cfg, self.model, self.device
        post_cfg = PostProcessConfig(score_thresh=(score_thresh,) * cfg.num_classes)
        frames = []
        seg_inter = seg_union = 0.0
        for batch in batches:
            for b in range(len(batch["points"])):
                pts = to_device(batch["points"][b], dev)
                msk = to_device(batch["mask"][b], dev)
                preds = model(pts, msk)
                seg_t, seg_m = make_seg_target(cfg, pts, msk)
                seg_p = (preds["seg"][..., 0] > 0.0).float() * seg_m
                seg_t = seg_t * seg_m
                inter = torch.sum(seg_p * seg_t)
                union = torch.sum(torch.maximum(seg_p, seg_t))
                boxes, scores, labels, keep, inter, union = fetch(
                    *postprocess(post_cfg, *model.decode(preds)), inter, union)
                seg_inter += float(inter)
                seg_union += float(union)
                gm = np.asarray(batch["gt_mask"][b], bool)
                frames.append(dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep],
                                   gt_boxes=np.asarray(batch["gt_boxes"][b])[gm],
                                   gt_labels=np.asarray(batch["gt_labels"][b])[gm]))
        per_class = evaluate_frames(frames, iou_thresh=iou_thresh)
        mean_ap = (float(np.mean([m["ap"] for m in per_class.values()]))
                   if per_class else 0.0)
        return dict(mean_ap=mean_ap, seg_iou=round(seg_inter / max(seg_union, 1.0), 4),
                    per_class={k: v["ap"] for k, v in per_class.items()})

    def save(self, path: str) -> str:
        return save_params(path, detector_params_to_flax(self.model))

    def load(self, path: str) -> None:
        self.model.load_state_dict(detector_params_from_flax(load_params(path)))
