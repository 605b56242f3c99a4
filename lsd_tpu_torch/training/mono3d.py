"""Training of the monocular 3D detector (counterpart of
``lsd_tpu/training/mono3d.py:211-342``).

``Mono3DTrainer`` trains the port's float32 ``Mono3D`` (TF32 off, as it is
served) on the targets that ``training.camera_data.SyntheticMono3DDataset``
draws with each batch (``t_*``), with ``models.mono3d.mono3d_loss`` per
image and the batch's mean, and the reference's optax chain: clipping at
10, AdamW with weight decay 1e-4 on a 100-step warmup and a cosine to
``total_steps`` (``training.optim.ClippedAdamW``).  ``evaluate`` is the
deployment decode and centre-distance AP of ``camera_data.mono3d_frames``
and ``mono3d_ap``; ``save`` and ``load`` read and write the reference's
flax-msgpack checkpoints.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..convert import camera_params_to_flax, load_camera_params
from ..models.mono3d import Mono3D, Mono3DConfig, init_camera_params, mono3d_loss
from ..models.params_io import load_params, save_params
from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger
from ..utils.precision import set_slam_precision
from ..utils.spans import span
from .camera_data import default_intrinsic, mono3d_ap, mono3d_frames
from .trainer import Batch, StepTrainer

TARGETS = ("heat", "offset", "depth", "dims", "rot", "mask")


class Mono3DTrainer(StepTrainer):
    def __init__(self, cfg: Mono3DConfig = Mono3DConfig(), lr: float = 1e-3,
                 total_steps: int = 2000, seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        set_slam_precision()            # float32 convolutions, no TF32
        self.logger = get_logger("train_mono3d")
        model = Mono3D(cfg)
        init_camera_params(model, torch.Generator().manual_seed(seed))
        self._start(model, lr, 100, total_steps, 1e-4, 10.0)

    def loss_on_batch(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with span("train/forward"):
            preds = self.model(batch["image"].permute(0, 3, 1, 2))
        with span("train/loss"):
            losses, aux = mono3d_loss({k: v.permute(0, 2, 3, 1) for k, v in preds.items()},
                                      {k: batch["t_" + k] for k in TARGETS})
            return losses.mean(), {k: v.mean() for k, v in aux.items()}

    def evaluate(self, batches, intrinsic: np.ndarray = None, score_thresh: float = 0.25,
                 match_radius: float = 2.0) -> Dict:
        """Centre-distance AP (BEV x/z within ``match_radius`` m) and the mean
        |depth error| of the matches, through the deployment decode."""
        K = intrinsic if intrinsic is not None else default_intrinsic(self.cfg.image_hw)
        frames = mono3d_frames(self.model, batches, K, self.device, score_thresh)
        return mono3d_ap(frames, self.cfg.num_classes, match_radius)

    def save(self, path: str) -> str:
        return save_params(path, camera_params_to_flax(self.model))

    def load(self, path: str) -> None:
        load_camera_params(self.model, load_params(path))
