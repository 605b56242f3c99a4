"""The detector's serving entry point (counterpart of
``lsd_tpu/runtime/modules.py:508-591``: ``shipped_detector_weights`` and
``build_detector_predict_fn``).  The pipeline modules themselves
(``DetectModule`` and the rest) are not ported yet; a caller runs the
sequence ``DetectModule.process`` runs: ``detection.accumulate`` ->
predict -> ``detection.freespace`` -> ``detection.tracker`` ->
``detection.object_filter``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..convert import detector_params_from_flax
from ..detection.post import PostProcessConfig, postprocess
from ..models.detector import CenterPointDetector, DetectorConfig, init_detector_params
from ..models.params_io import load_params
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.precision import set_slam_precision


def shipped_detector_weights(det_cfg) -> Optional[str]:
    """Path of the in-repo trained checkpoint matching ``det_cfg``'s
    capacity, or None.  The reference capacity (+-64 m, 0.2 m pillars, 640^2
    grid) and the deployed pitch (0.1 m pillars, 1280^2 fine grid) ship
    trained weights; ``pc_range``, ``voxel_size`` and ``s2d_factor`` must
    match exactly."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "weights")

    def _matches(ref):
        return (tuple(det_cfg.pc_range) == tuple(ref.pc_range)
                and tuple(det_cfg.voxel_size) == tuple(ref.voxel_size)
                and getattr(det_cfg, "s2d_factor", 1) == ref.s2d_factor)

    for ref, name in ((DetectorConfig.true_reference_capacity(), "detector_true_refcap.msgpack"),
                      (DetectorConfig.reference_capacity(), "detector_refcap.msgpack")):
        p = os.path.join(root, name)
        if _matches(ref) and os.path.exists(p):
            return p
    return None


def build_detector_predict_fn(weights: Optional[str] = None, det_cfg=None, with_seg: bool = False,
                              allow_random_init: bool = False, device: DeviceLike = None):
    """A ``(points, mask) -> (boxes, scores, labels, keep)`` function (with
    ``with_seg`` also the (H, W, 1) freespace logits) from the port's
    CenterPoint detector in bf16, as the reference serves it, with
    ``weights`` (a flax msgpack checkpoint) and the reference's
    postprocessing.

    With no ``weights`` the shipped checkpoint that matches the capacity is
    used; where none matches this raises, unless ``allow_random_init``
    (the reference's behaviour).  points (N, >=4), as host arrays or
    tensors; columns past the fourth (the accumulator's frame lag) are
    dropped.  The outputs are tensors on ``device`` (the card unless the
    caller asks for the CPU); the function makes no host sync: uploads are
    pinned and asynchronous, and nothing is read back.  The model is
    ``fn.model``."""
    cfg = det_cfg or DetectorConfig()
    dev = resolve_device(device)
    # the heads' last convolutions are float32 in the reference: no TF32
    set_slam_precision()
    model = CenterPointDetector(cfg)
    if not weights:
        weights = shipped_detector_weights(cfg)
        if weights is None and not allow_random_init:
            raise ValueError(
                "detection.enable=true but no detection.weights configured "
                "and no shipped checkpoint matches this capacity — refusing "
                "to serve a random-init model (set detection.weights, use "
                "capacity: reference, or train one)")
    if weights:
        model.load_state_dict(detector_params_from_flax(load_params(weights)))
    else:
        init_detector_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval().requires_grad_(False)
    pcfg = PostProcessConfig()

    @torch.inference_mode()
    def predict(points, mask):
        points, mask = to_device(points, dev, torch.float32), to_device(mask, dev, torch.bool)
        preds = model(points[:, :4], mask)
        out = postprocess(pcfg, *model.decode(preds))
        return out + (preds["seg"],) if with_seg else out

    predict.model = model
    return predict
