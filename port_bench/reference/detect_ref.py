"""The detection drive as the plain reference runs it: the frame padded to
its point bucket, two frames accumulated, the CenterPoint network in bf16
with the checkpoint read from its file, decode, thresholds and NMS, one
fetch, freespace, the tracker and the ROI filter, as
``DetectModule.process`` runs them; with ``fp8`` every convolution's
input and weight are rounded to float8 (e4m3, one scale a tensor): the
control."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import vfe
from .accumulate import FrameAccumulator
from .detector import CenterPointDetector, DetectorConfig
from .freespace import seg_to_freespace
from .object_filter import ObjectFilter
from .params_io import load_params
from .post import PostProcessConfig, postprocess
from .tracker import Tracker3D, TrackerConfig
from .weights import detector_params_from_flax

POINT_BUCKETS = (2 ** 14, 2 ** 15, 2 ** 16, 2 ** 17, 2 ** 18)
FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor."""
    s = FP8_MAX / t.detach().abs().amax().float().clamp(min=1e-12)
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


def det_config(conf: dict) -> DetectorConfig:
    keys = ("pc_range", "voxel_size", "max_voxels", "max_points_per_voxel", "num_classes",
            "pillar_filters", "max_boxes", "bev_stride", "s2d_factor")
    return DetectorConfig(**{k: tuple(conf[k]) if isinstance(conf[k], list) else conf[k]
                             for k in keys})


def roi_filter(conf: dict) -> ObjectFilter:
    r = conf["roi_half_width_m"]
    return ObjectFilter(include_polygons=[np.asarray([[-r, -r], [r, -r], [r, r], [-r, r]], float)],
                        exclude_polygons=[np.asarray(conf["roi_exclude"], float)])


def build_model(conf: dict, weights_path: str, device) -> CenterPointDetector:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CenterPointDetector(det_config(conf))
    model.load_state_dict(detector_params_from_flax(load_params(weights_path)))
    return model.to(device).eval().requires_grad_(False)


def run_drive(conf: dict, weights_path: str, frames: List[np.ndarray], motion: np.ndarray,
              n_frames: int, device, fp8_control: bool = False) -> List[Dict]:
    """The first ``n_frames`` frames of the drive ``frames``; per frame the
    candidates before NMS and the kept detections (boxes, scores, labels),
    the freespace cells and the tracked objects."""
    model = build_model(conf, weights_path, device)
    det_cfg = det_config(conf)
    pp = conf["postprocess"]
    pcfg = PostProcessConfig(score_thresh=tuple(pp["score_thresh"]), nms_iou=pp["nms_iou"],
                             max_objects=pp["max_objects"])
    n = frames[0].shape[0]
    cap = next(b for b in POINT_BUCKETS if n <= b)
    acc = FrameAccumulator(conf["accum_frames"], capacity_per_frame=cap)
    tracker = Tracker3D(TrackerConfig(), device=device)
    filt = roi_filter(conf)
    vfe.LOWER = fp8 if fp8_control else None
    motion = np.asarray(motion, np.float32)     # as a frame dict carries it
    out = []
    try:
        for i in range(n_frames):
            pts = np.zeros((cap, 4), np.float32)
            pts[:n] = frames[i][:, :4]
            mask = np.zeros(cap, bool)
            mask[:n] = True
            m = motion if i > 0 else None
            p, msk = acc.push(pts, mask, motion=m)
            with torch.inference_mode():
                pt = torch.as_tensor(p, device=device)[:, :4]
                mt = torch.as_tensor(msk, device=device)
                preds = model(pt, mt)
                cand = model.decode(preds)
                boxes, scores, labels, keep = postprocess(pcfg, *cand)
                seg = preds["seg"]
            boxes, scores, labels, keep, seg = (t.float().cpu().numpy()
                                                for t in (boxes, scores, labels, keep, seg))
            cb, cs, cl, cm = (t.float().cpu().numpy() for t in cand)
            cm = cm.astype(bool)
            keep = keep.astype(bool)
            labels = labels.astype(np.int32)
            fs = seg_to_freespace(seg, det_cfg.pc_range, det_cfg.voxel_size[0])
            res = tracker.update(boxes[keep], scores[keep], labels[keep], dt=0.1, motion=m)
            res = filt.filter(res)
            out.append(dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep],
                            cells=fs["cells"], objects=res["objects"],
                            pre=(cb[cm], cs[cm], cl[cm].astype(np.int32))))
    finally:
        vfe.LOWER = None
    return out
