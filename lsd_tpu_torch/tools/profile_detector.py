"""Where the time of the detection path goes on the card.

    python -m lsd_tpu_torch.tools.profile_detector [--capacity reference] [--frames 20]
                                                   [--out profile_detector_out]

Serves a shipped checkpoint (``--capacity reference``: 0.2 m pillars,
640^2 grid; ``true_reference``: 0.1 m pillars, 1280^2 fine grid) through
``runtime.modules.build_detector_predict_fn`` in bf16 and drives it as the
reference's ``DetectModule.process`` does, frame by frame (``detect_frame``):
two accumulated frames, predict, one packed fetch, freespace, the tracker
(its GIoU on the card) and the ROI filter.  The frames are
``ego_drive``'s: one realistic scene seen from a vehicle driving straight
at 10 m/s.  After 3 warm-up frames, ``--frames`` frames run under
``torch.profiler`` (host and device), then 3 more have their host syncs
counted, in predict alone and in the whole frame.  It prints, and writes
as JSON:

- wall ms per frame (host clock, ending in a synchronize), the device's
  busy ms per frame and its idle share, kernel launches per frame;
- each ``detect/*`` span's host ms and kernel launches per frame:
  ``voxelize``, ``vfe``, ``scatter``, ``backbone``, ``head``, ``decode``,
  ``nms`` (thresholds and the greedy sweep), ``fetch``, ``tracker``;
- the kernels and the host-side operators that take the most time;
- host syncs per frame by source line.

It needs a card; it has no CPU path.  ``eval_scenes``, ``mean_ap``,
``ego_drive`` and ``detect_frame`` are also what ``chip_smoke.py`` uses.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..detection.accumulate import FrameAccumulator
from ..detection.eval import evaluate_frames
from ..detection.freespace import seg_to_freespace
from ..detection.object_filter import ObjectFilter
from ..detection.tracker import Tracker3D, TrackerConfig
from ..models.detector import DetectorConfig
from ..runtime.modules import build_detector_predict_fn
from ..training.data import SyntheticDetectionDataset, SyntheticSceneConfig
from ..utils.device import fetch, resolve_device
from .profile_lio import _card, sync_sites, trace_report

SPANS = ("detect/",)
# the IoUs the Waymo Open Dataset scores at: vehicle, pedestrian, cyclist
WOD_IOUS = {0: 0.7, 1: 0.5, 2: 0.5}
CAPACITIES = {"reference": DetectorConfig.reference_capacity,
              "true_reference": DetectorConfig.true_reference_capacity}
WARM, SYNC_FRAMES = 3, 3


def scene_config() -> SyntheticSceneConfig:
    """The lidar-realistic scenes of the reference's detection evaluation
    (``lsd_tpu/tools/eval_detection.py``): objects within 60 m."""
    scfg = SyntheticSceneConfig(realistic=True)
    scfg.xy_range = 60.0
    return scfg


def eval_scenes(n_batches: int = 8, batch: int = 2, seed: int = 999) -> List[Dict]:
    """The 16 scenes (32,768-point capacity) that the reference's detection
    evaluation scores, one dict per scene."""
    ds = SyntheticDetectionDataset(scene_config(), batch_size=batch, seed=seed)
    return [{k: v[b] for k, v in bt.items()} for bt in ds.batches(n_batches) for b in range(batch)]


def mean_ap(predict, scenes: List[Dict]):
    """(mean AP over the classes at ``WOD_IOUS``, per-class AP, kept boxes
    per scene) of ``predict`` (a ``build_detector_predict_fn`` function) on
    ``scenes``."""
    frames = []
    for sc in scenes:
        boxes, scores, labels, keep = (a.cpu().numpy() for a in predict(sc["points"],
                                                                         sc["mask"])[:4])
        gm = sc["gt_mask"]
        frames.append(dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep],
                           gt_boxes=sc["gt_boxes"][gm], gt_labels=sc["gt_labels"][gm]))
    per_class = {k: v["ap"] for k, v in evaluate_frames(frames, iou_thresh=WOD_IOUS).items()}
    return float(np.mean(list(per_class.values()))), per_class, [len(f["boxes"]) for f in frames]


def ego_drive(n_frames: int, seed: int = 7, speed: float = 10.0, dt: float = 0.1):
    """One realistic scene (``scene_config``) seen from a vehicle driving
    straight along +x at ``speed`` m/s from the scene's origin; the objects
    are static.  Returns (frames, objects): frames of (points (N, 4), mask
    (N,), motion) in the vehicle's frame at that time, ``motion`` the 4x4
    transform that takes the previous frame's coordinates to this frame's
    (None for the first); objects are the scene's boxes (G, 7) and labels
    in the first frame's coordinates."""
    sc = SyntheticDetectionDataset(scene_config(), seed=seed).scene()
    step = speed * dt
    motion = np.eye(4)
    motion[0, 3] = -step
    frames = []
    for k in range(n_frames):
        pts = sc["points"].copy()
        pts[:, 0] -= k * step
        frames.append((pts, sc["mask"], motion if k else None))
    gm = sc["gt_mask"]
    return frames, (sc["gt_boxes"][gm], sc["gt_labels"][gm])


def detect_frame(predict, det_cfg: DetectorConfig, accumulator: FrameAccumulator,
                 tracker: Tracker3D, obj_filter: ObjectFilter, points, mask, motion,
                 dt: float = 0.1) -> Dict:
    """One frame as the reference's ``DetectModule.process`` runs it:
    accumulate, predict (``with_seg``), one packed fetch of the kept boxes
    and the freespace logits, ``seg_to_freespace``, ``Tracker3D.update``
    and ``ObjectFilter.filter``.  The motion goes to the accumulator and to
    the tracker alike, as the reference passes it.  Returns the filtered
    result with ``freespace`` and ``detections`` (boxes, scores, labels)."""
    pts, msk = accumulator.push(points, mask, motion=motion)
    boxes, scores, labels, keep, seg = predict(pts, msk)
    with record_function("detect/fetch"):
        boxes_h, scores_h, labels_h, keep_h, seg_h = fetch(boxes, scores, labels, keep, seg)
    freespace = seg_to_freespace(seg_h, det_cfg.pc_range, det_cfg.voxel_size[0])
    with record_function("detect/tracker"):
        out = tracker.update(boxes_h[keep_h], scores_h[keep_h], labels_h[keep_h], dt=dt,
                             motion=motion)
    out = obj_filter.filter(out)
    out["freespace"] = freespace
    out["detections"] = (boxes_h[keep_h], scores_h[keep_h], labels_h[keep_h])
    return out


def roi_filter(radius: float = 60.0) -> ObjectFilter:
    """The ROI filter the drives use: a square of ``radius`` metres around
    the vehicle, less the vehicle's own footprint."""
    r, e = radius, np.asarray([[-2.5, -1.2], [2.5, -1.2], [2.5, 1.2], [-2.5, 1.2]])
    return ObjectFilter(include_polygons=[np.asarray([[-r, -r], [r, -r], [r, r], [-r, r]])],
                        exclude_polygons=[e])


def frame_profile(run, predict, traced, probed) -> dict:
    """``run`` (one frame, ``detect_frame`` bound to its state) over the
    frames ``traced`` under ``torch.profiler``: wall and device-busy ms per
    frame, idle share, launches, and per ``detect/*`` span host ms and
    launches; then host syncs by site in ``run`` and in ``predict`` alone,
    per frame, over the frames ``probed``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in traced:
            run(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(traced)
    report = {k.replace("_per_scan", "_per_frame"): v
              for k, v in trace_report(prof, n, wall, SPANS).items()}
    sites_frame, sites_predict = {}, {}
    probe = FrameAccumulator(2, capacity_per_frame=probed[0][0].shape[0])
    for f in probed:
        stacked = probe.push(*f)
        for fn, into in ((lambda: run(f), sites_frame), (lambda: predict(*stacked), sites_predict)):
            for site, c in sync_sites(fn)[1].items():
                into[site] = into.get(site, 0) + c
    m = len(probed)
    report.update(host_syncs_per_frame=sum(sites_frame.values()) / m,
                  host_sync_sites_per_frame={k: v / m for k, v in sites_frame.items()},
                  host_syncs_in_predict=sum(sites_predict.values()) / m,
                  host_sync_sites_in_predict={k: v / m for k, v in sites_predict.items()})
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capacity", choices=sorted(CAPACITIES), default="reference")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="profile_detector_out")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    det_cfg = CAPACITIES[args.capacity]()
    predict = build_detector_predict_fn(det_cfg=det_cfg, with_seg=True, device=dev)
    frames, _ = ego_drive(WARM + args.frames + SYNC_FRAMES)
    acc = FrameAccumulator(2, capacity_per_frame=frames[0][0].shape[0])
    tracker = Tracker3D(TrackerConfig(), device=dev)
    filt = roi_filter()
    run = lambda f: detect_frame(predict, det_cfg, acc, tracker, filt, *f)
    for f in frames[:WARM]:
        run(f)
    report = dict(card=_card(), capacity=args.capacity, frames=args.frames,
                  points_per_frame=2 * frames[0][0].shape[0],
                  **frame_profile(run, predict, frames[WARM:WARM + args.frames],
                                  frames[WARM + args.frames:]))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_detector_{args.capacity}.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
