"""Where the time of the detection path goes on the card.

    python -m lsd_tpu_torch.tools.profile_detector [--capacity reference] [--frames 20]
                                                   [--out profile_detector_out]

Serves a shipped checkpoint (``--capacity reference``: 0.2 m pillars,
640^2 grid; ``true_reference``: 0.1 m pillars, 1280^2 fine grid), or
DSVT-Pillar with seeded random weights (``dsvt_pillar``: none ship; one
frame a call, no accumulation), through
``runtime.modules.build_detector_predict_fn`` in bf16, handed to a
``runtime.modules.DetectModule`` (``detect_module``), and drives the
module's ``process`` frame by frame: parsing, two accumulated frames,
predict, one packed fetch, freespace, the tracker (its GIoU on the card)
and the ROI filter.  The frames are ``ego_drive``'s: one realistic scene
seen from a vehicle driving straight at 10 m/s.  After 3 warm-up frames,
``--frames`` frames run under ``torch.profiler`` (host and device), then 3
more have their host syncs counted, in predict alone and in the whole
frame.  It prints, and writes as JSON:

- wall ms per frame (host clock, ending in a synchronize), the device's
  busy ms per frame and its idle share, kernel launches per frame;
- each ``detect/*`` span's host ms and kernel launches per frame, the
  program's own: ``parse``, ``accumulate``, ``upload``, ``voxelize``,
  ``vfe``, ``scatter``, ``backbone``, ``head``, ``decode``, ``nms``
  (thresholds and the greedy sweep), ``fetch``, ``freespace``,
  ``tracker``; for DSVT-Pillar also ``dsvt`` and its ``partition``,
  ``posembed``, ``attention`` and ``ffn``;
- the kernels and the host-side operators that take the most time;
- host syncs per frame by source line.

It needs a card; it has no CPU path.  ``eval_scenes``, ``mean_ap``,
``ego_drive``, ``detect_module``, ``frame_dict`` and ``frame_profile`` are
also what ``chip_smoke.py`` uses.
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..detection.eval import evaluate_frames
from ..models.detector import DetectorConfig
from ..runtime.config import AttrDict
from ..runtime.modules import DetectModule, build_detector_predict_fn
from ..training.data import SyntheticDetectionDataset, SyntheticSceneConfig
from ..utils.device import resolve_device
from .profile_lio import _card, sync_sites, trace_report

SPANS = ("detect/",)
# the IoUs the Waymo Open Dataset scores at: vehicle, pedestrian, cyclist
WOD_IOUS = {0: 0.7, 1: 0.5, 2: 0.5}
CAPACITIES = {"reference": DetectorConfig.reference_capacity,
              "true_reference": DetectorConfig.true_reference_capacity,
              "dsvt_pillar": DetectorConfig.dsvt_pillar}
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


def detect_module(predict, det_cfg: DetectorConfig, device,
                  accum_frames: int = 2) -> DetectModule:
    """A ``DetectModule`` serving ``predict`` (a ``build_detector_predict_fn``
    function with ``with_seg``, built at ``det_cfg``) through ``set_model``:
    ``accum_frames`` accumulated frames, freespace, the tracker and the ROI
    filter the drives use, a square of 60 m around the vehicle less the
    vehicle's own footprint."""
    r, ego = 60.0, [[-2.5, -1.2], [2.5, -1.2], [2.5, 1.2], [-2.5, 1.2]]
    cfg = AttrDict(dict(
        input=dict(mode="offline"), detection=dict(enable=False, accum_frames=accum_frames),
        roi=[dict(contour=[[-r, -r], [r, -r], [r, r], [-r, r]], is_included=True),
             dict(contour=ego, is_included=False)]))
    module = DetectModule(cfg, device=device)
    module.setup(cfg)
    module.set_model(predict, det_cfg)
    return module


def frame_dict(points, mask, motion, k: int, dt: float = 0.1) -> Dict:
    """Frame ``k`` of ``ego_drive`` as the runtime's frame dict.  The motion
    goes to the accumulator and to the tracker alike, as the reference's
    ``DetectModule.process`` passes it."""
    return dict(lidar_valid=True, points={"lidar": points[mask]},
                frame_timestamp_monotonic=int(k * dt * 1e6), timestep=int(dt * 1e6),
                motion_t=motion, motion_valid=motion is not None)


def frame_profile(module: DetectModule, traced, probed) -> dict:
    """``module.process`` over the frame dicts ``traced`` under
    ``torch.profiler``: wall and device-busy ms per frame, idle share,
    launches, and per ``detect/*`` span host ms and launches; then host
    syncs by site in the whole frame and in the predict function alone, per
    frame, over the frame dicts ``probed``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for d in traced:
            module.process(dict(d))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(traced)
    report = {k.replace("_per_scan", "_per_frame"): v
              for k, v in trace_report(prof, n, wall, SPANS).items()}
    predict, inputs = module.predict_fn, []

    def keep_inputs(points, mask):
        inputs.append((points, mask))
        return predict(points, mask)
    module.set_model(keep_inputs)
    sites_frame, sites_predict = collections.Counter(), collections.Counter()
    try:
        for d in probed:
            sites_frame.update(sync_sites(lambda: module.process(dict(d)))[1])
            sites_predict.update(sync_sites(lambda: predict(*inputs[-1]))[1])
    finally:
        module.set_model(predict)
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
    dsvt = det_cfg.encoder == "dsvt"
    predict = build_detector_predict_fn(det_cfg=det_cfg, with_seg=True, device=dev,
                                        allow_random_init=dsvt)
    frames, _ = ego_drive(WARM + args.frames + SYNC_FRAMES)
    dicts = [frame_dict(*f, k) for k, f in enumerate(frames)]
    module = detect_module(predict, det_cfg, dev, accum_frames=1 if dsvt else 2)
    for d in dicts[:WARM]:
        module.process(dict(d))
    acc = module.accumulator
    report = dict(card=_card(), capacity=args.capacity, frames=args.frames,
                  points_per_frame=acc.num_frames * acc.cap if acc else int(frames[0][1].sum()),
                  **frame_profile(module, dicts[WARM:WARM + args.frames],
                                  dicts[WARM + args.frames:]))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_detector_{args.capacity}.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
