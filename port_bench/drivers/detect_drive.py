"""Detection drive: ``runtime/modules.py:DetectModule.process`` driven one
frame per call in a closed loop, as the pipeline's detection stage runs
it: the frame dict parsed and padded, two frames accumulated, the
CenterPoint network and its postprocessing (the predict function the
module built from the shipped checkpoint), one fetch, freespace, the
tracker and the ROI filter.

The traffic is one drive (``gen/street.py``) made at set-up from the seed
and replayed from its start; each restart begins a new drive, with the
tracker and the accumulator empty.  The output check takes one whole drive
of the window (which one, drawn from the seed) and holds every frame's
kept detections, freespace and tracked objects to the plain reference
run over the same frames, and every frame's candidates before NMS, as
the predict function's ``model.decode`` returns them.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..compare import box_gaps, freespace_share, track_gaps
from ..counts import detector as det_counts
from ..gen import street
from ..harness import ROOT

MATCH_RADIUS_M = 1.0
# candidates before NMS: those scoring at least this on either side are
# compared; one cell apart (0.4 m) is a different candidate
CANDIDATE_FLOOR = 0.1
CANDIDATE_RADIUS_M = 0.2


def gaps(conf: dict, results, ref) -> dict:
    """The widest gaps over the frames of a drive between ``results`` and
    the reference's ``ref`` (``compare.py``)."""
    thr = conf["postprocess"]["score_thresh"]
    floor = [CANDIDATE_FLOOR] * len(thr)
    g = dict(pre_score_gap=0.0, pre_box_gap_m=0.0, det_score_gap=0.0, det_box_gap_m=0.0,
             track_box_gap_m=0.0, track_unpaired=0.0, freespace_cell_share=0.0)
    for p, r in zip(results, ref):
        if "pre" not in p:              # the program decoded no candidates
            g["pre_score_gap"] = g["pre_box_gap_m"] = float("inf")
        else:
            c = box_gaps(*p["pre"], *r["pre"], floor, CANDIDATE_RADIUS_M, CANDIDATE_FLOOR)
            g["pre_score_gap"] = max(g["pre_score_gap"], float(c["score"]))
            g["pre_box_gap_m"] = max(g["pre_box_gap_m"], float(c["box_m"]))
        b = box_gaps(p["boxes"], p["scores"], p["labels"], r["boxes"], r["scores"],
                     r["labels"], thr, MATCH_RADIUS_M)
        t = track_gaps(p["objects"], r["objects"], MATCH_RADIUS_M)
        for k, v in (("det_score_gap", b["score"]), ("det_box_gap_m", b["box_m"]),
                     ("track_box_gap_m", t["box_m"]), ("track_unpaired", t["unpaired"]),
                     ("freespace_cell_share", freespace_share(p["cells"], r["cells"]))):
            g[k] = max(g[k], float(v))
    return g


def control(cell, seed: int, device) -> dict:
    """The check's numbers with the reference in the program's place,
    computed with every convolution in float8 (the precision below the
    configuration's bf16), against the reference: the control, which has
    to fail."""
    from ..reference import detect_ref
    frames, motion, _ = street.drive(cell.traffic, seed)
    w = str(ROOT / cell.config["weights"])
    low = detect_ref.run_drive(cell.config, w, frames, motion, len(frames), device, fp8_control=True)
    return gaps(cell.config, low, detect_ref.run_drive(cell.config, w, frames, motion,
                                                        len(frames), device))


class Driver:
    unit = "frames"

    def __init__(self, cell, seed: int, device):
        from lsd_tpu_torch.detection.tracker import Tracker3D, TrackerConfig
        from lsd_tpu_torch.runtime.config import AttrDict
        from lsd_tpu_torch.runtime.modules import DetectModule

        conf, tr = cell.config, cell.traffic
        self.conf, self.tr, self.limits, self.device = conf, tr, cell.limits, device
        self.new_tracker = lambda: Tracker3D(TrackerConfig(), device=device)
        self.frames, self.motion, self.in_range = street.drive(tr, seed)
        self.F = len(self.frames)
        r = conf["roi_half_width_m"]
        mcfg = AttrDict(dict(
            input=dict(mode="offline"),
            detection=dict(enable=True, capacity=conf["capacity"], accum_frames=conf["accum_frames"],
                           weights=str(ROOT / conf["weights"])),
            roi=[dict(contour=[[-r, -r], [r, -r], [r, r], [-r, r]], is_included=True),
                 dict(contour=conf["roi_exclude"], is_included=False)]))
        self.module = DetectModule(mcfg, device=device)
        self.module.setup(mcfg)
        got = self.module.det_cfg_ref
        for k in ("pc_range", "voxel_size", "max_voxels", "max_points_per_voxel", "num_classes",
                  "pillar_filters", "max_boxes", "bev_stride", "s2d_factor"):
            if np.any(np.asarray(getattr(got, k)) != np.asarray(conf[k])):
                raise ValueError(f"the program's detector has {k}={getattr(got, k)}, "
                                 f"the configuration {conf[k]}")
        inner = self.module.predict_fn
        self.kept = self.pre = None
        # the candidates before NMS, where the predict function decodes them
        model = inner.model
        decode = model.decode

        def decode_and_keep(preds):
            out = decode(preds)
            if self.recording:
                self.pre.append(tuple(t.clone() for t in out))
            return out
        model.decode = decode_and_keep

        def predict(points, mask):
            with record_function("bench/predict"):
                out = inner(points, mask)
            if self.recording:
                self.kept.append(tuple(t.clone() for t in out[:4]))
            return out
        self.module.set_model(predict)

        rng = np.random.default_rng(seed)
        self.check_drive = 1 + int(rng.integers(0, 2))
        self.kept, self.pre, self.results = [], [], []
        self.recording = False
        self.k = 0
        self.failed = 0
        warm = int(tr["warm_frames"])
        for _ in range(warm):
            self.step()
        self.attempted_outside_window = warm

    def frame_dict(self, i: int) -> dict:
        first = i == 0
        return dict(lidar_valid=True, points={"lidar": self.frames[i]},
                    frame_timestamp_monotonic=int((self.k * self.tr["dt_s"]) * 1e6),
                    timestep=int(self.tr["dt_s"] * 1e6),
                    motion_t=None if first else self.motion, motion_valid=not first)

    def step(self) -> float:
        drive, i = divmod(self.k, self.F)
        if i == 0 and self.k:
            self.module.accumulator.reset()
            self.module.tracker = self.new_tracker()
        self.recording = drive == self.check_drive
        d = self.frame_dict(i)
        t0 = time.perf_counter()
        with record_function("bench/frame"):
            out = self.module.process(d)
        lat = time.perf_counter() - t0
        if self.recording:
            self.results.append(dict(cells=out["freespace"]["cells"], objects=out["objects"]))
        self.k += 1
        return lat

    def finish(self) -> None:
        while self.k < (self.check_drive + 1) * self.F:
            self.step()
            self.attempted_outside_window += 1

    def counts(self) -> dict:
        return dict(network_flops=det_counts.network_flops(self.conf))

    def release(self) -> None:
        kept = []
        for boxes, scores, labels, keep in self.kept:
            b, s, l, m = (t.float().cpu().numpy() for t in (boxes, scores, labels, keep))
            m = m.astype(bool)
            kept.append(dict(boxes=b[m], scores=s[m], labels=l[m].astype(np.int32)))
        for r, k in zip(self.results, kept):
            r.update(k)
        for r, cand in zip(self.results, self.pre):
            b, s, l, m = (t.float().cpu().numpy() for t in cand)
            m = m.astype(bool)
            r["pre"] = (b[m], s[m], l[m].astype(np.int32))
        self.kept = self.pre = None
        self.module = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, fp8_control: bool = False):
        from ..reference import detect_ref
        return detect_ref.run_drive(self.conf, str(ROOT / self.conf["weights"]), self.frames,
                                    self.motion, self.F, self.device, fp8_control=fp8_control)

    def describe(self) -> str:
        det = np.mean([len(r["boxes"]) for r in self.results])
        trk = np.mean([len(r["objects"]) for r in self.results])
        return (f"drive {self.check_drive} checked: {det:.1f} kept detections and "
                f"{trk:.1f} tracked objects a frame of {np.mean(self.in_range):.1f} objects "
                f"in range; {sum('pre' in r for r in self.results)} frames of candidates before NMS")

    def check(self):
        if len(self.results) != self.F:
            raise RuntimeError(f"{len(self.results)} frames of the checked drive, not {self.F}")
        g = gaps(self.conf, self.results, self.reference())
        return [(k, v, float(self.limits[k])) for k, v in g.items()]
