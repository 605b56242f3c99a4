"""DSVT-Pillar drive: ``runtime/modules.py:DetectModule.process`` driven one
frame per call in a closed loop with ``detection.capacity: dsvt_pillar``
and no accumulation, as a vehicle serves the detector: the frame dict
parsed and padded, the upload, the dynamic pillar encoder, DSVT, the BEV
backbone and head, decode and NMS, one fetch, freespace, the tracker and
the ROI filter.

The weights are seeded random, drawn by the benchmark in numpy from the
run's seed (``draw_weights``: non-trivial biases, norm scales and
BatchNorm statistics), written at set-up by the benchmark's own writer and
handed over as ``detection.weights``; the reference reads the same file.
No trained DSVT checkpoint is in the repository.  Set-up first makes sure
the program built the DSVT path at the configuration's widths, and fails
at once where it did not.

The traffic is one drive (``gen/street.py``) of Waymo-top-like sweeps made
at set-up from the seed and replayed from its start; each restart begins
with the tracker empty.  The output check holds ``check_frames`` frames of
the window (the first timed frame, the rest drawn from the seed) to the
float32 reference (``reference/dsvt.py``, reading the same file): per
frame the first layer's set attention before its out projection (the
widest gap; the widest of its heads' RMS gaps over the head's RMS; and
``attention_unmasked_share``, how far each head has moved towards the
reference's attention with the repeated slots left in as keys: 0 where the
mask holds, 1 where that head lost it), the pillar features after the
last DSVT block (read as the BEV image the program scatters them to) and
each of the six maps, as the widest gap over the frame's largest
magnitude, and the 256 candidates before NMS paired within 0.2 m
(``candidate_gaps``).  The first layer's attention is where a fault of the
kernel shows: one head's key mask dropped moves the features after the
last block, and that head's RMS, by less than bf16's own rounding does,
but its share towards the unmasked attention from about 0 to about 1.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..compare import _match
from ..counts import dsvt as dsvt_counts
from ..gen import street
from ..harness import BENCH_DIR

MAPS = ("heatmap", "offset", "z", "dim", "rot", "seg")
HEADS = 8
CANDIDATE_RADIUS_M = 0.2
# the heatmap's last bias about log(0.01 / 0.99): no cell of a random
# network passes the score thresholds, as none of a trained one does away
# from objects (at CenterPoint's log(0.1 / 0.9) whole classes of some seeds
# do, NMS and the tracker take every candidate, and the rate swings with the
# seed)
HEATMAP_BIAS = "head.heads.hm.out.bias"
HEATMAP_PRIOR = -4.6


def weights_path(seed: int):
    return BENCH_DIR / ".cache" / "dsvt" / f"weights-{seed}.msgpack"


def program_shapes() -> dict:
    """Name -> (shape, dtype) of every entry of the program's DSVT-Pillar
    ``state_dict`` (built on the meta device: types only, no values)."""
    from lsd_tpu_torch.models.detector import CenterPointDetector, DetectorConfig
    with torch.device("meta"):
        model = CenterPointDetector(DetectorConfig.dsvt_pillar(), dtype=torch.float32)
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def draw_weights(shapes: dict, seed: int) -> dict:
    """A checkpoint tree (``{"params": ...}``, nested by the dotted parts of
    the names) for ``shapes``, drawn in numpy from ``seed`` by the names
    the reference reads: matrices and kernels from a normal of variance
    1/fan_in (a transposed convolution's fan is its input channels: its
    stride is its size), biases from N(0, 0.2^2) (the heatmap's about
    ``HEATMAP_PRIOR``), the LayerNorms' and BatchNorms' scales from
    U(0.5, 1.5), the BatchNorms' running means from N(0, 0.2^2) and
    variances from U(0.5, 2): every fold, bias and affine term moves the
    outputs."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for name in sorted(shapes):
        shape, dtype = shapes[name]
        if name.endswith("num_batches_tracked"):
            a = np.zeros(shape, np.int64)
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif name.endswith(("running_mean", "bias")):
            a = rng.normal(0.0, 0.2, shape) + (HEATMAP_PRIOR if name == HEATMAP_BIAS else 0.0)
        elif len(shape) == 1:
            a = rng.uniform(0.5, 1.5, shape)
        else:
            fan_in = shape[0] if name.startswith("backbone.ups.") else int(np.prod(shape[1:]))
            a = rng.normal(0.0, fan_in ** -0.5, shape)
        *path, leaf = name.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a, np.int64 if dtype == torch.int64 else np.float32)
    return {"params": params}


def write_weights(seed: int, path=None):
    """The seed's weights (``draw_weights`` over the program's names and
    shapes) written by the benchmark's own writer to ``path`` (the cache's
    by default), which the program loads as ``detection.weights`` and the
    reference reads."""
    from ..reference.params_io import save_params
    path = weights_path(seed) if path is None else path
    save_params(str(path), draw_weights(program_shapes(), seed))
    return path


def check_frames(tr: dict, seed: int) -> list:
    """The steps the check compares: the first timed one and the rest drawn
    from the seed within the first pass over the drive."""
    rng = np.random.default_rng(seed)
    warm, F = int(tr["warm_frames"]), int(tr["frames"])
    rest = rng.choice(np.arange(warm + 1, F), int(tr["check_frames"]) - 1, replace=False)
    return sorted([warm] + [int(k) for k in rest])


def candidate_gaps(a, b, radius: float) -> dict:
    """Two top-K candidate lists (boxes, scores, labels) of one frame: pairs
    by label and centre within ``radius``; ``score`` the widest score gap of
    a pair or, for a candidate without a partner, how far its score lies
    above the other list's lowest (what it would take to leave the other
    top-K); ``box`` the widest gap of a pair's centre (m) or size (relative
    to the second list's: a random network's sizes are exponentials of its
    logits, metres apart where the logits agree to a percent).  Headings are
    left to ``rot_gap_rel``: the atan2 of a random network's (sin, cos)
    logits near 0 swings by radians on a rounding."""
    (ba, sa, la), (bb, sb, lb) = a, b
    pairs = _match(ba, la, bb, lb, radius)
    score, geom = 0.0, 0.0
    for i, j in pairs:
        score = max(score, abs(float(sa[i]) - float(sb[j])))
        size = np.abs(ba[i][3:6] - bb[j][3:6]) / np.maximum(np.abs(bb[j][3:6]), 1e-6)
        geom = max(geom, float(np.abs(ba[i][:3] - bb[j][:3]).max()), float(size.max()))
    for lone, s, other in ((set(range(len(ba))) - {i for i, _ in pairs}, sa, sb),
                           (set(range(len(bb))) - {j for _, j in pairs}, sb, sa)):
        floor = float(other.min()) if len(other) else 0.0
        for i in lone:
            score = max(score, float(s[i]) - floor)
    return dict(score=score, box=geom)


def frame_gaps(prog: dict, ref: dict, cand_ref) -> dict:
    """One frame's numbers: program (``features``, the maps, ``pre``)
    against the reference's; ``unmasked``, per head, the program's gap
    from the reference's attention dotted with the reference's own move
    when the repeated slots are left in as keys, and that move's squared
    norm (``check_numbers`` pools them over the frames)."""
    def rel(a, b):
        b = b.float()
        return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-12))
    M = ref["attention0"].shape[0]            # the frame's pillars, in key order on both sides
    a, r = prog["attention0"][:M].float(), ref["attention0"].float()
    toward = ref["attention0_unmasked"].float() - r
    heads, unmasked = [], []
    for c in torch.arange(r.shape[1], device=r.device).chunk(HEADS):
        heads.append(float((a[:, c] - r[:, c]).norm() / r[:, c].norm().clamp(min=1e-12)))
        d = toward[:, c]
        unmasked.append((float((a[:, c] - r[:, c]).mul(d).sum()), float(d.pow(2).sum())))
    g = dict(attention_gap_rel=rel(a, r), attention_head_rms_rel=max(heads),
             unmasked=np.asarray(unmasked), feature_gap_rel=rel(prog["features"], ref["features"]))
    for k in MAPS:
        g[f"{k}_gap_rel"] = rel(prog[k], ref[k])
    c = candidate_gaps(prog["pre"], cand_ref, CANDIDATE_RADIUS_M)
    g.update(pre_score_gap=c["score"], pre_box_gap=c["box"])
    return g


def check_numbers(frames: list) -> dict:
    """The check's numbers over frames (``frame_gaps`` each): the widest of
    each frame's, and ``attention_unmasked_share``, per head the
    program's move towards the reference's unmasked attention as a share of
    that move, pooled over the frames (one frame's share swings with
    bf16's rounding where its move is small), the widest over heads."""
    out = {}
    for k in frames[0]:
        if k == "unmasked":
            dot, norm = sum(f[k] for f in frames).T
            out["attention_unmasked_share"] = float(np.abs(dot / np.maximum(norm, 1e-24)).max())
        else:
            out[k] = max(f[k] for f in frames)
    return out


def candidates(maps: dict, conf: dict):
    """The reference's top-K before NMS, decoded as the program decodes."""
    from ..reference.center_head import decode_boxes
    out = decode_boxes({k: maps[k] for k in MAPS}, conf["voxel_size"], conf["pc_range"],
                       stride=1, max_boxes=conf["max_boxes"])
    return numpy_candidates(out)


def numpy_candidates(out):
    b, s, l, m = (t.float().cpu().numpy() for t in out)
    m = m.astype(bool)
    return b[m], s[m], l[m].astype(np.int32)


def reference_frames(conf: dict, seed: int, frames, device, lower=None):
    """The reference's outputs, frame by frame (a generator)."""
    from ..reference import dsvt as ref
    from ..reference.params_io import load_params
    params = ref.flatten(load_params(str(weights_path(seed))))
    for pts in frames:
        r = ref.forward(params, pts, device, lower=lower, pc_range=conf["pc_range"])
        r["pre"] = candidates(r, conf)
        yield r


def control(cell, seed: int, device) -> dict:
    """The check's numbers with the reference in the program's place,
    every matrix product and convolution in float8 e4m3 (the precision
    below the configuration's bf16), against the reference: the control,
    which has to fail."""
    from ..reference.detect_ref import fp8
    conf, tr = cell.config, cell.traffic
    write_weights(seed)
    frames, _, _ = street.drive(tr, seed)
    pts = [frames[k % len(frames)] for k in check_frames(tr, seed)]
    return check_numbers([frame_gaps(lo, r, r["pre"]) for lo, r in zip(
        reference_frames(conf, seed, pts, device, lower=fp8), reference_frames(conf, seed, pts, device))])


class Driver:
    unit = "frames"

    def __init__(self, cell, seed: int, device):
        from lsd_tpu_torch.models.detector import DetectorConfig
        if not hasattr(DetectorConfig, "dsvt_pillar"):
            raise RuntimeError("dsvt_drive: the program has no DetectorConfig.dsvt_pillar(); "
                               "it cannot serve DSVT-Pillar")
        from lsd_tpu_torch.detection.tracker import Tracker3D, TrackerConfig
        from lsd_tpu_torch.runtime.config import AttrDict
        from lsd_tpu_torch.runtime.modules import DetectModule

        conf, tr = cell.config, cell.traffic
        self.conf, self.tr, self.limits, self.device = conf, tr, cell.limits, device
        self.seed = seed
        path = write_weights(seed)
        r = conf["roi_half_width_m"]
        mcfg = AttrDict(dict(
            input=dict(mode="offline"),
            detection=dict(enable=True, capacity=conf["capacity"], accum_frames=conf["accum_frames"],
                           weights=str(path)),
            roi=[dict(contour=[[-r, -r], [r, -r], [r, r], [-r, r]], is_included=True),
                 dict(contour=conf["roi_exclude"], is_included=False)]))
        self.module = DetectModule(mcfg, device=device)
        self.module.setup(mcfg)
        self.new_tracker = lambda: Tracker3D(TrackerConfig(), device=device)
        self.model = model = getattr(self.module.predict_fn, "model", None)
        self._check_program(self.module.det_cfg_ref, model)

        # what the check reads, where the predict function produces it: into
        # buffers made at set-up, so that no allocation falls in the window
        self.rec, self.kept = None, set()
        encode, decode = model.encode, model.decode

        def encode_and_keep(points, mask):
            out = encode(points, mask)
            self.keep("features", out)
            return out

        # the first layer's attention is what its out projection takes
        model.dsvt.blocks[0].layers[0].out.register_forward_pre_hook(
            lambda mod, args: self.keep("attention0", args[0]))

        def decode_and_keep(preds):
            out = decode(preds)
            for k in MAPS:
                self.keep(k, preds[k])
            self.keep("pre", out)
            return out
        model.encode, model.decode = encode_and_keep, decode_and_keep
        inner = self.module.predict_fn

        def predict(points, mask):
            with record_function("bench/predict"):
                return inner(points, mask)
        self.module.set_model(predict)

        self.frames, self.motion, self.in_range = street.drive(tr, seed)
        self.F = len(self.frames)
        self.per_frame = [dsvt_counts.frame_counts(f, conf) for f in self.frames]
        self.check_steps = check_frames(tr, seed)
        self.k = 0
        self.failed = 0
        warm = int(tr["warm_frames"])
        for _ in range(warm - 1):
            self.step()
        self.rec = {}                    # the last warm-up frame shapes the buffers
        self.step()
        template, self.rec = self.rec, None
        self.records = [{k: tuple(map(torch.empty_like, v)) if isinstance(v, tuple)
                         else torch.empty_like(v) for k, v in template.items()}
                        for _ in self.check_steps]
        self.attempted_outside_window = warm
        self.counters0 = model.dsvt.counters.clone()
        self.launches0 = self._launches()

    def _check_program(self, det_cfg, model) -> None:
        conf = self.conf
        if det_cfg is None or getattr(det_cfg, "encoder", None) != "dsvt" or model is None \
                or not hasattr(model, "dsvt"):
            raise RuntimeError("dsvt_drive: DetectModule did not build the DSVT-Pillar path "
                               f"from capacity {conf['capacity']!r}")
        d = model.dsvt.cfg
        got = dict(pc_range=list(det_cfg.pc_range), voxel_size=list(det_cfg.voxel_size),
                   max_pillars=det_cfg.max_voxels, num_classes=det_cfg.num_classes,
                   max_boxes=det_cfg.max_boxes, d_model=d.d_model, nhead=d.heads,
                   dim_feedforward=d.ffn, set_size=d.set_size, blocks=d.blocks,
                   window_shape=list(d.window) + [1], shifts=[[0, 0, 0], list(d.shift) + [0]],
                   hybrid_factor=[d.hybrid_factor] * 2 + [1])
        for k, v in got.items():
            if not np.allclose(np.asarray(v, float), np.asarray(conf[k], float)):
                raise RuntimeError(f"dsvt_drive: the program's DSVT-Pillar has {k}={v}, "
                                   f"the configuration {conf[k]}")

    def keep(self, key: str, t) -> None:
        """``t`` into the frame's record, once a frame: cloned while the
        record is being shaped, else copied into its buffer."""
        if self.rec is None or key in self.kept:
            return
        self.kept.add(key)
        if key not in self.rec:
            self.rec[key] = tuple(x.clone() for x in t) if isinstance(t, tuple) else t.clone()
        elif isinstance(t, tuple):
            for dst, src in zip(self.rec[key], t):
                dst.copy_(src)
        else:
            self.rec[key].copy_(t)

    @staticmethod
    def _launches() -> int:
        from lsd_tpu_torch.models.dsvt import set_attention
        return set_attention.launches

    def frame_dict(self, i: int) -> dict:
        first = i == 0
        return dict(lidar_valid=True, points={"lidar": self.frames[i]},
                    frame_timestamp_monotonic=int((self.k * self.tr["dt_s"]) * 1e6),
                    timestep=int(self.tr["dt_s"] * 1e6),
                    motion_t=None if first else self.motion, motion_valid=not first)

    def step(self) -> float:
        i = self.k % self.F
        if i == 0 and self.k:
            self.module.tracker = self.new_tracker()
        if self.k in self.check_steps:
            self.rec = self.records[self.check_steps.index(self.k)]
        self.kept = set()
        d = self.frame_dict(i)
        t0 = time.perf_counter()
        with record_function("bench/frame"):
            self.module.process(d)
        lat = time.perf_counter() - t0
        if self.k in self.check_steps:
            self.rec = None
        self.k += 1
        return lat

    def finish(self) -> None:
        while self.k <= self.check_steps[-1]:
            self.step()
            self.attempted_outside_window += 1

    def counts(self) -> dict:
        warm, n = int(self.tr["warm_frames"]), int(self.tr["traced_frames"])
        traced = [self.per_frame[k % self.F] for k in range(warm, warm + n)]
        c = self.model.dsvt.counters - self.counters0
        self.program_counts = dict(zip(("frames", "found", "kept", "sets", "repeats"),
                                       (int(v) for v in c.cpu())))
        self.program_counts["launches"] = self._launches() - self.launches0
        return dict(dsvt_flops=float(np.mean([f["flops"] for f in self.per_frame])),
                    attn_bytes=float(np.mean([f["attn_bytes"] for f in traced])),
                    attn_flops=float(np.mean([f["attn_flops"] for f in traced])))

    def release(self) -> None:
        self.module = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def describe(self) -> str:
        pf = self.per_frame
        pc = getattr(self, "program_counts", {})
        fr = max(pc.get("frames", 0), 1)
        return (f"{np.mean([f['pillars'] for f in pf]):.0f} pillars a frame "
                f"({min(f['pillars'] for f in pf)}-{max(f['pillars'] for f in pf)} over the drive, "
                f"capacity {self.conf['max_pillars']}), {np.mean([f['sets'] for f in pf]):.0f} sets "
                f"and {np.mean([f['repeats'] for f in pf]):.0f} repeated slots over the 4 "
                f"partitions; the program counted {pc.get('found', 0) / fr:.0f} pillars found, "
                f"{pc.get('kept', 0) / fr:.0f} kept, {pc.get('sets', 0) / fr:.0f} sets, "
                f"{pc.get('repeats', 0) / fr:.0f} repeats and {pc.get('launches', 0) / fr:.2f} "
                f"kernel launches a frame over {pc.get('frames', 0)} frames; "
                f"{np.mean(self.in_range):.1f} objects in range; "
                f"{len(self.check_steps)} frames checked")

    def check(self):
        if self.k <= self.check_steps[-1]:
            raise RuntimeError(f"the drive stopped at step {self.k}, before the checked "
                               f"step {self.check_steps[-1]}")
        pts = [self.frames[k % self.F] for k in self.check_steps]
        frames = []
        for rec, r in zip(self.records, reference_frames(self.conf, self.seed, pts, self.device)):
            rec["pre"] = numpy_candidates(rec["pre"])
            frames.append(frame_gaps(rec, r, r["pre"]))
        g = check_numbers(frames)
        self.records = []
        return [(k, v, float(self.limits[k])) for k, v in g.items()]
