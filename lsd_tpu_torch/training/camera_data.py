"""The camera models' synthetic scenes and their evaluations (numpy
copies of ``lsd_tpu/training/mono3d.py:31-205, 264-335`` and
``lsd_tpu/training/yolo.py:38-119, 229-265``); the trainers that use them
are ``training/mono3d.py`` and ``training/yolo.py``.

- ``SyntheticMono3DDataset``: shaded cuboids of the four classes on a
  ground plane with exact camera-frame 3D labels; each batch also carries
  the training target maps ``t_heat``, ``t_offset``, ``t_depth``,
  ``t_dims``, ``t_rot`` and ``t_mask`` (``models.mono3d.make_mono3d_targets``
  at the scene's size with the default class count and stride), as the
  reference's does.  The same seed gives the same batches in both packages.
- ``SyntheticTrafficLightDataset``: stacked-lamp traffic lights among
  distractors, labels 0 red, 1 yellow, 2 green, 3 off.
- ``mono3d_frames`` / ``mono3d_ap``: the reference's ``Mono3DTrainer.evaluate``
  split in two: the port's model and ``decode_mono3d`` on each image (kept:
  valid and score > 0.25), then centre-distance AP (BEV x/z within 2 m,
  101-point interpolation) and the mean depth error of the matches.
- ``yolo2d_frames`` / ``yolo2d_ap``: ``YoloTrainer.evaluate`` split the
  same way: the port's model, ``decode_yolo2d`` and ``nms_2d`` over
  ``mask & (score > 0.3)``, then ``detection.eval.ap_2d`` per class at IoU
  0.5.

The images are float32 in [0, 1] at the model's size, so nothing is resized.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..detection.eval import ap_2d
from ..models.mono3d import Mono3DConfig, decode_mono3d, make_mono3d_targets, maps_hwc
from ..models.yolo2d import decode_yolo2d, nms_2d
from ..utils.device import DeviceLike, fetch, resolve_device, to_device

CLASS_NAMES = {0: "Vehicle", 1: "Pedestrian", 2: "Cyclist", 3: "Cone"}
# class dims (l, w, h) mean + jitter
_DIMS = {
    0: ((4.3, 1.85, 1.55), (0.5, 0.12, 0.12)),
    1: ((0.6, 0.6, 1.7), (0.1, 0.1, 0.12)),
    2: ((1.8, 0.6, 1.7), (0.2, 0.08, 0.1)),
    3: ((0.35, 0.35, 0.6), (0.05, 0.05, 0.08)),
}
_LIGHT = np.asarray([0.4, -0.8, 0.45])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
# traffic-light lamp colours: red, yellow, green
COLORS = {0: (0.9, 0.12, 0.1), 1: (0.95, 0.75, 0.1), 2: (0.1, 0.85, 0.3)}


def default_intrinsic(hw: Tuple[int, int] = (384, 640)) -> np.ndarray:
    H, W = hw
    f = 0.875 * W
    return np.asarray([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]],
                      np.float64)


def _fill_quad(img, shade, pts):
    """Rasterize a convex quad (4, 2) [u, v] with a flat shade (3,)."""
    H, W, _ = img.shape
    u0 = max(int(np.floor(pts[:, 0].min())), 0)
    u1 = min(int(np.ceil(pts[:, 0].max())) + 1, W)
    v0 = max(int(np.floor(pts[:, 1].min())), 0)
    v1 = min(int(np.ceil(pts[:, 1].max())) + 1, H)
    if u1 <= u0 or v1 <= v0:
        return
    uu, vv = np.meshgrid(np.arange(u0, u1) + 0.5, np.arange(v0, v1) + 0.5)
    inside = np.ones(uu.shape, bool)
    # convex polygon: consistent sign of cross products edge x (p - a).
    # The winding sign comes from the VERTICES (cross of consecutive
    # edges), not from a sampled pixel — for partially off-screen quads
    # the max-|cr| pixel of one edge can lie outside the quad and flip
    # the sign, silently rasterizing an empty mask.
    e01 = pts[1] - pts[0]
    e12 = pts[2] - pts[1]
    s = np.sign(e01[0] * e12[1] - e01[1] * e12[0])
    sign = s if s != 0 else 1.0
    for k in range(4):
        a, b = pts[k], pts[(k + 1) % 4]
        cr = (b[0] - a[0]) * (vv - a[1]) - (b[1] - a[1]) * (uu - a[0])
        inside &= (cr * sign) >= -1e-9
    img[v0:v1, u0:u1][inside] = shade


@dataclasses.dataclass
class Mono3DSceneConfig:
    hw: Tuple[int, int] = (384, 640)
    max_objects: int = 6
    n_distractors: int = 5
    cam_height: float = 1.5
    z_range: Tuple[float, float] = (5.0, 40.0)
    box_capacity: int = 8


class SyntheticMono3DDataset:
    """Shaded-cuboid street scenes with exact camera-frame 3D labels."""

    def __init__(self, cfg: Mono3DSceneConfig = Mono3DSceneConfig(),
                 batch_size: int = 4, seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.K = default_intrinsic(cfg.hw)

    def _project(self, P):
        """Cam-frame points (N, 3) -> pixel (N, 2); z clamped for safety."""
        z = np.maximum(P[:, 2], 0.5)
        u = self.K[0, 0] * P[:, 0] / z + self.K[0, 2]
        v = self.K[1, 1] * P[:, 1] / z + self.K[1, 2]
        return np.stack([u, v], 1)

    def _corners(self, box):
        x, y, z, l, w, h, yaw = box
        # vertical axis is camera -y; yaw in the x-z ground plane
        dx = np.asarray([l, l, -l, -l, l, l, -l, -l]) / 2
        dz = np.asarray([w, -w, -w, w, w, -w, -w, w]) / 2
        dy = np.asarray([h, h, h, h, -h, -h, -h, -h]) / 2   # +h/2 = bottom
        c, s = np.cos(yaw), np.sin(yaw)
        rx = c * dx + s * dz
        rz = -s * dx + c * dz
        return np.stack([x + rx, y + dy, z + rz], 1)        # (8, 3)

    _FACES = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
              (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)]

    def scene(self):
        cfg, rng = self.cfg, self.rng
        H, W = cfg.hw
        horizon = int(self.K[1, 2])
        img = np.empty((H, W, 3), np.float32)
        sky = rng.uniform(0.55, 0.85)
        gnd = rng.uniform(0.25, 0.45)
        img[:horizon] = sky + rng.normal(0, 0.02, (horizon, W, 3))
        grad = np.linspace(gnd * 1.2, gnd * 0.8, H - horizon)[:, None, None]
        img[horizon:] = grad + rng.normal(0, 0.02, (H - horizon, W, 3))
        # flat ground distractor patches (lane marks, shadows)
        for _ in range(cfg.n_distractors):
            z0 = rng.uniform(*cfg.z_range)
            x0 = rng.uniform(-0.6, 0.6) * z0
            pw, pl = rng.uniform(0.3, 2.5), rng.uniform(0.5, 4.0)
            quad = np.asarray([[x0 - pw, cfg.cam_height, z0 - pl],
                               [x0 + pw, cfg.cam_height, z0 - pl],
                               [x0 + pw, cfg.cam_height, z0 + pl],
                               [x0 - pw, cfg.cam_height, z0 + pl]])
            _fill_quad(img, np.full(3, rng.uniform(0.1, 0.9), np.float32),
                       self._project(quad))

        n_obj = int(rng.integers(1, cfg.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n_obj):
            lab = int(rng.integers(0, 4))
            (dl, dw, dh), (jl, jw, jh) = _DIMS[lab]
            l = max(dl + rng.normal(0, jl), 0.2)
            w = max(dw + rng.normal(0, jw), 0.2)
            h = max(dh + rng.normal(0, jh), 0.3)
            z = rng.uniform(*cfg.z_range)
            x = rng.uniform(-0.45, 0.45) * z
            y = cfg.cam_height - h / 2.0          # sitting on the ground
            yaw = rng.uniform(-np.pi, np.pi)
            boxes.append([x, y, z, l, w, h, yaw])
            labels.append(lab)
        order = np.argsort([-b[2] for b in boxes])     # painter: far first
        albedo = {0: (0.55, 0.1), 1: (0.5, 0.2), 2: (0.45, 0.15),
                  3: (0.85, 0.05)}
        for i in order:
            b, lab = boxes[i], labels[i]
            corners = self._corners(np.asarray(b))
            base_col = np.clip(
                albedo[lab][0] + rng.normal(0, albedo[lab][1], 3), 0.05, 1.0)
            ctr = corners.mean(0)
            for f in self._FACES:
                p = corners[list(f)]
                n = np.cross(p[1] - p[0], p[3] - p[0])
                nn = np.linalg.norm(n)
                if nn < 1e-9:
                    continue
                n = n / nn
                if np.dot(n, ctr - p.mean(0)) > 0:
                    n = -n                          # outward
                if np.dot(n, p.mean(0)) > 0:        # facing away from camera
                    continue
                shade = np.clip(
                    base_col * (0.35 + 0.65 * abs(float(np.dot(n, _LIGHT)))),
                    0.02, 1.0).astype(np.float32)
                _fill_quad(img, shade, self._project(p))
        img = np.clip(img * rng.uniform(0.8, 1.2) +
                      rng.normal(0, 0.015, img.shape), 0, 1).astype(np.float32)
        return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)

    def batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, G = self.batch_size, cfg.box_capacity
        H, W = cfg.hw
        imgs = np.zeros((B, H, W, 3), np.float32)
        gb = np.zeros((B, G, 7), np.float32)
        gl = np.zeros((B, G), np.int32)
        gm = np.zeros((B, G), bool)
        mcfg = Mono3DConfig(image_hw=cfg.hw)
        tg = {k: [] for k in ("heat", "offset", "depth", "dims", "rot", "mask")}
        for b in range(B):
            img, boxes, labels = self.scene()
            imgs[b] = img
            n = min(len(boxes), G)
            gb[b, :n], gl[b, :n], gm[b, :n] = boxes[:n], labels[:n], True
            t = make_mono3d_targets(mcfg, boxes[:n], labels[:n], self.K)
            for k in tg:
                tg[k].append(t[k])
        out = dict(image=imgs, gt_boxes=gb, gt_labels=gl, gt_mask=gm)
        out.update({"t_" + k: np.stack(v) for k, v in tg.items()})
        return out

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.batch()


@dataclasses.dataclass
class TrafficLightSceneConfig:
    hw: Tuple[int, int] = (256, 320)
    max_lights: int = 3
    n_distractors: int = 6
    box_capacity: int = 8


class SyntheticTrafficLightDataset:
    """Procedural day/night street-ish scenes with stacked-lamp traffic
    lights.  Labels: 0 red, 1 yellow, 2 green, 3 off; gt box is the
    housing rectangle (x1, y1, x2, y2) in pixels."""

    def __init__(self, cfg: TrafficLightSceneConfig = TrafficLightSceneConfig(),
                 batch_size: int = 8, seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def scene(self):
        cfg, rng = self.cfg, self.rng
        H, W = cfg.hw
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        # sky->ground gradient + color cast + noise
        base = rng.uniform(0.1, 0.7)
        img = np.stack([(base + 0.3 * (1 - yy / H))] * 3, -1)
        img *= rng.uniform(0.7, 1.1, 3)
        img += rng.normal(0, 0.03, img.shape)
        # distractor rectangles (buildings, signs, cars) + poles
        for _ in range(cfg.n_distractors):
            x0, y0 = rng.integers(0, W - 8), rng.integers(0, H - 8)
            w, h = rng.integers(6, 60), rng.integers(6, 60)
            img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 0.8, 3)
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, cfg.max_lights + 1))):
            lw = int(rng.integers(8, 22))            # lamp diameter px
            hw_, hh = lw + 6, 3 * lw + 10            # housing size
            x0 = int(rng.integers(2, W - hw_ - 2))
            y0 = int(rng.integers(2, H - hh - 2))
            img[y0:y0 + hh, x0:x0 + hw_] = rng.uniform(0.02, 0.12)
            lit = int(rng.integers(0, 4))            # 3 = all off
            for slot in range(3):
                cy = y0 + 5 + slot * lw + lw // 2
                cx = x0 + hw_ // 2
                r = lw * 0.42
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                lamp = d2 < r * r
                if slot == lit:
                    col = np.asarray(COLORS[lit])
                    img[lamp] = col
                    # glow halo
                    glow = np.exp(-d2 / (2 * (1.8 * r) ** 2))[..., None]
                    img = img * (1 - 0.5 * glow) + 0.5 * glow * col
                else:
                    img[lamp] = 0.08
            boxes.append([x0, y0, x0 + hw_, y0 + hh])
            labels.append(lit)
        img = np.clip(img * rng.uniform(0.8, 1.2), 0, 1).astype(np.float32)
        return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)

    def batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, G = self.batch_size, cfg.box_capacity
        H, W = cfg.hw
        imgs = np.zeros((B, H, W, 3), np.float32)
        gb = np.zeros((B, G, 4), np.float32)
        gl = np.zeros((B, G), np.int32)
        gm = np.zeros((B, G), bool)
        for b in range(B):
            img, boxes, labels = self.scene()
            imgs[b] = img
            n = min(len(boxes), G)
            gb[b, :n], gl[b, :n], gm[b, :n] = boxes[:n], labels[:n], True
        return dict(image=imgs, gt_boxes=gb, gt_labels=gl, gt_mask=gm)

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.batch()


# --------------------------------------------------------------------------
# evaluations


def _gt(batch, b):
    gm = np.asarray(batch["gt_mask"][b], bool)
    return np.asarray(batch["gt_boxes"][b])[gm], np.asarray(batch["gt_labels"][b])[gm]


@torch.inference_mode()
def mono3d_frames(model, batches, intrinsic: np.ndarray, device: DeviceLike = None,
                  score_thresh: float = 0.25) -> List[Dict]:
    """Per image of ``batches``: the kept detections of ``model`` (the
    port's ``Mono3D`` on ``device``) through ``decode_mono3d`` with the
    config's ``max_objects`` and ``stride``, beside the ground truth."""
    cfg, device = model.cfg, resolve_device(device)
    K = to_device(np.asarray(intrinsic, np.float32), device)
    frames = []
    for batch in batches:
        for b in range(len(batch["image"])):
            img = to_device(batch["image"][b], device).permute(2, 0, 1)[None]
            boxes, scores, labels, valid = fetch(*decode_mono3d(
                maps_hwc(model(img)), K, cfg.max_objects, cfg.stride))
            k = valid & (scores > score_thresh)
            gt_boxes, gt_labels = _gt(batch, b)
            frames.append(dict(boxes=boxes[k], scores=scores[k], labels=labels[k],
                               gt_boxes=gt_boxes, gt_labels=gt_labels))
    return frames


def mono3d_ap(frames: List[Dict], num_classes: int = 4, match_radius: float = 2.0) -> Dict:
    """Centre-distance AP (BEV x/z match within ``match_radius`` m, nuScenes
    convention) per class, its mean, and the mean |depth error| of the
    matched detections, rounded as the reference rounds them."""
    per_class, depth_errs = {}, []
    for cid in range(num_classes):
        recs = []          # (score, tp) over all frames
        n_gt = 0
        for f in frames:
            p = f["labels"] == cid
            g = f["gt_labels"] == cid
            gtb = f["gt_boxes"][g]
            n_gt += len(gtb)
            used = np.zeros(len(gtb), bool)
            order = np.argsort(-f["scores"][p])
            pb, ps = f["boxes"][p][order], f["scores"][p][order]
            for box, sc in zip(pb, ps):
                if len(gtb) == 0:
                    recs.append((sc, 0))
                    continue
                d = np.hypot(box[0] - gtb[:, 0], box[2] - gtb[:, 2])
                j = int(np.argmin(np.where(used, np.inf, d)))
                if (not used[j]) and d[j] < match_radius:
                    used[j] = True
                    recs.append((sc, 1))
                    depth_errs.append(abs(box[2] - gtb[j, 2]))
                else:
                    recs.append((sc, 0))
        if n_gt == 0:
            continue
        if not recs:
            per_class[CLASS_NAMES[cid]] = 0.0
            continue
        recs.sort(key=lambda r: -r[0])
        tp = np.cumsum([r[1] for r in recs])
        fp = np.cumsum([1 - r[1] for r in recs])
        rec = tp / n_gt
        prec = tp / np.maximum(tp + fp, 1)
        # 101-point interpolated AP
        ap = float(np.mean([prec[rec >= t].max() if (rec >= t).any()
                            else 0.0 for t in np.linspace(0, 1, 101)]))
        per_class[CLASS_NAMES[cid]] = round(ap, 4)
    mean_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return dict(mean_ap=round(mean_ap, 4), per_class=per_class,
                mean_abs_depth_err_m=(round(float(np.mean(depth_errs)), 3)
                                      if depth_errs else None),
                n_matched=len(depth_errs))


@torch.inference_mode()
def yolo2d_frames(model, batches, device: DeviceLike = None,
                  score_thresh: float = 0.3) -> List[Dict]:
    """Per image of ``batches``: the boxes of ``model`` (the port's
    ``Yolo2D`` on ``device``) that ``nms_2d`` keeps among the decoded ones
    above ``score_thresh``, beside the ground truth."""
    cfg, device = model.cfg, resolve_device(device)
    frames = []
    for batch in batches:
        for b in range(len(batch["image"])):
            img = to_device(batch["image"][b], device).permute(2, 0, 1)[None]
            boxes, scores, labels, mask = decode_yolo2d(maps_hwc(model(img)), cfg.stride,
                                                        cfg.max_boxes)
            keep = nms_2d(boxes, scores, mask & (scores > score_thresh))
            boxes, scores, labels, keep = fetch(boxes, scores, labels, keep)
            k = keep
            gt_boxes, gt_labels = _gt(batch, b)
            frames.append(dict(boxes=boxes[k], scores=scores[k], labels=labels[k],
                               gt_boxes=gt_boxes, gt_labels=gt_labels))
    return frames


def yolo2d_ap(frames: List[Dict], num_classes: int, iou_thresh: float = 0.5) -> Dict:
    """2D AP per class at ``iou_thresh`` (classes with ground truth) and its mean."""
    per_class = {}
    for cid in range(num_classes):
        pb = [f["boxes"][f["labels"] == cid] for f in frames]
        ps = [f["scores"][f["labels"] == cid] for f in frames]
        gb = [f["gt_boxes"][f["gt_labels"] == cid] for f in frames]
        if sum(len(g) for g in gb) == 0:
            continue
        per_class[cid] = ap_2d(pb, ps, gb, iou_thresh=iou_thresh)["ap"]
    mean_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return dict(mean_ap=mean_ap, per_class=per_class)
