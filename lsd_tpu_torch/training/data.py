"""Detection training data (counterpart of ``lsd_tpu/training/data.py``): a
numpy-only copy of ``pad_points``, ``pad_boxes``, ``LabeledFrameDataset``,
``SyntheticSceneConfig`` and ``SyntheticDetectionDataset``.

- ``LabeledFrameDataset``: annotated ``.pkl`` recordings (frames carrying
  ``gt_boxes`` (G, 7) and ``gt_labels`` (G,)), read through the port's
  ``io.player.FramePlayer``; its shuffle draws from the same seeded numpy
  generator as the reference's, so both give the same batches.
- ``SyntheticDetectionDataset``: procedural scenes; the same seed gives
  byte-equal scenes in both packages.

Batches are numpy: points (B, N, 4), mask (B, N), gt_boxes (B, G, 7),
gt_labels (B, G), gt_mask (B, G).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np


def pad_points(pts: np.ndarray, capacity: int):
    pts = np.asarray(pts, np.float32).reshape(-1, 4)[:capacity]
    buf = np.zeros((capacity, 4), np.float32)
    buf[:len(pts)] = pts
    msk = np.zeros(capacity, bool)
    msk[:len(pts)] = True
    return buf, msk


def pad_boxes(boxes: np.ndarray, labels: np.ndarray, capacity: int):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)[:capacity]
    labels = np.asarray(labels, np.int32).reshape(-1)[:capacity]
    b = np.zeros((capacity, 7), np.float32)
    l = np.zeros(capacity, np.int32)
    m = np.zeros(capacity, bool)
    b[:len(boxes)] = boxes
    l[:len(labels)] = labels
    m[:len(boxes)] = True
    return b, l, m


class LabeledFrameDataset:
    """Batches over annotated recordings (.pkl frame dicts with gt_boxes/
    gt_labels keys: the recorder format plus labels)."""

    def __init__(self, data_path: str, point_capacity: int = 2 ** 17,
                 box_capacity: int = 64, batch_size: int = 2,
                 shuffle: bool = True, seed: int = 0):
        from ..io.player import FramePlayer
        self.player = FramePlayer(data_path)
        self.point_capacity = point_capacity
        self.box_capacity = box_capacity
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.indices = [i for i in range(len(self.player))
                        if "gt_boxes" in self.player.read_dict(i)]

    def __len__(self) -> int:
        return len(self.indices)

    def _one(self, i: int) -> Dict[str, np.ndarray]:
        d = self.player.read_dict(i)
        clouds = [np.asarray(p, np.float32).reshape(-1, 4)
                  for p in (d.get("points") or {}).values()]
        pts = (np.concatenate(clouds, axis=0) if clouds
               else np.zeros((0, 4), np.float32))
        P, M = pad_points(pts, self.point_capacity)
        B, L, GM = pad_boxes(d.get("gt_boxes", np.zeros((0, 7))),
                             d.get("gt_labels", np.zeros(0)),
                             self.box_capacity)
        return dict(points=P, mask=M, gt_boxes=B, gt_labels=L, gt_mask=GM)

    def batches(self, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(epochs):
            order = np.asarray(self.indices)
            if self.shuffle:
                order = self.rng.permutation(order)
            for s in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
                items = [self._one(int(i))
                         for i in order[s:s + self.batch_size]]
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}


@dataclasses.dataclass
class SyntheticSceneConfig:
    n_boxes: int = 8
    points_per_box: int = 256
    clutter_points: int = 8192
    xy_range: float = 40.0
    class_sizes: Sequence = ((4.5, 1.9, 1.6), (0.8, 0.8, 1.7),
                             (1.8, 0.6, 1.6))   # vehicle / ped / cyclist
    # lidar-realistic sampling: sensor at the origin, 1/r point-density
    # falloff, only sensor-facing box faces return points, azimuth shadows
    # behind objects, and wall/pole background clutter.  Off by default
    # (the round-1 uniform sampler) so existing goldens stay stable.
    realistic: bool = False
    sensor_z: float = 1.8
    n_walls: int = 6
    n_poles: int = 12
    min_points_per_gt: int = 5    # realistic mode: drop near-invisible gts
    # place every object at least this far from the sensor (distant-
    # small-object eval slice: the fine-pitch model's regime, where a
    # far pedestrian spans only a few 0.1 m cells)
    min_obj_range: float = 0.0


class SyntheticDetectionDataset:
    """Procedural scenes: each object contributes points sampled on its
    (rotated) box surface above a cluttered ground plane."""

    def __init__(self, cfg: SyntheticSceneConfig = SyntheticSceneConfig(),
                 point_capacity: int = 2 ** 15, box_capacity: int = 16,
                 batch_size: int = 2, seed: int = 0):
        self.cfg = cfg
        self.point_capacity = point_capacity
        self.box_capacity = box_capacity
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def _box_surface(self, rng, dims, n):
        """n uniform surface samples of an axis-aligned box + their
        outward face normals (local frame)."""
        dx, dy, dz = dims
        local = rng.uniform(-0.5, 0.5, (n, 3)) * [dx, dy, dz]
        normals = np.zeros((n, 3))
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        for ax, d in enumerate((dx, dy, dz)):
            sel = face == ax
            local[sel, ax] = sign[sel] * 0.5 * d
            normals[sel, ax] = sign[sel]
        return local, normals

    def scene(self) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        boxes, labels, pts = [], [], []
        sensor = np.asarray([0.0, 0.0, cfg.sensor_z])
        shadows = []          # (azimuth, half_width, range) of each object
        for _ in range(cfg.n_boxes):
            cls = int(rng.integers(0, len(cfg.class_sizes)))
            dx, dy, dz = cfg.class_sizes[cls]
            if cfg.min_obj_range > 0.0:
                rr0 = rng.uniform(cfg.min_obj_range, cfg.xy_range)
                th0 = rng.uniform(-np.pi, np.pi)
                cx, cy = rr0 * np.cos(th0), rr0 * np.sin(th0)
            else:
                cx, cy = rng.uniform(-cfg.xy_range, cfg.xy_range, 2)
            cz = dz / 2.0
            yaw = rng.uniform(-np.pi, np.pi)
            r = float(np.hypot(cx, cy))
            n = cfg.points_per_box
            if cfg.realistic:
                # 1/r density falloff like a spinning lidar
                n = max(16, int(n * min(1.0, (12.0 / max(r, 1.0)) ** 1.5)))
            local, normals = self._box_surface(rng, (dx, dy, dz), n)
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            world = local @ R.T + [cx, cy, cz]
            if cfg.realistic:
                # keep only sensor-facing faces
                vis = np.einsum("ni,ni->n",
                                normals @ R.T, sensor - world) > 0
                world = world[vis]
                # boxes the lidar barely sees are not labels: real
                # datasets exclude <N-point objects from both training
                # targets and eval recall (KITTI DontCare / WOD LEVEL
                # filtering); without this, far occluded boxes put an
                # unreachable floor under the AP
                if len(world) < cfg.min_points_per_gt:
                    continue
                shadows.append((np.arctan2(cy, cx),
                                np.arctan2(max(dx, dy) / 2, max(r, 1.0)),
                                r))
            boxes.append([cx, cy, cz, dx, dy, dz, yaw])
            labels.append(cls)
            inten = rng.uniform(0, 1, (len(world), 1))
            pts.append(np.concatenate([world, inten], 1))

        if cfg.realistic:
            # ground with 1/r lidar density + walls + poles + shadowing
            nrm = cfg.clutter_points
            r_g = 2.0 * (cfg.xy_range / 2.0) ** rng.uniform(0, 1, nrm)
            th_g = rng.uniform(-np.pi, np.pi, nrm)
            ground = np.stack([r_g * np.cos(th_g), r_g * np.sin(th_g),
                               rng.normal(0, 0.02, nrm)], 1)
            extras = [ground]
            for _ in range(cfg.n_walls):
                ang = rng.uniform(-np.pi, np.pi)
                wr = rng.uniform(0.6, 1.0) * cfg.xy_range
                cw = np.asarray([wr * np.cos(ang), wr * np.sin(ang), 1.5])
                tdir = np.asarray([-np.sin(ang), np.cos(ang), 0.0])
                u = rng.uniform(-6, 6, 1200)
                v = rng.uniform(-1.5, 1.5, 1200)
                extras.append(cw + u[:, None] * tdir
                              + v[:, None] * np.asarray([0, 0, 1.0]))
            for _ in range(cfg.n_poles):
                px, py = rng.uniform(-cfg.xy_range, cfg.xy_range, 2)
                h = rng.uniform(0, 4.0, 120)
                extras.append(np.stack(
                    [np.full(120, px) + rng.normal(0, 0.03, 120),
                     np.full(120, py) + rng.normal(0, 0.03, 120), h], 1))
            bg = np.concatenate(extras, 0)
            # azimuth shadows: background behind an object mostly vanishes
            if shadows:
                az = np.arctan2(bg[:, 1], bg[:, 0])
                rr = np.hypot(bg[:, 0], bg[:, 1])
                occ = np.zeros(len(bg), bool)
                for (a0, hw, r0) in shadows:
                    d = np.abs((az - a0 + np.pi) % (2 * np.pi) - np.pi)
                    occ |= (d < hw) & (rr > r0 + 1.0)
                keep = ~occ | (rng.uniform(0, 1, len(bg)) > 0.85)
                bg = bg[keep]
            inten = rng.uniform(0, 1, (len(bg), 1))
            pts.append(np.concatenate([bg, inten], 1))
        else:
            ground = np.concatenate([
                rng.uniform(-cfg.xy_range, cfg.xy_range,
                            (cfg.clutter_points, 2)),
                rng.normal(0.0, 0.02, (cfg.clutter_points, 1)),
                rng.uniform(0, 1, (cfg.clutter_points, 1))], axis=1)
            pts.append(ground)
        P, M = pad_points(np.concatenate(pts, 0).astype(np.float32),
                          self.point_capacity)
        B, L, GM = pad_boxes(np.asarray(boxes), np.asarray(labels),
                             self.box_capacity)
        return dict(points=P, mask=M, gt_boxes=B, gt_labels=L, gt_mask=GM)

    def batches(self, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(steps):
            items = [self.scene() for _ in range(self.batch_size)]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
