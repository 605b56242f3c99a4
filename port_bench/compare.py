"""The numbers that decide ``correct``: the widest gaps between what the
program's timed path produced and what the plain reference works out from
the same inputs.  Each is compared with its limit in
``limits/<workload>.json``; ``PERF.md`` gives the readings each limit was
set from."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


# -- LIO ---------------------------------------------------------------

def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle (rad) between stacks of rotations, from the chord
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which stays exact for small
    angles where the arc cosine of the trace does not."""
    chord = np.linalg.norm((Ra - Rb).reshape(len(Ra), -1), axis=1)
    return 2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def lio_gaps(poses, covs, smap, ref_poses, ref_covs, ref_map) -> Dict[str, float]:
    """Program against reference over the same scans: the widest position
    gap (m) and rotation gap (rad) of a scan's pose, the widest gap of a
    scan's covariance relative to that covariance's largest entry, and of
    the surfel map at the last scan: the share of slots whose voxel key
    differs, and the widest gap of a moment relative to the largest
    magnitude of its row (count, sums, second moments)."""
    poses, ref_poses = np.asarray(poses, float), np.asarray(ref_poses, float)
    covs, ref_covs = np.asarray(covs, float), np.asarray(ref_covs, float)
    pos = np.linalg.norm(poses[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    rot = rotation_angle(poses[:, :3, :3], ref_poses[:, :3, :3])
    cov = (np.abs(covs - ref_covs).reshape(len(covs), -1).max(1)
           / np.abs(ref_covs).reshape(len(covs), -1).max(1))
    keys, _, mom = (np.asarray(a) for a in smap)
    rkeys, _, rmom = (np.asarray(a) for a in ref_map)
    used = (keys >= 0) | (rkeys >= 0)
    key_share = float(np.mean(keys[used] != rkeys[used])) if used.any() else 0.0
    same = used & (keys == rkeys)
    scale = np.maximum(np.abs(rmom[:, same]).max(1, initial=0.0), 1e-12)
    mom_gap = float((np.abs(mom[:, same] - rmom[:, same]).max(1, initial=0.0) / scale).max())
    return dict(pose_gap_m=float(pos.max()), rot_gap_rad=float(rot.max()),
                cov_gap_rel=float(cov.max()), map_key_share=key_share,
                map_moment_gap_rel=mom_gap)


# -- detection -----------------------------------------------------------

def _match(a_xy, a_lab, b_xy, b_lab, radius):
    """Greedy one-to-one pairs (i, j) of a and b of one label with centres
    within ``radius``, nearest first."""
    if not len(a_xy) or not len(b_xy):
        return []
    d = np.linalg.norm(a_xy[:, None, :2] - b_xy[None, :, :2], axis=-1)
    d[a_lab[:, None] != b_lab[None, :]] = np.inf
    pairs, used_a, used_b = [], set(), set()
    for flat in np.argsort(d, axis=None):
        i, j = divmod(int(flat), d.shape[1])
        if d[i, j] > radius:
            break
        if i not in used_a and j not in used_b:
            pairs.append((i, j))
            used_a.add(i)
            used_b.add(j)
    return pairs


def box_gaps(boxes, scores, labels, ref_boxes, ref_scores, ref_labels,
             thresholds: Sequence[float], radius: float, floor: float = 0.0) -> Dict[str, float]:
    """One frame's kept detections against the reference's.  Boxes pair
    up by label and centre (within ``radius`` m).  ``score`` is the widest
    score gap of a pair, or, for a box without a partner on the other
    side, how far its score lies above its class's threshold (what it
    would take to drop it); ``box_m`` the widest gap of a pair's centre,
    size or heading (m, m, rad).  Pairs and boxes that score under
    ``floor`` on both sides are left out."""
    thr = np.asarray(thresholds, float)
    pairs = _match(np.asarray(boxes), np.asarray(labels), np.asarray(ref_boxes),
                   np.asarray(ref_labels), radius)
    score, geom = 0.0, 0.0
    for i, j in pairs:
        if max(float(scores[i]), float(ref_scores[j])) < floor:
            continue
        score = max(score, abs(float(scores[i]) - float(ref_scores[j])))
        dh = abs((float(boxes[i][6]) - float(ref_boxes[j][6]) + np.pi) % (2 * np.pi) - np.pi)
        geom = max(geom, float(np.abs(np.asarray(boxes[i][:6]) - np.asarray(ref_boxes[j][:6])).max()), dh)
    lone_a = set(range(len(boxes))) - {i for i, _ in pairs}
    lone_b = set(range(len(ref_boxes))) - {j for _, j in pairs}
    for i in lone_a:
        score = max(score, float(scores[i]) - thr[int(labels[i])])
    for j in lone_b:
        score = max(score, float(ref_scores[j]) - thr[int(ref_labels[j])])
    return dict(score=score, box_m=geom)


def track_gaps(objs: List[dict], ref_objs: List[dict], radius: float) -> Dict[str, float]:
    """One frame's tracked objects against the reference's: the widest gap
    of a pair's box (m, rad), and the tracks without a partner."""
    def arr(o):
        return (np.asarray([x["box"] for x in o], float).reshape(-1, 7),
                np.asarray([x["label"] for x in o], int))
    a, la = arr(objs)
    b, lb = arr(ref_objs)
    pairs = _match(a, la, b, lb, radius)
    geom = 0.0
    for i, j in pairs:
        dh = abs((a[i, 6] - b[j, 6] + np.pi) % (2 * np.pi) - np.pi)
        geom = max(geom, float(np.abs(a[i, :6] - b[j, :6]).max()), dh)
    return dict(box_m=geom, unpaired=float(len(a) + len(b) - 2 * len(pairs)))


def freespace_share(cells: bytes, ref_cells: bytes) -> float:
    """Share of the freespace grid's cells whose state differs."""
    a = np.frombuffer(cells, np.uint8)
    b = np.frombuffer(ref_cells, np.uint8)
    if a.shape != b.shape:
        return 1.0
    return float(np.mean(a != b))
