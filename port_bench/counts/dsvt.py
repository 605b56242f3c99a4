"""Operations of one frame through DSVT-Pillar, and the bytes and
operations of one call of its set-attention kernel, from the layer shapes
and a numpy partition of the frame's pillars: the same work whatever
implements it.  A multiply-add is two operations; biases, norms,
activations and softmax are left out.

The partition (``configs/dsvt-pillar-waymo.json``): a pillar's window is
(cell + shift) // window, shift (0, 0) on 12 x 12 cells and (6, 6) on the
hybrid 24 x 24; a window of N pillars gets ceil(N / 36) sets, the same for
the x and the y layer of a shift; slots beyond N repeat a pillar.

The network: the dynamic pillar encoder (Linear 10 -> 96 and 192 -> 192 on
every point in the grid); per block the position MLP (Linear 2 -> 192 and
192 -> 192 on every pillar) and two layers, each with its projections on
every pillar (q and k 192 -> 384, v and out 192 -> 192, FFN 192 -> 384 ->
192) and its attention on every set (scores and values: 2 x 2 x 36 x 36 x
192); the BEV backbone on the 468 x 468 grid (stages of 2, 3, 3 basic
blocks of 128, 128, 256 channels at strides 1, 2, 2, a 1x1 shortcut on each
stage's first block; up paths to 128 channels by transposed convolutions
of kernel and stride 1, 2, 4); the head (a 3x3 convolution of 384 to 64,
then per map a 3x3 of 64 to 64 and a 1x1 to the map's channels).

The kernel's call (one set-attention layer): it reads each pillar's q, k
and v rows (3 x 192 bf16) once and writes its output row (192 bf16), and
reads an int32 index and a byte of flags a slot; its operations are the
attention's, 2 x 2 x 36 x 36 x 192 a set.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

SET, D, FFN = 36, 192, 384
WINDOWS = (((12, 12), (0, 0)), ((24, 24), (6, 6)))
BLOCKS = 4
STAGES = ((2, 128, 1), (3, 128, 2), (3, 256, 2))
UP_STRIDES, UP_CHANNELS = (1, 2, 4), 128
HEAD_CH = 64
MAP_CHANNELS = (None, 2, 1, 3, 2, 1)     # heatmap (classes), offset, z, dim, rot, seg
BF16 = 2


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * k * k * cin * cout * h_out * w_out


def grid(cfg: dict) -> Tuple[int, int]:
    r, v = cfg["pc_range"], cfg["voxel_size"]
    return int(round((r[4] - r[1]) / v[1])), int(round((r[3] - r[0]) / v[0]))


def pillar_cells(points: np.ndarray, cfg: dict) -> Tuple[np.ndarray, int]:
    """(the frame's pillars as (M, 2) [y, x] cells, the points in the grid):
    a point's cell is floor((p - min) / size) of its x and y in float32."""
    H, W = grid(cfg)
    lo = np.asarray(cfg["pc_range"][:2], np.float32)
    size = np.asarray(cfg["voxel_size"][:2], np.float32)
    c = np.floor((np.asarray(points[:, :2], np.float32) - lo) / size).astype(np.int64)
    c = c[np.all((c >= 0) & (c < [W, H]), axis=1)]
    key = np.unique(c[:, 1] * W + c[:, 0])
    return np.stack([key // W, key % W], 1), len(c)


def shift_sets(cells: np.ndarray, window, shift) -> Tuple[int, int]:
    """(sets, repeated slots) of one shift's partition, either axis."""
    (wx, wy), (sx, sy) = window, shift
    win = ((cells[:, 1] + sx) // wx) * 10 ** 6 + (cells[:, 0] + sy) // wy
    _, n = np.unique(win, return_counts=True)
    sets = -(-n // SET)
    return int(sets.sum()), int((sets * SET - n).sum())


def frame_partition(cells: np.ndarray) -> List[Tuple[int, int]]:
    return [shift_sets(cells, w, s) for w, s in WINDOWS]


def dense_flops(cfg: dict) -> float:
    """The BEV backbone and the head on the pillar grid."""
    H, W = grid(cfg)
    total, cin, h, w = 0.0, D, H, W
    for s, (n, ch, st) in enumerate(STAGES):
        h, w = -(-h // st), -(-w // st)
        for b in range(n):
            c0 = cin if b == 0 else ch
            total += conv(c0, ch, 3, h, w) + conv(ch, ch, 3, h, w)
            if b == 0:
                total += conv(c0, ch, 1, h, w)
        total += conv(ch, UP_CHANNELS, UP_STRIDES[s], h, w)
        cin = ch
    total += conv(UP_CHANNELS * len(STAGES), HEAD_CH, 3, H, W)
    for c in MAP_CHANNELS:
        total += conv(HEAD_CH, HEAD_CH, 3, H, W) + conv(HEAD_CH, c or cfg["num_classes"], 1, H, W)
    return total


def attn_flops(n_sets: int) -> float:
    return 2.0 * 2 * SET * SET * D * n_sets


def attn_bytes(n_pillars: int, n_sets: int) -> float:
    return n_pillars * 4 * D * BF16 + n_sets * SET * (4 + 1)


def network_flops(cfg: dict, n_points: int, n_pillars: int, sets: List[Tuple[int, int]]) -> float:
    """One frame: ``n_points`` in the grid, ``n_pillars``, and the (sets,
    repeats) of shift 0 and shift 1."""
    P = n_pillars
    vfe = 2.0 * n_points * (10 * (D // 2) + D * D)
    layer = 2.0 * P * (D * 2 * D + D * D + D * D + 2 * D * FFN)
    dsvt = 0.0
    for b in range(BLOCKS):
        dsvt += 2.0 * P * (2 * D + D * D) + 2 * (layer + attn_flops(sets[b % 2][0]))
    return vfe + dsvt + dense_flops(cfg)


def frame_counts(points: np.ndarray, cfg: dict) -> Dict[str, float]:
    """Everything the metrics read of one frame."""
    cells, n_points = pillar_cells(points, cfg)
    sets = frame_partition(cells)
    P = len(cells)
    calls = [sets[b % 2][0] for b in range(BLOCKS) for _ in range(2)]
    return dict(pillars=P, points=n_points, sets=sum(2 * s for s, _ in sets),
                repeats=sum(2 * r for _, r in sets),
                flops=network_flops(cfg, n_points, P, sets),
                attn_bytes=float(np.mean([attn_bytes(P, s) for s in calls])),
                attn_flops=float(np.mean([attn_flops(s) for s in calls])))
