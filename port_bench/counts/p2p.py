"""The fused point-to-plane reduction B1 (``csrc/p2p_reduce.cu``): what one
call needs at N residual points, pose block only (the main path's
``est_extrinsic=False``).

Bytes: each input read once, each output written once: per point the
lidar-frame point (3), the plane normal (3) and offset (1) and the weight
(1), float32; the rotations R and Re (9 + 9) and the translations te and
pos (3 + 3) once; out HtH (24 x 24), Htr (24) and three statistics.

Operations per point (float32): the world point R (Re p + te) + pos (two
3x3 products and adds: 2 x 18); the residual n.x + d (6); the validity
gate s = 1 - 0.9 |r| / sqrt(|p|) (|p|: 5, sqrt, divide, multiply-add: 9);
the Jacobian row, n^T R (15) and its cross product with the body point
(9); the weighted row (6); the upper triangle of the 6x6 outer product
(21 multiplies + 21 adds) and Htr (6 + 6); the statistics (3).
"""
from __future__ import annotations

FLOPS_PER_POINT = 2 * 18 + 6 + 9 + 15 + 9 + 6 + 42 + 12 + 3
BYTES_PER_POINT = (3 + 3 + 1 + 1) * 4
FIXED_IN_BYTES = (9 + 9 + 3 + 3) * 4
OUT_BYTES = (24 * 24 + 24 + 3) * 4


def b1_bytes(n: int) -> int:
    return n * BYTES_PER_POINT + FIXED_IN_BYTES + OUT_BYTES


def b1_flops(n: int) -> int:
    return n * FLOPS_PER_POINT
