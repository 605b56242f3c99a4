"""The least bytes one LIO scan step needs to move, counted from its shapes
(the phases of the port's ``tools/roofline.py:lio_traffic_model``, without
what only one implementation moves), and its operations, those of B1 at
each iteration: the step's other phases are bound by their bytes.

Phases: undistort (read the raw points and stamps, write the undistorted
points); downsample (read the points, write the residual points); match
(the key probes of every point's 7 voxels and the moment rows gathered);
iterate (per Gauss-Newton iteration, what B1 reads and writes:
``counts/p2p.py``); insert (the moment components, the touched voxels read
and written).  Not counted: restacking the whole moment table, and
Jacobian rows written out and read back, which a fused reduction never
materialises.
"""
from __future__ import annotations

from . import p2p

SURFEL_PROBES = 2
F32 = 4.0


def step_bytes(ds_capacity: int, max_iters: int, raw_points: int) -> float:
    N, it, f = ds_capacity, max_iters, F32
    undistort = raw_points * (3 + 1 + 3) * f
    downsample = raw_points * 4 * f + N * 4 * f
    match = N * 7 * SURFEL_PROBES * f + N * 7 * 10 * f
    iterate = it * p2p.b1_bytes(N)
    insert = N * 10 * f + N * 10 * f * 2
    return undistort + downsample + match + iterate + insert


def step_flops(ds_capacity: int, max_iters: int) -> float:
    return max_iters * p2p.b1_flops(ds_capacity)
