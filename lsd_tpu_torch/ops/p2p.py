"""Fused point-to-plane measurement reduction of the LIO iteration.

Counterpart of ``lsd_tpu/ops/pallas_p2p.py:p2p_reduce`` (the repo's one
Pallas TPU kernel).  ``p2p_reduce`` launches the hand-written CUDA kernel
``csrc/p2p_reduce.cu`` for CUDA tensors and runs ``p2p_reduce_plain`` for
CPU tensors; a CUDA tensor never falls back to the plain version.

Both return (HtH (24, 24), Htr (24,), stats (3,)) with
stats = [n_valid, sum |r| over valid points, sum of valid weights], the
order the reference's code returns (its docstring lists another order).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils import cuda_build

_ACTIVE = (slice(0, 6), slice(18, 24))   # Jacobian rows 0:6 and 6:12 in the 24-dim layout


def _scatter_24(G: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    HtH = G.new_zeros(24, 24)
    Htr = g.new_zeros(24)
    for a, sa in enumerate(_ACTIVE):
        Htr[sa] = g[6 * a:6 * a + 6]
        for b, sb in enumerate(_ACTIVE):
            HtH[sa, sb] = G[6 * a:6 * a + 6, 6 * b:6 * b + 6]
    return HtH, Htr


def p2p_reduce_plain(pts_l: torch.Tensor, normals: torch.Tensor, d: torch.Tensor,
                     weight: torch.Tensor, R: torch.Tensor, Re: torch.Tensor,
                     te: torch.Tensor, pos: torch.Tensor, max_resid: float,
                     est_extrinsic: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused reduction (the CPU path and the
    reference the kernel is held to).

    The per-point arithmetic is written out element by element in the same
    order as the kernel, so the two round alike and the validity gate
    decides the same points.
    """
    x, y, z = pts_l[:, 0], pts_l[:, 1], pts_l[:, 2]
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    est = 1.0 if est_extrinsic else 0.0
    pbx = Re[0, 0] * x + Re[0, 1] * y + Re[0, 2] * z + te[0]
    pby = Re[1, 0] * x + Re[1, 1] * y + Re[1, 2] * z + te[1]
    pbz = Re[2, 0] * x + Re[2, 1] * y + Re[2, 2] * z + te[2]
    pwx = R[0, 0] * pbx + R[0, 1] * pby + R[0, 2] * pbz + pos[0]
    pwy = R[1, 0] * pbx + R[1, 1] * pby + R[1, 2] * pbz + pos[1]
    pwz = R[2, 0] * pbx + R[2, 1] * pby + R[2, 2] * pbz + pos[2]
    r = nx * pwx + ny * pwy + nz * pwz + d
    ar = torch.abs(r)
    # FAST-LIO validity gate: s = 1 - 0.9 |r| / sqrt(|p_l|) > 0.9
    pnorm = torch.sqrt(x * x + y * y + z * z)
    s = 1.0 - 0.9 * ar / torch.sqrt(torch.clamp(pnorm, min=1e-3))
    valid = (weight > 0.0) & (s > 0.9) & (ar < max_resid)
    w = torch.where(valid, weight, 0.0)

    nRx = nx * R[0, 0] + ny * R[1, 0] + nz * R[2, 0]
    nRy = nx * R[0, 1] + ny * R[1, 1] + nz * R[2, 1]
    nRz = nx * R[0, 2] + ny * R[1, 2] + nz * R[2, 2]
    nRRex = nRx * Re[0, 0] + nRy * Re[1, 0] + nRz * Re[2, 0]
    nRRey = nRx * Re[0, 1] + nRy * Re[1, 1] + nRz * Re[2, 1]
    nRRez = nRx * Re[0, 2] + nRy * Re[1, 2] + nRz * Re[2, 2]
    J = torch.stack([
        nx, ny, nz,
        -(nRy * pbz - nRz * pby), -(nRz * pbx - nRx * pbz), -(nRx * pby - nRy * pbx),
        -(nRRey * z - nRRez * y) * est, -(nRRez * x - nRRex * z) * est,
        -(nRRex * y - nRRey * x) * est,
        nRx * est, nRy * est, nRz * est], dim=1)                # (N, 12)
    # zero invalid rows so non-finite values of skipped points cannot leak
    Jw = torch.where(valid[:, None], J * w[:, None], 0.0)
    J = torch.where(valid[:, None], J, 0.0)
    rv = torch.where(valid, r, 0.0)
    HtH, Htr = _scatter_24(Jw.T @ J, Jw.T @ rv)
    vf = valid.to(r.dtype)
    stats = torch.stack([vf.sum(), (vf * ar).sum(), w.sum()])
    return HtH, Htr, stats


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"p2p_reduce: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"p2p_reduce: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"p2p_reduce: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"p2p_reduce: {name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("p2p_reduce")
    lib.p2p_reduce_launch.restype = ctypes.c_int
    lib.p2p_reduce_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_void_p] * 5)
    lib.p2p_reduce_scratch_floats.restype = ctypes.c_int
    lib.p2p_reduce_scratch_floats.argtypes = []
    return lib


def p2p_reduce(pts_l: torch.Tensor, normals: torch.Tensor, d: torch.Tensor,
               weight: torch.Tensor, R: torch.Tensor, Re: torch.Tensor,
               te: torch.Tensor, pos: torch.Tensor, max_resid: float,
               est_extrinsic: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused measurement reduction, in the reference's argument order.

    pts_l (N, 3) lidar-frame points; normals (N, 3) and d (N,) world planes
    n.x + d = 0; weight (N,) = mask * inv_var (0 disables a point); R, Re
    (3, 3) body and extrinsic rotations; te, pos (3,).  All float32,
    contiguous, on one device.  Returns (HtH (24, 24), Htr (24,),
    stats (3,) = [n_valid, sum |r|, sum w]).
    """
    dev = pts_l.device
    n = pts_l.shape[0]
    for name, t, shape in (("pts_l", pts_l, (n, 3)), ("normals", normals, (n, 3)),
                           ("d", d, (n,)), ("weight", weight, (n,)),
                           ("R", R, (3, 3)), ("Re", Re, (3, 3)),
                           ("te", te, (3,)), ("pos", pos, (3,))):
        _check(name, t, shape, dev)
    if dev.type == "cpu":
        return p2p_reduce_plain(pts_l, normals, d, weight, R, Re, te, pos,
                                max_resid, est_extrinsic)
    if dev.type != "cuda":
        raise ValueError(f"p2p_reduce: unsupported device {dev}")
    if n >= 2 ** 31:
        raise ValueError(f"p2p_reduce: {n} points exceed the kernel's int32 index")

    lib = _library()
    # device parameter buffer: no host round trip for the pose.  params and
    # scratch go back to PyTorch's stream-ordered allocator when this
    # returns; work that reuses them is queued after the kernel on the stream
    params = torch.cat([R.reshape(-1), Re.reshape(-1), te, pos])
    scratch = torch.empty(lib.p2p_reduce_scratch_floats(), dtype=torch.float32, device=dev)
    HtH = torch.empty((24, 24), dtype=torch.float32, device=dev)
    Htr = torch.empty((24,), dtype=torch.float32, device=dev)
    stats = torch.empty((3,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p2p_reduce_launch(
            pts_l.data_ptr(), normals.data_ptr(), d.data_ptr(), weight.data_ptr(),
            params.data_ptr(), n, float(max_resid), 1.0 if est_extrinsic else 0.0,
            scratch.data_ptr(), HtH.data_ptr(), Htr.data_ptr(), stats.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"p2p_reduce: kernel launch failed with CUDA error {err}")
    p2p_reduce.launches += 1
    return HtH, Htr, stats


p2p_reduce.launches = 0   # kernel launches (pairs of passes) since the last reset
