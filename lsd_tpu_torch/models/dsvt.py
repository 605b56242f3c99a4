"""DSVT, the Dynamic Sparse Voxel Transformer (Wang et al., CVPR 2023,
arXiv:2301.06051), over pillars: the backbone of DSVT-Pillar (OpenPCDet's
``tools/cfgs/waymo_models/dsvt_pillar.yaml``, ``pcdet/models/backbones_3d/
dsvt.py`` and ``dsvt_input_layer.py``).  The JAX package has no
counterpart.

The pillars of a frame are partitioned, for each of two window shifts and
each of two axes, into sets of ``set_size`` slots (``partition_shift``):

- a pillar's window is ``(coord + shift) // window``; shift 0 is (0, 0) on
  ``window`` cells, shift 1 ``shift`` on the hybrid window ``window *
  hybrid_factor``;
- within a window of N pillars, sorted by their in-window coordinate
  (x-major for the x layer, y-major for the y layer), the window gets
  S = ceil(N / set_size) sets, and slot j of S * set_size takes the pillar
  of sorted rank floor(j N / (S set_size));
- a slot that repeats the slot before it is masked as a key, and each
  pillar takes its output from its first slot.

A layer is x <- LN1(x + MHSA(q = k = x + pe, v = x)) over each set, then
x <- LN2(x + W2 GELU(W1 x)), then LN(x + the layer's input) (OpenPCDet's
``DSVT_EncoderLayer`` around its ``SetAttention``).  A block is an x layer
and a y layer on the block's shift (blocks alternate between the shifts),
with the block's learned position embedding (Linear 2 -> d, BN, ReLU,
Linear d -> d of the in-window coordinate relative to the window's centre,
not normalised) added to queries and keys, and LN(x + the block's input)
around its two layers (``residual_norm_stage``).

Static shapes throughout: ``P`` pillar rows (a frame's pillars in its
first rows, ``pmask`` says which), a set capacity of ``ceil(P / set_size)``
plus the windows of the shift, which no frame can exceed.  No host sync.
Q, K and V are projected per pillar and gathered by the set-attention
kernel (``csrc/dsvt_set_attn.cu``, one launch a layer); on CPU tensors
``set_attention_plain`` stands in.  ``counters`` (a device tensor, added to
without a sync) counts frames, pillars found and kept, sets and repeated
slots; ``set_attention.launches`` the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..utils import cuda_build
from ..utils.spans import span
from .vfe import FoldedLinear, at_least_float32

KEY, WRITE = 1, 2                 # slot flags: a key of its set; writes its pillar


class DSVTConfig(NamedTuple):
    """The published sizes of DSVT-Pillar on Waymo."""
    d_model: int = 192
    heads: int = 8
    ffn: int = 384
    set_size: int = 36
    window: Tuple[int, int] = (12, 12)          # (x, y) cells, shift 0
    shift: Tuple[int, int] = (6, 6)             # (x, y) cells, shift 1
    hybrid_factor: int = 2                      # shift 1's window: window * hybrid_factor
    blocks: int = 4

    def shifts(self) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
        """(window, shift) of shift 0 and shift 1."""
        hw = tuple(w * self.hybrid_factor for w in self.window)
        return [(tuple(self.window), (0, 0)), (hw, tuple(self.shift))]


class SetPartition(NamedTuple):
    inds: torch.Tensor      # (S, set_size) int32 pillar row of each slot (0 in a set not used)
    flags: torch.Tensor     # (S, set_size) uint8: KEY, WRITE
    n_sets: torch.Tensor    # () int64, the sets the frame uses
    repeats: torch.Tensor   # () int64, slots of those sets that repeat the slot before


def partition_shift(coords: torch.Tensor, pmask: torch.Tensor, window, shift, grid_hw,
                    set_size: int) -> Tuple[SetPartition, SetPartition, torch.Tensor]:
    """The x-axis and y-axis partitions of one shift, and each pillar's
    in-window coordinate relative to its window's centre, (P, 2) float32
    [x, y].  coords (P, 3) [z, y, x] int, pmask (P,) bool; ``window`` and
    ``shift`` (x, y) cells; ``grid_hw`` the pillar grid (H, W)."""
    P, dev = coords.shape[0], coords.device
    (wx, wy), (sx, sy), (H, W) = window, shift, grid_hw
    nwx, nwy = -(-W // wx) + 1, -(-H // wy) + 1
    n_win = nwx * nwy
    x = coords[:, 2].long() + sx
    y = coords[:, 1].long() + sy
    cx, cy = x % wx, y % wy
    win = torch.where(pmask, (x // wx) * nwy + y // wy, n_win)
    count = torch.zeros(n_win + 1, dtype=torch.long, device=dev).index_add_(
        0, win, torch.ones_like(win))[:n_win]
    sets = (count + set_size - 1) // set_size
    set_end = torch.cumsum(sets, 0)
    win_end = torch.cumsum(count, 0)
    cap = -(-P // set_size) + n_win
    s = torch.arange(cap, device=dev)
    w = torch.searchsorted(set_end, s, right=True)          # n_win: past the last set
    used = (w < n_win)[:, None]
    w = w.clamp(max=n_win - 1)
    n, m = count[w][:, None], (sets[w] * set_size)[:, None]
    j = (s - set_end[w] + sets[w])[:, None] * set_size + torch.arange(set_size, device=dev)
    pos = torch.where(used, win_end[w][:, None] - n + j * n // m.clamp(min=1), 0)
    slot = s[:, None] * set_size + torch.arange(set_size, device=dev)
    parts = []
    for in_win in (cx * wy + cy, cy * wx + cx):              # x-major, y-major
        order = torch.argsort(win * (wx * wy) + in_win)
        inds = torch.where(used, order[pos], 0)
        rep = torch.zeros(cap, set_size, dtype=torch.bool, device=dev)
        rep[:, 1:] = inds[:, 1:] == inds[:, :-1]
        first = torch.full((P,), cap * set_size, dtype=torch.long, device=dev).scatter_reduce_(
            0, inds.reshape(-1), torch.where(used, slot, cap * set_size).reshape(-1), "amin")
        write = used & (first[inds] == slot)
        flags = (used & ~rep).to(torch.uint8) * KEY + write.to(torch.uint8) * WRITE
        parts.append(SetPartition(inds.to(torch.int32), flags, set_end[-1], (used & rep).sum()))
    rel = torch.stack([cx - wx / 2, cy - wy / 2], dim=-1).float()
    return parts[0], parts[1], rel


# --------------------------------------------------------------------------
# set attention


def set_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        part: SetPartition, heads: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per set, softmax attention
    of each head over the set's key slots, float32 scores and sums, the
    output rounded to the inputs' dtype and written to each pillar from its
    first slot; rows of no written pillar are 0."""
    S, tau = part.inds.shape
    P, D = v.shape
    idx = part.inds.long()

    def rows(t):
        return t[idx].float().reshape(S, tau, heads, D // heads)

    scores = torch.einsum("sihd,sjhd->shij", rows(q), rows(k)) * (1.0 / math.sqrt(D // heads))
    key = (part.flags & KEY).bool()
    scores = scores.masked_fill(~key[:, None, None, :], -torch.inf)
    o = torch.einsum("shij,sjhd->sihd", torch.softmax(scores, -1), rows(v))
    dest = torch.where((part.flags & WRITE).bool(), idx, P).reshape(-1)
    out = v.new_zeros(P + 1, D)
    out[dest] = o.reshape(S * tau, D).to(v.dtype)
    return out[:P]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("dsvt_set_attn")
    lib.dsvt_set_attn_launch.restype = ctypes.c_int
    lib.dsvt_set_attn_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def set_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, part: SetPartition,
                  heads: int) -> torch.Tensor:
    """One set-attention layer: q, k, v (P, D) per-pillar projections (row
    strides may differ), ``part`` the layer's partition -> (P, D), each
    pillar's attention output from its first slot, 0 where no set writes.
    On the card one launch of ``csrc/dsvt_set_attn.cu`` (bf16, D 192, 8
    heads, sets of 36); on the CPU ``set_attention_plain``."""
    dev = v.device
    if dev.type == "cpu":
        return set_attention_plain(q, k, v, part, heads)
    if dev.type != "cuda":
        raise ValueError(f"set_attention: unsupported device {dev}")
    S, tau = part.inds.shape
    P, D = v.shape
    if (D, heads, tau) != (192, 8, 36):
        raise ValueError(f"set_attention: the kernel takes d_model 192, 8 heads and sets of 36, "
                         f"not {D}, {heads} and {tau}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != dev or t.dtype != torch.bfloat16 or t.shape != (P, D) or t.stride(1) != 1
                or t.stride(0) % 8 or t.data_ptr() % 16):
            raise ValueError(f"set_attention: {name} must be ({P}, {D}) bfloat16 rows on {dev}, "
                             "16-byte aligned, row stride a multiple of 8")
    inds, flags = part.inds.contiguous(), part.flags.contiguous()
    if inds.dtype != torch.int32 or flags.dtype != torch.uint8 or inds.device != dev:
        raise ValueError("set_attention: the partition must be int32 rows and uint8 flags "
                         f"on {dev}")
    out = torch.zeros(P, D, dtype=torch.bfloat16, device=dev)
    err = _library().dsvt_set_attn_launch(
        q.data_ptr(), q.stride(0), k.data_ptr(), k.stride(0), v.data_ptr(), v.stride(0),
        inds.data_ptr(), flags.data_ptr(), S, 1.0 / math.sqrt(D // heads), out.data_ptr(),
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"set_attention: kernel launch failed with CUDA error {err}")
    set_attention.launches += 1
    return out


set_attention.launches = 0   # kernel launches since the last reset


# --------------------------------------------------------------------------
# the network


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, the result in ``x``'s dtype."""
    return F.layer_norm(at_least_float32(x), x.shape[-1:], norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class PositionMLP(nn.Module):
    """Linear(2, d), BN, ReLU, Linear(d, d) (OpenPCDet's
    ``PositionEmbeddingLearned``)."""

    def __init__(self, d: int):
        super().__init__()
        self.linear0 = FoldedLinear(2, d, bn=True)
        self.linear1 = FoldedLinear(d, d)

    def forward(self, rel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.linear1(torch.relu(self.linear0(rel.to(dtype))))


class SetAttentionLayer(nn.Module):
    def __init__(self, cfg: DSVTConfig):
        super().__init__()
        d = cfg.d_model
        self.heads = cfg.heads
        self.qkv = FoldedLinear(d, 3 * d)       # PyTorch's in_proj: rows q, k, v
        self.out = FoldedLinear(d, d)
        self.linear1 = FoldedLinear(d, cfg.ffn)
        self.linear2 = FoldedLinear(cfg.ffn, d)
        self.norm1, self.norm2, self.norm = (nn.LayerNorm(d) for _ in range(3))

    def forward(self, x: torch.Tensor, pe: torch.Tensor, part: SetPartition) -> torch.Tensor:
        d = x.shape[-1]
        w, b = self.qkv.w, self.qkv.b
        with span("detect/dsvt/attention"):
            qk = F.linear(x + pe, w[:2 * d], b[:2 * d])
            v = F.linear(x, w[2 * d:], b[2 * d:])
            a = self.out(set_attention(qk[:, :d], qk[:, d:], v, part, self.heads))
            y = layer_norm(self.norm1, x + a)
        with span("detect/dsvt/ffn"):
            y = layer_norm(self.norm2, y + self.linear2(F.gelu(self.linear1(y))))
            return layer_norm(self.norm, y + x)


class DSVTBlock(nn.Module):
    def __init__(self, cfg: DSVTConfig):
        super().__init__()
        self.pos = PositionMLP(cfg.d_model)
        self.layers = nn.ModuleList([SetAttentionLayer(cfg) for _ in range(2)])
        self.norm = nn.LayerNorm(cfg.d_model)


class DSVT(nn.Module):
    """Pillar features (P, d) -> (P, d) after ``cfg.blocks`` blocks."""

    def __init__(self, cfg: DSVTConfig, grid_hw: Tuple[int, int]):
        super().__init__()
        self.cfg, self.grid_hw = cfg, tuple(grid_hw)
        self.blocks = nn.ModuleList([DSVTBlock(cfg) for _ in range(cfg.blocks)])
        # frames, pillars found, pillars kept, sets, repeated slots
        self.register_buffer("counters", torch.zeros(5, dtype=torch.long), persistent=False)

    def forward(self, x: torch.Tensor, coords: torch.Tensor, pmask: torch.Tensor,
                found: torch.Tensor) -> torch.Tensor:
        """x (P, d) in the compute dtype; coords (P, 3) [z, y, x] and pmask
        (P,) of the pillar rows; found () the frame's pillars."""
        with span("detect/dsvt/partition"):
            parts = [partition_shift(coords, pmask, win, sh, self.grid_hw, self.cfg.set_size)
                     for win, sh in self.cfg.shifts()]
            kept = pmask.sum()
            self.counters += torch.stack([
                torch.ones_like(kept), found.to(kept.dtype), kept,
                sum(p.n_sets for xy in parts for p in xy[:2]),
                sum(p.repeats for xy in parts for p in xy[:2])])
        for b, block in enumerate(self.blocks):
            px, py, rel = parts[b % 2]
            with span("detect/dsvt/posembed"):
                pe = block.pos(rel, x.dtype)
            y = x
            for layer, part in zip(block.layers, (px, py)):
                y = layer(y, pe, part)
            x = layer_norm(block.norm, y + x)
        return x
