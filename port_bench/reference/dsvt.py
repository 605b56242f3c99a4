"""A frozen copy of ``lsd_tpu_torch/models/dsvt_plain.py``, the plain
float32 reference of DSVT-Pillar, for the benchmark's output check: it
imports nothing of the program.  Its docstring follows.

DSVT-Pillar in plain float32 PyTorch: the reference the port's
``CenterPointDetector`` on ``DetectorConfig.dsvt_pillar()`` is held to.

It imports nothing of the port, uses no kernel and no capacity, and runs
with TF32 off in ``matmul`` and ``cudnn``.  ``forward(params, points,
device)`` takes the model's ``state_dict`` (the port's parameter names) and
one frame's points and returns the BEV pillar features after the last DSVT
block, scattered to the grid, the six maps, each (H, W, c), as the port's
CenterHead lays them out, and the first layer's attention before its out
projection, with the repeated-key mask and without it.  The partition
follows its equations window by window in numpy:

- a pillar's window is (coord + shift) // window: shift (0, 0) on 12 x 12
  cells, shift (6, 6) on the hybrid 24 x 24 window;
- a window's N pillars sorted by their in-window coordinate, x-major for a
  block's first layer and y-major for its second, make S = ceil(N / 36)
  sets; slot j of S * 36 takes the pillar of sorted rank floor(j N / (S 36));
- a slot that repeats the slot before it in its set is no key; a pillar's
  output comes from its first slot.

The network (OpenPCDet's ``dsvt_pillar.yaml`` as read by the port; the
departures from the published model, listed under ``reduced`` and
``assumed`` in ``port_bench/configs/dsvt-pillar-waymo.json``):

- ``DynPillarVFE``: 10 point features (x, y, z, intensity, the offsets from
  the pillar's mean and from its centre, z's from the middle of the z
  range); the published Waymo model reads 11, with elongation, which the
  port's sweeps do not carry.  Points are kept where x and y fall in the
  grid, z is not checked, as ``DynPillarVFE`` keeps them.
- DSVT, 4 blocks of an x layer and a y layer, blocks alternating between
  the shifts.  Each block has one position MLP, applied to the in-window
  coordinates of the block's shift; OpenPCDet builds one per shift in each
  block and hands a layer the one of its own index.  Each layer ends in
  LN(x + the layer's input), each block in LN(x + the block's input).
- The BEV backbone as published (``BaseBEVResBackbone``).
- The head is the port's CenterHead (a shared 3x3 convolution to 64, then
  per map a 3x3 convolution and a 1x1 to the map, with a freespace map
  ``seg``) in place of the published SeparateHead with its IoU branch.
- BatchNorm in eval mode, as a trained model serves.

``lower``, where given, is applied to the inputs and weights of every
matrix product and convolution: the control that computes in a lower
precision.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

PC_RANGE = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
VOXEL = (0.32, 0.32, 6.0)
D_MODEL, HEADS, SET = 192, 8, 36
WINDOWS = (((12, 12), (0, 0)), ((24, 24), (6, 6)))          # (window, shift) per shift, (x, y)
BLOCKS = 4
STAGES = ((2, 128, 1), (3, 128, 2), (3, 256, 2))             # blocks, channels, stride
UP = (1, 2, 4)
MAPS = (("hm", "heatmap"), ("offset", "offset"), ("z", "z"), ("dim", "dim"), ("rot", "rot"),
        ("seg", "seg"))


def flatten(tree) -> Dict[str, torch.Tensor]:
    """A checkpoint tree nested by the dotted parts of the names
    (``{"params": {...}}``) -> a flat dict of float32 CPU tensors."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = torch.as_tensor(np.array(v))
    walk(tree.get("params", tree), "")
    return out


class _Net:
    def __init__(self, params: Dict[str, torch.Tensor], device, lower: Optional[Callable]):
        self.p = {k: v.to(device) for k, v in params.items()}
        self.lower = lower or (lambda t: t)

    def linear(self, x, name, bias=True):
        w = self.p[name + ".weight"].float()
        b = self.p[name + ".bias"].float() if bias else None
        return F.linear(self.lower(x), self.lower(w), b)

    def bn(self, x, name, eps):
        p = self.p
        return F.batch_norm(x, p[name + ".running_mean"].float(), p[name + ".running_var"].float(),
                            p[name + ".weight"].float(), p[name + ".bias"].float(), False, 0.0, eps)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"].float(),
                            self.p[name + ".bias"].float(), 1e-5)

    def conv(self, x, name, stride=1, padding=0, transposed=False):
        w = self.p[name + ".weight"].float()
        b = self.p.get(name + ".bias")
        b = None if b is None else b.float()
        if transposed:
            return F.conv_transpose2d(self.lower(x), self.lower(w), b, stride)
        return F.conv2d(self.lower(x), self.lower(w), b, stride, padding)


def pillars(points: np.ndarray, pc_range=PC_RANGE):
    """In-grid points -> (cells (M, 2) [y, x] of the frame's pillars, the
    pillar of each kept point, the kept points (n, 4), the grid (H, W))."""
    pts = np.asarray(points, np.float32)
    lo, size = np.asarray(pc_range[:2], np.float32), np.asarray(VOXEL[:2], np.float32)
    H = int(round((pc_range[4] - pc_range[1]) / VOXEL[1]))
    W = int(round((pc_range[3] - pc_range[0]) / VOXEL[0]))
    c = np.floor((pts[:, :2] - lo) / size).astype(np.int64)
    keep = np.all((c >= 0) & (c < [W, H]), axis=1)
    pts, c = pts[keep], c[keep]
    key = c[:, 1] * W + c[:, 0]
    uniq, inv = np.unique(key, return_inverse=True)
    return np.stack([uniq // W, uniq % W], 1), inv, pts, (H, W)


def sets_of(cells: np.ndarray, window, shift, axis: str):
    """The sets of one shift and axis: (S, 36) pillar indices, one row a
    set, windows in the order of their index, by the equations above."""
    (wx, wy), (sx, sy) = window, shift
    x, y = cells[:, 1] + sx, cells[:, 0] + sy
    win = (x // wx) * 10 ** 6 + y // wy
    cx, cy = x % wx, y % wy
    out = []
    for w in np.unique(win):
        members = np.flatnonzero(win == w)
        major, minor = (cx, cy) if axis == "x" else (cy, cx)
        members = members[np.lexsort((minor[members], major[members]))]
        n = len(members)
        s = -(-n // SET)
        j = np.arange(s * SET)
        out.append(members[j * n // (s * SET)].reshape(s, SET))
    return np.concatenate(out, 0)


def set_attention(net: _Net, x, pe, sets: np.ndarray, name: str, mask: bool = True):
    """One layer's set attention: (P, d) -> (P, d), each pillar's heads'
    outputs from its first slot, before the out projection; ``mask=False``
    leaves the repeated slots in as keys."""
    d, hd = D_MODEL, D_MODEL // HEADS
    w, b = net.p[name + ".qkv.linear.weight"].float(), net.p[name + ".qkv.linear.bias"].float()
    idx = torch.as_tensor(sets, device=x.device)
    S = idx.shape[0]
    qk_in, v_in = (x + pe)[idx], x[idx]                       # (S, 36, d)
    q = F.linear(net.lower(qk_in), net.lower(w[:d]), b[:d]).reshape(S, SET, HEADS, hd)
    k = F.linear(net.lower(qk_in), net.lower(w[d:2 * d]), b[d:2 * d]).reshape(S, SET, HEADS, hd)
    v = F.linear(net.lower(v_in), net.lower(w[2 * d:]), b[2 * d:]).reshape(S, SET, HEADS, hd)
    scores = torch.einsum("sihd,sjhd->shij", net.lower(q), net.lower(k)) / math.sqrt(hd)
    repeat = torch.zeros(S, SET, dtype=torch.bool, device=x.device)
    repeat[:, 1:] = idx[:, 1:] == idx[:, :-1]
    if mask:
        scores = scores.masked_fill(repeat[:, None, None, :], -torch.inf)
    o = torch.einsum("shij,sjhd->sihd", net.lower(torch.softmax(scores, -1)), net.lower(v))
    # each pillar from its first slot
    flat = idx.reshape(-1).cpu().numpy()
    _, first = np.unique(flat, return_index=True)
    out = torch.zeros_like(x)
    out[idx.reshape(-1)[first]] = o.reshape(-1, d)[torch.as_tensor(first, device=x.device)]
    return out


def layer(net: _Net, y, pe, sets: np.ndarray, name: str, keep: Optional[dict] = None):
    """One set-attention layer: LN1(y + attention), LN2(. + FFN), LN(. + y);
    the attention before its out projection goes into ``keep``
    (``attention``), with the same computed with the repeated slots left in
    as keys (``unmasked``)."""
    a = set_attention(net, y, pe, sets, name)
    if keep is not None:
        keep.update(attention=a, unmasked=set_attention(net, y, pe, sets, name, mask=False))
    z = net.ln(y + net.linear(a, name + ".out.linear"), name + ".norm1")
    f = net.linear(F.gelu(net.linear(z, name + ".linear1.linear")), name + ".linear2.linear")
    z = net.ln(z + f, name + ".norm2")
    return net.ln(z + y, name + ".norm")


def pillar_features(net: _Net, points: np.ndarray, pc_range=PC_RANGE):
    """The dynamic pillar encoder: (features (M, 192), cells (M, 2) [y, x],
    the grid (H, W))."""
    device = next(iter(net.p.values())).device
    cells, inv, pts, grid_hw = pillars(points, pc_range)
    M = len(cells)
    pts_t = torch.as_tensor(pts[:, :4], device=device)
    inv_t = torch.as_tensor(inv, device=device)
    cells_t = torch.as_tensor(cells, device=device)
    xyz = pts_t[:, :3]
    cnt = torch.zeros(M, device=device).index_add_(0, inv_t, torch.ones(len(pts), device=device))
    mean = torch.zeros(M, 3, device=device).index_add_(0, inv_t, xyz) / cnt[:, None]
    centre = torch.stack([cells_t[:, 1].float() * VOXEL[0] + (VOXEL[0] / 2 + pc_range[0]),
                          cells_t[:, 0].float() * VOXEL[1] + (VOXEL[1] / 2 + pc_range[1])], 1)
    f_center = torch.cat([xyz[:, :2] - centre[inv_t],
                          xyz[:, 2:] - (VOXEL[2] / 2 + pc_range[2])], 1)
    feats = torch.cat([pts_t, xyz - mean[inv_t], f_center], 1)

    def pfn(x, name):
        return torch.relu(net.bn(net.linear(x, name + ".linear", bias=False), name + ".norm",
                                 1e-3))

    def pillar_max(x):
        return torch.full((M, x.shape[1]), -torch.inf, device=device).scatter_reduce(
            0, inv_t[:, None].expand_as(x), x, "amax")
    x = pfn(feats, "vfe.pfn0")
    x = torch.cat([x, pillar_max(x)[inv_t]], 1)
    return pillar_max(pfn(x, "vfe.pfn1")), cells, grid_hw


def dsvt(net: _Net, x, cells: np.ndarray, keep: Optional[dict] = None):
    """The DSVT blocks: pillar features (M, 192) -> (M, 192); the first
    layer's attention before its out projection into ``keep`` (``layer``)."""
    cells_t = torch.as_tensor(cells, device=x.device)
    parts = []
    for window, shift in WINDOWS:
        (wx, wy), (sx, sy) = window, shift
        rel = torch.stack([((cells_t[:, 1] + sx) % wx).float() - wx / 2,
                           ((cells_t[:, 0] + sy) % wy).float() - wy / 2], 1)
        parts.append((sets_of(cells, window, shift, "x"), sets_of(cells, window, shift, "y"), rel))
    for b in range(BLOCKS):
        sx_sets, sy_sets, rel = parts[b % 2]
        pre = f"dsvt.blocks.{b}"
        pe = torch.relu(net.bn(net.linear(rel, pre + ".pos.linear0.linear"),
                               pre + ".pos.linear0.norm", 1e-5))
        pe = net.linear(pe, pre + ".pos.linear1.linear")
        y = x
        for i, sets in enumerate((sx_sets, sy_sets)):
            y = layer(net, y, pe, sets, f"{pre}.layers.{i}", keep if b == i == 0 else None)
        x = net.ln(y + x, pre + ".norm")
    return x


def backbone_and_head(net: _Net, bev) -> Dict[str, torch.Tensor]:
    """The BEV image (H, W, 192) -> the six maps, each (H, W, c)."""
    h = bev.permute(2, 0, 1)[None]
    ups, k = [], 0
    for s, (n, ch, stride) in enumerate(STAGES):
        for i in range(n):
            name = f"backbone.blocks.{k}"
            st = stride if i == 0 else 1
            y = torch.relu(net.bn(net.conv(h, name + ".conv0.conv", st, 1), name + ".conv0.norm",
                                  1e-3))
            y = net.bn(net.conv(y, name + ".conv1.conv", 1, 1), name + ".conv1.norm", 1e-3)
            sc = (net.bn(net.conv(h, name + ".shortcut.conv", st, 0), name + ".shortcut.norm",
                         1e-3) if i == 0 else h)
            h = torch.relu(y + sc)
            k += 1
        name = f"backbone.ups.{s}"
        ups.append(torch.relu(net.bn(net.conv(h, name + ".conv", UP[s], transposed=True),
                                     name + ".norm", 1e-3)))
    shared = torch.relu(net.conv(torch.cat(ups, 1), "head.shared", 1, 1))
    out = {}
    for head, key in MAPS:
        y = torch.relu(net.conv(shared, f"head.heads.{head}.conv1", 1, 1))
        out[key] = net.conv(y, f"head.heads.{head}.out")[0].permute(1, 2, 0)
    return out


def forward(params: Dict[str, torch.Tensor], points: np.ndarray, device,
            lower: Optional[Callable] = None, pc_range=PC_RANGE) -> Dict[str, torch.Tensor]:
    """One frame (N, >=4) -> dict(features (H, W, 192), heatmap, offset, z,
    dim, rot, seg, each (H, W, c); attention0, the first layer's attention
    before its out projection, (M, 192) over the frame's M pillars in key
    order, y then x, and attention0_unmasked, the same with the repeated
    slots left in as keys), float32 on ``device``; ``pc_range`` cuts the grid
    (the published range by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = _Net(params, device, lower)
    with torch.no_grad():
        x, cells, (H, W) = pillar_features(net, points, pc_range)
        first: dict = {}
        x = dsvt(net, x, cells, first)
        bev = torch.zeros(H * W, D_MODEL, device=device)
        bev[torch.as_tensor(cells[:, 0] * W + cells[:, 1], device=device)] = x
        bev = bev.reshape(H, W, D_MODEL)
        return dict(features=bev, attention0=first["attention"],
                    attention0_unmasked=first["unmasked"], **backbone_and_head(net, bev))
