"""CenterPoint-style detector: pillars -> BEV CNN -> heads (counterpart of
``lsd_tpu/models/detector.py:24-137``).

``encoder="dsvt"`` (``DetectorConfig.dsvt_pillar()``, no counterpart) is
DSVT-Pillar: the dynamic pillar encoder (``vfe.py:DynPillarVFE``), the
sparse window transformer over the pillars (``dsvt.py``), the scatter to
the BEV image, OpenPCDet's ``BaseBEVResBackbone`` (``bev_backbone.py``)
and the port's CenterHead at the pillar pitch.  Its
BatchNorms serve in eval mode, folded once by ``fold`` after the weights
are loaded and the model moved to its device.

``DetectorConfig`` carries the reference's fields, properties and the two
capacities that ship trained weights.  ``CenterPointDetector`` takes a
``dtype`` (the reference's bf16 by default; float32 builds a twin for
checks, and float64, with ``.double()``, a reference for float32's own
rounding) and returns the prediction maps in the reference's (H, W, C)
layout; ``forward_batch`` runs a batch of frames through one backbone call
(GroupNorm normalises each sample alone, so a frame's maps do not depend on
the others).

Training (``lsd_tpu/models/detector.py:144-258``): ``make_target_maps``,
``make_seg_target`` and ``detection_loss`` take one frame or a batch (a
leading axis) and give one frame's values, or one per frame: the loss
normalises each frame by its own positives and regression cells, as the
reference's ``vmap`` does.  Where two boxes share a head cell, the
reference's ``.at[flat].set`` keeps the last one (XLA on the CPU);
``last_wins`` makes that deterministic on any device (a ``scatter_reduce``
of the box index, then a gather), where ``index_put_`` with repeated
indices is undefined on CUDA.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.voxelize import pillarize_dynamic, voxelize_dynamic
from ..utils.spans import span
from .bev_backbone import BaseBEVResBackbone, BEVBackbone
from .center_head import HEATMAP_BIAS, CenterHead, decode_boxes
from .dsvt import DSVT, DSVTConfig
from .vfe import (POINT_FEATURES, DynPillarVFE, MeanVFE, PillarVFE, VoxelHeightEncoder,
                  at_least_float32, scatter_to_bev, scatter_to_bev_s2d, scatter_to_voxel_bev)

# the axes of an (H, W, c) map, summed per frame by the loss
_HWC = (-3, -2, -1)
# DSVT-Pillar's pillar rows (DetectorConfig.dsvt_pillar)
DSVT_PILLARS = 73728
# OpenPCDet BaseBEVResBackbone of dsvt_pillar.yaml: 1 + LAYER_NUMS [1, 2, 2]
# blocks, LAYER_STRIDES [1, 2, 2], NUM_FILTERS [128, 128, 256], 128 up each
DSVT_BACKBONE = dict(layer_nums=(2, 3, 3), channels=(128, 128, 256), strides=(1, 2, 2),
                     up_channels=(128, 128, 128))


class DetectorConfig(NamedTuple):
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -3.0, 51.2, 51.2, 3.0)
    voxel_size: Tuple[float, ...] = (0.4, 0.4, 6.0)
    max_voxels: int = 16384
    max_points_per_voxel: int = 16
    num_classes: int = 3
    pillar_filters: int = 64
    max_boxes: int = 256
    # stride of the first backbone stage = stride of the head maps relative
    # to the pillar grid (2 decodes a 640^2 grid on 320^2 maps)
    bev_stride: int = 1
    # "pillar": PillarVFE -> scatter_to_bev; "voxel": MeanVFE over 3D voxels
    # -> height-compressed BEV volume -> VoxelHeightEncoder (voxel_size[2]
    # sets the z bins); "dsvt": DynPillarVFE (no cap on points a pillar:
    # max_points_per_voxel is not read) -> DSVT -> scatter_to_bev ->
    # BaseBEVResBackbone, with max_voxels the pillar capacity
    encoder: str = "pillar"
    # space-to-depth scatter factor: pillars at the fine pitch scattered into
    # a grid_hw / s2d_factor image with s2d_factor^2 channel groups; 1 = off
    s2d_factor: int = 1

    @property
    def grid_hw(self) -> Tuple[int, int]:
        W = int(round((self.pc_range[3] - self.pc_range[0]) / self.voxel_size[0]))
        H = int(round((self.pc_range[4] - self.pc_range[1]) / self.voxel_size[1]))
        return H, W

    @property
    def grid_z(self) -> int:
        return int(round((self.pc_range[5] - self.pc_range[2]) / self.voxel_size[2]))

    @property
    def head_stride(self) -> int:
        """Stride of the head maps relative to the FINE voxel grid
        (space-to-depth factor x backbone first-stage stride)."""
        return self.bev_stride * self.s2d_factor

    @property
    def head_hw(self) -> Tuple[int, int]:
        H, W = self.grid_hw
        return H // self.head_stride, W // self.head_stride

    @classmethod
    def reference_capacity(cls) -> "DetectorConfig":
        """0.2 m pillars over +-64 m: a 640^2 grid, head at 0.4 m cells,
        65,536 pillars of 8 points."""
        return cls(pc_range=(-64.0, -64.0, -3.0, 64.0, 64.0, 3.0),
                   voxel_size=(0.2, 0.2, 6.0),
                   max_voxels=65536, max_points_per_voxel=8,
                   bev_stride=2)

    @classmethod
    def true_reference_capacity(cls) -> "DetectorConfig":
        """The deployed pitch: 0.1 m pillars over [-64, -64, -2, 64, 64, 4]
        (a 1280^2 fine grid), space-to-depth(2) into a 640^2 x 256-channel
        BEV image, head at 0.4 m cells, 131,072 pillars of 5 points."""
        return cls(pc_range=(-64.0, -64.0, -2.0, 64.0, 64.0, 4.0),
                   voxel_size=(0.1, 0.1, 6.0),
                   max_voxels=131072, max_points_per_voxel=5,
                   pillar_filters=64, bev_stride=2, s2d_factor=2)

    @classmethod
    def dsvt_pillar(cls) -> "DetectorConfig":
        """DSVT-Pillar at its published Waymo sizes (OpenPCDet
        ``dsvt_pillar.yaml``): 0.32 m pillars over +-74.88 m, z -2..4 (a
        468^2 grid), 192-wide pillars, the head at the pillar pitch, 3
        classes; 73,728 pillar rows, 1.33 times the most that any of 4,400
        169,600-point Waymo-top-like sweeps of the benchmark's drives
        filled (PERF.md §4)."""
        return cls(pc_range=(-74.88, -74.88, -2.0, 74.88, 74.88, 4.0),
                   voxel_size=(0.32, 0.32, 6.0), max_voxels=DSVT_PILLARS,
                   max_points_per_voxel=0, pillar_filters=192, bev_stride=1,
                   encoder="dsvt")


class CenterPointDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        if cfg.encoder == "dsvt":
            self.vfe = DynPillarVFE(cfg.pillar_filters, tuple(cfg.voxel_size),
                                    tuple(cfg.pc_range), dtype=dtype)
            self.dsvt = DSVT(DSVTConfig(d_model=cfg.pillar_filters), cfg.grid_hw)
            self.backbone = BaseBEVResBackbone(cfg.pillar_filters, **DSVT_BACKBONE)
            self.head = CenterHead(self.backbone.out_channels, cfg.num_classes, dtype=dtype)
            return
        if cfg.encoder == "voxel":
            self.mean_vfe = MeanVFE()
            self.encoder = VoxelHeightEncoder(cfg.grid_z * POINT_FEATURES, cfg.pillar_filters,
                                              dtype=dtype)
            bev_channels = cfg.pillar_filters
        else:
            self.vfe = PillarVFE(cfg.pillar_filters, tuple(cfg.voxel_size), tuple(cfg.pc_range),
                                 dtype=dtype)
            bev_channels = cfg.pillar_filters * cfg.s2d_factor ** 2
        self.backbone = BEVBackbone(bev_channels, strides=(cfg.bev_stride, 2, 2), dtype=dtype)
        self.head = CenterHead(self.backbone.out_channels, cfg.num_classes, dtype=dtype)

    def fold(self) -> "CenterPointDetector":
        """Fold each eval-mode BatchNorm into the layer before it and cast
        those weights to ``dtype`` (the DSVT path's; a no-op elsewhere).
        Call it after the weights are loaded and the model is on its
        device; the model serves only folded."""
        for m in self.modules():
            if m is not self and hasattr(m, "fold"):
                m.fold(self.dtype)
        return self

    def encode(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """points (N, 4), mask (N,) -> the BEV image (H, W, C) the backbone
        takes."""
        cfg = self.cfg
        if cfg.encoder == "dsvt":
            return self._encode_dsvt(points, mask)
        with span("detect/voxelize"):
            voxels, coords, num_pts, vmask = voxelize_dynamic(
                points, mask, cfg.voxel_size, cfg.pc_range, cfg.max_voxels,
                cfg.max_points_per_voxel)
        with span("detect/vfe"):
            if cfg.encoder == "voxel":
                feats = self.mean_vfe(voxels, num_pts) * vmask[:, None]
            else:
                feats = self.vfe(voxels, coords, num_pts) * vmask[:, None]
        with span("detect/scatter"):
            if cfg.encoder == "voxel":
                return scatter_to_voxel_bev(feats, coords, vmask, cfg.grid_hw, cfg.grid_z)
            if cfg.s2d_factor > 1:
                return scatter_to_bev_s2d(feats, coords, vmask, cfg.grid_hw, cfg.s2d_factor)
            return scatter_to_bev(feats, coords, vmask, cfg.grid_hw)

    def _encode_dsvt(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with span("detect/voxelize"):
            order, seg, cells, coords, pmask, found = pillarize_dynamic(
                points, mask, cfg.voxel_size, cfg.pc_range, cfg.max_voxels)
        with span("detect/vfe"):
            feats = self.vfe(points[order], seg, cells, cfg.max_voxels)
        with span("detect/dsvt"):
            feats = self.dsvt(feats, coords, pmask, found)
        with span("detect/scatter"):
            return scatter_to_bev(feats, coords, pmask, cfg.grid_hw)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """points (N, 4), mask (N,) -> prediction maps, each (H, W, c)
        float32 at the head's resolution."""
        # (H, W, C) viewed as (1, C, H, W) in channels-last memory: no copy
        x = self.encode(points, mask)[None].permute(0, 3, 1, 2)
        return {k: v[0] for k, v in self._maps(x).items()}

    def forward_batch(self, points: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """points (B, N, 4), mask (B, N) -> prediction maps, each (B, H, W, c)."""
        bev = torch.stack([self.encode(p, m) for p, m in zip(points, mask)])
        return self._maps(bev.permute(0, 3, 1, 2))

    def _maps(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """BEV images (B, C, H, W) -> the heads' maps, each (B, H, W, c)."""
        with span("detect/backbone"):
            if self.cfg.encoder == "voxel":
                # its GroupNorm is per BEV row of one image (VoxelHeightEncoder)
                x = torch.cat([self.encoder(x[i:i + 1]) for i in range(x.shape[0])])
            x = self.backbone(x)
        with span("detect/head"):
            maps = self.head(x)
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}

    def decode(self, preds: Dict[str, torch.Tensor]):
        with span("detect/decode"):
            return decode_boxes(preds, self.cfg.voxel_size, self.cfg.pc_range,
                                stride=self.cfg.head_stride, max_boxes=self.cfg.max_boxes)


def init_detector_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Fill ``model``'s parameters as flax initialises the reference's:
    kernels from a normal of variance 1/fan_in truncated at two standard
    deviations (LeCun normal), biases 0, norm scales 1, the heatmap's bias
    ``HEATMAP_BIAS``.  The numbers differ from flax's (another generator)."""
    # the standard deviation of the standard normal truncated at +-2
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.fill_(HEATMAP_BIAS if name.endswith("heads.hm.out.bias") else 0.0)
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                # Linear (out, in), Conv2d (out, in, kh, kw), ConvTranspose2d (in, out, kh, kw)
                owner = model.get_submodule(name.rsplit(".", 1)[0])
                fan_in = (p.shape[0] * p[0, 0].numel() if isinstance(owner, nn.ConvTranspose2d)
                          else p[0].numel())
                std = math.sqrt(1.0 / fan_in) / trunc_std
                w = nn.init.trunc_normal_(torch.empty(p.shape), std=std, a=-2.0 * std,
                                          b=2.0 * std, generator=generator)
                p.copy_(w)


# --------------------------------------------------------------------------
# training targets and loss (CenterPoint-style)


def as_batch(*tensors):
    """(one frame?, the tensors with a leading batch axis)."""
    one = tensors[0].dim() == 2
    return one, [t[None] if one else t for t in tensors]


def last_wins(flat: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, rows): for each row, the index along G of the last entry of
    ``flat`` (B, G) that names it, or -1."""
    order = torch.arange(flat.shape[-1], device=flat.device).expand_as(flat)
    return torch.full((flat.shape[0], rows), -1, dtype=order.dtype,
                      device=flat.device).scatter_reduce(1, flat, order, "amax")


def make_target_maps(cfg: DetectorConfig, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gaussian heatmap and regression targets at the head's resolution for
    (G, 7) boxes, or (B, G, 7): maps (H, W, c) or (B, H, W, c), and
    ``reg_mask`` (H, W) or (B, H, W)."""
    one, (gt_boxes, gt_labels, gt_mask) = as_batch(gt_boxes, gt_labels, gt_mask)
    B = gt_boxes.shape[0]
    H, W = cfg.head_hw
    dev = gt_boxes.device
    vx = cfg.voxel_size[0] * cfg.head_stride
    vy = cfg.voxel_size[1] * cfg.head_stride
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]

    cx = (gt_boxes[..., 0] - cfg.pc_range[0]) / vx                    # (B, G)
    cy = (gt_boxes[..., 1] - cfg.pc_range[1]) / vy
    radius = torch.clamp(torch.maximum(gt_boxes[..., 3] / vx, gt_boxes[..., 4] / vy) / 2.0,
                         2.0, 12.0)
    d2 = (xx - cx[..., None, None]) ** 2 + (yy - cy[..., None, None]) ** 2
    g = torch.exp(-d2 / (2 * (radius[..., None, None] / 3.0) ** 2))
    g = g * gt_mask[..., None, None]
    # jax.nn.one_hot: a label out of range is all zeros
    onehot = (gt_labels[..., None] == torch.arange(cfg.num_classes, device=dev)).float()
    heatmap = torch.amax(g[..., None] * onehot[:, :, None, None, :], dim=1)    # (B, H, W, C)

    # regression targets at each box's centre cell; where boxes share a cell
    # the last one wins
    ix = torch.clamp(torch.floor(cx).long(), 0, W - 1)
    iy = torch.clamp(torch.floor(cy).long(), 0, H - 1)
    flat = torch.where(gt_mask, iy * W + ix, H * W)
    winner = last_wins(flat, H * W + 1)[:, :H * W]
    has = winner >= 0
    pick = winner.clamp(min=0)

    def scatter(vals):
        out = torch.gather(vals, 1, pick[..., None].expand(-1, -1, vals.shape[-1]))
        return torch.where(has[..., None], out, 0.0).reshape(B, H, W, vals.shape[-1])

    out = dict(heatmap=heatmap,
               offset=scatter(torch.stack([cx - ix, cy - iy], -1)),
               z=scatter(gt_boxes[..., 2:3]),
               dim=scatter(torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-3))),
               rot=scatter(torch.stack([torch.sin(gt_boxes[..., 6]),
                                        torch.cos(gt_boxes[..., 6])], -1)),
               reg_mask=has.float().reshape(B, H, W))
    return {k: v[0] for k, v in out.items()} if one else out


def make_seg_target(cfg: DetectorConfig, points: torch.Tensor, mask: torch.Tensor,
                    ground_z: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drivable-area BEV targets from the scan's own geometry: a head cell
    with returns that are all low and flat is drivable, one with anything
    tall is an obstacle, an empty one is unknown (masked out of the loss).
    points (N, 4) or (B, N, 4) -> (seg, seg_mask), each (H, W) or (B, H, W)
    float 0/1."""
    one, (points, mask) = as_batch(points, mask)
    B = points.shape[0]
    H, W = cfg.head_hw
    vx = cfg.voxel_size[0] * cfg.head_stride
    vy = cfg.voxel_size[1] * cfg.head_stride
    cx = torch.floor((points[..., 0] - cfg.pc_range[0]) / vx).long()
    cy = torch.floor((points[..., 1] - cfg.pc_range[1]) / vy).long()
    ok = mask & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    rows = H * W + 1
    flat = torch.where(ok, cy * W + cx, H * W)
    flat = (flat + rows * torch.arange(B, device=points.device)[:, None]).reshape(-1)
    z = points[..., 2]
    zmax = torch.full((B * rows,), -1e9, device=points.device).scatter_reduce(
        0, flat, torch.where(ok, z, -1e9).reshape(-1), "amax").reshape(B, rows)[:, :H * W]
    zmin = torch.full((B * rows,), 1e9, device=points.device).scatter_reduce(
        0, flat, torch.where(ok, z, 1e9).reshape(-1), "amin").reshape(B, rows)[:, :H * W]
    observed = (zmax > -1e8).float()
    drivable = (((zmax - zmin) < 0.25) & (zmax < ground_z + 0.3)).float() * observed
    seg, seg_mask = drivable.reshape(B, H, W), observed.reshape(B, H, W)
    return (seg[0], seg_mask[0]) if one else (seg, seg_mask)


def detection_loss(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Focal heatmap loss + masked L1 regression (CenterPoint), and with
    ``seg`` targets the masked BCE of the freespace head.  Maps (H, W, c)
    give scalars; (B, H, W, c) one value per frame, each normalised by its
    own frame's positives and regression cells.

    Ties where gradients split: ``torch.minimum`` (the pi-symmetric rotation
    term) gives each side half, as ``jnp.minimum`` does; the heatmap's clamp
    passes the whole gradient at a bound where ``jnp.clip`` passes half, but
    a sigmoid lands exactly on 1e-4 or 1 - 1e-4 only when saturated, where
    both give 0."""
    hm = torch.clamp(torch.sigmoid(at_least_float32(preds["heatmap"])), 1e-4, 1 - 1e-4)
    t = targets["heatmap"]
    pos = (t > 0.99).float()
    neg_w = (1 - t) ** 4
    pos_loss = -pos * ((1 - hm) ** 2) * torch.log(hm)
    neg_loss = -(1 - pos) * neg_w * (hm ** 2) * torch.log(1 - hm)
    n_pos = torch.clamp(torch.sum(pos, _HWC), min=1.0)
    hm_loss = (torch.sum(pos_loss, _HWC) + torch.sum(neg_loss, _HWC)) / n_pos

    m = targets["reg_mask"][..., None]
    reg_loss = 0.0
    for k in ("offset", "z", "dim"):
        reg_loss = reg_loss + torch.sum(torch.abs(at_least_float32(preds[k]) - targets[k]) * m, _HWC)
    # rotation: pi-symmetric L1, the smaller of the two signs of (sin, cos)
    rp = at_least_float32(preds["rot"])
    rt = targets["rot"]
    l_rot = torch.minimum(torch.sum(torch.abs(rp - rt), -1, keepdim=True),
                          torch.sum(torch.abs(rp + rt), -1, keepdim=True))
    reg_loss = reg_loss + torch.sum(l_rot * m, _HWC)
    reg_loss = reg_loss / torch.clamp(torch.sum(m, _HWC), min=1.0)

    loss = hm_loss + 2.0 * reg_loss
    aux = dict(hm_loss=hm_loss, reg_loss=reg_loss)
    if "seg" in targets:
        sl = at_least_float32(preds["seg"][..., 0])
        sm = targets["seg_mask"]
        st = targets["seg"]
        bce = torch.clamp(sl, min=0.0) - sl * st + torch.log1p(torch.exp(-torch.abs(sl)))
        seg_loss = torch.sum(bce * sm, (-2, -1)) / torch.clamp(torch.sum(sm, (-2, -1)), min=1.0)
        loss = loss + seg_loss
        aux["seg_loss"] = seg_loss
    return loss, aux
