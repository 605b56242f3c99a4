"""CenterPoint-style detector: pillars -> BEV CNN -> heads.  A copy of the
port's ``models/detector.py`` (``DetectorConfig``, ``CenterPointDetector``)
without its training targets and loss; ``dtype`` is the compute type
(bf16, as served)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn
from contextlib import nullcontext as record_function

from .voxelize import voxelize_dynamic
from .bev_backbone import BEVBackbone
from .center_head import CenterHead, decode_boxes
from .vfe import (POINT_FEATURES, MeanVFE, PillarVFE, VoxelHeightEncoder,
                  scatter_to_bev, scatter_to_bev_s2d, scatter_to_voxel_bev)

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
    # sets the z bins)
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


class CenterPointDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
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

    def encode(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """points (N, 4), mask (N,) -> the BEV image (H, W, C) the backbone
        takes."""
        cfg = self.cfg
        with record_function("detect/voxelize"):
            voxels, coords, num_pts, vmask = voxelize_dynamic(
                points, mask, cfg.voxel_size, cfg.pc_range, cfg.max_voxels,
                cfg.max_points_per_voxel)
        with record_function("detect/vfe"):
            if cfg.encoder == "voxel":
                feats = self.mean_vfe(voxels, num_pts) * vmask[:, None]
            else:
                feats = self.vfe(voxels, coords, num_pts) * vmask[:, None]
        with record_function("detect/scatter"):
            if cfg.encoder == "voxel":
                return scatter_to_voxel_bev(feats, coords, vmask, cfg.grid_hw, cfg.grid_z)
            if cfg.s2d_factor > 1:
                return scatter_to_bev_s2d(feats, coords, vmask, cfg.grid_hw, cfg.s2d_factor)
            return scatter_to_bev(feats, coords, vmask, cfg.grid_hw)

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
        with record_function("detect/backbone"):
            if self.cfg.encoder == "voxel":
                # its GroupNorm is per BEV row of one image (VoxelHeightEncoder)
                x = torch.cat([self.encoder(x[i:i + 1]) for i in range(x.shape[0])])
            x = self.backbone(x)
        with record_function("detect/head"):
            maps = self.head(x)
        return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}

    def decode(self, preds: Dict[str, torch.Tensor]):
        with record_function("detect/decode"):
            return decode_boxes(preds, self.cfg.voxel_size, self.cfg.pc_range,
                                stride=self.cfg.head_stride, max_boxes=self.cfg.max_boxes)
