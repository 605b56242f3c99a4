"""Operations of one frame through the CenterPoint network (pillar
encoder, BEV backbone, CenterPoint head), from the configuration's
layer shapes: a multiply-add is two operations; biases, norms and
activations are left out.

The network, as the checkpoint fixes it: a pillar encoder Linear of
4 + 5 point features to ``pillar_filters`` over every point slot of every
pillar slot; the BEV image of ``pillar_filters * s2d_factor**2`` channels
on the fine grid cut by ``s2d_factor``; three backbone stages of
(1, 2, 2) residual blocks of (64, 128, 256) channels, the first at stride
``bev_stride`` and the others at 2, each block two 3x3 convolutions and,
where the stride or width changes, a 1x1 shortcut; one up-path per stage
to 128 channels at the first stage's stride (a 3x3 convolution where the
stage is at that stride, else a transposed convolution of kernel and
stride the ratio); the head's shared 3x3 convolution of the 384 channels
to 64, then per map (heatmap: one channel per class; offset 2, z 1,
dim 3, rot 2, seg 1) a 3x3 convolution 64 to 64 and a 1x1 to the map.
"""
from __future__ import annotations

LAYERS = (1, 2, 2)
CHANNELS = (64, 128, 256)
UP_CHANNELS = 128
HEAD_CH = 64
MAP_CHANNELS = (None, 2, 1, 3, 2, 1)     # heatmap (classes), offset, z, dim, rot, seg


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * k * k * cin * cout * h_out * w_out


def grid(cfg: dict):
    r, v = cfg["pc_range"], cfg["voxel_size"]
    return int(round((r[4] - r[1]) / v[1])), int(round((r[3] - r[0]) / v[0]))


def network_flops(cfg: dict) -> float:
    """Operations per frame of the network at ``cfg``'s sizes (the keys of
    ``configs/centerpoint-pp-0.1m.json``)."""
    f, s2d = cfg["pillar_filters"], cfg["s2d_factor"]
    total = 2.0 * (4 + 5) * f * cfg["max_voxels"] * cfg["max_points_per_voxel"]
    H, W = grid(cfg)
    h, w, cin = H // s2d, W // s2d, f * s2d * s2d
    strides = (cfg["bev_stride"], 2, 2)
    stage_hw, total_stride = [], 1
    for n, ch, st in zip(LAYERS, CHANNELS, strides):
        h, w = -(-h // st), -(-w // st)
        for b in range(n):
            c0 = cin if b == 0 else ch
            total += conv(c0, ch, 3, h, w) + conv(ch, ch, 3, h, w)
            if b == 0 and (st != 1 or c0 != ch):
                total += conv(c0, ch, 1, h, w)
        total_stride *= st
        up = total_stride // strides[0]
        # a transposed convolution of kernel and stride ``up``: k*k products
        # per input pixel and output channel
        total += conv(ch, UP_CHANNELS, 3, h, w) if up == 1 else conv(ch, UP_CHANNELS, up, h, w)
        stage_hw.append((h, w))
        cin = ch
    h0, w0 = stage_hw[0]
    total += conv(UP_CHANNELS * len(LAYERS), HEAD_CH, 3, h0, w0)
    for c in MAP_CHANNELS:
        total += conv(HEAD_CH, HEAD_CH, 3, h0, w0) + conv(HEAD_CH, c or cfg["num_classes"], 1, h0, w0)
    return total
