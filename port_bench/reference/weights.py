"""A checkpoint's flax tree as the ``state_dict`` of ``detector.py``'s
``CenterPointDetector``: a copy of the port's
``convert.detector_params_from_flax``."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# --------------------------------------------------------------------------
# detector weights.  Layouts: flax Dense (in, out) -> Linear (out, in); Conv
# HWIO -> Conv2d OIHW; ConvTranspose HWIO -> ConvTranspose2d (I, O, kH, kW)
# with both spatial axes flipped (flax does not flip a transposed conv's
# kernel, PyTorch's placement is that of a flipped one); norm "scale" ->
# "weight".  The backbone's up-path modules are numbered by type in flax
# (Conv_n for the stages already at the output stride, which come first,
# then ConvTranspose_n) and by stage in ``backbone.ups``.

_TOP = {"PillarVFE_0": "vfe", "VoxelHeightEncoder_0": "encoder", "BEVBackbone_0": "backbone",
        "CenterHead_0": "head"}
_VFE = {"Dense_0": "linear", "LayerNorm_0": "norm", "Conv_0": "conv", "GroupNorm_0": "norm"}
_BLOCK = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "shortcut", "GroupNorm_0": "norm0",
          "GroupNorm_1": "norm1"}


def _torch_module(path, n_conv_ups: int) -> str:
    """The port's module name for a flax module path (a tuple of names)."""
    top, *rest = path
    out = [_TOP[top]]
    if top == "BEVBackbone_0":
        if rest[0].startswith("ResBlock_"):
            out += ["blocks", rest[0].split("_")[1], _BLOCK[rest[1]]]
        elif rest[0].startswith("ConvTranspose_"):
            out += ["ups", str(n_conv_ups + int(rest[0].split("_")[1]))]
        else:
            out += ["ups", rest[0].split("_")[1]]
    elif top == "CenterHead_0":
        out += (["shared"] if rest[0] == "Conv_0"
                else ["heads", *rest[0].rsplit("_", 1)])     # hm_conv1 -> heads.hm.conv1
    else:
        out.append(_VFE[rest[0]])
    return ".".join(out)


def detector_params_from_flax(tree) -> "dict[str, torch.Tensor]":
    """The ``state_dict`` of the port's ``CenterPointDetector`` (float32, on
    the CPU) from a flax parameter tree: ``{"params": {...}}`` or the inner
    dict."""
    params = tree.get("params", tree)
    bb = params.get("BEVBackbone_0", {})
    n_conv_ups = sum(k.startswith("Conv_") for k in bb)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            kind = path[-1]
            if k == "kernel" and kind.startswith("Dense"):
                a = a.T
            elif k == "kernel" and kind.startswith("ConvTranspose"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif k == "kernel":
                a = a.transpose(3, 2, 0, 1)
            leaf = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[_torch_module(path, n_conv_ups) + "." + leaf] = torch.tensor(
                np.ascontiguousarray(a))
    walk(params, ())
    return out
