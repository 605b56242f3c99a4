"""Model export: a deployment artifact of the detector (counterpart of
``lsd_tpu/tools/export.py``).

The reference's deployment flow freezes the torch model into an ONNX +
TensorRT engine (pytorch_model/export/spconv_object_pytorch2onnx.py,
generate_trt.sh), and the JAX package serializes its jitted inference
function through ``jax.export``.  Here the same function (points ->
detector forward -> decode -> postprocess, weights baked in) is captured
with ``torch.export`` and saved with ``torch.export.save``: one file that a
PyTorch runtime loads and calls with no model code of this package.

    python -m lsd_tpu_torch.tools.export --weights w.msgpack --out detector.pt2 [--device cpu]
    python -m lsd_tpu_torch.tools.export --check detector.pt2

Artifact layout, as the reference's: 8-byte magic 'LSDTPU01' + 4-byte
little-endian JSON header length + JSON header (shapes, config, and here
``"format": "torch.export"`` and the device type it was exported on) +
the bytes of ``torch.export.save``.  An exported program keeps the devices
of its example inputs and parameters, so export on the device that will
run it; the loaded program runs there.
"""
from __future__ import annotations

import io
import json
import struct

import torch

from ..utils.device import DeviceLike, resolve_device

_MAGIC = b"LSDTPU01"
FORMAT = "torch.export"


class DetectorInference(torch.nn.Module):
    """``(points (N, 4), mask (N,)) -> (boxes, scores, labels, keep)``: the
    detector's forward, its decode and the reference's postprocessing."""

    def __init__(self, model: torch.nn.Module, post_cfg):
        super().__init__()
        self.model = model
        self.post_cfg = post_cfg

    def forward(self, points: torch.Tensor, mask: torch.Tensor):
        from ..detection.post import postprocess
        preds = self.model(points, mask)
        return postprocess(self.post_cfg, *self.model.decode(preds))


def export_detector(state_dict, det_cfg=None, post_cfg=None,
                    point_capacity: int = 2 ** 17,
                    out_path: str = "detector.pt2",
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.bfloat16) -> str:
    """Write the artifact of the detector with ``state_dict`` (the port's
    parameter names, e.g. from ``convert.detector_params_from_flax``) for
    clouds of ``point_capacity`` points, exported on ``device`` (the card
    unless the caller asks for the CPU).  ``dtype`` is the network's: bf16
    as the reference serves it, or float32 for the twin."""
    from ..detection.post import PostProcessConfig
    from ..models import CenterPointDetector, DetectorConfig
    from ..utils.precision import set_slam_precision

    dev = resolve_device(device)
    det_cfg = det_cfg or DetectorConfig()
    post_cfg = post_cfg or PostProcessConfig()
    # the heads' last convolutions are float32 in the reference: no TF32
    set_slam_precision()
    model = CenterPointDetector(det_cfg, dtype=dtype)
    model.load_state_dict(state_dict)
    infer = DetectorInference(model, post_cfg).to(dev).eval().requires_grad_(False)
    args = (torch.zeros((point_capacity, 4), dtype=torch.float32, device=dev),
            torch.zeros((point_capacity,), dtype=torch.bool, device=dev))
    program = torch.export.export(infer, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = json.dumps(dict(
        kind="centerpoint_detector",
        point_capacity=point_capacity,
        num_classes=det_cfg.num_classes,
        pc_range=list(det_cfg.pc_range),
        voxel_size=list(det_cfg.voxel_size),
        max_objects=post_cfg.max_objects,
        format=FORMAT,
        device=dev.type,
        dtype=str(dtype).removeprefix("torch."))).encode()
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(buf.getvalue())
    return out_path


class ExportedDetector:
    """A loaded artifact; call with (points, mask) as host arrays or
    tensors.  The program runs on the device it was exported on, and its
    outputs are tensors there.  Raises ``ValueError`` for a file that is not
    an artifact and for one the JAX package wrote (``jax.export``)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not an lsd_tpu export artifact")
            n = struct.unpack("<I", f.read(4))[0]
            self.meta = json.loads(f.read(n))
            if self.meta.get("format") != FORMAT:
                raise ValueError(
                    f"{path}: an artifact of format {self.meta.get('format', 'jax.export')!r} "
                    f"(the JAX package's); this loader reads {FORMAT!r} artifacts only")
            self.program = torch.export.load(io.BytesIO(f.read()))
        self.device = resolve_device(self.meta["device"])
        self._fn = self.program.module()

    def __call__(self, points, mask):
        from ..utils.device import to_device
        with torch.no_grad():
            return self._fn(to_device(points, self.device, torch.float32),
                            to_device(mask, self.device, torch.bool))


def main(argv=None) -> int:
    import argparse
    import os
    import tempfile

    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=None,
                    help="msgpack weights (random init if unset)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: lsd_tpu_detector.pt2 in the "
                         "temporary directory)")
    ap.add_argument("--points", type=int, default=2 ** 17)
    ap.add_argument("--check", default=None,
                    help="load an artifact and run a smoke inference")
    ap.add_argument("--int8", default=None, metavar="OUT.msgpack",
                    help="also write int8 per-channel PTQ weights (ref "
                         "generate_trt.sh --int8 role; models/quantize.py)")
    ap.add_argument("--device", default=None,
                    help="torch device to export on (default: the card)")
    args = ap.parse_args(argv)

    if args.check:
        det = ExportedDetector(args.check)
        cap = det.meta["point_capacity"]
        pts = np.random.rand(cap, 4).astype(np.float32) * 20
        out = det(pts, np.ones(cap, bool))
        print(f"check ok: {det.meta['kind']} device={det.meta['device']} "
              f"-> boxes {tuple(out[0].shape)}")
        return 0

    from ..convert import detector_params_from_flax, detector_params_to_flax
    from ..models import CenterPointDetector, DetectorConfig
    from ..models.detector import init_detector_params
    from ..models.params_io import load_params

    det_cfg = DetectorConfig()
    if args.weights:
        tree = load_params(args.weights)
        state = detector_params_from_flax(tree)
    else:
        model = CenterPointDetector(det_cfg)
        init_detector_params(model, torch.Generator().manual_seed(0))
        state = model.state_dict()
        tree = detector_params_to_flax(model) if args.int8 else None
    out = args.out or os.path.join(tempfile.gettempdir(), "lsd_tpu_detector.pt2")
    path = export_detector(state, det_cfg, point_capacity=args.points,
                           out_path=out, device=args.device)
    print(f"exported -> {path} ({os.path.getsize(path)} bytes)")
    if args.int8:
        from ..models.quantize import quantization_error, save_quantized
        qp = save_quantized(args.int8, tree)
        err = max(quantization_error(tree).values() or [0.0])
        print(f"int8 weights -> {qp} ({os.path.getsize(qp)} bytes, "
              f"max leaf rel err {err:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
