"""Post-training int8 quantization of checkpoints and the w8a8 product
(counterpart of ``lsd_tpu/models/quantize.py``).

- ``quantize_params``: every float leaf of two or more dimensions becomes
  ``{"q": int8, "scale": float32[c_out]}``, symmetric per output channel
  (the last axis), rounded half to even as ``np.round`` and ``jnp.round``
  round; biases and norm parameters stay float32.
- ``dequantize_params`` (``params_io``'s, which this module exports as the
  reference's does) turns such leaves back into ``q * scale``;
  ``quantize_params`` followed by it is the int8 column of
  ``tools/eval_detection.py``.
- ``save_quantized`` writes the tree behind the magic ``LSDQ8001`` with the
  port's own msgpack writer; ``params_io.load_params`` reads either form
  back, quantized leaves as ``q * scale``.
- ``quantized_matmul``: int8 x int8 -> int32 -> rescale.  On a card the
  product is ``torch._int_mm`` (cuBLASLt), whose shapes are padded with
  zeros to what it takes (more than 16 rows, K and N multiples of 8) and
  whose right operand goes in column-major memory: cuBLASLt's int8 GEMM
  refused a row-major one with ``CUBLAS_STATUS_NOT_SUPPORTED`` on an H100
  (CUDA 12.8) at 24 x 64 @ 64 x 32.  On the CPU it is an int32 matmul.
  Both give the same int32 accumulators.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from .params_io import MAGIC, dequantize_params, msgpack_serialize

# quantize 2-D and larger kernels; biases, scales and norm parameters stay float
_MIN_QUANT_NDIM = 2
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_INT_MM_MIN_ROWS, _INT_MM_MULTIPLE = 17, 8


def _quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(-1, w.shape[-1])
    amax = np.max(np.abs(flat), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def _quantizable(a: np.ndarray) -> bool:
    return a.ndim >= _MIN_QUANT_NDIM and np.issubdtype(a.dtype, np.floating)


def quantize_params(params: Any) -> Any:
    """Quantize every >=2-D float array leaf to per-channel int8."""
    if isinstance(params, dict):
        return {k: quantize_params(v) for k, v in params.items()}
    a = np.asarray(params)
    return _quantize_leaf(a) if _quantizable(a) else a


def quantization_error(params: Any) -> Dict[str, float]:
    """Largest reconstruction error of each quantized leaf over the leaf's
    largest magnitude, keyed by its path ("/ConvBlock_0/Conv_0/kernel")."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + "/" + k)
            return
        a = np.asarray(x)
        if _quantizable(a):
            rec = dequantize_params(_quantize_leaf(a))
            denom = np.max(np.abs(a)) or 1.0
            out[path] = float(np.max(np.abs(rec - a)) / denom)
    walk(params, "")
    return out


def save_quantized(path: str, params: Any) -> str:
    """Write ``quantize_params(params)`` as an ``LSDQ8001`` checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(msgpack_serialize(quantize_params(params)))
    return path


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    pad = lambda size, mult: -size % mult
    pk, pn = pad(k, _INT_MM_MULTIPLE), pad(n, _INT_MM_MULTIPLE)
    pm = max(_INT_MM_MIN_ROWS - m, 0)
    b = F.pad(b, (0, pn, 0, pk))
    acc = torch._int_mm(F.pad(a, (0, pk, 0, pm)).contiguous(), b.t().contiguous().t())
    return acc[:m, :n]


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (..., K) float32 against ``wq`` (K, N) int8 with per-column
    scales ``w_scale`` (N,): ``x`` is quantized with one scale per tensor
    (its largest magnitude over 127, unless ``x_scale`` is given, a
    calibrated one), multiplied in int8 with int32 accumulators, and
    rescaled to float32 (..., N)."""
    if x_scale is None:
        x_scale = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], wq.shape[-1])
    return acc.float() * (x_scale * w_scale)
