"""Read the reference's flax-msgpack checkpoints (``weights/*.msgpack``)
without flax or msgpack (counterpart of ``lsd_tpu/models/params_io.py:22-26``
and ``lsd_tpu/models/quantize.py:44-45, 102-112``).

A checkpoint is a msgpack map of maps whose leaves are numpy arrays packed
as msgpack extension type 1: the msgpack triple ``(shape, dtype name, raw C
bytes)``.  Type 3 is a numpy scalar packed the same way, type 2 a Python
complex.  flax splits arrays over 2**30 bytes into
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` maps.
The int8 deployment form starts with the magic ``LSDQ8001``; its quantized
leaves are ``{"q": int8, "scale": float32}`` maps, read back as ``q * scale``
in float32.

``load_params`` returns the tree as nested dicts of numpy arrays;
``convert.detector_params_from_flax`` turns a detector's tree into a
``state_dict``.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

MAGIC = b"LSDQ8001"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """Recursive-descent msgpack decoder over one buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def ext(self, code: int, data: bytes):
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype, raw = unpackb(data)
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == EXT_NPSCALAR else arr
        if code == EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack extension type {code} is not a flax checkpoint's")

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode()
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(n)))
        if 0xD4 <= b <= 0xD8:                      # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (all of it)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__") is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    return _unchunk(unpackb(data))


def dequantize_params(qparams: Any) -> Any:
    """Quantized leaves ``{"q", "scale"}`` -> ``q * scale`` in float32."""
    if isinstance(qparams, dict):
        if set(qparams) == {"q", "scale"}:
            return qparams["q"].astype(np.float32) * qparams["scale"]
        return {k: dequantize_params(v) for k, v in qparams.items()}
    return qparams


def load_params(path: str) -> Any:
    """A checkpoint, plain float32 or int8-quantized (sniffed by its magic),
    as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(MAGIC)] == MAGIC:
        return dequantize_params(msgpack_restore(blob[len(MAGIC):]))
    return msgpack_restore(blob)


def count_params(tree: Any) -> Tuple[int, int]:
    """(arrays, numbers) in a checkpoint tree."""
    if isinstance(tree, dict):
        counts = [count_params(v) for v in tree.values()]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)
    return (1, int(np.size(tree))) if isinstance(tree, np.ndarray) else (0, 0)
