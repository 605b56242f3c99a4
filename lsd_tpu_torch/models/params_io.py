"""Read and write the reference's flax-msgpack checkpoints
(``weights/*.msgpack``) without flax or msgpack (counterpart of
``lsd_tpu/models/params_io.py`` and ``lsd_tpu/models/quantize.py:44-45,
102-112``).

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
``state_dict``.  A model with no flax counterpart (DSVT-Pillar) is kept by
its PyTorch names: ``state_dict_to_tree`` nests a ``state_dict`` by the
dotted parts of its keys under ``"params"`` (buffers too, such as
BatchNorm's running statistics), ``tree_to_state_dict`` undoes it.
``save_params`` writes such a tree as flax's ``to_bytes`` writes it, byte
for byte (``packb`` packs as msgpack-python does with ``use_bin_type`` and
the smallest form of each number, string and container; arrays over
``MAX_CHUNK_BYTES`` are chunked as flax chunks them).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

MAGIC = b"LSDQ8001"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax splits arrays larger than this into chunks (msgpack's objects stop at
# 2**31 - 1 bytes)
MAX_CHUNK_BYTES = 2 ** 30


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


def _sized(out: list, n: int, fix: int, fix_max: int, forms) -> None:
    """A header: one byte ``fix | n`` while n < fix_max, else the first of
    ``forms`` ((tag, struct format, limit)) whose limit holds n."""
    if n < fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for tag, fmt, limit in forms:
        if n < limit:
            out.append(struct.pack(">B" + fmt, tag, n))
            return
    raise ValueError(f"{n} is too long for msgpack")


_U8, _U16, _U32 = 1 << 8, 1 << 16, 1 << 32


def _pack_int(out: list, n: int) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
        return
    forms = ((0xCC, "B", _U8), (0xCD, "H", _U16), (0xCE, "I", _U32), (0xCF, "Q", 1 << 64)) \
        if n >= 0 else ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15), (0xD2, "i", 1 << 31),
                        (0xD3, "q", 1 << 63))
    for tag, fmt, limit in forms:
        if -limit <= n < limit:
            out.append(struct.pack(">B" + fmt, tag, n))
            return
    raise ValueError(f"{n} does not fit in 64 bits")


def _ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(struct.pack(">Bb", fixed[len(data)], code))
    else:
        _sized(out, len(data), 0, 0, ((0xC7, "B", _U8), (0xC8, "H", _U16), (0xC9, "I", _U32)))
        out.append(struct.pack(">b", code))
    out.append(data)


def _array_bytes(a: np.ndarray) -> bytes:
    return packb((list(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(out: list, obj: Any) -> None:
    if obj is None or isinstance(obj, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj])
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        _sized(out, len(raw), 0xA0, 32, ((0xD9, "B", _U8), (0xDA, "H", _U16), (0xDB, "I", _U32)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), 0, 0, ((0xC4, "B", _U8), (0xC5, "H", _U16), (0xC6, "I", _U32)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, ((0xDC, "H", _U16), (0xDD, "I", _U32)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 16, ((0xDE, "H", _U16), (0xDF, "I", _U32)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("an array of Python objects has no msgpack form")
        _ext(out, EXT_NDARRAY, _array_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    elif isinstance(obj, complex):
        _ext(out, EXT_COMPLEX, packb((obj.real, obj.imag)))
    else:
        raise TypeError(f"{type(obj).__name__} has no msgpack form")


def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists, tuples, str, bytes, numbers, numpy arrays and
    scalars) as msgpack bytes; arrays and numpy scalars as flax's extension
    types."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def _chunk(tree: Any) -> Any:
    """``tree`` with its maps in key order (flax copies a tree through
    ``jax.tree_util``, which sorts them) and its large arrays chunked."""
    if isinstance(tree, dict):
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_BYTES:
        flat = tree.reshape(-1)
        step = max(1, MAX_CHUNK_BYTES // tree.dtype.itemsize)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for ``tree``
    (nested dicts with numpy leaves)."""
    return packb(_chunk(tree))


def save_params(path: str, params: Any) -> str:
    """Write ``params`` (nested dicts of numpy arrays, a tree ``load_params``
    returns or ``convert.*_params_to_flax`` makes) as a flax checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(params))
    return path


def state_dict_to_tree(state: "dict[str, Any]") -> dict:
    """``{"params": {...}}``: a ``state_dict``'s tensors as numpy arrays (of
    their own dtypes) nested by the dotted parts of their names."""
    params: dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(t.detach().cpu().numpy())
    return {"params": params}


def tree_to_state_dict(tree: Any) -> "dict[str, Any]":
    """The ``state_dict`` (CPU tensors) that ``state_dict_to_tree`` nested:
    ``{"params": {...}}`` or the inner dict."""
    import torch
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = torch.as_tensor(np.array(v))
    walk(tree.get("params", tree), "")
    return out
