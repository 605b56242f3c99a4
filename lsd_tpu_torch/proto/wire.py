"""Minimal protobuf wire-format codec (no protoc / generated code)
(a copy of ``lsd_tpu/proto/wire.py`` for the port).

The reference emits protobuf ``Detection`` messages over UDP/HTTP
(proto/detection.proto + proto/proto_serialize.py).  For wire
compatibility we implement the protobuf encoding rules directly —
varint / 64-bit / length-delimited / 32-bit — and describe messages as
plain schema dicts (field number -> (name, type)).  This is an original
encoder; only the field numbering (the public wire contract) follows the
reference's .proto.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

WT_VARINT, WT_64BIT, WT_LEN, WT_32BIT = 0, 1, 2, 5

_SCALAR_WT = {
    "uint32": WT_VARINT, "uint64": WT_VARINT, "int32": WT_VARINT,
    "int64": WT_VARINT, "bool": WT_VARINT, "enum": WT_VARINT,
    "float": WT_32BIT, "double": WT_64BIT,
    "bytes": WT_LEN, "string": WT_LEN,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _encode_field(num: int, ftype, value) -> bytes:
    if isinstance(ftype, dict):  # nested message schema
        payload = encode_message(ftype, value)
        return _varint(num << 3 | WT_LEN) + _varint(len(payload)) + payload
    wt = _SCALAR_WT[ftype]
    key = _varint(num << 3 | wt)
    if wt == WT_VARINT:
        if ftype == "int32" and value < 0:
            value = value + (1 << 64)
        return key + _varint(int(value))
    if wt == WT_32BIT:
        return key + struct.pack("<f", float(value))
    if wt == WT_64BIT:
        return key + struct.pack("<d", float(value))
    data = value.encode() if isinstance(value, str) else bytes(value)
    return key + _varint(len(data)) + data


def encode_message(schema: Dict[int, Tuple[str, Any, bool]], msg: Dict) -> bytes:
    """schema: {field_num: (name, type, repeated)}; msg: dict by name."""
    out = bytearray()
    for num in sorted(schema):
        name, ftype, repeated = schema[num]
        if name not in msg or msg[name] is None:
            continue
        vals = msg[name] if repeated else [msg[name]]
        for v in vals:
            out += _encode_field(num, ftype, v)
    return bytes(out)


def decode_message(schema: Dict[int, Tuple[str, Any, bool]], buf: bytes) -> Dict:
    msg: Dict[str, Any] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            raw, i = _read_varint(buf, i)
        elif wt == WT_64BIT:
            raw = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wt == WT_32BIT:
            raw = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wt == WT_LEN:
            ln, i = _read_varint(buf, i)
            raw = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if num not in schema:
            continue
        name, ftype, repeated = schema[num]
        if isinstance(ftype, dict):
            raw = decode_message(ftype, raw)
        elif ftype == "string":
            raw = raw.decode()
        elif ftype == "int32" and isinstance(raw, int) and raw > (1 << 31):
            raw = raw - (1 << 64)
        if repeated:
            msg.setdefault(name, []).append(raw)
        else:
            msg[name] = raw
    return msg
