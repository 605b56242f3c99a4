"""Minimal PCD point-cloud file IO (ascii + binary), numpy-native (a copy of
``lsd_tpu/io/pcd.py``).

Compatible with the keyframe clouds the reference writes via PCL
(slam/src/graph_utils.cpp dump_keyframe -> cloud.pcd with fields
x y z intensity) so maps interchange between the two stacks.
"""
from __future__ import annotations

import numpy as np

_TYPE_MAP = {("F", 4): np.float32, ("F", 8): np.float64,
             ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
             ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file, returning an (N, F) float32 array of its fields."""
    return read_pcd_fields(path)[0]


def read_pcd_fields(path: str):
    """Read a PCD file -> ((N, F) float32 array, list of column names).

    Multi-count fields expand to ``name``-indexed columns; names let
    callers find packed-``rgb`` vs split r/g/b colour layouts.
    """
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        dtype = np.dtype([(name if c == 1 else name, _TYPE_MAP[(t, s)], (c,) if c > 1 else ())
                          for name, s, t, c in zip(fields, sizes, types, counts)])
        names = []
        for name, c in zip(fields, counts):
            names.extend([name] if c == 1 else [f"{name}{i}" for i in range(c)])
        if header["DATA"] == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n)
            body = body.reshape(n, -1)
            return body.astype(np.float32), names
        elif header["DATA"] == "binary":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            cols = [np.asarray(raw[name], dtype=np.float32).reshape(n, -1) for name in raw.dtype.names]
            return np.concatenate(cols, axis=1), names
        else:
            raise ValueError(f"unsupported PCD DATA: {header['DATA']}")


def write_pcd(path: str, points: np.ndarray, fields=("x", "y", "z", "intensity"),
              binary: bool = True) -> None:
    points = np.asarray(points, dtype=np.float32)
    points = points.reshape(-1, points.shape[-1])[:, :len(fields)]
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")
