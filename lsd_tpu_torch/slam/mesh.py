"""Textured-mesh export (counterpart of ``lsd_tpu/slam/mesh.py``).

Parity with the reference's ``texture_mesh`` (slam/src/graph_utils.cpp:449,
exposed at slam_wrapper.cpp:307): colour the vertices of a reconstruction
mesh (OBJ, e.g. from Poisson/marching-cubes tooling) by averaging the k=3
nearest neighbours in the RGB map cloud, then save ``texture_mesh.ply``.

The kNN is a chunked brute force on the device, as in the reference:
squared distances as one matmul per (query-chunk x cloud-chunk) tile
(float32, TF32 off), and a running per-query top-k merged tile by tile with
``torch.topk``.  The OBJ / PLY io is the reference's numpy.
"""
from __future__ import annotations

import os
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..io.pcd import read_pcd_fields
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.precision import set_slam_precision


# ---------------------------------------------------------------------------
# OBJ / PLY io
# ---------------------------------------------------------------------------

def read_obj(path: str) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """Parse a Wavefront OBJ -> (vertices (N, 3) f32, faces as 0-based tuples).

    Handles ``v x y z [r g b]`` and ``f a b c ...`` with ``a/b/c`` index
    syntax and negative (relative) indices.
    """
    verts: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, ...]] = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v" and len(tok) >= 4:
                verts.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "f" and len(tok) >= 4:
                idx = []
                for t in tok[1:]:
                    i = int(t.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                faces.append(tuple(idx))
    return np.asarray(verts, np.float32).reshape(-1, 3), faces


def write_ply_mesh(path: str, vertices: np.ndarray, colors_u8: np.ndarray,
                   faces: Sequence[Tuple[int, ...]]) -> str:
    """Binary little-endian PLY with per-vertex RGBA (the reference's
    savePLYFileBinary output shape: xyz + rgba vertices + faces)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    c = np.asarray(colors_u8, np.uint8).reshape(-1, 4 if
                                                np.asarray(colors_u8).shape[-1] == 4 else 3)
    if c.shape[1] == 3:
        c = np.concatenate([c, np.full((len(c), 1), 255, np.uint8)], axis=1)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(v)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property uchar alpha\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n")
    rec = np.zeros(len(v), dtype=np.dtype([("xyz", np.float32, (3,)),
                                           ("rgba", np.uint8, (4,))]))
    rec["xyz"] = v
    rec["rgba"] = c
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
        for face in faces:
            f.write(struct.pack("<B", len(face)))
            f.write(struct.pack(f"<{len(face)}i", *face))
    return path


def read_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, ...]]]:
    """Read back a PLY written by :func:`write_ply_mesh`
    -> (vertices (N, 3), rgba (N, 4) u8, faces)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        n_v = n_f = 0
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith(b"element face"):
                n_f = int(line.split()[-1])
            elif line == b"end_header":
                break
        rec = np.dtype([("xyz", np.float32, (3,)), ("rgba", np.uint8, (4,))])
        data = np.frombuffer(f.read(n_v * rec.itemsize), dtype=rec, count=n_v)
        faces = []
        for _ in range(n_f):
            (n,) = struct.unpack("<B", f.read(1))
            faces.append(struct.unpack(f"<{n}i", f.read(4 * n)))
    return data["xyz"].copy(), data["rgba"].copy(), faces


# ---------------------------------------------------------------------------
# kNN colour transfer
# ---------------------------------------------------------------------------

def knn_mean_colors(cloud_xyz: np.ndarray, cloud_rgb: np.ndarray,
                    query_xyz: np.ndarray, k: int = 3,
                    q_chunk: int = 1024, c_chunk: int = 65536,
                    device: DeviceLike = None) -> np.ndarray:
    """Mean colour of each query's k nearest cloud points.

    Brute force on ``device`` (CUDA unless named): for each query tile,
    scan the cloud tiles computing d2 = |q|^2 + |c|^2 - 2 q.c^T (one
    (q_chunk, 3) x (3, c_chunk) matmul), and keep a running per-query top-k
    of (distance, colour) merged with ``torch.topk``.  The tiles and the
    padding are the reference's.  Returns (Q, 3) float colours in the
    cloud_rgb range, fetched once."""
    cloud_xyz = np.asarray(cloud_xyz, np.float32).reshape(-1, 3)
    cloud_rgb = np.asarray(cloud_rgb, np.float32).reshape(len(cloud_xyz), -1)[:, :3]
    query_xyz = np.asarray(query_xyz, np.float32).reshape(-1, 3)
    n_q, n_c = len(query_xyz), len(cloud_xyz)
    if n_c == 0 or n_q == 0:
        return np.zeros((n_q, 3), np.float32)
    k = min(k, n_c)
    dev = resolve_device(device)
    set_slam_precision()

    c_chunk = min(c_chunk, max(128, 1 << int(np.ceil(np.log2(n_c)))))
    n_tiles = -(-n_c // c_chunk)
    pad_c = n_tiles * c_chunk - n_c
    # padded points sit far away so they never enter a top-k
    cx = np.concatenate([cloud_xyz, np.full((pad_c, 3), 1e7, np.float32)])
    cc = np.concatenate([cloud_rgb, np.zeros((pad_c, 3), np.float32)])
    cx = to_device(cx.reshape(n_tiles, c_chunk, 3), dev)
    cc = to_device(cc.reshape(n_tiles, c_chunk, 3), dev)
    cn = torch.sum(cx * cx, dim=2)

    q_chunk = min(q_chunk, max(8, n_q))
    n_qt = -(-n_q // q_chunk)
    qs = np.zeros((n_qt * q_chunk, 3), np.float32)
    qs[:n_q] = query_xyz
    qs = to_device(qs.reshape(n_qt, q_chunk, 3), dev)
    out = []
    for q in qs:
        qn = torch.sum(q * q, dim=1, keepdim=True)
        best_d2 = torch.full((q_chunk, k), torch.inf, dtype=torch.float32, device=dev)
        best_rgb = torch.zeros((q_chunk, k, 3), dtype=torch.float32, device=dev)
        for tx, trgb, tn in zip(cx, cc, cn):
            d2 = qn + tn[None, :] - 2.0 * (q @ tx.T)
            nd2, idx = torch.topk(-d2, k, dim=1)
            cand = torch.cat([best_d2, -nd2], dim=1)
            cand_rgb = torch.cat([best_rgb, trgb[idx]], dim=1)
            md2, mi = torch.topk(-cand, k, dim=1)
            best_rgb = torch.take_along_dim(cand_rgb, mi[..., None], dim=1)
            best_d2 = -md2
        out.append(torch.mean(best_rgb, dim=1))
    return torch.cat(out).cpu().numpy()[:n_q]

# ---------------------------------------------------------------------------
# texture_mesh entry (the slam_wrapper.cpp:307 surface)
# ---------------------------------------------------------------------------

def _cloud_colors(arr: np.ndarray, names: List[str]) -> np.ndarray:
    """Extract per-point RGB in [0, 255] from a PCD column layout: split
    r/g/b fields, PCL packed-float ``rgb``, or intensity-as-gray fallback."""
    cols = {n: i for i, n in enumerate(names)}
    if all(c in cols for c in ("r", "g", "b")):
        rgb = arr[:, [cols["r"], cols["g"], cols["b"]]]
        return rgb * 255.0 if rgb.max(initial=0.0) <= 1.0 + 1e-6 else rgb
    if "rgb" in cols:
        packed = arr[:, cols["rgb"]].astype(np.float32).view(np.uint32)
        return np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                         packed & 0xFF], axis=-1).astype(np.float32)
    if "intensity" in cols:
        i = arr[:, cols["intensity"]]
        i = i * 255.0 if i.max(initial=0.0) <= 1.0 + 1e-6 else i
        return np.repeat(np.clip(i, 0, 255)[:, None], 3, axis=1)
    return np.full((len(arr), 3), 128.0, np.float32)


def texture_mesh(mesh_path: str, cloud_path: str, output_path: str,
                 k: int = 3, device: DeviceLike = None) -> str:
    """Colour ``mesh_path`` (OBJ) vertices from the RGB map cloud at
    ``cloud_path`` (PCD) and write ``output_path/texture_mesh.ply``
    (ref graph_utils.cpp:449-501, smooth_factor=3); the kNN runs on
    ``device``."""
    verts, faces = read_obj(mesh_path)
    arr, names = read_pcd_fields(cloud_path)
    cols = {n: i for i, n in enumerate(names)}
    xyz = arr[:, [cols.get("x", 0), cols.get("y", 1), cols.get("z", 2)]]
    rgb = _cloud_colors(arr, names)
    vcol = knn_mean_colors(xyz, rgb, verts, k=k, device=device)
    os.makedirs(output_path, exist_ok=True)
    out = os.path.join(output_path, "texture_mesh.ply")
    return write_ply_mesh(out, verts,
                          np.clip(vcol + 0.5, 0, 255).astype(np.uint8), faces)
