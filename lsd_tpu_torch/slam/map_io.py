"""Map persistence in the reference's on-disk format (numpy only; a copy of
``lsd_tpu/slam/map_io.py``, so both packages read each other's maps).

Maps interchange with the reference's editor/localizer: a map directory is

    <map>/graph/
        map_info.txt          # origin (lat, lon, alt), %1.10f rows
        map_meta.json         # {'area': ...}
        odometrys.txt         # "stamp x y z qx qy qz qw" per line
        graph.g2o             # VERTEX_SE3:QUAT / EDGE_SE3:QUAT text
        special_nodes.csv
        %06d/                 # one dir per keyframe
            cloud.pcd         # x y z intensity (intensity scaled *255)
            data              # "stamp <sec> <nsec>\nestimate\n<4x4>\nodom\n<4x4>\nid <n>"
            meta              # "image <n> <names...>"
            <name>.jpg        # per-camera images

(ref: slam/src/graph_utils.cpp dump_keyframe/dump_odometry/graph_save,
slam/common/keyframe.cpp KeyFrame::save/load*, slam/map_manager.py
start_save_mapping/saving_thread_loop.)
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import np_so3

from ..io.pcd import read_pcd, write_pcd


def _fmt_mat(T: np.ndarray) -> str:
    return "\n".join(" ".join("%.10g" % v for v in row) for row in np.asarray(T, float))


def save_keyframe(graph_dir: str, idx: int, stamp_us: int, points: np.ndarray,
                  pose: np.ndarray, images: Optional[Dict[str, bytes]] = None) -> str:
    d = os.path.join(graph_dir, "%06d" % idx)
    os.makedirs(d, exist_ok=True)
    pts = np.asarray(points, np.float32).copy()
    if pts.shape[1] >= 4:
        pts[:, 3] = pts[:, 3] * 255.0  # reference scales intensity to 0..255
    else:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
    write_pcd(os.path.join(d, "cloud.pcd"), pts)
    sec, usec = divmod(int(stamp_us), 1000000)
    with open(os.path.join(d, "data"), "w") as f:
        f.write("stamp %d %d\n" % (sec, usec * 1000))
        f.write("estimate\n%s\n" % _fmt_mat(pose))
        f.write("odom \n%s\n" % _fmt_mat(pose))
        f.write("id %d\n" % idx)
    images = images or {}
    with open(os.path.join(d, "meta"), "w") as f:
        f.write("image %d" % len(images))
        for name in images:
            f.write(" " + name)
        f.write("\n")
    for name, img in images.items():
        with open(os.path.join(d, name + ".jpg"), "wb") as f:
            f.write(img)
    return d


def load_keyframe(kf_dir: str) -> Tuple[int, np.ndarray, np.ndarray, Dict[str, bytes]]:
    """Returns (stamp_us, pose 4x4, points (N,4) with intensity /255,
    images {name: jpeg bytes})."""
    stamp_us, pose, kid = 0, np.eye(4), -1
    with open(os.path.join(kf_dir, "data")) as f:
        tokens = f.read().split()
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t == "stamp":
            stamp_us = int(tokens[i + 1]) * 1000000 + int(tokens[i + 2]) // 1000
            i += 3
        elif t in ("estimate", "odom"):
            vals = [float(v) for v in tokens[i + 1:i + 17]]
            pose = np.asarray(vals, float).reshape(4, 4)
            i += 17
        elif t == "id":
            kid = int(tokens[i + 1])
            i += 2
        else:
            i += 1
    pts = read_pcd(os.path.join(kf_dir, "cloud.pcd"))
    if pts.shape[1] >= 4:
        pts[:, 3] = pts[:, 3] / 255.0
    images: Dict[str, bytes] = {}
    meta_path = os.path.join(kf_dir, "meta")
    if os.path.exists(meta_path):
        tokens = open(meta_path).read().split()
        if tokens and tokens[0] == "image":
            for name in tokens[2:2 + int(tokens[1])]:
                ip = os.path.join(kf_dir, name + ".jpg")
                if os.path.exists(ip):
                    with open(ip, "rb") as imf:
                        images[name] = imf.read()
    return stamp_us, pose, pts, images


def save_odometry(graph_dir: str, stamps_us: List[int], poses: List[np.ndarray]) -> None:
    with open(os.path.join(graph_dir, "odometrys.txt"), "w") as f:
        for s, T in zip(stamps_us, poses):
            q = np_so3.matrix_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                    % (s / 1e6, t[0], t[1], t[2], q[1], q[2], q[3], q[0]))


def save_g2o(graph_dir: str, poses: List[np.ndarray],
             edges: List[Tuple[int, int, np.ndarray, np.ndarray]],
             fixed: Optional[List[int]] = None) -> None:
    """Write graph.g2o: VERTEX_SE3:QUAT + EDGE_SE3:QUAT (+FIX), g2o text
    conventions (qx qy qz qw order, 21 upper-triangular information)."""
    with open(os.path.join(graph_dir, "graph.g2o"), "w") as f:
        for i, T in enumerate(poses):
            q = np_so3.matrix_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write("VERTEX_SE3:QUAT %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n"
                    % (i, t[0], t[1], t[2], q[1], q[2], q[3], q[0]))
        for i in (fixed or []):
            f.write("FIX %d\n" % i)
        for (i, j, T_ij, info6) in edges:
            q = np_so3.matrix_to_quat(T_ij[:3, :3])
            t = T_ij[:3, 3]
            I = np.zeros((6, 6))
            np.fill_diagonal(I, np.asarray(info6))
            upper = [I[r, c] for r in range(6) for c in range(r, 6)]
            f.write("EDGE_SE3:QUAT %d %d %.9f %.9f %.9f %.9f %.9f %.9f %.9f %s\n"
                    % (i, j, t[0], t[1], t[2], q[1], q[2], q[3], q[0],
                       " ".join("%.9g" % v for v in upper)))
    with open(os.path.join(graph_dir, "special_nodes.csv"), "w") as f:
        f.write("anchor_node %d\n" % (0 if poses else -1))
        f.write("anchor_edge -1\n")
        f.write("floor_node -1\n")


def load_g2o(path: str):
    """Parse graph.g2o -> (poses dict id->4x4, edges list, fixed ids)."""
    poses: Dict[int, np.ndarray] = {}
    edges = []
    fixed = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "VERTEX_SE3:QUAT":
                i = int(p[1])
                t = np.asarray([float(v) for v in p[2:5]])
                qx, qy, qz, qw = [float(v) for v in p[5:9]]
                T = np.eye(4)
                T[:3, :3] = np_so3.quat_to_matrix([qw, qx, qy, qz])
                T[:3, 3] = t
                poses[i] = T
            elif p[0] == "EDGE_SE3:QUAT":
                i, j = int(p[1]), int(p[2])
                t = np.asarray([float(v) for v in p[3:6]])
                qx, qy, qz, qw = [float(v) for v in p[6:10]]
                T = np.eye(4)
                T[:3, :3] = np_so3.quat_to_matrix([qw, qx, qy, qz])
                T[:3, 3] = t
                upper = [float(v) for v in p[10:31]]
                I = np.zeros((6, 6))
                k = 0
                for r in range(6):
                    for c in range(r, 6):
                        I[r, c] = I[c, r] = upper[k]
                        k += 1
                edges.append((i, j, T, np.diag(I).copy()))
            elif p[0] == "FIX":
                fixed.append(int(p[1]))
    return poses, edges, fixed


def save_map(map_dir: str, origin_lla: np.ndarray,
             stamps_us: List[int], poses: List[np.ndarray],
             clouds: List[np.ndarray],
             edges: List[Tuple[int, int, np.ndarray, np.ndarray]],
             fixed: Optional[List[int]] = None,
             images: Optional[List[Dict[str, bytes]]] = None,
             meta: Optional[dict] = None) -> str:
    graph_dir = os.path.join(map_dir, "graph")
    os.makedirs(graph_dir, exist_ok=True)
    np.savetxt(os.path.join(graph_dir, "map_info.txt"),
               np.asarray(origin_lla, float).reshape(-1), fmt="%1.10f")
    with open(os.path.join(graph_dir, "map_meta.json"), "w") as f:
        json.dump(meta or {"area": []}, f)
    save_odometry(graph_dir, stamps_us, poses)
    save_g2o(graph_dir, poses, edges, fixed)
    for i, (s, T, c) in enumerate(zip(stamps_us, poses, clouds)):
        save_keyframe(graph_dir, i, s, c, T, (images[i] if images else None))
    return graph_dir


def load_map(map_dir: str):
    """Load a map directory -> dict with stamps, poses, clouds, edges, origin."""
    graph_dir = os.path.join(map_dir, "graph")
    if not os.path.isdir(graph_dir):
        graph_dir = map_dir
    origin = None
    info = os.path.join(graph_dir, "map_info.txt")
    if os.path.exists(info):
        origin = np.loadtxt(info).reshape(-1)
    meta = {}
    mf = os.path.join(graph_dir, "map_meta.json")
    if os.path.exists(mf):
        with open(mf) as f:
            meta = json.load(f)
    g2o_poses, edges, fixed = ({}, [], [])
    g2of = os.path.join(graph_dir, "graph.g2o")
    if os.path.exists(g2of):
        g2o_poses, edges, fixed = load_g2o(g2of)
    stamps, poses, clouds, images = [], [], [], []
    kf_ids = sorted(int(d) for d in os.listdir(graph_dir)
                    if d.isdigit() and os.path.isdir(os.path.join(graph_dir, d)))
    for i in kf_ids:
        s, T, pts, imgs = load_keyframe(os.path.join(graph_dir, "%06d" % i))
        if i in g2o_poses:
            T = g2o_poses[i]
        stamps.append(s)
        poses.append(T)
        clouds.append(pts)
        images.append(imgs)
    return dict(origin=origin, meta=meta, stamps=stamps, poses=poses,
                clouds=clouds, images=images, edges=edges, fixed=fixed,
                ids=kf_ids)
