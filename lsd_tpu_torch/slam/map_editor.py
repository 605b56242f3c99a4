"""Interactive map-editor service over a live Mapper (a copy of
``lsd_tpu/slam/map_editor.py`` for the port: host code; the alignment and
merge run on the mapper's device).

Host-side re-derivation of the reference's MapManager + SLAM editor
surface (slam/map_manager.py:100-300, slam/slam.py:150-232): vertex/edge
CRUD, per-keyframe point deletion, named areas, keyframe alignment,
segmented color-map streaming, export-map config, threaded map saving
with progress, and merging a saved map into the live session.

All payload endpoints speak the reference's internal.proto wire format
(proto/internal.py) so its web UI renders our data unmodified.
"""
from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..proto.internal import serialize_keyframe, serialize_pointcloud_map
from .map_io import load_map

# get_color_map segments at this many bytes (ref map_manager.py:110)
MAX_SEGMENT_LEN = int(1e8)


def point_in_polygon(x: float, y: float, poly: np.ndarray) -> bool:
    """Ray-casting point-in-polygon (replaces the reference's shapely
    Point.within, map_manager.py:203-209)."""
    poly = np.asarray(poly, float)
    n = len(poly)
    inside = False
    j = n - 1
    for i in range(n):
        xi, yi = poly[i][0], poly[i][1]
        xj, yj = poly[j][0], poly[j][1]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


class MapEditor:
    def __init__(self, mapper, camera_params: Optional[Dict] = None):
        """camera_params: {name: {"K": (3,3), "T_cam_from_lidar": (4,4)}}
        — enables true RGB colouration in get_color_map/export when
        keyframes carry that camera's images."""
        self.mapper = mapper
        self.camera_params = camera_params or {}
        self.meta: Dict = {"area": {}}
        self._color_map_bytes = b""
        self._export_cfg = dict(z_min=-1e9, z_max=1e9, color=False)
        self._save_thread: Optional[threading.Thread] = None
        self._save_idx = 0
        self._save_total = 0

    # --- introspection --------------------------------------------------
    def get_status(self) -> Dict:
        m = self.mapper
        return dict(num_keyframes=len(m.store),
                    num_edges=len(m.graph.se3),
                    num_loops=len(m.loops),
                    travel_distance=float(m.updater.accum_distance),
                    ground_constraint=bool(m.cfg.use_floor_prior))

    def get_pose(self) -> Dict[str, List[float]]:
        """vertex id -> flattened 4x4 pose (ref map_manager.get_pose)."""
        m = self.mapper
        return {str(i): m.store[i].pose.flatten().tolist()
                for i in range(len(m.store))}

    def get_edge(self) -> List[Dict]:
        return [dict(id=k, prev=int(e[0]), next=int(e[1]))
                for k, e in enumerate(self.mapper.graph.se3)]

    def get_graph_meta(self) -> Dict:
        m = self.mapper
        vertex = {str(i): dict(id=i, fix=bool(m.graph.fixed[i]),
                               pose=m.store[i].pose.flatten().tolist(),
                               stamps=int(m.store[i].stamp_us))
                  for i in range(len(m.store))}
        return dict(vertex=vertex, edge=self.get_edge(),
                    area=self.meta["area"],
                    loops=[list(l) for l in m.loops])

    def get_key_frame(self, index, item: str = "p") -> bytes:
        i = int(index)
        if not (0 <= i < len(self.mapper.store)):
            return serialize_keyframe(str(index), np.zeros((0, 4), np.float32))
        kf = self.mapper.store[i]
        return serialize_keyframe(str(index), kf.cloud, kf.images, item)

    def get_vertex_cloud(self, index) -> bytes:
        """Raw little-endian float32 (N,4) keyframe cloud in the keyframe's
        own frame — the built-in editor UI's bulk-load path (the proto
        route /v1/vertex-data carries the same points for external
        tooling; raw f32 needs no proto parser in the browser).  Point row
        order matches kf.cloud so del_points indices round-trip."""
        i = int(index)
        if not (0 <= i < len(self.mapper.store)):
            return b""
        cloud = np.asarray(self.mapper.store[i].cloud, np.float32)
        if cloud.ndim != 2 or cloud.shape[1] < 3:
            return b""
        if cloud.shape[1] == 3:
            cloud = np.concatenate(
                [cloud, np.zeros((len(cloud), 1), np.float32)], axis=1)
        return np.ascontiguousarray(cloud[:, :4]).tobytes()

    # --- color map streaming --------------------------------------------
    def get_color_map(self) -> bytes:
        """Build (once) and stream the aggregated world-frame map in
        MAX_SEGMENT_LEN chunks; the client re-polls until a short chunk
        arrives (ref slam_server.get_color_map / map_manager:109-123)."""
        if not self._color_map_bytes:
            pts = self._aggregate_map_points()
            self._color_map_bytes = serialize_pointcloud_map(
                {"color_map": pts},
                attr_type="rgb" if self._export_cfg["color"] else "intensity")
        n = min(MAX_SEGMENT_LEN, len(self._color_map_bytes))
        segment = self._color_map_bytes[:n]
        self._color_map_bytes = self._color_map_bytes[n:]
        return segment

    def _aggregate_map_points(self, max_points: int = 4_000_000) -> np.ndarray:
        m = self.mapper
        clouds = []
        zmin, zmax = self._export_cfg["z_min"], self._export_cfg["z_max"]
        do_color = bool(self._export_cfg["color"]) and self.camera_params
        for kf in m.store.frames:
            pts = kf.cloud
            world = pts[:, :3] @ kf.pose[:3, :3].T.astype(np.float32) \
                + kf.pose[:3, 3].astype(np.float32)
            keep = (world[:, 2] >= zmin) & (world[:, 2] <= zmax)
            attr = pts[:, 3:4] if pts.shape[1] >= 4 else \
                np.zeros((len(pts), 1), np.float32)
            if do_color:
                rgb = self._colorize_keyframe(kf)
                if rgb is not None:
                    attr = rgb[:, None]
            clouds.append(np.concatenate([world[keep],
                                          attr[keep]], axis=1))
        if not clouds:
            return np.zeros((0, 4), np.float32)
        out = np.concatenate(clouds, axis=0).astype(np.float32)
        if len(out) > max_points:
            out = out[:: len(out) // max_points + 1]
        return out

    def _colorize_keyframe(self, kf) -> Optional[np.ndarray]:
        """Per-point packed-RGB attr from the keyframe's camera images
        (ref map colouration -> LidarPointcloud type 'rgb'; the packed
        uint32 R<<16|G<<8|B bit pattern viewed as float32, the format
        the reference UI decodes).  The JPEGs are decoded with ``cv2``;
        where it is missing (the card's machine) this returns None and the
        map keeps its intensities, as in the reference."""
        try:
            import cv2
        except ImportError:
            return None
        from .map_render import colorize_cloud
        for name, cam in self.camera_params.items():
            jpeg = kf.images.get(name)
            if not isinstance(jpeg, (bytes, bytearray)):
                continue
            img = cv2.imdecode(np.frombuffer(bytes(jpeg), np.uint8), 1)
            if img is None:
                continue
            rgb, valid = colorize_cloud(kf.cloud[:, :3], img,
                                        np.asarray(cam["K"], float),
                                        np.asarray(cam["T_cam_from_lidar"],
                                                   float))
            rgb8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint32)
            packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
            return np.where(valid, packed.view(np.float32), 0.0)
        return None

    # --- vertex / edge / point CRUD --------------------------------------
    # Editor mutations run on the web-server thread while (under
    # cfg.slam.async_graph) the mapper's background worker may be adding
    # loop edges or optimizing concurrently; every graph/store mutation
    # below therefore holds mapper._graph_lock, and structural edits that
    # renumber the store (del_vertex, merge_map) drain pending worker
    # jobs first so no queued job indexes stale keyframe ids.
    def del_vertex(self, vid) -> None:
        """Remove keyframe `vid`: drop the node + incident factors, bridge
        its chain neighbours with the composed relative transform, remap
        every index above it (ref map_manager.del_vertex + backend
        del_graph_vertex)."""
        m = self.mapper
        m.flush()
        with m._graph_lock:
            m._loop_target_cache.clear()     # cloud indices change
            m._graph_struct_version += 1     # invalidate in-flight solves
            self._del_vertex_locked(int(vid))

    def _del_vertex_locked(self, i: int) -> None:
        m = self.mapper
        if not (0 <= i < len(m.store)):
            raise IndexError(f"vertex {i} out of range")
        g = m.graph
        # bridge: if (a -> i) and (i -> b) odometry-chain edges exist,
        # connect a -> b with the composition
        into = [(k, e) for k, e in enumerate(g.se3) if e[1] == i]
        outof = [(k, e) for k, e in enumerate(g.se3) if e[0] == i]
        bridge = None
        if into and outof:
            _, (a, _, q1, t1, si1) = into[0]
            _, (_, b, q2, t2, si2) = outof[0]
            T1 = np.eye(4); T1[:3, :3] = _quat_mat(q1); T1[:3, 3] = t1
            T2 = np.eye(4); T2[:3, :3] = _quat_mat(q2); T2[:3, 3] = t2
            bridge = (int(a), int(b), T1 @ T2,
                      np.minimum(np.asarray(si1), np.asarray(si2)))

        def remap(k: int) -> int:
            return k - 1 if k > i else k

        g.quat.pop(i); g.pos.pop(i); g.fixed.pop(i)
        g.se3 = [(remap(a), remap(b), q, t, si)
                 for (a, b, q, t, si) in g.se3 if a != i and b != i]
        g.gps = [(remap(a), xyz, si) for (a, xyz, si) in g.gps if a != i]
        g.floor = [(remap(a), z, si) for (a, z, si) in g.floor if a != i]
        g.orient = [(remap(a), q, si) for (a, q, si) in g.orient if a != i]
        if bridge is not None:
            a, b, T, si = bridge
            g.se3.append((remap(a) if a > i else a, remap(b) if b > i else b,
                          _mat_quat(T), np.asarray(T[:3, 3], np.float32),
                          np.asarray(si, np.float32)))
        m.store.frames.pop(i)
        for k, kf in enumerate(m.store.frames):
            kf.id = k
        m.sc_ids = [remap(s) if s != i else -1 for s in m.sc_ids]
        m.loops = [(remap(a), remap(b)) for (a, b) in m.loops
                   if a != i and b != i]

    def del_points(self, index: Dict) -> None:
        """index: {vertex_id_str: [point indices]} (ref map-del-points)."""
        with self.mapper._graph_lock:
            self.mapper._loop_target_cache.clear()   # clouds mutate
            for idx, point_idx in index.items():
                i = int(idx)
                kf = self.mapper.store[i]
                kf.cloud = np.delete(kf.cloud,
                                     np.asarray(point_idx, np.int64), axis=0)

    def add_edge(self, prev_id, next_id, relative) -> int:
        T = np.asarray(relative, float).reshape(4, 4)
        with self.mapper._graph_lock:
            return self.mapper.graph.add_se3_edge(
                int(prev_id), int(next_id), T,
                rot_info=200.0, trans_info=200.0)

    def del_edge(self, eid) -> None:
        with self.mapper._graph_lock:
            self.mapper._graph_struct_version += 1
            self.mapper.graph.del_se3_edge(int(eid))

    def set_vertex_pose(self, vid, pose) -> None:
        """Move a vertex to an absolute pose (editor drag; the reference
        editor's vertex manipulation before re-optimize).  Updates both
        the graph estimate and the keyframe store so clouds/edges follow."""
        i = int(vid)
        T = np.asarray(pose, float).reshape(4, 4)
        with self.mapper._graph_lock:
            self.mapper._graph_struct_version += 1
            self.mapper.graph.set_node_pose(i, T)
            self.mapper.store[i].pose = T.copy()

    def set_vertex_fix(self, vid, fix) -> None:
        with self.mapper._graph_lock:
            self.mapper.graph.set_fixed(int(vid), bool(fix))

    def graph_optimize(self) -> None:
        self.mapper.optimize_graph()
        self._color_map_bytes = b""

    # --- areas ------------------------------------------------------------
    def add_area(self, area: Dict) -> str:
        ids = [int(k) for k in self.meta["area"]]
        new_id = str(max(ids) + 1 if ids else 0)
        self.meta["area"][new_id] = area
        return new_id

    def del_area(self, aid) -> None:
        self.meta["area"].pop(str(aid), None)

    def is_in_area(self, pose: np.ndarray) -> Optional[Dict]:
        x, y = float(pose[0, 3]), float(pose[1, 3])
        for aid, area in self.meta["area"].items():
            poly = np.asarray(area.get("polygon", []), float)
            if len(poly) >= 3 and point_in_polygon(x, y, poly[:, :2]):
                return area
        return None

    # --- alignment / merge -------------------------------------------------
    def keyframe_align(self, source, target, guess) -> List[float]:
        """ICP-align keyframe `source`'s cloud onto keyframe `target`'s
        (ref map_manager.keyframe_align -> slam.pointcloud_align)."""
        from .registration import align_clouds
        src = self.mapper.store[int(source)].cloud[:, :3]
        tgt = self.mapper.store[int(target)].cloud[:, :3]
        T0 = np.asarray(guess, float).reshape(4, 4)
        T = align_clouds(src, tgt, T0, device=self.mapper.device)
        return np.asarray(T, float).flatten().tolist()

    def merge_map(self, map_file: str) -> int:
        """Append a saved map's keyframes into the live graph with
        consensus-filtered cross edges, then optimize (ref slam.merge_map
        -> graph_merge + robust optimize)."""
        from .keyframe import Keyframe, KeyframeStore
        from .map_merge import find_cross_edges
        data = load_map(map_file)
        m = self.mapper
        other = KeyframeStore()
        for i, (s, T, c) in enumerate(zip(data["stamps"], data["poses"],
                                          data["clouds"])):
            other.add(Keyframe(id=i, stamp_us=int(s),
                               pose=np.asarray(T, float),
                               odom=np.asarray(T, float),
                               cloud=np.asarray(c, np.float32)))
        m.flush()
        cross = find_cross_edges(m.store, other, device=m.device)
        with m._graph_lock:
            m._graph_struct_version += 1
            base = len(m.store)
            for kf in other.frames:
                kid = m.store.add(Keyframe(id=-1, stamp_us=kf.stamp_us,
                                           pose=kf.pose.copy(),
                                           odom=kf.odom.copy(),
                                           cloud=kf.cloud))
                m.graph.add_node(kf.pose, fixed=False)
                if kid > base:
                    prev = m.store[kid - 1]
                    T_rel = np.linalg.inv(prev.odom) @ kf.odom
                    m.graph.add_se3_edge(kid - 1, kid, T_rel,
                                         rot_info=400.0, trans_info=400.0)
            for (i, j, T_rel, *rest) in cross:
                info6 = rest[0] if rest else np.full(6, 200.0)
                m.graph.add_se3_edge(int(i), base + int(j), T_rel,
                                     rot_info=info6[:3], trans_info=info6[3:])
                m.loops.append((int(i), base + int(j)))
        # merge areas from the other map's meta
        for aid, area in (data.get("meta") or {}).get("area", {}).items() \
                if isinstance((data.get("meta") or {}).get("area"), dict) \
                else []:
            self.add_area(area)
        self.graph_optimize()
        return len(cross)

    # --- export -------------------------------------------------------------
    def set_export_map_config(self, z_min, z_max, color) -> None:
        self._export_cfg = dict(z_min=float(z_min), z_max=float(z_max),
                                color=bool(color))
        self._color_map_bytes = b""

    def export_map(self, out_path: str = "output/export_map.pcd") -> str:
        """Z-cropped aggregate map PCD with a GNSS-anchor comment header
        (ref map_manager.export_map: '# GNSS Anchor lat lon alt')."""
        from ..io.pcd import write_pcd
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        pts = self._aggregate_map_points()
        write_pcd(out_path, pts)
        origin = (self.mapper.origin_lla
                  if self.mapper.origin_lla is not None else np.zeros(3))
        header = ("# This PCD file is generated by LSD\n"
                  "# GNSS Anchor {:.10f} {:.10f} {:.10f}\n").format(
                      *np.asarray(origin, float).reshape(-1)[:3])
        with open(out_path, "rb") as f:
            body = f.read()
        with open(out_path, "wb") as f:
            f.write(header.encode() + body)
        return out_path

    # --- threaded save --------------------------------------------------------
    def start_save_mapping(self, root_path: str,
                           name: Optional[str] = None) -> str:
        """Robust-optimize then save keyframe dirs on a worker thread,
        tracking progress (ref map_manager.start_save_mapping:235-272)."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        m = self.mapper
        if not len(m.store):
            return "error"
        m.optimize_graph()
        sub = (datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
               if name is None else str(name))
        map_dir = os.path.join(root_path, sub)
        self._save_idx, self._save_total = 0, len(m.store)
        snapshot = dict(
            stamps=[kf.stamp_us for kf in m.store.frames],
            poses=[kf.pose.copy() for kf in m.store.frames],
            clouds=[kf.cloud for kf in m.store.frames],
            images=[dict(kf.images) for kf in m.store.frames],
            edges=[(i, j, _T_from(q, t), np.asarray(si[:6]) ** 2)
                   for (i, j, q, t, si) in m.graph.se3],
            fixed=[i for i, f in enumerate(m.graph.fixed) if f],
            origin=(m.origin_lla if m.origin_lla is not None
                    else np.zeros(3)),
            anchor=(None if m.origin_anchor_xyz is None else
                    [float(v) for v in np.asarray(m.origin_anchor_xyz).flat]))

        def run():
            from .map_io import (save_g2o, save_keyframe, save_odometry)
            import json
            graph_dir = os.path.join(map_dir, "graph")
            os.makedirs(graph_dir, exist_ok=True)
            np.savetxt(os.path.join(graph_dir, "map_info.txt"),
                       np.asarray(snapshot["origin"], float).reshape(-1),
                       fmt="%1.10f")
            meta = {"area": self.meta["area"]}
            if snapshot["anchor"] is not None:
                meta["origin_anchor_xyz"] = snapshot["anchor"]
            with open(os.path.join(graph_dir, "map_meta.json"), "w") as f:
                json.dump(meta, f)
            save_odometry(graph_dir, snapshot["stamps"], snapshot["poses"])
            save_g2o(graph_dir, snapshot["poses"], snapshot["edges"],
                     snapshot["fixed"])
            for i in range(len(snapshot["stamps"])):
                save_keyframe(graph_dir, i, snapshot["stamps"][i],
                              snapshot["clouds"][i], snapshot["poses"][i],
                              snapshot["images"][i])
                self._save_idx += 1

        self._save_thread = threading.Thread(target=run, name="MapSave",
                                             daemon=True)
        self._save_thread.start()
        return "ok"

    def get_save_progress(self) -> float:
        return (self._save_idx / (self._save_total + 1)) * 100.0

    def rotate_ground_constraint(self) -> str:
        m = self.mapper
        m.cfg.use_floor_prior = not m.cfg.use_floor_prior
        return "enable" if m.cfg.use_floor_prior else "disable"


def _quat_mat(q) -> np.ndarray:
    from ..geometry import np_so3
    return np_so3.quat_to_matrix(np.asarray(q))


def _mat_quat(T) -> np.ndarray:
    from ..geometry import np_so3
    return np_so3.matrix_to_quat(np.asarray(T)[:3, :3]).astype(np.float32)


def _T_from(q, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _quat_mat(q)
    T[:3, 3] = np.asarray(t, float)
    return T
