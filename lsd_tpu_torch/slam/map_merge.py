"""Multi-session map merging (counterpart of ``lsd_tpu/slam/map_merge.py``).

Re-derivation of the reference's map-merge flow (slam/slam.py merge_map ->
graph_merge in backend_api.h:51, advertised multi-map auto-merging in
README.md:31-36): load two LSD-format maps, find cross-map loop pairs with
ScanContext, verify/refine with point-to-plane ICP, rigidly pre-align the
second session, then jointly optimize one pose graph over both sessions'
keyframes.  ScanContext, the surfel target, ICP and the solve run on the
``device`` the caller names (CUDA unless named); the gates and the graph
bookkeeping are the reference's host code.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry import np_so3, so3
from ..ops.surfel import surfel_create, surfel_insert
from ..utils.device import DeviceLike, resolve_device, to_device
from .graph_builder import PoseGraphBuilder
from .keyframe import Keyframe, KeyframeStore
from .map_io import load_map, save_map
from .posegraph import PgoConfig, optimize
from .registration import icp_point_to_plane
from .scancontext import make_descriptor, sc_db_add, sc_db_create, sc_query


def _pad_cloud(pts: np.ndarray, device: torch.device):
    cap = 1 << int(np.ceil(np.log2(max(len(pts), 2))))
    pad = np.zeros((cap, 3), np.float32)
    pad[:len(pts)] = pts[:, :3]
    m = np.zeros(cap, bool)
    m[:len(pts)] = True
    return to_device(pad, device), to_device(m, device)


def _store_from(data: Dict) -> KeyframeStore:
    store = KeyframeStore()
    for i, (s, T, c) in enumerate(zip(data["stamps"], data["poses"], data["clouds"])):
        store.add(Keyframe(id=i, stamp_us=s, pose=np.asarray(T, float),
                           odom=np.asarray(T, float), cloud=np.asarray(c, np.float32)))
    return store


def find_cross_edges(store_a: KeyframeStore, store_b: KeyframeStore,
                     sc_thresh: float = 0.35, fitness_thresh: float = 0.4,
                     max_pairs: int = 10, device: DeviceLike = None
                     ) -> List[Tuple[int, int, np.ndarray]]:
    """ScanContext + ICP cross-session matches, on ``device``.

    Returns [(i_a, j_b, T_rel)] with T_rel = T_a_i^-1 @ T_world_of_b_j
    expressed so that node_a_i * T_rel = pose of b_j in A's frame.
    """
    dev = resolve_device(device)
    db = sc_db_create(capacity=2048, device=dev)
    for kf in store_a.frames:
        P, M = _pad_cloud(kf.cloud, dev)
        db = sc_db_add(db, make_descriptor(P, M))

    edges = []
    for j, kf_b in enumerate(store_b.frames):
        if len(edges) >= max_pairs:
            break
        P, M = _pad_cloud(kf_b.cloud, dev)
        idx, dist, yaw = sc_query(db, make_descriptor(P, M),
                                  num_candidates=10, exclude_recent=0)
        # one fetch (the index, below 2**24, is exact in float32)
        idx, dist, yaw = torch.stack([idx.to(torch.float32), dist, yaw]).cpu().tolist()
        i = int(idx)
        if i < 0 or dist > sc_thresh:
            continue
        kf_a = store_a.frames[i]
        # target: A's neighborhood cloud around candidate
        ids = store_a.within_radius(kf_a.pose[:3, 3], 30.0)
        target = store_a.merged_cloud(ids, max_points=2 ** 16)
        if len(target) < 500:
            continue
        TP, TM = _pad_cloud(target, dev)
        m = surfel_create(capacity=2 ** 16, voxel_size=0.5, device=dev)
        m = surfel_insert(m, TP, TM)
        # initial guess: candidate pose with SC yaw
        Rz = np_so3.exp_so3([0.0, 0.0, -float(yaw)])
        R0 = kf_a.pose[:3, :3] @ Rz
        q0 = so3.matrix_to_quat(to_device(R0, dev, torch.float32))
        t0 = to_device(kf_a.pose[:3, 3], dev, torch.float32)
        q, t, info = icp_point_to_plane(m, P, M, q0, t0, iters=15,
                                        min_points=4)
        # ONE fetch of every scalar/array the gates consume
        flat = torch.cat([q, t, torch.stack([info["inlier_ratio"], info["n_inliers"],
                                             info["mean_residual"]]),
                          info["JtJ"].reshape(-1)]).cpu().numpy()
        q_h, t_h, (inl_ratio, n_inl, mean_res), JtJ_h = \
            flat[:4], flat[4:7], flat[7:10], flat[10:].reshape(6, 6)
        # coverage-independent acceptance (fitness is capped by the local
        # target's overlap fraction) + absolute inlier floor
        if float(inl_ratio) < fitness_thresh or float(n_inl) < 200:
            continue
        T_b_in_a = np.eye(4)
        T_b_in_a[:3, :3] = np_so3.quat_to_matrix(np.asarray(q_h))
        T_b_in_a[:3, 3] = np.asarray(t_h)
        T_rel = np.linalg.inv(kf_a.pose) @ T_b_in_a
        # anisotropic edge information from the ICP Hessian (see
        # mapper._detect_loop; same discount/cap policy)
        A6 = np.asarray(JtJ_h, float)
        sigma = max(float(mean_res), 0.01)
        try:
            cov = sigma ** 2 * np.linalg.inv(A6 + 1e-6 * np.eye(6))
        except np.linalg.LinAlgError:
            continue
        Ra = kf_a.pose[:3, :3]
        info6 = 0.02 / np.maximum(np.concatenate([
            np.diag(Ra.T @ cov[:3, :3] @ Ra),
            np.diag(Ra.T @ cov[3:, 3:] @ Ra)]), 1e-12)
        info6 = np.clip(info6, 0.0, 400.0)
        edges.append((i, j, T_rel, info6))
    return _consensus_filter(store_a, store_b, edges)


def _consensus_filter(store_a: KeyframeStore, store_b: KeyframeStore,
                      edges: List[Tuple[int, int, np.ndarray]],
                      trans_tol: float = 1.0, rot_tol: float = 0.15
                      ) -> List[Tuple[int, int, np.ndarray]]:
    """Keep the largest mutually-consistent set of cross edges.

    Every correct cross edge implies the same session alignment
    T_align = T_a_i @ T_rel @ T_b_j^-1; appearance-aliased matches (e.g.
    in self-similar environments) imply a different one.  This plays the
    role of the reference's max-clique consistency filtering
    (slam/backend fast_max-clique_finder used by robust_graph_optimize).
    """
    if len(edges) <= 1:
        return edges
    aligns = [store_a.frames[i].pose @ T @ np.linalg.inv(store_b.frames[j].pose)
              for (i, j, T, *_) in edges]

    def consistent(Ta, Tb):
        d = np.linalg.inv(Ta) @ Tb
        ang = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
        return (np.linalg.norm(d[:3, 3]) < trans_tol) and (ang < rot_tol)

    best: List[int] = []
    for k in range(len(edges)):
        group = [m for m in range(len(edges)) if consistent(aligns[k], aligns[m])]
        if len(group) > len(best):
            best = group
    if len(best) < 2:
        # no consensus at all: treat every match as unreliable (forces the
        # caller to provide an init hint rather than merging on one
        # possibly-aliased match)
        return []
    return [edges[m] for m in best]


def _gnss_expected_alignment(da: Dict, db_: Dict) -> Optional[np.ndarray]:
    """Expected B->A frame transform implied by the maps' OWN GNSS
    anchoring (origin lat/lon + the persisted origin_anchor_xyz), or
    None when either map is not GNSS-anchored.

    Both sessions of a GNSS campaign are mapped against the same datum:
    a map point p is anchored as p = ENU_wrt_own_origin + anchor, so
    B's pose in A's frame is p - anchor_b + d + anchor_a with d the
    UTM offset between the two origin fixes.  Frames are ENU-aligned
    (INS heading), so the rotation is identity.  This must drive the
    merge: re-anchoring B rigidly on the single best ScanContext/ICP cross
    edge discards this cm-grade absolute information, and one aliased match
    can warp B by metres while both input maps are centimetre-accurate."""
    oa, ob = da.get("origin"), db_.get("origin")
    if oa is None or ob is None:
        return None
    oa, ob = np.asarray(oa, float).ravel(), np.asarray(ob, float).ravel()
    if len(oa) < 2 or len(ob) < 2 or not (np.any(oa[:2]) and np.any(ob[:2])):
        return None
    from ..geometry.utm import UTMProjector
    proj = UTMProjector()
    proj.project(oa[0], oa[1])                      # anchor at A's origin
    dx, dy = proj.project(ob[0], ob[1])
    dz = (ob[2] - oa[2]) if (len(oa) > 2 and len(ob) > 2) else 0.0
    anchor_a = np.asarray((da.get("meta") or {}).get(
        "origin_anchor_xyz", [0.0, 0.0, 0.0]), float)
    anchor_b = np.asarray((db_.get("meta") or {}).get(
        "origin_anchor_xyz", [0.0, 0.0, 0.0]), float)
    T = np.eye(4)
    T[:3, 3] = anchor_a + np.asarray([float(dx), float(dy), float(dz)]) \
        - anchor_b
    return T


def merge_maps(map_a_dir: str, map_b_dir: str,
               out_dir: Optional[str] = None,
               pgo_cfg: PgoConfig = PgoConfig(outer_iters=8, cg_iters=80),
               init_hint: Optional[np.ndarray] = None,
               device: DeviceLike = None) -> Dict:
    """Merge session B into session A's frame, the device work on
    ``device``.  Returns dict with the merged keyframe store, builder, and
    cross-edge list; saves to out_dir when given."""
    dev = resolve_device(device)
    da, db_ = load_map(map_a_dir), load_map(map_b_dir)
    store_a, store_b = _store_from(da), _store_from(db_)

    T_exp = _gnss_expected_alignment(da, db_)
    cross = find_cross_edges(store_a, store_b, device=dev)
    if T_exp is not None:
        # gate cross edges against the GNSS-implied alignment: an edge
        # whose implied placement contradicts both maps' world frames by
        # meters is an appearance alias, however good its ICP fitness
        kept = []
        for (i, j, T_rel, *rest) in cross:
            Tal = store_a.frames[i].pose @ T_rel \
                @ np.linalg.inv(store_b.frames[j].pose)
            d = np.linalg.inv(T_exp) @ Tal
            ang = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
            if np.linalg.norm(d[:3, 3]) < 2.0 and ang < 0.2:
                kept.append((i, j, T_rel, *rest))
        cross = kept
    if not cross and T_exp is None and init_hint is None:
        raise RuntimeError("no cross-session matches found; supply init_hint")

    # rigid pre-alignment of B into A's frame: the GNSS-implied transform
    # when both maps are anchored (cross edges then only REFINE inside the
    # joint optimization), else the best cross pair / caller hint
    if T_exp is not None:
        T_align = T_exp
    elif cross:
        i, j, T_rel = cross[0][:3]
        T_align = store_a.frames[i].pose @ T_rel @ np.linalg.inv(store_b.frames[j].pose)
    else:
        T_align = np.asarray(init_hint, float)
    for kf in store_b.frames:
        kf.pose = T_align @ kf.pose

    # joint graph: A fixed-anchored, consecutive odometry edges per session,
    # cross-session loop edges
    b = PoseGraphBuilder()
    na = len(store_a)
    for k, kf in enumerate(store_a.frames):
        b.add_node(kf.pose, fixed=(k == 0))
    for k in range(na - 1):
        T_rel_a = np.linalg.inv(store_a.frames[k].pose) @ store_a.frames[k + 1].pose
        b.add_se3_edge(k, k + 1, T_rel_a, rot_info=400.0, trans_info=400.0)
    for k, kf in enumerate(store_b.frames):
        b.add_node(kf.pose)
    for k in range(len(store_b) - 1):
        T_rel_b = np.linalg.inv(store_b.frames[k].pose) @ store_b.frames[k + 1].pose
        b.add_se3_edge(na + k, na + k + 1, T_rel_b, rot_info=400.0, trans_info=400.0)
    for (i, j, T_rel, *rest) in cross:
        info6 = rest[0] if rest else np.full(6, 200.0)
        b.add_se3_edge(i, na + j, T_rel, rot_info=info6[:3],
                       trans_info=info6[3:])
    if T_exp is not None:
        # both sessions were GNSS-mapped: their saved poses carry
        # cm-grade absolute placement.  Weak (sigma ~0.5 m) world-frame
        # priors keep the joint solve from warping either chain onto an
        # imperfect cross edge while still letting edges refine locally
        # (the chi2 gate in the solver drops any prior the geometry
        # genuinely contradicts).
        for k, kf in enumerate(store_a.frames + store_b.frames):
            b.add_gps_prior(k, kf.pose[:3, 3], info=4.0)

    g, info = optimize(b.to_data(device=dev), pgo_cfg)
    b.update_from(g)
    merged = KeyframeStore()
    for k, kf in enumerate(store_a.frames + store_b.frames):
        kf2 = Keyframe(id=k, stamp_us=kf.stamp_us, pose=b.node_pose(k).astype(float),
                       odom=kf.odom, cloud=kf.cloud, images=kf.images)
        merged.add(kf2)

    if out_dir is not None:
        stamps = [kf.stamp_us for kf in merged.frames]
        poses = [kf.pose for kf in merged.frames]
        clouds = [kf.cloud for kf in merged.frames]
        edges_out = []
        for (i, j, q, t, si) in b.se3:
            T = np.eye(4)
            T[:3, :3] = np_so3.quat_to_matrix(np.asarray(q))
            T[:3, 3] = t
            edges_out.append((i, j, T, np.asarray(si[:6]) ** 2))
        origin = da.get("origin") if da.get("origin") is not None else np.zeros(3)
        save_map(out_dir, origin, stamps, poses, clouds, edges_out, fixed=[0])
    return dict(store=merged, builder=b, cross_edges=cross, n_a=na,
                n_b=len(store_b))
