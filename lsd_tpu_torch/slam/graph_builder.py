"""Host-side incremental pose-graph container (counterpart of
``lsd_tpu/slam/graph_builder.py``).

Accumulates nodes and factors incrementally in numpy, then pads them to
static capacities (powers of two, so both packages solve the same arrays)
and uploads them for the solver (posegraph.optimize).  Also the surface a
map editor mutates (add/del vertex/edge, fix vertex).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geometry import np_so3
from ..utils.device import DeviceLike, resolve_device, to_device
from .posegraph import (FloorPriors, GpsPriors, GraphNodes, OrientPriors,
                        PoseGraphData, Se3Edges)


def _quat_from_T(T: np.ndarray) -> np.ndarray:
    # host-side numpy on purpose: a per-node tensor op here would cost
    # kernel launches and a device round-trip per call
    return np_so3.matrix_to_quat(T[:3, :3]).astype(np.float32)


class PoseGraphBuilder:
    def __init__(self):
        self.quat: List[np.ndarray] = []
        self.pos: List[np.ndarray] = []
        self.fixed: List[bool] = []
        self.se3: List[Tuple] = []       # (i, j, q, t, sqrt_info6)
        self.gps: List[Tuple] = []       # (i, xyz, sqrt_info3)
        self.floor: List[Tuple] = []     # (i, z, sqrt_info3)
        self.orient: List[Tuple] = []    # (i, quat, sqrt_info3)

    # --- nodes ---------------------------------------------------------
    def add_node(self, T: np.ndarray, fixed: bool = False) -> int:
        self.quat.append(_quat_from_T(T))
        self.pos.append(np.asarray(T[:3, 3], np.float32))
        self.fixed.append(bool(fixed))
        return len(self.quat) - 1

    def set_fixed(self, i: int, fixed: bool = True) -> None:
        self.fixed[i] = bool(fixed)

    def set_node_pose(self, i: int, T: np.ndarray) -> None:
        """Overwrite node i's estimate (editor vertex drag)."""
        T = np.asarray(T, np.float32).reshape(4, 4)
        self.quat[i] = _quat_from_T(T)
        self.pos[i] = np.asarray(T[:3, 3], np.float32)

    def node_pose(self, i: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np_so3.quat_to_matrix(self.quat[i])
        T[:3, 3] = self.pos[i]
        return T

    @property
    def num_nodes(self) -> int:
        return len(self.quat)

    # --- factors -------------------------------------------------------
    def add_se3_edge(self, i: int, j: int, T_ij: np.ndarray,
                     rot_info=100.0, trans_info=100.0) -> int:
        """rot_info/trans_info: scalar or per-axis (3,) information values
        (anisotropic loop edges carry Hessian-derived per-axis info)."""
        ri = np.broadcast_to(np.asarray(rot_info, np.float32), (3,))
        ti = np.broadcast_to(np.asarray(trans_info, np.float32), (3,))
        si = np.concatenate([ri, ti]).astype(np.float32) ** 0.5
        self.se3.append((i, j, _quat_from_T(T_ij),
                         np.asarray(T_ij[:3, 3], np.float32), si))
        return len(self.se3) - 1

    def del_se3_edge(self, e: int) -> None:
        self.se3.pop(e)

    def add_gps_prior(self, i: int, xyz, xy_only: bool = False,
                      info: float = 1.0) -> None:
        si = np.asarray([info, info, 0.0 if xy_only else info], np.float32) ** 0.5
        self.gps.append((i, np.asarray(xyz, np.float32), si))

    def add_floor_prior(self, i: int, z: float, z_info: float = 100.0,
                        tilt_info: float = 100.0) -> None:
        si = np.asarray([z_info, tilt_info, tilt_info], np.float32) ** 0.5
        self.floor.append((i, float(z), si))

    def add_orientation_prior(self, i: int, T_or_quat, info: float = 10.0) -> None:
        q = (_quat_from_T(T_or_quat) if np.asarray(T_or_quat).shape == (4, 4)
             else np.asarray(T_or_quat, np.float32))
        si = np.full(3, info, np.float32) ** 0.5
        self.orient.append((i, q, si))

    # --- export --------------------------------------------------------
    def to_data(self, node_cap: Optional[int] = None, se3_cap: Optional[int] = None,
                gps_cap: Optional[int] = None, floor_cap: Optional[int] = None,
                orient_cap: Optional[int] = None,
                device: DeviceLike = None) -> PoseGraphData:
        """The padded graph as tensors on ``device`` (CUDA unless named)."""
        dev = resolve_device(device)

        def cap(x, c):
            c = c if c is not None else max(1, 1 << int(np.ceil(np.log2(max(x, 1)))))
            return max(c, 1)

        n = self.num_nodes
        nc = cap(n, node_cap)
        quat = np.tile(np.asarray([1, 0, 0, 0], np.float32), (nc, 1))
        pos = np.zeros((nc, 3), np.float32)
        fixed = np.zeros(nc, bool)
        mask = np.zeros(nc, bool)
        if n:
            quat[:n] = np.stack(self.quat)
            pos[:n] = np.stack(self.pos)
            fixed[:n] = self.fixed
            mask[:n] = True

        ec = cap(len(self.se3), se3_cap)
        eidx = np.zeros((ec, 2), np.int32)
        eq = np.tile(np.asarray([1, 0, 0, 0], np.float32), (ec, 1))
        et = np.zeros((ec, 3), np.float32)
        esi = np.ones((ec, 6), np.float32)
        em = np.zeros(ec, bool)
        for k, (i, j, q, t, si) in enumerate(self.se3[:ec]):
            eidx[k] = (i, j); eq[k] = q; et[k] = t; esi[k] = si; em[k] = True

        gc = cap(len(self.gps), gps_cap)
        gidx = np.zeros(gc, np.int32); gxyz = np.zeros((gc, 3), np.float32)
        gsi = np.ones((gc, 3), np.float32); gm = np.zeros(gc, bool)
        for k, (i, xyz, si) in enumerate(self.gps[:gc]):
            gidx[k] = i; gxyz[k] = xyz; gsi[k] = si; gm[k] = True

        fc = cap(len(self.floor), floor_cap)
        fidx = np.zeros(fc, np.int32); fz = np.zeros(fc, np.float32)
        fsi = np.ones((fc, 3), np.float32); fm = np.zeros(fc, bool)
        for k, (i, z, si) in enumerate(self.floor[:fc]):
            fidx[k] = i; fz[k] = z; fsi[k] = si; fm[k] = True

        oc = cap(len(self.orient), orient_cap)
        oidx = np.zeros(oc, np.int32)
        oq = np.tile(np.asarray([1, 0, 0, 0], np.float32), (oc, 1))
        osi = np.ones((oc, 3), np.float32); om = np.zeros(oc, bool)
        for k, (i, q, si) in enumerate(self.orient[:oc]):
            oidx[k] = i; oq[k] = q; osi[k] = si; om[k] = True

        def J(a):
            return to_device(a, dev)
        return PoseGraphData(
            nodes=GraphNodes(J(quat), J(pos), J(fixed), J(mask)),
            se3=Se3Edges(J(eidx), J(eq), J(et), J(esi), J(em)),
            gps=GpsPriors(J(gidx), J(gxyz), J(gsi), J(gm)),
            floor=FloorPriors(J(fidx), J(fz), J(fsi), J(fm)),
            orient=OrientPriors(J(oidx), J(oq), J(osi), J(om)),
        )

    def update_from(self, data: PoseGraphData,
                    n_nodes: Optional[int] = None) -> None:
        """Pull optimized node poses back into the graph lists.

        ``n_nodes`` limits the writeback to the first n nodes — the
        caller's snapshot size when the solve ran outside the graph
        lock and nodes were appended meanwhile (mapper.optimize_graph
        reconciles the appended tail through the refreshed odom2map)."""
        n = self.num_nodes if n_nodes is None else min(n_nodes,
                                                       self.num_nodes)
        # one fetch for both arrays
        qp = torch.cat([data.nodes.quat[:n], data.nodes.pos[:n]], dim=1).cpu().numpy()
        quat, pos = qp[:, :4], qp[:, 4:]
        for i in range(n):
            self.quat[i] = quat[i]
            self.pos[i] = pos[i]
