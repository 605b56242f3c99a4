"""Pose-graph optimization: batched sparse Gauss-Newton (counterpart of
``lsd_tpu/slam/posegraph.py``).

- Factor types: SE3 odometry/loop edges, GPS XYZ (or XY) priors,
  floor-plane (z + attitude) factors, IMU orientation priors, fixed-vertex
  gauge.
- Solver: Gauss-Newton over static-capacity masked arrays.  Each outer
  round linearizes every factor once into explicit Jacobian blocks
  (``torch.func.vmap`` of ``jacfwd``) and solves the normal equations by
  block-Jacobi-preconditioned conjugate gradient on those blocks.
- Robustness: Huber IRLS weights per outer round, a sqrt-DCS scaling of
  loop edges, and chi-square gating that disables GNSS priors with gross
  residuals.

Nodes are (quat wxyz, pos) pairs; the error state is 6 per node (rotation
tangent, translation), right-perturbed like state.py.

The loops have no data-dependent control flow and make no host sync.  The
scatter-adds with repeated node indices are float atomics on CUDA, so two
solves of one graph there agree to rounding, not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import so3
from ..utils.device import DeviceLike, resolve_device
from ..utils.precision import slam_f32


class GraphNodes(NamedTuple):
    quat: torch.Tensor    # (N, 4)
    pos: torch.Tensor     # (N, 3)
    fixed: torch.Tensor   # (N,) bool, gauge anchors
    mask: torch.Tensor    # (N,) bool, slot in use


class Se3Edges(NamedTuple):
    idx: torch.Tensor       # (E, 2) int32 (i, j)
    q_meas: torch.Tensor    # (E, 4)  measured T_i^-1 T_j rotation
    t_meas: torch.Tensor    # (E, 3)  measured translation
    sqrt_info: torch.Tensor  # (E, 6) diagonal sqrt information [rot, trans]
    mask: torch.Tensor      # (E,)


class GpsPriors(NamedTuple):
    idx: torch.Tensor       # (G,) int32
    xyz: torch.Tensor       # (G, 3)
    sqrt_info: torch.Tensor  # (G, 3) diag sqrt info (zero z-entry = XY-only)
    mask: torch.Tensor      # (G,)


class FloorPriors(NamedTuple):
    idx: torch.Tensor       # (F,) int32
    z: torch.Tensor         # (F,) floor height at node
    sqrt_info: torch.Tensor  # (F, 3) [z, roll-ish, pitch-ish]
    mask: torch.Tensor      # (F,)


class OrientPriors(NamedTuple):
    idx: torch.Tensor       # (O,) int32
    quat: torch.Tensor      # (O, 4)
    sqrt_info: torch.Tensor  # (O, 3)
    mask: torch.Tensor      # (O,)


class PoseGraphData(NamedTuple):
    nodes: GraphNodes
    se3: Se3Edges
    gps: GpsPriors
    floor: FloorPriors
    orient: OrientPriors


class PgoConfig(NamedTuple):
    outer_iters: int = 6          # robust/GN relinearization rounds
    cg_iters: int = 50
    huber_delta: float = 1.0      # on whitened residual norm
    gps_chi2_gate: float = 25.0   # disable GNSS priors above this chi2
    damping: float = 1e-6
    # Dynamic-Covariance-Scaling-style robustification (after Agarwal et
    # al., ICRA 2013, intentionally milder than canonical DCS) on loop /
    # cross-run edges (any SE3 edge with |i-j| > 1; consecutive
    # odometry edges are never scaled).  With s = min(1, 2*phi/(phi +
    # chi2)), canonical DCS scales the residual by s (information by
    # s^2); here the residual is scaled by sqrt(s) (information by s),
    # the gentler power because it stacks with the Huber weight already
    # applied to every edge.  A grossly-wrong loop's influence still
    # decays like phi/chi2 -> 0.  Re-evaluated each outer round, so a true
    # loop recovers as the graph converges toward it.  0 disables.
    dcs_phi: float = 4.0


def empty_graph(n_nodes: int, n_se3: int, n_gps: int = 0, n_floor: int = 0,
                n_orient: int = 0, device: DeviceLike = None) -> PoseGraphData:
    dev = resolve_device(device)

    def z(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=dev)

    def ones(*s):
        return torch.ones(s, dtype=torch.float32, device=dev)

    def qid(n):
        return torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1)
    g = max(n_gps, 1)
    f = max(n_floor, 1)
    o = max(n_orient, 1)
    return PoseGraphData(
        nodes=GraphNodes(qid(n_nodes), z(n_nodes, 3), z(n_nodes, dtype=torch.bool),
                         z(n_nodes, dtype=torch.bool)),
        se3=Se3Edges(z(n_se3, 2, dtype=torch.int32), qid(n_se3), z(n_se3, 3),
                     ones(n_se3, 6), z(n_se3, dtype=torch.bool)),
        gps=GpsPriors(z(g, dtype=torch.int32), z(g, 3), ones(g, 3), z(g, dtype=torch.bool)),
        floor=FloorPriors(z(f, dtype=torch.int32), z(f), ones(f, 3), z(f, dtype=torch.bool)),
        orient=OrientPriors(z(o, dtype=torch.int32), qid(n_nodes)[:o], ones(o, 3),
                            z(o, dtype=torch.bool)),
    )


# --------------------------------------------------------------------------
# residuals (batched over the factors; dx is (N, 6) [rotation, translation])


def _node_pose(nodes: GraphNodes, dx: torch.Tensor, i: torch.Tensor):
    """Perturbed poses of nodes i: (quat, pos) boxplus dx[i]."""
    i = i.long()
    q = so3.quat_mul(nodes.quat[i], so3.quat_from_rotvec(dx[i, :3]))
    p = nodes.pos[i] + dx[i, 3:]
    return q, p


def _se3_f(d, qi0, pi0, qj0, pj0, qm, tm, si, w):
    """Whitened 6-dim residual of SE3 edges at the perturbation d (..., 12)
    = [dtheta_i, dp_i, dtheta_j, dp_j]."""
    qi = so3.quat_mul(qi0, so3.quat_from_rotvec(d[..., :3]))
    pi = pi0 + d[..., 3:6]
    qj = so3.quat_mul(qj0, so3.quat_from_rotvec(d[..., 6:9]))
    pj = pj0 + d[..., 9:12]
    qi_inv = so3.quat_conj(qi)
    # relative pose i->j
    q_ij = so3.quat_mul(qi_inv, qj)
    t_ij = so3.quat_rotate(qi_inv, pj - pi)
    r_rot = so3.rotvec_from_quat(so3.quat_mul(so3.quat_conj(qm), q_ij))
    return torch.cat([r_rot, t_ij - tm], dim=-1) * si * w


def _floor_f(d, q0, p0, z0, si, w):
    """Floor residual: height + tilt (x, y of the body z-axis in world)."""
    q = so3.quat_mul(q0, so3.quat_from_rotvec(d[..., :3]))
    p = p0 + d[..., 3:]
    ez = torch.cat([torch.zeros_like(q[..., :2]), torch.ones_like(q[..., :1])], dim=-1)
    zaxis = so3.quat_rotate(q, ez)           # body z-axis in world
    return torch.stack([p[..., 2] - z0, zaxis[..., 0], zaxis[..., 1]], dim=-1) * si * w


def _orient_f(d, q0, qm, si, w):
    q = so3.quat_mul(q0, so3.quat_from_rotvec(d[..., :3]))
    return so3.rotvec_from_quat(so3.quat_mul(so3.quat_conj(qm), q)) * si * w


def _se3_residual(nodes: GraphNodes, e: Se3Edges, dx: torch.Tensor) -> torch.Tensor:
    """Whitened 6-dim residual per SE3 edge."""
    i, j = e.idx[:, 0].long(), e.idx[:, 1].long()
    d = torch.cat([dx[i], dx[j]], dim=-1)
    return _se3_f(d, nodes.quat[i], nodes.pos[i], nodes.quat[j], nodes.pos[j],
                  e.q_meas, e.t_meas, e.sqrt_info, e.mask.to(dx.dtype)[:, None])


def _gps_residual(nodes: GraphNodes, g: GpsPriors, dx: torch.Tensor) -> torch.Tensor:
    _, p = _node_pose(nodes, dx, g.idx)
    return (p - g.xyz) * g.sqrt_info * g.mask.to(dx.dtype)[:, None]


def _floor_residual(nodes: GraphNodes, f: FloorPriors, dx: torch.Tensor) -> torch.Tensor:
    i = f.idx.long()
    return _floor_f(dx[i], nodes.quat[i], nodes.pos[i], f.z, f.sqrt_info,
                    f.mask.to(dx.dtype)[:, None])


def _orient_residual(nodes: GraphNodes, o: OrientPriors, dx: torch.Tensor) -> torch.Tensor:
    i = o.idx.long()
    return _orient_f(dx[i], nodes.quat[i], o.quat, o.sqrt_info,
                     o.mask.to(dx.dtype)[:, None])


# --------------------------------------------------------------------------
# solver


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt IRLS weight per factor from its whitened residual norm."""
    n = torch.linalg.norm(r, dim=-1)
    return torch.sqrt(torch.where(n <= delta, 1.0, delta / torch.clamp(n, min=1e-9)))


def _linearize_blocks(graph: PoseGraphData, nodes: GraphNodes,
                      rw_se3: torch.Tensor, rw_gps: torch.Tensor):
    """Per-factor Jacobian blocks + whitened residuals at dx=0.

    Linearizing once per GN round and running CG on explicit blocks keeps
    the CG iteration to gathers, small batched products and scatter-adds.
    Returns ((J_se3 (E, 6, 12), r_se3 (E, 6)), (w_gps (G, 3), r_gps (G, 3)),
    (J_fl (F, 3, 6), r_fl (F, 3)), (J_or (O, 6, 6), r_or (O, 6))); the
    orientation factor's last three rows are zero, as in the reference.
    """
    se3, gps, floor, orient = graph.se3, graph.gps, graph.floor, graph.orient
    f32 = torch.float32
    dev = nodes.quat.device

    def blocks(f, n_tangent, args):
        n = args[0].shape[0]
        d0 = torch.zeros((n, n_tangent), dtype=f32, device=dev)
        return vmap(jacfwd(f))(d0, *args), f(d0, *args)

    i, j = se3.idx[:, 0].long(), se3.idx[:, 1].long()
    w_se3 = (se3.mask.to(f32) * rw_se3)[:, None]
    J_se3, r_se3 = blocks(_se3_f, 12, (
        nodes.quat[i], nodes.pos[i], nodes.quat[j], nodes.pos[j],
        se3.q_meas, se3.t_meas, se3.sqrt_info, w_se3))

    w_gps = (gps.mask.to(f32) * rw_gps)[:, None] * gps.sqrt_info
    r_gps = (nodes.pos[gps.idx.long()] - gps.xyz) * w_gps          # (G, 3)

    fi = floor.idx.long()
    J_fl, r_fl = blocks(_floor_f, 6, (
        nodes.quat[fi], nodes.pos[fi], floor.z, floor.sqrt_info,
        floor.mask.to(f32)[:, None]))

    oi = orient.idx.long()
    J_or3, r_or3 = blocks(_orient_f, 6, (
        nodes.quat[oi], orient.quat, orient.sqrt_info, orient.mask.to(f32)[:, None]))
    J_or = torch.cat([J_or3, torch.zeros_like(J_or3)], dim=1)
    r_or = torch.cat([r_or3, torch.zeros_like(r_or3)], dim=1)
    return (J_se3, r_se3), (w_gps, r_gps), (J_fl, r_fl), (J_or, r_or)


def _JtJv(J: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J^T (J v) per factor: J (E, m, k), v (E, k) -> (E, k)."""
    Jv = torch.einsum("eij,ej->ei", J, v)
    return torch.einsum("eij,ei->ej", J, Jv)


@slam_f32
def optimize(graph: PoseGraphData, cfg: PgoConfig = PgoConfig()
             ) -> Tuple[PoseGraphData, dict]:
    """Run robust Gauss-Newton; returns (updated graph, info) with
    info = dict(costs (outer_iters,), gps_inliers ()), on the graph's
    device."""
    nodes = graph.nodes
    n = nodes.quat.shape[0]
    f32 = torch.float32
    dev = nodes.quat.device
    free = (nodes.mask & ~nodes.fixed).to(f32)[:, None]             # (N, 1)
    gi0, gi1 = graph.se3.idx[:, 0].long(), graph.se3.idx[:, 1].long()
    fi = graph.floor.idx.long()
    oi = graph.orient.idx.long()
    pi = graph.gps.idx.long()
    eye6 = torch.eye(6, dtype=f32, device=dev)
    dx0 = torch.zeros((n, 6), dtype=f32, device=dev)

    gps_on = torch.ones_like(graph.gps.mask)
    costs = []
    for _ in range(cfg.outer_iters):
        # robust weights + chi2 gating at the current linearization point
        r_se3_raw = _se3_residual(nodes, graph.se3, dx0)
        r_gps_raw = _gps_residual(
            nodes, graph.gps._replace(mask=graph.gps.mask & gps_on), dx0)
        rw_se3 = _huber_weights(r_se3_raw, cfg.huber_delta)
        if cfg.dcs_phi > 0:
            is_loop = torch.abs(graph.se3.idx[:, 0] - graph.se3.idx[:, 1]) > 1
            chi2_se3 = torch.sum(r_se3_raw ** 2, dim=-1)
            s2 = torch.clamp(2.0 * cfg.dcs_phi / (cfg.dcs_phi + chi2_se3), max=1.0)
            rw_se3 = rw_se3 * torch.where(is_loop, torch.sqrt(s2), 1.0)
        rw_gps = _huber_weights(r_gps_raw, cfg.huber_delta) * gps_on.to(f32)
        chi2 = torch.sum(r_gps_raw ** 2, dim=-1)
        gps_on_new = gps_on & (chi2 < cfg.gps_chi2_gate)

        (J_se3, r_se3), (w_gps, r_gps), (J_fl, r_fl), (J_or, r_or) = \
            _linearize_blocks(graph, nodes, rw_se3, rw_gps)
        w_gps2 = w_gps ** 2

        def matvec(v):
            JtJv = _JtJv(J_se3, torch.cat([v[gi0], v[gi1]], dim=-1))
            out = torch.zeros((n, 6), dtype=f32, device=dev)
            out.index_add_(0, gi0, JtJv[:, :6])
            out.index_add_(0, gi1, JtJv[:, 6:])
            out[:, 3:].index_add_(0, pi, w_gps2 * v[pi, 3:])
            out.index_add_(0, fi, _JtJv(J_fl, v[fi]))
            out.index_add_(0, oi, _JtJv(J_or, v[oi]))
            return out * free + cfg.damping * v

        b = torch.zeros((n, 6), dtype=f32, device=dev)
        Jtr = torch.einsum("eij,ei->ej", J_se3, r_se3)
        b.index_add_(0, gi0, Jtr[:, :6])
        b.index_add_(0, gi1, Jtr[:, 6:])
        b[:, 3:].index_add_(0, pi, w_gps * r_gps)
        b.index_add_(0, fi, torch.einsum("eij,ei->ej", J_fl, r_fl))
        b.index_add_(0, oi, torch.einsum("eij,ei->ej", J_or, r_or))
        b = -b * free

        # block-Jacobi preconditioner: per-node 6x6 diagonal blocks of
        # J^T J (tighter than the scalar diagonal: rotation/translation
        # coupling within a node is captured, so CG needs fewer
        # iterations for the same accuracy)
        blocks = (cfg.damping * eye6).repeat(n, 1, 1)
        blocks.index_add_(0, gi0, torch.einsum("eij,eik->ejk", J_se3[:, :, :6], J_se3[:, :, :6]))
        blocks.index_add_(0, gi1, torch.einsum("eij,eik->ejk", J_se3[:, :, 6:], J_se3[:, :, 6:]))
        for a in range(3):
            blocks[:, 3 + a, 3 + a].index_add_(0, pi, w_gps2[:, a])
        blocks.index_add_(0, fi, torch.einsum("eij,eik->ejk", J_fl, J_fl))
        blocks.index_add_(0, oi, torch.einsum("eij,eik->ejk", J_or, J_or))
        # conditioning guard for the f32 block inverse: absolute damping
        # (1e-6) is invisible next to odometry information ~4e4, so a
        # block with one near-unconstrained axis (corridor-sliding loop
        # edge) is ~1e10-conditioned and its f32 inverse is garbage;
        # damp relative to each block's own scale
        scale = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0
        blocks = blocks + (1e-5 * scale + cfg.damping) * eye6
        Binv = torch.linalg.inv_ex(blocks).inverse

        def precond(r):
            return torch.einsum("nij,nj->ni", Binv, r) * free

        x = torch.zeros_like(b)
        r = b
        z = precond(b)
        p = z
        for _ in range(cfg.cg_iters):
            Ap = matvec(p)
            rz = torch.sum(r * z)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            beta = torch.sum(r * z) / torch.clamp(rz, min=1e-12)
            p = p * beta + z
        dx = x * free
        costs.append(torch.sum(r_se3 ** 2) + torch.sum((w_gps * r_gps) ** 2)
                     + torch.sum(r_fl ** 2) + torch.sum(r_or ** 2))
        nodes = nodes._replace(
            quat=so3.quat_normalize(so3.quat_mul(nodes.quat, so3.quat_from_rotvec(dx[:, :3]))),
            pos=nodes.pos + dx[:, 3:],
        )
        gps_on = gps_on_new

    gps_mask = graph.gps.mask & gps_on
    info = dict(costs=torch.stack(costs), gps_inliers=gps_mask.to(torch.int32).sum())
    return graph._replace(nodes=nodes, gps=graph.gps._replace(mask=gps_mask)), info
