"""Distributed pose-graph optimization over a mesh of ranks (counterpart
of ``lsd_tpu/parallel/sharded_pgo.py``).

The SE3 factors are split over the ranks; the Gauss-Newton normal
equations are solved by conjugate gradient where every Hessian-vector
product is a local block product over the rank's factors, scatter-added
into (N, 6) and summed over the ranks by one ``all_reduce``.

- one linearization per outer round: per-factor Jacobian blocks
  J_se3 (E, 6, 12) and whitened residuals by ``vmap(jacfwd)`` of the same
  factor function as the single-device solver (``slam/posegraph.py``);
- the CG state (N, 6) is replicated; each CG step makes one
  ``all_reduce``, and the right-hand side and the block-Jacobi
  preconditioner one each per round;
- the GPS priors are replicated and added after the reduce;
- edges are padded to a multiple of the ranks with zero-weight rows.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import so3
from ..slam.posegraph import (GraphNodes, PgoConfig, PoseGraphData, Se3Edges, _gps_residual,
                              _huber_weights, _JtJv, _se3_f, _se3_residual)
from ..utils.precision import slam_f32
from .mesh import Mesh, check_replicated, psum, rank_rows

# the whitened SE3 edge residual at a 12-dim perturbation (the reference's
# ``_se3_factor``; one function serves both solvers)
_se3_factor = _se3_f


def linearize_se3(nodes: GraphNodes, se3: Se3Edges,
                  rw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (J (E, 6, 12), r (E, 6)) whitened, robust-weighted."""
    i, j = se3.idx[:, 0].long(), se3.idx[:, 1].long()
    w = (se3.mask.to(torch.float32) * rw)[:, None]
    d0 = torch.zeros((i.shape[0], 12), dtype=torch.float32, device=nodes.pos.device)
    args = (nodes.quat[i], nodes.pos[i], nodes.quat[j], nodes.pos[j],
            se3.q_meas, se3.t_meas, se3.sqrt_info, w)
    return vmap(jacfwd(_se3_factor))(d0, *args), _se3_factor(d0, *args)


def _pad_edges(se3: Se3Edges, mult: int) -> Se3Edges:
    pad = (-se3.idx.shape[0]) % mult
    if pad == 0:
        return se3
    dev = se3.idx.device
    return Se3Edges(
        idx=torch.cat([se3.idx, torch.zeros((pad, 2), dtype=se3.idx.dtype, device=dev)]),
        q_meas=torch.cat([se3.q_meas, torch.tensor([[1.0, 0, 0, 0]], device=dev).repeat(pad, 1)]),
        t_meas=torch.cat([se3.t_meas, torch.zeros((pad, 3), device=dev)]),
        sqrt_info=torch.cat([se3.sqrt_info, torch.ones((pad, 6), device=dev)]),
        mask=torch.cat([se3.mask, torch.zeros(pad, dtype=torch.bool, device=dev)]))


def _build_gn_round(mesh: Mesh, cfg: PgoConfig, n: int):
    """One robust Gauss-Newton round over this rank's edge shard:
    ``gn_round(nodes, se3_shard, gps, free) -> nodes``."""
    f32 = torch.float32

    def gn_round(nodes: GraphNodes, se3_shard: Se3Edges, gps, free):
        dev = nodes.pos.device
        dx0 = torch.zeros((n, 6), dtype=f32, device=dev)
        eye6 = torch.eye(6, dtype=f32, device=dev)
        # robust weights at the linearization point
        r_se3 = _se3_residual(nodes, se3_shard, dx0)
        rw = _huber_weights(r_se3, cfg.huber_delta)
        if cfg.dcs_phi > 0:
            # Dynamic Covariance Scaling on loop / cross edges, as the
            # single-device solver (posegraph.optimize)
            is_loop = torch.abs(se3_shard.idx[:, 0] - se3_shard.idx[:, 1]) > 1
            chi2_se3 = torch.sum(r_se3 ** 2, dim=-1)
            s2 = torch.clamp(2.0 * cfg.dcs_phi / (cfg.dcs_phi + chi2_se3), max=1.0)
            rw = rw * torch.where(is_loop, torch.sqrt(s2), 1.0)
        J, r = linearize_se3(nodes, se3_shard, rw)               # local shard
        gi0, gi1 = se3_shard.idx[:, 0].long(), se3_shard.idx[:, 1].long()

        r_g = _gps_residual(nodes, gps, dx0)
        rw_g = _huber_weights(r_g, cfg.huber_delta)
        gate = (torch.sum(r_g ** 2, -1) < cfg.gps_chi2_gate).to(f32)
        wg = (gps.mask.to(f32) * rw_g * gate)[:, None] * gps.sqrt_info
        pi = gps.idx.long()

        def matvec(v):
            JtJv = _JtJv(J, torch.cat([v[gi0], v[gi1]], dim=-1))         # (Es, 12)
            out = torch.zeros((n, 6), dtype=f32, device=dev)
            out.index_add_(0, gi0, JtJv[:, :6])
            out.index_add_(0, gi1, JtJv[:, 6:])
            out, = psum(mesh, out)
            # the GPS priors (translation only) are replicated: added once,
            # after the reduce
            gpsv = torch.zeros((n, 6), dtype=f32, device=dev)
            gpsv[:, 3:].index_add_(0, pi, (wg ** 2) * v[pi, 3:])
            return (out + gpsv) * free + cfg.damping * v

        # gradient b = -J^T r (+ the GPS part)
        Jtr = torch.einsum("eij,ei->ej", J, r)
        b = torch.zeros((n, 6), dtype=f32, device=dev)
        b.index_add_(0, gi0, Jtr[:, :6])
        b.index_add_(0, gi1, Jtr[:, 6:])
        b, = psum(mesh, b)
        b[:, 3:].index_add_(0, pi, wg * r_g)
        b = -b * free

        # block-Jacobi preconditioner: per-node 6x6 blocks summed over the
        # ranks (each rank adds 1/ranks of the damping), as the
        # single-device solver builds them
        blocks = (cfg.damping * eye6).repeat(n, 1, 1) / mesh.size
        blocks.index_add_(0, gi0, torch.einsum("eij,eik->ejk", J[:, :, :6], J[:, :, :6]))
        blocks.index_add_(0, gi1, torch.einsum("eij,eik->ejk", J[:, :, 6:], J[:, :, 6:]))
        blocks, = psum(mesh, blocks)
        gw2 = wg ** 2
        for a in range(3):
            blocks[:, 3 + a, 3 + a].index_add_(0, pi, gw2[:, a])
        # relative damping for the float32 block inverse
        scale = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0
        blocks = blocks + (1e-5 * scale + cfg.damping) * eye6
        Binv = torch.linalg.inv_ex(blocks).inverse

        def precond(rr):
            return torch.einsum("nij,nj->ni", Binv, rr) * free

        x = torch.zeros_like(b)
        rr = b
        z = precond(b)
        p = z
        for _ in range(cfg.cg_iters):
            Ap = matvec(p)
            rz = torch.sum(rr * z)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            beta = torch.sum(rr * z) / torch.clamp(rz, min=1e-12)
            p = p * beta + z
        dx = x * free
        return nodes._replace(
            quat=so3.quat_normalize(so3.quat_mul(nodes.quat, so3.quat_from_rotvec(dx[:, :3]))),
            pos=nodes.pos + dx[:, 3:])

    return gn_round


@slam_f32
def optimize_sharded(graph: PoseGraphData, mesh: Mesh,
                     cfg: PgoConfig = PgoConfig()) -> PoseGraphData:
    """Distributed robust Gauss-Newton.  Semantics of ``posegraph.optimize``
    for graphs of SE3 edges and GPS priors (floor and orientation priors
    are not on this path; ``schur_pgo.optimize_schur`` takes every factor).
    Every rank calls it with the same graph and returns the same one;
    raises ``ValueError`` on every rank when the ranks' graphs differ."""
    check_replicated(mesh, "optimize_sharded", graph)
    nodes = graph.nodes
    n = nodes.quat.shape[0]
    free = (nodes.mask & ~nodes.fixed).to(torch.float32)[:, None]
    se3 = _pad_edges(graph.se3, mesh.size)
    mine = rank_rows(mesh, se3.idx.shape[0])
    se3_shard = Se3Edges(*[a[mine] for a in se3])
    gn_round = _build_gn_round(mesh, cfg, n)
    for _ in range(cfg.outer_iters):
        nodes = gn_round(nodes, se3_shard, graph.gps, free)
    return graph._replace(nodes=nodes)
