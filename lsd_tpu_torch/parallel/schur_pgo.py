"""Distributed pose-graph optimization by Schur-complement reduction over
keyframe ownership (counterpart of ``lsd_tpu/parallel/schur_pgo.py``).

Partitioning (a host-side plan in numpy, ``build_plan``):
  - nodes are split into ``ndev`` contiguous keyframe ranges (chunks);
    contiguity is trajectory locality, so almost every odometry edge is
    inside a chunk;
  - an edge whose endpoints lie in different chunks is a CUT edge; the
    endpoints of cut edges are the SEPARATOR set;
  - an edge that touches an interior node lies inside one chunk, so each
    rank owns exactly the factors of its chunk; separator-separator
    factors go round-robin over the ranks and are summed.

Solve (an exact Gauss-Newton step per outer round, not truncated CG):
each rank assembles a dense Hessian over its extended slots [interior
slots | separator slots], eliminates its interiors with a Cholesky
factorization,  S_d = H_ss - H_si H_ii^-1 H_is,  the separator system
(sum_d S_d) dx_s = sum_d rhs_d  is solved on every rank, and the
interiors back-substitute locally.  One ``all_reduce`` of
(S*6)^2 + S*6 floats per round, and one of the (N, 6) step.

Semantics of ``slam/posegraph.py:optimize``: Huber IRLS weights, GNSS
chi2 gating with the gate carried across rounds, and every factor type
(SE3, GPS, floor, orientation).  A Cholesky factor that is not positive
definite gives NaN poses, as the reference's does, not an exception.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry import so3
from ..slam.posegraph import (GraphNodes, PgoConfig, PoseGraphData, _floor_f,
                              _gps_residual, _huber_weights, _orient_f, _se3_f,
                              _se3_residual)
from ..utils.precision import slam_f32
from .mesh import Mesh, check_replicated, psum


def _bucket(x: int, lo: int = 8) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


class SchurPlan(NamedTuple):
    """Host-built partition plan (numpy); static shapes per bucket."""
    ndev: int
    m_int: int                 # interior slots per rank
    n_sep: int                 # separator slots (shared)
    int_ids: np.ndarray        # (ndev, m_int) global node id (0 pad)
    int_mask: np.ndarray       # (ndev, m_int)
    sep_ids: np.ndarray        # (n_sep,) global node id
    sep_mask: np.ndarray       # (n_sep,)
    e_rows: np.ndarray         # (ndev, E_loc) row into graph.se3 (0 pad)
    e_slots: np.ndarray        # (ndev, E_loc, 2) extended-space slots
    e_mask: np.ndarray         # (ndev, E_loc)
    g_rows: np.ndarray         # (ndev, G_loc) row into graph.gps
    g_slots: np.ndarray        # (ndev, G_loc)
    g_mask: np.ndarray         # (ndev, G_loc)
    f_rows: np.ndarray         # (ndev, F_loc)
    f_slots: np.ndarray
    f_mask: np.ndarray
    o_rows: np.ndarray         # (ndev, O_loc)
    o_slots: np.ndarray
    o_mask: np.ndarray


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_plan(graph: PoseGraphData, ndev: int) -> SchurPlan:
    node_mask = _np(graph.nodes.mask)
    used = np.flatnonzero(node_mask)
    n_used = len(used)
    m_chunk = -(-max(n_used, 1) // ndev)
    chunk_of = np.full(node_mask.shape[0], -1, np.int64)
    chunk_of[used] = np.arange(n_used) // m_chunk

    eidx = _np(graph.se3.idx)
    emask = _np(graph.se3.mask)
    ci = chunk_of[eidx[:, 0]]
    cj = chunk_of[eidx[:, 1]]
    cut = emask & (ci != cj)
    sep_ids = np.unique(eidx[cut].ravel()) if cut.any() else np.zeros(0, np.int64)
    is_sep = np.zeros(node_mask.shape[0], bool)
    is_sep[sep_ids] = True

    n_sep = _bucket(max(len(sep_ids), 1))
    sep_pad = np.zeros(n_sep, np.int64)
    sep_pad[:len(sep_ids)] = sep_ids
    sep_mask = np.zeros(n_sep, bool)
    sep_mask[:len(sep_ids)] = True
    sep_slot_of = np.full(node_mask.shape[0], -1, np.int64)
    sep_slot_of[sep_ids] = np.arange(len(sep_ids))

    # interior lists per chunk
    m_int = _bucket(m_chunk)
    int_ids = np.zeros((ndev, m_int), np.int64)
    int_mask = np.zeros((ndev, m_int), bool)
    int_slot_of = np.full(node_mask.shape[0], -1, np.int64)
    for d in range(ndev):
        ids = used[d * m_chunk:(d + 1) * m_chunk]
        ids = ids[~is_sep[ids]]
        int_ids[d, :len(ids)] = ids
        int_mask[d, :len(ids)] = True
        int_slot_of[ids] = np.arange(len(ids))

    def ext_slot(node: np.ndarray) -> np.ndarray:
        """Extended-space slot of a node within its owner rank."""
        return np.where(is_sep[node], m_int + sep_slot_of[node], int_slot_of[node])

    # ---- assign SE3 edges ------------------------------------------------
    own = np.where(cut | ~emask, -1, np.where(is_sep[eidx[:, 0]], cj, ci))
    # sep-sep (cut or intra-chunk between two separators): round-robin
    both_sep = emask & is_sep[eidx[:, 0]] & is_sep[eidx[:, 1]]
    rr = np.cumsum(both_sep) % ndev
    own = np.where(both_sep, rr, own)
    # intra-chunk edge with one separator endpoint: the interior side owns
    one_int = emask & ~both_sep
    own = np.where(one_int & is_sep[eidx[:, 0]], cj, own)
    own = np.where(one_int & ~is_sep[eidx[:, 0]], ci, own)

    rows_per = [np.flatnonzero(emask & (own == d)) for d in range(ndev)]
    E_loc = _bucket(max([1] + [len(r) for r in rows_per]))
    e_rows = np.zeros((ndev, E_loc), np.int64)
    e_slots = np.zeros((ndev, E_loc, 2), np.int64)
    e_mask = np.zeros((ndev, E_loc), bool)
    for d, r in enumerate(rows_per):
        e_rows[d, :len(r)] = r
        e_slots[d, :len(r), 0] = ext_slot(eidx[r, 0])
        e_slots[d, :len(r), 1] = ext_slot(eidx[r, 1])
        e_mask[d, :len(r)] = True

    # ---- node-local priors: owner = node's chunk --------------------------
    def prior_plan(idx, mask):
        idx = _np(idx)
        mask = _np(mask) & node_mask[idx]
        owner = chunk_of[idx]
        rows_per = [np.flatnonzero(mask & (owner == d)) for d in range(ndev)]
        cap = _bucket(max([1] + [len(r) for r in rows_per]), lo=4)
        rows = np.zeros((ndev, cap), np.int64)
        slots = np.zeros((ndev, cap), np.int64)
        msk = np.zeros((ndev, cap), bool)
        for d, r in enumerate(rows_per):
            rows[d, :len(r)] = r
            slots[d, :len(r)] = ext_slot(idx[r])
            msk[d, :len(r)] = True
        return rows, slots, msk

    g_rows, g_slots, g_mask = prior_plan(graph.gps.idx, graph.gps.mask)
    f_rows, f_slots, f_mask = prior_plan(graph.floor.idx, graph.floor.mask)
    o_rows, o_slots, o_mask = prior_plan(graph.orient.idx, graph.orient.mask)

    return SchurPlan(ndev=ndev, m_int=m_int, n_sep=n_sep,
                     int_ids=int_ids, int_mask=int_mask,
                     sep_ids=sep_pad, sep_mask=sep_mask,
                     e_rows=e_rows, e_slots=e_slots, e_mask=e_mask,
                     g_rows=g_rows, g_slots=g_slots, g_mask=g_mask,
                     f_rows=f_rows, f_slots=f_slots, f_mask=f_mask,
                     o_rows=o_rows, o_slots=o_slots, o_mask=o_mask)


def _blocks(f, n_tangent: int, args):
    """Per-factor Jacobian at a zero perturbation and the residual there."""
    d0 = torch.zeros((args[0].shape[0], n_tangent), dtype=torch.float32,
                     device=args[0].device)
    return vmap(jacfwd(f))(d0, *args), f(d0, *args)


def _build_round(mesh: Mesh, cfg: PgoConfig, m_int: int, n_sep: int, n: int):
    """One Gauss-Newton round of this rank: ``gn_round(nodes, gps_on, free,
    int_ids, int_mask, sep_ids, sep_mask, e_rows, e_slots, e_mask, g_rows,
    g_slots, g_mask, f_rows, f_slots, f_mask, o_rows, o_slots, o_mask, se3,
    gps, floor, orient) -> (nodes, gps_on)``, the per-rank plan rows being
    this rank's."""
    ndev = mesh.size
    m_ext = m_int + n_sep
    f32 = torch.float32

    def gn_round(nodes: GraphNodes, gps_on, free,
                 int_ids, int_mask, sep_ids, sep_mask,
                 e_rows, e_slots, e_mask,
                 g_rows, g_slots, g_mask,
                 f_rows, f_slots, f_mask,
                 o_rows, o_slots, o_mask,
                 se3, gps, floor, orient):
        dev = nodes.pos.device
        # ---- robust weights + chi2 gate (replicated; tiny) --------------
        dx0 = torch.zeros((n, 6), dtype=f32, device=dev)
        r_se3_raw = _se3_residual(nodes, se3, dx0)
        rw_se3_all = _huber_weights(r_se3_raw, cfg.huber_delta)
        if cfg.dcs_phi > 0:
            # Dynamic Covariance Scaling on loop / cross edges, as the
            # single-device solver (posegraph.optimize)
            is_loop = torch.abs(se3.idx[:, 0] - se3.idx[:, 1]) > 1
            chi2_se3 = torch.sum(r_se3_raw ** 2, dim=-1)
            s2 = torch.clamp(2.0 * cfg.dcs_phi / (cfg.dcs_phi + chi2_se3), max=1.0)
            rw_se3_all = rw_se3_all * torch.where(is_loop, torch.sqrt(s2), 1.0)
        r_gps_raw = _gps_residual(nodes, gps._replace(mask=gps.mask & gps_on), dx0)
        rw_gps_all = _huber_weights(r_gps_raw, cfg.huber_delta) * gps_on.to(f32)
        chi2 = torch.sum(r_gps_raw ** 2, dim=-1)
        gps_on_new = gps_on & (chi2 < cfg.gps_chi2_gate)

        # ---- linearize this rank's factors -------------------------------
        ei = se3.idx[e_rows].long()                             # (E_loc, 2)
        w_e = (e_mask & se3.mask[e_rows]).to(f32) * rw_se3_all[e_rows]
        J_e, r_e = _blocks(_se3_f, 12, (
            nodes.quat[ei[:, 0]], nodes.pos[ei[:, 0]],
            nodes.quat[ei[:, 1]], nodes.pos[ei[:, 1]],
            se3.q_meas[e_rows], se3.t_meas[e_rows], se3.sqrt_info[e_rows], w_e[:, None]))

        # ---- assemble the dense extended Hessian --------------------------
        H = torch.zeros((m_ext, m_ext, 6, 6), dtype=f32, device=dev)
        b = torch.zeros((m_ext, 6), dtype=f32, device=dev)
        a_s, b_s_ = e_slots[:, 0], e_slots[:, 1]
        Ji, Jj = J_e[:, :, :6], J_e[:, :, 6:]
        H.index_put_((a_s, a_s), torch.einsum("eki,ekj->eij", Ji, Ji), accumulate=True)
        H.index_put_((a_s, b_s_), torch.einsum("eki,ekj->eij", Ji, Jj), accumulate=True)
        H.index_put_((b_s_, a_s), torch.einsum("eki,ekj->eij", Jj, Ji), accumulate=True)
        H.index_put_((b_s_, b_s_), torch.einsum("eki,ekj->eij", Jj, Jj), accumulate=True)
        b.index_add_(0, a_s, torch.einsum("eki,ek->ei", Ji, r_e))
        b.index_add_(0, b_s_, torch.einsum("eki,ek->ei", Jj, r_e))

        # GPS priors (translation only)
        wg = ((g_mask & gps.mask[g_rows]).to(f32)
              * rw_gps_all[g_rows])[:, None] * gps.sqrt_info[g_rows]
        r_g = (nodes.pos[gps.idx[g_rows].long()] - gps.xyz[g_rows]) * wg
        gblk = torch.zeros((g_rows.shape[0], 6, 6), dtype=f32, device=dev)
        for a in range(3):
            gblk[:, 3 + a, 3 + a] = wg[:, a] ** 2
        H.index_put_((g_slots, g_slots), gblk, accumulate=True)
        b[:, 3:].index_add_(0, g_slots, wg * r_g)

        # floor priors
        fi = floor.idx[f_rows].long()
        wf = (f_mask & floor.mask[f_rows]).to(f32)
        J_f, r_f = _blocks(_floor_f, 6, (nodes.quat[fi], nodes.pos[fi], floor.z[f_rows],
                                         floor.sqrt_info[f_rows], wf[:, None]))
        H.index_put_((f_slots, f_slots), torch.einsum("eki,ekj->eij", J_f, J_f),
                     accumulate=True)
        b.index_add_(0, f_slots, torch.einsum("eki,ek->ei", J_f, r_f))

        # orientation priors
        oi = orient.idx[o_rows].long()
        wo = (o_mask & orient.mask[o_rows]).to(f32)
        J_o, r_o = _blocks(_orient_f, 6, (nodes.quat[oi], orient.quat[o_rows],
                                          orient.sqrt_info[o_rows], wo[:, None]))
        H.index_put_((o_slots, o_slots), torch.einsum("eki,ekj->eij", J_o, J_o),
                     accumulate=True)
        b.index_add_(0, o_slots, torch.einsum("eki,ek->ei", J_o, r_o))

        b = -b

        # ---- free / fixed masking over the extended slots ----------------
        ext_free = torch.cat([int_mask & (free[int_ids] > 0),
                              sep_mask & (free[sep_ids] > 0)]).to(f32)
        H = H * ext_free[:, None, None, None] * ext_free[None, :, None, None]
        b = b * ext_free[:, None]

        # ---- Schur elimination of the interiors ---------------------------
        Hd = H.permute(0, 2, 1, 3).reshape(m_ext * 6, m_ext * 6)
        bd = b.reshape(m_ext * 6)
        k = m_int * 6
        int_free = torch.repeat_interleave(ext_free[:m_int], 6)
        # pinned slots (padding, fixed interiors) get a unit diagonal
        H_ii = Hd[:k, :k] + torch.diag(1.0 - int_free)
        H_is = Hd[:k, k:]
        H_ss = Hd[k:, k:]
        b_i = bd[:k]
        b_s = bd[k:]
        # symmetric Jacobi scaling before the float32 Cholesky, plus
        # damping relative to the unit diagonal: edge information spans
        # 1e0 (soft loop axes) to 4e4 (odometry), and an unscaled float32
        # factorization of the chain-structured interior block loses
        # positive definiteness at campaign scale
        dsc = torch.sqrt(torch.clamp(torch.diagonal(H_ii), min=1e-8))
        Hn = H_ii / dsc[:, None] / dsc[None, :] \
            + (cfg.damping + 1e-6) * torch.eye(k, dtype=f32, device=dev)
        L, not_pd = torch.linalg.cholesky_ex(Hn)
        # a factor that is not positive definite gives NaN, as JAX's does
        L = torch.where(not_pd == 0, L, float("nan"))
        X = torch.cholesky_solve(H_is / dsc[:, None], L) / dsc[:, None]      # H_ii^-1 H_is
        y = torch.cholesky_solve((b_i / dsc)[:, None], L)[:, 0] / dsc
        S_d = H_ss - H_is.T @ X
        rhs_d = b_s - H_is.T @ y

        S, rhs = psum(mesh, S_d, rhs_d)
        sep_free = torch.repeat_interleave(ext_free[m_int:], 6)
        S = S * sep_free[:, None] * sep_free[None, :] + torch.diag(1.0 - sep_free)
        dsep = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-8))
        Sn = S / dsep[:, None] / dsep[None, :] \
            + (cfg.damping + 1e-6) * torch.eye(n_sep * 6, dtype=f32, device=dev)
        dx_s = torch.linalg.solve_ex(Sn, (rhs * sep_free) / dsep)[0] / dsep
        dx_s = dx_s * sep_free

        # back-substitute the interiors
        dx_i = (y - X @ dx_s) * int_free

        # ---- scatter to global (n, 6); the sum combines the ranks ---------
        out = torch.zeros((n + 1, 6), dtype=f32, device=dev)
        out.index_add_(0, torch.where(int_mask, int_ids, n), dx_i.reshape(m_int, 6))
        out.index_add_(0, torch.where(sep_mask, sep_ids, n), dx_s.reshape(n_sep, 6) / ndev)
        dx, = psum(mesh, out[:n])
        new_nodes = nodes._replace(
            quat=so3.quat_normalize(so3.quat_mul(nodes.quat, so3.quat_from_rotvec(dx[:, :3]))),
            pos=nodes.pos + dx[:, 3:])
        return new_nodes, gps_on_new

    return gn_round


@slam_f32
def optimize_schur(graph: PoseGraphData, mesh: Mesh,
                   cfg: PgoConfig = PgoConfig()) -> Tuple[PoseGraphData, dict]:
    """Distributed robust Gauss-Newton by Schur-complement reduction: every
    factor type and GNSS gating, an exact step per outer round.  Every rank
    calls it with the same graph and returns the same one.  ``info``:
    ``gps_inliers``, ``n_sep``, and the rounds' wall times
    (``compile_plus_first_round_s`` is the first round's: nothing is
    compiled here).  Raises ``ValueError`` on every rank when the ranks'
    graphs differ."""
    check_replicated(mesh, "optimize_schur", graph)
    plan = build_plan(graph, mesh.size)
    n = graph.nodes.quat.shape[0]
    dev = graph.nodes.pos.device
    free = (graph.nodes.mask & ~graph.nodes.fixed).to(torch.float32)
    rnd = _build_round(mesh, cfg, plan.m_int, plan.n_sep, n)

    def mine(a):
        return torch.as_tensor(a[mesh.rank], device=dev)

    args_static = (
        mine(plan.int_ids), mine(plan.int_mask),
        torch.as_tensor(plan.sep_ids, device=dev), torch.as_tensor(plan.sep_mask, device=dev),
        mine(plan.e_rows), mine(plan.e_slots), mine(plan.e_mask),
        mine(plan.g_rows), mine(plan.g_slots), mine(plan.g_mask),
        mine(plan.f_rows), mine(plan.f_slots), mine(plan.f_mask),
        mine(plan.o_rows), mine(plan.o_slots), mine(plan.o_mask))
    nodes = graph.nodes
    gps_on = torch.ones_like(graph.gps.mask)
    round_s = []
    for _ in range(cfg.outer_iters):
        t0 = time.perf_counter()
        nodes, gps_on = rnd(nodes, gps_on, free, *args_static,
                            graph.se3, graph.gps, graph.floor, graph.orient)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_s.append(time.perf_counter() - t0)
    steady = round_s[1:] or round_s
    info = dict(gps_inliers=(graph.gps.mask & gps_on).to(torch.int32).sum(),
                n_sep=int(plan.sep_mask.sum()),
                compile_plus_first_round_s=round(round_s[0], 3),
                solve_round_ms=round(1e3 * sum(steady) / len(steady), 2),
                solve_total_s=round(sum(steady), 3))
    return graph._replace(nodes=nodes, gps=graph.gps._replace(mask=graph.gps.mask & gps_on)), info
