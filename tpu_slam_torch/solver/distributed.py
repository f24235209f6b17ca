"""Pose-graph solving with the edges sharded over a mesh — port of
``tpu_slam/solver/distributed.py`` and of the mesh arm of the reference's
LM program (``_lm_loop_program`` with ``psum_axis``).

Each rank forms the terms of its block of edges: their costs, the blocks
of their normal equations and, in CG, their share of each matvec. The
reference sums per-rank partials with a psum. Here one ``all_gather``
puts every edge's terms on every rank, and each rank sums them node by
node in edge order (``segment_sum`` over a slot table). So a solve's bits
do not depend on D, and do not change from run to run, as they would
with a float atomic scatter (``index_add_`` on CUDA). The terms are the
reference's edge-lane forms (``normal_equations_T``, ``graph_cost_T``)
written out elementwise, with the sines and cosines taken once a node
and the heading residual wrapped by ``lm.norm_angle``: an edge's terms
are the same whichever rank computes them, and with however many other
edges. Two forms:
  * dense: every edge's blocks gathered, the (3M, 3M) system assembled
    and solved replicated by Cholesky (``lm.dense_solve``); right where M
    is small next to E;
  * CG: the diagonal blocks and b gathered once a step, then one gather a
    matvec of the rank's off-diagonal products; H never materializes.

This is plain PyTorch, as the reference's mesh LM is XLA code and not a
kernel. Every branch (the CG early-out, the LM accept and stop) is taken
on replicated values, so all ranks take it alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_slam_torch.parallel.mesh import Mesh, all_gather_rows, block
from tpu_slam_torch.solver.lm import (
    _mm, _mv, cg_solve, dense_solve, lam_type, lm_loop, norm_angle, pack,
    wrap_headings,
)


class EdgeShard(NamedTuple):
    """The rank's block of the edges (``ei``, ``ej``, ``means``, ``infos``
    with masked edges carrying zero information) and what the sums need of
    the global graph: its edge ends and their slot table."""

    ei: torch.Tensor
    ej: torch.Tensor
    means: torch.Tensor
    infos: torch.Tensor
    gi: torch.Tensor
    gj: torch.Tensor
    table: torch.Tensor


def slot_table(ei, ej, n_nodes: int) -> torch.Tensor:
    """(M, S) int64: the rows of each node's terms among the 2E rows
    [the i-ends of every edge; the j-ends of every edge], in that order;
    S the most any node has, an empty slot pointing at row 2E (zeros)."""
    idx = torch.cat([ei, ej]).to(torch.int64)
    n = idx.shape[0]
    counts = torch.bincount(idx, minlength=n_nodes)
    S = max(int(counts.max()), 1) if n else 1
    order = torch.argsort(idx, stable=True)
    node = idx[order]
    slot = torch.arange(n, device=idx.device) - (torch.cumsum(counts, 0)
                                                 - counts)[node]
    table = torch.full((n_nodes, S), n, dtype=torch.int64, device=idx.device)
    table[node, slot] = order
    return table


def segment_sum(rows_i, rows_j, table) -> torch.Tensor:
    """Each node's sum of the (E, k) terms its edges give their i-end
    (``rows_i``) and j-end (``rows_j``), in edge order → (M, k)."""
    vals = torch.cat([rows_i, rows_j, rows_i.new_zeros((1, rows_i.shape[1]))])
    return vals[table].sum(1)


def shard_graph(mesh: Mesh, ei, ej, means, infos, mask,
                n_nodes: int) -> EdgeShard:
    """The rank's block of the (global, E a multiple of D) edge arrays and
    the global slot table."""
    infos = infos * mask.to(infos.dtype)[:, None, None]
    return EdgeShard(*(block(t, mesh) for t in (ei, ej, means, infos)), ei,
                     ej, slot_table(ei, ej, n_nodes))


def _edge_rows(poses, ei, ej, means):
    """Per edge (the reference's ``_edge_terms_T``): cos and sin of θi,
    the Jacobian's drx and dry, and the residual (E, 3)."""
    cos, sin = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    c, s = cos[ei], sin[ei]
    pi, pj = poses[ei], poses[ej]
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    r = torch.stack([c * dx + s * dy - means[:, 0],
                     -s * dx + c * dy - means[:, 1],
                     norm_angle(pj[:, 2] - pi[:, 2] - means[:, 2])], -1)
    return c, s, -s * dx + c * dy, -c * dx - s * dy, r


def edge_costs(poses, sh: EdgeShard) -> torch.Tensor:
    """rᵀ Ω r of each of the rank's edges (E/D,)."""
    *_, r = _edge_rows(poses, sh.ei, sh.ej, sh.means)
    W = sh.infos
    r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]
    return (W[:, 0, 0] * r0 * r0 + 2 * W[:, 0, 1] * r0 * r1
            + 2 * W[:, 0, 2] * r0 * r2 + W[:, 1, 1] * r1 * r1
            + 2 * W[:, 1, 2] * r1 * r2 + W[:, 2, 2] * r2 * r2)


def edge_blocks(poses, sh: EdgeShard):
    """The rank's edges' normal-equation terms: Hii, Hjj, Hij (E/D, 3, 3)
    and bi, bj (E/D, 3)."""
    c, s, drx, dry, r = _edge_rows(poses, sh.ei, sh.ej, sh.means)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([torch.stack([-c, -s, drx], -1),
                      torch.stack([s, -c, dry], -1),
                      torch.stack([z, z, -o], -1)], -2)
    Jj = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    JiW = _mm(Ji.mT, sh.infos)
    JjW = _mm(Jj.mT, sh.infos)
    return (_mm(JiW, Ji), _mm(JjW, Jj), _mm(JiW, Jj), _mv(JiW, r),
            _mv(JjW, r))


def normal_equations(mesh: Mesh, poses, sh: EdgeShard, *, dense: bool):
    """The summed diagonal blocks Hd (M, 3, 3) and b (M, 3) from one
    gather, with the off-diagonal blocks: every edge's (E, 3, 3) where
    ``dense``, else the rank's own (E/D, 3, 3)."""
    Hii, Hjj, Hij, bi, bj = edge_blocks(poses, sh)
    n = Hii.shape[0]
    parts = [Hii.reshape(n, 9), Hjj.reshape(n, 9), bi, bj]
    if dense:
        parts.append(Hij.reshape(n, 9))
    g = all_gather_rows(torch.cat(parts, 1), mesh)
    M = sh.table.shape[0]
    Hd = segment_sum(g[:, 0:9], g[:, 9:18], sh.table).view(M, 3, 3)
    b = segment_sum(g[:, 18:21], g[:, 21:24], sh.table)
    return Hd, (g[:, 24:33].reshape(-1, 3, 3) if dense else Hij), b


def edge_sum(mesh: Mesh, table):
    """The mesh's ``psum_axis`` of ``lm.cg_matvec``: (rows_i, rows_j) of
    the rank's edges (E/D, k) ↦ each node's sum of every rank's (M, k),
    from one gather, in edge order (``table``: the global slot table)."""

    def f(rows_i, rows_j):
        k = rows_i.shape[1]
        g = all_gather_rows(torch.cat([rows_i, rows_j], 1), mesh)
        return segment_sum(g[:, :k], g[:, k:], table)

    return f


def make_distributed_lm_delta(mesh: Mesh, n_nodes: int):
    """One LM delta with the edges sharded: step(poses (M, 3), ei, ej,
    means, infos, mask (E, ...) with E a multiple of D, lam, free_mask
    (M,)) → replicated delta (M, 3), from one gather of the edges'
    blocks."""

    def step(poses, ei, ej, means, infos, mask, lam, free_mask):
        sh = shard_graph(mesh, ei, ej, means, infos, mask, n_nodes)
        Hd, Hij, b = normal_equations(mesh, poses, sh, dense=True)
        return dense_solve(Hd, Hij, sh.gi, sh.gj, b, lam, free_mask)

    return step


def make_distributed_cg_delta(mesh: Mesh, n_nodes: int, cg_iters: int):
    """The CG form of the delta: ``cg_iters`` Jacobi-preconditioned steps
    (no early stop), one gather of the diagonal blocks and b, then one
    gather a matvec."""

    def step(poses, ei, ej, means, infos, mask, lam, free_mask):
        sh = shard_graph(mesh, ei, ej, means, infos, mask, n_nodes)
        Hd, Hij, b = normal_equations(mesh, poses, sh, dense=False)
        return cg_solve(Hd, Hij, sh.ei, sh.ej, b, lam, free_mask, cg_iters,
                        0.0, edge_sum(mesh, sh.table))

    return step


def mesh_lm(mesh: Mesh, poses, ei, ej, means, infos, mask, free_mask, lam0,
            *, iters: int, use_dense: bool, cg_iters: int, cg_tol: float,
            cg_restarts: int, sq_min_delta: float) -> torch.Tensor:
    """The whole doSPA LM with the edges sharded (the reference's
    ``_lm_loop_program`` under ``psum_axis``): each step dense or CG as
    above, each cost from one gather, λ in the type of ``poses``. Takes the
    global graph (E a multiple of D); returns the packed (8, max(M, 4))
    result of ``solver/lm.pack``."""
    sh = shard_graph(mesh, ei, ej, means, infos, mask, poses.shape[0])
    # the cost sums the real edges' terms alone: the same vector, so the
    # same bits, whatever padding D asks for
    real = torch.nonzero(mask).squeeze(1)

    def cost_of(p):
        return torch.sum(all_gather_rows(edge_costs(p, sh), mesh)[real])

    def step_of(p, lam):
        Hd, Hij, b = normal_equations(mesh, p, sh, dense=use_dense)
        if use_dense:
            return dense_solve(Hd, Hij, sh.gi, sh.gj, b, lam, free_mask)
        return cg_solve(Hd, Hij, sh.ei, sh.ej, b, lam, free_mask, cg_iters,
                        cg_tol, edge_sum(mesh, sh.table), cg_restarts)

    p, cost0, cost, good, it = lm_loop(poses, cost_of, step_of, wrap_headings,
                                       lam0, iters, sq_min_delta,
                                       lam_type(poses.dtype))
    return pack(p.T, cost0, cost, good, it)
