"""Schur-complement reduction of submap blocks for the pose-graph solver —
port of ``tpu_slam/solver/schur.py``.

Nodes are partitioned into S contiguous submaps; every node touched by a
cross-submap edge is promoted into a global *separator* set. After
permutation the damped, gauge-fixed normal equations take the arrow form

    [ A   B ] [δ_int]   [−b_int]       A = blockdiag(A_1..A_S)
    [ Bᵀ  C ] [δ_sep] = [−b_sep]

so the solve factors into S independent Cholesky factorizations of the
(3m, 3m) submap systems A_k, the separator system
S_c = C − Σ_k B_kᵀ A_k⁻¹ B_k, its factorization, and a back-substitution.
It is the same system as ``solver/lm.dense_solve`` (diagonal × (1+λ) plus
a 1e-12 jitter, fixed nodes → identity rows), so the deltas agree to
factorization roundoff.

The partition is numpy on the host (``build_partition``, the reference's
index for index). The device work is plain PyTorch, as the reference's is
XLA's (``cho_factor``, scatters, products); no kernel is involved:
  * the submaps are factored as one batch (``torch.linalg.cholesky_ex``),
    solved against [B | b_int] in one ``torch.cholesky_solve``, and
    Σ_k B_kᵀ A_k⁻¹ B_k is one product of the (S·3m, 3ns) stacks;
  * the 3×3 blocks are summed into A, B and C in a fixed order: an
    assembly plan (built once per partition on the host) lists, for every
    block position, the rows of the blocks that land there, and each
    position is the sum of its gathered rows. The normal equations are
    summed node by node in edge order (``solver/distributed.slot_table``).
    No float atomic add is involved, so a solve gives the same bits from
    run to run;
  * a failed factorization (of a submap or of the separator system) gives
    a NaN step, which the LM rejects, as the reference's ``cho_factor``
    does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_slam_torch.parallel.mesh import Mesh, psum, psum_packed
from tpu_slam_torch.solver.distributed import (
    EdgeShard, edge_blocks, segment_sum, slot_table,
)
from tpu_slam_torch.solver.lm import damped


@dataclasses.dataclass(frozen=True)
class SchurPartition:
    """Host-built index maps of one graph partition (all numpy)."""

    n_submaps: int
    n_nodes: int
    int_nodes: np.ndarray  # (S, m) global node id per internal slot (pad 0)
    int_valid: np.ndarray  # (S, m) bool — slot holds a real node
    sep_nodes: np.ndarray  # (ns,) global node ids (pad 0)
    sep_valid: np.ndarray  # (ns,) bool
    # int-int edges, per submap (both endpoints internal to the submap)
    ii_edge: np.ndarray  # (S, Eii) edge index (pad 0)
    ii_li: np.ndarray  # (S, Eii) local slot of endpoint i
    ii_lj: np.ndarray  # (S, Eii) local slot of endpoint j
    ii_valid: np.ndarray  # (S, Eii)
    # int-sep edges, per submap; Hij oriented internal→separator
    is_edge: np.ndarray  # (S, Eis)
    is_li: np.ndarray  # (S, Eis) local internal slot
    is_sj: np.ndarray  # (S, Eis) separator slot
    is_transpose: np.ndarray  # (S, Eis) True if edge stored sep→int
    is_valid: np.ndarray  # (S, Eis)
    # sep-sep edges (global)
    ss_edge: np.ndarray  # (Ess,)
    ss_si: np.ndarray  # (Ess,)
    ss_sj: np.ndarray  # (Ess,)
    ss_valid: np.ndarray  # (Ess,)


_PART_ARRAY_FIELDS = [
    f.name for f in dataclasses.fields(SchurPartition)
    if f.name not in ("n_submaps", "n_nodes")
]


def _pad2(rows: list[np.ndarray], fill=0) -> np.ndarray:
    n = max((len(r) for r in rows), default=0)
    n = max(n, 1)
    out = np.full((len(rows), n), fill, dtype=np.int64)
    for k, r in enumerate(rows):
        out[k, : len(r)] = r
    return out


def build_partition(
    ei: np.ndarray,
    ej: np.ndarray,
    edge_valid: np.ndarray,
    n_nodes: int,
    n_submaps: int,
) -> SchurPartition:
    """Contiguous-block partition with separator promotion.

    Scans arrive in trajectory order, so contiguous blocks are the natural
    submaps (odometry/chain edges stay internal); only loop closures and
    block boundaries promote nodes into the separator set.
    """
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    ev = np.asarray(edge_valid, bool)
    S = n_submaps
    block_size = -(-n_nodes // S)  # ceil
    blk = np.minimum(np.arange(n_nodes) // block_size, S - 1)

    cross = ev & (blk[ei] != blk[ej])
    sep_set = np.unique(np.concatenate([ei[cross], ej[cross]])) if cross.any() else np.empty(0, np.int64)
    is_sep = np.zeros(n_nodes, bool)
    is_sep[sep_set] = True

    # internal slots per submap + local index map
    local = np.full(n_nodes, -1, np.int64)
    int_rows = []
    for k in range(S):
        nodes = np.where((blk == k) & ~is_sep)[0]
        local[nodes] = np.arange(len(nodes))
        int_rows.append(nodes)
    int_nodes = _pad2(int_rows)
    m = int_nodes.shape[1]
    int_valid = np.zeros((S, m), bool)
    for k, r in enumerate(int_rows):
        int_valid[k, : len(r)] = True

    sep_local = np.full(n_nodes, -1, np.int64)
    sep_local[sep_set] = np.arange(len(sep_set))
    ns = max(len(sep_set), 1)
    sep_nodes = np.zeros(ns, np.int64)
    sep_nodes[: len(sep_set)] = sep_set
    sep_valid = np.zeros(ns, bool)
    sep_valid[: len(sep_set)] = True

    # classify edges
    E = len(ei)
    kind_int = ~is_sep
    ii_e, ii_i, ii_j = [[] for _ in range(S)], [[] for _ in range(S)], [[] for _ in range(S)]
    is_e, is_i, is_j, is_t = (
        [[] for _ in range(S)], [[] for _ in range(S)],
        [[] for _ in range(S)], [[] for _ in range(S)],
    )
    ss_e, ss_i, ss_j = [], [], []
    for e in range(E):
        if not ev[e]:
            continue
        a, b = ei[e], ej[e]
        ia, ib = kind_int[a], kind_int[b]
        if ia and ib:
            assert blk[a] == blk[b], "internal-internal edge crosses submaps"
            k = blk[a]
            ii_e[k].append(e)
            ii_i[k].append(local[a])
            ii_j[k].append(local[b])
        elif ia and not ib:
            k = blk[a]
            is_e[k].append(e)
            is_i[k].append(local[a])
            is_j[k].append(sep_local[b])
            is_t[k].append(0)
        elif ib and not ia:
            k = blk[b]
            is_e[k].append(e)
            is_i[k].append(local[b])
            is_j[k].append(sep_local[a])
            is_t[k].append(1)  # Hij is sep→int; transpose into B
        else:
            ss_e.append(e)
            ss_i.append(sep_local[a])
            ss_j.append(sep_local[b])

    def valid2(rows):
        arr = _pad2(rows)
        v = np.zeros(arr.shape, bool)
        for k, r in enumerate(rows):
            v[k, : len(r)] = True
        return arr, v

    ii_edge, ii_valid = valid2(ii_e)
    is_edge, is_valid = valid2(is_e)
    Ess = max(len(ss_e), 1)
    ss_edge = np.zeros(Ess, np.int64)
    ss_edge[: len(ss_e)] = ss_e
    ss_valid = np.zeros(Ess, bool)
    ss_valid[: len(ss_e)] = True
    ss_si = np.zeros(Ess, np.int64)
    ss_si[: len(ss_i)] = ss_i
    ss_sj = np.zeros(Ess, np.int64)
    ss_sj[: len(ss_j)] = ss_j

    def i32(a):
        return a.astype(np.int32) if a.dtype != bool else a

    return SchurPartition(
        n_submaps=S,
        n_nodes=n_nodes,
        int_nodes=i32(int_nodes),
        int_valid=int_valid,
        sep_nodes=i32(sep_nodes),
        sep_valid=sep_valid,
        ii_edge=i32(ii_edge),
        ii_li=i32(_pad2(ii_i)),
        ii_lj=i32(_pad2(ii_j)),
        ii_valid=ii_valid,
        is_edge=i32(is_edge),
        is_li=i32(_pad2(is_i)),
        is_sj=i32(_pad2(is_j)),
        is_transpose=_pad2(is_t).astype(bool),
        is_valid=is_valid,
        ss_edge=i32(ss_edge),
        ss_si=i32(ss_si),
        ss_sj=i32(ss_sj),
        ss_valid=ss_valid,
    )


def bucket_partition(
    part: SchurPartition, min_width: int = 16
) -> SchurPartition:
    """Pad every data-dependent partition width up to a power-of-two bucket
    (from ``min_width``); pad slots carry index 0 and valid=False, which
    the solve treats as identity gauge rows and dropped blocks. The
    reference buckets so that its compiled LM programs are reused as a
    graph grows; here it keeps the partition, and the solve's shapes, the
    reference's."""

    def _b(n: int) -> int:
        b = min_width
        while b < n:
            b *= 2
        return b

    def pad_last(a: np.ndarray, fill=0) -> np.ndarray:
        w = _b(a.shape[-1])
        if w == a.shape[-1]:
            return a
        pad = [(0, 0)] * (a.ndim - 1) + [(0, w - a.shape[-1])]
        return np.pad(a, pad, constant_values=fill)

    return dataclasses.replace(
        part,
        **{
            name: pad_last(np.asarray(getattr(part, name)))
            for name in _PART_ARRAY_FIELDS
        },
    )


# --- the assembly plan ------------------------------------------------------


class _Table(NamedTuple):
    """The block positions that receive blocks (``dest``, ascending flat
    indices), the rows of the blocks that land at each (``src``, (U, D),
    padded with row 0, a zero block), and where each submap's positions
    start (``ptr``, host ints; None for the separator system)."""

    dest: torch.Tensor
    src: torch.Tensor
    ptr: list | None


class _Nodes(NamedTuple):
    """The partition's node maps on one device."""

    int_nodes: torch.Tensor  # (S, m)
    int_valid: torch.Tensor  # (S, m)
    sep_nodes: torch.Tensor  # (ns,)
    sep_valid: torch.Tensor  # (ns,)
    int_slot: torch.Tensor  # flat (S·m) slots of the real internal nodes
    int_node: torch.Tensor  # their nodes
    sep_slot: torch.Tensor  # the real separator slots
    sep_node: torch.Tensor  # their nodes


class _Plan(NamedTuple):
    """What the device needs of a partition of a graph of E edges, on one
    device. The blocks are gathered from one (1 + M + 2E, 9) array
    (``_block_rows``): a zero row, the damped diagonal blocks, the edges'
    Hij, then their Hijᵀ."""

    nodes: _Nodes
    A: _Table  # into (S, m, m) block positions
    B: _Table  # into (S, m, ns)
    C: _Table  # into (ns, ns)
    table: torch.Tensor | None  # the normal equations' slot table


def _table(dest: np.ndarray, src: np.ndarray, dev, per: int | None,
           parts: int) -> _Table:
    """Group the (dest, src) pairs by dest, each group in the order given."""
    order = np.argsort(dest, kind="stable")
    d, s = dest[order], src[order]
    uniq, start, counts = np.unique(d, return_index=True, return_counts=True)
    D = max(int(counts.max()) if len(counts) else 1, 1)
    src_tab = np.zeros((len(uniq), D), np.int64)
    group = np.repeat(np.arange(len(uniq)), counts)
    src_tab[group, np.arange(len(d)) - start[group]] = s
    ptr = None if per is None else [
        int(x) for x in np.searchsorted(uniq, np.arange(parts + 1) * per)]
    return _Table(torch.as_tensor(uniq, device=dev),
                  torch.as_tensor(src_tab, device=dev), ptr)


def _node_maps(part: SchurPartition, dev) -> _Nodes:
    int_nodes = np.asarray(part.int_nodes, np.int64)
    int_valid = np.asarray(part.int_valid, bool)
    sep_nodes = np.asarray(part.sep_nodes, np.int64)
    sep_valid = np.asarray(part.sep_valid, bool)
    int_slot = np.nonzero(int_valid.reshape(-1))[0]
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return _Nodes(t(int_nodes), t(int_valid), t(sep_nodes), t(sep_valid),
                  t(int_slot), t(int_nodes.reshape(-1)[int_slot]),
                  t(np.nonzero(sep_valid)[0]), t(sep_nodes[sep_valid]))


def _build_plan(part: SchurPartition, E: int, dev) -> _Plan:
    S, M = part.n_submaps, part.n_nodes
    int_nodes = np.asarray(part.int_nodes, np.int64)
    int_valid = np.asarray(part.int_valid, bool)
    m = int_nodes.shape[1]
    sep_nodes = np.asarray(part.sep_nodes, np.int64)
    sep_valid = np.asarray(part.sep_valid, bool)
    ns = sep_nodes.shape[0]
    for name in ("ii_edge", "is_edge", "ss_edge"):
        idx = np.asarray(getattr(part, name))
        if idx.size and int(idx.max()) >= max(E, 1):
            raise ValueError(f"the partition's {name} passes the {E} edges")

    def edge(e):  # the rows of an edge's Hij in the block array
        return 1 + M + e

    def edge_t(e):  # and of its Hijᵀ
        return 1 + M + E + e

    # A: diagonal blocks, then Hij at (li, lj), then Hijᵀ at (lj, li)
    k, a = np.nonzero(int_valid)
    ke, ee = np.nonzero(np.asarray(part.ii_valid, bool))
    e = np.asarray(part.ii_edge, np.int64)[ke, ee]
    li = np.asarray(part.ii_li, np.int64)[ke, ee]
    lj = np.asarray(part.ii_lj, np.int64)[ke, ee]
    A = _table(np.concatenate([(k * m + a) * m + a, (ke * m + li) * m + lj,
                               (ke * m + lj) * m + li]),
               np.concatenate([1 + int_nodes[k, a], edge(e), edge_t(e)]),
               dev, m * m, S)

    # B: Hij oriented internal → separator
    ke, ee = np.nonzero(np.asarray(part.is_valid, bool))
    e = np.asarray(part.is_edge, np.int64)[ke, ee]
    tr = np.asarray(part.is_transpose, bool)[ke, ee]
    li = np.asarray(part.is_li, np.int64)[ke, ee]
    sj = np.asarray(part.is_sj, np.int64)[ke, ee]
    B = _table((ke * m + li) * ns + sj, np.where(tr, edge_t(e), edge(e)),
               dev, m * ns, S)

    # C: separator diagonal blocks, then Hij at (si, sj), Hijᵀ at (sj, si)
    s = np.nonzero(sep_valid)[0]
    v = np.asarray(part.ss_valid, bool)
    e = np.asarray(part.ss_edge, np.int64)[v]
    si = np.asarray(part.ss_si, np.int64)[v]
    sj = np.asarray(part.ss_sj, np.int64)[v]
    C = _table(np.concatenate([s * ns + s, si * ns + sj, sj * ns + si]),
               np.concatenate([1 + sep_nodes[s], edge(e), edge_t(e)]),
               dev, None, 1)
    return _Plan(_node_maps(part, dev), A, B, C, None)


# (id(part), E, device) → (part, plan); E None for the node maps alone. The
# partition is kept so that its id is not taken by a new partition's while
# the entry lives.
_PLANS: dict = {}


def _cached(part: SchurPartition, E, dev, build):
    key = (id(part), E, str(dev))
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not part:
        if len(_PLANS) > 64:
            _PLANS.clear()
        hit = _PLANS[key] = (part, build())
    return hit[1]


def _assembly_plan(part: SchurPartition, E: int, dev, ei=None,
                  ej=None) -> _Plan:
    """The partition's assembly plan for E edges on ``dev``, built once.
    With ``ei`` and ``ej`` (the edges the partition was built from) it
    also holds their slot table for the normal equations."""
    dev = torch.device(dev)
    plan = _cached(part, int(E), dev, lambda: _build_plan(part, int(E), dev))
    if plan.table is None and ei is not None:
        plan = plan._replace(table=slot_table(ei, ej, part.n_nodes))
        _PLANS[(id(part), int(E), str(dev))] = (part, plan)
    return plan


def _block_rows(Hdd, Hij):
    """The (1 + M + 2E, 9) array the plan gathers from."""
    flat = lambda x: x.reshape(x.shape[0], 9)  # noqa: E731
    return torch.cat([Hdd.new_zeros((1, 9)), flat(Hdd), flat(Hij),
                      flat(Hij.mT)])


def _blocks(V, tab: _Table, n: int, lo: int = 0, hi: int | None = None,
            base: int = 0):
    """(n, 9): each position's gathered blocks summed in the plan's order
    (positions ``tab.dest[lo:hi] - base``); zeros elsewhere."""
    out = V.new_zeros((n, 9))
    out[tab.dest[lo:hi] - base] = V[tab.src[lo:hi]].sum(1)
    return out


def _masks(nodes: _Nodes, free_mask, dt, ks=slice(None)):
    """The internal slots' free mask (S', m) and the separators' (ns,)."""
    fm_int = (nodes.int_valid[ks] & free_mask[nodes.int_nodes[ks]]).to(dt)
    fm_sep = (nodes.sep_valid & free_mask[nodes.sep_nodes]).to(dt)
    return fm_int, fm_sep


def _submap_AB(plan: _Plan, V, fm_int, k0: int, k1: int):
    """Gauge-fixed A (S', 3m, 3m) and B (S', 3m, 3ns) of submaps k0..k1-1,
    the separator-side mask left to the caller (fixed separators get zero
    columns on the reduced system)."""
    m, ns = plan.nodes.int_nodes.shape[1], plan.nodes.sep_nodes.shape[0]
    Sk = k1 - k0
    A = _blocks(V, plan.A, Sk * m * m, plan.A.ptr[k0], plan.A.ptr[k1],
                k0 * m * m).view(Sk, m, m, 3, 3)
    A = A.permute(0, 1, 3, 2, 4).reshape(Sk, 3 * m, 3 * m)
    B = _blocks(V, plan.B, Sk * m * ns, plan.B.ptr[k0], plan.B.ptr[k1],
                k0 * m * ns).view(Sk, m, ns, 3, 3)
    B = B.permute(0, 1, 3, 2, 4).reshape(Sk, 3 * m, 3 * ns)
    fm3 = fm_int.repeat_interleave(3, -1)
    A = A * fm3[:, :, None] * fm3[:, None, :] + torch.diag_embed(1.0 - fm3)
    return A, B * fm3[:, :, None]


def _sep_matrix(plan: _Plan, V, fm_sep):
    """The damped, gauge-fixed separator matrix C (3ns, 3ns) and the
    separators' column mask (3ns,)."""
    ns = plan.nodes.sep_nodes.shape[0]
    C = _blocks(V, plan.C, ns * ns).view(ns, ns, 3, 3)
    C = C.permute(0, 2, 1, 3).reshape(3 * ns, 3 * ns)
    colmask = fm_sep.repeat_interleave(3)
    C = C * colmask[:, None] * colmask[None, :] + torch.diag(1.0 - colmask)
    return C, colmask


def _cho(A):
    """The Cholesky factor of A (or of each of a batch), NaN where the
    factorization failed; never raises."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info != 0).view(*info.shape, 1, 1)
    return L.masked_fill(failed, float("nan"))


def _reduced(B, YB, C, colmask):
    """The separator system S_c = C − Σ_k B_kᵀ A_k⁻¹ B_k, the sum one
    product of the (S'·3m, 3ns) stacks, which never holds S copies of the
    (3ns)² system."""
    Bf = B.reshape(-1, B.shape[-1]).mT
    return C - (Bf @ YB.reshape(Bf.shape[1], -1)) * colmask[:, None] \
        * colmask[None, :]


def _solve_sep(Sc, rhs, colmask):
    """Sc⁻¹ rhs, masked to the free separators."""
    return torch.cholesky_solve(rhs[:, None], _cho(Sc))[:, 0] * colmask


def _scatter(nodes: _Nodes, d_int, d_sep, fm_int, fm_sep, M: int,
             int_slot=None, int_node=None):
    """δ (M, 3) from the internal (S', m, 3) and separator (ns, 3) parts.
    Every node is written once (unique indices, no accumulation);
    ``int_slot``/``int_node`` pick a subset of the internal slots."""
    out = (d_sep if d_int is None else d_int).new_zeros((M, 3))
    if d_int is not None:
        slot = nodes.int_slot if int_slot is None else int_slot
        node = nodes.int_node if int_node is None else int_node
        out[node] = (d_int * fm_int[..., None]).reshape(-1, 3)[slot]
    if d_sep is not None:
        out[nodes.sep_node] = (d_sep.view(-1, 3) * fm_sep[:, None])[
            nodes.sep_slot]
    return out


def _normal_equations(plan: _Plan, poses, ei, ej, means, infos, mask):
    """Hd (M, 3, 3), Hij (E, 3, 3) and b (M, 3) of the graph, each node's
    terms summed in edge order (the plan's slot table)."""
    infos = infos * mask.to(infos.dtype)[:, None, None]
    sh = EdgeShard(ei, ej, means, infos, ei, ej, plan.table)
    Hii, Hjj, Hij, bi, bj = edge_blocks(poses, sh)
    E = Hii.shape[0]
    Hd = segment_sum(Hii.reshape(E, 9), Hjj.reshape(E, 9), plan.table)
    return Hd.view(-1, 3, 3), Hij, segment_sum(bi, bj, plan.table)


class SchurFactor(NamedTuple):
    """``schur_factor``'s result: the submaps' factors L (S, 3m, 3m), B and
    A⁻¹B (S, 3m, 3ns), the internal slots' mask (S, m), the separator
    system's factor (3ns, 3ns), the separators' mask (ns,) and column mask
    (3ns,)."""

    L: torch.Tensor
    B: torch.Tensor
    YB: torch.Tensor
    fm_int: torch.Tensor
    Lsc: torch.Tensor
    fm_sep: torch.Tensor
    colmask: torch.Tensor


def schur_factor(part: SchurPartition, Hdd, Hij, free_mask) -> SchurFactor:
    """Factor the damped gauge-fixed system once, in the type of ``Hdd``;
    ``schur_apply`` solves it for any right-hand side. ``Hdd`` (M, 3, 3)
    are the damped diagonal blocks (``solver/lm.damped``), ``Hij`` (E, 3,
    3) the edges' off-diagonal blocks."""
    plan = _assembly_plan(part, Hij.shape[0], Hdd.device)
    V = _block_rows(Hdd, Hij)
    fm_int, fm_sep = _masks(plan.nodes, free_mask, Hdd.dtype)
    A, B = _submap_AB(plan, V, fm_int, 0, part.n_submaps)
    L = _cho(A)
    YB = torch.cholesky_solve(B, L)
    C, colmask = _sep_matrix(plan, V, fm_sep)
    return SchurFactor(L, B, YB, fm_int, _cho(_reduced(B, YB, C, colmask)),
                       fm_sep, colmask)


def schur_apply(part: SchurPartition, fac: SchurFactor, rhs, free_mask):
    """x = H⁻¹ rhs (both (M, 3)) for the damped gauge-fixed H of the
    factor, by the arrow back-substitution: y_k = A_k⁻¹ r_k;
    S_c x_sep = r_sep − Σ B_kᵀ y_k; x_k = y_k − (A_k⁻¹B_k) x_sep.
    ``free_mask`` is the factor's."""
    nodes = _cached(part, None, fac.L.device,
                    lambda: _node_maps(part, fac.L.device))
    S, m = nodes.int_nodes.shape
    dt = fac.L.dtype
    r_int = (rhs[nodes.int_nodes] * fac.fm_int[..., None]).to(dt)
    y = torch.cholesky_solve(r_int.reshape(S, 3 * m, 1), fac.L)[..., 0]
    r_sep = (rhs[nodes.sep_nodes] * fac.fm_sep[:, None]).reshape(-1).to(dt)
    acc = fac.B.reshape(-1, fac.B.shape[-1]).mT @ y.reshape(-1)
    x_sep = torch.cholesky_solve(((r_sep - acc) * fac.colmask)[:, None],
                                 fac.Lsc)[:, 0] * fac.colmask
    x_int = y - fac.YB @ x_sep
    return _scatter(nodes, x_int.view(S, m, 3), x_sep, fac.fm_int,
                    fac.fm_sep, part.n_nodes)


def _damped_system(plan, poses, ei, ej, means, infos, mask, lam, free_mask):
    """The block array of the damped system (``_block_rows``) and b."""
    Hd, Hij, b = _normal_equations(plan, poses, ei, ej, means, infos, mask)
    return _block_rows(damped(Hd, lam), Hij), b


def schur_delta(part: SchurPartition, poses, ei, ej, means, infos, mask,
                lam, free_mask):
    """The LM step δ (M, 3) of the graph by the Schur complement: the same
    damped (diagonal × (1+λ)), gauge-fixed system as
    ``solver/lm.dense_solve``, in the type of ``poses``. ``part`` is the
    partition of these edges (``build_partition``)."""
    plan = _assembly_plan(part, ei.shape[0], poses.device, ei, ej)
    nodes = plan.nodes
    V, b = _damped_system(plan, poses, ei, ej, means, infos, mask, lam,
                          free_mask)
    fm_int, fm_sep = _masks(nodes, free_mask, poses.dtype)
    A, B = _submap_AB(plan, V, fm_int, 0, part.n_submaps)
    S, m = fm_int.shape
    b_int = (b[nodes.int_nodes] * fm_int[..., None]).reshape(S, 3 * m, 1)
    sol = torch.cholesky_solve(torch.cat([B, b_int], -1), _cho(A))
    YB, y = sol[..., :-1], sol[..., -1]
    C, colmask = _sep_matrix(plan, V, fm_sep)
    b_sep = (b[nodes.sep_nodes] * fm_sep[:, None]).reshape(-1)
    rhs = -b_sep + (B.reshape(-1, B.shape[-1]).mT @ y.reshape(-1)) * colmask
    d_sep = _solve_sep(_reduced(B, YB, C, colmask), rhs, colmask)
    # back-substitution per submap: δ_int = −y − (A⁻¹B) δ_sep
    d_int = (-y - YB @ d_sep).view(S, m, 3)
    return _scatter(nodes, d_int, d_sep, fm_int, fm_sep, part.n_nodes)


def make_distributed_schur_delta(mesh: Mesh, part: SchurPartition,
                                 axis: str = "data"):
    """The submap-sharded Schur step: rank k factors submap k, one psum
    reduces the separator system and its right-hand side, every rank
    solves the separator system, and a psum of the back-substituted
    internal parts gives every rank the whole δ. One submap a rank
    (``part.n_submaps`` must be the mesh's size). The graph's tensors are
    the same on every rank: each assembles the normal equations whole, as
    the reference's devices do. Returns step(poses, ei, ej, means, infos,
    mask, lam, free_mask) → δ (M, 3), as ``schur_delta``."""
    assert part.n_submaps == mesh.shape[axis], (
        "one submap per device on the mesh axis")
    k = mesh.rank
    M = part.n_nodes
    m = part.int_nodes.shape[1]
    slots = np.nonzero(np.asarray(part.int_valid)[k])[0]
    own = (slots, np.asarray(part.int_nodes, np.int64)[k][slots])

    def step(poses, ei, ej, means, infos, mask, lam, free_mask):
        plan = _assembly_plan(part, ei.shape[0], poses.device, ei, ej)
        nodes = plan.nodes
        V, b = _damped_system(plan, poses, ei, ej, means, infos, mask, lam,
                              free_mask)
        fm_int, fm_sep = _masks(nodes, free_mask, poses.dtype,
                                slice(k, k + 1))
        A, B = _submap_AB(plan, V, fm_int, k, k + 1)
        b_int = (b[nodes.int_nodes[k]] * fm_int[0, :, None]).reshape(
            1, 3 * m, 1)
        sol = torch.cholesky_solve(torch.cat([B, b_int], -1), _cho(A))
        YB, y = sol[..., :-1], sol[..., -1]
        C, colmask = _sep_matrix(plan, V, fm_sep)
        b_sep = (b[nodes.sep_nodes] * fm_sep[:, None]).reshape(-1)
        # the one reduction of the solve: the separator system and rhs
        Bf = B.reshape(-1, B.shape[-1]).mT
        Sc_p, rhs_p = psum_packed(mesh, Bf @ YB.reshape(Bf.shape[1], -1),
                                  Bf @ y.reshape(-1))
        Sc = C - Sc_p * colmask[:, None] * colmask[None, :]
        d_sep = _solve_sep(Sc, -b_sep + rhs_p * colmask, colmask)
        # the rank's back-substitution, then every rank's summed
        d_int = (-y - YB @ d_sep).view(1, m, 3)
        slot, node = (torch.as_tensor(x, device=poses.device) for x in own)
        local = psum(_scatter(nodes, d_int, None, fm_int, fm_sep, M, slot,
                              node), mesh)
        return local + _scatter(nodes, None, d_sep, fm_int, fm_sep, M)

    return step
