"""Pose-graph Levenberg-Marquardt solver — port of
``tpu_slam/solver/pose_graph.py``.

The residual model, the normal equations and the LM schedule are doSPA's
(``solver/lm.py``); the loop stops once ‖δ‖² is under the float32-floored
``convergence_delta``.

Routing (``_route``) follows the reference's on its TPU, in its order:
  * a graph above ``use_dense_below`` nodes that bands under RCM
    (``use_direct``, no ``use_schur``) → the cyclic-reduction LM:
    ``solver/cr_lm.fused_cr_lm`` up to ``K_MAX`` (512) supernodes,
    ``solver/cr_stream.streamed_cr_lm`` above;
  * a graph of ``f64_schur_above`` nodes or more → the float64
    sparse-direct LM on the host (``_host_direct_lm``), ``use_schur`` or
    not; with ``host_direct_fallback=False`` the float64 LM on the
    solver's device whose every step is a direct Schur solve
    ("f64_schur", ``mixed_schur_delta``);
  * nodes ≤ ``use_dense_below`` on ``cuda`` → the block-Jacobi PCG LM
    (``solver/pcg_lm.fused_lm_solve``) where the reference runs its fused
    Pallas LM: ``use_fused_kernel``, ``cg_restarts ≤ 1``, no ``use_schur``,
    and the kernel's shapes (nodes and edges rounded up to 256) neither
    above the power-of-two buckets of the XLA program nor past the one-hot
    cap. Graphs of ≤ 128 nodes or ≤ 128 edges fail the bucket test;
  * ``use_schur`` with more than 2 × ``schur_submaps`` nodes and at least
    ``use_dense_below`` → the float32 LM whose every step is a Schur solve
    ("schur", ``solver/schur.schur_delta``) over the reference's partition
    of the graph padded to its power-of-two node bucket;
  * any other graph → the dense LM at ≤ ``use_dense_below`` nodes (also
    the reference's route off the TPU), else the PCG LM, with
    ``cg_restarts`` runs of CG a step (the reference's TPU sends
    ``cg_restarts > 1`` to its XLA LM program, the same block-Jacobi PCG
    LM as its fused kernel).
With a mesh every graph takes the edge-sharded LM of
``solver/distributed.mesh_lm``: dense up to ``use_dense_below`` nodes
("mesh_dense"), CG above ("mesh_cg", with ``cg_restarts`` and
``cg_tolerance``). As in the reference, a mesh skips the direct CR route,
the host f64 arm, the fused kernel and Schur.
The kernel routes launch their CUDA kernel on ``cuda`` and run its plain
version on ``cpu``; the host arm runs on the host on either device; the
dense and Schur routes are plain PyTorch on the solver's device (the
reference's are XLA programs) and launch no kernel.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.solver import banded
from tpu_slam_torch.solver.cr_lm import K_MAX, fused_cr_lm
from tpu_slam_torch.solver.cr_stream import streamed_cr_lm
from tpu_slam_torch.solver.distributed import mesh_lm
from tpu_slam_torch.solver.lm import (  # noqa: F401  (the reference's names)
    dense_solve,
    edge_jacobians,
    edge_residuals,
    graph_cost,
    lm_loop,
    normal_equations,
    pack,
    wrap_headings,
)
from tpu_slam_torch.solver.pcg_lm import fused_lm_solve
from tpu_slam_torch.solver.schur import (
    bucket_partition, build_partition, schur_delta,
)

# the fused LM's one-hot cap on (nodes × edges), rounded up to 256 each
# (tpu_slam/solver/pallas_lm.py MAX_ONEHOT_ELEMS)
MAX_ONEHOT_ELEMS = 3_200_000

# graph topology (banded.spec_cache_key) → RCM band spec, or None where the
# graph does not band; the reference keeps the same cache (_CR_SPEC_CACHE)
_SPEC_CACHE: dict = {}
# (bucketed nodes, submaps, blake2b of the edges) → bucketed Schur
# partition (the reference's _SCHUR_PART_CACHE)
_SCHUR_PART_CACHE: dict = {}

# the float64 Schur LM damps its steps at max(λ, this): the reference's
# floor (tpu_slam/solver/pose_graph.py:670-673), which its float32
# preconditioner needs and which slows the LM on graphs with soft modes
F64_SCHUR_LAMBDA_FLOOR = 1e-5


def _sq_min_delta(convergence_delta: float) -> float:
    """cfg.convergence_delta floored at 1e-8: ‖δ‖² in float32 bottoms out
    around 1e-9 and the LM would burn its iteration budget after
    convergence."""
    return max(float(convergence_delta), 1e-8)


def _dense_lm(p0, ei, ej, means, infos, free, lam0, iters, sq_min_delta):
    """The dense arm of the reference's LM program; returns the packed
    (8, M) result."""
    M = p0.shape[0]

    def step(p, lam):
        Hd, Hij, b = normal_equations(p, ei, ej, means, infos, M)
        return dense_solve(Hd, Hij, ei, ej, b, lam, free)

    p, cost0, cost, good, it = lm_loop(
        p0, lambda p: graph_cost(p, ei, ej, means, infos), step,
        wrap_headings, lam0, iters, sq_min_delta)
    return pack(p.T, cost0, cost, good, it)


def _host_direct_lm(poses, ei, ej, means, infos, free, iters, lam0,
                    sq_min_delta):
    """The doSPA LM in float64 on the host, each step a sparse direct
    solve (scipy's ``spsolve``) — the reference's arm for large graphs
    that do not band (``tpu_slam/solver/pose_graph.py:_host_direct_lm``).
    Their soft global modes need a float64 factorization. The damping is
    doSPA's: the diagonal × (1 + λ) plus a 1e-12 jitter; a step is
    accepted when it lowers the cost, and the loop stops, the step not
    taken, once ‖δ‖² < ``sq_min_delta``. Returns (poses (M, 3), cost0,
    cost, good, iterations)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    p = np.asarray(poses, np.float64).copy()
    M, E = p.shape[0], len(ei)
    infw = np.asarray(infos, np.float64)
    fidx = np.nonzero(free)[0]
    col_of = -np.ones(M, np.int64)
    col_of[fidx] = np.arange(len(fidx))
    nf = len(fidx)

    def residuals(q):
        r = gnp.compose(gnp.inverse(q[ei]), q[ej]) - means
        r[:, 2] = np.arctan2(np.sin(r[:, 2]), np.cos(r[:, 2]))
        return r

    def cost(q):
        r = residuals(q)
        return float(np.einsum("ei,eij,ej->", r, infw, r))

    # the COO pattern: four 3×3 blocks per edge between free nodes
    bi, bj = col_of[ei], col_of[ej]
    r3 = np.arange(3)

    def block_idx(a, b):
        n = len(a)
        rows = np.broadcast_to(
            3 * a[:, None, None] + r3[None, :, None], (n, 3, 3))
        cols = np.broadcast_to(
            3 * b[:, None, None] + r3[None, None, :], (n, 3, 3))
        return rows, cols

    lam, laminc = float(lam0), 2.0
    c = cost0 = cost(p)
    good = it = 0
    for _ in range(iters):
        it += 1
        r = residuals(p)
        ci, si = np.cos(p[ei, 2]), np.sin(p[ei, 2])
        dx, dy = p[ej, 0] - p[ei, 0], p[ej, 1] - p[ei, 1]
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0, 0], Ji[:, 0, 1], Ji[:, 0, 2] = -ci, -si, -si * dx + ci * dy
        Ji[:, 1, 0], Ji[:, 1, 1], Ji[:, 1, 2] = si, -ci, -ci * dx - si * dy
        Ji[:, 2, 2] = -1.0
        Jj[:, 0, 0], Jj[:, 0, 1] = ci, si
        Jj[:, 1, 0], Jj[:, 1, 1] = -si, ci
        Jj[:, 2, 2] = 1.0
        JiW = np.einsum("eba,ebc->eac", Ji, infw)
        JjW = np.einsum("eba,ebc->eac", Jj, infw)
        Hii = np.einsum("eab,ebc->eac", JiW, Ji)
        Hjj = np.einsum("eab,ebc->eac", JjW, Jj)
        Hij = np.einsum("eab,ebc->eac", JiW, Jj)
        g = np.zeros((M, 3))
        np.add.at(g, ei, np.einsum("eab,eb->ea", JiW, r))
        np.add.at(g, ej, np.einsum("eab,eb->ea", JjW, r))
        rows_l, cols_l, data_l = [], [], []
        for a, b, blk in ((bi, bi, Hii), (bj, bj, Hjj), (bi, bj, Hij),
                          (bj, bi, np.swapaxes(Hij, -1, -2))):
            ok = (a >= 0) & (b >= 0)
            rr, cc = block_idx(a[ok], b[ok])
            rows_l.append(rr.ravel())
            cols_l.append(cc.ravel())
            data_l.append(blk[ok].ravel())
        H = sp.coo_matrix(
            (np.concatenate(data_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(3 * nf, 3 * nf)).tocsc()
        Hd = H + sp.diags(H.diagonal() * lam + 1e-12)
        try:
            step = spla.spsolve(Hd, -g[fidx].ravel())
        except RuntimeError:  # a failed factorization: a zero step
            step = np.zeros(3 * nf)
        if not np.all(np.isfinite(step)):
            step = np.zeros(3 * nf)
        sq = float(step @ step)
        cand = p.copy()
        cand[fidx] += step.reshape(-1, 3)
        cand[:, 2] = np.arctan2(np.sin(cand[:, 2]), np.cos(cand[:, 2]))
        cn = cost(cand)
        if sq < sq_min_delta:
            break
        if cn < c:
            p, c = cand, cn
            lam *= 0.5
            good += 1
        else:
            lam *= laminc
            laminc *= 2.0
    return p, cost0, c, good, it


def mixed_schur_delta(schur_part, poses, ei, ej, means, infos, mask, lam,
                      free_mask):
    """The float64-exact LM step δ (M, 3) of the graph damped at ``lam``
    (the reference's contract). The reference reaches it with a float32
    Schur factor preconditioning a float64 PCG, because its TPU has no
    float64 factorization; the card has one, so the step is the direct
    Schur solve in float64 (``solver/schur.schur_delta``)."""
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    return schur_delta(schur_part, f64(poses), ei, ej, f64(means),
                       f64(infos), mask, lam, free_mask)


def _bucket(n: int) -> int:
    """The reference's power-of-two shape bucket, from 16."""
    b = 16
    while b < n:
        b *= 2
    return b


def _fused_shapes_fit(num_nodes: int, num_edges: int) -> bool:
    """The reference's shape test for its fused LM
    (``tpu_slam/solver/pose_graph.py:1017-1020``): nodes and edges rounded
    up to 256 may not pass their power-of-two buckets, and their product
    may not pass the kernel's one-hot cap."""
    M, E = max(num_nodes, 2), max(num_edges, 1)
    Mf, Ef = -(-M // 256) * 256, -(-E // 256) * 256
    return Mf <= _bucket(M) and Ef <= _bucket(E) and Mf * Ef <= MAX_ONEHOT_ELEMS


def _route(num_nodes: int, num_edges: int, device, cfg: SolverConfig,
           band_spec=lambda: None, mesh=None) -> str:
    """The solve route of a graph of ``num_nodes`` nodes and ``num_edges``
    edges on ``device``: "dense", "pcg", "direct", "host_f64",
    "f64_schur" or "schur"; with a mesh "mesh_dense" or "mesh_cg" (the
    reference's ``use_dense``, its mesh skipping every other route:
    ``tpu_slam/solver/pose_graph.py:939``, ``:964``, ``:1008``,
    ``:1033``). ``band_spec()`` is called only for a graph above
    ``use_dense_below`` and says whether it bands (None: it does not).
    The order is the reference's (``:939-945``, ``:964-984``,
    ``:1008-1038``); small graphs meet its TPU conditions for its fused
    kernel on ``cuda``, and Schur its partition test (``:1033-1038``)."""
    if mesh is not None:
        return "mesh_dense" if num_nodes <= cfg.use_dense_below else "mesh_cg"
    small = num_nodes <= cfg.use_dense_below
    if (not small and cfg.use_direct and not cfg.use_schur
            and band_spec() is not None):
        return "direct"
    if cfg.f64_schur_above > 0 and num_nodes >= cfg.f64_schur_above:
        return "host_f64" if cfg.host_direct_fallback else "f64_schur"
    if (small and torch.device(device).type == "cuda"
            and cfg.use_fused_kernel and cfg.cg_restarts <= 1
            and not cfg.use_schur
            and _fused_shapes_fit(num_nodes, num_edges)):
        return "pcg"
    if (cfg.use_schur and num_nodes > 2 * cfg.schur_submaps
            and num_nodes >= cfg.use_dense_below):
        return "schur"
    return "dense" if small else "pcg"


class SolveStats(NamedTuple):
    iterations: int
    initial_cost: float
    final_cost: float


class PoseGraphSolver:
    """Host-facing incremental graph with a device-side solve.

    The ScanSolver surface: ``add_node(s)``, ``add_constraint(s)``
    (information = covariance⁻¹ computed here), ``compute`` =
    doSPA(max_iterations) plus the corrections harvest. Poses and edges
    are kept on the host in float64; each device solve uploads them to
    ``device`` in float32, and the host f64 arm solves them where they
    are.

    With a ``mesh`` (``parallel/mesh.Mesh``) the solve runs on the mesh's
    device with the edges sharded over its ranks. Every rank must hold the
    same graph and call ``compute`` alike: each takes its block of the
    edges, and every rank gets the whole result."""

    def __init__(self, cfg: SolverConfig, device=DEFAULT_DEVICE, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self._poses: list[np.ndarray] = []
        self._edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._ids: dict[int, int] = {}  # external id → dense index
        self._arrays = None  # (ei, ej, means, infos) of _edges, built once

    # --- ScanSolver surface -------------------------------------------------
    def add_node(self, node_id: int, pose) -> None:
        self._ids[node_id] = len(self._poses)
        self._poses.append(np.asarray(pose, np.float64))

    def add_nodes(self, node_ids, poses) -> None:
        poses = np.asarray(poses, np.float64)
        base = len(self._poses)
        for k, nid in enumerate(node_ids):
            self._ids[nid] = base + k
        self._poses.extend(poses)

    def add_constraint(self, id_from: int, id_to: int, mean,
                       covariance=None, information=None) -> None:
        self.add_constraints(
            [id_from], [id_to], np.asarray(mean, np.float64)[None],
            covariances=None if covariance is None
            else np.asarray(covariance, np.float64)[None],
            informations=None if information is None
            else np.asarray(information, np.float64)[None],
        )

    def add_constraints(self, ids_from, ids_to, means, covariances=None,
                        informations=None) -> None:
        """Add edges; information = covariance⁻¹, with a 1e-9·I
        regularization for a degenerate covariance."""
        means = np.asarray(means, np.float64)
        if informations is None:
            c = np.asarray(covariances, np.float64)
            try:
                informations = np.linalg.inv(c)
            except np.linalg.LinAlgError:
                informations = np.empty_like(c)
                for k in range(len(c)):
                    try:
                        informations[k] = np.linalg.inv(c[k])
                    except np.linalg.LinAlgError:
                        informations[k] = np.linalg.inv(c[k] + 1e-9 * np.eye(3))
        else:
            informations = np.asarray(informations, np.float64)
        ids = self._ids
        self._arrays = None
        self._edges.extend(
            (ids[int(a)], ids[int(b)], m, inf)
            for a, b, m, inf in zip(ids_from, ids_to, means, informations)
        )

    def get_poses(self) -> np.ndarray:
        return np.asarray(self._poses)

    def set_node_pose(self, node_id: int, pose) -> None:
        self._poses[self._ids[node_id]] = np.asarray(pose, np.float64)

    @property
    def num_nodes(self) -> int:
        return len(self._poses)

    @property
    def num_edges(self) -> int:
        return len(self._edges)

    def clear(self) -> None:
        self._poses.clear()
        self._edges.clear()
        self._ids.clear()
        self._arrays = None

    # --- compute ------------------------------------------------------------
    def compute(self, max_iterations: int | None = None) -> SolveStats:
        """Run LM; updates the stored poses in place."""
        return self.compute_async(max_iterations).harvest()

    def compute_async(self, max_iterations: int | None = None):
        """Dispatch the LM solve. The kernel routes return as soon as the
        kernel is enqueued (the streamed CR-LM once its last chunk of LM
        iterations is); ``harvest()`` fetches the result."""
        iters = max_iterations or self.cfg.max_iterations
        route = _route(self.num_nodes, self.num_edges, self.device,
                       self.cfg, self._band_spec, self.mesh)
        if route in ("mesh_dense", "mesh_cg"):
            return self._compute_mesh(iters, route == "mesh_dense")
        if route == "dense":
            return self._compute_dense(iters)
        if route == "pcg":
            return self._compute_pcg(iters)
        if route == "direct":
            return self._compute_direct(iters, self._band_spec())
        if route == "host_f64":
            return self._compute_host_f64(iters)
        if route == "schur":
            return self._compute_schur(iters)
        return self._compute_f64_schur(iters)

    def _edge_arrays(self):
        """(ei, ej, means, infos) of the edges, built once per edge set."""
        if self._arrays is None:
            E = self.num_edges
            edges = self._edges
            self._arrays = (
                np.fromiter((e[0] for e in edges), np.int64, E),
                np.fromiter((e[1] for e in edges), np.int64, E),
                np.asarray([e[2] for e in edges], np.float64).reshape(E, 3),
                np.asarray([e[3] for e in edges], np.float64).reshape(E, 3, 3),
            )
        return self._arrays

    def device_graph(self):
        """(poses, ei, ej, means, infos, free) on the solver's device:
        float32 poses and edge values, int64 endpoints, and the free mask
        with node 0 fixed as the gauge (nFixed=1)."""
        dev = self.device
        ei, ej, means, infos = self._edge_arrays()
        f32 = dict(dtype=torch.float32, device=dev)
        free = torch.ones(self.num_nodes, dtype=torch.bool, device=dev)
        free[0] = False
        return (torch.as_tensor(np.asarray(self._poses), **f32),
                torch.as_tensor(ei, device=dev),
                torch.as_tensor(ej, device=dev),
                torch.as_tensor(means, **f32), torch.as_tensor(infos, **f32),
                free)

    def _compute_dense(self, iters: int) -> "PendingSolve":
        packed = _dense_lm(
            *self.device_graph(), self.cfg.initial_lambda, iters,
            _sq_min_delta(self.cfg.convergence_delta),
        )
        return PendingSolve(self, packed)

    def _compute_mesh(self, iters: int, use_dense: bool) -> "PendingSolve":
        """The edge-sharded LM: the edges padded (zero information) until
        their blocks tile the mesh."""
        cfg = self.cfg
        poses, ei, ej, means, infos, free = self.device_graph()
        E = ei.shape[0]
        pad = -(-max(E, 1) // self.mesh.size) * self.mesh.size - E
        mask = torch.arange(E + pad, device=self.device) < E
        ei, ej = (torch.nn.functional.pad(t, (0, pad)) for t in (ei, ej))
        means = torch.cat([means, means.new_zeros((pad, 3))])
        infos = torch.cat([infos, infos.new_zeros((pad, 3, 3))])
        out = mesh_lm(
            self.mesh, poses, ei, ej, means, infos, mask, free,
            cfg.initial_lambda, iters=iters, use_dense=use_dense,
            cg_iters=cfg.cg_iterations, cg_tol=cfg.cg_tolerance,
            cg_restarts=max(cfg.cg_restarts, 1),
            sq_min_delta=_sq_min_delta(cfg.convergence_delta))
        return PendingSolve(self, out)

    def _compute_host_f64(self, iters: int) -> "PendingSolve":
        """The host f64 arm: its result packed as a float64 (8, M) tensor on
        the CPU, so that the harvest does not round it to float32."""
        ei, ej, means, infos = self._edge_arrays()
        free = np.ones(self.num_nodes, bool)
        free[0] = False  # node 0 is the gauge (nFixed=1)
        p, cost0, cost, good, it = _host_direct_lm(
            np.asarray(self._poses), ei, ej, means, infos, free, iters,
            self.cfg.initial_lambda, float(self.cfg.convergence_delta))
        return PendingSolve(self, pack(torch.from_numpy(p.T.copy()), cost0,
                                       cost, good, it))

    def _schur_partition(self, M: int):
        """The bucketed Schur partition of the graph over ``M`` nodes,
        cached by a blake2b digest of its edges (a ``hash()`` collision
        would reuse a wrong partition)."""
        ei, ej, _m, _i = self._edge_arrays()
        hk = hashlib.blake2b(digest_size=16)
        hk.update(ei.tobytes())
        hk.update(ej.tobytes())
        key = (M, self.cfg.schur_submaps, hk.digest())
        part = _SCHUR_PART_CACHE.get(key)
        if part is None:
            part = bucket_partition(build_partition(
                ei, ej, np.ones(len(ei), bool), M, self.cfg.schur_submaps))
            if len(_SCHUR_PART_CACHE) > 64:
                _SCHUR_PART_CACHE.clear()
            _SCHUR_PART_CACHE[key] = part
        return part

    def _schur_lm(self, iters: int, dtype, step_of, sq_min_delta, lam_type):
        """The LM with a Schur step, as the reference's LM program runs it:
        the graph padded to its power-of-two node bucket (pad nodes fixed,
        so they are gauge rows), on the solver's device in ``dtype``;
        ``step_of(part, graph, p, lam)`` is the step. Returns the packed
        result."""
        n = self.num_nodes
        M = _bucket(max(n, 2))
        part = self._schur_partition(M)
        ei, ej, means, infos = self._edge_arrays()
        dev = self.device
        poses = np.zeros((M, 3))
        poses[:n] = np.asarray(self._poses)
        free = torch.zeros(M, dtype=torch.bool, device=dev)
        free[1:n] = True  # node 0 is the gauge (nFixed=1)
        typed = dict(dtype=dtype, device=dev)
        graph = (torch.as_tensor(ei, device=dev),
                 torch.as_tensor(ej, device=dev),
                 torch.as_tensor(means, **typed),
                 torch.as_tensor(infos, **typed),
                 torch.ones(len(ei), dtype=torch.bool, device=dev), free)
        p, cost0, cost, good, it = lm_loop(
            torch.as_tensor(poses, **typed),
            lambda p: graph_cost(p, *graph[:4]),
            lambda p, lam: step_of(part, graph, p, lam), wrap_headings,
            self.cfg.initial_lambda, iters, sq_min_delta, lam_type)
        return pack(p.T, cost0, cost, good, it)

    def _compute_schur(self, iters: int) -> "PendingSolve":
        """The float32 LM whose step is the Schur solve (``use_schur``)."""

        def step(part, graph, p, lam):
            ei, ej, means, infos, mask, free = graph
            return schur_delta(part, p, ei, ej, means, infos, mask, lam, free)

        return PendingSolve(self, self._schur_lm(
            iters, torch.float32, step,
            _sq_min_delta(self.cfg.convergence_delta), np.float32))

    def _compute_f64_schur(self, iters: int) -> "PendingSolve":
        """The float64 LM on the solver's device whose step is the direct
        Schur solve (``host_direct_fallback=False``): λ floored at
        ``F64_SCHUR_LAMBDA_FLOOR`` in the step, as the reference's caller
        floors it, and ‖δ‖² stopped at ``convergence_delta`` itself. Its
        packed result is float64."""

        def step(part, graph, p, lam):
            ei, ej, means, infos, mask, free = graph
            return mixed_schur_delta(part, p, ei, ej, means, infos, mask,
                                     max(lam, F64_SCHUR_LAMBDA_FLOOR), free)

        return PendingSolve(self, self._schur_lm(
            iters, torch.float64, step, float(self.cfg.convergence_delta),
            np.float64))

    def _band_spec(self):
        """RCM band spec of the graph, None if it does not band."""
        ei, ej, _m, _i = self._edge_arrays()
        key = (banded.spec_cache_key(ei, ej, np.ones(len(ei), bool),
                                     self.num_nodes),
               self.cfg.direct_max_bandwidth)
        if key not in _SPEC_CACHE:
            if len(_SPEC_CACHE) > 64:
                _SPEC_CACHE.clear()
            _SPEC_CACHE[key] = banded.prepare_banded(
                ei, ej, self.num_nodes, self.cfg.direct_max_bandwidth)
        return _SPEC_CACHE[key]

    def direct_inputs(self, spec=None):
        """The cyclic-reduction route's inputs: the RCM band spec (host),
        then the (NBANKS·W·SLOT_ROWS, W·K) slot array and the (8, W·K) pose
        array built by index ops on the device."""
        spec = spec if spec is not None else self._band_spec()
        if spec is None:
            raise ValueError("the graph does not band under RCM")
        ei, ej, means, infos = self._edge_arrays()
        dev = self.device
        E = len(ei)
        vals = np.zeros((10, E), np.float32)
        vals[0:3] = means.T
        vals[3:9] = infos[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
        vals[9] = spec.edge_flip
        rowbase = (spec.edge_bank * spec.W + spec.edge_d - 1) * banded.SLOT_ROWS
        rows = torch.as_tensor(
            rowbase[None, :] + np.arange(10)[:, None], device=dev)
        lanes = torch.as_tensor(spec.edge_lane, dtype=torch.int64,
                                device=dev).expand(10, E)
        slots = torch.zeros(
            (banded.NBANKS * spec.W * banded.SLOT_ROWS, spec.flat_size),
            dtype=torch.float32, device=dev)
        slots.index_put_((rows, lanes), torch.as_tensor(vals, device=dev),
                         accumulate=True)
        poses = torch.as_tensor(np.asarray(self._poses), dtype=torch.float32,
                                device=dev)
        src = torch.as_tensor(spec.pose_src, dtype=torch.int64, device=dev)
        valid = torch.as_tensor(spec.pose_valid, device=dev)
        pT8 = torch.zeros((8, spec.flat_size), dtype=torch.float32, device=dev)
        pT8[0:3] = poses[src].T * valid
        pT8[3] = torch.as_tensor(spec.free_flat, device=dev)
        return spec, pT8, slots

    def _compute_direct(self, iters: int, spec) -> "PendingSolve":
        """The CR-LM: the single-launch kernel up to ``K_MAX`` supernodes,
        the streamed pipeline above (the reference's split, kept so that
        both can be timed on the same graphs)."""
        spec, pT8, slots = self.direct_inputs(spec)
        solve = fused_cr_lm if spec.K <= K_MAX else streamed_cr_lm
        out = solve(
            pT8, slots, self.cfg.initial_lambda, W=spec.W, K=spec.K,
            iters=iters,
            sq_min_delta=_sq_min_delta(self.cfg.convergence_delta))
        return PendingSolve(self, out, lanes=spec.flat_of_orig)

    def _compute_pcg(self, iters: int) -> "PendingSolve":
        cfg = self.cfg
        poses, ei, ej, means, infos, free = self.device_graph()
        out = fused_lm_solve(
            poses, ei, ej, means, infos, torch.ones_like(ei, dtype=torch.bool),
            free, cfg.initial_lambda, iters=iters, cg_iters=cfg.cg_iterations,
            cg_tol=cfg.cg_tolerance,
            sq_min_delta=_sq_min_delta(cfg.convergence_delta),
            cg_restarts=max(cfg.cg_restarts, 1),
        )
        return PendingSolve(self, out[5])


class PendingSolve:
    """Handle to a dispatched solve. Its packed (8, L) result holds the
    poses in rows 0..2, node k at lane ``lanes[k]`` (lane k when None), and
    (cost0, cost, good, iters) in row 3; ``harvest`` fetches it in ONE
    device→host copy and writes the poses back, node 0 (the gauge)
    excepted. A mesh solve has run to its end on the host's schedule when
    it returns, so ``ready()`` is True on every rank alike (an event's
    state could differ between ranks and part their control flow)."""

    def __init__(self, solver: PoseGraphSolver, packed: torch.Tensor,
                 lanes: np.ndarray | None = None):
        self._solver = solver
        self._packed = packed
        self._lanes = lanes
        self.n_nodes = solver.num_nodes  # the nodes in this solve
        self._stats: SolveStats | None = None
        self._event = None
        if packed.is_cuda and solver.mesh is None:
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        """True once the result can be harvested without blocking."""
        return (self._stats is not None or self._event is None
                or self._event.query())

    def harvest(self) -> SolveStats:
        if self._stats is not None:
            return self._stats
        raw = self._packed.double().cpu().numpy()
        out = raw[0:3].T if self._lanes is None else raw[0:3, self._lanes].T
        for k in range(1, self.n_nodes):
            self._solver._poses[k] = out[k]
        # SolveStats reports the GOOD iterations, like doSPA's return value
        self._stats = SolveStats(
            int(raw[3, 2]), float(raw[3, 0]), float(raw[3, 1]))
        return self._stats
