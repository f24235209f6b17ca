"""The doSPA LM solve with an inner block-Jacobi preconditioned CG — port
of ``tpu_slam/solver/pallas_lm.py::fused_lm_solve``.

This is the route of the graphs that do not band under RCM, below
``f64_schur_above`` nodes: among them the offline mission's loop-closed
graphs, whose loops braid the laps together. The LM schedule is doSPA's;
each step runs ``cg_iters`` PCG iterations on H δ = −b, stopping once
‖r‖² ≤ cg_tol·‖b‖², with the damped 3×3 diagonal blocks inverted as the
preconditioner. With ``cg_restarts`` > 1 it runs that many such runs,
each from the true residual of the last one's solution and a fresh
Krylov space (the reference's restarted CG, ``cg_solve(restarts=)``).

On ``cuda`` ``fused_lm_solve`` launches ``csrc/pcg_lm.cu`` as one
thread-block cluster, the nodes cut into ranges a block each
(``launch_geometry``), with the CG hot set in the blocks' shared memory
where a range's fits and in device memory otherwise; a launch the card
refuses raises. On ``cpu`` it
runs ``pcg_lm_plain``, the plain PyTorch version below (the reference's
XLA CG program, on the normal equations of ``solver/lm.py``). Both write
the CG steps they ran, summed over the LM iterations and the restarts,
into row 4, lane 0 of the packed result.

Inside a caller's open stage (``utils/profiling``) the launch's host
preparation records ``pose_graph.pack`` (the endpoints read back, the
incidence lists, the cluster geometry) and ``pose_graph.upload`` (the
argument tensors), so that the caller's ``pose_graph.dispatch`` holds
the enqueue alone.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch._build import (
    MAX_CLUSTER,
    SMEM_PER_BLOCK,
    SMEM_STATIC_RESERVE,
)
from tpu_slam_torch.solver.lm import (
    damped,
    graph_cost,
    lm_loop,
    norm_angle,
    normal_equations,
    omega,
    pack,
)
from tpu_slam_torch.utils.profiling import span


# the kernel's threads per block (pcg_lm.cu) and the fewest nodes a block
# takes
MAX_THREADS = 512
MIN_NODES_PER_BLOCK = 256


def scratch_floats(M: int, E: int, blocks: int, S: int) -> int:
    """Float count of the kernel's device scratch (see pcg_lm.cu): the
    device-memory hot set over blocks·S node slots (36 floats each) and
    2E incidences (9 each), then poses, candidate and gradient (9·M) and
    the edge blocks of the assembly (18·E)."""
    return 36 * blocks * S + 18 * E + 9 * M + 18 * E


def hot_set_bytes(S: int, qmax: int) -> int:
    """Bytes of one block's PCG hot set (pcg_lm.cu ``hot_words``): for each
    of its S nodes x, r, z, two p buffers, Ap and the diagonal block and
    its inverse (float4 each, and float2 for the blocks' last entries);
    for each of its at most ``qmax`` incidences H (9 floats) and (edge
    and role, other node); its row pointers (S + 1)."""
    return 4 * (37 * S + 11 * qmax + 1)


def launch_geometry(row_ptr: np.ndarray) -> tuple[int, int, int, int]:
    """(blocks, log2 S, qmax, shared bytes) of the kernel's one cluster for
    a graph with CSR ``row_ptr`` (M + 1,): nodes cut into ranges of
    S = 2^logS ≥ MIN_NODES_PER_BLOCK, at most MAX_CLUSTER of them, one a
    block; qmax the most incidences a range holds; the shared bytes of its
    hot set where that fits a block, else 0 (the device-memory variant)."""
    M = len(row_ptr) - 1
    S = MIN_NODES_PER_BLOCK
    while S * MAX_CLUSTER < M:
        S *= 2
    blocks = -(-M // S)
    ends = np.minimum(np.arange(blocks + 1) * S, M)
    qmax = int(np.diff(row_ptr[ends]).max())
    need = hot_set_bytes(S, qmax)
    smem = need if need <= SMEM_PER_BLOCK - SMEM_STATIC_RESERVE else 0
    return blocks, S.bit_length() - 1, qmax, smem


def _incidence(ei: np.ndarray, ej: np.ndarray, M: int):
    """Node → incident edge lists (CSR): row_ptr (M+1,) and entries
    2·edge + role (role 0: the node is the edge's i, 1: its j), ordered by
    node then edge, so every node sums its edges in a fixed order."""
    E = len(ei)
    nodes = np.concatenate([ei, ej])
    code = np.concatenate([2 * np.arange(E), 2 * np.arange(E) + 1])
    order = np.lexsort((code, nodes))
    row_ptr = np.zeros(M + 1, np.int64)
    np.add.at(row_ptr, nodes + 1, 1)
    return np.cumsum(row_ptr).astype(np.int32), code[order].astype(np.int32)


def fused_lm_solve(poses, ei, ej, means, infos, mask, free_mask, lam0, *,
                   iters: int, cg_iters: int, cg_tol: float,
                   sq_min_delta: float, cg_restarts: int = 1):
    """Whole LM solve. poses (M, 3) f32, ei/ej (E,) int64, means (E, 3),
    infos (E, 3, 3), mask (E,) bool, free_mask (M,) bool. Returns
    (poses (M, 3), cost0, cost, iterations, good, packed): ``packed`` is the
    (8, max(M, 4)) array with the poses in rows 0..2 and (cost0, cost, good,
    iters) in row 3, lanes 0..3, and the number of PCG iterations run,
    every LM iteration's and every restart's, in row 4, lane 0."""
    if cg_restarts < 1:
        raise ValueError(f"cg_restarts must be at least 1, not {cg_restarts}")
    run = pcg_lm_plain if _dispatch.route(poses) == "cpu" else _launch
    packed = run(poses, ei, ej, means, infos, mask, free_mask, lam0,
                 iters=iters, cg_iters=cg_iters, cg_tol=cg_tol,
                 sq_min_delta=sq_min_delta, cg_restarts=cg_restarts)
    M = poses.shape[0]
    return (packed[0:3, :M].T, packed[3, 0], packed[3, 1], packed[3, 3],
            packed[3, 2], packed)


def _w6(infos, mask):
    """(6, E) information upper-triangle rows, zero for masked edges."""
    w6 = torch.stack([infos[:, 0, 0], infos[:, 0, 1], infos[:, 0, 2],
                      infos[:, 1, 1], infos[:, 1, 2], infos[:, 2, 2]])
    return (w6 * mask.to(w6.dtype)).contiguous()


def _launch(poses, ei, ej, means, infos, mask, free_mask, lam0, *, iters,
            cg_iters, cg_tol, sq_min_delta, cg_restarts=1):
    dev = poses.device
    M, E = poses.shape[0], ei.shape[0]
    if M < 1 or E < 1:
        raise ValueError("the PCG-LM kernel needs at least one node and edge")
    for name, t in (("poses", poses), ("means", means), ("infos", infos)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 on {dev}")
    if not (ei.shape == ej.shape == (E,) and means.shape == (E, 3)
            and free_mask.shape == (M,)):
        raise ValueError("edge and node arrays disagree in shape")
    with span("pose_graph.pack"):
        ei_h = ei.cpu().numpy()
        ej_h = ej.cpu().numpy()
        if (ei_h.min() < 0 or ej_h.min() < 0
                or max(ei_h.max(), ej_h.max()) >= M):
            raise ValueError("edge endpoint out of range")
        row_ptr, inc = _incidence(ei_h, ej_h, M)
        # each incidence beside the edge's other node, and each edge end's
        # incidence (where the kernel stores the edge's block for that end)
        other = np.where(inc & 1, ei_h[inc >> 1], ej_h[inc >> 1])
        pos = np.empty(2 * E, np.int32)
        pos[inc] = np.arange(2 * E, dtype=np.int32)
        inc = np.stack([inc, other.astype(np.int32)], axis=1)
        blocks, logS, qmax, smem = launch_geometry(row_ptr)
    with span("pose_graph.upload"):
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        args = [
            poses.T.contiguous(), torch.as_tensor(ei_h, **i32),
            torch.as_tensor(ej_h, **i32), means.T.contiguous(),
            _w6(infos, mask), free_mask.to(**f32).contiguous(),
            torch.as_tensor(row_ptr, **i32), torch.as_tensor(inc, **i32),
            torch.as_tensor(pos, **i32),
        ]
        L = max(M, 4)  # the stats lanes of the packed result
        out = torch.empty((8, L), **f32)
        scratch = torch.empty(scratch_floats(M, E, blocks, 1 << logS), **f32)
    _build.launch(
        "pcg_lm", *(a.data_ptr() for a in args), out.data_ptr(), L,
        scratch.data_ptr(), float(lam0), M, E, iters, cg_iters, float(cg_tol),
        float(sq_min_delta), blocks, logS, qmax, smem, int(cg_restarts),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("pcg_lm")
    return out


# --- plain version -----------------------------------------------------------


def _inv3_cofactor(D):
    """Symmetric 3×3 inverse by cofactors, determinant guarded at 1e-30
    (the reference's preconditioner)."""
    d00, d01, d02 = D[:, 0, 0], D[:, 0, 1], D[:, 0, 2]
    d11, d12, d22 = D[:, 1, 1], D[:, 1, 2], D[:, 2, 2]
    c00 = d11 * d22 - d12 * d12
    c01 = d02 * d12 - d01 * d22
    c02 = d01 * d12 - d02 * d11
    det = d00 * c00 + d01 * c01 + d02 * c02
    inv_det = 1.0 / torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    c11 = d00 * d22 - d02 * d02
    c12 = d02 * d01 - d00 * d12
    c22 = d00 * d11 - d01 * d01
    return torch.stack([torch.stack([c00, c01, c02], -1),
                        torch.stack([c01, c11, c12], -1),
                        torch.stack([c02, c12, c22], -1)], -2) * inv_det[:, None, None]


def _pcg(Hd, Hij, b, ei, ej, fm, lam, cg_iters, cg_tol, restarts=1):
    """Block-Jacobi PCG for H δ = −b with the damped, gauge-fixed diagonal
    blocks: the (M, 3) delta and the CG iterations run. ``restarts`` runs
    of at most ``cg_iters`` iterations, each after the first from the true
    residual of the solution so far and a fresh Krylov space, all against
    the first run's stopping threshold (``cg_solve(restarts=)``)."""
    eye3 = torch.eye(3, dtype=Hd.dtype, device=Hd.device)
    fm3 = fm[:, None, None]
    D = damped(Hd, lam) * fm3 + (1.0 - fm3) * eye3
    Minv = _inv3_cofactor(D)
    fmc = fm[:, None]

    def mv(x):
        x = x * fmc
        y = (D @ x[..., None])[..., 0]
        y = y.index_add(0, ei, (Hij @ x[ej][..., None])[..., 0])
        y = y.index_add(0, ej, (Hij.mT @ x[ei][..., None])[..., 0])
        return y * fmc + x * (1.0 - fmc)

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    bb = -b * fmc
    stop2 = cg_tol * torch.sum(bb * bb)
    x = torch.zeros_like(bb)
    steps = 0
    for run in range(restarts):
        r = bb - mv(x) if run else bb  # x = 0 on the first run
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            if not bool(torch.sum(r * r) > stop2):
                break  # r no longer changes: every later step is frozen
            Ap = mv(p)
            pAp = torch.sum(p * Ap)
            alpha = rz / torch.where(pAp != 0.0, pAp, torch.ones_like(pAp))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.where(rz != 0.0, rz, torch.ones_like(rz))
            p = z + beta * p
            rz = rz_new
            steps += 1
    return x, steps


def pcg_lm_plain(poses, ei, ej, means, infos, mask, free_mask, lam0, *,
                 iters, cg_iters, cg_tol, sq_min_delta, cg_restarts=1):
    """Plain PyTorch version of the PCG-LM kernel, with the arguments of
    ``fused_lm_solve``; returns the packed (8, max(M, 4)) array."""
    M = poses.shape[0]
    om = omega(_w6(infos, mask))  # masked edges carry zero information
    fm = free_mask.to(poses.dtype)
    cg_total = 0

    def step(P, lam):
        nonlocal cg_total
        Hd, Hij, b = normal_equations(P, ei, ej, means, om, M)
        delta, steps = _pcg(Hd, Hij, b, ei, ej, fm, lam, cg_iters, cg_tol,
                            cg_restarts)
        cg_total += steps
        return delta

    def wrap(cand):
        return torch.cat([cand[:, :2], norm_angle(cand[:, 2:])], dim=1)

    P, cost0, cost, good, it = lm_loop(
        poses, lambda P: graph_cost(P, ei, ej, means, om), step, wrap, lam0,
        iters, sq_min_delta)
    packed = pack(P.T, cost0, cost, good, it)
    packed[4, 0] = cg_total
    return packed
