"""The doSPA LM solve with an inner block-Jacobi preconditioned CG — port
of ``tpu_slam/solver/pallas_lm.py::fused_lm_solve``.

This is the route of the graphs that do not band under RCM, below
``f64_schur_above`` nodes: among them the offline mission's loop-closed
graphs, whose loops braid the laps together. The LM schedule is doSPA's;
each step runs ``cg_iters`` PCG iterations on H δ = −b, stopping once
‖r‖² ≤ cg_tol·‖b‖², with the damped 3×3 diagonal blocks inverted as the
preconditioner.

On ``cuda`` ``fused_lm_solve`` launches ``csrc/pcg_lm.cu``; on ``cpu`` it
runs ``pcg_lm_plain``, the plain PyTorch version below (the reference's
XLA CG program, on the normal equations of ``solver/lm.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.solver.lm import (
    graph_cost,
    lm_loop,
    norm_angle,
    normal_equations,
    omega,
    pack,
)


def scratch_floats(M: int, E: int) -> int:
    """Float count of the kernel's device scratch (see pcg_lm.cu)."""
    return 36 * M + 33 * E


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
                   sq_min_delta: float):
    """Whole LM solve. poses (M, 3) f32, ei/ej (E,) int64, means (E, 3),
    infos (E, 3, 3), mask (E,) bool, free_mask (M,) bool. Returns
    (poses (M, 3), cost0, cost, iterations, good, packed): ``packed`` is the
    (8, max(M, 4)) array with the poses in rows 0..2 and (cost0, cost, good,
    iters) in row 3, lanes 0..3. The kernel also puts the number of PCG
    iterations it ran in row 4, lane 0 (0 from the plain version)."""
    run = pcg_lm_plain if _dispatch.route(poses) == "cpu" else _launch
    packed = run(poses, ei, ej, means, infos, mask, free_mask, lam0,
                 iters=iters, cg_iters=cg_iters, cg_tol=cg_tol,
                 sq_min_delta=sq_min_delta)
    M = poses.shape[0]
    return (packed[0:3, :M].T, packed[3, 0], packed[3, 1], packed[3, 3],
            packed[3, 2], packed)


def _w6(infos, mask):
    """(6, E) information upper-triangle rows, zero for masked edges."""
    w6 = torch.stack([infos[:, 0, 0], infos[:, 0, 1], infos[:, 0, 2],
                      infos[:, 1, 1], infos[:, 1, 2], infos[:, 2, 2]])
    return (w6 * mask.to(w6.dtype)).contiguous()


def _launch(poses, ei, ej, means, infos, mask, free_mask, lam0, *, iters,
            cg_iters, cg_tol, sq_min_delta):
    dev = poses.device
    W6 = _w6(infos, mask)
    M, E = poses.shape[0], ei.shape[0]
    if M < 1 or E < 1:
        raise ValueError("the PCG-LM kernel needs at least one node and edge")
    for name, t in (("poses", poses), ("means", means), ("W6", W6)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 on {dev}")
    if not (ei.shape == ej.shape == (E,) and means.shape == (E, 3)
            and free_mask.shape == (M,)):
        raise ValueError("edge and node arrays disagree in shape")
    ei_h = ei.cpu().numpy()
    ej_h = ej.cpu().numpy()
    if ei_h.min() < 0 or ej_h.min() < 0 or max(ei_h.max(), ej_h.max()) >= M:
        raise ValueError("edge endpoint out of range")
    row_ptr, inc = _incidence(ei_h, ej_h, M)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [
        poses.T.contiguous(), torch.as_tensor(ei_h, **i32),
        torch.as_tensor(ej_h, **i32), means.T.contiguous(), W6,
        free_mask.to(**f32).contiguous(), torch.as_tensor(row_ptr, **i32),
        torch.as_tensor(inc, **i32),
    ]
    L = max(M, 4)  # the stats lanes of the packed result
    out = torch.empty((8, L), **f32)
    scratch = torch.empty(scratch_floats(M, E), **f32)
    _build.launch(
        "pcg_lm", *(a.data_ptr() for a in args), out.data_ptr(), L,
        scratch.data_ptr(), float(lam0), M, E, iters, cg_iters, float(cg_tol),
        float(sq_min_delta), torch.cuda.current_stream(dev).cuda_stream,
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


def _pcg(Hd, Hij, b, ei, ej, fm, lam, cg_iters, cg_tol):
    """Block-Jacobi PCG for H δ = −b with the damped, gauge-fixed diagonal
    blocks; (M, 3) delta."""
    eye3 = torch.eye(3, dtype=Hd.dtype, device=Hd.device)
    one_lam = float(np.float32(1.0) + lam)
    fm3 = fm[:, None, None]
    D = (Hd + 1e-12 * eye3) * torch.where(eye3 > 0, one_lam, 1.0)
    D = D * fm3 + (1.0 - fm3) * eye3
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
    r = bb
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        if not bool(torch.sum(r * r) > stop2):
            break  # r no longer changes: every later iteration is frozen
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
    return x


def pcg_lm_plain(poses, ei, ej, means, infos, mask, free_mask, lam0, *,
                 iters, cg_iters, cg_tol, sq_min_delta):
    """Plain PyTorch version of the PCG-LM kernel, with the arguments of
    ``fused_lm_solve``; returns the packed (8, max(M, 4)) array."""
    M = poses.shape[0]
    om = omega(_w6(infos, mask))  # masked edges carry zero information
    fm = free_mask.to(poses.dtype)

    def step(P, lam):
        Hd, Hij, b = normal_equations(P, ei, ej, means, om, M)
        return _pcg(Hd, Hij, b, ei, ej, fm, lam, cg_iters, cg_tol)

    def wrap(cand):
        return torch.cat([cand[:, :2], norm_angle(cand[:, 2:])], dim=1)

    P, cost0, cost, good, it = lm_loop(
        poses, lambda P: graph_cost(P, ei, ej, means, om), step, wrap, lam0,
        iters, sq_min_delta)
    return pack(P.T, cost0, cost, good, it)
