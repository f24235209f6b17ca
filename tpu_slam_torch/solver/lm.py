"""What the plain solvers share: the edge residuals, Jacobians, cost and
block normal equations of the pose graph, the dense damped step, the doSPA
Levenberg-Marquardt schedule (spa2d.cpp:425-609), and the packed result
they return.

Residual model (SPA2d's Con2dP2):
    r_xy = R(θi)ᵀ (t_j − t_i) − ẑ_xy
    r_θ  = normalize(θ_j − θ_i − ẑ_θ)
weighted by the information matrix Ω = covariance⁻¹.

λ halves on an accepted step and is multiplied by ``laminc`` on a rejected
one (``laminc`` then doubles); a step is accepted when it lowers the cost;
the loop stops once ‖δ‖² < ``sq_min_delta`` or after ``iters`` steps. λ is
kept in float32, as the kernels keep it (in float64 on a float64 solve).
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = 6.283185307179586
_PI = 3.141592653589793


def norm_angle(th: torch.Tensor) -> torch.Tensor:
    """Branchless wrap to [-π, π), as the kernels do."""
    return th - _TWO_PI * torch.floor((th + _PI) / _TWO_PI)


def omega(w6: torch.Tensor) -> torch.Tensor:
    """(6, L) information upper-triangle rows → (L, 3, 3) matrices."""
    rows = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    return torch.stack(
        [torch.stack([w6[q] for q in row], -1) for row in rows], -2)


def _rot_t(th):
    """R(θ)ᵀ as (..., 2, 2)."""
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def edge_residuals(poses, ei, ej, means):
    """(E, 3) residuals of the relative-pose constraints."""
    pi, pj = poses[ei], poses[ej]
    rxy = (_rot_t(pi[:, 2]) @ (pj[:, :2] - pi[:, :2])[..., None])[..., 0]
    rth = pj[:, 2] - pi[:, 2] - means[:, 2]
    rth = torch.atan2(torch.sin(rth), torch.cos(rth))
    return torch.cat([rxy - means[:, :2], rth[:, None]], dim=-1)


def edge_jacobians(poses, ei, ej):
    """Analytic Jacobians (E, 3, 3) × 2 wrt nodes i and j."""
    pi, pj = poses[ei], poses[ej]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    drx = -s * dx + c * dy
    dry = -c * dx - s * dy
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([torch.stack([-c, -s, drx], -1),
                      torch.stack([s, -c, dry], -1),
                      torch.stack([z, z, -o], -1)], -2)
    Jj = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    return Ji, Jj


def graph_cost(poses, ei, ej, means, infos):
    """Σ rᵀ Ω r over the edges."""
    r = edge_residuals(poses, ei, ej, means)
    return torch.sum(r[:, None, :] @ infos @ r[:, :, None])


def normal_equations(poses, ei, ej, means, infos, n_nodes):
    """Block normal equations: diagonal blocks Hd (M, 3, 3), per-edge
    off-diagonal blocks Hij (E, 3, 3) and gradient b = Jᵀ Ω r (M, 3)."""
    r = edge_residuals(poses, ei, ej, means)
    Ji, Jj = edge_jacobians(poses, ei, ej)
    JiW = Ji.mT @ infos
    JjW = Jj.mT @ infos
    Hd = torch.zeros((n_nodes, 3, 3), dtype=poses.dtype, device=poses.device)
    Hd.index_add_(0, ei, JiW @ Ji)
    Hd.index_add_(0, ej, JjW @ Jj)
    b = torch.zeros((n_nodes, 3), dtype=poses.dtype, device=poses.device)
    b.index_add_(0, ei, (JiW @ r[..., None])[..., 0])
    b.index_add_(0, ej, (JjW @ r[..., None])[..., 0])
    return Hd, JiW @ Jj, b


def assemble_dense(Hd, Hij, ei, ej):
    """Block form → the full (M, 3, M, 3) system, no damping or gauge: the
    form the mesh's dense step sums before the solve."""
    M = Hd.shape[0]
    dev = Hd.device
    H = torch.zeros((M, 3, M, 3), dtype=Hd.dtype, device=dev)
    nodes = torch.arange(M, device=dev)
    H[nodes, :, nodes, :] = Hd
    u = torch.arange(3, device=dev)
    i3, j3 = ei[:, None, None], ej[:, None, None]
    H.index_put_((i3, u[:, None], j3, u), Hij, accumulate=True)
    H.index_put_((j3, u[:, None], i3, u), Hij.mT, accumulate=True)
    return H


def damped(Hd, lam):
    """Diagonal blocks with a 1e-12 jitter, their diagonal × (1+λ)
    (spa2d setupSys)."""
    eye3 = torch.eye(3, dtype=Hd.dtype, device=Hd.device)
    # 1 + λ in the type of the blocks (a bare float here would be float32)
    scale = torch.tensor(1.0 + float(lam), dtype=Hd.dtype, device=Hd.device)
    return (Hd + 1e-12 * eye3) * torch.where(eye3 > 0, scale, 1.0)


def finalize_dense_solve(H, b, lam, free_mask):
    """Damp the assembled system's block diagonal, gauge-fix the non-free
    nodes (identity rows) and solve H δ = −b by Cholesky; (M, 3). A failed
    factorization gives a NaN step, which the LM rejects."""
    M = free_mask.shape[0]
    dt, dev = H.dtype, H.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    nodes = torch.arange(M, device=dev)
    H = H.clone()
    H[nodes, :, nodes, :] = damped(H[nodes, :, nodes, :], lam)
    fm = free_mask.to(dt)
    H = H * fm[:, None, None, None] * fm[None, None, :, None]
    H[nodes, :, nodes, :] += (1.0 - fm)[:, None, None] * eye3
    L, info = torch.linalg.cholesky_ex(H.reshape(3 * M, 3 * M))
    delta = torch.cholesky_solve(-(b * fm[:, None]).reshape(-1, 1), L)
    delta = torch.where(info == 0, delta, torch.full_like(delta, float("nan")))
    return delta.reshape(M, 3)


def dense_solve(Hd, Hij, ei, ej, b, lam, free_mask):
    """The dense LM step: assemble the (3M, 3M) system and solve it."""
    return finalize_dense_solve(assemble_dense(Hd, Hij, ei, ej), b, lam,
                                free_mask)


def wrap_headings(poses):
    """Poses with their headings wrapped by atan2(sin, cos)."""
    return torch.cat([poses[:, :2], torch.atan2(torch.sin(poses[:, 2:]),
                                                torch.cos(poses[:, 2:]))], 1)


def lm_loop(p0, cost_of, step_of, wrap, lam0, iters, sq_min_delta,
            lam_type=np.float32):
    """Run the schedule from poses ``p0``. ``cost_of(p)`` is the graph
    cost, ``step_of(p, lam)`` the damped Gauss-Newton step (lam a
    ``lam_type`` scalar: float32 as the kernels keep it, float64 for a
    float64 solve) and ``wrap(cand)`` the candidate with its headings
    wrapped. Returns (poses, cost0, cost, good, iterations)."""
    p = p0
    cost0 = cost = cost_of(p0)
    lam, laminc = lam_type(lam0), lam_type(2.0)
    good = it = 0
    while it < iters:
        delta = step_of(p, lam)
        converged = bool(torch.sum(delta * delta) < sq_min_delta)
        cand = wrap(p + delta)
        new_cost = cost_of(cand)
        it += 1
        if bool(new_cost < cost) and not converged:
            p, cost = cand, new_cost
            lam = lam * lam_type(0.5)
            good += 1
        else:
            lam = lam * laminc
            laminc = laminc * lam_type(2.0)
        if converged:
            break
    return p, cost0, cost, good, it


def pack(posesT, cost0, cost, good, iters) -> torch.Tensor:
    """The packed (8, max(L, 4)) result in the type of ``posesT``: poses
    (3, L) in rows 0..2, (cost0, cost, good, iters) in row 3, lanes 0..3."""
    L = posesT.shape[1]
    out = torch.zeros((8, max(L, 4)), dtype=posesT.dtype,
                      device=posesT.device)
    out[0:3, :L] = posesT
    out[3, 0] = cost0
    out[3, 1] = cost
    out[3, 2] = good
    out[3, 3] = iters
    return out
