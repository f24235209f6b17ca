"""The pose graph's Levenberg-Marquardt solve as SPA2d's ``doSPA`` runs it
(spa2d.cpp:425-609), each step a sparse direct solve in float64: the
reference optimum of a graph, and χ² of any poses on it.

Residual of an edge (i, j, z, Ω): r_xy = R(θi)ᵀ(t_j − t_i) − z_xy,
r_θ = wrap(θj − θi − zθ); χ² = Σ rᵀΩr. Node 0 is held (the gauge). The
damping is the diagonal × (1 + λ) plus 1e-12; an accepted step halves λ,
a rejected one multiplies it by a factor that doubles each time; the loop
stops once ‖δ‖² < ``sq_min_delta``.

``rounding`` (for the control) is applied to the poses, residuals and
normal equations of each step, as a solve in a lower precision would
round them; the sparse factor itself is float64 in either case.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from slam_bench import geometry as g


def bf16(a):
    """Round a float64 array to bfloat16 and back (the control's rounding)."""
    import torch

    return torch.as_tensor(np.asarray(a, np.float64)).to(
        torch.bfloat16).double().numpy()


def residuals(p, ei, ej, means):
    r = g.relative(p[ei], p[ej]) - means
    r[:, 2] = g.wrap(r[:, 2])
    return r


def chi2(p, ei, ej, means, infos) -> float:
    r = residuals(np.asarray(p, np.float64), ei, ej, means)
    return float(np.einsum("ei,eij,ej->", r, infos, r))


def _pattern(ei, ej, M):
    """COO rows and columns of the four 3×3 blocks of each edge over the
    free nodes (node 0 dropped), and the mask of the kept entries."""
    r3 = np.arange(3)
    rows, cols, keep = [], [], []
    for a, b in ((ei, ei), (ej, ej), (ei, ej), (ej, ei)):
        ok = (a > 0) & (b > 0)
        rr = 3 * (a - 1)[:, None, None] + r3[None, :, None]
        cc = 3 * (b - 1)[:, None, None] + r3[None, None, :]
        rows.append(np.broadcast_to(rr, (len(a), 3, 3)))
        cols.append(np.broadcast_to(cc, (len(a), 3, 3)))
        keep.append(np.broadcast_to(ok[:, None, None], (len(a), 3, 3)))
    keep = np.concatenate([k.ravel() for k in keep])
    return (np.concatenate([r.ravel() for r in rows])[keep],
            np.concatenate([c.ravel() for c in cols])[keep], keep)


def solve(init, ei, ej, means, infos, iters: int = 100, lam0: float = 1e-4,
          sq_min_delta: float = 1e-16, rounding=None) -> dict:
    """LM from ``init``: the poses, their χ² and the iterations run."""
    rnd = rounding or (lambda a: a)
    p = rnd(np.asarray(init, np.float64).copy())
    means = rnd(np.asarray(means, np.float64))
    infos = rnd(np.asarray(infos, np.float64))
    M = len(p)
    rows, cols, keep = _pattern(ei, ej, M)
    n = 3 * (M - 1)
    lam, laminc = lam0, 2.0
    c = chi2(p, ei, ej, means, infos)
    it = 0
    for _ in range(iters):
        it += 1
        r = rnd(residuals(p, ei, ej, means))
        ci, si = np.cos(p[ei, 2]), np.sin(p[ei, 2])
        dx, dy = p[ej, 0] - p[ei, 0], p[ej, 1] - p[ei, 1]
        E = len(ei)
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0] = np.stack([-ci, -si, -si * dx + ci * dy], -1)
        Ji[:, 1] = np.stack([si, -ci, -ci * dx - si * dy], -1)
        Ji[:, 2, 2] = -1.0
        Jj[:, 0, :2] = np.stack([ci, si], -1)
        Jj[:, 1, :2] = np.stack([-si, ci], -1)
        Jj[:, 2, 2] = 1.0
        JiW = np.einsum("eba,ebc->eac", Ji, infos)
        JjW = np.einsum("eba,ebc->eac", Jj, infos)
        Hij = np.einsum("eab,ebc->eac", JiW, Jj)
        blocks = np.concatenate([
            np.einsum("eab,ebc->eac", JiW, Ji).ravel(),
            np.einsum("eab,ebc->eac", JjW, Jj).ravel(),
            Hij.ravel(), np.swapaxes(Hij, 1, 2).ravel()])
        H = sp.coo_matrix((rnd(blocks[keep]), (rows, cols)),
                          shape=(n, n)).tocsc()
        grad = np.zeros((M, 3))
        np.add.at(grad, ei, np.einsum("eab,eb->ea", JiW, r))
        np.add.at(grad, ej, np.einsum("eab,eb->ea", JjW, r))
        Hd = H + sp.diags(H.diagonal() * lam + 1e-12)
        step = spla.spsolve(Hd.tocsc(), -rnd(grad[1:]).ravel())
        if not np.all(np.isfinite(step)):
            step = np.zeros(n)
        cand = p.copy()
        cand[1:] += step.reshape(-1, 3)
        cand[:, 2] = g.wrap(cand[:, 2])
        cand = rnd(cand)
        cn = chi2(cand, ei, ej, means, infos)
        if float(step @ step) < sq_min_delta:
            break
        if cn < c:
            p, c = cand, cn
            lam *= 0.5
        else:
            lam *= laminc
            laminc *= 2.0
    return {"poses": p, "chi2": c, "iterations": it}
