"""The doSPA LM solve of a banded pose graph with an exact block
cyclic-reduction step — port of ``tpu_slam/solver/pallas_cr_lm.py``.

``fused_cr_lm`` keeps the reference's contract: ``pT8`` (8, W·K) holds the
poses in the offset-major flat layout (lane f = a·K + k for chain position
p = k·W + a, rows 0..2) and the free mask (row 3); ``slots``
(NBANKS·W·SLOT_ROWS, W·K) holds each edge's mean, information upper
triangle and role flip at its low node's lane (``tpu_slam.solver.banded``).
The result is the packed (8, W·K) array: solved poses in rows 0..2 and
(cost0, cost, good, iters) in row 3, lanes 0..3.

On ``cuda`` it launches ``csrc/cr_lm.cu`` as one thread-block cluster
(``launch_geometry``); a launch the card refuses raises. On ``cpu`` it runs
``cr_lm_plain``, the plain PyTorch version below, which mirrors
``banded.assemble_supernodes``, ``banded.cr_solve`` and the kernel's LM
loop, vectorized over supernodes.
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
from tpu_slam_torch.solver.banded import NBANKS, SLOT_ROWS
from tpu_slam_torch.solver.lm import lm_loop, norm_angle, omega, pack

# the routing split kept from the reference (cr_lm_applicable)
K_MAX = 512
STAGE_ROWS = 12  # kernel staging rows per slot: 9 H entries + 3 b entries
# the kernel's warps per block (cr_lm.cu)
MAX_WARPS = 8  # 256 threads: up to 255 registers a thread


def scratch_floats(W: int, K: int) -> int:
    """Float count of the kernel's device scratch (see cr_lm.cu): P, C
    (3·W·K each), D, B, X1, X2 (n²·K each), r, Xr, x (n·K each) and the
    high-node staging rows."""
    n, WK = 3 * W, W * K
    return 6 * WK + 4 * n * n * K + 3 * n * K + NBANKS * W * STAGE_ROWS * WK


def warp_smem_bytes(W: int) -> int:
    """Shared memory of one warp's slice (cr_lm.cu ``warp_floats``): the
    survivor's five staged n × n operand blocks and two vectors, the most
    of a warp's three uses."""
    n = 3 * W
    return 4 * (5 * n * n + 2 * n)


def launch_geometry(W: int, K: int) -> tuple[int, int, int]:
    """(blocks, warps per block, dynamic shared bytes per block) of the
    kernel's one cluster: a warp for each of a level's K/2 eliminations,
    spread over up to MAX_CLUSTER SMs of at most MAX_WARPS warps (so at
    K = 256 a warp takes two of the first level's, at K = 512 four), and
    no more warps a block than their slices fit in shared memory."""
    need = K // 2
    per_warp = warp_smem_bytes(W)
    cap = min(MAX_WARPS, (SMEM_PER_BLOCK - SMEM_STATIC_RESERVE) // per_warp)
    blocks = min(MAX_CLUSTER, -(-need // cap))
    warps = min(cap, -(-need // blocks))
    return blocks, warps, warps * per_warp


def check_packed(pT8: torch.Tensor, slots: torch.Tensor, W: int,
                 K: int) -> None:
    """Raise unless ``pT8`` and ``slots`` are contiguous float32 tensors of
    the packed contract's shapes on one device."""
    WK = W * K
    for name, t, shape in (("pT8", pT8, (8, WK)),
                           ("slots", slots, (NBANKS * W * SLOT_ROWS, WK))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != pT8.device or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 {shape} "
                             f"on {pT8.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def check_launch(W: int, K: int) -> None:
    """Raise unless the kernel takes a band of ``W`` nodes and ``K``
    supernodes: the route's limits."""
    if not (1 <= W <= 8 and 32 <= K <= K_MAX and K & (K - 1) == 0):
        raise ValueError(f"CR-LM kernel takes W in 1..8 and K a power of "
                         f"two in 32..{K_MAX}, got W={W}, K={K}")


def fused_cr_lm(pT8: torch.Tensor, slots: torch.Tensor, lam0: float, *,
                W: int, K: int, iters: int,
                sq_min_delta: float) -> torch.Tensor:
    """Run the whole LM solve; returns the packed (8, W·K) result."""
    if _dispatch.route(pT8) == "cpu":
        return cr_lm_plain(pT8, slots, lam0, W=W, K=K, iters=iters,
                           sq_min_delta=sq_min_delta)
    dev = pT8.device
    WK = W * K
    check_launch(W, K)
    check_packed(pT8, slots, W, K)
    out = torch.empty((8, WK), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(W, K), dtype=torch.float32,
                          device=dev)
    blocks, warps, smem = launch_geometry(W, K)
    _build.launch(
        "cr_lm", pT8.data_ptr(), slots.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), float(lam0), W, K, iters, float(sq_min_delta),
        blocks, warps, smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("cr_lm")
    return out


# --- plain version -----------------------------------------------------------


def _hi_lanes(W: int, K: int, d: int, device):
    """Flat lane of chain position p + d for every flat lane, and whether
    it exists."""
    f = torch.arange(W * K, device=device)
    a2 = f // K + d
    k2 = f % K + a2 // W
    ok = k2 < K
    return torch.where(ok, (a2 % W) * K + k2, torch.zeros_like(f)), ok


def _edge_terms(P, slots, bank, d, W, K):
    """Per-lane terms of the edges in slot (bank, d), zero where empty."""
    base = (bank * W + d - 1) * SLOT_ROWS
    m = slots[base:base + 3]
    w6 = slots[base + 3:base + 9]
    flip = slots[base + 9] > 0.5
    hi_idx, hi_ok = _hi_lanes(W, K, d, P.device)
    live = hi_ok & (w6 != 0).any(dim=0)
    w6 = torch.where(live, w6, torch.zeros_like(w6))
    hi = P[:, hi_idx]
    pa = torch.where(flip, hi, P)
    pb = torch.where(flip, P, hi)
    c, s = torch.cos(pa[2]), torch.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    r = torch.stack([
        c * dx + s * dy - m[0],
        -s * dx + c * dy - m[1],
        norm_angle(pb[2] - pa[2] - m[2]),
    ])
    return w6, flip, c, s, -s * dx + c * dy, -c * dx - s * dy, r


def _cost(P, slots, W, K):
    acc = torch.zeros((), dtype=P.dtype, device=P.device)
    for bank in range(NBANKS):
        for d in range(1, W + 1):
            w, _f, _c, _s, _x, _y, r = _edge_terms(P, slots, bank, d, W, K)
            acc = acc + torch.sum(
                w[0] * r[0] * r[0] + 2 * w[1] * r[0] * r[1]
                + 2 * w[2] * r[0] * r[2] + w[3] * r[1] * r[1]
                + 2 * w[4] * r[1] * r[2] + w[5] * r[2] * r[2]
            )
    return acc


def _assemble(P, slots, free, lam, W, K):
    """D (K,n,n), B (K,n,n), r (K,n) at poses P, damped and gauge-fixed."""
    n = 3 * W
    dt, dev = P.dtype, P.device
    D = torch.zeros((K, n, n), dtype=dt, device=dev)
    B = torch.zeros((K, n, n), dtype=dt, device=dev)
    b = torch.zeros((K, n), dtype=dt, device=dev)
    for bank in range(NBANKS):
        for d in range(1, W + 1):
            w6, flip, c, s, drx, dry, r = _edge_terms(P, slots, bank, d, W, K)
            z, o = torch.zeros_like(c), torch.ones_like(c)
            Ja = torch.stack([torch.stack([-c, -s, drx], -1),
                              torch.stack([s, -c, dry], -1),
                              torch.stack([z, z, -o], -1)], -2)
            Jb = torch.stack([torch.stack([c, s, z], -1),
                              torch.stack([-s, c, z], -1),
                              torch.stack([z, z, o], -1)], -2)
            f3 = flip[:, None, None]
            JL = torch.where(f3, Jb, Ja)
            JH = torch.where(f3, Ja, Jb)
            Om = omega(w6)
            LW, HW = JL.mT @ Om, JH.mT @ Om
            HLL, HLH, HHH = LW @ JL, LW @ JH, HW @ JH
            bL = (LW @ r.T[:, :, None])[..., 0]
            bH = (HW @ r.T[:, :, None])[..., 0]
            for a in range(W):
                lanes = slice(a * K, (a + 1) * K)
                sa = slice(3 * a, 3 * a + 3)
                D[:, sa, sa] += HLL[lanes]
                b[:, sa] += bL[lanes]
                bo = a + d
                if bo < W:
                    so = slice(3 * bo, 3 * bo + 3)
                    D[:, sa, so] += HLH[lanes]
                    D[:, so, sa] += HLH[lanes].mT
                else:
                    so = slice(3 * (bo - W), 3 * (bo - W) + 3)
                    B[:, sa, so] += HLH[lanes]
                # the high node: node bo % W of supernode k + bo // W
                sh = slice(3 * (bo % W), 3 * (bo % W) + 3)
                if bo < W:
                    D[:, sh, sh] += HHH[lanes]
                    b[:, sh] += bH[lanes]
                else:
                    D[1:, sh, sh] += HHH[lanes][:-1]
                    b[1:, sh] += bH[lanes][:-1]
    idx = torch.arange(n, device=dev)
    D[:, idx, idx] = (D[:, idx, idx] + 1e-12) * float(np.float32(1.0) + lam)
    fm = free.view(W, K).T.repeat_interleave(3, dim=1)  # (K, n)
    fmn = torch.roll(fm, -1, dims=0)  # next supernode's mask
    D = D * fm[:, :, None] * fm[:, None, :]
    D[:, idx, idx] += 1.0 - fm
    B = B * fm[:, :, None] * fmn[:, None, :]
    return D, B, -b * fm


def _chol_solve(Dm, rhs):
    L = torch.linalg.cholesky_ex(Dm)[0]
    return torch.cholesky_solve(rhs, L)


def cr_solve(D, B, r):
    """Solve the block-tridiagonal system (diag D_k, super-diagonal B_k) by
    block cyclic reduction, in ``banded.cr_solve``'s order. Returns (K, n)."""
    K, n, _ = D.shape
    D, B, r = D.clone(), B.clone(), r.clone()
    X1, X2, Xr = torch.zeros_like(D), torch.zeros_like(D), torch.zeros_like(r)
    h = 1
    while h < K:
        odd = torch.arange(h, K, 2 * h, device=D.device)
        e = odd - h
        X = _chol_solve(D[odd], torch.cat([B[e].mT, B[odd], r[odd, :, None]], -1))
        X1[odd], X2[odd], Xr[odd] = X[..., :n], X[..., n:2 * n], X[..., 2 * n]
        has_r = odd + h < K
        og = odd[has_r]
        g = og + h
        D[g] -= B[og].mT @ X2[og]
        r[g] -= (B[og].mT @ Xr[og][..., None])[..., 0]
        Be = B[e]
        D[e] -= Be @ X1[odd]
        r[e] -= (Be @ Xr[odd][..., None])[..., 0]
        B[e] = torch.where(has_r[:, None, None], -(Be @ X2[odd]),
                           torch.zeros_like(Be))
        h *= 2
    x = torch.zeros_like(r)
    x[0] = _chol_solve(D[0], r[0][:, None])[:, 0]
    while h > 1:
        h //= 2
        odd = torch.arange(h, K, 2 * h, device=D.device)
        xg = torch.zeros_like(x[odd])
        has_r = odd + h < K
        xg[has_r] = x[odd[has_r] + h]
        x[odd] = (Xr[odd] - (X1[odd] @ x[odd - h][..., None])[..., 0]
                  - (X2[odd] @ xg[..., None])[..., 0])
    return x


def cr_lm_plain(pT8: torch.Tensor, slots: torch.Tensor, lam0: float, *,
                W: int, K: int, iters: int,
                sq_min_delta: float) -> torch.Tensor:
    """Plain PyTorch version of the CR-LM kernel (same packed contract)."""
    free = pT8[3]

    def step(P, lam):
        x = cr_solve(*_assemble(P, slots, free, lam, W, K))
        return x.view(K, W, 3).permute(2, 1, 0).reshape(3, W * K) * free

    def wrap(cand):
        return torch.cat([cand[0:2], norm_angle(cand[2:3])])

    return pack(*lm_loop(pT8[0:3], lambda P: _cost(P, slots, W, K), step,
                         wrap, lam0, iters, sq_min_delta))
