"""Banded/supernode preparation for the direct cyclic-reduction solver —
the port's own copy of ``tpu_slam/solver/banded.py`` (numpy only; the
port's device kernel is ``csrc/cr_lm.cu``, its plain version
``solver/cr_lm.py``).

The reference's back-end is a DIRECT sparse Cholesky (`spa2d.cpp:505`
`csp.doChol` -> `csparse.cpp` cs_cholsol): exact at any size. tpu_slam's
TPU-native equivalent factors the SAME normal equations exactly, but maps
them to the hardware differently:

  1. A host-side bandwidth-reducing ordering (reverse Cuthill-McKee, the
     moral analogue of CSparse's AMD fill-reducing ordering) folds SLAM
     pose graphs - chains plus sparse loop closures - into a BLOCK-BANDED
     matrix with small block bandwidth W (measured: W=6 for the classic
     ring benchmark at every size 1024..16384, W=4 for real karto mission
     graphs).
  2. W consecutive nodes form one supernode -> the system is block
     TRIDIAGONAL in (3W x 3W) supernode blocks with zero fill outside.
  3. The factorization runs as block CYCLIC REDUCTION (odd-even
     elimination): log2(K) levels, each eliminating every second active
     supernode. This is exactly Cholesky under a nested-dissection
     ordering - same arithmetic class as CSparse's elimination, but every
     level is data-parallel across supernodes, which maps onto the VPU
     lanes (supernodes-in-lanes layout) instead of a scalar CPU loop.

This module is the HOST side: ordering, supernode layout, slot packing
(device scatter indices), plus a numpy oracle of the masked-CR math used
by the unit tests. The device kernel lives in solver/pallas_cr_lm.py.

Flat node layout ("offset-major"): chain position p = k*W + a is stored
at flat lane f = a*K + k. Band-edge gathers (p -> p+d) then become two
static lane rolls, and supernode block extraction becomes static slices
[a*K:(a+1)*K] - no one-hot matmuls, so the O(M*E) VMEM cap of the fused
CG kernel (solver/pallas_lm.py) does not apply here.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

WMAX = 8  # reject graphs whose RCM bandwidth exceeds this (fall back)
NBANKS = 2  # slot banks: duplicate node-pair constraints (the classic
#             ring benchmark measures BOTH i->j and j->i closures across
#             the circle) get a second slot at the same (lo, d)
SLOT_ROWS = 10  # mean(3) + info upper-triangle(6) + flip(1) per (bank,d)


@dataclasses.dataclass(frozen=True)
class BandedSpec:
    """Static layout + per-graph index arrays for the CR kernel."""

    W: int             # block bandwidth (bucketed: 2/4/6/8)
    K: int             # supernodes (power of two, >= 128)
    n_nodes: int       # active nodes M0
    perm: np.ndarray   # (M0,) chain position p -> original node index
    inv: np.ndarray    # (M0,) original node index -> chain position p
    flat_of_orig: np.ndarray  # (M0,) original node -> flat lane a*K+k
    pose_src: np.ndarray      # (W*K,) flat lane -> original node (or 0)
    pose_valid: np.ndarray    # (W*K,) bool: flat lane holds a real node
    edge_lane: np.ndarray     # (E,) flat lane of the LOW endpoint
    edge_d: np.ndarray        # (E,) band offset 1..W
    edge_bank: np.ndarray     # (E,) slot bank 0..NBANKS-1
    edge_flip: np.ndarray     # (E,) 1.0 if the edge's FROM node is the
    #                           high endpoint (residual role swap)
    free_flat: np.ndarray     # (W*K,) f32: 1 = free, 0 = fixed/padding

    @property
    def flat_size(self) -> int:
        return self.W * self.K


def _bucket_w(w: int) -> int:
    for b in (2, 4, 6, 8):
        if w <= b:
            return b
    return w


def _bucket_k(k: int, min_k: int = 128) -> int:
    b = min_k
    while b < k:
        b *= 2
    return b


def rcm_order(ei, ej, M: int):
    """Reverse Cuthill-McKee ordering. Returns perm (position->node)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ones = np.ones(len(ei))
    A = sp.coo_matrix((ones, (ei, ej)), shape=(M, M))
    A = A + A.T + sp.eye(M)
    perm = np.asarray(
        reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True), np.int64
    )
    return perm


def prepare_banded(ei, ej, n_nodes: int,
                   max_bandwidth: int = WMAX,
                   min_k: int = 128) -> BandedSpec | None:
    """Host prep: ordering, bucketing, slot indices. None if the graph
    does not band (bandwidth too large after RCM, duplicate node-pair
    constraints, or trivial size)."""
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    M = int(n_nodes)
    if M < 8 or len(ei) == 0:
        return None
    if np.any(ei == ej):
        return None  # self-edges don't band; shouldn't occur
    perm = rcm_order(ei, ej, M)
    inv = np.empty(M, np.int64)
    inv[perm] = np.arange(M)
    pi, pj = inv[ei], inv[ej]
    bw = int(np.max(np.abs(pi - pj)))
    if bw == 0 or bw > max_bandwidth:
        return None
    W = _bucket_w(bw)
    K = _bucket_k(-(-M // W), min_k)
    lo = np.minimum(pi, pj)
    hi = np.maximum(pi, pj)
    d = hi - lo
    # slot banks: first edge of a (lo, d) pair -> bank 0, a duplicate
    # constraint on the same node pair -> bank 1; more than NBANKS edges
    # between one pair would need an overflow path - fall back instead
    seen: dict[tuple[int, int], int] = {}
    bank = np.zeros(len(lo), np.int32)
    for e in range(len(lo)):
        key = (int(lo[e]), int(d[e]))
        b = seen.get(key, 0)
        if b >= NBANKS:
            return None
        bank[e] = b
        seen[key] = b + 1
    a = lo % W
    k = lo // W
    edge_lane = (a * K + k).astype(np.int32)
    flip = (pi > pj).astype(np.float32)

    flat = np.arange(W * K, dtype=np.int64)
    aa, kk = flat // K, flat % K
    p = kk * W + aa
    valid = p < M
    pose_src = np.where(valid, perm[np.minimum(p, M - 1)], 0)
    free = valid.astype(np.float32)
    # gauge: original node 0 fixed (nFixed=1, spa_solver.cc)
    p0 = inv[0]
    free[(p0 % W) * K + (p0 // W)] = 0.0
    pos = inv  # original o at chain position inv[o]
    flat_of_orig = (pos % W) * K + (pos // W)

    return BandedSpec(
        W=W, K=K, n_nodes=M, perm=perm, inv=inv,
        flat_of_orig=flat_of_orig.astype(np.int64),
        pose_src=pose_src.astype(np.int32),
        pose_valid=valid,
        edge_lane=edge_lane, edge_d=d.astype(np.int32),
        edge_bank=bank, edge_flip=flip,
        free_flat=free.astype(np.float32),
    )


def spec_cache_key(ei, ej, mask, n_nodes: int) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(ei, np.int32).tobytes())
    h.update(np.asarray(ej, np.int32).tobytes())
    h.update(np.asarray(mask, bool).tobytes())
    h.update(int(n_nodes).to_bytes(8, "little"))
    return h.digest()


def build_slots_np(spec: BandedSpec, means, infos):
    """(NBANKS*W*SLOT_ROWS, W*K) dense slot rows - numpy mirror of the
    device prelude scatter (tests; the solver scatters on device)."""
    W, K = spec.W, spec.K
    out = np.zeros((NBANKS * W * SLOT_ROWS, W * K), np.float32)
    for e in range(len(spec.edge_lane)):
        base = (int(spec.edge_bank[e]) * W + int(spec.edge_d[e]) - 1)
        base *= SLOT_ROWS
        f = int(spec.edge_lane[e])
        Om = infos[e]
        out[base + 0:base + 3, f] = means[e]
        out[base + 3, f] = Om[0, 0]
        out[base + 4, f] = Om[0, 1]
        out[base + 5, f] = Om[0, 2]
        out[base + 6, f] = Om[1, 1]
        out[base + 7, f] = Om[1, 2]
        out[base + 8, f] = Om[2, 2]
        out[base + 9, f] = spec.edge_flip[e]
    return out


def flat_poses_np(spec: BandedSpec, poses):
    """(8, W*K): rows 0..2 = posesT in flat layout, row 3 = free mask."""
    W, K = spec.W, spec.K
    out = np.zeros((8, W * K), np.float32)
    src = poses[spec.pose_src].T.astype(np.float32)  # (3, WK)
    out[0:3] = src * spec.pose_valid[None, :]
    out[3] = spec.free_flat
    return out


def unflatten_poses_np(spec: BandedSpec, packed):
    """Inverse of flat_poses_np on the kernel's packed output row 0..2."""
    return np.asarray(packed, np.float64)[0:3, spec.flat_of_orig].T


# --- numpy oracle of the masked cyclic-reduction solve ----------------------
# Mirrors the kernel's elimination order and masking exactly (vectorized
# over supernode lanes) so the Pallas kernel can be golden-tested against
# it, and it against scipy.


def assemble_supernodes(spec: BandedSpec, poses, means, infos, lam,
                        dtype=np.float32):
    """Build D (K,n,n), B (K,n,n), rhs (K,n) from the graph at `poses`
    (original node order), damped + gauge-fixed. n = 3W."""
    W, K = spec.W, spec.K
    n = 3 * W
    D = np.zeros((K, n, n), dtype)
    B = np.zeros((K, n, n), dtype)
    rhs = np.zeros((K, n), dtype)
    free = spec.free_flat
    # per-edge blocks (f32, same formulas as pose_graph.normal_equations)
    E = len(spec.edge_lane)
    for e in range(E):
        f = spec.edge_lane[e]
        d = int(spec.edge_d[e])
        a, k = f // K, f % K
        p_lo = k * W + a
        p_hi = p_lo + d
        o_lo = spec.perm[p_lo]
        o_hi = spec.perm[p_hi]
        flip = spec.edge_flip[e] > 0.5
        oa, ob = (o_hi, o_lo) if flip else (o_lo, o_hi)
        pa = poses[oa].astype(dtype)
        pb = poses[ob].astype(dtype)
        c, s = np.cos(pa[2]), np.sin(pa[2])
        dx, dy = pb[0] - pa[0], pb[1] - pa[1]
        r0 = c * dx + s * dy - means[e][0]
        r1 = -s * dx + c * dy - means[e][1]
        rt = pb[2] - pa[2] - means[e][2]
        r2 = np.arctan2(np.sin(rt), np.cos(rt))
        drx = -s * dx + c * dy
        dry = -c * dx - s * dy
        Ja = np.array([[-c, -s, drx], [s, -c, dry], [0, 0, -1]], dtype)
        Jb = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype)
        JL, JH = (Jb, Ja) if flip else (Ja, Jb)
        Om = infos[e].astype(dtype)
        r = np.array([r0, r1, r2], dtype)
        HLL = JL.T @ Om @ JL
        HHH = JH.T @ Om @ JH
        HLH = JL.T @ Om @ JH
        bL = JL.T @ Om @ r
        bH = JH.T @ Om @ r
        # scatter into supernode blocks
        b_off = a + d
        if b_off < W:  # intra-supernode
            D[k, 3*a:3*a+3, 3*b_off:3*b_off+3] += HLH
            D[k, 3*b_off:3*b_off+3, 3*a:3*a+3] += HLH.T
            D[k, 3*b_off:3*b_off+3, 3*b_off:3*b_off+3] += HHH
            rhs[k, 3*b_off:3*b_off+3] += bH
        else:  # crossing into supernode k+1
            b2 = b_off - W
            B[k, 3*a:3*a+3, 3*b2:3*b2+3] += HLH
            D[k+1, 3*b2:3*b2+3, 3*b2:3*b2+3] += HHH
            rhs[k+1, 3*b2:3*b2+3] += bH
        D[k, 3*a:3*a+3, 3*a:3*a+3] += HLL
        rhs[k, 3*a:3*a+3] += bL
    # damping + jitter (finalize_dense_solve semantics)
    for q in range(K):
        for a in range(W):
            blk = slice(3*a, 3*a+3)
            D[q][blk, blk] += 1e-12 * np.eye(3, dtype=dtype)
            for u in range(3):
                D[q, 3*a+u, 3*a+u] *= dtype(1.0) + dtype(lam)
    # gauge / padding: zero rows+cols of non-free nodes, identity diag
    fm = np.zeros((K, n), dtype)
    for f in range(W * K):
        a, k = f // K, f % K
        fm[k, 3*a:3*a+3] = free[f]
    D = D * fm[:, :, None] * fm[:, None, :]
    fmn = np.roll(fm, -1, axis=0)  # next supernode's rows
    B = B * fm[:, :, None] * fmn[:, None, :]
    idx = np.arange(n)
    D[:, idx, idx] += (1.0 - fm)
    rhs = -rhs * fm
    return D, B, rhs


def cr_solve(D, B, rhs, dtype=np.float32):
    """Masked block cyclic reduction: solve the block-tridiagonal SPD
    system (diag D_k, super-diag B_k = block(k,k+1)) for all K supernodes.
    Mirrors the kernel: levels h = 1,2,..,K/2 eliminate supernodes with
    k mod 2h == h; X matrices stored per eliminated node; then top solve
    + descending back-substitution."""
    D = D.astype(dtype).copy()
    B = B.astype(dtype).copy()
    r = rhs.astype(dtype).copy()
    K, n, _ = D.shape
    X1s = np.zeros_like(D)   # D_o^-1 B_{o-h}^T
    X2s = np.zeros_like(D)   # D_o^-1 B_o
    Xrs = np.zeros_like(r)   # D_o^-1 r_o
    h = 1
    while h < K:
        odd = np.arange(h, K, 2 * h)
        for o in odd:
            L = np.linalg.cholesky(D[o])
            Li = np.linalg.inv(L).astype(dtype)
            Dinv = (Li.T @ Li).astype(dtype)
            e = o - h
            Bp = B[e]            # block(e, o)
            X1 = (Dinv @ Bp.T).astype(dtype)
            X2 = (Dinv @ B[o]).astype(dtype)
            Xr = (Dinv @ r[o]).astype(dtype)
            X1s[o], X2s[o], Xrs[o] = X1, X2, Xr
            D[e] = (D[e] - Bp @ X1).astype(dtype)
            r[e] = (r[e] - Bp @ Xr).astype(dtype)
            if o + h < K:
                D[o + h] = (D[o + h] - B[o].T @ X2).astype(dtype)
                r[o + h] = (r[o + h] - B[o].T @ Xr).astype(dtype)
                B[e] = (-(Bp @ X2)).astype(dtype)
            else:
                B[e] = np.zeros_like(B[e])
        h *= 2
    x = np.zeros_like(r)
    x[0] = np.linalg.solve(D[0].astype(np.float64), r[0]).astype(dtype)
    while h > 1:
        h //= 2
        odd = np.arange(h, K, 2 * h)
        for o in odd:
            xe = x[o - h]
            xg = x[o + h] if o + h < K else np.zeros(n, dtype)
            x[o] = (Xrs[o] - X1s[o] @ xe - X2s[o] @ xg).astype(dtype)
    return x


def flat_delta(spec: BandedSpec, x):
    """(K, 3W) supernode solution -> per-original-node (M0, 3) delta."""
    W, K, M = spec.W, spec.K, spec.n_nodes
    out = np.zeros((M, 3), x.dtype)
    for p in range(M):
        k, a = p // W, p % W
        out[spec.perm[p]] = x[k, 3*a:3*a+3]
    return out
