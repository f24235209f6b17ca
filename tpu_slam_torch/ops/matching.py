"""Shared correspondence search for the ICP family — port of
``tpu_slam/ops/matching.py``.

Exhaustive masked nearest neighbour with first-argmin ties, in two forms:
- ``nearest_neighbor`` keeps the reference's expanded form
  |a|² + |b|² − 2a·b, its route off the TPU, so the CPU agrees tightly
  with the JAX XLA path;
- ``nearest_neighbor_direct`` is the plain version of the NN kernel
  (``csrc/nn.cu``, the reference's ``ops/pallas/nn.py``): direct
  differences and ``fma(dx, dx, dy·dy)``, bit for bit the kernel's.

``nearest_neighbor_auto`` routes by device: the kernel on ``cuda``, the
expanded form on ``cpu``.
"""

from __future__ import annotations

import math

import torch

from tpu_slam_torch import _dispatch

BIG = 1e12


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) × (..., M, 2) → (..., N, M) squared distances."""
    an = torch.sum(a * a, dim=-1)[..., :, None]
    bn = torch.sum(b * b, dim=-1)[..., None, :]
    cross = (
        a[..., :, None, 0] * b[..., None, :, 0]
        + a[..., :, None, 1] * b[..., None, :, 1]
    )
    return an + bn - 2.0 * cross


def nearest_neighbor(
    src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Index and squared distance of the nearest valid tgt point for each
    src point: src (..., N, 2), tgt (..., M, 2) → ((..., N), (..., N)).
    Invalid targets sit at BIG; ties go to the first index."""
    d2 = pairwise_sqdist(src, tgt)
    d2 = torch.where(tgt_valid[..., None, :], d2, torch.full_like(d2, BIG))
    idx = torch.argmin(d2, dim=-1)
    best = torch.take_along_dim(d2, idx[..., None], dim=-1)[..., 0]
    return idx, best


def _fma_squares(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """fma(dx, dx, dy·dy) in float32, rounded once as a hardware fma
    rounds it. dx² is exact in float64 and dy·dy is the float32 product;
    their float64 sum is rounded to odd (the TwoSum error says whether it
    was inexact, and an even last bit then steps towards the exact sum),
    and a float64 value rounded to odd rounds to float32 as the exact sum
    would. Both terms are ≥ 0."""
    p = dx.double() * dx.double()
    q = (dy * dy).double()
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    bits = s.view(torch.int64)
    step = torch.where((bits & 1) == 0, torch.sign(err).to(torch.int64), 0)
    return (bits + step).view(torch.float64).to(torch.float32)


def nearest_neighbor_direct(
    src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The NN kernel's arithmetic (``ops/pallas/nn.py:31-45`` of the
    reference): d2 = fma(dx, dx, dy·dy) + (1 − valid)·1e12 in float32 with
    dx = sx − tx, dy = sy − ty, and the first index of the minimum.
    src (..., N, 2), tgt (..., M, 2) float32 → (idx (..., N) int64,
    d2 (..., N))."""
    dx = src[..., :, None, 0] - tgt[..., None, :, 0]
    dy = src[..., :, None, 1] - tgt[..., None, :, 1]
    big = torch.tensor(BIG, dtype=torch.float32, device=src.device)
    pen = torch.where(tgt_valid, torch.zeros_like(big), big)
    d2 = _fma_squares(dx, dy) + pen[..., None, :]
    idx = torch.argmin(d2, dim=-1)
    best = torch.take_along_dim(d2, idx[..., None], dim=-1)[..., 0]
    return idx, best


def nearest_neighbor_auto(
    src: torch.Tensor, tgt: torch.Tensor, tgt_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-routed NN (``_dispatch.route``): a tensor on ``cuda`` launches
    the NN kernel (``ops/cuda/nn.py``), one on ``cpu`` takes the expanded
    ``nearest_neighbor``, the reference's own route off its TPU.

    src (..., N, 2) against tgt (..., M, 2): tgt and tgt_valid broadcast
    to src's batch dims, which are flattened into the kernel's pair axis."""
    if _dispatch.route(src) == "cpu":
        return nearest_neighbor(src, tgt, tgt_valid)
    from tpu_slam_torch.ops.cuda.nn import nearest_neighbor_cuda

    batch = src.shape[:-2]
    n, m = src.shape[-2], tgt.shape[-2]
    b = math.prod(batch)
    tgt_b = tgt.expand(batch + (m, 2)).reshape(b, m, 2).contiguous()
    tv_b = tgt_valid.expand(batch + (m,)).reshape(b, m).contiguous()
    idx, d2 = nearest_neighbor_cuda(src.reshape(b, n, 2).contiguous(),
                                    tgt_b, tv_b)
    return idx.reshape(batch + (n,)), d2.reshape(batch + (n,))


def masked_quantile(x: torch.Tensor, mask: torch.Tensor,
                    q: float) -> torch.Tensor:
    """The quantile of x over mask == True per row: the element at
    floor(q·(count−1)) of the sorted masked values (unmasked → BIG)."""
    return masked_quantiles(x, mask, (q,))[0]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, 2) rows at idx (..., N) → (..., N, 2)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def second_point_on_segment(
    idx: torch.Tensor, src_w: torch.Tensor, tgt: torch.Tensor,
    tgt_valid: torch.Tensor,
) -> torch.Tensor:
    """CSM's second correspondence point: the better of the beams j1−1 and
    j1+1 next to the nearest point j1 (clamped at scan ends; invalid
    neighbours lose by distance). Returns indices (..., N)."""
    m = tgt.shape[-2]
    lo = torch.clamp(idx - 1, 0, m - 1)
    hi = torch.clamp(idx + 1, 0, m - 1)

    def d2_at(j):
        q = _take_rows(tgt, j)
        v = torch.take_along_dim(tgt_valid, j, dim=-1)
        d = torch.sum((src_w - q) ** 2, dim=-1)
        return torch.where(v & (j != idx), d, torch.full_like(d, BIG))

    return torch.where(d2_at(lo) <= d2_at(hi), lo, hi)


def masked_quantiles(x: torch.Tensor, mask: torch.Tensor, qs: tuple) -> list:
    """Several masked quantiles from one sort: per row, the element at
    floor(q·(count−1)) of the sorted masked values (unmasked → BIG)."""
    n = x.shape[-1]
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, BIG)), dim=-1).values
    cnt1 = torch.clamp(mask.sum(dim=-1) - 1, min=0).to(torch.float32)
    out = []
    for q in qs:
        # q·(cnt−1) in float32, as the reference (a float64 product rounds
        # e.g. 0.9·10 up to 9 where float32 gives 8.99999)
        pos = torch.floor(torch.tensor(q, dtype=torch.float32) * cnt1)
        pos = torch.clamp(pos.to(torch.int64), 0, n - 1)
        out.append(torch.take_along_dim(xs, pos[..., None], dim=-1)[..., 0])
    return out
