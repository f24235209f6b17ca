"""Shared correspondence search for the ICP family — port of
``tpu_slam/ops/matching.py``.

Exhaustive masked nearest neighbour with first-argmin ties. Squared
distances keep the reference's expanded form |a|² + |b|² − 2a·b, so the
plain version agrees tightly with the JAX XLA path on the CPU.
"""

from __future__ import annotations

import torch

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
