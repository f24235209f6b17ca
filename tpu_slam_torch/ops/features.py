"""LIO-SAM-style corner features (lesson 1) — port of
``tpu_slam/ops/features.py``.

  * invalid beams dropped → a stable masked reorder (static shape);
  * curvature = (Σ of the ±5 neighbours − 10·r)² over the valid-only
    sequence;
  * 6 sectors, in each the ≤ 20 beams of highest curvature above 1.0.
Selections are made in the compacted order and scattered back to the
original beam indices. Batched over leading axes.
"""

from __future__ import annotations

import torch

from tpu_slam_torch.config import FeatureConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.preprocess import compact_order


def curvature_compacted(ranges: torch.Tensor, valid: torch.Tensor,
                        half_window: int = 5):
    """Curvature over the valid-compacted beam sequence: (curvature (..., N)
    in compacted order, order (..., N), count). The first and last
    ``half_window`` valid beams, and the invalid tail, get 0."""
    n = ranges.shape[-1]
    order, count = compact_order(valid)
    idx = torch.arange(n, device=ranges.device)
    r = torch.take_along_dim(ranges, order, dim=-1)
    r = torch.where(idx < count[..., None], r, 0.0)
    # the kernel [1]*hw + [-2*hw] + [1]*hw as a zero-padded correlation,
    # summed tap by tap in float32 (a library convolution may run in TF32
    # on the card, which moves curvatures across the threshold)
    pad = torch.nn.functional.pad(r, (half_window, half_window))
    diff = torch.zeros_like(r)
    for k in range(2 * half_window + 1):
        tap = r * (-2.0 * half_window) if k == half_window else pad[..., k:k + n]
        diff = diff + tap
    interior = (idx >= half_window) & (idx < count[..., None] - half_window)
    return torch.where(interior, diff * diff, 0.0), order, count


def extract_corner_features(scan: Scan, cfg: FeatureConfig) -> torch.Tensor:
    """A bool mask (..., N) of the corner beams, over the original beams:
    the compacted scan is split into ``num_sectors`` index ranges and in
    each the ``max_per_sector`` beams of highest curvature above the
    threshold are kept (the lower index first among equal curvatures)."""
    n = scan.num_beams
    curv, order, count = curvature_compacted(scan.ranges, scan.valid,
                                             cfg.half_window)
    idx = torch.arange(n, device=curv.device)
    eligible = curv > cfg.curvature_threshold
    cnt = count[..., None]
    selected = torch.zeros(curv.shape, dtype=torch.bool, device=curv.device)
    neg_inf = torch.tensor(-float("inf"), dtype=curv.dtype,
                           device=curv.device)
    k = min(cfg.max_per_sector, n)
    for s in range(cfg.num_sectors):
        # sector s holds [cnt·s // S, cnt·(s+1) // S − 1], skipped when
        # start ≥ end
        start = cnt * s // cfg.num_sectors
        end = cnt * (s + 1) // cfg.num_sectors - 1
        member = (idx >= start) & (idx <= end) & (start < end)
        score = torch.where(eligible & member, curv, neg_inf)
        # a stable descending sort: equal scores keep their index order,
        # as jax.lax.top_k does
        top_v, top_i = torch.sort(score, dim=-1, descending=True, stable=True)
        top_v, top_i = top_v[..., :k], top_i[..., :k]
        selected |= torch.zeros_like(selected).scatter(
            -1, top_i, top_v > neg_inf)
    # selected is in compacted order: back to the original beam indices
    mask = torch.zeros_like(selected).scatter(-1, order, selected)
    return mask & scan.valid


def feature_scan(scan: Scan, cfg: FeatureConfig) -> Scan:
    """The republished sparse corner scan: the same scan with its validity
    restricted to the corner beams."""
    return scan.replace(valid=extract_corner_features(scan, cfg))
