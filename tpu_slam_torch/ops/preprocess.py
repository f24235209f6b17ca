"""Scan preprocessing — port of ``tpu_slam/ops/preprocess.py``.

Validity filtering and point-cloud conversion as masked fixed-shape math:
no compaction, no dynamic sizes.
"""

from __future__ import annotations

import torch

from tpu_slam_torch.data.scan import Scan


def scan_to_pointcloud(scan: Scan, invalid_value: float = float("nan")
                       ) -> torch.Tensor:
    """Scan(s) as (..., N, 3) xyz clouds; invalid beams get
    ``invalid_value`` (NaN), z is always 0 for 2D scans."""
    xy = torch.where(scan.valid[..., None], scan.points(),
                     torch.tensor(invalid_value, dtype=scan.ranges.dtype,
                                  device=scan.device))
    return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def masked_points(scan: Scan) -> tuple[torch.Tensor, torch.Tensor]:
    """(points (..., N, 2), valid (..., N)) with invalid points zeroed: the
    matchers' input format."""
    return torch.where(scan.valid[..., None], scan.points(), 0.0), scan.valid


def compact_order(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable order that brings valid beams to the front (static shape):
    ``order[j]`` is the original index of the j-th valid beam, ``count``
    the number of valid beams."""
    n = valid.shape[-1]
    key = torch.where(valid, 0, 1) * n + torch.arange(n, device=valid.device)
    return torch.argsort(key, dim=-1), valid.sum(dim=-1)
