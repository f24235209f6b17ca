"""Scan containers — port of ``tpu_slam/data/scan.py``.

A fixed-shape batch of laser scans: invalid beams are masked, never
dropped, so every scan of a batch has the same ``num_beams``.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_slam_torch import geometry
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import ScanConfig


@dataclasses.dataclass
class Scan:
    """A batch of laser scans; the last axis is the beam axis of size N.

    Attributes:
      ranges: (..., N) measured ranges in meters; invalid beams hold any value.
      valid: (..., N) bool — range_min < r < range_max and finite.
      angles: (..., N) beam angles in the laser frame.
      stamp: (...,) scan start time in seconds.
      time_increment: (...,) seconds between consecutive beams.
    """

    ranges: torch.Tensor
    valid: torch.Tensor
    angles: torch.Tensor
    stamp: torch.Tensor
    time_increment: torch.Tensor

    @property
    def num_beams(self) -> int:
        return self.ranges.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.ranges.device

    def points(self) -> torch.Tensor:
        """Polar→Cartesian endpoints in the laser frame, (..., N, 2).
        Invalid beams produce garbage values that must be gated with
        ``self.valid``."""
        x = self.ranges * torch.cos(self.angles)
        y = self.ranges * torch.sin(self.angles)
        return torch.stack([x, y], dim=-1)

    def beam_times(self) -> torch.Tensor:
        """Per-beam absolute timestamps, (..., N)."""
        idx = torch.arange(self.num_beams, dtype=self.ranges.dtype,
                           device=self.ranges.device)
        return self.stamp[..., None] + self.time_increment[..., None] * idx

    def replace(self, **fields) -> "Scan":
        """A copy with ``fields`` replaced (the reference's struct method)."""
        return dataclasses.replace(self, **fields)


def make_scan(
    ranges,
    cfg: ScanConfig,
    stamp=0.0,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> Scan:
    """Build a Scan (or batch) from raw range arrays + sensor config."""
    ranges = torch.as_tensor(ranges, dtype=dtype, device=device)
    batch_shape = ranges.shape[:-1]
    n = ranges.shape[-1]
    angles = cfg.angle_min + cfg.angle_increment * torch.arange(
        n, dtype=dtype, device=ranges.device
    )
    angles = angles.expand(ranges.shape).contiguous()
    valid = (
        torch.isfinite(ranges)
        & (ranges > cfg.range_min)
        & (ranges < cfg.range_max)
    )
    stamp = torch.as_tensor(stamp, dtype=dtype, device=ranges.device)
    stamp = stamp.expand(batch_shape).contiguous()
    tinc = torch.full(
        batch_shape, cfg.scan_period / max(n, 1), dtype=dtype,
        device=ranges.device,
    )
    return Scan(
        ranges=ranges, valid=valid, angles=angles, stamp=stamp,
        time_increment=tinc,
    )


def world_points(scan: Scan, pose: torch.Tensor) -> torch.Tensor:
    """Scan endpoints in the world frame given sensor pose(s), (..., N, 2);
    ``pose`` (..., 3) broadcasts against the scan batch."""
    return geometry.apply(pose, scan.points())


def stack_scans(scans: list[Scan]) -> Scan:
    """Stack a list of equally-shaped scans into a leading batch axis."""
    return Scan(**{
        f.name: torch.stack([getattr(s, f.name) for s in scans])
        for f in dataclasses.fields(Scan)
    })


def index_scan(batch: Scan, i) -> Scan:
    """Select scan(s) ``i`` from the leading batch axis."""
    return Scan(**{
        f.name: getattr(batch, f.name)[i] for f in dataclasses.fields(Scan)
    })
