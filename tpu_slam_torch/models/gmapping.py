"""GMapping-style hit/visit-count map builder — port of
``tpu_slam/models/gmapping.py``.

Each scan's beams update hit/visit counters at given poses (no pose
estimation): visits along every ray, a visit and a hit at its endpoint,
occupancy = hits/visits above 0.25. The counters are flat int32 tensors on
the model's device, plus the per-cell sum of the hit positions
(PointAccumulator's ``acc``). A scan's update is queued on the device;
nothing is read back until ``to_ros_map`` or ``cell_means``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan, index_scan
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops.correlative import apply_pose, sincosf


class GMapping:
    def __init__(self, cfg: SLAMConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = torch.device(device)
        n = cfg.grid.size_y * cfg.grid.size_x
        self.hits = torch.zeros(n, dtype=torch.int32, device=self.device)
        self.visits = torch.zeros_like(self.hits)
        # per-cell sum of hit world positions; cell_means() = acc / hits
        self.acc = torch.zeros((n, 2), dtype=torch.float32, device=self.device)

    def add_scan(self, scan: Scan, pose) -> None:
        """Count one scan at ``pose`` (3,) (numpy or a tensor; taken in
        float32). Beams that are invalid or not finite are masked. The
        sines and cosines, the pose transform and the cells round as the
        reference's compiled update rounds them."""
        s, c = sincosf(scan.angles)
        pts = torch.stack([scan.ranges * c, scan.ranges * s], dim=-1)
        valid = scan.valid & torch.isfinite(pts).all(dim=-1)
        pts = torch.where(valid[..., None], pts, 0.0)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        self.hits, self.visits, self.acc = gm.counts_update_scan(
            self.hits, self.visits, self.cfg.grid, pose[:2],
            apply_pose(pose, pts), valid, max_range=self.cfg.scan.range_max,
            acc=self.acc,
        )

    def run(self, scans: Scan, poses) -> None:
        """Count every scan of a batch at its pose; the poses go to the
        device once."""
        poses = torch.as_tensor(np.asarray(poses, np.float32),
                                device=self.device)
        for t in range(scans.ranges.shape[0]):
            self.add_scan(index_scan(scans, t), poses[t])

    def cell_means(self) -> np.ndarray:
        """Per-cell mean hit position (PointAccumulator::mean) as
        (size_y, size_x, 2) world coordinates; 0 where no hits."""
        g = self.cfg.grid
        return gm.counts_mean(self.acc, self.hits).cpu().numpy().reshape(
            g.size_y, g.size_x, 2)

    def to_ros_map(self) -> np.ndarray:
        """int8 map: occupied (100) iff visited and hits/visits above the
        threshold; free (0) iff visited; unknown (-1) otherwise."""
        g = self.cfg.grid
        frac = gm.counts_occupancy(self.hits, self.visits)
        visited = self.visits > 0
        occ = visited & (frac > self.cfg.gmapping.occupancy_threshold)
        out = torch.where(occ, 100, torch.where(visited, 0, -1))
        return out.to(torch.int8).cpu().numpy().reshape(g.size_y, g.size_x)
