"""Frame-to-frame point-to-point ICP odometry (lesson 2's ScanMatchICP) —
port of ``tpu_slam/models/icp_odometry.py``.

Each scan is matched against the previous one with ``ops/icp.icp_match``
on the model's device (on ``cuda``: ``cfg.icp.max_iterations`` launches of
the NN kernel per scan) and the deltas are accumulated on the host in
float32, one device→host read per scan.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.icp import icp_match


class ICPOdometry:
    def __init__(self, cfg: SLAMConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._prev = None
        self.pose = torch.zeros(3, dtype=torch.float32)

    def step(self, scan: Scan) -> np.ndarray:
        """Match one scan against the previous; returns the pose (3,)."""
        return self._step(scan.points().to(self.device),
                          scan.valid.to(self.device))

    def _step(self, pts: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        if self._prev is not None:
            # the current scan onto the previous (ScanMatchWithICP)
            d, _err, _n = icp_match(pts, valid, *self._prev, self.cfg.icp)
            self.pose = geo.compose(self.pose, d.cpu())
        self._prev = (pts, valid)
        return self.pose.numpy()

    def run(self, scans: Scan) -> np.ndarray:
        """Replay a (T, N) scan batch; returns the trajectory (T, 3)."""
        pts = scans.points().to(self.device)
        valid = scans.valid.to(self.device)
        out = np.zeros((pts.shape[0], 3))
        for t in range(pts.shape[0]):
            out[t] = self._step(pts[t], valid[t])
        return out
