"""Frame-to-frame PL-ICP matcher node (lesson 3's first stage) — port of
``tpu_slam/models/scan_match_plicp.py``.

Each scan is matched against the previous one (no keyframes, no
prediction) with ``ops/plicp.plicp_match`` on the model's device (on
``cuda``: ``cfg.plicp.max_iterations`` launches of the NN kernel per
scan); the deltas are read back once per scan and accumulated on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.plicp import plicp_match


class ScanMatchPLICP:
    def __init__(self, cfg: SLAMConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._prev = None
        self.pose = np.zeros(3)
        self.last_delta = np.zeros(3)

    def step(self, scan: Scan) -> np.ndarray:
        """Returns the frame-to-frame delta (x, y, yaw) of this scan."""
        return self._step(scan.points().to(self.device),
                          scan.valid.to(self.device))

    def _step(self, pts: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        if self._prev is None:
            self._prev = (pts, valid)
            return np.zeros(3)
        delta = plicp_match(pts, valid, *self._prev, self.cfg.plicp).pose.cpu()
        self.last_delta = delta.numpy().astype(np.float64)
        pose = torch.as_tensor(self.pose, dtype=torch.float32)
        self.pose = geo.compose(pose, delta).numpy().astype(np.float64)
        self._prev = (pts, valid)
        return self.last_delta

    def run(self, scans: Scan) -> np.ndarray:
        """Replay a (T, N) scan batch; returns the trajectory (T, 3)."""
        pts = scans.points().to(self.device)
        valid = scans.valid.to(self.device)
        out = np.zeros((pts.shape[0], 3))
        for t in range(pts.shape[0]):
            self._step(pts[t], valid[t])
            out[t] = self.pose
        return out
