"""PL-ICP keyframe laser odometry (lesson 3's odometry node) — port of
``tpu_slam/models/plicp_odometry.py``.

  * constant-velocity motion prediction;
  * laser ↔ base ↔ odom frame bookkeeping;
  * PL-ICP match of each scan against the current keyframe
    (``ops/plicp.plicp_match`` on the model's device; on ``cuda`` each of
    its ``cfg.plicp.max_iterations`` rounds launches the NN kernel);
  * the keyframe policy: rotation > kf_dist_angular, every kf_scan_count
    scans, or translation > kf_dist_linear, tested in that order.

As in the reference, the matcher is the device program and the keyframe
switching and velocity bookkeeping run on the host between scans: here in
float32 on the CPU, with one device→host read of the match (pose and
inlier count together) per scan. Also ``plicp_match_batch``, the batched
matcher for throughput.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.plicp import plicp_match

_F32 = torch.float32


class PLICPOdometry:
    """Sequential odometry over a scan stream.

    base_to_laser: the pose of the laser in the base frame (the reference
    node's TF lookup)."""

    def __init__(self, cfg: SLAMConfig, base_to_laser=(0.0, 0.0, 0.0),
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = torch.device(device)
        self.base_to_laser = torch.tensor(base_to_laser, dtype=_F32)
        self.laser_to_base = geo.inverse(self.base_to_laser)
        self.reset()

    def reset(self):
        self._kf_pts = None  # keyframe scan points (laser frame), on device
        self._kf_valid = None
        self._kf_base_in_odom = torch.zeros(3, dtype=_F32)
        self.base_in_odom = torch.zeros(3, dtype=_F32)
        self._last_base_in_odom = torch.zeros(3, dtype=_F32)
        self._velocity = np.zeros(3)
        self._scan_count = 0
        self._last_stamp = None

    def _new_keyframe_needed(self, d_base: np.ndarray) -> bool:
        """NewKeyframeNeeded in its exact order: the angular test, the
        scan-count test (with its reset), then the linear test."""
        kf = self.cfg.keyframe
        self._scan_count += 1
        if abs(d_base[2]) > kf.kf_dist_angular:
            return True
        if self._scan_count == kf.kf_scan_count:
            self._scan_count = 0
            return True
        if d_base[0] ** 2 + d_base[1] ** 2 > kf.kf_dist_linear**2:
            return True
        return False

    def step(self, scan: Scan) -> np.ndarray:
        """Process one scan; returns the base pose in the odom frame (3,)."""
        return self._step(scan.points().to(self.device),
                          scan.valid.to(self.device), float(scan.stamp))

    def _step(self, pts: torch.Tensor, valid: torch.Tensor,
              stamp: float) -> np.ndarray:
        if self._kf_pts is None:  # the first scan becomes the keyframe
            self._kf_pts, self._kf_valid = pts, valid
            self._last_stamp = stamp
            return self.base_in_odom.numpy()

        dt = max(stamp - self._last_stamp, 1e-6)
        # constant-velocity prediction in the base frame
        pred_change = torch.as_tensor(self._velocity * dt, dtype=_F32)
        predicted_base = geo.compose(self.base_in_odom, pred_change)
        # first guess: keyframe → predicted change, in the laser frame
        d_base_pred = geo.relative(self._kf_base_in_odom, predicted_base)
        guess_l = geo.compose(
            self.laser_to_base, geo.compose(d_base_pred, self.base_to_laser))

        res = plicp_match(pts, valid, self._kf_pts, self._kf_valid,
                          self.cfg.plicp, init_pose=guess_l.to(self.device))
        read = torch.cat([res.pose, res.num_inliers.to(_F32)[None]]).cpu()
        pose = read[:3]
        pose_np = pose.numpy()
        # match-failure fallback: keep the constant-velocity prediction
        # (the reference node publishes the unchanged transform when CSM
        # does not converge). CSM's max_linear_correction and
        # max_angular_correction_deg bound the plausible correction; with
        # an exhaustive NN they gate the final one.
        pcfg = self.cfg.plicp
        within_bounds = float(
            np.hypot(pose_np[0], pose_np[1])
        ) <= pcfg.max_linear_correction and abs(float(pose_np[2])) <= \
            math.radians(pcfg.max_angular_correction_deg)
        match_ok = (int(read[3]) >= 10
                    and bool(np.isfinite(pose_np).all()) and within_bounds)
        d_laser = pose if match_ok else guess_l
        d_base = geo.compose(
            self.base_to_laser, geo.compose(d_laser, self.laser_to_base))
        new_base = geo.compose(self._kf_base_in_odom, d_base)

        # velocity from the realized motion
        step_d = geo.relative(self.base_in_odom, new_base).numpy()
        step_d[2] = np.arctan2(np.sin(step_d[2]), np.cos(step_d[2]))
        self._velocity = step_d / dt

        self._last_base_in_odom = self.base_in_odom
        self.base_in_odom = new_base
        self._last_stamp = stamp

        if self._new_keyframe_needed(d_base.numpy()):
            self._kf_pts, self._kf_valid = pts, valid
            self._kf_base_in_odom = new_base
        return new_base.numpy()

    def run(self, scans: Scan) -> np.ndarray:
        """Replay a (T, N) scan batch; returns the trajectory (T, 3)."""
        pts = scans.points().to(self.device)
        valid = scans.valid.to(self.device)
        stamps = scans.stamp.cpu().numpy()
        out = np.zeros((pts.shape[0], 3))
        for t in range(pts.shape[0]):
            out[t] = self._step(pts[t], valid[t], float(stamps[t]))
        return out


def plicp_match_batch(cfg: SLAMConfig):
    """The batched matcher: (B, N, 2) × (B, N) pairs and (B, 3) first
    guesses → a PLICPResult of B poses. ``plicp_match`` is batched over
    leading axes, so this is the reference's ``vmap`` of it."""

    def f(sp, sv, tp, tv, ip):
        return plicp_match(sp, sv, tp, tv, cfg.plicp, init_pose=ip)

    return f
