"""Hector SLAM: multi-resolution scan-to-map GN matching and log-odds
mapping — port of ``tpu_slam/models/hector_slam.py``.

  step(scan):
    1. coarse-to-fine GN match against the map pyramid, one launch of the
       ``hector_fused`` kernel on the card (``ops/cuda/hector_fused``);
    2. if the pose moved more than (0.4 m, 0.13 rad) since the last map
       update: update every level (``ops/gridmap``, plain PyTorch).

Each level is a flat log-odds tensor on the model's device. ``step`` reads
the matched pose and H back to the host once per scan (one transfer): the
map-update gate is host control flow, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import GridConfig, SLAMConfig
from tpu_slam_torch.data.scan import Scan, index_scan
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops.cuda.hector_fused import hector_match_fused
from tpu_slam_torch.ops.hector import sampling_covariance, world_pose_to_map


def build_pyramid_cfgs(cfg: SLAMConfig) -> list[GridConfig]:
    """Level i: resolution ×2^i, cell count /2^i, the same world footprint;
    the origin puts the start at (map_start_x, map_start_y) of the map."""
    h = cfg.hector
    out = []
    res = h.map_resolution
    size = h.map_size
    origin_x = -size * res * h.map_start_x
    origin_y = -size * res * h.map_start_y
    for _ in range(h.map_multi_res_levels):
        out.append(GridConfig(resolution=res, size_x=size, size_y=size,
                              origin_x=origin_x, origin_y=origin_y))
        res *= 2.0
        size //= 2
    return out


def _beams(scan: Scan):
    """(points with non-finite or invalid beams at 0, valid & finite)."""
    p = scan.points()
    finite = torch.isfinite(p)
    pts = torch.where(scan.valid[..., None] & finite, p, 0.0)
    return pts, scan.valid & finite.all(dim=-1)


class HectorSLAM:
    def __init__(self, cfg: SLAMConfig, device=DEFAULT_DEVICE, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the row-stripe-sharded Hector map over a mesh is not ported "
                "yet (ROADMAP queue 1, item 11: multi-device layer)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid_cfgs = build_pyramid_cfgs(cfg)
        self.locfg = dataclasses.replace(
            cfg.logodds,
            p_free=cfg.hector.update_factor_free,
            p_occupied=cfg.hector.update_factor_occupied,
        )
        self.grids = [
            torch.zeros(g.size_y * g.size_x, dtype=torch.float32,
                        device=self.device)
            for g in self.grid_cfgs
        ]
        self.last_pose = torch.zeros(3, dtype=torch.float32,
                                     device=self.device)
        self._last_map_update_pose = None
        self.last_cov = np.zeros((3, 3))

    def _match(self, pose, pts, valid):
        probs = tuple(gm.occupancy_prob(g).view(c.size_y, c.size_x)
                      for g, c in zip(self.grids, self.grid_cfgs))
        return hector_match_fused(probs, tuple(self.grid_cfgs),
                                  self.cfg.hector, pose, pts, valid)

    def _update(self, pose, pts, valid):
        wp = geo.apply(pose, pts)
        self.grids = [
            gm.logodds_update_scan(g, gc, self.locfg, pose[:2], wp, valid,
                                   max_range=self.cfg.scan.range_max)
            for g, gc in zip(self.grids, self.grid_cfgs)
        ]

    def _moved_enough(self, pose: np.ndarray) -> bool:
        """poseDifferenceLargerThan, the map-update gate."""
        if self._last_map_update_pose is None:
            return True
        d = pose - self._last_map_update_pose
        h = self.cfg.hector
        ang = abs(float(np.arctan2(np.sin(d[2]), np.cos(d[2]))))
        return (np.hypot(d[0], d[1]) > h.map_update_distance_thresh
                or ang > h.map_update_angle_thresh)

    def update_only(self, scan: Scan, pose) -> None:
        """Map update at a given pose, no matching (the map-only node)."""
        pts, _ = _beams(scan)
        pose = torch.as_tensor(np.asarray(pose, np.float32),
                               device=self.device)
        self._update(pose, pts, scan.valid)
        self._last_map_update_pose = pose.cpu().numpy()
        self.last_pose = pose

    def step(self, scan: Scan, map_without_matching: bool = False
             ) -> np.ndarray:
        """One scan: match (unless mapping only or the map is empty), then
        the gated map update. Returns the pose as float32 numpy."""
        pts, valid = _beams(scan)
        if map_without_matching or self._last_map_update_pose is None:
            new_pose = self.last_pose
            pose_np = new_pose.cpu().numpy()
        else:
            new_pose, H = self._match(self.last_pose, pts, valid)
            # the one host read of the scan: pose and H together
            host = torch.cat([new_pose, H.reshape(-1)]).cpu().numpy()
            pose_np = host[:3].copy()
            self.last_cov = host[3:].reshape(3, 3)
        if self._moved_enough(pose_np):
            self._update(new_pose, pts, valid)
            self._last_map_update_pose = pose_np
        self.last_pose = new_pose
        return pose_np

    def sampling_covariance(self, scan: Scan, level: int = 0) -> np.ndarray:
        """Sampling-based covariance of ``last_pose`` at a pyramid level,
        in world units (meters on the translation rows and columns)."""
        gc = self.grid_cfgs[level]
        pts, valid = _beams(scan)
        cov_map = sampling_covariance(
            gm.occupancy_prob(self.grids[level]), gc.size_x, gc.size_y,
            world_pose_to_map(gc, self.last_pose), pts / gc.resolution,
            valid,
        )
        s = np.array([gc.resolution, gc.resolution, 1.0])
        return cov_map.cpu().numpy() * np.outer(s, s)

    def run(self, scans: Scan) -> np.ndarray:
        T = scans.ranges.shape[0]
        out = np.zeros((T, 3))
        for t in range(T):
            out[t] = self.step(index_scan(scans, t))
        return out

    def to_ros_map(self, level: int = 0) -> np.ndarray:
        """int8 occupancy map of a pyramid level."""
        g = self.grid_cfgs[level]
        return gm.logodds_to_ros(
            self.grids[level], self.cfg.logodds.obstacle_threshold,
        ).cpu().numpy().reshape(g.size_y, g.size_x)
