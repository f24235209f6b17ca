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

With a mesh (``parallel/mesh.Mesh``) each level is cut in row stripes,
and each rank keeps only its own (every level's ``size_y`` must divide by
D). The match goes coarse to fine with one sharded GN step a level
(``parallel/sharded_map.make_sharded_hector_step``: a halo row by
ppermute, a psum of H and dTr a step), and the map is updated by the
sharded rasterizer, as in the reference's mesh path; the ``hector_fused``
kernel is not used there. Every rank must step the same scans.
``map_grids()`` gathers the stripes into whole levels.
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
from tpu_slam_torch.ops.hector import (
    map_pose_to_world, sampling_covariance, world_pose_to_map,
)
from tpu_slam_torch.parallel.mesh import all_gather_rows
from tpu_slam_torch.parallel.sharded_map import (
    make_sharded_hector_step, make_sharded_logodds_update, stripe_rows,
)


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
        """The mapper on ``device``; with a ``mesh``, on the mesh's device
        with the pyramid in row stripes over its ranks."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self.grid_cfgs = build_pyramid_cfgs(cfg)
        self.locfg = dataclasses.replace(
            cfg.logodds,
            p_free=cfg.hector.update_factor_free,
            p_occupied=cfg.hector.update_factor_occupied,
        )
        # the rows of each level held here: all, or the rank's stripe
        self._rows = [g.size_y if mesh is None else stripe_rows(mesh, g)
                      for g in self.grid_cfgs]
        self.grids = [
            torch.zeros(r * g.size_x, dtype=torch.float32, device=self.device)
            for r, g in zip(self._rows, self.grid_cfgs)
        ]
        self.last_pose = torch.zeros(3, dtype=torch.float32,
                                     device=self.device)
        self._last_map_update_pose = None
        self.last_cov = np.zeros((3, 3))
        if mesh is not None:
            h, rng = cfg.hector, float(cfg.scan.range_max)
            # 1 + iterations GN steps a level (ScanMatcher.h:73-86)
            self._steps = [
                make_sharded_hector_step(
                    mesh, gc, max_rot_step=h.max_rot_step,
                    n_iters=1 + (h.iterations_fine if lvl == 0
                                 else h.iterations_coarse))
                for lvl, gc in enumerate(self.grid_cfgs)]
            self._updaters = [
                make_sharded_logodds_update(mesh, gc, self.locfg, rng)
                for gc in self.grid_cfgs]

    def _match(self, pose, pts, valid):
        if self.mesh is not None:
            return self._match_sharded(pose, pts, valid)
        probs = tuple(gm.occupancy_prob(g).view(c.size_y, c.size_x)
                      for g, c in zip(self.grids, self.grid_cfgs))
        return hector_match_fused(probs, tuple(self.grid_cfgs),
                                  self.cfg.hector, pose, pts, valid)

    def _match_sharded(self, pose, pts, valid):
        """Coarse to fine, one sharded GN launch a level, the angle wrapped
        after each (``match_level``'s tail)."""
        H = None
        for lvl in range(len(self.grid_cfgs) - 1, -1, -1):
            gc = self.grid_cfgs[lvl]
            prob = gm.occupancy_prob(self.grids[lvl]).view(self._rows[lvl],
                                                           gc.size_x)
            pose_map, H = self._steps[lvl](prob, world_pose_to_map(gc, pose),
                                           pts / gc.resolution, valid)
            pose_map = torch.cat([pose_map[:2],
                                  geo.normalize_angle(pose_map[2:])])
            pose = map_pose_to_world(gc, pose_map)
        return pose, H

    def _update(self, pose, pts, valid):
        wp = geo.apply(pose, pts)
        if self.mesh is not None:
            self.grids = [
                up(g.view(r, gc.size_x), pose[:2], wp, valid).reshape(-1)
                for up, g, r, gc in zip(self._updaters, self.grids,
                                        self._rows, self.grid_cfgs)]
            return
        self.grids = [
            gm.logodds_update_scan(g, gc, self.locfg, pose[:2], wp, valid,
                                   max_range=self.cfg.scan.range_max)
            for g, gc in zip(self.grids, self.grid_cfgs)
        ]

    def map_grids(self) -> list[torch.Tensor]:
        """Every level whole, flat (size_y·size_x,): with a mesh the stripes
        gathered (a collective: every rank must call it)."""
        if self.mesh is None:
            return list(self.grids)
        return [all_gather_rows(g, self.mesh) for g in self.grids]

    def load_grids(self, grids) -> None:
        """Set every level from whole flat grids; with a mesh each rank
        keeps its stripe."""
        self.grids = []
        for g, r, gc in zip(grids, self._rows, self.grid_cfgs):
            g = torch.as_tensor(g, dtype=torch.float32, device=self.device)
            lo = 0 if self.mesh is None else self.mesh.rank * r * gc.size_x
            self.grids.append(g.reshape(-1)[lo:lo + r * gc.size_x].clone())

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
            gm.occupancy_prob(self.map_grids()[level]), gc.size_x, gc.size_y,
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
        """int8 occupancy map of a pyramid level (with a mesh, of the
        gathered stripes)."""
        g = self.grid_cfgs[level]
        grid = self.grids[level]
        if self.mesh is not None:
            grid = all_gather_rows(grid, self.mesh)
        return gm.logodds_to_ros(
            grid, self.cfg.logodds.obstacle_threshold,
        ).cpu().numpy().reshape(g.size_y, g.size_x)
