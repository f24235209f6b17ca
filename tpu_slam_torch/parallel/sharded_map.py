"""Occupancy grids sharded in row stripes over a mesh, with a one-row
halo — port of ``tpu_slam/parallel/sharded_map.py``.

The reference keeps one flat cell array (``GridMapBase.h:401``); here rank
r holds rows [r·H/D, (r+1)·H/D) of each grid. Two callables:

  * the sharded log-odds update: every rank rasterizes the whole beam set
    (``ops/gridmap.ray_cell_indices``) but keeps only its stripe's cells,
    so the stripes together equal the unsharded update exactly, with no
    communication;
  * the sharded Hector GN step: bilinear interpolation at a stripe's top
    edge needs the first row of the next stripe, which one ``ppermute``
    brings (the halo); each rank then sums H and dTr over the beams that
    land in its stripe, and one psum a GN step forms the global system.

The stripes are persistent state: a grid argument is the rank's own
(H/D, W) stripe, and the update returns the stripe. A read of the whole
grid gathers the stripes (``mesh.all_gather_rows``).
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import GridConfig, LogOddsConfig
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops.hector import interp_map_with_derivs, solve3
from tpu_slam_torch.parallel.mesh import Mesh, ppermute, psum_packed


def stripe_rows(mesh: Mesh, cfg: GridConfig) -> int:
    """Rows a rank holds; the grid's rows must divide by D."""
    if cfg.size_y % mesh.size:
        raise ValueError(f"a grid of {cfg.size_y} rows does not divide into "
                         f"{mesh.size} stripes")
    return cfg.size_y // mesh.size


def make_sharded_logodds_update(mesh: Mesh, cfg: GridConfig,
                                locfg: LogOddsConfig, max_range: float):
    """f(the rank's stripe (H/D, W), origin (2,), endpoints (N, 2),
    valid (N,)) → the updated stripe."""
    rows = stripe_rows(mesh, cfg)
    row0 = mesh.rank * rows
    ncells = rows * cfg.size_x

    def to_local(idx):
        r, c = idx // cfg.size_x, idx % cfg.size_x
        ok = (r >= row0) & (r < row0 + rows) & (idx != gm.OOB_INDEX)
        return torch.where(ok, (r - row0) * cfg.size_x + c,
                           torch.full_like(idx, gm.OOB_INDEX))

    def f(stripe, origin_xy, endpoints, valid):
        free_idx, end_idx = gm.ray_cell_indices(
            cfg, origin_xy, endpoints, valid, max_range=max_range,
            stop_before_end=False)
        occ = gm._mark(to_local(end_idx), ncells)
        free = gm._mark(to_local(free_idx), ncells) & ~occ
        lo_free, lo_occ = gm.logodds_factors(locfg, stripe.dtype)
        upd = torch.where(occ, lo_occ, torch.where(free, lo_free, 0.0))
        return torch.clamp(stripe.reshape(-1) + upd, locfg.log_odds_min,
                           locfg.log_odds_max).view(rows, cfg.size_x)

    return f


def make_sharded_hector_step(mesh: Mesh, cfg: GridConfig,
                             max_rot_step: float = 0.2, n_iters: int = 1):
    """f(the rank's stripe (H/D, W) of prob_grid, pose_map (3,), pts_map
    (N, 2), valid (N,)) → ``n_iters`` GN steps: (pose_map, H (3, 3)),
    replicated. One ppermute of the halo row a call, one psum of H and dTr
    a step (the sharded ScanMatcher::matchData loop,
    ScanMatcher.h:60-139)."""
    D = mesh.size
    rows = stripe_rows(mesh, cfg)
    row0 = mesh.rank * rows
    # rank i gets the first row of rank i + 1 (the last rank's wraps and
    # is masked by the global-bounds gate)
    perm = [((i + 1) % D, i) for i in range(D)]

    def f(stripe, pose_map, pts_map, valid):
        halo = ppermute(stripe[0:1].contiguous(), mesh, perm)
        local = torch.cat([stripe, halo], dim=0).reshape(-1)
        H = None
        for _ in range(n_iters):
            # in the stripe's coords, at cell centres
            pw = geo.apply(pose_map, pts_map) - 0.5
            y = pw[..., 1] - row0
            # y < H − 1: the unsharded interpolation's top-edge rejection,
            # where the last rank's wrapped halo must not be read
            in_stripe = ((y >= 0.0) & (y < rows)
                         & (pw[..., 1] < cfg.size_y - 1) & valid)
            coords = torch.stack(
                [pw[..., 0], torch.where(in_stripe, y, torch.zeros_like(y))],
                dim=-1)
            val, dx, dy = interp_map_with_derivs(local, cfg.size_x, rows + 1,
                                                 coords)
            w = in_stripe.to(pts_map.dtype)
            c, s = torch.cos(pose_map[2]), torch.sin(pose_map[2])
            rot = ((-s * pts_map[..., 0] - c * pts_map[..., 1]) * dx
                   + (c * pts_map[..., 0] - s * pts_map[..., 1]) * dy)
            J = torch.stack([dx * w, dy * w, rot * w], dim=-1)
            dTr, H = psum_packed(mesh, torch.einsum("ni,n->i", J, 1.0 - val),
                                 torch.einsum("ni,nj->ij", J, J))
            ok = (H[0, 0] != 0.0) & (H[1, 1] != 0.0)
            delta = solve3(H, dTr)
            delta = torch.where(torch.isfinite(delta), delta,
                                torch.zeros_like(delta))
            delta = torch.cat([delta[:2], torch.clamp(
                delta[2:], -max_rot_step, max_rot_step)])
            pose_map = pose_map + torch.where(ok, delta,
                                              torch.zeros_like(delta))
        return pose_map, H

    return f
