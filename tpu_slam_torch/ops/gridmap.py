"""Occupancy-grid substrate, log-odds half — port of
``tpu_slam/ops/gridmap.py`` (the Hector log-odds grids).

Every ray is sampled at a fixed sub-resolution step, a (beams × samples)
tensor of cell indices, and the cell updates become masked writes. The
reference's "mark each cell at most once per scan, occupied beats free"
rule becomes two boolean masks combined as ``occ ∪ (free ∖ occ)``.

The JAX package marks a skipped cell with ``OOB_INDEX`` and lets XLA's
``mode="drop"`` discard it. A PyTorch index write has no drop mode (an
out-of-range index raises on the CPU and is a device-side assert on
CUDA), so ``scan_masks`` sends those indices to a spare cell past the
grid before it writes. No function here reads a value back to the host
or copies a host tensor to the device: a scan's map update is queued on
the device without waiting for it. The counts and Karto models of the
reference module are not ported yet (ROADMAP queue 1, items 8 and 10).
"""

from __future__ import annotations

import math

import torch

from tpu_slam_torch.config import GridConfig, LogOddsConfig

# "skip this cell": out of bounds for any realistic grid
OOB_INDEX = 1 << 30

# epsilon (in cells) so endpoints that land exactly on a cell border under
# f32 arithmetic (e.g. 94.0 computed as 93.99999) fall in the intended cell
_CELL_EPS = 1e-3


def world_to_cell(cfg: GridConfig, xy: torch.Tensor) -> torch.Tensor:
    """World coords → fractional cell coords (x-col, y-row), (..., 2)."""
    return torch.stack([xy[..., 0] - cfg.origin_x,
                        xy[..., 1] - cfg.origin_y], dim=-1) / cfg.resolution


def cell_to_world(cfg: GridConfig, cxy: torch.Tensor) -> torch.Tensor:
    c = cxy * cfg.resolution
    return torch.stack([c[..., 0] + cfg.origin_x, c[..., 1] + cfg.origin_y],
                       dim=-1)


def cell_index(cfg: GridConfig, cxy: torch.Tensor):
    """Fractional cell coords → (flat row-major int64 index with
    ``OOB_INDEX`` for a cell off the grid, inbounds mask)."""
    ix = torch.floor(cxy[..., 0] + _CELL_EPS).to(torch.int64)
    iy = torch.floor(cxy[..., 1] + _CELL_EPS).to(torch.int64)
    inb = (ix >= 0) & (ix < cfg.size_x) & (iy >= 0) & (iy < cfg.size_y)
    flat = torch.where(inb, iy * cfg.size_x + ix,
                       torch.full_like(ix, OOB_INDEX))
    return flat, inb


def ray_cell_indices(
    cfg: GridConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    valid: torch.Tensor,
    step_frac: float = 0.7,
    max_range: float | None = None,
    stop_before_end: bool = True,
):
    """Sample every beam at ``step_frac × resolution`` along the ray.

    Returns (free_idx (N, S) flat indices with ``OOB_INDEX`` = skip,
    end_idx (N,) endpoint indices with ``OOB_INDEX`` = skip). With
    ``stop_before_end`` the free samples stop one resolution short of the
    endpoint. Rays are truncated at ``max_range``."""
    d = endpoints - origin_xy[..., None, :]
    r = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    dirn = d / torch.clamp(r, min=1e-9)[..., None]
    if max_range is None:
        max_range = cfg.resolution * max(cfg.size_x, cfg.size_y)
    n_samples = int(max_range / (cfg.resolution * step_frac)) + 1
    t = torch.arange(n_samples, dtype=endpoints.dtype,
                     device=endpoints.device) * (cfg.resolution * step_frac)
    # (..., N, S, 2) sample points
    pts = origin_xy[..., None, None, :] + dirn[..., :, None, :] * t[:, None]
    margin = cfg.resolution if stop_before_end else 0.0
    free_ok = valid[..., None] & (
        t < (torch.clamp(r, max=max_range) - margin)[..., None])
    free_flat, free_inb = cell_index(cfg, world_to_cell(cfg, pts))
    oob = torch.full_like(free_flat, OOB_INDEX)
    free_idx = torch.where(free_ok & free_inb, free_flat, oob)

    end_ok = valid & (r <= max_range)
    end_flat, end_inb = cell_index(cfg, world_to_cell(cfg, endpoints))
    end_idx = torch.where(end_ok & end_inb, end_flat,
                          torch.full_like(end_flat, OOB_INDEX))
    return free_idx, end_idx


def _mark(idx: torch.Tensor, ncells: int) -> torch.Tensor:
    """Boolean (ncells,) mask of the cells in ``idx``, ``OOB_INDEX``
    dropped (the reference's ``.at[].max(True, mode="drop")``): skipped
    indices write one spare cell past the grid, which is cut off. (Keeping
    only the valid indices with a boolean mask would wait for the device
    to count them, once per call.)"""
    idx = idx.reshape(-1)
    idx = torch.where(idx == OOB_INDEX, torch.full_like(idx, ncells), idx)
    out = torch.zeros(ncells + 1, dtype=torch.bool, device=idx.device)
    out[idx] = True
    return out[:ncells]


def scan_masks(
    cfg: GridConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    valid: torch.Tensor,
    max_range: float | None = None,
):
    """Per-scan boolean (free, occ) cell masks: each cell at most once per
    scan; the endpoint (occupied) wins over free."""
    ncells = cfg.size_x * cfg.size_y
    # free samples run all the way to the endpoint: occupied-beats-free
    # below removes the endpoint cells
    free_idx, end_idx = ray_cell_indices(
        cfg, origin_xy, endpoints, valid, max_range=max_range,
        stop_before_end=False,
    )
    free = _mark(free_idx, ncells)
    occ = _mark(end_idx, ncells)
    return free & ~occ, occ


def logodds_factors(cfg: LogOddsConfig, dtype=torch.float32):
    """log(p/(1−p)) update increments, as 0-dim host tensors (which
    PyTorch's ops take beside a tensor on any device)."""
    lo_free = math.log(cfg.p_free / (1.0 - cfg.p_free))
    lo_occ = math.log(cfg.p_occupied / (1.0 - cfg.p_occupied))
    return (torch.tensor(lo_free, dtype=dtype),
            torch.tensor(lo_occ, dtype=dtype))


def logodds_update_scan(
    grid: torch.Tensor,
    cfg: GridConfig,
    locfg: LogOddsConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    valid: torch.Tensor,
    max_range: float | None = None,
) -> torch.Tensor:
    """One scan's log-odds update of a flat (size_y*size_x,) grid; cells
    are clipped to [``log_odds_min``, ``log_odds_max``]. Returns a new
    grid."""
    free, occ = scan_masks(cfg, origin_xy, endpoints, valid, max_range)
    lo_free, lo_occ = logodds_factors(locfg, grid.dtype)
    upd = torch.where(occ, lo_occ, torch.where(free, lo_free, 0.0))
    return torch.clamp(grid + upd, locfg.log_odds_min, locfg.log_odds_max)


def occupancy_prob(grid: torch.Tensor) -> torch.Tensor:
    """Log-odds → probability: odds/(1+odds)."""
    return torch.sigmoid(grid)


def logodds_to_ros(grid: torch.Tensor,
                   obstacle_threshold: float = 0.0) -> torch.Tensor:
    """Hector grid → nav_msgs-style int8 map: occupied→100, free→0,
    untouched→-1."""
    occupied = grid > obstacle_threshold
    free = (grid < 0.0) & (grid != 0.0)
    return torch.where(occupied, 100,
                       torch.where(free, 0, -1)).to(torch.int8)
