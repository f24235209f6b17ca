"""Occupancy-grid substrate — port of ``tpu_slam/ops/gridmap.py``: the
three cell models of the reference's map stacks.

  * Hector log-odds grids with the per-scan dedup update (``scan_masks``,
    ``logodds_update_scan``): every ray is sampled at a fixed
    sub-resolution step, a (beams × samples) tensor of cell indices, and
    "mark each cell at most once per scan, occupied beats free" becomes
    two boolean masks combined as ``occ ∪ (free ∖ occ)``;
  * GMapping hit/visit counters (``counts_update_scan``): the same rays,
    every beam counted, int32 scatter-adds;
  * Karto pass/hit counters (``karto_counts_update_scan``,
    ``karto_counts_windows``): the closed-form Bresenham walk of each
    beam (``bresenham_cells``), cells by ``kround_i``.

The JAX package marks a skipped cell with ``OOB_INDEX`` and lets XLA's
``mode="drop"`` discard it. A PyTorch index write has no drop mode (an
out-of-range index raises on the CPU and is a device-side assert on
CUDA), so these functions send those indices to spare cells past the
grid before they write, and cut the spare cells off. No function here
reads a value back to the host or copies a host tensor to the device: a
scan's map update is queued on the device without waiting for it.
Integer counts are exact in any order; the float ``acc`` sums of
``counts_update_scan`` are not (atomic adds on CUDA).

Which cell a sample lands in is decided by float32 rounding. The
reference runs these functions compiled (``jax.jit``), where XLA
multiplies by the float32 reciprocal of a constant divisor and contracts
``a·b + c`` to one fma; the functions that index cells do the same
(``_fma``, ``recip32``), in basic IEEE operations that give the same bits
on the CPU and on the card.
"""

from __future__ import annotations

import math

import torch

from tpu_slam_torch.config import GridConfig, LogOddsConfig
# kround_i: math::Round (half away from zero) → int32, the Karto grid's
# cell rule (WorldToGrid); torch.round rounds half to even
from tpu_slam_torch.ops.correlative import _fma, kround_i, recip32

# "skip this cell": out of bounds for any realistic grid
OOB_INDEX = 1 << 30

# spare cells past the grid that the skipped samples of a scatter-add go
# to, spread so that their atomic adds on the card do not meet at one cell
SPARE_CELLS = 1024

# samples (scans × beams × steps) that karto_counts_windows traces in one
# block: its int32 and int64 temporaries then take ~1.5 GB
BLOCK_SAMPLES = 1 << 24

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


def cell_index(cfg: GridConfig, cxy: torch.Tensor, eps: float = _CELL_EPS):
    """Fractional cell coords → (flat row-major int64 index, inbounds mask):
    the floor of each coordinate + ``eps``. Off the grid the index is
    ``OOB_INDEX``, which the scatters drop — the vectorized form of the
    reference's pointOutOfMapBounds/IsUpTo guards."""
    ix = torch.floor(cxy[..., 0] + eps).to(torch.int64)
    iy = torch.floor(cxy[..., 1] + eps).to(torch.int64)
    inb = (ix >= 0) & (ix < cfg.size_x) & (iy >= 0) & (iy < cfg.size_y)
    return torch.where(inb, iy * cfg.size_x + ix,
                       torch.full_like(ix, OOB_INDEX)), inb


def _cell_of(cfg: GridConfig, xy: torch.Tensor) -> torch.Tensor:
    """World coords → flat row-major int64 cell index, ``OOB_INDEX`` off
    the grid: the floor of (xy − origin)·float32(1/resolution) + ε, the
    product and the sum in one fma, as compiled XLA rounds the
    reference's ``cell_index(world_to_cell(xy))`` (the coordinates carry
    ε already, so ``cell_index`` adds none)."""
    inv = recip32(cfg.resolution)
    eps = torch.full_like(xy[..., 0], _CELL_EPS)
    cxy = torch.stack([_fma(xy[..., 0] - cfg.origin_x, inv, eps),
                       _fma(xy[..., 1] - cfg.origin_y, inv, eps)], -1)
    return cell_index(cfg, cxy, eps=0.0)[0]


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
    # the norm as XLA reduces it: d0², then d1² added in one fma
    r = torch.sqrt(_fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    dirn = d / torch.clamp(r, min=1e-9)[..., None]
    if max_range is None:
        max_range = cfg.resolution * max(cfg.size_x, cfg.size_y)
    n_samples = int(max_range / (cfg.resolution * step_frac)) + 1
    t = torch.arange(n_samples, dtype=endpoints.dtype,
                     device=endpoints.device) * (cfg.resolution * step_frac)
    # (..., N, S, 2) sample points, origin + dirn·t in one fma
    shape = dirn.shape[:-1] + (n_samples, 2)
    pts = _fma(dirn[..., :, None, :], t[:, None],
               origin_xy[..., None, None, :].expand(shape))
    margin = cfg.resolution if stop_before_end else 0.0
    free_ok = valid[..., None] & (
        t < (torch.clamp(r, max=max_range) - margin)[..., None])
    free_flat = _cell_of(cfg, pts)
    free_idx = torch.where(free_ok, free_flat,
                           torch.full_like(free_flat, OOB_INDEX))

    end_ok = valid & (r <= max_range)
    end_flat = _cell_of(cfg, endpoints)
    end_idx = torch.where(end_ok, end_flat,
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


def _scatter_add(counts: torch.Tensor, idx: torch.Tensor,
                 src=1) -> torch.Tensor:
    """``counts.at[idx].add(src, mode="drop")``: ``counts`` (C, ...) plus
    ``src`` (a number, or one row a sample) at the flat cells ``idx``;
    samples at ``OOB_INDEX`` (or any index off the grid) go to the spare
    cells past it, each to cell C + (its place mod SPARE_CELLS). Returns a
    new tensor."""
    C = counts.shape[0]
    idx = idx.reshape(-1)
    spare = C + torch.arange(idx.numel(), device=idx.device) % SPARE_CELLS
    idx = torch.where((idx >= 0) & (idx < C), idx, spare)
    buf = torch.cat([counts, counts.new_zeros((SPARE_CELLS,)
                                              + counts.shape[1:])])
    if isinstance(src, torch.Tensor):
        src = src.reshape((idx.numel(),) + counts.shape[1:])
    else:
        src = counts.new_full((1,) + counts.shape[1:], src).expand(
            (idx.numel(),) + counts.shape[1:])
    buf.index_add_(0, idx, src)
    return buf[:C]


def counts_update_scan(
    hits: torch.Tensor,
    visits: torch.Tensor,
    cfg: GridConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    valid: torch.Tensor,
    max_range: float | None = None,
    acc: torch.Tensor | None = None,
):
    """GMapping per-beam counters, no per-scan dedup: every beam's ray adds
    1 to ``visits`` along the line and 1 to (``visits``, ``hits``) at the
    endpoint; overlapping beams accumulate. A ray that samples one cell
    twice (sub-resolution steps) counts it once: a sample equal to the
    previous sample's cell is dropped. With ``acc`` (cells, 2) the
    endpoints' world positions are summed into it too and it is returned
    third (PointAccumulator's ``acc``)."""
    free_idx, end_idx = ray_cell_indices(
        cfg, origin_xy, endpoints, valid, max_range=max_range)
    # OOB_INDEX + 1 before the first sample: never a cell, never OOB_INDEX
    prev = torch.cat([torch.full_like(free_idx[..., :1], OOB_INDEX + 1),
                      free_idx[..., :-1]], dim=-1)
    uniq = torch.where(free_idx != prev, free_idx,
                       torch.full_like(free_idx, OOB_INDEX))
    visits = _scatter_add(visits, torch.cat([uniq.reshape(-1),
                                             end_idx.reshape(-1)]))
    hits = _scatter_add(hits, end_idx)
    if acc is None:
        return hits, visits
    acc = _scatter_add(acc, end_idx, endpoints.reshape(-1, 2).to(acc.dtype))
    return hits, visits, acc


def counts_mean(acc: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """Per-cell mean hit position (PointAccumulator::mean); cells with no
    hits → 0."""
    return acc / torch.clamp(hits, min=1)[..., None].to(acc.dtype)


def counts_occupancy(hits: torch.Tensor, visits: torch.Tensor,
                     threshold: float = 0.25) -> torch.Tensor:
    """GMapping cell value hits/visits (occupied above ``threshold``), as
    float32; never-visited cells → 0."""
    return hits.to(torch.float32) / torch.clamp(visits, min=1).to(
        torch.float32)


def bresenham_cells(c0: torch.Tensor, c1: torch.Tensor, max_steps: int):
    """Karto's TraceLine cell walk, closed form. ``c0``, ``c1``: (..., 2)
    int32 end cells. Returns ((..., S, 2) int32 cells, (..., S) step-valid
    mask), S = ``max_steps``. The walk is normalized (steep swap,
    ascending x) and visits every x of [x0, x1], both ends included; its
    k-th y is y0 + ystep·⌊(2k·Δy + Δx)/(2Δx)⌋, so all steps compute at
    once. With k ≤ Δx and Δy ≤ Δx the quotient never passes Δy."""
    x0, y0 = c0[..., 0], c0[..., 1]
    x1, y1 = c1[..., 0], c1[..., 1]
    steep = (y1 - y0).abs() > (x1 - x0).abs()
    ax0 = torch.where(steep, y0, x0)
    ay0 = torch.where(steep, x0, y0)
    ax1 = torch.where(steep, y1, x1)
    ay1 = torch.where(steep, x1, y1)
    flip = ax0 > ax1
    bx0 = torch.where(flip, ax1, ax0)
    by0 = torch.where(flip, ay1, ay0)
    bx1 = torch.where(flip, ax0, ax1)
    by1 = torch.where(flip, ay0, ay1)
    dx = (bx1 - bx0)[..., None]  # ≥ 0
    dy = (by1 - by0).abs()[..., None]
    ystep = torch.where(by0 < by1, 1, -1).to(c0.dtype)[..., None]
    k = torch.arange(max_steps, dtype=c0.dtype, device=c0.device)
    ok = k <= dx
    # dxe ≥ 1 keeps the numerator and the divisor positive: floor division
    dxe = torch.clamp(dx, min=1)
    j = torch.div(2 * k * dy + dxe, 2 * dxe, rounding_mode="floor")
    px = bx0[..., None] + k
    py = by0[..., None] + ystep * j
    st = steep[..., None]
    return torch.stack([torch.where(st, py, px), torch.where(st, px, py)],
                       dim=-1), ok


def _karto_rays(cfg: GridConfig, origin_xy: torch.Tensor,
                endpoints: torch.Tensor, ranges: torch.Tensor,
                range_threshold: float, min_range: float, max_range: float):
    """The cells of Karto's rays: (c0 (..., 2), c1 (..., N, 2) int32 end
    cells, use (..., N): the beam is traced, end_valid (..., N): its
    endpoint counts). A ray past the range threshold is cut to it; a
    beam that is not traced gets c1 = c0, so that no cell arithmetic
    overflows on a non-finite endpoint."""
    use = torch.isfinite(ranges) & (ranges > min_range) & (ranges < max_range)
    end_valid = use & (ranges < (range_threshold - 1e-6))
    over = ranges >= range_threshold
    ratio = torch.where(over, range_threshold / torch.clamp(ranges, min=1e-9),
                        torch.ones_like(ranges))
    d = endpoints - origin_xy[..., None, :]
    end = _fma(ratio[..., None], d, origin_xy[..., None, :].expand(d.shape))
    inv = recip32(cfg.resolution)
    org = torch.tensor([cfg.origin_x, cfg.origin_y], dtype=endpoints.dtype,
                       device=endpoints.device)
    c0 = kround_i((origin_xy - org) * inv)
    c1 = kround_i((end - org) * inv)
    c1 = torch.where(use[..., None], c1, c0[..., None, :].expand(c1.shape))
    return c0, c1, use, end_valid


def _flat(cfg: GridConfig, cells: torch.Tensor, keep: torch.Tensor):
    """Flat int64 indices of (..., 2) cells, ``OOB_INDEX`` where not
    ``keep`` or off the grid."""
    cx, cy = cells[..., 0].to(torch.int64), cells[..., 1].to(torch.int64)
    inb = (cx >= 0) & (cx < cfg.size_x) & (cy >= 0) & (cy < cfg.size_y)
    return torch.where(keep & inb, cy * cfg.size_x + cx,
                       torch.full_like(cx, OOB_INDEX))


def karto_max_steps(cfg: GridConfig, range_threshold: float) -> int:
    """The Bresenham steps that cover a ray cut at the range threshold."""
    return int(range_threshold / cfg.resolution * 1.5) + 4


def karto_counts_update_scan(
    pass_cnt: torch.Tensor,
    hit_cnt: torch.Tensor,
    cfg: GridConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    ranges: torch.Tensor,
    range_threshold: float,
    min_range: float,
    max_range: float,
    max_steps: int | None = None,
):
    """Karto AddScan → RayTrace → counters, of one scan or a batch (leading
    axes of ``origin_xy`` (..., 2)): beams with r ≤ min, r ≥ max or NaN are
    skipped; a ray is cut at the range threshold (its world vector scaled
    by threshold/r); TraceLine adds 1 pass to every in-bounds cell it
    visits, the end cell included; a valid endpoint (r < threshold −
    1e-6) then adds one more pass and a hit at its cell. Cells follow
    ``kround_i``. Returns (pass_cnt, hit_cnt), new flat tensors."""
    if max_steps is None:
        max_steps = karto_max_steps(cfg, range_threshold)
    c0, c1, use, end_valid = _karto_rays(
        cfg, origin_xy, endpoints, ranges, range_threshold, min_range,
        max_range)
    cells, ok = bresenham_cells(c0[..., None, :].expand(c1.shape), c1,
                                max_steps)
    traced = _flat(cfg, cells, ok & use[..., None])
    # the endpoint's double count: TraceLine visited the end cell already
    ends = _flat(cfg, c1, end_valid)
    pass_cnt = _scatter_add(pass_cnt, torch.cat([traced.reshape(-1),
                                                 ends.reshape(-1)]))
    hit_cnt = _scatter_add(hit_cnt, ends)
    return pass_cnt, hit_cnt


def karto_counts_windows(
    cfg: GridConfig,
    origin_xy: torch.Tensor,
    endpoints: torch.Tensor,
    ranges: torch.Tensor,
    range_threshold: float,
    min_range: float,
    max_range: float,
):
    """Whole-mission Karto counters: ``origin_xy`` (T, 2) scan positions,
    ``endpoints`` (T, N, 2) raw world endpoints, ``ranges`` (T, N) raw
    readings. The cells of ``karto_counts_update_scan``, traced in blocks
    of scans whose (scans × beams × steps) samples stay within
    ``BLOCK_SAMPLES``, each block one scatter-add into int32 counters.
    (The reference rasterizes each scan into a local window with one-hot
    matmuls, its TPU's way around scatter-adds; the counts are the same.)
    Returns (pass, hit), int32 (size_y, size_x) on the scans' device."""
    T, N = ranges.shape
    S = karto_max_steps(cfg, range_threshold)
    ncells = cfg.size_x * cfg.size_y
    pc = torch.zeros(ncells, dtype=torch.int32, device=ranges.device)
    hc = torch.zeros_like(pc)
    B = max(1, BLOCK_SAMPLES // max(N * S, 1))
    for t in range(0, T, B):
        pc, hc = karto_counts_update_scan(
            pc, hc, cfg, origin_xy[t:t + B], endpoints[t:t + B],
            ranges[t:t + B], range_threshold, min_range, max_range, S)
    return (pc.view(cfg.size_y, cfg.size_x),
            hc.view(cfg.size_y, cfg.size_x))


def karto_occupancy(pass_cnt: torch.Tensor, hit_cnt: torch.Tensor,
                    min_pass_through: int = 2,
                    occupancy_threshold: float = 0.1) -> torch.Tensor:
    """Karto cell state (UpdateCell): occupied iff pass > MinPassThrough
    and hit/pass > OccupancyThreshold (both strict), free iff passed,
    else unknown. int8: -1 unknown, 0 free, 100 occupied."""
    passed = pass_cnt > min_pass_through
    frac = hit_cnt.to(torch.float32) / torch.clamp(pass_cnt, min=1).to(
        torch.float32)
    occ = passed & (frac > occupancy_threshold)
    return torch.where(occ, 100, torch.where(passed, 0, -1)).to(torch.int8)


def logodds_to_ros(grid: torch.Tensor,
                   obstacle_threshold: float = 0.0) -> torch.Tensor:
    """Hector grid → nav_msgs-style int8 map: occupied→100, free→0,
    untouched→-1."""
    occupied = grid > obstacle_threshold
    free = (grid < 0.0) & (grid != 0.0)
    return torch.where(occupied, 100,
                       torch.where(free, 0, -1)).to(torch.int8)
