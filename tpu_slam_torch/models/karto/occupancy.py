"""Occupancy grid from all corrected scans — port of
``tpu_slam/models/karto/occupancy.py``.

The Karto node's ``updateMap`` (``karto::OccupancyGrid::CreateFromScans``):
whenever a map is asked for, every stored scan is ray-traced from its
corrected pose into pass/hit counters, which are then thresholded. The
grid's bounds are computed on the host in float64; the counters are int32
on the device the caller names (``ops/gridmap``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import GridConfig
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops.correlative import apply_pose

ENGINES = ("auto", "device", "device-scatter", "native")


def compute_grid_bounds(
    poses: np.ndarray, range_threshold: float, resolution: float,
    margin: float = 0.5,
) -> GridConfig:
    """A grid that covers every scan: the poses' box grown by the range
    threshold and ``margin`` (see ``karto_grid_bounds`` for the
    reference's own geometry)."""
    lo = poses[:, :2].min(axis=0) - range_threshold - margin
    hi = poses[:, :2].max(axis=0) + range_threshold + margin
    return GridConfig(
        resolution=resolution,
        size_x=int(math.ceil((hi[0] - lo[0]) / resolution)),
        size_y=int(math.ceil((hi[1] - lo[1]) / resolution)),
        origin_x=float(lo[0]),
        origin_y=float(lo[1]),
    )


def karto_grid_bounds(
    poses: np.ndarray,
    pts_laser: np.ndarray,
    ranges: np.ndarray,
    min_range: float,
    range_threshold: float,
    resolution: float,
) -> GridConfig:
    """The reference's grid geometry (ComputeDimensions): the box of every
    scan's position and of its readings within [min_range,
    range_threshold]; width and height Round(size / resolution), the
    offset the box's minimum. In float64 on the host."""
    p64 = np.asarray(poses, np.float64)
    c = np.cos(p64[:, 2])[:, None]
    s = np.sin(p64[:, 2])[:, None]
    pl = np.asarray(pts_laser, np.float64)
    with np.errstate(invalid="ignore"):  # beams filtered out below
        wx = p64[:, 0:1] + c * pl[..., 0] - s * pl[..., 1]
        wy = p64[:, 1:2] + s * pl[..., 0] + c * pl[..., 1]
    r = np.asarray(ranges, np.float64)
    filt = np.isfinite(r) & (r >= min_range) & (r <= range_threshold)
    xs = np.concatenate([p64[:, 0], wx[filt]])
    ys = np.concatenate([p64[:, 1], wy[filt]])
    lo = np.array([xs.min(), ys.min()])
    hi = np.array([xs.max(), ys.max()])

    def _round(v):
        return int(math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5))

    return GridConfig(
        resolution=resolution,
        size_x=_round((hi[0] - lo[0]) / resolution),
        size_y=_round((hi[1] - lo[1]) / resolution),
        origin_x=float(lo[0]),
        origin_y=float(lo[1]),
    )


def occupancy_from_scans(
    grid_cfg: GridConfig,
    poses: np.ndarray,
    pts_laser: np.ndarray,
    ranges: np.ndarray,
    range_threshold: float,
    min_range: float = 0.0,
    max_range: float = np.inf,
    min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
    scans_per_block: int = 1,
    engine: str = "auto",
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """CreateFromScans: the int8 (H, W) map (-1 unknown, 0 free, 100
    occupied) of the scans at their corrected sensor ``poses`` (T, 3),
    ``pts_laser`` (T, N, 2) and raw ``ranges`` (T, N). Rays skip r ≤ min,
    r ≥ max and NaN and are cut at the range threshold; TraceLine adds a
    pass to every cell it visits, the end included; a valid endpoint
    (r < threshold − 1e-6) adds one more pass and a hit; a cell is
    occupied iff pass > MinPassThrough and hit/pass > OccupancyThreshold.

    ``engine``: "device" traces whole blocks of scans a scatter-add
    (``gridmap.karto_counts_windows``), "device-scatter" ``scans_per_block``
    scans a step (``gridmap.karto_counts_update_scan``), both on
    ``device``; "native" runs the reference's C++ host rasterizer
    (``native.karto_counts``, the same semantics, on the host) and raises
    RuntimeError when the native library is unavailable. "auto" is
    "device". The reference's "auto" takes the native engine where the
    library loads: its measurement was a TPU's, on which the one-hot
    window matmuls ran ~24× slower than the C++ rasterizer. The port's
    device engine is a blocked scatter-add, not those windows, and the
    native engine's host time against it on the card is an open
    measurement (PERF.md); the default changes only on it."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "native":
        return _native_occupancy(grid_cfg, poses, pts_laser, ranges,
                                 range_threshold, min_range, max_range,
                                 min_pass_through, occupancy_threshold)
    T = poses.shape[0]
    if T == 0:
        return np.full((grid_cfg.size_y, grid_cfg.size_x), -1, np.int8)
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(poses, np.float32), **f32)
    ends = apply_pose(p, torch.as_tensor(np.asarray(pts_laser, np.float32),
                                         **f32))
    r = torch.as_tensor(np.asarray(ranges, np.float32), **f32)
    args = (range_threshold, min_range, max_range)
    if engine in ("auto", "device"):
        pc, hc = gm.karto_counts_windows(grid_cfg, p[:, :2], ends, r, *args)
    else:
        ncells = grid_cfg.size_x * grid_cfg.size_y
        pc = torch.zeros(ncells, dtype=torch.int32, device=device)
        hc = torch.zeros_like(pc)
        C = max(1, scans_per_block)
        for t in range(0, T, C):
            pc, hc = gm.karto_counts_update_scan(
                pc, hc, grid_cfg, p[t:t + C, :2], ends[t:t + C],
                r[t:t + C], *args)
    out = gm.karto_occupancy(pc.reshape(-1), hc.reshape(-1),
                             min_pass_through, occupancy_threshold)
    return out.cpu().numpy().reshape(grid_cfg.size_y, grid_cfg.size_x)


def _native_occupancy(grid_cfg, poses, pts_laser, ranges, range_threshold,
                      min_range, max_range, min_pass_through,
                      occupancy_threshold) -> np.ndarray:
    """The native engine (``tpu_slam/models/karto/occupancy.py:152-177``):
    world endpoints from the corrected poses on the host in float32, the
    C++ pass/hit counters, the same thresholds."""
    from tpu_slam_torch import native

    if not native.available():
        raise RuntimeError(
            f"native library unavailable: {native.build_error()}")
    if poses.shape[0] == 0:
        return np.full((grid_cfg.size_y, grid_cfg.size_x), -1, np.int8)
    p32 = np.asarray(poses, np.float32)
    c = np.cos(p32[:, 2])[:, None]
    s = np.sin(p32[:, 2])[:, None]
    pl32 = np.asarray(pts_laser, np.float32)
    with np.errstate(invalid="ignore"):
        wx = p32[:, 0:1] + c * pl32[..., 0] - s * pl32[..., 1]
        wy = p32[:, 1:2] + s * pl32[..., 0] + c * pl32[..., 1]
    ends = np.stack([wx, wy], axis=-1)
    pc, hc = native.karto_counts(
        p32[:, :2], ends, np.asarray(ranges, np.float32), grid_cfg,
        range_threshold, min_range, max_range,
    )
    passed = pc > min_pass_through
    occ = passed & (hc / np.maximum(pc, 1) > occupancy_threshold)
    return np.where(occ, 100, np.where(passed, 0, -1)).astype(np.int8)


def _map_inputs(slam):
    """(corrected sensor poses (T, 3), laser points (T, N, 2), raw ranges
    (T, N)) of every scan a mapper keeps. Sensor poses: the points are in
    the laser frame, so the rig offset stays applied (``trajectory()``
    would strip it)."""
    poses = np.asarray([r.corrected_pose for r in slam.scans]).reshape(-1, 3)
    if len(poses) == 0:
        raise ValueError("no scans processed yet")
    pts = np.stack([r.pts_laser for r in slam.scans])
    ranges = np.stack([
        r.ranges if r.ranges is not None
        # snapshots without stored ranges: the endpoint norms, valid beams
        else np.where(r.beam_valid,
                      np.hypot(r.pts_laser[:, 0], r.pts_laser[:, 1]), np.nan)
        for r in slam.scans
    ])
    return poses, pts, ranges


def karto_map(slam, resolution: float = 0.05) -> tuple[np.ndarray, GridConfig]:
    """updateMap of a ``KartoSLAM``: the map of all its scans at their
    corrected sensor poses, on the grid ``karto_grid_bounds`` sizes, traced
    on the mapper's device. Returns (int8 map, grid)."""
    slam.flush()  # apply any in-flight correction first
    poses, pts, ranges = _map_inputs(slam)
    sc = slam.cfg.scan
    cfg = karto_grid_bounds(poses, pts, ranges, sc.range_min,
                            sc.range_threshold, resolution)
    return (
        occupancy_from_scans(
            cfg, poses, pts, ranges, sc.range_threshold,
            min_range=sc.range_min, max_range=sc.range_max,
            device=slam.device,
        ),
        cfg,
    )


def karto_graph_png(
    slam, path: str, ros_map=None, grid: GridConfig = None,
    resolution: float = 0.05,
) -> str:
    """Write the pose graph of a ``KartoSLAM`` over its occupancy map as a
    PNG: nodes and sequential / chain / loop edges (the rviz MarkerArray
    of publishGraphVisualization). Reuses a given (ros_map, grid) pair,
    else rasterizes one."""
    from tpu_slam_torch.utils.map_io import save_graph_png

    if ros_map is None or grid is None:
        ros_map, grid = karto_map(slam, resolution)
    poses = np.asarray([r.corrected_pose for r in slam.scans]).reshape(-1, 3)
    return save_graph_png(path, np.asarray(ros_map), grid, poses,
                          slam.graph_edges)
