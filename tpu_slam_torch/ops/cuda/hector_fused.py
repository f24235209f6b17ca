"""Coarse-to-fine Hector GN match in one CUDA launch — port of
``tpu_slam/ops/pallas/hector_fused.py::hector_match_fused``.

The kernel is ``csrc/hector_fused.cu``, launched on the shape
``hector_geometry`` chooses; its plain PyTorch version is
``ops/hector.match_multires``. A pose on ``cuda`` launches the kernel, a
pose on ``cpu`` runs the plain version (``_dispatch.route``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.config import HectorConfig
from tpu_slam_torch.ops.cuda.plicp_fused import _check
from tpu_slam_torch.ops.hector import match_multires

MAX_LEVELS = 8  # csrc/hector_fused.cu
MAX_THREADS = 1024  # threads a block (hector_fused.cu)
MAX_BEAMS_PER_THREAD = 8  # hector_fused.cu's template instances
# threads a match while they cover the beams at ≤ MAX_BEAMS_PER_THREAD;
# chip_sweep.py times 2, 4, 8 and 12 warps on bench_hector's case
THREADS = 128
BARRIERS_PER_STEP = 1  # the design's, csrc/hector_fused.cu


class HectorGeometry(NamedTuple):
    threads: int  # T threads of the match's one block
    beams: int  # K beams a thread: beam (c·K + k)·T + t on thread t
    chunks: int = 1  # C chunks of K·T beams; the kernel derives it from N


def max_threads(beams: int) -> int:
    """The most threads a block of the K-beams instance takes (its launch
    bounds): the whole block up to 4 beams a thread, half above."""
    return MAX_THREADS if beams <= 4 else MAX_THREADS // 2


@functools.lru_cache(maxsize=64)
def hector_geometry(N: int) -> HectorGeometry:
    """The kernel's shape for N beams: ``THREADS`` threads (fewer, in whole
    warps, where N is smaller), widened a warp at a time until each thread
    holds at most ``MAX_BEAMS_PER_THREAD`` beams within its instance's
    thread cap; beyond what the largest instance holds (4,096 beams), its
    shape in chunks."""
    if N < 1:
        raise ValueError(f"{N} beams: the kernel needs at least one")
    for threads in range(min(THREADS, 32 * -(-N // 32)), MAX_THREADS + 1,
                         32):
        beams = -(-N // threads)
        if beams <= MAX_BEAMS_PER_THREAD and threads <= max_threads(beams):
            return HectorGeometry(threads, beams)
    threads = max_threads(MAX_BEAMS_PER_THREAD)
    return HectorGeometry(threads, MAX_BEAMS_PER_THREAD,
                          -(-N // (threads * MAX_BEAMS_PER_THREAD)))


def hector_match_fused(
    prob_grids: tuple,  # per level (size_y, size_x) float32, level 0 finest
    grid_cfgs: tuple,
    hcfg: HectorConfig,
    pose_world: torch.Tensor,  # (3,) float32
    pts_laser: torch.Tensor,  # (N, 2) float32, laser-frame meters
    valid: torch.Tensor,  # (N,) bool
):
    """The same match as ``ops/hector.match_multires``; returns
    (pose_world (3,), H (3, 3) of the finest level's last step).

    The reference's signature without its two TPU-only arguments:
    ``interpret`` (the Pallas interpreter) and ``max_range_m`` (the
    pose-centred VMEM window, which changes nothing in the result); this
    kernel reads the whole grid, as the reference does without a
    window. Invalid beams add nothing, whatever their coordinates."""
    if _dispatch.route(pose_world) == "cpu":
        pts = torch.where(valid[:, None], pts_laser, 0.0)
        return match_multires([g.reshape(-1) for g in prob_grids],
                              list(grid_cfgs), pose_world, pts, valid, hcfg)
    L = len(prob_grids)
    if not (0 < L <= MAX_LEVELS and len(grid_cfgs) == L):
        raise ValueError(f"{L} grids for {len(grid_cfgs)} levels; the "
                         f"kernel takes 1 to {MAX_LEVELS}")
    dev = pose_world.device
    N = pts_laser.shape[0]
    if N < 1:
        raise ValueError("the kernel needs at least one beam")
    for lvl, (g, c) in enumerate(zip(prob_grids, grid_cfgs)):
        if c.size_x < 2 or c.size_y < 2:
            raise ValueError(f"level {lvl}: the grid needs 2 x 2 cells")
        _check(f"prob_grids[{lvl}]", g, torch.float32, (c.size_y, c.size_x),
               dev)
    _check("pose_world", pose_world, torch.float32, (3,), dev)
    _check("pts_laser", pts_laser, torch.float32, (N, 2), dev)
    _check("valid", valid, torch.bool, (N,), dev)
    geo = hector_geometry(N)
    grids = (ctypes.c_void_p * L)(*(g.data_ptr() for g in prob_grids))
    sizes = (ctypes.c_int * (2 * L))(
        *(v for c in grid_cfgs for v in (c.size_x, c.size_y)))
    geo_l = (ctypes.c_float * (3 * L))(
        *(v for c in grid_cfgs
          for v in (c.resolution, c.origin_x, c.origin_y)))
    out = torch.empty(12, dtype=torch.float32, device=dev)
    _build.launch(
        "hector_fused", ctypes.addressof(grids), ctypes.addressof(sizes),
        ctypes.addressof(geo_l), L, pts_laser.data_ptr(), valid.data_ptr(),
        pose_world.data_ptr(), out.data_ptr(), N, hcfg.iterations_fine,
        hcfg.iterations_coarse, hcfg.max_rot_step, geo.threads, geo.beams,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("hector_fused")
    return out[:3], out[3:].view(3, 3)
