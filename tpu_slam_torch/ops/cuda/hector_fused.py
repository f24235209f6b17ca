"""Coarse-to-fine Hector GN match in one CUDA launch — port of
``tpu_slam/ops/pallas/hector_fused.py::hector_match_fused``.

The kernel is ``csrc/hector_fused.cu``; its plain PyTorch version is
``ops/hector.match_multires``. A pose on ``cuda`` launches the kernel, a
pose on ``cpu`` runs the plain version (``_dispatch.route``).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.config import HectorConfig
from tpu_slam_torch.ops.cuda.plicp_fused import _check
from tpu_slam_torch.ops.hector import match_multires

MAX_LEVELS = 8  # csrc/hector_fused.cu


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
    grids = (ctypes.c_void_p * L)(*(g.data_ptr() for g in prob_grids))
    sizes = (ctypes.c_int * (2 * L))(
        *(v for c in grid_cfgs for v in (c.size_x, c.size_y)))
    geo = (ctypes.c_float * (3 * L))(
        *(v for c in grid_cfgs
          for v in (c.resolution, c.origin_x, c.origin_y)))
    out = torch.empty(12, dtype=torch.float32, device=dev)
    _build.launch(
        "hector_fused", ctypes.addressof(grids), ctypes.addressof(sizes),
        ctypes.addressof(geo), L, pts_laser.data_ptr(), valid.data_ptr(),
        pose_world.data_ptr(), out.data_ptr(), N, hcfg.iterations_fine,
        hcfg.iterations_coarse, hcfg.max_rot_step,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("hector_fused")
    return out[:3], out[3:].view(3, 3)
