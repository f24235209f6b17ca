"""Batched PL-ICP in one CUDA launch — port of
``tpu_slam/ops/pallas/plicp_fused.py::plicp_match_fused``.

The kernel is ``csrc/plicp_fused.cu``; its plain PyTorch version is
``ops/plicp.plicp_match`` with the plain ``nearest_neighbor``. Tensors on
``cuda`` launch the kernel, tensors on ``cpu`` run the plain version
(``_dispatch.route``). The covariance
σ²·inv(H + 1e-6·I) is formed here from the kernel's H, outside the kernel,
as in the reference.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.config import PLICPConfig
from tpu_slam_torch.ops.matching import nearest_neighbor
from tpu_slam_torch.ops.plicp import PLICPResult, covariance_from_h, plicp_match

MAX_BEAMS = 1024  # one thread per source beam
MAX_TARGETS = 4096  # target beams held in shared memory


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def plicp_match_fused(
    src_pts: torch.Tensor,  # (B, N, 2) float32
    src_valid: torch.Tensor,  # (B, N) bool
    tgt_pts: torch.Tensor,  # (B, M, 2) float32
    tgt_valid: torch.Tensor,  # (B, M) bool
    cfg: PLICPConfig,
    init_pose: torch.Tensor | None = None,  # (B, 3) float32
) -> PLICPResult:
    """Batched point-to-line PL-ICP with per-pair convergence; the same
    PLICPResult fields as ``ops/plicp.plicp_match``."""
    if _dispatch.route(src_pts) == "cpu":
        return plicp_match(src_pts, src_valid, tgt_pts, tgt_valid, cfg,
                           init_pose=init_pose, nn=nearest_neighbor)
    if not cfg.use_point_to_line_distance:
        raise ValueError("the PL-ICP kernel implements the point-to-line form")
    B, N, _ = src_pts.shape
    M = tgt_pts.shape[1]
    dev = src_pts.device
    if init_pose is None:
        init_pose = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    _check("src_pts", src_pts, torch.float32, (B, N, 2), dev)
    _check("src_valid", src_valid, torch.bool, (B, N), dev)
    _check("tgt_pts", tgt_pts, torch.float32, (B, M, 2), dev)
    _check("tgt_valid", tgt_valid, torch.bool, (B, M), dev)
    _check("init_pose", init_pose, torch.float32, (B, 3), dev)
    if not (0 < N <= MAX_BEAMS and 0 < M <= MAX_TARGETS):
        raise ValueError(f"beam counts N={N}, M={M} outside the kernel's range")
    pose = torch.empty((B, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.float32, device=dev)
    H = torch.empty((B, 9), dtype=torch.float32, device=dev)
    if B > 0:
        _build.launch(
            "plicp_fused",
            src_pts.data_ptr(), src_valid.data_ptr(), tgt_pts.data_ptr(),
            tgt_valid.data_ptr(), init_pose.data_ptr(), pose.data_ptr(),
            stats.data_ptr(), H.data_ptr(), B, N, M, cfg.max_iterations,
            cfg.max_correspondence_dist**2, cfg.epsilon_xy, cfg.epsilon_theta,
            cfg.outliers_maxPerc, cfg.outliers_adaptive_order,
            cfg.outliers_adaptive_mult,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _dispatch.count_launch("plicp_fused")
    return PLICPResult(
        pose=pose,
        error=stats[:, 0],
        num_inliers=stats[:, 1].to(torch.int32),
        covariance=covariance_from_h(H.view(B, 3, 3), cfg),
        converged=stats[:, 2] > 0.5,
    )
