"""Point-to-point ICP — port of ``tpu_slam/ops/icp.py``.

Frame-to-frame matching of consecutive scans (lesson 2's
``pcl::IterativeClosestPoint``): each of ``cfg.max_iterations`` iterations
is one exhaustive NN (``nearest_neighbor_auto``: the NN kernel on
``cuda``) and a closed-form weighted 2D Procrustes update. Batched over
leading axes.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import ICPConfig
from tpu_slam_torch.ops.matching import _take_rows, nearest_neighbor_auto


def procrustes_step(src_w: torch.Tensor, tgt_q: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted 2D rigid alignment src → tgt:
    θ* = atan2(Σw p×q, Σw p·q) on centred points. Returns the pose (..., 3)
    to left-compose onto the current estimate."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mu_p = torch.sum(src_w * w[..., None], dim=-2) / wsum
    mu_q = torch.sum(tgt_q * w[..., None], dim=-2) / wsum
    p = src_w - mu_p[..., None, :]
    q = tgt_q - mu_q[..., None, :]
    dot = torch.sum(w * (p * q).sum(-1), dim=-1)
    crs = torch.sum(w * (p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]), dim=-1)
    th = torch.atan2(crs, dot)
    c, s = torch.cos(th), torch.sin(th)
    tx = mu_q[..., 0] - (c * mu_p[..., 0] - s * mu_p[..., 1])
    ty = mu_q[..., 1] - (s * mu_p[..., 0] + c * mu_p[..., 1])
    return torch.stack([tx, ty, th], dim=-1)


def icp_match(
    src_pts: torch.Tensor,
    src_valid: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_valid: torch.Tensor,
    cfg: ICPConfig,
    init_pose: torch.Tensor | None = None,
):
    """Estimate the pose T with T∘src ≈ tgt (src in tgt's frame), as
    ``icp_.align`` + ``getFinalTransformation``. Returns (pose (..., 3),
    mean squared error of the last iteration's inliers, their count)."""
    if init_pose is None:
        init_pose = torch.zeros(src_pts.shape[:-2] + (3,),
                                dtype=src_pts.dtype, device=src_pts.device)
    # zero invalid or non-finite beams so the masked reductions stay finite
    zero = torch.zeros((), dtype=src_pts.dtype, device=src_pts.device)
    src_pts = torch.where(
        src_valid[..., None] & torch.isfinite(src_pts), src_pts, zero)
    tgt_pts = torch.where(
        tgt_valid[..., None] & torch.isfinite(tgt_pts), tgt_pts, zero)
    max_d2 = cfg.max_correspondence_dist**2
    pose = init_pose
    for _ in range(cfg.max_iterations):
        src_w = geo.apply(pose, src_pts)
        idx, d2 = nearest_neighbor_auto(src_w, tgt_pts, tgt_valid)
        w = (src_valid & (d2 < max_d2)).to(src_pts.dtype)
        delta = procrustes_step(src_w, _take_rows(tgt_pts, idx), w)
        pose = geo.compose(delta, pose)
        n = torch.sum(w, dim=-1)
        err = torch.sum(w * d2, dim=-1) / torch.clamp(n, min=1.0)
    return pose, err, n
