"""PL-ICP: point-to-line ICP with CSM-style outlier trimming — port of
``tpu_slam/ops/plicp.py``.

This is the plain PyTorch version of the PL-ICP kernel
(``ops/cuda/plicp_fused.py``): per round an exhaustive masked NN, the
better of j1±1 as the second point, two masked-quantile trimming gates,
and two Gauss-Newton steps on frozen correspondences; each pair freezes
at its own epsilons.

As in the reference, each round takes its correspondences from
``nearest_neighbor_auto``: on ``cuda`` that launches the NN kernel. A
caller that holds this function as the PL-ICP kernel's plain version
passes ``nn=nearest_neighbor`` so that nothing in it launches a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import PLICPConfig
from tpu_slam_torch.ops.matching import (
    _take_rows,
    masked_quantiles,
    nearest_neighbor_auto,
    second_point_on_segment,
)


class PLICPResult(NamedTuple):
    pose: torch.Tensor  # (..., 3) transform: tgt_frame ← src_frame
    error: torch.Tensor  # (...,) mean |point-to-line| residual of inliers
    num_inliers: torch.Tensor  # (...,) int32
    covariance: torch.Tensor  # (..., 3, 3) GN covariance σ²·H⁻¹
    converged: torch.Tensor  # (...,) bool — last step below epsilon


def _correspondences(pose, src_pts, src_valid, tgt_pts, tgt_valid, cfg,
                     point_to_line: bool, nn):
    """One correspondence round → (src_w, q1, n, residual, gate)."""
    src_w = geo.apply(pose, src_pts)
    j1, d2 = nn(src_w, tgt_pts, tgt_valid)
    q1 = _take_rows(tgt_pts, j1)
    gate = src_valid & (d2 < cfg.max_correspondence_dist**2)
    gate &= torch.take_along_dim(tgt_valid, j1, dim=-1)
    if point_to_line:
        j2 = second_point_on_segment(j1, src_w, tgt_pts, tgt_valid)
        tang = _take_rows(tgt_pts, j2) - q1
        tlen = torch.linalg.vector_norm(tang, dim=-1)
        gate &= (tlen > 1e-9) & torch.take_along_dim(tgt_valid, j2, dim=-1)
        tang = tang / torch.clamp(tlen, min=1e-9)[..., None]
        n = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)
        resid = torch.sum(n * (src_w - q1), dim=-1)
    else:
        # point-to-point config: the residual is the distance itself, along
        # the unit vector towards q1
        diff = src_w - q1
        dist = torch.linalg.vector_norm(diff, dim=-1)
        n = diff / torch.clamp(dist, min=1e-9)[..., None]
        resid = dist
    return src_w, q1, n, resid, gate


def _trim(resid, gate, cfg):
    """CSM outlier rejection: keep |err| ≤ the maxPerc quantile AND
    |err| ≤ adaptive_mult × the adaptive_order quantile."""
    err = torch.abs(resid)
    q_perc, q_adap = masked_quantiles(
        err, gate, (cfg.outliers_maxPerc, cfg.outliers_adaptive_order)
    )
    thr = torch.minimum(
        q_perc, torch.clamp(cfg.outliers_adaptive_mult * q_adap, min=1e-6)
    )
    return gate & (err <= thr[..., None] + 1e-12)


def _gn_step(pose, src_w, q1, n, w, damping=1e-9):
    """One Gauss-Newton step on Σ w (nᵀ(R p + t − q1))²; returns the new
    pose, the step and the damped normal matrix H."""
    rp = src_w - pose[..., None, :2]
    drot = torch.stack([-rp[..., 1], rp[..., 0]], dim=-1)
    j_th = torch.sum(n * drot, dim=-1)
    J = torch.cat([n, j_th[..., None]], dim=-1)  # (..., N, 3)
    r = torch.sum(n * (src_w - q1), dim=-1)
    Jw = J * w[..., None]
    H = Jw.transpose(-1, -2) @ J
    H = H + damping * torch.eye(3, dtype=H.dtype, device=H.device)
    b = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    delta = torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
    # degenerate-solve guard: too few inliers or a non-finite step → no update
    ok = (torch.sum(w, dim=-1) >= 3) & torch.all(torch.isfinite(delta), dim=-1)
    delta = torch.where(ok[..., None], delta, torch.zeros_like(delta))
    new_pose = torch.stack(
        [
            pose[..., 0] + delta[..., 0],
            pose[..., 1] + delta[..., 1],
            geo.normalize_angle(pose[..., 2] + delta[..., 2]),
        ],
        dim=-1,
    )
    return new_pose, delta, H


def plicp_match(
    src_pts: torch.Tensor,
    src_valid: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_valid: torch.Tensor,
    cfg: PLICPConfig,
    init_pose: torch.Tensor | None = None,
    nn=nearest_neighbor_auto,
) -> PLICPResult:
    """Estimate T with T∘src ≈ tgt (CSM ``sm_icp`` semantics): src is the
    new scan, tgt the reference, the returned pose maps src into tgt's
    frame. Batched over leading axes; runs ``cfg.max_iterations`` rounds,
    each pair freezing once its step is under the epsilons. ``nn`` is the
    correspondence search, (src, tgt, tgt_valid) → (idx, d2)."""
    if init_pose is None:
        init_pose = torch.zeros(
            src_pts.shape[:-2] + (3,), dtype=src_pts.dtype,
            device=src_pts.device,
        )
    p2l = cfg.use_point_to_line_distance
    # invalid beams may carry inf/NaN coordinates: zero them so the masked
    # reductions stay finite (0-weight × inf would still poison the sums)
    zero = torch.zeros((), dtype=src_pts.dtype, device=src_pts.device)
    src_pts = torch.where(
        src_valid[..., None] & torch.isfinite(src_pts), src_pts, zero
    )
    tgt_pts = torch.where(
        tgt_valid[..., None] & torch.isfinite(tgt_pts), tgt_pts, zero
    )

    bshape = init_pose.shape[:-1]
    pose = init_pose
    conv = torch.zeros(bshape, dtype=torch.bool, device=pose.device)
    err = torch.zeros(bshape, dtype=pose.dtype, device=pose.device)
    ninl = torch.zeros(bshape, dtype=torch.int32, device=pose.device)
    H = torch.zeros(bshape + (3, 3), dtype=pose.dtype, device=pose.device)
    for _ in range(cfg.max_iterations):
        src_w, q1, n, resid, gate = _correspondences(
            pose, src_pts, src_valid, tgt_pts, tgt_valid, cfg, p2l, nn
        )
        w = _trim(resid, gate, cfg).to(src_pts.dtype)
        # two inner GN steps with frozen correspondences
        pose1, delta, _ = _gn_step(pose, src_w, q1, n, w)
        pose2, delta2, H2 = _gn_step(
            pose1, geo.apply(pose1, src_pts), q1, n, w
        )
        err2 = torch.sum(w * torch.abs(resid), dim=-1) / torch.clamp(
            torch.sum(w, dim=-1), min=1.0
        )
        step = delta + delta2
        # per-pair termination: converged pairs freeze pose and stats
        pose = torch.where(conv[..., None], pose, pose2)
        err = torch.where(conv, err, err2)
        ninl = torch.where(conv, ninl, torch.sum(w > 0, dim=-1).to(torch.int32))
        H = torch.where(conv[..., None, None], H, H2)
        conv = conv | (
            (torch.abs(step[..., 0]) < cfg.epsilon_xy)
            & (torch.abs(step[..., 1]) < cfg.epsilon_xy)
            & (torch.abs(step[..., 2]) < cfg.epsilon_theta)
        )
    return PLICPResult(
        pose=pose, error=err, num_inliers=ninl,
        covariance=covariance_from_h(H, cfg), converged=conv,
    )


def covariance_from_h(H: torch.Tensor, cfg: PLICPConfig) -> torch.Tensor:
    """Censi-style covariance stand-in: σ²·inv(H + 1e-6·I)."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return cfg.sigma**2 * torch.linalg.inv_ex(H + 1e-6 * eye)[0]
