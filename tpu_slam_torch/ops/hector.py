"""Hector scan-to-map Gauss-Newton matcher — port of
``tpu_slam/ops/hector.py``, and the plain PyTorch version of the
``csrc/hector_fused.cu`` kernel.

Bilinear map value and gradient at each beam endpoint, per-beam H (3×3)
and dTr accumulation, GN steps with the ±``max_rot_step`` clamp, coarse
to fine over the pyramid. Matching runs in map coords: poses and points
are scaled by 1/resolution, so the GN state is in cells.

The 3×3 step is the closed cofactor form of the JAX package's fused
kernel (``tpu_slam/ops/pallas/hector_fused.py::_solve3``): a singular H
gives a zero step, where ``torch.linalg.solve`` would raise and
``jnp.linalg.solve`` returns non-finite values that ``gn_step`` then
masks. Both end in the same pose.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import GridConfig, HectorConfig


def interp_map_with_derivs(prob_flat: torch.Tensor, size_x: int,
                           size_y: int, coords: torch.Tensor):
    """Bilinear occupancy probability and (d/dx, d/dy) at fractional cell
    coords (..., 2). Out of bounds → (0, 0, 0)."""
    x, y = coords[..., 0], coords[..., 1]
    # the bounds test is on the float coords against [0, size-1)
    inb = (x >= 0.0) & (y >= 0.0) & (x < size_x - 1) & (y < size_y - 1)
    # clamped as floats, so that ±inf and NaN (masked by inb) index safely
    x0 = torch.floor(x).nan_to_num(0.0).clamp(0, size_x - 2).to(torch.int64)
    y0 = torch.floor(y).nan_to_num(0.0).clamp(0, size_y - 2).to(torch.int64)
    fx = x - x0.to(coords.dtype)
    fy = y - y0.to(coords.dtype)

    base = y0 * size_x + x0
    p00 = prob_flat[base]
    p10 = prob_flat[base + 1]
    p01 = prob_flat[base + size_x]
    p11 = prob_flat[base + size_x + 1]

    xi, yi = 1.0 - fx, 1.0 - fy
    val = (p00 * xi + p10 * fx) * yi + (p01 * xi + p11 * fx) * fy
    dx = -((p00 - p10) * yi + (p01 - p11) * fy)
    dy = -((p00 - p01) * xi + (p10 - p11) * fx)
    zero = torch.zeros_like(val)
    return (torch.where(inb, val, zero), torch.where(inb, dx, zero),
            torch.where(inb, dy, zero))


def hessian_derivs(prob_flat, size_x: int, size_y: int,
                   pose_map: torch.Tensor, pts_map: torch.Tensor,
                   valid: torch.Tensor):
    """H (..., 3, 3) and dTr (..., 3) for the pose in map coords."""
    pw = geo.apply(pose_map, pts_map)
    # query at cell centres: the rasterizer stores cell [i, i+1) values
    val, dx, dy = interp_map_with_derivs(prob_flat, size_x, size_y,
                                         pw - 0.5)
    w = valid.to(pts_map.dtype)
    c = torch.cos(pose_map[..., 2])[..., None]
    s = torch.sin(pose_map[..., 2])[..., None]
    rot = ((-s * pts_map[..., 0] - c * pts_map[..., 1]) * dx
           + (c * pts_map[..., 0] - s * pts_map[..., 1]) * dy)
    J = torch.stack([dx * w, dy * w, rot * w], dim=-1)  # (..., N, 3)
    dTr = torch.einsum("...ni,...n->...i", J, 1.0 - val)
    H = torch.einsum("...ni,...nj->...ij", J, J)
    return H, dTr


def solve3(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(H + 1e-9·I)⁻¹ b for symmetric (..., 3, 3) H by cofactors; 0 where
    the determinant is 0."""
    h00 = H[..., 0, 0] + 1e-9
    h11 = H[..., 1, 1] + 1e-9
    h22 = H[..., 2, 2] + 1e-9
    h01, h02, h12 = H[..., 0, 1], H[..., 0, 2], H[..., 1, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    det = h00 * c00 + h01 * c01 + h02 * c02
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    nz = det != 0.0
    inv = 1.0 / torch.where(nz, det, torch.ones_like(det))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    d = torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) * inv,
                     (c01 * b0 + c11 * b1 + c12 * b2) * inv,
                     (c02 * b0 + c12 * b1 + c22 * b2) * inv], dim=-1)
    return torch.where(nz[..., None], d, torch.zeros_like(d))


def gn_step(prob_flat, size_x, size_y, pose_map, pts_map, valid,
            max_rot_step: float):
    """One GN step: returns (pose_map + δ, H)."""
    H, dTr = hessian_derivs(prob_flat, size_x, size_y, pose_map, pts_map,
                            valid)
    ok = (H[..., 0, 0] != 0.0) & (H[..., 1, 1] != 0.0)
    delta = solve3(H, dTr)
    fin = torch.isfinite(delta).all(dim=-1)
    dth = torch.clamp(delta[..., 2], -max_rot_step, max_rot_step)
    delta = torch.cat([delta[..., :2], dth[..., None]], dim=-1)
    delta = torch.where((ok & fin)[..., None], delta,
                        torch.zeros_like(delta))
    return pose_map + delta, H


def match_level(prob_flat, size_x: int, size_y: int, pose_map, pts_map,
                valid, iterations: int, max_rot_step: float = 0.2):
    """1 + ``iterations`` GN steps at one pyramid level. Returns
    (pose_map with its angle wrapped, H of the last step)."""
    H = None
    for _ in range(iterations + 1):
        pose_map, H = gn_step(prob_flat, size_x, size_y, pose_map, pts_map,
                              valid, max_rot_step)
    pose_map = torch.cat([pose_map[..., :2],
                          geo.normalize_angle(pose_map[..., 2])[..., None]],
                         dim=-1)
    return pose_map, H


def likelihood_for_state(prob_flat, size_x: int, size_y: int, pose_map,
                         pts_map, valid):
    """Scan likelihood of a map-coords pose, 1 − Σ(1 − M)/N over the valid
    beams; broadcasts over leading pose axes."""
    pw = geo.apply(pose_map, pts_map)
    val, _, _ = interp_map_with_derivs(prob_flat, size_x, size_y, pw - 0.5)
    w = valid.to(pts_map.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    resid = (w * (1.0 - val)).sum(-1)
    return 1.0 - resid / n


def sampling_covariance(prob_flat, size_x: int, size_y: int,
                        pose_map: torch.Tensor, pts_map: torch.Tensor,
                        valid: torch.Tensor, delta_trans: float = 1.5,
                        delta_ang: float = 0.05):
    """Likelihood-weighted covariance of 7 sigma poses (±Δxy in map cells,
    ±Δθ, centre) around the pose, in map coordinates. All-zero
    likelihoods give uniform weights."""
    x, y, a = pose_map[..., 0], pose_map[..., 1], pose_map[..., 2]
    sig = torch.stack([
        torch.stack([x + delta_trans, y, a], -1),
        torch.stack([x - delta_trans, y, a], -1),
        torch.stack([x, y + delta_trans, a], -1),
        torch.stack([x, y - delta_trans, a], -1),
        torch.stack([x, y, a + delta_ang], -1),
        torch.stack([x, y, a - delta_ang], -1),
        pose_map,
    ], dim=-2)  # (..., 7, 3)
    lh = likelihood_for_state(
        prob_flat, size_x, size_y, sig,
        pts_map.expand(sig.shape[:-1] + pts_map.shape[-2:]),
        valid.expand(sig.shape[:-1] + valid.shape[-1:]),
    )  # (..., 7)
    tot = lh.sum(-1, keepdim=True)
    pos = tot > 0.0
    wn = torch.where(pos, lh / torch.where(pos, tot, torch.ones_like(tot)),
                     torch.full_like(lh, 1.0 / 7.0))
    mean = (wn[..., None] * sig).sum(-2)
    d = sig - mean[..., None, :]
    return torch.einsum("...k,...ki,...kj->...ij", wn, d, d)


def world_pose_to_map(cfg: GridConfig, pose: torch.Tensor) -> torch.Tensor:
    """World pose → map-coords pose (xy scaled and offset, θ unchanged)."""
    return torch.stack([(pose[..., 0] - cfg.origin_x) / cfg.resolution,
                        (pose[..., 1] - cfg.origin_y) / cfg.resolution,
                        pose[..., 2]], dim=-1)


def map_pose_to_world(cfg: GridConfig, pose: torch.Tensor) -> torch.Tensor:
    return torch.stack([pose[..., 0] * cfg.resolution + cfg.origin_x,
                        pose[..., 1] * cfg.resolution + cfg.origin_y,
                        pose[..., 2]], dim=-1)


def match_multires(prob_flats: list, grid_cfgs: list,
                   pose_world: torch.Tensor, pts_laser: torch.Tensor,
                   valid: torch.Tensor, hcfg: HectorConfig):
    """Coarse-to-fine match over the pyramid, level L-1 (coarsest) → 0,
    each level's solution the next one's start: ``iterations_coarse`` + 1
    GN steps per coarse level, ``iterations_fine`` + 1 at level 0.

    prob_flats[i]: the flat occupancy-probability grid of level i;
    grid_cfgs[i] its geometry. pts_laser: beam endpoints in the laser
    frame (meters). Returns (pose_world, H of the finest level's last
    step)."""
    pose = pose_world
    H = None
    for lvl in range(len(prob_flats) - 1, -1, -1):
        cfg = grid_cfgs[lvl]
        iters = hcfg.iterations_fine if lvl == 0 else hcfg.iterations_coarse
        pose_map, H = match_level(
            prob_flats[lvl], cfg.size_x, cfg.size_y,
            world_pose_to_map(cfg, pose), pts_laser / cfg.resolution, valid,
            iters, hcfg.max_rot_step,
        )
        pose = map_pose_to_world(cfg, pose_map)
    return pose, H
