"""IMU + wheel-odometry motion-distortion correction (lesson 5) — port of
``tpu_slam/ops/undistort.py``.

The whole correction is one vectorised program over a scan batch:
  * IMU yaw-rate integration into a rotation timeline (trapezoidal
    cumulative sum, linear interpolation at the beam times);
  * the odometry's start/end translation increment (pose interpolation at
    the scan window's ends);
  * each point rotated and shifted into the frame of the first beam.
The IMU and odometry streams are 1-D timelines shared by the batch.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.data.scan import Scan


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` for increasing 1-D ``xp``: linear interpolation of
    (xp, fp) at x, clamped to fp[0] below xp[0] and to fp[-1] above
    xp[-1], with the reference's segment choice (the last sample ≤ x,
    by a right-sided search) and its guard on zero-width segments."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # the spacing of eps (eps is a power of two, so its ulp is eps²)
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def integrate_imu_rotation(imu_stamps: torch.Tensor, imu_omega: torch.Tensor,
                           query_times: torch.Tensor) -> torch.Tensor:
    """Integrated yaw at ``query_times`` relative to the stream start:
    trapezoidal integration of the angular rate."""
    seg = 0.5 * (imu_omega[1:] + imu_omega[:-1]) * torch.diff(imu_stamps)
    cum = torch.cat([torch.zeros_like(seg[:1]), torch.cumsum(seg, dim=0)])
    return interp(query_times, imu_stamps, cum)


def interp_pose_timeline(stamps: torch.Tensor, poses: torch.Tensor,
                         query_times: torch.Tensor) -> torch.Tensor:
    """Linear SE(2) interpolation of a pose timeline at query times; the
    heading goes through its unit vector, so it survives ±π wraps."""
    x = interp(query_times, stamps, poses[:, 0])
    y = interp(query_times, stamps, poses[:, 1])
    c = interp(query_times, stamps, torch.cos(poses[:, 2]))
    s = interp(query_times, stamps, torch.sin(poses[:, 2]))
    return torch.stack([x, y, torch.atan2(s, c)], dim=-1)


def undistort_scan(
    scan: Scan,
    imu_stamps: torch.Tensor,
    imu_omega: torch.Tensor,
    odom_stamps: torch.Tensor,
    odom_poses: torch.Tensor,
    use_imu: bool = True,
    use_odom: bool = True,
) -> torch.Tensor:
    """Corrected scan points (..., N, 2) in the first-beam frame; invalid
    beams at 0. Per beam i at time t_i in the window [t_0, t_end]:
    rotation dθ_i = ∫ω dt over [t_0, t_i], translation
    d_i = ratio_i · (odom(t_end) ⊖ odom(t_0)).xy, and the corrected point
    R(dθ_i)·p_i + d_i."""
    bt = scan.beam_times()
    t0 = scan.stamp
    if use_imu:
        base = integrate_imu_rotation(imu_stamps, imu_omega, t0[..., None])
        rot = integrate_imu_rotation(imu_stamps, imu_omega, bt) - base
    else:
        rot = torch.zeros_like(bt)
    if use_odom:
        t_end = bt[..., -1]
        start = interp_pose_timeline(odom_stamps, odom_poses, t0)
        end = interp_pose_timeline(odom_stamps, odom_poses, t_end)
        inc = geo.relative(start, end)
        ratio = (bt - t0[..., None]) / torch.clamp(
            (t_end - t0)[..., None], min=1e-9)
        trans = ratio[..., None] * inc[..., None, :2]
    else:
        trans = torch.zeros(bt.shape + (2,), dtype=scan.ranges.dtype,
                            device=bt.device)
    pts = scan.points()
    c, s = torch.cos(rot), torch.sin(rot)
    x = c * pts[..., 0] - s * pts[..., 1] + trans[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + trans[..., 1]
    out = torch.stack([x, y], dim=-1)
    return torch.where(scan.valid[..., None], out, 0.0)


def undistorted_ranges(points: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Ranges re-derived from corrected points (for republishing as a
    scan); invalid beams at +inf."""
    r = torch.linalg.vector_norm(points, dim=-1)
    return torch.where(valid, r, torch.full_like(r, float("inf")))
