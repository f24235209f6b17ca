"""Synthetic 2D LiDAR world simulator (host-side, numpy) — the port's own
copy of ``tpu_slam/data/simulator.py``; the same seeds give the same arrays.

The reference validates by replaying recorded bags (`lesson1.bag`,
`lesson3.bag`, `lesson5.bag` — listed in the reference's
`.MISSING_LARGE_BLOBS`, i.e. not shipped). This module is the substitute data
source: a segment world + exact raycaster + trajectory generator that yields
scans, IMU, and wheel-odometry streams with ground truth, so every workload in
BASELINE.json (ICP / PL-ICP odometry / undistortion / Hector / Karto loop
closure) has an ATE-checkable input.

Everything here is deliberately numpy (host data pipeline, SURVEY §1 L0); the
device pipeline consumes the produced arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpu_slam_torch.config import ScanConfig


@dataclasses.dataclass
class World:
    """A 2D world of line-segment walls, shape (S, 4) as [x1, y1, x2, y2]."""

    segments: np.ndarray

    @staticmethod
    def box(xmin=-5.0, ymin=-5.0, xmax=5.0, ymax=5.0) -> "World":
        return World(
            np.array(
                [
                    [xmin, ymin, xmax, ymin],
                    [xmax, ymin, xmax, ymax],
                    [xmax, ymax, xmin, ymax],
                    [xmin, ymax, xmin, ymin],
                ],
                dtype=np.float64,
            )
        )

    def add_box(self, xmin, ymin, xmax, ymax) -> "World":
        extra = np.array(
            [
                [xmin, ymin, xmax, ymin],
                [xmax, ymin, xmax, ymax],
                [xmax, ymax, xmin, ymax],
                [xmin, ymax, xmin, ymin],
            ],
            dtype=np.float64,
        )
        return World(np.concatenate([self.segments, extra], axis=0))

    def add_segment(self, x1, y1, x2, y2) -> "World":
        extra = np.array([[x1, y1, x2, y2]], dtype=np.float64)
        return World(np.concatenate([self.segments, extra], axis=0))


def office_world(
    seed: int = 0,
    size: float = 10.0,
    n_boxes: int = 8,
    clear_path: np.ndarray | None = None,
    clearance: float = 0.6,
) -> World:
    """A feature-rich room: outer walls + random box obstacles.

    Rich in corners so scan matching is well-conditioned (the reference's
    PL-ICP is known to fail in feature-poor corridors, README.md:100).

    clear_path: optional (T, >=2) trajectory whose xy must stay at least
    ``clearance`` away from every obstacle (rejection sampling), so the
    robot never drives through a box.
    """
    rng = np.random.default_rng(seed)
    h = size / 2
    w = World.box(-h, -h, h, h)
    path = None if clear_path is None else np.asarray(clear_path)[:, :2]
    placed = 0
    for _ in range(n_boxes * 20):
        if placed >= n_boxes:
            break
        cx, cy = rng.uniform(-h + 1.5, h - 1.5, size=2)
        if path is None and abs(cx) < 1.2 and abs(cy) < 1.2:
            cx += 2.0  # keep spawn area clear
        bw, bh = rng.uniform(0.3, 1.0, size=2)
        if path is not None:
            half_diag = 0.5 * math.hypot(bw, bh)
            d = np.hypot(path[:, 0] - cx, path[:, 1] - cy).min()
            if d < clearance + half_diag:
                continue
        w = w.add_box(cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2)
        placed += 1
    return w


def corridor_loop_world(arm: float = 12.0, width: float = 2.4) -> World:
    """A square corridor loop — the canonical loop-closure workload
    (lesson6 outdoor bag analogue)."""
    h = arm / 2
    wi = h - width
    w = World.box(-h, -h, h, h)
    w = w.add_box(-wi, -wi, wi, wi)
    # some clutter for matchability along each arm
    for i, (cx, cy) in enumerate(
        [(0, h - 0.4), (h - 0.4, 0), (0, -(h - 0.4)), (-(h - 0.4), 0.8)]
    ):
        w = w.add_box(cx - 0.15, cy - 0.15, cx + 0.15, cy + 0.15)
    return w


def raycast(world: World, origins: np.ndarray, angles: np.ndarray,
            range_max: float) -> np.ndarray:
    """Exact ray–segment intersection, vectorized over beams.

    origins: (B, 2) ray origins; angles: (B,) world-frame beam angles.
    Returns (B,) ranges; beams that hit nothing get +inf.
    """
    seg = world.segments
    p = seg[:, 0:2][None, :, :]  # (1, S, 2)
    pq = (seg[:, 2:4] - seg[:, 0:2])[None, :, :]  # (1, S, 2)
    o = origins[:, None, :]  # (B, 1, 2)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)[:, None, :]

    po = p - o  # (B, S, 2)
    denom = d[..., 0] * pq[..., 1] - d[..., 1] * pq[..., 0]  # cross(d, pq)
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (po[..., 0] * pq[..., 1] - po[..., 1] * pq[..., 0]) / denom
    u = (po[..., 0] * d[..., 1] - po[..., 1] * d[..., 0]) / denom
    hit = (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    r = np.nanmin(np.where(np.isnan(t), np.inf, t), axis=1)
    return np.where(r <= range_max, r, np.inf)


def circle_trajectory(n: int, radius: float = 2.0, dt: float = 0.1,
                      angular_rate: float = 0.25) -> np.ndarray:
    """Poses (n, 3) along a circle, heading tangent to motion."""
    t = np.arange(n) * dt * angular_rate
    x = radius * np.cos(t)
    y = radius * np.sin(t)
    th = t + math.pi / 2
    return np.stack([x, y, np.arctan2(np.sin(th), np.cos(th))], axis=-1)


def waypoint_trajectory(waypoints: np.ndarray, speed: float = 0.5,
                        turn_rate: float = 0.8, dt: float = 0.1) -> np.ndarray:
    """Drive through waypoints with a unicycle model → poses (n, 3)."""
    poses = []
    x, y = waypoints[0]
    th = math.atan2(
        waypoints[1][1] - y, waypoints[1][0] - x
    )
    for wx, wy in waypoints[1:]:
        for _ in range(10000):
            dx, dy = wx - x, wy - y
            dist = math.hypot(dx, dy)
            if dist < 0.15:
                break
            target = math.atan2(dy, dx)
            err = math.atan2(math.sin(target - th), math.cos(target - th))
            w = np.clip(err / dt, -turn_rate, turn_rate)
            v = speed * max(0.2, math.cos(err))
            th = th + w * dt
            x += v * math.cos(th) * dt
            y += v * math.sin(th) * dt
            poses.append((x, y, math.atan2(math.sin(th), math.cos(th))))
    return np.array(poses, dtype=np.float64)


def loop_trajectory(arm: float = 12.0, width: float = 2.4, speed: float = 0.6,
                    dt: float = 0.1) -> np.ndarray:
    """A closed loop around the corridor world, revisiting the start."""
    m = (arm / 2 + (arm / 2 - width)) / 2  # corridor centerline
    wps = np.array(
        [
            [-m, -m], [m, -m], [m, m], [-m, m], [-m, -m], [0.0, -m],
        ]
    )
    return waypoint_trajectory(wps, speed=speed, dt=dt)


@dataclasses.dataclass
class SimulatedSequence:
    """Everything a bag would contain, with ground truth attached."""

    ranges: np.ndarray  # (T, N) float32, inf = no return
    angles: np.ndarray  # (N,)
    stamps: np.ndarray  # (T,)
    gt_poses: np.ndarray  # (T, 3) sensor pose at scan start time
    imu_stamps: np.ndarray  # (Ti,)
    imu_omega: np.ndarray  # (Ti,) yaw rate
    odom_stamps: np.ndarray  # (To,)
    odom_poses: np.ndarray  # (To, 3) wheel odometry (optionally drifted)
    scan_config: ScanConfig = None


def simulate_sequence(
    world: World,
    gt_poses: np.ndarray,
    cfg: ScanConfig,
    noise_std: float = 0.005,
    seed: int = 0,
    motion_distortion: bool = False,
    imu_rate_hz: float = 100.0,
    odom_rate_hz: float = 50.0,
    odom_drift: float = 0.0,
) -> SimulatedSequence:
    """Render a full sensor sequence along a trajectory.

    With ``motion_distortion=True`` each beam is cast from the interpolated
    pose at its own timestamp — reproducing the rolling-shutter effect that
    lesson5's `LidarUndistortion` corrects (lidar_undistortion.cc:339-463).
    """
    rng = np.random.default_rng(seed)
    T = gt_poses.shape[0]
    N = cfg.num_beams
    dt = cfg.scan_period
    stamps = np.arange(T) * dt
    beam_angles = cfg.angle_min + cfg.angle_increment * np.arange(N)
    beam_dt = dt / N

    # dense pose interpolation helper over the trajectory timeline
    def pose_at(ts: np.ndarray) -> np.ndarray:
        ts = np.clip(ts, stamps[0], stamps[-1])
        idx = np.clip(np.searchsorted(stamps, ts, side="right") - 1, 0, T - 2)
        a = gt_poses[idx]
        b = gt_poses[idx + 1]
        alpha = ((ts - stamps[idx]) / dt)[..., None]
        dth = np.arctan2(
            np.sin(b[..., 2] - a[..., 2]), np.cos(b[..., 2] - a[..., 2])
        )[..., None]
        out = a + alpha * np.concatenate(
            [b[..., :2] - a[..., :2], dth], axis=-1
        )
        out[..., 2] = np.arctan2(np.sin(out[..., 2]), np.cos(out[..., 2]))
        return out

    ranges = np.empty((T, N), dtype=np.float64)
    for t in range(T):
        if motion_distortion:
            bt = stamps[t] + beam_dt * np.arange(N)
            poses = pose_at(bt)  # (N, 3)
        else:
            poses = np.broadcast_to(gt_poses[t], (N, 3))
        world_angles = poses[:, 2] + beam_angles
        r = raycast(world, poses[:, :2], world_angles, cfg.range_max)
        ranges[t] = r
    finite = np.isfinite(ranges)
    ranges[finite] += rng.normal(0.0, noise_std, size=finite.sum())

    # IMU: yaw rate from finite differences of gt heading
    ti = np.arange(stamps[0], stamps[-1], 1.0 / imu_rate_hz)
    eps = 1e-3
    th0 = pose_at(ti - eps)[:, 2]
    th1 = pose_at(ti + eps)[:, 2]
    omega = np.arctan2(np.sin(th1 - th0), np.cos(th1 - th0)) / (2 * eps)
    omega += rng.normal(0.0, 0.002, size=omega.shape)

    # wheel odometry: gt poses (optionally with slow drift) at odom rate
    to = np.arange(stamps[0], stamps[-1], 1.0 / odom_rate_hz)
    op = pose_at(to)
    if odom_drift > 0.0:
        drift = np.cumsum(
            rng.normal(0.0, odom_drift, size=(op.shape[0], 3)), axis=0
        )
        drift[:, 2] *= 0.1
        op = op + drift
    return SimulatedSequence(
        ranges=ranges.astype(np.float32),
        angles=beam_angles.astype(np.float32),
        stamps=stamps,
        gt_poses=gt_poses,
        imu_stamps=ti,
        imu_omega=omega,
        odom_stamps=to,
        odom_poses=op,
        scan_config=cfg,
    )
