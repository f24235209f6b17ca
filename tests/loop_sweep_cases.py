"""Pose sets and the corridor mission for the loop-candidate sweep's tests:
``test_torch_loop_sweep.py`` on the CPU and ``test_torch_loop_sweep_card.py``
on the card. Built from the port's copies alone: this module imports no
JAX."""

import dataclasses
import functools
import math

import numpy as np

from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan


def walk(rng, T, step, extent):
    """A random walk of T poses with steps of ``step`` m, folded into a
    square of side ``extent`` so that it revisits."""
    xy = np.cumsum(rng.normal(0, step, (T, 2)), axis=0)
    xy = np.abs((xy + extent) % (2 * extent) - extent)
    return np.concatenate([xy, rng.uniform(-3, 3, (T, 1))], axis=1)


def laps(rng, n, noise):
    """``n`` laps of a 9 m square at 9 cm a scan, with pose noise."""
    s = np.arange(0, 36.0, 0.09)
    side, t = np.divmod(s, 9.0)
    corners = np.array([[0, 0], [9, 0], [9, 9], [0, 9], [0, 0]], float)
    xy = (corners[side.astype(int)] + (corners[side.astype(int) + 1]
                                       - corners[side.astype(int)])
          * (t / 9.0)[:, None])
    xy = np.tile(xy, (n, 1)) - 4.5
    return np.concatenate([xy + rng.normal(0, noise, xy.shape),
                           np.zeros((len(xy), 1))], axis=1)


@functools.lru_cache(maxsize=None)
def corridor_mission(device="cpu"):
    """tests/test_offline.py's corridor mission (128 beams, a lap and a
    half side) with its drifting odometry: (config, scans on ``device``,
    true poses, odometry)."""
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, num_beams=128, range_max=6.0,
                                 range_threshold=5.0),
        offline=dataclasses.replace(
            cfg.offline, max_candidates=6, seeds_xy=3, seeds_theta=3,
            seed_xy=0.5, seed_theta=math.radians(12.0), rounds=2,
            loop_min_gap=40))
    arm, width = 6.0, 2.2
    m = (arm / 2 + (arm / 2 - width)) / 2
    wps = np.array([[-m, -m], [m, -m], [m, m], [-m, m], [-m, -m], [0.0, -m]])
    traj = sim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    world = sim.corridor_loop_world(arm=arm, width=width)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=5)
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = gnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.01, 2)
        d[2] += rng.normal(0, 0.002)
        odom.append(gnp.compose(odom[-1], d))
    scans = make_scan(seq.ranges, cfg.scan, device=device)
    return cfg, scans, seq.gt_poses, np.asarray(odom)


def poses_case(name):
    """The (T, 3) poses of the case ``name``, from a generator seeded by
    the name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("corridor_"):
        _cfg, _scans, gt, odom = corridor_mission()
        if name == "corridor_true":
            return gt
        if name == "corridor_odom":
            return odom
        if name == "corridor_noisy":
            return gt + rng.normal(0, 0.05, gt.shape)
    if name == "laps_exact":
        return laps(rng, 3, 0.0)
    if name == "laps_noisy":
        return laps(rng, 3, 0.05)
    if name == "random_ragged":  # T not a multiple of the NMS gap
        return walk(rng, 517, 0.3, 4.0)
    if name == "blockwise":  # past the reference's 2,048-column blocks
        return walk(rng, 2300, 0.25, 6.0) + 7.0
    if name == "duplicates":  # scans k, k + 30, k + 60 at one place
        poses = np.zeros((90, 3))
        poses[:, 0] = 0.5 * (np.arange(90) % 30)
        return poses
    if name == "all_near":  # every pair in the radius: past the smem sort
        return rng.uniform(-0.5, 0.5, (1500, 3))
    if name == "long":  # a 1,440,000-cell grid
        return walk(rng, 12_000, 0.2, 30.0)
    raise KeyError(name)


def tried_for(poses, kind, sweep):
    """No pairs for ``kind`` "none"; else every other pair that
    ``sweep(poses)`` picks with nothing tried, and pairs that are no
    candidate: (0, 1) inside the gap, (5, 3) with i > j, (2, T - 1)."""
    if kind == "none":
        return set()
    return set(sweep(poses)[::2]) | {(0, 1), (5, 3), (2, len(poses) - 1)}
