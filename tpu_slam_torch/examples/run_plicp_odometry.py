"""PL-ICP laser odometry end to end (the lesson3 workload) — port of
``examples/run_plicp_odometry.py``: a simulated office sequence (or a
rosbag with ``--bag``) through the keyframe PL-ICP odometry, with its
ATE, RPE and timing.

    python -m tpu_slam_torch.examples.run_plicp_odometry [--scans 200]
        [--bag FILE --topic laser_scan] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.models.plicp_odometry import PLICPOdometry
from tpu_slam_torch.utils.evaluation import ate_rmse, rpe_rmse


def recipe(cfg, device, n: int = 200):
    """An office circle of ``n`` scans (radius 1.6 m, 0.6 rad/s) in
    office_world(seed=21) with the path kept clear, noise 0.004, seed 4:
    (scans on ``device``, the true poses)."""
    traj = sim.circle_trajectory(n, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=21, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=device)
    return scans, seq.gt_poses


def bag_scans(cfg, path: str, topic: str, device):
    """The LaserScan messages of ``topic`` in a rosbag, stamps from the
    first."""
    from tpu_slam_torch.data.rosbag import parse_messages

    ranges, stamps = [], []
    for _msg, parsed in parse_messages(path, topics={topic}):
        ranges.append(parsed["ranges"])
        stamps.append(parsed["stamp"])
    stamps = np.asarray(stamps) - stamps[0]
    return make_scan(np.asarray(ranges), cfg.scan,
                     stamp=stamps.astype(np.float32), device=device)


def run(cfg, scans, gt, device) -> dict:
    """One ``PLICPOdometry.run``, timed, with its ATE and RPE where the
    truth is known."""
    odom = PLICPOdometry(cfg, device=device)
    t0 = time.perf_counter()
    est = odom.run(scans)
    dt = time.perf_counter() - t0
    fig = {"scans": int(scans.ranges.shape[0]), "s": dt, "estimate": est,
           "final_pose": est[-1]}
    if gt is not None:
        fig.update(ate=float(ate_rmse(est, gt)), rpe=float(rpe_rmse(est, gt)))
    return fig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bag", help="rosbag with a laser_scan topic")
    ap.add_argument("--topic", default="laser_scan")
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = default_config()
    if args.bag:
        scans, gt = bag_scans(cfg, args.bag, args.topic, dev), None
        print(f"loaded {scans.ranges.shape[0]} scans from {args.bag}")
    else:
        scans, gt = recipe(cfg, dev, args.scans)
    fig = run(cfg, scans, gt, dev)
    n, dt = fig["scans"], fig["s"]
    print(f"processed {n} scans in {dt:.2f}s ({1000 * dt / n:.2f} ms/scan)")
    if gt is not None:
        print(f"ATE RMSE: {fig['ate']:.4f} m")
        print(f"RPE RMSE: {fig['rpe']:.4f} m")
    print(f"final pose: {fig['final_pose'].round(3)}")
    return fig


if __name__ == "__main__":
    main()
