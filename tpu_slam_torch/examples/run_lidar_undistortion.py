"""Motion-distortion correction end to end (the lesson5 workload) — port
of ``examples/run_lidar_undistortion.py``: a fast-spinning robot renders
rolling-shutter scans; IMU yaw-rate integration and odometry
interpolation undistort every beam into the first-beam frame
(lidar_undistortion.cc:96-463).

    python -m tpu_slam_torch.examples.run_lidar_undistortion [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.ops.undistort import undistort_scan
from tpu_slam_torch.utils.profiling import sync


def recipe(cfg, device, n: int = 80):
    """``n`` rolling-shutter scans on an office circle (radius 1.2 m, 2.0
    rad/s, office_world(seed=21)), no noise, seed 3, IMU at 500 Hz and
    odometry at 200 Hz: (scans on ``device``, the IMU stamps and rates
    and the odometry stamps and poses on ``device``, the sequence)."""
    traj = sim.circle_trajectory(n, radius=1.2, angular_rate=2.0)
    world = sim.office_world(seed=21, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.0, seed=3,
                                motion_distortion=True, imu_rate_hz=500.0,
                                odom_rate_hz=200.0)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=device)
    streams = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                    for a in (seq.imu_stamps, seq.imu_omega, seq.odom_stamps,
                              seq.odom_poses))
    return scans, streams, seq


def first_beam_truth(cfg, raw: torch.Tensor, seq) -> np.ndarray:
    """The ground truth of all scans but the last: each beam's world
    endpoint from its own interpolated true pose, in the frame of the first
    beam (lidar_undistortion.cc:374-393); (T - 1, N, 2). ``raw`` holds the
    laser points on the CPU."""
    n = cfg.scan.num_beams
    out = []
    for t in range(raw.shape[0] - 1):
        bt = seq.stamps[t] + cfg.scan.scan_period / n * np.arange(n)
        i = np.clip(np.searchsorted(seq.stamps, bt, side="right") - 1, 0,
                    len(seq.stamps) - 2)
        alpha = (bt - seq.stamps[i]) / cfg.scan.scan_period
        poses = geo.interpolate(
            *(torch.as_tensor(np.asarray(a, np.float32))
              for a in (seq.gt_poses[i], seq.gt_poses[i + 1], alpha)))
        world = geo.apply(poses, raw[t][:, None, :])[:, 0, :]
        out.append(geo.apply(geo.inverse(poses[0]), world))
    return torch.stack(out).numpy()


def run(cfg, scans, streams, seq) -> dict:
    """The correction of every scan in one call (a warm call, then a timed
    one), and the mean endpoint error against the first-beam truth of the
    raw and of the corrected points."""
    cor = undistort_scan(scans, *streams)
    sync(cor)
    t0 = time.perf_counter()
    cor = undistort_scan(scans, *streams)
    sync(cor)
    dt = time.perf_counter() - t0
    raw = scans.points().cpu()
    truth = first_beam_truth(cfg, raw, seq)
    ok = scans.valid.cpu().numpy()[:-1]
    raw_err = np.linalg.norm(raw.numpy()[:-1] - truth, axis=-1)[ok]
    cor_err = np.linalg.norm(cor.cpu().numpy()[:-1] - truth, axis=-1)[ok]
    return {"scans": int(scans.ranges.shape[0]), "ms": dt * 1e3,
            "raw_err": float(raw_err.mean()),
            "cor_err": float(cor_err.mean()), "corrected": cor}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = default_config()
    fig = run(cfg, *recipe(cfg, dev))
    print(f"{fig['scans']} scans undistorted in {fig['ms']:.1f} ms "
          f"(batched, one call)")
    print(f"mean endpoint error raw:       {fig['raw_err']:.4f} m")
    print(f"mean endpoint error corrected: {fig['cor_err']:.4f} m")
    assert fig["cor_err"] < 0.25 * fig["raw_err"]
    return fig


if __name__ == "__main__":
    main()
