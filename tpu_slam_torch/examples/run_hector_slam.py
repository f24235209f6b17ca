"""Hector SLAM end to end (the lesson4 full-SLAM workload) — port of
``examples/run_hector_slam.py``: multi-resolution scan-to-map GN matching
and log-odds mapping, with an ASCII map render.

    python -m tpu_slam_torch.examples.run_hector_slam [--scans 150] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.models.hector_slam import HectorSLAM
from tpu_slam_torch.utils.evaluation import ate_rmse
from tpu_slam_torch.utils.profiling import sync


def example_config():
    """The example's configuration: ``default_config()`` with a 512² map of
    3 levels."""
    cfg = default_config()
    return dataclasses.replace(cfg, hector=dataclasses.replace(
        cfg.hector, map_size=512, map_multi_res_levels=3))


def recipe(cfg, device, n: int = 150):
    """An office circle of ``n`` scans (radius 1.5 m, 0.6 rad/s) in
    office_world(seed=31) with the path kept clear, noise 0.004, seed 3:
    (scans on ``device``, the true poses)."""
    traj = sim.circle_trajectory(n, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=3)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=device)
    return scans, seq.gt_poses


def run(cfg, scans, gt, device) -> dict:
    """One ``HectorSLAM.run`` from the true start pose, timed, with its
    map-frame ATE and map."""
    slam = HectorSLAM(cfg, device=device)
    slam.last_pose = torch.tensor(gt[0], dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    est = slam.run(scans)
    sync(slam.last_pose)
    dt = time.perf_counter() - t0
    m = slam.to_ros_map()
    return {"scans": int(scans.ranges.shape[0]), "s": dt,
            "ate": float(ate_rmse(est, gt, align=False)),
            "occupied": int((m == 100).sum()), "free": int((m == 0).sum()),
            "unknown": int((m == -1).sum()), "estimate": est, "map": m}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", type=int, default=150)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = example_config()
    fig = run(cfg, *recipe(cfg, dev, args.scans), dev)
    n, dt = fig["scans"], fig["s"]
    print(f"{n} scans in {dt:.2f}s "
          f"({1000 * dt / n:.2f} ms/scan incl. map updates)")
    print(f"ATE RMSE (map frame): {fig['ate']:.4f} m")
    print(f"map: {fig['occupied']} occupied / {fig['free']} free / "
          f"{fig['unknown']} unknown cells")
    m = fig["map"]  # ASCII render (downsampled)
    step = max(1, m.shape[0] // 48)
    lut = {100: "#", 0: ".", -1: " "}
    sub = m[::step, ::step]
    print("\n".join("".join(lut[v] for v in row) for row in sub[::2]))
    return fig


if __name__ == "__main__":
    main()
