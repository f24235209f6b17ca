"""GMapping-style occupancy map building (the lesson4 gmapping workload)
— port of ``examples/run_gmapping.py``: hit/visit counters per cell,
occupied iff hits/visits > 0.25 (gmapping.cc:146-158), at the true poses.

    python -m tpu_slam_torch.examples.run_gmapping [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.models.gmapping import GMapping


def recipe(cfg, device, n: int | None = None):
    """The corridor loop (arm 9 m, width 2.6 m, 0.9 m/s; its first ``n``
    scans, all 352 by default), noise 0.004, seed 6: (scans on ``device``,
    the true poses in float32)."""
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:n]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=6)
    return (make_scan(seq.ranges, cfg.scan, device=device),
            seq.gt_poses.astype(np.float32))


def run(cfg, scans, poses, device) -> dict:
    """One map of the scans at their poses, timed with the map's read."""
    t0 = time.perf_counter()
    gm = GMapping(cfg, device=device)
    gm.run(scans, poses)
    m = np.asarray(gm.to_ros_map())
    dt = time.perf_counter() - t0
    return {"scans": int(scans.ranges.shape[0]), "s": dt,
            "shape": m.shape, "occupied": int((m == 100).sum()),
            "free": int((m == 0).sum()), "unknown": int((m == -1).sum()),
            "map": m}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = default_config()
    fig = run(cfg, *recipe(cfg, dev), dev)
    T, dt = fig["scans"], fig["s"]
    print(f"{T} scans -> {fig['shape']} map in {dt:.2f}s "
          f"({dt / T * 1e3:.2f} ms/scan; reference: 390-410 ms/scan)")
    print(f"cells: {fig['occupied']} occupied / {fig['free']} free / "
          f"{fig['unknown']} unknown")
    assert fig["occupied"] > 200 and fig["free"] > 10_000
    return fig


if __name__ == "__main__":
    main()
