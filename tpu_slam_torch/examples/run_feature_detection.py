"""Corner-feature detection (the lesson1 workload) — port of
``examples/run_feature_detection.py``: LIO-SAM curvature over the
valid-compacted beam sequence, 6 sectors, <=20 corners each
(feature_detection.cc:77-179), for every scan of the sequence in one call.

    python -m tpu_slam_torch.examples.run_feature_detection [--cpu]
"""

from __future__ import annotations

import argparse
import time

from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.ops.features import extract_corner_features
from tpu_slam_torch.utils.profiling import sync


def recipe(cfg, device, n: int = 120):
    """``n`` scans of an office circle (radius 1.6 m, 0.5 rad/s) in
    office_world(seed=9) with the path kept clear, noise 0.003, seed 2."""
    traj = sim.circle_trajectory(n, radius=1.6, angular_rate=0.5)
    world = sim.office_world(seed=9, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.003, seed=2)
    return make_scan(seq.ranges, cfg.scan, device=device)


def run(cfg, scans) -> dict:
    """The corner masks of every scan: one warm call, then a timed one."""
    mask = extract_corner_features(scans, cfg.features)
    sync(mask)
    t0 = time.perf_counter()
    mask = extract_corner_features(scans, cfg.features)
    sync(mask)
    dt = time.perf_counter() - t0
    per_scan = mask.sum(-1).cpu().numpy()
    return {"scans": int(mask.shape[0]), "ms": dt * 1e3,
            "mean": float(per_scan.mean()), "min": int(per_scan.min()),
            "max": int(per_scan.max()), "per_scan": per_scan}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = default_config()
    fig = run(cfg, recipe(cfg, dev))
    T = fig["scans"]
    print(f"{T} scans featurized in {fig['ms']:.1f} ms "
          f"({fig['ms'] / T * 1e3:.0f} us/scan)")
    print(f"corners/scan: mean {fig['mean']:.1f} min {fig['min']} "
          f"max {fig['max']}")
    assert fig["mean"] > 4  # office corners are detected
    return fig


if __name__ == "__main__":
    main()
