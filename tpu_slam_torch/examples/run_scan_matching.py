"""Frame-to-frame scan matching (the lesson2/lesson3 workloads) — port of
``examples/run_scan_matching.py``: the point-to-point ICP against PL-ICP
comparison the reference builds its tutorial around. The reference
measures PCL ICP at ~0.12 s/frame (scan_match_icp.cc:135-164) and CSM
PL-ICP at ~0.5 ms/frame (scan_match_plicp.cc:38-300); here each matches
every pair of the sequence in one batched call, PL-ICP through the PL-ICP
kernel on the card.

    python -m tpu_slam_torch.examples.run_scan_matching [--frames 120] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import default_config
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.examples import device_of
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.icp import icp_match
from tpu_slam_torch.utils.profiling import sync


def masked_pairs(scans):
    """Consecutive pairs of a scan batch as the matchers take them: (src,
    src_valid, tgt, tgt_valid), invalid points at 0, each contiguous."""
    pts = torch.where(scans.valid[..., None], scans.points(), 0.0)
    return (pts[1:].contiguous(), scans.valid[1:].contiguous(),
            pts[:-1].contiguous(), scans.valid[:-1].contiguous())


def recipe(cfg, device, frames: int = 120):
    """``frames`` consecutive pairs of an office circle (office_world(seed=
    11), radius 1.6 m, 0.6 rad/s, noise 0.004, seed 4): (the pairs on
    ``device``, the true deltas (B, 3) in the sensor frame)."""
    traj = sim.circle_trajectory(frames + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    scans = make_scan(seq.ranges, cfg.scan, device=device)
    return masked_pairs(scans), gnp.relative(seq.gt_poses[:-1],
                                             seq.gt_poses[1:])


def delta_rmse(est: np.ndarray, gt: np.ndarray) -> tuple:
    """(translation m, rotation rad) RMSE of estimated deltas."""
    err = est.astype(np.float64) - gt
    err[:, 2] = np.arctan2(np.sin(err[:, 2]), np.cos(err[:, 2]))
    return (float(np.sqrt((err[:, :2] ** 2).mean())),
            float(np.sqrt((err[:, 2] ** 2).mean())))


MATCHERS = {
    "icp": ("point-to-point ICP (lesson2)",
            lambda cfg, pairs: icp_match(*pairs, cfg.icp)[0]),
    "plicp": ("PL-ICP (lesson3)",
              lambda cfg, pairs: plicp_match_fused(*pairs, cfg.plicp).pose),
}


def run(cfg, pairs, gt_d) -> dict:
    """Each matcher on every pair in one call (a warm call, then a timed
    one): its ms and its delta RMSE against the truth."""
    fig = {"frames": int(gt_d.shape[0])}
    for name, (_label, fn) in MATCHERS.items():
        sync(fn(cfg, pairs))
        t0 = time.perf_counter()
        pose = fn(cfg, pairs)
        est = pose.cpu().numpy()
        dt = time.perf_counter() - t0
        trans, rot = delta_rmse(est, gt_d)
        fig[name] = {"ms": dt * 1e3, "trans": trans, "rot": rot,
                     "estimate": est}
    return fig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = default_config()
    fig = run(cfg, *recipe(cfg, dev, args.frames))
    B = fig["frames"]
    for name, (label, _fn) in MATCHERS.items():
        r = fig[name]
        print(f"{label}: {B} frames in {r['ms']:.1f} ms "
              f"({r['ms'] / B:.3f} ms/frame); "
              f"delta RMSE trans {r['trans']:.4f} m, rot {r['rot']:.4f} rad")
    return fig


if __name__ == "__main__":
    main()
