"""Karto pose-graph SLAM end to end (the lesson6 workload) — port of
``examples/run_karto_slam.py``: drifting odometry around a corridor loop,
the correlative front end, loop closure, the LM back end, and the map of
the corrected scans.

    python -m tpu_slam_torch.examples.run_karto_slam [--cpu] [--no-loop]
        [--async-backend] [--checkpoint FILE] [--save-map BASE]
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
from tpu_slam_torch.models.karto.occupancy import karto_map
from tpu_slam_torch.models.karto.pipeline import KartoSLAM
from tpu_slam_torch.ops.correlative import atan2f, sincosf
from tpu_slam_torch.utils.evaluation import ate_rmse


def example_config(loop: bool = True, async_backend: bool = False):
    """The example's configuration: 180 beams to 6 m, a 0.02 m search
    step, a 4 m loop search within 3 m, chains of 5."""
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=180, range_max=6.0, range_threshold=5.0),
        correlative=dataclasses.replace(
            cfg.correlative, correlation_search_space_resolution=0.02),
        loop=dataclasses.replace(
            cfg.loop, loop_search_space_dimension=4.0,
            loop_search_maximum_distance=3.0,
            loop_match_minimum_chain_size=5),
        karto=dataclasses.replace(
            cfg.karto, do_loop_closing=loop,
            async_loop_closure=async_backend),
    )


def _compose32(a, b):
    """The reference's ``geometry.compose`` as JAX runs it outside ``jit``:
    float32, every operation rounded on its own, glibc's sin, cos and
    atan2 (``ops/correlative.sincosf``, ``atan2f``). a, b: (3,) float32."""
    s, c = sincosf(a[2:3])
    st, ct = sincosf(a[2:3] + b[2:3])
    return torch.cat([(a[0:1] + c * b[0:1]) - s * b[1:2],
                      (a[1:2] + s * b[0:1]) + c * b[1:2], atan2f(st, ct)])


def _inverse32(a):
    s, c = sincosf(a[2:3])
    sn, cn = sincosf(-a[2:3])
    return torch.cat([-(c * a[0:1] + s * a[1:2]),
                      -((-s) * a[0:1] + c * a[1:2]), atan2f(sn, cn)])


def drifted_odometry(gt, seed: int = 3, trans_sigma: float = 0.02,
                     rot_sigma: float = 0.004) -> np.ndarray:
    """The reference example's drifting wheel odometry, bit for bit: each
    true relative motion plus N(0, σ) noise from default_rng(seed),
    integrated in float32."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    odom = [gt[0].copy()]
    for i in range(1, len(gt)):
        d = _compose32(_inverse32(f32(gt[i - 1])), f32(gt[i])).numpy()
        d[:2] += rng.normal(0, trans_sigma, 2)
        d[2] += rng.normal(0, rot_sigma)
        odom.append(_compose32(f32(odom[-1]), f32(d)).numpy())
    return np.asarray(odom)


def recipe(cfg, device, n: int | None = None):
    """The corridor loop (arm 9 m, width 2.6 m, 0.9 m/s; its first ``n``
    scans, all 352 by default), noise 0.004, seed 8, and the drifting
    odometry: (scans on ``device``, odometry, true poses)."""
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:n]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=device)
    return scans, drifted_odometry(seq.gt_poses), seq.gt_poses


def run(cfg, scans, odom, gt, device) -> dict:
    """One ``KartoSLAM.run``, timed, with its ATE against the truth (and
    the raw odometry's) on the accepted scans, and its map at 0.1 m."""
    slam = KartoSLAM(cfg, device=device)
    t0 = time.perf_counter()
    accepted = slam.run(scans, odom)
    dt = time.perf_counter() - t0
    est = slam.trajectory()
    m, grid = karto_map(slam, resolution=0.1)
    m = np.asarray(m)
    return {"scans": int(scans.ranges.shape[0]), "accepted": len(accepted),
            "s": dt, "closures": slam.loop_closures,
            "edges": slam.solver.num_edges,
            "ate_odom": float(ate_rmse(odom[accepted], gt[accepted])),
            "ate": float(ate_rmse(est, gt[accepted])),
            "shape": m.shape, "occupied": int((m == 100).sum()),
            "free": int((m == 0).sum()), "slam": slam, "estimate": est,
            "map": m, "grid": grid}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument(
        "--async-backend", action="store_true",
        help="dispatch loop-closure solves asynchronously (pipeline "
        "parallelism); the front end keeps matching while the card "
        "optimizes")
    ap.add_argument("--checkpoint", help="save mapper state here when done")
    ap.add_argument(
        "--save-map",
        help="write <base>.pgm + <base>.yaml (ROS map_server format)")
    args = ap.parse_args(argv)
    dev = device_of(args.cpu)
    cfg = example_config(not args.no_loop, args.async_backend)
    fig = run(cfg, *recipe(cfg, dev), dev)
    slam = fig["slam"]
    print(f"{fig['accepted']} scans accepted of {fig['scans']} in "
          f"{fig['s']:.1f}s; {fig['closures']} loop closures, "
          f"{fig['edges']} edges")
    print(f"ATE raw odometry: {fig['ate_odom']:.4f} m")
    print(f"ATE karto SLAM:   {fig['ate']:.4f} m")
    print(f"map {fig['shape']}: {fig['occupied']} occ / {fig['free']} free")
    if args.save_map:
        from tpu_slam_torch.models.karto.occupancy import karto_graph_png
        from tpu_slam_torch.utils.map_io import save_map

        paths = save_map(args.save_map, fig["map"], fig["grid"])
        print(f"map saved: {paths[0]} + {paths[1]}")
        gpath = karto_graph_png(slam, args.save_map + "_graph.png",
                                ros_map=fig["map"], grid=fig["grid"])
        print(f"pose graph saved: {gpath}")
    for ev in slam.events.history[-3:]:
        print(f"  event [{ev.kind}] {ev.message}")
    print("stage timing (host wall incl. device sync):")
    print("  " + slam.timer.report().replace("\n", "\n  "))
    if args.checkpoint:
        from tpu_slam_torch.utils.checkpoint import save_karto

        save_karto(slam, args.checkpoint)
        print(f"checkpoint saved to {args.checkpoint}")
    return fig


if __name__ == "__main__":
    main()
