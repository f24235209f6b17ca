"""Unified command-line entry: ``python -m tpu_slam_torch <model> [options]``
— the port's counterpart of ``tpu_slam/cli.py``, with its models, options
and printed lines.

The launch-file replacement (SURVEY §1 L0): pick a pipeline, point it at a
rosbag (or the built-in simulator), optionally override config from YAML
(the rosparam tier), and write maps/checkpoints. Mirrors the reference's
per-lesson launch files (`lessonN/launch/*.launch`) without ROS.

    python -m tpu_slam_torch odometry --bag lesson3.bag --topic laser_scan
    python -m tpu_slam_torch hector   --sim --save-map out/hector
    python -m tpu_slam_torch karto    --sim --config my_params.yaml --cpu

Every model, scan and solver is built on the CUDA card, or on the CPU
with ``--cpu``. Without ``--cpu`` and without a card the run stops with an
error; it does not carry on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE

MODELS = (
    "odometry", "hector", "gmapping", "karto", "offline", "undistort",
    "features",
)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_slam_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--bag", help="rosbag with a LaserScan topic")
    ap.add_argument("--topic", default="laser_scan")
    ap.add_argument(
        "--sim", action="store_true",
        help="use the built-in simulator instead of a bag",
    )
    ap.add_argument("--sim-scans", type=int, default=120)
    ap.add_argument("--config", help="YAML config overrides (rosparam tier)")
    ap.add_argument(
        "--preset",
        help="shipped config preset (e.g. karto_indoor / karto_outdoor — "
        "the reference's mapper_params YAMLs); --config overrides on top",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--save-map", help="write <base>.pgm + <base>.yaml")
    ap.add_argument("--checkpoint", help="karto: save mapper state here")
    ap.add_argument(
        "--async-backend", action="store_true",
        help="karto: dispatch loop-closure solves asynchronously",
    )
    return ap


def device_of(args) -> str:
    """The device every model, scan and solver of the run is built on."""
    return "cpu" if args.cpu else DEFAULT_DEVICE


def _load_scans(args, cfg, dev):
    """Returns (cfg, scans, gt_poses or None, odom or None)."""
    from tpu_slam_torch.data import simulator as sim
    from tpu_slam_torch.data.scan import make_scan

    if args.bag:
        from tpu_slam_torch.data.rosbag import load_scan_array

        ranges, stamps, meta = load_scan_array(args.bag, args.topic)
        scfg = dataclasses.replace(
            cfg.scan,
            num_beams=ranges.shape[1],
            angle_min=meta["angle_min"],
            angle_increment=meta["angle_increment"],
            range_min=meta["range_min"],
            range_max=meta["range_max"],
        )
        cfg = dataclasses.replace(cfg, scan=scfg)
        scans = make_scan(ranges, scfg, stamp=stamps.astype(np.float32),
                          device=dev)
        return cfg, scans, None, None
    # simulator: a drifting-odometry loop, the karto example's workload
    n = args.sim_scans
    traj = sim.circle_trajectory(n, radius=1.8, angular_rate=0.5)
    world = sim.office_world(seed=7, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=2)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32),
                      device=dev)
    return cfg, scans, seq.gt_poses, None


def main(argv=None, out: dict | None = None) -> int:
    """Run one model. ``out``, when given, receives the run's objects
    (``cfg``, ``scans``, ``gt``, ``model``, ``estimate``, and the map
    and its grid where one was made), for callers that check the run."""
    args = _build_parser().parse_args(argv)
    if not args.bag and not args.sim:
        print("need --bag FILE or --sim", file=sys.stderr)
        return 2
    dev = device_of(args)
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the models run on the card; pass --cpu to run "
            "them on the CPU")

    from tpu_slam_torch.config import config_from_yaml, default_config, preset

    cfg = preset(args.preset) if args.preset else default_config()
    if args.config:
        cfg = config_from_yaml(args.config, base=cfg)
    cfg, scans, gt, _ = _load_scans(args, cfg, dev)
    T = int(scans.ranges.shape[0])
    print(f"{T} scans, {cfg.scan.num_beams} beams, model={args.model}")
    out = out if out is not None else {}
    out.update(cfg=cfg, scans=scans, gt=gt)

    ros_map = grid_cfg = None
    t0 = time.perf_counter()

    if args.model == "odometry":
        from tpu_slam_torch.models.plicp_odometry import PLICPOdometry

        model = PLICPOdometry(cfg, device=dev)
        est = model.run(scans)
        _report_traj(est, gt)
    elif args.model == "hector":
        from tpu_slam_torch.models.hector_slam import HectorSLAM

        model = HectorSLAM(cfg, device=dev)
        est = model.run(scans)
        _report_traj(est, gt)
        ros_map, grid_cfg = model.to_ros_map(), model.grid_cfgs[0]
    elif args.model == "gmapping":
        from tpu_slam_torch.models.gmapping import GMapping
        from tpu_slam_torch.models.plicp_odometry import PLICPOdometry

        # the lesson8 node maps from provided poses; odometry supplies them
        est = (
            gt if gt is not None
            else PLICPOdometry(cfg, device=dev).run(scans)
        ).astype(np.float32)
        model = GMapping(cfg, device=dev)
        model.run(scans, est)
        ros_map, grid_cfg = model.to_ros_map(), cfg.grid
    elif args.model == "karto":
        from tpu_slam_torch.models.karto.occupancy import karto_map
        from tpu_slam_torch.models.karto.pipeline import KartoSLAM

        cfg = dataclasses.replace(
            cfg,
            karto=dataclasses.replace(
                cfg.karto, async_loop_closure=args.async_backend
            ),
        )
        out["cfg"] = cfg
        model = KartoSLAM(cfg, device=dev)
        # odometry input: ground truth poses in sim; without a pose source
        # for bags, integrate PL-ICP odometry as the wheel-odom stand-in
        if gt is not None:
            odom = gt
        else:
            from tpu_slam_torch.models.plicp_odometry import PLICPOdometry

            odom = PLICPOdometry(cfg, device=dev).run(scans)
        accepted = model.run(scans, odom)
        est = model.trajectory()
        out.update(accepted=accepted, odom=odom)
        print(
            f"{len(accepted)}/{T} scans accepted, "
            f"{model.loop_closures} loop closures, "
            f"{model.solver.num_edges} edges"
        )
        _report_traj(est, gt[accepted] if gt is not None else None)
        ros_map, grid_cfg = karto_map(model, resolution=cfg.grid.resolution)
        if args.checkpoint:
            from tpu_slam_torch.utils.checkpoint import save_karto

            save_karto(model, args.checkpoint)
            print(f"checkpoint saved to {args.checkpoint}")
    elif args.model == "offline":
        from tpu_slam_torch.models.karto.occupancy import (
            compute_grid_bounds, occupancy_from_scans,
        )
        from tpu_slam_torch.models.offline import offline_slam

        model = offline_slam(scans, cfg, odom=gt)
        est = model.poses
        print(
            f"{len(model.loops)} loop closures"
            f" ({model.candidates_tried} candidates), "
            f"{model.solver.num_edges} edges"
        )
        _report_traj(est, gt)
        grid_cfg = compute_grid_bounds(
            est, cfg.scan.range_threshold, cfg.grid.resolution
        )
        pts = scans.points().cpu().numpy().astype(np.float32)
        pts[~np.isfinite(pts)] = 0.0
        ros_map = occupancy_from_scans(
            grid_cfg, est, pts, scans.ranges.cpu().numpy(),
            cfg.scan.range_threshold,
            min_range=cfg.scan.range_min, max_range=cfg.scan.range_max,
            device=dev,
        )
    elif args.model == "undistort":
        print(
            "undistortion needs IMU/odom streams; see "
            "tpu_slam_torch/ops/undistort.py (undistort_scan) and "
            "tpu_slam_torch/models/offline.py (undistort_mission) for the "
            "whole pipeline"
        )
        return 2
    elif args.model == "features":
        from tpu_slam_torch.ops.features import extract_corner_features

        model = None
        est = extract_corner_features(scans, cfg.features).cpu().numpy()
        print(
            f"corner features: mean {est.sum(-1).mean():.1f} per scan"
        )

    print(f"done in {time.perf_counter() - t0:.1f}s")
    out.update(model=model, estimate=est, map=ros_map, grid=grid_cfg)
    if ros_map is not None and args.save_map:
        from tpu_slam_torch.utils.map_io import save_map

        paths = save_map(args.save_map, np.asarray(ros_map), grid_cfg)
        print(f"map saved: {paths[0]} + {paths[1]}")
        if args.model == "karto":
            from tpu_slam_torch.models.karto.occupancy import karto_graph_png

            gpath = karto_graph_png(
                model, args.save_map + "_graph.png",
                ros_map=ros_map, grid=grid_cfg,
            )
            print(f"pose graph saved: {gpath}")
    return 0


def _report_traj(est, gt):
    """The ATE against the simulator's truth (aligned) where there is one,
    and the final pose."""
    from tpu_slam_torch.utils.evaluation import ate_rmse

    if gt is not None:
        print(f"ATE RMSE vs sim ground truth: {ate_rmse(est, gt):.4f} m")
    p = np.asarray(est)[-1]
    print(f"final pose: [{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}]")


if __name__ == "__main__":
    raise SystemExit(main())
