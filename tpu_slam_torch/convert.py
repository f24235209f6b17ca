"""Carry state across from the JAX package.

There are no weights; the state that crosses is the scans and the pose
graph, both as numpy arrays (a JAX ``Scan``'s fields after ``np.asarray``,
and a JAX ``PoseGraphSolver``'s ``_poses`` / ``_edges``, which are numpy
already). The tests feed both packages the same inputs through these.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam.config import SolverConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver


def scan_from_numpy(ranges, valid, angles, stamp, time_increment,
                    device="cpu") -> Scan:
    """A port ``Scan`` from the five fields of a JAX ``Scan``."""
    f32 = dict(dtype=torch.float32, device=device)
    return Scan(
        ranges=torch.as_tensor(np.array(ranges), **f32),
        valid=torch.as_tensor(np.array(valid, bool), device=device),
        angles=torch.as_tensor(np.array(angles), **f32),
        stamp=torch.as_tensor(np.array(stamp), **f32),
        time_increment=torch.as_tensor(np.array(time_increment), **f32),
    )


def solver_from_numpy(cfg: SolverConfig, poses, edges,
                      device="cpu") -> PoseGraphSolver:
    """A port ``PoseGraphSolver`` holding the same graph: ``poses`` (M, 3)
    and ``edges`` as (i, j, mean (3,), information (3, 3)) with dense node
    indices, the layout of the JAX solver's ``_poses`` and ``_edges``."""
    s = PoseGraphSolver(cfg, device=device)
    poses = np.asarray(poses, np.float64)
    s.add_nodes(range(len(poses)), poses)
    if len(edges):
        s.add_constraints(
            [e[0] for e in edges], [e[1] for e in edges],
            np.asarray([e[2] for e in edges], np.float64),
            informations=np.asarray([e[3] for e in edges], np.float64),
        )
    return s
