"""Carry state across from the JAX package.

There are no weights; the state that crosses is the configuration, the
scans, the pose graph, the Hector maps and the Karto mapper, all as plain
Python or numpy (``dataclasses.asdict`` of a JAX config, a JAX ``Scan``'s
fields after ``np.asarray``, a JAX ``PoseGraphSolver``'s ``_poses`` /
``_edges``, a JAX ``HectorSLAM``'s grids and poses) or as the JAX
package's Karto checkpoint file. The tests feed both packages the same
inputs through these, without the port importing the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import config as _config
from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig, SolverConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.models.hector_slam import HectorSLAM
from tpu_slam_torch.models.karto.pipeline import KartoSLAM
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver
from tpu_slam_torch.utils.checkpoint import load_karto


def config_from_dict(d: dict) -> SLAMConfig:
    """The port's ``SLAMConfig`` from a nested dict of its fields, such as
    ``dataclasses.asdict`` of the JAX package's config."""
    return _config.config_from_dict(d)


def scan_from_numpy(ranges, valid, angles, stamp, time_increment,
                    device=DEFAULT_DEVICE) -> Scan:
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
                      device=DEFAULT_DEVICE) -> PoseGraphSolver:
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


def hector_state_from_numpy(slam: HectorSLAM, grids, last_pose,
                            last_map_update_pose,
                            device=DEFAULT_DEVICE) -> HectorSLAM:
    """Load a JAX ``HectorSLAM``'s state into the port's ``slam``: its
    flat log-odds ``grids`` (one per level), ``last_pose`` (3,) and
    ``_last_map_update_pose`` (3,) or None. Returns ``slam``, whose
    tensors then lie on ``device``."""
    if len(grids) != len(slam.grid_cfgs):
        raise ValueError(f"{len(grids)} grids for {len(slam.grid_cfgs)} "
                         "pyramid levels")
    slam.device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=slam.device)
    slam.grids = [torch.as_tensor(np.array(g, np.float32).reshape(-1), **f32)
                  for g in grids]
    slam.last_pose = torch.as_tensor(np.array(last_pose, np.float32), **f32)
    slam._last_map_update_pose = (
        None if last_map_update_pose is None
        else np.array(last_map_update_pose, np.float32))
    return slam


def karto_state_from_checkpoint(slam: KartoSLAM, path: str) -> KartoSLAM:
    """Load a Karto snapshot (``save_karto``'s ``.npz``, of either package)
    into the port's freshly built ``slam``: scans, running buffers, graph
    and solver. Returns ``slam``, its scan store on ``slam.device``."""
    load_karto(slam, path)
    return slam
