"""Import hygiene of the port: tpu_slam_torch, chip_smoke, chip_sweep and
chip_rates must run on a machine without JAX, Flax or PyYAML, and import
nothing of the JAX package, not even a module of it that imports no JAX.
The check runs in a fresh interpreter, since this test process already
holds jax (conftest.py)."""

import inspect
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import tpu_slam_torch
mods = ["tpu_slam_torch"]
for info in pkgutil.walk_packages(tpu_slam_torch.__path__, "tpu_slam_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke  # the main guard keeps the chip run from starting
import chip_sweep
import chip_rates
print(json.dumps({"mods": mods,
                  "leaked": [m for m in ("jax", "flax", "yaml")
                             if m in sys.modules],
                  "reference": sorted(
                      m for m in sys.modules
                      if m == "tpu_slam" or m.startswith("tpu_slam."))}))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["reference"] == []
    expected = {
        "tpu_slam_torch.geometry", "tpu_slam_torch.convert",
        "tpu_slam_torch.data.scan", "tpu_slam_torch.ops.matching",
        "tpu_slam_torch.ops.plicp", "tpu_slam_torch.ops.cuda.plicp_fused",
        "tpu_slam_torch.parallel.distributed_step",
        "tpu_slam_torch.solver.pose_graph", "tpu_slam_torch.solver.cr_lm",
        "tpu_slam_torch.solver.pcg_lm", "tpu_slam_torch.models.offline",
        "tpu_slam_torch.config", "tpu_slam_torch.geometry_np",
        "tpu_slam_torch.solver.banded", "tpu_slam_torch.data.simulator",
        "tpu_slam_torch.utils.evaluation", "tpu_slam_torch.utils.profiling",
        "tpu_slam_torch.ops.gridmap", "tpu_slam_torch.ops.hector",
        "tpu_slam_torch.ops.cuda.hector_fused",
        "tpu_slam_torch.models.hector_slam",
        "tpu_slam_torch.ops.correlative",
        "tpu_slam_torch.ops.cuda.correlative_response",
        "tpu_slam_torch.models.karto.pipeline", "tpu_slam_torch.utils.events",
        "tpu_slam_torch.utils.checkpoint", "tpu_slam_torch.ops.cuda.nn",
        "tpu_slam_torch.ops.preprocess", "tpu_slam_torch.ops.icp",
        "tpu_slam_torch.ops.undistort", "tpu_slam_torch.ops.features",
        "tpu_slam_torch.models.icp_odometry",
        "tpu_slam_torch.models.plicp_odometry",
        "tpu_slam_torch.models.scan_match_plicp",
        "tpu_slam_torch.models.gmapping",
        "tpu_slam_torch.models.karto.occupancy",
        "tpu_slam_torch.utils.map_io",
        "tpu_slam_torch.cli", "tpu_slam_torch.__main__",
        "tpu_slam_torch.data.rosbag", "tpu_slam_torch.native",
        "tpu_slam_torch.parallel.mesh", "tpu_slam_torch.parallel.multihost",
        "tpu_slam_torch.parallel.loop_search",
        "tpu_slam_torch.parallel.sharded_map",
        "tpu_slam_torch.solver.distributed", "tpu_slam_torch.solver.schur",
        "tpu_slam_torch.examples",
        *(f"tpu_slam_torch.examples.run_{name}" for name in (
            "feature_detection", "gmapping", "hector_slam", "karto_slam",
            "lidar_undistortion", "plicp_odometry", "scan_matching")),
    }
    assert expected <= set(out["mods"])


def test_entry_points_default_to_the_card():
    from tpu_slam_torch import _dispatch, convert
    from tpu_slam_torch.data.scan import make_scan
    from tpu_slam_torch.models.gmapping import GMapping
    from tpu_slam_torch.models.hector_slam import HectorSLAM
    from tpu_slam_torch.models.icp_odometry import ICPOdometry
    from tpu_slam_torch.models.karto.occupancy import occupancy_from_scans
    from tpu_slam_torch.models.karto.pipeline import DeviceScanStore, KartoSLAM
    from tpu_slam_torch.models.plicp_odometry import PLICPOdometry
    from tpu_slam_torch.models.scan_match_plicp import ScanMatchPLICP
    from tpu_slam_torch.ops.correlative import CorrelativeMatcher
    from tpu_slam_torch.solver.pose_graph import PoseGraphSolver

    assert _dispatch.DEFAULT_DEVICE == "cuda"
    for fn in (PoseGraphSolver, make_scan, HectorSLAM, KartoSLAM,
               DeviceScanStore, CorrelativeMatcher, convert.scan_from_numpy,
               convert.solver_from_numpy, convert.hector_state_from_numpy,
               ICPOdometry, PLICPOdometry, ScanMatchPLICP, GMapping,
               occupancy_from_scans):
        default = inspect.signature(fn).parameters["device"].default
        assert default == _dispatch.DEFAULT_DEVICE, fn.__name__
    # the mesh: ranks on the card, joined by NCCL, unless told otherwise
    from tpu_slam_torch.parallel import mesh, multihost

    for fn in (mesh.make_mesh, multihost.global_mesh):
        assert inspect.signature(fn).parameters["device"].default == \
            _dispatch.DEFAULT_DEVICE, fn.__name__
        assert inspect.signature(fn).parameters["backend"].default is None
    assert mesh.default_backend(_dispatch.DEFAULT_DEVICE) == "nccl"
    assert mesh.default_backend("cpu") == "gloo"
    assert inspect.signature(multihost.initialize).parameters[
        "backend"].default == "nccl"
    # the command line: the card unless --cpu
    from tpu_slam_torch import cli

    for model in cli.MODELS:
        args = cli._build_parser().parse_args([model, "--sim"])
        assert cli.device_of(args) == _dispatch.DEFAULT_DEVICE, model


def test_cli_builds_on_the_card_unless_told_cpu(monkeypatch):
    """Without --cpu the CLI builds its scans (and so every model that
    takes their device) on the card, and with no card it stops; with
    --cpu it builds them on the CPU."""
    import pytest
    import torch

    from tpu_slam_torch import _dispatch, cli
    from tpu_slam_torch.data import scan as scan_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["odometry", "--sim", "--sim-scans", "3"])
    seen = []

    class Built(Exception):
        pass

    def recording(*args, device=None, **kw):
        seen.append(device)
        raise Built

    monkeypatch.setattr(scan_mod, "make_scan", recording)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for argv, dev in ((["karto", "--sim", "--sim-scans", "3"],
                       _dispatch.DEFAULT_DEVICE),
                      (["karto", "--sim", "--sim-scans", "3", "--cpu"],
                       "cpu")):
        with pytest.raises(Built):
            cli.main(argv)
        assert seen.pop() == dev
