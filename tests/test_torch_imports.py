"""Import hygiene of the port: tpu_slam_torch and chip_smoke must run on a
machine without JAX, Flax or PyYAML. The check runs in a fresh interpreter,
since this test process already holds jax (conftest.py)."""

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
print(json.dumps({"mods": mods,
                  "leaked": [m for m in ("jax", "flax", "yaml")
                             if m in sys.modules]}))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    expected = {
        "tpu_slam_torch.geometry", "tpu_slam_torch.convert",
        "tpu_slam_torch.data.scan", "tpu_slam_torch.ops.matching",
        "tpu_slam_torch.ops.plicp", "tpu_slam_torch.ops.cuda.plicp_fused",
        "tpu_slam_torch.parallel.distributed_step",
        "tpu_slam_torch.solver.pose_graph", "tpu_slam_torch.solver.cr_lm",
        "tpu_slam_torch.solver.pcg_lm", "tpu_slam_torch.models.offline",
    }
    assert expected <= set(out["mods"])
