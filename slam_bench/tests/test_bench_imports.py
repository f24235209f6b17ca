"""The measuring process loads no JAX and no JAX package, comparing
top-level module names whole; the reference loads nothing of the
program."""

import subprocess
import sys

import pytest

from conftest import ROOT


def fresh(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip()


def test_foreign_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(ROOT / "slam_bench"))
    try:
        import run as bench_run
    finally:
        sys.path.pop(0)
    for name in ("tpu_slam_torch", "tpu_slam_torch.models.offline",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jaxlib", "flax", "tpu_slam"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert bench_run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_slam.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench_run.foreign_modules() == ["jax", "tpu_slam"]


def test_harness_and_program_load_no_jax():
    out = fresh(
        "import sys; sys.path.insert(0, '.');"
        "from slam_bench import harness, program, traffic;"
        "from slam_bench.requests import offline_mission, pose_graph_solve;"
        "import tpu_slam_torch.models.offline, tpu_slam_torch.solver.pose_graph;"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'tpu_slam'}))")
    assert out == "[]"


@pytest.mark.parametrize("mod", ["mission", "graph", "lm", "plicp"])
def test_reference_loads_nothing_of_the_program(mod):
    out = fresh(
        "import sys; sys.path.insert(0, '.');"
        f"import slam_bench.reference.{mod};"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'tpu_slam', 'tpu_slam_torch'}))")
    assert out == "[]"
