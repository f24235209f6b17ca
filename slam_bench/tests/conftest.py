"""CPU tests of the benchmark's harness, reference and yardstick:
``python -m pytest slam_bench/tests -q``. Cases marked ``card`` need a
CUDA card and skip without one; whether there is one is decided inside
each such test."""

import copy
import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


def _load(rel):
    return json.loads((ROOT / rel).read_text())


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root whose cells are defined only by new data files under
    ``extra/``: the indoor configuration at 90 beams and 16 loop candidates
    a round, a one-lap corridor mission at 90 beams, a 256-node ring with
    noisy edges; the harness's own metrics and requests (``paths`` lists
    ``slam_bench`` after ``extra``) serve them."""
    bench = copy.deepcopy(_load("BENCHMARK.json"))
    bench["paths"] = ["extra", "slam_bench"]
    bench["configs"] = [
        {"name": "tiny_indoor", "source": "test", "reduced": [], "why": "test",
         "file": "extra/configs/tiny_indoor.json"},
        {"name": "tiny_spa", "source": "test", "reduced": [], "why": "test",
         "file": "extra/configs/tiny_spa.json"}]
    bench["workloads"] = [
        {"name": "tiny_mission", "config": "tiny_indoor",
         "traffic": "tiny_corridor", "chips": 1, "why": "test"},
        {"name": "tiny_ring", "config": "tiny_spa", "traffic": "tiny_ring",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            solve = (m["name"].startswith("solve_ms")
                     or m.get("moves") == "solve_ms")
            m["workloads"] = ["tiny_ring" if solve else "tiny_mission"]
    (tmp_path / "slam_bench").symlink_to(ROOT / "slam_bench")
    extra = tmp_path / "extra"
    for sub in ("configs", "traffic", "limits"):
        (extra / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    ind = _load("slam_bench/configs/karto_indoor.json")
    ind["config"]["scan"]["num_beams"] = 90
    ind["config"]["scan"]["angle_increment"] = 2 * math.pi / 90
    ind["config"]["offline"]["max_candidates"] = 16
    (extra / "configs/tiny_indoor.json").write_text(json.dumps(ind))
    (extra / "configs/tiny_spa.json").write_text(
        json.dumps(_load("slam_bench/configs/spa_backend.json")))
    t = _load("slam_bench/traffic/corridor_3lap.json")
    t.update(beams=90, laps=1, pool=1)
    (extra / "traffic/tiny_corridor.json").write_text(json.dumps(t))
    (extra / "traffic/tiny_ring.json").write_text(json.dumps({
        "request": "pose_graph_solve", "kind": "ring_graph", "nodes": 256,
        "radius": 10.0, "closure_every": 16, "drift_std": [0.02, 0.02, 0.004],
        "edge_noise_std": [0.01, 0.01, 0.005],
        "info_diag": [1e4, 1e4, 4e4], "pool": 2}))
    (extra / "limits/tiny_mission.json").write_text(json.dumps({"limits": {
        "chain_gap": 1e-3, "loop_err_excess": 1e-3, "pose_gap_m": 1e-2,
        "ate_m": 0.05, "loop_miss": 0.1}}))
    (extra / "limits/tiny_ring.json").write_text(json.dumps({"limits": {
        "pose_gap_m": 1e-3, "chi2_excess": 1e-8}}))
    return tmp_path
