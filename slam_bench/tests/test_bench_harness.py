"""The harness end to end on the CPU, through the program's plain path, on
cells defined only by new data files (``tiny_root``): the result line's
keys, ``correct`` true for the program, false for the control (the
reference in bfloat16 in the program's place) and for faults planted
under the timed path."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from slam_bench import faults, harness, spec

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "host",
        "checks"]


def run(root, workload, trace=False, control=False, seconds=0.3):
    cell = spec.load_cell(root, workload)
    torch.set_num_threads(2)
    return harness.run_cell(cell, 2**31 + 7, seconds, trace, "cpu",
                            time.perf_counter(), control=control)


def test_ring_cell_from_data_files(tiny_root, capsys):
    line = run(tiny_root, "tiny_ring")
    assert list(line) == KEYS  # the checks come last
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= line["failed"] == 0
    assert set(line["metrics"]) == {"solve_ms", "solve_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    harness.print_result(line)
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1].startswith('{"correct": true')
    assert err.strip().splitlines()[-1] == "correct True"


def test_mission_cell_per_layer(tiny_root):
    line = run(tiny_root, "tiny_mission", trace=True)
    assert line["correct"] is True, line["checks"]
    # the CPU has no device trace: only the timer's metrics are read
    assert set(line["metrics"]) == {"offline.loop_search_ms",
                                    "offline.chain_match_ms",
                                    "pose_graph.solve_ms.mission"}
    assert set(line["checks"]) == {"chain_gap", "loop_err_excess", "pose_gap_m",
                                   "ate_m", "loop_miss"}


@pytest.mark.parametrize("workload", ["tiny_ring", "tiny_mission"])
def test_control_fails(tiny_root, workload):
    line = run(tiny_root, workload, control=True)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload, fault", [
    ("tiny_ring", "unchanged_state"), ("tiny_mission", "unchanged_state"),
    ("tiny_mission", "half_batch"),
    ("tiny_ring", "altered_answer"), ("tiny_mission", "altered_answer"),
    ("tiny_mission", "no_loops"), ("tiny_mission", "half_candidates"),
])
def test_fault_fails(tiny_root, workload, fault):
    with faults.FAULTS[fault]():
        line = run(tiny_root, workload)
    assert line["correct"] is False, line["checks"]


def test_cli_refuses_without_a_card(tmp_path):
    """No card: exit code 2 and no result line. A directory that holds
    only BENCHMARK.json and the benchmark's files: no result either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cmd = [sys.executable, "slam_bench/run.py", "--workload", "graph1k_solve",
           "--seed", str(2**33), "--seconds", "1"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench")
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
def test_cli_on_the_card():
    """One short run of the smallest cell on the card: a correct result
    line with the contract's keys, the card's name and count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    p = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", "graph1k_solve",
         "--seed", str(2**32 + 5), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert np.isfinite(line["metrics"]["cr_lm.roofline"]["value"])
