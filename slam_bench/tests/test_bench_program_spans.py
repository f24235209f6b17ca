"""The metrics that read the program's own spans and counters, on a
synthetic run: each reads its number from the timer's totals and counts of
a traced window, and nothing without a device trace or where the program
records no such span or counter."""

from pathlib import Path

import pytest

from slam_bench import harness, spec
from slam_bench.trace import DeviceTrace

DIRS = [Path(spec.__file__).resolve().parent]

# a window of 4 requests (missions or solves) holding 5 solves
TOTALS = {"pose_graph.ingest": 0.020, "pose_graph.route": 0.003,
          "pose_graph.pack": 0.004, "pose_graph.upload": 0.002,
          "pose_graph.harvest": 0.0015, "prepare": 0.060,
          "graph_build": 0.010}
COUNTS = {"pose_graph.solves": 5, "pose_graph.lm_iterations": 60,
          "pose_graph.cg_steps": 1500, "pose_graph.ingest": 10,
          "prepare": 8, "graph_build": 9}

EXPECTED = {
    "pose_graph.ingest_ms.solve": 1e3 * 0.020 / 5,
    "pose_graph.prepare_ms.solve": 1e3 * (0.003 + 0.004 + 0.002) / 5,
    "pose_graph.harvest_ms.solve": 1e3 * 0.0015 / 5,
    "pose_graph.lm_iters.solve": 60 / 5,
    "pose_graph.lm_iters.mission": 60 / 5,
    "offline.prepare_ms": 1e3 * 0.060 / 4,
    "offline.graph_build_ms": 1e3 * 0.010 / 4,
    "pcg_lm.cg_steps.mission": 1500 / 60,
}


def made_trace():
    t = DeviceTrace(["cr_lm", "pcg_lm"])
    t.index([(110.0, 130.0, "cr_lm_kernel"), (150.0, 190.0, "pcg_lm_kernel")],
            100.0)
    return t


def synthetic_run(totals, counts, trace):
    return harness.Run(
        cell=None, setup_s=1.0, window_s=1.0, t0=0.0, t1=1.0,
        requests=[(k, 0.25 * k, 0.25 * k + 0.2) for k in range(4)],
        work=4.0, stages={"totals": dict(totals), "counts": dict(counts)},
        trace=trace, accounts={}, pool=[])


def read(name, run):
    return spec.load_module(DIRS, "metrics", name).read(run)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_the_program_record(name):
    run = synthetic_run(TOTALS, COUNTS, made_trace())
    assert read(name, run) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_nothing_without_a_trace(name):
    assert read(name, synthetic_run(TOTALS, COUNTS, None)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_nothing_without_the_program_record(name):
    """A program that opens no such span and keeps no such counter (the
    harness's own stages alone): nothing, and no error."""
    run = synthetic_run({"request.build": 0.02, "solve": 0.01},
                        {"request.build": 4, "solve": 4}, made_trace())
    assert read(name, run) is None


def test_metrics_are_declared_for_their_cells():
    bench = spec.load_json(DIRS[0].parent / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = per_layer[name]
        solve = name.endswith(".solve")
        assert m["workloads"] == ["graph1k_solve" if solve
                                  else "indoor_mission"], name
        assert m["moves"] == ("solve_ms" if solve
                              else "mission_scans_per_s"), name
        counter = "iters" in name or "cg_steps" in name
        assert m["source"] == ("program_counter" if counter
                               else "program_span"), name
