"""The spans and counters of utils/profiling: a stage makes its timer the
open timer, ``span`` and ``count`` record into it, and the pose-graph
solver and ``offline_slam`` record their phases there, on the CPU."""

import dataclasses
import math

import numpy as np
import pytest

from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import SolverConfig, default_config
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import make_scan
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.solver import pose_graph as tpg
from tpu_slam_torch.utils import profiling
from tpu_slam_torch.utils.profiling import StageTimer, count, span

from test_torch_pose_graph import _braided_ring, _ring, _skip_edge_graph

SOLVE_SPANS = ("pose_graph.route", "pose_graph.pack", "pose_graph.upload",
               "pose_graph.dispatch", "pose_graph.wait", "pose_graph.harvest")


def _graph(route):
    """(config, init, edges) of a small graph that takes ``route`` on the
    CPU."""
    if route == "dense":
        init, edges, _gt = _ring(n=60)
        return SolverConfig(), init, edges
    if route == "direct":
        init, edges, _gt = _ring(n=96, stride=8)
        return SolverConfig(use_dense_below=32), init, edges
    if route == "pcg":
        init, edges = _braided_ring()
        return SolverConfig(use_dense_below=32), init, edges
    init, edges = _skip_edge_graph()
    return SolverConfig(f64_schur_above=64, use_dense_below=32), init, edges


ROUTES = ["direct", "pcg", "dense", "host_f64"]


@pytest.mark.parametrize("route", ROUTES)
def test_solve_records_each_span_once(route):
    """Ingestion once a call of ``add_nodes`` and of ``add_constraints``;
    every solve span once a solve (the host f64 arm uploads nothing)."""
    cfg, init, edges = _graph(route)
    probe = solver_from_numpy(cfg, init, edges, device="cpu")
    assert tpg._route(probe.num_nodes, probe.num_edges, "cpu", cfg,
                      probe._band_spec) == route
    timer = StageTimer()
    with timer.stage("request"):
        s = solver_from_numpy(cfg, init, edges, device="cpu")
        s.compute()
    want = {name: 1 for name in SOLVE_SPANS}
    if route == "host_f64":
        del want["pose_graph.upload"]
    want["pose_graph.ingest"] = 2
    got = {k: v for k, v in timer.counts.items()
           if k in timer.totals and k.startswith("pose_graph.")}
    assert got == want
    assert all(timer.totals[k] >= 0.0 for k in want)
    # the spans nest inside the caller's stage
    assert sum(timer.totals[k] for k in want) <= timer.totals["request"]


@pytest.mark.parametrize("route", ROUTES)
def test_counters_equal_the_packed_results(route):
    """Two solves: ``pose_graph.solves`` counts them, and the LM and CG
    counters sum each packed result's row 3, lane 3 and row 4, lane 0
    (the CG steps on the "pcg" route alone)."""
    cfg, init, edges = _graph(route)
    timer = StageTimer()
    raws = []
    with timer.stage("request"):
        s = solver_from_numpy(cfg, init, edges, device="cpu")
        for _ in range(2):
            pending = s.compute_async(max_iterations=3)
            raws.append(pending._packed.double().numpy())
            pending.harvest()
    assert timer.counts["pose_graph.solves"] == 2
    assert timer.counts["pose_graph.lm_iterations"] == sum(
        int(r[3, 3]) for r in raws) > 0
    if route == "pcg":
        assert timer.counts["pose_graph.cg_steps"] == sum(
            int(r[4, 0]) for r in raws) > 0
    else:
        assert "pose_graph.cg_steps" not in timer.counts
    for name in ("pose_graph.solves", "pose_graph.lm_iterations"):
        assert name not in timer.totals  # counters are not stages


def test_no_open_stage_records_nothing():
    cfg, init, edges = _graph("dense")
    bystander = StageTimer()
    assert profiling._OPEN.get() is None
    s = solver_from_numpy(cfg, init, edges, device="cpu")
    stats = s.compute()
    assert stats.iterations > 0
    assert profiling._OPEN.get() is None
    assert not bystander.totals and not bystander.counts
    # the shared no-op: no timer is made or kept
    assert span("pose_graph.route") is span("x") is profiling._NO_SPAN
    count("pose_graph.solves", 3)
    assert profiling._OPEN.get() is None and not bystander.counts


def test_nested_stages_restore_the_outer_timer():
    outer, inner = StageTimer(), StageTimer()
    with outer.stage("a"):
        assert profiling._OPEN.get() is outer
        with inner.stage("b"):
            assert profiling._OPEN.get() is inner
            with span("x"):
                count("things", 2)
        with span("y"):
            count("things")
        with pytest.raises(RuntimeError):
            with inner.stage("c"):
                raise RuntimeError("the stage closes all the same")
        assert profiling._OPEN.get() is outer
    assert profiling._OPEN.get() is None
    assert dict(inner.counts) == {"x": 1, "b": 1, "things": 2, "c": 1}
    assert dict(outer.counts) == {"y": 1, "a": 1, "things": 1}
    assert set(inner.totals) == {"x", "b", "c"}
    assert set(outer.totals) == {"y", "a"}


def test_report_lists_counters_apart_from_stages():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("solve"):
            count("pose_graph.lm_iterations", 7)
    assert timer.mean_ms("pose_graph.lm_iterations") == 0.0
    assert "pose_graph.lm_iterations" not in timer.totals
    lines = timer.report().splitlines()
    assert lines[0].startswith("solve: ") and "×2" in lines[0]
    assert lines[1:] == ["pose_graph.lm_iterations: 14"]


@pytest.fixture(scope="module")
def mission():
    """A corridor lap at 128 beams that closes its loop (test_offline.py's
    recipe on the port's simulator), and the offline run's timer."""
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, num_beams=128, range_max=6.0,
                                 range_threshold=5.0),
        offline=dataclasses.replace(
            cfg.offline, max_candidates=6, seeds_xy=3, seeds_theta=3,
            seed_xy=0.5, seed_theta=math.radians(12.0), rounds=2,
            loop_min_gap=40),
    )
    arm, width = 6.0, 2.2
    m = (arm / 2 + (arm / 2 - width)) / 2
    wps = np.array([[-m, -m], [m, -m], [m, m], [-m, m], [-m, -m], [0.0, -m]])
    traj = sim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    world = sim.corridor_loop_world(arm=arm, width=width)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=5)
    scans = make_scan(seq.ranges, cfg.scan, device="cpu")
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = gnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.01, 2)
        d[2] += rng.normal(0, 0.002)
        odom.append(gnp.compose(odom[-1], d))
    res = offline_slam(scans, cfg, odom=np.asarray(odom))
    assert res.loops, "the lap must close its loop"
    return res.timer


def test_offline_slam_records_prepare_and_graph_build(mission):
    """``prepare`` and ``graph_build`` (one build more than solves: the
    chain's graph before any loop), the stages that kept their names, and
    the solver's spans and counters under ``solve``."""
    t = mission
    for stage in ("prepare", "chain_match", "candidates", "loop_match",
                  "pcm", "solve"):
        assert t.counts[stage] >= 1, stage
    assert t.counts["graph_build"] == t.counts["solve"] + 1
    assert t.counts["pose_graph.solves"] == t.counts["solve"]
    assert t.counts["pose_graph.dispatch"] == t.counts["solve"]
    assert t.counts["pose_graph.ingest"] >= 2 * t.counts["graph_build"]
    assert t.counts["pose_graph.lm_iterations"] >= t.counts["solve"]
    # the solver's spans of a solve nest inside ``solve``
    assert (t.totals["pose_graph.dispatch"] + t.totals["pose_graph.harvest"]
            <= t.totals["solve"])
    assert "pose_graph.solves" in t.report()
