"""Port parity: tpu_slam_torch.solver.pose_graph.PoseGraphSolver against
tpu_slam's on the same graphs, through each route the port takes: dense,
cyclic reduction (the single-launch and the streamed entry), PCG and the
host f64 arm. On the CPU the JAX solver takes its dense or CG program, or
its host f64 arm at f64_schur_above nodes."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_slam import config as jconfig
from tpu_slam import geometry_np as gnp
from tpu_slam.solver.pose_graph import PoseGraphSolver as JaxSolver
from tpu_slam_torch import _dispatch
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.solver import pose_graph as tpg
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver


def _ring(n=60, noise=0.01, stride=0, seed=0):
    """A ring with consecutive constraints and its closure; ``stride`` adds
    cross closures every ``stride`` nodes. Returns the drifted odometry
    init, the edges with information, and the ground truth."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([5 * np.cos(th), 5 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    pairs = [(i, i + 1) for i in range(n - 1)] + [(n - 1, 0)]
    if stride:
        pairs += [(i, (i + n // 2) % n) for i in range(0, n // 2, stride)]
    edges = []
    for i, j in pairs:
        m = gnp.relative(gt[i], gt[j]) + rng.normal(0, noise, 3)
        edges.append((i, j, m, np.diag([100.0, 100.0, 400.0])))
    init = [gt[0]]
    for i, j, m, _w in edges[: n - 1]:
        init.append(gnp.compose(init[-1], m))
    return np.asarray(init), edges, gt


def _jax_solve(cfg, init, edges):
    s = JaxSolver(jconfig.SolverConfig(**dataclasses.asdict(cfg)))
    s.add_nodes(range(len(init)), init)
    for i, j, m, w in edges:
        s.add_constraint(i, j, m, information=w)
    return s.compute(), s.get_poses()


def _port_solve(cfg, init, edges):
    s = solver_from_numpy(cfg, init, edges, device="cpu")
    return s.compute(), s.get_poses()


def test_dense_route_matches_reference():
    # at noise 0.01 both stop at the same cost to float32 precision, but
    # the reference accepts one more step at the noise level of the f32
    # sum, which slides a flat direction by 1.4e-4; at 0.002 the LM stops
    # cleanly and the two agree to 5e-7
    init, edges, _gt = _ring(noise=0.002)
    cfg = SolverConfig()
    (js, jp), (ts, tp) = _jax_solve(cfg, init, edges), _port_solve(cfg, init, edges)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3, abs=1e-6)
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    np.testing.assert_array_equal(tp[0], init[0])  # gauge node untouched


def test_cr_route_matches_reference():
    # use_dense_below lowered: the port takes the CR route (the ring bands),
    # the reference's CPU program runs PCG
    init, edges, _gt = _ring(n=96, stride=8)
    cfg = SolverConfig(use_dense_below=32)
    s = solver_from_numpy(cfg, init, edges, device="cpu")
    assert s._band_spec() is not None
    (js, jp), (ts, tp) = _jax_solve(cfg, init, edges), _port_solve(cfg, init, edges)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3, abs=1e-5)


def _braided_ring():
    """A graph that does not band under RCM at W ≤ 8."""
    init, edges, _gt = _ring(n=80, stride=1)
    edges += [(i, (i + 7) % 80, gnp.relative(init[i], init[(i + 7) % 80]),
               np.diag([100.0, 100.0, 400.0])) for i in range(0, 80, 3)]
    return init, edges


def test_pcg_route_matches_reference():
    # both take PCG
    init, edges = _braided_ring()
    cfg = SolverConfig(use_dense_below=32)
    s = solver_from_numpy(cfg, init, edges, device="cpu")
    assert s._band_spec() is None
    (js, jp), (ts, tp) = _jax_solve(cfg, init, edges), _port_solve(cfg, init, edges)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3, abs=1e-5)


def test_restarted_cg_matches_reference():
    """cg_restarts = 2 at a CG budget too short for one run: the port's
    PCG route (restarts in the plain PCG-LM) against the reference's XLA
    LM program (cg_solve(restarts=2)); in both packages two restarts end
    no higher than one. Three LM steps, so that the steps' quality shows
    in the cost (measured 100.28 with one run, 89.35 with two, in both;
    with the LM run to convergence both reach ~88.366)."""
    init, edges = _braided_ring()
    cfg = SolverConfig(use_dense_below=32, use_direct=False,
                       cg_iterations=8, cg_restarts=2, max_iterations=3)
    assert tpg._route(len(init), len(edges), "cpu", cfg, lambda: None) \
        == "pcg"
    (js, jp), (ts, tp) = _jax_solve(cfg, init, edges), _port_solve(cfg, init, edges)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3, abs=1e-5)
    one = dataclasses.replace(cfg, cg_restarts=1)
    (js1, _), (ts1, _) = _jax_solve(one, init, edges), _port_solve(one, init, edges)
    assert js.final_cost <= js1.final_cost
    assert ts.final_cost <= ts1.final_cost


def test_routes_agree_with_each_other():
    init, edges, gt = _ring(n=96, stride=8)
    out = {}
    for name, cfg in (("dense", SolverConfig()),
                      ("cr", SolverConfig(use_dense_below=32)),
                      ("pcg", SolverConfig(use_dense_below=32,
                                           use_direct=False))):
        stats, out[name] = _port_solve(cfg, init, edges)
        assert stats.final_cost < 1e-2 * stats.initial_cost
    np.testing.assert_allclose(out["cr"], out["dense"], atol=1e-3)
    np.testing.assert_allclose(out["pcg"], out["dense"], atol=1e-3)


def test_covariance_input_and_incremental_surface():
    s = PoseGraphSolver(SolverConfig(), device="cpu")
    s.add_node(0, [0.0, 0.0, 0.0])
    s.add_node(7, [1.2, 0.1, 0.0])
    s.add_constraint(0, 7, [1.0, 0.0, 0.0], covariance=np.eye(3) * 0.01)
    assert (s.num_nodes, s.num_edges) == (2, 1)
    pending = s.compute_async()
    assert pending.ready()
    stats = pending.harvest()
    assert pending.harvest() is stats  # harvest is idempotent
    np.testing.assert_allclose(s.get_poses()[1], [1.0, 0.0, 0.0], atol=1e-4)
    assert stats.final_cost <= stats.initial_cost
    s.set_node_pose(7, [2.0, 0.0, 0.0])
    np.testing.assert_array_equal(s.get_poses()[1], [2.0, 0.0, 0.0])
    s.clear()
    assert (s.num_nodes, s.num_edges) == (0, 0)


def test_degenerate_covariance_is_regularized():
    s = PoseGraphSolver(SolverConfig(), device="cpu")
    s.add_nodes([0, 1], [[0, 0, 0], [1, 0, 0]])
    s.add_constraints([0], [1], [[1.0, 0.0, 0.0]],
                      covariances=np.zeros((1, 3, 3)))
    assert np.all(np.isfinite(s._edges[0][3]))


def test_unported_routes_raise():
    """Every route is ported, and none raises. On a mesh of one rank the
    edge-sharded LM (dense and CG) gives the single-device solve to the
    reference's mesh bars; the two Schur routes, which raised until they
    were ported, solve the same graph as the reference's (the device f64
    Schur LM within tests/test_pose_graph.py's 5e-5, the float32 Schur LM
    within 5e-4)."""
    from tpu_slam_torch.parallel.mesh import make_mesh

    init, edges, _gt = _ring(n=80, stride=1)
    for kw in (dict(), dict(use_dense_below=32)):
        cfg = SolverConfig(**kw)
        s = PoseGraphSolver(cfg, mesh=make_mesh(device="cpu"))
        s.add_nodes(range(len(init)), init)
        s.add_constraints([e[0] for e in edges], [e[1] for e in edges],
                          np.asarray([e[2] for e in edges]),
                          informations=np.asarray([e[3] for e in edges]))
        stats = s.compute()
        ref_stats, ref = _port_solve(cfg, init, edges)
        np.testing.assert_allclose(s.get_poses(), ref, atol=5e-4)
        assert stats.final_cost == pytest.approx(ref_stats.final_cost,
                                                 rel=1e-2, abs=1e-6)
    # at f64_schur_above nodes the host f64 arm runs; without it the
    # device f64 Schur LM, and with use_schur the float32 Schur LM
    for cfg, route, tol in (
            (SolverConfig(use_dense_below=32, f64_schur_above=64,
                          use_direct=False, host_direct_fallback=False),
             "f64_schur", 5e-5),
            (SolverConfig(use_dense_below=32, use_schur=True), "schur",
             5e-4)):
        assert tpg._route(len(init), len(edges), "cpu", cfg) == route
        (js, jp), (ts, tp) = (_jax_solve(cfg, init, edges),
                              _port_solve(cfg, init, edges))
        np.testing.assert_allclose(tp, jp, rtol=0, atol=tol)
        assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-2,
                                              abs=1e-6)


@pytest.mark.parametrize("nodes, bands, kw, route", [
    # the reference's order (tpu_slam/solver/pose_graph.py:939-1038):
    # a band first unless use_schur, then f64_schur_above, then Schur
    (4000, False, dict(use_schur=True), "host_f64"),
    (1000, False, dict(use_schur=True), "schur"),
    (4000, True, dict(use_schur=True), "host_f64"),
    (4000, True, {}, "direct"),
    (4000, False, dict(host_direct_fallback=False), "f64_schur"),
    (4000, False, {}, "host_f64"),
    (1000, False, dict(cg_restarts=2), "pcg"),
    (1000, False, {}, "pcg"),
    # the reference's partition test (:1033-1038): more than 2 ×
    # schur_submaps nodes and at least use_dense_below, from use_dense_below
    # itself; a use_schur graph that fails it takes the LM program
    (512, False, dict(use_schur=True), "schur"),
    (520, False, dict(use_schur=True, schur_submaps=300), "pcg"),
    (600, False, dict(use_schur=True, schur_submaps=300), "pcg"),
    (601, False, dict(use_schur=True, schur_submaps=300), "schur"),
    (500, False, dict(use_schur=True), "dense"),
])
def test_route_order_is_the_reference_order(nodes, bands, kw, route):
    cfg = SolverConfig(**kw)
    assert cfg.f64_schur_above == 3000 and cfg.use_dense_below == 512
    spec = (lambda: object()) if bands else (lambda: None)
    assert tpg._route(nodes, 2 * nodes, "cuda", cfg, spec) == route
    assert tpg._route(nodes, 2 * nodes, "cpu", cfg, spec) == route


@pytest.fixture
def one_thread():
    """The plain CR-LM at W = 2 (batches of 6 × 6 blocks) ran ~20× slower
    on 8 intra-op threads than on one, here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_large_band_routes_to_the_streamed_cr(monkeypatch, one_thread):
    # 3,000 chain nodes band at W = 2 with K = 2,048 > K_MAX supernodes
    n = 3000
    rng = np.random.default_rng(4)
    truth = np.zeros((n, 3))
    truth[:, 0] = np.arange(n) * 0.1
    init = truth + rng.normal(0, 0.01, (n, 3)) * (np.arange(n) > 0)[:, None]
    edges = [(i, i + 1, np.array([0.1, 0.0, 0.0]), np.eye(3))
             for i in range(n - 1)]
    calls = []

    def recording(*args, **kw):
        calls.append((kw["W"], kw["K"]))
        return streamed(*args, **kw)

    streamed = tpg.streamed_cr_lm
    monkeypatch.setattr(tpg, "streamed_cr_lm", recording)
    s = solver_from_numpy(SolverConfig(), init, edges, device="cpu")
    stats = s.compute()
    assert calls == [(2, 2048)]
    assert stats.final_cost <= 1e-6 * stats.initial_cost
    # float32 along a 300 m chain: the heading noise left when ‖δ‖² falls
    # under 1e-8 times the lever (measured 1.2e-3 m at the far end)
    np.testing.assert_allclose(s.get_poses(), truth, atol=5e-3)


def test_large_ring_matches_reference_host_f64(monkeypatch):
    """bench_solver's 4,096-node ring (W 6, K 1,024): the port solves it
    by the streamed CR route, the reference on the CPU by its host f64 arm
    (the CR kernels run only on its TPU); the two land on the same optimum
    (measured 1.9e-6)."""
    from test_banded import ring_problem

    init, ei, ej, means, infos = ring_problem(4096, stride=16)
    edges = list(zip(ei.tolist(), ej.tolist(), means, infos))
    cfg = SolverConfig()
    port = solver_from_numpy(cfg, init, edges, device="cpu")
    spec = port._band_spec()
    assert (spec.W, spec.K) == (6, 1024)
    calls = []
    streamed = tpg.streamed_cr_lm
    monkeypatch.setattr(tpg, "streamed_cr_lm",
                        lambda *a, **kw: calls.append(1) or streamed(*a, **kw))
    ts, tp = port.compute(), port.get_poses()
    assert calls == [1]
    js, jp = _jax_solve(cfg, init, edges)
    assert ts.final_cost <= 1e-6 * ts.initial_cost
    assert js.final_cost <= 1e-6 * js.initial_cost
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    np.testing.assert_allclose(tp, jp, atol=1e-4)


def _skip_edge_graph():
    """tests/test_pose_graph.py::test_mixed_schur_f64_path_matches_oracle's
    graph: a 160-node arc with skip edges at strides 8 and 32, which does
    not band under RCM."""
    rng = np.random.default_rng(11)
    n = 160
    th = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    edges = []
    rels = gnp.relative(gt[:-1], gt[1:])
    for i in range(n - 1):
        edges.append((i, i + 1, rels[i] + rng.normal(0, 0.01, 3)))
    for s in (8, 32):
        rl = gnp.relative(gt[:-s], gt[s:])
        for i in range(0, n - s, s):
            edges.append((i, i + s, rl[i] + rng.normal(0, 0.004, 3)))
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    info = np.diag([1e4, 1e4, 4e4])
    return np.asarray(init), [(i, j, m, info) for i, j, m in edges]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_host_f64_arm_matches_reference(device):
    # the solve runs on the host whatever the solver's device: no tensor is
    # made on it and no kernel launched, so "cuda" runs here too
    init, edges = _skip_edge_graph()
    cfg = SolverConfig(f64_schur_above=64, use_dense_below=32)
    s = solver_from_numpy(cfg, init, edges, device=device)
    assert s._band_spec() is None
    assert tpg._route(s.num_nodes, s.num_edges, device, cfg,
                      s._band_spec) == "host_f64"
    before = dict(_dispatch.LAUNCHES)
    pending = s.compute_async()
    assert pending._packed.dtype == torch.float64
    ts, tp = pending.harvest(), s.get_poses()
    assert _dispatch.LAUNCHES == before
    js, jp = _jax_solve(cfg, init, edges)  # the reference's host arm on the CPU
    # both are the same float64 host code
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
    assert ts.iterations == js.iterations
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-9)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-9)
    # the edges are noisy: the optimum keeps a χ² of ~100
    assert ts.iterations > 0 and ts.final_cost < 0.05 * ts.initial_cost


def test_each_route_counts_no_launch_on_cpu():
    init, edges, _gt = _ring(n=96, stride=8)
    before = dict(_dispatch.LAUNCHES)
    _port_solve(SolverConfig(use_dense_below=32), init, edges)
    assert _dispatch.LAUNCHES == before


def test_sq_min_delta_floor():
    assert tpg._sq_min_delta(1e-16) == 1e-8
    assert tpg._sq_min_delta(1e-6) == 1e-6


def test_edge_arrays_and_band_spec_built_once_per_graph():
    init, edges, _gt = _ring(n=96, stride=8)
    s = solver_from_numpy(SolverConfig(), init, edges, device="cpu")
    arrays, spec = s._edge_arrays(), s._band_spec()
    assert s._edge_arrays() is arrays
    # the same topology in another solver reuses the cached spec
    again = solver_from_numpy(SolverConfig(), init, edges, device="cpu")
    assert again._band_spec() is spec
    # a new edge rebuilds the arrays and the spec
    s.add_constraint(3, 40, [1.0, 0.0, 0.0], information=np.eye(3))
    assert len(s._edge_arrays()[0]) == len(edges) + 1
    assert s._band_spec() is not spec
    s.clear()
    assert len(s._edge_arrays()[0]) == 0


def test_direct_inputs_match_reference_packers():
    from tpu_slam.solver import banded

    init, edges, _gt = _ring(n=96, stride=8)
    s = solver_from_numpy(SolverConfig(), init, edges, device="cpu")
    spec, pT8, slots = s.direct_inputs()
    means = np.stack([e[2] for e in edges])
    infos = np.stack([e[3] for e in edges])
    np.testing.assert_allclose(slots.numpy(),
                               banded.build_slots_np(spec, means, infos))
    np.testing.assert_allclose(pT8.numpy(), banded.flat_poses_np(spec, init))
