"""Port parity: tpu_slam_torch.solver.pose_graph.PoseGraphSolver against
tpu_slam's on the same graphs, through each route the port takes: dense,
cyclic reduction and PCG. On the CPU the JAX solver takes its dense or CG
program."""

import dataclasses

import numpy as np
import pytest

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


def test_pcg_route_matches_reference():
    # a graph that does not band under RCM at W ≤ 8: both take PCG
    init, edges, _gt = _ring(n=80, stride=1)
    edges += [(i, (i + 7) % 80, gnp.relative(init[i], init[(i + 7) % 80]),
               np.diag([100.0, 100.0, 400.0])) for i in range(0, 80, 3)]
    cfg = SolverConfig(use_dense_below=32)
    s = solver_from_numpy(cfg, init, edges, device="cpu")
    assert s._band_spec() is None
    (js, jp), (ts, tp) = _jax_solve(cfg, init, edges), _port_solve(cfg, init, edges)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3, abs=1e-5)


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
    init, edges, _gt = _ring(n=80, stride=1)
    with pytest.raises(NotImplementedError, match="multi-device"):
        PoseGraphSolver(SolverConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="_host_direct_lm"):
        _port_solve(SolverConfig(use_dense_below=32, f64_schur_above=64,
                                 use_direct=False), init, edges)
    with pytest.raises(NotImplementedError, match="Schur"):
        _port_solve(SolverConfig(use_dense_below=32, use_schur=True),
                    init, edges)
    with pytest.raises(NotImplementedError, match="restarted CG"):
        _port_solve(SolverConfig(use_dense_below=32, use_direct=False,
                                 cg_restarts=2), init, edges)


def test_large_band_raises_streamed_cr():
    # 3,000 chain nodes band at W = 2 with K = 2,048 > 512 supernodes
    n = 3000
    init = np.zeros((n, 3))
    init[:, 0] = np.arange(n) * 0.1
    edges = [(i, i + 1, np.array([0.1, 0.0, 0.0]), np.eye(3))
             for i in range(n - 1)]
    s = solver_from_numpy(SolverConfig(), init, edges, device="cpu")
    with pytest.raises(NotImplementedError, match="streamed_cr_lm"):
        s.compute()


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
