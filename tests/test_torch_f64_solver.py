"""Port parity for the float64 solver: tpu_slam_torch's
``PoseGraphSolver(cfg, dtype=torch.float64, device="cpu")`` against
tpu_slam's ``PoseGraphSolver(cfg, dtype=jnp.float64)`` run under
``jax.enable_x64`` (as tests/test_pose_graph.py:307-315 runs it), on the
same numpy graphs from a seed, through each float64 route: "dense",
"cg", "schur", "mesh_dense" and "mesh_cg"; the route order of a float64
solver; the reference's module-level ``cg_solve`` / ``cg_matvec``; one
float64 step of each LM form against the reference's to 1e-12; and the
reference's float32-against-float64 divergence test on the port.

Tolerances: poses within 1e-8 and the same good-iteration count for the
direct steps (dense, Schur); within 1e-6 for CG, where the two packages'
sum orders may move a CG early-out by a step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import config as jconfig
from tpu_slam import geometry_np as gnp
from tpu_slam.parallel.mesh import make_mesh as jmake_mesh
from tpu_slam.solver import pose_graph as jpg
from tpu_slam_torch import _dispatch
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.parallel.mesh import make_mesh
from tpu_slam_torch.solver import distributed as sd
from tpu_slam_torch.solver import lm, pcg_lm
from tpu_slam_torch.solver import pose_graph as tpg

import torch_mesh_ranks as ranks

F64 = torch.float64
DIRECT_POSE_TOL = 1e-8  # m / rad: dense and Schur steps
CG_POSE_TOL = 1e-6
STEP_TOL = 1e-12  # one float64 step against the reference's
INFO = np.diag([1e4, 1e4, 4e4])


def _ring(n=96, noise=0.01, stride=8, seed=0):
    """A ring with consecutive constraints, its closure and cross closures
    every ``stride`` nodes; the drifted odometry as the initial guess."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([5 * np.cos(th), 5 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    pairs = [(i, i + 1) for i in range(n - 1)] + [(n - 1, 0)]
    pairs += [(i, (i + n // 2) % n) for i in range(0, n // 2, stride)]
    info = np.diag([100.0, 100.0, 400.0])
    edges = [(i, j, gnp.relative(gt[i], gt[j]) + rng.normal(0, noise, 3),
              info) for i, j in pairs]
    init = [gt[0]]
    for _i, _j, m, _w in edges[: n - 1]:
        init.append(gnp.compose(init[-1], m))
    return np.asarray(init), edges


def _lap_chain(n, seed=31):
    """tests/test_pose_graph.py:165-210's graph at ``n`` nodes: a noisy
    chain of three laps of a circle of 8 m with exact loop closures one
    lap apart every 50 nodes, the odometry integrated as the guess."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 6 * np.pi, n)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    edges = [(i, i + 1, gnp.relative(gt[i], gt[i + 1])
              + rng.normal(0, 0.005, 3), INFO) for i in range(n - 1)]
    period = n // 3
    edges += [(i, i + period, gnp.relative(gt[i], gt[i + period]), INFO)
              for i in range(0, n - period, 50)]
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    return np.asarray(init), edges


def _skip_graph(n=160, seed=11):
    """tests/test_pose_graph.py:298's mission-shaped graph: a noisy chain
    on a circle of 8 m with skip edges at strides 8 and 32."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    rels = gnp.relative(gt[:-1], gt[1:])
    edges = [(i, i + 1, rels[i] + rng.normal(0, 0.01, 3), INFO)
             for i in range(n - 1)]
    for s in (8, 32):
        rl = gnp.relative(gt[:-s], gt[s:])
        edges += [(i, i + s, rl[i] + rng.normal(0, 0.004, 3), INFO)
                  for i in range(0, n - s, s)]
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    return np.asarray(init), edges


def _jax_solve(cfg, init, edges, mesh=None):
    """The reference's float64 solver on the graph: (stats, poses)."""
    with jax.enable_x64(True):
        s = jpg.PoseGraphSolver(
            jconfig.SolverConfig(**dataclasses.asdict(cfg)),
            dtype=jnp.float64, mesh=mesh)
        s.add_nodes(range(len(init)), init)
        for i, j, m, w in edges:
            s.add_constraint(i, j, m, information=w)
        return s.compute(), s.get_poses()


def _port_solve(cfg, init, edges, route):
    """The port's float64 solver on the CPU: (stats, poses), with its
    route, its packed result's type and its launches checked."""
    s = solver_from_numpy(cfg, init, edges, device="cpu", dtype=F64)
    assert tpg._route(s.num_nodes, s.num_edges, "cpu", cfg, s._band_spec,
                      dtype=F64) == route
    before = dict(_dispatch.LAUNCHES)
    pending = s.compute_async()
    assert pending._packed.dtype == F64
    stats = pending.harvest()
    assert _dispatch.LAUNCHES == before
    return stats, s.get_poses()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_only_float32_and_float64_solvers(dtype):
    with pytest.raises(ValueError, match="float32 or float64"):
        tpg.PoseGraphSolver(SolverConfig(), device="cpu", dtype=dtype)


@pytest.mark.parametrize("nodes, kw, route, f32_route", [
    (100, {}, "dense", "dense"),
    (512, {}, "dense", "dense"),
    (200, dict(cg_restarts=2), "dense", "dense"),
    # f32 takes the CR kernel where the graph bands, else the PCG LM
    (513, {}, "cg", "pcg"),
    (1000, dict(cg_restarts=2), "cg", "pcg"),
    # f32 takes the host f64 arm or the device f64 Schur LM at this size
    (3000, {}, "cg", "host_f64"),
    (4000, {}, "cg", "host_f64"),
    (4000, dict(host_direct_fallback=False), "cg", "f64_schur"),
    (1000, dict(use_schur=True), "schur", "schur"),
    (4000, dict(use_schur=True), "schur", "host_f64"),
    (512, dict(use_schur=True), "schur", "schur"),
    (520, dict(use_schur=True, schur_submaps=300), "cg", "pcg"),
    (100, dict(use_schur=True), "dense", "dense"),
    (64, dict(use_schur=True, schur_submaps=4, use_dense_below=32),
     "schur", "schur"),
])
def test_f64_route_order(nodes, kw, route, f32_route):
    """A float64 solver takes the reference's gates in their order and
    never a float32-only route ("direct", "host_f64", "f64_schur",
    "pcg"), on either device and whether the graph bands or not."""
    cfg = SolverConfig(**kw)
    for dev in ("cuda", "cpu"):
        for bands in (lambda: object(), lambda: None):
            assert tpg._route(nodes, 2 * nodes, dev, cfg, bands,
                              dtype=F64) == route
    assert tpg._route(nodes, 2 * nodes, "cpu", cfg, lambda: None) == f32_route
    want = "mesh_dense" if nodes <= cfg.use_dense_below else "mesh_cg"
    assert tpg._route(nodes, 2 * nodes, "cuda", cfg, lambda: None,
                      make_mesh(device="cpu"), F64) == want


def test_sq_min_delta_keeps_its_floor_in_float32_only():
    assert tpg._sq_min_delta(1e-16, F64) == 1e-16
    assert tpg._sq_min_delta(1e-16, torch.float32) == 1e-8
    assert tpg._sq_min_delta(1e-6, F64) == 1e-6


def test_device_graph_is_in_the_solvers_type():
    init, edges = _ring(n=20)
    for dt in (torch.float32, F64):
        s = solver_from_numpy(SolverConfig(), init, edges, "cpu", dt)
        poses, ei, ej, means, infos, free = s.device_graph()
        assert poses.dtype == means.dtype == infos.dtype == dt
        assert ei.dtype == ej.dtype == torch.int64
        assert not free[0] and bool(free[1:].all())


def test_f64_dense_matches_reference():
    init, edges = _ring(n=96)
    cfg = SolverConfig()
    (js, jp), (ts, tp) = (_jax_solve(cfg, init, edges),
                          _port_solve(cfg, init, edges, "dense"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=DIRECT_POSE_TOL)
    assert ts.iterations == js.iterations > 0
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-12)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-9)
    assert ts.final_cost < 0.05 * ts.initial_cost


@pytest.mark.parametrize("restarts", [1, 2])
def test_f64_cg_matches_reference(restarts):
    """The loop-closed three-lap chain of 600 nodes at use_dense_below=0:
    both packages run their block-Jacobi CG LM in float64."""
    init, edges = _lap_chain(600)
    cfg = SolverConfig(use_dense_below=0, cg_restarts=restarts)
    (js, jp), (ts, tp) = (_jax_solve(cfg, init, edges),
                          _port_solve(cfg, init, edges, "cg"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=CG_POSE_TOL)
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-12)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-8)
    assert ts.final_cost < 1e-2 * ts.initial_cost


def test_f64_schur_matches_reference():
    """use_schur on the 160-node skip graph with schur_submaps and
    use_dense_below lowered so that both packages build the partition
    (tests/test_pose_graph.py:298-302): the reference's float64 step is
    its mixed-precision Schur PCG, the port's a direct float64 Schur
    solve, both at λ floored to 1e-5."""
    init, edges = _skip_graph()
    cfg = SolverConfig(use_schur=True, schur_submaps=8, use_dense_below=32)
    (js, jp), (ts, tp) = (_jax_solve(cfg, init, edges),
                          _port_solve(cfg, init, edges, "schur"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=DIRECT_POSE_TOL)
    assert ts.iterations == js.iterations > 0
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-9)


# --- the module-level CG and one float64 step of each LM form --------------


def _system(n=48, lam=0.1):
    """A ring's float64 normal equations at its guess, λ (not a float32
    number), and a free mask with the gauge and one more row fixed."""
    init, edges = _ring(n=n, noise=0.02, stride=4, seed=5)
    s = solver_from_numpy(SolverConfig(), init, edges, "cpu", F64)
    poses, ei, ej, means, infos, free = s.device_graph()
    free[n // 3] = False
    Hd, Hij, b = lm.normal_equations(poses, ei, ej, means, infos, n)
    return (poses, ei, ej, means, infos, free), (Hd, Hij, b), lam


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("restarts", [1, 2])
def test_cg_solve_and_matvec_match_reference(restarts):
    """``cg_solve`` and ``cg_matvec`` of solver/pose_graph against the
    reference's in x64, at a CG budget too short to converge (so that the
    restart shows), with a non-free row besides the gauge."""
    (_p, ei, ej, *_r, free), (Hd, Hij, b), lam = _system()
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(len(Hd), 3)))
    Hdd = lm.damped(Hd, lam)
    out = tpg.cg_solve(Hd, Hij, ei, ej, b, lam, free, 8, 1e-10,
                       restarts=restarts)
    y = tpg.cg_matvec(x, Hdd, Hij, ei, ej, free)
    with jax.enable_x64(True):
        ref = np.asarray(jpg.cg_solve(
            _j(Hd), _j(Hij), _j(ei), _j(ej), _j(b), jnp.float64(lam),
            _j(free), 8, 1e-10, restarts=restarts))
        yref = np.asarray(jpg.cg_matvec(_j(x), _j(Hdd), _j(Hij), _j(ei),
                                        _j(ej), _j(free)))
    assert out.dtype == y.dtype == F64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(y.numpy(), yref, rtol=0, atol=STEP_TOL)
    # the fixed rows: no step, and none in the product (x is masked first)
    assert not out[~free].any() and not y[~free].any()
    if restarts == 2:
        one = tpg.cg_solve(Hd, Hij, ei, ej, b, lam, free, 8, 1e-10)
        assert not torch.equal(one, out)


def test_plain_pcg_f64_step_matches_reference():
    """The PCG kernel's plain version (``pcg_lm._pcg``) keeps λ in the
    blocks' type: in float64 its step is the reference's cg_solve step."""
    (_p, ei, ej, *_r, free), (Hd, Hij, b), lam = _system()
    out, _steps = pcg_lm._pcg(Hd, Hij, b, ei, ej, free.to(F64),
                              np.float64(lam), 8, 1e-10, restarts=2)
    with jax.enable_x64(True):
        ref = np.asarray(jpg.cg_solve(
            _j(Hd), _j(Hij), _j(ei), _j(ej), _j(b), jnp.float64(lam),
            _j(free), 8, 1e-10, restarts=2))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=STEP_TOL)


def _jax_one_step(graph, lam, use_dense, cg_iters=10):
    """The reference's LM program for one iteration in x64: (poses,
    cost)."""
    poses, ei, ej, means, infos, free = graph
    with jax.enable_x64(True):
        p, _c0, c, _g = jpg._lm_loop_program(
            _j(poses), jnp.float64(lam), _j(ei.int()), _j(ej.int()),
            _j(means), _j(infos), jnp.ones(len(ei), bool), _j(free), None,
            M=len(poses), use_dense=use_dense, iters=1,
            cg_iterations=cg_iters, cg_tolerance=1e-10)
        return np.asarray(p), float(c)


@pytest.mark.parametrize("use_dense", [True, False])
def test_one_f64_lm_step_matches_reference(use_dense):
    """One float64 LM step at λ = 0.1 (a float32 rounding of λ moves it
    by ~1e-10): the one-device program ("dense", "cg") and the mesh LM
    (a mesh of one rank without a process group) against the reference's
    program to 1e-12."""
    graph, _sys, lam = _system()
    poses, ei, ej, means, infos, free = graph
    want, wcost = _jax_one_step(graph, lam, use_dense)
    cg = None if use_dense else (10, 1e-10, 1)
    got = tpg._lm_program(poses, ei, ej, means, infos, free, lam, 1, 1e-16,
                          cg=cg)
    mesh = sd.mesh_lm(make_mesh(device="cpu"), poses, ei, ej, means, infos,
                      torch.ones(len(ei), dtype=torch.bool), free, lam,
                      iters=1, use_dense=use_dense, cg_iters=10,
                      cg_tol=1e-10, cg_restarts=1, sq_min_delta=1e-16)
    n = len(poses)
    for packed in (got, mesh):
        assert packed.dtype == F64 and int(packed[3, 2]) == 1
        np.testing.assert_allclose(packed[0:3, :n].T.numpy(), want, rtol=0,
                                   atol=STEP_TOL)
        assert float(packed[3, 1]) == pytest.approx(wcost, rel=1e-12)


def test_f32_f64_divergence_bounded():
    """tests/test_pose_graph.py:165-210 on the port: the float32 solve of
    the 1,500-node three-lap chain (use_dense_below=0) against the port's
    own float64 "cg" solve, at the reference's bars: a final cost below
    1.5 × the float64 one + 1e-6, and the poses within 1 cm. As in the
    reference's test on the CPU, both solves are the block-Jacobi CG LM
    (``use_direct=False``: the graph bands, and the port's float32 solve
    would take the cyclic-reduction route, exact, to the optimum χ² 30.49
    that 40 LM steps of 100-step CG do not reach: 39.62, 0.79 m away,
    in both packages' float64 CG)."""
    init, edges = _lap_chain(1500)
    cfg = SolverConfig(use_dense_below=0, use_direct=False)
    s32 = solver_from_numpy(cfg, init, edges, "cpu")
    assert tpg._route(s32.num_nodes, s32.num_edges, "cpu", cfg,
                      s32._band_spec) == "pcg"
    st32 = s32.compute()
    st64, p64 = _port_solve(cfg, init, edges, "cg")
    assert st32.final_cost < 1.5 * st64.final_cost + 1e-6, (st32, st64)
    d = np.linalg.norm(s32.get_poses()[:, :2] - p64[:, :2], axis=1)
    assert d.max() < 0.01, d.max()


# --- the mesh routes: two gloo ranks against the reference's mesh in x64 ----

D = 2
MESH_CFGS = {"dense": dict(use_dense_below=10_000),
             "cg": dict(use_dense_below=0)}


def _mesh_graph():
    init, edges = _ring(n=40, noise=0.02, stride=8, seed=11)
    return init, edges


@pytest.fixture(scope="module")
def mesh_runs():
    """Each rank's float64 solves of the ring under both configs, and the
    reference's on its mesh of D virtual devices."""
    if len(jax.devices()) < 2 * D:
        pytest.skip("needs the conftest's virtual devices")
    init, edges = _mesh_graph()
    info = edges[0][3]
    job = ranks.Ranks(D, [("pose_graph", dict(
        cfgs=[SolverConfig(**kw) for kw in MESH_CFGS.values()], init=init,
        edges=[e[:3] for e in edges], info=info, dtype="float64"))])
    mesh = jmake_mesh(D)
    ref = {name: _jax_solve(SolverConfig(**kw), init, edges, mesh)
           for name, kw in MESH_CFGS.items()}
    return [r[0] for r in job.result()], ref


@pytest.mark.parametrize("path", list(MESH_CFGS))
def test_f64_mesh_matches_reference(mesh_runs, path):
    per_rank, ref = mesh_runs
    k = list(MESH_CFGS).index(path)
    poses, stats, route, coll = per_rank[0][k]
    assert route == f"mesh_{path}"
    assert coll["all_gather"] >= 2 * stats[0] > 0
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[k][0], poses)
    js, jp = ref[path]
    tol = DIRECT_POSE_TOL if path == "dense" else CG_POSE_TOL
    np.testing.assert_allclose(poses, jp, rtol=0, atol=tol)
    if path == "dense":
        assert stats[0] == js.iterations
    assert stats[2] == pytest.approx(js.final_cost, rel=1e-8)
