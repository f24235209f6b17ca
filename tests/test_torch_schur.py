"""The Schur-complement solves of the port (tpu_slam_torch/solver/schur.py,
the "schur" and "f64_schur" routes of PoseGraphSolver) against tpu_slam's
on the CPU, at the sizes of tests/test_schur.py: the step of one damped
system against the reference's Schur step and the dense one, and whole
solves against the reference's solver and the port's host f64 arm."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_schur import ring_graph
from test_torch_pose_graph import _jax_solve, _port_solve, _skip_edge_graph
from tpu_slam.solver import pose_graph as jpg
from tpu_slam.solver import schur as js
from tpu_slam_torch import _dispatch
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.solver import lm
from tpu_slam_torch.solver import pose_graph as tpg
from tpu_slam_torch.solver import schur as ts

LAM = 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _step_args(M=64, seed=0):
    """ring_graph's system as both packages take it: (reference args,
    port args)."""
    poses, ei, ej, means, infos, mask, free = ring_graph(M, seed=seed)
    jargs = (jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
             jnp.asarray(means), jnp.asarray(infos), jnp.asarray(mask),
             jnp.float32(LAM), jnp.asarray(free))
    targs = (_t(poses), _t(ei).long(), _t(ej).long(), _t(means), _t(infos),
             _t(mask), np.float32(LAM), _t(free))
    return jargs, targs


def _dense(targs):
    poses, ei, ej, means, infos, _mask, lam, free = targs
    Hd, Hij, b = lm.normal_equations(poses, ei, ej, means, infos,
                                     poses.shape[0])
    return lm.dense_solve(Hd, Hij, ei, ej, b, lam, free).numpy()


def _bar(ref):
    return 1e-4 * max(np.abs(ref).max(), 1.0)


def test_partition_is_the_references():
    M, S = 64, 4
    _p, ei, ej, _m, _i, mask, _f = ring_graph(M)
    ref = js.build_partition(ei, ej, mask, M, S)
    out = ts.build_partition(ei, ej, mask, M, S)
    assert (out.n_submaps, out.n_nodes) == (ref.n_submaps, ref.n_nodes)
    for name in js._PART_ARRAY_FIELDS:
        a, b = getattr(out, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    bref, bout = js.bucket_partition(ref), ts.bucket_partition(out)
    for name in js._PART_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(bout, name),
                                      getattr(bref, name), err_msg=name)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_schur_delta_matches_reference_and_dense(S):
    """δ within 1e-4 · max(|δ|, 1) of the reference's Schur step, and
    within the reference's own 2e-3 bar of the port's dense step (S = 2
    and 8: the submap count does not move the step); zero at the fixed
    node."""
    jargs, targs = _step_args()
    M = targs[0].shape[0]
    ei, ej, mask = (np.asarray(a) for a in (jargs[1], jargs[2], jargs[5]))
    jpart = js.build_partition(ei, ej, mask, M, S)
    ref = np.asarray(jax.jit(lambda *a: js.schur_delta(jpart, *a))(*jargs))
    out = ts.schur_delta(ts.build_partition(ei, ej, mask, M, S), *targs)
    assert out.dtype == torch.float32 and out.shape == (M, 3)
    out = out.numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_bar(ref))
    dense = _dense(targs)
    np.testing.assert_allclose(out, dense, rtol=0,
                               atol=2e-3 * max(np.abs(dense).max(), 1.0))
    np.testing.assert_array_equal(out[0], 0.0)


def test_bucketed_partition_gives_the_same_delta():
    jargs, targs = _step_args()
    M = targs[0].shape[0]
    ei, ej, mask = (np.asarray(a) for a in (jargs[1], jargs[2], jargs[5]))
    part = ts.build_partition(ei, ej, mask, M, 4)
    a = ts.schur_delta(part, *targs).numpy()
    b = ts.schur_delta(ts.bucket_partition(part), *targs).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_masked_edges_and_factor_apply():
    """A masked edge is left out of the partition and of the system (the
    step equals that of the graph without it); ``schur_factor`` +
    ``schur_apply`` to −b solve the same system as ``schur_delta``, and two
    calls give the same bits."""
    jargs, targs = _step_args()
    poses, ei, ej, means, infos, mask, lam, free = targs
    M = poses.shape[0]
    mask = mask.clone()
    mask[-1] = False  # the last loop edge
    part = ts.build_partition(ei.numpy(), ej.numpy(), mask.numpy(), M, 4)
    d = ts.schur_delta(part, poses, ei, ej, means, infos, mask, lam, free)
    keep = mask.numpy()
    sub = (poses, ei[keep], ej[keep], means[keep], infos[keep],
           mask[keep], lam, free)
    part2 = ts.build_partition(ei.numpy()[keep], ej.numpy()[keep],
                               np.ones(keep.sum(), bool), M, 4)
    np.testing.assert_allclose(d.numpy(), ts.schur_delta(part2, *sub).numpy(),
                               rtol=0, atol=1e-6)
    again = ts.schur_delta(part, poses, ei, ej, means, infos, mask, lam, free)
    assert torch.equal(d, again)
    Hd, Hij, b = lm.normal_equations(*sub[:5], M)
    fac = ts.schur_factor(part2, lm.damped(Hd, lam), Hij, free)
    x = ts.schur_apply(part2, fac, -b * free[:, None], free)
    np.testing.assert_allclose(x.numpy(), d.numpy(), rtol=0,
                               atol=_bar(d.numpy()))


def test_failed_factorization_gives_a_nan_step():
    """An indefinite system (negative information) does not raise: its
    step is NaN, which the LM rejects, as the reference's cho_factor."""
    _jargs, targs = _step_args()
    poses, ei, ej, means, infos, mask, lam, free = targs
    M = poses.shape[0]
    part = ts.build_partition(ei.numpy(), ej.numpy(), mask.numpy(), M, 4)
    d = ts.schur_delta(part, poses, ei, ej, means, -infos, mask, lam, free)
    assert torch.isnan(d).any()


def test_mixed_schur_delta_is_the_references_f64_step():
    """The port's float64 step (a direct Schur solve) against the
    reference's (an f32 Schur factor preconditioning an f64 PCG) on the
    same damped system: the same float64 step."""
    M = 64
    poses, ei, ej, means, infos, mask, free = ring_graph(M)
    jpart = js.build_partition(ei, ej, mask, M, 4)
    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(np.asarray(x, np.float64))  # noqa: E731
        ref = np.asarray(jpg.mixed_schur_delta(
            jpart, f64(poses), jnp.asarray(ei), jnp.asarray(ej), f64(means),
            f64(infos), jnp.asarray(mask), jnp.float64(1e-5),
            jnp.asarray(free)))
    out = tpg.mixed_schur_delta(
        ts.build_partition(ei, ej, mask, M, 4), _t(poses), _t(ei).long(),
        _t(ej).long(), _t(means), _t(infos), _t(mask), np.float64(1e-5),
        _t(free))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-8 * max(np.abs(ref).max(), 1.0))


def test_solver_schur_route_matches_reference():
    """PoseGraphSolver(use_schur=True, schur_submaps=4) on
    tests/test_schur.py's 48-node ring, with use_dense_below lowered so
    that both packages build the partition (at the default 512 both solve
    it densely): poses within 5e-4, final cost within 1e-2 relative."""
    M = 48
    poses, ei, ej, means, infos, _mask, _free = ring_graph(M, seed=3)
    edges = [(int(a), int(b), m, w) for a, b, m, w in
             zip(ei, ej, means.astype(np.float64), infos.astype(np.float64))]
    cfg = SolverConfig(use_schur=True, schur_submaps=4, use_dense_below=32)
    assert tpg._route(M, len(edges), "cpu", cfg) == "schur"
    assert tpg._route(M, len(edges), "cuda", cfg) == "schur"
    before = dict(_dispatch.LAUNCHES)
    (js_, jp), (ts_, tp) = (_jax_solve(cfg, poses, edges),
                            _port_solve(cfg, poses, edges))
    assert _dispatch.LAUNCHES == before
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-4)
    assert ts_.initial_cost == pytest.approx(js_.initial_cost, rel=1e-5)
    assert ts_.final_cost == pytest.approx(js_.final_cost, rel=1e-2,
                                           abs=1e-6)
    assert ts_.final_cost < 0.05 * ts_.initial_cost


def test_f64_schur_route_matches_reference_and_host_arm():
    """The "f64_schur" route (host_direct_fallback=False) on the 160-node
    skip graph: a float64 solve on the solver's device, poses within 5e-5
    (tests/test_pose_graph.py's bar) of the reference's _compute_f64_schur
    and of the port's host f64 arm."""
    init, edges = _skip_edge_graph()
    cfg = SolverConfig(f64_schur_above=64, use_dense_below=32,
                       host_direct_fallback=False, schur_submaps=8)
    s = tpg.PoseGraphSolver(cfg, device="cpu")
    s.add_nodes(range(len(init)), init)
    s.add_constraints([e[0] for e in edges], [e[1] for e in edges],
                      np.asarray([e[2] for e in edges]),
                      informations=np.asarray([e[3] for e in edges]))
    assert tpg._route(s.num_nodes, s.num_edges, "cpu", cfg,
                      s._band_spec) == "f64_schur"
    pending = s.compute_async()
    assert pending._packed.dtype == torch.float64
    ts_, tp = pending.harvest(), s.get_poses()
    js_, jp = _jax_solve(cfg, init, edges)
    hs, hp = _port_solve(dataclasses.replace(cfg, host_direct_fallback=True),
                         init, edges)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tp, hp, rtol=0, atol=5e-5)
    assert ts_.initial_cost == pytest.approx(js_.initial_cost, rel=1e-9)
    assert ts_.final_cost == pytest.approx(hs.final_cost, rel=1e-6)
    assert ts_.final_cost == pytest.approx(js_.final_cost, rel=1e-6)
