"""Port parity: tpu_slam_torch.solver.pcg_lm (the plain version of the
PCG-LM kernel) against the reference's XLA LM program (CG arm) and its
Pallas kernel in interpret mode, on test_pose_graph's ring."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.solver import pose_graph as pg
from tpu_slam.solver.pallas_lm import fused_lm_solve as jax_fused_lm
from tpu_slam_torch import _dispatch
from tpu_slam_torch.solver import pcg_lm

from test_pose_graph import ring_graph


@pytest.fixture(scope="module")
def ring():
    """test_fused_lm_matches_xla's case: a noisy 48-node ring."""
    gt, edges = ring_graph(n=48, noise=0.015, seed=4)
    rng = np.random.default_rng(2)
    init = (gt + rng.normal(0, 0.08, gt.shape)
            * (np.arange(len(gt)) > 0)[:, None]).astype(np.float32)
    M, E = len(gt), len(edges)
    info = np.diag([100.0, 100.0, 400.0])
    return dict(
        p=init, ei=np.asarray([e[0] for e in edges]),
        ej=np.asarray([e[1] for e in edges]),
        means=np.stack([e[2] for e in edges]).astype(np.float32),
        infos=np.tile(info, (E, 1, 1)).astype(np.float32),
        mask=np.ones(E, bool), free=np.arange(M) > 0,
    )


KW = dict(iters=25, cg_iters=50, cg_tol=1e-10, sq_min_delta=1e-8)


def _port(g):
    t = {k: torch.as_tensor(v) for k, v in g.items()}
    return pcg_lm.fused_lm_solve(
        t["p"], t["ei"], t["ej"], t["means"], t["infos"], t["mask"],
        t["free"], 1e-4, **KW)


def test_plain_matches_xla_lm_program(ring):
    ref_fn = functools.partial(
        pg._lm_loop_program, M=len(ring["p"]), use_dense=False, iters=25,
        cg_iterations=50, cg_tolerance=1e-10, schur_part=None,
    )
    j = {k: jnp.asarray(v) for k, v in ring.items()}
    pr, c0r, cr, gr = jax.jit(ref_fn)(
        j["p"], jnp.float32(1e-4), j["ei"].astype(jnp.int32),
        j["ej"].astype(jnp.int32), j["means"], j["infos"], j["mask"],
        j["free"])
    poses, c0, c, _it, good, packed = _port(ring)
    assert float(c0) == pytest.approx(float(c0r), rel=1e-5)
    assert float(c) == pytest.approx(float(cr), rel=1e-2, abs=1e-4)
    np.testing.assert_allclose(poses.numpy(), np.asarray(pr), atol=3e-3)
    assert packed.shape == (8, len(ring["p"]))


def test_plain_matches_fused_interpret(ring):
    j = {k: jnp.asarray(v) for k, v in ring.items()}
    pf, c0f, cf, itf, gf, _ = jax_fused_lm(
        j["p"], j["ei"].astype(jnp.int32), j["ej"].astype(jnp.int32),
        j["means"], j["infos"], j["mask"], j["free"], 1e-4, interpret=True,
        **KW)
    poses, c0, c, _it, _good, _ = _port(ring)
    # test_fused_lm_matches_xla's bounds: near the optimum the f32 sum
    # order decides which tiny steps are accepted, so accept counts may
    # differ while cost and poses agree
    assert float(c0) == pytest.approx(float(c0f), rel=1e-5)
    assert float(c) == pytest.approx(float(cf), rel=1e-2, abs=1e-4)
    np.testing.assert_allclose(poses.numpy(), np.asarray(pf), atol=3e-3)


def test_gauge_node_fixed_and_masked_edges_ignored(ring):
    g = dict(ring)
    poses, *_ = _port(g)
    np.testing.assert_array_equal(poses.numpy()[0], ring["p"][0])
    # an extra masked edge with an absurd mean changes nothing
    g2 = {k: v.copy() for k, v in ring.items()}
    g2["ei"] = np.append(g2["ei"], 3)
    g2["ej"] = np.append(g2["ej"], 30)
    g2["means"] = np.vstack([g2["means"], [[50.0, -50.0, 1.0]]]).astype(
        np.float32)
    g2["infos"] = np.concatenate([g2["infos"], g2["infos"][:1]])
    g2["mask"] = np.append(g2["mask"], False)
    poses2, *_ = _port(g2)
    np.testing.assert_array_equal(poses2.numpy(), poses.numpy())


def test_wrapper_on_cpu_counts_no_launch(ring):
    before = dict(_dispatch.LAUNCHES)
    _port(ring)
    assert _dispatch.LAUNCHES == before


def test_incidence_lists_every_edge_end_once():
    ei = np.array([0, 1, 2, 0, 3])
    ej = np.array([1, 2, 3, 3, 1])
    row_ptr, inc = pcg_lm._incidence(ei, ej, 5)
    assert row_ptr.tolist() == [0, 2, 5, 7, 10, 10]
    for m in range(5):
        for code in inc[row_ptr[m]:row_ptr[m + 1]]:
            e, role = code >> 1, code & 1
            assert (ej if role else ei)[e] == m
    assert sorted(inc.tolist()) == list(range(10))
