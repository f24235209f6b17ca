"""Port parity: tpu_slam_torch.solver.cr_lm (the plain version of the CR-LM
kernel) against tpu_slam.solver.banded's numpy oracle and the reference
Pallas kernel in interpret mode, on test_banded's ring problems."""

import numpy as np
import pytest
import torch

from tpu_slam.solver import banded
from tpu_slam_torch import _dispatch
from tpu_slam_torch.solver import cr_lm

from test_banded import dense_f64_delta, ring_problem


def _inputs(M, stride=16, min_k=128):
    init, ei, ej, means, infos = ring_problem(M, stride=stride)
    spec = banded.prepare_banded(ei, ej, M, min_k=min_k)
    slots = torch.as_tensor(banded.build_slots_np(spec, means, infos))
    pT8 = torch.as_tensor(banded.flat_poses_np(spec, init))
    return init, ei, ej, means, infos, spec, slots, pT8


def test_assembly_matches_oracle():
    init, _ei, _ej, means, infos, spec, slots, pT8 = _inputs(160)
    lam = 1e-4
    D, B, rhs = banded.assemble_supernodes(
        spec, init.astype(np.float32), means, infos, lam)
    Dt, Bt, rt = cr_lm._assemble(pT8[0:3], slots, pT8[3], np.float32(lam),
                                 spec.W, spec.K)
    # float32 sums in another order: relative to the largest entry
    np.testing.assert_allclose(Dt.numpy(), D, atol=2e-6 * np.abs(D).max())
    np.testing.assert_allclose(Bt.numpy(), B, atol=2e-6 * np.abs(D).max())
    np.testing.assert_allclose(rt.numpy(), rhs, atol=2e-6 * np.abs(rhs).max())


def test_cr_step_matches_f64_dense():
    # test_banded.py's one-step check, with its bound
    M = 160
    init, ei, ej, means, infos, spec, slots, pT8 = _inputs(M)
    lam = 1e-4
    D, B, r = cr_lm._assemble(pT8[0:3], slots, pT8[3], np.float32(lam),
                              spec.W, spec.K)
    delta = banded.flat_delta(spec, cr_lm.cr_solve(D, B, r).numpy())
    dref = dense_f64_delta(M, init.astype(np.float32).astype(np.float64),
                           ei, ej, means.astype(np.float64),
                           infos.astype(np.float64), lam)
    assert np.abs(delta - dref).max() < 2e-4
    assert np.all(delta[0] == 0.0)  # node 0 gauge-fixed


def test_cr_solve_matches_oracle():
    init, _ei, _ej, means, infos, spec, _slots, _pT8 = _inputs(96)
    D, B, rhs = banded.assemble_supernodes(
        spec, init.astype(np.float32), means, infos, 1e-4)
    x = banded.cr_solve(D, B, rhs)
    xt = cr_lm.cr_solve(*(torch.as_tensor(a) for a in (D, B, rhs))).numpy()
    np.testing.assert_allclose(xt, x, atol=1e-4 * np.abs(x).max())


def _oracle_lm(spec, init, ei, ej, means, infos, iters):
    """test_banded.py's numpy doSPA loop around banded.cr_solve."""
    def cost(p):
        acc = np.float32(0.0)
        for e in range(len(ei)):
            pa = p[ei[e]].astype(np.float32)
            pb = p[ej[e]].astype(np.float32)
            c, s = np.cos(pa[2]), np.sin(pa[2])
            dx, dy = pb[0] - pa[0], pb[1] - pa[1]
            r = np.array([
                c * dx + s * dy - means[e][0],
                -s * dx + c * dy - means[e][1],
                np.arctan2(np.sin(pb[2] - pa[2] - means[e][2]),
                           np.cos(pb[2] - pa[2] - means[e][2]))], np.float32)
            acc += r @ infos[e] @ r
        return float(acc)

    poses = init.astype(np.float64).copy()
    lam, laminc, cst, good = 1e-4, 2.0, cost(poses), 0
    for _ in range(iters):
        D, B, rhs = banded.assemble_supernodes(
            spec, poses.astype(np.float32), means, infos, lam)
        delta = banded.flat_delta(spec, banded.cr_solve(D, B, rhs))
        if float(np.sum(delta.astype(np.float64) ** 2)) < 1e-8:
            break
        cand = poses + delta
        cand[:, 2] = np.arctan2(np.sin(cand[:, 2]), np.cos(cand[:, 2]))
        nc = cost(cand)
        if nc < cst:
            poses, cst, lam, good = cand, nc, lam * 0.5, good + 1
        else:
            lam, laminc = lam * laminc, laminc * 2.0
    return poses, cst, good


def test_plain_lm_matches_oracle_lm():
    init, ei, ej, means, infos, spec, slots, pT8 = _inputs(72, 8, min_k=32)
    out = cr_lm.cr_lm_plain(pT8, slots, 1e-4, W=spec.W, K=spec.K, iters=3,
                            sq_min_delta=1e-8)
    poses, cst, good = _oracle_lm(spec, init, ei, ej, means, infos, 3)
    assert int(out[3, 2]) == good
    np.testing.assert_allclose(
        banded.unflatten_poses_np(spec, out.numpy())[1:], poses[1:], atol=1e-4)
    np.testing.assert_allclose(float(out[3, 1]), cst, rtol=1e-3, atol=1e-4)


def test_plain_lm_converges_and_reports_stats():
    _init, _ei, _ej, _m, _i, spec, slots, pT8 = _inputs(160)
    out = cr_lm.cr_lm_plain(pT8, slots, 1e-4, W=spec.W, K=spec.K, iters=40,
                            sq_min_delta=1e-8)
    cost0, cost, good, iters = out[3, :4].tolist()
    assert cost < 1e-3 * cost0 and 0 < good <= iters < 40
    assert not out[4:].any() and not out[3, 4:].any()
    # gauge: the fixed node keeps its pose
    f0 = spec.flat_of_orig[0]
    assert torch.equal(out[0:3, f0], pT8[0:3, f0])


def test_wrapper_on_cpu_is_the_plain_version():
    _init, _ei, _ej, _m, _i, spec, slots, pT8 = _inputs(72, 8, min_k=32)
    before = dict(_dispatch.LAUNCHES)
    kw = dict(W=spec.W, K=spec.K, iters=5, sq_min_delta=1e-8)
    a = cr_lm.fused_cr_lm(pT8, slots, 1e-4, **kw)
    b = cr_lm.cr_lm_plain(pT8, slots, 1e-4, **kw)
    assert torch.equal(a, b)
    assert _dispatch.LAUNCHES == before


def test_kernel_launch_bound_is_the_route_split():
    # the route sends K ≤ K_MAX supernodes to the kernel, one thread each:
    # the kernel must be compiled for that many threads a block (without
    # the bound its registers kept 512 threads from launching)
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "cr_lm.cu").read_text()
    assert re.search(r"constexpr int K_MAX = (\d+);", src)[1] == str(cr_lm.K_MAX)
    assert "__launch_bounds__(K_MAX) cr_lm_kernel" in src


def test_kernel_scratch_size_covers_the_layout():
    # P, C (3·WK each), D, B, X1, X2 (n²K each), r, Xr, x (nK each) and the
    # high-node staging rows — the layout csrc/cr_lm.cu carves up
    W, K = 4, 256
    n = 3 * W
    assert cr_lm.scratch_floats(W, K) == (
        6 * W * K + 4 * n * n * K + 3 * n * K + 2 * W * 12 * W * K)


@pytest.mark.slow
def test_plain_lm_matches_fused_interpret():
    """The reference kernel (interpret mode), 3 LM iterations, against the
    port's plain version (test_banded.py:127-143's case)."""
    import jax.numpy as jnp

    from tpu_slam.solver.pallas_cr_lm import fused_cr_lm

    _init, _ei, _ej, _m, _i, spec, slots, pT8 = _inputs(72, 8, min_k=32)
    assert spec.K == 32
    ref = np.asarray(fused_cr_lm(
        jnp.asarray(pT8.numpy()), jnp.asarray(slots.numpy()),
        jnp.float32(1e-4), W=spec.W, K=spec.K, iters=3, sq_min_delta=1e-8,
        interpret=True))
    out = cr_lm.cr_lm_plain(pT8, slots, 1e-4, W=spec.W, K=spec.K, iters=3,
                            sq_min_delta=1e-8).numpy()
    assert int(out[3, 2]) == int(ref[3, 2])
    np.testing.assert_allclose(out[0:3], ref[0:3], atol=1e-3)
    np.testing.assert_allclose(out[3, 1], ref[3, 1], rtol=1e-3, atol=1e-4)
