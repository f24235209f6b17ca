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
    # the route sends K ≤ K_MAX supernodes to the kernel, one cluster of
    # warps, a warp per active supernode: the kernel must be compiled for
    # the most threads a block of the geometry takes, and its limits must
    # be the wrapper's
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "cr_lm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("K_MAX") == cr_lm.K_MAX
    assert const("MAX_WARPS") == cr_lm.MAX_WARPS
    assert const("MAX_CLUSTER") == cr_lm.MAX_CLUSTER
    assert "constexpr int MAX_THREADS = 32 * MAX_WARPS;" in src
    assert "__launch_bounds__(MAX_THREADS, 1)" in src
    assert "launch_cluster(" in src  # csrc/cluster.cuh: one cluster
    assert "cudaLaunchAttributeClusterDimension" in (
        _build.CSRC / "cluster.cuh").read_text()
    assert "<<<" not in src  # no plain launch: the cluster launch only
    widest = max(cr_lm.launch_geometry(W, K)[1]
                 for W in range(1, 9) for K in (32, 64, 128, 256, 512))
    assert widest <= cr_lm.MAX_WARPS


def test_kernel_scratch_size_covers_the_layout():
    # P, C (3·WK each), D, B, X1, X2 (n²K each, a supernode's block
    # contiguous), r, Xr, x (nK each) and the high-node staging rows — the
    # layout csrc/cr_lm.cu carves up
    W, K = 4, 256
    n = 3 * W
    assert cr_lm.scratch_floats(W, K) == (
        6 * W * K + 4 * n * n * K + 3 * n * K + 2 * W * 12 * W * K)
    from tpu_slam_torch import _build

    # warp_floats lives in the warp code both CR kernels share
    src = (_build.CSRC / "cr_warp.cuh").read_text()
    assert "return 5 * n * n + 2 * n;" in src  # warp_floats
    assert '#include "cr_warp.cuh"' in (_build.CSRC / "cr_lm.cu").read_text()
    for W in range(1, 9):
        n = 3 * W
        assert cr_lm.warp_smem_bytes(W) == 4 * (5 * n * n + 2 * n)
        # the elimination (factor, 2n + 1 right-hand sides, pivots) and
        # the back-substitution (2n² + 2n) fit the survivor's slice
        assert 4 * (n * (n | 1) + n * (2 * n + 1) + n) \
            <= cr_lm.warp_smem_bytes(W)
        assert 4 * (2 * n * n + 2 * n) <= cr_lm.warp_smem_bytes(W)


@pytest.mark.parametrize("K", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("W", range(1, 9))
def test_launch_geometry_fits_the_card_and_covers_a_level(W, K):
    blocks, warps, smem = cr_lm.launch_geometry(W, K)
    assert 1 <= blocks <= cr_lm.MAX_CLUSTER  # one portable cluster
    assert 1 <= warps <= cr_lm.MAX_WARPS and 32 * warps <= 1024
    assert smem == warps * cr_lm.warp_smem_bytes(W)
    assert smem + cr_lm.SMEM_STATIC_RESERVE <= 232_448  # 227 KB a block
    # the kernel's strided loop gives each of a level's K/2 eliminations
    # to exactly one warp, in at most four rounds (K = 512); the cluster
    # is as wide as it may be before a warp takes two
    nwarps = blocks * warps
    owners = [j % nwarps for j in range(K // 2)]
    assert sorted(set(owners)) == list(range(min(nwarps, K // 2)))
    assert -(-(K // 2) // nwarps) <= 4
    assert nwarps >= min(K // 2, cr_lm.MAX_CLUSTER * cr_lm.MAX_WARPS)
    # assembly: each block an even chunk of the W·K flat lanes, at most
    # four a thread
    assert 4 * nwarps * 32 >= W * K


def test_refused_launch_raises(monkeypatch):
    # a launch the card refuses comes back from cr_lm_launch as a non-zero
    # cudaError_t (here cudaErrorLaunchOutOfResources), and the wrapper's
    # launcher raises: nothing falls back to the plain version
    from tpu_slam_torch import _build

    class Lib:
        @staticmethod
        def cr_lm_launch(*args):
            return 701

    monkeypatch.setitem(_build._LIBS, "cr_lm", Lib())
    with pytest.raises(RuntimeError, match="cr_lm kernel launch failed"):
        _build.launch("cr_lm", *range(13))


@pytest.mark.parametrize("W,K", [(0, 64), (9, 64), (4, 16), (4, 1024),
                                 (4, 96)])
def test_wrapper_refuses_what_the_kernel_does_not_take(W, K):
    with pytest.raises(ValueError, match="CR-LM kernel takes"):
        cr_lm.check_launch(W, K)


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
