"""Port parity: tpu_slam_torch.solver.cr_stream (the streamed CR-LM; its
plain version is solver/cr_lm.cr_lm_plain) against tpu_slam's streamed
pipeline, solver/cr_stream.streamed_cr_lm, run in interpret mode on
test_banded's ring problems at K = 128, the smallest K it takes."""

import numpy as np
import pytest
import torch

from tpu_slam.solver import banded
from tpu_slam.solver import cr_stream as jcr_stream
from tpu_slam_torch import _dispatch
from tpu_slam_torch.solver import cr_lm, cr_stream

from test_banded import ring_problem


def _inputs(M=160, stride=8, min_k=128):
    init, ei, ej, means, infos = ring_problem(M, stride=stride)
    spec = banded.prepare_banded(ei, ej, M, min_k=min_k)
    return (spec, torch.as_tensor(banded.flat_poses_np(spec, init)),
            torch.as_tensor(banded.build_slots_np(spec, means, infos)))


def _reference(spec, pT8, slots, iters):
    import jax.numpy as jnp

    return np.asarray(jcr_stream.streamed_cr_lm(
        jnp.asarray(pT8.numpy()), jnp.asarray(slots.numpy()),
        jnp.float32(1e-4), W=spec.W, K=spec.K, iters=iters,
        sq_min_delta=1e-8, interpret=True))


@pytest.fixture(scope="module")
def ring160():
    """One interpret-mode call of the reference (~85 s, nearly all of it
    tracing and compiling the level pipeline) and the port's solve."""
    spec, pT8, slots = _inputs()
    assert (spec.W, spec.K) == (6, 128)
    ref = _reference(spec, pT8, slots, iters=2)
    out = cr_stream.streamed_cr_lm(pT8, slots, 1e-4, W=spec.W, K=spec.K,
                                   iters=2, sq_min_delta=1e-8).numpy()
    return ref, out


def test_plain_matches_streamed_interpret(ring160):
    ref, out = ring160
    # the same accepted steps and iterations; float32 sums in other orders
    # (measured: poses 1.9e-6, cost 6e-4 relative)
    assert out[3, 2] == ref[3, 2] and out[3, 3] == ref[3, 3]
    np.testing.assert_allclose(out[3, 0], ref[3, 0], rtol=1e-5)
    np.testing.assert_allclose(out[0:3], ref[0:3], atol=1e-4)
    np.testing.assert_allclose(out[3, 1], ref[3, 1], rtol=1e-3)
    assert not out[4:].any() and not out[3, 4:].any()


@pytest.mark.slow
def test_plain_matches_streamed_interpret_to_convergence():
    spec, pT8, slots = _inputs()
    ref = _reference(spec, pT8, slots, iters=12)
    out = cr_stream.streamed_cr_lm(pT8, slots, 1e-4, W=spec.W, K=spec.K,
                                   iters=12, sq_min_delta=1e-8).numpy()
    assert out[3, 1] < 1e-3 * out[3, 0] and ref[3, 1] < 1e-3 * ref[3, 0]
    np.testing.assert_allclose(out[0:3], ref[0:3], atol=1e-4)


@pytest.mark.slow
def test_float32_spread_grows_on_a_large_ring():
    """Why chip_smoke holds the streamed kernel's poses on bench_solver's
    16,384-node ring after 3 iterations and not after 40: the plain
    version in float32 and in float64 stay within 1e-3 m for the first
    steps (measured 1.5e-4 after 3), then part along the ring's soft
    bending modes (measured 5.5e-3 after 10) while χ² falls alike."""
    spec, pT8, slots = _inputs(16384, stride=16)
    assert spec.K == 4096
    gaps = []
    for iters in (3, 10):
        kw = dict(W=spec.W, K=spec.K, iters=iters, sq_min_delta=1e-8)
        a = cr_lm.cr_lm_plain(pT8, slots, 1e-4, **kw)
        b = cr_lm.cr_lm_plain(pT8.double(), slots.double(), 1e-4, **kw)
        np.testing.assert_allclose(float(a[3, 1]), float(b[3, 1]), rtol=1e-3)
        gaps.append(float((a[0:3].double() - b[0:3]).abs().max()))
    assert gaps[0] < 1e-3 < gaps[1], gaps


def test_wrapper_on_cpu_is_the_plain_version():
    spec, pT8, slots = _inputs()
    before = dict(_dispatch.LAUNCHES)
    kw = dict(W=spec.W, K=spec.K, iters=3, sq_min_delta=1e-8)
    a = cr_stream.streamed_cr_lm(pT8, slots, 1e-4, **kw)
    b = cr_lm.cr_lm_plain(pT8, slots, 1e-4, **kw)
    assert torch.equal(a, b)
    assert _dispatch.LAUNCHES == before


def test_kernel_inputs_are_checked():
    # what both CR wrappers check before a launch (cr_lm.check_packed)
    spec, pT8, slots = _inputs()
    cr_lm.check_packed(pT8, slots, spec.W, spec.K)
    for bad in (pT8.double(), pT8[:, :-1], pT8.T.contiguous().T):
        with pytest.raises(ValueError, match="pT8"):
            cr_lm.check_packed(bad, slots, spec.W, spec.K)
    with pytest.raises(ValueError, match="slots"):
        cr_lm.check_packed(pT8, slots[:-1], spec.W, spec.K)


@pytest.mark.parametrize("K", [32, 64, 96, 128, 256, 1000, 1024, 8192])
def test_applicable_agrees_with_reference(K):
    # the reference does not look at W; the kernel takes W in 1..8
    for W in range(1, 9):
        assert cr_stream.streamed_applicable(W, K) == \
            jcr_stream.streamed_applicable(W, K), (W, K)
    assert not cr_stream.streamed_applicable(9, 1024)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    # cr_lm.cu and cr_stream.cu include csrc/cr_edges.cuh: an edit there
    # must not load a library built from the old header
    from tpu_slam_torch import _build

    assert (_build.CSRC / "cr_edges.cuh").exists()
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before


def test_kernel_scratch_size_covers_the_layout():
    # the LM state (16), two pose buffers (3·WK each), the high-node
    # staging rows, D, B, X1, X2 (n²K each), r, Xr, x (nK each) and the two
    # rows of per-block partial sums — the layout csrc/cr_stream.cu carves
    W, K = 6, 4096
    n, WK = 3 * W, W * K
    assert cr_stream.scratch_floats(W, K) == (
        16 + 6 * WK + 2 * W * 12 * WK + 4 * n * n * K + 3 * n * K
        + 2 * (WK // 256))
