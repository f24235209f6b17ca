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
    # cr_lm.cu and cr_stream.cu include csrc/cr_edges.cuh and the warp
    # code csrc/cr_warp.cuh: an edit there must not load a library built
    # from the old header
    from tpu_slam_torch import _build

    for header in ("cr_edges.cuh", "cr_warp.cuh", "cluster.cuh"):
        assert (_build.CSRC / header).exists()
        for kernel in ("cr_lm.cu", "cr_stream.cu"):
            assert f'#include "{header}"' in (_build.CSRC / kernel).read_text()
    real = {name: _build.library_path(name) for name in ("cr_lm", "cr_stream")}
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before
    # the two CR kernels' libraries are named by different sources
    assert real["cr_lm"] != real["cr_stream"]


def test_kernel_scratch_size_covers_the_layout():
    # the LM state (16 floats, the blocks' ticket counter included), two
    # pose buffers (3·WK each), D, B, X1, X2 (n²K each), r, Xr, x (nK
    # each) and the per-block partial sums of ‖δ‖² (one per per-lane
    # block) and χ² (one per edge block of 32 lanes) — the
    # layout csrc/cr_stream.cu carves; the assembly writes D, B and r once,
    # so there is no staging array
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "cr_stream.cu").read_text()
    for W, K in ((6, 4096), (1, 128), (8, 32768), (7, 1024)):
        n, WK = 3 * W, W * K
        sched = cr_stream.stream_schedule(W, K)
        assert sched.lane_blocks == -(-WK // 256)
        assert sched.edge_blocks == -(-WK // 32)
        assert cr_stream.scratch_floats(W, K) == (
            16 + 6 * WK + 4 * n * n * K + 3 * n * K + sched.lane_blocks
            + sched.edge_blocks)
    assert "float* stage" not in src and "STAGE_ROWS" not in src
    assert re.search(r"constexpr int STATE_FLOATS = (\d+);", src)[1] == \
        str(cr_stream.STATE_FLOATS)
    assert re.search(r"constexpr int BLOCK = (\d+);", src)[1] == \
        str(cr_stream.BLOCK)
    # an edge block: a warp of lanes per slot distance, on each side in
    # the assembly (2W ≤ 16 warps, each with its own partial sums)
    assert int(re.search(r"constexpr int LANES = (\d+);", src)[1]) == \
        cr_stream.LANES == 32
    assert "__shared__ float part[2 * 8][12][LANES];" in src
    assert "<<<c.eblk, 64 * c.W, 0, st>>>" in src
    # State: six floats, cur, done and the ticket fit the head's 16 floats
    state = src[src.index("struct State {"):src.index("};", src.index(
        "struct State {"))]
    fields = sum(len(line.split(";")[0].split(","))
                 for line in state.splitlines()[1:] if ";" in line)
    assert fields == 9 <= cr_stream.STATE_FLOATS
    assert "static_assert(sizeof(State) <= STATE_FLOATS * sizeof(float)" in src


def test_kernel_constants_are_the_schedules():
    # what stream_schedule assumes of csrc/cr_stream.cu: the cluster takes
    # at most K_MAX active supernodes, WIDE_WARPS warps a wide block, and
    # the kernel launches the cluster through csrc/cluster.cuh
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "cr_stream.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("K_MAX") == cr_lm.K_MAX == 512
    assert const("WIDE_WARPS") == cr_stream.WIDE_WARPS
    assert const("MAX_WARPS") == cr_lm.MAX_WARPS
    assert const("MAX_CLUSTER") == cr_lm.MAX_CLUSTER
    assert "cluster_config(cr_stream_cluster_kernel<N>" in src
    assert "cudaOccupancyMaxActiveClusters" in (
        _build.CSRC / "cluster.cuh").read_text()


@pytest.mark.parametrize("K", [128, 256, 512, 1024, 4096, 32768])
def test_stream_schedule(K):
    from tpu_slam_torch import _build

    for W in range(1, 9):
        s = cr_stream.stream_schedule(W, K)
        # every level h = 1 … K/2 is eliminated exactly once: grid-wide
        # below h0, in the cluster from h0 on
        levels = list(s.grid_levels) + list(s.cluster_levels)
        assert levels == [1 << i for i in range(K.bit_length() - 1)]
        assert all(h < s.h0 for h in s.grid_levels)
        assert all(h >= s.h0 for h in s.cluster_levels)
        assert s.h0 & (s.h0 - 1) == 0
        # the cluster sees at most CLUSTER_ACTIVE active supernodes (it
        # may take K_MAX), and no wide level runs with that many or fewer
        assert K // s.h0 <= cr_stream.CLUSTER_ACTIVE <= cr_lm.K_MAX
        assert all(K // h > cr_stream.CLUSTER_ACTIVE for h in s.grid_levels)
        # its geometry is the single-launch kernel's at that many: one
        # portable cluster whose warps' slices fit shared memory, a warp
        # for each first-level elimination in at most four rounds
        blocks, warps, smem = s.cluster
        assert (blocks, warps, smem) == cr_lm.launch_geometry(W, K // s.h0)
        assert 1 <= blocks <= _build.MAX_CLUSTER and 1 <= warps <= 8
        assert smem == warps * cr_lm.warp_smem_bytes(W)
        assert smem + _build.SMEM_STATIC_RESERVE <= _build.SMEM_PER_BLOCK
        assert -(-(K // s.h0 // 2) // (blocks * warps)) <= 4
        # the wide levels: a warp per supernode, and their slices fit too
        for h in s.grid_levels:
            assert s.wide_blocks(h) * cr_stream.WIDE_WARPS >= K // (2 * h)
            assert (s.wide_blocks(h) - 1) * cr_stream.WIDE_WARPS < K // (2 * h)
        assert cr_stream.WIDE_WARPS * cr_lm.warp_smem_bytes(W) \
            <= _build.SMEM_PER_BLOCK
        # launches per LM iteration: assembly, (elimination, fold) per wide
        # level, the cluster, a back-substitution per wide level, the
        # candidate and its cost with the LM decision
        assert s.per_iter == 4 + 3 * len(s.grid_levels)
        assert s.per_iter == {256: 7, 512: 10, 1024: 13, 4096: 19,
                              32768: 28}.get(K, 4)
        assert s.lane_blocks == -(-(W * K) // cr_stream.BLOCK)
        assert s.edge_blocks * cr_stream.LANES >= W * K


def test_enqueued_iterations_follow_the_chunks():
    # the host reads done after each chunk: a solve that stops after `run`
    # iterations enqueued the whole chunk it stopped in, and never more
    # than `iters`
    s = cr_stream.stream_schedule(6, 4096)
    assert s.chunk == cr_stream.CHUNK == 4
    assert [s.iterations_enqueued(r, 40) for r in (1, 4, 5, 14, 38, 40)] == \
        [4, 4, 8, 16, 40, 40]
    assert s.iterations_enqueued(3, 3) == 3 and s.iterations_enqueued(9, 10) == 10
    assert s.kernels(14, 40) == 2 + 19 * 16
    assert s.kernels(40, 40) - s.kernels(40, 40) == 0


def test_refused_launch_raises(monkeypatch):
    # a launch the card refuses (here cudaErrorLaunchOutOfResources for
    # the cluster) comes back from cr_stream_launch as a non-zero
    # cudaError_t, and the wrapper's launcher raises: nothing falls back
    from tpu_slam_torch import _build

    class Lib:
        @staticmethod
        def cr_stream_launch(*args):
            return 701

    monkeypatch.setitem(_build._LIBS, "cr_stream", Lib())
    assert len(_build.SIGNATURES["cr_stream"][1]) == 15
    with pytest.raises(RuntimeError, match="cr_stream kernel launch failed"):
        _build.launch("cr_stream", *range(15))
