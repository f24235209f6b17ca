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


def _csr_matvec(Hd, Hij, ei, ej, fm, p):
    """The kernel's node-centric matvec in numpy: node m sums D_m p_m and,
    in CSR order, H_ij p_j (m = i) or H_ijᵀ p_i (m = j), masked as
    cg_matvec masks."""
    M = len(fm)
    row_ptr, inc = pcg_lm._incidence(ei, ej, M)
    x = p * fm[:, None]
    y = np.zeros_like(p)
    for m in range(M):
        acc = Hd[m] @ x[m]
        for code in inc[row_ptr[m]:row_ptr[m + 1]]:
            e, role = code >> 1, code & 1
            acc = acc + (Hij[e].T @ x[ei[e]] if role else Hij[e] @ x[ej[e]])
        y[m] = acc
    return y * fm[:, None] + x * (1.0 - fm[:, None])


def test_node_centric_matvec_matches_dense_product(ring):
    rng = np.random.default_rng(5)
    M, E = len(ring["p"]), len(ring["ei"])
    A = rng.normal(size=(M, 3, 3))
    Hd = A @ A.transpose(0, 2, 1) + 3 * np.eye(3)
    Hij = rng.normal(size=(E, 3, 3))
    ei, ej = ring["ei"], ring["ej"]
    fm = ring["free"].astype(np.float64)
    H = np.zeros((3 * M, 3 * M))
    for m in range(M):
        H[3 * m:3 * m + 3, 3 * m:3 * m + 3] = Hd[m]
    for e in range(E):
        i, j = 3 * ei[e], 3 * ej[e]
        H[i:i + 3, j:j + 3] += Hij[e]
        H[j:j + 3, i:i + 3] += Hij[e].T
    F = np.repeat(fm, 3)
    # cg_matvec masks p before the product, so a fixed node's rows and
    # columns are zero (its residual is zero, so CG never moves it)
    Hg = H * F[:, None] * F[None, :]
    p = rng.normal(size=(M, 3))
    np.testing.assert_allclose(_csr_matvec(Hd, Hij, ei, ej, fm, p),
                               (Hg @ p.reshape(-1)).reshape(M, 3),
                               rtol=1e-12, atol=1e-12)


def _chain_graph(n, strides=(8, 32)):
    """chip_smoke.exact_chain's edges at n nodes: a chain and skip edges
    every s nodes for each s in ``strides`` (it does not band)."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    for s in strides:
        pairs += [(i, i + s) for i in range(0, n - s, s)]
    ei, ej = np.array(pairs).T
    return ei, ej


@pytest.mark.parametrize("M,variant,blocks", [
    (1056, "shared", 5),  # the offline mission's loop-closed graph size
    (129, "shared", 1),  # the fewest nodes the card's route sends it
    (2999, "shared", 6),  # the most under f64_schur_above, over 6 SMs
    (9000, "device", 5),  # past f64_schur_above (a route with it off)
])
def test_variant_choice_by_hot_set_size(M, variant, blocks):
    ei, ej = _chain_graph(M)
    row_ptr, _inc = pcg_lm._incidence(ei, ej, M)
    nb, logS, qmax, smem = pcg_lm.launch_geometry(row_ptr)
    assert nb == blocks
    assert (smem > 0) == (variant == "shared")
    if smem:
        assert smem == pcg_lm.hot_set_bytes(1 << logS, qmax)
        assert smem + pcg_lm.SMEM_STATIC_RESERVE <= pcg_lm.SMEM_PER_BLOCK
    else:
        assert pcg_lm.hot_set_bytes(1 << logS, qmax) \
            + pcg_lm.SMEM_STATIC_RESERVE > pcg_lm.SMEM_PER_BLOCK


@pytest.mark.parametrize("M", [1, 3, 255, 256, 257, 1056, 2048, 2049, 8192,
                               8193, 20000])
def test_launch_geometry_cuts_the_nodes_into_block_ranges(M):
    ei, ej = _chain_graph(max(M, 2), strides=(3,))
    ei, ej = ei[ej < M], ej[ej < M]
    row_ptr, _inc = pcg_lm._incidence(ei, ej, M)
    blocks, logS, qmax, smem = pcg_lm.launch_geometry(row_ptr)
    S = 1 << logS
    assert 1 <= blocks <= pcg_lm.MAX_CLUSTER
    assert S >= pcg_lm.MIN_NODES_PER_BLOCK
    assert (blocks - 1) * S < M <= blocks * S  # no empty block
    ranges = [(b * S, min((b + 1) * S, M)) for b in range(blocks)]
    assert qmax == max(row_ptr[e] - row_ptr[s] for s, e in ranges)
    assert smem in (0, pcg_lm.hot_set_bytes(S, qmax))


def test_hot_set_and_scratch_follow_the_kernel_layout():
    # pcg_lm.cu's hot_words and the scratch it carves
    from tpu_slam_torch import _build

    src = (_build.CSRC / "pcg_lm.cu").read_text()
    assert "return 37 * S + 11 * qmax + 1;" in src
    assert "uv6" not in src  # the node-centric matvec: no edge staging
    assert "launch_cluster(" in src  # csrc/cluster.cuh: one cluster
    assert "cudaLaunchAttributeClusterDimension" in (
        _build.CSRC / "cluster.cuh").read_text()
    assert "<<<" not in src  # the cluster launch only
    for name in ("MAX_THREADS", "MAX_CLUSTER"):
        import re
        assert int(re.search(rf"constexpr int {name} = (\d+);", src)[1]) \
            == getattr(pcg_lm, name)
    S, qmax = 256, 700
    # x, p, pn, z, r, Ap, the diagonal block and its inverse (4 each as
    # float4, 2 each as float2) a node; H (9) and (edge and role, other
    # node) (2) an incidence; the row pointers (S + 1)
    assert pcg_lm.hot_set_bytes(S, qmax) == 4 * (
        6 * 4 * S + 2 * 6 * S + 9 * qmax + 2 * qmax + S + 1)
    M, E, blocks = 1000, 1200, 4
    # the device-memory hot set (36 floats a node slot, 9 an incidence),
    # P, C, b3 (3M each), the assembly's Hii6, Hjj6 (6E), bi3, bj3 (3E)
    assert pcg_lm.scratch_floats(M, E, blocks, S) == (
        36 * blocks * S + 9 * 2 * E + 9 * M + 18 * E)


def test_refused_launch_raises(monkeypatch):
    from tpu_slam_torch import _build

    class Lib:
        @staticmethod
        def pcg_lm_launch(*args):
            return 1  # cudaErrorInvalidValue: e.g. shared memory short

    monkeypatch.setitem(_build._LIBS, "pcg_lm", Lib())
    with pytest.raises(RuntimeError, match="pcg_lm kernel launch failed"):
        _build.launch("pcg_lm", *range(25))


@pytest.mark.parametrize("restarts", [1, 2])
def test_plain_pcg_matches_cg_solve(ring, restarts):
    """The plain PCG of one LM step (``_pcg``) against the reference's
    ``cg_solve`` on the same normal equations, at a CG budget too short
    for one run (8 iterations on the 48-node ring), with and without a
    restart: the same iterations in another float32 sum order (measured
    4e-7 and 1e-6 of the solution's largest entry)."""
    from tpu_slam_torch.solver.lm import normal_equations

    t = {k: torch.as_tensor(v) for k, v in ring.items()}
    M = len(ring["p"])
    Hd, Hij, b = normal_equations(t["p"], t["ei"], t["ej"], t["means"],
                                  t["infos"], M)
    fm = t["free"].to(torch.float32)
    lam = 1e-4
    port, _steps = pcg_lm._pcg(Hd, Hij, b, t["ei"], t["ej"], fm, lam, 8,
                               1e-10, restarts)
    port = port.numpy()
    ref = np.asarray(pg.cg_solve(
        jnp.asarray(Hd.numpy()), jnp.asarray(Hij.numpy()),
        jnp.asarray(ring["ei"], jnp.int32), jnp.asarray(ring["ej"], jnp.int32),
        jnp.asarray(b.numpy()), jnp.float32(lam), jnp.asarray(ring["free"]),
        8, 1e-10, restarts=restarts))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-5 * scale)
    if restarts == 2:  # the restart moved the solution on
        one, _steps = pcg_lm._pcg(Hd, Hij, b, t["ei"], t["ej"], fm, lam, 8,
                                  1e-10)
        assert np.abs(port - one.numpy()).max() > 1e-3 * scale


def test_entry_point_takes_the_restart_count():
    """pcg_lm.cu's C entry point and its ctypes signature agree, with the
    restart count the argument before the stream, and the kernel keeps a
    code path without the restart loop (restarts = 1)."""
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "pcg_lm.cu").read_text()
    params = re.search(r'extern "C" int pcg_lm_launch\((.*?)\)\s*\{', src,
                       re.S)[1].split(",")
    assert len(params) == len(_build.SIGNATURES["pcg_lm"][1])
    assert params[-2].split() == ["int", "restarts"]
    assert "pcg_lm_kernel<true, false>" in src
    assert "pcg_lm_kernel<false, false>" in src
    with pytest.raises(ValueError, match="cg_restarts"):
        pcg_lm.fused_lm_solve(*(torch.zeros(1),) * 7, 1e-4, iters=1,
                              cg_iters=1, cg_tol=0.0, sq_min_delta=0.0,
                              cg_restarts=0)


class _CountingTorch:
    """``torch`` for the module under test, counting ``torch.where``."""

    def __init__(self):
        self.wheres = 0

    def where(self, *args, **kwargs):
        self.wheres += 1
        return torch.where(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(torch, name)


@pytest.mark.parametrize("restarts", [1, 2])
@pytest.mark.parametrize("cg_tol", [0.0, 1e-6])
def test_plain_version_counts_its_cg_steps(ring, monkeypatch, restarts,
                                           cg_tol):
    """Row 4, lane 0 of the plain version holds the CG steps it ran over
    the solve, as the kernel's does, counted by hand from ``_pcg``'s loop:
    each CG step takes two guarded divisions (``torch.where``) and each
    LM iteration's preconditioner one. With no stopping threshold every
    LM iteration runs ``cg_iters`` steps a restart; with one, fewer; never
    more than ``iters × cg_iters × restarts``."""
    counting = _CountingTorch()
    monkeypatch.setattr(pcg_lm, "torch", counting)
    t = {k: torch.as_tensor(v) for k, v in ring.items()}
    iters, cg_iters = 6, 40
    packed = pcg_lm.pcg_lm_plain(
        t["p"], t["ei"], t["ej"], t["means"], t["infos"], t["mask"],
        t["free"], 1e-4, iters=iters, cg_iters=cg_iters, cg_tol=cg_tol,
        sq_min_delta=1e-8, cg_restarts=restarts)
    lm_its, steps = int(packed[3, 3]), int(packed[4, 0])
    assert float(packed[4, 0]) == steps
    assert (counting.wheres - lm_its) % 2 == 0
    assert steps == (counting.wheres - lm_its) // 2
    cap = lm_its * cg_iters * restarts
    assert 0 < steps <= iters * cg_iters * restarts
    if cg_tol == 0.0:
        assert steps == cap
    else:
        assert steps < cap
