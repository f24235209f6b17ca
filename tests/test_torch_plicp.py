"""Port parity: tpu_slam_torch's matching, PL-ICP (the plain version of the
PL-ICP kernel) and matcher factories against tpu_slam's, on the same
seeded numpy inputs. The JAX side runs its XLA path, and its Pallas kernel
in interpret mode, as tpu_slam's own tests do on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import geometry as geo
from tpu_slam import geometry_np as gnp
from tpu_slam.config import PLICPConfig, ScanConfig
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.models.offline import _loop_candidates
from tpu_slam.ops import matching as jmatch
from tpu_slam.ops.pallas.plicp_fused import plicp_match_fused as jax_fused
from tpu_slam.ops.plicp import plicp_match as jax_plicp
from tpu_slam.parallel import distributed_step as jds
from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch import config as tconfig
from tpu_slam_torch.ops import matching as tmatch
from tpu_slam_torch.ops.cuda import plicp_fused as cp
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.plicp import plicp_match
from tpu_slam_torch.parallel import distributed_step as tds

from test_offline import _corridor_mission
from test_torch_host_copies import port_config as _port


def _pairs(n_pairs, delta=(0.07, -0.03, 0.05), n=360):
    """test_matching's two-scan recipe: one world rendered from two poses;
    returns numpy (src, src_valid, tgt, tgt_valid) stacks."""
    cfg = ScanConfig(num_beams=n)
    out = []
    for seed in range(n_pairs):
        world = sim.office_world(seed=seed)
        p0 = np.array([0.3, -0.2, 0.4])
        p1 = gnp.compose(p0, np.asarray(delta))
        seq = sim.simulate_sequence(
            world, np.stack([p0, p1]), cfg, noise_std=0.002, seed=seed
        )
        s = make_scan(seq.ranges, cfg)
        pts = np.asarray(s.points())
        v = np.asarray(s.valid)
        out.append((pts[1], v[1], pts[0], v[0]))
    return [np.stack(x) for x in zip(*out)]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_nearest_neighbor_matches_reference():
    rng = np.random.default_rng(0)
    src = rng.normal(0, 3, (4, 50, 2)).astype(np.float32)
    tgt = rng.normal(0, 3, (4, 70, 2)).astype(np.float32)
    tv = rng.random((4, 70)) > 0.2
    ji, jd = jmatch.nearest_neighbor(*_j(src, tgt, tv))
    ti, td = tmatch.nearest_neighbor(*_t(src, tgt, tv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    j2 = jmatch.second_point_on_segment(ji, *_j(src, tgt, tv))
    t2 = tmatch.second_point_on_segment(ti, *_t(src, tgt, tv))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_nearest_neighbor_ties_and_masking():
    # first-argmin ties; an invalid closer target is ignored
    src = torch.tensor([[0.0, 0.0]])
    tgt = torch.tensor([[1.0, 0.0], [0.01, 0.0], [-1.0, 0.0], [0.0, 1.0]])
    valid = torch.tensor([True, False, True, True])
    idx, d2 = tmatch.nearest_neighbor(src, tgt, valid)
    assert int(idx[0]) == 0
    np.testing.assert_allclose(float(d2[0]), 1.0, atol=1e-6)


@pytest.mark.parametrize("qs", [(0.9, 0.7), (0.0, 1.0), (0.5,)])
def test_masked_quantiles_match_reference(qs):
    rng = np.random.default_rng(1)
    x = rng.random((6, 37)).astype(np.float32)
    m = rng.random((6, 37)) > 0.3
    m[0] = False  # an empty row
    m[1, :11] = True  # 0.9 * 10 sits on an integer boundary in float64
    m[1, 11:] = False
    ref = jmatch.masked_quantiles(*_j(x, m), qs)
    out = tmatch.masked_quantiles(*_t(x, m), qs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _assert_plicp_close(out, ref):
    # test_matching.py's bounds for the fused-vs-XLA comparison
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_allclose(out.covariance.numpy(),
                               np.asarray(ref.covariance), rtol=1e-3, atol=1e-9)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))


def test_plicp_plain_matches_xla_path():
    arrays = _pairs(4)
    cfg = PLICPConfig()
    guess = np.zeros((4, 3), np.float32)
    ref = jax_plicp(*_j(*arrays), cfg, init_pose=jnp.asarray(guess))
    out = plicp_match(*_t(*arrays), _port(cfg),
                      init_pose=torch.as_tensor(guess))
    _assert_plicp_close(out, ref)
    np.testing.assert_allclose(out.error.numpy(), np.asarray(ref.error),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(out.pose.numpy(), [[0.07, -0.03, 0.05]] * 4,
                               atol=0.01)


def test_plicp_plain_matches_fused_interpret():
    arrays = _pairs(3)
    cfg = PLICPConfig()
    ref = jax_fused(*_j(*arrays), cfg, interpret=True)
    out = plicp_match(*_t(*arrays), _port(cfg))
    _assert_plicp_close(out, ref)


def test_plicp_sanitizes_nonfinite_invalid_beams():
    src, sv, tgt, tv = _pairs(1)
    src = src.copy()
    tgt = tgt.copy()
    src[0, ~sv[0]] = np.inf
    tgt[0, ~tv[0]] = np.nan
    cfg = PLICPConfig()
    ref = jax_plicp(*_j(src, sv, tgt, tv), cfg)
    out = plicp_match(*_t(src, sv, tgt, tv), _port(cfg))
    assert np.all(np.isfinite(out.pose.numpy()))
    _assert_plicp_close(out, ref)


def test_wrapper_on_cpu_is_the_plain_version():
    arrays = _t(*_pairs(2))
    cfg = tconfig.PLICPConfig()
    before = dict(_dispatch.LAUNCHES)
    a = plicp_match_fused(*arrays, cfg)
    b = plicp_match(*arrays, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert _dispatch.LAUNCHES == before  # no kernel launched on the CPU


def test_route_rejects_other_devices():
    assert _dispatch.route(torch.zeros(1)) == "cpu"
    with pytest.raises(ValueError):
        _dispatch.route(torch.zeros(1, device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("plicp_fused")
    # the library name follows the source: one cache entry per content
    assert _build.library_path("plicp_fused") != _build.library_path("cr_lm")


# --- matcher factories over a mission store -------------------------------


@pytest.fixture(scope="module")
def store():
    """The corridor mission (128 beams) as a ranges store + direction table,
    with ground-truth loop candidates, in both packages' tensors."""
    cfg, scans, seq, odom = _corridor_mission()
    ranges = np.asarray(scans.ranges)
    valid = np.asarray(scans.valid)
    a0 = np.asarray(scans.angles)[0]
    st = np.where(valid & np.isfinite(ranges), ranges, 0.0).astype(np.float32)
    dirs = np.stack([np.cos(a0), np.sin(a0)], -1).astype(np.float32)
    return cfg, seq, odom, (st, valid, dirs)


def test_packed_matcher_matches_reference(store):
    cfg, _seq, odom, arrays = store
    si = np.arange(1, 17, dtype=np.int32)
    ti = np.arange(0, 16, dtype=np.int32)
    g = gnp.relative(odom[ti], odom[si]).astype(np.float32)
    ref = np.asarray(jds.make_packed_indexed_matcher(cfg)(
        *_j(*arrays), *_j(si, ti, g)))
    out = tds.make_packed_indexed_matcher(_port(cfg))(
        *_t(*arrays), *_t(si.astype(np.int64), ti.astype(np.int64), g))
    assert out.shape == (16, 14) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:, :4].numpy(), ref[:, :4], atol=1e-5)
    np.testing.assert_array_equal(out[:, 4].numpy(), ref[:, 4])
    np.testing.assert_allclose(out[:, 5:].numpy(), ref[:, 5:], rtol=1e-3,
                               atol=1e-9)


def test_chain_matcher_matches_reference(store):
    cfg, _seq, odom, arrays = store
    B = 32
    si = np.arange(1, B + 1, dtype=np.int32)
    ti = np.arange(0, B, dtype=np.int32)
    g = gnp.relative(odom[ti], odom[si]).astype(np.float32)
    pose0 = odom[0].astype(np.float32)
    ref = np.asarray(jds.make_chain_matcher(cfg)(
        *_j(*arrays), *_j(si, ti, g, pose0)))
    out = tds.make_chain_matcher(_port(cfg))(
        *_t(*arrays), *_t(si.astype(np.int64), ti.astype(np.int64), g, pose0))
    assert out.shape == (2 * B + 1, 14)
    out = out.numpy()
    np.testing.assert_allclose(out[:B, :4], ref[:B, :4], atol=1e-5)
    np.testing.assert_array_equal(out[:B, 4], ref[:B, 4])
    np.testing.assert_allclose(out[B:, :3], ref[B:, :3], atol=1e-4)
    assert not out[B:, 3:].any()


def _selector_inputs(cfg, seq, S=3):
    cands = _loop_candidates(seq.gt_poses, cfg.offline, set())[:8]
    C = len(cands)
    ci = np.asarray([c[0] for c in cands])
    cj = np.asarray([c[1] for c in cands])
    rel = gnp.relative(seq.gt_poses[ci], seq.gt_poses[cj]).astype(np.float32)
    seeds = np.asarray([[0, 0, 0], [0.3, -0.2, 0.05], [-0.25, 0.3, -0.04]],
                       np.float32)
    g = (rel[:, None, :] + seeds[None]).reshape(C * S, 3)
    gates = np.asarray([0.35, 0.5, 0.21, 0.06], np.float32)
    return np.repeat(cj, S), np.repeat(ci, S), g, rel, gates


def test_loop_selector_matches_reference(store):
    cfg, seq, _odom, arrays = store
    si, ti, g, rel, gates = _selector_inputs(cfg, seq)
    ref = np.asarray(jds.make_loop_selector(cfg, 3)(
        *_j(*arrays), *_j(si.astype(np.int32), ti.astype(np.int32), g, rel,
                          gates)))
    out = tds.make_loop_selector(_port(cfg), 3)(
        *_t(*arrays), *_t(si, ti, g, rel, gates)).numpy()
    assert out.shape == ref.shape == (len(rel), 16)
    assert (ref[:, 15] > 0.5).any(), "the case must exercise accepted loops"
    np.testing.assert_array_equal(out[:, 15], ref[:, 15])
    np.testing.assert_allclose(out[:, :4], ref[:, :4], atol=1e-5)
    np.testing.assert_allclose(out[:, 14], ref[:, 14], atol=1e-6)


def test_loop_selector_rejects_mixed_source_blocks(store):
    cfg, seq, _odom, arrays = store
    si, ti, g, rel, gates = _selector_inputs(cfg, seq)
    si = si.copy()
    si[1] = si[1] + 1  # the first block's seeds no longer share a source
    with pytest.raises(ValueError, match="blocks"):
        tds.make_loop_selector(_port(cfg), 3)(*_t(*arrays),
                                              *_t(si, ti, g, rel, gates))


def test_factories_run_the_match_they_are_given(store):
    # the functions beneath the factories take the batched match callable,
    # so the same selection and integration can run over the plain version
    cfg, seq, odom, arrays = store
    calls = []

    def base(sp, sv, tp, tv, g):
        calls.append(sp.shape[0])
        return plicp_match(sp, sv, tp, tv, _port(cfg.plicp), init_pose=g)

    si, ti, g, rel, gates = _selector_inputs(cfg, seq)
    sel = _t(*arrays) + _t(si, ti, g, rel, gates)
    assert torch.equal(tds._loop_selector(base, 3)(*sel),
                       tds.make_loop_selector(_port(cfg), 3)(*sel))
    B = 16
    ci, cj = np.arange(0, B), np.arange(1, B + 1)
    chain = _t(*arrays) + _t(cj, ci, gnp.relative(odom[ci], odom[cj]).astype(
        np.float32), odom[0].astype(np.float32))
    assert torch.equal(tds._chain_matcher(base)(*chain),
                       tds.make_chain_matcher(_port(cfg))(*chain))
    assert calls == [len(si), B]


def test_sharded_factories_raise():
    """The sharded factories are ported: over a mesh of one rank they give
    the unsharded matchers' results bit for bit and the reference's
    sharded matcher's within 1e-5 (test_torch_mesh.py holds two ranks);
    a batch that does not tile the mesh raises."""
    from tpu_slam.config import default_config as jdefault_config
    from tpu_slam.parallel.mesh import make_mesh as jmake_mesh
    from tpu_slam.parallel.mesh import shard_batch
    from tpu_slam_torch.config import default_config
    from tpu_slam_torch.parallel.mesh import make_mesh

    src, sv, tgt, tv = _pairs(2, delta=(0.06, -0.02, 0.04))
    g = np.zeros((2, 3), np.float32)
    cfg, mesh = default_config(), make_mesh(device="cpu")
    args = _t(src, sv, tgt, tv, g)
    one = tds.make_batched_matcher(cfg)(*args)
    got = tds.make_batched_matcher(cfg, mesh)(*args)
    for a, b in zip(got, one):
        assert torch.equal(a, b)
    store, valid = np.concatenate([src, tgt]), np.concatenate([sv, tv])
    idx = _t(np.array([0, 1]), np.array([2, 3]), g)
    packed = tds.make_packed_indexed_matcher(cfg, mesh)(
        torch.as_tensor(store), torch.as_tensor(valid), torch.zeros(1, 2),
        *idx)
    assert torch.equal(packed, tds.make_packed_indexed_matcher(cfg)(
        torch.as_tensor(store), torch.as_tensor(valid), torch.zeros(1, 2),
        *idx))
    assert torch.equal(packed[:, :3], one.pose)
    jm = jmake_mesh(1)
    ref = jds.make_batched_matcher(jdefault_config(), jm)(
        *(shard_batch(jm, jnp.asarray(a)) for a in (src, sv, tgt, tv, g)))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
    with pytest.raises(ValueError, match="tile"):
        import dataclasses

        tds.make_batched_matcher(cfg, dataclasses.replace(mesh, size=3))(
            *args)


def test_batched_matcher_recovers_motion():
    src, sv, tgt, tv = _pairs(2, delta=(0.06, -0.02, 0.04))
    from tpu_slam_torch.config import default_config

    res = tds.make_batched_matcher(default_config())(
        *_t(src, sv, tgt, tv), torch.zeros(2, 3))
    truth = np.asarray(geo.relative(jnp.zeros(3), jnp.asarray([0.06, -0.02, 0.04])))
    np.testing.assert_allclose(res.pose.numpy(), [truth] * 2, atol=0.01)


# --- the kernel's design, held on the CPU ---------------------------------


def _rank_select_model(x, mask, qs):
    """csrc/plicp_fused.cu's exact selection, in plain torch: each gated
    source counts the gated errors below its own plus the equal ones at a
    lower index (its rank in the sorted order), and the source of rank
    floor(q·(cnt − 1)), clamped to N − 1, writes the quantile into a slot
    that starts at BIG."""
    n = x.shape[-1]
    e = torch.where(mask, x, torch.full_like(x, float("inf")))
    idx = torch.arange(n)
    below = e[..., None, :] < e[..., :, None]  # [i, j]: e_j < e_i
    tie = (e[..., None, :] == e[..., :, None]) & (idx[None, :] < idx[:, None])
    rank = (below | tie).sum(-1)
    cnt1 = torch.clamp(mask.sum(-1) - 1, min=0).to(torch.float32)
    out = []
    for q in qs:
        pos = torch.floor(torch.tensor(q, dtype=torch.float32) * cnt1)
        pos = torch.clamp(pos.to(torch.int64), 0, n - 1)
        hit = mask & (rank == pos[..., None])
        slot = torch.where(hit, x, torch.zeros_like(x)).sum(-1)
        out.append(torch.where(hit.any(-1), slot,
                               torch.full_like(slot, tmatch.BIG)))
    return out


def _selection_case(kind, n):
    rng = np.random.default_rng(n)
    x = rng.random((4, n)).astype(np.float32)
    m = rng.random((4, n)) > 0.3
    if kind == "ties":  # many equal |err|: a straight wall, repeated ranges
        x = rng.integers(0, 3, (4, n)).astype(np.float32) * np.float32(0.02)
    elif kind == "none_gated":
        m[:] = False
    elif kind == "one_gated":
        m[:] = False
        m[np.arange(4), rng.integers(0, n, 4)] = True
    elif kind == "all_gated":
        m[:] = True
    return torch.as_tensor(x), torch.as_tensor(m)


def _radix_select_model(x, mask, qs):
    """csrc/plicp_fused.cu's radix select, in plain torch: a histogram of
    the gated |err| over 1,024 bins of 1/32 octave, (bits >> 18) − 3,072
    clamped to [0, 1,023]; the bin that holds sorted position
    r = floor(q·(cnt − 1)) (clamped to N − 1) and the count below it; the
    gated errors of that bin, each counting the members below and at its
    value; a member whose [below, at) range holds r − (count below the
    bin) gives the quantile, and r ≥ cnt gives BIG."""
    out = []
    for q in qs:
        vals = []
        for row, mrow in zip(x, mask):
            n = row.shape[0]
            g = row[mrow]
            cnt = int(g.numel())
            cnt1 = torch.tensor(float(max(cnt - 1, 0)), dtype=torch.float32)
            r = int(torch.floor(torch.tensor(q, dtype=torch.float32) * cnt1))
            r = min(max(r, 0), n - 1)
            if r >= cnt:
                vals.append(torch.tensor(tmatch.BIG, dtype=row.dtype))
                continue
            bins = torch.clamp((g.view(torch.int32) >> 18) - (96 << 5),
                               0, 1023)
            hist = torch.bincount(bins, minlength=1024)
            below = torch.cumsum(hist, 0) - hist
            b = int(torch.nonzero((below <= r) & (r < below + hist))[0, 0])
            members = g[bins == b]
            rr = r - int(below[b])
            lt = (members[None, :] < members[:, None]).sum(-1)
            le = (members[None, :] <= members[:, None]).sum(-1)
            hit = (lt <= rr) & (rr < le)
            assert bool(hit.any()) and torch.unique(members[hit]).numel() == 1
            vals.append(members[hit][0])
        out.append(torch.stack(vals))
    return out


@pytest.mark.parametrize("n", [1, 7, 360, 1024])
@pytest.mark.parametrize(
    "kind", ["random", "ties", "none_gated", "one_gated", "all_gated"])
def test_rank_selection_equals_masked_quantiles(kind, n):
    x, m = _selection_case(kind, n)
    qs = (0.0, 0.7, 0.9, 1.0)
    for want, got in zip(tmatch.masked_quantiles(x, m, qs),
                         _rank_select_model(x, m, qs)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 360, 1024])
@pytest.mark.parametrize(
    "kind", ["random", "ties", "none_gated", "one_gated", "all_gated",
             "spread"])
def test_radix_selection_equals_masked_quantiles(kind, n):
    if kind == "spread":  # |err| over many octaves, past both end bins
        rng = np.random.default_rng(n + 1)
        x = torch.as_tensor((10.0 ** rng.uniform(-12, 1, (4, n)))
                            .astype(np.float32))
        m = torch.as_tensor(rng.random((4, n)) > 0.2)
    else:
        x, m = _selection_case(kind, n)
    qs = (0.0, 0.7, 0.9, 1.0)
    for want, got in zip(tmatch.masked_quantiles(x, m, qs),
                         _radix_select_model(x, m, qs)):
        assert torch.equal(got, want)


def _pruned_nn_model(src, tgt, tv, seed, tile=32, slack=4e-6,
                     chunk=cp.MAX_TARGETS):
    """csrc/plicp_fused.cu's NN, in plain float32 torch, one source at a
    time (the kernel's warp scans a tile when any lane needs it, which
    only adds targets): d = valid ? dx² + dy² : BIG; the bound from target
    0 and the 8 targets of the first chunk around ``seed``; target 0, then
    the staged chunks
    of ``chunk`` targets in order and the tiles of each in order, skipping
    a tile whose box (of its valid targets, or BIG where it holds an
    invalid one) lies beyond the bound and the best so far; a strict <
    within, the best carried across chunks. Returns the picks and how
    many tiles were skipped."""
    M = tgt.shape[0]
    dx = src[:, None, 0] - tgt[None, :, 0]
    dy = src[:, None, 1] - tgt[None, :, 1]
    d = torch.where(tv[None, :], dx * dx + dy * dy,
                    torch.tensor(tmatch.BIG, dtype=torch.float32))
    inf = float("inf")
    boxes = []
    starts = [k0 + t for k0 in range(0, M, chunk)
              for t in range(0, min(chunk, M - k0), tile)]
    for t0 in starts:
        sl = slice(t0, min(t0 + tile, M, t0 - t0 % chunk + chunk))
        v = tv[sl]
        pts = tgt[sl][v]
        lo = pts.min(0).values if len(pts) else torch.tensor([inf, inf])
        hi = pts.max(0).values if len(pts) else torch.tensor([-inf, -inf])
        boxes.append((lo, hi, tmatch.BIG if bool((~v).any()) else inf))
    picks, skipped = [], 0
    for i in range(src.shape[0]):
        m0 = min(M, chunk)
        j0 = min(max(int(seed[i]) - 4, 0), max(m0 - 8, 0))
        bound = torch.minimum(d[i, 0], d[i, j0:min(j0 + 8, m0)].min())
        best, j1 = d[i, 0], 0
        for t0, (lo, hi, inv) in zip(starts, boxes):
            g = torch.clamp(torch.maximum(lo - src[i], src[i] - hi), min=0)
            lb = torch.minimum(g[0] * g[0] + g[1] * g[1],
                               torch.tensor(inv, dtype=torch.float32))
            if lb * (1 - slack) > torch.minimum(bound, best) + 1e-30:
                skipped += 1
                continue
            end = min(t0 + tile, M, t0 - t0 % chunk + chunk)
            for j in range(max(t0, 1), end):
                if d[i, j] < best:
                    best, j1 = d[i, j], j
        picks.append(j1)
    return torch.tensor(picks), skipped


@pytest.mark.parametrize("case", ["scan_pair", "invalid_tiles", "far",
                                  "duplicates", "no_valid", "chunks"])
def test_pruned_nn_picks_the_exhaustive_first_minimum(case):
    rng = np.random.default_rng(3)
    src, _sv, tgt, tv = (torch.as_tensor(a[0]) for a in _pairs(1))
    tgt = torch.where(tv[:, None], tgt, torch.zeros(()))
    seed = torch.arange(src.shape[0]) * tgt.shape[0] // src.shape[0]
    if case == "invalid_tiles":  # whole tiles and scattered beams invalid
        tv = tv.clone()
        tv[64:128] = False
        tv[::7] = False
    elif case == "far":  # sources beyond every box; seeds far off
        src = src + torch.tensor([40.0, -25.0])
        seed = torch.as_tensor(rng.integers(0, tgt.shape[0], src.shape[0]))
    elif case == "duplicates":  # repeated targets: the first copy wins
        tgt = tgt[:120].repeat(3, 1)
        tv = tv[:120].repeat(3)
        src = torch.round(src * 4) / 4
    elif case == "no_valid":
        tv = torch.zeros_like(tv)
    chunk = cp.MAX_TARGETS
    if case == "chunks":
        # staged chunks of 1,000 targets (the kernel's are MAX_TARGETS):
        # the scan repeated 14 times, the last copies 0.01 m off, so the
        # first copy wins across chunks except where a later one is nearer
        chunk = 1000
        M = tgt.shape[0]
        tgt = torch.cat([tgt + (0.01 * (k // 7)) for k in range(14)])
        tv = tv.repeat(14)
        src = src[::9]
        seed = (torch.arange(src.shape[0]) * 14 * M) // src.shape[0]
    dx = src[:, None, 0] - tgt[None, :, 0]
    dy = src[:, None, 1] - tgt[None, :, 1]
    d = torch.where(tv[None, :], dx * dx + dy * dy,
                    torch.tensor(tmatch.BIG, dtype=torch.float32))
    want = torch.argmin(d, dim=-1)  # the first index of the minimum
    got, skipped = _pruned_nn_model(src, tgt, tv, seed, chunk=chunk)
    assert torch.equal(got, want)
    if case == "chunks":
        assert bool((want >= chunk).any()) and bool((want < M).any())
    if case == "scan_pair":  # the pruning does skip most tiles
        assert skipped > 0.5 * src.shape[0] * -(-tgt.shape[0] // 32)


PLICP_SHAPES = [  # chip_smoke's batches, its edge cases, one chunk's ends
    (512, 360, 360), (2048, 360, 360), (5760, 360, 360), (6, 100, 130),
    (600, 1, 360), (600, 1024, 360), (600, 360, 1), (600, 360, 4096),
    (1, 1024, 4096), (1, 1, 1),
] + [(2, N, M) for N in (360, 1081, 4097, 12345)  # past one chunk
     for M in (360, 4097, 5000, 12345)] + [(600, 1081, 1081), (1, 1025, 1)]


@pytest.mark.parametrize("shape", PLICP_SHAPES)
def test_plicp_geometry_covers_every_source_once(shape):
    B, N, M = shape
    sms = 132
    geo = cp.plicp_geometry(B, N, M, sms)
    T, S, C = geo.threads, geo.sources, geo.source_chunks
    assert 32 <= T <= cp.MAX_THREADS and T % 32 == 0
    assert 1 <= S <= cp.MAX_SOURCES and T <= cp.max_threads(S)
    assert T * S <= cp.MAX_PASS and C == -(-N // (T * S))
    # source (c·S + s)·T + t on thread t: every source once, no chunk
    # without a source, no thread idle in every slot of one chunk
    slots = [(c * S + s) * T + t
             for c in range(C) for s in range(S) for t in range(T)]
    assert sorted(i for i in slots if i < N) == list(range(N))
    assert (C - 1) * S * T < N
    assert C > 1 or (S - 1) * T < N
    # the targets staged chunk after chunk, whole tiles, every target once
    mc, KC = geo.targets, geo.target_chunks
    assert mc == min(M, cp.MAX_TARGETS) and KC == -(-M // mc)
    assert KC == 1 or mc % cp.TILE == 0
    staged = [k0 + j for k0 in range(0, KC * mc, mc)
              for j in range(min(mc, M - k0))]
    assert staged == list(range(M))
    # the groups of 32 sources that the GN sums add in source order
    groups = C * S * (T // 32)
    assert 32 * groups >= N
    assert geo.smem == cp.smem_bytes(N, mc, T, S, C,
                                     lists=not geo.lists_global)
    assert geo.smem <= _build.SMEM_PER_BLOCK
    # device scratch: the records of every source where there are chunks,
    # then the lists where they do not fit shared memory
    want = 0
    if C > 1 or KC > 1 or geo.lists_global:
        want = cp.RECORD_FLOATS * N + (
            cp.list_floats(N, T, S, C) if geo.lists_global else 0)
    assert geo.scratch == 4 * -(-want // 4)
    if geo.lists_global:
        assert cp.smem_bytes(N, mc, T, S, C) > _build.SMEM_PER_BLOCK
    if N <= cp.MAX_PASS and M <= cp.MAX_TARGETS:
        # one chunk of each: the geometry of the kernel before chunks
        assert (C, KC, geo.lists_global, geo.scratch) == (1, 1, False, 0)
        assert geo.smem == cp.smem_bytes(N, M, T, S)
    if B >= sms and N == 360:
        assert S == cp.SOURCES_PER_THREAD
    if B < sms:  # fewer pairs than SMs: one source a thread
        assert S == 1 or N > cp.MAX_PASS


def test_plicp_kernel_constants_are_the_wrappers():
    import re

    src = (_build.CSRC / "plicp_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    for name in ("MAX_THREADS", "MAX_SOURCES", "PAIR_THREADS", "NV1", "NV2",
                 "TILE", "BINS"):
        assert const(name) == getattr(cp, name), name
    instances = [int(k) for k in re.findall(r"PLICP_CASE\((\d+)\)", src)]
    assert sorted(set(instances)) == list(range(1, cp.MAX_SOURCES + 1))
    # the staging barrier, the design's barriers a round, the two around
    # each chunk of targets staged after the first and the one before the
    # first is staged again
    assert src.count("__syncthreads()") == (
        1 + cp.BARRIERS_PER_ROUND + cp.STAGING_BARRIERS)
    # one design: no bitonic sort, and no switch to another NN or selection
    assert "bitonic" not in src and "design" not in src
    assert len(_build.SIGNATURES["plicp_fused"][1]) == 26


def test_plicp_wrapper_rejects_beyond_its_limits():
    """No beam on either side is outside the kernel's range; the old
    limits (1,024 sources, 4,096 targets) are not: they reach the device
    check, which a tensor off the card fails."""
    cfg = tconfig.PLICPConfig()
    meta = torch.device("meta")
    z = torch.zeros

    def launch(N, M):
        cp.launch_plicp(z((2, N, 2), device=meta),
                        z((2, N), dtype=torch.bool, device=meta),
                        z((2, M, 2), device=meta),
                        z((2, M), dtype=torch.bool, device=meta), cfg,
                        z((2, 3), device=meta))

    for N, M in ((0, 360), (360, 0)):
        with pytest.raises(ValueError, match="outside"):
            launch(N, M)
    for N, M in ((1025, 360), (360, 4097), (12345, 12345)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(N, M)
    with pytest.raises(ValueError, match="expected"):  # a malformed shape
        cp.launch_plicp(z((2, 5, 3), device=meta),
                        z((2, 5), dtype=torch.bool, device=meta),
                        z((2, 7, 2), device=meta),
                        z((2, 7), dtype=torch.bool, device=meta), cfg,
                        z((2, 3), device=meta))
