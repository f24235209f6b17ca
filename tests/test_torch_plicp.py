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
    from tpu_slam_torch.config import default_config

    with pytest.raises(NotImplementedError):
        tds.make_packed_indexed_matcher(default_config(), mesh=object())
    with pytest.raises(NotImplementedError):
        tds.make_batched_matcher(default_config(), mesh=object())


def test_batched_matcher_recovers_motion():
    src, sv, tgt, tv = _pairs(2, delta=(0.06, -0.02, 0.04))
    from tpu_slam_torch.config import default_config

    res = tds.make_batched_matcher(default_config())(
        *_t(src, sv, tgt, tv), torch.zeros(2, 3))
    truth = np.asarray(geo.relative(jnp.zeros(3), jnp.asarray([0.06, -0.02, 0.04])))
    np.testing.assert_allclose(res.pose.numpy(), [truth] * 2, atol=0.01)
