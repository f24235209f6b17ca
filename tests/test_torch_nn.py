"""Port parity: the NN kernel's plain version and the device-routed NN of
tpu_slam_torch.ops.matching against tpu_slam's, on the same seeded numpy
inputs. The JAX side runs its Pallas NN kernel in interpret mode, as
tpu_slam's own tests do on the CPU, and its XLA ``nearest_neighbor``."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.config import default_config as jax_default_config
from tpu_slam.ops import matching as jmatch
from tpu_slam.ops.pallas.nn import nearest_neighbor_pallas
from tpu_slam.parallel import distributed_step as jds
from tpu_slam_torch import _dispatch
from tpu_slam_torch.ops import matching as tmatch
from tpu_slam_torch.ops.cuda import nn as cuda_nn
from tpu_slam_torch.parallel import distributed_step as tds

from test_torch_host_copies import port_config
from test_torch_plicp import _pairs


def _case(name):
    """(src (B, N, 2), tgt (B, M, 2), tgt_valid (B, M)) float32 / bool."""
    rng = np.random.default_rng(CASES.index(name))
    B, N, M = {"random": (3, 50, 70), "b_not_multiple_of_8": (5, 33, 41),
               "n_not_m": (2, 97, 13), "one_source": (3, 1, 40),
               "ties": (2, 24, 30), "no_valid": (2, 20, 25),
               "far_sources": (2, 16, 30)}[name]
    src = rng.normal(0, 3, (B, N, 2)).astype(np.float32)
    tgt = rng.normal(0, 3, (B, M, 2)).astype(np.float32)
    tv = rng.random((B, M)) > 0.2
    if name == "ties":
        # duplicated targets, and sources on the grid between them
        tgt = np.round(tgt).astype(np.float32)
        tgt[:, 15:] = tgt[:, :15]
        src = np.round(src * 2).astype(np.float32) / 2
        tv[:] = True
    if name == "no_valid":
        tv[:] = False
        src[0, :4] = 200.0  # d + 1e12 with d past 32,768 m²: indices move
    if name == "far_sources":
        src[:, :8] += np.float32(5e3)
    return src, tgt, tv


CASES = ["random", "b_not_multiple_of_8", "n_not_m", "one_source", "ties",
         "no_valid", "far_sources"]


@pytest.mark.parametrize("name", CASES)
def test_direct_equals_the_pallas_kernel_bit_for_bit(name):
    src, tgt, tv = _case(name)
    ji, jd = nearest_neighbor_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(tv), interpret=True)
    ti, td = tmatch.nearest_neighbor_direct(*map(torch.as_tensor,
                                                 (src, tgt, tv)))
    assert ti.dtype == torch.int64 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


def _round_to_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the exact value x, ties to even."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - x),
                                     int(np.float32(f).view(np.int32)) & 1))


def test_direct_rounds_the_squares_once():
    # fma(dx, dx, dy·dy): the exact dx² plus the float32 dy·dy, rounded
    # once to nearest; two roundings (dx·dx + dy·dy) differ on some
    rng = np.random.default_rng(7)
    dx = rng.normal(0, 2, 3000).astype(np.float32)
    dy = rng.normal(0, 2, 3000).astype(np.float32)
    dx[:1000] *= np.float32(1e-3)  # far-apart magnitudes
    got = tmatch._fma_squares(torch.as_tensor(dx), torch.as_tensor(dy))
    want = [_round_to_f32(Fraction(x) ** 2 + Fraction(y))
            for x, y in zip(dx.tolist(), (dy * dy).tolist())]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    assert (got.numpy() != dx * dx + dy * dy).any()


@pytest.mark.parametrize("name", ["random", "n_not_m", "far_sources"])
def test_auto_on_cpu_is_the_reference_route(name):
    src, tgt, tv = _case(name)
    ji, jd = jmatch.nearest_neighbor(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(tv))
    before = dict(_dispatch.LAUNCHES)
    ti, td = tmatch.nearest_neighbor_auto(*map(torch.as_tensor,
                                               (src, tgt, tv)))
    assert _dispatch.LAUNCHES == before
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the expanded form |a|² + |b|² − 2a·b cancels: its rounding error is
    # absolute, a few ulps of |a|² + |b|² (~2e-6 at these ~3 m points),
    # and the two packages sum the terms in different orders
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_auto_flattens_and_broadcasts_for_the_kernel(monkeypatch):
    # with the route forced to the card, the wrapper gets (B, N, 2)
    # contiguous pairs with the targets broadcast to the source batch
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.normal(0, 3, (2, 3, 17, 2)).astype(np.float32))
    tgt = torch.as_tensor(rng.normal(0, 3, (3, 19, 2)).astype(np.float32))
    tv = torch.as_tensor(rng.random(19) > 0.3)
    seen = []

    def fake(s, t, v):
        seen.append((tuple(s.shape), tuple(t.shape), tuple(v.shape),
                     s.is_contiguous() and t.is_contiguous()))
        return tmatch.nearest_neighbor_direct(s, t, v)

    monkeypatch.setattr(_dispatch, "route", lambda t: "cuda")
    monkeypatch.setattr(cuda_nn, "nearest_neighbor_cuda", fake)
    idx, d2 = tmatch.nearest_neighbor_auto(src, tgt, tv)
    assert seen == [((6, 17, 2), (6, 19, 2), (6, 19), True)]
    want_i, want_d = tmatch.nearest_neighbor_direct(src, tgt, tv)
    assert idx.shape == d2.shape == (2, 3, 17)
    assert torch.equal(idx, want_i) and torch.equal(d2, want_d)


def test_wrapper_on_cpu_is_the_plain_version():
    src, tgt, tv = map(torch.as_tensor, _case("random"))
    before = dict(_dispatch.LAUNCHES)
    a = cuda_nn.nearest_neighbor_cuda(src, tgt, tv)
    b = tmatch.nearest_neighbor_direct(src, tgt, tv)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _dispatch.LAUNCHES == before
    assert "nn" in _dispatch.LAUNCHES
    with pytest.raises(ValueError):
        cuda_nn.nearest_neighbor_cuda(src.to("meta"), tgt.to("meta"),
                                      tv.to("meta"))


@pytest.mark.parametrize("q", [0.0, 0.7, 0.9, 1.0])
def test_masked_quantile_matches_reference(q):
    rng = np.random.default_rng(2)
    x = rng.random((5, 23)).astype(np.float32)
    m = rng.random((5, 23)) > 0.4
    m[0] = False
    ref = jmatch.masked_quantile(jnp.asarray(x), jnp.asarray(m), q)
    out = tmatch.masked_quantile(torch.as_tensor(x), torch.as_tensor(m), q)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_point_to_point_match_fn_reaches_the_nn_route(monkeypatch):
    """The point-to-point form of ``_match_fn`` runs ``plicp_match`` with
    ``nearest_neighbor_auto`` (on the card: the NN kernel in every round),
    as the reference's does on its TPU, and still equals the reference's
    point-to-point batch on the CPU."""
    import dataclasses

    jcfg = jax_default_config()
    jcfg = dataclasses.replace(jcfg, plicp=dataclasses.replace(
        jcfg.plicp, use_point_to_line_distance=False))
    src, sv, tgt, tv = _pairs(3, delta=(0.05, 0.02, -0.03), n=180)
    g = np.zeros((3, 3), np.float32)
    ref = jds.make_batched_matcher(jcfg)(*map(jnp.asarray,
                                              (src, sv, tgt, tv, g)))
    calls = []
    auto = tmatch.nearest_neighbor_auto

    def recording(*args):
        calls.append(args[0].shape)
        return auto(*args)

    monkeypatch.setattr(tds, "nearest_neighbor_auto", recording)
    out = tds.make_batched_matcher(port_config(jcfg))(
        *map(torch.as_tensor, (src, sv, tgt, tv, g)))
    assert calls == [(3, 180, 2)] * jcfg.plicp.max_iterations
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
