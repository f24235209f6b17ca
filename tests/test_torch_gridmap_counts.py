"""The counts half of tpu_slam_torch/ops/gridmap.py (GMapping hit/visit
counters, the Karto pass/hit counters and their cell rules) against
tpu_slam's on the same seeded inputs. The JAX side runs compiled
(``jax.jit``), as the reference's models run it: the cells a sample lands
in are decided by XLA's float32 rounding, which the port reproduces.
Counts must be int32-equal, ``acc`` within 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import geometry as jgeo
from tpu_slam.config import GridConfig
from tpu_slam.ops import gridmap as J
from tpu_slam_torch.ops import correlative as corr
from tpu_slam_torch.ops import gridmap as T

from test_torch_host_copies import port_config

CFG = GridConfig(resolution=0.1, size_x=128, size_y=128, origin_x=-6.4,
                 origin_y=-6.4)
TCFG = port_config(CFG)
# an off-centre grid, 0.05 m, not square, origin off the cell lattice
ODD = GridConfig(resolution=0.05, size_x=300, size_y=260, origin_x=-7.3,
                 origin_y=-6.1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _scans(seed, T_=6, N=180, rmax=9.0):
    """``T_`` scans of ``N`` beams at random poses: float32 poses, the
    laser points (0 where not finite), the raw ranges (5% NaN, 5% inf)
    and the world endpoints as the reference's compiled ``geometry.apply``
    gives them."""
    rng = np.random.default_rng(seed)
    poses = np.c_[rng.uniform(-2, 2, (T_, 2)),
                  rng.uniform(-3, 3, T_)].astype(np.float32)
    ang = np.linspace(-np.pi, np.pi, N, endpoint=False).astype(np.float32)
    r = rng.uniform(0.05, rmax, (T_, N)).astype(np.float32)
    r[rng.random((T_, N)) < 0.05] = np.nan
    r[rng.random((T_, N)) < 0.05] = np.inf
    with np.errstate(invalid="ignore"):
        pl = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    pl = np.where(np.isfinite(pl), pl, 0.0).astype(np.float32)
    wp = np.asarray(jax.jit(lambda p, q: jgeo.apply(p[:, None, :], q))(
        poses, pl))
    return poses, pl, r, wp


def test_apply_pose_is_the_compiled_references():
    poses, pl, _r, wp = _scans(0)
    np.testing.assert_array_equal(
        corr.apply_pose(_t(poses), _t(pl)).numpy(), wp)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_acc", [False, True])
def test_counts_update_scan_matches_reference(seed, with_acc):
    poses, _pl, r, wp = _scans(seed)
    g, n = ODD, ODD.size_x * ODD.size_y
    valid = np.isfinite(r) & (r > 0.15) & (r < 8.0)

    @jax.jit
    def ref_step(h, v, a, o, e, va):
        if a is None:
            return J.counts_update_scan(h, v, g, o, e, va, max_range=8.0)
        return J.counts_update_scan(h, v, g, o, e, va, max_range=8.0, acc=a)

    jh, jv = jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32)
    ja = jnp.zeros((n, 2), jnp.float32) if with_acc else None
    th = torch.zeros(n, dtype=torch.int32)
    tv = torch.zeros_like(th)
    ta = torch.zeros((n, 2)) if with_acc else None
    for t in range(len(poses)):
        jout = ref_step(jh, jv, ja, poses[t, :2], wp[t], valid[t])
        tout = T.counts_update_scan(th, tv, port_config(g), _t(poses[t, :2]),
                                    _t(wp[t]), _t(valid[t]), max_range=8.0,
                                    acc=ta)
        jh, jv = jout[:2]
        th, tv = tout[:2]
        if with_acc:
            ja, ta = jout[2], tout[2]
    assert th.dtype == tv.dtype == torch.int32
    assert int(np.asarray(jv).sum()) > 10_000
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if with_acc:
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            T.counts_mean(ta, th).numpy(),
            np.asarray(J.counts_mean(ja, jh)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        T.counts_occupancy(th, tv).numpy(),
        np.asarray(jax.jit(J.counts_occupancy)(jh, jv)))


def test_counts_dedup_drops_a_repeated_cell_only():
    """A ray at 0.7 cell steps meets some cells twice: each cell of a ray
    is visited once, and a later return to a cell is a new visit."""
    origin = torch.zeros(2)
    ends = torch.tensor([[3.0, 0.0], [2.0, 2.0]])
    n = 128 * 128
    h, v = T.counts_update_scan(torch.zeros(n, dtype=torch.int32),
                                torch.zeros(n, dtype=torch.int32), TCFG,
                                origin, ends, torch.tensor([True, True]))
    free, _end = T.ray_cell_indices(TCFG, origin, ends,
                                    torch.tensor([True, True]))
    for b in range(2):
        cells = free[b][free[b] != T.OOB_INDEX]
        assert len(cells) > len(torch.unique(cells))  # repeats were sampled
    assert int(v.max()) <= 2 and int(h.sum()) == 2
    assert int(v.sum()) == sum(
        len(torch.unique_consecutive(free[b][free[b] != T.OOB_INDEX]))
        for b in range(2)) + 2


def test_gmapping_counts():
    """tests/test_gridmap.py::test_gmapping_counts on the port."""
    hits = torch.zeros(128 * 128, dtype=torch.int32)
    visits = torch.zeros_like(hits)
    origin = torch.tensor([0.0, 0.0])
    endpoints = torch.tensor([[3.0, 0.0]])
    valid = torch.tensor([True])
    for _ in range(4):
        hits, visits = T.counts_update_scan(hits, visits, TCFG, origin,
                                            endpoints, valid)
    h = hits.numpy().reshape(128, 128)
    v = visits.numpy().reshape(128, 128)
    assert h[64, 94] == 4 and v[64, 94] == 4
    assert h[64, 70] == 0 and v[64, 70] == 4  # one visit a scan
    frac = T.counts_occupancy(hits, visits).numpy().reshape(128, 128)
    assert frac[64, 94] == 1.0 and frac[64, 70] == 0.0


def test_karto_counts_range_threshold():
    """tests/test_gridmap.py::test_karto_counts_range_threshold on the
    port."""
    p = torch.zeros(128 * 128, dtype=torch.int32)
    h = torch.zeros_like(p)
    origin = torch.tensor([0.0, 0.0])
    # one beam in range, one past the threshold (traced free, no hit)
    endpoints = torch.tensor([[3.0, 0.0], [0.0, 5.5]])
    ranges = torch.tensor([3.0, 5.5])
    p, h = T.karto_counts_update_scan(
        p, h, TCFG, origin, endpoints, ranges, range_threshold=4.0,
        min_range=0.1, max_range=12.0)
    pp = p.numpy().reshape(128, 128)
    hh = h.numpy().reshape(128, 128)
    # the valid endpoint: TraceLine's visit plus the endpoint's pass and hit
    assert hh[64, 94] == 1 and pp[64, 94] == 2
    assert hh[:, 64].sum() == 0  # the long beam never hits
    assert pp[80, 64] == 1  # but traces free along +y up to 4 m
    assert pp[64 + 41, 64] == 0  # nothing past the threshold
    assert pp[64, 70] == 1


def test_karto_occupancy_rule():
    """tests/test_gridmap.py::test_karto_occupancy_rule on the port, and
    the reference's rule on random counts."""
    p = torch.tensor([0, 1, 3, 10, 10])
    h = torch.tensor([0, 1, 3, 0, 2])
    assert T.karto_occupancy(p, h).tolist() == [-1, -1, 100, 0, 100]
    rng = np.random.default_rng(5)
    pc = rng.integers(0, 40, 5000).astype(np.int32)
    hc = np.minimum(rng.integers(0, 8, 5000), pc).astype(np.int32)
    for args in ((), (4, 0.3)):
        out = T.karto_occupancy(_t(pc), _t(hc), *args)
        assert out.dtype == torch.int8
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(J.karto_occupancy(pc, hc, *args)))


def test_kround_i_rounds_half_away_from_zero():
    x = np.array([-2.5, -1.5, -0.5, -0.49999997, 0.0, 0.5, 1.5, 2.5,
                  0.49999997, 7.5, -7.5, 1e6 + 0.5], np.float32)
    rng = np.random.default_rng(3)
    x = np.concatenate([x, rng.uniform(-400, 400, 2000).astype(np.float32),
                        (rng.integers(-400, 400, 200) + 0.5).astype(
                            np.float32)])
    out = T.kround_i(_t(x))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(J.kround_i(x)))
    # |x| + 0.5 rounds in float32: 0.49999997 + 0.5 is 1.0, as there
    assert out[:9].tolist() == [-3, -2, -1, -1, 0, 1, 2, 3, 1]
    assert torch.round(_t(x[:8])).to(torch.int32).tolist() == [
        -2, -2, 0, 0, 0, 0, 2, 2]


@pytest.mark.parametrize("seed", [0, 1])
def test_bresenham_cells_match_reference(seed):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(-30, 30, (400, 2)).astype(np.int32)
    c1 = (c0 + rng.integers(-40, 40, (400, 2))).astype(np.int32)
    c1[:20] = c0[:20]  # a walk of one cell
    c1[20:40, 0] = c0[20:40, 0]  # vertical
    c1[40:60, 1] = c0[40:60, 1]  # horizontal
    jc, jok = jax.jit(J.bresenham_cells, static_argnums=2)(c0, c1, 90)
    tc, tok = T.bresenham_cells(_t(c0), _t(c1), 90)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tc.numpy()[tok.numpy()],
                                  np.asarray(jc)[np.asarray(jok)])
    # each walk starts and ends on its end cells and moves one step a cell
    ok = tok.numpy()
    for b in range(0, 400, 37):
        cells = tc.numpy()[b][ok[b]]
        assert {tuple(cells[0]), tuple(cells[-1])} == {tuple(c0[b]),
                                                       tuple(c1[b])}
        assert np.abs(np.diff(cells, axis=0)).max(initial=1) == 1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("thr", [6.0, 20.0])
def test_karto_counts_match_reference(seed, thr):
    """One batched ``karto_counts_update_scan`` (threshold below and above
    the longest reading), the port's ``karto_counts_windows``, the
    reference's windows and the reference's scan-by-scan loop: all
    int32-equal."""
    poses, _pl, r, wp = _scans(seed)
    g, n = ODD, ODD.size_x * ODD.size_y
    tg = port_config(g)
    z = jnp.zeros(n, jnp.int32)
    jp, jh = map(np.asarray, jax.jit(
        lambda o, e, rr: J.karto_counts_update_scan(
            z, z, g, o, e, rr, thr, 0.15, 8.0))(poses[:, :2], wp, r))
    zt = torch.zeros(n, dtype=torch.int32)
    tp, th = T.karto_counts_update_scan(zt, zt, tg, _t(poses[:, :2]),
                                        _t(wp), _t(r), thr, 0.15, 8.0)
    assert tp.dtype == torch.int32 and int(jh.sum()) > 100
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(th.numpy(), jh)
    wpc, whc = map(np.asarray, jax.jit(
        lambda o, e, rr: J.karto_counts_windows(g, o, e, rr, thr, 0.15, 8.0)
    )(poses[:, :2], wp, r))
    lp, lh = z, z
    step = jax.jit(lambda a, b, o, e, rr: J.karto_counts_update_scan(
        a, b, g, o, e, rr, thr, 0.15, 8.0))
    for t in range(len(poses)):
        lp, lh = step(lp, lh, poses[t, :2], wp[t], r[t])
    pc, hc = T.karto_counts_windows(tg, _t(poses[:, :2]), _t(wp), _t(r), thr,
                                    0.15, 8.0)
    assert pc.shape == (g.size_y, g.size_x) and pc.dtype == torch.int32
    for ref in (wpc, np.asarray(lp).reshape(wpc.shape)):
        np.testing.assert_array_equal(pc.numpy(), ref)
    for ref in (whc, np.asarray(lh).reshape(whc.shape)):
        np.testing.assert_array_equal(hc.numpy(), ref)


def test_karto_counts_windows_blocks_give_the_same_counts(monkeypatch):
    """Blocks of one scan and of a few: the same counts as one block."""
    poses, _pl, r, wp = _scans(4, T_=7)
    args = (port_config(ODD), _t(poses[:, :2]), _t(wp), _t(r), 6.0, 0.15,
            8.0)
    whole = T.karto_counts_windows(*args)
    S = T.karto_max_steps(port_config(ODD), 6.0)
    for scans_a_block in (1, 3):
        monkeypatch.setattr(T, "BLOCK_SAMPLES", scans_a_block * 180 * S)
        for a, b in zip(T.karto_counts_windows(*args), whole):
            assert torch.equal(a, b)


def test_samples_off_the_grid_go_to_spare_cells():
    """Rays that leave the grid and endpoints past its edge count nothing
    off it, raise nothing, and leave the counts of the cells inside."""
    g = GridConfig(resolution=0.1, size_x=20, size_y=10, origin_x=0.0,
                   origin_y=0.0)
    tg = port_config(g)
    origin = np.array([1.0, 0.5], np.float32)
    ends = np.array([[30.0, 0.5], [1.0, -20.0], [-5.0, -5.0], [1.5, 0.5]],
                    np.float32)
    ranges = np.hypot(*(ends - origin).T).astype(np.float32)
    z = torch.zeros(200, dtype=torch.int32)
    p, h = T.karto_counts_update_scan(z, z, tg, _t(origin), _t(ends),
                                      _t(ranges), 50.0, 0.0, 60.0)
    zj = jnp.zeros(200, jnp.int32)
    jp, jh = jax.jit(lambda: J.karto_counts_update_scan(
        zj, zj, g, origin, ends, ranges, 50.0, 0.0, 60.0))()
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert int(h.sum()) == 1  # only the endpoint on the grid is a hit
    hv = T.counts_update_scan(z, z, tg, _t(origin), _t(ends),
                              torch.ones(4, dtype=torch.bool), max_range=60.0,
                              acc=torch.zeros(200, 2))
    assert int(hv[0].sum()) == 1 and hv[2].shape == (200, 2)
    assert dataclasses.asdict(tg) == dataclasses.asdict(g)
