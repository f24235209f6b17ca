"""The Karto occupancy map of tpu_slam_torch (models/karto/occupancy.py and
utils/map_io.py) against tpu_slam's: the grid bounds, the map of both
device engines on the same scans, ``karto_map`` after the same small-config
Karto run, the pose-graph PNG and the map_server file round trip."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.karto import occupancy as J
from tpu_slam.models.karto.pipeline import KartoSLAM as JKartoSLAM
from tpu_slam.utils import map_io as jmap_io
from tpu_slam.utils.checkpoint import save_karto as jsave_karto
from tpu_slam_torch.convert import karto_state_from_checkpoint, scan_from_numpy
from tpu_slam_torch.models.karto import occupancy as T
from tpu_slam_torch.models.karto.pipeline import KartoSLAM
from tpu_slam_torch.utils import map_io as tmap_io

from test_torch_host_copies import port_config

sys.path.insert(0, os.path.dirname(__file__))
from test_aux import _decode_png  # noqa: E402
from test_karto import drifted_odometry, small_karto_cfg  # noqa: E402

FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")


def _mission_scans(seed, T_=40, N=180):
    """``T_`` scans of ``N`` beams along a drifting path: float64 poses,
    laser points (0 where not finite), raw ranges with NaN, inf and short
    readings."""
    rng = np.random.default_rng(seed)
    poses = np.cumsum(np.c_[rng.normal(0.1, 0.05, (T_, 2)),
                            rng.normal(0, 0.2, T_)], axis=0)
    ang = np.linspace(-np.pi, np.pi, N, endpoint=False)
    r = rng.uniform(0.05, 7.0, (T_, N)).astype(np.float32)
    r[rng.random((T_, N)) < 0.04] = np.nan
    r[rng.random((T_, N)) < 0.04] = np.inf
    with np.errstate(invalid="ignore"):
        pl = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    pl = np.where(np.isfinite(pl), pl, 0.0).astype(np.float32)
    return poses, pl, r


@pytest.mark.parametrize("seed", [0, 1])
def test_karto_grid_bounds_are_the_references(seed):
    poses, pl, r = _mission_scans(seed)
    for thr in (4.0, 12.0):
        ref = J.karto_grid_bounds(poses, pl, r, 0.15, thr, 0.05)
        out = T.karto_grid_bounds(poses, pl, r, 0.15, thr, 0.05)
        assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    ref = J.compute_grid_bounds(poses, 5.0, 0.1)
    assert dataclasses.asdict(T.compute_grid_bounds(poses, 5.0, 0.1)) == \
        dataclasses.asdict(ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_occupancy_from_scans_engines_match_reference(seed):
    """Both device engines of both packages give one int8 map (the
    reference's compiled windows and scatter loop; the port's blocks and
    scan-by-scan steps, 1 and 3 scans a step)."""
    poses, pl, r = _mission_scans(seed)
    grid = J.karto_grid_bounds(poses, pl, r, 0.15, 5.0, 0.05)
    kw = dict(min_range=0.15, max_range=6.5)
    ref = J.occupancy_from_scans(grid, poses, pl, r, 5.0, engine="device",
                                 **kw)
    np.testing.assert_array_equal(
        J.occupancy_from_scans(grid, poses, pl, r, 5.0,
                               engine="device-scatter", **kw), ref)
    assert ref.dtype == np.int8 and (ref == 100).sum() > 100
    tg = port_config(grid)
    for engine, per in (("device", 1), ("auto", 1), ("device-scatter", 1),
                        ("device-scatter", 3)):
        out = T.occupancy_from_scans(tg, poses, pl, r, 5.0, engine=engine,
                                     scans_per_block=per, device="cpu", **kw)
        assert out.dtype == np.int8
        np.testing.assert_array_equal(out, ref)


def test_engines_that_are_not_ported_raise():
    """Every engine is ported: the native engine (the C++ host
    rasterizer) gives the reference's native map and the port's device
    map; an unknown engine raises, and no scans give an unknown map."""
    poses, pl, r = _mission_scans(2, T_=3)
    jgrid = J.karto_grid_bounds(poses, pl, r, 0.15, 5.0, 0.05)
    grid = port_config(jgrid)
    native = T.occupancy_from_scans(grid, poses, pl, r, 5.0, engine="native",
                                    device="cpu")
    np.testing.assert_array_equal(
        native, J.occupancy_from_scans(jgrid, poses, pl, r, 5.0,
                                       engine="native"))
    np.testing.assert_array_equal(
        native, T.occupancy_from_scans(grid, poses, pl, r, 5.0,
                                       engine="device", device="cpu"))
    assert (native == 100).sum() > 10
    with pytest.raises(ValueError, match="unknown engine"):
        T.occupancy_from_scans(grid, poses, pl, r, 5.0, engine="tpu",
                               device="cpu")
    empty = T.occupancy_from_scans(grid, poses[:0], pl[:0], r[:0], 5.0,
                                   device="cpu")
    assert empty.shape == (grid.size_y, grid.size_x) and (empty == -1).all()


@pytest.fixture(scope="module")
def karto_runs(tmp_path_factory):
    """tests/test_aux.py::test_karto_occupancy_map's run (small_karto_cfg,
    the corridor loop's first 100 scans, drifting odometry) in both
    packages, and the port's mapper loaded with the reference's state
    (its checkpoint)."""
    cfg = small_karto_cfg()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:100]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = jax.tree_util.tree_map(np.asarray, jmake_scan(
        seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32)))
    ref = JKartoSLAM(cfg)
    ref.run(scans, odom)
    port = KartoSLAM(port_config(cfg), device="cpu")
    port.run(scan_from_numpy(*(getattr(scans, f) for f in FIELDS),
                             device="cpu"), odom)
    path = str(tmp_path_factory.mktemp("karto") / "ref.npz")
    jsave_karto(ref, path)
    loaded = karto_state_from_checkpoint(
        KartoSLAM(port_config(cfg), device="cpu"), path)
    return ref, port, loaded


def test_karto_map_after_the_same_run(karto_runs):
    """The same run in both packages gives the same map on the same grid;
    the reference's state carried across gives the reference's map too."""
    ref, port, loaded = karto_runs
    m, g = J.karto_map(ref, resolution=0.1)
    assert (m == 100).sum() > 100 and (m == 0).sum() > 1000
    assert (m == -1).sum() > 100
    for mapper in (port, loaded):
        tm, tg = T.karto_map(mapper, resolution=0.1)
        assert dataclasses.asdict(tg) == dataclasses.asdict(g)
        assert tm.dtype == np.int8
        np.testing.assert_array_equal(tm, m)


def test_karto_graph_png(karto_runs, tmp_path):
    """karto_graph_png draws the same picture in both packages, from the
    map it rasterizes and from a map it is given."""
    ref, _port, loaded = karto_runs
    want = _decode_png(J.karto_graph_png(ref, str(tmp_path / "ref.png"),
                                         resolution=0.1))
    got = _decode_png(T.karto_graph_png(loaded, str(tmp_path / "port.png"),
                                        resolution=0.1))
    np.testing.assert_array_equal(got, want)
    m, g = T.karto_map(loaded, resolution=0.1)
    again = _decode_png(T.karto_graph_png(loaded, str(tmp_path / "p2.png"),
                                          ros_map=m, grid=g))
    np.testing.assert_array_equal(again, want)
    assert want.shape == (g.size_y, g.size_x, 3)


def test_map_io_roundtrip(tmp_path):
    """tests/test_aux.py::test_map_io_roundtrip on the port's copy, and the
    same bytes as the reference's writer."""
    rng = np.random.RandomState(3)
    m = rng.choice(np.array([-1, 0, 100], np.int8),
                   size=(37, 53)).astype(np.int8)
    grid = port_config(jmap_io.GridConfig(
        resolution=0.05, size_x=53, size_y=37, origin_x=-1.25, origin_y=2.5))
    pgm, yml = tmap_io.save_map(str(tmp_path / "map"), m, grid)
    m2, g2 = tmap_io.load_map(yml)
    np.testing.assert_array_equal(m2, m)
    assert dataclasses.asdict(g2) == dataclasses.asdict(grid)
    rpgm, ryml = jmap_io.save_map(str(tmp_path / "ref"), m, grid)
    with open(pgm, "rb") as a, open(rpgm, "rb") as b:
        assert a.read() == b.read()
    with open(yml) as a, open(ryml) as b:
        assert a.read().replace("map.pgm", "ref.pgm") == b.read()
    m3, _g3 = jmap_io.load_map(yml)
    np.testing.assert_array_equal(m3, m)


def test_graph_png_renders_typed_edges(tmp_path):
    """tests/test_aux.py::test_graph_png_renders_typed_edges on the port's
    copy."""
    grid = port_config(jmap_io.GridConfig(
        resolution=0.1, size_x=40, size_y=30, origin_x=0.0, origin_y=0.0))
    m = np.zeros((30, 40), np.int8)
    poses = np.array([[0.5, 0.5, 0.0], [2.5, 0.5, 0.0], [2.5, 2.5, 0.0],
                      [0.5, 2.5, 0.0]])
    edges = [(0, 1, "sequential"), (1, 2, "sequential"), (2, 3, "chain"),
             (3, 0, "loop")]
    path = tmap_io.save_graph_png(str(tmp_path / "g.png"), m, grid, poses,
                                  edges)
    rgb = _decode_png(path)[::-1]
    assert rgb.shape == (30, 40, 3)
    colors = tmap_io.GRAPH_COLORS
    assert tuple(rgb[5, 15]) == colors["sequential"]
    assert tuple(rgb[15, 25]) == colors["sequential"]
    assert tuple(rgb[25, 15]) == colors["chain"]
    assert tuple(rgb[15, 5]) == colors["loop"]
    assert tuple(rgb[5, 6]) == colors["node"]
    assert tuple(rgb[2, 35]) == (254, 254, 254)
    np.testing.assert_array_equal(
        tmap_io.render_graph_overlay(m, grid, poses, edges),
        jmap_io.render_graph_overlay(m, grid, poses, edges))
