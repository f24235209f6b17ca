"""The port's own copies of the JAX package's host modules (config,
geometry_np, data/simulator, solver/banded, utils/evaluation,
utils/profiling with device_trace, utils/events, utils/map_io, the Hector
half of utils/checkpoint, the CLI's models and options) compute what the
JAX package's modules compute, on the same seeded inputs. ``port_config`` is
the tests' one way to hand both packages the same settings."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tpu_slam import config as jconfig
from tpu_slam import geometry_np as jgnp
from tpu_slam.data import simulator as jsim
from tpu_slam.solver import banded as jbanded
from tpu_slam.solver import schur as jschur
from tpu_slam.utils import evaluation as jeval
from tpu_slam.utils import events as jevents
from tpu_slam.utils import map_io as jmap_io
from tpu_slam_torch import config as tconfig
from tpu_slam_torch import geometry_np as tgnp
from tpu_slam_torch.convert import config_from_dict
from tpu_slam_torch.data import simulator as tsim
from tpu_slam_torch.solver import banded as tbanded
from tpu_slam_torch.solver import schur as tschur
from tpu_slam_torch.utils import evaluation as teval
from tpu_slam_torch.utils import events as tevents
from tpu_slam_torch.utils import map_io as tmap_io
from tpu_slam_torch.utils.profiling import StageTimer, ThroughputCounter, sync

YAMLS = sorted((pathlib.Path(jconfig.__file__).parent / "configs").glob(
    "*.yaml"))


def port_config(cfg):
    """The port's config with the same fields as the JAX config ``cfg``
    (a ``SLAMConfig`` or one of its sections)."""
    d = dataclasses.asdict(cfg)
    if isinstance(cfg, jconfig.SLAMConfig):
        return config_from_dict(d)
    return getattr(tconfig, type(cfg).__name__)(**d)


def test_default_config_is_the_same():
    ref = dataclasses.asdict(jconfig.default_config())
    assert dataclasses.asdict(tconfig.default_config()) == ref
    assert dataclasses.asdict(config_from_dict(ref)) == ref
    assert [f.name for f in dataclasses.fields(tconfig.SLAMConfig)] == [
        f.name for f in dataclasses.fields(jconfig.SLAMConfig)]


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.stem)
def test_yaml_config_crosses(path):
    ref = jconfig.config_from_yaml(str(path))
    assert ref != jconfig.default_config()
    out = config_from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    # the port's own loader reads the same file to the same config
    assert dataclasses.asdict(tconfig.config_from_yaml(str(path))) == \
        dataclasses.asdict(ref)


def test_shipped_presets_are_copies():
    """The port ships the reference's preset files unchanged."""
    ours = sorted((pathlib.Path(tconfig.__file__).parent / "configs").glob(
        "*.yaml"))
    assert [p.name for p in ours] == [p.name for p in YAMLS]
    for mine, ref in zip(ours, YAMLS):
        assert mine.read_bytes() == ref.read_bytes()


def test_outdoor_recipe_is_the_benchmarks():
    """benchmarks/bench_outdoor.py's world and route, copied onto the
    port's simulator, are bit-equal to the benchmark's."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "benchmarks"))
    try:
        import bench_outdoor
    finally:
        sys.path.pop(0)
    for arm, street, seed in ((80.0, 16.0, 4), (16.0, 4.0, 4)):
        np.testing.assert_array_equal(
            tsim.outdoor_world(arm=arm, street=street, seed=seed).segments,
            bench_outdoor.outdoor_world(arm=arm, street=street,
                                        seed=seed).segments)
    h, wi = 40.0, 24.0
    m = (h + wi) / 2
    lap = [[m, -m], [m, m], [-m, m], [-m, -m]]
    wps = np.array([[-m, -m]] + lap + [[0.0, -m]])
    want = jsim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    np.testing.assert_array_equal(tsim.outdoor_lap(), want)
    assert len(want) == 3234


def test_section_configs_cross():
    ref = jconfig.default_config()
    for f in dataclasses.fields(ref):
        sec = getattr(ref, f.name)
        assert dataclasses.asdict(port_config(sec)) == dataclasses.asdict(sec)


@pytest.mark.parametrize("seed", [0, 31])
def test_simulator_is_bit_equal(seed):
    cfg = jconfig.ScanConfig(num_beams=120)
    jtraj = jsim.circle_trajectory(8, radius=1.5, angular_rate=0.6)
    ttraj = tsim.circle_trajectory(8, radius=1.5, angular_rate=0.6)
    np.testing.assert_array_equal(ttraj, jtraj)
    jw = jsim.office_world(seed=seed, clear_path=jtraj)
    tw = tsim.office_world(seed=seed, clear_path=ttraj)
    np.testing.assert_array_equal(tw.segments, jw.segments)
    for distort in (False, True):
        j = jsim.simulate_sequence(jw, jtraj, cfg, noise_std=0.004,
                                   seed=seed, motion_distortion=distort,
                                   odom_drift=0.01)
        t = tsim.simulate_sequence(tw, ttraj, port_config(cfg),
                                   noise_std=0.004, seed=seed,
                                   motion_distortion=distort,
                                   odom_drift=0.01)
        for name in ("ranges", "angles", "stamps", "gt_poses", "imu_omega",
                     "odom_poses"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_corridor_loop_is_bit_equal():
    jt = np.concatenate([jsim.loop_trajectory(arm=9.0, width=2.6,
                                              speed=0.9)] * 2)
    tt = np.concatenate([tsim.loop_trajectory(arm=9.0, width=2.6,
                                              speed=0.9)] * 2)
    np.testing.assert_array_equal(tt, jt)
    jw = jsim.corridor_loop_world(arm=9.0, width=2.6)
    tw = tsim.corridor_loop_world(arm=9.0, width=2.6)
    cfg = jconfig.ScanConfig(num_beams=90)
    j = jsim.simulate_sequence(jw, jt[:40], cfg, seed=8)
    t = tsim.simulate_sequence(tw, tt[:40], port_config(cfg), seed=8)
    np.testing.assert_array_equal(t.ranges, j.ranges)


def _bench_graph(n=1024):
    """A noisy 2-loop chain with closures every 50 nodes (the bench pose
    graph): edge endpoints and the drifted initial poses."""
    rng = np.random.default_rng(17)
    th = np.linspace(0, 4 * np.pi, n)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    rels = jgnp.relative(gt[:-1], gt[1:]) + rng.normal(0, 0.005, (n - 1, 3))
    period = n // 2
    ei = np.concatenate([np.arange(n - 1), np.arange(0, n - period, 50)])
    ej = np.concatenate([np.arange(1, n), np.arange(0, n - period, 50)
                         + period])
    return ei, ej, gt, rels


def test_prepare_banded_gives_the_same_spec():
    ei, ej, gt, _rels = _bench_graph()
    n = len(gt)
    js = jbanded.prepare_banded(ei, ej, n)
    ts = tbanded.prepare_banded(ei, ej, n)
    assert js is not None and (ts.W, ts.K) == (js.W, js.K)
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(ts, f.name),
                                      getattr(js, f.name))
    assert (tbanded.NBANKS, tbanded.SLOT_ROWS) == (jbanded.NBANKS,
                                                   jbanded.SLOT_ROWS)
    rng = np.random.default_rng(2)
    means = rng.normal(0, 1, (len(ei), 3))
    infos = np.broadcast_to(np.diag([1e4, 1e4, 4e4]), (len(ei), 3, 3))
    np.testing.assert_array_equal(tbanded.build_slots_np(ts, means, infos),
                                  jbanded.build_slots_np(js, means, infos))
    np.testing.assert_array_equal(tbanded.flat_poses_np(ts, gt),
                                  jbanded.flat_poses_np(js, gt))
    assert tbanded.spec_cache_key(ei, ej, np.ones(len(ei), bool), n) == \
        jbanded.spec_cache_key(ei, ej, np.ones(len(ei), bool), n)


@pytest.mark.parametrize("n, S, seed", [(64, 4, 0), (200, 8, 1),
                                         (37, 5, 2), (16, 1, 3)])
def test_schur_partition_is_the_same(n, S, seed):
    """``build_partition`` and ``bucket_partition``: every field equal, on
    a chain with random closures (both directions, duplicates, masked
    edges)."""
    rng = np.random.default_rng(seed)
    k = 3 * n // 4
    ei = np.r_[np.arange(n - 1), rng.integers(0, n, k)]
    ej = np.r_[np.arange(1, n), rng.integers(0, n, k)]
    mask = rng.random(len(ei)) > 0.1
    ref = jschur.build_partition(ei, ej, mask, n, S)
    out = tschur.build_partition(ei, ej, mask, n, S)
    for a, b in ((out, ref), (tschur.bucket_partition(out),
                              jschur.bucket_partition(ref))):
        assert (a.n_submaps, a.n_nodes) == (b.n_submaps, b.n_nodes)
        for name in jschur._PART_ARRAY_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_ate_is_the_same():
    rng = np.random.default_rng(4)
    ref = np.cumsum(rng.normal(0, 0.1, (200, 3)), axis=0)
    est = ref + rng.normal(0, 0.02, ref.shape)
    for align in (True, False):
        assert teval.ate_rmse(est, ref, align=align) == \
            jeval.ate_rmse(est, ref, align=align)
    assert teval.rpe_rmse(est, ref, delta=3) == jeval.rpe_rmse(est, ref,
                                                               delta=3)


def test_geometry_np_is_the_same():
    rng = np.random.default_rng(6)
    a = rng.normal(0, 2, (50, 3))
    b = rng.normal(0, 2, (50, 3))
    np.testing.assert_array_equal(tgnp.compose(a, b), jgnp.compose(a, b))
    np.testing.assert_array_equal(tgnp.inverse(a), jgnp.inverse(a))
    np.testing.assert_array_equal(tgnp.relative(a[:, None], b[None]),
                                  jgnp.relative(a[:, None], b[None]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_candidates_are_the_same(seed):
    """``parallel/loop_search.loop_candidates``, the host chain
    extraction, on random distance rows with random exclusions."""
    from tpu_slam.parallel.loop_search import loop_candidates as jlc
    from tpu_slam_torch.parallel.loop_search import loop_candidates as tlc

    rng = np.random.default_rng(seed)
    d2 = np.where(rng.random(200) < 0.6, rng.uniform(0, 4, 200),
                  rng.uniform(4, 100, 200))
    exclude = set(rng.choice(200, 10, replace=False).tolist())
    for ex in (None, exclude):
        for min_chain in (1, 3, 5):
            got = tlc(d2, max_distance=2.0, min_chain=min_chain, exclude=ex)
            assert got == jlc(d2, 2.0, min_chain, ex)
    assert tlc(d2, 2.0, 3)  # the rows hold chains


def test_profiling_counts_and_syncs_on_the_cpu():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("match", sync_result=[torch.ones(2)]):
            pass
    assert timer.counts["match"] == 3 and timer.mean_ms("match") >= 0.0
    assert "match" in timer.report()
    sync({"x": torch.zeros(1)})  # nothing to wait for on the CPU
    tc = ThroughputCounter()
    tc.tick(5)
    assert tc.n == 5 and tc.per_sec > 0.0


def test_event_bus_is_the_same(caplog):
    """The MapperListener bus: each Fire* kind in order, listeners added
    and removed, and the logging listener's line."""
    heard = {}
    buses = {}
    for name, mod in (("jax", jevents), ("port", tevents)):
        bus = mod.EventBus()
        got = heard.setdefault(name, [])

        def listen(ev, got=got):
            got.append((ev.kind, ev.message))

        bus.add_listener(listen)
        bus.info("start")
        bus.loop_closure_check("scan 3 vs chain[0..9]")
        bus.begin_loop_closure("closing")
        bus.remove_listener(listen)
        bus.end_loop_closure("closed")
        bus.debug("harvested")
        buses[name] = bus
    assert heard["port"] == heard["jax"] == [
        ("info", "start"), ("loop_closure_check", "scan 3 vs chain[0..9]"),
        ("begin_loop_closure", "closing")]
    assert [(e.kind, e.message) for e in buses["port"].history] == [
        (e.kind, e.message) for e in buses["jax"].history]
    assert [f.name for f in dataclasses.fields(tevents.Event)] == [
        f.name for f in dataclasses.fields(jevents.Event)]
    with caplog.at_level("INFO"):
        ev = tevents.Event("info", "hello")
        tevents.logging_listener(ev)
        jevents.logging_listener(ev)
    assert [r.getMessage() for r in caplog.records] == ["[info] hello"] * 2


def test_map_io_is_the_same(tmp_path):
    """The map_server writer and reader and the graph overlay: the same
    pixels, files and maps; yaml, struct and zlib are imported only
    inside the functions, as there."""
    rng = np.random.default_rng(8)
    m = rng.choice(np.array([-1, 0, 40, 65, 100], np.int8), size=(23, 31))
    np.testing.assert_array_equal(tmap_io.to_trinary_pgm(m),
                                  jmap_io.to_trinary_pgm(m))
    pix = rng.integers(0, 256, (23, 31)).astype(np.uint8)
    np.testing.assert_array_equal(tmap_io.from_trinary_pgm(pix),
                                  jmap_io.from_trinary_pgm(pix))
    grid = port_config(jconfig.GridConfig(resolution=0.1, size_x=31,
                                          size_y=23, origin_x=-1.5,
                                          origin_y=0.25))
    poses = np.c_[rng.uniform(0, 3, (6, 2)), rng.uniform(-3, 3, 6)]
    edges = [(0, 1, "sequential"), (1, 2, "chain"), (2, 5, "loop"),
             (3, 4, "other")]
    for name, mod in (("t", tmap_io), ("j", jmap_io)):
        mod.save_graph_png(str(tmp_path / f"{name}.png"), m, grid, poses,
                           edges)
        mod.save_map(str(tmp_path / name), m, grid)
    for ext in (".png", ".pgm"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    back, g2 = tmap_io.load_map(str(tmp_path / "j.yaml"))
    np.testing.assert_array_equal(back, jmap_io.load_map(
        str(tmp_path / "j.yaml"))[0])
    assert dataclasses.asdict(g2) == dataclasses.asdict(grid)
    assert tmap_io.GRAPH_COLORS == jmap_io.GRAPH_COLORS
    assert not {"yaml", "struct", "zlib"} & set(vars(tmap_io))


def test_map_yaml_is_read_without_pyyaml(tmp_path):
    """The port reads map_server's flat YAML itself (the card's machine
    has no PyYAML): the keys load_map uses equal yaml.safe_load's, on a
    file as map_saver writes it, comments and quotes included."""
    import yaml

    text = ("image: 'lab map.pgm'  # the image\n"
            "resolution: 0.050000\n"
            "origin: [-12.2, 3.5e-1, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n\n")
    path = tmp_path / "m.yaml"
    path.write_text(text)
    ref = yaml.safe_load(text)
    got = tmap_io._read_map_yaml(str(path))
    assert got.keys() == ref.keys()
    assert got["image"] == ref["image"]
    assert got["origin"] == ref["origin"]
    for k in ("resolution", "negate", "occupied_thresh", "free_thresh"):
        assert got[k] == ref[k], k


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    from tpu_slam_torch.utils.profiling import device_trace

    path = tmp_path / "trace.json"
    with device_trace(str(path)):
        a = torch.arange(64.0).reshape(8, 8)
        (a @ a).sum()
    trace = json.loads(path.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


def test_hector_checkpoint_crosses_the_packages(tmp_path):
    """save_hector / load_hector: a snapshot of either package loads into
    the other's HectorSLAM to equal state (test_hector.py's small config,
    a few scans mapped and matched)."""
    import jax.numpy as jnp

    from tpu_slam.data.scan import index_scan as jindex_scan
    from tpu_slam.data.scan import make_scan as jmake_scan
    from tpu_slam.models.hector_slam import HectorSLAM as JHector
    from tpu_slam.utils import checkpoint as jckpt
    from tpu_slam_torch.convert import scan_from_numpy
    from tpu_slam_torch.data.scan import index_scan
    from tpu_slam_torch.models.hector_slam import HectorSLAM
    from tpu_slam_torch.utils import checkpoint as tckpt

    from test_hector import small_cfg

    cfg = small_cfg()
    traj = jsim.circle_trajectory(8, radius=1.5, angular_rate=0.6)
    world = jsim.office_world(seed=31, size=10.0, clear_path=traj)
    seq = jsim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                 seed=3)
    jscans = jmake_scan(seq.ranges, cfg.scan)
    tscans = scan_from_numpy(
        *(np.asarray(getattr(jscans, f)) for f in
          ("ranges", "valid", "angles", "stamp", "time_increment")),
        device="cpu")
    ref = JHector(cfg)
    port = HectorSLAM(port_config(cfg), device="cpu")
    for t in range(5):
        ref.step(jindex_scan(jscans, t))
        port.step(index_scan(tscans, t))
    jckpt.save_hector(ref, str(tmp_path / "ref.npz"))
    tckpt.save_hector(port, str(tmp_path / "port.npz"))
    assert sorted(np.load(tmp_path / "ref.npz").files) == \
        sorted(np.load(tmp_path / "port.npz").files)

    loaded = HectorSLAM(port_config(cfg), device="cpu")
    tckpt.load_hector(loaded, str(tmp_path / "ref.npz"))
    for g, r in zip(loaded.grids, ref.grids):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(loaded.last_pose.numpy(),
                                  np.asarray(ref.last_pose))
    np.testing.assert_array_equal(loaded._last_map_update_pose,
                                  ref._last_map_update_pose)

    jloaded = JHector(cfg)
    jckpt.load_hector(jloaded, str(tmp_path / "port.npz"))
    for g, r in zip(jloaded.grids, port.grids):
        np.testing.assert_array_equal(np.asarray(g), r.numpy())
    np.testing.assert_array_equal(np.asarray(jloaded.last_pose),
                                  port.last_pose.numpy())
    # the loaded port mapper steps on as the saved one does
    a = loaded.step(index_scan(tscans, 5))
    b = JHector(cfg)
    jckpt.load_hector(b, str(tmp_path / "ref.npz"))
    np.testing.assert_allclose(a, np.asarray(b.step(jindex_scan(jscans, 5))),
                               atol=2e-4)
    # before any map update the snapshot says so (NaN), and loads as None
    fresh = HectorSLAM(port_config(cfg), device="cpu")
    tckpt.save_hector(fresh, str(tmp_path / "fresh.npz"))
    tckpt.load_hector(loaded, str(tmp_path / "fresh.npz"))
    assert loaded._last_map_update_pose is None
    assert jnp.all(jnp.isnan(np.load(tmp_path / "fresh.npz")["last_update"]))


def test_cli_models_and_options_are_the_references():
    from tpu_slam import cli as jcli
    from tpu_slam_torch import cli

    assert cli.MODELS == jcli.MODELS

    def options(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       a.type, str(a.choices)) for a in parser._actions
                      if a.dest != "help")

    assert options(cli._build_parser()) == options(jcli._build_parser())
