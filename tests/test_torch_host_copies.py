"""The port's own copies of the JAX package's host modules (config,
geometry_np, data/simulator, solver/banded, utils/evaluation,
utils/profiling, utils/events) compute what the JAX package's modules compute, on the
same seeded inputs. ``port_config`` is the tests' one way to hand both
packages the same settings."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tpu_slam import config as jconfig
from tpu_slam import geometry_np as jgnp
from tpu_slam.data import simulator as jsim
from tpu_slam.solver import banded as jbanded
from tpu_slam.utils import evaluation as jeval
from tpu_slam.utils import events as jevents
from tpu_slam_torch import config as tconfig
from tpu_slam_torch import geometry_np as tgnp
from tpu_slam_torch.convert import config_from_dict
from tpu_slam_torch.data import simulator as tsim
from tpu_slam_torch.solver import banded as tbanded
from tpu_slam_torch.utils import evaluation as teval
from tpu_slam_torch.utils import events as tevents
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
