"""The online Karto mapper under the outdoor preset in tpu_slam_torch
against tpu_slam: a small outdoor block (the 16 m city block of
tests/test_torch_outdoor.py, every second scan of one lap) at 180 beams
and a 12 m range, the recipe's noise and odometry drift, the synchronous
back end. Both packages accept the same scans, build the same graph, close
the same loop and land on the same poses; the map of the result is the
same in both."""

import dataclasses

import jax
import numpy as np
import pytest

from tpu_slam import config as jconfig
from tpu_slam import geometry_np as jgnp
from tpu_slam.data import simulator as jsim
from tpu_slam.data.scan import make_scan
from tpu_slam.models.karto import occupancy as jocc
from tpu_slam.models.karto.pipeline import KartoSLAM as JKartoSLAM
from tpu_slam.utils.evaluation import ate_rmse
from tpu_slam_torch import _dispatch
from tpu_slam_torch.convert import scan_from_numpy
from tpu_slam_torch.data import simulator as tsim
from tpu_slam_torch.models.karto import occupancy as tocc
from tpu_slam_torch.models.karto.pipeline import KartoSLAM

from test_torch_host_copies import port_config
from test_torch_karto import FIELDS, POSE_ATOL, _assert_same_mapper


def _outdoor_online_cfg():
    """``preset("karto_outdoor")`` (the synchronous back end) at 180 beams
    and a 12 m range and range threshold."""
    cfg = jconfig.preset("karto_outdoor")
    assert not cfg.karto.async_loop_closure
    scan = dataclasses.replace(cfg.scan, num_beams=180,
                               angle_increment=2 * np.pi / 180,
                               range_max=12.0, range_threshold=12.0)
    return dataclasses.replace(cfg, scan=scan)


@pytest.fixture(scope="module")
def online_runs():
    """One lap of the 16 m block (outdoor_world at arm 16, street 4, seed
    4), every second scan (317), noise 0.01 with seed 6, odometry noise
    0.015 m and 0.003 rad from default_rng(3), through both packages."""
    cfg = _outdoor_online_cfg()
    traj = tsim.outdoor_lap(arm=16.0, street=4.0)[::2]
    world = jsim.World(tsim.outdoor_world(arm=16.0, street=4.0,
                                          seed=4).segments)
    seq = jsim.simulate_sequence(world, traj, cfg.scan, noise_std=0.01,
                                 seed=6)
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = jgnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.015, 2)
        d[2] += rng.normal(0, 0.003)
        odom.append(jgnp.compose(odom[-1], d))
    odom = np.asarray(odom)
    scans = jax.tree_util.tree_map(np.asarray, make_scan(
        seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32)))
    ref = JKartoSLAM(cfg)
    jacc = ref.run(scans, odom)
    ref.flush()
    port = KartoSLAM(port_config(cfg), device="cpu")
    before = dict(_dispatch.LAUNCHES)
    tacc = port.run(scan_from_numpy(*(getattr(scans, f) for f in FIELDS),
                                    device="cpu"), odom)
    port.flush()
    assert _dispatch.LAUNCHES == before  # the CPU runs no kernel
    return seq, odom, ref, jacc, port, tacc


def test_online_outdoor_block_matches_reference(online_runs):
    """The same accepted scans, edges and closures (at least one), poses
    within test_small_config_run_matches_reference's atol, and an ATE
    below the raw odometry's."""
    seq, odom, ref, jacc, port, tacc = online_runs
    np.testing.assert_array_equal(tacc, jacc)
    assert ref.loop_closures >= 1
    assert port.timer.counts["solve"] == ref.timer.counts["solve"] >= 1
    assert port.timer.counts["loop_coarse"] == ref.timer.counts["loop_coarse"]
    _assert_same_mapper(port, ref, POSE_ATOL)
    gt = seq.gt_poses[tacc]
    ate = ate_rmse(port.trajectory(), gt)
    assert ate == pytest.approx(ate_rmse(ref.trajectory(), gt),
                                abs=POSE_ATOL)
    assert ate < ate_rmse(odom[tacc], gt)


def test_online_outdoor_block_map_matches_reference(online_runs):
    """``karto_map`` of the two mappers: the same grid and int8 map."""
    _seq, _odom, ref, _jacc, port, _tacc = online_runs
    m, g = jocc.karto_map(ref, resolution=0.1)
    tm, tg = tocc.karto_map(port, resolution=0.1)
    assert dataclasses.asdict(tg) == dataclasses.asdict(g)
    np.testing.assert_array_equal(tm, m)
    assert (m == 100).sum() > 500 and (m == 0).sum() > 10_000
