"""The port's examples (tpu_slam_torch/examples/run_*.py) against
tpu_slam's models on the same cut recipes on the CPU (10-20 scans each),
their options and their refusal to run without a card or --cpu; under
``-m slow`` the full recipes against the figures the reference examples
(examples/*.py --cpu) print, which chip_smoke.EXAMPLES_REF records."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.config import default_config as jdefault_config
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam_torch.config import default_config
from tpu_slam_torch.examples import (
    run_feature_detection, run_gmapping, run_hector_slam, run_karto_slam,
    run_lidar_undistortion, run_plicp_odometry, run_scan_matching,
)

EXAMPLES = ("run_feature_detection", "run_gmapping", "run_hector_slam",
           "run_karto_slam", "run_lidar_undistortion", "run_plicp_odometry",
           "run_scan_matching")


def _jscans(tscans, cfg):
    """The reference's scans of the same ranges and stamps."""
    return jmake_scan(tscans.ranges.numpy(), cfg.scan,
                      stamp=tscans.stamp.numpy())


def _jcfg(cfg):
    """The reference's config with the port config's fields."""
    from tpu_slam.config import SLAMConfig

    ref = jdefault_config()
    out = {}
    for f in dataclasses.fields(SLAMConfig):
        sec = getattr(cfg, f.name)
        out[f.name] = type(getattr(ref, f.name))(**dataclasses.asdict(sec))
    return SLAMConfig(**out)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_stops_without_a_card(name, monkeypatch):
    """No --cpu and no card: the example raises before it makes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"tpu_slam_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_features_example_matches_reference(capsys):
    from tpu_slam.ops.features import extract_corner_features

    cfg = default_config()
    scans = run_feature_detection.recipe(cfg, "cpu", n=16)
    fig = run_feature_detection.run(cfg, scans)
    ref = np.asarray(jax.jit(lambda s: extract_corner_features(
        s, _jcfg(cfg).features))(_jscans(scans, cfg))).sum(-1)
    np.testing.assert_array_equal(fig["per_scan"], ref)
    assert fig["mean"] == pytest.approx(ref.mean())
    # main prints the reference example's two lines
    out = run_feature_detection.main(["--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{out['scans']} scans featurized in ")
    assert lines[1] == (f"corners/scan: mean {out['mean']:.1f} min "
                        f"{out['min']} max {out['max']}")


def test_gmapping_example_matches_reference():
    from tpu_slam.models.gmapping import GMapping as JGMapping

    cfg = default_config()
    scans, poses = run_gmapping.recipe(cfg, "cpu", n=20)
    fig = run_gmapping.run(cfg, scans, poses, "cpu")
    ref = JGMapping(_jcfg(cfg))
    ref.run(_jscans(scans, cfg), poses)
    m = np.asarray(ref.to_ros_map())
    np.testing.assert_array_equal(fig["map"], m)
    assert (fig["occupied"], fig["free"], fig["unknown"]) == (
        int((m == 100).sum()), int((m == 0).sum()), int((m == -1).sum()))


def test_hector_example_matches_reference():
    from tpu_slam.models.hector_slam import HectorSLAM as JHectorSLAM
    from tpu_slam.utils.evaluation import ate_rmse as jate

    cfg = run_hector_slam.example_config()
    assert (cfg.hector.map_size, cfg.hector.map_multi_res_levels) == (512, 3)
    scans, gt = run_hector_slam.recipe(cfg, "cpu", n=15)
    fig = run_hector_slam.run(cfg, scans, gt, "cpu")
    ref = JHectorSLAM(_jcfg(cfg))
    ref.last_pose = jnp.asarray(gt[0], jnp.float32)
    est = ref.run(_jscans(scans, cfg))
    # test_torch_hector.py's whole-run bars
    np.testing.assert_allclose(fig["estimate"], est, rtol=0, atol=2e-3)
    assert fig["ate"] == pytest.approx(jate(est, gt, align=False), abs=1e-3)
    m = ref.to_ros_map()
    assert np.sum(fig["map"] != m) <= 1e-3 * np.sum(m != -1)


def test_karto_example_matches_reference():
    from tpu_slam.models.karto.pipeline import KartoSLAM as JKartoSLAM

    cfg = run_karto_slam.example_config()
    scans, odom, gt = run_karto_slam.recipe(cfg, "cpu", n=20)
    fig = run_karto_slam.run(cfg, scans, odom, gt, "cpu")
    ref = JKartoSLAM(_jcfg(cfg))
    accepted = ref.run(_jscans(scans, cfg), odom)
    assert fig["accepted"] == len(accepted)
    assert (fig["closures"], fig["edges"]) == (ref.loop_closures,
                                               ref.solver.num_edges)
    np.testing.assert_allclose(fig["estimate"], ref.trajectory(), rtol=0,
                               atol=1e-4)
    assert fig["occupied"] > 0 and fig["free"] > fig["occupied"]


def test_karto_example_config_and_options():
    """The example's options reach the mapper's configuration, which is
    otherwise test_karto.py's small one."""
    from test_karto import small_karto_cfg

    cfg = run_karto_slam.example_config(loop=False, async_backend=True)
    assert not cfg.karto.do_loop_closing and cfg.karto.async_loop_closure
    ref = small_karto_cfg()
    base = run_karto_slam.example_config()
    for sec in ("scan", "correlative", "loop"):
        assert dataclasses.asdict(getattr(base, sec)) == \
            dataclasses.asdict(getattr(ref, sec)), sec


def test_undistortion_example_matches_reference():
    from tpu_slam.ops.undistort import undistort_scan as jundistort

    cfg = default_config()
    scans, streams, seq = run_lidar_undistortion.recipe(cfg, "cpu", n=10)
    fig = run_lidar_undistortion.run(cfg, scans, streams, seq)
    ref = np.asarray(jax.jit(jundistort)(
        _jscans(scans, cfg), *(jnp.asarray(s.numpy()) for s in streams)))
    np.testing.assert_allclose(fig["corrected"].numpy(), ref, rtol=0,
                               atol=1e-5)
    assert fig["cor_err"] < 0.25 * fig["raw_err"]


def test_plicp_odometry_example_matches_reference():
    from tpu_slam.models.plicp_odometry import PLICPOdometry as JPLICP
    from tpu_slam.utils.evaluation import ate_rmse as jate

    cfg = default_config()
    scans, gt = run_plicp_odometry.recipe(cfg, "cpu", n=15)
    fig = run_plicp_odometry.run(cfg, scans, gt, "cpu")
    est = JPLICP(_jcfg(cfg)).run(_jscans(scans, cfg))
    np.testing.assert_allclose(fig["estimate"], est, rtol=0, atol=1e-4)
    assert fig["ate"] == pytest.approx(jate(est, gt), abs=1e-5)
    np.testing.assert_array_equal(fig["final_pose"], fig["estimate"][-1])


def test_plicp_odometry_example_reads_a_bag(tmp_path):
    """``--bag``: the LaserScan messages of the topic, stamps from the
    first, give the same scans as the recipe's."""
    from tpu_slam_torch.data.rosbag import serialize_laser_scan, write_bag

    cfg = default_config()
    scans, _gt = run_plicp_odometry.recipe(cfg, "cpu", n=4)
    r = scans.ranges.numpy()
    sc = cfg.scan
    msgs = [("/scan", "sensor_msgs/LaserScan", 5.0 + 0.1 * t,
             serialize_laser_scan({
                 "stamp": 5.0 + 0.1 * t, "frame_id": "laser",
                 "angle_min": sc.angle_min,
                 "angle_max": sc.angle_min + sc.angle_increment * (
                     r.shape[1] - 1),
                 "angle_increment": sc.angle_increment,
                 "time_increment": 0.0, "scan_time": sc.scan_period,
                 "range_min": sc.range_min, "range_max": sc.range_max,
                 "ranges": r[t], "intensities": np.zeros(0, np.float32)}))
            for t in range(4)]
    path = str(tmp_path / "scans.bag")
    write_bag(path, msgs)
    got = run_plicp_odometry.bag_scans(cfg, path, "/scan", "cpu")
    np.testing.assert_array_equal(got.ranges.numpy(), r)
    np.testing.assert_allclose(got.stamp.numpy(), 0.1 * np.arange(4),
                               atol=1e-6)


def test_scan_matching_example_matches_reference():
    from tpu_slam.ops.icp import icp_match
    from tpu_slam.ops.plicp import plicp_match

    cfg = default_config()
    jcfg = _jcfg(cfg)
    pairs, gt_d = run_scan_matching.recipe(cfg, "cpu", frames=10)
    fig = run_scan_matching.run(cfg, pairs, gt_d)
    jp = [jnp.asarray(p.numpy()) for p in pairs]
    ref = {"icp": np.asarray(jax.jit(
               lambda *a: icp_match(*a, jcfg.icp))(*jp)[0]),
           "plicp": np.asarray(jax.jit(
               lambda *a: plicp_match(*a, jcfg.plicp))(*jp).pose)}
    for name, pose in ref.items():
        np.testing.assert_allclose(fig[name]["estimate"], pose, rtol=0,
                                   atol=1e-4, err_msg=name)
        got = run_scan_matching.delta_rmse(pose, gt_d)
        assert (fig[name]["trans"], fig[name]["rot"]) == pytest.approx(
            got, abs=1e-5)


# --- the full recipes against the reference examples' printed figures ----


def _printed_equal(fig, ref):
    """Each recorded figure as the reference example prints it: counts
    exactly, lengths to 4 decimals, the corner mean to 1."""
    for key, want in ref.items():
        got = fig[key]
        if isinstance(want, tuple):  # a matcher's (trans, rot)
            assert (f"{got['trans']:.4f}", f"{got['rot']:.4f}") == tuple(
                f"{w:.4f}" for w in want), key
        elif isinstance(want, int):
            assert got == want, key
        elif key == "mean":
            assert f"{got:.1f}" == f"{want:.1f}", key
        else:
            assert f"{got:.4f}" == f"{want:.4f}", key


@pytest.mark.slow
@pytest.mark.parametrize("name", EXAMPLES)
def test_full_example_prints_the_references_figures(name, tmp_path):
    import chip_smoke

    mod = importlib.import_module(f"tpu_slam_torch.examples.{name}")
    argv = ["--cpu"]
    if name == "run_karto_slam":
        base = str(tmp_path / "map")
        argv += ["--save-map", base, "--checkpoint", base + ".npz"]
    _printed_equal(mod.main(argv), chip_smoke.EXAMPLES_REF[name])
    if name == "run_karto_slam":
        for suffix in (".pgm", ".yaml", "_graph.png", ".npz"):
            assert (tmp_path / f"map{suffix}").exists(), suffix
