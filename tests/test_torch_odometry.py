"""Port parity: the lesson odometry models of tpu_slam_torch (ICPOdometry,
ScanMatchPLICP, PLICPOdometry and the batched matcher) against tpu_slam's
over the same simulated scans: tests/test_odometry.py's office circle cut
to 30 scans of 180 beams."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.icp_odometry import ICPOdometry as JICP
from tpu_slam.models.plicp_odometry import PLICPOdometry as JPLICP
from tpu_slam.models.plicp_odometry import plicp_match_batch as jbatch
from tpu_slam.models.scan_match_plicp import ScanMatchPLICP as JSM
from tpu_slam_torch.data.scan import index_scan, make_scan
from tpu_slam_torch.models.icp_odometry import ICPOdometry
from tpu_slam_torch.models.plicp_odometry import PLICPOdometry, plicp_match_batch
from tpu_slam_torch.models.scan_match_plicp import ScanMatchPLICP
from tpu_slam_torch.utils.evaluation import ate_rmse

from test_torch_host_copies import port_config

POSE_TOL = 1e-4  # m / rad over the whole run


def _cfg(**plicp):
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, num_beams=180,
                                 angle_increment=2 * np.pi / 180),
        plicp=dataclasses.replace(cfg.plicp, **plicp),
    )


@pytest.fixture(scope="module")
def office():
    """tests/test_odometry.py's recipe at 30 scans of 180 beams: (JAX cfg,
    JAX scans, port scans on the CPU, true poses)."""
    cfg = _cfg()
    traj = sim.circle_trajectory(30, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    stamps = seq.stamps.astype(np.float32)
    return (cfg, jmake_scan(seq.ranges, cfg.scan, stamp=stamps),
            make_scan(seq.ranges, port_config(cfg.scan), stamp=stamps,
                      device="cpu"),
            seq.gt_poses)


def _assert_traj_close(out, ref):
    np.testing.assert_allclose(out[:, :2], ref[:, :2], atol=POSE_TOL)
    dth = np.arctan2(np.sin(out[:, 2] - ref[:, 2]),
                     np.cos(out[:, 2] - ref[:, 2]))
    np.testing.assert_allclose(dth, 0.0, atol=POSE_TOL)


def _keyframe_steps(model):
    """Record the scan index of every keyframe switch of ``model``."""
    steps, decide = [], model._new_keyframe_needed
    count = [0]

    def recording(d_base):
        count[0] += 1
        out = decide(d_base)
        if out:
            steps.append(count[0])
        return out

    model._new_keyframe_needed = recording
    return steps


def test_icp_odometry_matches_reference(office):
    cfg, js, ts, gt = office
    ref = JICP(cfg).run(js)
    out = ICPOdometry(port_config(cfg), device="cpu").run(ts)
    _assert_traj_close(out, ref)
    assert ate_rmse(out, gt) < 0.25


def test_scan_match_plicp_matches_reference(office):
    cfg, js, ts, gt = office
    jm = JSM(cfg)
    ref = jm.run(js)
    tm = ScanMatchPLICP(port_config(cfg), device="cpu")
    out = tm.run(ts)
    _assert_traj_close(out, ref)
    np.testing.assert_allclose(tm.last_delta, jm.last_delta, atol=POSE_TOL)
    assert ate_rmse(out, gt) < 0.05


@pytest.mark.parametrize("kf_scan_count", [10, 1])
def test_plicp_odometry_matches_reference(office, kf_scan_count):
    cfg, js, ts, gt = office
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, kf_scan_count=kf_scan_count))
    jm = JPLICP(cfg, base_to_laser=(0.1, -0.05, 0.02))
    tm = PLICPOdometry(port_config(cfg), base_to_laser=(0.1, -0.05, 0.02),
                       device="cpu")
    jk, tk = _keyframe_steps(jm), _keyframe_steps(tm)
    ref = jm.run(js)
    out = tm.run(ts)
    _assert_traj_close(out, ref)
    assert tk == jk and len(tk) > 2
    assert ate_rmse(out, gt) < 0.05


def test_plicp_odometry_step_is_run(office):
    cfg, _js, ts, _gt = office
    a = PLICPOdometry(port_config(cfg), device="cpu")
    b = PLICPOdometry(port_config(cfg), device="cpu")
    out = a.run(index_scan(ts, slice(0, 8)))
    steps = np.stack([b.step(index_scan(ts, t)) for t in range(8)])
    np.testing.assert_array_equal(out, steps)


def test_plicp_odometry_fallbacks_match_reference(office):
    """A zero correction bound rejects every match: the trajectory is the
    constant-velocity prediction from rest, zeros. A sensor blackout keeps
    the prediction and stays finite."""
    cfg, js, ts, _gt = office
    strict = _cfg(max_linear_correction=0.0, max_angular_correction_deg=0.0)
    out = PLICPOdometry(port_config(strict), device="cpu").run(ts)
    np.testing.assert_allclose(out, 0.0, atol=1e-6)
    r = ts.ranges.clone()
    r[12:15] = float("inf")
    dark = make_scan(r, port_config(cfg.scan), stamp=ts.stamp, device="cpu")
    jr = np.asarray(js.ranges).copy()
    jr[12:15] = np.inf
    ref = JPLICP(cfg).run(jmake_scan(jr, cfg.scan, stamp=np.asarray(js.stamp)))
    out = PLICPOdometry(port_config(cfg), device="cpu").run(dark)
    assert np.isfinite(out).all()
    _assert_traj_close(out, ref)


def test_plicp_match_batch_matches_reference(office):
    cfg, js, ts, _gt = office
    pts = torch.where(ts.valid[..., None], ts.points(), 0.0)
    g = torch.zeros((29, 3))
    args = (pts[1:], ts.valid[1:], pts[:-1], ts.valid[:-1], g)
    out = plicp_match_batch(port_config(cfg))(*args)
    ref = jbatch(cfg)(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))


@pytest.mark.slow
def test_chip_smoke_references_are_the_reference_runs():
    """The reference figures chip_smoke.py holds the card's lesson runs to
    are tpu_slam's own CPU runs of the same recipes at 360 beams: each
    odometry model's ATE and PLICPOdometry's keyframes over
    examples/run_plicp_odometry.py's 200 scans, the delta RMSEs of
    examples/run_scan_matching.py's 120 pairs and the corner count of
    examples/run_feature_detection.py's 120 scans."""
    import jax

    import chip_smoke
    from tpu_slam.ops.features import extract_corner_features
    from tpu_slam.ops.icp import icp_match
    from tpu_slam.ops.plicp import plicp_match
    from tpu_slam.parallel.distributed_step import make_batched_matcher
    from tpu_slam.utils.evaluation import ate_rmse as jate

    cfg = default_config()
    _c, tscans, gt = chip_smoke.lesson_recipe("cpu")
    scans = jmake_scan(tscans.ranges.numpy(), cfg.scan,
                       stamp=tscans.stamp.numpy())
    models = {"icp": JICP(cfg), "plicp": JPLICP(cfg), "scan_match": JSM(cfg)}
    kf = _keyframe_steps(models["plicp"])
    for name, model in models.items():
        ate = jate(model.run(scans), gt)
        assert ate == pytest.approx(chip_smoke.LESSON_REF[name], rel=1e-3)
    assert kf == chip_smoke.LESSON_REF_KEYFRAMES

    _c, pairs, gt_d = chip_smoke.scan_matching_recipe("cpu")
    jp = [jnp.asarray(p.numpy()) for p in pairs]
    p2p = dataclasses.replace(cfg, plicp=dataclasses.replace(
        cfg.plicp, use_point_to_line_distance=False))
    est = {
        "icp": jax.jit(lambda *a: icp_match(*a, cfg.icp))(*jp)[0],
        "plicp": jax.jit(lambda *a: plicp_match(*a, cfg.plicp))(*jp).pose,
        "p2p": make_batched_matcher(p2p)(*jp, jnp.zeros((len(gt_d), 3))).pose,
    }
    for name, pose in est.items():
        got = chip_smoke.delta_rmse(np.asarray(pose), gt_d)
        np.testing.assert_allclose(got, chip_smoke.SCAN_MATCH_REF[name],
                                   rtol=1e-3)

    traj = sim.circle_trajectory(120, radius=1.6, angular_rate=0.5)
    world = sim.office_world(seed=9, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.003, seed=2)
    mask = jax.jit(lambda s: extract_corner_features(s, cfg.features))(
        jmake_scan(seq.ranges, cfg.scan))
    assert float(np.asarray(mask).sum(-1).mean()) == pytest.approx(
        chip_smoke.FEATURES_REF_MEAN)
