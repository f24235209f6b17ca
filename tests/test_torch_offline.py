"""The slice as a whole: tpu_slam_torch.models.offline.offline_slam against
tpu_slam's on test_offline.py's corridor mission (128 beams), with the
same scans and odometry fed to both."""

import dataclasses

import numpy as np
import pytest

from tpu_slam.models import offline as joff
from tpu_slam.utils.evaluation import ate_rmse
from tpu_slam_torch.convert import scan_from_numpy
from tpu_slam_torch.models import offline as toff

from test_offline import _corridor_mission
from test_torch_host_copies import port_config as _port_cfg


def _port_scans(scans):
    return scan_from_numpy(*(np.asarray(getattr(scans, f)) for f in (
        "ranges", "valid", "angles", "stamp", "time_increment")),
        device="cpu")



@pytest.fixture(scope="module")
def missions():
    cfg, scans, seq, odom = _corridor_mission()
    ref = joff.offline_slam(scans, cfg, odom=odom)
    out = toff.offline_slam(_port_scans(scans), _port_cfg(cfg), odom=odom)
    return cfg, scans, seq, odom, ref, out


def test_chain_matches_reference(missions):
    _cfg, _scans, _seq, _odom, ref, out = missions
    np.testing.assert_allclose(out.chain_rels, ref.chain_rels, atol=1e-4)
    np.testing.assert_allclose(out.chain_poses, ref.chain_poses, atol=1e-4)


def test_same_loops_accepted(missions):
    _cfg, _scans, _seq, _odom, ref, out = missions
    assert ref.loops, "the case must close loops"
    assert sorted((e.i, e.j) for e in out.loops) == sorted(
        (e.i, e.j) for e in ref.loops)
    assert out.candidates_tried == ref.candidates_tried


def test_poses_and_ate_match_reference(missions):
    _cfg, _scans, seq, _odom, ref, out = missions
    T = len(seq.gt_poses)
    assert out.poses.shape == (T, 3)
    np.testing.assert_allclose(out.poses[:, :2], ref.poses[:, :2], atol=1e-3)
    ate_ref = ate_rmse(ref.poses, seq.gt_poses)
    ate_out = ate_rmse(out.poses, seq.gt_poses)
    assert abs(ate_out - ate_ref) <= 5e-4
    # and the slice does its job: test_offline.py's bounds
    assert ate_out < 0.08
    assert ate_out <= ate_rmse(out.chain_poses, seq.gt_poses) + 1e-6


def test_stage_timer_records_every_stage(missions):
    *_, out = missions
    for stage in ("chain_match", "candidates", "loop_match", "pcm", "solve"):
        assert out.timer.counts[stage] >= 1, stage
    assert out.solver.num_nodes == out.poses.shape[0]


def test_host_helpers_match_reference():
    cfg, _scans, seq, _odom = _corridor_mission()
    ocfg, tocfg = cfg.offline, _port_cfg(cfg).offline
    np.testing.assert_array_equal(toff._seed_lattice(tocfg),
                                  joff._seed_lattice(ocfg))
    assert [toff._bucket(n) for n in (1, 64, 65, 1000)] == [
        joff._bucket(n) for n in (1, 64, 65, 1000)]
    assert toff._loop_candidates(seq.gt_poses, tocfg, set()) == \
        joff._loop_candidates(seq.gt_poses, ocfg, set())


def test_pcm_and_thinning_match_reference():
    rng = np.random.default_rng(5)
    poses = np.cumsum(rng.normal(0, 0.2, (300, 3)), axis=0)
    loops_t, loops_j = [], []
    for k in range(40):
        i = int(rng.integers(0, 150))
        j = int(rng.integers(i + 40, 300))
        mean = rng.normal(0, 0.5, 3)
        cov = np.diag(rng.uniform(1e-4, 1e-2, 3))
        args = dict(i=i, j=j, mean=mean, covariance=cov, error=0.01,
                    inlier_frac=float(rng.uniform(0.6, 1.0)), round=0)
        loops_t.append(toff.LoopEdge(**args))
        loops_j.append(joff.LoopEdge(**args))
    ocfg = dataclasses.replace(_corridor_mission()[0].offline,
                               max_solver_loops=12, pcm_chi2=50.0)
    np.testing.assert_array_equal(
        toff.consistent_loop_set(loops_t, poses, 1e-4, _port_cfg(ocfg)),
        joff.consistent_loop_set(loops_j, poses, 1e-4, ocfg))
    thin = toff._thin_loops(loops_t, _port_cfg(ocfg))
    assert 0 < len(thin) <= 12
    assert [(e.i, e.j) for e in thin] == sorted((e.i, e.j) for e in thin)


def test_unported_stages_raise():
    """The mesh form is the one stage still to port (the drift-control
    stages run; test_torch_outdoor.py holds them against the
    reference)."""
    cfg, scans, _seq, odom = _corridor_mission()
    cfg = _port_cfg(cfg)
    port = _port_scans(scans)
    with pytest.raises(NotImplementedError,
                       match="queue 1, item 6: multi-device"):
        toff.offline_slam(port, cfg, odom=odom, mesh=object())


@pytest.fixture(scope="module")
def undistorted():
    """tests/test_offline.py::test_offline_undistortion_mission's recipe
    (16 scans of 180 beams under fast rotation, motion distortion, IMU at
    500 Hz and odometry at 200 Hz) through both packages: the corrected
    points, and the mission on raw and on corrected points."""
    from tpu_slam.config import ScanConfig, default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan

    scfg = ScanConfig(num_beams=180)
    cfg = dataclasses.replace(default_config(), scan=scfg)
    traj = sim.circle_trajectory(16, radius=1.5, angular_rate=1.5)
    seq = sim.simulate_sequence(
        sim.office_world(seed=5), traj, scfg, noise_std=0.0, seed=1,
        motion_distortion=True, imu_rate_hz=500.0, odom_rate_hz=200.0)
    scans = make_scan(seq.ranges, scfg, stamp=seq.stamps.astype(np.float32))
    streams = (seq.imu_stamps, seq.imu_omega, seq.odom_stamps,
               seq.odom_poses)
    port = _port_scans(scans)
    pcfg = _port_cfg(cfg)
    corrected = toff.undistort_mission(port, *streams)
    return dict(
        cfg=pcfg, seq=seq, scans=port, streams=streams, corrected=corrected,
        ref_corrected=joff.undistort_mission(scans, *streams),
        raw=toff.offline_slam(port, pcfg, odom=seq.gt_poses),
        fixed=toff.offline_slam(port, pcfg, odom=seq.gt_poses,
                                corrected_pts=corrected),
        ref_fixed=joff.offline_slam(scans, cfg, odom=seq.gt_poses,
                                    corrected_pts=corrected))


def test_undistort_mission_batched_equals_per_scan(undistorted):
    import torch

    from tpu_slam_torch.data.scan import index_scan
    from tpu_slam_torch.ops.undistort import undistort_scan

    u = undistorted
    one = undistort_scan(index_scan(u["scans"], 5), *(
        torch.as_tensor(np.asarray(a, np.float32)) for a in u["streams"]))
    v5 = u["scans"].valid[5].numpy()
    np.testing.assert_allclose(u["corrected"][5][v5], one.numpy()[v5],
                               atol=1e-5)
    assert u["corrected"].dtype == np.float32
    assert not u["corrected"][~u["scans"].valid.numpy()].any()


def test_undistort_mission_matches_reference(undistorted):
    np.testing.assert_allclose(undistorted["corrected"],
                               undistorted["ref_corrected"], atol=1e-5)


def test_corrected_mission_beats_raw(undistorted):
    u = undistorted
    gt = u["seq"].gt_poses
    ate_raw = ate_rmse(u["raw"].chain_poses, gt)
    ate_fix = ate_rmse(u["fixed"].chain_poses, gt)
    assert ate_fix < 0.5 * ate_raw, (ate_raw, ate_fix)


def test_corrected_mission_matches_reference(undistorted):
    fixed, ref = undistorted["fixed"], undistorted["ref_fixed"]
    np.testing.assert_allclose(fixed.chain_poses, ref.chain_poses, atol=1e-4)
    np.testing.assert_allclose(fixed.poses, ref.poses, atol=1e-4)


def test_corrected_mission_uploads_a_points_store(monkeypatch, undistorted):
    # a corrected mission has per-beam directions: the matcher gets the
    # (T, N, 2) points, never the shared-direction ranges store
    u = undistorted
    stores = []
    make = toff.make_chain_matcher

    def recording(cfg):
        f = make(cfg)

        def g(store, *args):
            stores.append(tuple(store.shape))
            return f(store, *args)
        return g

    monkeypatch.setattr(toff, "make_chain_matcher", recording)
    for pts in (u["corrected"], None):
        toff.offline_slam(u["scans"], u["cfg"], odom=u["seq"].gt_poses,
                          corrected_pts=pts)
    assert stores == [(16, 180, 2), (16, 180)]


def test_needs_two_scans():
    cfg, scans, _seq, _odom = _corridor_mission()
    cfg = _port_cfg(cfg)
    port = _port_scans(scans)
    one = dataclasses.replace(port, **{
        f: getattr(port, f)[:1] for f in ("ranges", "valid", "angles",
                                          "stamp", "time_increment")})
    with pytest.raises(ValueError):
        toff.offline_slam(one, cfg)
