"""Port parity: the lesson front-end ops of tpu_slam_torch (preprocess,
point-to-point ICP, corner features, undistortion) against tpu_slam's, on
the same seeded numpy inputs and the recipes of tpu_slam's own tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import geometry as jgeo
from tpu_slam.config import FeatureConfig, ICPConfig, PLICPConfig, ScanConfig
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.ops import features as jfeat
from tpu_slam.ops import icp as jicp
from tpu_slam.ops import preprocess as jpre
from tpu_slam.ops import undistort as jund
from tpu_slam.ops.plicp import plicp_match as jplicp
from tpu_slam_torch.data.scan import index_scan, make_scan
from tpu_slam_torch.ops import features as tfeat
from tpu_slam_torch.ops import icp as ticp
from tpu_slam_torch.ops import preprocess as tpre
from tpu_slam_torch.ops import undistort as tund
from tpu_slam_torch.ops.plicp import plicp_match

from test_features import reference_feature_select
from test_torch_host_copies import port_config
from test_torch_plicp import _pairs


def _scans(ranges, cfg, stamps=None):
    """The same ranges as a JAX Scan and as a port Scan on the CPU."""
    kw = {} if stamps is None else {"stamp": stamps}
    return (jmake_scan(ranges, cfg, **kw),
            make_scan(ranges, port_config(cfg), device="cpu", **kw))


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# --- preprocess ------------------------------------------------------------


def _noisy_ranges(seed, shape):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.05, 14.0, shape).astype(np.float32)
    r[rng.random(shape) < 0.1] = np.inf
    r[rng.random(shape) < 0.05] = np.nan
    return r


def test_preprocess_matches_reference():
    """The masking, the NaN fill, z and the compaction order are exact; the
    coordinates are the scan's own ``points()``, which both packages take
    from their own sin/cos (tests/test_torch_geometry.py: 1e-5)."""
    js, ts = _scans(_noisy_ranges(0, (3, 90)), ScanConfig(num_beams=90))
    jo, jc = jpre.compact_order(js.valid)
    to, tc = tpre.compact_order(ts.valid)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    v = ts.valid.numpy()
    pts = ts.points().numpy()
    for fill in (float("nan"), -1.0):
        ref = np.asarray(jpre.scan_to_pointcloud(js, invalid_value=fill))
        out = tpre.scan_to_pointcloud(ts, invalid_value=fill).numpy()
        assert out.shape == ref.shape == (3, 90, 3)
        np.testing.assert_array_equal(out[..., 2], 0.0)
        np.testing.assert_array_equal(out[~v], ref[~v])
        np.testing.assert_array_equal(out[v][:, :2], pts[v])
        np.testing.assert_allclose(out[v], ref[v], atol=1e-5)
    jp, jv = jpre.masked_points(js)
    tp, tv = tpre.masked_points(ts)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy()[~v], 0.0)
    np.testing.assert_array_equal(tp.numpy()[v], pts[v])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


# --- ICP -------------------------------------------------------------------


def test_procrustes_step_matches_reference():
    rng = np.random.default_rng(5)
    p = rng.normal(0, 3, (4, 60, 2)).astype(np.float32)
    q = rng.normal(0, 3, (4, 60, 2)).astype(np.float32)
    w = (rng.random((4, 60)) > 0.3).astype(np.float32)
    ref = np.asarray(jicp.procrustes_step(*map(jnp.asarray, (p, q, w))))
    out = ticp.procrustes_step(*_t(p, q, w)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_icp_match_matches_reference():
    arrays = _pairs(3, delta=(0.06, -0.02, 0.04), n=180)
    cfg = ICPConfig()
    g = np.asarray([[0, 0, 0], [0.02, 0.01, 0.0], [0, 0, 0.01]], np.float32)
    jp, je, jn = jicp.icp_match(*map(jnp.asarray, arrays), cfg,
                                init_pose=jnp.asarray(g))
    tp, te, tn = ticp.icp_match(*_t(*arrays), port_config(cfg),
                                init_pose=torch.as_tensor(g))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-7)


def test_point_to_point_plicp_matches_reference():
    arrays = _pairs(3, delta=(0.05, 0.03, -0.02), n=180)
    cfg = dataclasses.replace(PLICPConfig(), use_point_to_line_distance=False)
    ref = jplicp(*map(jnp.asarray, arrays), cfg)
    out = plicp_match(*_t(*arrays), port_config(cfg))
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))


# --- corner features ------------------------------------------------------


def _curvature_tol(ranges, jc, hw=5):
    """|Δcurvature| allowed between two float32 sums of the same 2·hw + 1
    taps in other orders: each sum d = Σ taps is off by at most
    (2·hw + 1)·ε·Σ|taps| ≤ (2·hw + 1)·ε·4·hw·max r, so d² by 2|d|·e + e²;
    plus rtol 1e-6 on the value."""
    e = (2 * hw + 1) * np.finfo(np.float32).eps * 4 * hw * np.nanmax(
        np.where(np.isfinite(ranges), ranges, np.nan))
    return 1e-6 * np.abs(jc) + 2 * np.sqrt(jc) * e + e * e


def _features_both(ranges, cfg, fcfg=FeatureConfig()):
    js, ts = _scans(ranges, cfg)
    jc, jo, jn = jfeat.curvature_compacted(js.ranges, js.valid,
                                           fcfg.half_window)
    tc, to, tn = tfeat.curvature_compacted(ts.ranges, ts.valid,
                                           fcfg.half_window)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jc, tc = np.asarray(jc), tc.numpy()
    assert (np.abs(tc - jc) <= _curvature_tol(ranges, jc)).all()
    jm = np.asarray(jfeat.extract_corner_features(js, fcfg))
    tm = tfeat.extract_corner_features(ts, port_config(fcfg)).numpy()
    return jc, tc, jm, tm


def _ranges(name):
    rng = np.random.default_rng(1234)
    if name == "flat":
        return np.full(64, 3.0, np.float32), 64
    if name == "corner":
        r = np.full(64, 3.0, np.float32)
        r[32:] = 6.0
        return r, 64
    if name == "random_invalid":
        r = rng.uniform(1.0, 9.0, size=240)
        r[rng.uniform(size=240) < 0.1] = np.inf
        return r.astype(np.float32), 240
    if name == "sector_cap":
        return rng.uniform(1.0, 9.0, size=360).astype(np.float32), 360
    if name == "batched":
        return rng.uniform(1.0, 9.0, size=(4, 120)).astype(np.float32), 120
    raise KeyError(name)


@pytest.mark.parametrize("name", ["flat", "corner", "random_invalid",
                                  "sector_cap", "batched"])
def test_corner_features_match_reference(name):
    """tests/test_features.py's recipes: curvature within the float32
    rounding of the window sum, and the same corner masks."""
    ranges, n = _ranges(name)
    cfg = ScanConfig(num_beams=n, range_max=50.0)
    jc, tc, jm, tm = _features_both(ranges, cfg)
    # a mask may differ only where a curvature sits at the threshold
    near = np.abs(jc - 1.0) <= _curvature_tol(ranges, jc)
    assert not near.any()
    np.testing.assert_array_equal(tm, jm)
    if name == "random_invalid":
        got = set(np.nonzero(tm)[0].tolist())
        assert got == reference_feature_select(ranges.astype(np.float64),
                                               FeatureConfig())
    if name == "sector_cap":
        assert 0 < tm.sum() <= 6 * 20


def test_corner_ties_keep_the_lower_index():
    # a square wave: every interior curvature is one of a few equal
    # values, more than 20 per sector above the threshold
    r = np.where(np.arange(240) % 12 < 6, 2.0, 4.0).astype(np.float32)
    cfg = ScanConfig(num_beams=240, range_max=50.0)
    jc, tc, jm, tm = _features_both(r, cfg)
    np.testing.assert_array_equal(tc, jc)
    assert len(np.unique(jc[jc > 1.0])) < 10 and tm.sum() > 0
    np.testing.assert_array_equal(tm, jm)


def test_feature_scan_restricts_validity():
    ranges, n = _ranges("random_invalid")
    js, ts = _scans(ranges, ScanConfig(num_beams=n, range_max=50.0))
    out = tfeat.feature_scan(ts, port_config(FeatureConfig()))
    ref = jfeat.feature_scan(js, FeatureConfig())
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.ranges is ts.ranges and out.valid.sum() < ts.valid.sum()


# --- undistortion ---------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "samples", "outside", "repeat"])
def test_interp_matches_jnp_interp(case):
    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(0, 10, 40)).astype(np.float32)
    fp = rng.normal(0, 3, 40).astype(np.float32)
    x = {"random": rng.uniform(0.5, 9.5, (3, 50)),
         "samples": xp,
         "outside": np.array([-5.0, xp[0], xp[-1], 20.0, -np.inf, np.inf]),
         "repeat": np.repeat(xp[10], 3)}[case].astype(np.float32)
    if case == "repeat":  # a zero-width segment
        xp[11] = xp[10]
    ref = np.asarray(jnp.interp(*map(jnp.asarray, (x, xp, fp))))
    out = tund.interp(*_t(x, xp, fp)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    if case in ("samples", "outside"):
        np.testing.assert_array_equal(out, ref)


def test_imu_and_pose_timelines_match_reference():
    t = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    w = np.sin(6 * t).astype(np.float32)
    q = np.array([-0.1, 0.0, 0.25, 0.5, 0.999, 1.3], np.float32)
    ref = np.asarray(jund.integrate_imu_rotation(*map(jnp.asarray, (t, w, q))))
    out = tund.integrate_imu_rotation(*_t(t, w, q)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    stamps = np.array([0.0, 1.0, 2.0], np.float32)
    poses = np.array([[0, 0, 3.0], [1, 0.5, -3.0], [2, 1, -2.5]], np.float32)
    qt = np.array([0.5, 1.5, 2.5, -1.0], np.float32)
    ref = np.asarray(jund.interp_pose_timeline(*map(jnp.asarray,
                                                    (stamps, poses, qt))))
    out = tund.interp_pose_timeline(*_t(stamps, poses, qt)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert abs(abs(float(out[0, 2])) - np.pi) < 0.2  # wrapped through ±π


@pytest.fixture(scope="module")
def distorted():
    """tests/test_undistort.py's recipe: a fast-turning office circle
    rendered with rolling-shutter distortion, IMU at 500 Hz, odometry at
    200 Hz."""
    cfg = ScanConfig(num_beams=180)
    world = sim.office_world(seed=5)
    traj = sim.circle_trajectory(12, radius=1.5, angular_rate=1.5)
    seq = sim.simulate_sequence(
        world, traj, cfg, noise_std=0.0, seed=1, motion_distortion=True,
        imu_rate_hz=500.0, odom_rate_hz=200.0,
    )
    streams = [np.asarray(a, np.float32) for a in (
        seq.imu_stamps, seq.imu_omega, seq.odom_stamps, seq.odom_poses)]
    js, ts = _scans(seq.ranges, cfg, seq.stamps.astype(np.float32))
    return seq, js, ts, streams


@pytest.mark.parametrize("imu,odom", [(True, True), (True, False),
                                      (False, True)])
def test_undistort_scan_matches_reference(distorted, imu, odom):
    _seq, js, ts, streams = distorted
    ref = np.asarray(jax.jit(jund.undistort_scan, static_argnums=(5, 6))(
        js, *map(jnp.asarray, streams), imu, odom))
    out = tund.undistort_scan(ts, *_t(*streams), use_imu=imu, use_odom=odom)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    single = tund.undistort_scan(index_scan(ts, 4), *_t(*streams),
                                 use_imu=imu, use_odom=odom)
    np.testing.assert_allclose(single.numpy(), out[4].numpy(), atol=1e-6)
    r = tund.undistorted_ranges(out, ts.valid).numpy()
    np.testing.assert_allclose(
        r, np.asarray(jund.undistorted_ranges(jnp.asarray(ref), js.valid)),
        atol=1e-5)


def test_undistortion_feeds_the_matcher(distorted):
    """tests/test_undistort.py's capability check on the port: PL-ICP
    deltas on corrected points beat those on the raw points."""
    seq, _js, ts, streams = distorted
    cor = tund.undistort_scan(ts, *_t(*streams))
    raw = torch.where(ts.valid[..., None], ts.points(), 0.0)
    valid = ts.valid
    gt = np.stack([np.asarray(jgeo.relative(jnp.asarray(seq.gt_poses[t - 1]),
                                            jnp.asarray(seq.gt_poses[t])))
                   for t in range(1, 12)])
    cfg = port_config(PLICPConfig())

    def rmse(pts):
        res = plicp_match(pts[1:], valid[1:], pts[:-1], valid[:-1], cfg)
        err = res.pose.numpy() - gt
        err[:, 2] = np.arctan2(np.sin(err[:, 2]), np.cos(err[:, 2]))
        return (np.sqrt((err[:, :2] ** 2).mean()),
                np.sqrt((err[:, 2] ** 2).mean()))

    (raw_t, raw_r), (cor_t, cor_r) = rmse(raw), rmse(cor)
    assert cor_r < 0.5 * raw_r and cor_t < 0.7 * raw_t
    assert cor_t < 0.01 and cor_r < 0.01
    ref = jplicp(*map(jnp.asarray, (cor[1:].numpy(), valid[1:].numpy(),
                                    cor[:-1].numpy(), valid[:-1].numpy())),
                 PLICPConfig())
    out = plicp_match(cor[1:], valid[1:], cor[:-1], valid[:-1], cfg)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
