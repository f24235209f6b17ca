"""Port parity for the Hector SLAM slice: tpu_slam_torch's scan helpers,
log-odds map update, GN matcher (the plain version of the hector_fused
kernel), the kernel's wrapper on the CPU, and the whole HectorSLAM run,
against tpu_slam's on the same seeded inputs. The JAX side runs its XLA
path, and its Pallas kernel in interpret mode, as test_hector.py does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import geometry as jgeo
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import index_scan as jindex_scan
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.data.scan import stack_scans as jstack_scans
from tpu_slam.data.scan import world_points as jworld_points
from tpu_slam.models.hector_slam import HectorSLAM as JHectorSLAM
from tpu_slam.models.hector_slam import build_pyramid_cfgs as jpyramid
from tpu_slam.ops import gridmap as jgm
from tpu_slam.ops import hector as jhector
from tpu_slam.ops.pallas.hector_fused import hector_match_fused as jfused
from tpu_slam.utils.evaluation import ate_rmse
from tpu_slam_torch import _dispatch
from tpu_slam_torch.convert import hector_state_from_numpy, scan_from_numpy
from tpu_slam_torch.data.scan import index_scan, stack_scans, world_points
from tpu_slam_torch.models.hector_slam import HectorSLAM, build_pyramid_cfgs
from tpu_slam_torch.ops import gridmap as tgm
from tpu_slam_torch.ops import hector as thector
from tpu_slam_torch.ops.cuda.hector_fused import hector_match_fused

from test_hector import small_cfg
from test_torch_host_copies import port_config

POSE_ATOL = 2e-4  # test_hector.py's fused-vs-XLA bounds
H_RTOL, H_ATOL = 1e-3, 1e-2
FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")


def _port_scans(scans):
    return scan_from_numpy(*(np.asarray(getattr(scans, f)) for f in FIELDS),
                           device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def hector_seq():
    """test_hector.py's fixture: 60 scans of an office circle, 256² grid,
    3 levels; the scans in both packages."""
    cfg = small_cfg()
    traj = sim.circle_trajectory(60, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, size=10.0, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=3)
    scans = jmake_scan(seq.ranges, cfg.scan,
                       stamp=seq.stamps.astype(np.float32))
    return cfg, scans, _port_scans(scans), seq


def _mapped(cfg, scans, seq, n=3):
    """A JAX HectorSLAM with scans 0..n-1 mapped at their true poses."""
    slam = JHectorSLAM(cfg)
    for t in range(n):
        slam.update_only(jindex_scan(scans, t), seq.gt_poses[t])
    return slam


def _probs(slam):
    return [np.asarray(jgm.occupancy_prob(g)) for g in slam.grids]


def test_scan_helpers_match_reference(hector_seq):
    _cfg, scans, tscans, seq = hector_seq
    pose = seq.gt_poses[:4].astype(np.float32)
    ref = jworld_points(jindex_scan(scans, slice(0, 4)), jnp.asarray(pose))
    out = world_points(index_scan(tscans, slice(0, 4)), _t(pose))
    v = np.asarray(scans.valid)[:4]
    np.testing.assert_allclose(out.numpy()[v], np.asarray(ref)[v], atol=1e-5)
    js = jstack_scans([jindex_scan(scans, 5), jindex_scan(scans, 2)])
    ts = stack_scans([index_scan(tscans, 5), index_scan(tscans, 2)])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


def test_pyramid_cfgs_match_reference():
    cfg = small_cfg()
    ref = [dataclasses.asdict(g) for g in jpyramid(cfg)]
    assert [dataclasses.asdict(g)
            for g in build_pyramid_cfgs(port_config(cfg))] == ref


def test_interp_matches_reference():
    rng = np.random.default_rng(7)
    size = 16
    grid = rng.uniform(0, 1, size * size).astype(np.float32)
    # in bounds, on cell borders, and off the map on every side
    coords = np.concatenate([
        rng.uniform(-2, size + 2, (200, 2)),
        rng.integers(0, size, (20, 2)).astype(np.float64),
        [[size - 1, 3.0], [3.0, size - 1], [-0.0, 0.0], [np.inf, 2.0],
         [np.nan, 1.0]],
    ]).astype(np.float32)
    ref = jhector.interp_map_with_derivs(jnp.asarray(grid), size, size,
                                         jnp.asarray(coords))
    out = thector.interp_map_with_derivs(_t(grid), size, size, _t(coords))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_gn_step_matches_reference(hector_seq):
    cfg, scans, _tscans, seq = hector_seq
    slam = _mapped(cfg, scans, seq)
    gc = slam.grid_cfgs[0]
    prob = _probs(slam)[0]
    s = jindex_scan(scans, 4)
    pts = np.where(np.asarray(s.valid)[:, None], np.asarray(s.points()), 0.0)
    pts = (pts / gc.resolution).astype(np.float32)
    valid = np.asarray(s.valid)
    guess = seq.gt_poses[4] + [0.04, -0.03, 0.02]
    pm = np.asarray(jhector.world_pose_to_map(gc, jnp.asarray(
        guess, jnp.float32)))
    ref = jhector.gn_step(jnp.asarray(prob), gc.size_x, gc.size_y,
                          jnp.asarray(pm), jnp.asarray(pts),
                          jnp.asarray(valid), 0.2)
    out = thector.gn_step(_t(prob), gc.size_x, gc.size_y, _t(pm), _t(pts),
                          _t(valid), 0.2)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                               rtol=H_RTOL, atol=H_ATOL)
    # no valid beam: H = 0, and the pose does not move in either package
    none = np.zeros_like(valid)
    ref = jhector.gn_step(jnp.asarray(prob), gc.size_x, gc.size_y,
                          jnp.asarray(pm), jnp.asarray(pts),
                          jnp.asarray(none), 0.2)
    out = thector.gn_step(_t(prob), gc.size_x, gc.size_y, _t(pm), _t(pts),
                          _t(none), 0.2)
    np.testing.assert_array_equal(out[0].numpy(), pm)
    np.testing.assert_array_equal(np.asarray(ref[0]), pm)
    assert not out[1].any()
    # one valid beam: a rank-1 H (singular in f32) takes a finite step or
    # none, and does not raise as torch.linalg.solve would
    one = np.zeros_like(valid)
    one[np.flatnonzero(valid)[10]] = True
    out = thector.gn_step(_t(prob), gc.size_x, gc.size_y, _t(pm), _t(pts),
                          _t(one), 0.2)
    assert torch.isfinite(out[0]).all()


def test_solve3_matches_linalg():
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (20, 3, 3))
    H = (A @ A.transpose(0, 2, 1) + np.eye(3)).astype(np.float32)
    b = rng.normal(0, 1, (20, 3)).astype(np.float32)
    ref = np.linalg.solve(H.astype(np.float64) + 1e-9 * np.eye(3),
                          b[..., None])[..., 0]
    np.testing.assert_allclose(thector.solve3(_t(H), _t(b)).numpy(), ref,
                               rtol=1e-4, atol=1e-4)
    assert not thector.solve3(torch.zeros(3, 3) - 1e-9 * torch.eye(3),
                              torch.ones(3)).any()


@pytest.fixture(scope="module")
def match_case(hector_seq):
    """test_hector.py's fused fixture: a map of scans 0-2, scan 4 matched
    from its true pose plus (0.04, -0.03, 0.02)."""
    cfg, scans, tscans, seq = hector_seq
    slam = _mapped(cfg, scans, seq)
    s = jindex_scan(scans, 4)
    pts = np.where(np.asarray(s.valid)[:, None], np.asarray(s.points()),
                   0.0).astype(np.float32)
    guess = (seq.gt_poses[4] + [0.04, -0.03, 0.02]).astype(np.float32)
    return cfg, slam, pts, np.asarray(s.valid), guess, seq.gt_poses[4]


def test_match_multires_matches_reference(match_case):
    cfg, slam, pts, valid, guess, truth = match_case
    probs = _probs(slam)
    ref_pose, ref_H = jhector.match_multires(
        [jnp.asarray(p) for p in probs], slam.grid_cfgs, jnp.asarray(guess),
        jnp.asarray(pts), jnp.asarray(valid), cfg.hector)
    tcfg = port_config(cfg)
    pose, H = thector.match_multires(
        [_t(p) for p in probs], build_pyramid_cfgs(tcfg), _t(guess), _t(pts),
        _t(valid), tcfg.hector)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(H.numpy(), np.asarray(ref_H), rtol=H_RTOL,
                               atol=H_ATOL)
    err = pose.numpy() - truth
    assert abs(err[0]) < 0.03 and abs(err[1]) < 0.03


@pytest.mark.parametrize("map_size,windowed", [(256, False), (512, True)])
def test_wrapper_on_cpu_matches_fused_interpret(hector_seq, map_size,
                                                windowed):
    """The port's hector_match_fused on CPU tensors (its plain route)
    against the reference's Pallas kernel in interpret mode, full-grid and
    with its pose-centred window (test_hector.py's two fused cases).
    Invalid beams carry NaN coordinates, which both wrappers zero."""
    cfg, scans, _tscans, seq = hector_seq
    cfg = dataclasses.replace(
        cfg, hector=dataclasses.replace(cfg.hector, map_size=map_size))
    slam = _mapped(cfg, scans, seq)
    s = jindex_scan(scans, 4)
    valid = np.asarray(s.valid)
    pts = np.where(valid[:, None], np.asarray(s.points()),
                   np.nan).astype(np.float32)
    guess = (seq.gt_poses[4] + [0.04, -0.03, 0.02]).astype(np.float32)
    probs = [p.reshape(c.size_y, c.size_x)
             for p, c in zip(_probs(slam), slam.grid_cfgs)]
    rmax = None
    if windowed:
        rmax = float(np.max(np.asarray(s.ranges)[valid])) + 0.25
    ref_pose, ref_H = jfused(
        tuple(jnp.asarray(p) for p in probs), tuple(slam.grid_cfgs),
        cfg.hector, jnp.asarray(guess), jnp.asarray(pts), jnp.asarray(valid),
        interpret=True, max_range_m=rmax)
    tcfg = port_config(cfg)
    before = dict(_dispatch.LAUNCHES)
    pose, H = hector_match_fused(
        tuple(_t(p) for p in probs), tuple(build_pyramid_cfgs(tcfg)),
        tcfg.hector, _t(guess), _t(pts), _t(valid))
    assert _dispatch.LAUNCHES == before  # the CPU runs no kernel
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(H.numpy(), np.asarray(ref_H), rtol=H_RTOL,
                               atol=H_ATOL)


def test_logodds_update_matches_reference(hector_seq):
    cfg, scans, _tscans, seq = hector_seq
    slam = _mapped(cfg, scans, seq, n=2)
    for lvl, gc in enumerate(slam.grid_cfgs):
        for t in (2, 9):
            s = jindex_scan(scans, t)
            pose = seq.gt_poses[t].astype(np.float32)
            valid = np.asarray(s.valid)
            pts = np.where(valid[:, None], np.asarray(s.points()), 0.0)
            wp = np.asarray(jgeo.apply(jnp.asarray(pose), jnp.asarray(pts)))
            jargs = (jnp.asarray(pose[:2]), jnp.asarray(wp),
                     jnp.asarray(valid))
            targs = (_t(pose[:2]), _t(wp), _t(valid))
            jf, jo = jgm.scan_masks(gc, *jargs, max_range=12.0)
            tf, to = tgm.scan_masks(port_config(gc), *targs, max_range=12.0)
            touched = int(np.sum(np.asarray(jf) | np.asarray(jo)))
            split = int(np.sum(tf.numpy() != np.asarray(jf))
                        + np.sum(to.numpy() != np.asarray(jo)))
            # f32 cell borders may split a cell: at most 0.1% of touched
            assert touched > 100 and split <= 1e-3 * touched, (lvl, split)
            grid = np.asarray(slam.grids[lvl])
            ref = jgm.logodds_update_scan(jnp.asarray(grid), gc, slam.locfg,
                                          *jargs, max_range=12.0)
            out = tgm.logodds_update_scan(_t(grid), port_config(gc),
                                          port_config(slam.locfg), *targs,
                                          max_range=12.0)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-6)
            np.testing.assert_array_equal(
                tgm.logodds_to_ros(out).numpy(),
                np.asarray(jgm.logodds_to_ros(ref)))


def _run_recording_updates(slam, scans, index, T):
    """Run ``slam`` step by step; returns (poses, indices of the scans that
    updated the map)."""
    poses, updates = [], []
    for t in range(T):
        before = slam._last_map_update_pose
        poses.append(slam.step(index(scans, t)))
        if slam._last_map_update_pose is not before:
            updates.append(t)
    return np.asarray(poses, np.float64), updates


def test_whole_run_matches_reference(hector_seq):
    cfg, scans, tscans, seq = hector_seq
    T = len(seq.gt_poses)
    ref = JHectorSLAM(cfg)
    ref.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    rp, ru = _run_recording_updates(ref, scans, jindex_scan, T)
    out = HectorSLAM(port_config(cfg), device="cpu")
    out.last_pose = _t(seq.gt_poses[0].astype(np.float32))
    op, ou = _run_recording_updates(out, tscans, index_scan, T)
    np.testing.assert_allclose(op, rp, atol=2e-3)
    assert ou == ru and len(ou) > 5
    ate_ref = ate_rmse(rp, seq.gt_poses, align=False)
    ate_out = ate_rmse(op, seq.gt_poses, align=False)
    assert ate_ref < 0.06 and ate_out < 0.06, (ate_ref, ate_out)
    # the run of the port through the wrapper launches nothing on the CPU
    # and gives test_hector.py's map
    m, mr = out.to_ros_map(), ref.to_ros_map()
    assert (m == 100).sum() > 100 and (m == 0).sum() > 5000
    assert np.sum(m != mr) <= 1e-3 * np.sum(mr != -1)


def test_step_from_a_carried_state(hector_seq):
    cfg, scans, tscans, seq = hector_seq
    ref = JHectorSLAM(cfg)
    ref.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    for t in range(12):
        ref.step(jindex_scan(scans, t))
    out = hector_state_from_numpy(
        HectorSLAM(port_config(cfg), device="cpu"),
        [np.asarray(g) for g in ref.grids], np.asarray(ref.last_pose),
        ref._last_map_update_pose, device="cpu")
    for g, r in zip(out.grids, ref.grids):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    pr = ref.step(jindex_scan(scans, 12))
    po = out.step(index_scan(tscans, 12))
    np.testing.assert_allclose(po, pr, atol=POSE_ATOL)
    np.testing.assert_allclose(out.last_cov, np.asarray(ref.last_cov),
                               rtol=H_RTOL, atol=H_ATOL)
    for g, r in zip(out.grids, ref.grids):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    with pytest.raises(ValueError, match="levels"):
        hector_state_from_numpy(out, out.grids[:1], np.zeros(3), None,
                                device="cpu")


def test_sampling_covariance_matches_reference(hector_seq):
    cfg, scans, tscans, seq = hector_seq
    ref = _mapped(cfg, scans, seq)
    ref.last_pose = jnp.asarray(seq.gt_poses[3], jnp.float32)
    out = hector_state_from_numpy(
        HectorSLAM(port_config(cfg), device="cpu"),
        [np.asarray(g) for g in ref.grids], np.asarray(ref.last_pose),
        ref._last_map_update_pose, device="cpu")
    for level in (0, 2):
        np.testing.assert_allclose(
            out.sampling_covariance(index_scan(tscans, 3), level),
            ref.sampling_covariance(jindex_scan(scans, 3), level),
            rtol=1e-4, atol=1e-10)
    out.last_pose = torch.tensor([1e3, 1e3, 0.0])  # off the map
    assert np.isfinite(out.sampling_covariance(index_scan(tscans, 3))).all()


def test_map_only_and_mesh(hector_seq):
    cfg, scans, tscans, seq = hector_seq
    ref = _mapped(cfg, scans, seq, n=20)
    out = HectorSLAM(port_config(cfg), device="cpu")
    for t in range(20):
        out.update_only(index_scan(tscans, t), seq.gt_poses[t])
    assert np.sum(out.to_ros_map() != ref.to_ros_map()) <= 1e-3 * np.sum(
        ref.to_ros_map() != -1)
    assert (out.to_ros_map(level=1) == 100).sum() > 20
    with pytest.raises(NotImplementedError, match="multi-device"):
        HectorSLAM(port_config(cfg), device="cpu", mesh=object())


# --- the kernel's design, held on the CPU ---------------------------------


@pytest.mark.parametrize("N", [1, 100, 360, 1080, 4096, 4097, 5000, 12345])
def test_hector_geometry_covers_every_beam_once(N):
    from tpu_slam_torch.ops.cuda import hector_fused as ch

    geo = ch.hector_geometry(N)
    T, K, C = geo.threads, geo.beams, geo.chunks
    assert 32 <= T <= ch.max_threads(K) and T % 32 == 0
    assert 1 <= K <= ch.MAX_BEAMS_PER_THREAD
    # the kernel's chunk count, from N
    assert C == -(-N // (K * T))
    # beam (c·K + k)·T + t on thread t: every beam once
    slots = [(c * K + k) * T + t
             for c in range(C) for k in range(K) for t in range(T)]
    assert sorted(i for i in slots if i < N) == list(range(N))
    assert (C - 1) * K * T < N  # no chunk without a beam
    if C == 1:  # no slot of beams idle on every thread
        assert (K - 1) * T < N
    if N <= ch.MAX_THREADS * 4:  # one pass of registers: no chunks
        assert C == 1
        assert T == min(ch.THREADS, 32 * -(-N // 32)) or N > ch.THREADS * 8


def test_hector_geometry_rejects_beyond_its_limit():
    from tpu_slam_torch.ops.cuda import hector_fused as ch

    # below one beam; above 4,096 the largest instance takes chunks
    for N in (0, -1):
        with pytest.raises(ValueError, match="beams"):
            ch.hector_geometry(N)
    assert ch.hector_geometry(4097) == ch.HectorGeometry(
        ch.max_threads(ch.MAX_BEAMS_PER_THREAD), ch.MAX_BEAMS_PER_THREAD, 2)


def test_hector_kernel_constants_are_the_wrappers():
    import re

    from tpu_slam_torch import _build
    from tpu_slam_torch.ops.cuda import hector_fused as ch

    src = (_build.CSRC / "hector_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    for name in ("MAX_LEVELS", "MAX_THREADS", "MAX_BEAMS_PER_THREAD"):
        assert const(name) == getattr(ch, name), name
    instances = [int(k) for k in re.findall(r"HECTOR_CASE\((\d+)\)", src)]
    assert sorted(set(instances)) == list(
        range(1, ch.MAX_BEAMS_PER_THREAD + 1))
    assert src.count("__syncthreads()") == ch.BARRIERS_PER_STEP
    assert len(_build.SIGNATURES["hector_fused"][1]) == 15
