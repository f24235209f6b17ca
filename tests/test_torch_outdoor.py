"""The outdoor offline mission's stages in tpu_slam_torch against tpu_slam,
on the same seeded inputs: the presets, the multi-query anchor matcher
(``match_anchors_store_async``) and the drift-control stages of
``offline_slam`` (skip edges, the anchor sweep and its macro schedule).
The JAX side of the anchor matcher runs compiled (``jax.jit``), as the
reference runs it, through its XLA response path."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import config as jconfig
from tpu_slam import geometry as jgeo
from tpu_slam import geometry_np as jgnp
from tpu_slam.config import ScanConfig
from tpu_slam.data import simulator as jsim
from tpu_slam.data.scan import make_scan
from tpu_slam.models import offline as joff
from tpu_slam.ops import correlative as J
from tpu_slam.solver import pose_graph as jpg
from tpu_slam.utils.evaluation import ate_rmse
from tpu_slam_torch import config as tconfig
from tpu_slam_torch.data import simulator as tsim
from tpu_slam_torch.models import offline as toff
from tpu_slam_torch.ops import correlative as T
from tpu_slam_torch.ops.cuda import correlative_response as K
from tpu_slam_torch.solver import pose_graph as tpg

from test_offline import _corridor_mission
from test_torch_correlative import _assert_same_match, _port_params
from test_torch_host_copies import port_config
from test_torch_offline import _port_scans


@pytest.mark.parametrize("name", ["karto_outdoor", "karto_indoor"])
def test_presets_are_the_references(name):
    ref = jconfig.preset(name)
    assert ref != jconfig.default_config()
    assert dataclasses.asdict(tconfig.preset(name)) == dataclasses.asdict(ref)


def test_unknown_preset_raises_in_both():
    for preset in (tconfig.preset, jconfig.preset):
        with pytest.raises(ValueError, match="unknown preset"):
            preset("karto_lunar")


# --- the multi-query anchor matcher ----------------------------------------


def _anchor_params(level):
    """The sweep's two matchers (``offline._mk_matcher``) under the outdoor
    preset, at a 5 m range threshold so that the grids stay small: the
    short level at the front end's window, the long level at
    ``anchor_long_*``."""
    c = jconfig.preset("karto_outdoor").correlative
    o = jconfig.OfflineConfig()
    search, res, smear = {
        "short": (c.correlation_search_space_dimension,
                  c.correlation_search_space_resolution,
                  c.correlation_search_space_smear_deviation),
        "long": (o.anchor_long_search, o.anchor_long_resolution,
                 o.anchor_long_smear)}[level]
    return J.CorrelativeParams(
        search_size=search, resolution=res, smear_deviation=smear,
        range_threshold=5.0, angle_offset=c.coarse_search_angle_offset,
        angle_res=c.coarse_angle_resolution,
        fine_angle_offset=c.fine_search_angle_offset,
        distance_variance_penalty=c.distance_variance_penalty,
        angle_variance_penalty=c.angle_variance_penalty,
        minimum_distance_penalty=c.minimum_distance_penalty,
        minimum_angle_penalty=c.minimum_angle_penalty)


@pytest.fixture(scope="module")
def anchor_store():
    """Six scans of 180 beams along an office path: a points store as
    ``offline_slam`` uploads it (invalid beams zeroed) and the true
    poses."""
    scan_cfg = ScanConfig(num_beams=180, range_max=6.0, range_threshold=5.0)
    traj = jsim.circle_trajectory(6, radius=1.2, angular_rate=0.5)
    world = jsim.office_world(seed=41, size=8.0, n_boxes=6, clear_path=traj)
    seq = jsim.simulate_sequence(world, traj, scan_cfg, noise_std=0.003,
                                 seed=2)
    scans = make_scan(seq.ranges, scan_cfg)
    valid = np.asarray(scans.valid)
    pts = np.where(valid[..., None], np.asarray(scans.points()),
                   0.0).astype(np.float32)
    return pts, valid, seq.gt_poses.astype(np.float32)


def _anchor_group(level, poses):
    """Two lanes of the sweep. Short: lane 0 matches scan 3 against
    scans 0 and 1 and a padded member, lane 1 is a padded lane (the
    sweep's last group). Long: lane 0 as before, lane 1 matches scan 5
    against 2, 3 and 4; the search centres are off the truth."""
    ci = np.full((2, 3), -1.0, np.float32)
    bp = np.zeros((2, 3, 3), np.float32)
    qi = np.zeros(2, np.float32)
    qp = np.zeros((2, 3), np.float32)
    ci[0, :2] = [0, 1]
    bp[0, :2] = poses[[0, 1]]
    qi[0] = 3
    qp[0] = poses[3] + np.float32([0.04, -0.03, 0.03])
    if level == "long":
        ci[1] = [2, 3, 4]
        bp[1] = poses[[2, 3, 4]]
        qi[1] = 5
        qp[1] = poses[5] + np.float32([-0.3, 0.2, -0.05])
    return ci, bp, qi, qp


def _ref_coarse(p, store_pts, store_valid, base_poses, idx, member, qi,
                pose):
    """The reference's coarse pass of one anchor lane, as its
    ``_full_anchor_store`` and ``correlate_scan`` compute it: the lane's
    grid and its int32 numerators."""
    bp = store_pts[idx]
    bv = store_valid[idx] & member[:, None]
    wp = jgeo.apply(base_poses[:, None, :], bp)
    keep = jax.vmap(J.find_valid_points, in_axes=(0, 0, None))(
        wp, bv, pose[:2])
    grid = J.build_correlation_grid(p, pose[:2], wp.reshape(-1, 2),
                                    keep.reshape(-1))
    m = J.CorrelativeMatcher(p, pallas_responses=None)
    xo = jnp.asarray(m.coarse_x)
    yo = jnp.asarray(m.coarse_y)
    angles = pose[2] - p.angle_offset + p.angle_res * jnp.arange(
        m.n_angles_coarse, dtype=jnp.float32)
    rel0 = (pose[:2] + jnp.stack([xo[0], yo[0]]) - pose[:2]) / p.resolution
    cand0 = J.kround_i(rel0) + p.center_cell
    stride = J._lattice_stride(m.coarse_x, m.coarse_y, p.resolution)
    nums = J._responses_sliced(grid, store_pts[qi] / p.resolution,
                               store_valid[qi], angles, cand0,
                               len(m.coarse_x), len(m.coarse_y), stride)
    return grid, nums


@pytest.mark.parametrize("level", ["short", "long"])
def test_anchor_matcher_matches_reference(anchor_store, level, monkeypatch):
    """Each lane its own query scan at its own centre against its own base
    scans, padded members and a padded lane included: the same (C, 13)
    result, each pass one response launch for both lanes, and the coarse
    pass's grids and int32 numerators equal lane by lane."""
    pts, valid, poses = anchor_store
    p = _anchor_params(level)
    ci, bp, qi, qp = _anchor_group(level, poses)
    ref = np.asarray(J.CorrelativeMatcher(
        p, use_response_expansion=False, pallas_responses=None
    ).match_anchors_store_async(jnp.asarray(pts), jnp.asarray(valid), ci,
                                bp, qi, qp))
    calls = []
    run = K.responses_sliced

    def recording(grid, ys, xs, beam_valid, n_x, n_y, stride):
        out = run(grid, ys, xs, beam_valid, n_x, n_y, stride)
        calls.append((grid, beam_valid, out))
        return out

    monkeypatch.setattr(K, "responses_sliced", recording)
    tm = T.CorrelativeMatcher(_port_params(p), use_response_expansion=False,
                              device="cpu")
    out = tm.match_anchors_store_async(torch.as_tensor(pts),
                                       torch.as_tensor(valid), ci, bp, qi, qp)
    got = T.to_host(out)
    assert got.shape == ref.shape == (2, 13)

    def result(a):
        return types.SimpleNamespace(pose=a[:, :3], response=a[:, 3],
                                     covariance=a[:, 4:].reshape(-1, 3, 3))

    _assert_same_match(result(got), result(ref))
    assert got[0, 3] > 0.3  # lane 0 matches its scan
    if level == "short":
        assert got[1, 3] == 0.0  # the padded lane has an empty grid
    # one launch a pass (coarse, fine) for both lanes, each lane its own
    # beam flags
    assert len(calls) == 2
    assert all(g.shape[0] == 2 and v.shape == (2, pts.shape[1])
               for g, v, _o in calls)
    coarse = jax.jit(_ref_coarse, static_argnums=0)
    member = ci >= -0.5
    idx = np.clip(ci.astype(np.int32), 0, len(pts) - 1)
    for lane in range(2):
        grid, nums = coarse(p, jnp.asarray(pts), jnp.asarray(valid),
                            jnp.asarray(bp[lane]), jnp.asarray(idx[lane]),
                            jnp.asarray(member[lane]), int(qi[lane]),
                            jnp.asarray(qp[lane]))
        g, _v, o = calls[0]
        np.testing.assert_array_equal(g[lane].numpy(),
                                      np.asarray(grid).astype(np.uint8))
        np.testing.assert_array_equal(o[lane].numpy(), np.asarray(nums))


# --- the drift-control stages of the mission --------------------------------


def _record_builds(monkeypatch, cls):
    """Every ``_build_solver``'s edges past the chain, in order: a solver
    takes the chain in one ``add_constraints`` call, then the skip edges,
    the anchor edges and the loops in one more."""
    builds = []  # (solver, its calls), the solver held so it stays apart
    add = cls.add_constraints

    def recording(self, ids_from, ids_to, means, *a, **kw):
        if not builds or builds[-1][0] is not self:
            builds.append((self, []))
        builds[-1][1].append(
            (np.asarray(ids_from).tolist(), np.asarray(ids_to).tolist(),
             np.asarray(means, np.float64)))
        return add(self, ids_from, ids_to, means, *a, **kw)

    monkeypatch.setattr(cls, "add_constraints", recording)
    return builds


def _extras(builds):
    """(i, j) and means of the edges past the chain of each build."""
    return [calls[1] if len(calls) > 1 else ([], [], np.zeros((0, 3)))
            for _solver, calls in builds]


def _assert_same_builds(tb, jb, atol=1e-4):
    t_ext, j_ext = _extras(tb), _extras(jb)
    assert len(t_ext) == len(j_ext)
    for (ti, tj, tm), (ji, jj, jm) in zip(t_ext, j_ext):
        assert list(zip(ti, tj)) == list(zip(ji, jj))
        np.testing.assert_allclose(tm, jm, atol=atol, rtol=0)


def test_drift_control_on_the_corridor_mission_matches_reference(
        monkeypatch):
    """A drift-control route length on test_offline.py's corridor mission
    runs the skip edges (it is too short for anchors) in both packages:
    the same edges in every solve, the same loops and poses."""
    cfg, scans, seq, odom = _corridor_mission()
    cfg = dataclasses.replace(cfg, offline=dataclasses.replace(
        cfg.offline, drift_control_min_route=1.0))
    jb = _record_builds(monkeypatch, jpg.PoseGraphSolver)
    tb = _record_builds(monkeypatch, tpg.PoseGraphSolver)
    ref = joff.offline_slam(scans, cfg, odom=odom)
    out = toff.offline_slam(_port_scans(scans), port_config(cfg), odom=odom)
    _assert_same_builds(tb, jb)
    skips = _extras(tb)[0]
    assert skips[0], "the route engages the skip edges"
    assert sorted((e.i, e.j) for e in out.loops) == sorted(
        (e.i, e.j) for e in ref.loops)
    assert out.anchors_tried == ref.anchors_tried == 0
    np.testing.assert_allclose(out.poses[:, :2], ref.poses[:, :2], atol=1e-3)
    assert abs(ate_rmse(out.poses, seq.gt_poses)
               - ate_rmse(ref.poses, seq.gt_poses)) <= 5e-4
    assert out.timer.counts["skip_match"] == 1


def _outdoor_cfg():
    """The outdoor preset on a small block at 180 beams: a 12 m range, the
    drift-control route, the anchors' scan count, spans and steps lowered
    so that skip edges, both anchor levels and the macro schedule fire on
    a few hundred scans, 2 anchor lanes (the reference compiles one
    program a lane), and a smaller loop search."""
    cfg = jconfig.preset("karto_outdoor")
    scan = dataclasses.replace(cfg.scan, num_beams=180,
                               angle_increment=2 * np.pi / 180,
                               range_max=12.0, range_threshold=12.0)
    off = dataclasses.replace(
        cfg.offline, drift_control_min_route=20.0, anchor_min_scans=100,
        anchor_span=40, anchor_gap=8, anchor_step=16, anchor_lanes=2,
        anchor_long_span=96, anchor_long_step=48, max_candidates=16,
        seeds_xy=3, seed_xy=1.0, seeds_theta=1)
    return dataclasses.replace(cfg, scan=scan, offline=off)


@pytest.fixture(scope="module")
def outdoor_missions():
    """One lap of a 16 m city block (outdoor_world at arm 16, street 4) at
    1.5 m/s, the outdoor recipe's noise and odometry drift, through both
    packages with the same settings, recording every solve's edges."""
    cfg = _outdoor_cfg()
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
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32))
    mp = pytest.MonkeyPatch()
    try:
        jb = _record_builds(mp, jpg.PoseGraphSolver)
        tb = _record_builds(mp, tpg.PoseGraphSolver)
        ref = joff.offline_slam(scans, cfg, odom=odom)
        out = toff.offline_slam(_port_scans(scans), port_config(cfg),
                                odom=odom)
    finally:
        mp.undo()
    return seq, ref, out, jb, tb


def test_outdoor_mission_edges_match_reference(outdoor_missions):
    """The same skip-edge pairs, anchor edges and loops in every solve of
    the mission, their means to 1e-4."""
    _seq, ref, out, jb, tb = outdoor_missions
    _assert_same_builds(tb, jb)
    ext = _extras(tb)
    assert ext[0][0], "the route engages the skip edges"
    # anchor edges: (t - span, t) at either level's span
    o = _outdoor_cfg().offline
    spans = {o.anchor_span, o.anchor_long_span}
    anchors = {(i, j) for ii, jj, _m in ext for i, j in zip(ii, jj)
               if j - i in spans}
    assert anchors, "the sweep accepts anchors"
    assert out.anchors_tried == ref.anchors_tried > 0
    assert out.anchors_accepted == ref.anchors_accepted > 0
    # the skip edges the port reports: the last graph's edges at a skip
    # stride (the spans differ from the strides) that are not loops
    loops = {(e.i, e.j) for e in out.loops}
    ii, jj, _m = ext[-1]
    skips = [(i, j) for i, j in zip(ii, jj)
             if j - i in o.skip_strides and (i, j) not in loops]
    assert out.skip_edges == len(skips) > 0
    assert sorted((e.i, e.j) for e in out.loops) == sorted(
        (e.i, e.j) for e in ref.loops)
    assert out.loops
    assert out.candidates_tried == ref.candidates_tried


def test_outdoor_mission_poses_and_ate_match_reference(outdoor_missions):
    seq, ref, out, _jb, _tb = outdoor_missions
    np.testing.assert_allclose(out.poses[:, :2], ref.poses[:, :2], atol=1e-3)
    ate_ref = ate_rmse(ref.poses, seq.gt_poses)
    ate_out = ate_rmse(out.poses, seq.gt_poses)
    assert abs(ate_out - ate_ref) <= 5e-4
    assert ate_out < ate_rmse(out.chain_poses, seq.gt_poses)
    for stage in ("chain_match", "skip_match", "loop_match", "anchor_match",
                  "pcm", "solve"):
        assert out.timer.counts[stage] >= 1, stage
