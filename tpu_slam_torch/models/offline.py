"""Offline batch SLAM: the whole mission as a handful of batched device
calls — port of ``tpu_slam/models/offline.py::offline_slam``.

  1. every consecutive scan pair is matched in ONE batched PL-ICP call
     against a once-uploaded mission scan store (ranges + beam directions),
     with the pose integration in the same call (``make_chain_matcher``);
  2. on routes of ``drift_control_min_route`` or more, skip edges: scan t
     against t + s for the strides ``skip_strides``, in ONE batched PL-ICP
     call, gated on inliers, the error gate and the deviation from the
     chain;
  3. loop candidates come from a pose-proximity sweep on the device
     (``ops/cuda/loop_sweep``: one read of the picked pairs);
  4. candidates are matched by multi-start batched PL-ICP, with best-seed
     selection and gating on the device (``make_loop_selector``);
  5. pairwise-consistent loops plus the chain (and the skip and anchor
     edges) feed the LM pose-graph solve;
  6. detection → match → solve repeats ``OfflineConfig.rounds`` times;
  7. on those routes, the correlative anchor sweep: every anchor scan
     re-matched against a submap of its recent past at the current
     estimates (``CorrelativeMatcher.match_anchors_store_async``, C lanes
     a group, two levels, a solve between them), alternating with loop
     re-detection for up to ``macro_rounds`` passes; the anchor edges are
     dropped before the final solve once ``anchor_drop_min_loops`` loops
     are accepted.

The device is the device of the scans' tensors. ``corrected_pts`` (for
instance ``undistort_mission``'s output) replaces the polar→Cartesian
conversion of the scans.

With a mesh (``parallel/mesh.Mesh``; every rank calls ``offline_slam``
on the same scans) the device is the mesh's, and every PL-ICP batch,
chain, skip and loop, goes through the sharded packed matcher: each rank
matches its block of the pairs and all get the whole result. As in the
reference's mesh branch, the chain is integrated on the host and the loop
seeds' gates are evaluated on the host in float64 on the gathered rows;
the back end is ``PoseGraphSolver(mesh=mesh)``. The anchor sweep runs
whole on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.correlative import (
    CorrelativeMatcher, CorrelativeParams, to_host,
)
from tpu_slam_torch.ops.cuda.loop_sweep import loop_sweep
from tpu_slam_torch.ops.undistort import undistort_scan
from tpu_slam_torch.parallel.distributed_step import (
    make_chain_matcher, make_loop_selector, make_packed_indexed_matcher,
)
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver
from tpu_slam_torch.utils.profiling import StageTimer, count


@dataclasses.dataclass
class LoopEdge:
    i: int
    j: int
    mean: np.ndarray  # (3,) T_{i,j} in i's frame
    covariance: np.ndarray  # (3, 3)
    error: float
    inlier_frac: float
    round: int


@dataclasses.dataclass
class OfflineResult:
    poses: np.ndarray  # (T, 3) optimized laser-frame poses
    chain_poses: np.ndarray  # (T, 3) raw integrated odometry chain
    chain_rels: np.ndarray  # (T-1, 3) consecutive PL-ICP transforms
    loops: list  # list[LoopEdge]
    solver: PoseGraphSolver
    candidates_tried: int
    timer: object = None  # StageTimer
    anchors_accepted: int = 0  # correlative re-anchor edges in the graph
    anchors_tried: int = 0
    skip_edges: int = 0  # skip edges accepted into the graph


def _bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _seed_lattice(ocfg) -> np.ndarray:
    """(S, 3) additive perturbations around the predicted relative pose."""
    xs = np.linspace(-ocfg.seed_xy, ocfg.seed_xy, ocfg.seeds_xy)
    ths = np.linspace(-ocfg.seed_theta, ocfg.seed_theta, ocfg.seeds_theta)
    gx, gy, gt = np.meshgrid(xs, xs, ths, indexing="ij")
    return np.stack(
        [gx.ravel(), gy.ravel(), gt.ravel()], axis=-1
    ).astype(np.float32)


def _loop_candidates(
    poses, ocfg, tried: set
) -> list[tuple[int, int]]:
    """Pose-proximity candidate pairs (i < j), thinned by non-maximum
    suppression along both scan indices (the analogue of Karto's
    FindPossibleLoopClosure sweep, done once over the whole mission):
    ``ops/cuda/loop_sweep``, on the card for a CUDA tensor of poses, in
    its plain version for a CPU tensor or a numpy array. Counts the live
    cells the sweep walked (``offline.sweep_cells``)."""
    if not isinstance(poses, torch.Tensor):
        poses = torch.as_tensor(np.asarray(poses)[:, :2], dtype=torch.float32)
    picked, live = loop_sweep(poses, ocfg.loop_radius, ocfg.loop_min_gap,
                              ocfg.loop_nms_gap, ocfg.max_candidates, tried)
    count("offline.sweep_cells", live)
    return picked


def consistent_loop_set(
    loops: list[LoopEdge],
    poses: np.ndarray,
    chain_step_var: float,
    ocfg,
) -> np.ndarray:
    """Pairwise-consistency filtering of loop edges (PCM-style greedy max
    clique): two true edges are consistent through the odometry chain, a
    corridor-slide alias breaks every cycle it is in. Returns a boolean
    keep-mask over ``loops``."""
    C = len(loops)
    if C <= 1:
        return np.ones(C, bool)
    ci = np.array([e.i for e in loops])
    cj = np.array([e.j for e in loops])
    Tm = np.stack([e.mean for e in loops])  # (C, 3)
    covs = np.stack([e.covariance for e in loops])  # (C, 3, 3)

    # Q_e = P_{i_e} · T_e : the edge's claim for pose j_e in world frame
    Q = gnp.compose(poses[ci], Tm)
    # cycle C_ab = rel(Q_a, Q_b) ∘ rel(P_{j_b}, P_{j_a})
    relQ = gnp.compose(gnp.inverse(Q)[:, None, :], Q[None, :, :])
    relP = gnp.compose(
        gnp.inverse(poses[cj])[None, :, :], poses[cj][:, None, :]
    )
    cyc = gnp.compose(relQ, relP)

    d2xy = cyc[..., 0] ** 2 + cyc[..., 1] ** 2
    dth = np.arctan2(np.sin(cyc[..., 2]), np.cos(cyc[..., 2]))

    # allowance: both edges' covariances + drift of the chain segments
    sig_xy = np.maximum(
        np.linalg.eigvalsh(covs[:, :2, :2]).max(axis=-1), 1e-8
    )
    sig_th = np.maximum(covs[:, 2, 2], 1e-10)
    gap = np.abs(ci[:, None] - ci[None, :]) + np.abs(cj[:, None] - cj[None, :])
    drift = ocfg.pcm_drift_inflation * chain_step_var * gap
    var_xy = sig_xy[:, None] + sig_xy[None, :] + drift
    var_th = sig_th[:, None] + sig_th[None, :] + 0.1 * drift
    chi2 = d2xy / var_xy + dth**2 / var_th
    adj = chi2 <= ocfg.pcm_chi2
    np.fill_diagonal(adj, True)

    # greedy max clique: seed with the highest-degree edge, grow by degree
    deg = adj.sum(axis=1)
    order = np.argsort(-deg)
    clique: list[int] = []
    for k in order:
        if all(adj[k, c] for c in clique):
            clique.append(int(k))
    keep = np.zeros(C, bool)
    keep[clique] = True
    return keep


def _thin_loops(loop_edges: list[LoopEdge], ocfg) -> list[LoopEdge]:
    """Cap the loop set the solver sees (the full set stays in the result):
    keep the best edge (highest inlier fraction) per (i, j) NMS cell, then
    evenly subsample to ``max_solver_loops``."""
    cap = ocfg.max_solver_loops
    if len(loop_edges) <= cap:
        return loop_edges
    g = max(ocfg.loop_nms_gap, 1)
    best: dict[tuple[int, int], LoopEdge] = {}
    for e in loop_edges:
        c = (e.i // g, e.j // g)
        b = best.get(c)
        if b is None or e.inlier_frac > b.inlier_frac:
            best[c] = e
    kept = sorted(best.values(), key=lambda e: (e.i, e.j))
    if len(kept) > cap:
        idx = np.linspace(0, len(kept) - 1, cap).round().astype(int)
        kept = [kept[k] for k in sorted(set(idx.tolist()))]
    return kept


def laser_points(ranges, valid, angles, corrected_pts=None) -> np.ndarray:
    """The mission's (T, N, 2) float32 laser-frame points, as the reference
    computes them on the host: ``corrected_pts``, or the polar→Cartesian
    conversion of the ranges; invalid beams and non-finite points
    zeroed."""
    if corrected_pts is not None:
        pts = np.where(valid[..., None], np.asarray(corrected_pts, np.float32),
                       0.0).astype(np.float32)
    else:
        pts = np.where(
            valid[..., None],
            np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1),
            0.0,
        ).astype(np.float32)
    pts[~np.isfinite(pts)] = 0.0
    return pts


def anchor_levels(cfg: SLAMConfig, T: int, device) -> list:
    """The anchor sweep's levels for a mission of T scans, in sweep order:
    (level, matcher, span, gap, step). Level 1, the long lever at a
    coarser pitch (``anchor_long_*``), sweeps first where the mission is
    long enough; level 0 is the front end's window. The matchers take no
    response expansion, as the reference's do."""
    c, ocfg = cfg.correlative, cfg.offline

    def matcher(search, res, smear):
        return CorrelativeMatcher(
            CorrelativeParams(
                search_size=search,
                resolution=res,
                smear_deviation=smear,
                range_threshold=cfg.scan.range_threshold,
                angle_offset=c.coarse_search_angle_offset,
                angle_res=c.coarse_angle_resolution,
                fine_angle_offset=c.fine_search_angle_offset,
                distance_variance_penalty=c.distance_variance_penalty,
                angle_variance_penalty=c.angle_variance_penalty,
                minimum_distance_penalty=c.minimum_distance_penalty,
                minimum_angle_penalty=c.minimum_angle_penalty,
            ),
            use_response_expansion=False, device=device,
        )

    levels = [(0, matcher(c.correlation_search_space_dimension,
                          c.correlation_search_space_resolution,
                          c.correlation_search_space_smear_deviation),
               ocfg.anchor_span, ocfg.anchor_gap, ocfg.anchor_step)]
    if (ocfg.use_anchor_long
            and T > ocfg.anchor_long_span + ocfg.anchor_long_step):
        levels.insert(0, (1, matcher(ocfg.anchor_long_search,
                                     ocfg.anchor_long_resolution,
                                     ocfg.anchor_long_smear),
                          ocfg.anchor_long_span, ocfg.anchor_long_step,
                          ocfg.anchor_long_step))
    return levels


def anchor_group(lane_ts, span: int, gap: int, n_scans: int, lanes: int,
                 poses: np.ndarray):
    """One group of ``lanes`` anchor lanes: anchor t matched against
    ``n_scans`` base scans spread over [t − span, t − gap] (repeats
    dropped, the rest padded with −1), each scan at its current pose, from
    t's current pose; lanes past ``lane_ts`` are padded. Returns
    (chain_idx, base_poses, query_idx, query_poses) as
    ``match_anchors_store_async`` takes them."""
    ci = np.full((lanes, n_scans), -1.0, np.float32)
    bp = np.zeros((lanes, n_scans, 3), np.float32)
    qi = np.zeros(lanes, np.float32)
    qp = np.zeros((lanes, 3), np.float32)
    for lane, t in enumerate(lane_ts):
        base = np.unique(np.linspace(t - span, t - gap, n_scans)
                         .round().astype(np.int64))
        ci[lane, :len(base)] = base
        bp[lane, :len(base)] = poses[base]
        qi[lane] = t
        qp[lane] = poses[t]
    return ci, bp, qi, qp


def undistort_mission(
    scans: Scan,
    imu_stamps,
    imu_omega,
    odom_stamps,
    odom_poses,
    use_imu: bool = True,
    use_odom: bool = True,
) -> np.ndarray:
    """Motion-distortion correction of a whole mission in one batched call
    of ``ops/undistort.undistort_scan`` on the scans' device, for
    ``offline_slam(corrected_pts=...)``. Returns (T, N, 2) float32 points
    with invalid beams and non-finite points zeroed."""
    def up(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=scans.device)

    pts = undistort_scan(
        scans, up(imu_stamps), up(imu_omega), up(odom_stamps),
        up(odom_poses), use_imu=use_imu, use_odom=use_odom,
    ).cpu().numpy()
    pts = np.where(scans.valid.cpu().numpy()[..., None], pts,
                   0.0).astype(np.float32)
    pts[~np.isfinite(pts)] = 0.0
    return pts


def _select_seeds_host(packed, C: int, S: int, rel_pred, n_valid, ocfg,
                       err_gate: float):
    """The loop selector's gates on the host in float64, on the (C·S, 14)
    packed rows of C candidates × S seeds (the reference's mesh branch,
    ``tpu_slam/models/offline.py:567-600``): a seed is eligible when its
    inlier fraction clears ``min_inlier_frac`` and its pose stays in the
    seeded basin; the best eligible seed must clear ``err_gate``. Returns
    (pose, error, covariance, inlier fraction, accept) of each
    candidate's best seed."""
    err = packed[:, 3].reshape(C, S)
    pose = packed[:, :3].reshape(C, S, 3)
    cov = packed[:, 5:14].reshape(C, S, 3, 3)
    frac = packed[:, 4].reshape(C, S) / np.maximum(
        np.asarray(n_valid, np.float64)[:, None], 1.0)
    dev = pose - np.asarray(rel_pred, np.float64)[:, None, :]
    dev_th = np.arctan2(np.sin(dev[..., 2]), np.cos(dev[..., 2]))
    in_basin = ((np.linalg.norm(dev[..., :2], axis=-1) <= ocfg.seed_xy)
                & (np.abs(dev_th) <= ocfg.seed_theta))
    err = np.where((frac >= ocfg.min_inlier_frac) & in_basin, err, np.inf)
    best = np.argmin(err, axis=1)
    rows = np.arange(C)
    b_err = err[rows, best]
    return (pose[rows, best], b_err, cov[rows, best], frac[rows, best],
            np.isfinite(b_err) & (b_err <= err_gate))


def offline_slam(
    scans: Scan,
    cfg: SLAMConfig,
    odom: np.ndarray | None = None,
    mesh=None,
    timer=None,
    corrected_pts: np.ndarray | None = None,
) -> OfflineResult:
    """Run the offline pipeline on the device of ``scans``' tensors.

    corrected_pts: optional (T, N, 2) laser-frame points to match instead
    of the scans' polar→Cartesian conversion, e.g. ``undistort_mission``'s
    output. With a ``mesh``, the edge-sharded and batch-sharded form on
    the mesh's device."""
    timer = timer if timer is not None else StageTimer()
    ocfg = cfg.offline
    dev = scans.device if mesh is None else mesh.device
    with timer.stage("prepare"):
        ranges = scans.ranges.cpu().numpy()
        valid = scans.valid.cpu().numpy()
        angles = scans.angles.cpu().numpy()
        T = ranges.shape[0]
        if T < 2:
            raise ValueError("offline_slam needs at least two scans")
        # the laser-frame points: the anchor sweep's store, and the match
        # store of a mission whose beam directions vary
        pts = laser_points(ranges, valid, angles, corrected_pts)

        # mission scan store, uploaded ONCE; every match stage addresses it
        # by row index. A fixed-mount laser shares one beam-direction row, so
        # the store holds ranges plus an (N, 2) direction table; a corrected
        # mission has per-beam directions, so its store holds points.
        Ts = _bucket(T, lo=16)
        storev = np.zeros((Ts,) + valid.shape[1:], bool)
        storev[:T] = valid
        shared_dirs = corrected_pts is None and (
            angles.ndim == 1 or bool(np.all(angles == angles[:1])))
        if shared_dirs:
            a0 = angles if angles.ndim == 1 else angles[0]
            store = np.zeros((Ts,) + valid.shape[1:], np.float32)
            store[:T] = np.where(valid & np.isfinite(ranges), ranges, 0.0)
            dirs = np.stack([np.cos(a0), np.sin(a0)], axis=-1).astype(
                np.float32)
        else:
            store = np.zeros((Ts,) + pts.shape[1:], np.float32)
            store[:T] = pts
            dirs = np.zeros((1, 2), np.float32)  # unused for a points store
        d_store = torch.as_tensor(store, device=dev)
        d_storev = torch.as_tensor(storev, device=dev)
        d_dirs = torch.as_tensor(dirs, device=dev)

        def up(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        pmatch = make_packed_indexed_matcher(cfg, mesh)
        D = 1 if mesh is None else mesh.size

        def pmatch_np(src_idx, tgt_idx, guesses):
            """The packed indexed match of (B,) index batches padded to
            their bucket, a multiple of the mesh's ranks (pads match scan 0
            against itself and are dropped): the (B, 14) packed result on
            the host, in one read."""
            B = len(src_idx)
            Bp = -(-_bucket(B) // D) * D
            si = np.zeros(Bp, np.int64)
            ti = np.zeros(Bp, np.int64)
            g = np.zeros((Bp, 3), np.float32)
            si[:B] = src_idx
            ti[:B] = tgt_idx
            g[:B] = guesses
            out = pmatch(d_store, d_storev, d_dirs, up(si, torch.int64),
                         up(ti, torch.int64), up(g, torch.float32))
            return out.double().cpu().numpy()[:B]

        # 1. consecutive odometry chain + integration, one batched call ---
        if odom is not None:
            odom = np.asarray(odom, np.float64)
            guesses = gnp.compose(gnp.inverse(odom[:-1]), odom[1:]).astype(
                np.float32
            )
        else:
            guesses = np.zeros((T - 1, 3), np.float32)
        floor = np.diag([ocfg.cov_floor_xy**2, ocfg.cov_floor_xy**2,
                         ocfg.cov_floor_theta**2])
        Bc = T - 1
        pose0 = (np.zeros(3) if odom is None
                 else np.asarray(odom[0], np.float64))
        if mesh is None:
            cmatch = make_chain_matcher(cfg)
            Bp = _bucket(Bc)
            si = np.zeros(Bp, np.int64)
            ti = np.zeros(Bp, np.int64)
            g = np.zeros((Bp, 3), np.float32)
            si[:Bc] = np.arange(1, T)
            ti[:Bc] = np.arange(0, T - 1)
            g[:Bc] = guesses
    if mesh is None:
        with timer.stage("chain_match"):
            out = cmatch(
                d_store, d_storev, d_dirs, up(si, torch.int64),
                up(ti, torch.int64), up(g, torch.float32),
                up(pose0, torch.float32),
            ).double().cpu().numpy()
            packed = out[:Bc]
            chain_poses = out[Bp:Bp + T, :3]
    else:
        with timer.stage("chain_match"):
            packed = pmatch_np(np.arange(1, T), np.arange(0, T - 1), guesses)
        with timer.stage("integrate"):  # on the host
            chain_poses = geo.compose_chain(
                torch.as_tensor(pose0, dtype=torch.float32),
                torch.as_tensor(packed[:, :3], dtype=torch.float32),
            ).double().numpy()
    with timer.stage("prepare"):
        chain_rels = packed[:, :3]
        chain_covs_raw = packed[:, 5:14].reshape(Bc, 3, 3)
        chain_covs = chain_covs_raw + floor
        chain_errs = packed[:, 3]
        # per-step drift variance for the PCM allowance: the RAW GN
        # covariance
        chain_step_var = float(np.median(
            np.linalg.eigvalsh(chain_covs_raw[:, :2, :2]).max(axis=-1)))
        # the mission's own noise floor calibrates the loop alias gate
        err_gate = min(
            ocfg.max_mean_error,
            ocfg.alias_error_mult
            * float(np.median(chain_errs[np.isfinite(chain_errs)])),
        )

        # 2. multi-stride skip edges: t against t + s, one batched call over
        # all strides, guesses from the integrated chain. The route length
        # engages both drift-control stages (skip edges and anchors).
        route_len = float(np.sum(np.hypot(chain_rels[:, 0],
                                          chain_rels[:, 1])))
        drift_control = route_len >= ocfg.drift_control_min_route
        skip_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        skip_pairs = []
        for s in ocfg.skip_strides if drift_control else ():
            if 1 < s < T:
                ii = np.arange(0, T - s, s, dtype=np.int64)
                skip_pairs.append(np.stack([ii, ii + s], axis=-1))
        if skip_pairs:
            sp = np.concatenate(skip_pairs)
            si, sj = sp[:, 0], sp[:, 1]
            sguess = gnp.relative(chain_poses[si], chain_poses[sj]).astype(
                np.float32)
        # the loop search's seeds and selector; the anchor sweep's matchers
        # and stores
        seeds = _seed_lattice(ocfg)
        S = seeds.shape[0]
        if mesh is None:
            lsel = make_loop_selector(cfg, S)
            gates = up([ocfg.min_inlier_frac, ocfg.seed_xy, ocfg.seed_theta,
                        err_gate], torch.float32)
        anchor_on = (ocfg.use_anchor and drift_control
                     and T >= ocfg.anchor_min_scans
                     and T > ocfg.anchor_span + ocfg.anchor_step)
        if anchor_on:
            levels = anchor_levels(cfg, T, dev)
            # the laser-frame points upload once; anchor groups address
            # them by row index
            store_pts = torch.as_tensor(pts, device=dev)
            store_valid = torch.as_tensor(valid, device=dev)
    if skip_pairs:
        with timer.stage("skip_match"):
            spk = pmatch_np(sj, si, sguess)
        with timer.stage("prepare"):  # the skip edges' gates
            srels = spk[:, :3]
            scovs = spk[:, 5:14].reshape(-1, 3, 3) + floor
            serrs = spk[:, 3]
            sfrac = spk[:, 4] / np.maximum(
                valid[sj].sum(axis=-1).astype(np.float64), 1.0)
            sdev = srels - sguess.astype(np.float64)
            sdev_th = np.arctan2(np.sin(sdev[:, 2]), np.cos(sdev[:, 2]))
            s_ok = (
                (sfrac >= ocfg.min_inlier_frac)
                & np.isfinite(serrs)
                & (serrs <= err_gate)
                & (np.linalg.norm(sdev[:, :2], axis=-1) <= ocfg.skip_dev_xy)
                & (np.abs(sdev_th) <= ocfg.skip_dev_theta)
            )
            for k in np.nonzero(s_ok)[0]:
                skip_edges.append((int(si[k]), int(sj[k]), srels[k],
                                   scovs[k]))

    anchor_edges: dict[tuple[int, int],
                       tuple[int, int, np.ndarray, np.ndarray]] = {}

    def _build_solver(loop_edges: list[LoopEdge], init_poses: np.ndarray):
        # nodes start from the current estimate (warm start); the edges
        # past the chain go in the reference's order, skip, anchor, loop,
        # which is the float32 sum order of the solve
        loop_edges = _thin_loops(loop_edges, ocfg)
        s = PoseGraphSolver(cfg.solver, device=dev, mesh=mesh)
        s.add_nodes(range(T), init_poses)
        s.add_constraints(
            np.arange(T - 1), np.arange(1, T), chain_rels,
            covariances=chain_covs,
        )
        extra = list(skip_edges) + list(anchor_edges.values()) + [
            (e.i, e.j, e.mean, e.covariance) for e in loop_edges
        ]
        if extra:
            s.add_constraints(
                [t[0] for t in extra], [t[1] for t in extra],
                np.asarray([t[2] for t in extra]),
                covariances=np.asarray([t[3] for t in extra]),
            )
        return s

    def _solve():
        nonlocal poses, solver
        with timer.stage("solve"):
            with timer.stage("graph_build"):
                solver = _build_solver(loops, poses)
            solver.compute()
            poses = solver.get_poses()

    poses = chain_poses
    with timer.stage("graph_build"):
        solver = _build_solver([], chain_poses)
    candidates_all: list[LoopEdge] = []  # gate-passing edges (pre-PCM)
    loops: list[LoopEdge] = []  # the consistent set fed to the solver
    tried: set[tuple[int, int]] = set()

    def _loop_rounds():
        # 3.-6. detect → match → PCM → solve, ``rounds`` times; again after
        # each anchor sweep, since candidates are gathered around the
        # current estimates
        for rnd in range(ocfg.rounds):
            if not _loop_round(rnd):
                break

    def _loop_round(rnd: int) -> bool:
        nonlocal loops
        with timer.stage("candidates"):
            cands = _loop_candidates(up(poses, torch.float32), ocfg, tried)
        tried.update(cands)
        if not cands:
            return False
        C = len(cands)
        ci = np.fromiter((c[0] for c in cands), np.int64, C)
        cj = np.fromiter((c[1] for c in cands), np.int64, C)
        rel_pred = gnp.compose(gnp.inverse(poses[ci]), poses[cj]).astype(
            np.float32
        )
        # multi-start match + best-seed selection + gates, one call over
        # the (C·S) batch gathered from the store by row index
        with timer.stage("loop_match"):
            if mesh is not None:
                b_pose, b_err, b_cov, b_frac, accept = _select_seeds_host(
                    pmatch_np(np.repeat(cj, S), np.repeat(ci, S),
                              (rel_pred[:, None, :] + seeds[None, :, :])
                              .reshape(C * S, 3)),
                    C, S, rel_pred, valid[cj].sum(axis=-1), ocfg, err_gate)
            else:
                Cp = _bucket(C, lo=16)
                cip = np.zeros(Cp, np.int64)
                cjp = np.zeros(Cp, np.int64)
                cip[:C] = ci
                cjp[:C] = cj
                gp = np.zeros((Cp, S, 3), np.float32)
                gp[:C] = rel_pred[:, None, :] + seeds[None, :, :]
                rp = np.zeros((Cp, 3), np.float32)
                rp[:C] = rel_pred
                sel = lsel(
                    d_store, d_storev, d_dirs,
                    up(np.repeat(cjp, S), torch.int64),
                    up(np.repeat(cip, S), torch.int64),
                    up(gp.reshape(Cp * S, 3), torch.float32),
                    up(rp, torch.float32), gates,
                ).double().cpu().numpy()[:C]
                b_pose, b_err = sel[:, :3], sel[:, 3]
                b_cov, b_frac = sel[:, 5:14].reshape(C, 3, 3), sel[:, 14]
                accept = sel[:, 15] > 0.5
        for k in np.nonzero(accept)[0]:
            candidates_all.append(
                LoopEdge(
                    i=int(ci[k]), j=int(cj[k]),
                    mean=b_pose[k],
                    covariance=b_cov[k] + floor,
                    error=float(b_err[k]),
                    inlier_frac=float(b_frac[k]),
                    round=rnd,
                )
            )
        if not accept.any():
            return False
        # pairwise-consistency selection over ALL edges so far
        if ocfg.use_pcm:
            with timer.stage("pcm"):
                keep = consistent_loop_set(
                    candidates_all, chain_poses, chain_step_var, ocfg
                )
            loops = [e for e, k in zip(candidates_all, keep) if k]
        else:
            loops = list(candidates_all)
        if not loops:
            return False
        _solve()
        return True

    # 7. the correlative anchor sweep: each anchor scan re-matched against a
    # submap of its recent past at the current estimates; an accepted match
    # becomes an edge against the FAR end of the submap
    anchors_tried = 0

    def _anchor_sweep() -> bool:
        nonlocal anchors_tried
        Sa = ocfg.anchor_scans
        C = ocfg.anchor_lanes
        any_edges = False
        for level, matcher, span, gap, step in levels:
            anchors = np.arange(span, T, step)
            anchors_tried += len(anchors)
            with timer.stage("anchor_match"):
                outs = []
                for g0 in range(0, len(anchors), C):
                    lane_ts = anchors[g0:g0 + C]
                    outs.append((lane_ts, matcher.match_anchors_store_async(
                        store_pts, store_valid,
                        *anchor_group(lane_ts, span, gap, Sa, C, poses))))
                # every group is queued: one read-back pass
                for lane_ts, out in outs:
                    o = to_host(out)
                    for lane, t in enumerate(lane_ts):
                        if o[lane, 3] < ocfg.anchor_min_response:
                            continue
                        # the far end of the submap: the match pins t
                        # against the whole span
                        ref = int(t - span)
                        mean = gnp.relative(poses[ref],
                                            o[lane, :3].astype(np.float64))
                        cov = (o[lane, 4:13].reshape(3, 3).astype(np.float64)
                               + floor)
                        key = (level, int(t))
                        prev = anchor_edges.get(key)
                        # only a new or changed edge counts as found
                        if prev is None or not (
                                np.array_equal(prev[2], mean)
                                and np.array_equal(prev[3], cov)):
                            any_edges = True
                        anchor_edges[key] = (ref, int(t), mean, cov)
            if anchor_edges:
                # a solve between levels: the long sweep's correction
                # re-centres the short sweep's windows
                _solve()
        return any_edges

    # macro schedule: loops are gathered around the current poses and
    # anchors need decent poses to centre their windows, so the two
    # alternate until a pass finds nothing new (at most macro_rounds)
    _loop_rounds()
    n_anchors_used = 0
    if anchor_on:
        for _macro in range(ocfg.macro_rounds):
            found_anchor = False
            for _ in range(ocfg.anchor_rounds):
                if not _anchor_sweep():
                    break
                found_anchor = True
            n_loops = len(loops)
            _loop_rounds()  # re-detect from anchor-corrected poses
            if not found_anchor and len(loops) == n_loops:
                break
        n_anchors_used = len(anchor_edges)
        # anchors are a bootstrap scaffold: once enough loops carry the
        # global structure, the final solve drops them
        if anchor_edges and len(loops) >= ocfg.anchor_drop_min_loops:
            anchor_edges.clear()
            _solve()

    return OfflineResult(
        poses=poses,
        chain_poses=chain_poses,
        chain_rels=chain_rels,
        loops=loops,
        solver=solver,
        candidates_tried=len(tried),
        timer=timer,
        anchors_accepted=max(n_anchors_used, len(anchor_edges)),
        anchors_tried=anchors_tried,
        skip_edges=len(skip_edges),
    )
