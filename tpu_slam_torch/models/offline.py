"""Offline batch SLAM: the whole mission as a handful of batched device
calls — port of ``tpu_slam/models/offline.py::offline_slam``.

  1. every consecutive scan pair is matched in ONE batched PL-ICP call
     against a once-uploaded mission scan store (ranges + beam directions),
     with the pose integration in the same call (``make_chain_matcher``);
  2. loop candidates come from a pose-proximity sweep on the host;
  3. candidates are matched by multi-start batched PL-ICP, with best-seed
     selection and gating on the device (``make_loop_selector``);
  4. pairwise-consistent loops plus the chain feed the LM pose-graph solve;
  5. detection → match → solve repeats ``OfflineConfig.rounds`` times.

The device is the device of the scans' tensors. ``corrected_pts`` (for
instance ``undistort_mission``'s output) replaces the polar→Cartesian
conversion of the scans. Not ported yet, and raising
``NotImplementedError`` where they would fire: the drift-control stages of
routes ≥ ``drift_control_min_route`` (skip edges and correlative anchors)
and the ``mesh`` form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan
from tpu_slam_torch.ops.undistort import undistort_scan
from tpu_slam_torch.parallel.distributed_step import (
    make_chain_matcher, make_loop_selector,
)
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver
from tpu_slam_torch.utils.profiling import StageTimer


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
    anchors_accepted: int = 0
    anchors_tried: int = 0


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
    poses: np.ndarray, ocfg, tried: set
) -> list[tuple[int, int]]:
    """Pose-proximity candidate pairs (i < j), thinned by non-maximum
    suppression along both scan indices (the analogue of Karto's
    FindPossibleLoopClosure sweep, done once over the whole mission)."""
    T = poses.shape[0]
    # blockwise sweep bounds the T x T distance matrix's memory
    blk = 2048
    xy = poses[:, :2].astype(np.float32)
    n2 = np.sum(xy * xy, axis=1)
    r2 = np.float32(ocfg.loop_radius) ** 2
    ii_l, jj_l, dd_l = [], [], []
    for r0 in range(0, T, blk):
        r1 = min(r0 + blk, T)
        d2 = n2[:, None] + n2[None, r0:r1] - 2.0 * (xy @ xy[r0:r1].T)
        gap_ok = (
            np.arange(r0, r1)[None, :] - np.arange(T)[:, None]
            >= ocfg.loop_min_gap
        )
        i_b, j_b = np.nonzero((d2 <= r2) & gap_ok)
        ii_l.append(i_b)
        jj_l.append(j_b + r0)
        dd_l.append(d2[i_b, j_b])
    ii = np.concatenate(ii_l)
    jj = np.concatenate(jj_l)
    order = np.argsort(np.concatenate(dd_l))
    # only the closest pair of each (gap x gap) index cell can survive the
    # exact NMS below
    g = max(ocfg.loop_nms_gap, 1)
    cells = (ii // g).astype(np.int64) * (T // g + 2) + jj // g
    _, first = np.unique(cells[order], return_index=True)
    order = order[np.sort(first)]
    picked: list[tuple[int, int]] = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if (i, j) in tried:
            continue
        if any(
            abs(i - a) < ocfg.loop_nms_gap and abs(j - b) < ocfg.loop_nms_gap
            for a, b in picked
        ):
            continue
        picked.append((i, j))
        if len(picked) >= ocfg.max_candidates:
            break
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
    output."""
    if mesh is not None:
        raise NotImplementedError(
            "offline_slam over a mesh is not ported yet (ROADMAP queue 1, "
            "item 6: multi-device layer)"
        )
    timer = timer if timer is not None else StageTimer()
    ocfg = cfg.offline
    dev = scans.device
    ranges = scans.ranges.cpu().numpy()
    valid = scans.valid.cpu().numpy()
    angles = scans.angles.cpu().numpy()
    T = ranges.shape[0]
    if T < 2:
        raise ValueError("offline_slam needs at least two scans")

    # mission scan store, uploaded ONCE; every match stage addresses it by
    # row index. A fixed-mount laser shares one beam-direction row, so the
    # store holds ranges plus an (N, 2) direction table; a corrected
    # mission has per-beam directions, so its store holds points.
    Ts = _bucket(T, lo=16)
    storev = np.zeros((Ts,) + valid.shape[1:], bool)
    storev[:T] = valid
    if corrected_pts is not None:
        pts = np.where(valid[..., None], np.asarray(corrected_pts, np.float32),
                       0.0).astype(np.float32)
    elif angles.ndim == 1 or bool(np.all(angles == angles[:1])):
        pts = None
    else:
        pts = np.where(
            valid[..., None],
            np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1),
            0.0,
        ).astype(np.float32)
    if pts is None:
        a0 = angles if angles.ndim == 1 else angles[0]
        store = np.zeros((Ts,) + valid.shape[1:], np.float32)
        store[:T] = np.where(valid & np.isfinite(ranges), ranges, 0.0)
        dirs = np.stack([np.cos(a0), np.sin(a0)], axis=-1).astype(np.float32)
    else:
        pts[~np.isfinite(pts)] = 0.0
        store = np.zeros((Ts,) + pts.shape[1:], np.float32)
        store[:T] = pts
        dirs = np.zeros((1, 2), np.float32)  # unused for a points store
    d_store = torch.as_tensor(store, device=dev)
    d_storev = torch.as_tensor(storev, device=dev)
    d_dirs = torch.as_tensor(dirs, device=dev)

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # 1. consecutive odometry chain + integration, one batched call -------
    if odom is not None:
        odom = np.asarray(odom, np.float64)
        guesses = gnp.compose(gnp.inverse(odom[:-1]), odom[1:]).astype(
            np.float32
        )
    else:
        guesses = np.zeros((T - 1, 3), np.float32)
    floor = np.diag(
        [ocfg.cov_floor_xy**2, ocfg.cov_floor_xy**2, ocfg.cov_floor_theta**2]
    )
    Bc = T - 1
    pose0 = np.zeros(3) if odom is None else np.asarray(odom[0], np.float64)
    cmatch = make_chain_matcher(cfg)
    Bp = _bucket(Bc)
    si = np.zeros(Bp, np.int64)
    ti = np.zeros(Bp, np.int64)
    g = np.zeros((Bp, 3), np.float32)
    si[:Bc] = np.arange(1, T)
    ti[:Bc] = np.arange(0, T - 1)
    g[:Bc] = guesses
    with timer.stage("chain_match"):
        out = cmatch(
            d_store, d_storev, d_dirs, up(si, torch.int64),
            up(ti, torch.int64), up(g, torch.float32),
            up(pose0, torch.float32),
        ).double().cpu().numpy()
        packed = out[:Bc]
        chain_poses = out[Bp:Bp + T, :3]
    chain_rels = packed[:, :3]
    chain_covs_raw = packed[:, 5:14].reshape(Bc, 3, 3)
    chain_covs = chain_covs_raw + floor
    chain_errs = packed[:, 3]
    # per-step drift variance for the PCM allowance: the RAW GN covariance
    chain_step_var = float(
        np.median(np.linalg.eigvalsh(chain_covs_raw[:, :2, :2]).max(axis=-1))
    )
    # the mission's own noise floor calibrates the loop alias gate
    err_gate = min(
        ocfg.max_mean_error,
        ocfg.alias_error_mult
        * float(np.median(chain_errs[np.isfinite(chain_errs)])),
    )

    # the drift-control stages engage on routes ≥ drift_control_min_route
    route_len = float(np.sum(np.hypot(chain_rels[:, 0], chain_rels[:, 1])))
    if route_len >= ocfg.drift_control_min_route:
        skip_on = any(1 < s < T for s in ocfg.skip_strides)
        anchor_on = (ocfg.use_anchor and T >= ocfg.anchor_min_scans
                     and T > ocfg.anchor_span + ocfg.anchor_step)
        if skip_on or anchor_on:
            raise NotImplementedError(
                f"route of {route_len:.1f} m engages the drift-control "
                "stages (skip edges, correlative anchors), which are not "
                "ported yet (ROADMAP queue 1, item 2)"
            )

    def _build_solver(loop_edges: list[LoopEdge], init_poses: np.ndarray):
        # nodes start from the current estimate (warm start)
        loop_edges = _thin_loops(loop_edges, ocfg)
        s = PoseGraphSolver(cfg.solver, device=dev)
        s.add_nodes(range(T), init_poses)
        s.add_constraints(
            np.arange(T - 1), np.arange(1, T), chain_rels,
            covariances=chain_covs,
        )
        if loop_edges:
            s.add_constraints(
                [e.i for e in loop_edges], [e.j for e in loop_edges],
                np.asarray([e.mean for e in loop_edges]),
                covariances=np.asarray([e.covariance for e in loop_edges]),
            )
        return s

    seeds = _seed_lattice(ocfg)
    S = seeds.shape[0]
    lsel = make_loop_selector(cfg, S)
    gates = up([ocfg.min_inlier_frac, ocfg.seed_xy, ocfg.seed_theta,
                err_gate], torch.float32)
    poses = chain_poses
    solver = _build_solver([], chain_poses)
    candidates_all: list[LoopEdge] = []  # gate-passing edges (pre-PCM)
    loops: list[LoopEdge] = []  # the consistent set fed to the solver
    tried: set[tuple[int, int]] = set()

    for rnd in range(ocfg.rounds):
        # candidates from the current pose estimates
        with timer.stage("candidates"):
            cands = _loop_candidates(poses, ocfg, tried)
        tried.update(cands)
        if not cands:
            break
        C = len(cands)
        ci = np.fromiter((c[0] for c in cands), np.int64, C)
        cj = np.fromiter((c[1] for c in cands), np.int64, C)
        rel_pred = gnp.compose(gnp.inverse(poses[ci]), poses[cj]).astype(
            np.float32
        )
        # multi-start match + best-seed selection + gates, one call over
        # the (C·S) batch gathered from the store by row index
        with timer.stage("loop_match"):
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
                d_store, d_storev, d_dirs, up(np.repeat(cjp, S), torch.int64),
                up(np.repeat(cip, S), torch.int64),
                up(gp.reshape(Cp * S, 3), torch.float32),
                up(rp, torch.float32), gates,
            ).double().cpu().numpy()[:C]
        accept = sel[:, 15] > 0.5
        for k in np.nonzero(accept)[0]:
            candidates_all.append(
                LoopEdge(
                    i=int(ci[k]), j=int(cj[k]),
                    mean=sel[k, :3],
                    covariance=sel[k, 5:14].reshape(3, 3) + floor,
                    error=float(sel[k, 3]),
                    inlier_frac=float(sel[k, 14]),
                    round=rnd,
                )
            )
        if not accept.any():
            break

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
            break

        # global solve
        with timer.stage("solve"):
            solver = _build_solver(loops, poses)
            solver.compute()
            poses = solver.get_poses()

    return OfflineResult(
        poses=poses,
        chain_poses=chain_poses,
        chain_rels=chain_rels,
        loops=loops,
        solver=solver,
        candidates_tried=len(tried),
        timer=timer,
    )
