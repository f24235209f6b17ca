"""The reference's account of an offline mission, and the judge of the
program's.

From the same ranges and odometry it works out again:
  * the chain: every scan t + 1 matched into scan t by PL-ICP from the
    odometry's relative pose (``plicp``);
  * for each loop edge the program accepted (i, j): where PL-ICP of scan j
    into scan i settles when started from the program's edge, and its
    trimmed error there. Which pairs close, and from which of the seeds,
    is the program's state: the reference follows it there, and judges
    each edge by its own error against the error where PL-ICP settles
    (in a corridor PL-ICP slides along the wall's direction at equal
    error, so a distance between the two would judge the corridor);
  * the optimum of the graph the solve sees: the reference's chain and
    the program's loop edges (thinned to ``max_solver_loops`` as the
    configuration states), every edge weighted by the covariance of the
    reference's own PL-ICP (where it settles) plus the configuration's
    floor, solved by ``lm.solve`` in float64 from the reference's
    integrated chain. Which pairs close follows the program; the loop
    means, the loop edges' errors and the loop recall check that choice
    by themselves;
  * which places the mission revisits, from the generator's true poses:
    every later scan j within ``loop_radius`` of a scan at least
    ``loop_min_gap`` before it, in windows of ``loop_nms_gap`` scans.

The numbers compared (each the worst over the mission):
  * ``chain_gap``: max |Δ| of a chain edge (m or rad) from the reference's;
  * ``loop_err_excess``: max over the loop edges of the trimmed error
    (m) at the edge minus that where PL-ICP settles from it;
  * ``pose_gap_m``: max distance of a final pose from the reference optimum;
  * ``ate_m``: the final poses' ATE against the generator's true poses;
  * ``loop_miss``: the share of the revisited windows in which the program
    accepted no loop edge (i, j) whose true poses lie within
    ``loop_radius``: 1 where it closes no loop.

The control (``control=True``) is the same account in bfloat16 put in the
program's place: its chain, its settled loop edges and its own graph's
optimum, with each LM step rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import geometry as g
from slam_bench.reference import lm
from slam_bench.reference.plicp import plicp, trimmed_error


def scan_points(mission, scan_cfg: dict):
    """(T, N, 2) float32 laser-frame points and (T, N) validity, as the
    configuration's laser model reads the ranges."""
    r = mission.ranges
    n = r.shape[1]
    ang = (np.float32(mission.angle_min)
           + np.float32(mission.angle_increment) * np.arange(n, dtype=np.float32))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    valid = np.isfinite(r) & (r > scan_cfg["range_min"]) & (r < scan_cfg["range_max"])
    pts = np.where(valid[..., None], r[..., None] * dirs, 0.0).astype(np.float32)
    return pts, valid


def thin_loops(loops: list, ocfg: dict) -> list:
    """The loop edges the solve sees: the best (highest inlier fraction) of
    each (i, j) cell of ``loop_nms_gap``, then evenly ``max_solver_loops``
    of them. ``loops`` holds dicts with i, j, frac."""
    cap = ocfg["max_solver_loops"]
    if len(loops) <= cap:
        return list(loops)
    gap = max(ocfg["loop_nms_gap"], 1)
    best = {}
    for e in loops:
        c = (e["i"] // gap, e["j"] // gap)
        if c not in best or e["frac"] > best[c]["frac"]:
            best[c] = e
    kept = sorted(best.values(), key=lambda e: (e["i"], e["j"]))
    if len(kept) > cap:
        idx = np.linspace(0, len(kept) - 1, cap).round().astype(int)
        kept = [kept[k] for k in sorted(set(idx.tolist()))]
    return kept


def _gap(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if d.size == 0:
        return 0.0
    d[..., 2] = np.abs(g.wrap(np.asarray(a)[..., 2] - np.asarray(b)[..., 2]))
    return float(d.max())


def _gather(P, V, idx, device):
    i = torch.as_tensor(np.asarray(idx, np.int64), device=device)
    return P[i], V[i]


def account(mission, loops: list, cfg: dict, device,
            control: bool = False) -> dict:
    """The reference's chain, settled loop edges and optimum for ``mission``
    and the program's loop edges ``loops`` (dicts with i, j, mean, cov,
    frac); with ``control``, the control's (see the module's text)."""
    dtype = torch.bfloat16 if control else torch.float32
    pts, valid = scan_points(mission, cfg["scan"])
    P = torch.as_tensor(pts, device=device)
    V = torch.as_tensor(valid, device=device)
    T = len(pts)
    guess = g.relative(mission.odom[:-1], mission.odom[1:]).astype(np.float32)
    chain = plicp(P[1:], V[1:], P[:-1], V[:-1],
                  torch.as_tensor(guess, device=device), cfg["plicp"], dtype)
    used = thin_loops(loops, cfg["offline"])
    o = cfg["offline"]
    floor = np.diag([o["cov_floor_xy"] ** 2, o["cov_floor_xy"] ** 2,
                     o["cov_floor_theta"] ** 2])
    settled = {"pose": np.zeros((0, 3)), "covariance": np.zeros((0, 3, 3)),
               "error": np.zeros(0)}
    if used:
        src = _gather(P, V, [e["j"] for e in used], device)
        tgt = _gather(P, V, [e["i"] for e in used], device)
        start = np.asarray([e["mean"] for e in used], np.float32)
        settled = plicp(*src, *tgt, torch.as_tensor(start, device=device),
                        cfg["plicp"], dtype)
        settled["error"] = trimmed_error(
            *src, *tgt, torch.as_tensor(settled["pose"], device=device),
            cfg["plicp"])
    if control:
        loop_means = settled["pose"]
    else:
        loop_means = np.asarray([e["mean"] for e in used]).reshape(-1, 3)
    loop_covs = settled["covariance"] + floor
    ei = np.concatenate([np.arange(T - 1), [e["i"] for e in used]]).astype(np.int64)
    ej = np.concatenate([np.arange(1, T), [e["j"] for e in used]]).astype(np.int64)
    means = np.concatenate([chain["pose"], loop_means])
    infos = np.linalg.inv(np.concatenate([chain["covariance"] + floor,
                                          loop_covs]))
    init = g.integrate(np.asarray(mission.odom[0], np.float64), chain["pose"])
    opt = lm.solve(init, ei, ej, means, infos,
                   lam0=cfg["solver"]["initial_lambda"],
                   rounding=lm.bf16 if control else None)
    return {"chain": chain, "loops": settled, "used": used,
            "graph": (ei, ej, means, infos), "poses": opt["poses"],
            "lm_iterations": opt["iterations"], "points": (P, V)}


def revisit_windows(truth, ocfg: dict) -> np.ndarray:
    """The windows (j // ``loop_nms_gap``) of the later scans j that lie
    within ``loop_radius`` of a true pose ``loop_min_gap`` or more scans
    before them."""
    xy = np.asarray(truth, np.float64)[:, :2]
    d = np.hypot(*(xy[:, None] - xy[None]).transpose(2, 0, 1))
    T = len(xy)
    before = np.arange(T)[None, :] <= np.arange(T)[:, None] - ocfg["loop_min_gap"]
    j = np.nonzero(((d <= ocfg["loop_radius"]) & before).any(1))[0]
    return np.unique(j // max(ocfg["loop_nms_gap"], 1))


def loop_miss(mission, loops: list, ocfg: dict) -> float:
    """The share of revisited windows without an accepted loop edge whose
    true poses lie within ``loop_radius``."""
    want = revisit_windows(mission.truth, ocfg)
    if not len(want):
        return 0.0
    t = np.asarray(mission.truth, np.float64)
    gap = max(ocfg["loop_nms_gap"], 1)
    got = {e["j"] // gap for e in loops
           if np.hypot(*(t[e["i"], :2] - t[e["j"], :2])) <= ocfg["loop_radius"]}
    return 1.0 - len(set(want.tolist()) & got) / len(want)


def judge(mission, out: dict, ref: dict, cfg: dict) -> dict:
    """The numbers compared, for the program's (or the control's) ``out``
    (chain_rels (T-1, 3), loops, poses (T, 3)) against ``ref``."""
    by_pair = {(e["i"], e["j"]): e["mean"] for e in out["loops"]}
    used = ref["used"]
    excess = 0.0
    if used:
        P, V = ref["points"]
        dev = P.device
        means = np.asarray([by_pair[(e["i"], e["j"])] for e in used], np.float32)
        err = trimmed_error(*_gather(P, V, [e["j"] for e in used], dev),
                            *_gather(P, V, [e["i"] for e in used], dev),
                            torch.as_tensor(means, device=dev), cfg["plicp"])
        excess = float((err - ref["loops"]["error"]).max())
    poses = np.asarray(out["poses"], np.float64)
    return {
        "chain_gap": _gap(out["chain_rels"], ref["chain"]["pose"]),
        "loop_err_excess": excess,
        "pose_gap_m": float(np.hypot(*(poses[:, :2] - ref["poses"][:, :2]).T).max()),
        "ate_m": g.ate_rmse(poses, mission.truth),
        "loop_miss": loop_miss(mission, out["loops"], cfg["offline"]),
    }
