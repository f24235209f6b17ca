"""Quickest proof that the PyTorch/CUDA port (``tpu_slam_torch``) runs on
the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; imports no JAX
and nothing of the JAX package. Phases, each printing its own line(s):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the four kernels from ``tpu_slam_torch/csrc``, one nvcc per
     source, all started together;
  3. the PL-ICP kernel against its plain version on 512 scan pairs of 360
     beams (the bench PL-ICP batch), with both times;
  4. the CR-LM kernel against its plain version on the 1,024-node bench
     pose graph, with both times, then all three kernels against their
     plain versions on edge cases (odd beam counts, N ≠ M, invalid and
     non-finite beams, W = 2 and 6, K = 32 and 128, a 3-node graph);
  5. the main path, with the launch counters zeroed first: the offline
     Karto mission (3 laps of the corridor world, 360 beams) through
     ``offline_slam``, then the bench pose graph through
     ``PoseGraphSolver.compute``. Every match must run the PL-ICP kernel
     and every solve an LM kernel (the mission's loop-closed graphs do not
     band, so they take the PCG-LM; the bench graph takes the CR-LM), and
     the mission ATE must stay ≤ 5 mm. The run records the mission's chain
     batch and its first loop-selector batch;
  6. the PL-ICP kernel against its plain version on those two batches:
     chain poses and trajectory within tolerance, the same accept flags
     and selected rows from the loop selector, with both times;
  7. the PCG-LM kernel against its plain version on the mission's
     loop-closed graph, with both times;
  8. the mission's scans/s (median of 3 runs after the warm one);
  9. one mission under ``torch.profiler``: device busy time, idle share
     and each kernel's device time per launch;
 10. the Hector kernel against its plain version at full width
     (``default_config()``: 1,024² grid, 3 levels, 360 beams) on
     bench_hector's map and scan, with both times, then on edge cases
     (100 beams, no valid beam, a pose by the map's edge, 1 and 4 levels);
 11. the Hector main path, with the launch counters zeroed first:
     ``HectorSLAM.run`` over the 150 scans of examples/run_hector_slam.py
     at the full grid. Every matched scan must launch the Hector kernel
     once and the ATE must stay ≤ 0.06 m; then its scans/s (median of 3
     runs after the warm one) and one run under ``torch.profiler``;
 12. one JSON line with every kernel (its launches, error against its
     plain version, both times, and its bound: the larger of bytes over
     3.35 TB/s and FLOPs over 67 TFLOP/s), then ``{"ok": true, ...}``
     last.
Any failing phase raises: the script then exits non-zero and never prints
the ok line. Without a CUDA device it raises at phase 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch import geometry as geo
from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import SolverConfig, default_config
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import index_scan, make_scan
from tpu_slam_torch.models import offline
from tpu_slam_torch.models.hector_slam import HectorSLAM, _beams
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops import hector as hec
from tpu_slam_torch.ops.cuda.hector_fused import hector_match_fused
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.plicp import plicp_match
from tpu_slam_torch.parallel.distributed_step import (
    _chain_matcher, _gather_scan, _loop_selector, make_chain_matcher,
    make_loop_selector,
)
from tpu_slam_torch.solver import banded
from tpu_slam_torch.solver.cr_lm import cr_lm_plain, fused_cr_lm
from tpu_slam_torch.solver.pcg_lm import fused_lm_solve, pcg_lm_plain
from tpu_slam_torch.solver.pose_graph import _sq_min_delta
from tpu_slam_torch.utils.evaluation import ate_rmse
from tpu_slam_torch.utils.profiling import StageTimer

PLICP_POSE_TOL = 1e-4  # m / rad; the two split distance ties differently
PLICP_INLIER_EQ_FRAC = 0.99  # the rest may differ by ±1 inlier
SPLIT_TOL = 1e-6  # a pair whose two poses differ by more has split
# the integrated chain of ~1,000 steps: each step's heading difference
# moves every later pose by itself times the lever (up to ~20 m here), so
# the per-pair 1e-4 grows; 1e-3 m is the slice's pose bound (tests)
CHAIN_TRAJ_TOL = 1e-3
LM_POSE_TOL = 1e-3  # both LM kernels against their plain versions
LM_COST_RTOL = 1e-3
MISSION_ATE_MAX = 0.005  # m; the reference recorded 0.0019 m
# the Hector kernel against its plain version: test_hector.py's bounds
# for the reference's own fused and XLA paths (sum orders differ)
HECTOR_POSE_TOL = 2e-4
HECTOR_H_RTOL, HECTOR_H_ATOL = 1e-3, 1e-2
HECTOR_ATE_MAX = 0.06  # m, map frame, test_hector.py's bound
HECTOR_SCANS = 150  # examples/run_hector_slam.py
# the least time the card could take: published H100 SXM peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, flops: float) -> dict:
    """The larger of bytes over the memory rate and FLOPs over the f32
    rate, and which one sets it."""
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations",
            "library_ms": None}  # no single PyTorch call computes it


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in paths)})", flush=True)


def phase_plicp(dev) -> dict:
    """bench PL-ICP recipe: 512 consecutive pairs of an office circle."""
    cfg = default_config()
    B = 512
    traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    scans = make_scan(seq.ranges, cfg.scan, device=dev)
    pts = torch.where(scans.valid[..., None], scans.points(), 0.0)
    args = (pts[1:].contiguous(), scans.valid[1:].contiguous(),
            pts[:-1].contiguous(), scans.valid[:-1].contiguous())
    g = torch.zeros((B, 3), dtype=torch.float32, device=dev)

    def kern():
        return plicp_match_fused(*args, cfg.plicp, init_pose=g)

    def plain():
        return plicp_match(*args, cfg.plicp, init_pose=g)

    k, p = kern(), plain()
    torch.cuda.synchronize()
    dpose = float((k.pose - p.pose).abs().max())
    dinl = (k.num_inliers - p.num_inliers).abs()
    eq = float((dinl == 0).float().mean())
    ok = (torch.isfinite(k.pose).all() and dpose <= PLICP_POSE_TOL
          and eq >= PLICP_INLIER_EQ_FRAC and int(dinl.max()) <= 1)
    ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
    rounds = plicp_rounds(args, cfg.plicp, g)
    N = M = pts.shape[1]
    work = bound(B * (9 * N + 9 * M + 12) + B * (12 + 16 + 36),
                 int(rounds.sum()) * plicp_round_flops(N, M))
    print(f"plicp: B={B} N=360 pose max|d|={dpose:.3e} inliers equal "
          f"{eq:.4f} max|d|={int(dinl.max())} converged {int(k.converged.sum())}"
          f"/{int(p.converged.sum())} rounds {int(rounds.sum())} kernel "
          f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {work['bound_ms']:.5f} "
          f"ms ({work['bound_by']})", flush=True)
    if not ok:
        raise AssertionError("PL-ICP kernel disagrees with its plain version")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def plicp_rounds(args, pcfg, g) -> torch.Tensor:
    """Rounds each pair runs before it converges: the plain version stops
    no pair early, but after k rounds it reports which pairs converged
    within k, so the first such k is that pair's count."""
    rounds = torch.full((g.shape[0],), pcfg.max_iterations,
                        dtype=torch.int64, device=g.device)
    seen = torch.zeros_like(rounds, dtype=torch.bool)
    for k in range(1, pcfg.max_iterations + 1):
        conv = plicp_match(*args, dataclasses.replace(pcfg, max_iterations=k),
                           init_pose=g).converged
        rounds = torch.where(conv & ~seen, k, rounds)
        seen |= conv
    return rounds


def plicp_round_flops(N: int, M: int) -> float:
    """One PL-ICP round of one pair: 6 operations per source-target
    distance (two differences, two squares, a sum, a compare), the bitonic
    sort of the N residuals for the trimming quantiles (one compare per
    pair per stage), and ~120 per source beam for the second point, the
    residual and the sums of the two GN steps."""
    p2 = 1 << max(N - 1, 1).bit_length()
    lg = p2.bit_length() - 1
    return 6 * N * M + p2 // 2 * lg * (lg + 1) // 2 + 120 * N


def lm_edge_flops(E: int) -> float:
    """One LM iteration's work per edge, ~440 FLOPs: residual, Jacobians,
    the three 3×3 blocks and the gradient of JᵀΩJ, and the candidate's
    cost."""
    return 440.0 * E


def bench_graph(n: int = 1024):
    """bench_solver_ms's graph: a noisy 2-loop odometry chain with closures
    every 50 nodes; returns (poses, edges) with information matrices."""
    rng = np.random.default_rng(17)
    th = np.linspace(0, 4 * np.pi, n)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    rels = gnp.relative(gt[:-1], gt[1:])
    edges = [(i, i + 1, rels[i] + rng.normal(0, 0.005, 3)) for i in range(n - 1)]
    period = n // 2
    lrels = gnp.relative(gt[:-period], gt[period:])
    edges += [(i, i + period, lrels[i]) for i in range(0, n - period, 50)]
    init = [gt[0]]
    for i in range(n - 1):  # drifted odometry chain as the initial guess
        init.append(gnp.compose(init[-1], edges[i][2]))
    info = np.diag([1e4, 1e4, 4e4])
    return np.asarray(init), [(i, j, m, info) for i, j, m in edges]


def phase_cr(dev) -> dict:
    cfg = SolverConfig()
    poses, edges = bench_graph()
    spec, pT8, slots = solver_from_numpy(cfg, poses, edges, dev).direct_inputs()
    kw = dict(W=spec.W, K=spec.K, iters=cfg.max_iterations, sq_min_delta=1e-8)

    def kern():
        return fused_cr_lm(pT8, slots, cfg.initial_lambda, **kw)

    def plain():
        return cr_lm_plain(pT8, slots, cfg.initial_lambda, **kw)

    k, p = kern(), plain()
    torch.cuda.synchronize()
    dpose = float((k[0:3] - p[0:3]).abs().max())
    kc, pc = float(k[3, 1]), float(p[3, 1])
    ok = (bool(torch.isfinite(k).all()) and dpose <= LM_POSE_TOL
          and abs(kc - pc) <= LM_COST_RTOL * abs(pc))
    ms, plain_ms = cuda_ms(kern, 3), cuda_ms(plain, 2)
    # per LM iteration, per supernode of n = 3W: Cholesky n³/3,
    # D⁻¹[Bprevᵀ | B | r] ~4n³ and the two Schur updates ~4n³
    n = 3 * spec.W
    iters = int(k[3, 3])
    work = bound(4 * (2 * pT8.numel() + slots.numel()),
                 iters * (lm_edge_flops(len(edges))
                          + spec.K * (n ** 3 / 3 + 8 * n ** 3)))
    print(f"cr_lm: nodes={len(poses)} W={spec.W} K={spec.K} pose max|d|="
          f"{dpose:.3e} cost0 {float(k[3, 0]):.6g} cost kernel {kc:.6g} plain "
          f"{pc:.6g} iters kernel {iters} plain {int(p[3, 3])} kernel "
          f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {work['bound_ms']:.5f} "
          f"ms ({work['bound_by']})", flush=True)
    if not ok:
        raise AssertionError("CR-LM kernel disagrees with its plain version")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def _ring_edges(n, stride, rng):
    """A noisy ring with cross closures every ``stride`` nodes (0: none)."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    pairs = [(i, (i + 1) % n) for i in range(n)]
    pairs += [(i, (i + n // 2) % n) for i in range(0, n, stride)] if stride else []
    ei = np.array([a for a, _ in pairs])
    ej = np.array([b for _, b in pairs])
    means = gnp.relative(gt[ei], gt[ej]) + rng.normal(0, 0.01, (len(ei), 3))
    init = gt + rng.normal(0, 0.05, gt.shape) * (np.arange(n) > 0)[:, None]
    infos = np.broadcast_to(np.diag([50.0, 50.0, 100.0]), (len(ei), 3, 3))
    return init, ei, ej, means.astype(np.float32), infos.astype(np.float32)


def phase_edge_cases(dev) -> None:
    """Each kernel against its plain version off the main path's shapes."""
    rng = np.random.default_rng(23)
    cfg = default_config()
    # PL-ICP: N = 100 source and M = 130 target beams (neither a multiple
    # of 32), one all-invalid source, non-finite coordinates on invalid beams
    B, N, M = 6, 100, 130
    world = sim.office_world(seed=2)
    traj = sim.circle_trajectory(B + 1, radius=1.2, angular_rate=0.5)
    scs = [make_scan(sim.simulate_sequence(
        world, traj, dataclasses.replace(cfg.scan, num_beams=nb),
        noise_std=0.003, seed=nb).ranges, dataclasses.replace(
            cfg.scan, num_beams=nb), device=dev) for nb in (N, M)]
    src, sv = scs[0].points()[1:].contiguous(), scs[0].valid[1:].clone()
    tgt, tv = scs[1].points()[:-1].contiguous(), scs[1].valid[:-1].contiguous()
    sv[0] = False
    src[1][~sv[1]] = float("inf")
    g = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    k = plicp_match_fused(src, sv, tgt, tv, cfg.plicp, init_pose=g)
    p = plicp_match(src, sv, tgt, tv, cfg.plicp, init_pose=g)
    dpose = float((k.pose - p.pose).abs().max())
    dinl = int((k.num_inliers - p.num_inliers).abs().max())
    print(f"edge plicp: B={B} N={N} M={M} pose max|d|={dpose:.3e} inliers "
          f"max|d|={dinl} empty-pair pose {k.pose[0].tolist()}", flush=True)
    if not (dpose <= PLICP_POSE_TOL and dinl <= 1
            and bool(torch.isfinite(k.pose).all())
            and int(k.num_inliers[0]) == 0):
        raise AssertionError("PL-ICP kernel edge cases disagree")
    # CR-LM: a plain ring bands at W = 2 (K = 128), a ring with cross
    # closures at W = 6 (K = 32 with min_k = 32)
    for n, stride, min_k in ((200, 0, 128), (72, 8, 32)):
        init, ei, ej, means, infos = _ring_edges(n, stride, rng)
        spec = banded.prepare_banded(ei, ej, n, min_k=min_k)
        pT8 = torch.as_tensor(banded.flat_poses_np(spec, init), device=dev)
        slots = torch.as_tensor(banded.build_slots_np(spec, means, infos),
                                device=dev)
        kw = dict(W=spec.W, K=spec.K, iters=40, sq_min_delta=1e-8)
        k = fused_cr_lm(pT8, slots, 1e-4, **kw)
        p = cr_lm_plain(pT8, slots, 1e-4, **kw)
        dpose = float((k[0:3] - p[0:3]).abs().max())
        kc, pc = float(k[3, 1]), float(p[3, 1])
        print(f"edge cr_lm: nodes={n} W={spec.W} K={spec.K} pose max|d|="
              f"{dpose:.3e} cost kernel {kc:.6g} plain {pc:.6g}", flush=True)
        if not (dpose <= LM_POSE_TOL
                and abs(kc - pc) <= LM_COST_RTOL * abs(pc) + 1e-6):
            raise AssertionError("CR-LM kernel edge case disagrees")
    # PCG-LM: a 3-node graph (fewer nodes than the packed stats lanes)
    f32 = dict(dtype=torch.float32, device=dev)
    args = (torch.tensor([[0, 0, 0], [1.1, 0.1, 0.2], [1.9, 1.2, 1.4]], **f32),
            torch.tensor([0, 1, 0], device=dev),
            torch.tensor([1, 2, 2], device=dev),
            torch.tensor([[1, 0, 0], [0, 1, 1.5], [1, 1, 1.5]], **f32),
            torch.eye(3, **f32).expand(3, 3, 3).contiguous(),
            torch.ones(3, dtype=torch.bool, device=dev),
            torch.tensor([False, True, True], device=dev), 1e-4)
    kw = dict(iters=40, cg_iters=100, cg_tol=1e-10, sq_min_delta=1e-8)
    k = fused_lm_solve(*args, **kw)[5]
    p = pcg_lm_plain(*args, **kw)
    dpose = float((k[0:3, :3] - p[0:3, :3]).abs().max())
    print(f"edge pcg_lm: nodes=3 pose max|d|={dpose:.3e} stats kernel "
          f"{k[3, :4].tolist()} plain {p[3, :4].tolist()}", flush=True)
    if not (dpose <= LM_POSE_TOL and k.shape == p.shape == (8, 4)
            and abs(float(k[3, 1]) - float(p[3, 1])) <= 1e-5):
        raise AssertionError("PCG-LM kernel edge case disagrees")


def bench_mission(dev):
    """bench_karto's mission: 3 laps of the corridor loop, 360 beams."""
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=360, range_max=12.0, range_threshold=10.0
        ),
    )
    traj = np.concatenate(
        [sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)] * 3
    )
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    rng = np.random.default_rng(3)
    drift = np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], (len(traj), 3)), 0)
    odom = seq.gt_poses + drift
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    return cfg, scans, odom, seq.gt_poses


@contextlib.contextmanager
def recording_batches():
    """Record the arguments of the mission's first chain-match call and of
    its first loop-selector call, passing every call through unchanged."""
    rec = {}
    chain0, sel0 = offline.make_chain_matcher, offline.make_loop_selector

    def recorder(key, f):
        def g(*args):
            rec.setdefault(key, args)
            return f(*args)
        return g

    def chain(cfg):
        return recorder("chain", chain0(cfg))

    def sel(cfg, n_seeds):
        rec["seeds"] = n_seeds
        return recorder("loop", sel0(cfg, n_seeds))

    offline.make_chain_matcher, offline.make_loop_selector = chain, sel
    try:
        yield rec
    finally:
        offline.make_chain_matcher, offline.make_loop_selector = chain0, sel0


def rcm_bandwidth(solver) -> int:
    """Largest |position difference| of an edge's ends under RCM: the
    reference's CR route needs ≤ direct_max_bandwidth (8)."""
    ei, ej, _m, _i = solver._edge_arrays()
    perm = banded.rcm_order(ei, ej, solver.num_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return int(np.abs(inv[ei] - inv[ej]).max())


def phase_main_path(dev):
    """The counted run: the mission, then the bench graph's solve."""
    cfg, scans, odom, gt = bench_mission(dev)
    T = len(gt)
    timer = StageTimer()
    _dispatch.reset_launches()
    with recording_batches() as batches:
        res = offline_slam(scans, cfg, odom=odom, timer=timer)
    mission_solves = timer.counts["solve"]
    poses, edges = bench_graph()
    stats = solver_from_numpy(SolverConfig(), poses, edges, dev).compute()
    torch.cuda.synchronize()
    launches = dict(_dispatch.LAUNCHES)
    ate = float(ate_rmse(res.poses, gt))
    print(f"main path: mission scans={T} loops={len(res.loops)} (round 0: "
          f"{sum(e.round == 0 for e in res.loops)}) solves={mission_solves} "
          f"last graph edges={res.solver.num_edges} RCM bandwidth="
          f"{rcm_bandwidth(res.solver)} ATE {ate:.5f} m; bench graph solve "
          f"cost {stats.final_cost:.6g}; launches {launches}", flush=True)
    if res.poses.shape != (T, 3) or not np.all(np.isfinite(res.poses)):
        raise AssertionError("mission poses are not finite (T, 3)")
    if ate > MISSION_ATE_MAX:
        raise AssertionError(f"mission ATE {ate:.5f} m > {MISSION_ATE_MAX} m")
    if launches["plicp_fused"] == 0:
        raise AssertionError("the mission ran no PL-ICP kernel launch")
    if mission_solves == 0 or launches["pcg_lm"] != mission_solves:
        raise AssertionError("not every mission solve ran the PCG-LM kernel")
    if launches["cr_lm"] != 1 or not np.isfinite(stats.final_cost):
        raise AssertionError("the bench graph solve did not run the CR-LM "
                             "kernel")
    return cfg, scans, odom, res, launches, batches


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row max |Δ| of (..., 3) poses, the heading difference wrapped."""
    d = (a - b).abs()
    dth = torch.atan2(torch.sin(a[..., 2] - b[..., 2]),
                      torch.cos(a[..., 2] - b[..., 2])).abs()
    return torch.maximum(d[..., :2].amax(-1), dth)


def f64_witness(cfg, kpose, ppose, sp, sv, tp, tv, g) -> str:
    """Pairs whose kernel and plain poses differ by more than SPLIT_TOL,
    solved again in float64 by the plain version: which float32 result each
    one lies closer to, and how far each lies from it at most."""
    split = torch.nonzero(pose_gap(kpose, ppose) > SPLIT_TOL)[:, 0]
    if not len(split):
        return f"no pair split by > {SPLIT_TOL:g}"
    f64 = plicp_match(sp[split].double(), sv[split], tp[split].double(),
                      tv[split], cfg.plicp, init_pose=g[split].double()).pose
    gk = pose_gap(kpose[split].double(), f64)
    gp = pose_gap(ppose[split].double(), f64)
    return (f"{len(split)} pairs split by > {SPLIT_TOL:g}; float64 witness: "
            f"kernel closer {int((gk < gp).sum())}, plain closer "
            f"{int((gp < gk).sum())}, max|kernel-f64|={float(gk.max()):.3e} "
            f"max|plain-f64|={float(gp.max()):.3e}")


def phase_mission_batches(cfg, T: int, batches) -> None:
    """The PL-ICP kernel against its plain version on the mission's own
    batches, as the counted run recorded them: the chain batch through
    ``make_chain_matcher`` and the first loop round's multi-start batch
    through ``make_loop_selector``. Pairs that split are solved again in
    float64 as a witness (``f64_witness``)."""

    def plain_match(sp, sv, tp, tv, g):
        return plicp_match(sp, sv, tp, tv, cfg.plicp, init_pose=g)

    def gathered(store, storev, dirs, si, ti):
        return (_gather_scan(store, si, dirs), storev[si].contiguous(),
                _gather_scan(store, ti, dirs), storev[ti].contiguous())

    # chain: per-pair rows and the integrated trajectory
    args = batches["chain"]
    store, storev, dirs, si, ti, g, _pose0 = args
    Bp = si.shape[0]
    kern_c = make_chain_matcher(cfg)
    plain_c = _chain_matcher(plain_match)
    k, p = kern_c(*args), plain_c(*args)
    torch.cuda.synchronize()
    n = T - 1
    drel = float(pose_gap(k[:n, :3], p[:n, :3]).max())
    dtraj = float(pose_gap(k[Bp:Bp + T, :3], p[Bp:Bp + T, :3]).max())
    dinl = (k[:n, 4] - p[:n, 4]).abs()
    witness = f64_witness(cfg, k[:n, :3], p[:n, :3],
                          *gathered(store, storev, dirs, si[:n], ti[:n]),
                          g[:n])
    ms, plain_ms = cuda_ms(lambda: kern_c(*args), 5), cuda_ms(
        lambda: plain_c(*args), 2)
    print(
        f"mission chain batch: B={Bp} pairs={n} rel max|d|={drel:.3e} "
        f"trajectory max|d|={dtraj:.3e} inliers equal "
        f"{float((dinl == 0).float().mean()):.4f} max|d|={int(dinl.max())}; "
        f"{witness}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms", flush=True)
    if not (drel <= PLICP_POSE_TOL and dtraj <= CHAIN_TRAJ_TOL
            and int(dinl.max()) <= 1):
        raise AssertionError("chain batch: kernel and plain version disagree")

    # first loop round: the selector's rows, then the pairs beneath them
    S = batches["seeds"]
    args = batches["loop"]
    store, storev, dirs, si, ti, g, rel_pred, _gates = args
    Cp = rel_pred.shape[0]
    kern_l = make_loop_selector(cfg, S)
    plain_l = _loop_selector(plain_match, S)
    k, p = kern_l(*args), plain_l(*args)
    pairs = gathered(store, storev, dirs, si, ti)
    kp = plicp_match_fused(*pairs, cfg.plicp, init_pose=g)
    pp = plicp_match(*pairs, cfg.plicp, init_pose=g)
    torch.cuda.synchronize()
    acc_k, acc_p = k[:, 15] > 0.5, p[:, 15] > 0.5
    both = acc_k & acc_p
    dsel = float(pose_gap(k[both, :3], p[both, :3]).max()) if both.any() \
        else 0.0
    derr = float((k[both, 3] - p[both, 3]).abs().max()) if both.any() else 0.0
    witness = f64_witness(cfg, kp.pose, pp.pose, *pairs, g)
    ms = cuda_ms(lambda: plicp_match_fused(*pairs, cfg.plicp, init_pose=g), 5)
    plain_ms = cuda_ms(lambda: plicp_match(*pairs, cfg.plicp, init_pose=g), 2)
    inl_eq = float((kp.num_inliers == pp.num_inliers).float().mean())
    print(
        f"mission loop batch (round 0): Cp={Cp} S={S} pairs={Cp * S} accepted "
        f"kernel {int(acc_k.sum())} plain {int(acc_p.sum())} same flags "
        f"{bool(torch.equal(acc_k, acc_p))} selected rows pose max|d|="
        f"{dsel:.3e} err max|d|={derr:.3e}; pairs: pose max|d|="
        f"{float(pose_gap(kp.pose, pp.pose).max()):.3e} inliers equal "
        f"{inl_eq:.4f}; {witness}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
        flush=True)
    if not (torch.equal(acc_k, acc_p) and dsel <= PLICP_POSE_TOL):
        raise AssertionError("loop batch: kernel and plain version select "
                             "differently")


def phase_pcg(dev, res) -> dict:
    """PCG-LM kernel vs plain on the mission's loop-closed graph, started
    from the raw chain."""
    cfg = res.solver.cfg
    _poses, ei, ej, means, infos, free = res.solver.device_graph()
    M = len(free)
    args = (torch.as_tensor(res.chain_poses, dtype=torch.float32, device=dev),
            ei, ej, means, infos, torch.ones_like(ei, dtype=torch.bool), free,
            cfg.initial_lambda)
    kw = dict(iters=cfg.max_iterations, cg_iters=cfg.cg_iterations,
              cg_tol=cfg.cg_tolerance,
              sq_min_delta=_sq_min_delta(cfg.convergence_delta))

    def kern():
        return fused_lm_solve(*args, **kw)[5]

    def plain():
        return pcg_lm_plain(*args, **kw)

    k, p = kern(), plain()
    torch.cuda.synchronize()
    dpose = float((k[0:3] - p[0:3]).abs().max())
    kc, pc = float(k[3, 1]), float(p[3, 1])
    ok = (bool(torch.isfinite(k).all()) and dpose <= LM_POSE_TOL
          and abs(kc - pc) <= LM_COST_RTOL * abs(pc))
    ms, plain_ms = cuda_ms(kern, 3), cuda_ms(plain, 2)
    # per LM iteration the edge work and ~60 FLOPs per node (damping, the
    # 3×3 preconditioner inverse); per PCG iteration two 3×3 block
    # products per edge (36) and ~60 per node (diagonal block, the
    # preconditioner, three dot products and three updates)
    E, iters, cg = len(ei), int(k[3, 3]), int(k[4, 0])
    work = bound(12 * M + 16 * E + 48 * E + E + M + k.numel() * 4,
                 iters * (lm_edge_flops(E) + 60 * M) + cg * (36 * E + 60 * M))
    print(f"pcg_lm: nodes={M} edges={E} pose max|d|={dpose:.3e} cost0 "
          f"{float(k[3, 0]):.6g} cost kernel {kc:.6g} plain {pc:.6g} iters "
          f"kernel {iters} plain {int(p[3, 3])} PCG iterations {cg} kernel "
          f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {work['bound_ms']:.5f} "
          f"ms ({work['bound_by']})", flush=True)
    if not ok:
        raise AssertionError("PCG-LM kernel disagrees with its plain version")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def phase_mission_rate(cfg, scans, odom) -> None:
    T = scans.ranges.shape[0]
    timer = StageTimer()
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        offline_slam(scans, cfg, odom=odom, timer=timer)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    rates = sorted(T / dt for dt in dts)
    print(f"mission: scans/s median {rates[1]:.1f} (min {rates[0]:.1f} max "
          f"{rates[2]:.1f}) over 3 runs after the warm one", flush=True)
    print("stage timer (3 runs):\n" + timer.report(), flush=True)


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall µs, device busy µs
    as the union of the kernel intervals, {kernel: (launches, device
    µs)}), each hand-written kernel by name and the rest as "other"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type.name == "CUDA" and e.time_range.elapsed_us() > 0)
    busy, end = 0.0, -np.inf
    for s, e, _name in spans:  # union of the kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    per = {}
    for s, e, name in spans:
        key = next((k for k in _dispatch.LAUNCHES if f"{k}_kernel" in name),
                   "other")
        n, us = per.get(key, (0, 0.0))
        per[key] = (n + 1, us + e - s)
    return wall_us, busy, per


def profile_line(what: str, wall_us, busy, per) -> str:
    return (f"profile: {what} wall {wall_us / 1e3:.1f} ms device busy "
            f"{busy / 1e3:.1f} ms idle share {1 - busy / wall_us:.3f}; " +
            "; ".join(f"{k} {n} x {us / 1e3 / n:.3f} ms = {us / 1e3:.1f} ms"
                      for k, (n, us) in sorted(per.items())))


def phase_profile(cfg, scans, odom) -> None:
    """One warm mission under ``torch.profiler``: its wall, the device's busy
    time (the union of kernel intervals) and idle share, and the device
    time of each hand-written kernel per launch."""
    timer = StageTimer()
    prof = device_profile(
        lambda: offline_slam(scans, cfg, odom=odom, timer=timer))
    print(profile_line("mission", *prof), flush=True)
    print("profile stages:\n" + timer.report(), flush=True)


def hector_seq(n: int, dev, cfg=None):
    """examples/run_hector_slam.py's recipe: an office circle of ``n``
    scans (radius 1.5 m, 0.6 rad/s) in office_world(seed=31) with the path
    kept clear, noise 0.004, seed 3; (cfg, scans on ``dev``, true poses)."""
    cfg = cfg or default_config()
    traj = sim.circle_trajectory(n, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=3)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    return cfg, scans, seq.gt_poses


def hector_case(dev, cfg=None, beams=None):
    """bench_hector's setup: a map of scans 0-2 of the Hector recipe at
    their true poses, and scan 4 with its true pose plus (0.04, -0.03,
    0.02). ``beams`` renders scan 4 with another beam count. Returns
    (slam, probability grids, start pose, points, valid, true pose)."""
    cfg, scans, gt = hector_seq(8, dev, cfg)
    slam = HectorSLAM(cfg, device=dev)
    for t in range(3):
        slam.update_only(index_scan(scans, t), gt[t])
    if beams is not None:
        scfg = dataclasses.replace(cfg.scan, num_beams=beams,
                                   angle_increment=2 * np.pi / beams)
        _c, scans, _g = hector_seq(8, dev, dataclasses.replace(cfg,
                                                              scan=scfg))
    pts, valid = _beams(index_scan(scans, 4))
    guess = torch.tensor(gt[4] + [0.04, -0.03, 0.02], dtype=torch.float32,
                         device=dev)
    probs = tuple(gm.occupancy_prob(g).view(c.size_y, c.size_x)
                  for g, c in zip(slam.grids, slam.grid_cfgs))
    return slam, probs, guess, pts.contiguous(), valid.contiguous(), gt[4]


def hector_compare(slam, probs, guess, pts, valid, label: str):
    """The Hector kernel against its plain version (``match_multires``) on
    one match; raises on disagreement. Returns (pose |Δ|, kernel, plain)."""
    gcfgs, hcfg = tuple(slam.grid_cfgs), slam.cfg.hector

    def kern():
        return hector_match_fused(probs, gcfgs, hcfg, guess, pts, valid)

    def plain():
        return hec.match_multires([g.reshape(-1) for g in probs],
                                  list(gcfgs), guess, pts, valid, hcfg)

    (kp, kH), (pp, pH) = kern(), plain()
    torch.cuda.synchronize()
    dpose = float(pose_gap(kp, pp))
    hok = bool(((kH - pH).abs() <= HECTOR_H_ATOL
                + HECTOR_H_RTOL * pH.abs()).all())
    print(f"{label}: levels={len(probs)} N={pts.shape[0]} valid="
          f"{int(valid.sum())} pose max|d|={dpose:.3e} H max|d|="
          f"{float((kH - pH).abs().max()):.3e} (|H| max "
          f"{float(pH.abs().max()):.4g}) pose {kp.tolist()}", flush=True)
    if not (bool(torch.isfinite(kp).all()) and dpose <= HECTOR_POSE_TOL
            and hok):
        raise AssertionError(f"{label}: the Hector kernel disagrees with "
                             "its plain version")
    return dpose, (kp, kH), (pp, pH), kern, plain


def hector_work(probs, gcfgs, hcfg, guess, pts, valid):
    """(bytes, FLOPs) one match needs on these inputs, from a replay of
    the plain version's steps: the grid cells its bilinear taps read
    (each cell once), the points, mask, pose and result; and ~65 FLOPs
    for each valid in-map beam at each GN step (rotation, taps'
    weights, value, gradient, Jacobian row and the 9 sums) plus ~80 for
    each step's 3×3 solve."""
    nbytes = 9 * pts.shape[0] + 12 + 48
    flops, pose = 0.0, guess
    for lvl in range(len(probs) - 1, -1, -1):
        c = gcfgs[lvl]
        steps = (hcfg.iterations_fine if lvl == 0
                 else hcfg.iterations_coarse) + 1
        pm = hec.world_pose_to_map(c, pose)
        pmap = pts / c.resolution
        flat = probs[lvl].reshape(-1)
        cells = []
        for _ in range(steps):
            q = geo.apply(pm, pmap) - 0.5
            x, y = q[:, 0], q[:, 1]
            use = valid & (x >= 0) & (y >= 0) & (x < c.size_x - 1) & (
                y < c.size_y - 1)
            base = (torch.floor(y[use]).long() * c.size_x
                    + torch.floor(x[use]).long())
            cells += [base, base + 1, base + c.size_x, base + c.size_x + 1]
            flops += 65 * int(use.sum()) + 80
            pm, _H = hec.gn_step(flat, c.size_x, c.size_y, pm, pmap, valid,
                                 hcfg.max_rot_step)
        nbytes += 4 * int(torch.unique(torch.cat(cells)).numel())
        pm = torch.cat([pm[:2], geo.normalize_angle(pm[2:3])])
        pose = hec.map_pose_to_world(c, pm)
    return nbytes, flops


def phase_hector(dev) -> dict:
    """The Hector kernel against its plain version at full width on
    bench_hector's map and scan, with both times and its bound."""
    slam, probs, guess, pts, valid, truth = hector_case(dev)
    dpose, (kp, _kH), _p, kern, plain = hector_compare(
        slam, probs, guess, pts, valid, "hector")
    err = np.abs(kp.cpu().numpy()[:2] - truth[:2]).max()
    ms, plain_ms = cuda_ms(kern, 200), cuda_ms(plain, 20)
    nbytes, flops = hector_work(probs, slam.grid_cfgs, slam.cfg.hector,
                                guess, pts, valid)
    work = bound(nbytes, flops)
    print(f"hector: grid {slam.grid_cfgs[0].size_x}^2 x "
          f"{len(slam.grid_cfgs)} levels, match |xy - truth| {err:.4f} m "
          f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms; work {nbytes} bytes "
          f"{flops:.0f} FLOPs, bound {work['bound_ms']:.6f} ms "
          f"({work['bound_by']})", flush=True)
    if err > 0.03:
        raise AssertionError("the Hector match missed the true pose")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def phase_hector_edges(dev) -> None:
    """The Hector kernel against its plain version off the main path's
    shapes: 100 beams; no valid beam (the pose comes back, H = 0); a
    trajectory 0.9 m from the map's east edge (the map shifted so half
    the beams fall off it); pyramids of 1 and 4 levels."""
    slam, probs, guess, pts, valid, _t = hector_case(dev, beams=100)
    hector_compare(slam, probs, guess, pts, valid, "edge hector 100 beams")
    slam, probs, guess, pts, valid, _t = hector_case(dev)
    none = torch.zeros_like(valid)
    _d, (kp, kH), _p, _k, _pl = hector_compare(slam, probs, guess, pts, none,
                                              "edge hector no valid beam")
    if float((kp - guess).abs().max()) > 1e-5 or bool(kH.any()):
        raise AssertionError("no valid beam: the pose moved or H is not 0")
    cfg = default_config()
    # map_start_x puts the map's east edge at x = 2.5 m, 1 m east of the
    # circle's start (1.5, 0), so the beams to the east end off the map
    width = cfg.hector.map_size * cfg.hector.map_resolution
    edge = dataclasses.replace(cfg, hector=dataclasses.replace(
        cfg.hector, map_start_x=1.0 - 2.5 / width))
    slam, probs, guess, pts, valid, _t = hector_case(dev, edge)
    wx = geo.apply(guess, pts)[:, 0]
    east = slam.grid_cfgs[0].origin_x + width
    off = float((valid & (wx > east)).float().sum() / valid.sum())
    print(f"edge hector by the map edge: {off:.2f} of the valid beams end "
          f"off the map", flush=True)
    if off < 0.3:
        raise AssertionError("the edge case keeps its beams on the map")
    hector_compare(slam, probs, guess, pts, valid, "edge hector map edge")
    for levels in (1, 4):
        c = dataclasses.replace(cfg, hector=dataclasses.replace(
            cfg.hector, map_multi_res_levels=levels))
        slam, probs, guess, pts, valid, _t = hector_case(dev, c)
        hector_compare(slam, probs, guess, pts, valid,
                       f"edge hector {levels} levels")


def hector_run(cfg, scans, gt, dev):
    """One ``HectorSLAM.run`` from the true start pose; (poses, the number
    of map updates)."""
    slam = HectorSLAM(cfg, device=dev)
    slam.last_pose = torch.tensor(gt[0], dtype=torch.float32, device=dev)
    updates = [0]
    update = slam._update

    def counted(*args):
        updates[0] += 1
        update(*args)

    slam._update = counted
    est = slam.run(scans)
    torch.cuda.synchronize()
    return est, updates[0]


def phase_hector_main(dev) -> int:
    """The counted Hector run, its scans/s and its profile."""
    cfg, scans, gt = hector_seq(HECTOR_SCANS, dev)
    T = len(gt)
    _dispatch.reset_launches()
    est, updates = hector_run(cfg, scans, gt, dev)
    launches = dict(_dispatch.LAUNCHES)
    ate = float(ate_rmse(est, gt, align=False))
    print(f"hector main path: scans={T} grid {cfg.hector.map_size}^2 x "
          f"{cfg.hector.map_multi_res_levels} levels map updates={updates} "
          f"ATE {ate:.5f} m (map frame); launches {launches}", flush=True)
    if est.shape != (T, 3) or not np.all(np.isfinite(est)):
        raise AssertionError("Hector poses are not finite (T, 3)")
    if ate > HECTOR_ATE_MAX:
        raise AssertionError(f"Hector ATE {ate:.5f} m > {HECTOR_ATE_MAX} m")
    if launches["hector_fused"] != T - 1:
        raise AssertionError("not every matched scan ran the Hector kernel")
    dts = []
    for _ in range(4):  # a warm run, then 3 timed
        t0 = time.perf_counter()
        hector_run(cfg, scans, gt, dev)
        dts.append(time.perf_counter() - t0)
    rates = sorted(T / dt for dt in dts[1:])
    print(f"hector: scans/s median {rates[1]:.1f} (min {rates[0]:.1f} max "
          f"{rates[2]:.1f}) over 3 runs after the warm one", flush=True)
    wall, busy, per = device_profile(lambda: hector_run(cfg, scans, gt, dev))
    print(profile_line(f"hector run ({T} scans)", wall, busy, per),
          flush=True)
    # the map update alone, at every scan's estimated pose: its device time
    # per update, and per scan of the main path (updates / T of them)
    slam = HectorSLAM(cfg, device=dev)
    poses = torch.tensor(est, dtype=torch.float32, device=dev)

    def updates_only():
        for t in range(T):
            pts, valid = _beams(index_scan(scans, t))
            slam._update(poses[t], pts, valid)

    def matches_only():  # each with step's one read of pose and H
        for t in range(T):
            pts, valid = _beams(index_scan(scans, t))
            pose, H = slam._match(poses[t], pts, valid)
            torch.cat([pose, H.reshape(-1)]).cpu()

    uwall, ubusy, _u = device_profile(updates_only)
    per_update = ubusy / 1e3 / T
    print(f"profile: log-odds update {per_update:.3f} ms device per update "
          f"({uwall / 1e3 / T:.3f} ms wall), {per_update * updates / T:.3f} "
          f"ms device per scan of the main path", flush=True)
    walls = {}
    for name, fn in (("match and read", matches_only),
                     ("map update", updates_only)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / T
    print("hector host, no profiler: " + "; ".join(
        f"{k} {v:.3f} ms wall per call" for k, v in walls.items()),
        flush=True)
    return launches["hector_fused"]


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    plicp = phase_plicp(dev)
    cr = phase_cr(dev)
    phase_edge_cases(dev)
    cfg, scans, odom, res, launches, batches = phase_main_path(dev)
    phase_mission_batches(cfg, res.poses.shape[0], batches)
    pcg = phase_pcg(dev, res)
    phase_mission_rate(cfg, scans, odom)
    phase_profile(cfg, scans, odom)
    hector = phase_hector(dev)
    phase_hector_edges(dev)
    hector_launches = phase_hector_main(dev)
    kernels = [
        {"name": "plicp_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/plicp_fused.cu",
         "replaces": "tpu_slam/ops/pallas/plicp_fused.py:585",
         "launches": launches["plicp_fused"], **plicp},
        {"name": "cr_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/cr_lm.cu",
         "replaces": "tpu_slam/solver/pallas_cr_lm.py:573",
         "launches": launches["cr_lm"], **cr},
        {"name": "pcg_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/pcg_lm.cu",
         "replaces": "tpu_slam/solver/pallas_lm.py:384",
         "launches": launches["pcg_lm"], **pcg},
        {"name": "hector_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/hector_fused.cu",
         "replaces": "tpu_slam/ops/pallas/hector_fused.py:269",
         "launches": hector_launches, **hector},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
