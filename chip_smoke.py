"""Quickest proof that the PyTorch/CUDA port (``tpu_slam_torch``) runs on
the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; imports no JAX
and nothing of the JAX package. Phases, each printing its own line(s):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the seven kernels from ``tpu_slam_torch/csrc``, one nvcc per
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
 12. the correlative response kernel against its plain version, int32
     for int32, at the shapes of examples/run_karto_slam.py's recipe at
     the full ``default_config()``: the front-end coarse (21 × 16²) and
     fine (11 × 3²) passes on the 2,445² grid of a 128-scan base, and the
     loop coarse pass (21 × 81²) on eight 645² grids in one launch; with
     both times and the bound;
 13. the same on edge cases: windows clamped at every grid edge, starts
     below 0 and past the edge, no valid beam (and a match without one,
     which takes the response expansion), 1 and 1,500 beams, 1 lane;
 14. the wall of each layer of one front-end match at that shape
     (``find_valid_points``, grid build, coarse and fine pass, the whole
     match and its read), then the online Karto main path, with the
     launch counters zeroed first:
     ``KartoSLAM.run`` over the recipe's 352 scans at the full width.
     Every match must run the correlative kernel. Every solve takes the
     dense LM and no LM kernel: the graphs (≤ 126 nodes, 127 edges) fail
     the reference's shape test for its fused LM, as on its TPU. The ATE
     must stay ≤ 0.01 m; then its scans/s (median of 3 runs after the
     counted one, which warms it), the stage timer, and one run under
     ``torch.profiler``;
 15. the NN kernel against its plain version
     (``ops/matching.nearest_neighbor_direct``), bit for bit in indices
     and distances, at the odometry's shape (1 × 360 × 360) and the
     scan-matching batch's (120 × 360 × 360), with both times and the
     bound, then on edge cases (N ≠ M with odd counts, N = 1, M = 4,096
     over 4 source tiles, no valid target, duplicated targets, sources far
     outside);
 16. the lesson main paths over examples/run_plicp_odometry.py's 200
     scans at 360 beams, each with the launch counters zeroed first:
     ``ICPOdometry.run``, ``PLICPOdometry.run`` and ``ScanMatchPLICP.run``.
     Every NN call must launch the NN kernel (199 × 20, 199 × 10 and
     199 × 10), each ATE stay ≤ 1.1 × the reference's CPU run + 1 mm, and
     PLICPOdometry's keyframes within ±1 of the reference's; then each
     one's scans/s and a run of its first 50 scans under
     ``torch.profiler``;
 17. examples/run_scan_matching.py's 120 pairs in one batch, counters
     zeroed before each: ``icp_match`` (20 NN launches),
     ``plicp_match_batch`` (10) and the point-to-point ``_match_fn`` (10),
     each delta RMSE within the same slack of the reference's;
 18. examples/run_lidar_undistortion.py's 80 scans: the corrected and raw
     endpoint errors, PL-ICP deltas on corrected against raw points (the
     corrected must win), and the correction's wall per scan;
 19. examples/run_feature_detection.py's 120 scans: the card's corner
     masks equal the CPU's, the mean count within 0.5% of the reference's;
 20. the streamed CR-LM kernel against its plain version on bench_solver's
     rings of 4,096 and 16,384 nodes (K 1,024 and 4,096), then on edge
     cases (W = 2, W = 8, 32,768 nodes), with both times, the kernels it
     enqueues and the bound; then both CR-LM kernels on the same graphs
     (the bench graph at K 256, a 3,072-node ring at K 512), with both
     times;
 21. the large-graph main path, with the launch counters zeroed first:
     ``PoseGraphSolver.compute`` on the 4,096- and 16,384-node rings, each
     one streamed-kernel launch and no other, χ² → ~0; their solve ms
     (median of 3 warm runs) and one solve under ``torch.profiler``;
 22. the host f64 arm: a 3,200-node skip-edge graph that does not band
     solves on the host and launches nothing;
 23. ``offline_slam(corrected_pts=...)`` on the 80-scan undistortion
     recipe: every match a PL-ICP launch, the corrected chain's ATE under
     the raw one's;
 24. one JSON line with every kernel (its launches, error against its
     plain version, both times, and its bound: the larger of bytes over
     3.35 TB/s and operations over 67 T/s in float32, or 16.7 T/s for the
     correlative kernel's int32 adds), then ``{"ok": true, ...}`` last.
Phases 20-23 run right after phase 4. Any failing phase raises: the
script then exits non-zero and never prints the ok line. Without a CUDA
device it raises at phase 1. A ``[time]`` line after each group of
phases gives its wall and the running total.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
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
from tpu_slam_torch.data.scan import Scan, index_scan, make_scan
from tpu_slam_torch.models import offline
from tpu_slam_torch.models.hector_slam import HectorSLAM, _beams
from tpu_slam_torch.models.icp_odometry import ICPOdometry
from tpu_slam_torch.models.karto.pipeline import KartoSLAM
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.models.plicp_odometry import (
    PLICPOdometry, plicp_match_batch,
)
from tpu_slam_torch.models.scan_match_plicp import ScanMatchPLICP
from tpu_slam_torch.ops import correlative as corr
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops import hector as hec
from tpu_slam_torch.ops.cuda.correlative_response import responses_sliced
from tpu_slam_torch.ops.cuda.hector_fused import hector_match_fused
from tpu_slam_torch.ops.cuda.nn import nearest_neighbor_cuda
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.features import extract_corner_features
from tpu_slam_torch.ops.icp import icp_match
from tpu_slam_torch.ops.matching import (
    nearest_neighbor, nearest_neighbor_direct,
)
from tpu_slam_torch.ops.plicp import plicp_match
from tpu_slam_torch.ops.undistort import undistort_scan
from tpu_slam_torch.parallel.distributed_step import (
    _chain_matcher, _gather_scan, _loop_selector, _match_fn,
    make_chain_matcher, make_loop_selector,
)
from tpu_slam_torch.solver import banded
from tpu_slam_torch.solver.cr_lm import cr_lm_plain, fused_cr_lm
from tpu_slam_torch.solver.cr_stream import streamed_cr_lm
from tpu_slam_torch.solver.pcg_lm import fused_lm_solve, pcg_lm_plain
from tpu_slam_torch.solver.pose_graph import _route, _sq_min_delta
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
KARTO_ATE_MAX = 0.01  # m
# the reference's run of the Karto recipe at the full width on the CPU
KARTO_REF = {"accepted": 126, "closures": 2, "ate": 0.00577}
# the lesson front-ends: examples/run_plicp_odometry.py's recipe (200 scans
# of 360 beams), and the reference's CPU runs of it (tpu_slam on the CPU,
# whose NN takes the expanded form; reproduced by the slow test
# tests/test_torch_odometry.py::test_chip_smoke_references_are_the_reference_runs):
# each model's ATE (m), and the scan indices at which PLICPOdometry took a
# keyframe (every second scan)
LESSON_SCANS = 200
LESSON_PROFILE_SCANS = 50  # the profiled window of each model's run
LESSON_REF = {"icp": 0.18175, "plicp": 0.000863, "scan_match": 0.003486}
LESSON_REF_KEYFRAMES = list(range(2, 199, 2))
# the kernel's direct differences can split a near-tie that the expanded
# form decides the other way: each ATE may grow by 10% and 1 mm
LESSON_ATE_SLACK = (1.1, 0.001)
# examples/run_scan_matching.py's 120 pairs on the reference's CPU: delta
# RMSE (m, rad) of point-to-point ICP, PL-ICP and point-to-point PL-ICP
SCAN_MATCH_REF = {"icp": (0.005188, 0.007105), "plicp": (0.0004323, 0.0001208),
                  "p2p": (0.006319, 0.008753)}
# examples/run_feature_detection.py's 120 scans on the reference's CPU:
# 10,895 corners, 90.79 per scan
FEATURES_REF_MEAN = 10895 / 120
FEATURES_MEAN_RTOL = 0.005
# the least time the card could take: published H100 SXM peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
# int32 adds: 132 SMs × 64 INT32 lanes at the 1,980 MHz boost clock (the
# data sheet gives no int32 rate outside the tensor cores)
PEAK_INT32_OPS = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float, peak: float = PEAK_F32_FLOPS) -> dict:
    """The larger of bytes over the memory rate and operations over their
    peak rate (float32 outside the tensor cores unless ``peak`` says
    otherwise), and which one sets it."""
    tb, tf = nbytes / PEAK_BYTES_PER_S, ops / peak
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


def plain_plicp(*args, **kw):
    """``plicp_match`` as the PL-ICP kernel's plain version: with the plain
    nearest neighbour, so that it launches no kernel."""
    return plicp_match(*args, nn=nearest_neighbor, **kw)


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
        return plain_plicp(*args, cfg.plicp, init_pose=g)

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
        conv = plain_plicp(*args, dataclasses.replace(pcfg, max_iterations=k),
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
    p = plain_plicp(src, sv, tgt, tv, cfg.plicp, init_pose=g)
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
    f64 = plain_plicp(sp[split].double(), sv[split], tp[split].double(),
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
        return plain_plicp(sp, sv, tp, tv, cfg.plicp, init_pose=g)

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
    pp = plain_plicp(*pairs, cfg.plicp, init_pose=g)
    torch.cuda.synchronize()
    acc_k, acc_p = k[:, 15] > 0.5, p[:, 15] > 0.5
    both = acc_k & acc_p
    dsel = float(pose_gap(k[both, :3], p[both, :3]).max()) if both.any() \
        else 0.0
    derr = float((k[both, 3] - p[both, 3]).abs().max()) if both.any() else 0.0
    witness = f64_witness(cfg, kp.pose, pp.pose, *pairs, g)
    ms = cuda_ms(lambda: plicp_match_fused(*pairs, cfg.plicp, init_pose=g), 5)
    plain_ms = cuda_ms(lambda: plain_plicp(*pairs, cfg.plicp, init_pose=g), 2)
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
    """Run ``fn`` once under ``torch.profiler``, tracing the card alone (a
    host trace of every small op costs more to record and read than the
    run): (wall µs, device busy µs as the union of the kernel intervals,
    {kernel: (launches, device µs)}), each hand-written kernel by name and
    the rest as "other"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the raw events: FunctionEvent trees would take minutes at ~10^5
    spans = sorted(
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type().name == "CUDA" and e.duration_ns() > 0)
    busy, end = 0.0, -np.inf
    for s, e, _name in spans:  # union of the kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    per = {}
    for s, e, name in spans:
        # "<key>_kernel" or "<key>_<stage>_kernel" from a word's start, so
        # that e.g. a library's "..._NN_kernel" is not "nn"
        key = next((k for k in _dispatch.LAUNCHES
                    if re.search(rf"(^|\W){k}_(\w+_)?kernel\b", name)),
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


def _compose32(a, b):
    """The reference's ``geometry.compose`` as JAX runs it outside ``jit``:
    float32, every operation rounded on its own, glibc's sin, cos and
    atan2 (``ops/correlative.sincosf``, ``atan2f``). a, b: (3,) float32."""
    s, c = corr.sincosf(a[2:3])
    st, ct = corr.sincosf(a[2:3] + b[2:3])
    return torch.cat([(a[0:1] + c * b[0:1]) - s * b[1:2],
                      (a[1:2] + s * b[0:1]) + c * b[1:2],
                      corr.atan2f(st, ct)])


def _inverse32(a):
    s, c = corr.sincosf(a[2:3])
    sn, cn = corr.sincosf(-a[2:3])
    return torch.cat([-(c * a[0:1] + s * a[1:2]),
                      -((-s) * a[0:1] + c * a[1:2]), corr.atan2f(sn, cn)])


def drifted_odometry(gt, seed: int = 3, trans_sigma: float = 0.02,
                     rot_sigma: float = 0.004) -> np.ndarray:
    """tests/test_karto.py's drifting wheel odometry, bit for bit: each
    true relative motion plus N(0, σ) noise from default_rng(seed),
    integrated in float32."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    odom = [gt[0].copy()]
    for i in range(1, len(gt)):
        d = _compose32(_inverse32(f32(gt[i - 1])), f32(gt[i])).numpy()
        d[:2] += rng.normal(0, trans_sigma, 2)
        d[2] += rng.normal(0, rot_sigma)
        odom.append(_compose32(f32(odom[-1]), f32(d)).numpy())
    return np.asarray(odom)


def karto_recipe(dev):
    """examples/run_karto_slam.py's recipe at the full ``default_config()``
    (360 beams, 12 m; the 0.3 m / 0.01 m front grid of 2,445² cells, the
    8 m / 0.05 m loop grid of 645²): the corridor loop (arm 9 m, width
    2.6 m, 0.9 m/s, 352 scans), noise 0.004, seed 8, and the drifting
    odometry. Returns (cfg, scans on ``dev``, odometry, true poses)."""
    cfg = default_config()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    return cfg, scans, drifted_odometry(seq.gt_poses), seq.gt_poses


def karto_records(cfg, scans, gt, dev):
    """Each scan as the mapper keeps it (``_make_record``: 359 beams, raw
    endpoints), at its true pose: a mapper on ``dev``, the laser points
    (T, 359, 2) and valid flags on ``dev``, the poses (T, 3) float32."""
    slam = KartoSLAM(cfg, device=dev)
    host = Scan(**{f.name: getattr(scans, f.name).cpu().numpy()
                   for f in dataclasses.fields(Scan)})
    recs = [slam._make_record(index_scan(host, t), gt[t], "laser0")
            for t in range(len(gt))]
    pts = torch.as_tensor(np.stack([r.pts_laser for r in recs]), device=dev)
    valid = torch.as_tensor(np.stack([r.beam_valid for r in recs]),
                            device=dev)
    return slam, pts, valid, torch.as_tensor(gt, dtype=torch.float32,
                                             device=dev)


def response_case(matcher, idx, pts, valid, poses, query: int, offset,
                  fine: bool = False):
    """One pass of ``matcher`` as the mapper runs it: lanes of base scans
    ``idx`` (C, S) rows (−1 padded) at their poses, the grid of each lane
    (uint8), and the window starts of scan ``query`` searched from its pose
    plus ``offset``. Returns the kernel's arguments."""
    p = matcher.p
    dev = pts.device
    idx = torch.as_tensor(idx, device=dev)
    member = idx >= 0
    rows = idx.clamp(min=0)
    center = poses[query] + torch.as_tensor(offset, dtype=torch.float32,
                                            device=dev)
    wp = corr.apply_pose(poses[rows], pts[rows])
    keep = corr.find_valid_points(wp, valid[rows] & member[..., None],
                                  center[:2])
    C = idx.shape[0]
    grid = corr.build_correlation_grid(
        p, center[:2], wp.reshape(C, -1, 2), keep.reshape(C, -1))
    if fine:
        xo, yo, n = matcher.fine_x, matcher.fine_y, matcher.n_angles_fine
        ao, ar = matcher.fine_angle_offset, p.fine_angle_offset
    else:
        xo, yo = matcher.coarse_x, matcher.coarse_y
        n, ao, ar = matcher.n_angles_coarse, p.angle_offset, p.angle_res
    sc = center.expand(C, 3)
    angles = corr.angle_ladder(sc[:, 2:3], ao, ar, n)
    stride = corr._lattice_stride(xo, yo, p.resolution)
    q_valid = valid[query].contiguous()
    ys, xs = corr.lattice_starts(p, center[:2], sc,
                                 pts[query] * corr.recip32(p.resolution),
                                 q_valid, angles, xo, yo, stride)
    return grid.to(torch.uint8), ys, xs, q_valid, len(xo), len(yo), stride


def response_compare(label, grid, ys, xs, valid, nx, ny, stride,
                     reps=(20, 2)):
    """The kernel against its plain version: int32 equality, both times
    (CUDA events; none when ``reps`` is 0) and the bound of this work."""

    def kern():
        return responses_sliced(grid, ys, xs, valid, nx, ny, stride)

    def plain():
        return corr.sum_windows(grid, ys, xs, valid, nx, ny, stride)

    k, pl = kern(), plain()
    torch.cuda.synchronize()
    err = int((k - pl).abs().max())
    C, A, N = ys.shape
    nv = int(valid.sum())
    # each input read once (the grids, the starts, the flags), the
    # numerators written once; one int32 add per lane, heading, candidate
    # and valid beam
    work = bound(grid.numel() + 8 * ys.numel() + N + 4 * k.numel(),
                 float(C * A * nx * ny * nv), PEAK_INT32_OPS)
    ms = cuda_ms(kern, reps[0]) if reps[0] else None
    plain_ms = cuda_ms(plain, reps[1]) if reps[1] else None
    times = (f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms" if reps[0]
             else "not timed")
    print(f"{label}: lanes={C} headings={A} lattice={ny}x{nx} stride="
          f"{stride} beams={N} valid={nv} grid {grid.shape[1]}x"
          f"{grid.shape[2]} int32 equal {err == 0} max|d|={err} sum "
          f"{int(k.sum())} {times} bound {work['bound_ms']:.6f} ms "
          f"({work['bound_by']})", flush=True)
    if err != 0 or k.shape != (C, A, nx * ny):
        raise AssertionError(f"{label}: the correlative kernel disagrees "
                             "with its plain version")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            **work}


def phase_correlative(dev, cfg, scans, gt):
    """The correlative kernel at the recipe's shapes: the front coarse and
    fine passes of scan 130 against the 128 scans before it (one lane),
    and the loop coarse pass of the last scan, which revisits the start,
    against eight 10-scan chains around the loop (eight lanes). Returns
    the loop pass's numbers and what the edge cases reuse."""
    slam, pts, valid, poses = karto_records(cfg, scans, gt, dev)
    base = np.arange(2, 130)[None]  # 128 scans: the 128-row bucket
    front = response_case(slam.front_matcher, base, pts, valid, poses, 130,
                          [0.03, -0.02, 0.01])
    response_compare("correlative front coarse", *front)
    fine = response_case(slam.front_matcher, base, pts, valid, poses, 130,
                         [0.004, -0.003, 0.002], fine=True)
    response_compare("correlative front fine", *fine)
    chains = np.full((8, 16), -1)  # 16: the mapper's bucket for 10 scans
    for k, s0 in enumerate(range(0, 320, 40)):
        chains[k, :10] = np.arange(s0, s0 + 10)
    loop = response_case(slam.loop_matcher, chains, pts, valid, poses,
                         len(gt) - 1, [0.2, -0.15, 0.03])
    out = response_compare("correlative loop coarse", *loop, reps=(10, 1))
    print("correlative library: none; no single PyTorch call computes these "
          "sums: each beam's window start is shifted to stay inside the grid "
          "(dynamic_slice's wrap of a negative start, then its clamp), per "
          "lane and heading; a convolution with a one-hot kernel of the "
          "rotated beams computes them only where no window is shifted",
          flush=True)
    return out, (slam, pts, valid, poses), front


def phase_correlative_edges(dev, records, front) -> None:
    """The kernel against its plain version off the main path's shapes."""
    slam, pts, valid, poses = records
    grid, ys, xs, v, nx, ny, stride = front
    _c, H, W = grid.shape
    # a grid of random values 0..100, so that a window at an edge, where
    # the recipe's grid holds zeros, still sums something
    g = torch.Generator().manual_seed(0)
    grid = torch.randint(0, 101, grid.shape, generator=g,
                         dtype=torch.uint8).to(dev)
    # first candidates at every grid edge and corner, below 0 and past the
    # far edge: window_starts wraps and clamps them
    q = pts[130] * corr.recip32(slam.front_matcher.p.resolution)
    angles = corr.angle_ladder(poses[130, 2:3][None], 0.35, 0.035, 21)
    for c0 in ((0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1), (-40, -40),
               (W + 40, H + 40), (W // 2, -3)):
        cand0 = torch.tensor([c0], dtype=torch.int32, device=dev)
        y2, x2 = corr.window_starts(q, v, angles, cand0, H, W, nx, ny, stride)
        response_compare(f"edge correlative cand0={c0}", grid, y2, x2, v, nx,
                         ny, stride, reps=(0, 0))
    # starts outside [0, dim − span]: the kernel clamps them as its plain
    # version does, and reads nothing outside the grid
    response_compare("edge correlative unclamped starts", grid, ys + 5000,
                     xs - 5000, v, nx, ny, stride, reps=(0, 0))
    none = torch.zeros_like(v)
    response_compare("edge correlative no valid beam", grid, ys, xs, none,
                     nx, ny, stride, reps=(0, 0))
    # 1 beam, and 1,500 beams (more than a block stages: split in chunks)
    response_compare("edge correlative 1 beam", grid,
                     ys[..., :1].contiguous(), xs[..., :1].contiguous(),
                     v[:1].contiguous(), nx, ny, stride, reps=(0, 0))
    big = torch.randint(0, 2000, (1, ys.shape[1], 1500), generator=g,
                        dtype=torch.int32).to(dev)
    response_compare("edge correlative 1,500 beams", grid, big,
                     big.flip(-1).contiguous(),
                     torch.ones(1500, dtype=torch.bool, device=dev), nx, ny,
                     stride, reps=(0, 0))
    # a match whose scan has no valid beam: response 0, so the response
    # expansion runs 3 more passes, each a coarse and a fine launch
    m = slam.front_matcher
    wp = corr.apply_pose(poses[2:130], pts[2:130]).reshape(-1, 2)
    before = _dispatch.LAUNCHES["correlative_response"]
    r = m.match(wp, valid[2:130].reshape(-1), pts[130], none, poses[130])
    n = _dispatch.LAUNCHES["correlative_response"] - before
    print(f"edge correlative match without a valid beam: response "
          f"{float(r.response)} after {n} kernel launches", flush=True)
    if float(r.response) != 0.0 or n != 8:
        raise AssertionError("a match without a valid beam must answer 0 "
                             "after the 3 expansion passes (8 launches)")


def phase_karto_layers(dev, records) -> None:
    """Wall per call of each layer of one front-end match at the recipe's
    shape (scan 130 against the 128 scans before it, one lane), each call
    ended by a synchronize, median of 5 after a warm one: the view filter
    (``find_valid_points``), the grid build, the coarse and the fine pass
    (each with its kernel launch), and the whole match through the store
    with its one device→host read."""
    slam, pts, valid, poses = records
    m = slam.front_matcher
    p = m.p
    rows = torch.arange(2, 130, device=dev)
    center = poses[130] + torch.tensor([0.03, -0.02, 0.01], device=dev)
    wp = corr.apply_pose(poses[rows], pts[rows])[None]
    bv = valid[rows][None]
    keep = corr.find_valid_points(wp, bv, center[:2])
    flat = wp.reshape(1, -1, 2), keep.reshape(1, -1)
    grid = corr.build_correlation_grid(p, center[:2], *flat).to(torch.uint8)
    coarse_args = (m.coarse_x, m.coarse_y, m.n_angles_coarse, p.angle_offset,
                   p.angle_res, True)
    coarse = corr.correlate_scan(grid, p, center[:2], center[None], pts[130],
                                 valid[130], *coarse_args)
    fine_args = (m.fine_x, m.fine_y, m.n_angles_fine, m.fine_angle_offset,
                 p.fine_angle_offset, True)
    idx = np.arange(2, 130)[None]
    host = [t.cpu().numpy() for t in (poses[rows][None], pts[130],
                                      valid[130], center)]
    layers = {
        "find_valid_points": lambda: corr.find_valid_points(wp, bv,
                                                            center[:2]),
        "grid build": lambda: corr.build_correlation_grid(p, center[:2],
                                                          *flat),
        "coarse pass": lambda: corr.correlate_scan(
            grid, p, center[:2], center[None], pts[130], valid[130],
            *coarse_args),
        "fine pass": lambda: corr.correlate_scan(
            grid, p, center[:2], coarse.best_pose, pts[130], valid[130],
            *fine_args),
        "whole match and read": lambda: m.match_chains_store(
            pts, valid, idx, host[0], host[1], host[2], host[3]),
    }
    out = []
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out.append(f"{name} {sorted(walls)[2]:.3f} ms")
    print("karto front match layers (wall per call, median of 5): "
          + "; ".join(out), flush=True)


def karto_run(cfg, scans, odom, dev):
    """One ``KartoSLAM.run`` over the recipe; (mapper, accepted indices,
    wall s)."""
    slam = KartoSLAM(cfg, device=dev)
    t0 = time.perf_counter()
    acc = slam.run(scans, odom)
    torch.cuda.synchronize()
    return slam, acc, time.perf_counter() - t0


def phase_karto_main(dev, cfg, scans, odom, gt) -> dict:
    """The counted online Karto run at full width, its rate, stages and
    profile."""
    T = len(gt)
    _dispatch.reset_launches()
    slam, acc, wall = karto_run(cfg, scans, odom, dev)
    launches = dict(_dispatch.LAUNCHES)
    est = slam.trajectory()
    ate = float(ate_rmse(est, gt[acc]))
    solves = slam.timer.counts["solve"]
    print(f"karto main path: scans={T} accepted {len(acc)} (reference "
          f"{KARTO_REF['accepted']}) closures {slam.loop_closures} (reference "
          f"{KARTO_REF['closures']}) edges {slam.solver.num_edges} solves "
          f"{solves} ATE {ate:.5f} m (reference {KARTO_REF['ate']} m, raw "
          f"odometry {float(ate_rmse(odom[acc], gt[acc])):.4f} m) wall "
          f"{wall:.2f} s; launches {launches}", flush=True)
    if est.shape != (len(acc), 3) or not np.all(np.isfinite(est)):
        raise AssertionError("Karto poses are not finite (accepted, 3)")
    if ate > KARTO_ATE_MAX:
        raise AssertionError(f"Karto ATE {ate:.5f} m > {KARTO_ATE_MAX} m")
    if launches["correlative_response"] == 0:
        raise AssertionError("the Karto run launched no correlative kernel")
    route = _route(slam.solver.num_nodes, slam.solver.num_edges, dev,
                   slam.solver.cfg)
    if (slam.loop_closures == 0 or solves == 0 or route != "dense"
            or launches["pcg_lm"] or launches["cr_lm"]):
        raise AssertionError("the Karto solves must take the dense LM, as "
                             "the reference's do on its TPU at this size")
    print("karto stage timer (counted run):\n" + slam.timer.report(),
          flush=True)
    # the counted run warmed the path: 3 timed runs follow it
    walls = [karto_run(cfg, scans, odom, dev)[2] for _ in range(3)]
    rates = sorted(T / w for w in walls)
    print(f"karto: scans/s median {rates[1]:.1f} (min {rates[0]:.1f} max "
          f"{rates[2]:.1f}) over 3 runs after the counted one, {T} scans "
          f"offered per run", flush=True)
    wall_us, busy, per = device_profile(
        lambda: karto_run(cfg, scans, odom, dev))
    print(profile_line(f"karto run ({T} scans)", wall_us, busy, per),
          flush=True)
    return launches


# --- the lesson front-ends and the NN kernel ------------------------------


def masked_pairs(scans):
    """Consecutive pairs of a scan batch as the matchers take them: (src,
    src_valid, tgt, tgt_valid), invalid points at 0, each contiguous."""
    pts = torch.where(scans.valid[..., None], scans.points(), 0.0)
    return (pts[1:].contiguous(), scans.valid[1:].contiguous(),
            pts[:-1].contiguous(), scans.valid[:-1].contiguous())


def lesson_recipe(dev, n: int = LESSON_SCANS):
    """examples/run_plicp_odometry.py's recipe at the full
    ``default_config()`` (360 beams): an office circle of ``n`` scans
    (radius 1.6 m, 0.6 rad/s) in office_world(seed=21) with the path kept
    clear, noise 0.004, seed 4; (cfg, scans on ``dev``, true poses)."""
    cfg = default_config()
    traj = sim.circle_trajectory(n, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=21, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=4)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    return cfg, scans, seq.gt_poses


def scan_matching_recipe(dev, B: int = 120):
    """examples/run_scan_matching.py's recipe: B consecutive pairs of an
    office circle (office_world(seed=11), radius 1.6 m, 0.6 rad/s, noise
    0.004, seed 4); (cfg, the pairs on ``dev``, the true deltas (B, 3))."""
    cfg = default_config()
    traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=4)
    scans = make_scan(seq.ranges, cfg.scan, device=dev)
    return cfg, masked_pairs(scans), gnp.relative(seq.gt_poses[:-1],
                                                  seq.gt_poses[1:])


def nn_bound(B: int, N: int, M: int) -> dict:
    """The NN's least time: each input read once (8 bytes a point, 1 a
    target flag), each output written once (an 8-byte index and a 4-byte
    d2), and 6 float32 operations per source-target pair (two
    differences, a product, an fma, the penalty's add, the compare)."""
    return bound(B * (8 * N + 9 * M + 12 * N), 6.0 * B * N * M)


def nn_compare(label, src, tgt, tv, reps=None) -> dict:
    """The NN kernel against its plain version, equal bit for bit in idx
    and d2; with ``reps``, both times from CUDA events, and
    ``torch.cdist(...).min(-1)``'s for information (it ignores the flags,
    so it is no library time of this function). Returns (the numbers of
    the kernels line, the kernel's indices)."""

    def kern():
        return nearest_neighbor_cuda(src, tgt, tv)

    def plain():
        return nearest_neighbor_direct(src, tgt, tv)

    (ki, kd), (pi, pd) = kern(), plain()
    torch.cuda.synchronize()
    same = torch.equal(ki, pi) and torch.equal(kd.view(torch.int32),
                                                pd.view(torch.int32))
    B, N, _ = src.shape
    M = tgt.shape[1]
    work = nn_bound(B, N, M)
    times = "not timed"
    out = {"max_abs_err": float((kd.double() - pd.double()).abs().max()),
           "ms": None, "plain_ms": None, **work}
    if reps:
        out["ms"], out["plain_ms"] = cuda_ms(kern, reps[0]), cuda_ms(plain,
                                                                     reps[1])
        cdist_ms = cuda_ms(lambda: torch.cdist(src, tgt).min(-1), reps[0])
        times = (f"kernel {out['ms']:.4f} ms plain {out['plain_ms']:.3f} ms "
                 f"(cdist+min {cdist_ms:.4f} ms, for information)")
    print(f"{label}: B={B} N={N} M={M} valid targets {int(tv.sum())} "
          f"idx and d2 bit-equal {same} d2 max {float(kd.max()):.6g}; "
          f"{times} bound {work['bound_ms']:.6f} ms ({work['bound_by']})",
          flush=True)
    if not same or ki.shape != (B, N):
        raise AssertionError(f"{label}: the NN kernel disagrees with its "
                             "plain version")
    return out, ki


def phase_nn(dev) -> dict:
    """The NN kernel against ``nearest_neighbor_direct`` at the odometry's
    shape (1, 360, 360), the scan-matching batch's (120, 360, 360), and
    off them: N ≠ M with odd counts, N = 1, M = 4,096 over four source
    tiles, no valid target, duplicated targets, sources far outside.
    Returns the odometry shape's numbers."""
    _c, scans, _g = lesson_recipe(dev, 2)
    src, _sv, tgt, tv = masked_pairs(scans)
    odo, _i = nn_compare("nn odometry", src, tgt, tv, reps=(500, 50))
    _c, (bs, _bsv, bt, btv), _g = scan_matching_recipe(dev)
    nn_compare("nn scan-matching batch", bs, bt, btv, reps=(50, 5))
    g = torch.Generator().manual_seed(5)

    def pts(*shape, scale=3.0):
        return (torch.randn(*shape, 2, generator=g) * scale).to(dev)

    def flags(*shape):
        return (torch.rand(*shape, generator=g) < 0.8).to(dev)

    nn_compare("edge nn N != M, odd counts", pts(3, 101), pts(3, 77),
               flags(3, 77))
    nn_compare("edge nn N = 1", pts(4, 1), pts(4, 360), flags(4, 360))
    nn_compare("edge nn M = 4,096, 4 source tiles", pts(2, 1000),
               pts(2, 4096, scale=10.0), flags(2, 4096))
    # no valid target: d2 = fl(d + 1e12), whose ulp (65,536) swallows the
    # differences between near targets, so near sources tie at index 0;
    # sources 3 km out still tell targets 30 m apart
    far = pts(2, 360)
    far[:, :180] += 3000.0
    _o, idx = nn_compare("edge nn no valid target", far,
                         pts(2, 360, scale=10.0),
                         torch.zeros((2, 360), dtype=torch.bool, device=dev))
    print(f"edge nn no valid target: index 0 for {int((idx == 0).sum())} "
          f"of {idx.numel()} sources", flush=True)
    # duplicated targets: three copies of 60 points; the first copy wins
    base = torch.round(pts(2, 60))
    sources = torch.round(pts(2, 90) * 2) / 2
    _o, idx = nn_compare("edge nn duplicated targets", sources,
                         torch.cat([base] * 3, dim=1).contiguous(),
                         torch.ones((2, 180), dtype=torch.bool, device=dev))
    if int(idx.max()) >= 60:
        raise AssertionError("duplicated targets: a later copy won")
    nn_compare("edge nn sources far outside", pts(2, 64) + 5e3, pts(2, 300),
               flags(2, 300))
    return odo


def keyframe_steps(model) -> list:
    """Record the scan index of every keyframe switch of a PLICPOdometry."""
    steps, decide, count = [], model._new_keyframe_needed, [0]

    def recording(d_base):
        count[0] += 1
        out = decide(d_base)
        if out:
            steps.append(count[0])
        return out

    model._new_keyframe_needed = recording
    return steps


def lesson_run(model, scans):
    est = model.run(scans)
    torch.cuda.synchronize()
    return est


def phase_lesson_main(dev) -> int:
    """The lesson main paths, each with the launch counters zeroed first:
    ``ICPOdometry.run``, ``PLICPOdometry.run`` and ``ScanMatchPLICP.run``
    over the recipe's 200 scans. Every NN call must launch the kernel
    (199 × 20, 199 × 10 and 199 × 10), each ATE stay within the slack of
    the reference's, and the keyframe count within ±1 of the reference's;
    then each model's scans/s (median of 3 runs after the counted one,
    which warms it) and one run of the first ``LESSON_PROFILE_SCANS``
    under ``torch.profiler`` (its teardown takes several times the run's
    wall at the ~2,300 kernels a scan of PL-ICP launches). Returns the NN launches of the three
    counted runs."""
    cfg, scans, gt = lesson_recipe(dev)
    T = len(gt)
    window = index_scan(scans, slice(0, LESSON_PROFILE_SCANS))
    models = {
        "icp": (lambda: ICPOdometry(cfg, device=dev),
                cfg.icp.max_iterations),
        "plicp": (lambda: PLICPOdometry(cfg, device=dev),
                  cfg.plicp.max_iterations),
        "scan_match": (lambda: ScanMatchPLICP(cfg, device=dev),
                       cfg.plicp.max_iterations),
    }
    total = 0
    for name, (make, rounds) in models.items():
        model = make()
        kf = keyframe_steps(model) if name == "plicp" else None
        _dispatch.reset_launches()
        est = lesson_run(model, scans)
        launches = dict(_dispatch.LAUNCHES)
        ate = float(ate_rmse(est, gt))
        limit = LESSON_ATE_SLACK[0] * LESSON_REF[name] + LESSON_ATE_SLACK[1]
        extra = ""
        if kf is not None:
            differ = sorted(set(kf) ^ set(LESSON_REF_KEYFRAMES))
            extra = (f" keyframes {len(kf)} (reference "
                     f"{len(LESSON_REF_KEYFRAMES)}; steps that differ: "
                     f"{differ})")
        print(f"lesson {name} main path: scans={T} ATE {ate:.6f} m "
              f"(reference {LESSON_REF[name]} m, limit {limit:.6f}){extra}; "
              f"launches {launches}", flush=True)
        if est.shape != (T, 3) or not np.all(np.isfinite(est)):
            raise AssertionError(f"lesson {name}: poses not finite (T, 3)")
        if ate > limit:
            raise AssertionError(f"lesson {name}: ATE {ate:.6f} > {limit:.6f}")
        others = {k: v for k, v in launches.items() if k != "nn" and v}
        if launches["nn"] != (T - 1) * rounds or others:
            raise AssertionError(f"lesson {name}: not every NN call launched "
                                 f"the NN kernel, or another kernel ran")
        if kf is not None and abs(len(kf) - len(LESSON_REF_KEYFRAMES)) > 1:
            raise AssertionError("PLICPOdometry's keyframes differ by > 1")
        total += launches["nn"]
        walls = []
        for _ in range(3):  # the counted run was the warm one
            t0 = time.perf_counter()
            lesson_run(make(), scans)
            walls.append(time.perf_counter() - t0)
        rates = sorted(T / w for w in walls)
        print(f"lesson {name}: scans/s median {rates[1]:.1f} (min "
              f"{rates[0]:.1f} max {rates[2]:.1f}) over 3 runs after the "
              f"counted one", flush=True)
        prof = device_profile(lambda: lesson_run(make(), window))
        print(profile_line(f"lesson {name} run, first {LESSON_PROFILE_SCANS} "
                           "scans", *prof), flush=True)
    return total


def delta_rmse(est: np.ndarray, gt: np.ndarray) -> tuple:
    err = est.astype(np.float64) - gt
    err[:, 2] = np.arctan2(np.sin(err[:, 2]), np.cos(err[:, 2]))
    return (float(np.sqrt((err[:, :2] ** 2).mean())),
            float(np.sqrt((err[:, 2] ** 2).mean())))


def phase_scan_matching(dev) -> int:
    """examples/run_scan_matching.py's 120 pairs in one batch, each matcher
    with the counters zeroed first: ``icp_match`` (20 NN launches),
    ``plicp_match_batch`` (10) and the point-to-point ``_match_fn`` (10,
    the repaired route); the delta RMSE of each against ground truth,
    within the slack of the reference's. Returns the NN launches."""
    cfg, pairs, gt = scan_matching_recipe(dev)
    B = gt.shape[0]
    g = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    p2p = dataclasses.replace(cfg, plicp=dataclasses.replace(
        cfg.plicp, use_point_to_line_distance=False))
    runs = {
        "icp": (lambda: icp_match(*pairs, cfg.icp)[0],
                cfg.icp.max_iterations),
        "plicp": (lambda: plicp_match_batch(cfg)(*pairs, g).pose,
                  cfg.plicp.max_iterations),
        "p2p": (lambda: _match_fn(p2p)(*pairs, g).pose,
                cfg.plicp.max_iterations),
    }
    total = 0
    for name, (fn, rounds) in runs.items():
        fn()
        torch.cuda.synchronize()
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        est = fn().cpu().numpy()
        wall = time.perf_counter() - t0
        launches = dict(_dispatch.LAUNCHES)
        rt, rr = delta_rmse(est, gt)
        ref_t, ref_r = SCAN_MATCH_REF[name]
        lim_t, lim_r = (LESSON_ATE_SLACK[0] * x + LESSON_ATE_SLACK[1]
                        for x in (ref_t, ref_r))
        print(f"scan matching {name}: {B} pairs in one batch, wall "
              f"{wall * 1e3:.2f} ms ({wall * 1e3 / B:.3f} ms/pair); delta "
              f"RMSE {rt:.6f} m {rr:.6f} rad (reference {ref_t} m {ref_r} "
              f"rad); launches {launches}", flush=True)
        others = {k: v for k, v in launches.items() if k != "nn" and v}
        if launches["nn"] != rounds or others:
            raise AssertionError(f"scan matching {name}: the NN kernel did "
                                 "not carry every round")
        if not (np.all(np.isfinite(est)) and rt <= lim_t and rr <= lim_r):
            raise AssertionError(f"scan matching {name}: deltas off")
        total += launches["nn"]
    return total


def undistortion_recipe(dev):
    """examples/run_lidar_undistortion.py's recipe: 80 rolling-shutter scans
    of 360 beams on an office circle (radius 1.2 m, 2.0 rad/s,
    office_world(seed=21)), no noise, seed 3, IMU at 500 Hz and odometry
    at 200 Hz; (cfg, scans and the four streams on ``dev``, the sequence)."""
    cfg = default_config()
    traj = sim.circle_trajectory(80, radius=1.2, angular_rate=2.0)
    world = sim.office_world(seed=21, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.0, seed=3,
                                motion_distortion=True, imu_rate_hz=500.0,
                                odom_rate_hz=200.0)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    streams = tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                    for a in (seq.imu_stamps, seq.imu_omega, seq.odom_stamps,
                              seq.odom_poses))
    return cfg, scans, streams, seq


def first_beam_truth(cfg, raw: torch.Tensor, seq) -> np.ndarray:
    """The example's ground truth for all scans but the last: each beam's
    world endpoint from its own interpolated true pose, in the frame of
    the first beam; (T - 1, N, 2). ``raw`` holds the laser points on the
    CPU."""
    n = cfg.scan.num_beams
    out = []
    for t in range(raw.shape[0] - 1):
        bt = seq.stamps[t] + cfg.scan.scan_period / n * np.arange(n)
        i = np.clip(np.searchsorted(seq.stamps, bt, side="right") - 1, 0,
                    len(seq.stamps) - 2)
        alpha = (bt - seq.stamps[i]) / cfg.scan.scan_period
        poses = geo.interpolate(
            *(torch.as_tensor(np.asarray(a, np.float32))
              for a in (seq.gt_poses[i], seq.gt_poses[i + 1], alpha)))
        world = geo.apply(poses, raw[t][:, None, :])[:, 0, :]
        out.append(geo.apply(geo.inverse(poses[0]), world))
    return torch.stack(out).numpy()


def phase_undistortion(dev) -> int:
    """Undistortion feeding the matcher, with the counters zeroed first:
    the 80 scans corrected in one call, the corrected-against-raw endpoint
    error (the example's check: < 0.25), PL-ICP deltas on the corrected
    and on the raw points (tests/test_undistort.py's check: rotation < 0.5
    and translation < 0.7 of the raw ones), and the correction's wall per
    scan (median of 3 after a warm one). Returns the NN launches."""
    cfg, scans, streams, seq = undistortion_recipe(dev)
    T = scans.ranges.shape[0]
    _dispatch.reset_launches()
    cor = undistort_scan(scans, *streams)
    raw_pts = torch.where(scans.valid[..., None], scans.points(), 0.0)
    gt_d = gnp.relative(seq.gt_poses[:-1], seq.gt_poses[1:])
    v = scans.valid

    def deltas(p):
        return delta_rmse(plicp_match(p[1:], v[1:], p[:-1], v[:-1],
                                      cfg.plicp).pose.cpu().numpy(), gt_d)

    (raw_t, raw_r), (cor_t, cor_r) = deltas(raw_pts), deltas(cor)
    torch.cuda.synchronize()
    launches = dict(_dispatch.LAUNCHES)
    truth = first_beam_truth(cfg, scans.points().cpu(), seq)
    m = v.cpu().numpy()[:-1]
    raw_err = np.linalg.norm(scans.points().cpu().numpy()[:-1] - truth,
                             axis=-1)[m].mean()
    cor_err = np.linalg.norm(cor.cpu().numpy()[:-1] - truth, axis=-1)[m].mean()
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        undistort_scan(scans, *streams)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ms = sorted(walls[1:])[1] * 1e3
    print(f"undistortion: {T} scans, endpoint error raw {raw_err:.5f} m "
          f"corrected {cor_err:.5f} m (ratio {cor_err / raw_err:.4f}); PL-ICP "
          f"delta RMSE raw {raw_t:.5f} m {raw_r:.5f} rad, corrected "
          f"{cor_t:.5f} m {cor_r:.5f} rad; correction wall {ms:.3f} ms per "
          f"batch, {ms / T:.4f} ms per scan; launches {launches}", flush=True)
    if not cor_err < 0.25 * raw_err:
        raise AssertionError("undistortion: the correction does not help")
    if not (cor_r < 0.5 * raw_r and cor_t < 0.7 * raw_t):
        raise AssertionError("undistortion: corrected deltas do not beat raw")
    if launches["nn"] != 2 * cfg.plicp.max_iterations:
        raise AssertionError("undistortion: the matcher's NN calls did not "
                             "launch the kernel")
    return launches["nn"]


def phase_features(dev) -> None:
    """examples/run_feature_detection.py's 120 scans in one call: the card's
    corner masks equal the port's on the CPU, the mean count per scan is
    within 0.5% of the reference's CPU run, and the call's wall per scan
    (median of 3 after a warm one)."""
    cfg = default_config()
    traj = sim.circle_trajectory(120, radius=1.6, angular_rate=0.5)
    world = sim.office_world(seed=9, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.003,
                                seed=2)
    scans = make_scan(seq.ranges, cfg.scan, device=dev)
    mask = extract_corner_features(scans, cfg.features)
    host = extract_corner_features(make_scan(seq.ranges, cfg.scan,
                                             device="cpu"), cfg.features)
    same = torch.equal(mask.cpu(), host)
    mean = float(mask.sum(-1).double().mean())
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        extract_corner_features(scans, cfg.features)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ms = sorted(walls[1:])[1] * 1e3
    T = mask.shape[0]
    print(f"features: {T} scans, corners per scan mean {mean:.3f} "
          f"(reference {FEATURES_REF_MEAN:.3f}) min {int(mask.sum(-1).min())} "
          f"max {int(mask.sum(-1).max())}; masks equal to the CPU's {same}; "
          f"wall {ms:.3f} ms per batch, {ms * 1e3 / T:.1f} us per scan",
          flush=True)
    if not same:
        raise AssertionError("features: the card's masks differ from the "
                             "CPU's")
    if abs(mean - FEATURES_REF_MEAN) > FEATURES_MEAN_RTOL * FEATURES_REF_MEAN:
        raise AssertionError("features: mean count off the reference's")


def bench_ring(M: int):
    """bench_solver's ring (benchmarks/bench_solver.py, seed 0): M nodes on
    a circle of 10 m, the drifting odometry as the initial guess, an edge
    between neighbours and closures every 16 nodes across the circle (from
    both ends, so the pair's second slot bank fills), information
    diag(50, 50, 100). Returns (init, edges)."""
    rng = np.random.default_rng(0)
    th = np.linspace(0, 2 * np.pi, M, endpoint=False)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2], -1)
    init = gt + np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], (M, 3)), 0)
    pairs = [(i, (i + 1) % M) for i in range(M)]
    pairs += [(i, (i + M // 2) % M) for i in range(0, M, 16)]
    ei, ej = np.array(pairs).T
    info = np.diag([50.0, 50.0, 100.0])
    return init, [(i, j, m, info) for i, j, m in
                  zip(ei, ej, gnp.relative(gt[ei], gt[ej]))]


def skip_graph(n: int, strides=(8, 32), seed: int = 11):
    """tests/test_pose_graph.py's mixed f64 graph at ``n`` nodes: a noisy
    chain along a circle of 8 m with skip edges at ``strides``; with a
    stride past the band cap it does not band. Returns (init, edges)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    rels = gnp.relative(gt[:-1], gt[1:])
    edges = [(i, i + 1, rels[i] + rng.normal(0, 0.01, 3)) for i in range(n - 1)]
    for s in strides:
        rl = gnp.relative(gt[:-s], gt[s:])
        edges += [(i, i + s, rl[i] + rng.normal(0, 0.004, 3))
                  for i in range(0, n - s, s)]
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    info = np.diag([1e4, 1e4, 4e4])
    return np.asarray(init), [(i, j, m, info) for i, j, m in edges]


def cr_work(spec, pT8, slots, n_edges: int, iters: int) -> dict:
    """``phase_cr``'s bound of a CR-LM solve: its inputs read and result
    written once, and per LM iteration the edge work plus, per supernode
    of n = 3W, the Cholesky (n³/3), D⁻¹[Bprevᵀ | B | r] (~4n³) and the
    two Schur updates (~4n³)."""
    n = 3 * spec.W
    return bound(4 * (2 * pT8.numel() + slots.numel()),
                 iters * (lm_edge_flops(n_edges)
                          + spec.K * (n ** 3 / 3 + 8 * n ** 3)))


STREAM_SHORT_ITERS = 3  # the like-for-like comparison of a whole LM step


def streamed_compare(label: str, dev, poses, edges, reps: int = 3) -> dict:
    """The streamed CR-LM kernel against its plain version (``cr_lm_plain``)
    on a graph's ``direct_inputs``. After STREAM_SHORT_ITERS iterations
    the poses must agree within LM_POSE_TOL (headings wrapped) and the
    costs within LM_COST_RTOL. After the solve's 40 the final χ² must both
    be ≤ 1e-6 × cost0 or within LM_COST_RTOL, and the poses within
    LM_POSE_TOL where both solves converged (‖δ‖² under its floor before
    the iteration cap). A ring of 16,384 nodes or more uses all 40: its
    soft bending modes keep the float32 rounding of each step, which the
    two sum orders make differently (the plain version in float32 and in
    float64 part too, more with every iteration:
    tests/test_torch_cr_stream.py::test_float32_spread_grows_on_a_large_ring),
    so there the poses are printed, not held. Prints
    both times of the full solve (the kernel's over ``reps`` runs after a
    warm one, the plain version's one run, warmed by the short one), the
    kernels the wrapper enqueues per solve and the bound; returns them
    with max_abs_err, the full solves' pose gap where both converged,
    else the short runs'."""
    cfg = SolverConfig()
    spec, pT8, slots = solver_from_numpy(cfg, poses, edges, dev).direct_inputs()

    def run(solve, iters):
        return solve(pT8, slots, cfg.initial_lambda, W=spec.W, K=spec.K,
                     iters=iters,
                     sq_min_delta=_sq_min_delta(cfg.convergence_delta))

    def gap(k, p):
        return float(pose_gap(k[0:3].T, p[0:3].T).max())

    k, p = (run(f, STREAM_SHORT_ITERS) for f in (streamed_cr_lm, cr_lm_plain))
    short = gap(k, p)
    short_ok = (short <= LM_POSE_TOL and abs(float(k[3, 1]) - float(p[3, 1]))
                <= LM_COST_RTOL * float(p[3, 1]))
    T = cfg.max_iterations
    k = run(streamed_cr_lm, T)
    # the plain version's one full run, warmed by the short one, is timed
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    p = run(cr_lm_plain, T)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    dpose = gap(k, p)
    c0, kc, pc = float(k[3, 0]), float(k[3, 1]), float(p[3, 1])
    iters = int(k[3, 3])
    converged = iters < T and int(p[3, 3]) < T
    ok = (short_ok and bool(torch.isfinite(k).all())
          and (dpose <= LM_POSE_TOL or not converged)
          and (max(kc, pc) <= 1e-6 * c0 or abs(kc - pc) <= LM_COST_RTOL * pc))
    ms = cuda_ms(lambda: run(streamed_cr_lm, T), reps)
    per_iter = 3 * (spec.K.bit_length() - 1) + 6
    work = cr_work(spec, pT8, slots, len(edges), iters)
    print(f"{label}: nodes={len(poses)} edges={len(edges)} W={spec.W} "
          f"K={spec.K} after {STREAM_SHORT_ITERS} iterations pose max|d|="
          f"{short:.3e}; after {T}: pose max|d|={dpose:.3e} cost0 {c0:.6g} "
          f"cost kernel {kc:.6g} plain {pc:.6g} iters kernel {iters} plain "
          f"{int(p[3, 3])} good {int(k[3, 2])}/{int(p[3, 2])}; kernel {ms:.3f} "
          f"ms plain {plain_ms:.3f} ms bound {work['bound_ms']:.5f} ms "
          f"({work['bound_by']}); one wrapper launch enqueues "
          f"{4 + T * per_iter} kernels, {per_iter} per LM iteration, of which "
          f"{4 + iters * per_iter} run", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the streamed CR-LM kernel disagrees "
                             "with its plain version")
    return {"max_abs_err": dpose if converged else short, "ms": ms,
            "plain_ms": plain_ms, **work}


def phase_cr_stream(dev) -> dict:
    """The streamed CR-LM kernel against its plain version on bench_solver's
    rings of 4,096 (K 1,024) and 16,384 nodes (K 4,096), then on edge
    cases: W = 2 (a plain 200-node ring, K 128), W = 8 (a 300-node chain
    with stride-7 skip edges, K 128) and 32,768 nodes (K 8,192). Returns
    the 4,096-node ring's numbers, the larger ring whose two solves both
    converge (its max_abs_err the full solves' pose gap)."""
    out = streamed_compare("cr_stream ring", dev, *bench_ring(4096))
    streamed_compare("cr_stream ring", dev, *bench_ring(16384))
    init, ei, ej, means, infos = _ring_edges(200, 0, np.random.default_rng(23))
    streamed_compare("edge cr_stream W=2 ring", dev, init,
                     list(zip(ei, ej, means, infos)))
    streamed_compare("edge cr_stream W=8 skip chain", dev,
                     *skip_graph(300, strides=(7,), seed=29))
    streamed_compare("edge cr_stream ring", dev, *bench_ring(32768),
                     reps=2)
    return out


def phase_cr_both(dev) -> None:
    """Both CR-LM kernels on the same inputs, where both take them: the
    1,024-node bench graph (K 256) and a 3,072-node bench_solver ring at
    K 512, the largest K the single-launch kernel's route takes. They
    must agree as ``streamed_compare``'s full solves do."""
    cfg = SolverConfig()
    for label, (poses, edges) in (("bench graph", bench_graph()),
                                  ("ring", bench_ring(3072))):
        spec, pT8, slots = solver_from_numpy(cfg, poses, edges,
                                             dev).direct_inputs()
        kw = dict(W=spec.W, K=spec.K, iters=cfg.max_iterations,
                  sq_min_delta=_sq_min_delta(cfg.convergence_delta))

        def single():
            return fused_cr_lm(pT8, slots, cfg.initial_lambda, **kw)

        def streamed():
            return streamed_cr_lm(pT8, slots, cfg.initial_lambda, **kw)

        a, b = single(), streamed()
        torch.cuda.synchronize()
        d = float(pose_gap(a[0:3].T, b[0:3].T).max())
        c0, ca, cb = float(a[3, 0]), float(a[3, 1]), float(b[3, 1])
        converged = max(int(a[3, 3]), int(b[3, 3])) < cfg.max_iterations
        ms_a, ms_b = cuda_ms(single, 2), cuda_ms(streamed, 3)
        print(f"cr_lm and cr_stream on the {label}: nodes={len(poses)} "
              f"W={spec.W} K={spec.K} pose max|d|={d:.3e} cost0 {c0:.6g} "
              f"cost {ca:.6g} / {cb:.6g} iters {int(a[3, 3])} / "
              f"{int(b[3, 3])}; cr_lm {ms_a:.3f} ms cr_stream {ms_b:.3f} ms",
              flush=True)
        if not ((d <= LM_POSE_TOL or not converged)
                and (max(ca, cb) <= 1e-6 * c0
                     or abs(ca - cb) <= LM_COST_RTOL * ca)):
            raise AssertionError(f"{label}: the two CR-LM kernels disagree")


def phase_large_graph_main(dev) -> dict:
    """The large-graph main path, with the launch counters zeroed first:
    ``PoseGraphSolver.compute`` on bench_solver's rings of 4,096 and 16,384
    nodes. Each solve must launch the streamed CR-LM kernel once and no
    other LM kernel, and end at χ² ≤ 1e-6 × cost0; then each one's solve
    ms (median of 3 warm runs, the poses reset between runs as
    bench_solver does) and one 16,384-node solve under ``torch.profiler``.
    Returns the counted launches."""
    cfg = SolverConfig()
    rings = {M: bench_ring(M) for M in (4096, 16384)}
    solvers = {M: solver_from_numpy(cfg, *g, dev) for M, g in rings.items()}

    def reset(M):
        for i, p in enumerate(rings[M][0]):
            solvers[M].set_node_pose(i, p)

    _dispatch.reset_launches()
    stats = {M: s.compute() for M, s in solvers.items()}
    torch.cuda.synchronize()
    launches = dict(_dispatch.LAUNCHES)
    print(f"large-graph main path: launches {launches}", flush=True)
    if launches["cr_stream"] != len(rings) or any(
            v for k, v in launches.items() if k != "cr_stream"):
        raise AssertionError("a large-graph solve did not run the streamed "
                             "CR-LM kernel alone")
    for M, st in stats.items():
        poses = solvers[M].get_poses()
        walls = []
        for _ in range(3):
            reset(M)
            t0 = time.perf_counter()
            solvers[M].compute()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"large-graph solve {M} nodes: cost {st.initial_cost:.6g} -> "
              f"{st.final_cost:.6g} ({st.iterations} good iterations); solve "
              f"ms median {sorted(walls)[1]:.3f} (min {min(walls):.3f} max "
              f"{max(walls):.3f}) over 3 warm runs", flush=True)
        if not (np.all(np.isfinite(poses))
                and st.final_cost <= 1e-6 * st.initial_cost):
            raise AssertionError(f"{M}-node ring: χ² did not reach ~0")
    reset(16384)
    prof = device_profile(lambda: solvers[16384].compute())
    print(profile_line("large-graph solve, 16,384 nodes", *prof), flush=True)
    return launches


def phase_host_f64(dev) -> None:
    """The host f64 arm on the card's machine: a 3,200-node skip-edge graph
    (tests/test_pose_graph.py's shape) does not band and passes
    ``f64_schur_above`` (3,000), so ``PoseGraphSolver`` on the card solves
    it in float64 on the host and launches nothing."""
    cfg = SolverConfig()
    s = solver_from_numpy(cfg, *skip_graph(3200), dev)
    route = _route(s.num_nodes, s.num_edges, dev, cfg, s._band_spec)
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    st = s.compute()
    wall = time.perf_counter() - t0
    launches = sum(_dispatch.LAUNCHES.values())
    print(f"host f64 arm: nodes={s.num_nodes} edges={s.num_edges} route "
          f"{route}; cost {st.initial_cost:.6g} -> {st.final_cost:.6g} "
          f"({st.iterations} good iterations); wall {wall:.3f} s; kernel "
          f"launches {launches}", flush=True)
    if route != "host_f64" or launches or not (
            np.all(np.isfinite(s.get_poses()))
            and st.final_cost < st.initial_cost):
        raise AssertionError("the 3,200-node skip-edge graph did not solve "
                             "on the host f64 arm alone")


def phase_offline_corrected(dev) -> int:
    """``offline_slam(corrected_pts=...)`` on the 80-scan undistortion
    recipe, with the counters zeroed first: the mission on raw points and
    on ``undistort_mission``'s. Every match (the chain, each loop round)
    must launch the PL-ICP kernel once, and the corrected chain's ATE must
    beat the raw one's. Returns the PL-ICP launches."""
    cfg, scans, _streams, seq = undistortion_recipe(dev)
    corrected = offline.undistort_mission(
        scans, seq.imu_stamps, seq.imu_omega, seq.odom_stamps, seq.odom_poses)
    timers = {"raw": StageTimer(), "corrected": StageTimer()}
    _dispatch.reset_launches()
    runs = {name: offline_slam(scans, cfg, odom=seq.gt_poses, timer=timer,
                               corrected_pts=corrected if name != "raw"
                               else None)
            for name, timer in timers.items()}
    torch.cuda.synchronize()
    launches = dict(_dispatch.LAUNCHES)
    matches = sum(t.counts["chain_match"] + t.counts["loop_match"]
                  for t in timers.values())
    ate = {name: (float(ate_rmse(r.chain_poses, seq.gt_poses)),
                  float(ate_rmse(r.poses, seq.gt_poses)))
           for name, r in runs.items()}
    print(f"offline corrected_pts: {scans.ranges.shape[0]} scans; chain ATE "
          f"raw {ate['raw'][0]:.5f} m corrected {ate['corrected'][0]:.5f} m; "
          f"final ATE raw {ate['raw'][1]:.5f} m corrected "
          f"{ate['corrected'][1]:.5f} m; loops raw {len(runs['raw'].loops)} "
          f"corrected {len(runs['corrected'].loops)}; matches {matches}; "
          f"launches {launches}", flush=True)
    if launches["plicp_fused"] != matches:
        raise AssertionError("offline corrected_pts: not every match ran the "
                             "PL-ICP kernel")
    if not ate["corrected"][0] < ate["raw"][0]:
        raise AssertionError("offline corrected_pts: the corrected chain "
                             "does not beat the raw one")
    return launches["plicp_fused"]


class PhaseClock:
    """Prints the wall of each group of phases and the running total, so
    that a run shows where its time limit goes."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"[time] {label}: {now - self.last:.1f} s ({now - self.start:.1f}"
              f" s in all)", flush=True)
        self.last = now


def main() -> None:
    clock = PhaseClock()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    clock("device and build")
    plicp = phase_plicp(dev)
    cr = phase_cr(dev)
    phase_edge_cases(dev)
    clock("PL-ICP, CR-LM and edge cases")
    stream = phase_cr_stream(dev)
    phase_cr_both(dev)
    large_launches = phase_large_graph_main(dev)
    phase_host_f64(dev)
    phase_offline_corrected(dev)
    clock("large pose graphs, host f64 arm, corrected mission")
    cfg, scans, odom, res, launches, batches = phase_main_path(dev)
    phase_mission_batches(cfg, res.poses.shape[0], batches)
    pcg = phase_pcg(dev, res)
    phase_mission_rate(cfg, scans, odom)
    phase_profile(cfg, scans, odom)
    clock("mission")
    hector = phase_hector(dev)
    phase_hector_edges(dev)
    hector_launches = phase_hector_main(dev)
    clock("Hector")
    kcfg, kscans, kodom, kgt = karto_recipe(dev)
    resp, records, front = phase_correlative(dev, kcfg, kscans, kgt)
    phase_correlative_edges(dev, records, front)
    phase_karto_layers(dev, records)
    clock("correlative kernel")
    karto_launches = phase_karto_main(dev, kcfg, kscans, kodom, kgt)
    clock("online Karto")
    nn = phase_nn(dev)
    clock("NN kernel")
    nn_launches = phase_lesson_main(dev)
    clock("lesson odometry")
    nn_launches += phase_scan_matching(dev)
    nn_launches += phase_undistortion(dev)
    phase_features(dev)
    clock("scan matching, undistortion, features")
    kernels = [
        {"name": "plicp_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/plicp_fused.cu",
         "replaces": "tpu_slam/ops/pallas/plicp_fused.py:585",
         "launches": launches["plicp_fused"], **plicp},
        {"name": "cr_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/cr_lm.cu",
         "replaces": "tpu_slam/solver/pallas_cr_lm.py:573",
         "launches": launches["cr_lm"], **cr},
        {"name": "cr_stream", "route": "cuda",
         "source": "tpu_slam_torch/csrc/cr_stream.cu",
         "replaces": "tpu_slam/solver/cr_stream.py:529",
         "launches": large_launches["cr_stream"], **stream},
        {"name": "pcg_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/pcg_lm.cu",
         "replaces": "tpu_slam/solver/pallas_lm.py:384",
         "launches": launches["pcg_lm"], **pcg},
        {"name": "hector_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/hector_fused.cu",
         "replaces": "tpu_slam/ops/pallas/hector_fused.py:269",
         "launches": hector_launches, **hector},
        {"name": "correlative_response", "route": "cuda",
         "source": "tpu_slam_torch/csrc/correlative_response.cu",
         "replaces": "tpu_slam/ops/pallas/correlative_response.py:160",
         "launches": karto_launches["correlative_response"], **resp},
        {"name": "nn", "route": "cuda", "source": "tpu_slam_torch/csrc/nn.cu",
         "replaces": "tpu_slam/ops/pallas/nn.py:50",
         "launches": nn_launches, **nn},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
