"""Quickest proof that the PyTorch/CUDA port (``tpu_slam_torch``) runs on
the GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; imports no JAX
and nothing of the JAX package. Phases, each printing its own line(s):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the eight kernels from ``tpu_slam_torch/csrc``, one nvcc per
     source, all started together;
  3. the PL-ICP kernel against its plain version on 512 scan pairs of 360
     beams (the bench PL-ICP batch): its device time per launch from a
     replayed CUDA graph of its launches (the wrapper's host µs per call
     beside it), the launch geometry (``plicp_geometry``), the rounds
     each pair ran (the dependent steps: max and mean) and µs a round of
     the longest pair, the design's barriers a round, the bound counted
     from the work the pairs' rounds need (``plicp_ops``: the target
     tiles each source's nearest neighbour must scan at each round's
     pose), and the plain version's time;
  4. the CR-LM kernel against its plain version on the 1,024-node bench
     pose graph, with both times and the solve's dependent steps (LM
     iterations × levels) and time per step, then all three kernels
     against their plain versions on edge cases (odd beam counts, N ≠ M,
     invalid and non-finite beams; the CR-LM's launch geometry at W = 1,
     2, 6 and 8, K = 32 (one block), 128, 256 and 512 (W 8 × K 512: the
     largest shared-memory slices); a 3-node graph), and the PL-ICP
     kernel at one chunk's ends (N 1,024 × M 4,096: shared memory above
     48 KB), past them in chunks of sources and of staged targets (N
     1,081 × M 1,081, 1,081 × 5,000, 4,097 × 12,345 and 20,000 × 1,081,
     whose gathered lists go to device scratch; the plain version with
     the kernel's direct-form NN there, since at 5,000 beams and more
     the expanded form's rounding splits near-ties), at N = 1, on
     degenerate pairs (an all-invalid target, a source of 2 valid beams,
     a straight wall whose residuals all tie) and on one batch whose
     pairs converge in round 1 beside pairs that run all 10;
  5. the main path, with the launch counters zeroed first: the offline
     Karto mission (3 laps of the corridor world, 360 beams) through
     ``offline_slam``, then the bench pose graph through
     ``PoseGraphSolver.compute``. Every match must run the PL-ICP kernel
     and every solve an LM kernel (the mission's loop-closed graphs do not
     band, so they take the PCG-LM; the bench graph takes the CR-LM), and
     the mission ATE must stay ≤ 5 mm, and each loop-candidate sweep
     (``candidates`` stage) must launch the loop-sweep kernel once. The
     run records the mission's chain batch, its first loop-selector batch
     and every sweep's inputs and picks;
  6. the PL-ICP kernel against its plain version on those two batches:
     chain poses and trajectory within tolerance, the same accept flags
     and selected rows from the loop selector; the kernel alone on each
     batch timed as in 3, with its own bound, and both matchers' times;
 6b. the loop-sweep kernel against its plain version, on the card and on
     the CPU, on every sweep the counted mission made (round 1, and round
     2 with the pairs round 1 tried): the same picks and live cells from
     all three, and the picks the mission took; then on the first and
     the last sweep the kernel's device time per sweep by launch (cells,
     select; profiler), the wall of a sweep with the poses' upload and
     the read-back (as the ``candidates`` stage takes it) for the kernel
     and for the plain version on the card, the plain version's wall on
     the CPU, and the bound;
  7. the PCG-LM kernel against its plain version on the mission's
     loop-closed graph, with both times and the PCG iterations run (the
     dependent steps) and time per step; then at the ends of its route:
     129 nodes (one block), the 2,999-node chain with skip edges (six
     blocks, the most nodes under ``f64_schur_above``) and the same at
     9,000 nodes with ``f64_schur_above`` off (the device-memory
     variant);
 7b. restarted CG: the PCG-LM kernel at restarts = 1 on the mission
     graph, bit for bit phase 7's result and timed in turns with it; at
     restarts = 2 against its plain version to the PCG bars; then
     ``PoseGraphSolver.compute`` on bench_solver's 4,096-node ring on the
     PCG route (``use_direct=False``, ``f64_schur_above=0``) at
     ``cg_restarts`` 1 and 2, the counters zeroed first (one PCG-LM
     launch each): the final cost at 2 no higher than at 1, the LM and
     PCG iterations and the solve ms of each;
  8. the mission's scans/s (median of 3 runs after the warm one);
  9. one mission under ``torch.profiler``: device busy time, idle share
     and each kernel's device time per launch;
  9b. the Schur routes (``phase_schur``; plain PyTorch, no kernel), each
     solve with the launch counters zeroed first (none may launch):
     ``use_schur`` on the mission's loop-closed graph from its chain
     (two runs bit-equal; the first 3 LM iterations within 1e-3 of the
     CPU's run of the same route; its final cost beside the PCG-LM
     kernel's on that graph; solve ms, median of 3 warm runs), on
     bench_solver's 4,096-node ring with ``f64_schur_above`` off (solve
     ms and cost beside phase 21's streamed CR-LM solve of it), and
     ``host_direct_fallback=False`` on phase 22's 3,200-node skip graph:
     the float64 LM on the card at the reference's λ floor (its good
     iterations and cost those of the reference's CPU run) and with the
     floor off (poses within 5e-5 and cost within 1e-6 relative of the
     host f64 arm's), the wall of each, the partition's separators and
     factor sizes;
 10. the Hector kernel against its plain version at full width
     (``default_config()``: 1,024² grid, 3 levels, 360 beams) on
     bench_hector's map and scan, with its device time per match from a
     replayed CUDA graph (the wrapper's host µs beside it), its geometry
     (``hector_geometry``), the GN steps (the dependent steps) and µs a
     step, and the plain version's time, then on edge cases (100, 1,080
     and 5,000 beams, no valid beam, a pose by the map's edge, 1 and 4
     levels);
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
     the launch geometry (``response_geometry``: the row or byte path,
     candidates a thread, warps, blocks, strips a tile, beam slices; no
     cluster), the nodes of one pass's CUDA graph (one kernel, no
     memset), the kernel's device time from a replayed CUDA graph, the
     plain version's, and the bound with its bytes and operations terms
     (one 32-bit add per two candidates of a valid beam);
 13. the same on edge cases: windows clamped at every grid edge, starts
     below 0, past the edge and all at the far edge, no valid beam (and a
     match without one, which takes the response expansion), 1, 656,
     1,500 and 4,000 beams (4,000 also at the loop shape, eight staged
     rounds, with one lane's grid all 100), odd nx at stride 1
     and 2, a 1 × 1 lattice, 8 lanes with their own flags (lane stride N,
     one lane with none valid) and with one scan's (lane stride 0), and a
     grid whose base is not 8-byte aligned;
 14. the wall of each layer of one front-end match at that shape
     (``find_valid_points``, grid build, coarse and fine pass, the whole
     match and its read), then the online Karto main path, with the
     launch counters zeroed first:
     ``KartoSLAM.run`` over the recipe's 352 scans at the full width.
     Every match must run the correlative kernel. Every solve takes the
     dense LM and no LM kernel: the graphs (≤ 126 nodes, 127 edges) fail
     the reference's shape test for its fused LM, as on its TPU. The ATE
     must stay ≤ 0.01 m; then ``karto_map`` of the counted run (its wall,
     its cells; int8-equal to the CPU's map from the same corrected
     poses), its scans/s (one run after the counted one, which warms it),
     the stage timer, and a run of its first 50 scans under
     ``torch.profiler``;
     then the native library: it must build with g++ and load, and
     ``occupancy_from_scans(engine="native")`` (the C++ host rasterizer)
     must give the device engine's map, int8 for int8, on the counted
     run's final state, both engines' ms beside the card's name and power
     limit;
 14a. the float64 solver (``phase_f64``; plain PyTorch, no kernel):
     ``PoseGraphSolver(dtype=torch.float64)`` on the online Karto run's
     final graph ("dense"), the mission's loop-closed graph from its
     chain ("dense" at ``use_dense_below=2048``, a 3,168² float64 factor
     a step; "cg" at ``cg_restarts`` 1 and 2; "schur" with
     ``use_schur``) and bench_solver's 4,096-node ring ("cg"), each with
     the counters zeroed first: the named route, a float64 result on
     ``cuda``, no launch, poses within 1e-8 and cost within 1e-9
     relative of the port's CPU run of the same route (1e-6 and 1e-8 for
     "cg"), the final cost beside the float32 route's on the same graph
     and the host f64 arm's optimum, and the solve ms (median of 3 runs;
     the ring's of one);
 14b. the outdoor offline mission, with the launch counters zeroed
     first: benchmarks/bench_outdoor.py's 1-lap recipe (3,234 scans of
     360 beams, ``preset("karto_outdoor")``, no cut) through
     ``offline_slam`` once after a 600-scan warm-up: its wall and
     scans/s, the stage timer, the skip edges, anchors and loops
     accepted, the solves' route, the chain and final ATE (final ≤ 0.01 m
     and below the chain's; ≥ 1 skip edge, ≥ 1 anchor, ≥ 4 loops; the
     PL-ICP and correlative kernels launched, the loop-sweep kernel once
     a sweep); the loop-sweep kernel against its plain version on every
     sweep of the run, as in 6b, untimed; then the correlative
     kernel int32 for int32 against its plain version on one anchor
     group of each level, coarse and fine pass, at the final poses;
 14c. the online outdoor run, with the launch counters zeroed first:
     the same recipe through ``KartoSLAM.run`` and ``flush`` once
     (bench_outdoor.py --online, the synchronous back end): its wall and
     scans/s, accepted scans, closures, the solves by route (each the
     route ``_route`` gives for its size; graphs past 128 nodes take the
     PCG-LM or CR-LM kernels), the stage timer, launches and the ATE
     (≤ 0.05 m and below the raw odometry's; ≥ 1 closure, ≥ 1 LM
     kernel launch); then the correlative kernel int32 for int32 on a
     front coarse, a front fine and a loop coarse pass recorded from the
     final state, the LM kernel of the largest kernel solve against its
     plain version on that graph, ``karto_map`` of the result (its wall
     and cells; on the card and the CPU int8-equal on a stride of the
     scans whose CPU run takes ~25 s) and a profile of the run's first
     25 scans;
 14d. GMapping at full width (examples/run_gmapping.py: 352 scans, the
     1,024² grid): hits and visits equal to the CPU's run, cell means
     within 1e-5 relative, the same map, > 200 occupied and > 10,000
     free cells; its scans/s (median of 3 runs after a warm one);
 15. the NN kernel against its plain version
     (``ops/matching.nearest_neighbor_direct``), bit for bit in indices
     and distances, at the odometry's shape (1 × 360 × 360) and the
     scan-matching batch's (120 × 360 × 360), with the kernel's device
     time per launch from a replayed CUDA graph of its launches (the
     wrapper's host µs per call beside it), the plain version's time and
     the bound, then on edge cases (N ≠ M with odd counts, N = 1,
     M = 4,096 over many source tiles, no valid target, duplicated
     targets, sources far outside), on each path of ``nn_geometry``
     (32 lanes a source with M = 7 < 32, M = 37 not a multiple of the
     lanes, one lane a source with N = 361), on the reference's NaN
     rule (NaN sources, NaN targets: index M, d2 NaN) and past one
     staged chunk of 4,096 targets (M 5,000 and 12,345, a copy of the
     first chunk in the second, NaN sources and targets);
 16. the lesson main paths over examples/run_plicp_odometry.py's 200
     scans at 360 beams, each with the launch counters zeroed first:
     ``ICPOdometry.run``, ``PLICPOdometry.run`` and ``ScanMatchPLICP.run``.
     Every NN call must launch the NN kernel (199 × 20, 199 × 10 and
     199 × 10), each ATE stay ≤ 1.1 × the reference's CPU run + 1 mm, and
     PLICPOdometry's keyframes within ±1 of the reference's; then each
     one's scans/s and a run of its first 20 scans under
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
 19a. the examples (``tpu_slam_torch/examples``), each
     ``main([])`` once on the card at its own recipe, the launch counters
     zeroed first: its figures against those the reference example prints
     on the CPU (``EXAMPLES_REF``: counts equal where the card computes
     them exactly, accuracies within the lesson phases' slack, map cells
     within 3%), and its model's kernels launched;
 19b. the command line over bags (``cli.main``), each run with the launch
     counters zeroed first: bags written with ``data/rosbag.write_bag``
     from the online Karto recipe (bz2), the Hector recipe and the bench
     mission, read back bit for bit by the native decoder, replayed as
     ``karto --bag`` (with ``--save-map`` and ``--checkpoint``),
     ``odometry --bag``, ``hector --bag`` and ``offline --bag`` at full
     width; ``gmapping`` and ``features`` with ``--sim``. Each run equal
     to a direct call of its model on the same decoded scans, its kernels
     by name, its ATE against the recipe's truth, wall and scans/s; the
     map and the Karto and Hector checkpoints read back (the reloaded
     Hector mapper steps to the original's pose), and one ``offline
     --bag`` run under ``utils/profiling.device_trace`` whose Chrome trace
     names the PL-ICP, PCG-LM and loop-sweep kernels;
 19c. the multi-device layer (``phase_mesh``), ranks spawned from this
     script (``torch.multiprocessing``, spawn): (a) one rank over NCCL,
     (b) two ranks sharing the card over gloo (NCCL refuses two ranks on
     one card), each rank with the launch and collective counters zeroed
     before each run: the sharded packed matcher on the 512-pair batch
     (bit-equal to the unsharded kernel), ``PoseGraphSolver(mesh)`` on the
     mission's loop-closed graph from its chain (the mesh CG route; poses
     within 5e-4 and cost within 1e-2 relative of ``pcg_lm.cu``; then one
     gather of a CG matvec's edge terms, timed; then in float64:
     "mesh_cg", a float64 result on ``cuda``, no launch, within 1e-6 of
     phase 14a's one-device float64 "cg" solve, (a) and (b) bit-equal),
     ``offline_slam(mesh)`` on
     the mission cut to its first round (the same loops, poses within 5e-4
     of the unsharded run) and whole (ATE ≤ 5 mm, the same loop count and
     the chain within 1e-5 of the unsharded run; the same loops and poses
     within 5e-4 of the mesh's solver run in this process without ranks),
     ``KartoSLAM(mesh)`` on the 352-scan recipe (the same
     accepts and closures, trajectory within 5e-3) and ``HectorSLAM(mesh)``
     on the 150-scan recipe at the full grid (ATE ≤ 0.06 m; (a) and (b)
     within 1e-4, every level's map equal), and the submap-sharded Schur
     step (``make_distributed_schur_delta``, S = D) on the mission graph
     (two psums; within 1e-4 × max(|δ|, 1) of ``schur_delta`` on one
     device at the same partition); every rank's results equal; a rank
     that fails or passes its deadline fails the script;
 20. the streamed CR-LM kernel against its plain version on bench_solver's
     rings of 4,096 and 16,384 nodes (K 1,024 and 4,096), then on edge
     cases (W = 2, W = 8, 32,768 nodes, and a 24,576-node chain with
     exact measurements at K 4,096 that converges), with both times, the
     schedule (``solver/cr_stream.stream_schedule``: grid levels, the
     cluster, launches per LM iteration), the kernels a solve enqueued
     and how many of them after convergence, and the bound; then both
     CR-LM kernels on the same graphs (the bench graph at K 256, a
     3,072-node ring at K 512), with both times and both times per
     dependent step, and the streamed kernel alone on a 6,144-node ring
     at K 1,024;
 21. the large-graph main path, with the launch counters zeroed first:
     ``PoseGraphSolver.compute`` on the 4,096- and 16,384-node rings, each
     one streamed-kernel launch and no other, χ² → ~0; their solve ms
     (median of 3 warm runs) and one solve under ``torch.profiler``;
 22. the host f64 arm: a 3,200-node skip-edge graph that does not band
     solves on the host and launches nothing;
 23. ``offline_slam(corrected_pts=...)`` on the 80-scan undistortion
     recipe: every match a PL-ICP launch, the corrected chain's ATE under
     the raw one's;
 24. one JSON line with every kernel (its launches, the PL-ICP,
     correlative and loop-sweep kernels' counting the outdoor mission's
     and every mesh rank's too, every kernel's the examples', the
     correlative and LM kernels' the online outdoor run's, every kernel's
     the command line's runs, the PCG-LM's the restarted ring's, its error
     against its plain version, both times, and its bound: the larger of
     bytes over 3.35 TB/s and operations over 67 T/s in float32, or 16.7
     T/s for the correlative kernel's int32 adds), then ``{"ok": true,
     ...}`` last.
Phases 20-23 run right after phase 4. Any failing phase raises: the
script then exits non-zero and never prints the ok line. Without a CUDA
device it raises at phase 1. A ``[time]`` line after each group of
phases gives its wall and the running total.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import socket
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from tpu_slam_torch import _build, _dispatch, cli, native
from tpu_slam_torch import geometry as geo
from tpu_slam_torch import geometry_np as gnp
from tpu_slam_torch.config import SolverConfig, default_config, preset
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.data import rosbag
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.data.scan import Scan, index_scan, make_scan
from tpu_slam_torch.examples import (
    run_feature_detection, run_gmapping, run_hector_slam, run_karto_slam,
    run_lidar_undistortion, run_plicp_odometry, run_scan_matching,
)
from tpu_slam_torch.examples.run_karto_slam import (  # noqa: F401
    drifted_odometry,  # the reference's odometry, which the tests hold
)
from tpu_slam_torch.examples.run_lidar_undistortion import first_beam_truth
from tpu_slam_torch.examples.run_scan_matching import delta_rmse, masked_pairs
from tpu_slam_torch.models import offline
from tpu_slam_torch.models.gmapping import GMapping
from tpu_slam_torch.models.hector_slam import HectorSLAM, _beams
from tpu_slam_torch.models.icp_odometry import ICPOdometry
from tpu_slam_torch.models.karto import occupancy as occ
from tpu_slam_torch.models.karto.pipeline import KartoSLAM
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.models.plicp_odometry import (
    PLICPOdometry, plicp_match_batch,
)
from tpu_slam_torch.models.scan_match_plicp import ScanMatchPLICP
from tpu_slam_torch.ops import correlative as corr
from tpu_slam_torch.ops import gridmap as gm
from tpu_slam_torch.ops import hector as hec
from tpu_slam_torch.ops.cuda import correlative_response as corr_response
from tpu_slam_torch.ops.cuda.correlative_response import responses_sliced
from tpu_slam_torch.ops.cuda.hector_fused import (
    BARRIERS_PER_STEP, hector_geometry, hector_match_fused,
)
from tpu_slam_torch.ops.cuda.loop_sweep import (
    loop_sweep_cuda, loop_sweep_plain,
)
from tpu_slam_torch.ops.cuda.nn import nearest_neighbor_cuda, nn_geometry
from tpu_slam_torch.ops.cuda.plicp_fused import (
    BARRIERS_PER_ROUND, TILE, launch_plicp, plicp_geometry, plicp_match_fused,
)
from tpu_slam_torch.ops.features import extract_corner_features
from tpu_slam_torch.ops.icp import icp_match
from tpu_slam_torch.ops.matching import (
    nearest_neighbor, nearest_neighbor_direct,
)
from tpu_slam_torch.ops.plicp import _correspondences as plicp_correspondences
from tpu_slam_torch.ops.plicp import plicp_match
from tpu_slam_torch.ops.undistort import undistort_scan
from tpu_slam_torch.parallel.distributed_step import (
    _chain_matcher, _gather_scan, _loop_selector, _match_fn,
    make_chain_matcher, make_loop_selector, make_packed_indexed_matcher,
)
from tpu_slam_torch.parallel.mesh import make_mesh
from tpu_slam_torch.solver import banded, cr_lm, pcg_lm, pose_graph
from tpu_slam_torch.solver.cr_lm import cr_lm_plain, fused_cr_lm
from tpu_slam_torch.solver.cr_stream import stream_schedule, streamed_cr_lm
from tpu_slam_torch.solver.pcg_lm import fused_lm_solve, pcg_lm_plain
from tpu_slam_torch.solver.pose_graph import (
    PoseGraphSolver, _route, _sq_min_delta,
)
from tpu_slam_torch.solver.schur import (
    build_partition, make_distributed_schur_delta, schur_delta,
)
from tpu_slam_torch.utils.checkpoint import (
    load_hector, load_karto, save_hector,
)
from tpu_slam_torch.utils.evaluation import ate_rmse
from tpu_slam_torch.utils.map_io import load_map
from tpu_slam_torch.utils.profiling import StageTimer, device_trace

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
# the outdoor mission (benchmarks/bench_outdoor.py's 1-lap recipe): 2x the
# reference's recorded 0.005 m (BENCHMARKS.md:736), and what must fire
OUTDOOR_ATE_MAX = 0.01  # m
OUTDOOR_WARM_SCANS = 600
OUTDOOR_MIN = {"skip edges": 1, "anchors": 1, "loops": 4}
# the reference's run of the Karto recipe at the full width on the CPU
KARTO_REF = {"accepted": 126, "closures": 2, "ate": 0.00577}
# the 1-lap online outdoor run (bench_outdoor.py --online): the reference's
# accepted scans, solves and ATE, and the ATE bar, 2x that ATE
OUTDOOR_ONLINE_REF = {"accepted": 1149, "solves": 61, "ate": 0.024}
OUTDOOR_ONLINE_ATE_MAX = 0.05  # m
OUTDOOR_ONLINE_PROFILE_SCANS = 25  # the profiled window of the run
KARTO_PROFILE_SCANS = 50  # the profiled window of the online Karto run
MAP_CPU_BUDGET_S = 25.0  # the CPU run the outdoor map is held to (≤ 30 s)
GMAPPING_MIN = {"occupied": 200, "free": 10_000}  # examples/run_gmapping.py
GMAPPING_MEANS_RTOL = 1e-5
GMAPPING_MEANS_ATOL = 1e-6  # m, where a cell's hits straddle 0
# the lesson front-ends: examples/run_plicp_odometry.py's recipe (200 scans
# of 360 beams), and the reference's CPU runs of it (tpu_slam on the CPU,
# whose NN takes the expanded form; reproduced by the slow test
# tests/test_torch_odometry.py::test_chip_smoke_references_are_the_reference_runs):
# each model's ATE (m), and the scan indices at which PLICPOdometry took a
# keyframe (every second scan)
LESSON_SCANS = 200
LESSON_PROFILE_SCANS = 20  # the profiled window of each model's run
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


def graph_ms(fn, reps: int) -> tuple[float, float, str]:
    """Device milliseconds per call of a small kernel's wrapper ``fn``,
    free of the host: ``reps`` calls captured in one CUDA graph, whose
    replay (after a warm one) is timed with CUDA events. Where the card
    refuses the capture, the profiler's device time per launch instead.
    Also the host's µs per call of ``fn`` itself (``reps`` calls enqueued
    back to back). Returns (ms, host µs, how the ms was taken)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps, host_us, "CUDA graph replay"
    except RuntimeError as err:
        print(f"graph capture refused ({err}); profiler time instead",
              flush=True)
        _w, _b, per = device_profile(lambda: [fn() for _ in range(reps)])
        n, us = next(v for k, v in per.items() if k != "other")
        return us / n / 1e3, host_us, "profiler, per launch"


def graph_nodes(fn) -> tuple[int, int]:
    """The device work of one call of ``fn``, from the CUDA graph that
    captures it: (kernel nodes, other nodes, e.g. memsets), read with
    libcuda's cuGraphGetNodes and cuGraphNodeGetType."""
    import ctypes

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels, count.value - kernels


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


def plicp_bench_batch(dev, B: int = 512):
    """bench PL-ICP recipe: B consecutive pairs of an office circle;
    (cfg, (src, src_valid, tgt, tgt_valid), zero guesses)."""
    cfg = default_config()
    traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    scans = make_scan(seq.ranges, cfg.scan, device=dev)
    pts = torch.where(scans.valid[..., None], scans.points(), 0.0)
    args = (pts[1:].contiguous(), scans.valid[1:].contiguous(),
            pts[:-1].contiguous(), scans.valid[:-1].contiguous())
    return cfg, args, torch.zeros((B, 3), dtype=torch.float32, device=dev)


def plicp_pair_gaps(cfg, args, g, plain_result):
    """The kernel against the plain version's result on the same pairs:
    (pose gap, share of pairs with equal inliers, max |Δ inliers|, the
    kernel's result); raises beyond the bench batch's bars."""
    k, p = plicp_match_fused(*args, cfg.plicp, init_pose=g), plain_result
    torch.cuda.synchronize()
    dpose = float((k.pose - p.pose).abs().max())
    dinl = (k.num_inliers - p.num_inliers).abs()
    eq = float((dinl == 0).float().mean())
    if not (bool(torch.isfinite(k.pose).all()) and dpose <= PLICP_POSE_TOL
            and eq >= PLICP_INLIER_EQ_FRAC and int(dinl.max()) <= 1):
        raise AssertionError(f"PL-ICP kernel disagrees with its plain version "
                             f"(pose {dpose:.3e}, inliers equal {eq:.4f})")
    return dpose, eq, int(dinl.max()), k


def phase_plicp(dev) -> dict:
    """The bench PL-ICP batch: 512 pairs of 360 beams."""
    cfg, args, g = plicp_bench_batch(dev)

    def plain():
        return plain_plicp(*args, cfg.plicp, init_pose=g)

    p = plain()
    dpose, eq, dinl, k = plicp_pair_gaps(cfg, args, g, p)
    out, timing = plicp_timing(args, g, cfg, 50)
    out["plain_ms"] = cuda_ms(plain, 3)
    print(f"plicp: B={g.shape[0]} N=360 pose max|d|={dpose:.3e} inliers "
          f"equal {eq:.4f} max|d|={dinl} converged "
          f"{int(k.converged.sum())}/{int(p.converged.sum())}; {timing}; "
          f"plain {out['plain_ms']:.3f} ms", flush=True)
    return {"max_abs_err": dpose, **out}


def plicp_timing(pairs, g, cfg, reps: int) -> tuple[dict, str]:
    """The PL-ICP kernel on ``pairs`` (src, src_valid, tgt, tgt_valid):
    its device ms a launch (``graph_ms`` of the bare launch, the wrapper's
    host µs beside it), the launch geometry, the rounds each pair ran
    (``plicp_rounds``: the dependent steps), µs a round of the longest
    pair, the design's barriers a round, and the bound counted from the
    work the pairs' rounds need (``plicp_ops``). Returns (ms and bound,
    the printed text)."""
    B, N, _ = pairs[0].shape
    M = pairs[2].shape[1]
    ms, host_us, how = graph_ms(lambda: launch_plicp(*pairs, cfg.plicp, g),
                                reps)
    rounds, starts = plicp_rounds(pairs, cfg.plicp, g)
    shape = plicp_geometry(B, N, M, torch.cuda.get_device_properties(
        g.device).multi_processor_count)
    work = bound(B * (9 * N + 9 * M + 12) + B * (12 + 16 + 36),
                 plicp_ops(pairs, rounds, starts))
    rmax = int(rounds.max())
    text = (f"kernel {ms:.4f} ms ({how}; the wrapper's host {host_us:.1f} us "
            f"a call), {shape.threads} threads x {shape.sources} sources "
            f"a thread, {shape.smem} B shared; rounds a pair max {rmax} mean "
            f"{float(rounds.float().mean()):.2f} (all {int(rounds.sum())}), "
            f"{ms * 1e3 / rmax:.2f} us a round of the longest pair, "
            f"{BARRIERS_PER_ROUND} barriers a round (design); bound "
            f"{work['bound_ms']:.5f} ms ({work['bound_by']})")
    return {"ms": ms, **work}, text


def plicp_rounds(args, pcfg, g) -> tuple[torch.Tensor, list]:
    """Rounds each pair runs before it converges, and the pose each round
    starts from: the plain version stops no pair early, but after k
    rounds it reports which pairs converged within k, so the first such k
    is that pair's count, and its pose after k rounds is where round k + 1
    starts. Returns (rounds (B,), one (B, 3) start pose a round)."""
    rounds = torch.full((g.shape[0],), pcfg.max_iterations,
                        dtype=torch.int64, device=g.device)
    seen = torch.zeros_like(rounds, dtype=torch.bool)
    starts = [g]
    for k in range(1, pcfg.max_iterations + 1):
        res = plain_plicp(*args, dataclasses.replace(pcfg, max_iterations=k),
                          init_pose=g)
        rounds = torch.where(res.converged & ~seen, k, rounds)
        seen |= res.converged
        starts.append(res.pose)
    return rounds, starts[:-1]


def plicp_ops(pairs, rounds, starts, chunk: int = 256) -> float:
    """The operations the pairs' rounds need on these inputs, each round
    at the pose it starts from: the nearest neighbour of each valid source
    needs 6 operations (two differences, two squares, a sum, a compare)
    for each target of each tile of ``TILE`` targets whose bounding box
    lies no farther than the source's nearest valid target (a tile that
    holds an invalid target bounds at 1e12, as in the kernel), and ~10
    for each tile's box test; the exact trimming quantiles a linear radix
    select, 2 per source (a histogram count, and a compare among the two
    bins' members); the second point, the residual and the sums of the
    two GN steps ~120 per source."""
    src, sv, tgt, tv = pairs
    B, N, _ = src.shape
    M = tgt.shape[1]
    nb = -(-M // TILE)
    pad = nb * TILE - M
    inf = float("inf")

    def tiles(x, fill):  # (B, M) -> (B, nb, TILE), padded with ``fill``
        return torch.nn.functional.pad(x, (0, pad), value=fill).view(
            B, nb, TILE)

    tx, ty = tgt[..., 0], tgt[..., 1]
    x0 = tiles(torch.where(tv, tx, inf), inf).amin(-1)
    y0 = tiles(torch.where(tv, ty, inf), inf).amin(-1)
    x1 = tiles(torch.where(tv, tx, -inf), -inf).amax(-1)
    y1 = tiles(torch.where(tv, ty, -inf), -inf).amax(-1)
    invalid = tiles((~tv).float(), 0.0).amax(-1) > 0
    size = torch.full((nb,), float(TILE), device=src.device)
    size[-1] = M - (nb - 1) * TILE
    nn_ops = 0.0
    for r, pose in enumerate(starts):
        live = rounds > r
        for a in range(0, B, chunk):
            b = slice(a, a + chunk)
            w = geo.apply(pose[b], src[b])  # (b, N, 2)
            d2 = ((w[:, :, None, :] - tgt[b][:, None, :, :]) ** 2).sum(-1)
            best = torch.where(tv[b][:, None, :], d2, 1e12).amin(-1)
            wx, wy = w[..., 0:1], w[..., 1:2]
            gx = torch.clamp(torch.maximum(x0[b][:, None] - wx,
                                           wx - x1[b][:, None]), min=0)
            gy = torch.clamp(torch.maximum(y0[b][:, None] - wy,
                                           wy - y1[b][:, None]), min=0)
            lb = gx * gx + gy * gy
            lb = torch.where(invalid[b][:, None], lb.clamp(max=1e12), lb)
            scanned = ((lb <= best[..., None]) * size).sum(-1)  # (b, N)
            use = sv[b] & live[b][:, None]
            nn_ops += float((6 * scanned + 10 * nb)[use].sum())
    return nn_ops + float(rounds.sum()) * 122 * N


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


def cr_compare(label: str, dev, cfg, poses, edges, sq_min_delta) -> dict:
    """The single-launch CR-LM kernel against its plain version on a
    graph's ``direct_inputs``: poses within LM_POSE_TOL, final χ² within
    LM_COST_RTOL. Prints both times, the dependent steps (LM iterations ×
    levels) and µs a step, and the bound; returns them with
    max_abs_err."""
    spec, pT8, slots = solver_from_numpy(cfg, poses, edges,
                                         dev).direct_inputs()
    kw = dict(W=spec.W, K=spec.K, iters=cfg.max_iterations,
              sq_min_delta=sq_min_delta)

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
    iters = int(k[3, 3])
    work = cr_work(spec, pT8, slots, len(edges), iters)
    steps = cr_steps(spec.K, iters)
    print(f"{label}: nodes={len(poses)} W={spec.W} K={spec.K} geometry "
          f"{cr_geometry(spec.W, spec.K)} pose max|d|={dpose:.3e} cost0 "
          f"{float(k[3, 0]):.6g} cost kernel {kc:.6g} plain {pc:.6g} iters "
          f"kernel {iters} plain {int(p[3, 3])} kernel {ms:.3f} ms plain "
          f"{plain_ms:.3f} ms bound {work['bound_ms']:.5f} ms "
          f"({work['bound_by']}); dependent steps {steps} (LM iterations × "
          f"levels), {ms / steps * 1e3:.3f} µs a step", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the CR-LM kernel disagrees with its "
                             "plain version")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def phase_cr(dev) -> dict:
    """The CR-LM kernel against its plain version on the 1,024-node bench
    pose graph."""
    return cr_compare("cr_lm", dev, SolverConfig(), *bench_graph(), 1e-8)


def cr_steps(K: int, iters: int) -> int:
    """The CR-LM solve's dependent steps: LM iterations × CR levels."""
    return max(iters, 1) * (K.bit_length() - 1)


def cr_geometry(W: int, K: int) -> str:
    blocks, warps, smem = cr_lm.launch_geometry(W, K)
    return f"{blocks} blocks x {warps} warps, {smem} B shared"


def chain_banded(n: int, W: int, seed: int):
    """A noisy odometry chain of ``n`` nodes (skip_graph without skips, the
    guess perturbed) packed at band ``W`` (the packer's buckets start at
    2, so the spec is built with its bucket lifted): (spec, init, means,
    infos) for the CR-LM kernel at W = 1."""
    init, edges = skip_graph(n, strides=(), seed=seed)
    rng = np.random.default_rng(seed)
    init = init + rng.normal(0, 0.02, init.shape) * (np.arange(n) > 0)[:, None]
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    bucket = banded._bucket_w
    banded._bucket_w = lambda w: max(w, W)
    try:
        spec = banded.prepare_banded(ei, ej, n, min_k=32)
    finally:
        banded._bucket_w = bucket
    means = np.stack([e[2] for e in edges]).astype(np.float32)
    infos = np.stack([e[3] for e in edges]).astype(np.float32)
    return spec, init.astype(np.float32), means, infos


def exact_chain(n: int, strides, every: bool, seed: int = 0):
    """An open chain of ``n`` nodes on three quarters of a circle of 10 m:
    an edge from every node to the next and, for each s in ``strides``,
    to the s-th next from every node (``every``) or from every s-th node;
    exact measurements (χ² → 0 at the optimum, as on bench_solver's
    rings), each pose but the first perturbed by N(0, (5 cm, 5 cm, 0.01))
    as the guess, information diag(50, 50, 100). With ``every`` it bands
    at W = max(strides) rounded up to the packer's bucket; with skips
    every 32 nodes it does not band. Returns (init, edges)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 1.5 * np.pi, n)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2], -1)
    init = gt + rng.normal(0, [0.05, 0.05, 0.01], (n, 3)) * (
        np.arange(n) > 0)[:, None]
    pairs = [(i, i + 1) for i in range(n - 1)]
    for s in strides:
        pairs += [(i, i + s) for i in range(0, n - s, 1 if every else s)]
    ei, ej = np.array(pairs).T
    info = np.diag([50.0, 50.0, 100.0])
    return init, [(i, j, m, info) for i, j, m in
                  zip(ei, ej, gnp.relative(gt[ei], gt[ej]))]


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
    # closures at W = 6 (K = 32 with min_k = 32, the smallest cluster: one
    # block), a chain at W = 1 (K = 256), and a 4,000-node chain with an
    # edge to the 7th node on from every node at W = 8, K = 512 (the
    # largest slices: 16 warps of 11,712 B a block)
    cases = []
    for n, stride, min_k in ((200, 0, 128), (72, 8, 32)):
        init, ei, ej, means, infos = _ring_edges(n, stride, rng)
        cases.append((banded.prepare_banded(ei, ej, n, min_k=min_k), init,
                      means, infos))
    cases.append(chain_banded(200, 1, seed=5))
    init, edges = exact_chain(4000, (7,), every=True)
    cases.append((banded.prepare_banded([e[0] for e in edges],
                                        [e[1] for e in edges], 4000),
                  init, np.stack([e[2] for e in edges]).astype(np.float32),
                  np.stack([e[3] for e in edges]).astype(np.float32)))
    for spec, init, means, infos in cases:
        n = len(init)
        pT8 = torch.as_tensor(banded.flat_poses_np(spec, init), device=dev)
        slots = torch.as_tensor(banded.build_slots_np(spec, means, infos),
                                device=dev)
        kw = dict(W=spec.W, K=spec.K, iters=40, sq_min_delta=1e-8)
        k = fused_cr_lm(pT8, slots, 1e-4, **kw)
        p = cr_lm_plain(pT8, slots, 1e-4, **kw)
        dpose = float((k[0:3] - p[0:3]).abs().max())
        kc, pc = float(k[3, 1]), float(p[3, 1])
        print(f"edge cr_lm: nodes={n} W={spec.W} K={spec.K} geometry "
              f"{cr_geometry(spec.W, spec.K)} pose max|d|={dpose:.3e} cost0 "
              f"{float(k[3, 0]):.6g} cost kernel {kc:.6g} plain {pc:.6g} "
              f"iters {int(k[3, 3])} / {int(p[3, 3])}", flush=True)
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


def plicp_edge(label, cfg, src, sv, tgt, tv, g, nn=nearest_neighbor):
    """The PL-ICP kernel against its plain version on one edge batch, at
    phase_edge_cases' bars; returns (kernel, plain) results. ``nn`` is the
    plain version's nearest neighbour: the expanded form by default, the
    kernel's direct form (``nearest_neighbor_direct``) where the targets
    are dense enough that the expanded form's rounding splits near-ties
    (the expanded form's gap is then printed for information)."""
    k = plicp_match_fused(src, sv, tgt, tv, cfg.plicp, init_pose=g)
    p = plicp_match(src, sv, tgt, tv, cfg.plicp, init_pose=g, nn=nn)
    info = ""
    if nn is not nearest_neighbor:
        e = plain_plicp(src, sv, tgt, tv, cfg.plicp, init_pose=g)
        info = (f" (against the expanded-form NN, for information: pose "
                f"max|d|={float(pose_gap(k.pose, e.pose).max()):.3e})")
    torch.cuda.synchronize()
    B, N, _ = src.shape
    M = tgt.shape[1]
    shape = plicp_geometry(B, N, M, torch.cuda.get_device_properties(
        src.device).multi_processor_count)
    dpose = float(pose_gap(k.pose, p.pose).max())
    dinl = int((k.num_inliers - p.num_inliers).abs().max())
    print(f"{label}: B={B} N={N} M={M} geometry {shape.threads} threads x "
          f"{shape.sources} sources x {shape.source_chunks} chunks, "
          f"{shape.target_chunks} target chunks of {shape.targets}, "
          f"{shape.smem} B shared, lists in "
          f"{'device scratch' if shape.lists_global else 'shared'}, "
          f"{4 * shape.scratch} B scratch a pair; pose max|d|="
          f"{dpose:.3e} inliers kernel {k.num_inliers.tolist()[:8]} max|d|="
          f"{dinl} converged {int(k.converged.sum())}/"
          f"{int(p.converged.sum())}{info}", flush=True)
    if not (dpose <= PLICP_POSE_TOL and dinl <= 1
            and bool(torch.isfinite(k.pose).all())
            and torch.equal(k.converged, p.converged)):
        raise AssertionError(f"{label}: the PL-ICP kernel disagrees with its "
                             "plain version")
    return k, p


def office_pairs(dev, B: int, n_src: int, n_tgt: int, rate: float = 0.5,
                 seed: int = 2):
    """B consecutive pairs of an office circle: sources of ``n_src`` beams
    from poses 1..B, targets of ``n_tgt`` beams from poses 0..B-1, each
    scan at its own beam count over the full turn."""
    cfg = default_config()
    traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=rate)
    world = sim.office_world(seed=seed, clear_path=traj)
    out = []
    for nb in (n_src, n_tgt):
        scfg = dataclasses.replace(cfg.scan, num_beams=nb,
                                   angle_increment=2 * np.pi / nb)
        sc = make_scan(sim.simulate_sequence(world, traj, scfg,
                                             noise_std=0.004,
                                             seed=nb).ranges, scfg,
                       device=dev)
        out.append((torch.where(sc.valid[..., None], sc.points(), 0.0),
                    sc.valid))
    (sp, sv), (tp, tv) = out
    return (sp[1:].contiguous(), sv[1:].contiguous(), tp[:-1].contiguous(),
            tv[:-1].contiguous())


def phase_plicp_edges(dev) -> None:
    """The PL-ICP kernel off the main path's shapes: the wrapper's limits
    (N 1,024 x M 4,096: shared memory above 48 KB), N = 1, a batch of
    degenerate pairs (an all-invalid target, a source of 2 valid beams,
    a straight wall whose residuals all tie, an ordinary pair), and one
    batch whose pairs converge in round 1 beside pairs that run all 10."""
    cfg = default_config()
    f32 = dict(dtype=torch.float32, device=dev)
    pairs = office_pairs(dev, 2, 1024, 4096)
    plicp_edge("edge plicp N=1,024 M=4,096", cfg, *pairs,
               torch.zeros((2, 3), **f32))
    # past one pass of sources (1,024) and one staged chunk of targets
    # (4,096): chunks of each, the records in device scratch; at 20,000
    # sources the lists too. Targets of 5,000 beams and more lie ~4 mm
    # apart, where the expanded-form NN's rounding splits near-ties, so
    # the plain version takes the kernel's direct-form NN
    for n_src, n_tgt in ((1081, 1081), (1081, 5000), (4097, 12345),
                         (20000, 1081)):
        plicp_edge(f"edge plicp N={n_src:,} M={n_tgt:,}", cfg,
                   *office_pairs(dev, 3, n_src, n_tgt),
                   torch.tensor([[0.0, 0.0, 0.0], [0.03, -0.02, 0.01],
                                 [-0.05, 0.04, -0.02]], **f32),
                   nn=nearest_neighbor_direct)
    src, sv, tgt, tv = office_pairs(dev, 4, 360, 360)
    first = sv.float().argmax(-1)  # each source's first valid beam
    rows = torch.arange(4, device=dev)
    plicp_edge("edge plicp N=1", cfg, src[rows, first][:, None].contiguous(),
               sv[rows, first][:, None].contiguous(), tgt, tv,
               torch.zeros((4, 3), **f32))
    # degenerate pairs: 0 an all-invalid target, 1 a source of 2 valid
    # beams, 2 a straight wall (y = 1) seen from 0.02 m off, its x values
    # each twice, so that every residual is the same |err|, 3 ordinary
    src, sv, tgt, tv = (x.clone() for x in (src, sv, tgt, tv))
    tv[0] = False
    sv[1] = False
    sv[1, first[1]] = sv[1, first[1] + 5] = True
    wx = torch.linspace(-4.5, 4.5, 360, **f32)
    tgt[2] = torch.stack([wx, torch.ones_like(wx)], -1)
    tv[2] = True
    src[2] = torch.stack([wx[::2].repeat_interleave(2),
                          torch.full_like(wx, 1.02)], -1)
    sv[2] = True
    g = torch.zeros((4, 3), **f32)
    _s, _q1, _n, resid, gate = plicp_correspondences(
        g, src, sv, tgt, tv, cfg.plicp, True, nearest_neighbor)
    ties = int(gate[2].sum()) - int(torch.unique(resid[2][gate[2]].abs())
                                    .numel())
    k, _p = plicp_edge("edge plicp degenerate pairs (no valid target, 2 "
                       "valid sources, a tied wall, ordinary)", cfg, src,
                       sv, tgt, tv, g)
    print(f"edge plicp tied wall: {int(gate[2].sum())} gated sources, "
          f"{ties} of them tie an earlier |err| in round 1; wall pair "
          f"pose {k.pose[2].tolist()}", flush=True)
    if not (int(k.num_inliers[0]) == 0 and int(k.num_inliers[1]) <= 2
            and ties >= 300 and bool((k.pose[:2] == 0).all())):
        raise AssertionError("edge plicp degenerate pairs: wrong inliers, "
                             "or a pair without 3 inliers moved")
    # 4 pairs of identical scans (converge in round 1), 12 started 0.2 m
    # and 0.1 rad off on a fast turn (run up to all 10 rounds)
    src, sv, tgt, tv = office_pairs(dev, 16, 360, 360, rate=2.5, seed=11)
    src[:4], sv[:4] = tgt[:4], tv[:4]
    g = torch.zeros((16, 3), **f32)
    g[4:] = torch.tensor([0.2, 0.1, -0.1], **f32)
    rounds, _starts = plicp_rounds((src, sv, tgt, tv), cfg.plicp, g)
    print(f"edge plicp mixed convergence: rounds a pair {rounds.tolist()}",
          flush=True)
    if not (int(rounds.min()) == 1
            and int(rounds.max()) == cfg.plicp.max_iterations):
        raise AssertionError("the mixed batch does not span 1 to all rounds")
    plicp_edge("edge plicp mixed convergence", cfg, src, sv, tgt, tv, g)


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
def recording_sweeps():
    """Record every loop-candidate sweep of the runs inside: the poses,
    settings and tried pairs it took, and its picks, passing every call
    through unchanged."""
    sweeps = []
    find0 = offline._loop_candidates

    def find(poses, ocfg, tried):
        before = set(tried)
        got = find0(poses, ocfg, tried)
        sweeps.append((poses.clone(), ocfg, before, got))
        return got

    offline._loop_candidates = find
    try:
        yield sweeps
    finally:
        offline._loop_candidates = find0


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
    with recording_batches() as batches, recording_sweeps() as sweeps:
        res = offline_slam(scans, cfg, odom=odom, timer=timer)
    batches["sweeps"] = sweeps
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
    if launches["loop_sweep"] != timer.counts["candidates"]:
        raise AssertionError("not every loop-candidate sweep ran its kernel")
    if launches["cr_lm"] != 1 or not np.isfinite(stats.final_cost):
        raise AssertionError("the bench graph solve did not run the CR-LM "
                             "kernel")
    return cfg, scans, odom, gt, res, launches, batches


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


def mission_pairs(store, storev, dirs, si, ti):
    """A recorded matcher call's pairs, as the matcher gathers them:
    (src, src_valid, tgt, tgt_valid)."""
    return (_gather_scan(store, si, dirs), storev[si].contiguous(),
            _gather_scan(store, ti, dirs), storev[ti].contiguous())


def plain_matchers(cfg, S: int):
    """The chain matcher and loop selector over the plain version."""

    def plain_match(sp, sv, tp, tv, g):
        return plain_plicp(sp, sv, tp, tv, cfg.plicp, init_pose=g)

    return _chain_matcher(plain_match), _loop_selector(plain_match, S)


def chain_gaps(cfg, T: int, args, plain_rows):
    """The kernel's chain matcher on the recorded chain call against the
    plain version's rows: (rel pose gap, trajectory gap, |Δ inliers| per
    pair, the kernel's rows); raises beyond the chain's bars."""
    Bp = args[3].shape[0]
    k, p = make_chain_matcher(cfg)(*args), plain_rows
    torch.cuda.synchronize()
    n = T - 1
    drel = float(pose_gap(k[:n, :3], p[:n, :3]).max())
    dtraj = float(pose_gap(k[Bp:Bp + T, :3], p[Bp:Bp + T, :3]).max())
    dinl = (k[:n, 4] - p[:n, 4]).abs()
    if not (drel <= PLICP_POSE_TOL and dtraj <= CHAIN_TRAJ_TOL
            and int(dinl.max()) <= 1):
        raise AssertionError(f"chain batch: kernel and plain version "
                             f"disagree (rel {drel:.3e}, trajectory "
                             f"{dtraj:.3e}, inliers {int(dinl.max())})")
    return drel, dtraj, dinl, k


def loop_gaps(cfg, S: int, args, plain_rows):
    """The kernel's loop selector on the recorded loop call against the
    plain version's rows: (accepted by the kernel, by the plain version,
    selected rows' pose gap, their error gap); raises unless the accept
    flags are the same and the selected rows within PLICP_POSE_TOL."""
    k, p = make_loop_selector(cfg, S)(*args), plain_rows
    torch.cuda.synchronize()
    acc_k, acc_p = k[:, 15] > 0.5, p[:, 15] > 0.5
    both = acc_k & acc_p
    dsel = float(pose_gap(k[both, :3], p[both, :3]).max()) if both.any() \
        else 0.0
    derr = float((k[both, 3] - p[both, 3]).abs().max()) if both.any() else 0.0
    if not (torch.equal(acc_k, acc_p) and dsel <= PLICP_POSE_TOL):
        raise AssertionError(f"loop batch: kernel and plain version select "
                             f"differently (selected rows {dsel:.3e})")
    return acc_k, acc_p, dsel, derr


def phase_mission_batches(cfg, T: int, batches) -> None:
    """The PL-ICP kernel against its plain version on the mission's own
    batches, as the counted run recorded them: the chain batch through
    ``make_chain_matcher`` and the first loop round's multi-start batch
    through ``make_loop_selector``. Pairs that split are solved again in
    float64 as a witness (``f64_witness``). Each batch's kernel is timed
    alone (``plicp_timing``), with its bound from the work its rounds need."""
    S = batches["seeds"]
    plain_c, plain_l = plain_matchers(cfg, S)

    # chain: per-pair rows and the integrated trajectory
    args = batches["chain"]
    store, storev, dirs, si, ti, g, _pose0 = args
    Bp = si.shape[0]
    n = T - 1
    p = plain_c(*args)
    drel, dtraj, dinl, k = chain_gaps(cfg, T, args, p)
    witness = f64_witness(cfg, k[:n, :3], p[:n, :3],
                          *mission_pairs(store, storev, dirs, si[:n], ti[:n]),
                          g[:n])
    kern_c = make_chain_matcher(cfg)
    ms, plain_ms = cuda_ms(lambda: kern_c(*args), 5), cuda_ms(
        lambda: plain_c(*args), 2)
    _o, timing = plicp_timing(mission_pairs(store, storev, dirs, si, ti), g,
                              cfg, 20)
    print(
        f"mission chain batch: B={Bp} pairs={n} rel max|d|={drel:.3e} "
        f"trajectory max|d|={dtraj:.3e} inliers equal "
        f"{float((dinl == 0).float().mean()):.4f} max|d|={int(dinl.max())}; "
        f"{witness}; {timing}; matcher {ms:.3f} ms (events) plain "
        f"{plain_ms:.3f} ms", flush=True)

    # first loop round: the selector's rows, then the pairs beneath them
    args = batches["loop"]
    store, storev, dirs, si, ti, g, rel_pred, _gates = args
    Cp = rel_pred.shape[0]
    acc_k, acc_p, dsel, derr = loop_gaps(cfg, S, args, plain_l(*args))
    pairs = mission_pairs(store, storev, dirs, si, ti)
    kp = plicp_match_fused(*pairs, cfg.plicp, init_pose=g)
    pp = plain_plicp(*pairs, cfg.plicp, init_pose=g)
    witness = f64_witness(cfg, kp.pose, pp.pose, *pairs, g)
    plain_ms = cuda_ms(lambda: plain_plicp(*pairs, cfg.plicp, init_pose=g), 2)
    _o, timing = plicp_timing(pairs, g, cfg, 10)
    inl_eq = float((kp.num_inliers == pp.num_inliers).float().mean())
    print(
        f"mission loop batch (round 0): Cp={Cp} S={S} pairs={Cp * S} accepted "
        f"kernel {int(acc_k.sum())} plain {int(acc_p.sum())} same flags "
        f"{bool(torch.equal(acc_k, acc_p))} selected rows pose max|d|="
        f"{dsel:.3e} err max|d|={derr:.3e}; pairs: pose max|d|="
        f"{float(pose_gap(kp.pose, pp.pose).max()):.3e} inliers equal "
        f"{inl_eq:.4f}; {witness}; {timing}; plain {plain_ms:.3f} ms",
        flush=True)


def sweep_bound(T: int, min_gap: int, n_tried: int, cap: int) -> dict:
    """The loop sweep's least time: the poses read once (x and y, 8 bytes
    a scan), the tried pairs read and the picks written once (8 bytes a
    pair); 3 float32 operations a scan (its squared norm) and 6 a pair
    with j - i >= min_gap (a product, an fma, two adds, the subtraction
    and the compare with the radius)."""
    m = max(min_gap, 1)
    pairs = (T - m) * (T - m + 1) // 2 if T > m else 0
    return bound(8.0 * (T + n_tried + cap), 3.0 * T + 6.0 * pairs)


def wall_ms(fn, reps: int) -> float:
    """Median wall milliseconds of a call of ``fn`` that ends in a read on
    the host, after one warm-up."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) * 1e3


def phase_loop_sweep(label: str, sweeps, reps: int = 0) -> dict | None:
    """The loop-sweep kernel against its plain version, on the card and on
    the CPU, on the sweeps a run recorded (``recording_sweeps``): the
    same picks and live cells from all three, and the picks the run
    took. With ``reps``, on the first sweep and on the last: the kernel's
    device time per sweep by launch (profiler), the wall of a sweep with
    the poses' upload and the read-back (median of ``reps``) for the
    kernel and for the plain version on the card, the plain version's
    wall on the CPU, and the bound. Returns the numbers of the kernels
    line, from the last sweep, or None untimed."""
    if not sweeps:
        raise AssertionError(f"{label}: the run made no loop-candidate sweep")
    live = []
    for k, (poses, ocfg, tried, took) in enumerate(sweeps):
        args = (ocfg.loop_radius, ocfg.loop_min_gap, ocfg.loop_nms_gap,
                ocfg.max_candidates, tried)
        kern = loop_sweep_cuda(poses, *args)
        card = loop_sweep_plain(poses, *args)
        host = loop_sweep_plain(poses.cpu(), *args)
        live.append(kern[1])
        if not (kern == card == host and kern[0] == took):
            raise AssertionError(
                f"{label} {k}: the kernel (picks {len(kern[0])}, live cells "
                f"{kern[1]}), the plain version on the card ({len(card[0])}, "
                f"{card[1]}) and on the CPU ({len(host[0])}, {host[1]}) and "
                f"the run ({len(took)} picks) disagree")
    print(f"{label}: {len(sweeps)} sweeps at T={sweeps[0][0].shape[0]}: "
          f"kernel, plain version on the card and on the CPU equal, and "
          f"equal to the run's picks; picks {[len(s[3]) for s in sweeps]} "
          f"live cells {live} tried {[len(s[2]) for s in sweeps]}",
          flush=True)
    if not reps:
        return None
    out = None
    for k in sorted({0, len(sweeps) - 1}):
        poses, ocfg, tried, _took = sweeps[k]
        args = (ocfg.loop_radius, ocfg.loop_min_gap, ocfg.loop_nms_gap,
                ocfg.max_candidates, tried)
        T, dev = poses.shape[0], poses.device
        host = poses.cpu()
        _w, _b, per = device_profile(
            lambda: [loop_sweep_cuda(poses, *args) for _ in range(reps)],
            stages=True)
        dev_us = {st: per[f"loop_sweep_{st}"][1] / reps
                  for st in ("cells", "select")}
        if any(per[f"loop_sweep_{st}"][0] != reps for st in dev_us):
            raise AssertionError(f"{label} {k}: not one launch of each "
                                 "kernel a sweep")
        kern_ms = wall_ms(lambda: loop_sweep_cuda(host.to(dev), *args), reps)
        card_ms = wall_ms(lambda: loop_sweep_plain(host.to(dev), *args), reps)
        host_ms = wall_ms(lambda: loop_sweep_plain(host, *args), reps)
        work = sweep_bound(T, ocfg.loop_min_gap, len(tried),
                           ocfg.max_candidates)
        print(f"{label} {k} (tried {len(tried)}): kernel device "
              f"{dev_us['cells']:.2f} (cells) + {dev_us['select']:.2f} "
              f"(select) us a sweep (profiler, {reps} sweeps); wall with "
              f"upload and read-back: kernel {kern_ms:.4f} ms, plain "
              f"version on the card {card_ms:.3f} ms; plain version on the "
              f"CPU {host_ms:.3f} ms (median of {reps}); bound "
              f"{work['bound_ms']:.6f} ms ({work['bound_by']})", flush=True)
        out = {"max_abs_err": 0.0, "ms": sum(dev_us.values()) / 1e3,
               "wall_ms": kern_ms, "plain_ms": card_ms,
               "plain_cpu_ms": host_ms, **work}
    return out


def pcg_compare(label: str, dev, args, kw, reps: int = 3) -> dict:
    """The PCG-LM kernel against its plain version on ``fused_lm_solve``'s
    arguments: poses within LM_POSE_TOL, final χ² within LM_COST_RTOL.
    Prints both times (the plain version's over ``min(reps, 2)`` runs),
    the variant (hot set in shared memory or device memory), the PCG
    iterations the solve ran (the dependent steps) and the time of each,
    and the bound; returns them with max_abs_err."""

    def kern():
        return fused_lm_solve(*args, **kw)[5]

    def plain():
        return pcg_lm_plain(*args, **kw)

    k, p = kern(), plain()
    torch.cuda.synchronize()
    M, E = args[0].shape[0], args[1].shape[0]
    dpose = float((k[0:3, :M] - p[0:3, :M]).abs().max())
    c0, kc, pc = float(k[3, 0]), float(k[3, 1]), float(p[3, 1])
    # χ² as streamed_compare holds it: within LM_COST_RTOL, or both ~0
    ok = (bool(torch.isfinite(k).all()) and dpose <= LM_POSE_TOL
          and (abs(kc - pc) <= LM_COST_RTOL * abs(pc) + 1e-6
               or max(kc, pc) <= 1e-6 * c0))
    ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, min(reps, 2))
    # per LM iteration the edge work and ~60 FLOPs per node (damping, the
    # 3×3 preconditioner inverse); per PCG iteration two 3×3 block
    # products per edge (36) and ~60 per node (diagonal block, the
    # preconditioner, three dot products and three updates); a restart's
    # true residual is one more such matvec and update
    iters, cg = int(k[3, 3]), int(k[4, 0])
    restarts = iters * (kw.get("cg_restarts", 1) - 1)
    work = bound(12 * M + 16 * E + 48 * E + E + M + k.numel() * 4,
                 iters * (lm_edge_flops(E) + 60 * M)
                 + (cg + restarts) * (36 * E + 60 * M))
    blocks, logS, _qmax, smem = pcg_lm.launch_geometry(pcg_lm._incidence(
        args[1].cpu().numpy(), args[2].cpu().numpy(), M)[0])
    variant = (f"{blocks} blocks of {1 << logS} nodes, hot set in "
               + (f"shared memory ({smem} B a block)" if smem
                  else "device memory"))
    print(f"{label}: nodes={M} edges={E} {variant} pose max|d|="
          f"{dpose:.3e} cost0 {c0:.6g} cost kernel {kc:.6g} "
          f"plain {pc:.6g} iters kernel {iters} plain {int(p[3, 3])}; kernel "
          f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {work['bound_ms']:.5f} "
          f"ms ({work['bound_by']}); dependent steps {cg} PCG iterations, "
          f"{ms / max(cg, 1) * 1e3:.3f} µs a step", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the PCG-LM kernel disagrees with its "
                             "plain version")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work,
            "packed": k}


def pcg_args(dev, solver, poses=None):
    """``fused_lm_solve``'s arguments and settings for a solver's graph,
    started from ``poses`` (the solver's own when None)."""
    cfg = solver.cfg
    dposes, ei, ej, means, infos, free = solver.device_graph()
    if poses is not None:
        dposes = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    args = (dposes, ei, ej, means, infos,
            torch.ones_like(ei, dtype=torch.bool), free, cfg.initial_lambda)
    kw = dict(iters=cfg.max_iterations, cg_iters=cfg.cg_iterations,
              cg_tol=cfg.cg_tolerance,
              sq_min_delta=_sq_min_delta(cfg.convergence_delta))
    return args, kw


def phase_pcg(dev, res) -> tuple[dict, torch.Tensor]:
    """PCG-LM kernel vs plain on the mission's loop-closed graph, started
    from the raw chain: (its numbers, the kernel's packed result)."""
    out = pcg_compare("pcg_lm", dev, *pcg_args(dev, res.solver,
                                                 res.chain_poses))
    return out, out.pop("packed")


def phase_pcg_edges(dev) -> None:
    """The PCG-LM kernel against its plain version at the ends of its
    route: a 129-node ring with cross closures (the fewest nodes the card
    sends it: one block), a 2,999-node chain with skip edges every 8 and
    32 nodes that does not band (the most nodes under ``f64_schur_above``:
    six blocks), and the same chain at 9,000 nodes with
    ``f64_schur_above`` off, whose node ranges do not fit shared memory
    and take the device-memory variant."""
    cfg = SolverConfig()
    init, ei, ej, means, infos = _ring_edges(129, 4, np.random.default_rng(31))
    cases = [("edge pcg_lm ring", cfg, solver_from_numpy(
        cfg, init, list(zip(ei, ej, means, infos)), dev))]
    for n, c in ((2999, cfg), (9000, dataclasses.replace(cfg,
                                                          f64_schur_above=0))):
        cases.append((f"edge pcg_lm skip chain {n}", c, solver_from_numpy(
            c, *exact_chain(n, (8, 32), every=False), dev)))
    variants = []
    for label, c, s in cases:
        route = _route(s.num_nodes, s.num_edges, dev, c, s._band_spec)
        if route != "pcg":
            raise AssertionError(f"{label}: routed to {route}, not the "
                                 "PCG-LM kernel")
        args, kw = pcg_args(dev, s)
        pcg_compare(label, dev, args, kw, reps=2)
        variants.append(pcg_lm.launch_geometry(pcg_lm._incidence(
            args[1].cpu().numpy(), args[2].cpu().numpy(), s.num_nodes)[0])[3])
    if not (variants[0] and variants[1] and variants[2] == 0):
        raise AssertionError("PCG-LM edge cases: the variants are not "
                             "shared, shared, device memory")


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


def device_profile(fn, stages: bool = False):
    """Run ``fn`` once under ``torch.profiler``, tracing the card alone (a
    host trace of every small op costs more to record and read than the
    run): (wall µs, device busy µs as the union of the kernel intervals,
    {kernel: (launches, device µs)}), each hand-written kernel by name and
    the rest as "other"; with ``stages``, a kernel of several stages
    (``<key>_<stage>_kernel``) by stage."""
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
        stage = re.search(rf"(^|\W){key}_(\w+?)_kernel\b", name)
        if stages and stage:
            key = f"{key}_{stage[2]}"
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
    return (cfg, *run_hector_slam.recipe(cfg, dev, n))


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
    ms, host_us, how = graph_ms(kern, 200)
    plain_ms = cuda_ms(plain, 20)
    nbytes, flops = hector_work(probs, slam.grid_cfgs, slam.cfg.hector,
                                guess, pts, valid)
    work = bound(nbytes, flops)
    hc = slam.cfg.hector
    steps = hc.iterations_fine + 1 + (len(probs) - 1) * (
        hc.iterations_coarse + 1)
    split = hector_geometry(pts.shape[0])
    print(f"hector: grid {slam.grid_cfgs[0].size_x}^2 x "
          f"{len(slam.grid_cfgs)} levels, match |xy - truth| {err:.4f} m "
          f"kernel {ms:.4f} ms ({how}; the wrapper's host {host_us:.1f} us "
          f"a call), {split.threads} threads x {split.beams} beams a thread, "
          f"{steps} GN steps (the dependent steps), {ms * 1e3 / steps:.3f} "
          f"us a step, {BARRIERS_PER_STEP} barrier a step (design); plain "
          f"{plain_ms:.3f} ms; work {nbytes} bytes {flops:.0f} FLOPs, bound "
          f"{work['bound_ms']:.6f} ms ({work['bound_by']})", flush=True)
    if err > 0.03:
        raise AssertionError("the Hector match missed the true pose")
    return {"max_abs_err": dpose, "ms": ms, "plain_ms": plain_ms, **work}


def phase_hector_edges(dev) -> None:
    """The Hector kernel against its plain version off the main path's
    shapes: 100, 1,080 and 5,000 beams (more than one pass of the largest
    instance holds: two chunks); no valid beam (the pose comes back, H = 0); a
    trajectory 0.9 m from the map's east edge (the map shifted so half
    the beams fall off it); pyramids of 1 and 4 levels."""
    # 1,080: several beams a thread; 5,000: in chunks
    for beams in (100, 1080, 5000):
        slam, probs, guess, pts, valid, _t = hector_case(dev, beams=beams)
        split = hector_geometry(beams)
        hector_compare(slam, probs, guess, pts, valid,
                       f"edge hector {beams} beams ({split.threads} threads "
                       f"x {split.beams} beams x {split.chunks} chunks)")
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


def karto_recipe(dev):
    """examples/run_karto_slam.py's recipe at the full ``default_config()``
    (360 beams, 12 m; the 0.3 m / 0.01 m front grid of 2,445² cells, the
    8 m / 0.05 m loop grid of 645²): the corridor loop (arm 9 m, width
    2.6 m, 0.9 m/s, 352 scans), noise 0.004, seed 8, and the drifting
    odometry. Returns (cfg, scans on ``dev``, odometry, true poses)."""
    cfg = default_config()
    return (cfg, *run_karto_slam.recipe(cfg, dev))


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


def window_cells(grid, ys, xs, valid, nx, ny, stride) -> int:
    """The distinct grid cells that the valid beams' windows read (starts
    clamped as ``sum_windows`` clamps them): the bytes of the grids that
    the function needs, a lane at a time."""
    C, H, W = grid.shape
    dev = grid.device
    lat = ((torch.arange(ny, device=dev) * (stride * W))[:, None]
           + torch.arange(nx, device=dev) * stride).reshape(-1)
    span_x, span_y = (nx - 1) * stride + 1, (ny - 1) * stride + 1
    cells = 0
    for c in range(C):
        starts = (torch.clamp(ys[c].long(), 0, H - span_y) * W
                  + torch.clamp(xs[c].long(), 0, W - span_x))
        starts = torch.unique(starts[:, valid[c]])
        touched = torch.zeros(H * W, dtype=torch.bool, device=dev)
        for k in range(0, len(starts), 4096):
            touched[(starts[k:k + 4096, None] + lat).reshape(-1)] = True
        cells += int(touched.sum())
    return cells


def response_compare(label, grid, ys, xs, valid, nx, ny, stride,
                     reps=(100, 2)):
    """The kernel against its plain version: int32 equality, the launch
    geometry, both times (the kernel's from ``graph_ms``, the plain
    version's from CUDA events) and the nodes of one pass's CUDA graph
    (none of these when ``reps`` is 0), and the bound of this work.
    ``valid`` is (C, N), or (N,) taken by every lane."""
    C, A, N = ys.shape
    valid = valid.expand(C, N)

    def kern():
        return responses_sliced(grid, ys, xs, valid, nx, ny, stride)

    def plain():
        return corr.sum_windows(grid, ys, xs, valid, nx, ny, stride)

    k, pl = kern(), plain()
    torch.cuda.synchronize()
    err = int((k - pl).abs().max())
    nv = int(valid.sum())
    # the grid cells the valid beams' windows read, the starts and the
    # flags read once, the numerators written once; one 32-bit add per two
    # candidates of each lane, heading and valid beam of the lane (the
    # kernel sums two candidates in the 16-bit halves of one register)
    cells = window_cells(grid, ys, xs, valid, nx, ny, stride)
    nbytes = cells + 8 * ys.numel() + C * N + 4 * k.numel()
    ops = A * nx * ny * nv / 2
    work = bound(nbytes, ops, PEAK_INT32_OPS)
    g = corr_response.response_geometry(C, A, grid.shape[2], nx, ny, stride,
                                        N, _dispatch.sm_count(grid.device))
    shape = (f"geometry path={g.path} R={g.R} warps={g.threads // 32} "
             f"blocks={g.blocks(C, A, nx, ny, stride)} strips/tile="
             f"{g.strips} slices={g.slices} no cluster")
    ms, plain_ms, times = None, None, "not timed"
    if reps[0]:
        ms, host_us, how = graph_ms(kern, reps[0])
        launches, others = graph_nodes(kern)
        plain_ms = cuda_ms(plain, reps[1])
        times = (f"one pass: {launches} kernel node(s), {others} other "
                 f"graph nodes; kernel {ms:.4f} ms ({how}; the wrapper's "
                 f"host {host_us:.1f} us a call) plain {plain_ms:.3f} ms")
        if launches != 1 or others:
            raise AssertionError(f"{label}: a pass must be one kernel "
                                 f"launch and nothing else, got {launches} "
                                 f"kernels and {others} other device ops")
    print(f"{label}: lanes={C} headings={A} lattice={ny}x{nx} stride="
          f"{stride} beams={N} valid={nv} grid {grid.shape[1]}x"
          f"{grid.shape[2]} {shape} int32 equal {err == 0} max|d|={err} "
          f"sum {int(k.sum())} {times} bound {work['bound_ms']:.6f} ms "
          f"({work['bound_by']}; bytes {nbytes / PEAK_BYTES_PER_S * 1e3:.6f}"
          f" ms: {cells} grid cells of {grid.numel()} read; operations "
          f"{ops / PEAK_INT32_OPS * 1e3:.6f} ms)", flush=True)
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
    return out, (slam, pts, valid, poses), front, loop


def phase_correlative_edges(dev, records, front, loop) -> None:
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
    # every window at the far corner: the lattice's last row and column on
    # the grid's
    response_compare("edge correlative starts at the far edge", grid,
                     torch.full_like(ys, H - (ny - 1) * stride - 1),
                     torch.full_like(xs, W - (nx - 1) * stride - 1), v, nx,
                     ny, stride, reps=(0, 0))
    # 1 beam; 656, 1,500 and 4,000 beams (more than a round stages)
    response_compare("edge correlative 1 beam", grid,
                     ys[..., :1].contiguous(), xs[..., :1].contiguous(),
                     v[:1].contiguous(), nx, ny, stride, reps=(0, 0))
    for n in (656, 1500, 4000):
        big = torch.randint(0, 2000, (1, ys.shape[1], n), generator=g,
                            dtype=torch.int32).to(dev)
        flags = (torch.rand(n, generator=g) > 0.1 if n != 1500
                 else torch.ones(n, dtype=torch.bool))
        response_compare(f"edge correlative {n:,} beams", grid, big,
                         big.flip(-1).contiguous(), flags.to(dev), nx, ny,
                         stride, reps=(0, 0))
    # odd nx at stride 1 and 2, where the candidates a thread do not
    # divide the row, and a 1 x 1 lattice
    for lnx, lny, ls in ((17, 5, 2), (7, 3, 1), (9, 9, 1), (1, 1, 1)):
        y3, x3 = corr.window_starts(q, v, angles, torch.tensor(
            [[W // 3, H // 3]], dtype=torch.int32, device=dev), H, W, lnx,
            lny, ls)
        response_compare(f"edge correlative lattice {lny}x{lnx} stride {ls}",
                         grid, y3, x3, v, lnx, lny, ls, reps=(0, 0))
    # a grid whose base is 1 byte past an 8-byte boundary
    buf = torch.empty(grid.numel() + 4, dtype=torch.uint8, device=dev)
    odd = buf[1:1 + grid.numel()].view(grid.shape)
    odd.copy_(grid)
    response_compare("edge correlative grid base not 8-byte aligned", odd, ys,
                     xs, v, nx, ny, stride, reps=(0, 0))
    # 8 lanes (the loop pass's grids, random values): each lane's own
    # flags (lane stride N, lane 3 with none valid), one scan's (lane
    # stride 0), and 4,000 beams with lane 0's grid all 100
    lgrid, lys, lxs, lv, lnx, lny, ls = loop
    lgrid = torch.randint(0, 101, lgrid.shape, generator=g,
                          dtype=torch.uint8).to(dev)
    C, A, N = lys.shape
    own = (torch.rand(C, N, generator=g) > 0.2).to(dev)
    own[3] = False
    response_compare("edge correlative 8 lanes, own flags (lane stride N, "
                     "lane 3 none valid)", lgrid, lys, lxs, own, lnx, lny, ls,
                     reps=(0, 0))
    response_compare("edge correlative 8 lanes, one scan's flags (lane "
                     "stride 0)", lgrid, lys, lxs, own[0], lnx, lny, ls,
                     reps=(0, 0))
    lgrid[0] = 100
    Hl, Wl = lgrid.shape[1:]
    big_y = torch.randint(0, Hl - (lny - 1) * ls, (C, A, 4000), generator=g,
                          dtype=torch.int32).to(dev)
    big_x = torch.randint(0, Wl - (lnx - 1) * ls, (C, A, 4000), generator=g,
                          dtype=torch.int32).to(dev)
    response_compare("edge correlative 4,000 beams at the loop shape, lane 0 "
                     "all 100", lgrid, big_y, big_x,
                     torch.ones(4000, dtype=torch.bool, device=dev), lnx,
                     lny, ls, reps=(0, 0))
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


def phase_karto_main(dev, cfg, scans, odom, gt):
    """The counted online Karto run at full width, its rate, stages and
    profile; (its launches, the counted run's mapper, its accepted
    scans)."""
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
    karto_map_check("karto online map", slam, dev)
    # the counted run warmed the path: one timed run follows it (a profile
    # of the whole run took ~2 min to tear down: it profiles a window)
    wall = karto_run(cfg, scans, odom, dev)[2]
    print(f"karto: scans/s {T / wall:.1f} in one run after the counted one, "
          f"{T} scans offered", flush=True)
    n = KARTO_PROFILE_SCANS
    wall_us, busy, per = device_profile(lambda: karto_run(
        cfg, index_scan(scans, slice(0, n)), odom[:n], dev))
    print(profile_line(f"karto run (first {n} scans)", wall_us, busy, per),
          flush=True)
    return launches, slam, acc


# --- the outdoor offline mission ------------------------------------------


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def outdoor_recipe(dev, n: int | None = None):
    """benchmarks/bench_outdoor.py's 1-lap recipe (bench_outdoor.py:100-124)
    on the port's simulator: ``preset("karto_outdoor")``, outdoor_world(arm
    80, street 16, seed 4), the street's centre line at 0.9 m/s and 0.1 s
    a scan (3,234 scans of 360 beams), noise 0.01 with seed 6, odometry
    noise 0.015 m and 0.003 rad from default_rng(3); the first ``n`` scans
    where given. Returns (cfg, scans on ``dev``, odometry, true poses)."""
    cfg = preset("karto_outdoor")
    traj = sim.outdoor_lap(arm=80.0, street=16.0)
    if n:
        traj = traj[:n]
    world = sim.outdoor_world(arm=80.0, street=16.0, seed=4)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.01, seed=6)
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = gnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.015, 2)
        d[2] += rng.normal(0, 0.003)
        odom.append(gnp.compose(odom[-1], d))
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32), device=dev)
    return cfg, scans, np.asarray(odom), seq.gt_poses


def outdoor_run(cfg, scans, odom):
    timer = StageTimer()
    t0 = time.perf_counter()
    res = offline_slam(scans, cfg, odom=odom, timer=timer)
    torch.cuda.synchronize()
    return res, timer, time.perf_counter() - t0


def anchor_passes(cfg, scans, poses) -> list:
    """The first anchor group of each level of the mission's sweep, at
    ``poses``, recorded pass by pass where the matcher would launch the
    correlative kernel (the plain version answers): [(label, the kernel's
    arguments)]."""
    dev = scans.device
    T = poses.shape[0]
    ocfg = cfg.offline
    store_pts = torch.as_tensor(offline.laser_points(
        scans.ranges.cpu().numpy(), scans.valid.cpu().numpy(),
        scans.angles.cpu().numpy()), device=dev)
    passes = []
    for level, matcher, span, gap, step in offline.anchor_levels(cfg, T,
                                                                 dev):
        lane_ts = np.arange(span, T, step)[:ocfg.anchor_lanes]
        group = offline.anchor_group(lane_ts, span, gap, ocfg.anchor_scans,
                                     ocfg.anchor_lanes, poses)
        calls = []

        def recording(*args):
            calls.append(args)
            return corr.sum_windows(*args)

        with patched(corr_response, "responses_sliced", recording):
            matcher.match_anchors_store_async(store_pts, scans.valid, *group)
        if len(calls) != 2:
            raise AssertionError(f"anchor group: {len(calls)} response "
                                 "passes recorded, not a coarse and a fine")
        name = "long" if level else "short"
        passes += [(f"correlative anchor {name} {kind}", args)
                   for kind, args in zip(("coarse", "fine"), calls)]
    if len(passes) != 4:
        raise AssertionError(f"{len(passes)} anchor passes, not 4")
    return passes


def phase_outdoor_main(dev) -> dict:
    """The outdoor offline mission at full width, with the launch counters
    zeroed first: a warm-up on the recipe's first 600 scans (under the
    drift-control route: no skip edge, no anchor), then one timed run of
    the 3,234 scans through ``offline_slam``. Its wall and scans/s, the
    stage timer, the skip edges, anchors and loops accepted, the route of
    the solves, the chain and final ATE; then the correlative kernel int32
    for int32 against its plain version on one anchor group of each
    level, both passes, at the final poses. Returns the run's launches."""
    cfg, scans, odom, gt = outdoor_recipe(dev, OUTDOOR_WARM_SCANS)
    outdoor_run(cfg, scans, odom)
    cfg, scans, odom, gt = outdoor_recipe(dev)
    T = len(gt)
    _dispatch.reset_launches()
    with recording_sweeps() as sweeps:
        res, timer, wall = outdoor_run(cfg, scans, odom)
    launches = dict(_dispatch.LAUNCHES)
    skips = res.skip_edges
    route = _route(res.solver.num_nodes, res.solver.num_edges, dev,
                   res.solver.cfg, res.solver._band_spec)
    lm = {k: launches[k] for k in ("pcg_lm", "cr_lm", "cr_stream")}
    ate_chain = float(ate_rmse(res.chain_poses, gt))
    ate = float(ate_rmse(res.poses, gt))
    found = {"skip edges": skips, "anchors": res.anchors_accepted,
             "loops": len(res.loops)}
    print(f"outdoor main path: scans={T} route "
          f"{float(np.sum(np.hypot(*res.chain_rels[:, :2].T))):.1f} m wall "
          f"{wall:.2f} s ({T / wall:.1f} scans/s; one run after a "
          f"{OUTDOOR_WARM_SCANS}-scan warm-up) skip edges {skips} anchors "
          f"{res.anchors_accepted}/{res.anchors_tried} loops "
          f"{len(res.loops)} candidates {res.candidates_tried} solves "
          f"{timer.counts['solve']} (route of the final graph {route}; LM "
          f"kernel launches {lm}) ATE chain {ate_chain:.5f} m final "
          f"{ate:.5f} m (reference 0.005 m, bar {OUTDOOR_ATE_MAX} m); "
          f"launches {launches}", flush=True)
    print("outdoor stage timer:\n" + timer.report(), flush=True)
    if not np.all(np.isfinite(res.poses)) or res.poses.shape != (T, 3):
        raise AssertionError("outdoor poses are not finite (T, 3)")
    if not (ate <= OUTDOOR_ATE_MAX and ate < ate_chain):
        raise AssertionError(f"outdoor ATE {ate:.5f} m: above "
                             f"{OUTDOOR_ATE_MAX} m or the chain's")
    for what, least in OUTDOOR_MIN.items():
        if found[what] < least:
            raise AssertionError(f"outdoor: {found[what]} {what}, fewer "
                                 f"than {least}")
    if not (launches["plicp_fused"] and launches["correlative_response"]):
        raise AssertionError("the outdoor run did not launch the PL-ICP and "
                             "correlative kernels")
    if launches["loop_sweep"] != timer.counts["candidates"]:
        raise AssertionError("not every outdoor loop-candidate sweep ran its "
                             "kernel")
    phase_loop_sweep("outdoor sweeps", sweeps)
    for label, args in anchor_passes(cfg, scans, res.poses):
        response_compare(label, *args, reps=(20, 1))
    return launches


# --- the online outdoor run and the maps ----------------------------------


_SOLVE_ROUTES = {"dense": "_compute_dense", "pcg": "_compute_pcg",
                 "direct": "_compute_direct", "host_f64": "_compute_host_f64"}


@contextlib.contextmanager
def solve_routes():
    """Inside the block each solve a ``PoseGraphSolver`` dispatches is
    noted where it takes its route: [(route, poses (M, 3) it starts from,
    edges as ``solver_from_numpy`` takes them)]. The note copies the
    graph's lists and nothing else; the solve runs as it would."""
    solves = []
    olds = {name: getattr(PoseGraphSolver, name)
            for name in _SOLVE_ROUTES.values()}

    def noting(route, fn):
        def run(self, *args, **kw):
            solves.append((route, np.array(self._poses), list(self._edges)))
            return fn(self, *args, **kw)
        return run

    try:
        for route, name in _SOLVE_ROUTES.items():
            setattr(PoseGraphSolver, name, noting(route, olds[name]))
        yield solves
    finally:
        for name, fn in olds.items():
            setattr(PoseGraphSolver, name, fn)


def route_counts(solves, dev, cfg) -> dict:
    """The solves by route, each held to the route ``_route`` gives for its
    size and its band spec (RCM from its edges, no cache)."""
    counts = dict.fromkeys(_SOLVE_ROUTES, 0)
    for route, poses, edges in solves:
        n, e = len(poses), len(edges)
        ei = np.array([x[0] for x in edges], np.int64)
        ej = np.array([x[1] for x in edges], np.int64)
        want = _route(n, e, dev, cfg, lambda: banded.prepare_banded(
            ei, ej, n, cfg.direct_max_bandwidth))
        if route != want:
            raise AssertionError(f"a solve of {n} nodes and {e} edges took "
                                 f"{route}, not {want}")
        counts[route] += 1
    return counts


def lm_final_compare(label: str, dev, cfg, solves) -> None:
    """The LM kernel that took the run's largest kernel solve against its
    plain version on that solve's graph and starting poses, with
    ``phase_pcg``'s bars."""
    route, poses, edges = max(
        (s for s in solves if s[0] in ("pcg", "direct")),
        key=lambda s: len(s[1]))
    solver = solver_from_numpy(cfg, poses, edges, dev)
    if route == "pcg":
        pcg_compare(f"{label} pcg_lm", dev, *pcg_args(dev, solver))
    elif solver._band_spec().K <= cr_lm.K_MAX:
        cr_compare(f"{label} cr_lm", dev, cfg, poses, edges,
                   _sq_min_delta(cfg.convergence_delta))
    else:
        streamed_compare(f"{label} cr_stream", dev, poses, edges)


def recorded_passes(slam) -> list:
    """Three correlative passes from a mapper's final state, recorded where
    the matcher would launch the kernel (the plain version answers): the
    front coarse and fine passes of its last scan against its running
    buffer, and the loop coarse pass of that scan against the chains in
    the loop search's range (the near-linked ones too, so that a closed
    loop still has candidates), 8 lanes at most. [(label, the kernel's
    arguments)]."""
    rec = slam.scans[-1]
    sid = rec.state_id
    running = [i for i in slam.sensors[rec.sensor].running if i != sid]
    _near, in_range = slam._loop_gather_state(sid)
    chains, start = [], 0
    while len(chains) < 8:
        chain, start = slam._find_possible_loop(
            sid, start, rec.sensor, gather_state=(set(), in_range))
        if not chain:
            break
        chains.append(chain)
    if not chains:
        raise AssertionError("no loop candidate chain for the last scan")
    calls = []

    def recording(*args):
        calls.append(args)
        return corr.sum_windows(*args)

    with patched(corr_response, "responses_sliced", recording):
        slam._match(slam.front_matcher, rec, running, rec.corrected_pose)
        slam._match_chains(slam.loop_matcher, rec, chains,
                           rec.corrected_pose, do_penalize=False,
                           do_fine=False)
    if len(calls) != 3:
        raise AssertionError(f"{len(calls)} response passes recorded, not "
                             "a front coarse, a front fine and a loop coarse")
    return [(f"correlative online outdoor {name}", args) for name, args in
            zip(("front coarse", "front fine", "loop coarse"), calls)]


def map_counts(m: np.ndarray) -> str:
    return (f"{(m == 100).sum()} occupied / {(m == 0).sum()} free / "
            f"{(m == -1).sum()} unknown")


def karto_map_check(label: str, slam, dev, budget_s=None) -> None:
    """``karto_map`` of a mapper on the card: its wall (median of 3 after a
    warm call) and cell counts. Then ``occupancy_from_scans`` on the card
    against the CPU, int8 for int8, on the same grid and corrected poses:
    every scan, or with ``budget_s`` every stride-th scan, the stride
    chosen from a CPU run of 8 scans so that the CPU run takes about
    ``budget_s``."""
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        m, grid = occ.karto_map(slam)
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(walls[1:])[1]
    if m.shape != (grid.size_y, grid.size_x) or not (m == 100).any():
        raise AssertionError(f"{label}: the map has no occupied cell")
    poses, pts, ranges = occ._map_inputs(slam)
    T = len(poses)
    sc = slam.cfg.scan
    kw = dict(range_threshold=sc.range_threshold, min_range=sc.range_min,
              max_range=sc.range_max)

    def cpu_map(sel):
        t0 = time.perf_counter()
        out = occ.occupancy_from_scans(grid, poses[sel], pts[sel],
                                       ranges[sel], device="cpu", **kw)
        return out, time.perf_counter() - t0

    stride = 1
    if budget_s is not None:
        _m, s8 = cpu_map(slice(0, T, max(1, T // 8)))
        per_scan = s8 / len(range(0, T, max(1, T // 8)))
        stride = max(1, int(np.ceil(T * per_scan / budget_s)))
    sel = slice(0, T, stride)
    want, cpu_s = cpu_map(sel)
    got = m if stride == 1 else occ.occupancy_from_scans(
        grid, poses[sel], pts[sel], ranges[sel], device=dev, **kw)
    split = int((got != want).sum())
    print(f"{label}: karto_map of {T} scans x {pts.shape[1]} beams "
          f"({gm.karto_max_steps(grid, sc.range_threshold)} steps a ray) on "
          f"a {grid.size_x}x{grid.size_y} grid at {grid.resolution} m: "
          f"{ms:.1f} ms wall (median of 3 after a warm call; "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms), {map_counts(m)}; "
          f"held to the CPU's occupancy_from_scans on every {stride}. scan "
          f"({len(range(0, T, stride))} scans, CPU {cpu_s:.2f} s): int8 equal "
          f"{split == 0} ({split} cells differ; {map_counts(want)})",
          flush=True)
    if split:
        raise AssertionError(f"{label}: the card's map differs from the "
                             "CPU's")


def outdoor_online_run(cfg, scans, odom, dev):
    """``KartoSLAM.run`` then ``flush``: (mapper, accepted indices,
    wall s)."""
    slam = KartoSLAM(cfg, device=dev)
    t0 = time.perf_counter()
    acc = slam.run(scans, odom)
    slam.flush()
    torch.cuda.synchronize()
    return slam, acc, time.perf_counter() - t0


def phase_outdoor_online(dev, recipe=outdoor_recipe) -> dict:
    """The online outdoor run (bench_outdoor.py --online, 1 lap) at full
    width, with the launch counters zeroed first: ``KartoSLAM.run`` and
    ``flush`` over the recipe's 3,234 scans under
    ``preset("karto_outdoor")`` and its synchronous back end, once. Its
    wall and scans/s, the accepted scans, closures and solves by route
    (each held to ``_route``'s route for its size), the stage timer, the
    launches and the ATE against the raw odometry's; then the correlative
    kernel on three passes recorded from the final state, the LM kernel
    that took the largest kernel solve against its plain version on that
    graph, ``karto_map`` of the result held to the CPU on a stride of its
    scans, and a profile of the run's first scans. Returns the run's
    launches. A ``[time]`` line after each step gives its wall."""
    clock = PhaseClock()
    cfg, scans, odom, gt = recipe(dev)
    clock("outdoor online: recipe")
    if cfg.karto.async_loop_closure:
        raise AssertionError("the online outdoor run takes the synchronous "
                             "back end")
    T = len(gt)
    _dispatch.reset_launches()
    with solve_routes() as solves:
        slam, acc, wall = outdoor_online_run(cfg, scans, odom, dev)
    launches = dict(_dispatch.LAUNCHES)
    clock("outdoor online: run")
    est = slam.trajectory()
    ate = float(ate_rmse(est, gt[acc]))
    ate_odom = float(ate_rmse(odom[acc], gt[acc]))
    routes = route_counts(solves, dev, slam.solver.cfg)
    clock("outdoor online: routes checked")
    big = max((len(p), len(e)) for _r, p, e in solves) if solves else (0, 0)
    lm = {k: launches[k] for k in ("pcg_lm", "cr_lm", "cr_stream")}
    ref = OUTDOOR_ONLINE_REF
    print(f"outdoor online main path: scans={T} wall {wall:.2f} s "
          f"({T / wall:.1f} scans/s offered, one run) accepted {len(acc)} "
          f"(reference {ref['accepted']}) closures {slam.loop_closures} "
          f"solves {len(solves)} (reference {ref['solves']}) by route "
          f"{routes}, the largest {big[0]} nodes {big[1]} edges; LM kernel "
          f"launches {lm}; ATE {ate:.5f} m (reference {ref['ate']} m, bar "
          f"{OUTDOOR_ONLINE_ATE_MAX} m) raw odometry {ate_odom:.4f} m; "
          f"launches {launches}", flush=True)
    print("outdoor online stage timer:\n" + slam.timer.report(), flush=True)
    if est.shape != (len(acc), 3) or not np.all(np.isfinite(est)):
        raise AssertionError("online outdoor poses are not finite")
    if not (ate <= OUTDOOR_ONLINE_ATE_MAX and ate < ate_odom):
        raise AssertionError(f"online outdoor ATE {ate:.5f} m: above "
                             f"{OUTDOOR_ONLINE_ATE_MAX} m or the odometry's")
    if slam.loop_closures < 1:
        raise AssertionError("the online outdoor run closed no loop")
    if launches["correlative_response"] == 0:
        raise AssertionError("the online outdoor run launched no "
                             "correlative kernel")
    if (lm["pcg_lm"] != routes["pcg"]
            or lm["cr_lm"] + lm["cr_stream"] != routes["direct"]):
        raise AssertionError("the LM kernel launches do not match the "
                             "solves' routes")
    if sum(lm.values()) == 0:
        raise AssertionError("no online solve launched an LM kernel")
    for label, args in recorded_passes(slam):
        response_compare(label, *args, reps=(20, 1))
    clock("outdoor online: correlative passes")
    lm_final_compare("outdoor online final graph", dev, slam.solver.cfg,
                     solves)
    clock("outdoor online: LM kernel")
    karto_map_check("outdoor online map", slam, dev,
                    budget_s=MAP_CPU_BUDGET_S)
    clock("outdoor online: map")
    n = OUTDOOR_ONLINE_PROFILE_SCANS
    timer = None

    def prefix():
        nonlocal timer
        s = KartoSLAM(cfg, device=dev)
        s.run(index_scan(scans, slice(0, n)), odom[:n])
        timer = s.timer

    print(profile_line(f"outdoor online run (first {n} scans)",
                       *device_profile(prefix)), flush=True)
    print("outdoor online profiled window's stage timer:\n"
          + timer.report(), flush=True)
    clock("outdoor online: profile")
    return launches


def gmapping_recipe():
    """examples/run_gmapping.py's recipe at the full ``default_config()``
    (360 beams, 12 m, the 1,024² grid at 0.05 m): the corridor loop (arm
    9 m, width 2.6 m, 0.9 m/s, 352 scans), noise 0.004, seed 6, at the
    true poses. Returns (cfg, ranges, float32 poses)."""
    cfg = default_config()
    scans, poses = run_gmapping.recipe(cfg, "cpu")
    return cfg, scans.ranges.numpy(), poses


def gmapping_run(cfg, ranges, poses, dev):
    """One map: (GMapping, int8 map, wall s of the scans and the map's
    read)."""
    scans = make_scan(ranges, cfg.scan, device=dev)
    t0 = time.perf_counter()
    gmap = GMapping(cfg, device=dev)
    gmap.run(scans, poses)
    m = gmap.to_ros_map()
    return gmap, m, time.perf_counter() - t0


def phase_gmapping(dev) -> None:
    """GMapping at full width on the card against the same run on the CPU:
    hits and visits equal, the cell means within GMAPPING_MEANS_RTOL
    relative and GMAPPING_MEANS_ATOL (the card's float atomics add in
    another order), the same map, and the
    example's bars; then its scans/s, the median of 3 runs after a warm
    one."""
    cfg, ranges, poses = gmapping_recipe()
    T = len(poses)
    gmap, m, _wall = gmapping_run(cfg, ranges, poses, dev)
    walls = [gmapping_run(cfg, ranges, poses, dev)[2] for _ in range(3)]
    cpu, cm, cpu_s = gmapping_run(cfg, ranges, poses, "cpu")
    hits_eq = torch.equal(gmap.hits.cpu(), cpu.hits)
    visits_eq = torch.equal(gmap.visits.cpu(), cpu.visits)
    means, cmeans = gmap.cell_means(), cpu.cell_means()
    dmeans = float(np.max(np.abs(means - cmeans)
                          - GMAPPING_MEANS_RTOL * np.abs(cmeans)
                          - GMAPPING_MEANS_ATOL))
    rates = sorted(T / w for w in walls)
    found = {"occupied": int((m == 100).sum()), "free": int((m == 0).sum())}
    print(f"gmapping: {T} scans x {cfg.scan.num_beams} beams on a "
          f"{cfg.grid.size_x}x{cfg.grid.size_y} grid: scans/s median "
          f"{rates[1]:.1f} (min {rates[0]:.1f} max {rates[2]:.1f}) over 3 "
          f"runs after a warm one (each with the map's read); {map_counts(m)}"
          f"; against the CPU run ({cpu_s:.2f} s): hits equal {hits_eq} "
          f"visits equal {visits_eq} map equal {np.array_equal(m, cm)} cell "
          f"means max(|d| - {GMAPPING_MEANS_RTOL} |cpu| - "
          f"{GMAPPING_MEANS_ATOL} m) {dmeans:.3e}",
          flush=True)
    if not (hits_eq and visits_eq and np.array_equal(m, cm)
            and dmeans <= 0.0):
        raise AssertionError("GMapping on the card differs from the CPU")
    for what, least in GMAPPING_MIN.items():
        if found[what] <= least:
            raise AssertionError(f"GMapping: {found[what]} {what} cells, "
                                 f"not more than {least}")


# --- the lesson front-ends and the NN kernel ------------------------------


def lesson_recipe(dev, n: int = LESSON_SCANS):
    """examples/run_plicp_odometry.py's recipe at the full
    ``default_config()`` (360 beams): an office circle of ``n`` scans
    (radius 1.6 m, 0.6 rad/s) in office_world(seed=21) with the path kept
    clear, noise 0.004, seed 4; (cfg, scans on ``dev``, true poses)."""
    cfg = default_config()
    return (cfg, *run_plicp_odometry.recipe(cfg, dev, n))


def scan_matching_recipe(dev, B: int = 120):
    """examples/run_scan_matching.py's recipe: B consecutive pairs of an
    office circle (office_world(seed=11), radius 1.6 m, 0.6 rad/s, noise
    0.004, seed 4); (cfg, the pairs on ``dev``, the true deltas (B, 3))."""
    cfg = default_config()
    return (cfg, *run_scan_matching.recipe(cfg, dev, B))


def nn_bound(B: int, N: int, M: int) -> dict:
    """The NN's least time: each input read once (8 bytes a point, 1 a
    target flag), each output written once (an 8-byte index and a 4-byte
    d2), and 6 float32 operations per source-target pair (two
    differences, a product, an fma, the penalty's add, the compare)."""
    return bound(B * (8 * N + 9 * M + 12 * N), 6.0 * B * N * M)


def nn_compare(label, src, tgt, tv, reps=None, lanes=None) -> dict:
    """The NN kernel against its plain version, equal bit for bit in idx
    and d2; with ``reps``, the kernel's device time per launch
    (``graph_ms``, with the wrapper's host µs per call beside it), the
    plain version's from CUDA events, and ``torch.cdist(...).min(-1)``'s
    for information (it ignores the flags, so it is no library time of
    this function). With ``lanes`` = G, the case must take G lanes a
    source. Returns (the numbers of the kernels line, the kernel's
    indices)."""

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
    geo = nn_geometry(B, N, M, torch.cuda.get_device_properties(
        src.device).multi_processor_count)
    work = nn_bound(B, N, M)
    times = "not timed"
    finite = torch.isfinite(kd) & torch.isfinite(pd)
    out = {"max_abs_err": float((kd.double() - pd.double())[finite].abs()
                                .max()) if bool(finite.any()) else 0.0,
           "ms": None, "plain_ms": None, **work}
    if reps:
        out["ms"], host_us, how = graph_ms(kern, reps[0])
        out["plain_ms"] = cuda_ms(plain, reps[1])
        cdist_ms = cuda_ms(lambda: torch.cdist(src, tgt).min(-1), reps[0])
        times = (f"kernel {out['ms']:.4f} ms ({how}; the wrapper's host "
                 f"{host_us:.1f} us a call) plain {out['plain_ms']:.3f} ms "
                 f"(cdist+min {cdist_ms:.4f} ms, for information)")
    print(f"{label}: B={B} N={N} M={M} geometry G={geo.lanes} "
          f"{geo.threads} threads x ({B}, {geo.tiles}) "
          f"blocks valid targets {int(tv.sum())} idx and d2 bit-equal "
          f"{same} d2 max {float(kd.max()):.6g}; {times} bound "
          f"{work['bound_ms']:.6f} ms ({work['bound_by']})", flush=True)
    if not same or ki.shape != (B, N):
        raise AssertionError(f"{label}: the NN kernel disagrees with its "
                             "plain version")
    if lanes and lanes != geo.lanes:
        raise AssertionError(f"{label}: took G={geo.lanes}, not the "
                             f"G = {lanes} it is for")
    return out, ki


def phase_nn(dev) -> dict:
    """The NN kernel against ``nearest_neighbor_direct`` at the odometry's
    shape (1, 360, 360), the scan-matching batch's (120, 360, 360), and
    off them: N ≠ M with odd counts, N = 1, M = 4,096 over many source
    tiles, no valid target, duplicated targets, sources far outside, and
    each path of ``nn_geometry``: G = 32 lanes with M < 32, M not a
    multiple of G, one lane a source with N = 361; and the reference's NaN
    rule, NaN sources and NaN targets (a row with a NaN distance: index
    M, d2 NaN).
    Returns the odometry shape's numbers."""
    _c, scans, _g = lesson_recipe(dev, 2)
    src, _sv, tgt, tv = masked_pairs(scans)
    odo, _i = nn_compare("nn odometry", src, tgt, tv, reps=(500, 50))
    _c, (bs, _bsv, bt, btv), _g = scan_matching_recipe(dev)
    nn_compare("nn scan-matching batch", bs, bt, btv, reps=(200, 5))
    g = torch.Generator().manual_seed(5)

    def pts(*shape, scale=3.0):
        return (torch.randn(*shape, 2, generator=g) * scale).to(dev)

    def flags(*shape):
        return (torch.rand(*shape, generator=g) < 0.8).to(dev)

    nn_compare("edge nn N != M, odd counts", pts(3, 101), pts(3, 77),
               flags(3, 77))
    nn_compare("edge nn N = 1", pts(4, 1), pts(4, 360), flags(4, 360))
    nn_compare("edge nn M = 4,096, many source tiles", pts(2, 1000),
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
    # the geometry's paths: G = 32 with M < 32 (lanes without a target),
    # M = 37 (not a multiple of G = 32), G = 1 with N = 361
    nn_compare("edge nn G = 32, M = 7", pts(1, 5), pts(1, 7), flags(1, 7),
               lanes=32)
    nn_compare("edge nn M = 37 over 32 lanes", pts(1, 100), pts(1, 37),
               flags(1, 37), lanes=32)
    nn_compare("edge nn 1 lane a source, N = 361", pts(400, 361),
               pts(400, 50), flags(400, 50), lanes=1)
    # the reference's NaN rule: a source with a NaN distance to any target
    # of its pair gets (M, NaN); a NaN target (valid or not) poisons its
    # pair
    nan_src = pts(2, 360)
    nan_src[0, ::7, 0] = float("nan")
    nan_src[1, ::5, 1] = float("nan")
    nan_tgt = pts(3, 360)
    nan_tgt[1, 11, 0] = float("nan")
    nan_tgt[2, 200, 1] = float("nan")
    nan_tv = flags(3, 360)
    nan_tv[2, 200] = False
    for label, s_, t_, v_ in (
            ("edge nn NaN sources", nan_src, pts(2, 360), flags(2, 360)),
            ("edge nn NaN targets", pts(3, 360), nan_tgt, nan_tv)):
        _o, idx = nn_compare(label, s_, t_, v_)
        nan_rows = (torch.isnan(s_).any(-1)
                    | torch.isnan(t_).any(-1).any(-1)[:, None])
        if not (torch.equal(idx == 360, nan_rows) and bool(nan_rows.any())):
            raise AssertionError(f"{label}: index M not exactly on the NaN "
                                 "rows")
    # past one staged chunk of 4,096 targets: M = 5,000 (2 chunks) and
    # 12,345 (4), the second chunk a copy of the first (the first copy
    # wins across chunks), and the NaN rule with a NaN target and a NaN
    # source in the third chunk's pairs
    for M in (5000, 12345):
        t_ = pts(3, M, scale=10.0)
        t_[:, 4096:min(M, 8192)] = t_[:, :min(M, 8192) - 4096]
        v_ = flags(3, M)
        v_[:, 4096:min(M, 8192)] = v_[:, :min(M, 8192) - 4096]
        s_ = pts(3, 400, scale=10.0)
        _o, idx = nn_compare(f"edge nn M = {M:,}, chunks of targets", s_,
                             t_, v_)
        in_copy = (idx >= 4096) & (idx < 8192)
        if bool(in_copy.any()):
            raise AssertionError(f"edge nn M = {M:,}: a later copy won")
        t_[1, M - 3, 0] = float("nan")
        s_[2, ::9, 1] = float("nan")
        _o, idx = nn_compare(f"edge nn M = {M:,} NaN", s_, t_, v_)
        nan_rows = (torch.isnan(s_).any(-1)
                    | torch.isnan(t_).any(-1).any(-1)[:, None])
        if not (torch.equal(idx == M, nan_rows) and bool(nan_rows.any())):
            raise AssertionError(f"edge nn M = {M:,} NaN: index M not "
                                 "exactly on the NaN rows")
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
    then each model's scans/s (one run after the counted one, which
    warms it) and one run of the first ``LESSON_PROFILE_SCANS``
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
        t0 = time.perf_counter()  # the counted run was the warm one
        lesson_run(make(), scans)
        print(f"lesson {name}: scans/s {T / (time.perf_counter() - t0):.1f} "
              "in one run after the counted one", flush=True)
        prof = device_profile(lambda: lesson_run(make(), window))
        print(profile_line(f"lesson {name} run, first {LESSON_PROFILE_SCANS} "
                           "scans", *prof), flush=True)
    return total


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
    return (cfg, *run_lidar_undistortion.recipe(cfg, dev))


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
    scans = run_feature_detection.recipe(cfg, dev)
    mask = extract_corner_features(scans, cfg.features)
    host = extract_corner_features(make_scan(scans.ranges.cpu(), cfg.scan,
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


# --- the examples ---------------------------------------------------

# the figures the reference examples print (examples/*.py --cpu, JAX on the
# CPU, run once): counts as printed, lengths to 4 decimals, the corner mean
# to 1
EXAMPLES_REF = {
    "run_feature_detection": {"mean": 90.8, "min": 78, "max": 110},
    "run_gmapping": {"occupied": 2177, "free": 25390, "unknown": 1021009},
    "run_hector_slam": {"ate": 0.0331, "occupied": 1066, "free": 36283,
                        "unknown": 224795},
    "run_karto_slam": {"accepted": 126, "closures": 1, "edges": 131,
                       "ate_odom": 0.2485, "ate": 0.0225, "occupied": 489,
                       "free": 3511},
    "run_lidar_undistortion": {"raw_err": 0.4871, "cor_err": 0.0002},
    "run_plicp_odometry": {"ate": 0.0009, "rpe": 0.0007},
    "run_scan_matching": {"icp": (0.0052, 0.0071), "plicp": (0.0004, 0.0001)},
}
EXAMPLE_MAP_RTOL = 0.03  # occupied / free cells where the card's sums differ


def _slack(ref: float) -> float:
    """An accuracy figure's bar: the lesson phases' slack over the
    reference's printed figure."""
    return LESSON_ATE_SLACK[0] * ref + LESSON_ATE_SLACK[1]


def example_bars(name: str, fig: dict, launches: dict) -> list:
    """(holds, what) for each bar of an example's run on the card: its
    figures against the reference example's printed ones, and the kernels
    its model must launch."""
    ref = EXAMPLES_REF[name]
    near = lambda k, tol: abs(fig[k] - ref[k]) <= tol  # noqa: E731
    cells = lambda k: near(k, EXAMPLE_MAP_RTOL * ref[k])  # noqa: E731
    others = lambda *ks: not any(  # noqa: E731
        v for k, v in launches.items() if k not in ks)
    cfg = default_config()
    if name == "run_feature_detection":
        return [(f"{fig['mean']:.1f}" == f"{ref['mean']:.1f}"
                 and (fig["min"], fig["max"]) == (ref["min"], ref["max"]),
                 "corner counts"), (others(), "no kernel")]
    if name == "run_gmapping":
        return [(all(fig[k] == ref[k] for k in ref), "cells"),
                (others(), "no kernel")]
    if name == "run_hector_slam":
        return [(fig["ate"] <= _slack(ref["ate"]), "ATE"),
                (cells("occupied") and cells("free"), "cells"),
                (launches["hector_fused"] == fig["scans"] - 1
                 and others("hector_fused"), "a Hector launch a match")]
    if name == "run_karto_slam":
        return [(abs(fig["accepted"] - ref["accepted"]) <= 2
                 and fig["closures"] >= ref["closures"], "accepts, closures"),
                (near("ate_odom", 5e-4) and fig["ate"] <= _slack(ref["ate"]),
                 "ATE"), (cells("occupied") and cells("free"), "cells"),
                (launches["correlative_response"] > 0
                 and others("correlative_response"), "correlative launches")]
    if name == "run_lidar_undistortion":
        return [(near("raw_err", 1e-4) and fig["cor_err"] <= 2.5e-4,
                 "endpoint errors"), (others(), "no kernel")]
    if name == "run_plicp_odometry":
        return [(fig["ate"] <= _slack(ref["ate"])
                 and fig["rpe"] <= _slack(ref["rpe"]), "ATE, RPE"),
                (launches["nn"] == (fig["scans"] - 1)
                 * cfg.plicp.max_iterations and others("nn"),
                 "an NN launch a round")]
    return [(all(fig[k]["trans"] <= _slack(ref[k][0])
                 and fig[k]["rot"] <= _slack(ref[k][1]) for k in ref),
             "delta RMSE"),
            (launches["nn"] == 2 * cfg.icp.max_iterations
             and launches["plicp_fused"] == 2 and others("nn", "plicp_fused"),
             "ICP's NN launches, one PL-ICP launch, each call twice")]


def _shown(fig: dict) -> dict:
    """An example's figures without its arrays and objects."""
    out = {}
    for k, v in fig.items():
        if isinstance(v, dict):
            v = _shown(v)
        elif isinstance(v, float):
            v = round(v, 6)
        elif not isinstance(v, (int, tuple, str)):
            continue
        out[k] = v
    return out


def phase_examples(dev) -> dict:
    """Each example's ``main([])`` once on the card at its own
    recipe, the launch counters zeroed before each: its figures against
    the reference example's printed ones (``example_bars``), and each
    example's wall. Returns the launches."""
    total = dict.fromkeys(_dispatch.LAUNCHES, 0)
    examples = (run_feature_detection, run_gmapping, run_hector_slam,
               run_karto_slam, run_lidar_undistortion, run_plicp_odometry,
               run_scan_matching)
    for mod in examples:
        name = mod.__name__.rsplit(".", 1)[1]
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            fig = mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_dispatch.LAUNCHES)
        lines = printed.getvalue().splitlines()
        bars = example_bars(name, fig, launches)
        for line in lines[:4]:
            print(f"  {name}| {line}")
        print(f"example {name}: {wall:.2f} s; figures {_shown(fig)} "
              f"(reference example {EXAMPLES_REF[name]}); launches "
              f"{ {k: v for k, v in launches.items() if v} }; bars "
              f"{ {what: ok for ok, what in bars} }", flush=True)
        failed = [what for ok, what in bars if not ok]
        if failed:
            raise AssertionError(f"example {name}: {failed} off")
        for k, v in launches.items():
            total[k] += v
    return total


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
    sched = stream_schedule(spec.W, spec.K)
    work = cr_work(spec, pT8, slots, len(edges), iters)
    after = sched.kernels(iters, T) - sched.kernels(iters, iters)
    print(f"{label}: nodes={len(poses)} edges={len(edges)} W={spec.W} "
          f"K={spec.K} after {STREAM_SHORT_ITERS} iterations pose max|d|="
          f"{short:.3e}; after {T}: pose max|d|={dpose:.3e} cost0 {c0:.6g} "
          f"cost kernel {kc:.6g} plain {pc:.6g} iters kernel {iters} plain "
          f"{int(p[3, 3])} good {int(k[3, 2])}/{int(p[3, 2])}; kernel {ms:.3f} "
          f"ms ({ms / max(iters, 1):.4f} ms an LM iteration) plain "
          f"{plain_ms:.3f} ms bound {work['bound_ms']:.5f} ms "
          f"({work['bound_by']}); schedule: grid levels "
          f"{list(sched.grid_levels)}, cluster from h0={sched.h0} "
          f"({sched.cluster[0]} blocks x {sched.cluster[1]} warps, "
          f"{sched.cluster[2]} B shared), {sched.per_iter} launches per LM "
          f"iteration; the solve enqueued {sched.kernels(iters, T)} kernels "
          f"({sched.iterations_enqueued(iters, T)} iterations in chunks of "
          f"{sched.chunk}), {after} of them after convergence", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the streamed CR-LM kernel disagrees "
                             "with its plain version")
    return {"max_abs_err": dpose if converged else short, "ms": ms,
            "plain_ms": plain_ms, **work}


def phase_cr_stream(dev) -> dict:
    """The streamed CR-LM kernel against its plain version on bench_solver's
    rings of 4,096 (K 1,024) and 16,384 nodes (K 4,096), then on edge
    cases: W = 2 (a plain 200-node ring, K 128), W = 8 (a 300-node chain
    with stride-7 skip edges, K 128), 32,768 nodes (K 8,192) and a
    24,576-node chain with exact measurements and an edge to the sixth
    node on (W 6, K 4,096), which converges. Returns
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
    # a deep handoff held to convergence: exact measurements, W 6, K 4,096
    # (three wide levels before the cluster)
    streamed_compare("edge cr_stream exact chain", dev,
                     *exact_chain(24576, strides=(6,), every=True), reps=2)
    return out


def phase_cr_both(dev) -> None:
    """Both CR-LM kernels on the same inputs, where both take them: the
    1,024-node bench graph (K 256) and a 3,072-node bench_solver ring at
    K 512, the largest K the single-launch kernel's route takes. They
    must agree as ``streamed_compare``'s full solves do. Then the streamed
    kernel alone on a 6,144-node ring at K 1,024, with its time per
    dependent step beside theirs."""
    cfg = SolverConfig()
    for label, (poses, edges) in (("bench graph", bench_graph()),
                                  ("ring", bench_ring(3072)),
                                  ("ring", bench_ring(6144))):
        spec, pT8, slots = solver_from_numpy(cfg, poses, edges,
                                             dev).direct_inputs()
        kw = dict(W=spec.W, K=spec.K, iters=cfg.max_iterations,
                  sq_min_delta=_sq_min_delta(cfg.convergence_delta))

        def single():
            return fused_cr_lm(pT8, slots, cfg.initial_lambda, **kw)

        def streamed():
            return streamed_cr_lm(pT8, slots, cfg.initial_lambda, **kw)

        if spec.K > cr_lm.K_MAX:  # past the single-launch kernel's route
            b = streamed()
            torch.cuda.synchronize()
            ms_b = cuda_ms(streamed, 3)
            sb = cr_steps(spec.K, int(b[3, 3]))
            print(f"cr_stream alone on the {label}: nodes={len(poses)} "
                  f"W={spec.W} K={spec.K} cost0 {float(b[3, 0]):.6g} cost "
                  f"{float(b[3, 1]):.6g} iters {int(b[3, 3])}; cr_stream "
                  f"{ms_b:.3f} ms; dependent steps {sb}, "
                  f"{ms_b / sb * 1e3:.3f} µs a step", flush=True)
            if not (bool(torch.isfinite(b).all())
                    and float(b[3, 1]) <= 1e-6 * float(b[3, 0])):
                raise AssertionError(f"{label}: χ² did not reach ~0")
            continue
        a, b = single(), streamed()
        torch.cuda.synchronize()
        d = float(pose_gap(a[0:3].T, b[0:3].T).max())
        c0, ca, cb = float(a[3, 0]), float(a[3, 1]), float(b[3, 1])
        converged = max(int(a[3, 3]), int(b[3, 3])) < cfg.max_iterations
        ms_a, ms_b = cuda_ms(single, 2), cuda_ms(streamed, 3)
        sa, sb = cr_steps(spec.K, int(a[3, 3])), cr_steps(spec.K, int(b[3, 3]))
        print(f"cr_lm and cr_stream on the {label}: nodes={len(poses)} "
              f"W={spec.W} K={spec.K} pose max|d|={d:.3e} cost0 {c0:.6g} "
              f"cost {ca:.6g} / {cb:.6g} iters {int(a[3, 3])} / "
              f"{int(b[3, 3])}; cr_lm {ms_a:.3f} ms cr_stream {ms_b:.3f} ms; "
              f"dependent steps (LM iterations × levels) {sa} / {sb}, "
              f"{ms_a / sa * 1e3:.3f} / {ms_b / sb * 1e3:.3f} µs a step",
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
    Returns the counted launches and each ring's (solve ms, final cost)."""
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
    solves = {}
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
        solves[M] = (sorted(walls)[1], st.final_cost)
    reset(16384)
    prof = device_profile(lambda: solvers[16384].compute(), stages=True)
    print(profile_line("large-graph solve, 16,384 nodes", *prof), flush=True)
    return launches, solves


def phase_host_f64(dev) -> tuple:
    """The host f64 arm on the card's machine: a 3,200-node skip-edge graph
    (tests/test_pose_graph.py's shape) does not band and passes
    ``f64_schur_above`` (3,000), so ``PoseGraphSolver`` on the card solves
    it in float64 on the host and launches nothing. Returns (poses,
    stats, wall s), which ``phase_schur`` holds the device f64 route to."""
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
    return s.get_poses(), st, wall


# --- the Schur-complement routes --------------------------------------------

SCHUR_SHORT_ITERS = 3  # the card against the CPU over whole LM steps
SCHUR_F64_POSE_TOL = 5e-5  # m / rad, tests/test_pose_graph.py's f64 bar
SCHUR_F64_COST_RTOL = 1e-6
# the reference's _compute_f64_schur (JAX, float64, CPU) on the 3,200-node
# skip graph: 40 good LM iterations to this cost (the port's CPU run gives
# it to 3e-13); its λ floor keeps it above the host f64 arm's 2286.624028
SCHUR_F64_REF = (40, 2303.5682659791687)
SCHUR_F64_REF_RTOL = 1e-9


def schur_timed(solver, init, reps: int = 3) -> tuple:
    """(stats, poses) of one solve from ``init``, then the median ms of
    ``reps`` more, the poses reset before each (as bench_solver does)."""
    def solve():
        for i, p in enumerate(init):
            solver.set_node_pose(i, p)
        return solver.compute()

    st = solve()
    poses = solver.get_poses()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve()
        walls.append((time.perf_counter() - t0) * 1e3)
    return st, poses, sorted(walls)[len(walls) // 2]


def schur_shape(solver) -> str:
    """The partition a Schur route builds for ``solver``'s graph: submaps,
    internal slots, separators (real and bucketed) and the bytes of its
    factors in the solve's type."""
    from tpu_slam_torch.solver.pose_graph import _bucket

    part = solver._schur_partition(_bucket(max(solver.num_nodes, 2)))
    S, m = part.int_nodes.shape
    ns = part.sep_nodes.shape[0]
    return (f"{S} submaps x {m} slots, {int(part.sep_valid.sum())} "
            f"separators (bucket {ns}); factors L {S} x {3 * m}^2, B {S} x "
            f"{3 * m} x {3 * ns}, S_c {3 * ns}^2")


def phase_schur(dev, res, pcg_base, ring_solves, host_f64) -> dict:
    """The Schur routes (plain PyTorch, no kernel), each solve with the
    launch counters zeroed first:
      * "schur" on the mission's loop-closed graph from its chain
        (``use_schur``): no kernel launched, two runs bit-equal, the first
        ``SCHUR_SHORT_ITERS`` LM iterations against the port's CPU run of
        the same route within LM_POSE_TOL, the final cost beside
        ``pcg_lm.cu``'s on the same graph, solve ms (median of 3);
      * "schur" on bench_solver's 4,096-node ring (``use_schur``,
        ``f64_schur_above`` off, so that it does not take the host arm):
        solve ms and final cost beside ``cr_stream.cu``'s solve of it;
      * "f64_schur" on the 3,200-node skip graph
        (``host_direct_fallback=False``): poses within 5e-5 and cost within
        1e-6 relative of the host f64 arm's run in this call, the wall of
        each.
    Returns the mission graph's final cost on "schur"."""

    def counted(fn):
        _dispatch.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        return r, sum(_dispatch.LAUNCHES.values())

    ei, ej, means, infos = res.solver._edge_arrays()
    edges = list(zip(ei, ej, means, infos))
    init = res.chain_poses
    mcfg = dataclasses.replace(res.solver.cfg, use_schur=True)
    card = solver_from_numpy(mcfg, init, edges, dev)
    route = _route(card.num_nodes, card.num_edges, dev, mcfg, card._band_spec)
    (st, poses, ms), launched = counted(lambda: schur_timed(card, init))
    again = solver_from_numpy(mcfg, init, edges, dev)
    st2 = again.compute()
    same = np.array_equal(again.get_poses(), poses) and tuple(st2) == tuple(st)
    short = dataclasses.replace(mcfg, max_iterations=SCHUR_SHORT_ITERS)
    k3 = solver_from_numpy(short, init, edges, dev)
    h3 = solver_from_numpy(short, init, edges, "cpu")
    t0 = time.perf_counter()
    k3.compute(), h3.compute()
    cpu_s = time.perf_counter() - t0
    gap = float(pose_gap(torch.as_tensor(k3.get_poses()),
                         torch.as_tensor(h3.get_poses())).max())
    pcg_cost = float(pcg_base[3, 1])
    print(f"schur mission graph: nodes={card.num_nodes} edges={card.num_edges}"
          f" route {route}, {schur_shape(card)}; cost {st.initial_cost:.6g} -> "
          f"{st.final_cost:.6g} ({st.iterations} good iterations; pcg_lm.cu "
          f"on the same graph {pcg_cost:.6g}); solve ms median {ms:.3f} of 3; "
          f"kernel launches {launched}; two runs bit-equal {same}; after "
          f"{SCHUR_SHORT_ITERS} iterations against the CPU's run pose max|d| "
          f"{gap:.3e} (bar {LM_POSE_TOL}; both runs {cpu_s:.2f} s)",
          flush=True)
    if not (route == "schur" and launched == 0 and same
            and gap <= LM_POSE_TOL and np.all(np.isfinite(poses))
            and st.final_cost < st.initial_cost):
        raise AssertionError("the mission graph's Schur solve failed its bars")

    rcfg = SolverConfig(use_schur=True, f64_schur_above=0)
    rinit, redges = bench_ring(4096)
    ring = solver_from_numpy(rcfg, rinit, redges, dev)
    route = _route(ring.num_nodes, ring.num_edges, dev, rcfg, ring._band_spec)
    (rst, rposes, rms), launched = counted(lambda: schur_timed(ring, rinit))
    cr_ms, cr_cost = ring_solves[4096]
    print(f"schur 4,096-node ring: route {route}, {schur_shape(ring)}; cost "
          f"{rst.initial_cost:.6g} -> {rst.final_cost:.6g} ({rst.iterations} "
          f"good iterations); solve ms median {rms:.3f} of 3 (cr_stream.cu's "
          f"solve {cr_ms:.3f} ms to cost {cr_cost:.6g}); kernel launches "
          f"{launched}", flush=True)
    if not (route == "schur" and launched == 0 and np.all(np.isfinite(rposes))
            and rst.final_cost < rst.initial_cost):
        raise AssertionError("the 4,096-node ring's Schur solve failed")

    hposes, hst, hwall = host_f64
    fcfg = SolverConfig(host_direct_fallback=False)
    sinit, sedges = skip_graph(3200)
    f64 = solver_from_numpy(fcfg, sinit, sedges, dev)
    route = _route(f64.num_nodes, f64.num_edges, dev, fcfg, f64._band_spec)
    (fst, fposes, fms), launched = counted(lambda: schur_timed(f64, sinit))
    with patched(pose_graph, "F64_SCHUR_LAMBDA_FLOOR", 0.0):
        (xst, xposes, xms), xlaunched = counted(
            lambda: schur_timed(f64, sinit))
    host = solver_from_numpy(SolverConfig(), sinit, sedges, dev)
    t0 = time.perf_counter()
    host.compute()
    hwall2 = time.perf_counter() - t0

    def off_host(st, poses):
        return (float(pose_gap(torch.as_tensor(poses),
                               torch.as_tensor(hposes)).max()),
                abs(st.final_cost - hst.final_cost) / abs(hst.final_cost))

    fgap, frel = off_host(fst, fposes)
    xgap, xrel = off_host(xst, xposes)
    ref_iters, ref_cost = SCHUR_F64_REF
    rrel = abs(fst.final_cost - ref_cost) / ref_cost
    print(f"f64 schur skip graph: nodes={f64.num_nodes} edges={f64.num_edges} "
          f"route {route}, {schur_shape(f64)} (float64); at the reference's "
          f"λ floor: cost {fst.initial_cost:.10g} -> {fst.final_cost:.10g} "
          f"({fst.iterations} good iterations; the reference's CPU run "
          f"{ref_cost:.10g} in {ref_iters}, rel {rrel:.2e}), from the host "
          f"f64 arm's poses max|d| {fgap:.3e} cost rel {frel:.2e}; without "
          f"the floor (exact steps): cost {xst.final_cost:.10g} "
          f"({xst.iterations}), from the host f64 arm's poses max|d| "
          f"{xgap:.3e} (bar {SCHUR_F64_POSE_TOL}) cost rel {xrel:.2e}; wall "
          f"(median of 3 warm): device f64 Schur {fms / 1e3:.3f} s, without "
          f"the floor {xms / 1e3:.3f} s, host f64 arm {hwall:.3f} s (phase 22)"
          f" and {hwall2:.3f} s (again here; cost {hst.final_cost:.10g} in "
          f"{hst.iterations}); kernel launches {launched + xlaunched}",
          flush=True)
    if not (route == "f64_schur" and launched == xlaunched == 0
            and fst.iterations == ref_iters and rrel <= SCHUR_F64_REF_RTOL
            and xgap <= SCHUR_F64_POSE_TOL and xrel <= SCHUR_F64_COST_RTOL):
        raise AssertionError("the device f64 Schur LM is off the reference's "
                             "run, or its exact steps off the host f64 arm")
    return st.final_cost


# --- the float64 solver -------------------------------------------------------

F64_DIRECT_POSE_TOL = 1e-8  # m / rad: "dense" and "schur" against the CPU
F64_DIRECT_COST_RTOL = 1e-9
# "cg": the host's sum order can move a CG early-out by a step
F64_CG_POSE_TOL = 1e-6
F64_CG_COST_RTOL = 1e-8
F64_MESH_POSE_TOL = 1e-6  # the mesh's float64 CG against one device's
F64 = torch.float64


def f64_cases(res, kslam, pcg_cost: float, ring_cost: float,
              schur_cost: float) -> list:
    """``phase_f64``'s solves at full width: (label, route, cfg, starting
    poses, edges, the float32 route's name on that graph and its final
    cost, None where the phase solves it, timed runs). Online Karto's
    final graph (its mapper's poses at the end of the run), the mission's
    loop-closed graph from its chain (dense at ``use_dense_below=2048``,
    CG at ``cg_restarts`` 1 and 2, Schur), bench_solver's 4,096-node ring
    (one timed run: the phase's budget)."""
    kei, kej, kmeans, kinfos = kslam.solver._edge_arrays()
    kgraph = (kslam.solver.get_poses(), list(zip(kei, kej, kmeans, kinfos)))
    ei, ej, means, infos = res.solver._edge_arrays()
    mgraph = (res.chain_poses, list(zip(ei, ej, means, infos)))
    mcfg = res.solver.cfg
    rep = dataclasses.replace
    return [
        ("karto final graph", "dense", kslam.solver.cfg, *kgraph,
         "float32 dense", None, 3),
        ("mission graph, use_dense_below=2048", "dense",
         rep(mcfg, use_dense_below=2048), *mgraph, "pcg_lm.cu", pcg_cost, 3),
        ("mission graph", "cg", mcfg, *mgraph, "pcg_lm.cu", pcg_cost, 3),
        ("mission graph, cg_restarts=2", "cg", rep(mcfg, cg_restarts=2),
         *mgraph, "pcg_lm.cu", pcg_cost, 3),
        ("4,096-node ring", "cg", SolverConfig(), *bench_ring(4096),
         "cr_stream.cu", ring_cost, 1),
        ("mission graph, use_schur", "schur", rep(mcfg, use_schur=True),
         *mgraph, "float32 schur", schur_cost, 3),
    ]


def f64_timed(solver, init, reps: int = 3) -> tuple:
    """``reps`` solves from ``init``, the poses reset before each: (stats,
    poses, LM iterations, packed dtype, packed device, launches) of the
    first, run with the launch counters zeroed, and the median, min and
    max ms of all."""

    def solve():
        for i, p in enumerate(init):
            solver.set_node_pose(i, p)
        t0 = time.perf_counter()
        pending = solver.compute_async()
        st = pending.harvest()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return st, pending._packed

    walls = []
    _dispatch.reset_launches()
    st, packed = solve()
    launched = sum(_dispatch.LAUNCHES.values())
    poses = solver.get_poses()
    for _ in range(reps - 1):
        solve()
    walls.sort()
    return (st, poses, int(packed[3, 3]), packed.dtype, packed.device.type,
            launched, (walls[len(walls) // 2], walls[0], walls[-1]))


def phase_f64(dev, cases) -> dict:
    """``PoseGraphSolver(dtype=torch.float64)`` on the card (plain PyTorch,
    no kernel): each of ``f64_cases`` once with the counters zeroed (the
    named route, a float64 result on ``cuda``, no launch), held to the
    port's CPU run of the same route on the same graph (poses within 1e-8
    and cost within 1e-9 relative for "dense" and "schur", 1e-6 and 1e-8
    for "cg"; or both costs ≤ 1e-12 × the initial), its final cost beside
    the float32 route's and the host f64 arm's optimum
    (``_host_direct_lm``), its wall (the median of the counted run and
    two more; the ring's of its one run). Returns {label: (poses,
    stats)}."""
    out, optima = {}, {}
    for label, route, cfg, init, edges, f32_name, f32_cost, reps in cases:
        card = solver_from_numpy(cfg, init, edges, dev, F64)
        got = _route(card.num_nodes, card.num_edges, dev, cfg,
                     card._band_spec, dtype=F64)
        st, poses, iters, dt, kind, launched, (ms, lo, hi) = f64_timed(
            card, init, reps)
        host = solver_from_numpy(cfg, init, edges, "cpu", F64)
        t0 = time.perf_counter()
        hst = host.compute()
        cpu_s = time.perf_counter() - t0
        gap = float(pose_gap(torch.as_tensor(poses),
                             torch.as_tensor(host.get_poses())).max())
        rel = abs(st.final_cost - hst.final_cost) / abs(hst.final_cost)
        # χ² as pcg_compare holds it: within the bar, or both ~0 (the
        # ring's, where rounding is all that is left of the residuals)
        both_zero = (max(st.final_cost, hst.final_cost)
                     <= 1e-12 * hst.initial_cost)
        if f32_cost is None:
            f32 = solver_from_numpy(cfg, init, edges, dev)
            r32 = _route(f32.num_nodes, f32.num_edges, dev, cfg,
                         f32._band_spec)
            f32_name += f" ({r32} route)"
            f32_cost = f32.compute().final_cost
        if id(edges) not in optima:  # once a graph
            t0 = time.perf_counter()
            _p, _c0, *optimum = pose_graph._host_direct_lm(
                np.asarray(init), *card._edge_arrays(),
                np.arange(len(init)) > 0, cfg.max_iterations,
                cfg.initial_lambda, float(cfg.convergence_delta))
            optima[id(edges)] = (*optimum, time.perf_counter() - t0)
        opt, opt_good, opt_it, opt_s = optima[id(edges)]
        direct = route in ("dense", "schur")
        pose_tol = F64_DIRECT_POSE_TOL if direct else F64_CG_POSE_TOL
        cost_tol = F64_DIRECT_COST_RTOL if direct else F64_CG_COST_RTOL
        print(f"f64 {label}: nodes={card.num_nodes} edges={card.num_edges} "
              f"route {got} ({dt} on {kind}); cost {st.initial_cost:.10g} -> "
              f"{st.final_cost:.10g} ({st.iterations} good of {iters} LM "
              f"iterations); {f32_name} {f32_cost:.10g}; host f64 arm "
              f"{opt:.10g} ({opt_good} good of {opt_it}, {opt_s:.3f} s); "
              f"against the CPU's run of the route: poses max|d| {gap:.3e} "
              f"(bar {pose_tol}) cost rel {rel:.2e} (bar {cost_tol}; CPU "
              f"{cpu_s:.2f} s); solve ms median {ms:.3f} of {reps} (min "
              f"{lo:.3f} max {hi:.3f}); kernel launches {launched}",
              flush=True)
        if not (got == route and dt == F64 and kind == "cuda"
                and launched == 0 and gap <= pose_tol
                and (rel <= cost_tol or both_zero)
                and np.all(np.isfinite(poses))
                and st.final_cost < st.initial_cost):
            raise AssertionError(f"the float64 solve of the {label} failed "
                                 "its bars")
        out[label] = (poses, tuple(st))
    return out


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


# --- restarted CG in the PCG-LM kernel ------------------------------------


def phase_pcg_restarts(dev, res, base) -> dict:
    """The PCG-LM kernel's restart count (restarted CG, ``cg_restarts``).
    On the mission's loop-closed graph, as ``phase_pcg`` solves it: at
    restarts = 1 the kernel's packed result must equal ``base`` (that
    phase's) bit for bit, timed in turns with the default call (the same
    instance without the restart loop); at restarts = 2 it is held against
    its plain version to the PCG bars. Then the main path of the option:
    ``PoseGraphSolver.compute`` on bench_solver's 4,096-node ring with
    ``use_direct=False`` and ``f64_schur_above=0`` (the PCG route) at
    ``cg_restarts`` 1 and 2, the counters zeroed first: one PCG-LM launch
    each, the final cost at 2 no higher than at 1; each with its LM and
    PCG iterations and solve ms (median of 3 warm runs). Returns the
    counted launches."""
    args, kw = pcg_args(dev, res.solver, res.chain_poses)
    one = fused_lm_solve(*args, **kw, cg_restarts=1)[5]
    torch.cuda.synchronize()
    same = torch.equal(one, base)
    times = {"default": [], "restarts=1": []}
    for name in ("default", "restarts=1", "restarts=1", "default"):
        extra = {} if name == "default" else {"cg_restarts": 1}
        times[name].append(cuda_ms(lambda: fused_lm_solve(
            *args, **kw, **extra)[5], 3))
    print(f"pcg_lm restarts=1 on the mission graph: packed result equal to "
          f"phase_pcg's bit for bit {same}; ms in turns default "
          f"{times['default']} restarts=1 {times['restarts=1']}", flush=True)
    if not same:
        raise AssertionError("pcg_lm at restarts = 1 moved the mission "
                             "graph's result")
    if min(times["restarts=1"]) > 1.1 * max(times["default"]):
        raise AssertionError("pcg_lm at restarts = 1 is slower than the "
                             "default call beyond the phase's noise")
    pcg_compare("pcg_lm restarts=2 mission graph", dev, args,
                dict(kw, cg_restarts=2))
    cfg = SolverConfig(use_direct=False, f64_schur_above=0)
    init, edges = bench_ring(4096)
    solvers = {r: solver_from_numpy(dataclasses.replace(cfg, cg_restarts=r),
                                    init, edges, dev) for r in (1, 2)}
    route = _route(4096, len(edges), dev, solvers[2].cfg,
                   solvers[2]._band_spec)
    if route != "pcg":
        raise AssertionError(f"the 4,096-node ring routed to {route}")
    _dispatch.reset_launches()
    packed = {}
    for r, s in solvers.items():
        pending = s.compute_async()
        stats = pending.harvest()
        packed[r] = (stats, pending._packed.cpu())
    launches = dict(_dispatch.LAUNCHES)
    costs = {}
    for r, s in solvers.items():
        walls = []
        for _ in range(3):
            for i, p in enumerate(init):
                s.set_node_pose(i, p)
            t0 = time.perf_counter()
            s.compute()
            walls.append((time.perf_counter() - t0) * 1e3)
        stats, pk = packed[r]
        costs[r] = stats.final_cost
        print(f"pcg_lm ring 4096 cg_restarts={r}: cost {stats.initial_cost:.6g}"
              f" -> {stats.final_cost:.6g}; LM iterations {int(pk[3, 3])} "
              f"({stats.iterations} good), PCG iterations {int(pk[4, 0])}; "
              f"solve ms median {sorted(walls)[1]:.3f} (min {min(walls):.3f} "
              f"max {max(walls):.3f}) over 3 warm runs", flush=True)
    print(f"pcg_lm ring 4096: launches {launches}", flush=True)
    if launches["pcg_lm"] != 2 or any(v for k, v in launches.items()
                                      if k != "pcg_lm"):
        raise AssertionError("the ring's solves did not each run the PCG-LM "
                             "kernel alone")
    if not (np.isfinite(costs[2]) and costs[2] <= costs[1]):
        raise AssertionError(f"cg_restarts=2 ended at cost {costs[2]:.6g}, "
                             f"above the single run's {costs[1]:.6g}")
    return launches


# --- the command line, bag replay and the native library ------------------

SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
POSE_EQ_TOL = 1e-5  # m / rad: a CLI run against the same model called directly
# ATE bars of the bag runs (aligned, against the recipe's truth): the CPU
# runs of the same bags gave karto 0.0020, odometry 0.0027, hector 0.0052
# m. offline has none: a bag carries no odometry, so the mission's PL-ICP
# chain slides along the corridor (2.17 m on the CPU run), and its loops
# cannot pull the laps back; the run is held to its direct call instead.
CLI_ATE_MAX = {"karto": 0.05, "odometry": 0.05, "hector": HECTOR_ATE_MAX,
               "offline": None}


def phase_native(dev, slam, smi: str) -> None:
    """The native host library on the card's machine: it must build (g++)
    and load; then ``occupancy_from_scans(engine="native")`` (the C++
    rasterizer on the host) against ``engine="device"`` on the online Karto
    run's final state, int8 for int8, with both engines' wall ms (median
    of 3 after a warm call) beside the card's name and power limit."""
    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the native library is unavailable: "
                             f"{native.build_error()}")
    slam.flush()
    poses, pts, ranges = occ._map_inputs(slam)
    sc = slam.cfg.scan
    grid = occ.karto_grid_bounds(poses, pts, ranges, sc.range_min,
                                 sc.range_threshold, 0.05)  # karto_map's
    kw = dict(range_threshold=sc.range_threshold, min_range=sc.range_min,
              max_range=sc.range_max)
    maps, ms = {}, {}
    for engine in ("native", "device"):
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            maps[engine] = occ.occupancy_from_scans(
                grid, poses, pts, ranges, engine=engine, device=dev, **kw)
            walls.append((time.perf_counter() - t0) * 1e3)
        ms[engine] = sorted(walls[1:])[1]
    split = int((maps["native"] != maps["device"]).sum())
    print(f"native: library {native.library_path().name} built and loaded in "
          f"{build_s:.2f} s; Karto map of the online run ({len(poses)} scans "
          f"x {pts.shape[1]} beams, {grid.size_x}x{grid.size_y} cells): "
          f"native engine {ms['native']:.2f} ms (host), device engine "
          f"{ms['device']:.2f} ms (wall), median of 3 after a warm call, on "
          f"{smi}; int8 equal {split == 0} ({split} cells differ; "
          f"{map_counts(maps['native'])})", flush=True)
    if split:
        raise AssertionError(f"native and device maps differ in {split} cells")


def scan_bag(path, ranges, stamps, scfg, compression: str) -> np.ndarray:
    """Write ``ranges`` (T, N) as a LaserScan bag with the port's
    ``write_bag``; returns the float32 ranges as written."""
    r32 = np.asarray(ranges, "<f4")
    N = r32.shape[1]
    msgs = []
    for t in range(len(r32)):
        stamp = float(stamps[t])
        msgs.append(("laser_scan", "sensor_msgs/LaserScan", stamp,
                     rosbag.serialize_laser_scan({
                         "stamp": stamp, "frame_id": "laser",
                         "angle_min": scfg.angle_min,
                         "angle_max": scfg.angle_min
                         + scfg.angle_increment * (N - 1),
                         "angle_increment": scfg.angle_increment,
                         "time_increment": scfg.scan_period / N,
                         "scan_time": scfg.scan_period,
                         "range_min": scfg.range_min,
                         "range_max": scfg.range_max, "ranges": r32[t]})))
    rosbag.write_bag(str(path), msgs, compression=compression)
    return r32


def cli_run(argv):
    """``cli.main(argv)`` on the card, the launch counters zeroed first:
    (its printed lines, the run's objects, the kernels it launched, wall
    s)."""
    out, buf = {}, io.StringIO()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, out=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _dispatch.LAUNCHES.items() if v}
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}\n{buf.getvalue()}")
    return buf.getvalue(), out, launches, wall


def direct_run(model: str, out, dev, odometry: dict):
    """The same model called directly on the CLI run's decoded scans and
    config: (estimate, counts). The Karto run's PL-ICP odometry goes into
    ``odometry`` by bag, and the odometry model's direct call on the same
    bag is that run (the same call on the same decoded scans)."""
    cfg, scans = out["cfg"], out["scans"]
    bag = out.get("bag")
    if model == "karto":
        odom = odometry[bag] = PLICPOdometry(cfg, device=dev).run(scans)
        slam = KartoSLAM(cfg, device=dev)
        acc = slam.run(scans, odom)
        return slam.trajectory(), (tuple(acc), slam.loop_closures,
                                   slam.solver.num_edges)
    if model == "odometry":
        if bag not in odometry:
            odometry[bag] = PLICPOdometry(cfg, device=dev).run(scans)
        return odometry[bag], ()
    if model == "hector":
        return HectorSLAM(cfg, device=dev).run(scans), ()
    if model == "offline":
        r = offline_slam(scans, cfg)
        return r.poses, (len(r.loops), r.candidates_tried,
                         r.solver.num_edges)
    if model == "gmapping":
        g = GMapping(cfg, device=dev)
        g.run(scans, out["gt"].astype(np.float32))
        return out["estimate"], (g.to_ros_map().tobytes(),)
    return extract_corner_features(scans, cfg.features).cpu().numpy(), ()


def cli_counts(model: str, out):
    m = out["model"]
    if model == "karto":
        return (tuple(out["accepted"]), m.loop_closures, m.solver.num_edges)
    if model == "offline":
        return (len(m.loops), m.candidates_tried, m.solver.num_edges)
    if model == "gmapping":
        return (out["map"].tobytes(),)
    return ()


CLI_KERNELS = {"karto": {"correlative_response", "nn"}, "odometry": {"nn"},
               "hector": {"hector_fused"},
               "offline": {"plicp_fused", "pcg_lm", "loop_sweep"},
               "gmapping": set(), "features": set()}


def phase_bag_cli(dev) -> dict:
    """The command line over recorded bags on the card, at full width
    (``default_config()``, 360 beams): bags written with the port's
    ``write_bag`` from the online Karto recipe (352 scans, bz2, as the
    lesson bags), the Hector recipe (150 scans) and the bench mission
    (1,056 scans), replayed by ``cli.main`` as ``karto --bag`` (with
    ``--save-map`` and ``--checkpoint``) and ``odometry --bag`` (the Karto
    bag), ``hector --bag`` and ``offline --bag``; ``gmapping`` and
    ``features`` with ``--sim``. For each: the ranges the native decoder
    reads back equal those written bit for bit; the run's accepted scans,
    closures, edges and poses equal a direct call of the same model on the
    same decoded scans (counts exactly, poses within POSE_EQ_TOL); the
    kernels it launched, by name, include the model's; its ATE against
    the recipe's truth (this script's own: a bag carries none); its wall
    and scans/s. The map and checkpoint files are read back, the Hector
    state goes through ``save_hector`` / ``load_hector`` (the loaded and
    the original mapper step one more scan to the same pose), and one
    ``offline --bag`` run under ``device_trace`` must name the PL-ICP,
    PCG-LM and loop-sweep kernels in its Chrome trace. Returns the runs' launches."""
    SCRATCH.mkdir(parents=True, exist_ok=True)
    kcfg, kscans, _kodom, kgt = karto_recipe("cpu")
    hcfg, hscans, hgt = hector_seq(HECTOR_SCANS, "cpu")
    mcfg, mscans, _modom, mgt = bench_mission("cpu")
    bags = {}
    for name, cfg, scans, compression in (
            ("karto", kcfg, kscans, "bz2"), ("hector", hcfg, hscans, "none"),
            ("mission", mcfg, mscans, "none")):
        path = SCRATCH / f"{name}.bag"
        t0 = time.perf_counter()
        written = scan_bag(path, scans.ranges.numpy(), scans.stamp.numpy(),
                           cfg.scan, compression)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = native.bag_read_scans(str(path), "laser_scan")
        read_s = time.perf_counter() - t0
        equal = got is not None and got[0].tobytes() == written.tobytes()
        print(f"bag {name}: {written.shape[0]} scans x {written.shape[1]} "
              f"beams, {compression}, {path.stat().st_size} bytes, written "
              f"in {write_s:.2f} s; native decoder {read_s * 1e3:.1f} ms; "
              f"ranges bit-equal to those written {equal} (NaN "
              f"{int(np.isnan(written).sum())}, inf "
              f"{int(np.isinf(written).sum())})", flush=True)
        if not equal:
            raise AssertionError(f"bag {name}: the native decoder did not "
                                 "read back the ranges written")
        bags[name] = str(path)
    mapbase, ckpt = str(SCRATCH / "karto_map"), str(SCRATCH / "karto.npz")
    runs = [("karto", ["--bag", bags["karto"], "--save-map", mapbase,
                       "--checkpoint", ckpt], kgt),
            ("odometry", ["--bag", bags["karto"]], kgt),
            ("hector", ["--bag", bags["hector"]], hgt),
            ("offline", ["--bag", bags["mission"]], mgt),
            ("gmapping", ["--sim"], None), ("features", ["--sim"], None)]
    total = dict.fromkeys(_dispatch.LAUNCHES, 0)
    outs, odometry = {}, {}
    for model, extra, gt in runs:
        text, out, launches, wall = cli_run([model, *extra])
        outs[model] = out
        out["bag"] = extra[1] if extra[0] == "--bag" else None
        for k, v in launches.items():
            total[k] += v
        est, counts = direct_run(model, out, dev, odometry)
        same_counts = counts == cli_counts(model, out)
        gap = float(np.max(np.abs(np.asarray(out["estimate"], np.float64)
                                  - np.asarray(est, np.float64))))
        T = int(out["scans"].ranges.shape[0])
        ate, bar = "", CLI_ATE_MAX.get(model)
        if gt is not None:
            ref = gt[out["accepted"]] if model == "karto" else gt
            a = float(ate_rmse(out["estimate"], ref))
            ate = f" ATE {a:.5f} m (bar {bar} m)"
        lines = " | ".join(ln for ln in text.splitlines() if ln)
        print(f"cli {model} {' '.join(extra[:1])}: {T} scans, wall "
              f"{wall:.2f} s ({T / wall:.1f} scans/s);{ate} kernels "
              f"{launches}; against the direct call: counts equal "
              f"{same_counts}, estimate max|d| {gap:.3e} (bit-equal "
              f"{gap == 0.0}); printed: {lines}", flush=True)
        if not (same_counts and gap <= POSE_EQ_TOL):
            raise AssertionError(f"cli {model}: differs from the direct call")
        if not CLI_KERNELS[model] <= set(launches):
            raise AssertionError(f"cli {model}: launched {launches}, not "
                                 f"every one of {CLI_KERNELS[model]}")
        if bar is not None and not a <= bar:
            raise AssertionError(f"cli {model}: ATE {a:.5f} m above {bar} m")
    # the files a run wrote, read back
    kout = outs["karto"]
    back, grid = load_map(mapbase + ".yaml")
    fresh = KartoSLAM(kout["cfg"], device=dev)
    load_karto(fresh, ckpt)
    orig = kout["model"]
    ck_ok = (len(fresh.scans) == len(orig.scans)
             and fresh.solver.num_edges == orig.solver.num_edges
             and fresh.loop_closures == orig.loop_closures
             and np.array_equal(fresh.solver.get_poses(),
                                orig.solver.get_poses()))
    map_ok = (np.array_equal(back, kout["map"])
              and (grid.size_x, grid.size_y) == (kout["grid"].size_x,
                                                 kout["grid"].size_y))
    # the Hector state through its checkpoint: both step one more scan
    hout = outs["hector"]
    hslam, hs = hout["model"], hout["scans"]
    hpath = str(SCRATCH / "hector.npz")
    save_hector(hslam, hpath)
    loaded = HectorSLAM(hout["cfg"], device=dev)
    load_hector(loaded, hpath)
    grids_ok = all(torch.equal(a, b) for a, b in zip(loaded.grids,
                                                     hslam.grids))
    last = index_scan(hs, hs.ranges.shape[0] - 1)
    p_orig, p_loaded = hslam.step(last), loaded.step(last)
    step_ok = bool(np.array_equal(p_orig, p_loaded))
    print(f"cli files: map {mapbase}.yaml read back equal {map_ok}; Karto "
          f"checkpoint into a fresh KartoSLAM: {len(fresh.scans)} scans, "
          f"{fresh.solver.num_edges} edges, poses equal {ck_ok}; Hector "
          f"checkpoint: grids equal {grids_ok}, one more step to "
          f"{p_loaded.tolist()} equal to the original's {step_ok}",
          flush=True)
    if not (map_ok and ck_ok and grids_ok and step_ok):
        raise AssertionError("a file of the CLI runs did not read back")
    # one offline --bag run under device_trace
    trace = SCRATCH / "offline_trace.json"
    t0 = time.perf_counter()
    with device_trace(str(trace)):
        cli_run(["offline", "--bag", bags["mission"]])
    trace_s = time.perf_counter() - t0
    kernels = [e.get("name", "") for e in
               json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels)
             for k in ("plicp_fused", "pcg_lm", "loop_sweep")}
    print(f"cli offline under device_trace: {trace_s:.2f} s with the trace's "
          f"export, {trace.stat().st_size} bytes, {len(kernels)} kernel "
          f"events; by name {named}", flush=True)
    if not all(named.values()):
        raise AssertionError("the Chrome trace does not name the PL-ICP, "
                             "PCG-LM and loop-sweep kernels")
    return total


# --- the multi-device layer -----------------------------------------------

MESH_DIR = SCRATCH / "mesh"
# (label, ranks, backend): NCCL at one rank, and two ranks sharing the one
# card, which NCCL refuses, over gloo (its collectives copy through the host)
MESH_CASES = (("a", 1, "nccl"), ("b", 2, "gloo"))
MESH_DEADLINE_S = 300.0  # a case's ranks, started to joined
MESH_PGS_POSE_TOL = 5e-4  # m / rad, the reference's mesh bars
MESH_PGS_COST_RTOL = 1e-2
MESH_CHAIN_TOL = 1e-5
MESH_POSE_TOL = 5e-4  # m / rad (see mesh_inputs)
MESH_KARTO_TOL = 5e-3
MESH_HECTOR_TOL = 1e-4  # between the two cases
MESH_GATHER_REPS = 50
MESH_SCHUR_TOL = 1e-4  # × max(|δ|, 1): tests/test_schur.py's bar
SCAN_FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")


def scan_fields(scans) -> tuple:
    return tuple(getattr(scans, f).cpu().numpy() for f in SCAN_FIELDS)


def mesh_inputs(dev, mission, karto, hector, f64_cg) -> tuple[dict, dict]:
    """The mesh phase's inputs (numpy and configs, for the ranks) and the
    results they are held to: the 512-pair bench PL-ICP batch as a store
    of its 1,024 scans with the unsharded packed matcher's rows (the
    kernel), the mission's loop-closed graph from its chain poses with the
    single-device solve (``pcg_lm.cu``), and the mission, Karto and Hector
    recipes with their unsharded runs' results. The mission also runs cut
    to its first detect→match→solve round (``offline.rounds`` = 1),
    unsharded here: that round's candidates come from the chain alone, so
    both runs match the same loops and solve the same graph. The second
    round's candidates come from each run's own solve, and two float32
    solvers (``pcg_lm.cu``, the mesh's plain CG) pick different loop sets
    there, so the whole mission's poses part from the unsharded run by
    millimetres (PERF.md §6). The whole mission runs once more here through
    the mesh's solver on a mesh of one rank without a process group: the
    mesh sums every edge's terms in edge order, so the ranks of either
    case must give its loops and its poses.
    ``mission`` = (cfg, scans, odom, gt, result), ``karto`` = (cfg, scans,
    odom, gt, mapper, accepted), ``hector`` = (cfg, scans, gt), ``f64_cg``
    = (poses, stats) of ``phase_f64``'s one-device float64 "cg" solve of
    the mission graph, which the ranks' float64 mesh solve is held to."""
    cfg, args, g = plicp_bench_batch(dev)
    B = g.shape[0]
    store = torch.cat([args[0], args[2]]).contiguous()
    valid = torch.cat([args[1], args[3]]).contiguous()
    si = torch.arange(B, device=dev)
    ti = si + B
    packed = make_packed_indexed_matcher(cfg)(
        store, valid, torch.zeros((1, 2), device=dev), si, ti, g)
    mcfg, mscans, modom, mgt, res = mission
    cfg1 = dataclasses.replace(
        mcfg, offline=dataclasses.replace(mcfg.offline, rounds=1))
    res1 = offline_slam(mscans, cfg1, odom=modom)
    res_mesh = offline_slam(mscans, mcfg, odom=modom,
                            mesh=make_mesh(device=dev))
    ei, ej, means, infos = res.solver._edge_arrays()
    single = solver_from_numpy(mcfg.solver, res.chain_poses, list(zip(
        ei, ej, means, infos)), dev)
    pgs_stats = single.compute()
    kcfg, kscans, kodom, kgt, kslam, kacc = karto
    hcfg, hscans, hgt = hector
    inputs = {
        "matcher": {"cfg": cfg, "store": store.cpu().numpy(),
                    "valid": valid.cpu().numpy(), "si": si.cpu().numpy(),
                    "ti": ti.cpu().numpy(), "g": g.cpu().numpy()},
        "graph": {"cfg": mcfg.solver, "init": res.chain_poses, "ei": ei,
                  "ej": ej, "means": means, "infos": infos},
        "mission": {"cfg": mcfg, "cfg1": cfg1, "fields": scan_fields(mscans),
                    "odom": modom},
        "karto": {"cfg": kcfg, "fields": scan_fields(kscans), "odom": kodom},
        "hector": {"cfg": hcfg, "fields": scan_fields(hscans),
                   "pose0": hgt[0]},
    }
    refs = {
        "schur": {D: schur_delta(schur_part(inputs["graph"], D), *schur_args(
            inputs["graph"], dev)).cpu().numpy() for _l, D, _b in MESH_CASES},
        "matcher": packed.cpu().numpy(),
        "pgs": (single.get_poses(), tuple(pgs_stats)), "pgs64": f64_cg,
        "offline": _offline_out(res), "offline1": _offline_out(res1),
        "offline_mesh": _offline_out(res_mesh),
        "karto": {"accepted": list(kacc), "closures": kslam.loop_closures,
                  "trajectory": kslam.trajectory()},
        "mission_gt": mgt, "hector_gt": hgt,
    }
    return inputs, refs


def schur_args(graph: dict, dev) -> tuple:
    """``schur_delta``'s arguments for the mesh phase's graph: its chain
    poses, every edge, λ the solver's initial one, node 0 fixed."""
    n = len(graph["init"])
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(graph["init"], **f32),
            torch.as_tensor(graph["ei"], device=dev),
            torch.as_tensor(graph["ej"], device=dev),
            torch.as_tensor(graph["means"], **f32),
            torch.as_tensor(graph["infos"], **f32),
            torch.ones(len(graph["ei"]), dtype=torch.bool, device=dev),
            np.float32(graph["cfg"].initial_lambda),
            torch.arange(n, device=dev) > 0)


def schur_part(graph: dict, S: int):
    """The mesh phase's graph cut into S submaps."""
    return build_partition(graph["ei"], graph["ej"],
                           np.ones(len(graph["ei"]), bool), len(graph["init"]),
                           S)


def _offline_out(res) -> dict:
    return {"poses": res.poses, "chain": res.chain_poses,
            "loops": len(res.loops),
            "pairs": sorted((e.i, e.j) for e in res.loops)}


def mesh_rank(rank: int, D: int, backend: str, device: str, port: int,
              inputs_path: str, label: str) -> None:
    """One rank of a mesh case (spawned; the main guard keeps the import
    of this file from starting the chip run). It joins the process group,
    builds ``make_mesh(D)`` on ``device`` and drives the port's mesh
    forms, each with the launch and collective counters zeroed first: the
    sharded packed matcher, ``PoseGraphSolver(mesh)`` (then a timed gather
    of a CG matvec's edge terms), the same solver in float64,
    ``offline_slam(mesh)`` (the mission's first round, then the whole
    mission), ``KartoSLAM(mesh)`` and
    ``HectorSLAM(mesh)``; it pickles what it got, its walls and counts to
    ``MESH_DIR``."""
    import pickle

    import torch.distributed as dist

    from tpu_slam_torch.convert import scan_from_numpy
    from tpu_slam_torch.parallel import mesh as pm
    from tpu_slam_torch.parallel import multihost

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    if D == 1:  # a group of one: its collectives still make their calls
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0,
                                timeout=multihost.INIT_TIMEOUT)
    else:
        multihost.initialize(f"localhost:{port}", D, rank, backend=backend)
    mesh = pm.make_mesh(D, device=dev, backend=backend)
    inp = pickle.loads(Path(inputs_path).read_bytes())
    out = {"mesh": repr(mesh), "walls": {}, "launches": {},
           "collectives": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def counted(name, fn):
        sync()
        _dispatch.reset_launches()
        pm.reset_collectives()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out["walls"][name] = time.perf_counter() - t0
        out["launches"][name] = dict(_dispatch.LAUNCHES)
        out["collectives"][name] = dict(pm.COLLECTIVES)
        return r

    def t(a):
        return torch.as_tensor(a, device=dev)

    m = inp["matcher"]
    out["matcher"] = counted("matcher", lambda: make_packed_indexed_matcher(
        m["cfg"], mesh)(t(m["store"]), t(m["valid"]),
                        torch.zeros((1, 2), device=dev), t(m["si"]),
                        t(m["ti"]), t(m["g"]))).cpu().numpy()
    gph = inp["graph"]
    pgs = PoseGraphSolver(gph["cfg"], mesh=mesh)
    pgs.add_nodes(range(len(gph["init"])), gph["init"])
    pgs.add_constraints(gph["ei"], gph["ej"], gph["means"],
                        informations=gph["infos"])
    out["pgs_route"] = _route(pgs.num_nodes, pgs.num_edges, dev, pgs.cfg,
                              pgs._band_spec, mesh)
    out["pgs_stats"] = tuple(counted("pgs", pgs.compute))
    out["pgs"] = pgs.get_poses()
    # a CG matvec's collective: the rank's edges' six terms, gathered
    x = torch.ones((-(-pgs.num_edges // D), 6), device=dev)
    pm.all_gather_rows(x, mesh)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(MESH_GATHER_REPS):
        pm.all_gather_rows(x, mesh)
    sync()
    out["gather_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_GATHER_REPS
    out["gather_floats"] = x.numel() * D
    pgs64 = PoseGraphSolver(gph["cfg"], mesh=mesh, dtype=torch.float64)
    pgs64.add_nodes(range(len(gph["init"])), gph["init"])
    pgs64.add_constraints(gph["ei"], gph["ej"], gph["means"],
                          informations=gph["infos"])
    out["pgs64_route"] = _route(pgs64.num_nodes, pgs64.num_edges, dev,
                                pgs64.cfg, pgs64._band_spec, mesh,
                                torch.float64)
    pending = counted("pgs64", pgs64.compute_async)
    out["pgs64_packed"] = (str(pending._packed.dtype),
                           pending._packed.device.type)
    out["pgs64_stats"] = tuple(pending.harvest())
    out["pgs64"] = pgs64.get_poses()
    step = make_distributed_schur_delta(mesh, schur_part(gph, D))
    out["schur"] = counted("schur", lambda: step(*schur_args(gph, dev))
                           ).cpu().numpy()
    o = inp["mission"]
    for name, key in (("offline1", "cfg1"), ("offline", "cfg")):
        out[name] = _offline_out(counted(name, lambda: offline_slam(
            scan_from_numpy(*o["fields"], device=dev), o[key],
            odom=o["odom"], mesh=mesh)))
    k = inp["karto"]
    kslam = KartoSLAM(k["cfg"], mesh=mesh)
    acc = counted("karto", lambda: kslam.run(
        scan_from_numpy(*k["fields"], device=dev), k["odom"]))
    out["karto"] = {"accepted": list(acc), "closures": kslam.loop_closures,
                    "trajectory": kslam.trajectory()}
    h = inp["hector"]
    hslam = HectorSLAM(h["cfg"], mesh=mesh)
    hslam.last_pose = torch.tensor(h["pose0"], dtype=torch.float32,
                                   device=dev)
    est = counted("hector", lambda: hslam.run(
        scan_from_numpy(*h["fields"], device=dev)))
    out["hector"] = {"est": est, "maps": [
        hslam.to_ros_map(level=lv) for lv in range(len(hslam.grid_cfgs))]}
    (MESH_DIR / f"{label}_rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def run_mesh_case(label: str, D: int, backend: str, device,
                  inputs_path: Path) -> list[dict]:
    """Spawn the case's D ranks (never fork: this process holds a CUDA
    context) and join them against ``MESH_DEADLINE_S``: a rank that fails
    raises here, and at the deadline every rank still running is killed
    and the phase fails. Returns each rank's results."""
    import pickle

    import torch.multiprocessing as tmp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = tmp.start_processes(
        mesh_rank, args=(D, backend, str(device), port, str(inputs_path),
                         label), nprocs=D, join=False, start_method="spawn")
    end = time.perf_counter() + MESH_DEADLINE_S
    try:
        while not ctx.join(timeout=max(end - time.perf_counter(), 0.0)):
            if time.perf_counter() >= end:
                raise AssertionError(f"mesh case ({label}): the ranks passed "
                                     f"the {MESH_DEADLINE_S:.0f} s deadline")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [pickle.loads((MESH_DIR / f"{label}_rank{r}.pkl").read_bytes())
            for r in range(D)]


def _max_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def mesh_case_check(label: str, D: int, backend: str, outs, refs) -> None:
    """Each rank against rank 0 (the same results on every rank) and
    rank 0 against the single-device results and the mesh's solver without
    ranks, to the bars above; prints the case's line."""
    o = outs[0]
    for r, other in enumerate(outs[1:], 1):
        for key in ("matcher", "pgs", "pgs64", "schur"):
            if not np.array_equal(other[key], o[key]):
                raise AssertionError(f"mesh ({label}): rank {r}'s {key} "
                                     "differs from rank 0's")
        for key, sub in (("offline1", "poses"), ("offline", "poses"),
                         ("karto", "trajectory"), ("hector", "est")):
            if not np.array_equal(other[key][sub], o[key][sub]):
                raise AssertionError(f"mesh ({label}): rank {r}'s {key} "
                                     "differs from rank 0's")
    matcher_eq = np.array_equal(o["matcher"], refs["matcher"])
    pposes, pstats = refs["pgs"]
    pgs_gap = _max_gap(o["pgs"], pposes)
    cost_rel = abs(o["pgs_stats"][2] - pstats[2]) / max(abs(pstats[2]), 1e-12)
    off1, roff1 = o["offline1"], refs["offline1"]
    off1_gap = _max_gap(off1["poses"], roff1["poses"])
    off1_same = off1["pairs"] == roff1["pairs"]
    off, roff = o["offline"], refs["offline"]
    off_ate = float(ate_rmse(off["poses"], refs["mission_gt"]))
    ref_ate = float(ate_rmse(roff["poses"], refs["mission_gt"]))
    chain_gap = _max_gap(off["chain"], roff["chain"])
    off_gap = _max_gap(off["poses"], roff["poses"])
    pairs_differ = len(set(off["pairs"]) ^ set(roff["pairs"]))
    moff = refs["offline_mesh"]
    mesh_gap = _max_gap(off["poses"], moff["poses"])
    mesh_same = off["pairs"] == moff["pairs"]
    mesh_bits = np.array_equal(off["poses"], moff["poses"])
    kt, rk = o["karto"], refs["karto"]
    karto_same = (kt["accepted"] == rk["accepted"]
                  and kt["closures"] == rk["closures"])
    karto_gap = (_max_gap(kt["trajectory"], rk["trajectory"]) if karto_same
                 else float("inf"))
    hec_ate = float(ate_rmse(o["hector"]["est"], refs["hector_gt"],
                             align=False))
    p64, s64 = refs["pgs64"]
    pgs64_gap = _max_gap(o["pgs64"], p64)
    pgs64_rel = abs(o["pgs64_stats"][2] - s64[2]) / abs(s64[2])
    sref = refs["schur"][D]
    schur_gap = _max_gap(o["schur"], sref)
    schur_bar = MESH_SCHUR_TOL * max(float(np.abs(sref).max()), 1.0)
    schur_coll = o["collectives"]["schur"]
    coll = o["collectives"]["pgs"]
    lm_iters = o["pgs_stats"][0]
    per_rank = [(sum(x["launches"][k]["plicp_fused"]
                     for k in ("matcher", "offline1", "offline")),
                 x["launches"]["karto"]["correlative_response"])
                for x in outs]
    walls = " ".join(f"{k} {v:.2f} s" for k, v in o["walls"].items())
    print(f"mesh ({label}): D={D} {backend} ({o['mesh']}); walls {walls}; "
          f"matcher bit-equal to the unsharded kernel {matcher_eq}; solve "
          f"route {o['pgs_route']} {lm_iters} good LM iterations, "
          f"collectives {coll} (a matvec's gather of {o['gather_floats']} "
          f"floats {o['gather_ms']:.4f} ms), poses max|d| {pgs_gap:.3e} (bar "
          f"{MESH_PGS_POSE_TOL}) cost {o['pgs_stats'][2]:.6g} against "
          f"{pstats[2]:.6g} (rel {cost_rel:.2e}); float64 solve route "
          f"{o['pgs64_route']} ({' on '.join(o['pgs64_packed'])}) "
          f"{o['pgs64_stats'][0]} good LM iterations, "
          f"{o['walls']['pgs64']:.2f} s, launches "
          f"{sum(o['launches']['pgs64'].values())}, poses max|d| "
          f"{pgs64_gap:.3e} from one device's float64 \"cg\" (bar "
          f"{F64_MESH_POSE_TOL}) cost {o['pgs64_stats'][2]:.10g} against "
          f"{s64[2]:.10g} (rel {pgs64_rel:.2e}); offline first round: the same "
          f"{off1['loops']} loops {off1_same}, poses max|d| {off1_gap:.3e} "
          f"(bar {MESH_POSE_TOL}); offline ATE {off_ate:.5f} m (unsharded "
          f"{ref_ate:.5f}) loops {off['loops']} (unsharded {roff['loops']}; "
          f"{pairs_differ} pairs in one set only) chain max|d| "
          f"{chain_gap:.3e} poses max|d| {off_gap:.3e}; against the mesh's "
          f"solver without ranks: the same {moff['loops']} loops "
          f"{mesh_same}, poses max|d| {mesh_gap:.3e} (bar {MESH_POSE_TOL}; "
          f"bit-equal {mesh_bits}); karto accepted "
          f"{len(kt['accepted'])} closures {kt['closures']} (unsharded "
          f"{len(rk['accepted'])}, {rk['closures']}) trajectory max|d| "
          f"{karto_gap:.3e}; hector ATE {hec_ate:.5f} m; Schur step at S = D "
          f"{o['walls']['schur'] * 1e3:.1f} ms, collectives {schur_coll}, "
          f"max|d| {schur_gap:.3e} from one device's (bar {schur_bar:.1e}); "
          f"PL-ICP and "
          f"correlative launches per rank {per_rank}", flush=True)
    checks = [
        (matcher_eq, "the sharded matcher differs from the unsharded kernel"),
        (o["pgs_route"] == "mesh_cg", "the mission graph did not take the "
         "mesh CG route"),
        (pgs_gap <= MESH_PGS_POSE_TOL and cost_rel <= MESH_PGS_COST_RTOL,
         "PoseGraphSolver(mesh) is off the single-device solve"),
        (o["pgs64_route"] == "mesh_cg"
         and o["pgs64_packed"] == ("torch.float64", "cuda")
         and not any(o["launches"]["pgs64"].values())
         and pgs64_gap <= F64_MESH_POSE_TOL,
         "PoseGraphSolver(mesh, float64) is off the one-device float64 CG"),
        (off1_same and off1_gap <= MESH_POSE_TOL,
         "offline_slam(mesh) is off the unsharded mission's first round"),
        (off_ate <= MISSION_ATE_MAX and off["loops"] == roff["loops"]
         and chain_gap <= MESH_CHAIN_TOL,
         "offline_slam(mesh) is off the unsharded mission"),
        (mesh_same and mesh_gap <= MESH_POSE_TOL,
         "offline_slam(mesh) is off the mesh's solver run without ranks"),
        (karto_same and karto_gap <= MESH_KARTO_TOL,
         "KartoSLAM(mesh) is off the single-device run"),
        (hec_ate <= HECTOR_ATE_MAX, "HectorSLAM(mesh) ATE above its bar"),
        (schur_gap <= schur_bar and schur_coll["psum"] == 2
         and np.all(np.isfinite(o["schur"])),
         "the sharded Schur step is off the one-device step"),
        (all(p > 0 and c > 0 for p, c in per_rank),
         "a rank launched no PL-ICP or no correlative kernel"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"mesh ({label}): {what}")


def phase_mesh(dev, inputs: dict, refs: dict) -> dict:
    """The mesh forms on the card in two cases: (a) one rank over NCCL,
    (b) two ranks sharing the card over gloo. Each case is a correctness
    run, not a scaling measurement. Every rank must give the same results;
    rank 0 is held to the single-device results (``mesh_case_check``),
    the float64 solves of the two cases to each other (bit-equal) and the
    Hector runs to each other (trajectory within ``MESH_HECTOR_TOL``, maps
    equal). Returns the launches of every rank of both cases."""
    import pickle

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    path = MESH_DIR / "inputs.pkl"
    path.write_bytes(pickle.dumps(inputs))
    total = dict.fromkeys(_dispatch.LAUNCHES, 0)
    hector, pgs64 = {}, {}
    for label, D, backend in MESH_CASES:
        t0 = time.perf_counter()
        outs = run_mesh_case(label, D, backend, dev, path)
        print(f"mesh ({label}): {D} rank(s) spawned and joined in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        mesh_case_check(label, D, backend, outs, refs)
        for x in outs:
            for run in x["launches"].values():
                for k, v in run.items():
                    total[k] += v
        hector[label] = outs[0]["hector"]
        pgs64[label] = (outs[0]["pgs64"], outs[0]["pgs64_stats"])
    f64_same = (pgs64["a"][0].tobytes() == pgs64["b"][0].tobytes()
                and pgs64["a"][1] == pgs64["b"][1])
    print(f"mesh float64 solve (a) against (b): bit-equal {f64_same}",
          flush=True)
    if not f64_same:
        raise AssertionError("PoseGraphSolver(mesh, float64) differs between "
                             "one rank and two")
    a, b = hector["a"], hector["b"]
    gap = _max_gap(a["est"], b["est"])
    maps_eq = all(np.array_equal(x, y) for x, y in zip(a["maps"], b["maps"]))
    print(f"mesh hector (a) against (b): trajectory max|d| {gap:.3e} (bar "
          f"{MESH_HECTOR_TOL}), every level's map equal {maps_eq}",
          flush=True)
    if not (gap <= MESH_HECTOR_TOL and maps_eq):
        raise AssertionError("HectorSLAM(mesh) differs between one rank and "
                             "two")
    return total


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
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    clock("device and build")
    plicp = phase_plicp(dev)
    cr = phase_cr(dev)
    phase_edge_cases(dev)
    phase_plicp_edges(dev)
    clock("PL-ICP, CR-LM and edge cases")
    stream = phase_cr_stream(dev)
    phase_cr_both(dev)
    large_launches, ring_solves = phase_large_graph_main(dev)
    host_f64 = phase_host_f64(dev)
    phase_offline_corrected(dev)
    clock("large pose graphs, host f64 arm, corrected mission")
    cfg, scans, odom, gt, res, launches, batches = phase_main_path(dev)
    phase_mission_batches(cfg, res.poses.shape[0], batches)
    sweep = phase_loop_sweep("mission sweeps", batches["sweeps"], reps=50)
    pcg, pcg_base = phase_pcg(dev, res)
    phase_pcg_edges(dev)
    restart_launches = phase_pcg_restarts(dev, res, pcg_base)
    phase_mission_rate(cfg, scans, odom)
    phase_profile(cfg, scans, odom)
    clock("mission")
    schur_cost = phase_schur(dev, res, pcg_base, ring_solves, host_f64)
    clock("Schur routes")
    hector = phase_hector(dev)
    phase_hector_edges(dev)
    hector_launches = phase_hector_main(dev)
    clock("Hector")
    kcfg, kscans, kodom, kgt = karto_recipe(dev)
    resp, records, front, loop = phase_correlative(dev, kcfg, kscans, kgt)
    phase_correlative_edges(dev, records, front, loop)
    phase_karto_layers(dev, records)
    clock("correlative kernel")
    karto_launches, kslam, kacc = phase_karto_main(dev, kcfg, kscans, kodom,
                                                   kgt)
    clock("online Karto")
    phase_native(dev, kslam, smi)
    clock("native library")
    f64 = phase_f64(dev, f64_cases(res, kslam, float(pcg_base[3, 1]),
                                   ring_solves[4096][1], schur_cost))
    clock("float64 solver")
    outdoor_launches = phase_outdoor_main(dev)
    clock("outdoor mission")
    online_launches = phase_outdoor_online(dev)
    clock("online outdoor run")
    phase_gmapping(dev)
    clock("GMapping")
    nn = phase_nn(dev)
    clock("NN kernel")
    nn_launches = phase_lesson_main(dev)
    clock("lesson odometry")
    nn_launches += phase_scan_matching(dev)
    nn_launches += phase_undistortion(dev)
    phase_features(dev)
    clock("scan matching, undistortion, features")
    examples = phase_examples(dev)
    clock("examples")
    cli_launches = phase_bag_cli(dev)
    clock("command line and bag replay")
    mesh_launches = phase_mesh(dev, *mesh_inputs(
        dev, (cfg, scans, odom, gt, res),
        (kcfg, kscans, kodom, kgt, kslam, kacc),
        hector_seq(HECTOR_SCANS, dev), f64["mission graph"]))
    clock("multi-device layer")
    kernels = [
        {"name": "plicp_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/plicp_fused.cu",
         "replaces": "tpu_slam/ops/pallas/plicp_fused.py:585",
         "launches": launches["plicp_fused"]
         + outdoor_launches["plicp_fused"] + cli_launches["plicp_fused"]
         + mesh_launches["plicp_fused"] + examples["plicp_fused"],
         **plicp},
        {"name": "cr_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/cr_lm.cu",
         "replaces": "tpu_slam/solver/pallas_cr_lm.py:573",
         "launches": launches["cr_lm"] + online_launches["cr_lm"]
         + cli_launches["cr_lm"] + examples["cr_lm"], **cr},
        {"name": "cr_stream", "route": "cuda",
         "source": "tpu_slam_torch/csrc/cr_stream.cu",
         "replaces": "tpu_slam/solver/cr_stream.py:529",
         "launches": large_launches["cr_stream"]
         + online_launches["cr_stream"] + cli_launches["cr_stream"]
         + examples["cr_stream"], **stream},
        {"name": "pcg_lm", "route": "cuda",
         "source": "tpu_slam_torch/csrc/pcg_lm.cu",
         "replaces": "tpu_slam/solver/pallas_lm.py:384",
         "launches": launches["pcg_lm"] + online_launches["pcg_lm"]
         + restart_launches["pcg_lm"] + cli_launches["pcg_lm"]
         + examples["pcg_lm"], **pcg},
        {"name": "hector_fused", "route": "cuda",
         "source": "tpu_slam_torch/csrc/hector_fused.cu",
         "replaces": "tpu_slam/ops/pallas/hector_fused.py:269",
         "launches": hector_launches + cli_launches["hector_fused"]
         + examples["hector_fused"], **hector},
        {"name": "correlative_response", "route": "cuda",
         "source": "tpu_slam_torch/csrc/correlative_response.cu",
         "replaces": "tpu_slam/ops/pallas/correlative_response.py:160",
         "launches": karto_launches["correlative_response"]
         + outdoor_launches["correlative_response"]
         + online_launches["correlative_response"]
         + cli_launches["correlative_response"]
         + mesh_launches["correlative_response"]
         + examples["correlative_response"], **resp},
        {"name": "nn", "route": "cuda", "source": "tpu_slam_torch/csrc/nn.cu",
         "replaces": "tpu_slam/ops/pallas/nn.py:50",
         "launches": nn_launches + cli_launches["nn"] + examples["nn"],
         **nn},
        {"name": "loop_sweep", "route": "cuda",
         "source": "tpu_slam_torch/csrc/loop_sweep.cu",
         "replaces": "tpu_slam/models/offline.py:101",
         "launches": launches["loop_sweep"]
         + outdoor_launches["loop_sweep"] + cli_launches["loop_sweep"]
         + mesh_launches["loop_sweep"] + examples["loop_sweep"], **sweep},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
