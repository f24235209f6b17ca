"""Shape sweeps on the card: the measurements behind five kernels' chosen
shapes.

- The NN kernel (``tpu_slam_torch/csrc/nn.cu``) at every G = 1 … 32 lanes
  a source, on the odometry's shape (1 × 360 × 360), the scan-matching
  batch's (120 × 360 × 360) and a batch of 512 such pairs: the device time
  per launch of a replayed CUDA graph of launches (``chip_smoke.graph_ms``),
  each G held bit-equal to the plain version; ``nn_geometry``'s own choice
  is marked.
- The streamed CR-LM (``tpu_slam_torch/csrc/cr_stream.cu``) on
  bench_solver's rings of 4,096 and 16,384 nodes, with the cluster taking
  over at 512, 256, 128 or 64 active supernodes and 4 or 40 LM iterations
  enqueued between two reads of the device's done flag: the kernel's ms
  (CUDA events, median of 3) and, at chunk 4, the device time by stage
  under ``torch.profiler``; the poses against those of the chosen shape.

- The PL-ICP kernel (``tpu_slam_torch/csrc/plicp_fused.cu``) at 64, 96,
  128, 192 and 384 threads a pair (6, 4, 3, 2 and 1 sources a thread at
  N = 360), on the bench batch (512 pairs), its first 64 pairs, and the
  mission's chain and first loop batches as its counted run records
  them: each setting
  held to the phase's bars against the plain version
  (``chip_smoke.plicp_pair_gaps``, ``chain_gaps``, ``loop_gaps``; a
  setting outside them is printed so, and the chosen one must hold) and
  timed as a replayed CUDA graph of its launches; the choice is marked.
- The Hector kernel (``tpu_slam_torch/csrc/hector_fused.cu``) at 2, 4, 8
  and 12 warps a match on bench_hector's case, each held to
  ``chip_smoke.hector_compare``'s bars and timed the same way;
  ``hector_geometry``'s choice is marked.

- The correlative response kernel
  (``tpu_slam_torch/csrc/correlative_response.cu``) on its row path (an
  8-byte chunk a thread: 4 candidates at stride 2, 8 at stride 1) and
  its byte path (2 candidates a thread), at 2, 4, 8, 16 and 32 warps a
  block
  (``correlative_response.shape_at``: the tile and the beam slices follow
  from them), at its seven pass shapes (``chip_rates.correlative_passes``:
  the Karto recipe's front coarse, front fine and loop coarse passes, the
  outdoor mission's long and short anchor passes, coarse and fine), each
  setting held int32-equal to ``sum_windows`` and timed as a replayed
  CUDA graph of its launches; ``response_geometry``'s choice is marked.

Run from the root of the repository: ``python3 chip_sweep.py`` (one CUDA
card; builds the kernels at first use). Prints one line per setting;
``python3 chip_sweep.py plicp hector`` runs only the sweeps named.
"""

from __future__ import annotations

import statistics
import sys

import torch

import chip_rates
import chip_smoke as cs
from tpu_slam_torch import _dispatch
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.ops import correlative as corr
from tpu_slam_torch.ops.cuda import correlative_response as cresp
from tpu_slam_torch.ops.cuda import hector_fused as chec
from tpu_slam_torch.ops.cuda import nn as cnn
from tpu_slam_torch.ops.cuda import plicp_fused as cplicp
from tpu_slam_torch.ops.matching import nearest_neighbor_direct
from tpu_slam_torch.solver import cr_stream as crs
from tpu_slam_torch.solver.pose_graph import _sq_min_delta


def sweep_nn(dev) -> None:
    _c, scans, _g = cs.lesson_recipe(dev, 2)
    src, _sv, tgt, tv = cs.masked_pairs(scans)
    _c, (bs, _bsv, bt, btv), _g = cs.scan_matching_recipe(dev)
    big = tuple(torch.cat([x] * 5)[:512].contiguous() for x in (bs, bt, btv))
    chosen = cnn.nn_geometry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for s, t, v in ((src, tgt, tv), (bs, bt, btv), big):
            B, N, _ = s.shape
            M = t.shape[1]
            want_i, want_d = nearest_neighbor_direct(s, t, v)
            pick = chosen(B, N, M, sms).lanes
            for G in (1, 2, 4, 8, 16, 32):
                geo = cnn.tile_sources(N, M, G)
                cnn.nn_geometry = lambda *_a, geo=geo: geo
                ki, kd = cnn.nearest_neighbor_cuda(s, t, v)
                if not (torch.equal(ki, want_i) and torch.equal(
                        kd.view(torch.int32), want_d.view(torch.int32))):
                    raise AssertionError(f"nn G={G}: not bit-equal")
                ms, host_us, how = cs.graph_ms(
                    lambda: cnn.nearest_neighbor_cuda(s, t, v), 300)
                print(f"sweep nn {B}x{N}x{M} G={G}"
                      f"{' (chosen)' if G == pick else ''}: {ms:.5f} ms a "
                      f"launch ({how}), {geo.threads} threads x "
                      f"({B}, {geo.tiles}) blocks, bit-equal", flush=True)
    finally:
        cnn.nn_geometry = chosen


def sweep_cr_stream(dev) -> None:
    cfg = SolverConfig()
    chosen = (crs.CLUSTER_ACTIVE, crs.CHUNK)
    try:
        for nodes in (4096, 16384):
            spec, pT8, slots = solver_from_numpy(
                cfg, *cs.bench_ring(nodes), dev).direct_inputs()

            def run():
                return crs.streamed_cr_lm(
                    pT8, slots, cfg.initial_lambda, W=spec.W, K=spec.K,
                    iters=cfg.max_iterations,
                    sq_min_delta=_sq_min_delta(cfg.convergence_delta))

            crs.CLUSTER_ACTIVE, crs.CHUNK = chosen
            base = run()
            for active in (512, 256, 128, 64):
                for chunk in (4, 40):
                    crs.CLUSTER_ACTIVE, crs.CHUNK = active, chunk
                    out = run()
                    torch.cuda.synchronize()
                    gap = float((out[0:3] - base[0:3]).abs().max())
                    ms = statistics.median(cs.cuda_ms(run, 1)
                                           for _ in range(3))
                    sched = crs.stream_schedule(spec.W, spec.K)
                    mark = " (chosen)" if (active, chunk) == chosen else ""
                    line = (f"sweep cr_stream ring {nodes} (W {spec.W}, K "
                            f"{spec.K}) cluster from {active} active, chunk "
                            f"{chunk}{mark}: {ms:.3f} ms, {sched.per_iter} "
                            f"launches an iteration, iters "
                            f"{int(out[3, 3])} cost {float(out[3, 1]):.6g}, "
                            f"poses within {gap:.2e} of the chosen shape's")
                    if chunk == 4:
                        wall, busy, per = cs.device_profile(run, stages=True)
                        line += (f"; profile wall {wall / 1e3:.3f} ms busy "
                                 f"{busy / 1e3:.3f} ms: " + "; ".join(
                                     f"{k} {n} x {us / n:.2f} us"
                                     for k, (n, us) in sorted(per.items())))
                    print(line, flush=True)
    finally:
        crs.CLUSTER_ACTIVE, crs.CHUNK = chosen


PLICP_THREADS = (64, 96, 128, 192, 384)
HECTOR_WARPS = (2, 4, 8, 12)


def sweep_plicp(dev) -> None:
    cfg, args, g = cs.plicp_bench_batch(dev)
    small = tuple(x[:64].contiguous() for x in args)
    mcfg, scans, odom, gt = cs.bench_mission(dev)
    with cs.recording_batches() as rec:
        offline_slam(scans, mcfg, odom=odom)
    S = rec["seeds"]
    plain_c, plain_l = cs.plain_matchers(mcfg, S)
    chain_rows, loop_rows = plain_c(*rec["chain"]), plain_l(*rec["loop"])
    plain_big = cs.plain_plicp(*args, cfg.plicp, init_pose=g)
    plain_small = cs.plain_plicp(*small, cfg.plicp, init_pose=g[:64])
    cases = (
        ("512 pairs", args, g, cfg, 50,
         lambda: cs.plicp_pair_gaps(cfg, args, g, plain_big)[0]),
        ("64 pairs", small, g[:64], cfg, 50,
         lambda: cs.plicp_pair_gaps(cfg, small, g[:64], plain_small)[0]),
        ("mission chain", cs.mission_pairs(*rec["chain"][:5]),
         rec["chain"][5], mcfg, 20,
         lambda: cs.chain_gaps(mcfg, len(gt), rec["chain"], chain_rows)[0]),
        ("mission loop", cs.mission_pairs(*rec["loop"][:5]), rec["loop"][5],
         mcfg, 10,
         lambda: cs.loop_gaps(mcfg, S, rec["loop"], loop_rows)[2]),
    )
    chosen = cplicp.plicp_geometry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for label, pairs, gs, c, reps, gap in cases:
            B, N, _ = pairs[0].shape
            M = pairs[2].shape[1]
            pick = chosen(B, N, M, sms)
            shapes = [cplicp.shape_at(N, M, t, -(-N // t))
                      for t in PLICP_THREADS]
            for shape in shapes:
                cplicp.plicp_geometry = lambda *_a, shape=shape: shape
                try:
                    held = f"within the phase's bars (pose {gap():.2e})"
                except AssertionError as err:
                    if shape == pick:
                        raise
                    held = f"OUTSIDE the phase's bars ({err})"
                ms, _host_us, how = cs.graph_ms(
                    lambda: cplicp.launch_plicp(*pairs, c.plicp, gs), reps)
                mark = " (chosen)" if shape == pick else ""
                print(f"sweep plicp {label} ({B}x{N}x{M}) {shape.threads} "
                      f"threads x {shape.sources} sources{mark}: {ms:.4f} "
                      f"ms a launch ({how}), {held}", flush=True)
    finally:
        cplicp.plicp_geometry = chosen


def sweep_hector(dev) -> None:
    slam, probs, guess, pts, valid, _t = cs.hector_case(dev)
    N = pts.shape[0]
    hc = slam.cfg.hector
    steps = hc.iterations_fine + 1 + (len(probs) - 1) * (
        hc.iterations_coarse + 1)
    chosen = chec.hector_geometry
    pick = chosen(N)
    try:
        for warps in HECTOR_WARPS:
            split = chec.HectorGeometry(32 * warps, -(-N // (32 * warps)))
            chec.hector_geometry = lambda _n, split=split: split
            dpose, _k, _p, kern, _pl = cs.hector_compare(
                slam, probs, guess, pts, valid,
                f"sweep hector {warps} warps x {split.beams} beams")
            ms, host_us, how = cs.graph_ms(kern, 200)
            print(f"sweep hector {N} beams {warps} warps x {split.beams} "
                  f"beams{' (chosen)' if split == pick else ''}: {ms:.5f} ms "
                  f"a match ({how}), {ms * 1e3 / steps:.3f} us a GN step",
                  flush=True)
    finally:
        chec.hector_geometry = chosen


CORR_R = (0, 2)  # 0: the row path, 2: the byte path
CORR_WARPS = (2, 4, 8, 16, 32)


def sweep_correlative(dev) -> None:
    chosen = cresp.response_geometry
    sms = _dispatch.sm_count(dev)
    try:
        for label, args in chip_rates.correlative_passes(dev).items():
            grid, ys, xs, v, nx, ny, stride = args
            C, A, N = ys.shape
            want = corr.sum_windows(*args)
            W = grid.shape[2]
            pick = chosen(C, A, W, nx, ny, stride, N, sms)
            reps = max(5, min(200, int(2e8 // (A * C * nx * ny * N))))
            for R in CORR_R:
                warp_set = sorted(set(CORR_WARPS) | (
                    {pick.threads // 32} if pick.R == R else set()))
                for warps in warp_set:
                    try:
                        geo = cresp.shape_at(C, A, W, nx, ny, stride, N,
                                             sms, R, warps)
                    except ValueError:
                        continue  # no such launch at this shape
                    cresp.response_geometry = lambda *_a, geo=geo: geo
                    got = cresp.responses_sliced(*args)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label} {geo}: not "
                                             "int32-equal")
                    ms, _host_us, how = cs.graph_ms(
                        lambda: cresp.responses_sliced(*args), reps)
                    print(f"sweep {label} ({C}x{A}x{ny}x{nx} stride "
                          f"{stride}, {N} beams) path={geo.path} R={R} "
                          f"warps={warps} blocks="
                          f"{geo.blocks(C, A, nx, ny, stride)} strips/tile="
                          f"{geo.strips} slices={geo.slices}"
                          f"{' (chosen)' if geo == pick else ''}: {ms:.5f} "
                          f"ms a launch ({how}), int32-equal", flush=True)
    finally:
        cresp.response_geometry = chosen


SWEEPS = {"nn": sweep_nn, "cr_stream": sweep_cr_stream, "plicp": sweep_plicp,
          "hector": sweep_hector, "correlative": sweep_correlative}


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    for name in sys.argv[1:] or SWEEPS:
        SWEEPS[name](dev)


if __name__ == "__main__":
    main()
