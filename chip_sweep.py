"""Shape sweeps on the card: the measurements behind two kernels' chosen
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

Run from the root of the repository: ``python3 chip_sweep.py`` (one CUDA
card; builds the two kernels at first use). Prints one line per setting.
"""

from __future__ import annotations

import statistics

import torch

import chip_smoke as cs
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.convert import solver_from_numpy
from tpu_slam_torch.ops.cuda import nn as cnn
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


def main() -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    sweep_nn(dev)
    sweep_cr_stream(dev)


if __name__ == "__main__":
    main()
