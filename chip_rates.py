"""Mission, Hector and online Karto scans/s of one checkout, and the device
time of the PL-ICP, NN and correlative response kernels at the main
paths' shapes, for comparing two commits within one call on the card.

    python3 chip_rates.py LABEL

Runs ``chip_smoke``'s recipes from the checkout it is started in (its
``chip_smoke.py`` and ``tpu_slam_torch``): the bench mission through
``offline_slam``, the 150-scan Hector run and the 352-scan online Karto
run (``karto_recipe``), each once to warm up and then ``RUNS`` times;
the PL-ICP kernel on the 512-pair bench batch, on its first 64 pairs
(one source a thread) and on the mission's first chain and loop
batches, the NN kernel at the odometry's 1 × 360 × 360, and the
correlative kernel at the Karto recipe's front coarse and loop coarse
passes and the outdoor mission's long anchor coarse pass (at the true
poses; ``correlative_passes``), each timed as a replayed CUDA graph of
its launches (``chip_smoke.graph_ms``), and the PCG-LM kernel on the
mission's loop-closed graph and ``phase_pcg_edges``' three graphs
(``pcg_graphs``: CUDA events, and a digest of each packed result, so
that two checkouts' bits compare). Prints one line, ``RATES`` and a
JSON object with the label, each run's scans/s (sorted), their medians
and the kernels' ms a launch. To compare a parent with a change on one
card, copy this file into both checkouts and run it in each,
alternating: parent, change, change, parent. Host-bound rates spread
between calls, so compare only within one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.ops.cuda import correlative_response
from tpu_slam_torch.ops.cuda.nn import nearest_neighbor_cuda
from tpu_slam_torch.ops.cuda.plicp_fused import launch_plicp
from tpu_slam_torch.solver.pcg_lm import fused_lm_solve

RUNS = 5
# the correlative passes this script times, and their graph replays
TIMED_PASSES = {"correlative front coarse": 100, "correlative loop coarse": 10,
                "correlative anchor long coarse": 20}


def rates(run, scans: int) -> list[float]:
    """Scans/s of ``RUNS`` calls of ``run`` after a warm one."""
    out = []
    for i in range(RUNS + 1):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i:
            out.append(scans / (time.perf_counter() - t0))
    return sorted(out)


def correlative_passes(dev) -> dict:
    """The correlative kernel's seven pass shapes, as chip_smoke builds
    them: the Karto recipe's front coarse and fine passes and loop coarse
    pass (``phase_correlative``'s cases) and the outdoor mission's first
    anchor group of each level, coarse and fine (``anchor_passes``, here
    at the true poses). {label: the kernel's arguments, flags (C, N)}."""
    kcfg, kscans, _o, kgt = cs.karto_recipe(dev)
    slam, pts, valid, poses = cs.karto_records(kcfg, kscans, kgt, dev)
    base = np.arange(2, 130)[None]
    chains = np.full((8, 16), -1)
    for k, s0 in enumerate(range(0, 320, 40)):
        chains[k, :10] = np.arange(s0, s0 + 10)
    cases = {
        "correlative front coarse": cs.response_case(
            slam.front_matcher, base, pts, valid, poses, 130,
            [0.03, -0.02, 0.01]),
        "correlative front fine": cs.response_case(
            slam.front_matcher, base, pts, valid, poses, 130,
            [0.004, -0.003, 0.002], fine=True),
        "correlative loop coarse": cs.response_case(
            slam.loop_matcher, chains, pts, valid, poses, len(kgt) - 1,
            [0.2, -0.15, 0.03]),
    }
    out = {}
    for label, (grid, ys, xs, v, nx, ny, stride) in cases.items():
        out[label] = (grid, ys, xs, v.expand(ys.shape[0], v.shape[-1]), nx,
                      ny, stride)
    ocfg, oscans, _o, ogt = cs.outdoor_recipe(dev)
    out.update(cs.anchor_passes(ocfg, oscans, ogt))
    return out


def pcg_graphs(dev, res) -> dict:
    """The PCG-LM kernel on the mission's loop-closed graph from its raw
    chain (chip_smoke's ``phase_pcg``) and on ``phase_pcg_edges``' 129-node
    ring and 2,999- and 9,000-node chains: {graph: [ms a solve by CUDA
    events, the first 16 hex digits of the packed result's sha256]}."""
    cfg = cs.SolverConfig()
    init, ei, ej, means, infos = cs._ring_edges(129, 4,
                                                np.random.default_rng(31))
    solvers = {"ring129": cs.solver_from_numpy(
        cfg, init, list(zip(ei, ej, means, infos)), dev)}
    for n, c in ((2999, cfg), (9000, dataclasses.replace(
            cfg, f64_schur_above=0))):
        solvers[f"chain{n}"] = cs.solver_from_numpy(
            c, *cs.exact_chain(n, (8, 32), every=False), dev)
    cases = {"mission": cs.pcg_args(dev, res.solver, res.chain_poses)}
    cases.update({k: cs.pcg_args(dev, s) for k, s in solvers.items()})
    out = {}
    for name, (args, kw) in cases.items():
        def kern(args=args, kw=kw):
            return fused_lm_solve(*args, **kw)[5]
        digest = hashlib.sha256(kern().cpu().numpy().tobytes()).hexdigest()
        out[name] = [cs.cuda_ms(kern, 5), digest[:16]]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_rates.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg, scans, odom, gt = cs.bench_mission(dev)
    mission = rates(lambda: offline_slam(scans, cfg, odom=odom), len(gt))
    hcfg, hscans, hgt = cs.hector_seq(cs.HECTOR_SCANS, dev)
    hector = rates(lambda: cs.hector_run(hcfg, hscans, hgt, dev), len(hgt))
    kcfg, kscans, kodom, kgt = cs.karto_recipe(dev)
    karto = rates(lambda: cs.karto_run(kcfg, kscans, kodom, dev), len(kgt))
    pcfg, pairs, g = cs.plicp_bench_batch(dev)
    plicp_ms = cs.graph_ms(lambda: launch_plicp(*pairs, pcfg.plicp, g),
                           50)[0]
    small = [a[:64].contiguous() for a in pairs]
    plicp64_ms = cs.graph_ms(
        lambda: launch_plicp(*small, pcfg.plicp, g[:64]), 50)[0]
    with cs.recording_batches() as rec:
        res = offline_slam(scans, cfg, odom=odom)
    batch_ms = {}
    for key in ("chain", "loop"):
        batch = cs.mission_pairs(*rec[key][:5])
        batch_ms[key] = cs.graph_ms(
            lambda: launch_plicp(*batch, cfg.plicp, rec[key][5]), 20)[0]
    _c, lscans, _g = cs.lesson_recipe(dev, 2)
    src, _sv, tgt, tv = cs.masked_pairs(lscans)
    nn_ms = cs.graph_ms(lambda: nearest_neighbor_cuda(src, tgt, tv), 500)[0]
    passes = correlative_passes(dev)
    corr_ms = {}
    for label, reps in TIMED_PASSES.items():
        args = passes[label]
        corr_ms[label.replace("correlative ", "").replace(" ", "_")] = (
            cs.graph_ms(lambda: correlative_response.responses_sliced(*args),
                        reps)[0])
    print("RATES " + json.dumps({
        "label": sys.argv[1] if len(sys.argv) > 1 else "",
        "mission_scans_s": mission,
        "mission_median": statistics.median(mission),
        "hector_scans_s": hector,
        "hector_median": statistics.median(hector),
        "karto_scans_s": karto,
        "karto_median": statistics.median(karto),
        "plicp_512_pairs_ms": plicp_ms, "plicp_64_pairs_ms": plicp64_ms,
        "plicp_chain_ms": batch_ms["chain"], "plicp_loop_ms": batch_ms["loop"],
        "nn_odometry_ms": nn_ms,
        "correlative_ms": corr_ms,
        "pcg_lm_ms_digest": pcg_graphs(dev, res)}),
        flush=True)


if __name__ == "__main__":
    main()
