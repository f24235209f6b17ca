"""The bench mission's loop-closed graph, built by both packages: the same
loops and the same pose graph, which does not band under RCM, so the
reference routes its solve past the cyclic-reduction LM too.

The bench mission is bench.py's bench_karto world (3 laps of the corridor
loop, drifting odometry) cut from 360 to 180 beams to stay a CPU-sized
run, and to its first detect→match→solve round: that round's candidates
come from the chain alone, so both packages see the same batch. Later
rounds start from each package's own solve (the reference's CPU CG
program, the port's PCG), and their candidate sets drift apart."""

import dataclasses

import numpy as np
import pytest

from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.models import offline as joff
from tpu_slam.solver import banded
from tpu_slam_torch.convert import scan_from_numpy
from tpu_slam_torch.models import offline as toff

from test_torch_host_copies import port_config

BEAMS = 180


def _bench_mission():
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, num_beams=BEAMS, range_max=12.0,
                                 range_threshold=10.0),
        offline=dataclasses.replace(cfg.offline, rounds=1),
    )
    traj = np.concatenate(
        [sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)] * 3)
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    rng = np.random.default_rng(3)
    drift = np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], (len(traj), 3)), 0)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq.gt_poses + drift


def _graph(res):
    edges = res.solver._edges
    return (np.array([e[0] for e in edges]), np.array([e[1] for e in edges]))


def _rcm_bandwidth(ei, ej, n):
    perm = banded.rcm_order(ei, ej, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return int(np.abs(inv[ei] - inv[ej]).max())


@pytest.mark.slow
def test_bench_mission_graph_matches_reference_and_does_not_band():
    cfg, scans, odom = _bench_mission()
    ref = joff.offline_slam(scans, cfg, odom=odom)
    out = toff.offline_slam(scan_from_numpy(*(np.asarray(getattr(scans, f))
                                              for f in ("ranges", "valid",
                                                        "angles", "stamp",
                                                        "time_increment")),
                                            device="cpu"),
                            port_config(cfg), odom=odom)
    assert out.candidates_tried == ref.candidates_tried
    assert sorted((e.i, e.j) for e in out.loops) == sorted(
        (e.i, e.j) for e in ref.loops)
    (ri, rj), (oi, oj) = _graph(ref), _graph(out)
    np.testing.assert_array_equal(oi, ri)
    np.testing.assert_array_equal(oj, rj)
    T = len(odom)
    bw = _rcm_bandwidth(ri, rj, T)
    assert bw > cfg.solver.direct_max_bandwidth
    assert banded.prepare_banded(ri, rj, T,
                                 cfg.solver.direct_max_bandwidth) is None
    assert out.solver._band_spec() is None
    np.testing.assert_allclose(out.poses[:, :2], ref.poses[:, :2], atol=1e-3)
