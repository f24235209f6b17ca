"""The traffic generator: the same seed gives bit-equal requests and
visiting order, another seed different ones of the same sizes."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from slam_bench import traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


# bench_solver's 16,384-node ring with noisy edges: no cell runs it yet
RING = {"request": "pose_graph_solve", "kind": "ring_graph", "nodes": 16384,
        "radius": 10.0, "closure_every": 16, "drift_std": [0.02, 0.02, 0.004],
        "edge_noise_std": [0.001, 0.001, 0.0005],
        "info_diag": [1e6, 1e6, 4e6], "pool": 8}


def small(name):
    t = (dict(RING) if name == "ring" else
         json.loads((TRAFFIC / f"{name}.json").read_text()))
    if t["kind"] == "corridor_mission":
        t.update(beams=45, laps=1)
    else:
        t.update(nodes=min(t["nodes"], 300))
    t["pool"] = 2
    return t


def arrays(item):
    return [np.asarray(v) for v in vars(item).values()
            if isinstance(v, np.ndarray)]


@pytest.mark.parametrize("name", ["corridor_3lap", "ring", "chain2loop1k"])
def test_same_seed_same_traffic(name):
    t = small(name)
    big = 2**31 + 12345  # a seed may run past 32 signed bits
    a, b, c = (traffic.make_pool(t, s) for s in (big, big, big + 1))
    for x, y, z in zip(a, b, c):
        ax, ay, az = arrays(x), arrays(y), arrays(z)
        assert all(np.array_equal(p, q, equal_nan=True) for p, q in zip(ax, ay))
        assert [p.shape for p in ax] == [q.shape for q in az]
        assert not all(np.array_equal(p, q, equal_nan=True)
                       for p, q in zip(ax, az))
    take = lambda s: list(itertools.islice(traffic.visit_order(t, s), 10))
    assert take(big) == take(big)
    assert sorted(take(big)[:2]) == [0, 1]


def test_recipes_match_the_repository_sizes():
    ring = traffic.ring_graph(RING, traffic.rng_for(1, 0))
    assert (len(ring.init), len(ring.ei)) == (16384, 17408)
    chain = traffic.loop_chain_graph(
        json.loads((TRAFFIC / "chain2loop1k.json").read_text()),
        traffic.rng_for(1, 0))
    assert (len(chain.init), len(chain.ei)) == (1024, 1034)
    lap = json.loads((TRAFFIC / "corridor_3lap.json").read_text())
    traj = traffic.loop_trajectory(lap["arm"], lap["width"], lap["speed"],
                                   lap["scan_period"], lap["laps"])
    assert len(traj) == 984  # one lap is 352 scans; the laps do not restart
    assert np.hypot(*np.diff(traj[:, :2], axis=0).T).max() < 0.1
