"""Each kernel's roofline count against a count by hand at a small shape."""

import types
from pathlib import Path

import numpy as np
import pytest

from slam_bench import roofline, spec, traffic

DIRS = [Path(spec.__file__).resolve().parent]


class FakeTrace:
    """Launches of each kernel: key → [(start µs, end µs)], all inside
    every request."""

    def __init__(self, launches):
        self._l = launches

    def launches(self, key, t0, t1):
        return self._l.get(key, [])


def fake_run(config, pool, accounts, launches, n_requests=1):
    cell = types.SimpleNamespace(config=config, dirs=DIRS)
    return types.SimpleNamespace(
        cell=cell, pool=pool, accounts=accounts, trace=FakeTrace(launches),
        requests=[(0, 0.0, 1.0)] * n_requests)


def test_plicp_fused_count():
    # three scans of 4 beams: scan 0 all valid, scan 1 one beam past
    # range_max, scan 2 one non-finite beam; two chain pairs (1→0, 2→1)
    r = np.full((3, 4), 2.0, np.float32)
    r[1, 0] = 20.0
    r[2, 3] = np.inf
    mission = types.SimpleNamespace(ranges=r)
    acc = {"chain": {"rounds": np.array([3, 5])}}
    run = fake_run({"scan": {"range_min": 0.15, "range_max": 12.0}},
                   [mission], {0: acc}, {"plicp_fused": [(0.0, 2.0), (5.0, 9.0)]})
    ops, nbytes, sec = spec.load_module(DIRS, "rooflines", "plicp_fused").count(run)
    # pair 1→0: 3 valid sources, 4 valid targets, 3 rounds
    # pair 2→1: 3 valid sources, 3 valid targets, 5 rounds
    assert ops == 3 * (6 * 3 * 4 + 122 * 3) + 5 * (6 * 3 * 3 + 122 * 3)
    assert nbytes == 2 * (2 * 4 * 9 + 12 + 64)
    assert sec == pytest.approx(2e-6)  # the first launch: the chain batch


def test_pcg_lm_count():
    acc = {"graph": (np.arange(5), None, None, None), "poses": np.zeros((4, 3)),
           "lm_iterations": 7}
    run = fake_run({"solver": {"cg_iterations": 10}}, [None], {0: acc},
                   {"pcg_lm": [(0.0, 3.0), (4.0, 8.0)]})
    ops, nbytes, sec = spec.load_module(DIRS, "rooflines", "pcg_lm").count(run)
    per = 7 * (440 * 5 + 10 * (72 * 5 + 66 * 4))
    assert ops == 2 * per
    assert nbytes == 2 * (24 * 4 + 52 * 5)
    assert sec == pytest.approx(7e-6)


@pytest.mark.parametrize("key", ["cr_lm", "cr_stream"])
def test_banded_counts(key):
    # a 6-node chain with one closure 0-2: RCM bandwidth 2 → b = 9
    g = traffic.Graph(init=np.zeros((6, 3)), ei=np.array([0, 1, 2, 3, 4, 0]),
                      ej=np.array([1, 2, 3, 4, 5, 2]), means=None, infos=None)
    run = fake_run({}, [g], {0: {"lm_iterations": 4}},
                   {key: [(0.0, 1.0), (2.0, 4.0)]})
    ops, nbytes, sec = spec.load_module(DIRS, "rooflines", key).count(run)
    n, b = 18, 9
    assert ops == 4 * (440 * 6 + n * b * b + 4 * n * b)
    assert nbytes == 24 * 6 + 52 * 6
    assert sec == pytest.approx(3e-6)


def test_share_is_least_time_over_device_time():
    least = roofline.least_seconds(67e9, 1.0)
    assert least == pytest.approx(1e-3)
    assert roofline.least_seconds(1.0, 3.35e9) == pytest.approx(1e-3)
