"""The device trace's arithmetic on a hand-made trace: the union of
intervals, busy time, launches by kernel, the largest device operations
and the idle gaps by the host span open at each."""

import pytest

from slam_bench import trace


def made():
    t = trace.DeviceTrace(["cr_lm", "plicp_fused"])
    # µs on the trace's clock = host seconds × 1e6 + 100
    raw = [(110.0, 130.0, "void cr_lm_kernel<6>(float*)"),
           (120.0, 140.0, "Memcpy HtoD (Pageable -> Device)"),
           (160.0, 170.0, "plicp_fused_kernel"),
           (200.0, 260.0, "cr_lm_kernel")]
    t.index(raw, 100.0)
    return t


def test_union_and_busy():
    t = made()
    assert t.merged.tolist() == [[110, 140], [160, 170], [200, 260]]
    assert t.busy_s(0.0, 200e-6) == pytest.approx(100e-6)  # [100, 300] µs
    assert t.busy_s(30e-6, 110e-6) == pytest.approx(30e-6)


def test_launches_and_top_ops():
    t = made()
    assert t.launches("cr_lm", 0.0, 1.0) == [(110.0, 130.0), (200.0, 260.0)]
    assert t.launches("cr_lm", 50e-6, 1.0) == [(200.0, 260.0)]
    top = t.top_ops(0.0, 1.0)
    assert top[0] == ["cr_lm", pytest.approx(80e-6)]
    assert [k for k, _ in top] == ["cr_lm", "Memcpy HtoD (Pageable -> Device)",
                                   "plicp_fused"]


def test_idle_gaps_by_innermost_span():
    t = made()
    spans = [("request", 0.0, 150e-6), ("build", 35e-6, 60e-6)]
    gaps = dict(t.idle_gaps(0.0, 170e-6, spans))
    # the window is [100, 270] µs; idle [100, 110] and [170, 200] in
    # "request" (to 250 µs), [140, 160] in "build" (its middle, 150 µs, is
    # host 50 µs), [260, 270] after both spans
    assert gaps == pytest.approx({"request": 40e-6, "build": 20e-6,
                                  "between requests": 10e-6})
