"""The device trace of a window: ``torch.profiler`` on the card alone (a
host-op trace of ~10^5 small launches costs more to record and read than
the run), read from the raw kineto events.

The host's spans are on ``time.perf_counter``; the trace's events on the
profiler's clock. A marker kernel launched right after the profiler
starts, at a known host time, ties the two: ``device_us(t)`` is host time
``t`` on the trace's clock, to within a launch's latency."""

from __future__ import annotations

import re
import time

import numpy as np
import torch


def kernel_key(name: str, keys) -> str:
    """A program kernel's key for a kernel named ``<key>_kernel`` or
    ``<key>_<stage>_kernel`` (from a word's start), else the name itself,
    cut to 80 characters."""
    for k in keys:
        if re.search(rf"(^|\W){k}_(\w+_)?kernel\b", name):
            return k
    return name[:80]


def union(spans) -> np.ndarray:
    """Merge (start, end) intervals: an (n, 2) array sorted by start."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, np.float64).reshape(-1, 2)


def overlap(merged: np.ndarray, a: float, b: float) -> float:
    """Length of [a, b] covered by the merged intervals."""
    lo = np.searchsorted(merged[:, 1], a)  # the first ending after a
    hi = np.searchsorted(merged[:, 0], b)  # past the last starting before b
    m = merged[lo:hi]
    return float(np.clip(np.minimum(m[:, 1], b) - np.maximum(m[:, 0], a),
                         0.0, None).sum())


def innermost(spans, points) -> list:
    """For each point, the name of the shortest span (name, start, end)
    that holds it, else None. Only spans that start within the longest
    span's length before a point can hold it."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = np.asarray([x[1] for x in spans])
    longest = max((e - s for _n, s, e in spans), default=0.0)
    out = []
    for p in points:
        k = int(np.searchsorted(starts, p, side="right")) - 1
        best = None
        while k >= 0 and spans[k][1] >= p - longest:
            name, s0, e0 = spans[k]
            if e0 >= p and (best is None or e0 - s0 < best[0]):
                best = (e0 - s0, name)
            k -= 1
        out.append(None if best is None else best[1])
    return out


class DeviceTrace:
    def __init__(self, keys):
        self.keys = list(keys)
        self.events = []  # (key, start µs, end µs) on the trace's clock

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._pc0 = time.perf_counter()
        torch.zeros(1, device="cuda")  # the marker
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        raw = sorted(
            (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
             e.name())
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA" and e.duration_ns() > 0)
        self._prof = None
        self.index(raw[1:], raw[0][0] - self._pc0 * 1e6 if raw else 0.0)

    def index(self, raw, offset: float) -> None:
        """Key and index the events ``raw`` ((start µs, end µs, name),
        sorted by start); ``offset`` is the trace's clock less the host's."""
        self._offset = offset
        self.events = [(kernel_key(n, self.keys), s, e) for s, e, n in raw]
        self.merged = union((s, e) for _k, s, e in self.events)
        by_key = {}
        for k, s, e in self.events:
            by_key.setdefault(k, []).append((s, e))
        self._by_key = {k: np.asarray(v) for k, v in by_key.items()}

    def device_us(self, t: float) -> float:
        return t * 1e6 + self._offset

    def busy_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] (host clock) in which the device ran an
        operation."""
        return overlap(self.merged, self.device_us(t0), self.device_us(t1)) / 1e6

    def launches(self, key: str, t0: float, t1: float) -> list:
        """(start µs, end µs) of each launch of ``key`` that starts in
        [t0, t1] (host clock), in order."""
        v = self._by_key.get(key)
        if v is None:
            return []
        lo, hi = np.searchsorted(v[:, 0], [self.device_us(t0),
                                           self.device_us(t1)], side="left")
        return [tuple(x) for x in v[lo:hi]]

    def top_ops(self, t0: float, t1: float, n: int = 10) -> list:
        """The device operations that took most time in [t0, t1]:
        [[name, seconds], ...]."""
        tot = {k: sum(e - s for s, e in self.launches(k, t0, t1)) / 1e6
               for k in self._by_key}
        return sorted(([k, v] for k, v in tot.items() if v > 0),
                      key=lambda x: -x[1])[:n]

    def idle_gaps(self, t0: float, t1: float, spans, n: int = 10) -> list:
        """The device's idle time in [t0, t1] by the innermost host span
        (name, start, end on the host clock) open at each gap's middle:
        [[name, seconds], ...], the largest first."""
        a, b = self.device_us(t0), self.device_us(t1)
        m = self.merged
        m = m[(m[:, 1] > a) & (m[:, 0] < b)]
        edges = np.concatenate([[a], np.clip(m, a, b).ravel(), [b]])
        gs, ge = edges[0::2], edges[1::2]
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        spans = [(name, self.device_us(s), self.device_us(e))
                 for name, s, e in spans]
        tot = {}
        for name, s, e in zip(innermost(spans, 0.5 * (gs + ge)), gs, ge):
            name = name or "between requests"
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda x: -x[1])[:n]

    def dump(self, path, t0: float, t1: float) -> None:
        """The window's device events, µs from the window's start."""
        import json

        a = self.device_us(t0)
        with open(path, "w") as f:
            json.dump({"events": [[k, round(s - a, 3), round(e - s, 3)]
                                  for k, s, e in self.events]}, f)
