"""Stage timers, throughput counters and a device trace — the port's own
copy of ``tpu_slam/utils/profiling.py`` (``StageTimer``,
``ThroughputCounter``; ``device_trace`` on ``torch.profiler``).

``sync`` is the timing barrier: ``torch.cuda.synchronize()`` when the
result holds a CUDA tensor, nothing on the CPU (PyTorch's CPU ops finish
before they return).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def sync(x) -> None:
    """Wait for the device work behind every CUDA tensor in ``x``."""
    for t in _tensors(x):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class StageTimer:
    """Accumulating per-stage wall-clock timers.

    >>> t = StageTimer()
    >>> with t.stage("match"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                sync(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1000.0 * self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = [
            f"{k}: {self.mean_ms(k):.2f} ms/call ×{self.counts[k]}"
            f" (total {self.totals[k]:.2f}s)"
            for k in sorted(self.totals)
        ]
        return "\n".join(lines)


class ThroughputCounter:
    """scans/sec counter (the per-node Hz prints of the reference)."""

    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def tick(self, k: int = 1) -> None:
        self.n += k

    @property
    def per_sec(self) -> float:
        return self.n / max(time.perf_counter() - self.t0, 1e-9)


@contextlib.contextmanager
def device_trace(path: str):
    """``torch.profiler`` trace of the block, written to ``path`` as a
    Chrome trace (``export_chrome_trace``): host ops, and the card's
    kernels when a CUDA device is in use. View it in Perfetto
    (ui.perfetto.dev) or ``chrome://tracing``; it is not a TensorBoard
    xprof trace, as the JAX package's ``device_trace`` writes."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
