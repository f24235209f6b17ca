"""Stage timers, the spans and counters that join the caller's open stage,
and a device trace — the port's own copy of
``tpu_slam/utils/profiling.py`` (``StageTimer``; ``device_trace`` on
``torch.profiler``).

A ``StageTimer`` stage makes its timer the *open timer* for the block.
Library code below it records into that timer without being handed it:
``span(name)`` is a stage of the open timer and ``count(name, k)`` adds
to its counter ``name``. Where no stage is open both do nothing, at the
cost of one ``ContextVar.get``. Spans read only ``time.perf_counter``:
they never wait on the device, and emit no profiler range.

``sync`` is the timing barrier: ``torch.cuda.synchronize()`` when the
result holds a CUDA tensor, nothing on the CPU (PyTorch's CPU ops finish
before they return).
"""

from __future__ import annotations

import contextlib
import contextvars
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


# the timer of the innermost open stage, None outside every stage
_OPEN: contextvars.ContextVar = contextvars.ContextVar("open_timer",
                                                       default=None)
_NO_SPAN = contextlib.nullcontext()


class StageTimer:
    """Accumulating per-stage wall-clock timers and counters.

    ``totals[name]`` is a stage's seconds. ``counts[name]`` is how many
    times stage ``name`` was entered, or, for a counter (a noun, never a
    stage's name), the sum given to ``count(name, k)``. While a stage is
    open this timer is the open timer (``span``, ``count``); a nested
    stage of any timer restores the outer one on exit.

    >>> t = StageTimer()
    >>> with t.stage("match"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        token = _OPEN.set(self)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _OPEN.reset(token)
            if sync_result is not None:
                sync(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        return (1000.0 * self.totals.get(name, 0.0)
                / max(self.counts.get(name, 0), 1))

    def report(self) -> str:
        """One line a stage, then one line a counter."""
        lines = [
            f"{k}: {self.mean_ms(k):.2f} ms/call ×{self.counts[k]}"
            f" (total {self.totals[k]:.2f}s)"
            for k in sorted(self.totals)
        ]
        lines += [f"{k}: {self.counts[k]}" for k in sorted(self.counts)
                  if k not in self.totals]
        return "\n".join(lines)


def span(name: str):
    """A stage ``name`` of the open timer; a shared no-op context where no
    stage is open."""
    timer = _OPEN.get()
    return _NO_SPAN if timer is None else timer.stage(name)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the open timer's counter ``name``; nothing where no
    stage is open."""
    timer = _OPEN.get()
    if timer is not None:
        timer.counts[name] += k


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
