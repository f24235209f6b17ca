"""What the harness takes from the program (``tpu_slam_torch``): its
configuration type, its stage timer as a span recorder, and its launch
counters. Imported only when a run starts, never by the reference."""

from __future__ import annotations

import contextlib
import time


def config(d: dict):
    """The program's ``SLAMConfig`` from a configuration file's ``config``
    dict (``config_from_dict``: every key given replaces the default), its
    JSON lists made tuples, as the frozen, hashable configs hold them."""
    from tpu_slam_torch.config import config_from_dict

    def tuples(x):
        if isinstance(x, dict):
            return {k: tuples(v) for k, v in x.items()}
        return tuple(x) if isinstance(x, list) else x

    return config_from_dict(tuples(d))


def span_timer():
    """The program's ``StageTimer`` that also keeps each stage's interval
    on the host clock (``time.perf_counter``) in ``spans``."""
    from tpu_slam_torch.utils.profiling import StageTimer

    class SpanTimer(StageTimer):
        def __init__(self):
            super().__init__()
            self.spans: list[tuple[str, float, float]] = []

        @contextlib.contextmanager
        def stage(self, name: str, sync_result=None):
            t0 = time.perf_counter()
            try:
                with super().stage(name, sync_result):
                    yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))

        def reset(self):
            self.totals.clear()
            self.counts.clear()
            self.spans.clear()

    return SpanTimer()


def launches() -> dict:
    from tpu_slam_torch import _dispatch

    return dict(_dispatch.LAUNCHES)


def reset_launches() -> None:
    from tpu_slam_torch import _dispatch

    _dispatch.reset_launches()
