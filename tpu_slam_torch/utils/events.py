"""Mapper event/listener system — the port's own copy of
``tpu_slam/utils/events.py``.

Equivalent of karto's `MapperListener` / `MapperLoopClosureListener`
hierarchy and the Fire* dispatch (`Mapper.h:35-83`, `Mapper.cpp:2160-2218`):
observability hooks surfacing loop-closure decisions and general progress
without coupling the pipeline to any logger.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

log = logging.getLogger("tpu_slam_torch")


@dataclasses.dataclass
class Event:
    kind: str  # info | debug | loop_closure_check | begin_loop_closure | end_loop_closure
    message: str
    stamp: float = dataclasses.field(default_factory=time.time)


class EventBus:
    """FireInfo/FireDebug/FireLoopClosureCheck/FireBeginLoopClosure/
    FireEndLoopClosure dispatch."""

    def __init__(self):
        self._listeners: list[Callable[[Event], None]] = []
        self.history: list[Event] = []

    def add_listener(self, fn: Callable[[Event], None]) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Event], None]) -> None:
        self._listeners.remove(fn)

    def _fire(self, kind: str, message: str) -> None:
        ev = Event(kind, message)
        self.history.append(ev)
        for fn in self._listeners:
            fn(ev)

    def info(self, message: str) -> None:
        self._fire("info", message)

    def debug(self, message: str) -> None:
        self._fire("debug", message)

    def loop_closure_check(self, message: str) -> None:
        self._fire("loop_closure_check", message)

    def begin_loop_closure(self, message: str) -> None:
        self._fire("begin_loop_closure", message)

    def end_loop_closure(self, message: str) -> None:
        self._fire("end_loop_closure", message)


def logging_listener(ev: Event) -> None:
    """A default listener mirroring the reference's console output."""
    log.info("[%s] %s", ev.kind, ev.message)
