"""Timed spans: the port's counterpart of `corrosion_tpu/runtime/trace.py`.

`span(name, **attrs)` is a context manager that times its block on the
host clock and keeps the finished span (name, attributes as strings, wall
clock at the start, seconds) in the process-global bounded `SPANS` log,
newest last. The simulation drivers wrap each telemetry publish in one,
as the reference does, so a span's wall clock lines up with the flight
frames it drained.

Not ported here: W3C context propagation, OTLP export (`runtime/otel.py`)
and the profiler hook.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple


class FinishedSpan(NamedTuple):
    name: str
    attrs: Dict[str, str]
    wall: float  # time.time() at the start
    seconds: float
    error: bool


class SpanLog:
    """Bounded, thread-safe log of finished spans."""

    def __init__(self, capacity: int = 1024):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, span: FinishedSpan) -> None:
        with self._lock:
            self._spans.append(span)

    def recent(self, k: int) -> List[FinishedSpan]:
        """The last `k` finished spans, oldest first."""
        with self._lock:
            spans = list(self._spans)
        return spans[-max(0, int(k)):]


SPANS = SpanLog()


class Span:
    """Context manager: times its block and logs it to `SPANS`."""

    def __init__(self, name: str, attrs: Dict[str, str]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self._wall = time.time()
        self._start = time.monotonic()
        return self

    def __exit__(self, et, e, tb) -> None:
        SPANS.add(FinishedSpan(self.name, self.attrs, self._wall,
                               time.monotonic() - self._start,
                               et is not None))


def span(name: str, **attrs) -> Span:
    return Span(name, {k: str(v) for k, v in attrs.items()})
