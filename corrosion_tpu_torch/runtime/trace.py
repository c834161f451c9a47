"""Timed spans: the port's counterpart of `corrosion_tpu/runtime/trace.py`.

`span(name, **attrs)` is a context manager that times its block on the
host clock and keeps the finished span (name, attributes as strings, wall
clock at the start, seconds) in the process-global bounded `SPANS` log,
newest last. The simulation drivers wrap each telemetry publish in one,
as the reference does, so a span's wall clock lines up with the flight
frames it drained.

`timed_query(sql, shape=)` times a store statement and logs it, with
the `corro_slow_queries_total` counter, when it takes a second or more.

Not ported here: W3C context propagation, OTLP export (`runtime/otel.py`)
and the statement profiler's tap in `timed_query` (`runtime/profiler.py`).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

log = logging.getLogger(__name__)


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


# -- slow-query logging ----------------------------------------------------

SLOW_QUERY_S = 1.0


class timed_query:
    """Logs any wrapped block slower than 1 s with its SQL (the reference's
    sqlite trace_v2 slow-query hook). `shape` names the statement's class
    ("apply:batch", a capture-shape key); the reference's statement
    profiler reads it, which the port does not have yet."""

    def __init__(self, sql: str, shape: Optional[str] = None):
        self.sql = sql
        self.shape = shape
        self._start = 0.0

    def __enter__(self) -> "timed_query":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        elapsed = time.monotonic() - self._start
        if elapsed >= SLOW_QUERY_S:
            METRICS.counter("corro_slow_queries_total").inc()
            log.warning("slow query (%.3fs): %s", elapsed, self.sql[:500])
