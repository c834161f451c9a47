"""Timed spans with W3C context propagation: the port's counterpart of
`corrosion_tpu/runtime/trace.py`.

`span(name, **attrs)` is a context manager that opens a child span of
the ambient context (a contextvar) or a fresh trace, times its block on
the host clock and keeps the finished span (name, attributes as strings,
wall clock at the start, seconds, error, trace and span ids) in the
process-global bounded `SPANS` log, newest last; it also observes
`corro_span_seconds{span=}`. The simulation drivers wrap each telemetry
publish in one, as the reference does, so a span's wall clock lines up
with the flight frames it drained.

The W3C half is the reference's, byte for byte: `SpanContext` and
`parse_traceparent` (the `traceparent` header that rides the broadcast
envelopes and the SyncStart payload), `continue_from` (a server adopts
the peer's trace id), `current_traceparent` (the ambient context's
header, which a snapshot request carries), `stage_span` (one finished
stage span as a child of a wire context), and the one-byte trace meta
of envelope ext v3 (`make_meta`, `meta_hop`, `meta_forced`,
`bump_hop`).

Every finished span is also routed as the JAX module routes it: a
stage span (its attributes carry `stage=`) buffers in the tail-sampling
trace store (`runtime/tracestore.py`) when one is installed, and is
exported only if its trace is kept; any other span goes to the OTLP
exporter (`runtime/otel.py`) when one is configured.

`timed_query(sql, shape=)` times a store statement and logs it, with
the `corro_slow_queries_total` counter, when it takes a second or more;
with a `shape` it is the statement profiler's tap
(`runtime/profiler.py::record_stmt`, a no-op until a profiler is
installed).
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

from corrosion_tpu_torch.runtime import otel
from corrosion_tpu_torch.runtime import profiler as _profiler
from corrosion_tpu_torch.runtime.metrics import METRICS

log = logging.getLogger(__name__)

_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    sampled: bool = True

    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"


def parse_traceparent(tp: Optional[str]) -> Optional[SpanContext]:
    if not tp:
        return None
    m = _TRACEPARENT.match(tp.strip())
    if m is None:
        return None
    _ver, trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=flags != "00")


_current: contextvars.ContextVar[Optional[SpanContext]] = contextvars.ContextVar(
    "corro_trace", default=None
)


def _rand_hex(n: int) -> str:
    return os.urandom(n // 2).hex()


# -- tail-sampling trace meta (the envelope ext v3 byte) --------------------
#
# One byte rides the broadcast/sync envelopes next to the traceparent
# (`types/codec.py` _ENVELOPE_EXT_V3): bit 0 carries the origin's head
# decision, bits 2..7 the relay hop count (capped at 63). Bit 1 is
# reserved.

TRACE_META_FORCED = 0x01
_META_HOP_SHIFT = 2
_META_HOP_MAX = 63


def meta_forced(meta: Optional[int]) -> bool:
    return bool(meta) and bool(meta & TRACE_META_FORCED)


def meta_hop(meta: Optional[int]) -> int:
    return ((meta or 0) >> _META_HOP_SHIFT) & _META_HOP_MAX


def make_meta(forced: bool = False, hop: int = 0) -> int:
    return (TRACE_META_FORCED if forced else 0) | (
        min(_META_HOP_MAX, max(0, hop)) << _META_HOP_SHIFT
    )


def current_traceparent() -> Optional[str]:
    ctx = _current.get()
    return ctx.traceparent() if ctx is not None else None


def bump_hop(meta: Optional[int]) -> Optional[int]:
    """Relay path: same flags, hop + 1 (saturating)."""
    if meta is None:
        return None
    return (meta & ((1 << _META_HOP_SHIFT) - 1)) | (
        min(_META_HOP_MAX, meta_hop(meta) + 1) << _META_HOP_SHIFT
    )


class FinishedSpan(NamedTuple):
    name: str
    attrs: Dict[str, str]
    wall: float  # time.time() at the start
    seconds: float
    error: bool
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: Optional[str] = None


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
    """Context manager: opens a child span of the ambient context (or a
    fresh trace), times it, histograms it and logs it to `SPANS`."""

    def __init__(
        self,
        name: str,
        parent: Optional[SpanContext] = None,
        attrs: Optional[Dict[str, str]] = None,
    ):
        self.name = name
        self.attrs = attrs or {}
        ambient = parent if parent is not None else _current.get()
        self.ctx = SpanContext(
            trace_id=ambient.trace_id if ambient else _rand_hex(32),
            span_id=_rand_hex(16),
            sampled=ambient.sampled if ambient else True,
        )
        self.parent = ambient
        self._token: Optional[contextvars.Token] = None
        self._start = 0.0

    def __enter__(self) -> "Span":
        self._token = _current.set(self.ctx)
        self._start = time.monotonic()
        self._start_ns = time.time_ns()
        self._wall = self._start_ns / 1e9
        return self

    def __exit__(self, et, e, tb) -> None:
        elapsed = time.monotonic() - self._start
        if self._token is not None:
            _current.reset(self._token)
        METRICS.histogram("corro_span_seconds", span=self.name).observe(elapsed)
        if self.ctx.sampled:
            parent_id = self.parent.span_id if self.parent is not None else None
            SPANS.add(FinishedSpan(
                self.name, self.attrs, self._wall, elapsed, et is not None,
                self.ctx.trace_id, self.ctx.span_id, parent_id))
            _finish_span(self.name, self.ctx, parent_id, self._start_ns,
                         self._start_ns + int(elapsed * 1e9), self.attrs,
                         error=et is not None)


def _finish_span(name: str, ctx: SpanContext, parent_span_id: Optional[str],
                 start_ns: int, end_ns: int, attrs: Dict[str, str],
                 error: bool = False, forced: bool = False) -> None:
    """Route one finished span: a stage span buffers in the trace store's
    per-trace ring when one is installed (exported only if its trace is
    kept); any other span goes straight to the OTLP exporter when one is
    configured. Unconfigured, this is two global None-checks."""
    if attrs.get("stage") is not None:
        from corrosion_tpu_torch.runtime import tracestore

        store = tracestore.store()
        if store is not None:
            store.add_span({
                "name": name,
                "trace_id": ctx.trace_id,
                "span_id": ctx.span_id,
                "parent_span_id": parent_span_id,
                "start_ns": start_ns,
                "end_ns": end_ns,
                "attrs": attrs,
                "error": error,
                "forced": forced,
            })
            return
    if otel.exporter() is not None:
        otel.record_span(name, ctx.trace_id, ctx.span_id, parent_span_id,
                         start_ns, end_ns, attrs, error=error)


def span(name: str, **attrs) -> Span:
    return Span(name, attrs={k: str(v) for k, v in attrs.items()})


def stage_span(
    traceparent: Optional[str],
    name: str,
    stage: str,
    duration_s: float,
    error: bool = False,
    forced: bool = False,
    **attrs,
) -> Optional[SpanContext]:
    """Synthesize one finished stage span as a child of the wire context,
    covering the last `duration_s` seconds (hop stamps measure
    origin-to-here wall deltas, which a contextvar-scoped Span cannot
    represent). None when `traceparent` does not parse."""
    parent = parse_traceparent(traceparent)
    if parent is None:
        return None
    ctx = SpanContext(
        trace_id=parent.trace_id,
        span_id=_rand_hex(16),
        sampled=parent.sampled,
    )
    if not ctx.sampled:
        return ctx
    duration_s = max(0.0, duration_s)
    end_ns = time.time_ns()
    start_ns = end_ns - int(duration_s * 1e9)
    a = {"stage": stage}
    a.update({k: str(v) for k, v in attrs.items()})
    METRICS.histogram("corro_span_seconds", span=name).observe(duration_s)
    SPANS.add(FinishedSpan(name, a, start_ns / 1e9, duration_s,
                           error, ctx.trace_id, ctx.span_id,
                           parent.span_id))
    _finish_span(name, ctx, parent.span_id, start_ns, end_ns, a,
                 error=error, forced=forced)
    return ctx


def continue_from(traceparent: Optional[str], name: str, **attrs: str) -> Span:
    """Server side: adopt the peer's trace id from the wire."""
    return Span(
        name, parent=parse_traceparent(traceparent),
        attrs={k: str(v) for k, v in attrs.items()},
    )


# -- slow-query logging ----------------------------------------------------

SLOW_QUERY_S = 1.0


class timed_query:
    """Logs any wrapped block slower than 1 s with its SQL (the reference's
    sqlite trace_v2 slow-query hook). `shape` names the statement's class
    ("apply:batch", a capture-shape key): with a profiler installed every
    exit feeds `corro.store.stmt.seconds{shape=}` and the /v1/profile
    statement table."""

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
        if self.shape is not None:
            _profiler.record_stmt(self.shape, elapsed)
