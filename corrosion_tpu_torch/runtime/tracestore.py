"""Tail-based trace capture: per-trace span buffering, the keep/drop
decision at trace close, and the kept-trace store behind GET /v1/traces.

The r11 trace plane exports EVERY sampled span the moment it finishes —
fine for a debug session pointed at a collector, wrong for production:
the spans worth money are the slow, broken and representative ones, and
head sampling cannot know which a trace will be.  This module adds the
tail discipline (the Prime CCL cost rule, arXiv:2505.14065 — near-zero
overhead on the healthy fast path):

- stage spans (attrs carry ``stage=``) buffer in a bounded per-trace
  ring (`add_span`, O(1) under one lock; the oldest TRACE is evicted
  whole when the buffer is full — never a partial trace);
- a trace is CLOSED when no span has arrived for `idle_close_secs`
  (cross-node traces have no in-band end marker; idleness is the local
  evidence — the Lifeguard discipline of judging the path with evidence
  from the path, arXiv:1707.00788).  Closing happens on the flusher
  THREAD (`sweep`), never on the event loop: exports and eviction are
  off the hot path by construction;
- the keep decision, in precedence order: any span errored; any span
  carried the origin's forced-keep bit (envelope trace meta — the head
  lottery decision every node honors without coordination); any stage
  span exceeded the SLO observatory's per-stage target
  (`runtime/latency.py` supplies the thresholds via config.slo.targets);
  a deterministic 1-in-`lottery_n` lottery on the trace id (the same
  verdict on every node, no wire bytes needed).  Everything else is
  dropped at close with O(1) cost;
- kept traces land in a bounded ring of summaries (slowest-N served by
  GET /v1/traces, exemplar ids for /v1/slo) and their spans are
  forwarded to the OTLP exporter (runtime/otel.py) if one is
  configured.  Traces captured while a chaos injection is active are
  marked with the scenario (the drill-vs-outage discriminator).

Thread contract: `add_span` is called from write-path worker threads
AND the event loop; `sweep` runs on the flusher thread; HTTP handlers
read summaries from the loop.  Every shared structure is mutated under
``self._lock`` and reads return copies.

The port's copy of `corrosion_tpu/runtime/tracestore.py`.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS


class _TraceBuf:
    """One in-flight trace's buffered spans + rollup flags."""

    __slots__ = ("spans", "last_mono", "error", "forced", "chaos",
                 "spans_dropped")

    def __init__(self, chaos: Optional[str]):
        self.spans: List[dict] = []
        self.last_mono = 0.0
        self.error = False
        self.forced = False
        self.chaos = chaos
        self.spans_dropped = 0


class TraceStore:
    def __init__(
        self,
        targets: Optional[Dict[str, float]] = None,
        lottery_n: int = 64,
        max_traces: int = 512,
        max_spans_per_trace: int = 64,
        keep_max: int = 256,
        idle_close_secs: float = 1.0,
        clock=time.monotonic,
    ):
        self.targets = dict(targets or {})
        self.lottery_n = int(lottery_n)
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.keep_max = int(keep_max)
        self.idle_close_secs = float(idle_close_secs)
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: "OrderedDict[str, _TraceBuf]" = OrderedDict()
        self._kept: List[dict] = []  # bounded summary ring, newest last
        self.kept_total = 0
        self.dropped_total = 0

    # -- head decision (hot path, origin side) ------------------------------

    def head_forced(self, trace_id: str) -> bool:
        """The origin's cached head decision: did this trace win the
        deterministic keep lottery?  Pure arithmetic on the id — the
        same verdict on every node, stamped into the envelope trace
        meta so even differently-configured peers keep the same
        traces."""
        return self._lottery(trace_id)

    def _lottery(self, trace_id: str) -> bool:
        if self.lottery_n <= 0:
            return False
        try:
            return int(trace_id[:8], 16) % self.lottery_n == 0
        except ValueError:
            return False

    # -- producer side (any thread) -----------------------------------------

    def add_span(self, rec: dict) -> None:
        """Buffer one finished stage span; O(1), one lock hold."""
        tid = rec["trace_id"]
        now = self._clock()
        with self._lock:
            buf = self._buf.get(tid)
            if buf is None:
                buf = _TraceBuf(chaos=_active_chaos())
                self._buf[tid] = buf
                if len(self._buf) > self.max_traces:
                    # evict the OLDEST in-flight trace whole: bounded
                    # memory beats a torn newest trace
                    self._buf.popitem(last=False)
                    METRICS.counter("corro.trace.evicted.total").inc()
            buf.last_mono = now
            if rec.get("error"):
                buf.error = True
            if rec.get("forced"):
                buf.forced = True
            if len(buf.spans) < self.max_spans_per_trace:
                buf.spans.append(rec)
            else:
                buf.spans_dropped += 1
            occupancy = len(self._buf)
        METRICS.gauge("corro.trace.buffer.traces").set(occupancy)

    # -- the tail decision (flusher thread) ----------------------------------

    def sweep(self, now: Optional[float] = None) -> int:
        """Close every trace idle past `idle_close_secs`, decide
        keep/drop, export kept spans.  Returns traces closed."""
        now = self._clock() if now is None else now
        with self._lock:
            closed = [
                (tid, self._buf.pop(tid))
                for tid in [
                    t for t, b in self._buf.items()
                    if now - b.last_mono >= self.idle_close_secs
                ]
            ]
            occupancy = len(self._buf)
        METRICS.gauge("corro.trace.buffer.traces").set(occupancy)
        for tid, buf in closed:
            keep, reason = self._decide(tid, buf)
            if not keep:
                with self._lock:
                    self.dropped_total += 1
                METRICS.counter("corro.trace.dropped.total").inc()
                continue
            summary = self._summarize(tid, buf, reason)
            with self._lock:
                self._kept.append(summary)
                if len(self._kept) > self.keep_max:
                    del self._kept[0]
                self.kept_total += 1
            METRICS.counter("corro.trace.kept.total", reason=reason).inc()
            self._export(buf)
        return len(closed)

    def _decide(self, tid: str, buf: _TraceBuf):
        if buf.error:
            return True, "error"
        if buf.forced:
            return True, "forced"
        for rec in buf.spans:
            target = self.targets.get(rec["attrs"].get("stage"))
            if target is not None and _dur_s(rec) > target:
                return True, f"slo:{rec['attrs']['stage']}"
        if self._lottery(tid):
            return True, "lottery"
        return False, "dropped"

    def _summarize(self, tid: str, buf: _TraceBuf, reason: str) -> dict:
        spans = buf.spans
        start = min(r["start_ns"] for r in spans)
        end = max(r["end_ns"] for r in spans)
        stages: Dict[str, dict] = {}
        actors = set()
        tables = set()
        hops = 0
        rows = []
        for r in sorted(spans, key=lambda r: r["start_ns"]):
            a = r["attrs"]
            stage = a.get("stage", "?")
            d = _dur_s(r)
            st = stages.setdefault(
                stage, {"count": 0, "seconds": 0.0, "max_secs": 0.0}
            )
            st["count"] += 1
            st["seconds"] = round(st["seconds"] + d, 6)
            st["max_secs"] = round(max(st["max_secs"], d), 6)
            if "actor" in a:
                actors.add(a["actor"])
            if "table" in a:
                tables.add(a["table"])
            hops = max(hops, int(a.get("hop", 0) or 0))
            rows.append(
                {
                    "name": r["name"],
                    "stage": stage,
                    "actor": a.get("actor"),
                    "start_offset_secs": round((r["start_ns"] - start) / 1e9, 6),
                    "duration_secs": round(d, 6),
                    "error": bool(r.get("error")),
                    "hop": int(a.get("hop", 0) or 0),
                }
            )
        return {
            "trace_id": tid,
            "reason": reason,
            "start_wall": round(start / 1e9, 6),
            "duration_secs": round((end - start) / 1e9, 6),
            "n_spans": len(spans),
            "spans_dropped": buf.spans_dropped,
            "actors": sorted(actors),
            "tables": sorted(tables),
            "hops": hops,
            "chaos": buf.chaos,
            "stages": stages,
            "spans": rows,
        }

    def _export(self, buf: _TraceBuf) -> None:
        from corrosion_tpu_torch.runtime import otel

        if otel.exporter() is None:
            return
        for r in buf.spans:
            otel.record_span(
                r["name"], r["trace_id"], r["span_id"],
                r.get("parent_span_id"), r["start_ns"], r["end_ns"],
                r["attrs"], error=bool(r.get("error")),
            )
        METRICS.counter("corro.trace.exported.total").inc(len(buf.spans))

    # -- query side (loop thread; copies only) --------------------------------

    def kept(
        self,
        n: int = 20,
        stage: Optional[str] = None,
        actor: Optional[str] = None,
        table: Optional[str] = None,
    ) -> List[dict]:
        """Slowest-N kept traces, optionally filtered."""
        with self._lock:
            items = list(self._kept)
        if stage:
            items = [t for t in items if stage in t["stages"]]
        if actor:
            items = [t for t in items if actor in t["actors"]]
        if table:
            items = [t for t in items if table in t["tables"]]
        items.sort(key=lambda t: t["duration_secs"], reverse=True)
        return items[: max(1, n)]

    def slowest_ids(self, stage: str, n: int = 3) -> List[str]:
        """Exemplar trace ids for one stage, slowest-first by that
        stage's worst span (/v1/slo attaches these to stage rows)."""
        with self._lock:
            items = [t for t in self._kept if stage in t["stages"]]
        items.sort(key=lambda t: t["stages"][stage]["max_secs"], reverse=True)
        return [t["trace_id"] for t in items[: max(1, n)]]

    def census(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "buffered": len(self._buf),
                "kept_ring": len(self._kept),
                "kept_total": self.kept_total,
                "dropped_total": self.dropped_total,
                "lottery_n": self.lottery_n,
                "idle_close_secs": self.idle_close_secs,
            }


def _dur_s(rec: dict) -> float:
    return max(0, rec["end_ns"] - rec["start_ns"]) / 1e9


def _active_chaos() -> Optional[str]:
    """Scenario name when a chaos injection is live at capture time —
    the /v1/traces analog of /v1/status's chaos block."""
    try:
        from corrosion_tpu_torch.chaos.faults import CENSUS

        snap = CENSUS.snapshot()
        if snap["active"]:
            return snap["scenario"] or "injection"
    except Exception:  # noqa: BLE001 — census must never fail capture
        pass
    return None


# -- process-global installation (mirrors runtime/otel.py) ------------------

_STORE: Optional[TraceStore] = None
_FLUSHER: Optional["_Flusher"] = None


class _Flusher:
    """Daemon thread sweeping the store — trace close, keep decisions
    and OTLP forwarding all run here, never on the event loop."""

    def __init__(self, store: TraceStore):
        self.store = store
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="trace-sweep", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        period = max(0.05, self.store.idle_close_secs / 2.0)
        while not self._stop.wait(period):
            self.store.sweep()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def configure(
    targets: Optional[Dict[str, float]] = None,
    auto_sweep: bool = True,
    **kw,
) -> Optional[TraceStore]:
    """Install (or, with targets=None and no kwargs, uninstall) the
    global tail sampler.  Agent setup passes config.slo.targets +
    [trace] knobs; tests drive `sweep()` by hand with
    auto_sweep=False."""
    global _STORE, _FLUSHER
    if _FLUSHER is not None:
        _FLUSHER.stop()
        _FLUSHER = None
    if targets is None and not kw:
        _STORE = None
        return None
    _STORE = TraceStore(targets=targets, **kw)
    if auto_sweep:
        _FLUSHER = _Flusher(_STORE)
    return _STORE


def ensure(targets: Optional[Dict[str, float]] = None, **kw) -> TraceStore:
    """Install the global store if absent (idempotent agent-setup hook:
    the FIRST agent's config wins in multi-agent processes — tests that
    need different knobs call configure() explicitly)."""
    global _STORE
    if _STORE is None:
        return configure(targets=targets or {}, **kw)
    return _STORE


def store() -> Optional[TraceStore]:
    return _STORE
