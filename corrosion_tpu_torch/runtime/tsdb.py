"""Local metrics TSDB: a bounded ring-buffer time-series store over the
process `Registry` (r20 — the alerting plane's substrate).

Every observability plane so far serves the registry's CURRENT state
(/v1/status, /metrics, the digests); nothing remembers how a series
MOVED, so a rule like "store faults > 0.5/s for 4 s" had nothing to
evaluate against.  This module samples the registry every few seconds
and keeps, per series, a bounded ring of points:

  counters    -> windowed per-second RATES (delta of the cumulative
                 value between consecutive samples / elapsed; clamped
                 at 0 across resets), field ``<name>:rate``
  gauges      -> levels, field ``<name>`` (this is how loopmon lag and
                 the write-gate depth gauges enter the TSDB — they are
                 already gauges)
  histograms  -> count rates, field ``<name>:rate``
  latencies   -> windowed p50/p99 (``<name>:p50`` / ``<name>:p99``)
                 plus the count rate ``<name>:rate``

The sampler runs on a DAEMON THREAD (`_Sampler`, the tracestore
flusher pattern), never the event loop: one `Registry.snapshot()` +
quantile pass per tick, O(series).  Memory is capped twice — per
series by the ring depth (`slots`) and globally by `max_series`
(excess series are dropped TYPED: `corro.tsdb.series.dropped.total`)
— and accounted (`corro.tsdb.series` / `corro.tsdb.points` /
`corro.tsdb.bytes.est`).

Thread contract (the r7 lock-discipline rule): `sample_once` mutates
the store from the sampler thread while the alert engine and HTTP
handlers read from worker threads and the event loop — every shared
structure is touched under ``self._lock`` and reads return copies.
The registry locks are never held together with the TSDB lock (the
snapshot is taken first, appended second).

The port's copy of `corrosion_tpu/runtime/tsdb.py`, sampling the port's
`METRICS` registry.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.runtime.metrics import METRICS, Registry

LabelKey = Tuple[Tuple[str, str], ...]

# rough per-point cost for the bytes estimate: a (wall, value) float
# pair in a deque plus container overhead
_POINT_BYTES = 48
_SERIES_BYTES = 160

# window the latency quantile fields are computed over at sample time
# (the /v1/slo default: "p99 right now" means the last minute)
QUANTILE_WINDOW_SECS = 60.0


class _Series:
    __slots__ = ("points",)

    def __init__(self, slots: int):
        self.points: deque = deque(maxlen=slots)  # (wall, value)


class MetricsTSDB:
    def __init__(
        self,
        registry: Registry = METRICS,
        sample_interval_secs: float = 2.0,
        slots: int = 240,
        max_series: int = 4096,
        clock=time.monotonic,
        wall=time.time,
    ):
        self.registry = registry
        self.sample_interval_secs = float(sample_interval_secs)
        self.slots = int(slots)
        self.max_series = int(max_series)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, LabelKey], _Series] = {}
        # counter-rate state: (field, labels) -> (mono, cumulative)
        self._prev: Dict[Tuple[str, LabelKey], Tuple[float, float]] = {}
        self.samples_total = 0

    # -- sampling (sampler thread) ------------------------------------------

    def sample_once(self) -> int:
        """One full registry pass; returns points appended.  Runs on
        the sampler thread (or a test driver) — never the event loop."""
        t0 = self._clock()
        wall = self._wall()
        rows: List[Tuple[str, LabelKey, float, bool]] = []
        # (field, labels, value, is_cumulative)
        for kind, name, labels, value in self.registry.snapshot():
            lk = tuple(sorted(labels.items()))
            if kind == "gauge":
                rows.append((name, lk, value, False))
            elif kind == "counter":
                rows.append((f"{name}:rate", lk, value, True))
            elif kind in ("histogram", "latency") and name.endswith("_count"):
                base = name[: -len("_count")]
                rows.append((f"{base}:rate", lk, value, True))
        for name, labels, inst in self.registry.latency_items():
            qs = inst.quantiles(window_secs=QUANTILE_WINDOW_SECS)
            lk = tuple(sorted(labels.items()))
            for q in ("p50", "p99"):
                if qs.get(q) is not None:
                    rows.append((f"{name}:{q}", lk, qs[q], False))

        added = dropped = 0
        with self._lock:
            for field, lk, value, cumulative in rows:
                key = (field, lk)
                if cumulative:
                    prev = self._prev.get(key)
                    self._prev[key] = (t0, value)
                    if prev is None:
                        continue  # first sight: no interval yet
                    dt = t0 - prev[0]
                    if dt <= 0:
                        continue
                    value = max(0.0, value - prev[1]) / dt
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series:
                        dropped += 1
                        continue
                    s = self._series[key] = _Series(self.slots)
                s.points.append((wall, value))
                added += 1
            self.samples_total += 1
            n_series = len(self._series)
            n_points = sum(len(s.points) for s in self._series.values())
        reg = self.registry
        reg.counter("corro.tsdb.samples.total").inc()
        if dropped:
            reg.counter("corro.tsdb.series.dropped.total").inc(dropped)
        reg.gauge("corro.tsdb.series").set(n_series)
        reg.gauge("corro.tsdb.points").set(n_points)
        reg.gauge("corro.tsdb.bytes.est").set(
            n_series * _SERIES_BYTES + n_points * _POINT_BYTES
        )
        reg.histogram("corro.tsdb.sample.seconds").observe(
            self._clock() - t0
        )
        return added

    # -- queries (any thread; copies under the lock) ------------------------

    def _matching(
        self, field: str, labels: Optional[Dict[str, str]]
    ) -> List[Tuple[LabelKey, List[Tuple[float, float]]]]:
        want = set((labels or {}).items())
        with self._lock:
            return [
                (lk, list(s.points))
                for (f, lk), s in self._series.items()
                if f == field and want <= set(lk)
            ]

    def window(
        self,
        field: str,
        labels: Optional[Dict[str, str]] = None,
        window_secs: float = 60.0,
    ) -> List[Tuple[float, float]]:
        """Raw (wall, value) points of every matching label set within
        the window, oldest first."""
        lo = self._wall() - window_secs
        out: List[Tuple[float, float]] = []
        for _lk, pts in self._matching(field, labels):
            out.extend(p for p in pts if p[0] >= lo)
        out.sort(key=lambda p: p[0])
        return out

    def aggregate(
        self,
        field: str,
        labels: Optional[Dict[str, str]] = None,
        window_secs: float = 60.0,
        across: str = "sum",
        over: str = "last",
    ) -> Optional[float]:
        """One scalar: per-tick aggregation ACROSS matching label sets
        (sum/max/avg — points from one `sample_once` pass share a wall
        stamp), then OVER the window's ticks (last/avg/max/min).
        None when no point is inside the window."""
        lo = self._wall() - window_secs
        by_tick: Dict[float, List[float]] = {}
        for _lk, pts in self._matching(field, labels):
            for w, v in pts:
                if w >= lo:
                    by_tick.setdefault(w, []).append(v)
        if not by_tick:
            return None
        fns = {"sum": sum, "max": max, "min": min,
               "avg": lambda vs: sum(vs) / len(vs)}
        fa = fns[across]
        ticks = sorted(by_tick)
        vals = [fa(by_tick[w]) for w in ticks]
        if over == "last":
            return vals[-1]
        return fns[over](vals)

    def absent(
        self,
        field: str,
        labels: Optional[Dict[str, str]] = None,
        window_secs: float = 60.0,
    ) -> bool:
        """True when the series was seen before but produced NO point
        inside the window — a vanished series, not a never-born one
        (an absent-rule must not fire on a plane that never started)."""
        matching = self._matching(field, labels)
        if not matching:
            return False
        lo = self._wall() - window_secs
        return not any(
            p[0] >= lo for _lk, pts in matching for p in pts
        )

    def fields(self) -> List[str]:
        with self._lock:
            return sorted({f for f, _lk in self._series})

    def census(self) -> dict:
        with self._lock:
            n_series = len(self._series)
            n_points = sum(len(s.points) for s in self._series.values())
            samples = self.samples_total
        return {
            "enabled": True,
            "series": n_series,
            "points": n_points,
            "samples": samples,
            "sample_interval_secs": self.sample_interval_secs,
            "slots": self.slots,
            "max_series": self.max_series,
        }


# -- process-global installation (mirrors runtime/tracestore.py) ------------

_TSDB: Optional[MetricsTSDB] = None
_SAMPLER: Optional["_Sampler"] = None


class _Sampler:
    """Daemon thread driving `sample_once` — the whole sampling plane
    runs off the event loop by construction."""

    def __init__(self, db: MetricsTSDB):
        self.db = db
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="tsdb-sample", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        period = max(0.05, self.db.sample_interval_secs)
        while not self._stop.wait(period):
            self.db.sample_once()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def configure(auto_sample: bool = True, **kw) -> Optional[MetricsTSDB]:
    """Install (or, with no kwargs, uninstall) the global TSDB.  Agent
    setup passes the [tsdb] knobs; tests drive `sample_once` by hand
    with auto_sample=False."""
    global _TSDB, _SAMPLER
    if _SAMPLER is not None:
        _SAMPLER.stop()
        _SAMPLER = None
    if not kw:
        _TSDB = None
        return None
    _TSDB = MetricsTSDB(**kw)
    if auto_sample:
        _SAMPLER = _Sampler(_TSDB)
    return _TSDB


def ensure(**kw) -> MetricsTSDB:
    """Install the global TSDB if absent (idempotent agent-setup hook —
    the FIRST agent's config wins in multi-agent processes, the
    tracestore rule)."""
    global _TSDB
    if _TSDB is None:
        return configure(**kw)
    return _TSDB


def get() -> Optional[MetricsTSDB]:
    return _TSDB
