"""Windowed percentile latency plane: log-bucketed histograms, the
write→event hop stamps, and the SLO monitor — the port's copy of
`corrosion_tpu/runtime/latency.py`.

- `LatencyHistogram`: HDR-style log-bucketed counts (~5 % value
  resolution, 1 µs…1 h span), mergeable (aligned bucket arrays add),
  with the sparse form the telemetry digests carry (`to_sparse`,
  `from_sparse`).
- `WindowedLatency`: a ring of slot sub-histograms and a cumulative
  one: percentiles over the last N seconds and since boot, from one
  `observe()` per sample; registered in the metrics `Registry`
  (`Registry.latency`), whose windowed `quantiles` the TSDB samples.
- Hop stamps: `e2e_observe` feeds the `corro.e2e.<stage>.seconds`
  histograms of the write→event path (broadcast, apply, match, deliver,
  total). Cross-node deltas are wall-clock differences between two
  machines: negative values (clock skew) are clamped to 0 and counted in
  `corro.e2e.skew.clamped.total{stage=}`.
- `SloMonitor`: per-stage SLO targets and error-budget burn; a breach
  sustained for `breach_checks` consecutive checks trips a
  `FlightRecorder` incident dump (each check also appends a
  `kernel="slo"` host frame with the per-stage p99s).

Import rule: this module must not import `runtime.metrics` at module
level (metrics imports the histogram classes from here); helpers that
need the process registry resolve it lazily.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ~5 % resolution: bucket i covers (BASE*RATIO**i, BASE*RATIO**(i+1)].
# 1 µs … >1 h in 456 buckets; everything below BASE lands in bucket 0,
# everything above the span in the last bucket.
BASE = 1e-6
RATIO = 1.05
_LOG_RATIO = math.log(RATIO)
N_BUCKETS = 456  # BASE * RATIO**456 ≈ 4.6e3 s

# the five write→event stages, in path order (each attributable to one
# hop, so a p99 regression names its culprit):
#   broadcast  origin commit → payload handed to the gossip transport
#   apply      origin commit → remote apply committed (network + ingest
#              queue + write tx; labeled by change source)
#   match      apply commit → live-query diff produced the event
#              (includes the matcher's candidate batching window)
#   deliver    event produced → bytes written to the HTTP stream
#   total      origin commit → delivered (only when the origin stamp
#              traveled the whole way)
E2E_STAGES = ("broadcast", "apply", "match", "deliver", "total")

QUANTILES = (0.5, 0.9, 0.99, 0.999)

# default sliding window served by /v1/slo and the quantile gauges
DEFAULT_WINDOW_SECS = 60.0


def bucket_index(v: float) -> int:
    if v <= BASE:
        return 0
    return min(N_BUCKETS - 1, int(math.log(v / BASE) / _LOG_RATIO))


def bucket_upper(i: int) -> float:
    """Inclusive upper edge of bucket i — what quantiles report (within
    one RATIO of the true sample value)."""
    return BASE * RATIO ** (i + 1)


class LatencyHistogram:
    """Log-bucketed counts; NOT thread-safe on its own (WindowedLatency
    owns the lock; standalone users in scripts are single-threaded)."""

    __slots__ = ("counts", "count", "total")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        i = bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.total += v

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.count += other.count
        self.total += other.total
        return self

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram()
        out.counts = dict(self.counts)
        out.count = self.count
        out.total = self.total
        return out

    def diff(self, earlier: "LatencyHistogram") -> "LatencyHistogram":
        """self − earlier (a later snapshot minus a prior one of the SAME
        instrument): exact per-interval isolation without window-slot
        blur — what the scenario banker uses."""
        out = LatencyHistogram()
        for i, c in self.counts.items():
            d = c - earlier.counts.get(i, 0)
            if d > 0:
                out.counts[i] = d
        out.count = sum(out.counts.values())
        out.total = max(0.0, self.total - earlier.total)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile q (0..1], reported as the containing
        bucket's upper edge (≤ ~5 % above the true sample)."""
        if self.count <= 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                return bucket_upper(i)
        return bucket_upper(max(self.counts))  # pragma: no cover

    def count_le(self, threshold: float) -> int:
        """Samples ≤ threshold, at bucket resolution (a bucket straddling
        the threshold counts as within — the SLO check errs forgiving by
        at most one 5 % bucket)."""
        ti = bucket_index(threshold)
        return sum(c for i, c in self.counts.items() if i <= ti)

    def nonzero_buckets(self) -> List[Tuple[int, int]]:
        return sorted(self.counts.items())

    def to_sparse(self) -> Tuple[List[Tuple[int, int]], float]:
        """(sorted (bucket, count) pairs, total) — the exact state a
        digest wire codec needs (`runtime/digest.py`): `from_sparse`
        reconstructs an identical histogram, so merge-of-decoded ≡
        decode-of-merged holds bucket-for-bucket."""
        return self.nonzero_buckets(), self.total

    @classmethod
    def from_sparse(
        cls, pairs: Sequence[Tuple[int, int]], total: float
    ) -> "LatencyHistogram":
        out = cls()
        for i, c in pairs:
            if c > 0:
                out.counts[int(i)] = out.counts.get(int(i), 0) + int(c)
        out.count = sum(out.counts.values())
        out.total = float(total)
        return out


class WindowedLatency:
    """A cumulative LatencyHistogram + a ring of time-slot
    sub-histograms giving percentiles over the last N seconds.

    Thread model: observed from write-path worker threads while the API
    event loop reads quantiles — one instance lock, same rule as the
    metrics instruments (runtime/metrics.py)."""

    __slots__ = ("cumulative", "slot_secs", "_slots", "_epochs", "_clock",
                 "_lock")

    def __init__(
        self,
        slot_secs: float = 5.0,
        slots: int = 36,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cumulative = LatencyHistogram()
        self.slot_secs = float(slot_secs)
        self._slots = [LatencyHistogram() for _ in range(slots)]
        self._epochs = [-1] * slots
        self._clock = clock
        self._lock = threading.Lock()

    @property
    def coverage_secs(self) -> float:
        return self.slot_secs * len(self._slots)

    def observe(self, v: float) -> None:
        with self._lock:
            self.cumulative.observe(v)
            e = int(self._clock() // self.slot_secs)
            j = e % len(self._slots)
            if self._epochs[j] != e:
                self._slots[j] = LatencyHistogram()
                self._epochs[j] = e
            self._slots[j].observe(v)

    def window_hist(
        self, window_secs: float = DEFAULT_WINDOW_SECS
    ) -> LatencyHistogram:
        """Merged histogram of the slots inside the last `window_secs`
        (capped at ring coverage; expired slots never contribute)."""
        now = self._clock()
        lo = now - min(window_secs, self.coverage_secs)
        out = LatencyHistogram()
        with self._lock:
            for j, e in enumerate(self._epochs):
                if e < 0:
                    continue
                # slot e covers [e*slot, (e+1)*slot)
                if (e + 1) * self.slot_secs > lo and e * self.slot_secs <= now:
                    out.merge(self._slots[j])
        return out

    def snapshot_cumulative(self) -> LatencyHistogram:
        with self._lock:
            return self.cumulative.copy()

    def quantiles(
        self,
        qs: Sequence[float] = QUANTILES,
        window_secs: float = DEFAULT_WINDOW_SECS,
    ) -> Dict[str, Optional[float]]:
        h = self.window_hist(window_secs)
        out: Dict[str, Optional[float]] = {
            _qname(q): h.quantile(q) for q in qs
        }
        out["count"] = h.count
        return out


def _qname(q: float) -> str:
    return "p" + format(q * 100, "g").replace(".", "")


# -- the write→event hop stamps ---------------------------------------------


@dataclass
class BatchStamp:
    """Rides a committed batch from the change hooks through the matcher
    queue to the event fan-out.

    `origin` is the wall clock at the ORIGIN node's commit (None when no
    stamp traveled — e.g. pre-upgrade peers); `applied` is the wall
    clock at the LOCAL apply/commit that fed the hooks.  When candidate
    batches coalesce in the matcher, the OLDEST stamp wins — a batch's
    latency is its worst element's.

    r19: `traceparent`/`trace_meta` carry the origin's W3C trace
    context + tail-sampling meta alongside the wall stamps, so the
    match and deliver stage spans stitch to the same trace id the
    write opened.  Coalescing keeps the trace of whichever stamp wins
    the oldest-origin contest (the batch is attributed to its worst
    element in spans exactly as it is in histograms)."""

    origin: Optional[float]
    applied: float
    traceparent: Optional[str] = None
    trace_meta: Optional[int] = None

    def oldest(self, other: Optional["BatchStamp"]) -> "BatchStamp":
        if other is None:
            return self
        if self.origin is not None and other.origin is not None:
            older = self if self.origin <= other.origin else other
            origin = older.origin
        elif self.origin is not None:
            older, origin = self, self.origin
        elif other.origin is not None:
            older, origin = other, other.origin
        else:
            older, origin = (self if self.traceparent else other), None
        return BatchStamp(
            origin=origin,
            applied=min(self.applied, other.applied),
            traceparent=older.traceparent,
            trace_meta=older.trace_meta,
        )


def _registry(registry=None):
    if registry is not None:
        return registry
    from corrosion_tpu_torch.runtime.metrics import METRICS

    return METRICS


def e2e_latency(stage: str, registry=None, **labels: str) -> WindowedLatency:
    return _registry(registry).latency(
        f"corro.e2e.{stage}.seconds", **labels
    )


def e2e_observe(
    stage: str, delta: float, registry=None, **labels: str
) -> float:
    """Observe one stage sample; negative deltas (cross-node clock skew)
    clamp to 0 and count, so skew shows up as its own series instead of
    as impossible latencies.  Returns the recorded value."""
    reg = _registry(registry)
    if delta < 0:
        reg.counter("corro.e2e.skew.clamped.total", stage=stage).inc()
        delta = 0.0
    e2e_latency(stage, registry=reg, **labels).observe(delta)
    return delta


def stage_hists(
    window_secs: Optional[float] = None, registry=None
) -> Dict[str, LatencyHistogram]:
    """Per-stage histogram, merged ACROSS label sets (the apply stage is
    labeled by change source) — windowed when `window_secs` is given,
    cumulative otherwise."""
    reg = _registry(registry)
    out: Dict[str, LatencyHistogram] = {}
    for stage in E2E_STAGES:
        merged = LatencyHistogram()
        for _name, _labels, inst in reg.latency_family(
            f"corro.e2e.{stage}.seconds"
        ):
            merged.merge(
                inst.window_hist(window_secs)
                if window_secs is not None
                else inst.snapshot_cumulative()
            )
        out[stage] = merged
    return out


def snapshot_stages(registry=None) -> Dict[str, LatencyHistogram]:
    """Cumulative per-stage snapshot, for diffing against a later one
    (`LatencyHistogram.diff`)."""
    return stage_hists(window_secs=None, registry=registry)


def stage_report(
    before: Optional[Dict[str, LatencyHistogram]] = None,
    window_secs: Optional[float] = None,
    registry=None,
) -> Dict[str, dict]:
    """{stage: {count, p50, p90, p99, p999, mean}} — over the interval
    since `before` (snapshot diff: exact scenario isolation), else over
    the sliding window, else cumulative."""
    now = stage_hists(
        window_secs=None if before is not None else window_secs,
        registry=registry,
    )
    out: Dict[str, dict] = {}
    for stage, h in now.items():
        if before is not None:
            h = h.diff(before.get(stage, LatencyHistogram()))
        row = {_qname(q): h.quantile(q) for q in QUANTILES}
        row["count"] = h.count
        row["mean"] = (h.total / h.count) if h.count else None
        out[stage] = row
    return out


# -- SLO monitor ------------------------------------------------------------


class SloMonitor:
    """Per-stage SLO targets + error-budget burn over the sliding
    window.

    `targets` maps stage → p-`objective` latency target in seconds.  A
    stage's error budget is `1 - objective` (e.g. 1 % of samples may
    exceed the target); burn rate is the observed violating fraction
    over that budget — burn > 1 means the objective is being missed.  A
    burn sustained for `breach_checks` consecutive checks with samples
    present trips ONE FlightRecorder incident dump per breach episode
    (re-armed when the stage recovers), so the black box holds the
    latency timeline that preceded the page."""

    def __init__(
        self,
        targets: Dict[str, float],
        objective: float = 0.99,
        window_secs: float = DEFAULT_WINDOW_SECS,
        breach_checks: int = 3,
        registry=None,
    ):
        self.targets = dict(targets)
        self.objective = objective
        self.window_secs = window_secs
        self.breach_checks = max(1, int(breach_checks))
        self._registry = registry
        self._streak: Dict[str, int] = {}
        self._open: Dict[str, bool] = {}
        self._lock = threading.Lock()

    def check(self, window_secs: Optional[float] = None) -> Dict[str, dict]:
        """Evaluate every stage; returns the per-stage report the
        /v1/slo plane serves (and fires incident dumps as a side
        effect)."""
        from corrosion_tpu_torch.runtime.records import FLIGHT

        reg = _registry(self._registry)
        window = window_secs if window_secs is not None else self.window_secs
        budget = max(1e-9, 1.0 - self.objective)
        hists = stage_hists(window_secs=window, registry=reg)
        cums = stage_hists(window_secs=None, registry=reg)
        report: Dict[str, dict] = {}
        frame: Dict[str, int] = {}
        for stage in E2E_STAGES:
            h = hists[stage]
            row = {_qname(q): h.quantile(q) for q in QUANTILES}
            row["window_count"] = h.count
            c = cums[stage]
            row["cumulative"] = {
                _qname(q): c.quantile(q) for q in QUANTILES
            }
            row["cumulative"]["count"] = c.count
            target = self.targets.get(stage)
            row["target"] = target
            breached = False
            if target is not None and h.count:
                viol = h.count - h.count_le(target)
                burn = (viol / h.count) / budget
                row["burn_rate"] = burn
                breached = burn > 1.0
                reg.gauge("corro.slo.burn.rate", stage=stage).set(burn)
                if breached:
                    reg.counter(
                        "corro.slo.breach.total", stage=stage
                    ).inc()
            else:
                row["burn_rate"] = None
            row["breached"] = breached
            report[stage] = row
            p99 = row.get("p99")
            frame[f"{stage}_p99_us"] = (
                int(p99 * 1e6) if p99 is not None else 0
            )
            frame[f"{stage}_n"] = h.count
        # the latency timeline the black box replays after a breach —
        # recorded BEFORE breach tracking so even a first-check incident
        # dump contains this check's percentiles
        FLIGHT.record_host_frame("slo", frame, registry=reg)
        for stage in E2E_STAGES:
            self._track(stage, report[stage]["breached"], reg, FLIGHT)
        return report

    def _track(self, stage: str, breached: bool, reg, flight) -> None:
        with self._lock:
            if not breached:
                self._streak[stage] = 0
                self._open[stage] = False
                return
            self._streak[stage] = self._streak.get(stage, 0) + 1
            fire = (
                self._streak[stage] >= self.breach_checks
                and not self._open.get(stage, False)
            )
            if fire:
                self._open[stage] = True
        if fire:
            reg.counter("corro.slo.incidents.total", stage=stage).inc()
            flight.snapshot_incident(f"slo_breach_{stage}", registry=reg)
