"""The kernels' telemetry: lane names and the metrics registry.

The port's own copy of what it needs from `corrosion_tpu/runtime/
metrics.py`:

- the three tuples that fix the layout of the `events` lane and the
  flight `ring` of both SWIM kernels' states, and the CRDT merge
  engine's event lane. The order is a wire format: every drained event
  vector and flight-ring row is indexed in it, so it must stay identical
  to the reference's (tests/test_torch_swim.py and
  tests/test_torch_crdt.py pin it);
- a minimal `Registry` of counters, gauges, bucketed histograms and the
  windowed latency instruments of `runtime/latency.py` (the agent's
  `corro.e2e.<stage>.seconds`) with a non-mutating `snapshot`, and the
  process-global `METRICS` the simulation drivers, the CRDT merge
  engine, the agent and the SWIM host path (`agent/membership.py`,
  `net/transport.py`) publish into, under the reference's series names,
  among them:

      corro.kernel.events.total{kernel, event}   counter: drained device
                                                 event counts
      corro.kernel.phase.seconds{kernel, phase}  gauge: latest phase time
      corro.gossip.*                             the prober's counters
      corro.transport.rtt.seconds{addr}          histogram: probe RTTs

Instruments are mutated from whatever thread steps a simulation, so each
carries its own lock (a `+=` is not atomic under the GIL). The
cardinality guard and Prometheus serving are not ported.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, List, Tuple

# Cumulative event lane, one int32 counter per protocol event (wraps
# mod 2^32; drains take uint32 deltas).
KERNEL_EVENTS = (
    "gossip_emitted",  # gossip messages sent (sender+receiver up, same
    #                    partition; includes anti-entropy lanes)
    "gossip_lost",  # of those, dropped by iid loss injection
    "inbox_delivered",  # messages that landed in a bounded inbox
    "inbox_overflowed",  # messages dropped at the inbox cap
    "merge_won",  # inbox/own-update entries that improved the view
    "feed_pulls",  # successful feed-window partner exchanges
    "seed_pulls",  # bootstrap-seed window exchanges
    "suspect_raised",  # failed indirect probes -> new suspicions
    "down_declared",  # suspicion timers fired un-refuted
    "refuted",  # members that refuted by bumping incarnation
    "self_announced",  # periodic self-announces entering gossip
    "suspicion_confirmations",  # Lifeguard: confirming suspect messages
    #                             applied to open suspicion timers
    "suspect_fp",  # of suspect_raised, subjects that are in fact alive
    "down_fp",  # of down_declared, subjects that are in fact alive
)

# Flight-ring census lanes: point-in-time [N]-shaped integer reductions
# recorded after each tick's event deltas.
FLIGHT_CENSUS = (
    "census_alive",  # ground-truth live processes
    "census_suspect",  # open suspicion timers cluster-wide
    "census_down",  # ground-truth dead processes
    "inbox_highwater",  # max per-member valid inbox entries this tick
    "inc_max",  # max incarnation
    "lhm_max",  # max Local Health Multiplier score (Lifeguard)
)

# One ring row = event deltas then census, in this order.
FLIGHT_LANES = KERNEL_EVENTS + FLIGHT_CENSUS

# The CRDT merge engine's lane (`ops/crdt_merge.py::_merge_kernel`):
# per-batch decision outcomes, read back with the decisions themselves.
CRDT_MERGE_EVENTS = (
    "decide_won",  # changes that won their cell/row decision
    "decide_transition",  # causal-length transitions among the wins
    "decide_stale",  # changes beaten by local state or the batch
    "decide_ambiguous",  # undecidable digest ties (host-engine fallback)
)

# Per-kernel event lanes: the names a drained event vector is published
# under.
EVENTS_BY_KERNEL = {
    "dense": KERNEL_EVENTS,
    "pview": KERNEL_EVENTS,
    "crdt_merge": CRDT_MERGE_EVENTS,
}

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v


_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)


class Histogram:
    """Counts per upper bucket bound (one overflow bucket), sum and count."""

    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets=_DEFAULT_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect_right(self.buckets, v)] += 1
            self.total += v
            self.count += 1


class Registry:
    """Counters, gauges and histograms keyed by (name, sorted labels)."""

    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        # windowed percentile histograms (`runtime/latency.py`)
        self._latencies: Dict[Tuple[str, LabelKey], object] = {}
        self._lock = threading.Lock()

    def _get(self, table, factory, name: str, labels: Dict[str, str]):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            inst = table.get(key)
            if inst is None:
                inst = table[key] = factory()
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def latency(self, name: str, **labels: str):
        """Windowed percentile histogram (`runtime/latency.py`
        `WindowedLatency`): log buckets at ~5 % resolution, p50..p999
        over the sliding window and cumulative."""
        from corrosion_tpu_torch.runtime.latency import WindowedLatency

        return self._get(self._latencies, WindowedLatency, name, labels)

    def latency_items(self):
        """Every latency instrument as (name, labels, instrument) rows,
        read without minting series (the TSDB's quantile pass)."""
        with self._lock:
            items = list(self._latencies.items())
        return [(n, dict(labels), w) for (n, labels), w in items]

    def latency_family(self, name: str):
        """All label sets of one latency series, as (name, labels,
        instrument) rows, read without minting series."""
        with self._lock:
            items = list(self._latencies.items())
        return [(n, dict(labels), w) for (n, labels), w in items
                if n == name]

    def snapshot(self) -> List[Tuple[str, str, Dict[str, str], float]]:
        """Every series as (kind, name, labels, value) rows, read without
        minting new series; a histogram gives two rows, `<name>_count`
        and `<name>_sum`, and so does a latency instrument (its
        cumulative histogram)."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        out = (
            [("counter", name, dict(labels), c.value)
             for (name, labels), c in counters]
            + [("gauge", name, dict(labels), g.value)
               for (name, labels), g in gauges]
        )
        for (name, labels), h in hists:
            with h._lock:
                cnt, tot = h.count, h.total
            out.append(("histogram", name + "_count", dict(labels), cnt))
            out.append(("histogram", name + "_sum", dict(labels), tot))
        with self._lock:
            lats = list(self._latencies.items())
        for (name, labels), w in lats:
            c = w.snapshot_cumulative()
            out.append(("latency", name + "_count", dict(labels), c.count))
            out.append(("latency", name + "_sum", dict(labels), c.total))
        return out


METRICS = Registry()


def record_phase_seconds(kernel: str, phase: str, seconds: float,
                         registry: Registry = METRICS) -> None:
    """Publish one phase timing (gauge: the latest measurement wins)."""
    registry.gauge("corro.kernel.phase.seconds", kernel=kernel,
                   phase=phase).set(seconds)


def record_kernel_events(kernel: str, deltas,
                         registry: Registry = METRICS) -> None:
    """Publish one drained batch of device event counts, aligned with
    `EVENTS_BY_KERNEL[kernel]`. Zero deltas mint no series."""
    for name, d in zip(EVENTS_BY_KERNEL[kernel], deltas):
        d = float(d)
        if d:
            registry.counter("corro.kernel.events.total", kernel=kernel,
                             event=name).inc(d)


def kernel_event_totals(
    registry: Registry = METRICS,
) -> Dict[str, Dict[str, float]]:
    """{kernel: {event: total}} over the event-counter family."""
    out: Dict[str, Dict[str, float]] = {}
    for kind, name, labels, value in registry.snapshot():
        if kind == "counter" and name == "corro.kernel.events.total":
            out.setdefault(labels.get("kernel", "?"), {})[
                labels.get("event", "?")] = value
    return out
