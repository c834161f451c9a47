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
carries its own lock (a `+=` is not atomic under the GIL). A series name
may mint at most `Registry.max_label_sets` label sets (the cardinality
guard: further ones are dropped, counted under
`corro.metrics.cardinality.dropped.total{kind}`, and the registry's size
is the gauge `corro.metrics.series`). `render_prometheus` is the text
exposition and `serve_prometheus` serves it at GET /metrics (the CLI
agent's `telemetry.prometheus_bind_addr`).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from itertools import accumulate
from typing import Dict, List, Optional, Tuple

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


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text format 0.0.4 label-value escaping (backslash,
    double quote, line feed)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Registry:
    """Counters, gauges, histograms and latency instruments keyed by
    (name, sorted labels), with the per-name cardinality guard."""

    # distinct label sets one series name may mint before further ones
    # are dropped (counted) and handed a detached instrument
    max_label_sets = 512

    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        # windowed percentile histograms (`runtime/latency.py`)
        self._latencies: Dict[Tuple[str, LabelKey], object] = {}
        self._lock = threading.Lock()
        # label sets minted per name (all kinds pooled), and the shared
        # detached instruments a refused mint is handed
        self._name_counts: Dict[str, int] = {}
        self._null_counter = Counter()
        self._null_gauge = Gauge()
        self._null_histogram = Histogram()
        self._null_latency = None

    def _admit(self, name: str) -> bool:
        """Under self._lock: account one new label set for `name`; False
        once the name holds `max_label_sets`."""
        n = self._name_counts.get(name, 0)
        if n >= self.max_label_sets:
            return False
        self._name_counts[name] = n + 1
        return True

    def _note_mint(self) -> None:
        """Publish the registry's size after a mint (outside the lock; the
        gauge's own first mint recurses once, then takes the fast path)."""
        g = self.gauge("corro.metrics.series")
        with self._lock:
            total = (len(self._counters) + len(self._gauges)
                     + len(self._histograms) + len(self._latencies))
        g.set(total)

    def _get(self, table, kind, factory, name: str,
             labels: Dict[str, str]):
        """The instrument of (name, labels): an existing one, a newly
        minted one, or None when the cardinality guard refuses it (the
        drop is counted)."""
        key = (name, _labels_key(labels))
        minted = False
        with self._lock:
            inst = table.get(key)
            if inst is None and self._admit(name):
                inst = table[key] = factory()
                minted = True
        if inst is None:
            self.counter("corro.metrics.cardinality.dropped.total",
                         kind=kind).inc()
            return None
        if minted:
            self._note_mint()
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        c = self._get(self._counters, "counter", Counter, name, labels)
        return c if c is not None else self._null_counter

    def gauge(self, name: str, **labels: str) -> Gauge:
        g = self._get(self._gauges, "gauge", Gauge, name, labels)
        return g if g is not None else self._null_gauge

    def histogram(self, name: str, **labels: str) -> Histogram:
        h = self._get(self._histograms, "histogram", Histogram, name,
                      labels)
        return h if h is not None else self._null_histogram

    def latency(self, name: str, **labels: str):
        """Windowed percentile histogram (`runtime/latency.py`
        `WindowedLatency`): log buckets at ~5 % resolution, p50..p999
        over the sliding window and cumulative."""
        from corrosion_tpu_torch.runtime.latency import WindowedLatency

        w = self._get(self._latencies, "latency", WindowedLatency, name,
                      labels)
        if w is None:
            with self._lock:
                if self._null_latency is None:
                    self._null_latency = WindowedLatency()
            return self._null_latency
        return w

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

    def render_prometheus(self) -> str:
        """Prometheus text format 0.0.4 (the JAX registry's rendering)."""
        from corrosion_tpu_torch.runtime import latency as _lat

        out: List[str] = []

        def fmt(name: str, labels: LabelKey,
                extra: Optional[Dict[str, str]] = None) -> str:
            norm = name.replace(".", "_").replace("-", "_")
            items = list(labels) + (list(extra.items()) if extra else [])
            if items:
                lbl = ",".join(f'{k}="{_escape_label_value(v)}"'
                               for k, v in items)
                return f"{norm}{{{lbl}}}"
            return norm

        def tail(name: str, labels: LabelKey, buckets, total, count):
            """Cumulative `le` buckets, `+Inf`, `_sum` and `_count`."""
            for le, cum in buckets:
                out.append(
                    f"{fmt(name + '_bucket', labels, {'le': le})} {cum}")
            out.append(
                f"{fmt(name + '_bucket', labels, {'le': '+Inf'})} {count}")
            out.append(f"{fmt(name + '_sum', labels)} {total}")
            out.append(f"{fmt(name + '_count', labels)} {count}")

        with self._lock:
            for (name, labels), c in sorted(self._counters.items()):
                out.append(f"{fmt(name, labels)} {c.value}")
            for (name, labels), g in sorted(self._gauges.items()):
                out.append(f"{fmt(name, labels)} {g.value}")
            for (name, labels), h in sorted(self._histograms.items()):
                with h._lock:
                    counts = list(h.counts)
                    total, count = h.total, h.count
                tail(name, labels,
                     zip(map(str, h.buckets), accumulate(counts)),
                     total, count)
            for (name, labels), w in sorted(self._latencies.items()):
                # cumulative log buckets at the occupied edges, then the
                # windowed quantile gauges
                c = w.snapshot_cumulative()
                occupied = c.nonzero_buckets()
                tail(name, labels,
                     zip((format(_lat.bucket_upper(i), ".6g")
                          for i, _n in occupied),
                         accumulate(n for _i, n in occupied)),
                     c.total, c.count)
                qs = w.quantiles(window_secs=_lat.DEFAULT_WINDOW_SECS)
                for q in _lat.QUANTILES:
                    v = qs[_lat._qname(q)]
                    if v is not None:
                        extra = {"quantile": format(q, "g"),
                                 "window": format(_lat.DEFAULT_WINDOW_SECS,
                                                  "g")}
                        out.append(f"{fmt(name, labels, extra)} {v}")
        return "\n".join(out) + "\n"


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


async def serve_prometheus(addr: str, registry: Registry = METRICS):
    """Serve the registry at GET /metrics on `addr` ("host:port"); returns
    the aiohttp AppRunner (`.cleanup()` stops it)."""
    from aiohttp import web

    async def h_metrics(_request):
        return web.Response(text=registry.render_prometheus(),
                            content_type="text/plain")

    app = web.Application()
    app.router.add_get("/metrics", h_metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    host, port = addr.rsplit(":", 1)
    site = web.TCPSite(runner, host, int(port))
    await site.start()
    return runner
