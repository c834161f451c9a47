"""Declarative anomaly rules over the metrics TSDB: the alerting plane
(r20).

The repo measures everything (218+ documented series, /v1/slo,
/v1/cluster, /v1/traces) but until now nothing WATCHED the signals —
an operator (or the chaos matrix) had to poll and eyeball.  This module
turns the `[alerts]` config into typed, lifecycle-tracked alerts:

- RULES — threshold / rate / absent expressions over the TSDB fields
  (`runtime/tsdb.py`): a `threshold` rule compares the latest
  aggregated level of a gauge-like field, a `rate` rule the windowed
  per-second rate of a counter, an `absent` rule fires when a series
  that existed goes silent.  Every rule carries a for-duration and a
  severity; the default pack (`DEFAULT_RULES`) covers what the chaos
  matrix already proved can break: SLO burn, loop lag, shed/refusal
  rates, open sync circuits, view divergence, store faults.

- LIFECYCLE — OK → pending (condition true) → firing (held for the
  effective for-duration) → resolved (condition false), with a bounded
  transition history.  A PAGE-severity firing trips ONE FlightRecorder
  incident dump per episode (warn/info never dump — a flapping warn on
  a loaded host must not write frame histories); every firing
  attaches the tail sampler's slowest kept trace ids
  (runtime/tracestore.py — the jump from "paged" to "this write,
  through these nodes"), and an alert raised while the chaos CENSUS
  shows an active injection carries the scenario as a ``drill`` mark —
  the drill-vs-outage discriminator (chaos/faults.py).

- LOCAL HEALTH (Lifeguard, arXiv:1707.00788) — a node whose own event
  loop lags or whose store is faulting must distrust its own timers
  instead of flooding false positives: the health score (loop lag,
  store fault rate, membership LHM) WIDENS every rule's for-duration
  by up to `health_widen_max`×.  A sick node still pages — later, on
  stronger evidence (the LHA-Probe discipline applied to alerting).

Prime CCL bar (arXiv:2505.14065): a fault must surface as a typed
degradation signal, never a silent stall — the rules are how the
signals come TO the operator as pages instead of waiting in gauges.

Thread contract: `evaluate()` runs via `asyncio.to_thread` from
`alerts_loop` (incident dumps do file I/O) while HTTP handlers and the
digest builder read summaries from the loop/worker threads — all
shared state under ``self._lock``, reads return copies.

The port's copy of `corrosion_tpu/runtime/alerts.py`. Every series a
default rule names is published under the same name by the port's agent.
One difference: a rule's state turns to firing in `_on_fire`, under the
lock, together with its drill mark, trace ids, incident and profile.
The JAX module turns it in `evaluate` and decorates it afterwards
(a page's profile capture and incident dump take a while on a loaded
host), so a reader between the two saw a firing row without its drill
mark or profile; the traffic matrix's sick-disk bar failed on that.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.tsdb import MetricsTSDB

log = logging.getLogger(__name__)

SEVERITIES = ("info", "warn", "page")
KINDS = ("threshold", "rate", "absent")
OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}

# the default rule pack: one typed alert per failure class the chaos
# matrix / SLO plane already surfaced.  `series` names a TSDB field —
# rate rules name the COUNTER (the engine reads its `:rate` field).
DEFAULT_RULES = (
    {
        "name": "slo-burn",
        "kind": "threshold",
        "series": "corro.slo.burn.rate",
        "op": ">", "value": 1.0, "for_secs": 6.0,
        "agg": "max", "severity": "page",
        "summary": "error-budget burn > 1 on a write→event stage",
    },
    {
        "name": "loop-lag",
        "kind": "threshold",
        "series": "corro.runtime.loop.lag.max.seconds",
        "op": ">", "value": 0.5, "for_secs": 10.0,
        "agg": "max", "severity": "warn",
        "summary": "event-loop scheduling lag sustained above 500 ms",
    },
    {
        "name": "shed-rate",
        "kind": "rate",
        "series": "corro.subs.shed.total",
        "op": ">", "value": 1.0, "for_secs": 6.0,
        "severity": "warn",
        "summary": "subscription streams being shed as laggards",
    },
    {
        "name": "refusal-rate",
        "kind": "rate",
        "series": "corro.api.requests",
        "labels": {"status": "503"},
        "op": ">", "value": 5.0, "for_secs": 6.0,
        "severity": "warn",
        "summary": "API load-shedding 503s sustained",
    },
    {
        "name": "sync-circuit-open",
        "kind": "rate",
        "series": "corro.sync.circuit.opened.total",
        "op": ">", "value": 0.0, "for_secs": 4.0,
        "severity": "warn",
        "summary": "per-peer sync circuit breakers opening",
    },
    {
        "name": "view-divergence",
        "kind": "threshold",
        "series": "corro.cluster.divergence.active",
        "op": ">=", "value": 1.0, "for_secs": 4.0,
        "agg": "max", "severity": "page",
        "summary": "membership view divergence episode open "
                   "(partition / split-brain / silent node)",
    },
    {
        "name": "store-faults",
        "kind": "rate",
        "series": "corro.store.write.errors.total",
        "op": ">", "value": 0.5, "for_secs": 4.0,
        "severity": "page",
        "summary": "local write transactions failing at the store "
                   "(sick disk)",
    },
    {
        "name": "commit-stall",
        "kind": "rate",
        "series": "corro.store.commit.stall.total",
        "op": ">", "value": 0.5, "for_secs": 4.0,
        "severity": "page",
        "summary": "sqlite COMMIT walls stalling past the flush budget "
                   "(slow disk)",
    },
)


# rule → actuator bindings for the r22 remediation plane
# (agent/remediation.py): which registered actuator a FIRING rule
# drives.  Kept here beside DEFAULT_RULES so adding a rule forces the
# "should the cluster act on this?" question in the same diff; rules
# absent from the map page a human and nothing else.
DEFAULT_ACTIONS = {
    "view-divergence": "targeted-sync",
    "store-faults": "drain-refuse-bulk",
    "slo-burn": "shed-laggards",
}


@dataclass
class AlertRule:
    name: str
    kind: str  # threshold | rate | absent
    series: str
    op: str = ">"
    value: float = 0.0
    for_secs: float = 4.0
    window_secs: float = 10.0
    severity: str = "warn"
    agg: str = "sum"  # across-label-set aggregation
    labels: Dict[str, str] = field(default_factory=dict)
    summary: str = ""

    @classmethod
    def from_dict(cls, d: dict, for_scale: float = 1.0) -> "AlertRule":
        d = dict(d)
        unknown = set(d) - {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        if unknown:
            raise ValueError(
                f"alert rule {d.get('name', '?')!r}: unknown key(s) "
                f"{sorted(unknown)}"
            )
        r = cls(**d)
        if not r.name:
            raise ValueError("alert rule without a name")
        if r.kind not in KINDS:
            raise ValueError(f"alert rule {r.name!r}: kind {r.kind!r}")
        if r.op not in OPS:
            raise ValueError(f"alert rule {r.name!r}: op {r.op!r}")
        if r.severity not in SEVERITIES:
            raise ValueError(
                f"alert rule {r.name!r}: severity {r.severity!r}"
            )
        r.for_secs = float(r.for_secs) * for_scale
        r.window_secs = float(r.window_secs) * for_scale
        r.labels = dict(r.labels or {})
        return r

    @property
    def tsdb_field(self) -> str:
        return f"{self.series}:rate" if self.kind == "rate" else self.series


class _RuleState:
    __slots__ = ("state", "since_mono", "since_wall", "value", "drill",
                 "trace_ids", "incident", "profile")

    def __init__(self):
        self.state = "ok"  # ok | pending | firing
        self.since_mono = 0.0
        self.since_wall = 0.0
        self.value: Optional[float] = None
        self.drill: Optional[str] = None
        self.trace_ids: List[str] = []
        self.incident: Optional[str] = None
        self.profile: Optional[dict] = None


class AlertEngine:
    """One node's rule evaluator over the (process-global) TSDB."""

    def __init__(
        self,
        tsdb: MetricsTSDB,
        cfg=None,
        agent=None,
        registry=METRICS,
        clock=time.monotonic,
        wall=time.time,
    ):
        from corrosion_tpu_torch.runtime.config import AlertsConfig

        self.tsdb = tsdb
        self.cfg = cfg if cfg is not None else AlertsConfig()
        self.agent = agent
        self.registry = registry
        self._clock = clock
        self._wall = wall
        scale = max(1e-6, float(self.cfg.for_scale))
        packs: List[dict] = []
        if self.cfg.default_pack:
            packs.extend(DEFAULT_RULES)
        packs.extend(self.cfg.rules)
        self.rules: List[AlertRule] = []
        seen = set()
        for d in packs:
            r = AlertRule.from_dict(d, for_scale=scale)
            if r.name in seen:  # operator rule overrides the pack's
                self.rules = [x for x in self.rules if x.name != r.name]
            seen.add(r.name)
            self.rules.append(r)
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }
        self._history: deque = deque(maxlen=int(self.cfg.history_max))

    # -- local health (Lifeguard) -------------------------------------------

    def health_score(self) -> float:
        """0 = healthy; each sick local signal adds up to 1.  Read from
        the TSDB so the score judges the same evidence the rules do."""
        cfg = self.cfg
        score = 0.0
        lag = self.tsdb.aggregate(
            "corro.runtime.loop.lag.max.seconds",
            window_secs=max(30.0, 3 * self.tsdb.sample_interval_secs),
            across="max", over="last",
        )
        if lag is not None and cfg.health_lag_secs > 0:
            score += min(1.0, lag / cfg.health_lag_secs)
        faults = self.tsdb.aggregate(
            "corro.store.write.errors.total:rate",
            window_secs=max(30.0, 3 * self.tsdb.sample_interval_secs),
            across="sum", over="avg",
        )
        if faults is not None and cfg.health_fault_rate > 0:
            score += min(1.0, faults / cfg.health_fault_rate)
        if self.agent is not None:
            try:
                lhm = self.agent.membership.lhm
                lhm_max = max(1, self.agent.membership.config.lhm_max)
                score += min(1.0, lhm / lhm_max)
            except AttributeError:
                pass
        return score

    def _widen(self) -> float:
        """For-duration multiplier: 1 (healthy) … health_widen_max
        (sick) — the node distrusts its own timers, it does not
        silence them."""
        return min(
            float(self.cfg.health_widen_max), 1.0 + self.health_score()
        )

    # -- evaluation (worker thread via alerts_loop) -------------------------

    def _eval_condition(self, rule: AlertRule):
        if rule.kind == "absent":
            return (
                self.tsdb.absent(
                    rule.tsdb_field, rule.labels or None,
                    window_secs=rule.window_secs,
                ),
                None,
            )
        over = "last" if rule.kind == "threshold" else "avg"
        across = rule.agg if rule.kind == "threshold" else "sum"
        v = self.tsdb.aggregate(
            rule.tsdb_field, rule.labels or None,
            window_secs=rule.window_secs, across=across, over=over,
        )
        if v is None:
            return False, None
        return OPS[rule.op](v, rule.value), v

    def evaluate(self) -> dict:
        """One pass over every rule; returns {fired: [...], resolved:
        [...]} for callers that react (tests, obs_report)."""
        now = self._clock()
        wall = self._wall()
        widen = self._widen()
        self.registry.gauge("corro.alerts.health.score").set(
            round(self.health_score(), 4)
        )
        fired: List[str] = []
        resolved: List[str] = []
        for rule in self.rules:
            cond, value = self._eval_condition(rule)
            with self._lock:
                st = self._states[rule.name]
                st.value = value
                if cond:
                    if st.state == "ok":
                        st.state = "pending"
                        st.since_mono = now
                        st.since_wall = wall
                    if (
                        st.state == "pending"
                        and now - st.since_mono >= rule.for_secs * widen
                    ):
                        # `_on_fire` turns it firing once decorated
                        fired.append(rule.name)
                elif st.state != "ok":
                    if st.state == "firing":
                        resolved.append(rule.name)
                    st.state = "ok"
                    st.drill = None
                    st.trace_ids = []
                    st.incident = None
                    st.profile = None
        for name in fired:
            self._on_fire(name, wall)
        for name in resolved:
            self._on_resolve(name, wall)
        with self._lock:
            firing = sum(
                1 for s in self._states.values() if s.state == "firing"
            )
            pending = sum(
                1 for s in self._states.values() if s.state == "pending"
            )
        self.registry.counter("corro.alerts.evals.total").inc()
        self.registry.gauge("corro.alerts.firing").set(firing)
        self.registry.gauge("corro.alerts.pending").set(pending)
        return {"fired": fired, "resolved": resolved}

    def _on_fire(self, name: str, wall: float) -> None:
        from corrosion_tpu_torch.chaos.faults import CENSUS
        from corrosion_tpu_torch.runtime import profiler
        from corrosion_tpu_torch.runtime import tracestore
        from corrosion_tpu_torch.runtime.records import FLIGHT

        rule = next(r for r in self.rules if r.name == name)
        chaos = CENSUS.snapshot()
        drill = (
            (chaos.get("scenario") or "injection")
            if chaos.get("active") else None
        )
        st_store = tracestore.store()
        trace_ids = (
            [t["trace_id"] for t in st_store.kept(n=3)]
            if st_store is not None else []
        )
        # black-box dump for PAGES only: a warn-level alert flapping on
        # a loaded host (loop-lag on a busy 1-core box) must not write
        # a multi-MB frame history per episode per node.  A page also
        # grabs the continuous profiler's hot window (r23) — the
        # incident answers "WHERE was the time going when this fired",
        # not just "what were the lanes doing".
        profile = None
        if rule.severity == "page":
            prof = profiler.get()
            if prof is not None:
                try:
                    profile = prof.capture(f"alert_{name}")
                except Exception:
                    log.exception("profile capture failed for %s", name)
        incident = (
            FLIGHT.snapshot_incident(
                f"alert_{name}", registry=self.registry,
                extra={"profile": profile} if profile else None,
            )
            if rule.severity == "page" else None
        )
        with self._lock:
            st = self._states[name]
            st.state = "firing"
            st.drill = drill
            st.trace_ids = trace_ids
            st.incident = incident
            st.profile = profile
            value = st.value
            self._history.append({
                "rule": name, "event": "fired", "wall": wall,
                "severity": rule.severity, "value": value,
                "drill": drill,
            })
        self.registry.counter(
            "corro.alerts.fired.total", rule=name
        ).inc()
        log.warning(
            "ALERT firing: %s (%s)%s value=%s", name, rule.severity,
            f" [drill: {drill}]" if drill else "", value,
        )

    def _on_resolve(self, name: str, wall: float) -> None:
        rule = next(r for r in self.rules if r.name == name)
        with self._lock:
            fired_wall = next(
                (h["wall"] for h in reversed(self._history)
                 if h["rule"] == name and h["event"] == "fired"),
                None,
            )
            self._history.append({
                "rule": name, "event": "resolved", "wall": wall,
                "severity": rule.severity,
                "duration_secs": (
                    round(wall - fired_wall, 3)
                    if fired_wall is not None else None
                ),
            })
        self.registry.counter(
            "corro.alerts.resolved.total", rule=name
        ).inc()
        log.info("alert resolved: %s", name)

    # -- read side (loop / digest builder; copies only) ---------------------

    def _state_row(self, rule: AlertRule, st: _RuleState) -> dict:
        return {
            "rule": rule.name,
            "severity": rule.severity,
            "kind": rule.kind,
            "series": rule.series,
            "state": st.state,
            "value": st.value,
            "since_wall": (
                st.since_wall if st.state != "ok" else None
            ),
            "drill": st.drill,
            "trace_ids": list(st.trace_ids),
            "incident": st.incident,
            "profile": dict(st.profile) if st.profile else None,
            "summary": rule.summary,
        }

    def report(self, history: bool = True) -> dict:
        with self._lock:
            rows = [
                self._state_row(r, self._states[r.name])
                for r in self.rules
            ]
            hist = list(self._history) if history else []
        out = {
            "enabled": True,
            "health_score": round(self.health_score(), 4),
            "rules": rows,
            "active": [r for r in rows if r["state"] != "ok"],
        }
        if history:
            out["history"] = hist
        return out

    def active_summaries(self, cap: int = 16) -> List[dict]:
        """Compact active-alert rows for the cluster digest
        (runtime/digest.py): firing first, bounded."""
        with self._lock:
            rows = [
                {
                    "rule": r.name,
                    "severity": r.severity,
                    "state": st.state,
                    "since": st.since_wall,
                    "value": st.value if st.value is not None else 0.0,
                    "drill": bool(st.drill),
                }
                for r in self.rules
                for st in (self._states[r.name],)
                if st.state != "ok"
            ]
        rows.sort(key=lambda a: (a["state"] != "firing", a["rule"]))
        return rows[:cap]

    def firing_snapshot(self) -> List[dict]:
        """The remediation supervisor's consumption point
        (agent/remediation.py): every FIRING rule with how long it has
        been firing — enough to gate sustain windows and cooldowns
        without re-deriving lifecycle state."""
        now = self._clock()
        rules = {r.name: r for r in self.rules}
        with self._lock:
            return [
                {
                    "rule": name,
                    "severity": rules[name].severity,
                    "firing_secs": max(0.0, now - st.since_mono),
                    "since_wall": st.since_wall,
                    "value": st.value,
                    "drill": st.drill,
                }
                for name, st in self._states.items()
                if st.state == "firing"
            ]

    def census(self) -> dict:
        """The /v1/status block."""
        with self._lock:
            firing = [
                n for n, s in self._states.items() if s.state == "firing"
            ]
            pending = [
                n for n, s in self._states.items() if s.state == "pending"
            ]
        return {
            "enabled": True,
            "rules": len(self.rules),
            "firing": sorted(firing),
            "pending": sorted(pending),
            "health_score": round(self.health_score(), 4),
        }


async def alerts_loop(agent) -> None:
    """Evaluate the agent's rules every `eval_interval_secs` until
    tripwire.  Evaluation runs via to_thread: a firing rule dumps a
    flight-recorder incident (file I/O) and every TSDB read takes
    locks — neither belongs on the event loop."""
    eng = agent.alerts
    if eng is None:
        return
    interval = agent.config.alerts.eval_interval_secs
    while not agent.tripwire.tripped:
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(agent.tripwire.wait(), interval)
        if agent.tripwire.tripped:
            return
        try:
            await asyncio.to_thread(eng.evaluate)
        except Exception:
            log.exception("alert evaluation failed")
