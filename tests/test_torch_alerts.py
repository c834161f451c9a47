"""The port's metrics TSDB, alert engine and remediation supervisor
(`runtime/tsdb.py`, `runtime/alerts.py`, `agent/remediation.py`) against
the JAX package's on the CPU.

Each package gets its own `Registry`, fed the same series, and its TSDB,
engine and supervisor run on the same injected clocks: the TSDB's fields,
windows, aggregates and census, every default rule's state after each
sample (fire, hold, resolve), each actuator's history through the kill
switch, a cooldown and a revert, the Lifeguard deferral gate, and the
digest's alert block as bytes must be equal. Values are compared
exactly: both packages run the same arithmetic on the same inputs.
"""

import asyncio
from types import SimpleNamespace

import pytest

from corrosion_tpu.agent import remediation as jrem
from corrosion_tpu.agent import syncer as jsyncer
from corrosion_tpu.chaos import faults as jfaults
from corrosion_tpu.runtime import alerts as jalerts
from corrosion_tpu.runtime import config as jconfig
from corrosion_tpu.runtime import digest as jdigest
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.runtime import records as jrecords
from corrosion_tpu.runtime import tsdb as jtsdb
from corrosion_tpu_torch.agent import remediation as trem
from corrosion_tpu_torch.agent import syncer as tsyncer
from corrosion_tpu_torch.chaos import faults as tfaults
from corrosion_tpu_torch.runtime import alerts as talerts
from corrosion_tpu_torch.runtime import config as tconfig
from corrosion_tpu_torch.runtime import digest as tdigest
from corrosion_tpu_torch.runtime import metrics as tmetrics
from corrosion_tpu_torch.runtime import records as trecords
from corrosion_tpu_torch.runtime import tsdb as ttsdb

from tests.test_torch_planes import planes_reset  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(tsdb=jtsdb, alerts=jalerts, metrics=jmetrics,
                           config=jconfig, rem=jrem, syncer=jsyncer,
                           faults=jfaults, digest=jdigest,
                           flight=jrecords.FLIGHT),
    "port": SimpleNamespace(tsdb=ttsdb, alerts=talerts, metrics=tmetrics,
                            config=tconfig, rem=trem, syncer=tsyncer,
                            faults=tfaults, digest=tdigest,
                            flight=trecords.FLIGHT),
}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    """`fn(pkg)` for each package: (JAX's result, the port's)."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    """Page firings dump flight incidents: into the test's directory."""
    monkeypatch.setenv("CORRO_FLIGHT_DIR", str(tmp_path))


# -- the TSDB -----------------------------------------------------------------


def _fed_tsdb(pkg, steps: int = 6, **kw):
    """A TSDB over a fresh registry with counters, gauges, a histogram
    and a latency instrument, sampled `steps` times one second apart."""
    reg = pkg.metrics.Registry()
    clock = Clock()
    db = pkg.tsdb.MetricsTSDB(registry=reg, sample_interval_secs=1.0,
                              clock=clock, wall=clock, **kw)
    for i in range(steps):
        reg.counter("x.writes.total", table="a").inc(3 + i)
        reg.counter("x.writes.total", table="b").inc(1)
        reg.gauge("x.depth", queue="q1").set(float(i))
        reg.gauge("x.depth", queue="q2").set(10.0 - i)
        reg.histogram("x.wait.seconds").observe(0.01 * (i + 1))
        reg.latency("x.e2e.seconds", stage="write").observe(0.002 * (i + 1))
        db.sample_once()
        clock.t += 1.0
    return db


def _census(db) -> dict:
    """The TSDB's census without the registry's own size gauge
    (`corro.metrics.series`, minted by its cardinality guard)."""
    out = db.census()
    for f in db.fields():
        if f.startswith("corro.metrics."):
            out["series"] -= 1
            out["points"] -= len(db.window(f, window_secs=1e9))
    return out


def _fields(db) -> list:
    return [f for f in db.fields() if not f.startswith("corro.metrics.")]


def test_tsdb_series_and_rates_match():
    def read(pkg):
        db = _fed_tsdb(pkg)
        return {
            "fields": _fields(db),
            "census": _census(db),
            "writes": db.window("x.writes.total:rate", window_secs=60.0),
            "writes_a": db.window("x.writes.total:rate", {"table": "a"}, 60),
            "depth": db.window("x.depth", window_secs=3.0),
            "wait_rate": db.window("x.wait.seconds:rate", window_secs=60.0),
            "e2e": db.window("x.e2e.seconds:p99", window_secs=60.0),
            "e2e_rate": db.window("x.e2e.seconds:rate", window_secs=60.0),
        }
    j, t = _both(read)
    assert j == t
    # counters enter as rates from their second sample on
    assert len(t["writes_a"]) == 5 and t["writes_a"][-1][1] == 8.0


@pytest.mark.parametrize("across,over", [
    ("sum", "last"), ("max", "avg"), ("min", "max"), ("avg", "min")])
def test_tsdb_aggregates_match(across, over):
    def agg(pkg):
        db = _fed_tsdb(pkg)
        return [db.aggregate(f, window_secs=w, across=across, over=over)
                for f in ("x.depth", "x.writes.total:rate", "x.none")
                for w in (2.5, 60.0)]
    j, t = _both(agg)
    assert j == t and t[0] is not None and t[-1] is None


def test_tsdb_absent_and_series_cap_match():
    def read(pkg):
        # the registry's own size gauge takes one series slot
        db = _fed_tsdb(pkg, max_series=4)
        drops = db.registry.counter("corro.tsdb.series.dropped.total").value
        db._wall.t += 120.0
        return (_fields(db), drops,
                db.absent("x.depth", window_secs=60.0),
                db.absent("x.never", window_secs=60.0))
    j, t = _both(read)
    assert j == t and t[1] > 0 and t[2] is True and t[3] is False


# -- the eight default rules --------------------------------------------------


def _drive_series(reg, rule: dict, on: bool) -> None:
    """One second of `rule`'s input: past its bar while `on`, at rest
    otherwise."""
    labels = dict(rule.get("labels", {}))
    if rule["kind"] == "threshold":
        bar = rule["value"]
        v = (bar + 1.0 if on else 0.0) if rule["op"].startswith(">") else \
            (bar - 1.0 if on else bar + 10.0)
        if rule["series"] == "corro.slo.burn.rate":
            labels.setdefault("stage", "write")
        reg.gauge(rule["series"], **labels).set(v)
    elif on:
        reg.counter(rule["series"], **labels).inc(rule["value"] + 2.0)


@pytest.mark.parametrize("name", [r["name"] for r in jalerts.DEFAULT_RULES])
def test_default_rule_fires_holds_and_resolves(name, flight_dir,
                                               planes_reset):
    """Every default rule on a registry holding only its input: its state
    and value after each one-second sample, and the engine's report and
    history, are the JAX package's."""
    rule = next(r for r in jalerts.DEFAULT_RULES if r["name"] == name)
    assert rule == next(r for r in talerts.DEFAULT_RULES
                        if r["name"] == name)

    def run(pkg):
        reg = pkg.metrics.Registry()
        clock = Clock()
        db = pkg.tsdb.MetricsTSDB(registry=reg, sample_interval_secs=1.0,
                                  clock=clock, wall=clock)
        eng = pkg.alerts.AlertEngine(tsdb=db, cfg=pkg.config.AlertsConfig(),
                                     registry=reg, clock=clock, wall=clock)
        trail = []
        for step in range(60):
            _drive_series(reg, rule, on=step < 40)
            db.sample_once()
            eng.evaluate()
            st = eng._states[name]
            trail.append((st.state, st.value))
            clock.t += 1.0
        report = eng.report()
        for row in report["rules"]:
            # a page's flight dump: its path names the process, and each
            # package's recorder holds other frames
            row["incident"] = None
        return trail, report, eng.census(), eng.active_summaries()
    (jt, jr, jc, ja), (tt, tr, tc, ta) = _both(run)
    assert tt == jt
    assert tr == jr and tc == jc and ta == ja
    states = [s for s, _v in tt]
    assert "pending" in states and "firing" in states
    assert states[-1] == "ok"
    events = [(h["rule"], h["event"]) for h in tr["history"]]
    assert events == [(name, "fired"), (name, "resolved")]


def test_a_firing_row_carries_its_drill_mark(flight_dir, planes_reset,
                                             monkeypatch):
    """A page rule firing during a drill, its row read while the engine
    dumps the incident (where a reader on another thread can read it):
    the JAX engine shows it firing with no drill mark yet, the port's
    still pending (it turns firing with its decorations, the one
    difference of `runtime/alerts.py`). After `evaluate` both rows and
    histories are equal, firing with the drill's name."""
    rule = next(r for r in jalerts.DEFAULT_RULES if r["name"] == "store-faults")

    def run(pkg):
        reg = pkg.metrics.Registry()
        clock = Clock()
        db = pkg.tsdb.MetricsTSDB(registry=reg, sample_interval_secs=1.0,
                                  clock=clock, wall=clock)
        eng = pkg.alerts.AlertEngine(tsdb=db, cfg=pkg.config.AlertsConfig(),
                                     registry=reg, clock=clock, wall=clock)
        mid = []
        dump = pkg.flight.snapshot_incident

        def read_then_dump(*a, **kw):
            mid.append(next(r for r in eng.report(history=False)["rules"]
                            if r["rule"] == "store-faults"))
            return dump(*a, **kw)

        monkeypatch.setattr(pkg.flight, "snapshot_incident", read_then_dump)
        pkg.faults.CENSUS.begin("sick-disk")
        try:
            for _ in range(40):
                _drive_series(reg, rule, on=True)
                db.sample_once()
                eng.evaluate()
                clock.t += 1.0
                if mid:
                    break
        finally:
            pkg.faults.CENSUS.end()
        report = eng.report()
        for row in report["rules"]:
            row["incident"] = None  # a dump's path names the process
        return mid, report
    (jm, jr), (tm, tr) = _both(run)
    assert len(jm) == len(tm) == 1
    assert (jm[0]["state"], jm[0]["drill"]) == ("firing", None)
    assert (tm[0]["state"], tm[0]["drill"]) == ("pending", None)
    assert tr == jr
    row = next(r for r in tr["rules"] if r["rule"] == "store-faults")
    assert (row["state"], row["drill"]) == ("firing", "sick-disk")


def test_rule_pack_overrides_and_refusals_match():
    """An operator rule of the same name replaces the pack's; a bad kind,
    op or severity is refused with the same message."""
    def build(pkg):
        cfg = pkg.config.AlertsConfig(for_scale=0.5, rules=[
            {"name": "loop-lag", "kind": "threshold",
             "series": "corro.runtime.loop.lag.max.seconds", "op": ">",
             "value": 2.0, "severity": "page"}])
        db = pkg.tsdb.MetricsTSDB(registry=pkg.metrics.Registry())
        eng = pkg.alerts.AlertEngine(tsdb=db, cfg=cfg,
                                     registry=pkg.metrics.Registry())
        rows = [(r.name, r.kind, r.tsdb_field, r.value, r.for_secs,
                 r.window_secs, r.severity) for r in eng.rules]
        errors = []
        for bad in ({"name": "x", "kind": "nope", "series": "s"},
                    {"name": "x", "kind": "rate", "series": "s", "op": "~"},
                    {"name": "x", "kind": "rate", "series": "s",
                     "severity": "loud"},
                    {"name": "x", "kind": "rate", "series": "s", "k": 1}):
            try:
                pkg.alerts.AlertRule.from_dict(bad)
            except ValueError as e:
                errors.append(str(e))
        return rows, errors
    j, t = _both(build)
    assert j == t and len(t[1]) == 4 and len(t[0]) == 8


def test_digest_alert_block_bytes_match(flight_dir, planes_reset):
    """The digest a node gossips carries its engine's active summaries:
    the same engines give the same bytes, and each package decodes the
    other's."""
    def encoded(pkg):
        reg = pkg.metrics.Registry()
        clock = Clock()
        db = pkg.tsdb.MetricsTSDB(registry=reg, sample_interval_secs=1.0,
                                  clock=clock, wall=clock)
        eng = pkg.alerts.AlertEngine(tsdb=db, cfg=pkg.config.AlertsConfig(),
                                     registry=reg, clock=clock, wall=clock)
        for step in range(12):
            reg.gauge("corro.cluster.divergence.active").set(1.0)
            reg.counter("corro.store.write.errors.total").inc(3.0)
            if step < 3:
                reg.counter("corro.sync.circuit.opened.total").inc(1.0)
            db.sample_once()
            eng.evaluate()
            clock.t += 1.0
        d = pkg.digest.NodeDigest(actor_id=bytes(range(16)), seq=7,
                                  wall=5000.0, view_hash=11, view_size=3,
                                  alive=3, alerts=eng.active_summaries())
        return d.alerts, pkg.digest.encode_digest(d)
    (ja, jb), (ta, tb) = _both(encoded)
    assert ta == ja and tb == jb
    assert {a["rule"] for a in ta} >= {"view-divergence", "store-faults"}
    assert tdigest.decode_digest(jb).alerts == jdigest.decode_digest(tb).alerts


# -- remediation ----------------------------------------------------------------


def _firing(rule, secs=60.0):
    return {"rule": rule, "severity": "page", "firing_secs": secs,
            "since_wall": 1.0, "value": 1.0, "drill": None}


class _Alerts:
    def __init__(self, firing=(), health=0.0):
        self.firing, self.health = list(firing), health

    def firing_snapshot(self):
        return list(self.firing)

    def health_score(self):
        return self.health


class _Obs:
    def __init__(self, rollup):
        self.rollup = rollup

    def cluster_alerts(self):
        return {"rollup": self.rollup}


class _Subs:
    """The matcher homes and fan-out the drain and shed actuators use."""

    def __init__(self):
        self.refuse_until = 0.0
        self.drains = 0
        self.fanout = SimpleNamespace(clogged_count=lambda: 2,
                                      shed_clogged=lambda: 2)

    async def drain(self):
        self.drains += 1
        return 3


def _agent(pkg, rule, **kw):
    cfg = pkg.config.Config()
    ns = SimpleNamespace(
        actor_id="me-node", config=cfg, alerts=_Alerts([_firing(rule)]),
        observatory=None, subs=_Subs(), bulk_refuse_until=0.0,
        members=SimpleNamespace(states={"me-node": 1, "peer": 1}))
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _sup(pkg, agent, clock):
    return pkg.rem.RemediationSupervisor(agent, cfg=agent.config.remediation,
                                         clock=clock, wall=clock)


@pytest.mark.parametrize("rule", list(jalerts.DEFAULT_ACTIONS))
def test_actuator_kill_switch_acts_cooldown_and_revert(rule, monkeypatch,
                                                       planes_reset):
    """The actuator bound to `rule`, through the default registry: with
    the kill switch on, one `would_act` per episode and no side effect;
    armed, it acts, a tick inside the cooldown does not, a tick past it
    acts again; then the rule resolves (a revert where the actuator has
    one). The histories, census, report and side effects are the JAX
    package's."""
    async def targeted(agent, timeout=30.0):
        return 7

    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.syncer, "targeted_sync", targeted)

    def run(pkg):
        clock = Clock()
        agent = _agent(pkg, rule)
        sup = _sup(pkg, agent, clock)
        trail = []

        async def go():
            for armed, dt in ((False, 0.0), (False, 1.0), (True, 1.0),
                              (True, 1.0), (True, 120.0)):
                agent.config.remediation.enabled = armed
                clock.t += dt
                await sup.tick()
                trail.append(([h["mode"] for h in sup.report()["history"]],
                              agent.subs.drains, agent.bulk_refuse_until > 0))
            agent.alerts.firing = []
            await sup.tick()
        asyncio.run(go())
        return trail, sup.report()["history"], sup.census(), sup.report(
            history=False), pkg.flight.window(3, kernel="remediation")
    (jt, jh, jc, jr, jf), (tt, th, tc, tr, tf) = _both(run)
    assert tt == jt and th == jh and tc == jc and tr == jr
    assert [f["events"] for f in tf] == [f["events"] for f in jf]
    modes = [h["mode"] for h in th]
    assert modes[0] == "would_act" and modes.count("acted") == 2


@pytest.mark.parametrize("confirmed", [False, True])
def test_bad_health_defers_until_cluster_consensus(confirmed, planes_reset):
    """A node whose own health score is past `defer_health` defers, and
    acts only once another node's digest shows the rule firing."""
    def run(pkg):
        clock = Clock()
        rollup = {"view-divergence": {"firing": (["other", "me-node"]
                                                 if confirmed
                                                 else ["me-node"])}}
        agent = _agent(pkg, "view-divergence",
                       alerts=_Alerts([_firing("view-divergence")], 0.9),
                       observatory=_Obs(rollup))
        agent.config.remediation.enabled = True
        sup = _sup(pkg, agent, clock)

        async def go():
            for _ in range(3):
                await sup.tick()
                clock.t += 1.0

        async def targeted(agent, timeout=30.0):
            return 0

        real = pkg.syncer.targeted_sync
        pkg.syncer.targeted_sync = targeted
        try:
            asyncio.run(go())
        finally:
            pkg.syncer.targeted_sync = real
        return [(h["mode"], h["detail"]) for h in sup.report()["history"]]
    j, t = _both(run)
    assert j == t
    assert [m for m, _d in t] == (["acted"] if confirmed else ["deferred"])


def test_default_actuators_bind_every_ruled_action():
    def table(pkg):
        acts = pkg.rem.default_actuators(pkg.config.RemediationConfig())
        return {n: (a.rule, a.cooldown_secs, a.sustain_secs,
                    a.revert is not None, a.precondition is not None)
                for n, a in acts.items()}
    j, t = _both(table)
    assert j == t
    assert {a[0] for a in t.values()} == set(talerts.DEFAULT_ACTIONS)
