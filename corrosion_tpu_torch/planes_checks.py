"""The runtime planes on a live three-agent cluster, for either package.

`scenario_planes(api, db_dir, transport)` drives the agents of the
package `api` names (`agent_checks.port_api(device)`, or the JAX
package's namespace in `tests/test_torch_planes.py`) with every runtime
plane on: the tail-sampling trace store, the metrics TSDB, the alert
engine with its remediation supervisor and the continuous profiler, as a
default `Config` has them, plus OTLP export into an in-process sink
(`OtlpSink`). Only their clocks are tuned (`tune`): the TSDB samples and
the rules evaluate every 0.5 s, every rule's for-duration and window
are a quarter of the default pack's, and a digest goes out every second
(a node is silent after 3 s without one, long enough that a busy host's
loop lag does not read as a partition).

Agents A and B boot with their APIs (`agent_checks.boot_with_api`) and
SWIM timers whose suspicion outlasts a partition; A's h2 client writes
`agent_checks.net_rows(rows)` in `txs` transactions, and once B holds
them C boots and catches up by delta sync, as in `agent_checks.
scenario_api`. Then two episodes:

1. A partition with remediation armed: C is cut off from A and B
   (`_Cut`: C's transport and theirs drop datagrams to each other and
   refuse streams, as the in-memory network's partition does), A writes
   `PARTITION_ROWS` more, and the partition holds until `view-divergence`
   fires on A and B, B's `/v1/alerts?scope=cluster` shows it firing on
   A, and `targeted-sync` has acted on A and on B. After the heal C must
   catch up to every row and every episode must close.
2. A sick disk with remediation observe-only: A's store fails every
   statement (`StoreFaults(statement_busy_rate=1.0)`, the chaos census
   naming the drill "sick-disk") while A's client keeps writing, until
   `store-faults` fires on every node, every node's supervisor has
   recorded `drain-refuse-bulk` as `would_act` and the trace store has
   kept a trace for an error. Then the disk heals and the rule resolves.

The metrics registry, the TSDB, the trace store and the profiler are
process-global, so every agent's rules read the same series: a rule
fires on every node. `planes_outcome` is the part of the record that
timing cannot change and `chip_smoke.PLANES_REF` holds: the rows, the
episode rules fired per node with their severities, the actuator each
drove and whether it reached its terminal outcome on the nodes where
that is certain, whether each node opened a divergence episode between
the cut and the heal, and whether one `cluster_divergence` incident was
dumped for each episode meanwhile (counted as `FLIGHT.snapshot_incident`
is called). How many episodes a node opens is timing's: a long cut on
a loaded host lets SWIM's membership views part, and a node may close
and reopen one; short episodes open before the cut and after the heal. Those counts are
recorded, not compared. `planes_checks` adds what timing decides, as
bounds.

Every wait is capped, and every agent, server, client, exporter and
sink is closed on every exit path; the process-global planes are
uninstalled before the agents boot and after they stop.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from corrosion_tpu_torch import agent_checks as ac

PLANES_SEED = 83
# rows A writes while C is cut off
PARTITION_ROWS = 200
# the rules each episode is about, with the actuators they drive
# (`runtime/alerts.py::DEFAULT_ACTIONS`) and the outcome each must reach:
# armed for the partition, observe-only for the sick disk
EPISODES = {
    "view-divergence": ("targeted-sync", "acted"),
    "store-faults": ("drain-refuse-bulk", "would_act"),
}
# fast probing, as in `models/cluster.py::cluster_observatory_scenario`,
# and a suspicion window (about a minute for three members) longer than
# the partition: a member declared down leaves every view, and the
# observatory would see one view again
PLANES_SWIM = dict(probe_period=0.05, probe_rtt=0.02, suspicion_mult=600.0)
EPISODE_CAP_S = 90.0


def tune(cfg) -> None:
    """The runtime planes back on (`agent_checks.fast_config` turns them
    off), as a default `Config` has them; only their clocks shrink."""
    for section, flag in ac.PLANES_OFF:
        setattr(getattr(cfg, section), flag, True)
    cfg.sync.snapshot = False
    cfg.tsdb.sample_interval_secs = 0.5
    cfg.alerts.eval_interval_secs = 0.5
    cfg.alerts.for_scale = 0.25
    cfg.remediation.tick_secs = 0.5
    cfg.cluster.digest_interval_secs = 1.0
    cfg.cluster.silent_after_mult = 3.0


def _tune(cfg, cluster: dict) -> None:
    tune(cfg)
    for key, value in cluster.items():
        setattr(cfg.cluster, key, value)


def reset_planes(api) -> None:
    """Uninstall the package's process-global planes and join their
    threads: the TSDB and its sampler, the trace store and its sweep,
    the profiler, the OTLP exporter."""
    api.tsdb.configure()
    api.tracestore.configure()
    api.profiler.configure()
    api.otel.configure(None)


class OtlpSink:
    """An OTLP/HTTP collector on `127.0.0.1:0` in a thread: counts the
    spans and requests of every POST to `/v1/traces`."""

    def __init__(self):
        sink = self
        self.spans = 0
        self.requests = 0
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                n = sum(len(ss.get("spans", []))
                        for rs in json.loads(body)["resourceSpans"]
                        for ss in rs["scopeSpans"])
                with sink._lock:
                    sink.spans += n
                    sink.requests += 1
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = "http://127.0.0.1:%d" % self._server.server_port
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="otlp-sink", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class _Cut:
    """Cuts one agent's transport from a set of addresses: datagrams to
    them are dropped, uni and bi streams to them refused with the
    transport's error, as `MemNetwork.partition` does. Cutting both
    sides of each link makes a partition on any transport."""

    def __init__(self, api, transport):
        self.blocked = set()
        for name in ("send_datagram", "send_uni", "open_bi"):
            setattr(transport, name,
                    self._guard(name, getattr(transport, name),
                                api.TransportError))

    def _guard(self, name, fn, error):
        async def guarded(addr, *args):
            if addr in self.blocked:
                if name == "send_datagram":
                    return None
                raise error(f"unreachable: {addr}")
            return await fn(addr, *args)
        return guarded


def _counter(api, name: str) -> float:
    return sum(v for kind, n, _l, v in api.METRICS.snapshot()
               if kind == "counter" and n == name)


def _fired(agent) -> dict:
    """{rule: severity} of every rule the agent's engine fired."""
    return {h["rule"]: h["severity"]
            for h in agent.alerts.report()["history"]
            if h["event"] == "fired"}


def _modes(agent, rule: str) -> list:
    """The remediation outcomes recorded for `rule`, in order."""
    return [h["mode"] for h in agent.remediation.report()["history"]
            if h["rule"] == rule]


def _firing(agent, rule: str) -> bool:
    return rule in agent.alerts.census()["firing"]


def _state(agents) -> str:
    """Each agent's rows, firing rules, remediation history and episode,
    for a failure's message."""
    return "; ".join(
        f"{n}: {ac.count_rows(ag)} rows, firing "
        f"{ag.alerts.census()['firing']}, remediation "
        f"{[(h['rule'], h['mode']) for h in ag.remediation.report()['history']]}"
        f", episode open {ag.observatory._episode_open} streak "
        f"{ag.observatory._div_streak} lagged {ag.observatory._self_lagged} "
        f"{ag.observatory.check_divergence()['silent']}"
        for n, ag in zip("abc", agents))


async def _until(what: str, pred, agents, cap: float = EPISODE_CAP_S) -> float:
    """Seconds until `pred()`, polled every 0.25 s (a row count or a
    census read on the agents' own event loop: polling faster slows
    them), or an AssertionError with every agent's state after `cap`."""
    t0 = time.monotonic()
    if not await ac.wait_until(pred, timeout=cap, step=0.25):
        raise AssertionError(f"{what} within {cap} s: {_state(agents)}")
    return time.monotonic() - t0


async def scenario_planes(api, db_dir: str, transport: str = "quic",
                          rows: int = 400, txs: int = 4,
                          timeout: float = 120.0,
                          cluster: Optional[dict] = None) -> dict:
    """The two episodes above on three agents of `api` over `transport`
    ("mem", "quic" or "tcp"). `cluster` overrides `[cluster]` settings
    (the CPU tests shorten the digest interval on their small runs). Returns the record `planes_outcome` and
    `planes_checks` read: rows, fired rules, remediation histories,
    episodes and incidents, the endpoints' bodies, the profiler's census,
    the TSDB's fields against the rules' inputs, the OTLP counts, the
    array lanes and the walls."""
    reset_planes(api)
    sink = OtlpSink()
    api.otel.configure(sink.endpoint, flush_interval_s=0.5)
    exported0 = _counter(api, "corro_otel_spans_exported_total")
    failed0 = _counter(api, "corro_otel_export_failures_total")
    net = api.MemNetwork(seed=PLANES_SEED) if transport == "mem" else None
    addrs = ([f"planes-{x}" for x in "abc"] if transport == "mem"
             else [ac.loopback_addr(transport) for _ in range(3)])
    flight_dir = os.path.join(db_dir, "flight")
    old_flight = os.environ.get("CORRO_FLIGHT_DIR")
    agents, servers, clients = [], [], []
    # every flight incident the run dumps, by reason (the files' names
    # wrap at 16 per process, so they cannot be counted)
    dumps: list = []
    real_dump = api.FLIGHT.snapshot_incident

    def counted_dump(reason, *args, **kw):
        path = real_dump(reason, *args, **kw)
        dumps.append((reason, path is not None))
        return path

    api.FLIGHT.snapshot_incident = counted_dump
    expected = ac.net_rows(rows)
    extra = [(rows + i, f"partition-{i}")
             for i in range(1, PARTITION_ROWS + 1)]
    walls: dict = {}
    out: dict = {"transport": transport, "rows": rows + PARTITION_ROWS,
                 "txs": txs, "walls": walls}
    async def start(i: int) -> None:
        ag, server, client = await ac.boot_with_api(
            api, net, addrs[i], db_dir, addrs[:i],
            tune=lambda cfg: _tune(cfg, cluster or {}),
            swim=api.SwimConfig(**PLANES_SWIM), transport=transport)
        agents.append(ag)
        servers.append(server)
        clients.append(client)

    try:
        t_boot = time.monotonic()
        await start(0)
        await start(1)
        a, b = agents
        await ac._sizes(agents, 2, 30.0)
        per = -(-rows // txs)
        t0 = time.monotonic()
        for k in range(0, rows, per):
            await clients[0].execute([
                ["INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
                 list(it)] for it in expected[k:k + per]])
        walls["write_s"] = time.monotonic() - t0
        walls["b_converged_s"] = await _until(
            f"{api.name}: B holding {rows} rows",
            lambda: ac.count_rows(b) == rows, agents, timeout)
        # C joins late and catches up by delta sync, as in `agent_api`
        await start(2)
        c = agents[2]
        await ac._sizes(agents, 3, 30.0)
        walls["c_converged_s"] = await _until(
            f"{api.name}: C holding {rows} rows",
            lambda: ac.count_rows(c) == rows, agents, timeout)
        walls["boot_to_converged_s"] = time.monotonic() - t_boot
        # an SLO check publishes the burn gauges `slo-burn` reads (the
        # canary, which would run it, is off)
        _st, slo = await ac._get_json(clients[0], "/v1/slo")
        out["slo_stages"] = sorted(slo["stages"])

        # -- 1. partition with remediation armed ---------------------------
        # every node must hold every node's digest first: a node never
        # heard from is no evidence of silence
        walls["quiet_s"] = await _until(
            f"{api.name}: full digest coverage and no divergence episode "
            "open before the partition",
            lambda: all(len(ag.observatory._store) == 3
                        and not ag.observatory._episode_open
                        and not _firing(ag, "view-divergence")
                        for ag in agents), agents)
        for ag in agents:
            ag.config.remediation.enabled = True
        os.environ["CORRO_FLIGHT_DIR"] = flight_dir
        dumps.clear()
        episodes0 = [ag.observatory._episodes for ag in agents]
        lane_c0 = dict(getattr(c.store, "array_lane", None) or {})
        cuts = [_Cut(api, ag.transport) for ag in agents]
        cuts[2].blocked.update(addrs[:2])
        for cut in cuts[:2]:
            cut.blocked.add(addrs[2])
        t0 = time.monotonic()
        await clients[0].execute([
            ["INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
             list(it)] for it in extra])
        cluster_view = {}

        async def seen_from_b() -> bool:
            _st, body = await ac._get_json(clients[1],
                                           "/v1/alerts?scope=cluster")
            row = body["rollup"].get("view-divergence") or {}
            cluster_view.update(body)
            return str(a.actor_id) in row.get("firing", [])

        def observers_acted() -> bool:
            return all(_firing(ag, "view-divergence")
                       and "acted" in _modes(ag, "view-divergence")
                       for ag in (a, b))

        walls["divergence_acted_s"] = await _until(
            f"{api.name}: view-divergence firing and targeted-sync acting "
            "on A and B", observers_acted, agents)
        deadline = time.monotonic() + EPISODE_CAP_S
        while not await seen_from_b():
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{api.name}: B's /v1/alerts?scope=cluster never showed "
                    f"view-divergence firing on A: {cluster_view}")
            await asyncio.sleep(0.1)
        out["cluster_alerts_from_b"] = cluster_view
        walls["partition_s"] = time.monotonic() - t0
        # what the cut opened: C stays silent to A and B (and they to C)
        # until the heal, so no episode can close and reopen before it
        out["episodes"] = {n: ag.observatory._episodes - e0 for n, ag, e0
                           in zip("abc", agents, episodes0)}
        out["incidents"] = sum(1 for reason, written in dumps
                               if reason == "cluster_divergence" and written)
        for cut in cuts:
            cut.blocked.clear()
        t0 = time.monotonic()
        total = rows + PARTITION_ROWS
        walls["c_caught_up_s"] = await _until(
            f"{api.name}: C catching up to {total} rows after the heal",
            lambda: all(ac.count_rows(ag) == total for ag in agents),
            agents, timeout)
        walls["episodes_closed_s"] = await _until(
            f"{api.name}: every divergence episode closing after the heal",
            lambda: not any(ag.observatory._episode_open for ag in agents)
            and not any(_firing(ag, "view-divergence") for ag in agents),
            agents)
        # after the heal a loaded host may open a short episode more
        out["episodes_to_closed"] = {
            n: ag.observatory._episodes - e0
            for n, ag, e0 in zip("abc", agents, episodes0)}
        lane_c = getattr(c.store, "array_lane", None)
        out["c_catch_up_lane"] = (None if lane_c is None else {
            k: lane_c[k] - lane_c0.get(k, 0) for k in ("decided", "declined")})

        # -- 2. sick disk with remediation observe-only --------------------
        for ag in agents:
            ag.config.remediation.enabled = False
        api.CENSUS.begin("sick-disk")
        api.CENSUS.add("sick-disk:a", "A's store fails every statement",
                       "store")
        a.store.chaos = api.StoreFaults(statement_busy_rate=1.0,
                                        seed=PLANES_SEED)
        st = api.tracestore.store()
        t0 = time.monotonic()
        refused = 0

        def sick_seen() -> bool:
            return (all("would_act" in _modes(ag, "store-faults")
                        for ag in agents)
                    and any(t["reason"] == "error"
                            for t in st.kept(n=st.keep_max)))

        try:
            deadline = time.monotonic() + EPISODE_CAP_S
            while not sick_seen():
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"{api.name}: sick disk: store-faults outcomes "
                        f"{[_modes(ag, 'store-faults') for ag in agents]}, "
                        f"traces {st.census()}")
                try:
                    await clients[0].execute([[
                        "INSERT OR REPLACE INTO tests (id, text) "
                        "VALUES (?, ?)", [1, "never"]]])
                except api.ClientError:
                    refused += 1
                await asyncio.sleep(0.1)
        finally:
            a.store.chaos = None
            api.CENSUS.end()
        walls["sick_disk_s"] = time.monotonic() - t0
        out["sick_disk_refused_writes"] = refused
        walls["store_faults_resolved_s"] = await _until(
            f"{api.name}: store-faults resolving after the disk heals",
            lambda: not any(_firing(ag, "store-faults") for ag in agents),
            agents)

        # -- what the planes hold ------------------------------------------
        out["rows_digest"] = [ac.digest(ac.query(
            ag, "SELECT id, text FROM tests ORDER BY id")) for ag in agents]
        out["expected_digest"] = ac.digest(expected + extra)
        out["fired"] = {n: _fired(ag) for n, ag in zip("abc", agents)}
        out["remediation"] = {
            n: {rule: [(h["action"], h["mode"])
                       for h in ag.remediation.report()["history"]
                       if h["rule"] == rule] for rule in EPISODES}
            for n, ag in zip("abc", agents)}
        out["incident_dumps"] = sorted({r for r, _w in dumps})
        _st, traces = await ac._get_json(clients[0], "/v1/traces?n=256")
        out["traces"] = {
            "census": traces["census"],
            "kept_reasons": sorted({t["reason"] for t in traces["traces"]}),
            "error_chaos": sorted({str(t["chaos"]) for t in traces["traces"]
                                   if t["reason"] == "error"}),
        }
        hot = {}
        for n, client in zip("abc", clients):
            _st, body = await ac._get_json(client, "/v1/profile?scope=cluster")
            hot[n] = {node: len(row["hotspots"])
                      for node, row in body["nodes"].items()}
        out["hotspots"] = hot
        _st, doc = await ac._get_json(clients[0],
                                      "/v1/profile?format=speedscope")
        out["speedscope"] = {"frames": len(doc["shared"]["frames"]),
                             "samples": sum(doc["profiles"][0]["weights"])}
        _st, prof = await ac._get_json(clients[0], "/v1/profile")
        out["profile"] = {k: prof[k] for k in (
            "samples", "hz", "shed", "overhead_pct", "top_self")}
        census = api.profiler.get().census()
        out["profile"]["max_overhead_pct"] = census["max_overhead_pct"]
        out["profile"]["busy_secs_total"] = census["busy_secs_total"]
        _st, status = await ac._get_json(clients[0], "/v1/status")
        out["status"] = {k: status[k] for k in (
            "traces", "tsdb", "alerts", "remediation", "profile")
            if k in status}
        db = api.tsdb.get()
        fields = set(db.fields())
        registry = {n for _k, n, _l, _v in api.METRICS.snapshot()}
        inputs = {r.tsdb_field: r.series for r in a.alerts.rules}
        out["tsdb"] = {
            "census": db.census(),
            "rule_inputs": sorted(inputs),
            "in_tsdb": sorted(f for f in inputs if f in fields),
            # inputs whose series this run never minted (a counter that
            # never moved): nothing for the TSDB to hold
            "never_published": sorted(
                f for f, s in inputs.items()
                if s not in registry and s + "_count" not in registry),
            "sample_seconds": _histogram(api, "corro.tsdb.sample.seconds"),
        }
        exp = api.otel.exporter()
        await asyncio.to_thread(exp.flush)
        out["otlp"] = {
            "exported": _counter(api, "corro_otel_spans_exported_total")
            - exported0,
            "failures": _counter(api, "corro_otel_export_failures_total")
            - failed0,
            "sink_spans": sink.spans, "sink_requests": sink.requests,
        }
        out["array_lane"] = {n: getattr(ag.store, "array_lane", None)
                             for n, ag in zip("abc", agents)}
        return out
    finally:
        for client in clients:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(client.close(), 10.0)
        for server in servers:
            with contextlib.suppress(Exception):
                await asyncio.wait_for(server.stop(), ac.STOP_BUDGET_S)
        for ag in agents:
            if ag.observatory is not None:
                ag.observatory.disarm()
        done = await asyncio.gather(*(api.shutdown(ag) for ag in agents),
                                    return_exceptions=True)
        await asyncio.to_thread(reset_planes, api)
        del api.FLIGHT.snapshot_incident
        sink.close()
        if old_flight is None:
            os.environ.pop("CORRO_FLIGHT_DIR", None)
        else:
            os.environ["CORRO_FLIGHT_DIR"] = old_flight
        errors = [e for e in done if isinstance(e, BaseException)]
        if errors:
            raise errors[0]


def _histogram(api, name: str) -> dict:
    """{count, sum} of an unlabelled histogram of the registry."""
    rows = {n: v for kind, n, _l, v in api.METRICS.snapshot()
            if kind == "histogram" and n in (name + "_count", name + "_sum")}
    return {"count": rows.get(name + "_count", 0.0),
            "sum": rows.get(name + "_sum", 0.0)}


def planes_outcome(rec: dict) -> dict:
    """The part of a `scenario_planes` record that must equal the JAX
    package's (`chip_smoke.PLANES_REF`): the rows, the episode rules each
    node fired with their severities, on A and B the partition's
    actuator and whether it acted, on every node the sick disk's
    actuator and whether it recorded `would_act`, whether each node
    opened a divergence episode during the cut, and whether each such
    episode dumped its incident. C's partition outcome is
    left out: cut off, its supervisor defers or acts depending on when
    its own health score crosses the bar."""
    fired = {n: {r: s for r, s in rules.items() if r in EPISODES}
             for n, rules in rec["fired"].items()}
    actions = {}
    for n, by_rule in rec["remediation"].items():
        actions[n] = {}
        for rule, (actuator, terminal) in EPISODES.items():
            if rule == "view-divergence" and n == "c":
                continue
            rows = by_rule[rule]
            actions[n][rule] = [sorted({act for act, _m in rows}),
                                any(m == terminal for _a, m in rows)]
    return {"rows_digest": rec["expected_digest"], "rows": rec["rows"],
            "fired": fired, "actions": actions,
            "episode_opened": {n: k >= 1 for n, k in rec["episodes"].items()},
            "incident_per_episode":
                rec["incidents"] == sum(rec["episodes"].values())}


def planes_checks(rec: dict, ref: dict) -> List[str]:
    """What must hold of a `scenario_planes` record: its outcome equals
    `ref`, and the bounds timing decides."""
    bad = []
    got = planes_outcome(rec)
    for key, want in ref.items():
        if got[key] != want:
            bad.append(f"{key}: {got[key]} != {want}")
    if set(rec["rows_digest"]) != {rec["expected_digest"]}:
        bad.append(f"rows digests {rec['rows_digest']}")
    tr = rec["traces"]
    if "error" not in tr["kept_reasons"] or "sick-disk" not in tr["error_chaos"]:
        bad.append(f"no kept trace for the sick disk's errors: {tr}")
    for n, nodes in rec["hotspots"].items():
        if len(nodes) != 3 or not all(nodes.values()):
            bad.append(f"{n}: /v1/profile?scope=cluster hotspots {nodes}")
    if rec["speedscope"]["samples"] <= 0:
        bad.append(f"speedscope document {rec['speedscope']}")
    prof = rec["profile"]
    if not prof["overhead_pct"] < prof["max_overhead_pct"]:
        bad.append(f"profiler overhead {prof['overhead_pct']} % over "
                   f"{prof['max_overhead_pct']} %")
    otlp = rec["otlp"]
    if otlp["exported"] <= 0 or otlp["sink_spans"] != otlp["exported"] \
            or otlp["failures"]:
        bad.append(f"OTLP: {otlp}")
    ts = rec["tsdb"]
    missing = set(ts["rule_inputs"]) - set(ts["in_tsdb"]) \
        - set(ts["never_published"])
    if missing:
        bad.append(f"TSDB lacks the rule inputs {sorted(missing)}")
    lane = rec["c_catch_up_lane"]
    if lane is not None and lane["decided"] == 0:
        bad.append(f"C's catch-up decided no batch on its engine: {lane}")
    return bad
