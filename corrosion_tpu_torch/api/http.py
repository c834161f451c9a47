"""HTTP server: transactions, queries, migrations, table_stats (+ pubsub
routes once a SubsManager/UpdatesManager is attached).

The port's copy of `corrosion_tpu/api/http.py`. One difference: POST
/v1/queries writes its NDJSON body in pieces of about `QUERY_WRITE_BYTES`
instead of one write per row. The bytes are the same. Each write becomes
one h1 chunk or one h2 DATA frame, and loopback TCP on the H100's host
charges per small write (`chip_smoke.py`'s `host` line; PERF.md §6).

Counterpart of the axum router in `klukai-agent/src/agent/util.rs:181-351`:
  - POST /v1/transactions   (concurrency 128)
  - POST /v1/queries        (streams NDJSON QueryEvents, 128)
  - POST /v1/migrations     (concurrency 4)
  - POST /v1/table_stats    (concurrency 4)
  - POST /v1/subscriptions, GET /v1/subscriptions/{id}
  - POST /v1/updates/{table}
  - GET  /v1/status         (r7: cluster status plane — one JSON
    snapshot of membership census, kernel event telemetry, loop lag and
    sync backlog, read non-mutatingly from the shared registry; the
    machine-readable sibling of /metrics for dashboards and obs_report)
  - GET  /v1/flight         (r8: the flight-recorder timeline plane —
    the last-K per-tick frames stitched from the device rings, the
    tick-RESOLVED sibling of /v1/status's cumulative totals)
  - bearer-token authz middleware (`util.rs:330-351`), load-shed → 503
"""

from __future__ import annotations

import asyncio
import contextlib
import sqlite3
import time
from typing import Any, List, Optional

from aiohttp import web

from corrosion_tpu_torch.agent.handle import Agent
from corrosion_tpu_torch.agent.run import make_broadcastable_changes
from corrosion_tpu_torch.api.types import (
    Statement,
    dump_value,
    ev_columns,
    ev_eoq,
    ev_error,
    ev_row,
    exec_response,
    parse_statement,
)
from corrosion_tpu_torch.runtime.metrics import (
    METRICS,
    kernel_event_totals,
)
from corrosion_tpu_torch.store.schema import SchemaError

# the size of one write of a /v1/queries body (one h2 DATA frame's worth)
QUERY_WRITE_BYTES = 16384


def _held_versions(agent: Agent) -> int:
    """Versions this node holds (the catch-up census's local half) —
    host-state reads only, same contract as the rest of /v1/status."""
    from corrosion_tpu_torch.sync import held_total

    return held_total(agent.bookie)


def _trace_census() -> dict:
    """The /v1/status `traces` block: the JAX package's answer with its
    tail sampler off. The trace store is not ported yet (ROADMAP §1
    item 9.5), and `setup` refuses `trace.enabled`."""
    return {"enabled": False}


class _Limit:
    """Load-shedding concurrency limit: full ⇒ 503 (util.rs:181-328)."""

    def __init__(self, n: int):
        self._sem = asyncio.Semaphore(n)

    async def __aenter__(self):
        if self._sem.locked():
            raise web.HTTPServiceUnavailable(text="overloaded")
        await self._sem.acquire()

    async def __aexit__(self, *exc):
        self._sem.release()


def _profile_census() -> dict:
    """The /v1/status `profile` block: the JAX package's answer with the
    profiler off. The profiler is not ported yet (ROADMAP §1 item 9.5),
    and `setup` refuses `profile.enabled`."""
    return {"enabled": False}


class ApiServer:
    def __init__(self, agent: Agent, subs=None, updates=None):
        self.agent = agent
        self.subs = subs if subs is not None else agent.subs
        self.updates = updates if updates is not None else agent.updates
        self._tx_limit = _Limit(128)
        self._query_limit = _Limit(128)
        self._slow_limit = _Limit(4)
        self._runner: Optional[web.AppRunner] = None
        self.addrs: List[str] = []
        self._fronts: list = []

    def build_app(self) -> web.Application:
        app = web.Application(middlewares=[self._metrics_mw, self._authz])
        app.router.add_post("/v1/transactions", self.h_transactions)
        app.router.add_post("/v1/queries", self.h_queries)
        app.router.add_post("/v1/migrations", self.h_migrations)
        app.router.add_post("/v1/table_stats", self.h_table_stats)
        app.router.add_post("/v1/subscriptions", self.h_subscribe)
        app.router.add_get("/v1/subscriptions/{id}", self.h_subscription_by_id)
        app.router.add_post("/v1/updates/{table}", self.h_updates)
        app.router.add_get("/v1/status", self.h_status)
        app.router.add_get("/v1/flight", self.h_flight)
        app.router.add_get("/v1/slo", self.h_slo)
        app.router.add_get("/v1/cluster", self.h_cluster)
        app.router.add_get("/v1/traces", self.h_traces)
        app.router.add_get("/v1/alerts", self.h_alerts)
        app.router.add_get("/v1/remediation", self.h_remediation)
        app.router.add_get("/v1/profile", self.h_profile)
        return app

    async def start(self) -> None:
        # short shutdown grace: live NDJSON subscription streams otherwise
        # hold the runner open indefinitely on cleanup
        self._runner = web.AppRunner(self.build_app(), shutdown_timeout=2.0)
        await self._runner.setup()
        # the aiohttp app binds one internal loopback port serving the
        # HTTP/1.1 side; every public bind addr gets a dual-protocol
        # front-end (api/h2front.py) — the reference's hyper auto-mode
        # server on one port.  HTTP/2 is served NATIVELY against the
        # same Application (route resolution + middleware chain +
        # streaming responses as h2 frames); only h1 bytes take the
        # loopback pass-through to aiohttp's own parser.
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        internal_port = site._server.sockets[0].getsockname()[1]
        from corrosion_tpu_torch.api.h2front import ApiFrontend

        for bind in self.agent.config.api.bind_addr:
            host, _, port = bind.rpartition(":")
            front = ApiFrontend(
                "127.0.0.1", internal_port,
                host=host or "127.0.0.1", port=int(port),
                app=self._runner.app,
            )
            await front.start()
            self._fronts.append(front)
            self.addrs.extend(front.addrs)

    async def stop(self) -> None:
        # end live subscription/update streams first (their handlers block
        # on queue.get() until a None sentinel arrives), then tear down
        if self.subs is not None:
            await self.subs.stop_all()
        if self.updates is not None:
            await self.updates.stop_all()
        for front in self._fronts:
            await front.stop()
        self._fronts.clear()
        if self._runner is not None:
            await self._runner.cleanup()

    # -- middleware --------------------------------------------------------

    @web.middleware
    async def _metrics_mw(self, request: web.Request, handler):
        """Per-endpoint request counters + latency histograms (the
        reference exports these via axum/metrics middleware)."""
        start = time.monotonic()
        # canonical route template, NOT the raw path: parameterized
        # routes (/v1/subscriptions/{id}) and unauthenticated path spray
        # must not mint unbounded metric label values
        resource = request.match_info.route.resource if request.match_info else None
        endpoint = resource.canonical if resource is not None else "unmatched"
        # BaseException default: a handler cancelled mid-request (agent
        # restart under churn — the r18 chaos matrix's churn-storm
        # scenario found this) produces NO response and NO Exception,
        # and an unbound `status` here turned the clean CancelledError
        # into an UnboundLocalError in the finally
        status: object = "cancelled"
        try:
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        except Exception:
            status = 500
            raise
        finally:
            METRICS.counter(
                "corro.api.requests", endpoint=endpoint, status=str(status)
            ).inc()
            METRICS.histogram(
                "corro.api.request.seconds", endpoint=endpoint
            ).observe(time.monotonic() - start)

    @web.middleware
    async def _authz(self, request: web.Request, handler):
        expected = self.agent.config.api.authz_bearer
        if expected:
            got = request.headers.get("Authorization", "")
            if got != f"Bearer {expected}":
                raise web.HTTPUnauthorized(text="invalid bearer token")
        return await handler(request)

    # -- handlers ----------------------------------------------------------

    @staticmethod
    def _timeout_param(request: web.Request) -> Optional[float]:
        """`?timeout=<seconds>` (TimeoutParams, api/public/mod.rs:203,525):
        bounds statement runtime; overruns are interrupted server-side."""
        raw = request.query.get("timeout")
        if raw is None:
            return None
        try:
            t = float(raw)
        except ValueError:
            return None
        return t if t > 0 else None

    async def h_transactions(self, request: web.Request) -> web.Response:
        async with self._tx_limit:
            start = time.monotonic()
            timeout = self._timeout_param(request)
            try:
                body = await request.json()
                stmts = [parse_statement(s) for s in body]
            except (ValueError, TypeError) as e:
                return web.json_response(
                    {"results": [{"error": str(e)}], "time": 0.0},
                    status=400,
                )

            results: List[dict] = []

            def apply(tx) -> List[Any]:
                # overrunning statements are interrupted via the store
                # watchdog (InterruptibleTransaction analog) and surface
                # as an 'interrupted' sqlite error → 400
                guard = (
                    self.agent.store.interrupt_after(timeout)
                    if timeout
                    else contextlib.nullcontext()
                )
                out = []
                with guard:
                    for stmt in stmts:
                        t0 = time.monotonic()
                        n = _execute_stmt(tx, stmt)
                        out.append(
                            {
                                "rows_affected": n,
                                "time": time.monotonic() - t0,
                            }
                        )
                return out

            try:
                res = await make_broadcastable_changes(self.agent, apply)
            except sqlite3.Error as e:
                return web.json_response(
                    {"results": [{"error": str(e)}], "time": 0.0},
                    status=400,
                )
            results = res.results
            return web.json_response(
                exec_response(
                    results,
                    time.monotonic() - start,
                    res.version or None,
                    str(self.agent.actor_id),
                )
            )

    async def h_queries(self, request: web.Request) -> web.StreamResponse:
        async with self._query_limit:
            timeout = self._timeout_param(request)
            try:
                stmt = parse_statement(await request.json())
            except (ValueError, TypeError) as e:
                return web.json_response({"error": str(e)}, status=400)

            resp = web.StreamResponse(
                headers={"content-type": "application/x-ndjson"}
            )
            await resp.prepare(request)
            start = time.monotonic()
            loop = asyncio.get_running_loop()

            def run_query():
                import threading

                from corrosion_tpu_torch.runtime.trace import timed_query

                with self.agent.store.pooled_read() as conn:
                    # ?timeout= interrupt (mod.rs:336: "sql call took more
                    # than {timeout}, interrupting"). disarm-before-fire
                    # is lock-checked so a timer firing as the query
                    # finishes can never interrupt the pool's NEXT user.
                    lk, live = threading.Lock(), [True]
                    timer = None
                    if timeout:
                        def fire():
                            with lk:
                                if live[0]:
                                    conn.interrupt()
                        timer = threading.Timer(timeout, fire)
                        timer.daemon = True
                        timer.start()
                    try:
                        with timed_query(stmt.query, shape="query:api"):
                            cur = conn.execute(
                                stmt.query, _bind_params(stmt)
                            )
                        cols = (
                            [d[0] for d in cur.description]
                            if cur.description
                            else []
                        )
                        rows = cur.fetchall()
                        return cols, rows
                    finally:
                        with lk:
                            live[0] = False
                        if timer is not None:
                            timer.cancel()

            try:
                cols, rows = await loop.run_in_executor(None, run_query)
                METRICS.counter("corro.api.queries.count").inc()
                METRICS.histogram(
                    "corro.api.queries.processing.time.seconds"
                ).observe(time.monotonic() - start)
                lines = [ev_columns(cols) + "\n"]
                size = len(lines[0])
                for i, row in enumerate(rows):
                    line = ev_row(i + 1, [row[k] for k in row.keys()]) + "\n"
                    lines.append(line)
                    size += len(line)
                    if size >= QUERY_WRITE_BYTES:
                        await resp.write("".join(lines).encode())
                        lines, size = [], 0
                lines.append(ev_eoq(time.monotonic() - start) + "\n")
                await resp.write("".join(lines).encode())
            except sqlite3.Error as e:
                await resp.write((ev_error(str(e)) + "\n").encode())
            await resp.write_eof()
            return resp

    async def h_migrations(self, request: web.Request) -> web.Response:
        async with self._slow_limit:
            start = time.monotonic()
            try:
                body = await request.json()
                sql = "\n".join(body) if isinstance(body, list) else str(body)
            except ValueError as e:
                return web.json_response(
                    {"results": [{"error": str(e)}], "time": 0.0}, status=400
                )

            def apply():
                self.agent.store.apply_schema_sql(sql)

            try:
                async with self.agent.write_gate.priority():
                    await asyncio.get_running_loop().run_in_executor(
                        None, apply
                    )
            except (SchemaError, sqlite3.Error) as e:
                return web.json_response(
                    {"results": [{"error": str(e)}], "time": 0.0}, status=400
                )
            return web.json_response(
                exec_response(
                    [{"rows_affected": 0, "time": 0.0}],
                    time.monotonic() - start,
                    None,
                    str(self.agent.actor_id),
                )
            )

    async def h_table_stats(self, request: web.Request) -> web.Response:
        async with self._slow_limit:
            try:
                body = await request.json()
                tables = body.get("tables") if isinstance(body, dict) else None
            except ValueError:
                tables = None
            if not tables:
                tables = list(self.agent.store.schema.tables)

            def stats():
                with self.agent.store.pooled_read() as conn:
                    total = 0
                    invalid = []
                    for t in tables:
                        if t not in self.agent.store.schema.tables:
                            continue
                        n = conn.execute(
                            f'SELECT COUNT(*) AS n FROM "{t}"'
                        ).fetchone()["n"]
                        total += n
                        clock_n = conn.execute(
                            "SELECT COUNT(DISTINCT pk) AS n FROM"
                            f' "{t}__crdt_clock"'
                        ).fetchone()["n"]
                        if clock_n > n:
                            invalid.append(t)
                    return total, invalid

            total, invalid = await asyncio.get_running_loop().run_in_executor(
                None, stats
            )
            return web.json_response(
                {"total_row_count": total, "invalid_tables": invalid}
            )

    async def h_status(self, request: web.Request) -> web.Response:
        """Cluster status plane: one JSON snapshot of what an operator
        asks first — who is in the cluster, what the kernels did, is the
        event loop healthy, is sync keeping up.  Every value is either
        host state readable without I/O or a non-mutating registry peek
        (`Registry.snapshot`), so the endpoint is safe to poll."""
        agent = self.agent
        from corrosion_tpu_torch.agent.membership import MemberState

        by_state = {s.name: 0 for s in MemberState}
        # worker-thread rule from agent_metrics.collect_once: copy the
        # dict under the GIL before iterating
        for m in list(agent.membership.members.values()):
            by_state[m.state.name] = by_state.get(m.state.name, 0) + 1

        # one registry pass feeds every metric-derived field below
        snap = METRICS.snapshot()

        def peek(name: str, default: float = 0.0, **labels) -> float:
            for _kind, sname, slabels, value in snap:
                if sname == name and slabels == labels:
                    return value
            return default

        phase_seconds: dict = {}
        for kind, name, labels, value in snap:
            if kind == "gauge" and name == "corro.kernel.phase.seconds":
                phase_seconds.setdefault(labels.get("kernel", "?"), {})[
                    labels.get("phase", "?")
                ] = value

        # r9 Lifeguard census: local health + open-suspicion pressure —
        # the host-side mirror of the kernels' lhm_max /
        # suspicion_confirmations flight lanes
        suspects = [
            m for m in list(agent.membership.members.values())
            if m.state == MemberState.SUSPECT
        ]
        # r18 chaos census: the drill-vs-outage discriminator — elevated
        # p99s WITH a populated chaos block is an exercise, not a page
        from corrosion_tpu_torch.chaos.faults import CENSUS as CHAOS_CENSUS

        status = {
            "actor_id": str(agent.actor_id),
            "chaos": CHAOS_CENSUS.snapshot(),
            "cluster": {
                "size": agent.membership.cluster_size,
                "member_states": by_state,
                "members_tracked": len(agent.members.states),
                "bookie_actors": len(agent.bookie.items()),
                "lifeguard": {
                    "enabled": agent.membership.config.lifeguard,
                    "lhm": agent.membership.lhm,
                    "multiplier": agent.membership.lhm_multiplier,
                    "open_suspects": len(suspects),
                    "suspicion_confirmations": sum(
                        len(m.suspectors) for m in suspects
                    ),
                },
            },
            "kernel_events": kernel_event_totals(METRICS),
            "kernel_phase_seconds": phase_seconds,
            # r10 subscription serving plane: how many live queries, how
            # the change router is spending the write path, and whether
            # the shared diff executor is backing up (depth > workers =
            # matchers queueing for a diff slot)
            "subscriptions": {
                # r12: the matcher's candidate-batching window — the
                # knob the SLO plane named as the match-stage p50 floor
                "candidate_batch_wait": agent.config.pubsub.candidate_batch_wait,
                "count": len(self.subs.handles()) if self.subs else 0,
                "streams": self.subs.stream_count() if self.subs else 0,
                # r16 serving-plane asymptote census: admission ceiling,
                # laggard sheds, dedupe pressure and the shared writer's
                # coalescing behavior — the numbers that say whether the
                # node is at its stream ceiling and who is paying for it
                "max_streams": agent.config.subs.max_streams,
                "admission_rejected": peek(
                    "corro.subs.admission.rejected.total"
                ),
                "shed": peek("corro.subs.shed.total"),
                "dedupe_hits": peek("corro.subs.dedupe.hits.total"),
                "writer_writes": peek("corro.subs.writer.writes.total"),
                "writer_coalesced_batches": peek(
                    "corro.subs.writer.coalesced.batches.total"
                ),
                "writer_clogged": peek("corro.subs.writer.clogged"),
                "router_tables": peek("corro.subs.router.tables"),
                "router_changes": peek("corro.subs.router.changes.total"),
                "router_matched": peek("corro.subs.router.matched.total"),
                "router_fanout": peek("corro.subs.router.fanout.total"),
                "executor_depth": peek("corro.subs.executor.depth"),
                "executor_submitted": peek(
                    "corro.subs.executor.submitted.total"
                ),
            },
            # r15 direct change capture: how local writes are being
            # captured (direct in-memory vs trigger fallback) — a
            # rising `fallback` means hot statements carry bound
            # values outside the provably-identical set, a rising
            # `trigger` means raw/unrecognized SQL on the write path
            "write_capture": {
                "enabled": agent.config.perf.direct_capture,
                "direct": peek("corro.write.capture.direct.total"),
                "trigger": peek("corro.write.capture.trigger.total"),
                "fallback": peek("corro.write.capture.fallback.total"),
            },
            # r19 trace census: is the tail sampler on, how full is the
            # in-flight buffer, how many traces were kept vs dropped
            # (full kept traces live at GET /v1/traces)
            "traces": _trace_census(),
            # r20 alerts census: which rules are firing/pending right
            # now and how sick this node judges itself (full lifecycle
            # rows + history live at GET /v1/alerts)
            # (the alert plane is not ported yet, ROADMAP §1 item 9.5:
            # the JAX package's block with it off)
            "alerts": {"enabled": False},
            # r22 remediation census: is the plane armed (vs observe-
            # only) and what it has done (full actuator table + typed
            # action history live at GET /v1/remediation)
            # (not ported yet, ROADMAP §1 item 9.5: the JAX package's
            # block with the plane off)
            "remediation": {"enabled": False},
            # r23 continuous-profiling census: sampler rate/shed state,
            # measured overhead, held windows (flamegraphs live at
            # GET /v1/profile)
            "profile": _profile_census(),
            # r11 SLO plane pointer: the canary's live numbers (full
            # per-stage percentiles live at GET /v1/slo)
            "slo": {
                "canary_enabled": agent.config.slo.canary,
                "canary_writes": peek("corro.slo.canary.writes.total"),
                "canary_missed": peek("corro.slo.canary.missed.total"),
                "canary_last_seconds": peek(
                    "corro.slo.canary.last.seconds"
                ),
            },
            "loop": {
                "lag_max_seconds": peek(
                    "corro.runtime.loop.lag.max.seconds"
                ),
                "tasks_alive": peek("corro.runtime.loop.tasks.alive"),
                "monitor_ticks": peek("corro.runtime.loop.ticks"),
            },
            "sync": {
                "changes_in_queue": peek("corro.agent.changes.in_queue"),
                "gaps": peek("corro.db.gaps.count"),
                "gap_versions": peek("corro.db.gaps.versions"),
                "buffered_change_versions": peek(
                    "corro.db.buffered_changes.versions"
                ),
                "client_rounds": peek("corro.sync.client.rounds"),
                "server_permits_available": getattr(
                    agent.sync_serve_sem, "_value", 0
                ),
                # r17 catch-up plane census: is this node (or anyone
                # pulling from it) catching up, how, and is the
                # fault-tolerance machinery engaging — the one block an
                # operator reads during a cold-node join or post-
                # partition repair
                "catchup": {
                    "snapshot_enabled": agent.config.sync.snapshot,
                    "bootstrap": dict(agent.catchup_census),
                    "held_versions": _held_versions(agent),
                    "resume_waves": peek("corro.sync.resume.waves.total"),
                    "resume_versions": peek(
                        "corro.sync.resume.versions.total"
                    ),
                    "circuits_open": sum(
                        1
                        for c in agent.sync_circuits.values()
                        if not c.allows(time.monotonic())
                    ),
                    "snapshot_installs": peek("corro.snapshot.install.total"),
                    "snapshot_serves": peek("corro.snapshot.serve.total"),
                    "snapshot_cache_age_secs": (
                        round(agent.snapshots.age(), 3)
                        if agent.snapshots is not None
                        and agent.snapshots.age() is not None
                        else None
                    ),
                    "snapshot_cache_bytes": (
                        agent.snapshots.compressed_bytes
                        if agent.snapshots is not None
                        else 0
                    ),
                },
            },
        }
        return web.json_response(status)

    async def h_flight(self, request: web.Request) -> web.Response:
        """Flight-recorder timeline plane: the last-K per-tick frames
        (`?window=K`, default 64, capped at the recorder's capacity;
        `?kernel=` filters one kernel's timeline).  Each frame is one
        protocol period: event DELTAS + census levels, wall-clock
        stamped at drain — where /v1/status answers "how much, total",
        this answers "when" (the distinction a convergence-stall
        post-mortem actually needs)."""
        from corrosion_tpu_torch.runtime.metrics import FLIGHT_CENSUS, KERNEL_EVENTS
        from corrosion_tpu_torch.runtime.records import FLIGHT

        try:
            window = int(request.query.get("window", "64"))
        except ValueError:
            raise web.HTTPBadRequest(text="window must be an integer")
        kernel = request.query.get("kernel") or None
        frames = FLIGHT.window(max(1, min(window, 4096)), kernel=kernel)
        return web.json_response(
            {
                "window": len(frames),
                "event_lanes": list(KERNEL_EVENTS),
                "census_lanes": list(FLIGHT_CENSUS),
                "frames": frames,
            }
        )

    async def h_slo(self, request: web.Request) -> web.Response:
        """SLO latency plane (r11): per-stage windowed p50/p90/p99/p999
        of the write→event path (`corro.e2e.*`), cumulative percentiles,
        the configured targets, and error-budget burn per stage — the
        question every perf round is judged by ("what is p99 write→event
        latency right now"), answered from the log-bucketed windowed
        histograms without a sorted-array pass.  `?window=K` overrides
        the sliding window (seconds).  Checking ALSO advances the
        breach tracker: a sustained breach trips a flight-recorder
        incident dump, so polling this endpoint (or running the canary)
        is what arms the black box."""
        from corrosion_tpu_torch.runtime.latency import SloMonitor

        agent = self.agent
        window: Optional[float] = None
        raw = request.query.get("window")
        if raw is not None:
            try:
                window = float(raw)
            except ValueError:
                raise web.HTTPBadRequest(text="window must be a number")
            if window <= 0:
                raise web.HTTPBadRequest(text="window must be positive")
        slo = agent.slo
        if slo is None:  # agents assembled without setup() (tests)
            slo = agent.slo = SloMonitor(targets=agent.config.slo.targets)
        stages = slo.check(window_secs=window)

        # r19 exemplars: each stage row names the kept traces whose
        # worst span of THAT stage is slowest. The trace store is not
        # ported yet (ROADMAP §1 item 9.5): no trace is kept, as in the
        # JAX package with its tail sampler off
        for row in stages.values():
            row["slowest_trace_ids"] = []

        snap = METRICS.snapshot()

        def peek(name: str, default: float = 0.0, **labels) -> float:
            for _kind, sname, slabels, value in snap:
                if sname == name and slabels == labels:
                    return value
            return default

        skew = {
            labels["stage"]: value
            for _k, name, labels, value in snap
            if name == "corro.e2e.skew.clamped.total" and "stage" in labels
        }
        return web.json_response(
            {
                "actor_id": str(agent.actor_id),
                "window_secs": window
                if window is not None
                else slo.window_secs,
                "objective": slo.objective,
                "stages": stages,
                "skew_clamped": skew,
                "canary": {
                    "enabled": agent.config.slo.canary,
                    "writes": peek("corro.slo.canary.writes.total"),
                    "missed": peek("corro.slo.canary.missed.total"),
                    "last_seconds": peek("corro.slo.canary.last.seconds"),
                    "observed": peek(
                        "corro.e2e.canary.seconds_count", scope="local"
                    )
                    + peek("corro.e2e.canary.seconds_count", scope="remote"),
                },
            }
        )

    async def h_traces(self, request: web.Request) -> web.Response:
        """End-to-end write-trace plane (r19): the slowest-N KEPT traces
        from the tail sampler — each one write's full
        write→broadcast→apply→match→deliver causality with a per-stage
        breakdown, the keep reason (error / forced / slo:<stage> /
        lottery), the actors it crossed, and whether a chaos injection
        was live at capture.  Where /v1/slo answers "which stage is
        slow in aggregate", this answers "which WRITE, through which
        nodes, stalled where".  Filters: `?n=` (default 20),
        `?stage=`, `?actor=`, `?table=`; `?spans=0` drops the
        per-span rows for compact dashboards."""
        # the trace plane is not ported yet (ROADMAP §1 item 9.5): the
        # JAX package's answer with its tail sampler off
        return web.json_response(
            {
                "actor_id": str(self.agent.actor_id),
                "census": {"enabled": False},
                "traces": [],
            }
        )

    async def h_alerts(self, request: web.Request) -> web.Response:
        """Alerting plane (r20): the typed, lifecycle-tracked alerts
        the `[alerts]` rules raised over the metrics TSDB.  Default
        scope serves THIS node's engine (rule states, active alerts
        with drill marks / exemplar trace ids / incident paths, and
        the transition history; `?history=0` trims it);
        `?scope=cluster` serves every node's digest-carried active
        alerts plus a per-rule rollup — from ANY single node, over the
        observatory's anti-entropy store."""
        if request.query.get("scope") == "cluster":
            obs = self.agent.observatory
            if obs is None:
                raise web.HTTPNotImplemented(
                    text="cluster observatory disabled "
                         "([cluster] digests=false)"
                )
            return web.json_response(obs.cluster_alerts())
        # the alert plane is not ported yet (ROADMAP §1 item 9.5):
        # `agent.alerts` stays None, and the answer is the JAX package's
        # with the plane off
        return web.json_response({"enabled": False, "rules": [], "active": []})

    async def h_remediation(self, request: web.Request) -> web.Response:
        """Remediation plane (r22): the actuator census (alert rule →
        action → cooldown → revert, with live cooldown remainders) and
        the typed action history — every acted / would_act / deferred /
        refused / reverted decision with its wall stamp, drill mark and
        detail.  `?history=0` trims the history."""
        # the remediation plane is not ported yet (ROADMAP §1 item 9.5):
        # `agent.remediation` stays None, and the answer is the JAX
        # package's with the plane off
        return web.json_response(
            {"enabled": False, "actuators": [], "history": []}
        )

    async def h_profile(self, request: web.Request) -> web.Response:
        """Continuous profiling plane (r23): the always-on wall-clock
        stack sampler's folded output.  `?window=` bounds the lookback
        in seconds (default 60); `?format=folded` serves the collapsed-
        stack text every flamegraph tool ingests, `?format=speedscope`
        a speedscope.app document, default JSON a summary (top self-time
        frames, statement-shape table, overhead gauge, census).
        `?scope=cluster` serves the digest-carried per-node hotspot
        rollup — any node answers for the whole cluster."""
        if request.query.get("scope") == "cluster":
            obs = self.agent.observatory
            if obs is None:
                raise web.HTTPNotImplemented(
                    text="cluster observatory disabled "
                         "([cluster] digests=false)"
                )
            # no profiler runs (ROADMAP §1 item 9.5), so every digest's
            # hotspot block is empty, as a JAX node's is with it off
            return web.json_response(obs.cluster_hotspots())
        # the profiler is not ported yet (ROADMAP §1 item 9.5): the JAX
        # package's answer with it off
        return web.json_response({"enabled": False})

    async def h_cluster(self, request: web.Request) -> web.Response:
        """Cluster observatory plane (r12): the CLUSTER-wide answer any
        single node can serve — digest coverage/staleness per node,
        per-node health roll-up (census, LHM, loop lag, sync backlog),
        exact cluster-merged write→event stage percentiles (the gossiped
        digests carry mergeable histograms), and the view-divergence
        verdict.  Serving rebuilds the local digest and runs one
        divergence check, so polling this endpoint also advances
        detection — same discipline as /v1/slo's breach tracker."""
        obs = self.agent.observatory
        if obs is None:
            raise web.HTTPNotImplemented(
                text="cluster observatory disabled ([cluster] digests=false)"
            )
        return web.json_response(obs.cluster_report())

    # -- pubsub routes (wired when managers are attached) ------------------

    async def h_subscribe(self, request: web.Request) -> web.StreamResponse:
        if self.subs is None:
            raise web.HTTPNotImplemented(text="subscriptions not enabled")
        from corrosion_tpu_torch.api.pubsub_http import handle_subscribe

        return await handle_subscribe(self, request)

    async def h_subscription_by_id(
        self, request: web.Request
    ) -> web.StreamResponse:
        if self.subs is None:
            raise web.HTTPNotImplemented(text="subscriptions not enabled")
        from corrosion_tpu_torch.api.pubsub_http import handle_subscription_by_id

        return await handle_subscription_by_id(self, request)

    async def h_updates(self, request: web.Request) -> web.StreamResponse:
        if self.updates is None:
            raise web.HTTPNotImplemented(text="updates not enabled")
        from corrosion_tpu_torch.api.pubsub_http import handle_updates

        return await handle_updates(self, request)


def _bind_params(stmt: Statement):
    if stmt.named_params:
        return {k.lstrip(":@$"): v for k, v in stmt.named_params.items()}
    return tuple(stmt.params)


def _execute_stmt(tx, stmt: Statement) -> int:
    # both paths go through WriteTx.execute: one trace/timing point and
    # one faithful rows_affected mapping (DML counts pass through, -1
    # row-less statement classes report 0)
    if stmt.named_params:
        return tx.execute(
            stmt.query,
            {k.lstrip(":@$"): v for k, v in stmt.named_params.items()},
        )
    return tx.execute(stmt.query, stmt.params)
