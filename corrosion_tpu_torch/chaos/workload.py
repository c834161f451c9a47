"""Mixed-workload driver: the production traffic the chaos matrix

The port's copy of `corrosion_tpu/chaos/workload.py`.
measures under.

Four concurrent stages against an N-agent devcluster, all through the
REAL serving surfaces (HTTP API + live subscription streams — never
store-handle shortcuts):

- ``write``  — small INSERT OR REPLACE transactions round-robin over
  the nodes (`/v1/transactions`)
- ``query``  — point SELECTs against random nodes (`/v1/queries`)
- ``subscribe`` — one live subscription per node, counting delivered
  change events (`/v1/subscriptions`; sheds resume via the client's
  changes-log replay)
- ``render`` — template renders (`tpl.py` engine) whose `sql()` calls
  ride `/v1/queries`

Every op runs under a DEADLINE (`op_timeout_secs`): the accounting
distinguishes the four ways a production request can end —

  ok        the cluster served it
  refusal   a TYPED fast no (4xx/503 admission, shed frame): the
            serving plane answered; Prime CCL-style degradation
  error     a fast transport failure (connection refused/reset): a
            node is down, the caller knows immediately
  timeout   the op hit its deadline — the HANG WITNESS.  The scenario
            matrix's standing bar is timeouts == 0: faults may shrink
            `ok`, they must never convert requests into stalls.

``availability`` = (ok + refusals) / attempts — the fraction of
requests the serving plane ANSWERED (a typed shed is an answer; a
hang or dead socket is not).

Client-side op latencies land in `runtime/latency.py` histograms
(p50/p99 per stage); the cluster's own verdict is scraped from the
`/v1/slo` and `/v1/cluster` planes at collection time — the point of
the r11/r12 observatories is that the cluster grades its own scorecard.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import aiohttp

from corrosion_tpu_torch.client import (
    ClientError,
    CorrosionApiClient,
    SubShedError,
)
from corrosion_tpu_torch.net.h2 import StreamReset
from corrosion_tpu_torch.runtime.latency import LatencyHistogram

# transport-level failure set every stage shares: fast, typed-ish,
# retry-able — a downed node's refused connection lands here
_TRANSPORT_ERRORS = (
    aiohttp.ClientError,
    StreamReset,
    ConnectionError,
    OSError,
)

RENDER_TEMPLATE = (
    '<% for row in sql("SELECT id, text FROM tests '
    'ORDER BY id DESC LIMIT 5") %><%= row[0] %>=<%= row[1] %>\n<% end %>'
)


@dataclass
class StageStats:
    attempts: int = 0
    ok: int = 0
    refusals: int = 0
    errors: int = 0
    timeouts: int = 0
    hist: LatencyHistogram = field(default_factory=LatencyHistogram)

    def record(self, outcome: str, secs: Optional[float] = None) -> None:
        self.attempts += 1
        setattr(self, outcome, getattr(self, outcome) + 1)
        if secs is not None and outcome == "ok":
            self.hist.observe(secs)

    @property
    def availability(self) -> float:
        if self.attempts == 0:
            return 1.0
        return (self.ok + self.refusals) / self.attempts

    def report(self) -> dict:
        return {
            "attempts": self.attempts,
            "ok": self.ok,
            "refusals": self.refusals,
            "errors": self.errors,
            "timeouts": self.timeouts,
            "availability": round(self.availability, 4),
            "p50_secs": self.hist.quantile(0.5),
            "p99_secs": self.hist.quantile(0.99),
        }


@dataclass
class WorkloadNode:
    """One target: the agent handle plus its HTTP surface."""

    name: str
    agent: object
    client: CorrosionApiClient
    api_addr: str


class MixedWorkload:
    """Drives all four stages until `stop()`; `summary()` collects the
    client-side stats plus the cluster's own /v1/slo + /v1/cluster
    verdicts.

    `nodes` is a live callable (not a frozen dict): churn scenarios
    restart agents mid-run and the driver must always target the
    harness's CURRENT node set."""

    def __init__(
        self,
        nodes: Callable[[], Dict[str, WorkloadNode]],
        op_timeout_secs: float = 5.0,
        write_period_secs: float = 0.05,
        query_period_secs: float = 0.05,
        render_period_secs: float = 0.25,
        seed: int = 0,
        id_base: int = 0,
    ):
        self.nodes = nodes
        self.op_timeout = op_timeout_secs
        self.write_period = write_period_secs
        self.query_period = query_period_secs
        self.render_period = render_period_secs
        self.rng = random.Random(seed)
        self.stats: Dict[str, StageStats] = {
            s: StageStats() for s in ("write", "query", "subscribe", "render")
        }
        self.events_delivered = 0
        self._tasks: List[asyncio.Task] = []
        self._stopping = asyncio.Event()
        # each run must write FRESH pks: an INSERT OR REPLACE of an
        # identical (pk, value) is a CRDT no-op (no change emitted, no
        # event delivered) — back-to-back scenarios reusing ids would
        # silently zero the subscription stage
        self._next_id = id_base
        self._id_base = id_base
        self._template = None

    # -- one op per stage ---------------------------------------------------

    async def _op(self, stage: str, coro) -> bool:
        """Run one op under the deadline with the shared accounting."""
        st = self.stats[stage]
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(coro, self.op_timeout)
        except asyncio.TimeoutError:
            st.record("timeouts")
            return False
        except SubShedError:
            st.record("refusals")
            return False
        except ClientError as e:
            if 400 <= e.status < 600:
                st.record("refusals")
            else:
                st.record("errors")
            return False
        except _TRANSPORT_ERRORS:
            st.record("errors")
            return False
        st.record("ok", time.monotonic() - t0)
        return True

    def _pick(self) -> Optional[WorkloadNode]:
        nodes = list(self.nodes().values())
        return self.rng.choice(nodes) if nodes else None

    async def _write_loop(self) -> None:
        order = 0
        while not self._stopping.is_set():
            nodes = list(self.nodes().values())
            if nodes:
                node = nodes[order % len(nodes)]
                order += 1
                self._next_id += 1
                k = self._next_id
                await self._op(
                    "write",
                    node.client.execute(
                        [[
                            "INSERT OR REPLACE INTO tests (id, text)"
                            " VALUES (?, ?)",
                            [k, f"w-{node.name}-{k}"],
                        ]]
                    ),
                )
            await asyncio.sleep(self.write_period)

    async def _query_loop(self) -> None:
        while not self._stopping.is_set():
            node = self._pick()
            if node is not None:
                k = self.rng.randint(
                    self._id_base + 1, max(self._id_base + 1, self._next_id)
                )
                await self._op(
                    "query",
                    node.client.query_rows(
                        ["SELECT id, text FROM tests WHERE id = ?", [k]]
                    ),
                )
            await asyncio.sleep(self.query_period)

    async def _subscribe_loop(self, name: str) -> None:
        """One node's live subscription: (re)connect until stopped,
        count delivered change events.  A shed is a typed refusal; a
        transport death is an error; either way the loop reconnects —
        the stream must never wedge the driver."""
        st = self.stats["subscribe"]
        while not self._stopping.is_set():
            node = self.nodes().get(name)
            if node is None:
                await asyncio.sleep(0.1)
                continue
            st.attempts += 1
            t0 = time.monotonic()
            got_any = False
            try:
                stream = node.client.subscribe(
                    "SELECT id, text FROM tests", skip_rows=True
                )
                async for ev in stream:
                    if self._stopping.is_set():
                        break
                    if "change" in ev:
                        self.events_delivered += 1
                        if not got_any:
                            got_any = True
                            st.ok += 1
                            st.hist.observe(time.monotonic() - t0)
            except asyncio.CancelledError:
                if not got_any:
                    # harness shutdown before any event arrived: neither
                    # a success nor a failure — don't skew availability
                    st.attempts -= 1
                raise
            except SubShedError:
                st.refusals += 1
            except ClientError:
                st.refusals += 1
            except asyncio.TimeoutError:
                st.timeouts += 1
            except _TRANSPORT_ERRORS:
                st.errors += 1
            else:
                if not got_any:
                    # stream ended cleanly before any event: neither a
                    # success nor a failure — don't skew availability
                    st.attempts -= 1
            if not got_any and not self._stopping.is_set():
                await asyncio.sleep(0.2)

    async def _render_loop(self) -> None:
        from corrosion_tpu_torch.tpl import TemplateState, compile_template

        if self._template is None:
            self._template = compile_template(RENDER_TEMPLATE)
        loop = asyncio.get_running_loop()
        while not self._stopping.is_set():
            node = self._pick()
            if node is not None:
                state = TemplateState(node.api_addr, None, loop, watch=False)

                async def render(s=state):
                    try:
                        out = await asyncio.to_thread(
                            self._template, s.namespace()
                        )
                        assert isinstance(out, str)
                    finally:
                        await s.close()

                await self._op("render", render())
            await asyncio.sleep(self.render_period)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._stopping.clear()
        self._tasks = [
            asyncio.ensure_future(self._write_loop()),
            asyncio.ensure_future(self._query_loop()),
            asyncio.ensure_future(self._render_loop()),
        ]
        for name in list(self.nodes()):
            self._tasks.append(
                asyncio.ensure_future(self._subscribe_loop(name))
            )

    async def stop(self) -> None:
        self._stopping.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._tasks.clear()

    # -- collection ---------------------------------------------------------

    async def scrape(self, node: WorkloadNode, path: str) -> Optional[dict]:
        """GET a JSON observability plane from one node (the cluster's
        own scorecard: /v1/slo, /v1/cluster, /v1/status)."""
        try:
            session = await node.client._ensure()
            async with session.get(f"{node.client.base}{path}") as resp:
                if resp.status != 200:
                    return None
                return json.loads(await resp.text())
        except _TRANSPORT_ERRORS + (asyncio.TimeoutError, ValueError):
            return None

    async def summary(self, scrape_node: Optional[WorkloadNode] = None) -> dict:
        out = {
            "stages": {s: st.report() for s, st in self.stats.items()},
            "events_delivered": self.events_delivered,
        }
        if scrape_node is not None:
            slo = await self.scrape(scrape_node, "/v1/slo")
            cluster = await self.scrape(scrape_node, "/v1/cluster")
            out["slo"] = _slo_percentiles(slo)
            out["cluster"] = _cluster_digestion(cluster)
        return out


def _slo_percentiles(slo: Optional[dict]) -> Optional[dict]:
    """Per-stage {p50, p99} out of one /v1/slo response (cumulative
    quantiles — scenario runs snapshot-diff at the harness level)."""
    if not slo:
        return None
    stages = {}
    for stage, rec in (slo.get("stages") or {}).items():
        cum = rec.get("cumulative") or {}
        stages[stage] = {
            "p50": cum.get("p50"),
            "p99": cum.get("p99"),
            "count": cum.get("count"),
        }
    return stages


def _cluster_digestion(cluster: Optional[dict]) -> Optional[dict]:
    if not cluster:
        return None
    div = cluster.get("divergence") or {}
    return {
        "nodes_known": (cluster.get("coverage") or {}).get("known"),
        "nodes_fresh": (cluster.get("coverage") or {}).get("fresh"),
        "divergent": div.get("divergent"),
        "view_groups": div.get("groups"),
    }
