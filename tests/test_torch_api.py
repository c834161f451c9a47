"""The port's public API (`api/http.py`, `api/h2front.py`, the HTTP
handlers of `api/pubsub_http.py`), its client (`client.py`), the chaos
census (`chaos/faults.py`) and `pubsub_bench.py` against the JAX
package's on the CPU.

One JAX agent with the JAX `ApiServer` and one port agent with the
port's, both on the in-memory network with the same seed, take the same
client calls: the JSON bodies of transactions, queries, migrations,
table_stats, `/v1/status` (volatile fields masked: `STATUS_MASKED`), the
plane-off endpoints and `/v1/flight` must be equal, and the NDJSON lines
of subscription and updates streams equal with ids and timestamps
masked, through `from=` replay, `skip_rows` and the admission 503. Each
package's client talks to the other's server. A `StoreFaults` busy or
commit fault surfaces as the same typed error in both stores. The
subscription shutdown race (`tests/test_chaos.py::
test_client_restart_surfaces_typed_error_not_hang`'s sequence) runs 20
times on the port with every await bounded. `agent_checks.scenario_api`
over plaintext QUIC at 400 rows gives the JAX package's outcome, and
one `pubsub_bench` rung delivers the JAX script's event counts.

    JAX_PLATFORMS=cpu python -m tests.test_torch_api --ref

prints `chip_smoke.API_REF`, the JAX package's `scenario_api` at the chip
phase's size (`agent_checks.CHIP_NET`) over QUIC (about a minute).
"""

import asyncio
import contextlib
import importlib.util
import json
import sqlite3
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import aiohttp
import pytest

from corrosion_tpu.api import http as jhttp
from corrosion_tpu.chaos import faults as jfaults
from corrosion_tpu.client import ClientError as JClientError
from corrosion_tpu.client import CorrosionApiClient as JClient
from corrosion_tpu.net.h2 import StreamReset as JStreamReset
from corrosion_tpu.runtime import profiler as jprofiler
from corrosion_tpu.runtime import records as jrecords
from corrosion_tpu.runtime import tracestore as jtracestore
from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import pubsub_bench as tbench
from corrosion_tpu_torch.chaos import faults as tfaults
from corrosion_tpu_torch.client import ClientError as TClientError
from corrosion_tpu_torch.client import CorrosionApiClient as TClient
from corrosion_tpu_torch.runtime import records as trecords

from tests.test_torch_agent import jax_api

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0
IO_S = 10.0  # one socket await


def jax_http_api() -> SimpleNamespace:
    """`jax_api()` with the JAX package's API server and client."""
    api = jax_api()
    api.ApiServer, api.CorrosionApiClient = jhttp.ApiServer, JClient
    api.ClientError, api.StreamReset = JClientError, JStreamReset
    return api


PKGS = {
    "jax": SimpleNamespace(name="jax", api=jax_http_api, engine="python",
                           faults=jfaults, flight=jrecords.FLIGHT),
    "port": SimpleNamespace(name="port", api=lambda: ac.port_api("cpu"),
                            engine="array", faults=tfaults,
                            flight=trecords.FLIGHT),
}


def _run(coro, timeout: float = TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@contextlib.asynccontextmanager
async def _served(pkg, tmp: Path, addr: str, seed: int = 23, net=None):
    """One agent of `pkg` on the in-memory network with its API server
    and an h2 client of the same package."""
    api = pkg.api()
    net = net if net is not None else api.MemNetwork(seed=seed)
    d = tmp / f"{pkg.name}-{addr}"
    d.mkdir(parents=True, exist_ok=True)
    agent, server, client = await asyncio.wait_for(
        ac.boot_with_api(api, net, addr, str(d)), TIMEOUT_S)
    try:
        yield SimpleNamespace(api=api, agent=agent, server=server,
                              client=client, net=net)
    finally:
        await asyncio.wait_for(client.close(), IO_S)
        await asyncio.wait_for(server.stop(), IO_S)
        await asyncio.wait_for(api.shutdown(agent), TIMEOUT_S)


@pytest.fixture
def planes_off(monkeypatch):
    """The JAX package's trace store and profiler are process-global:
    another test in this process may have installed them. These agents
    run with both planes off, as a fresh process has them."""
    monkeypatch.setattr(jtracestore, "_STORE", None)
    monkeypatch.setattr(jprofiler, "_PROFILER", None)


async def _request(client, method: str, path: str, body=None):
    """(status, parsed body or text) of one call on the client's h2
    session, bounded."""
    session = await client._ensure()
    ctx = (session.post(f"{client.base}{path}", json=body)
           if method == "POST" else session.get(f"{client.base}{path}"))

    async def go():
        async with ctx as resp:
            text = await resp.text()
            try:
                return resp.status, json.loads(text)
            except json.JSONDecodeError:
                pass
            try:  # NDJSON
                return resp.status, [json.loads(x) for x in text.splitlines()
                                     if x.strip()]
            except json.JSONDecodeError:
                return resp.status, text
    return await asyncio.wait_for(go(), IO_S)


# /v1/status fields masked in the comparison: `actor_id`, and every value
# read from the process-global metrics registry (each package has its
# own, and earlier tests in the process have counted into it). Their
# keys are still compared.
STATUS_MASKED = (
    "actor_id", "kernel_events", "kernel_phase_seconds",
    "subscriptions.admission_rejected", "subscriptions.shed",
    "subscriptions.dedupe_hits", "subscriptions.writer_writes",
    "subscriptions.writer_coalesced_batches", "subscriptions.writer_clogged",
    "subscriptions.router_tables", "subscriptions.router_changes",
    "subscriptions.router_matched", "subscriptions.router_fanout",
    "subscriptions.executor_depth", "subscriptions.executor_submitted",
    "write_capture.direct", "write_capture.trigger", "write_capture.fallback",
    "slo.canary_writes", "slo.canary_missed", "slo.canary_last_seconds",
    "loop.lag_max_seconds", "loop.tasks_alive", "loop.monitor_ticks",
    "sync.changes_in_queue", "sync.gaps", "sync.gap_versions",
    "sync.buffered_change_versions", "sync.client_rounds",
    "sync.catchup.resume_waves", "sync.catchup.resume_versions",
    "sync.catchup.snapshot_installs", "sync.catchup.snapshot_serves",
)


def _mask(obj, paths, prefix=""):
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        path = f"{prefix}{k}"
        out[k] = "<masked>" if path in paths else _mask(v, paths, path + ".")
    return out


def _mask_times(obj):
    """`time` of exec responses and eoq frames (a wall clock) and
    `actor_id` (each agent's random id)."""
    if isinstance(obj, dict):
        return {k: (f"<{k}>" if k in ("time", "actor_id")
                    else _mask_times(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_times(v) for v in obj]
    return obj


async def _api_calls(srv, flight) -> list:
    """The same client calls on one package's server; what each answered
    (times masked: the walls of the calls)."""
    client, out = srv.client, []

    async def call(method, path, body=None):
        code, got = await _request(client, method, path, body)
        out.append([method, path, code, _mask_times(got)])

    await call("POST", "/v1/migrations", [
        ac.TEST_SCHEMA,
        "CREATE TABLE kv (k TEXT NOT NULL PRIMARY KEY, v INTEGER);"])
    await call("POST", "/v1/migrations", ["CREATE TABLE broken ("])
    await call("POST", "/v1/transactions", [
        ["INSERT INTO tests (id, text) VALUES (?, ?)", [1, "one"]],
        ["INSERT INTO tests (id, text) VALUES (?, ?)", [2, "two"]],
        {"query": "INSERT INTO kv (k, v) VALUES (:k, :v)",
         "named_params": {"k": "a", "v": 7}},
        "UPDATE tests SET text = 'uno' WHERE id = 1",
    ])
    await call("POST", "/v1/transactions",
               [["INSERT INTO nope (x) VALUES (?)", [1]]])
    await call("POST", "/v1/transactions", {"not": "a list"})
    await call("POST", "/v1/transactions", [
        ["DELETE FROM tests WHERE id = ?", [2]],
        ["INSERT INTO kv (k, v) VALUES (?, ?)", ["b", None]]])
    await call("POST", "/v1/queries",
               ["SELECT id, text FROM tests ORDER BY id", []])
    await call("POST", "/v1/queries", "SELECT k, v FROM kv ORDER BY k")
    await call("POST", "/v1/queries", "SELECT * FROM missing_table")
    await call("POST", "/v1/queries?timeout=5", ["SELECT ?1 + 1", [41]])
    await call("POST", "/v1/table_stats", {"tables": ["tests", "kv"]})
    await call("POST", "/v1/table_stats", {})
    for path in ("/v1/traces", "/v1/alerts", "/v1/remediation",
                 "/v1/profile", "/v1/profile?format=folded",
                 "/v1/flight?window=x"):
        await call("GET", path)
    # the cluster views: their keys, and the one node's rollup and
    # coverage (its digest's ages are walls)
    for path in ("/v1/alerts?scope=cluster", "/v1/profile?scope=cluster",
                 "/v1/cluster"):
        code, got = await _request(client, "GET", path)
        out.append(["GET", path, code, sorted(got), got.get("rollup"),
                    got.get("coverage") if "scope" in got else None])
    # three frames of a kernel no test publishes, then the window
    kernel = f"api-test-{srv.api.name}"
    for i in range(3):
        flight.record_host_frame(kernel, {"decided": i, "declined": 0})
    code, got = await _request(client, "GET",
                               f"/v1/flight?window=2&kernel={kernel}")
    for f in got["frames"]:
        f["wall"], f["kernel"] = "<wall>", "<kernel>"
    out.append(["GET", "/v1/flight", code, got])
    code, status = await _request(client, "GET", "/v1/status")
    out.append(["GET", "/v1/status", code,
                _mask(status, set(STATUS_MASKED))])
    return out


def test_api_bodies_equal_jax(tmp_path, planes_off):
    """A JAX agent with the JAX `ApiServer` and a port agent with the
    port's take the same calls: every body is equal, `/v1/status` with
    `STATUS_MASKED` masked."""
    got = {}
    for name, pkg in PKGS.items():
        async def main(pkg=pkg):
            async with _served(pkg, tmp_path, "api-a") as srv:
                return await _api_calls(srv, pkg.flight)
        with cb.engine_env(pkg.engine):
            got[name] = _run(main())
    for want, have in zip(got["jax"], got["port"]):
        assert have == want, want[:2]
    assert len(got["port"]) == len(got["jax"]) == 23
    codes = {tuple(c[:2]): c[2] for c in got["port"]}
    assert codes[("POST", "/v1/migrations")] == 400  # the last one: broken
    assert codes[("GET", "/v1/flight?window=x")] == 400
    status = got["port"][-1][3]
    assert status["chaos"]["active"] is False
    assert status["traces"] == status["profile"] == {"enabled": False}


def _mask_line(line: str) -> str:
    ev = json.loads(line)
    if "eoq" in ev:
        ev["eoq"]["time"] = "<t>"
    return json.dumps(ev, sort_keys=True)


async def _lines_until(it, n: int, kind: str) -> list:
    """The next lines of a raw stream until `n` lines of `kind`."""
    out, seen = [], 0
    while seen < n:
        line = await asyncio.wait_for(it.__anext__(), IO_S)
        out.append(_mask_line(line))
        seen += line.startswith('{"%s"' % kind)
    return out


async def _stream_calls(srv) -> list:
    api, agent, client = srv.api, srv.agent, srv.client
    out = []
    sql = ["SELECT id, text FROM tests WHERE id < ?", [100]]
    for i in (1, 2, 3):
        await ac.insert(api, agent, i, f"r{i}")
    s1 = client.subscribe(sql, raw=True)
    it1 = s1.__aiter__()
    out.append(await _lines_until(it1, 1, "eoq"))
    # each write's events are read before the next write: one diff batch
    # each, so the change ids do not depend on the batching window
    await ac.insert_many(api, agent, [(4, "r4"), (5, "r5"), (500, "far")])
    out.append(await _lines_until(it1, 2, "change"))
    await api.make_broadcastable_changes(agent, lambda tx: [
        tx.execute("UPDATE tests SET text = 'R1' WHERE id = 1"),
        tx.execute("DELETE FROM tests WHERE id = 2")])
    out.append(await _lines_until(it1, 2, "change"))
    # re-attach by id from change 1: the log replays 2..4, then live
    s2 = client.subscribe(sql, raw=True, from_change=1)
    s2.query_id = s1.query_id
    it2 = s2.__aiter__()
    out.append(await _lines_until(it2, 3, "change"))
    s3 = client.subscribe(sql, raw=True, skip_rows=True)
    it3 = s3.__aiter__()
    out.append(await _lines_until(it3, 1, "eoq"))
    upd = client.updates("tests").__aiter__()
    note = asyncio.ensure_future(upd.__anext__())  # sends the request

    def attached() -> bool:
        return any(h.subscriber_count for h in agent.updates.handles())

    assert await ac.wait_until(attached, timeout=IO_S)
    await ac.insert(api, agent, 6, "r6")
    for it in (it1, it2, it3):
        out.append(await _lines_until(it, 1, "change"))
    out.append([json.dumps(await asyncio.wait_for(note, IO_S))])
    out.append(s1.query_id == s2.query_id == s3.query_id)
    # errors: an unknown id, a malformed `from`, unparsable SQL, and a
    # node at its stream ceiling (the typed admission 503)
    for method, path, body in (
            ("GET", "/v1/subscriptions/nope", None),
            ("GET", f"/v1/subscriptions/{s1.query_id}?from=x", None),
            ("POST", "/v1/subscriptions", "SELEC nonsense")):
        out.append([path.replace(s1.query_id, "<qid>"),
                    *await _request(client, method, path, body)])
    agent.config.subs.max_streams = 3
    code, body = await _request(client, "POST", "/v1/subscriptions", sql)
    out.append([code, body])
    for it in (it1, it2, it3, upd):
        await it.aclose()
    return out


def test_streams_equal_jax(tmp_path):
    """Subscription and updates NDJSON lines are equal (eoq times
    masked; the query id is compared only across one package's streams),
    through rows, live changes, `from=` replay, `skip_rows`, the error
    answers and the admission 503."""
    got = {}
    for name, pkg in PKGS.items():
        async def main(pkg=pkg):
            async with _served(pkg, tmp_path, "api-s", seed=31) as srv:
                return await _stream_calls(srv)
        with cb.engine_env(pkg.engine):
            got[name] = _run(main())
    assert got["port"] == got["jax"]
    lines = got["port"]
    assert lines[0][0] == '{"columns": ["id", "text"]}'
    assert len(lines[0]) == 5  # columns, three rows, eoq
    assert lines[2][-1].startswith('{"change": ["delete"')
    assert lines[-1][0] == 503 and lines[-1][1]["code"] == "subs_admission"


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_client_against_the_other_packages_server(tmp_path, planes_off,
                                                  server, client):
    """Each package's client on the other's server: a transaction, a
    query, a subscription's snapshot and live change, an updates event,
    a typed ClientError on a bad statement."""
    other = {"jax": (JClient, JClientError), "port": (TClient, TClientError)}

    async def main():
        async with _served(PKGS[server], tmp_path, "api-x", seed=43) as srv:
            cls, err = other[client]
            c = cls(srv.server.addrs[0])
            try:
                res = await asyncio.wait_for(c.execute([
                    ["INSERT INTO tests (id, text) VALUES (?, ?)",
                     [1, "x"]]]), IO_S)
                rows = await asyncio.wait_for(
                    c.query_rows(["SELECT id, text FROM tests", []]), IO_S)
                it = c.subscribe("SELECT id, text FROM tests").__aiter__()
                first = [await asyncio.wait_for(it.__anext__(), IO_S)
                         for _ in range(3)]
                upd = c.updates("tests").__aiter__()
                nxt = asyncio.ensure_future(upd.__anext__())
                assert await ac.wait_until(lambda: any(
                    h.subscriber_count
                    for h in srv.agent.updates.handles()), timeout=IO_S)
                await ac.insert(srv.api, srv.agent, 2, "y")
                change = await asyncio.wait_for(it.__anext__(), IO_S)
                note = await asyncio.wait_for(nxt, IO_S)
                with pytest.raises(err) as bad:
                    await asyncio.wait_for(
                        c.execute(["INSERT INTO nope VALUES (1)"]), IO_S)
                await it.aclose()
                await upd.aclose()
                return (res["results"][0]["rows_affected"], rows, first,
                        change["change"][:3], note, bad.value.status)
            finally:
                await asyncio.wait_for(c.close(), IO_S)

    with cb.engine_env(PKGS[server].engine):
        got = _run(main())
    assert got[0] == 1 and got[1] == [[1, "x"]]
    assert got[2][0] == {"columns": ["id", "text"]}
    assert got[2][1] == {"row": [1, [1, "x"]]}
    assert "eoq" in got[2][2]
    assert got[3] == ["insert", 2, [2, "y"]]
    assert got[4] == {"notify": ["insert", [2]]}
    assert got[5] == 400


def test_chaos_census_equals_jax():
    """Registration, removal and clear of the census, snapshot by
    snapshot (`since` is a wall clock), and the registry lanes it
    counts into."""
    snaps = {}
    for name, mod in (("jax", jfaults), ("port", tfaults)):
        census = mod.ChaosCensus()
        seq = [census.snapshot()]
        census.begin("drill-1")
        census.add("inj-1", "zombie node-a", "process")
        census.add("inj-2", "slow disk 50ms", "store")
        seq.append(census.snapshot())
        census.remove("inj-1")
        seq.append(census.snapshot())
        census.end()
        seq.append(census.snapshot())
        for s in seq:
            s["since"] = s["since"] is not None
        snaps[name] = seq
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][1]["active"] and not snaps["port"][3]["active"]
    assert tfaults.CENSUS.snapshot()["active"] is False


@pytest.mark.parametrize("fault", [
    dict(statement_busy_rate=1.0), dict(commit_io_error_rate=1.0)])
def test_store_faults_surface_as_the_same_typed_error(tmp_path, fault):
    """A `StoreFaults` on an agent's store: a write fails with the same
    typed sqlite error in both packages, nothing of it lands, and with
    the faults gone the next write commits."""
    got = {}
    for name, pkg in PKGS.items():
        async def main(pkg=pkg):
            api = pkg.api()
            d = tmp_path / pkg.name / str(sorted(fault))
            d.mkdir(parents=True)
            agent = await ac.boot(api, api.MemNetwork(seed=41), "sick-a",
                                  str(d))
            try:
                agent.store.chaos = pkg.faults.StoreFaults(seed=1, **fault)
                with pytest.raises(sqlite3.OperationalError) as e:
                    await ac.insert(api, agent, 1, "doomed")
                agent.store.chaos = None
                await ac.insert(api, agent, 2, "ok")
                return (type(e.value).__name__, str(e.value),
                        ac.rows(agent))
            finally:
                await api.shutdown(agent)
        with cb.engine_env(pkg.engine):
            got[name] = _run(main())
    assert got["port"] == got["jax"]
    assert "[chaos-injected]" in got["port"][1]
    assert got["port"][2] == [(2, "ok")]


async def _drain(it) -> None:
    while True:
        await it.__anext__()


TYPED = (aiohttp.ClientError, ConnectionError, TClientError,
         StopAsyncIteration)


async def _stop_round(api, d: Path, http2: bool = True) -> float:
    """`tests/test_chaos.py::test_client_restart_surfaces_typed_error_not_hang`'s
    sequence on one port agent, every await bounded: boot, subscribe (over
    h2, or HTTP/1.1 through the front's byte pump), one event,
    `/v1/status` reads no chaos, stop the API mid-stream; `stop()` returns
    within 10 s and the stream ends typed within 20 s. Returns the stop's
    wall."""
    d.mkdir()
    agent, server, h2 = await asyncio.wait_for(
        ac.boot_with_api(api, api.MemNetwork(seed=59), "ca", str(d)),
        TIMEOUT_S)
    client = h2 if http2 else TClient(server.addrs[0], http2=False)
    try:
        stream = client.subscribe("SELECT id, text FROM tests",
                                  skip_rows=True)
        stream._max_retries = 2  # the capped loop, fast in-suite
        it = stream.__aiter__()
        await ac.insert(api, agent, 1, "live")
        ev = await asyncio.wait_for(it.__anext__(), IO_S)
        assert "change" in ev or "columns" in ev
        code, status = await _request(h2, "GET", "/v1/status")
        assert code == 200 and status["chaos"]["active"] is False
        assert status["chaos"]["scenario"] is None
        t0 = time.monotonic()
        await asyncio.wait_for(server.stop(), ac.STOP_BUDGET_S)
        stop_s = time.monotonic() - t0
        with pytest.raises(TYPED):
            await asyncio.wait_for(_drain(it), ac.RESTART_BUDGET_S)
        return stop_s
    finally:
        for c in {h2, client}:
            await asyncio.wait_for(c.close(), IO_S)
        await asyncio.wait_for(server.stop(), IO_S)
        await asyncio.wait_for(api.shutdown(agent), TIMEOUT_S)


async def _stop_lanes(tmp: Path, lanes: int, rounds: int,
                      http2: bool) -> list:
    """`lanes` agents at a time, `rounds` `_stop_round`s each."""
    api = ac.port_api("cpu")

    async def lane(j: int) -> list:
        return [await _stop_round(api, tmp / f"r{rounds * j + k}", http2)
                for k in range(rounds)]

    done = await asyncio.gather(*(lane(j) for j in range(lanes)))
    return [s for stops in done for s in stops]


def test_api_stop_with_a_live_stream_is_bounded_and_typed(tmp_path):
    """`_stop_round` over h2, 20 times (four agents at a time)."""
    stops = _run(_stop_lanes(tmp_path, 4, 5, http2=True), 120.0)
    assert len(stops) == 20 and max(stops) < ac.STOP_BUDGET_S


def test_api_stop_with_a_live_h1_stream_is_bounded_and_typed(tmp_path):
    """`_stop_round` with the stream over HTTP/1.1, 8 times (four agents
    at a time): the front cancels its h1 byte pumps before its bounded
    wait, so the stop returns and the stream ends typed."""
    stops = _run(_stop_lanes(tmp_path, 4, 2, http2=False), 120.0)
    assert len(stops) == 8 and max(stops) < ac.STOP_BUDGET_S


async def _h1_h2_calls(srv) -> list:
    """An h2 and an HTTP/1.1 client of one package on the same API port:
    writes, queries, a subscription on each that sees the other's write
    (times masked), and a 2,000-row query on each."""
    h2 = srv.client
    h1 = srv.api.CorrosionApiClient(srv.server.addrs[0], http2=False)
    insert = "INSERT INTO tests (id, text) VALUES (?, ?)"
    out = []
    try:
        for c, row in ((h2, [1, "h2"]), (h1, [2, "h1"])):
            out.append(_mask_times(await asyncio.wait_for(
                c.execute([[insert, row]]), IO_S)))
        for c in (h2, h1):
            out.append(await asyncio.wait_for(c.query_rows(
                ["SELECT id, text FROM tests ORDER BY id", []]), IO_S))
        its = [c.subscribe("SELECT id, text FROM tests").__aiter__()
               for c in (h1, h2)]
        for it in its:  # columns, two rows, eoq
            out.append(_mask_times([await asyncio.wait_for(
                it.__anext__(), IO_S) for _ in range(4)]))
        for c, row in ((h2, [3, "to h1"]), (h1, [4, "to h2"])):
            await asyncio.wait_for(c.execute([[insert, row]]), IO_S)
        for it in its:
            out.append([(await asyncio.wait_for(it.__anext__(), IO_S))
                         ["change"][:3] for _ in range(2)])
        for it in its:
            await it.aclose()
        out.append([type(h2._session.h2).__name__,
                    type(h1._session).__name__])
        # a body of several writes (the port batches /v1/queries' lines)
        await ac.insert_many(srv.api, srv.agent, ac.net_rows(2000))
        for c in (h2, h1):
            got = await asyncio.wait_for(c.query_rows(
                ["SELECT id, text FROM tests ORDER BY id", []]), IO_S)
            out.append([len(got), ac.digest(got)])
        return out
    finally:
        await asyncio.wait_for(h1.close(), IO_S)


def test_h1_and_h2_clients_share_the_api_port_as_jax(tmp_path):
    """`tests/test_h2.py::test_api_port_serves_h2_and_h1_together` held
    against the JAX package: on each package's API port an h2 client and
    an HTTP/1.1 one (through the front's byte pump to aiohttp) get equal
    bodies, and each one's subscription sees the other's writes."""
    got = {}
    for name, pkg in PKGS.items():
        async def main(pkg=pkg):
            async with _served(pkg, tmp_path, "api-h1", seed=47) as srv:
                return await _h1_h2_calls(srv)
        with cb.engine_env(pkg.engine):
            got[name] = _run(main())
    assert got["port"] == got["jax"]
    assert got["port"][2] == got["port"][3] == [[1, "h2"], [2, "h1"]]
    assert got["port"][6] == got["port"][7] == [
        ["insert", 3, [3, "to h1"]], ["insert", 4, [4, "to h2"]]]
    assert got["port"][-3] == ["H2Client", "ClientSession"]
    assert got["port"][-2] == got["port"][-1] and got["port"][-1][0] == 2000


def test_matcher_close_refuses_readers_typed(tmp_path):
    """`Matcher.close` holds the connection lock, and a reader after it
    raises `MatcherError` (the JAX module's readers would touch a closed
    or None connection)."""
    from corrosion_tpu_torch.pubsub.matcher import MatcherError

    async def main():
        api = ac.port_api("cpu")
        agent = await ac.boot(api, api.MemNetwork(seed=5), "m-a",
                              str(tmp_path))
        try:
            handle, _ = await agent.subs.get_or_insert(
                "SELECT id, text FROM tests")
            matcher = handle.matcher
            assert matcher.snapshot() == ([], 0)
            with matcher._conn_lock:
                # close waits for the lock a reader holds
                closer = asyncio.ensure_future(
                    asyncio.to_thread(matcher.close))
                await asyncio.sleep(0.05)
                assert not closer.done() and matcher._conn is not None
            await asyncio.wait_for(closer, IO_S)
            out = []
            for read in (matcher.snapshot, matcher.prune_log,
                         lambda: matcher.changes_since(0),
                         lambda: matcher.materialized_pks("tests"),
                         lambda: matcher.handle_candidates({})):
                with pytest.raises(MatcherError, match="closed"):
                    read()
                out.append(True)
            return out
        finally:
            await api.shutdown(agent)

    assert _run(main()) == [True] * 5


def test_scenario_api_equals_jax(tmp_path, planes_off):
    """`agent_checks.scenario_api` over plaintext QUIC at 400 rows: the
    port's outcome on B and on C equals the JAX package's, both pass the
    bar, and the port's restart check passes."""
    recs = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        with cb.engine_env(pkg.engine):
            recs[name] = _run(ac.scenario_api(
                pkg.api(), str(d), "quic", rows=400, txs=4,
                restart=name == "port"), 2 * TIMEOUT_S)
    ref = ac.api_outcome(recs["jax"])
    assert ac.api_checks(recs["jax"], ref, restart=False) == []
    assert ac.api_checks(recs["port"], ref) == []
    assert ac.api_outcome(recs["port"], "c") == ref
    assert ref["events"] == {"insert": 100}
    lanes = recs["port"]["array_lane"]
    assert lanes["b"]["decided"] > 0 and lanes["c"]["decided"] > 0


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_pubsub_script", REPO / "scripts" / "bench_pubsub.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_subs", [1, 4])
def test_pubsub_bench_rung_delivers_as_the_script(n_subs):
    """One small rung of `pubsub_bench.main` and of the JAX script's
    `main` at 500 rows: the same events delivered."""
    jbench = _jax_bench()
    want = _run(jbench.main(500, 50, n_subs))
    with cb.engine_env("array"):
        got = _run(tbench.main(500, 50, n_subs, device="cpu"))
    assert got["events_delivered"] == want["events_delivered"] == 500 * n_subs
    assert got["rung"] == want["rung"]
    assert set(got) == set(want)
    assert set(got["code_sha"]) == set(tbench._MEASURED_FILES)


def test_pubsub_bench_stream_rung_small():
    """A SUBS_SCALE rung at 40 streams over 4 queries: every event to
    every stream, the over-limit probe refused with the typed 503."""
    with cb.engine_env("array"):
        rec = _run(tbench.streams_rung(40, 4, 10, device="cpu"))
    assert rec["events_delivered"] == rec["events_expected"] == 400
    assert rec["streams_complete"] == 40 and rec["matchers"] == 4
    assert rec["admission"]["over_limit_probe_rejected"] is True


def api_ref() -> dict:
    """`chip_smoke.API_REF`: the JAX package's `scenario_api` at the chip
    phase's size over QUIC (no restart check: the JAX package's
    `ApiServer.stop` does not return with streams live)."""
    import tempfile

    with cb.engine_env("python"), tempfile.TemporaryDirectory() as d:
        rec = asyncio.run(ac.scenario_api(
            jax_http_api(), d, "quic", **ac.CHIP_NET, timeout=900.0,
            restart=False))
    bad = ac.api_checks(rec, ac.api_outcome(rec), restart=False)
    assert not bad, bad
    print(f"# walls {rec['walls']}", flush=True)
    return ac.api_outcome(rec)


if __name__ == "__main__":
    if "--ref" in sys.argv:
        print(f"API_REF = {api_ref()!r}", flush=True)
