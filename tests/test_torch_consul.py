"""The port's Consul sync (`corrosion_tpu_torch/consul.py`) against the JAX
package's (`corrosion_tpu/consul.py`).

The hashing, diffing and TTL derivation give equal values on the same
inputs. Then `tests/test_consul.py`'s flows run through both packages,
each against a `FakeConsul` (copied from `tests/test_consul.py:49`) and an
agent of its own package with its API (the port's store on the CPU):
every round of the forward sync issues the same statements, the rows and
the hash tables come out equal, and the reverse TTL sync PUTs the same
bodies. Everything is compared exactly.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
from aiohttp import web

import corrosion_tpu.consul as JC
import corrosion_tpu_torch.consul as TC
from corrosion_tpu.agent import run as j_run
from corrosion_tpu.api.http import ApiServer as JApiServer
from corrosion_tpu.client import CorrosionApiClient as JClient
from corrosion_tpu.net.mem import MemNetwork as JMemNetwork
from corrosion_tpu.runtime.config import Config as JConfig
from corrosion_tpu.runtime.tmpdb import fresh_db_path as j_fresh_db_path
from corrosion_tpu_torch.agent import run as t_run
from corrosion_tpu_torch.api.http import ApiServer as TApiServer
from corrosion_tpu_torch.client import CorrosionApiClient as TClient
from corrosion_tpu_torch.net.mem import MemNetwork as TMemNetwork
from corrosion_tpu_torch.runtime.config import Config as TConfig
from corrosion_tpu_torch.runtime.tmpdb import fresh_db_path as t_fresh_db_path
from tests.test_torch_planes import planes_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _planes_uninstalled(planes_reset):
    """The agents these tests boot install the process-global planes
    (trace store, TSDB, profiler): uninstalled, threads joined, around
    every test."""
    yield


CONSUL_SCHEMA = """
CREATE TABLE consul_services (
    node TEXT NOT NULL, id TEXT NOT NULL,
    name TEXT NOT NULL DEFAULT '', tags TEXT NOT NULL DEFAULT '[]',
    meta TEXT NOT NULL DEFAULT '{}', port INTEGER NOT NULL DEFAULT 0,
    address TEXT NOT NULL DEFAULT '', updated_at INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (node, id)
);
CREATE TABLE consul_checks (
    node TEXT NOT NULL, id TEXT NOT NULL,
    service_id TEXT NOT NULL DEFAULT '', service_name TEXT NOT NULL DEFAULT '',
    name TEXT NOT NULL DEFAULT '', status TEXT NOT NULL DEFAULT '',
    output TEXT NOT NULL DEFAULT '', updated_at INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (node, id)
);
"""

PKGS = {
    "jax": SimpleNamespace(
        consul=JC, run=j_run, ApiServer=JApiServer, Client=JClient,
        MemNetwork=JMemNetwork, Config=JConfig,
        fresh_db_path=j_fresh_db_path, setup_kw={}),
    "torch": SimpleNamespace(
        consul=TC, run=t_run, ApiServer=TApiServer, Client=TClient,
        MemNetwork=TMemNetwork, Config=TConfig,
        fresh_db_path=t_fresh_db_path, setup_kw={"device": "cpu"}),
}


class FakeConsul:
    """Stands in for the local Consul agent HTTP API
    (`tests/test_consul.py:49`)."""

    def __init__(self):
        self.services = {}
        self.checks = {}
        self.ttl_updates = []  # (check_id, {"Status":…, "Output":…}) PUTs
        self.runner = None
        self.addr = None

    async def start(self):
        app = web.Application()
        app.router.add_get("/v1/agent/services", self.h_services)
        app.router.add_get("/v1/agent/checks", self.h_checks)
        app.router.add_put(
            "/v1/agent/check/update/{cid}", self.h_check_update
        )
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        host, port = self.runner.addresses[0][:2]
        self.addr = f"{host}:{port}"

    async def stop(self):
        if self.runner:
            await self.runner.cleanup()

    async def h_services(self, _req):
        return web.json_response(self.services)

    async def h_checks(self, _req):
        return web.json_response(self.checks)

    async def h_check_update(self, req):
        body = await req.json()
        if body.get("Status") not in ("passing", "warning", "critical"):
            return web.json_response({"error": "bad status"}, status=400)
        self.ttl_updates.append((req.match_info["cid"], body))
        return web.json_response({})


def svc_json(sid, name, port=80, tags=(), addr="10.0.0.1"):
    return {"ID": sid, "Service": name, "Tags": list(tags), "Meta": {},
            "Port": port, "Address": addr}


def check_json(cid, sid, sname, status, output="", notes=""):
    return {"CheckID": cid, "Name": cid, "Status": status, "Output": output,
            "ServiceID": sid, "ServiceName": sname, "Notes": notes}


NOTES = json.dumps({"hash_include": ["output"]})
SERVICES = [svc_json("s1", "web"), svc_json("s1", "web", port=81),
            svc_json("s2", "db", tags=("a", "b"), addr="10.0.0.2"),
            {"ID": "s3", "Service": "x"}]
CHECKS = [check_json("c1", "s1", "web", "passing", "x"),
          check_json("c1", "s1", "web", "passing", "y"),
          check_json("c1", "s1", "web", "critical", "y"),
          check_json("c1", "s1", "web", "passing", "x", NOTES),
          check_json("c1", "s1", "web", "critical", "x", NOTES),
          {"CheckID": "c9"}]


def test_hashes_and_diffs_match():
    def read(c):
        svcs = [c.AgentService.from_json(s) for s in SERVICES]
        chks = [c.AgentCheck.from_json(k) for k in CHECKS]
        hs = [c.hash_service(s) for s in svcs]
        hc = [c.hash_check(k) for k in chks]
        ups, dels = c.diff_services(
            {"s1": svcs[0], "s2": svcs[2]}, {"s1": hs[0], "gone": 123})
        cups, cdels = c.diff_checks(
            {"c1": chks[2]}, {"c1": hc[0], "old": 7})
        return (hs, hc, [(u[0].id, u[1]) for u in ups], dels,
                [(u[0].id, u[1]) for u in cups], cdels,
                c._h64("a", "b"))
    assert read(JC) == read(TC)
    hs = read(TC)[0]
    assert hs[0] != hs[1]


@pytest.mark.parametrize("rows", [
    [], [["passing", "all good"]], [["warning"]], [[1]], [[0]],
    [["bogus", "x"]], [[None]]])
def test_derive_ttl_status_matches(rows):
    assert TC.derive_ttl_status(rows) == JC.derive_ttl_status(rows)


class RecordingClient:
    """A client whose `execute` calls are recorded (the statements the
    sync issues), delegating everything to the package's client."""

    def __init__(self, inner):
        self.inner = inner
        self.statements = []

    async def execute(self, stmts, *a, **kw):
        self.statements.append(json.loads(json.dumps(stmts)))
        return await self.inner.execute(stmts, *a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


async def _boot(pkg, schema=CONSUL_SCHEMA):
    cfg = pkg.Config()
    cfg.db.path = pkg.fresh_db_path()
    cfg.gossip.bind_addr = "a:1"
    cfg.api.bind_addr = ["127.0.0.1:0"]
    agent = await pkg.run.setup(cfg, network=pkg.MemNetwork(),
                                **pkg.setup_kw)
    if schema:
        agent.store.apply_schema_sql(schema)
    await pkg.run.run(agent)
    api_srv = pkg.ApiServer(agent)
    await api_srv.start()
    return agent, api_srv


async def _forward_flow(pkg) -> dict:
    """`tests/test_consul.py::test_end_to_end_sync_flow`'s rounds, every
    round's statements, stats and rows recorded."""
    c = pkg.consul
    agent, api_srv = await _boot(pkg)
    fake = FakeConsul()
    await fake.start()
    api = RecordingClient(pkg.Client(api_srv.addrs[0]))
    consul = c.ConsulClient(fake.addr)
    out = []
    try:
        sync = c.ConsulSync(consul, api, node="testnode")
        await c.setup(api)
        await sync.load_hashes()

        async def round_(label):
            api.statements.clear()
            svc, chk = await sync.tick()
            out.append({
                "round": label,
                "stats": [(s.upserted, s.deleted) for s in (svc, chk)],
                "statements": _timeless(api.statements),
                "services": await api.query_rows(
                    "SELECT node, id, name, tags, meta, port, address"
                    " FROM consul_services ORDER BY id"),
                "checks": await api.query_rows(
                    "SELECT node, id, service_id, service_name, name,"
                    " status, output FROM consul_checks ORDER BY id"),
                "hashes": [dict(sync.service_hashes),
                           dict(sync.check_hashes)]})

        fake.services["s1"] = svc_json("s1", "web", tags=("prod",))
        fake.checks["c1"] = check_json("c1", "s1", "web", "passing")
        await round_("appear")
        await round_("unchanged")
        fake.checks["c1"] = check_json("c1", "s1", "web", "critical")
        await round_("flap")
        fake.services["s2"] = svc_json("s2", "db", port=5432)
        fake.checks["c2"] = check_json("c2", "s2", "db", "passing", "ok",
                                       NOTES)
        await round_("second service")
        del fake.services["s1"]
        del fake.checks["c1"]
        await round_("deregister")
        sync2 = c.ConsulSync(c.ConsulClient(fake.addr), api, node="testnode")
        await sync2.load_hashes()
        out.append({"warm": [dict(sync2.service_hashes),
                             dict(sync2.check_hashes)]})
        await sync2.consul.close()
    finally:
        await consul.close()
        await api.close()
        await fake.stop()
        await api_srv.stop()
        await pkg.run.shutdown(agent)
    return out


def _timeless(statements):
    """Statements with their `updated_at` stamps (wall-clock seconds)
    masked: each is a [sql, params] pair whose last param is the stamp
    when the sql names `updated_at`."""
    out = []
    for st in statements:
        for s in st:
            if isinstance(s, list) and "updated_at" in s[0]:
                s = [s[0], s[1][:-1] + ["<ts>"]]
            out.append(s)
    return out


async def test_forward_sync_statements_rows_and_hashes_match():
    j = await _forward_flow(PKGS["jax"])
    t = await _forward_flow(PKGS["torch"])
    assert t == j
    assert [r["stats"] for r in t[:5]] == [
        [(1, 0), (1, 0)], [(0, 0), (0, 0)], [(0, 0), (1, 0)],
        [(1, 0), (1, 0)], [(0, 1), (0, 1)]]
    assert t[-1]["warm"] == t[-2]["hashes"]


async def _ttl_flow(pkg) -> list:
    """`tests/test_consul.py::test_reverse_ttl_sync_flow`'s rounds: the
    TTL PUT bodies the fake agent received."""
    c = pkg.consul
    agent, api_srv = await _boot(pkg)
    fake = FakeConsul()
    await fake.start()
    api = pkg.Client(api_srv.addrs[0])
    consul = c.ConsulClient(fake.addr)
    try:
        sync = c.ConsulSync(
            consul, api, node="testnode",
            ttl_checks=[{"id": "corrosion-live", "query": (
                "SELECT CASE WHEN count(*) > 0 THEN 'passing'"
                " ELSE 'critical' END, 'services=' || count(*)"
                " FROM consul_services")}],
            ttl_refresh=3600.0)
        await c.setup(api)
        await sync.load_hashes()
        await sync.tick()
        await sync.tick()
        fake.services["s1"] = svc_json("s1", "web")
        await sync.tick()
        sync.ttl_refresh = 0.0
        await sync.tick()
        sync.ttl_checks = [{"id": "corrosion-live",
                            "query": "SELECT * FROM nope"}]
        sync.ttl_refresh = 3600.0
        await sync.tick()
        return list(fake.ttl_updates)
    finally:
        await consul.close()
        await api.close()
        await fake.stop()
        await api_srv.stop()
        await pkg.run.shutdown(agent)


async def test_reverse_ttl_puts_match():
    j = await _ttl_flow(PKGS["jax"])
    t = await _ttl_flow(PKGS["torch"])
    assert t == j
    assert [b["Status"] for _cid, b in t] == [
        "critical", "passing", "passing", "critical"]
    assert "query failed" in t[-1][1]["Output"]


async def test_setup_rejects_missing_schema_in_both():
    for pkg in PKGS.values():
        agent, api_srv = await _boot(pkg, schema=None)
        api = pkg.Client(api_srv.addrs[0])
        try:
            with pytest.raises(pkg.consul.ConsulSetupError):
                await pkg.consul.setup(api)
        finally:
            await api.close()
            await api_srv.stop()
            await pkg.run.shutdown(agent)
