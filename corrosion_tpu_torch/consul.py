"""Consul → store sync: replicate the local Consul agent's services and

The port's copy of `corrosion_tpu/consul.py`.
checks into the cluster.

Counterpart of `klukai/src/command/consul/sync.rs` (~980 LoC) and the
Consul client types in `klukai-types/src/consul/mod.rs`:

  - poll `/v1/agent/services` + `/v1/agent/checks` every 1 s (5 s timeout)
  - hash-based change detection: per-entity hashes persisted in
    `__corro_consul_services` / `__corro_consul_checks` so restarts don't
    re-upsert everything; check hashes cover (service_name, service_id,
    status) by default, or the fields named by a JSON
    `{"hash_include": ["status","output"]}` directive in the check's notes
  - diff vs cached hashes → upsert/delete statements executed through the
    corrosion HTTP API in one transaction (hash bookkeeping rides along)
  - rows written with `node = <hostname>`; deletes/upserts are scoped to
    this node's rows
  - reverse TTL sync: configured `[[consul.ttl_checks]]` entries map a
    store SQL query onto a Consul TTL check; statuses are PUT back to
    `/v1/agent/check/update/<id>`, hash-gated on (status, output) with a
    forced refresh inside the TTL window (this reference snapshot's
    consul client is poll-only — consul/mod.rs:111-116 — so the write
    direction follows Consul's own TTL check-update API contract)
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import socket
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from corrosion_tpu_torch.runtime.config import ConsulConfig
from corrosion_tpu_torch.runtime.metrics import METRICS

log = logging.getLogger(__name__)

PULL_INTERVAL = 1.0
CONSUL_TIMEOUT = 5.0


@dataclass(frozen=True)
class AgentService:
    """A service registered with the local Consul agent
    (consul/mod.rs:166-177)."""

    id: str
    name: str
    tags: Tuple[str, ...] = ()
    meta: Tuple[Tuple[str, str], ...] = ()
    port: int = 0
    address: str = ""

    @classmethod
    def from_json(cls, d: dict) -> "AgentService":
        return cls(
            id=d.get("ID", ""),
            name=d.get("Service", ""),
            tags=tuple(d.get("Tags") or ()),
            meta=tuple(sorted((d.get("Meta") or {}).items())),
            port=int(d.get("Port") or 0),
            address=d.get("Address", ""),
        )


@dataclass(frozen=True)
class AgentCheck:
    """A health check from the local Consul agent
    (consul/mod.rs:182-193)."""

    id: str
    name: str
    status: str  # passing | warning | critical
    output: str
    service_id: str
    service_name: str
    notes: Optional[str] = None

    @classmethod
    def from_json(cls, d: dict) -> "AgentCheck":
        return cls(
            id=d.get("CheckID", ""),
            name=d.get("Name", ""),
            status=d.get("Status", "critical"),
            output=d.get("Output", ""),
            service_id=d.get("ServiceID", ""),
            service_name=d.get("ServiceName", ""),
            notes=d.get("Notes") or None,
        )


class ConsulClient:
    """Minimal Consul agent HTTP client (klukai-types/src/consul/mod.rs:
    hyper client exposing agent_services/agent_checks)."""

    def __init__(self, address: str):
        self.base = f"http://{address}"
        self._session = None

    async def _ensure(self):
        import aiohttp

        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def agent_services(self) -> Dict[str, AgentService]:
        s = await self._ensure()
        async with s.get(f"{self.base}/v1/agent/services") as resp:
            resp.raise_for_status()
            data = await resp.json()
        return {k: AgentService.from_json(v) for k, v in data.items()}

    async def agent_checks(self) -> Dict[str, AgentCheck]:
        s = await self._ensure()
        async with s.get(f"{self.base}/v1/agent/checks") as resp:
            resp.raise_for_status()
            data = await resp.json()
        return {k: AgentCheck.from_json(v) for k, v in data.items()}

    async def update_ttl_check(
        self, check_id: str, status: str, output: str = ""
    ) -> None:
        """PUT /v1/agent/check/update/<id> — refresh a TTL check.

        The reverse half of the sync: this reference snapshot's client
        only polls (consul/mod.rs:111-116 — GETs, no writer), so the
        write-back follows Consul's own TTL check-update API contract
        (status must be passing|warning|critical)."""
        s = await self._ensure()
        async with s.put(
            f"{self.base}/v1/agent/check/update/{check_id}",
            json={"Status": status, "Output": output},
        ) as resp:
            resp.raise_for_status()


# -- hashing ---------------------------------------------------------------


def _h64(*parts: str) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x1f")
    return int.from_bytes(h.digest()[:8], "big")


def hash_service(svc: AgentService) -> int:
    return _h64(
        svc.id,
        svc.name,
        json.dumps(list(svc.tags)),
        json.dumps(dict(svc.meta), sort_keys=True),
        str(svc.port),
        svc.address,
    )


def hash_check(check: AgentCheck) -> int:
    """Checks hash (service_name, service_id, status) by default; a JSON
    notes directive {"hash_include": [...]} overrides which volatile
    fields count (sync.rs:354-386) — so flapping output text doesn't
    rewrite cluster state unless asked to."""
    parts = [check.service_name, check.service_id]
    directive = None
    if check.notes:
        try:
            directive = json.loads(check.notes).get("hash_include")
        except (json.JSONDecodeError, AttributeError):
            directive = None
    if directive:
        for fld in directive:
            if fld == "status":
                parts.append(check.status)
            elif fld == "output":
                parts.append(check.output)
    else:
        parts.append(check.status)
    return _h64(*parts)


# -- schema ----------------------------------------------------------------

INTERNAL_TABLES = """
CREATE TABLE IF NOT EXISTS __corro_consul_services (
    id TEXT NOT NULL PRIMARY KEY, hash BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS __corro_consul_checks (
    id TEXT NOT NULL PRIMARY KEY, hash BLOB NOT NULL
);
"""

_EXPECTED_SERVICE_COLS = {
    "node", "id", "name", "tags", "meta", "port", "address", "updated_at",
}
_EXPECTED_CHECK_COLS = {
    "node", "id", "service_id", "service_name", "name", "status", "output",
    "updated_at",
}


class ConsulSetupError(Exception):
    pass


async def setup(api) -> None:
    """Create hash tables, verify the user schema has the consul tables
    (sync.rs:130-221). `api` is a CorrosionApiClient."""
    for t, cols in (
        ("consul_services", _EXPECTED_SERVICE_COLS),
        ("consul_checks", _EXPECTED_CHECK_COLS),
    ):
        have = {
            r[0]
            for r in await api.query_rows(
                ["SELECT name FROM pragma_table_info(?)", [t]]
            )
        }
        if not have:
            raise ConsulSetupError(
                f"schema must define a CRR table {t!r} (see reference"
                " sync.rs:158-221 for the expected columns)"
            )
        missing = cols - have
        if missing:
            raise ConsulSetupError(f"{t} is missing columns {sorted(missing)}")
    # hash tables are internal (non-CRR) — plain statements
    for stmt in INTERNAL_TABLES.strip().split(";"):
        if stmt.strip():
            await api.execute([stmt.strip()])


# -- diffing ---------------------------------------------------------------


@dataclass
class ApplyStats:
    upserted: int = 0
    deleted: int = 0

    @property
    def is_zero(self) -> bool:
        return self.upserted == 0 and self.deleted == 0


def diff_services(
    services: Dict[str, AgentService], hashes: Dict[str, int]
) -> Tuple[List[Tuple[AgentService, int]], List[str]]:
    """(upserts, deletes) vs the cached hashes (sync.rs:update_services)."""
    upserts: List[Tuple[AgentService, int]] = []
    deletes: List[str] = []
    remaining = dict(services)
    for sid, old_hash in hashes.items():
        svc = remaining.pop(sid, None)
        if svc is None:
            deletes.append(sid)
            continue
        h = hash_service(svc)
        if h != old_hash:
            upserts.append((svc, h))
    for svc in remaining.values():
        upserts.append((svc, hash_service(svc)))
    return upserts, deletes


def diff_checks(
    checks: Dict[str, AgentCheck], hashes: Dict[str, int]
) -> Tuple[List[Tuple[AgentCheck, int]], List[str]]:
    upserts: List[Tuple[AgentCheck, int]] = []
    deletes: List[str] = []
    remaining = dict(checks)
    for cid, old_hash in hashes.items():
        check = remaining.pop(cid, None)
        if check is None:
            deletes.append(cid)
            continue
        h = hash_check(check)
        if h != old_hash:
            upserts.append((check, h))
    for check in remaining.values():
        upserts.append((check, hash_check(check)))
    return upserts, deletes


# -- statement assembly ----------------------------------------------------


def _svc_statements(node, svc: AgentService, h: int, updated_at: int):
    return [
        [
            "INSERT INTO __corro_consul_services (id, hash) VALUES (?, ?)"
            " ON CONFLICT (id) DO UPDATE SET hash = excluded.hash",
            [svc.id, list(h.to_bytes(8, "big"))],
        ],
        [
            "INSERT INTO consul_services"
            " (node, id, name, tags, meta, port, address, updated_at)"
            " VALUES (?,?,?,?,?,?,?,?)"
            " ON CONFLICT (node, id) DO UPDATE SET"
            " name = excluded.name, tags = excluded.tags,"
            " meta = excluded.meta, port = excluded.port,"
            " address = excluded.address, updated_at = excluded.updated_at",
            [
                node,
                svc.id,
                svc.name,
                json.dumps(list(svc.tags)),
                json.dumps(dict(svc.meta), sort_keys=True),
                svc.port,
                svc.address,
                updated_at,
            ],
        ],
    ]


def _check_statements(node, check: AgentCheck, h: int, updated_at: int):
    return [
        [
            "INSERT INTO __corro_consul_checks (id, hash) VALUES (?, ?)"
            " ON CONFLICT (id) DO UPDATE SET hash = excluded.hash",
            [check.id, list(h.to_bytes(8, "big"))],
        ],
        [
            "INSERT INTO consul_checks"
            " (node, id, service_id, service_name, name, status, output,"
            " updated_at) VALUES (?,?,?,?,?,?,?,?)"
            " ON CONFLICT (node, id) DO UPDATE SET"
            " service_id = excluded.service_id,"
            " service_name = excluded.service_name, name = excluded.name,"
            " status = excluded.status, output = excluded.output,"
            " updated_at = excluded.updated_at",
            [
                node,
                check.id,
                check.service_id,
                check.service_name,
                check.name,
                check.status,
                check.output,
                updated_at,
            ],
        ],
    ]


# -- reverse TTL status derivation ----------------------------------------

_TTL_STATUSES = ("passing", "warning", "critical")


def derive_ttl_status(rows: List[Any]) -> Tuple[str, str]:
    """Map a store query result onto a Consul TTL status.

    Contract: no rows → critical; if the first cell is a literal status
    string it is used verbatim (second cell, if any, becomes the output);
    otherwise the first cell's truthiness decides passing/critical. This
    lets one `SELECT 'passing', 'detail'`-style query drive the check
    directly, while `SELECT count(*) > 0 FROM ...` works unadorned."""
    if not rows:
        return "critical", "query returned no rows"
    row = rows[0]
    cell = row[0] if isinstance(row, (list, tuple)) else row
    if isinstance(cell, str) and cell in _TTL_STATUSES:
        out = ""
        if isinstance(row, (list, tuple)) and len(row) > 1 and row[1] is not None:
            out = str(row[1])
        return cell, out
    return ("passing", "") if cell else ("critical", f"query returned {cell!r}")


# -- sync engine -----------------------------------------------------------


class ConsulSync:
    """The 1 s pull loop, factored for testing (sync.rs:90-128)."""

    def __init__(
        self,
        consul: ConsulClient,
        api,
        node: Optional[str] = None,
        ttl_checks: Optional[List[dict]] = None,
        ttl_refresh: float = 30.0,
    ):
        self.consul = consul
        self.api = api
        self.node = node or socket.gethostname()
        self.service_hashes: Dict[str, int] = {}
        self.check_hashes: Dict[str, int] = {}
        self.ttl_checks = list(ttl_checks or ())
        self.ttl_refresh = ttl_refresh
        # check id -> (hash of last PUT (status, output), monotonic time)
        self._ttl_state: Dict[str, Tuple[int, float]] = {}

    async def load_hashes(self) -> None:
        """Warm the in-memory hash caches from the persisted tables."""
        for table, cache in (
            ("__corro_consul_services", self.service_hashes),
            ("__corro_consul_checks", self.check_hashes),
        ):
            for rid, h in await self.api.query_rows(
                f"SELECT id, hash FROM {table}"
            ):
                # blobs ride JSON as byte arrays (api/types.py dump_value)
                cache[rid] = int.from_bytes(bytes(h), "big")

    async def tick(self) -> Tuple[ApplyStats, ApplyStats]:
        """One pull + diff + apply round (sync.rs update_consul)."""
        t_poll = time.monotonic()
        services, checks = await asyncio.gather(
            asyncio.wait_for(self.consul.agent_services(), CONSUL_TIMEOUT),
            asyncio.wait_for(self.consul.agent_checks(), CONSUL_TIMEOUT),
        )
        METRICS.histogram("corro_consul.consul.response.time.seconds").observe(
            time.monotonic() - t_poll
        )
        svc_up, svc_del = diff_services(services, self.service_hashes)
        chk_up, chk_del = diff_checks(checks, self.check_hashes)

        updated_at = int(time.time() * 1000)
        statements: List[Any] = []
        for svc, h in svc_up:
            statements.extend(_svc_statements(self.node, svc, h, updated_at))
        for sid in svc_del:
            statements.append(
                ["DELETE FROM __corro_consul_services WHERE id = ?", [sid]]
            )
            statements.append(
                [
                    "DELETE FROM consul_services WHERE node = ? AND id = ?",
                    [self.node, sid],
                ]
            )
        for check, h in chk_up:
            statements.extend(
                _check_statements(self.node, check, h, updated_at)
            )
        for cid in chk_del:
            statements.append(
                ["DELETE FROM __corro_consul_checks WHERE id = ?", [cid]]
            )
            statements.append(
                [
                    "DELETE FROM consul_checks WHERE node = ? AND id = ?",
                    [self.node, cid],
                ]
            )

        if statements:
            resp = await self.api.execute(statements)
            for res in resp.get("results", []):
                if "error" in res:
                    raise RuntimeError(f"consul sync tx failed: {res}")

        # commit caches only after the tx landed
        for svc, h in svc_up:
            self.service_hashes[svc.id] = h
        for sid in svc_del:
            self.service_hashes.pop(sid, None)
        for check, h in chk_up:
            self.check_hashes[check.id] = h
        for cid in chk_del:
            self.check_hashes.pop(cid, None)

        if self.ttl_checks:
            await self.update_ttl_checks()

        svc_stats = ApplyStats(len(svc_up), len(svc_del))
        chk_stats = ApplyStats(len(chk_up), len(chk_del))
        METRICS.counter("corro_consul.services.upserted").inc(svc_stats.upserted)
        METRICS.counter("corro_consul.services.deleted").inc(svc_stats.deleted)
        METRICS.counter("corro_consul.checks.upserted").inc(chk_stats.upserted)
        METRICS.counter("corro_consul.checks.deleted").inc(chk_stats.deleted)
        return svc_stats, chk_stats

    async def update_ttl_checks(self) -> int:
        """Reverse sync: evaluate each configured TTL check's query against
        the store and PUT the derived status back to the local Consul
        agent. Hash-gated like the forward path — an unchanged
        (status, output) pair is NOT re-sent unless `ttl_refresh` seconds
        have elapsed since the last PUT (TTL checks lapse to critical on
        the Consul side if never refreshed, so gating can't be absolute).
        Returns the number of PUTs issued."""
        sent = 0
        for spec in self.ttl_checks:
            cid = spec.get("id")
            query = spec.get("query")
            if not cid or not query:
                continue
            try:
                rows = await self.api.query_rows(query)
                status, output = derive_ttl_status(rows)
            except Exception as e:  # store unreachable → check fails
                status, output = "critical", f"query failed: {e}"
            h = _h64(status, output)
            prev = self._ttl_state.get(cid)
            now = time.monotonic()
            if (
                prev is not None
                and prev[0] == h
                and now - prev[1] < self.ttl_refresh
            ):
                continue
            # one failing PUT (e.g. check not yet registered → 404) must
            # not starve the remaining checks or abort the tick
            try:
                await self.consul.update_ttl_check(cid, status, output)
            except Exception as e:
                METRICS.counter("corro_consul.consul.response.errors").inc()
                log.warning("ttl check %s update failed: %s", cid, e)
                continue
            self._ttl_state[cid] = (h, now)
            sent += 1
            METRICS.counter("corro_consul.ttl_checks.updated").inc()
        return sent

    async def run(self, tripwire=None) -> None:
        await setup(self.api)
        await self.load_hashes()
        while tripwire is None or not tripwire.tripped:
            try:
                svc_stats, chk_stats = await self.tick()
                if not svc_stats.is_zero:
                    log.info("updated consul services: %s", svc_stats)
                if not chk_stats.is_zero:
                    log.info("updated consul checks: %s", chk_stats)
            except (asyncio.TimeoutError, OSError, RuntimeError) as e:
                METRICS.counter("corro_consul.consul.response.errors").inc()
                log.warning("non-fatal consul sync error: %s", e)
            except Exception as e:
                # aiohttp raises ClientResponseError/ContentTypeError (not
                # OSError subclasses) on non-2xx or malformed responses —
                # common during Consul agent restarts. The reference treats
                # these as non-fatal too (consul sync.rs response.errors).
                if type(e).__module__.split(".")[0] not in (
                    "aiohttp",
                    "json",
                ):
                    raise
                METRICS.counter("corro_consul.consul.response.errors").inc()
                log.warning("non-fatal consul sync error: %s", e)
            await asyncio.sleep(PULL_INTERVAL)


async def consul_sync_loop(agent, consul_cfg: ConsulConfig, tripwire) -> None:
    """Side task started by `corrosion agent` when [consul] is enabled."""
    from corrosion_tpu_torch.client import CorrosionApiClient

    api = CorrosionApiClient(
        agent.config.api.bind_addr[0], token=agent.config.api.authz_bearer
    )
    consul = ConsulClient(consul_cfg.address)
    try:
        await ConsulSync(
            consul,
            api,
            ttl_checks=consul_cfg.ttl_checks,
            ttl_refresh=consul_cfg.ttl_refresh_seconds,
        ).run(tripwire)
    finally:
        await consul.close()
        await api.close()


async def run_consul_sync_cli(cfg) -> int:
    """`corrosion consul sync` (command/agent.rs consul side task)."""
    from corrosion_tpu_torch.client import CorrosionApiClient
    from corrosion_tpu_torch.runtime.tripwire import Tripwire

    consul_cfg = getattr(cfg, "consul", None) or ConsulConfig()
    api = CorrosionApiClient(
        cfg.api.bind_addr[0], token=cfg.api.authz_bearer
    )
    consul = ConsulClient(consul_cfg.address)
    tripwire = Tripwire.from_signals()
    try:
        await ConsulSync(
            consul,
            api,
            ttl_checks=consul_cfg.ttl_checks,
            ttl_refresh=consul_cfg.ttl_refresh_seconds,
        ).run(tripwire)
        return 0
    except ConsulSetupError as e:
        print(f"error: {e}")
        return 1
    finally:
        await consul.close()
        await api.close()
