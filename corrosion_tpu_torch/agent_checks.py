"""Agent workloads that hold the port's agent to the JAX package's.

Each one is written over a small `api` namespace (`setup`, `run`,
`shutdown`, `make_broadcastable_changes`, `parallel_sync`, `MemNetwork`,
`Config`, `SwimConfig`, `held_total`, `METRICS`), so the same code boots either
package's agents: `chip_smoke.py` and `sync_bench.py` run the port's with
their stores' decision program on the card, and the tests run the JAX
package's beside them on the CPU with the same seeds.

The configuration is the one of the JAX package's agent tests
(`tests/test_agent.py::fast_config`: 20 ms broadcasts, 5 ms apply
window, sync every 0.1-0.5 s, fast SWIM timers) with the planes the port
does not have yet turned off for both packages (`PLANES_OFF`): a port
`setup` refuses them, and the same TOML must mean the same thing in both.
The cluster observatory (`cluster.digests`) and the snapshot catch-up
plane (`sync.snapshot`) stay on, as the reference's defaults have them;
the SLO canary stays off (its default) unless a scenario turns it on.

Agents gossip over the in-memory network (`transport="mem"`) or over
real loopback sockets (`"quic"`, `"tcp"`; `loopback_addr` picks a free
port as `tests/test_agent.py::free_port` does).

The scenarios are the JAX package's agent tests (`tests/test_agent.py`):
insert-and-gossip, an LWW conflict, a late joiner caught up by sync, one
`parallel_sync` round trip, a transaction large enough for several
broadcast chunks, a shed queue repaired by sync, and the stress shape of
six agents on a random bootstrap topology (`cluster_run`); and the
socket transports under a live query (`scenario_net`). Each returns
what it saw as plain data; timing differs from run to run in both
packages, so what is held equal is the converged part: the rows every
agent ends with where only one writer wrote, and equality across agents
where several did.

Every wait is capped, and every agent is shut down on every exit path.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import inspect
import os
import random
import socket
import time
from types import SimpleNamespace
from typing import Callable, List, Optional

TEST_SCHEMA = (
    "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
)
FAST_SWIM = dict(probe_period=0.05, probe_rtt=0.02, suspicion_mult=1.0)
# (section, flag): planes the port's `setup` refuses (`agent/run.py`
# `UNPORTED_PLANES`), turned off for both packages
PLANES_OFF = (
    ("trace", "enabled"), ("tsdb", "enabled"), ("alerts", "enabled"),
    ("profile", "enabled"),
)
TRANSPORTS = ("mem", "quic", "tcp")


def port_api(device=None) -> SimpleNamespace:
    """The port's agent, its stores' decision program on `device` (None:
    the card)."""
    from corrosion_tpu_torch.agent import run as run_mod
    from corrosion_tpu_torch.agent.membership import SwimConfig
    from corrosion_tpu_torch.agent.syncer import parallel_sync
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.client import ClientError, CorrosionApiClient
    from corrosion_tpu_torch.net.h2 import StreamReset
    from corrosion_tpu_torch.net.mem import MemNetwork
    from corrosion_tpu_torch.runtime.config import Config
    from corrosion_tpu_torch.runtime.metrics import METRICS
    from corrosion_tpu_torch.sync import held_total

    async def setup(config, network=None, tripwire=None):
        return await run_mod.setup(config, network=network,
                                   tripwire=tripwire, device=device)

    return SimpleNamespace(
        name="port", setup=setup, run=run_mod.run,
        shutdown=run_mod.shutdown,
        make_broadcastable_changes=run_mod.make_broadcastable_changes,
        parallel_sync=parallel_sync, MemNetwork=MemNetwork, Config=Config,
        SwimConfig=SwimConfig, held_total=held_total, METRICS=METRICS,
        ApiServer=ApiServer, CorrosionApiClient=CorrosionApiClient,
        ClientError=ClientError, StreamReset=StreamReset,
    )


def free_port(dgram: bool = False) -> int:
    """A loopback port free at the time of the call (racy by nature:
    the socket closes before the agent binds it)."""
    kind = socket.SOCK_DGRAM if dgram else socket.SOCK_STREAM
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loopback_addr(transport: str) -> str:
    """A free `127.0.0.1:port` for a socket transport: a UDP port for
    QUIC; for TCP a port free for both its streams and its datagrams
    (the listener binds UDP and TCP on one port)."""
    if transport == "quic":
        return f"127.0.0.1:{free_port(dgram=True)}"
    if transport != "tcp":
        raise ValueError(f"no loopback address for transport {transport!r}")
    for _ in range(64):
        port = free_port()
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.bind(("127.0.0.1", port))
        except OSError:
            continue
        return f"127.0.0.1:{port}"
    raise OSError("no loopback port free for both TCP and UDP")


def fast_config(api, addr: str, db_dir: str, bootstrap=(),
                transport: str = "mem"):
    """The test config for an agent at `addr` (a name on the in-memory
    network, `host:port` on a socket transport)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}")
    cfg = api.Config()
    cfg.db.path = os.path.join(db_dir, addr.replace(":", "_") + ".db")
    cfg.gossip.bind_addr = addr
    cfg.gossip.bootstrap = list(bootstrap)
    if transport != "mem":
        cfg.gossip.transport = transport
    cfg.perf.broadcast_interval_ms = 20
    cfg.perf.apply_queue_timeout_ms = 5
    cfg.perf.sync_interval_min_secs = 0.1
    cfg.perf.sync_interval_max_secs = 0.5
    for section, flag in PLANES_OFF:
        setattr(getattr(cfg, section), flag, False)
    return cfg


async def boot(api, net, addr: str, db_dir: str, bootstrap=(),
               tune: Optional[Callable] = None, swim=None,
               before_run: Optional[Callable] = None,
               transport: str = "mem"):
    """setup + schema + run, as the JAX package's tests boot an agent;
    `before_run(agent)`, if given, runs (or is awaited) just before
    `run`. A socket transport binds `addr` itself (`net` is None)."""
    if (net is None) != (transport != "mem"):
        raise ValueError(f"transport {transport!r} with network {net!r}")
    cfg = fast_config(api, addr, db_dir, bootstrap, transport)
    if tune is not None:
        tune(cfg)
    agent = await api.setup(cfg, network=net)
    try:
        agent.membership.config = swim or api.SwimConfig(**FAST_SWIM)
        agent.store.apply_schema_sql(TEST_SCHEMA)
        if before_run is not None:
            res = before_run(agent)
            if inspect.isawaitable(res):
                await res
        await api.run(agent)
    except BaseException:
        await api.shutdown(agent)
        raise
    return agent


async def boot_with_api(api, net, addr: str, db_dir: str, bootstrap=(),
                        **kw):
    """`boot`, then an `ApiServer` on `127.0.0.1:0` (the JAX package's
    `tests/test_http_api.py::boot_with_api`): returns the agent, the
    server and an h2 `CorrosionApiClient` on it."""
    agent = await boot(api, net, addr, db_dir, bootstrap, **kw)
    server = api.ApiServer(agent)
    try:
        agent.config.api.bind_addr = ["127.0.0.1:0"]
        await server.start()
    except BaseException:
        await server.stop()
        await api.shutdown(agent)
        raise
    return agent, server, api.CorrosionApiClient(server.addrs[0])


async def shutdown_all(api, agents) -> None:
    for ag in agents:
        if ag is not None:
            await api.shutdown(ag)


async def wait_until(pred, timeout: float = 10.0, step: float = 0.02) -> bool:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(step)
    return pred()


def query(agent, sql: str, args=()) -> list:
    conn = agent.store.read_conn()
    try:
        return [tuple(r) for r in conn.execute(sql, args).fetchall()]
    finally:
        conn.close()


def count_rows(agent, where: str = "1=1") -> int:
    return query(agent, f"SELECT COUNT(*) FROM tests WHERE {where}")[0][0]


def clock_count(agent) -> int:
    return query(agent, "SELECT COUNT(*) FROM tests__crdt_clock")[0][0]


def rows(agent, lo: int = 0, hi: int = 1 << 62) -> list:
    return query(agent, "SELECT id, text FROM tests WHERE id >= ? AND id < ?"
                 " ORDER BY id", (lo, hi))


def digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def booked_contains(agent, other_id, lo: int, hi: int) -> bool:
    """Whether `agent` booked versions lo..hi of `other_id` (an actor id
    of either package: looked up by its bytes)."""
    booked = next((b for aid, b in agent.bookie.items().items()
                   if aid.bytes16 == other_id.bytes16), None)
    if booked is None:
        return False
    with booked.read() as bv:
        return bv.contains_all((lo, hi))


def array_lane(agents) -> dict:
    """Batches the port's stores decided and declined on their decision
    program (`CrdtStore.array_lane`); None for the JAX package's."""
    lanes = [getattr(ag.store, "array_lane", None) for ag in agents]
    if any(lane is None for lane in lanes):
        return None
    return {k: sum(lane[k] for lane in lanes)
            for k in ("decided", "declined")}


async def insert(api, agent, rowid: int, text: str):
    return await api.make_broadcastable_changes(
        agent,
        lambda tx: [tx.execute(
            "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
            (rowid, text))],
    )


async def insert_many(api, agent, items) -> object:
    """One transaction writing every (id, text) of `items`."""
    items = list(items)
    return await api.make_broadcastable_changes(
        agent,
        lambda tx: [tx.execute(
            "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)", it)
            for it in items],
    )


async def _sizes(agents, n: int, timeout: float) -> None:
    if not await wait_until(
            lambda: all(ag.membership.cluster_size == n for ag in agents),
            timeout=timeout):
        raise AssertionError(
            f"cluster sizes {[ag.membership.cluster_size for ag in agents]}"
            f", expected {n}")


# -- the JAX package's agent tests, as scenarios ------------------------------


async def scenario_gossip(api, db_dir: str) -> dict:
    """`test_insert_rows_and_gossip`: three agents; a write on a and one
    on b reach everyone by broadcast."""
    net = api.MemNetwork(seed=11)
    agents = []
    try:
        agents.append(await boot(api, net, "agent-a", db_dir))
        for name in ("agent-b", "agent-c"):
            agents.append(await boot(api, net, name, db_dir, ["agent-a"]))
        a, b, c = agents
        await _sizes(agents, 3, 10.0)
        res = await insert(api, a, 1, "hello")
        ok1 = await wait_until(lambda: count_rows(b) == 1
                               and count_rows(c) == 1)
        await insert(api, b, 2, "world")
        ok2 = await wait_until(lambda: count_rows(a) == 2
                               and count_rows(c) == 2)
        return {"version": res.version, "rows_affected": res.rows_affected,
                "replicated": [ok1, ok2],
                "booked": [booked_contains(ag, a.actor_id, 1, 1)
                           for ag in (b, c)],
                "rows": [rows(ag) for ag in agents]}
    finally:
        await shutdown_all(api, agents)


async def scenario_lww(api, db_dir: str) -> dict:
    """`test_lww_convergence_on_conflict`: concurrent writes to one row
    end with one value on both agents (which one depends on timing)."""
    net = api.MemNetwork(seed=13)
    agents = []
    try:
        agents.append(await boot(api, net, "agent-a", db_dir))
        agents.append(await boot(api, net, "agent-b", db_dir, ["agent-a"]))
        a, b = agents
        await _sizes(agents, 2, 10.0)
        await asyncio.gather(insert(api, a, 7, "from-a"),
                             insert(api, b, 7, "from-b"))

        def values():
            return [rows(ag, 7, 8) for ag in agents]

        ok = await wait_until(lambda: values()[0] != [] and
                              values()[0] == values()[1])
        return {"converged": ok, "value": values()[0]}
    finally:
        await shutdown_all(api, agents)


async def scenario_late_joiner(api, db_dir: str) -> dict:
    """`test_late_joiner_catches_up_via_sync`: 20 rows written before c
    boots reach c by sync alone."""
    net = api.MemNetwork(seed=17)
    agents = []
    try:
        a = await boot(api, net, "agent-a", db_dir)
        agents.append(a)
        for i in range(20):
            await insert(api, a, i, f"row-{i}")
        c = await boot(api, net, "agent-c", db_dir, ["agent-a"])
        agents.append(c)
        await _sizes([c], 2, 10.0)
        ok = await wait_until(lambda: count_rows(c) == 20, timeout=15.0)
        booked = c.bookie.get(a.actor_id)
        with booked.read() as bv:
            last = bv.last()
        return {"caught_up": ok, "booked": booked_contains(c, a.actor_id,
                                                           1, 20),
                "last": last, "rows": rows(c)}
    finally:
        await shutdown_all(api, agents)


async def scenario_parallel_sync(api, db_dir: str) -> dict:
    """`test_direct_parallel_sync_roundtrip`: one sync session driven
    directly, no scheduler."""
    net = api.MemNetwork(seed=19)
    agents = []
    try:
        agents.append(await boot(api, net, "agent-a", db_dir))
        agents.append(await boot(api, net, "agent-b", db_dir))
        a, b = agents
        for i in range(5):
            await insert(api, a, i, f"v-{i}")
        b.members.add_member(a.actor)
        received = await asyncio.wait_for(api.parallel_sync(b, [a.actor]),
                                          30.0)
        ok = await wait_until(lambda: count_rows(b) == 5)
        return {"received": received, "applied": ok, "rows": rows(b)}
    finally:
        await shutdown_all(api, agents)


async def scenario_large_tx(api, db_dir: str) -> dict:
    """`test_large_tx_multichunk_broadcast_replicates`: one transaction
    of 80 rows of 400 bytes, split into several broadcast chunks, lands
    whole."""
    net = api.MemNetwork(seed=31)
    agents = []
    try:
        agents.append(await boot(api, net, "big-a", db_dir))
        agents.append(await boot(api, net, "big-b", db_dir, ["big-a"]))
        a, b = agents
        await _sizes(agents, 2, 15.0)
        big = "x" * 400
        await insert_many(api, a, [(k, big) for k in range(80)])
        ok = await wait_until(lambda: count_rows(b) == 80, timeout=30.0)
        return {"replicated": ok, "rows": digest(rows(b))}
    finally:
        await shutdown_all(api, agents)


async def scenario_loadshed(api, db_dir: str, counter) -> dict:
    """`test_loadshed_drop_oldest_then_sync_repairs`: b's processing
    queue holds 2, so a 40-write flood sheds (`counter()` reads the
    package's `corro.agent.changes.dropped`), and sync repairs b to the
    full row set."""
    net = api.MemNetwork(seed=29)
    agents = []

    def tune(cfg):
        cfg.perf.processing_queue_len = 2
        cfg.perf.apply_queue_len = 10_000
        cfg.perf.apply_queue_timeout_ms = 200

    try:
        agents.append(await boot(api, net, "shed-a", db_dir))
        agents.append(await boot(api, net, "shed-b", db_dir, ["shed-a"],
                                 tune=tune))
        a, b = agents
        await _sizes(agents, 2, 10.0)
        dropped0 = counter()
        for i in range(40):
            await insert(api, a, i, f"flood-{i}")
        shed = await wait_until(lambda: counter() > dropped0, timeout=10.0)
        ok = await wait_until(lambda: count_rows(b) == 40, timeout=30.0)
        return {"shed": shed, "repaired": ok,
                "booked": booked_contains(b, a.actor_id, 1, 40),
                "rows": rows(b)}
    finally:
        await shutdown_all(api, agents)


# -- the stress shape: n agents, random bootstrap topology --------------------


def own_rows(ai: int, txs: int, rows_per_tx: int) -> list:
    """Agent `ai`'s disjoint range: ids ai * 10^6 + k."""
    base = ai * 1_000_000
    return [(base + k, f"w{ai}-r{k}") for k in range(txs * rows_per_tx)]


SHARED_BASE = 900_000_000
# `chip_smoke.py`'s agent_cluster: six agents, 50 transactions of 20 rows
# each, then 100 shared ids written by all six
CHIP_CLUSTER = dict(n_agents=6, txs=50, rows_per_tx=20, shared=100)


async def cluster_run(api, db_dir: str, n_agents: int = 6, txs: int = 5,
                      rows_per_tx: int = 4, shared: int = 10,
                      seed: int = 4242, net_seed: int = 23,
                      timeout: float = 60.0) -> dict:
    """`test_configurable_stress_random_topology_concurrent_writers`,
    widened: `n_agents` agents bootstrap through 1-2 random earlier ones
    (`random.Random(seed)`, `MemNetwork(seed=net_seed)`); every agent
    concurrently writes `txs` transactions of `rows_per_tx` rows into its
    own id range, then every agent writes the same `shared` ids with
    values of its own (in transactions of `rows_per_tx` rows). The run
    ends when every agent holds every row and every writer's versions
    are booked by every peer.

    Returns the disjoint ranges' rows (equal to `own_rows` on every
    agent), the shared ids' rows (equal across agents; the winners
    depend on timing), the cluster sizes, `held_total` per agent, the
    wall to convergence and the port's array lane."""
    rng = random.Random(seed)
    net = api.MemNetwork(seed=net_seed)
    names = [f"stress-{i}" for i in range(n_agents)]
    agents = []
    try:
        agents.append(await boot(api, net, names[0], db_dir))
        for i in range(1, n_agents):
            boots = rng.sample(names[:i], k=min(i, rng.choice((1, 2))))
            agents.append(await boot(api, net, names[i], db_dir, boots))
        await _sizes(agents, n_agents, 20.0)
        t0 = time.monotonic()

        async def writer(ai, ag):
            mine = own_rows(ai, txs, rows_per_tx)
            for t in range(txs):
                await insert_many(
                    api, ag, mine[t * rows_per_tx:(t + 1) * rows_per_tx])

        await asyncio.gather(*(writer(ai, ag)
                               for ai, ag in enumerate(agents)))

        async def shared_writer(ai, ag):
            ids = [(SHARED_BASE + k, f"s{ai}-{k}") for k in range(shared)]
            for t in range(0, shared, rows_per_tx):
                await insert_many(api, ag, ids[t:t + rows_per_tx])

        await asyncio.gather(*(shared_writer(ai, ag)
                               for ai, ag in enumerate(agents)))
        versions = txs + -(-shared // rows_per_tx)
        total = n_agents * txs * rows_per_tx + shared

        def converged() -> bool:
            # cheapest first: the bookies' locks are taken (on the event
            # loop) only once every row is there
            if not all(count_rows(ag) == total for ag in agents):
                return False
            shared_rows = [rows(ag, SHARED_BASE) for ag in agents]
            if any(r != shared_rows[0] for r in shared_rows):
                return False
            return all(booked_contains(ag, other.actor_id, 1, versions)
                       for ag in agents for other in agents
                       if other is not ag)

        ok = await wait_until(converged, timeout=timeout, step=0.1)
        wall = time.monotonic() - t0
        if not ok:
            raise AssertionError(
                f"{api.name} cluster did not converge in {timeout} s: rows "
                f"{[count_rows(ag) for ag in agents]} of {total}")
        disjoint = [rows(ag, 0, SHARED_BASE) for ag in agents]
        shared_rows = [rows(ag, SHARED_BASE) for ag in agents]
        return {
            "agents": n_agents, "rows_total": total,
            "versions_per_writer": versions,
            "disjoint_digest": [digest(r) for r in disjoint],
            "disjoint_expected": digest(sorted(
                r for ai in range(n_agents)
                for r in own_rows(ai, txs, rows_per_tx))),
            "shared_digest": [digest(r) for r in shared_rows],
            "shared_writers": sorted({t.split("-")[0]
                                      for _i, t in shared_rows[0]}),
            "cluster_size": [ag.membership.cluster_size for ag in agents],
            "held_total": [api.held_total(ag.bookie) for ag in agents],
            "wall_s": wall,
            "array_lane": array_lane(agents),
        }
    finally:
        await shutdown_all(api, agents)


def cluster_checks(rec: dict) -> List[str]:
    """What must hold of a `cluster_run` record in either package."""
    bad = []
    n = rec["agents"]
    if set(rec["disjoint_digest"]) != {rec["disjoint_expected"]}:
        bad.append("disjoint ranges differ from the rows written")
    if len(set(rec["shared_digest"])) != 1:
        bad.append("shared ids differ across agents")
    if rec["cluster_size"] != [n] * n:
        bad.append(f"cluster sizes {rec['cluster_size']}")
    if len(set(rec["held_total"])) != 1:
        bad.append(f"held_total {rec['held_total']}")
    lane = rec["array_lane"]
    if lane is not None and lane["decided"] == 0:
        bad.append(f"array lane {lane}")
    return bad


# -- the socket transports under a live query ---------------------------------

NET_QUERY = "SELECT id, text FROM tests WHERE id % 4 = 0"
NET_SEED = 71
# `chip_smoke.py`'s agent_net: 10,000 rows in 50 transactions of 200 (cut
# from 20,000 in 100 for the phase's ~120 s: PERF.md §4)
CHIP_NET = dict(rows=10_000, txs=50)


def net_rows(rows: int) -> list:
    """The rows A writes: ids 1..rows, text from
    `random.Random(NET_SEED)`."""
    rng = random.Random(NET_SEED)
    return [(i, f"n{rng.getrandbits(48):012x}") for i in range(1, rows + 1)]


class _EventTally:
    """Drains one subscription queue (live query or table updates) into
    counts per event kind, until the queue ends or `stop`."""

    def __init__(self, q: asyncio.Queue):
        self.q = q
        self.kinds: dict = {}
        self.task = asyncio.ensure_future(self._drain())

    async def _drain(self) -> None:
        while True:
            item = await self.q.get()
            if item is None or not isinstance(item, (list, tuple)):
                return
            for ev in item if isinstance(item, list) else (item,):
                kind = getattr(ev, "kind", None) or ev[0]
                self.kinds[kind] = self.kinds.get(kind, 0) + 1

    async def stop(self) -> None:
        self.task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await self.task


class _InProcess:
    """`scenario_net`'s plane: A writes through its store (`insert_many`),
    and B's and C's events come off the agents' own live-query and
    `tests` update handles, attached before their stores see a row of
    the run. The SLO canary is on."""

    prefix = "net"

    def __init__(self, api, rows: int):
        self.api, self.rows = api, rows
        self.watches: dict = {}

    def tune(self, cfg) -> None:
        cfg.slo.canary = True
        cfg.sync.snapshot = False

    async def attach(self, name: str, agent, watched: bool) -> None:
        if watched:
            handle, _ = await agent.subs.get_or_insert(NET_QUERY)
            upd, _ = await agent.updates.get_or_insert("tests")
            self.watches[name] = (handle, _EventTally(handle.attach()),
                                  _EventTally(upd.attach()))

    async def write(self, items) -> None:
        await insert_many(self.api, self.agents[0], items)

    def complete(self, name: str, agent) -> bool:
        _h, sub, _u = self.watches[name]
        return (count_rows(agent) == self.rows
                and sub.kinds.get("insert", 0) >= self.rows // 4)

    def state(self, name: str) -> str:
        handle, sub, _u = self.watches[name]
        return f"{sub.kinds} events, live query error {handle.error}"

    async def settle(self) -> None:
        # the port's agents count what their canary saw (JAX: None)
        seen = [getattr(ag, "canary_seen", None) for ag in self.agents]
        await wait_until(lambda: all(s is None or s["local"] > 0
                                     for s in seen), timeout=10.0)
        # the update handles flush on their own task
        await wait_until(
            lambda: all(u.kinds.get("insert", 0) >= self.rows
                        for _h, _s, u in self.watches.values()), timeout=10.0)

    async def observe(self, name: str, agent, since: float) -> dict:
        handle, sub, upd = self.watches[name]
        mat = sorted(tuple(v) for _rid, v in handle.matcher.all_rows())
        return {"sub_digest": digest(mat), "sub_rows": len(mat),
                "query_digest": digest(query(agent, NET_QUERY + " ORDER BY id")),
                "events": dict(sorted(sub.kinds.items())),
                "updates": dict(sorted(upd.kinds.items()))}

    async def finish(self, out: dict) -> None:
        out["canary_seen"] = [
            None if s is None else dict(s)
            for s in (getattr(ag, "canary_seen", None) for ag in self.agents)]

    async def close(self) -> None:
        for _h, sub, upd in self.watches.values():
            await sub.stop()
            await upd.stop()


async def _scenario(api, db_dir: str, transport: str, plane, rows: int,
                    txs: int, timeout: float) -> dict:
    """The body `scenario_net` and `scenario_api` share. Agents A and B
    boot on `transport` (delta sync only), A writes `net_rows(rows)` in
    `txs` transactions, and once B's watches hold every row, C boots with
    the same watches and catches up by delta sync. `plane` says how the
    agents are reached: `tune` and `attach` (just before each agent
    runs), `write`, `complete`, `state` (for a failure's message),
    `settle`, `observe` (per watched agent), `finish` and `close`."""
    net = api.MemNetwork(seed=37) if transport == "mem" else None
    addrs = ([f"{plane.prefix}-{x}" for x in "abc"] if transport == "mem"
             else [loopback_addr(transport) for _ in range(3)])
    expected = net_rows(rows)
    agents = plane.agents = []

    async def start(i: int, bootstrap, watched: bool):
        name = "abc"[i]
        agents.append(await boot(
            api, net, addrs[i], db_dir, bootstrap, tune=plane.tune,
            transport=transport,
            before_run=lambda ag: plane.attach(name, ag, watched)))
        return agents[-1]

    async def converge(name: str, ag) -> None:
        if not await wait_until(lambda: plane.complete(name, ag),
                                timeout=timeout, step=0.05):
            raise AssertionError(
                f"{api.name} {transport}: {name.upper()} holds "
                f"{count_rows(ag)} of {rows} rows, {plane.state(name)}")

    try:
        t_boot = time.monotonic()
        await start(0, [], False)
        b = await start(1, [addrs[0]], True)
        await _sizes(agents, 2, 20.0)
        per = -(-rows // txs)
        t0 = time.monotonic()
        for k in range(0, rows, per):
            await plane.write(expected[k:k + per])
        write_s = time.monotonic() - t0
        await converge("b", b)
        t_b = time.monotonic()
        c = await start(2, addrs[:2], True)
        await converge("c", c)
        wall_c = time.monotonic() - t_b
        await plane.settle()
        out = {"transport": transport, "rows": rows, "txs": txs,
               "expected_digest": digest(expected),
               "rows_digest": [digest(query(
                   ag, "SELECT id, text FROM tests ORDER BY id"))
                   for ag in agents]}
        for name, ag, since in (("b", b, t0), ("c", c, t_b)):
            out[name] = await plane.observe(name, ag, since)
        out["array_lane"] = {name: getattr(ag.store, "array_lane", None)
                             for name, ag in zip("abc", agents)}
        out["walls"] = {"write_s": write_s,
                        "b_boot_to_converged_s": t_b - t_boot,
                        "b_all_rows_s": t_b - t0, "c_catch_up_s": wall_c}
        await plane.finish(out)
        return out
    finally:
        await plane.close()
        # together: an agent left alone would spend its shutdown trying
        # to tell peers that are already gone
        done = await asyncio.gather(*(api.shutdown(ag) for ag in agents),
                                    return_exceptions=True)
        errors = [e for e in done if isinstance(e, BaseException)]
        if errors:
            raise errors[0]


async def scenario_net(api, db_dir: str, transport: str, rows: int = 400,
                       txs: int = 4, timeout: float = 120.0) -> dict:
    """`_scenario` in process (`_InProcess`): B attaches `NET_QUERY` and
    the `tests` update handle, A writes through its store, the SLO canary
    is on.

    Returns, per agent, the rows digest, and for B and C the live query's
    materialized rows (digest, count), the digest of a SELECT on the
    agent's store, the live query's event counts per kind, the update
    handle's, the port's array lane, what each canary saw and the
    walls."""
    return await _scenario(api, db_dir, transport, _InProcess(api, rows),
                           rows, txs, timeout)


def _outcome(rec: dict, name: str, keys) -> dict:
    return {"rows_digest": rec["rows_digest"][0],
            **{k: rec[name][k] for k in keys}}


def net_outcome(rec: dict, name: str = "b") -> dict:
    """The part of a `scenario_net` record that must equal the JAX
    package's (`chip_smoke.NET_REF`), for watched agent `name`: the same
    in every run."""
    return _outcome(rec, name, ("sub_digest", "sub_rows", "events",
                                "updates"))


def _watched_checks(rec: dict, ref: dict, outcome) -> List[str]:
    """What must hold of either scenario's record against `ref` (the
    JAX package's `outcome`): every agent's rows, and on B and C the
    outcome, the stream's rows against the agent's query, one insert
    event per live-query row and per row, and decided batches."""
    bad = []
    if set(rec["rows_digest"]) != {ref["rows_digest"]}:
        bad.append(f"rows digests {rec['rows_digest']}")
    if rec["expected_digest"] != ref["rows_digest"]:
        bad.append("the reference's rows are not the rows written")
    for name in ("b", "c"):
        got = outcome(rec, name)
        for key, want in ref.items():
            if got[key] != want:
                bad.append(f"{name}.{key} {got[key]} != {want}")
        got = rec[name]
        if got["query_digest"] != got["sub_digest"]:
            bad.append(f"{name}: the live query's rows differ from its query")
        if got["events"].get("insert") != rec["rows"] // 4:
            bad.append(f"{name}: {got['events']} insert events, "
                       f"expected {rec['rows'] // 4}")
        if got["updates"].get("insert") != rec["rows"]:
            bad.append(f"{name}: {got['updates']} update events, "
                       f"expected {rec['rows']}")
        lane = rec["array_lane"][name]
        if lane is not None and lane["decided"] == 0:
            bad.append(f"{name}: array lane {lane}")
    return bad


def net_checks(rec: dict, ref: dict) -> List[str]:
    """What must hold of a `scenario_net` record against the reference
    outcome `ref` (`net_outcome` of the JAX package's run)."""
    bad = _watched_checks(rec, ref, net_outcome)
    seen = rec["canary_seen"]
    if any(s is not None and s["local"] == 0 for s in seen):
        bad.append(f"canary not observed: {seen}")
    return bad


# -- the public API over the socket transports --------------------------------

# GET endpoints of planes the port has not ported yet (ROADMAP §1 item
# 9.5): their bodies with `actor_id` masked must equal the JAX package's
# with those planes off
PLANES_OFF_PATHS = ("/v1/traces", "/v1/alerts", "/v1/remediation",
                    "/v1/profile")
# what a stream may end with once its server stops: a clean end or a
# typed error of the client (`tests/test_chaos.py`'s set, and the h2
# transport's `StreamReset` for the updates stream, which has no retry)
RESTART_BUDGET_S = 20.0
STOP_BUDGET_S = 10.0


class _StreamTally:
    """Consumes one NDJSON stream of the API client (a subscription or
    table updates) in a task: event counts per kind, the subscription's
    materialized rows, the first and last change times, and how the
    stream ended (`end`: "end", or the exception's class name)."""

    def __init__(self, it, typed: tuple):
        self.typed = typed
        self.kinds: dict = {}
        self.rows: dict = {}
        self.eoq = asyncio.Event()
        self.first = self.last = None
        self.end = None
        self.ended_typed = None
        self.task = asyncio.ensure_future(self._drain(it))

    def _event(self, kind: str) -> None:
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self.last = time.monotonic()
        if self.first is None:
            self.first = self.last

    async def _drain(self, it) -> None:
        try:
            async for ev in it:
                if "row" in ev:
                    rowid, values = ev["row"]
                    self.rows[rowid] = values
                elif "eoq" in ev:
                    self.eoq.set()
                elif "change" in ev:
                    kind, rowid, values, _cid = ev["change"]
                    if kind == "delete":
                        self.rows.pop(rowid, None)
                    else:
                        self.rows[rowid] = values
                    self._event(kind)
                elif "notify" in ev:
                    self._event(ev["notify"][0])
            self.end, self.ended_typed = "end", True
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — recorded, then judged
            self.end = type(e).__name__
            self.ended_typed = isinstance(e, self.typed)

    def materialized(self) -> list:
        return sorted(tuple(v) for v in self.rows.values())

    def rate(self, since: float) -> float:
        n = sum(self.kinds.values())
        return n / (self.last - since) if n and self.last > since else 0.0

    async def stop(self) -> None:
        self.task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await self.task


async def _get_json(client, path: str):
    session = await client._ensure()
    async with session.get(f"{client.base}{path}") as resp:
        return resp.status, await resp.json()


def _masked(body):
    if isinstance(body, dict) and "actor_id" in body:
        return {**body, "actor_id": "<actor>"}
    return body


async def _open_streams(api, agent, client, typed) -> tuple:
    """The subscription on `NET_QUERY` and the `tests` updates stream,
    both attached on the server before this returns."""
    sub = _StreamTally(client.subscribe(NET_QUERY).__aiter__(), typed)
    upd = _StreamTally(client.updates("tests").__aiter__(), typed)
    await asyncio.wait_for(sub.eoq.wait(), 30.0)

    def updates_attached() -> bool:
        return any(h.table == "tests" and h.subscriber_count > 0
                   for h in agent.updates.handles())

    if not await wait_until(updates_attached, timeout=30.0):
        raise AssertionError(f"{api.name}: the updates stream never attached")
    return sub, upd


def _hpack_codec(client) -> str:
    """The HPACK encoder's class on `client`'s live h2 connection."""
    return type(client._session.h2._conn.deflater).__name__


class _ThroughApi:
    """`scenario_api`'s plane: every agent runs an `ApiServer` on
    `127.0.0.1:0` and every client is the package's h2
    `CorrosionApiClient`. A's client writes with `/v1/transactions`; B's
    and C's clients open a `/v1/subscriptions` stream on `NET_QUERY` and a
    `/v1/updates/tests` stream before their agents run. With `restart`,
    `finish` stops B's API with both streams live."""

    prefix = "api"

    def __init__(self, api, rows: int, restart: bool):
        import aiohttp

        self.api, self.rows, self.restart = api, rows, restart
        self.typed = (aiohttp.ClientError, ConnectionError, api.ClientError,
                      api.StreamReset)
        self.servers, self.clients, self.streams = {}, {}, {}

    def tune(self, cfg) -> None:
        cfg.sync.snapshot = False

    async def attach(self, name: str, agent, watched: bool) -> None:
        server = self.servers[name] = self.api.ApiServer(agent)
        agent.config.api.bind_addr = ["127.0.0.1:0"]
        await server.start()
        client = self.clients[name] = self.api.CorrosionApiClient(
            server.addrs[0])
        if watched:
            self.streams[name] = await _open_streams(
                self.api, agent, client, self.typed)

    async def write(self, items) -> None:
        res = await self.clients["a"].execute([
            ["INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
             list(it)] for it in items])
        if len(res["results"]) != len(items):
            raise AssertionError(f"{self.api.name}: transaction {res}")

    def complete(self, name: str, agent) -> bool:
        sub, upd = self.streams[name]
        return (sub.kinds.get("insert", 0) >= self.rows // 4
                and upd.kinds.get("insert", 0) >= self.rows
                and count_rows(agent) == self.rows)

    def state(self, name: str) -> str:
        sub, upd = self.streams[name]
        return f"streams {sub.kinds} {upd.kinds} ({sub.end}, {upd.end})"

    async def settle(self) -> None:
        # the streams' last events may trail the row counts
        await asyncio.sleep(0.3)

    async def observe(self, name: str, agent, since: float) -> dict:
        sub, upd = self.streams[name]
        client = self.clients[name]
        mat = sub.materialized()
        got = await client.query_rows([NET_QUERY + " ORDER BY id", []])
        # the same query over HTTP/1.1 on the same port (the front's byte
        # pump to aiohttp)
        h1 = self.api.CorrosionApiClient(self.servers[name].addrs[0],
                                         http2=False)
        try:
            got_h1 = await asyncio.wait_for(
                h1.query_rows([NET_QUERY + " ORDER BY id", []]), 30.0)
        finally:
            await asyncio.wait_for(h1.close(), 10.0)
        _st, status = await _get_json(client, "/v1/status")
        planes = {}
        for path in PLANES_OFF_PATHS:
            code, body = await _get_json(client, path)
            planes[path] = [code, _masked(body)]
        return {
            "sub_digest": digest(mat), "sub_rows": len(mat),
            "query_digest": digest([tuple(r) for r in got]),
            "h1_query_digest": digest([tuple(r) for r in got_h1]),
            "events": dict(sorted(sub.kinds.items())),
            "updates": dict(sorted(upd.kinds.items())),
            "chaos": status["chaos"],
            "planes_off": planes,
            "rate_per_s": {"subscription": sub.rate(since),
                           "updates": upd.rate(since)},
            "first_event_s": sub.first - since,
            "hpack_codec": _hpack_codec(client),
        }

    async def finish(self, out: dict) -> None:
        out["walls"]["b_first_row_s"] = out["b"]["first_event_s"]
        if not self.restart:
            return
        # B's API stops with both of its streams live; both must end
        # within one budget counted from the stop
        t = time.monotonic()
        await asyncio.wait_for(self.servers["b"].stop(), STOP_BUDGET_S)
        stop_s = time.monotonic() - t
        sub, upd = self.streams["b"]
        await asyncio.wait({sub.task, upd.task},
                           timeout=max(0.0, RESTART_BUDGET_S - stop_s))
        out["restart"] = {
            "stop_s": stop_s, "ended_s": time.monotonic() - t,
            "subscription": [sub.end, sub.ended_typed],
            "updates": [upd.end, upd.ended_typed],
        }

    async def close(self) -> None:
        for tally in (t for pair in self.streams.values() for t in pair):
            await tally.stop()
        for client in self.clients.values():
            with contextlib.suppress(Exception):
                await asyncio.wait_for(client.close(), 10.0)
        for server in self.servers.values():
            with contextlib.suppress(Exception):
                await asyncio.wait_for(server.stop(), STOP_BUDGET_S)


async def scenario_api(api, db_dir: str, transport: str, rows: int = 400,
                       txs: int = 4, timeout: float = 120.0,
                       restart: bool = True) -> dict:
    """`_scenario` through the public API (`_ThroughApi`). Then, on B and
    C: the stream's rows, `/v1/queries` over h2 and over HTTP/1.1 on the
    same port, `/v1/status`'s chaos census, the
    plane-off endpoints and the HPACK codec the client's connection ran.
    Last, with `restart`, B's API stops with both streams live (the JAX
    package's `ApiServer.stop` does not return there: its reference run
    passes `restart=False`).

    Returns, per watched agent, the outcome `api_outcome` compares, and
    the array lanes, the restart check and the walls."""
    return await _scenario(api, db_dir, transport,
                           _ThroughApi(api, rows, restart), rows, txs,
                           timeout)


def api_outcome(rec: dict, name: str = "b") -> dict:
    """The part of a `scenario_api` record that must equal the JAX
    package's (`chip_smoke.API_REF`), for watched agent `name`."""
    return _outcome(rec, name, ("sub_digest", "sub_rows", "query_digest",
                                "events", "updates", "chaos", "planes_off"))


def api_checks(rec: dict, ref: dict, restart: bool = True) -> List[str]:
    """What must hold of a `scenario_api` record against `ref`
    (`api_outcome` of the JAX package's run); `restart`: the record must
    hold a passed restart check."""
    bad = _watched_checks(rec, ref, api_outcome)
    for name in ("b", "c"):
        got = rec[name]
        if got["h1_query_digest"] != got["query_digest"]:
            bad.append(f"{name}: /v1/queries over HTTP/1.1 differs from h2")
        if got["chaos"]["active"] is not False:
            bad.append(f"{name}: chaos census {got['chaos']}")
    rs = rec.get("restart")
    if rs is None:
        return bad + ["no restart check in the record"] if restart else bad
    if rs["stop_s"] > STOP_BUDGET_S:
        bad.append(f"api.stop() took {rs['stop_s']} s")
    if rs["ended_s"] > RESTART_BUDGET_S:
        bad.append(f"restart: the streams took {rs['ended_s']} s to end")
    for stream in ("subscription", "updates"):
        end, typed = rs[stream]
        if end is None or not typed:
            bad.append(f"restart: {stream} stream ended {end!r} "
                       f"(typed: {typed}) within {RESTART_BUDGET_S} s")
    return bad
