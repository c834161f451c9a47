"""The port's live-query engine (`pubsub/`, `api/types.py`,
`api/pubsub_http.py::expand_sql`) and its wiring into the agent against
the JAX package's on the CPU.

`parse_select` must give equal `ParsedSelect`s over a corpus of joins,
self-joins, LEFT JOINs and the forms it rejects, and `expand_sql` equal
text or an equal refusal. Then the same seeded write transactions run on
a store of each package, and each batch of captured changes (equal in
both) is fed to that package's `SubsManager` and `UpdatesManager`: every
subscription's event sequence (kind, values, change id), every sub
database on disk and the table updates must be identical, through a
delete-then-reinsert in one batch and a restore from disk after writes
that landed while no matcher ran. Matchers diff each batch alone
(`batch_wait=0`), and each batch is fed only once the previous one is
diffed, so the sequences do not depend on timing.

On agents: two port agents on the in-memory network with the SLO
canary on each observe their own canary and the other's, and
`agent_checks.scenario_net` (a live query on B and on a late joiner C
while A writes) over plaintext QUIC and TCP at 400 rows gives the JAX
package's outcome.

    JAX_PLATFORMS=cpu python -m tests.test_torch_pubsub --ref

prints `chip_smoke.NET_REF`, the JAX package's `scenario_net` at the
chip phase's size (`agent_checks.CHIP_NET`) over QUIC and over TCP
(about two minutes).
"""

import asyncio
import dataclasses
import sqlite3
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from corrosion_tpu.api import pubsub_http as japi_http
from corrosion_tpu.api import types as japi_types
from corrosion_tpu.pubsub import manager as jmanager
from corrosion_tpu.pubsub import parse as jparse
from corrosion_tpu.pubsub import updates as jupdates
from corrosion_tpu.store.crdt import CrdtStore as JStore
from corrosion_tpu.types.actor import ActorId as JActorId
from corrosion_tpu.types.base import Timestamp as JTimestamp
from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch.api import pubsub_http as tapi_http
from corrosion_tpu_torch.api import types as tapi_types
from corrosion_tpu_torch.pubsub import manager as tmanager
from corrosion_tpu_torch.pubsub import parse as tparse
from corrosion_tpu_torch.pubsub import updates as tupdates
from corrosion_tpu_torch.store.crdt import CrdtStore as TStore
from corrosion_tpu_torch.types.actor import ActorId as TActorId
from corrosion_tpu_torch.types.base import Timestamp as TTimestamp

from tests.test_torch_agent import jax_api

SCHEMA = """
CREATE TABLE users (
  id INTEGER NOT NULL PRIMARY KEY,
  name TEXT NOT NULL DEFAULT '',
  age INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE posts (
  user_id INTEGER NOT NULL,
  post_id INTEGER NOT NULL,
  title TEXT,
  PRIMARY KEY (user_id, post_id)
);
"""
QUERIES = (
    "SELECT name, age FROM users WHERE age >= 18",
    "SELECT u.name, p.title FROM users u JOIN posts p ON p.user_id = u.id",
    "SELECT a.name, b.name FROM users a JOIN users b ON b.id = a.age",
    "SELECT u.name, p.title FROM users u"
    " LEFT JOIN posts p ON p.user_id = u.id",
    "SELECT name FROM users ORDER BY age DESC",
    "SELECT * FROM posts WHERE title LIKE 't%'",
)
REJECTED = (
    "INSERT INTO users VALUES (1, 'x', 2)",
    "SELECT 1",
    "SELECT * FROM nope",
    "SELECT * FROM users UNION SELECT * FROM users",
    "WITH x AS (SELECT 1) SELECT * FROM x",
    "SELECT name FROM users LIMIT 1",
    "SELECT age, count(*) FROM users GROUP BY age",
    "SELECT name FROM users ORDER BY age LIMIT 2",
)
TIMEOUT_S = 60.0


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        return SimpleNamespace(
            name=name, parse=jparse, manager=jmanager, updates=jupdates,
            Timestamp=JTimestamp,
            store=lambda path: JStore(path, site_id=JActorId(bytes([5]) * 16)))
    return SimpleNamespace(
        name=name, parse=tparse, manager=tmanager, updates=tupdates,
        Timestamp=TTimestamp,
        store=lambda path: TStore(path, site_id=TActorId(bytes([5]) * 16),
                                  device="cpu"))


def _parsed(mod, sql: str, schema):
    try:
        p = mod.parse_select(sql, schema)
    except mod.ParseError as e:
        return ("ParseError", str(e))
    return dataclasses.asdict(p), sorted(p.routing_keys())


def test_parse_select_equals_jax(tmp_path):
    schemas = []
    for pkg in (_pkg("jax"), _pkg("port")):
        st = pkg.store(str(tmp_path / f"{pkg.name}.db"))
        st.apply_schema_sql(SCHEMA)
        schemas.append(st)
    corpus = QUERIES + REJECTED + (
        "SELECT * FROM users",
        "SELECT DISTINCT u.name FROM users AS u, posts AS p"
        " WHERE p.user_id = u.id AND p.title IS NOT NULL",
        'SELECT "u"."name" FROM "users" "u" WHERE u.age > ?',
        "SELECT name FROM users WHERE id IN (SELECT user_id FROM posts)",
        "select name from users where name = 'it''s' -- trailing",
        "SELECT a.id, b.id, c.id FROM users a JOIN users b ON a.age = b.id"
        " LEFT JOIN users c ON c.id = b.age",
        "SELECT u.name FROM users u RIGHT JOIN posts p ON p.user_id = u.id",
    )
    for sql in corpus:
        j = _parsed(jparse, sql, schemas[0].schema)
        t = _parsed(tparse, sql, schemas[1].schema)
        assert t == j, sql
    assert sum(1 for sql in REJECTED
               if _parsed(tparse, sql, schemas[1].schema)[0] == "ParseError"
               ) == len(REJECTED)
    for st in schemas:
        st.close()


def _expand(types_mod, http_mod, obj):
    try:
        return http_mod.expand_sql(types_mod.parse_statement(obj))
    except Exception as e:  # noqa: BLE001 - the refusal is compared
        return (type(e).__name__, str(e))


def test_expand_sql_equals_jax():
    rng = np.random.default_rng(11)
    corpus = [
        "SELECT * FROM t",
        ["SELECT * FROM t WHERE x = :a AND y = :ab", {"a": 1, "ab": 2}],
        ["SELECT * FROM t WHERE x = ? AND y = ':a ?'", [5]],
        ["SELECT * FROM t WHERE x = ?", [1, 2]],
        ["SELECT * FROM t WHERE a = ?2 OR b = ?1", [10, 20]],
        ["SELECT * FROM t WHERE a = ?1 OR b = ?1", [7]],
        ["SELECT * FROM t WHERE a = ?2 AND b = ?", [1, 2, 3]],
        ["SELECT * FROM t WHERE a = ?5", [1]],
        ["SELECT * FROM t WHERE a = @x AND b = $y AND c = :z",
         {"x": 1, "y": 2, "z": 3}],
        ["SELECT * FROM t WHERE a = :missing", {"x": 1}],
        ["SELECT * FROM t WHERE a = ? AND b = ? AND c = ?",
         [None, 2.5, "o'neil"]],
    ]
    for _ in range(30):
        n = int(rng.integers(1, 5))
        vals = [int(v) for v in rng.integers(-1000, 1000, n)]
        sql = "SELECT * FROM t WHERE " + " AND ".join(
            f"c{i} = ?{int(rng.integers(1, n + 1))}" for i in range(n))
        corpus.append([sql, vals])
    for obj in corpus:
        j = _expand(japi_types, japi_http, obj)
        assert _expand(tapi_types, tapi_http, obj) == j, obj
    assert tapi_types.dump_value(b"\x01\x02") == japi_types.dump_value(
        b"\x01\x02")


# -- the same change batches through both engines -----------------------------


def _transactions(seed: int, n_tx: int) -> list:
    """Seeded write transactions (lists of (sql, params)) over users and
    posts, grouped into batches of 1-3 transactions; one batch deletes
    and re-inserts one user."""
    rng = np.random.default_rng(seed)
    txs = []
    for _ in range(n_tx):
        tx = []
        for _ in range(int(rng.integers(1, 4))):
            op = int(rng.integers(0, 7))
            uid = int(rng.integers(0, 12))
            if op <= 1:
                tx.append(("INSERT OR REPLACE INTO users (id, name, age)"
                           " VALUES (?, ?, ?)",
                           [uid, f"u{int(rng.integers(100))}",
                            int(rng.integers(0, 30))]))
            elif op == 2:
                tx.append(("UPDATE users SET age = ? WHERE id = ?",
                           [int(rng.integers(0, 30)), uid]))
            elif op == 3:
                tx.append(("DELETE FROM users WHERE id = ?", [uid]))
            elif op == 4:
                tx.append(("INSERT OR REPLACE INTO posts (user_id, post_id,"
                           " title) VALUES (?, ?, ?)",
                           [uid, int(rng.integers(0, 3)),
                            ["t1", "t2", "x3"][int(rng.integers(3))]]))
            elif op == 5:
                tx.append(("UPDATE posts SET title = ? WHERE user_id = ?",
                           [f"t{int(rng.integers(9))}", uid]))
            else:
                tx.append(("DELETE FROM posts WHERE user_id = ?", [uid]))
        txs.append(tx)
    batches = []
    while txs:
        k = int(rng.integers(1, 4))
        batches.append(txs[:k])
        txs = txs[k:]
    batches.insert(len(batches) // 2, [
        [("INSERT OR REPLACE INTO users (id, name, age) VALUES (3, 'z', 20)",
          [])],
        [("DELETE FROM users WHERE id = 3", [])],
        [("INSERT INTO users (id, name, age) VALUES (3, 'back', 21)", [])],
    ])
    return batches


def _write(pkg, store, tx) -> list:
    with store.write_tx(pkg.Timestamp(0)) as w:
        for sql, params in tx:
            w.execute(sql, params)
        changes, _version, _seq = w.commit()
    return changes


def _change_key(ch) -> tuple:
    return (ch.table, ch.pk, ch.cid, ch.val, ch.col_version, ch.db_version,
            ch.seq, bytes(ch.site_id), ch.cl)


def _idle(handle) -> bool:
    """The matcher's loop waits on an empty candidate queue."""
    q = handle._queue
    return q.empty() and any(not f.done() for f in q._getters)


async def _settle(handles) -> None:
    await asyncio.sleep(0.005)
    while not all(_idle(h) for h in handles):
        await asyncio.sleep(0.005)


def _drain(q) -> list:
    out = []
    while not q.empty():
        item = q.get_nowait()
        if isinstance(item, list):
            out.extend((ev.kind, ev.values, ev.change_id) for ev in item)
        else:
            out.append(("end", repr(item)))
    return out


def _dump_sub_dbs(subs_path: Path) -> dict:
    """Every sub database's tables, keyed by the subscription's SQL: all
    but a diff's scratch (`temp_<table>`, the batch's candidate pks, and
    `state_results`), which the next diff overwrites and whose last
    contents depend on which of a restore's per-table sweeps ran last."""
    out = {}
    for db in sorted(subs_path.glob("*/sub.sqlite")):
        conn = sqlite3.connect(db)
        try:
            tables = [r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type = 'table'"
                " AND name NOT LIKE 'temp\\_%' ESCAPE '\\'"
                " AND name != 'state_results' ORDER BY name")]
            dump = {t: conn.execute(f'SELECT * FROM "{t}"').fetchall()
                    for t in tables}
        finally:
            conn.close()
        sql = dict(dump["meta"])["sql"]
        out[sql] = dump
    return out


async def _drive(pkg, tmp: Path, batches, late) -> dict:
    store = pkg.store(str(tmp / "main.db"))
    store.apply_schema_sql(SCHEMA)
    subs_path = tmp / "subs"
    for tx in batches[0]:
        _write(pkg, store, tx)  # rows before the initial materialization
    subs = pkg.manager.SubsManager(store, str(subs_path), batch_wait=0.0)
    updates = pkg.updates.UpdatesManager(store)
    handles = []
    for sql in QUERIES:
        h, created = await subs.get_or_insert(sql)
        assert created
        handles.append(h)
    initial = [h.matcher.snapshot() for h in handles]
    queues = [h.attach() for h in handles]
    uh, _ = await updates.get_or_insert("users")
    uq = uh.attach()
    fed, upd_events = [], []
    for batch in batches[1:]:
        changes = [ch for tx in batch for ch in _write(pkg, store, tx)]
        fed.append([_change_key(ch) for ch in changes])
        subs.match_changes(changes)
        updates.match_changes(changes)
        await _settle(handles)
        want = len({ch.pk for ch in changes if ch.table == "users"})
        for _ in range(want):
            kind, pk = await asyncio.wait_for(uq.get(), 10)
            upd_events.append((kind, pk))
        # a batch's update events flush together: no stragglers
        assert uq.empty()
    events = {sql: _drain(q) for sql, q in zip(QUERIES, queues)}
    await updates.stop_all()
    await subs.stop_all()
    dbs = _dump_sub_dbs(subs_path)
    # writes while no matcher runs, then a restore from disk
    for tx in late:
        fed.append([_change_key(ch) for ch in _write(pkg, store, tx)])
    subs2 = pkg.manager.SubsManager(store, str(subs_path), batch_wait=0.0)
    assert await subs2.restore() == len(QUERIES)
    restored = [subs2.get_by_sql(sql) for sql in QUERIES]
    await _settle(restored)
    rq = [h.attach() for h in restored]
    # the resync's events were fanned out before the attach: read them
    # back from each changes log past the last id before the restore
    after = {sql: [(e.kind, e.values, e.change_id)
                   for e in h.changes_since(
                       max((c for _k, _v, c in events[sql]), default=0))]
             for sql, h in zip(QUERIES, restored)}
    assert all(q.empty() for q in rq)
    await subs2.stop_all()
    out = {"fed": fed, "initial": initial, "events": events,
           "updates": upd_events, "sub_dbs": dbs, "restored": after,
           "sub_dbs_after_restore": _dump_sub_dbs(subs_path)}
    store.close()
    return out


def test_subs_and_updates_managers_equal_jax(tmp_path, monkeypatch):
    # the table-update flush window, cut from 600 ms in both packages
    monkeypatch.setattr(jupdates, "BATCH_WAIT", 0.01)
    monkeypatch.setattr(tupdates, "BATCH_WAIT", 0.01)
    batches = _transactions(seed=21, n_tx=40)
    late = _transactions(seed=22, n_tx=6)[0] + [
        [("DELETE FROM users WHERE id = 3", [])]]
    got = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        got[name] = asyncio.run(asyncio.wait_for(
            _drive(_pkg(name), d, batches, late), TIMEOUT_S))
    j, t = got["jax"], got["port"]
    assert t["fed"] == j["fed"]
    for key in ("initial", "events", "updates", "sub_dbs", "restored",
                "sub_dbs_after_restore"):
        assert t[key] == j[key], key
    # the run exercised every kind of event, and the restore saw changes
    kinds = {k for evs in t["events"].values() for k, _v, _c in evs}
    assert kinds == {"insert", "update", "delete"}
    assert sum(len(v) for v in t["restored"].values()) > 0
    assert {k for k, _pk in t["updates"]} == {"insert", "update", "delete"}


# -- agents -------------------------------------------------------------------


def test_canary_observes_local_and_remote_on_port_agents(tmp_path):
    api = ac.port_api("cpu")

    def tune(cfg):
        cfg.slo.canary = True  # the SLO canary, on for this test
        cfg.slo.canary_interval_secs = 0.2

    async def main():
        net = api.MemNetwork(seed=41)
        agents = []
        try:
            agents.append(await ac.boot(api, net, "canary-a", str(tmp_path),
                                        tune=tune))
            agents.append(await ac.boot(api, net, "canary-b", str(tmp_path),
                                        ["canary-a"], tune=tune))
            await ac._sizes(agents, 2, 20.0)
            ok = await ac.wait_until(
                lambda: all(ag.canary_seen["local"] > 0
                            and ag.canary_seen["remote"] > 0
                            for ag in agents), timeout=20.0)
            return ok, [dict(ag.canary_seen) for ag in agents], [
                ac.query(ag, "SELECT COUNT(*) FROM corro_canary")[0][0]
                for ag in agents]
        finally:
            await ac.shutdown_all(api, agents)

    with cb.engine_env("array"):
        ok, seen, rows = asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))
    assert ok, seen
    assert rows == [2, 2]


@pytest.mark.parametrize("transport", ["quic", "tcp"])
def test_scenario_net_equals_jax(tmp_path, transport):
    recs = {}
    for name, api, engine in (("jax", jax_api(), "python"),
                              ("port", ac.port_api("cpu"), "array")):
        d = tmp_path / name
        d.mkdir()
        with cb.engine_env(engine):
            recs[name] = asyncio.run(asyncio.wait_for(
                ac.scenario_net(api, str(d), transport, rows=400, txs=4),
                TIMEOUT_S))
    ref = ac.net_outcome(recs["jax"])
    assert ac.net_checks(recs["jax"], ref) == []
    assert ac.net_checks(recs["port"], ref) == []
    assert ac.net_outcome(recs["port"]) == ref
    assert ref["events"] == {"insert": 100}
    assert ref["updates"] == {"insert": 400}
    lanes = recs["port"]["array_lane"]
    assert lanes["b"]["decided"] > 0 and lanes["c"]["decided"] > 0
    assert all(s["local"] > 0 for s in recs["port"]["canary_seen"])


def net_ref() -> dict:
    """`chip_smoke.NET_REF`: the JAX package's `scenario_net` at the chip
    phase's size, over each transport."""
    import tempfile

    out = {}
    for transport in ("quic", "tcp"):
        with cb.engine_env("python"), tempfile.TemporaryDirectory() as d:
            rec = asyncio.run(ac.scenario_net(
                jax_api(), d, transport, **ac.CHIP_NET, timeout=900.0))
        bad = ac.net_checks(rec, ac.net_outcome(rec))
        assert not bad, bad
        print(f"# {transport}: walls {rec['walls']}", flush=True)
        out[transport] = ac.net_outcome(rec)
    return out


if __name__ == "__main__":
    if "--ref" in sys.argv:
        print(f"NET_REF = {net_ref()!r}", flush=True)
