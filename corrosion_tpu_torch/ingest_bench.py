"""The remote-apply rungs of `scripts/bench_ingest.py` on the port's store.

    python -m corrosion_tpu_torch.ingest_bench [--out PATH]

Two streams of 20,000 remote changes go through `CrdtStore.apply_changes`
in batches of 500 into a file-backed store in a temporary directory, as
the script's `_apply_rung` does: `ingest-remote` (`gen_uniform`: one
site, columns a, b, c over 400 pks, rising col_versions) and
`ingest-conflict` (`gen_conflict`: 3 sites racing 200 pks through
delete/re-create transitions and equal-clock value ties). Each runs under
each merge engine (`CORRO_CRDT_ENGINE`); a rung records rows per second
on the host clock (ending in a sync of the card) and the digest of the
final state (`crdt_bench.state_digest`), which must not depend on the
engine. `apply_concurrently` applies both rungs under `array` into
several stores at once, one thread per store, as an agent's apply
workers and its peers' stores do: every store must still end at its
rung's digest.

The script's local-write rungs (`_local_write`) boot one agent (the
JAX package's agent test configuration with the runtime planes off,
`agent_checks.fast_config`) and drive its public write path,
`make_broadcastable_changes`: `ingest-local-w{1,4,16}` are 1, 4 and 16
concurrent writers sharing `TXS_TOTAL` transactions of `ROWS_PER_TX`
rows, and each `-durable` form commits with `PRAGMA synchronous = FULL`.
Each records rows per second, commit p50 and p99 on the host clock, and
a digest of the rows written, in today's default write mode (group
commit, the committer thread); the script's `--ab` pre modes are not
ported. A local commit decides nothing, so these rungs never run the
merge engine.

Prints one JSON line with the card's name and power limit; a record is
written only to `--out`. Runs on the card unless `run` is given
device="cpu".
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from corrosion_tpu_torch.crdt_bench import engine_env, state_digest
from corrosion_tpu_torch.runtime.device import card_line, resolve_device, sync
from corrosion_tpu_torch.store.crdt import CrdtStore
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import SENTINEL, Change
from corrosion_tpu_torch.types.pack import pack_columns

ENGINES = ("python", "native", "array")
TXS_TOTAL = 576
ROWS_PER_TX = 10
LOCAL_RUNGS = tuple((n, durable) for durable in (False, True)
                    for n in (1, 4, 16))
ROWS = 20_000
BATCH = 500
SCHEMA = (
    "CREATE TABLE kv (id INTEGER NOT NULL PRIMARY KEY,"
    " a TEXT NOT NULL DEFAULT '', b INTEGER NOT NULL DEFAULT 0,"
    " c TEXT NOT NULL DEFAULT '');"
)


def gen_uniform(n: int, n_pks: int, seed=0) -> list:
    """The script's `_gen_uniform`: low-conflict column writes of one
    site."""
    rng = random.Random(seed)
    site = ActorId(bytes([1]) * 16).bytes16
    ts = Timestamp.from_unix(1)
    out = []
    for i in range(n):
        pk = pack_columns([rng.randint(1, n_pks)])
        cid = rng.choice(["a", "b", "c"])
        val = rng.randint(0, 10**6) if cid == "b" else f"v{i}"
        out.append(
            Change(
                table="kv", pk=pk, cid=cid, val=val,
                col_version=i // n_pks + 1, db_version=i + 1, seq=0,
                site_id=site, cl=1, ts=ts,
            )
        )
    return out


def gen_conflict(n: int, seed=3) -> list:
    """The script's `_gen_conflict`: 3 sites race 200 pks through causal
    transitions (delete/re-create sentinels) and equal-clock value
    ties."""
    rng = random.Random(seed)
    sites = [ActorId(bytes([i]) * 16).bytes16 for i in (1, 2, 3)]
    ts = Timestamp.from_unix(2)
    out = []
    versions = {s: 0 for s in sites}
    for i in range(n):
        site = rng.choice(sites)
        pk = pack_columns([rng.randint(1, 200)])
        cl = rng.choice([1, 1, 1, 2, 3, 3, 4, 5])
        if cl % 2 == 0 or rng.random() < 0.1:
            cid, val = SENTINEL, None
        else:
            cid = rng.choice(["a", "b", "c"])
            # small value space: frequent equal-(cl, cv) ties
            val = rng.randint(0, 4) if cid == "b" else rng.choice(["x", "y"])
        versions[site] += rng.choice([0, 1])
        out.append(
            Change(
                table="kv", pk=pk, cid=cid, val=val,
                col_version=rng.randint(1, 3),
                db_version=max(1, versions[site]),
                seq=rng.randint(0, 3), site_id=site, cl=cl, ts=ts,
            )
        )
    return out


def rungs() -> dict:
    """The script's two remote rungs: name -> changes."""
    return {"ingest-remote": gen_uniform(ROWS, 400),
            "ingest-conflict": gen_conflict(ROWS)}


def apply_rung(rung: str, changes: list, batch: int, engine: str, tmp: str,
               device=None) -> dict:
    """The script's `_apply_rung` under `engine`: a fresh file-backed store
    in `tmp`, the changes in batches of `batch`, then the final state's
    digest."""
    dev = resolve_device(device)
    path = os.path.join(tmp, f"bench-{rung}-{engine}.db")
    if os.path.exists(path):
        os.unlink(path)
    with engine_env(engine):
        st = CrdtStore(path, device=dev)
        st.apply_schema_sql(SCHEMA)
        t0 = time.monotonic()
        for i in range(0, len(changes), batch):
            st.apply_changes(changes[i : i + batch])
        sync(dev)
        wall = time.monotonic() - t0
    digest = state_digest(st)
    st.close()
    return {"rung": rung, "engine": engine, "rows": len(changes),
            "batch": batch, "wall_s": wall, "rows_per_s": len(changes) / wall,
            "digest": digest}


def run(engines=ENGINES, device=None) -> dict:
    """Both rungs under each engine, with the card's name and power
    limit."""
    dev = resolve_device(device)
    out = {**card_line(dev), "device": str(dev), "rungs": []}
    streams = rungs()
    with tempfile.TemporaryDirectory(prefix="corro-ingest-") as tmp:
        for rung, changes in streams.items():
            for engine in engines:
                out["rungs"].append(
                    apply_rung(rung, changes, BATCH, engine, tmp, dev))
    return out


def apply_concurrently(device=None, stores: int = 3,
                       streams=None) -> list:
    """The remote rungs under `array`, each into `stores` file-backed
    stores at once: every store is fed its rung's batches in order by a
    thread of its own, so 2 x `stores` threads launch the decision
    program together, at both rungs' shapes. `streams` (default
    `rungs()`) maps a rung to its changes. Per store: its rung, the
    digest of its final state and its array lane."""
    dev = resolve_device(device)
    streams = streams or rungs()
    jobs = []
    with tempfile.TemporaryDirectory(prefix="corro-ingest-threads-") as tmp, \
            engine_env("array"):
        try:
            for rung, changes in streams.items():
                for k in range(stores):
                    st = CrdtStore(os.path.join(tmp, f"{rung}-{k}.db"),
                                   device=dev)
                    jobs.append((rung, changes, st))
                    st.apply_schema_sql(SCHEMA)
            start = threading.Barrier(len(jobs))

            def feed(changes, st) -> None:
                start.wait(timeout=60.0)
                for i in range(0, len(changes), BATCH):
                    st.apply_changes(changes[i : i + BATCH])

            with ThreadPoolExecutor(len(jobs)) as pool:
                for f in [pool.submit(feed, changes, st)
                          for _rung, changes, st in jobs]:
                    f.result()
            sync(dev)
            return [{"rung": rung, "digest": state_digest(st),
                     "lane": dict(st.array_lane)}
                    for rung, _changes, st in jobs]
        finally:
            for _rung, _changes, st in jobs:
                st.close()


async def local_write(n_writers: int, durable: bool = False, api=None,
                      device=None) -> dict:
    """The script's `_local_write` in its default mode: `n_writers`
    writers share `TXS_TOTAL` transactions of `ROWS_PER_TX` rows through
    one agent's `make_broadcastable_changes`, after one warm
    transaction."""
    from corrosion_tpu_torch import agent_checks as ac

    api = api or ac.port_api(device)
    name = f"bench-ingest-w{n_writers}{'d' if durable else ''}"
    net = api.MemNetwork(seed=11)
    with tempfile.TemporaryDirectory(prefix="corro-local-") as tmp:
        agent = await ac.boot(api, net, name, tmp)
        try:
            if durable:
                # the fsync-per-commit regime: every COMMIT syncs the WAL
                agent.store._conn.execute("PRAGMA synchronous = FULL")
            txs_per_writer = TXS_TOTAL // n_writers
            lat_ms: list = []
            sql = "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)"

            def mk_fn(base: int):
                rows = [(base + j, f"v{base + j}")
                        for j in range(ROWS_PER_TX)]

                def fn(tx):
                    return [tx.executemany(sql, rows)]

                return fn

            async def writer(w: int) -> None:
                for t in range(txs_per_writer):
                    base = (w * txs_per_writer + t) * ROWS_PER_TX
                    t0 = time.monotonic()
                    await api.make_broadcastable_changes(agent, mk_fn(base))
                    lat_ms.append((time.monotonic() - t0) * 1e3)

            await api.make_broadcastable_changes(agent, mk_fn(10_000_000))
            t0 = time.monotonic()
            await asyncio.gather(*(writer(w) for w in range(n_writers)))
            wall = time.monotonic() - t0
            digest = ac.digest(ac.rows(agent))
        finally:
            await api.shutdown(agent)
    rows = txs_per_writer * n_writers * ROWS_PER_TX
    lat_ms.sort()
    return {
        "rung": f"ingest-local-w{n_writers}"
                f"{'-durable' if durable else ''}",
        "writers": n_writers, "durable": durable,
        "txs": txs_per_writer * n_writers, "rows_per_tx": ROWS_PER_TX,
        "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
        "commit_p50_ms": lat_ms[len(lat_ms) // 2],
        "commit_p99_ms": lat_ms[int(len(lat_ms) * 0.99) - 1],
        "digest": digest,
    }


def run_local(api=None, device=None) -> list:
    """The six local-write rungs, in the script's order."""
    return [asyncio.run(local_write(n, durable, api=api, device=device))
            for n, durable in LOCAL_RUNGS]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the record here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)
    out = run()
    out["local_rungs"] = run_local()
    out["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
