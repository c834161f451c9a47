"""Workloads that hold the port's CRDT store to the JAX package's store.

Each one is written over a small `api` namespace (a store factory, the
change and changeset types, the codec), so the same code drives either
package's `CrdtStore`: `chip_smoke.py` runs the port's on the card, and
the tests run the reference's beside it on the CPU with the same inputs.

- Remote-apply parity (`parity_cases`, `parity_digests`): small
  randomized batches, the generators of `tests/test_crdt_batch.py`
  (`random_changes`, `random_rich_changes`, copied here field for field),
  one of them split into batches of 13, even causal lengths with a
  non-sentinel cid, and two value ties the decision program cannot order
  (it declines them to the host engines). Per case, a digest of the final
  dump and the impactful changes in order.
- Three replicas (`replica_digests`): stores with site ids 1, 2 and 3
  each run `n_txs` seeded local write transactions (1-8 INSERT, UPDATE
  or DELETE statements over 2,048 `kv` rows, fixed timestamps), export
  their live versions with `changes_for_versions` through the changeset
  codec, and apply the other two's in an order of their own. Every
  replica must reach the same `converged_part`; each replica's whole
  dump depends on its order and is held to the same replica of the
  reference. The clocks' `ts` is left out: the wire carries one per
  changeset, and a receiver stores 0.
"""

from __future__ import annotations

import hashlib
import random
from types import SimpleNamespace

from corrosion_tpu_torch.crdt_bench import dump_state
from corrosion_tpu_torch.store.crdt import CrdtStore
from corrosion_tpu_torch.types import codec
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import SENTINEL, Change, ChangesetFull
from corrosion_tpu_torch.types.pack import pack_columns

SCHEMA = (
    "CREATE TABLE kv (id INTEGER NOT NULL PRIMARY KEY,"
    " a TEXT NOT NULL DEFAULT '', b INTEGER NOT NULL DEFAULT 0);"
    "CREATE TABLE other (k TEXT NOT NULL PRIMARY KEY,"
    " v TEXT NOT NULL DEFAULT '');"
)
REPLICA_SCHEMA = (
    "CREATE TABLE kv (id INTEGER NOT NULL PRIMARY KEY,"
    " a TEXT NOT NULL DEFAULT '', b INTEGER NOT NULL DEFAULT 0);"
)
SITES = [ActorId(bytes([i]) * 16) for i in (1, 2, 3)]
REPLICA_ROWS = 2048
REPLICA_TXS = 1000
REPLICA_SEED = 8
APPLY_CHUNK = 64  # changesets per apply on a replica


def port_api(device=None) -> SimpleNamespace:
    """The port's store (on `device`), types and codec."""
    return SimpleNamespace(
        new_store=lambda site: CrdtStore(":memory:", site_id=ActorId(site),
                                         device=device),
        Change=Change, ChangesetFull=ChangesetFull, ActorId=ActorId,
        Timestamp=Timestamp, pack_columns=pack_columns,
        Writer=codec.Writer, Reader=codec.Reader,
        write_changeset=codec.write_changeset,
        read_changeset=codec.read_changeset,
    )


# -- the generators of tests/test_crdt_batch.py ------------------------------


def random_changes(api, rng: random.Random, count: int) -> list:
    """Changes over two tables and two unknown targets (dropped by every
    engine): stale causal lengths, delete/re-create chains, equal-clock
    value races."""
    changes = []
    versions = {s.bytes16: 0 for s in SITES}
    pack = api.pack_columns
    for _ in range(count):
        site = rng.choice(SITES)
        tbl, cid_pool, pk = rng.choices(
            [
                ("kv", ["a", "b"], pack([rng.randint(1, 6)])),
                ("other", ["v"], pack([f"k{rng.randint(1, 4)}"])),
                ("nope", ["x"], pack([1])),
                ("kv", ["zz"], pack([1])),
            ],
            weights=[10, 6, 1, 1],
        )[0]
        cl = rng.choice([1, 1, 1, 2, 3, 3, 4, 5])
        if cl % 2 == 0 or rng.random() < 0.1:
            cid, val = SENTINEL, None
        else:
            cid = rng.choice(cid_pool)
            val = (rng.randint(0, 5) if cid == "b"
                   else rng.choice(["x", "y", "zz", ""]))
        versions[site.bytes16] += rng.choice([0, 1, 1])
        changes.append(api.Change(
            table=tbl, pk=pk, cid=cid, val=val,
            col_version=rng.randint(1, 4),
            db_version=max(1, versions[site.bytes16]),
            seq=rng.randint(0, 3), site_id=site.bytes16, cl=cl,
            ts=api.Timestamp.from_unix(rng.randint(1, 100)),
        ))
    return changes


RICH_VALUES = [
    0, 1, -1, 2**62, -(2**62), 2**53 + 1, True, False, 0.0, -0.5, 2.0**53,
    1e300, "", "x", "zz", "é中", "é", b"", b"\x00", b"\x00\x01", b"\xff",
]


def random_rich_changes(api, rng: random.Random, count: int) -> list:
    """Changes whose values span every SQLite type and the comparison
    edge cases (int64 extremes, unicode, blobs, bools)."""
    changes = []
    for i in range(count):
        site = rng.choice(SITES)
        cl = rng.choice([1, 1, 1, 2, 3, 3, 4, 5])
        if cl % 2 == 0 or rng.random() < 0.1:
            cid, val = SENTINEL, None
        else:
            cid = rng.choice(["a", "b"])
            val = rng.choice(RICH_VALUES)
        changes.append(api.Change(
            table="kv", pk=api.pack_columns([rng.randint(1, 5)]), cid=cid,
            val=val, col_version=rng.randint(1, 3), db_version=i + 1, seq=0,
            site_id=site.bytes16, cl=cl,
            ts=api.Timestamp.from_unix(rng.randint(1, 100)),
        ))
    return changes


def kv_change(api, row, cid, val, cl, cv, dbv, site=0, ts=1):
    return api.Change(table="kv", pk=api.pack_columns([row]), cid=cid,
                      val=val, col_version=cv, db_version=dbv, seq=0,
                      site_id=SITES[site].bytes16, cl=cl,
                      ts=api.Timestamp.from_unix(ts))


def even_cl_cases(api) -> list:
    """Even causal lengths carried by a non-sentinel cid."""
    c = lambda *a, **k: kv_change(api, *a, **k)  # noqa: E731
    return [
        [c(1, "a", "ghost", 2, 3, 1)],
        [c(1, "a", "ghost", 2, 3, 1), c(1, "b", 7, 3, 1, 2, ts=2)],
        [c(1, "a", "x", 1, 1, 1), c(1, "b", "ghost", 2, 9, 2, ts=2),
         c(1, "a", "y", 3, 1, 3, ts=3)],
        [c(1, "-1", None, 2, 1, 1), c(1, "a", "ghost", 2, 5, 2, ts=2)],
    ]


def tie_cases(api) -> list:
    """Equal-clock writes whose values the 112-bit digest cannot order:
    the decision program declines each batch."""
    c = lambda *a, **k: kv_change(api, *a, **k)  # noqa: E731
    return [
        [c(1, "a", "y" * 20, 1, 2, 1), c(1, "a", "y" * 30, 1, 2, 2)],
        [c(1, "b", 2**53, 1, 1, 1), c(1, "b", 2**53 + 1, 1, 1, 2),
         c(2, "a", "q", 1, 1, 3)],
    ]


def parity_cases(api) -> list:
    """(name, changes, split) of the parity workload: 120-180 changes per
    randomized case."""
    out = [(f"randomized_{s}", random_changes(api, random.Random(3000 + s),
                                              120), None) for s in range(4)]
    out += [(f"rich_{s}", random_rich_changes(api, random.Random(4000 + s),
                                              150), None) for s in range(4)]
    out.append(("split_13", random_changes(api, random.Random(5151), 180), 13))
    out.append(("rich_split_11",
                random_rich_changes(api, random.Random(4242), 180), 11))
    out += [(f"even_cl_{i}", chs, None)
            for i, chs in enumerate(even_cl_cases(api))]
    out += [(f"tie_{i}", chs, None) for i, chs in enumerate(tie_cases(api))]
    return out


def change_fields(ch) -> tuple:
    return (ch.table, bytes(ch.pk), ch.cid, ch.val, ch.col_version,
            ch.db_version, ch.seq, bytes(ch.site_id), ch.cl, ch.ts.ntp64)


def digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def parity_run(api, changes, split=None) -> tuple:
    """One case on a fresh store (site 9, `SCHEMA`): the final dump and the
    impactful changes' fields in order."""
    st = api.new_store(bytes([9]) * 16)
    st.apply_schema_sql(SCHEMA)
    step = split or len(changes)
    impactful = []
    for i in range(0, len(changes), step):
        impactful += st.apply_changes(changes[i:i + step]).impactful
    out = dump_state(st), [change_fields(c) for c in impactful]
    st.close()
    return out


def parity_digests(api) -> dict:
    """{case: digest of (dump, impactful)} over `parity_cases`."""
    return {name: digest(parity_run(api, chs, split))
            for name, chs, split in parity_cases(api)}


# -- three replicas ------------------------------------------------------------


def replica_txs(rng: random.Random, n_txs: int,
                rows: int = REPLICA_ROWS) -> list:
    """`n_txs` transactions, each 1-8 (sql, params) statements over the
    `kv` rows: inserts (or replaces), updates and deletes."""
    txs = []
    for _ in range(n_txs):
        ops = []
        for _ in range(rng.randint(1, 8)):
            kind = rng.random()
            row = rng.randint(1, rows)
            if kind < 0.45:
                ops.append((
                    "INSERT OR REPLACE INTO kv (id, a, b) VALUES (?, ?, ?)",
                    (row, rng.choice(["x", "y", "zz", f"r{row}"]),
                     rng.randint(0, 10**6)),
                ))
            elif kind < 0.8:
                ops.append(("UPDATE kv SET a = ?, b = b + ? WHERE id = ?",
                            (rng.choice(["p", "q", ""]), rng.randint(1, 9),
                             row)))
            else:
                ops.append(("DELETE FROM kv WHERE id = ?", (row,)))
        txs.append(ops)
    return txs


def replica_write(api, store, site: int, txs) -> int:
    """Run `txs` as local write transactions at fixed timestamps; the
    store's head db_version."""
    for i, ops in enumerate(txs):
        with store.write_tx(api.Timestamp.from_unix(site * 10**6 + i + 1)) \
                as tx:
            for sql, params in ops:
                tx.execute(sql, params)
            tx.commit()
    return store.db_version_for(store.site_id)


def export_versions(api, store, head: int) -> list:
    """Every live version of the store's own site as encoded changesets,
    oldest first."""
    out = []
    for v, chs in store.changes_for_versions(store.site_id, 1, head):
        last = chs[-1].seq if chs else 0
        cs = api.ChangesetFull(version=v, changes=tuple(chs),
                               seqs=(0, last), last_seq=last,
                               ts=chs[0].ts if chs else api.Timestamp(0))
        w = api.Writer()
        api.write_changeset(w, cs)
        out.append((v, w.bytes()))
    return sorted(out)


def replica_run(api, n_txs: int = REPLICA_TXS, seed: int = REPLICA_SEED,
                rows: int = REPLICA_ROWS) -> dict:
    """Three replicas write, export and apply each other's versions (each
    replica in an order of its own, `APPLY_CHUNK` changesets per apply);
    returns each replica's dump and what was exchanged."""
    stores, exported = {}, {}
    for site in (1, 2, 3):
        st = api.new_store(bytes([site]) * 16)
        st.apply_schema_sql(REPLICA_SCHEMA)
        txs = replica_txs(random.Random(seed * 1000 + site), n_txs, rows)
        head = replica_write(api, st, site, txs)
        exported[site] = export_versions(api, st, head)
        stores[site] = st
    for site, st in stores.items():
        incoming = [(o, v, blob) for o in (1, 2, 3) if o != site
                    for v, blob in exported[o]]
        order = random.Random(seed * 1000 + 10 + site)
        if site == 1:
            pass  # by site, each site's versions oldest first
        elif site == 2:
            incoming.reverse()
        else:
            order.shuffle(incoming)
        for i in range(0, len(incoming), APPLY_CHUNK):
            batch = []
            for _, _, blob in incoming[i:i + APPLY_CHUNK]:
                batch.extend(api.read_changeset(api.Reader(blob)).changes)
            st.apply_changes(batch)
    dumps = {site: dump_state(st, clock_ts=False)
             for site, st in stores.items()}
    for st in stores.values():
        st.close()
    return {"dumps": dumps,
            "versions": {s: len(e) for s, e in exported.items()},
            "changes": {s: sum(len(b) for _, b in e)
                        for s, e in exported.items()}}


def converged_part(dump: dict) -> dict:
    """The part of a replica's dump that every order of applying must
    reach: the rows, the causal lengths, `__crdt_db_versions`, and each
    clock cell's (pk, cid, col_version). Where two sites wrote one cell
    at an equal causal length and col_version with equal values, or
    created one row at an equal causal length, the merge keeps the entry
    that came first, so the rest of the clock row (db_version, seq,
    site_id) depends on the order of arrival, in the reference's store as
    in the port's."""
    return {k: ([r[:3] for r in rows] if k.endswith("__crdt_clock")
                else rows) for k, rows in dump.items()}


def replica_digests(api, n_txs: int = REPLICA_TXS,
                    seed: int = REPLICA_SEED) -> dict:
    """Per replica the digest of its whole dump (order-dependent clock
    metadata included, ts left out) and of its converged part, and the
    versions and encoded bytes each one exported."""
    run = replica_run(api, n_txs, seed)
    return {"replicas": {s: digest(d) for s, d in run["dumps"].items()},
            "converged": {s: digest(converged_part(d))
                          for s, d in run["dumps"].items()},
            "versions": run["versions"], "bytes": run["changes"]}
