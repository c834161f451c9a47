"""The port's snapshot container and locked restore against the JAX
package's, on the CPU.

A cold node of either package installs a snapshot that a node of the
other package built, so the header, the four wire messages and the
schema sha must be byte-equal, and an install in either direction must
leave the installing store with the builder's rows, clock rows and
bookkeeping under its own site id. The database file that `VACUUM INTO`
writes need not be byte-equal; its dump must. The cases of
`tests/test_snapshot.py` (torn transfer, schema mismatch, the cache's
staleness window, the watermark's gaps and partials, the own-origin
install guard) run on both packages, and `restore` and `backup` move
files both ways.
"""

from __future__ import annotations

import random
import sqlite3
import zlib
from types import SimpleNamespace

import pytest

SCHEMA = "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
SCHEMAS = [
    SCHEMA,
    "CREATE TABLE kv (k TEXT NOT NULL PRIMARY KEY, v BLOB, n INTEGER);\n"
    "CREATE INDEX kv_n ON kv (n);",
    "CREATE TABLE a (id INTEGER NOT NULL PRIMARY KEY, x REAL);\n"
    "CREATE TABLE b (p TEXT NOT NULL, q INTEGER NOT NULL, r TEXT,"
    " PRIMARY KEY (p, q));\nCREATE INDEX b_r ON b (r);",
    "create   table   Tests2 (id INTEGER NOT NULL PRIMARY KEY,\n"
    "   body TEXT DEFAULT 'x')  ;",
]
# tables every dump leaves out: the site id is re-pinned by an install
# (checked on its own), members are scrubbed by the backup plane, and
# sqlite_sequence is SQLite's own
NOT_DUMPED = ("__crdt_site", "__corro_members", "sqlite_sequence")


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from corrosion_tpu.agent import catchup
        from corrosion_tpu.store import bookkeeping, crdt, restore, snapshot
        from corrosion_tpu.store.schema import parse_sql
        from corrosion_tpu.types import actor, base, rangeset

        def store(path):
            return crdt.CrdtStore(path)
    else:
        from corrosion_tpu_torch.agent import catchup
        from corrosion_tpu_torch.store import (
            bookkeeping, crdt, restore, snapshot)
        from corrosion_tpu_torch.store.schema import parse_sql
        from corrosion_tpu_torch.types import actor, base, rangeset

        def store(path):
            return crdt.CrdtStore(path, device="cpu")
    return SimpleNamespace(name=name, catchup=catchup, bk=bookkeeping,
                           restore=restore, snap=snapshot,
                           parse_sql=parse_sql, actor=actor, base=base,
                           rangeset=rangeset, store=store)


JAX, PORT = _pkg("jax"), _pkg("port")
BOTH = (JAX, PORT)
PAIRS = [(JAX, PORT), (PORT, JAX)]
PAIR_IDS = ["jax-to-port", "port-to-jax"]


def seeded_store(pkg, path, n_versions=12, seed=0):
    store = pkg.store(str(path))
    store.apply_schema_sql(SCHEMA)
    rng = random.Random(seed)
    for i in range(n_versions):
        with store.write_tx(pkg.base.Timestamp(1_000_000 + i)) as tx:
            for _ in range(rng.randrange(1, 4)):
                k = rng.randrange(40)
                if rng.random() < 0.15:
                    tx.execute("DELETE FROM tests WHERE id = ?", (k,))
                else:
                    tx.execute("INSERT OR REPLACE INTO tests (id, text)"
                               " VALUES (?, ?)", (k, f"v{i}-{k}"))
    return store


def store_bookie(pkg, store):
    bookie = pkg.bk.Bookie()
    for aid in store.booked_actor_ids():
        bookie.insert(aid, store.load_booked_versions(aid))
    return bookie


def build(pkg, store, out_path, chunk_bytes=4096):
    return pkg.snap.build_snapshot_file(
        store.path, str(out_path), store.schema, store.site_id.bytes16,
        pkg.snap.bookie_watermark(store_bookie(pkg, store)),
        chunk_bytes=chunk_bytes)


def dump(path) -> dict:
    """Every table of the database file at `path` but `NOT_DUMPED`,
    every column, in a total order."""
    conn = sqlite3.connect(str(path))
    try:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'"
            " ORDER BY name")]
        out = {}
        for n in names:
            if n in NOT_DUMPED:
                continue
            ncols = len(conn.execute(f'SELECT * FROM "{n}" LIMIT 0')
                        .description)
            order = ", ".join(str(i + 1) for i in range(ncols))
            out[n] = [tuple(r) for r in conn.execute(
                f'SELECT * FROM "{n}" ORDER BY {order}')]
        return out
    finally:
        conn.close()


def site_of(path) -> bytes:
    conn = sqlite3.connect(str(path))
    try:
        return bytes(conn.execute(
            "SELECT site_id FROM __crdt_site WHERE id = 1").fetchone()[0])
    finally:
        conn.close()


def _booked(pkg, store) -> list:
    out = []
    for aid in sorted(store.booked_actor_ids(), key=lambda a: a.bytes16):
        bv = store.load_booked_versions(aid)
        out.append((aid.bytes16, bv.last(), list(bv.needed),
                    sorted(bv.partials)))
    return out


# -- codecs and the schema sha ----------------------------------------------------


def _header(pkg, rng):
    wm = {}
    for _ in range(rng.randrange(4)):
        ranges, v = [], 0
        for _ in range(rng.randrange(1, 5)):
            lo = v + rng.randrange(1, 1000)
            v = lo + rng.randrange(1000)
            ranges.append((lo, v))
        wm[rng.randbytes(16)] = ranges
    return pkg.snap.SnapshotHeader(
        schema_sha=rng.randbytes(32), site_id=rng.randbytes(16),
        wall=rng.uniform(0, 2e9), raw_bytes=rng.getrandbits(40),
        chunk_bytes=rng.randrange(1, 1 << 20), watermark=wm)


@pytest.mark.parametrize("seed", range(3))
def test_header_and_messages_are_byte_equal(seed):
    for trial in range(8):
        hs = [_header(pkg, random.Random(seed * 100 + trial))
              for pkg in BOTH]
        jh, th = hs
        assert JAX.snap.encode_header(jh) == PORT.snap.encode_header(th)
        enc = [pkg.snap.encode_snapshot_msg_header(h)
               for pkg, h in zip(BOTH, hs)]
        assert enc[0] == enc[1]
        back = PORT.snap.decode_snapshot_msg(enc[0])
        assert back == th and back.watermark_total() == jh.watermark_total()
    rng = random.Random(seed)
    z = zlib.compress(rng.randbytes(rng.randrange(1, 5000)))
    done = (rng.getrandbits(20), rng.getrandbits(40), rng.getrandbits(40))
    for make in (
        lambda p: p.snap.encode_snapshot_msg_chunk(z),
        lambda p: p.snap.encode_snapshot_msg_done(p.snap.SnapshotDone(*done)),
        lambda p: p.snap.encode_snapshot_msg_rejection(p.snap.REJECT_SCHEMA),
    ):
        jb, tb = make(JAX), make(PORT)
        assert jb == tb
        jm, tm = JAX.snap.decode_snapshot_msg(tb), \
            PORT.snap.decode_snapshot_msg(jb)
        assert (jm == tm if isinstance(tm, (bytes, int))
                else (jm.n_chunks, jm.raw_bytes, jm.compressed_bytes)
                == (tm.n_chunks, tm.raw_bytes, tm.compressed_bytes))


def test_bad_messages_rejected_alike():
    good = JAX.snap.encode_snapshot_msg_rejection(1)
    for bad in (b"\x01" + good[1:], good[:4] + b"\x09\x00\x00\x00",
                good[:6]):
        kinds = []
        for pkg in BOTH:
            with pytest.raises(ValueError) as e:
                pkg.snap.decode_snapshot_msg(bad)
            kinds.append(str(e.value))
        assert kinds[0] == kinds[1]
    h = JAX.snap.encode_header(_header(JAX, random.Random(9)))
    for pkg in BOTH:
        with pytest.raises(pkg.snap.SnapshotError, match="format"):
            pkg.snap.decode_header(b"\x02" + h[1:])


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_sha_equal(i):
    shas = [pkg.snap.schema_sha(pkg.parse_sql(SCHEMAS[i])) for pkg in BOTH]
    assert shas[0] == shas[1] and len(shas[0]) == 32
    names = sorted(PORT.parse_sql(SCHEMAS[i]).tables)
    ex = [pkg.snap.schema_sha(pkg.parse_sql(SCHEMAS[i]), exclude=names[:1])
          for pkg in BOTH]
    assert ex[0] == ex[1] and (ex[0] != shas[0]) == bool(names)
    assert PORT.snap._norm(SCHEMAS[i]) == JAX.snap._norm(SCHEMAS[i])


def test_schema_sha_canonical_and_gated():
    a = PORT.parse_sql(SCHEMA)
    b = PORT.parse_sql("create   table tests (id INTEGER NOT NULL PRIMARY"
                       " KEY, text TEXT)  ;")
    assert PORT.snap.schema_sha(a) == PORT.snap.schema_sha(b)
    c = PORT.parse_sql(SCHEMA + "\nCREATE TABLE more (id INTEGER PRIMARY KEY);")
    assert PORT.snap.schema_sha(a) != PORT.snap.schema_sha(c)
    assert PORT.snap.schema_sha(c, exclude=("more",)) == \
        PORT.snap.schema_sha(a)


def _watermark_case(pkg, rng) -> dict:
    bookie = pkg.bk.Bookie()
    for _ in range(3):
        origin = pkg.actor.ActorId(rng.randbytes(16))
        with bookie.ensure(origin).write() as bv:
            s = bv.snapshot()
            ranges, v = [], 0
            for _ in range(rng.randrange(1, 4)):
                lo = v + rng.randrange(1, 6)
                v = lo + rng.randrange(6)
                ranges.append((lo, v))
            s.insert_db(pkg.bk.NULL_GAP_STORE, pkg.rangeset.RangeSet(ranges))
            bv.commit_snapshot(s)
            for _ in range(rng.randrange(3)):
                ver = rng.randrange(1, v + 1)
                seqs = pkg.rangeset.RangeSet([(0, rng.randrange(4))])
                bv.insert_partial(ver, pkg.bk.PartialVersion(
                    seqs=seqs, last_seq=rng.choice((3, 9)),
                    ts=pkg.base.Timestamp(1)))
    return pkg.snap.bookie_watermark(bookie)


def test_bookie_watermark_equal_with_gaps_and_partials():
    for seed in range(10):
        wms = [_watermark_case(pkg, random.Random(seed)) for pkg in BOTH]
        assert wms[0] == wms[1]
    # the reference's own case: gaps 5-7 and an incomplete partial at 9
    for pkg in BOTH:
        origin = pkg.actor.ActorId(b"\x03" * 16)
        bookie = pkg.bk.Bookie()
        with bookie.ensure(origin).write() as bv:
            s = bv.snapshot()
            s.insert_db(pkg.bk.NULL_GAP_STORE,
                        pkg.rangeset.RangeSet([(1, 4), (8, 10)]))
            bv.commit_snapshot(s)
            bv.insert_partial(9, pkg.bk.PartialVersion(
                seqs=pkg.rangeset.RangeSet([(0, 2)]), last_seq=9,
                ts=pkg.base.Timestamp(1)))
        assert pkg.snap.bookie_watermark(bookie) == {
            origin.bytes16: [(1, 4), (8, 8), (10, 10)]}


# -- build and install across the packages ----------------------------------------


@pytest.mark.parametrize("src,dst", PAIRS, ids=PAIR_IDS)
def test_install_across_packages_equals_the_source(tmp_path, src, dst):
    a = seeded_store(src, tmp_path / "a.db", seed=3)
    out = tmp_path / "a.snapshot"
    header = build(src, a, out, chunk_bytes=2048)
    frames = [p for batch in dst.snap.iter_snapshot_frames(str(out), 5)
              for p in batch]
    assert len(frames) >= 3  # header, chunks, done
    assert header.schema_sha == dst.snap.schema_sha(
        dst.parse_sql(SCHEMA))

    b = dst.store(str(tmp_path / "b.db"))
    b.apply_schema_sql(SCHEMA)
    b_site = b.site_id
    with b.swapped_database():
        res = dst.snap.install_snapshot_file(
            str(out), b.path,
            expect_schema_sha=dst.snap.schema_sha(b.schema),
            self_site_id=b_site.bytes16)
    head = _booked(src, a)[0][1]
    assert res.watermark_versions == header.watermark_total() == head > 6
    a.close()
    b_booked = _booked(dst, b)
    b.close()
    assert dump(tmp_path / "b.db") == dump(tmp_path / "a.db")
    assert site_of(tmp_path / "b.db") == b_site.bytes16
    # the installed store reopens on its own site id, with the
    # builder's bookkeeping, and its next write is its own version 1
    b2 = dst.store(str(tmp_path / "b.db"))
    assert b2.site_id == b_site and _booked(dst, b2) == b_booked
    a2 = src.store(str(tmp_path / "a.db"))
    assert [(x[0], x[1]) for x in _booked(src, a2)] == [
        (x[0], x[1]) for x in b_booked]
    with b2.write_tx(dst.base.Timestamp(9_000_000)) as tx:
        tx.execute("INSERT OR REPLACE INTO tests (id, text)"
                   " VALUES (999, 'post')")
    assert b2.db_version_for(b_site) == 1
    a2.close()
    b2.close()


@pytest.mark.parametrize("pkg", BOTH, ids=["jax", "port"])
def test_builds_of_one_store_dump_alike(tmp_path, pkg):
    """A snapshot of one store built by either package decompresses to a
    database with the same dump, and the same header but its wall."""
    a = seeded_store(JAX, tmp_path / "a.db", seed=5)
    hs = []
    for p in BOTH:
        out = tmp_path / f"{p.name}.snapshot"
        hs.append(build(p, a, out))
        pkg.snap.decompress_snapshot_file(str(out),
                                          str(tmp_path / f"{p.name}.raw"))
    a.close()
    for h in hs:
        h.wall = 0.0
    assert JAX.snap.encode_header(hs[0]) == PORT.snap.encode_header(hs[1])
    assert dump(tmp_path / "jax.raw") == dump(tmp_path / "port.raw")


def test_install_refuses_schema_mismatch(tmp_path):
    a = seeded_store(JAX, tmp_path / "a.db", n_versions=3)
    out = tmp_path / "a.snapshot"
    build(JAX, a, out)
    c = PORT.store(str(tmp_path / "c.db"))
    c.apply_schema_sql(
        "CREATE TABLE other (id INTEGER NOT NULL PRIMARY KEY, v TEXT);")
    before = dump(tmp_path / "c.db")
    with pytest.raises(PORT.snap.SnapshotSchemaMismatch):
        PORT.snap.install_snapshot_file(
            str(out), c.path,
            expect_schema_sha=PORT.snap.schema_sha(c.schema),
            self_site_id=c.site_id.bytes16)
    assert dump(tmp_path / "c.db") == before
    a.close()
    c.close()


@pytest.mark.parametrize("cut", ["half", "no-done", "extra-chunk"])
def test_torn_snapshot_detected(tmp_path, cut):
    a = seeded_store(PORT, tmp_path / "a.db", n_versions=3)
    out = tmp_path / "a.snapshot"
    build(PORT, a, out, chunk_bytes=1024)
    a.close()
    data = out.read_bytes()
    frames = [p for batch in PORT.snap.iter_snapshot_frames(str(out))
              for p in batch]
    from corrosion_tpu_torch.types.codec import frame
    if cut == "half":
        torn = data[: len(data) // 2]
    elif cut == "no-done":
        torn = b"".join(frame(p) for p in frames[:-1])
    else:
        torn = b"".join(frame(p) for p in frames[:-1] + frames[1:2]
                        + frames[-1:])
    bad = tmp_path / "torn.snapshot"
    bad.write_bytes(torn)
    for pkg in BOTH:
        with pytest.raises(pkg.snap.SnapshotError):
            pkg.snap.decompress_snapshot_file(str(bad),
                                              str(tmp_path / "x.db"))


def test_cache_staleness_window(tmp_path):
    a = seeded_store(PORT, tmp_path / "a.db", n_versions=3)
    cache = PORT.snap.SnapshotCache(a.path)
    bookie = store_bookie(PORT, a)
    h1 = cache.ensure_fresh(a.schema, a.site_id.bytes16, bookie, 60.0)
    built1 = cache.built_mono
    assert cache.compressed_bytes > 0 and cache.age() >= 0
    h2 = cache.ensure_fresh(a.schema, a.site_id.bytes16, bookie, 60.0)
    assert h2 is h1 and cache.built_mono == built1
    cache.built_mono -= 120.0
    h3 = cache.ensure_fresh(a.schema, a.site_id.bytes16, bookie, 60.0)
    assert h3 is not h1 and cache.built_mono != built1
    assert h3.watermark_total() == 3
    cache.drop()
    import os
    assert not os.path.exists(cache.path) and cache.age() is None
    a.close()


def _covered_case(pkg) -> list:
    me = pkg.actor.ActorId(b"\x01" * 16)
    other = pkg.actor.ActorId(b"\x02" * 16)
    bookie = pkg.bk.Bookie()
    for who, upto in ((me, 3), (other, 50)):
        with bookie.ensure(who).write() as bv:
            s = bv.snapshot()
            s.insert_db(pkg.bk.NULL_GAP_STORE,
                        pkg.rangeset.RangeSet([(1, upto)]))
            bv.commit_snapshot(s)
    agent = SimpleNamespace(bookie=bookie, actor_id=me)
    out = []
    for wm in ({me.bytes16: [(1, 3)], other.bytes16: [(1, 40)]},
               {me.bytes16: [(1, 2)], other.bytes16: [(1, 50)]},
               {other.bytes16: [(1, 50)]},
               {me.bytes16: [(1, 1), (2, 9)]}):
        h = pkg.snap.SnapshotHeader(
            schema_sha=b"", site_id=other.bytes16, wall=0.0, raw_bytes=0,
            chunk_bytes=1, watermark=wm)
        out.append(pkg.catchup._local_covered_by(agent, h))
    return out


def test_local_covered_guard_own_origin_only():
    assert _covered_case(JAX) == _covered_case(PORT) == [
        True, False, False, True]


# -- restore and backup ------------------------------------------------------------


@pytest.mark.parametrize("src,dst", PAIRS, ids=PAIR_IDS)
def test_backup_and_restore_across_packages(tmp_path, src, dst):
    """`backup` of a store of one package by the other's, then `restore`
    of the backup over a live store of the other package under every
    SQLite lock: the target holds the source's rows, clocks and
    bookkeeping; the backup scrubs the members."""
    a = seeded_store(src, tmp_path / "a.db", seed=11)
    a._conn.execute("INSERT INTO __corro_members (actor_id, address,"
                    " foca_state, rtt_min, updated_at) VALUES"
                    " (?, 'x', '{}', 1, 1)", (b"\x07" * 16,))
    want = dump(tmp_path / "a.db")
    a.close()
    bak = tmp_path / "backup.db"
    dst.restore.backup(str(tmp_path / "a.db"), str(bak))
    with pytest.raises(dst.restore.RestoreError, match="exists"):
        dst.restore.backup(str(tmp_path / "a.db"), str(bak))
    conn = sqlite3.connect(str(bak))
    assert conn.execute("SELECT COUNT(*) FROM __corro_members"
                        ).fetchone()[0] == 0
    assert conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    conn.close()
    assert dump(bak) == want

    b = dst.store(str(tmp_path / "b.db"))
    b.apply_schema_sql(SCHEMA)
    b_site = b.site_id
    with b.swapped_database():
        res = src.restore.restore(str(bak), b.path, timeout=5.0)
        src.restore.set_self_site_id(b.path, b_site.bytes16.hex())
    assert res.is_wal and res.new_len == bak.stat().st_size
    assert b.site_id == b_site
    assert b._conn.execute("SELECT COUNT(*) FROM tests").fetchone()[0] == \
        len(want["tests"])
    b.close()
    assert dump(tmp_path / "b.db") == want
    assert site_of(tmp_path / "b.db") == b_site.bytes16


LOCK_PROBE = """
import sqlite3, sys
conn = sqlite3.connect(sys.argv[1], timeout=0.2)
try:
    conn.execute("BEGIN IMMEDIATE")
    conn.execute("COMMIT")
    print("wrote")
except sqlite3.OperationalError as e:
    print("locked" if "locked" in str(e) else repr(e))
"""


@pytest.mark.parametrize("pkg", BOTH, ids=["jax", "port"])
def test_lock_all_blocks_another_process(tmp_path, pkg):
    """While `lock_all` holds SQLite's lock bytes, a writer in another
    process cannot start a transaction; after release it can."""
    import subprocess
    import sys

    s = seeded_store(pkg, tmp_path / "a.db", n_versions=1)
    s.close()
    probe = [sys.executable, "-c", LOCK_PROBE, str(tmp_path / "a.db")]
    held = PORT.restore.lock_all(str(tmp_path / "a.db"), timeout=2.0)
    try:
        out = subprocess.run(probe, capture_output=True, text=True,
                             timeout=60)
        assert out.stdout.strip() == "locked", out
    finally:
        held.release()
    out = subprocess.run(probe, capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "wrote", out


def test_restore_refuses_a_non_database(tmp_path):
    bad = tmp_path / "short.db"
    bad.write_bytes(b"SQLite")
    dst = tmp_path / "dst.db"
    sqlite3.connect(str(dst)).close()
    for pkg in BOTH:
        with pytest.raises(pkg.restore.RestoreError, match="too short"):
            pkg.restore.restore(str(bad), str(dst), timeout=1.0)
