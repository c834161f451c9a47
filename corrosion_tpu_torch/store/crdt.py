"""CrdtStore: the cr-sqlite replacement — SQLite storage + CRDT clocks.

The port's copy of `corrosion_tpu/store/crdt.py`, with the same tables,
triggers, pk format, clock rules and engine knobs (`CORRO_CRDT_ENGINE`,
`CORRO_NATIVE_BATCH`, `CORRO_FINALIZE`, `CORRO_CAPTURE`). The one
addition is the device of the array engine: `CrdtStore(path, site_id,
device=...)` hands `device` to `ops/crdt_merge.py::merge_table_array`,
which takes the card when none is named (`runtime/device.py::
resolve_device`) and raises without CUDA. Only the decision program's
own decline (an ambiguous value tie, an int out of int32 range) sends a
batch on to the native and then the Python engine. The chaos hook
(`self.chaos`, None by default) takes a `chaos/faults.py::StoreFaults`,
consulted at the reference's sites: each writer statement, each COMMIT
and each remote apply.

The reference embeds the cr-sqlite C extension (loaded in
`klukai-types/src/sqlite.rs:125-143`) to make tables conflict-free. This
module reimplements its observable behavior natively on stdlib sqlite3:

  - per-table clock tables  `<t>__crdt_clock(pk, cid, col_version,
    db_version, seq, site_id, ts)` — one row per (row, column) cell holding
    the latest write's clock; the sentinel cid "-1" row tracks row
    create/delete
  - per-table row tables    `<t>__crdt_rows(pk, cl)` — causal length per
    row (odd = alive, even = deleted)
  - change capture for local writes via generated AFTER INSERT/UPDATE/DELETE
    triggers (gated on `__crdt_ctx.enabled` so remote applies don't re-log),
    with pks packed by a registered Python function in the cr-sqlite pk
    format
  - merge semantics for remote changes (column-level LWW): higher causal
    length wins the row; at equal (odd) cl, higher col_version wins the
    cell; at equal col_version the larger value wins, equal values merge
    silently (the reference sets `crsql_config_set('merge-equal-values',1)`,
    agent.rs:361)
  - db_version/seq assignment: every local commit takes the next db_version;
    its changed cells are sequenced 0..=last_seq (change.rs:188-258)

Observable-parity features: `changes_for_version` reconstructs
`crsql_changes` rows (current values only — overwritten versions become
"cleared", the basis of Changeset::Empty/EmptySet in sync), and
`rows_impacted`-style filtering marks which applied changes were impactful
(`agent/util.rs:1206-1310`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sqlite3
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.store.bookkeeping import (
    BookedVersions,
    GapStore,
    PartialVersion,
)
from corrosion_tpu_torch.store import capture as _capture
from corrosion_tpu_torch.store.schema import Schema, SchemaError, diff_schemas, parse_sql
from corrosion_tpu_torch.types.codec import (
    Writer,
    write_change_cells,
    write_change_fields,
)
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import Change, SENTINEL
from corrosion_tpu_torch.types.pack import pack_columns, unpack_columns
from corrosion_tpu_torch.types.rangeset import RangeSet
from corrosion_tpu_torch import native
from corrosion_tpu_torch.types.values import (
    TYPE_BLOB,
    TYPE_INTEGER,
    TYPE_REAL,
    TYPE_TEXT,
    SqliteValue,
    cmp_values,
    value_type,
)


class ChangeApplyError(Exception):
    pass


# -- internal tables -------------------------------------------------------

_BOOTSTRAP = """
CREATE TABLE IF NOT EXISTS __crdt_ctx (id INTEGER PRIMARY KEY CHECK (id = 1),
    capture INTEGER NOT NULL DEFAULT 1);
INSERT OR IGNORE INTO __crdt_ctx (id, capture) VALUES (1, 1);

CREATE TABLE IF NOT EXISTS __crdt_pending (
    rowseq INTEGER PRIMARY KEY AUTOINCREMENT,
    tbl TEXT NOT NULL, pk BLOB NOT NULL, cid TEXT NOT NULL, val ANY
);

CREATE TABLE IF NOT EXISTS __crdt_site (id INTEGER PRIMARY KEY CHECK (id = 1),
    site_id BLOB NOT NULL);

CREATE TABLE IF NOT EXISTS __crdt_db_versions (
    site_id BLOB PRIMARY KEY, db_version INTEGER NOT NULL
);

CREATE TABLE IF NOT EXISTS __corro_bookkeeping_gaps (
    actor_id BLOB NOT NULL, start INTEGER NOT NULL, end INTEGER NOT NULL,
    PRIMARY KEY (actor_id, start)
);

CREATE TABLE IF NOT EXISTS __corro_seq_bookkeeping (
    site_id BLOB NOT NULL, db_version INTEGER NOT NULL,
    start_seq INTEGER NOT NULL, end_seq INTEGER NOT NULL,
    last_seq INTEGER NOT NULL, ts INTEGER NOT NULL,
    PRIMARY KEY (site_id, db_version, start_seq)
);

CREATE TABLE IF NOT EXISTS __corro_buffered_changes (
    site_id BLOB NOT NULL, db_version INTEGER NOT NULL, seq INTEGER NOT NULL,
    tbl TEXT NOT NULL, pk BLOB NOT NULL, cid TEXT NOT NULL, val ANY,
    col_version INTEGER NOT NULL, cl INTEGER NOT NULL,
    last_seq INTEGER NOT NULL, ts INTEGER NOT NULL,
    PRIMARY KEY (site_id, db_version, seq)
);

CREATE TABLE IF NOT EXISTS __corro_schema (
    tbl_name TEXT NOT NULL, type TEXT NOT NULL, name TEXT NOT NULL,
    sql TEXT NOT NULL, source TEXT NOT NULL,
    PRIMARY KEY (tbl_name, type, name)
);

CREATE TABLE IF NOT EXISTS __corro_members (
    actor_id BLOB PRIMARY KEY, address TEXT NOT NULL,
    foca_state TEXT, rtt_min REAL, updated_at INTEGER NOT NULL DEFAULT 0
);

CREATE TABLE IF NOT EXISTS __corro_state (key TEXT PRIMARY KEY, value ANY);
"""


def _corro_json_contains(selector, obj) -> bool:
    """Custom SQL scalar `corro_json_contains(selector, object)`: true if
    every key of the JSON selector appears in the JSON object with a
    recursively-contained value; non-objects compare by equality
    (reference `klukai-types/src/sqlite.rs:237-274`). Used by operators
    to filter rows on JSON columns, e.g. consul service meta."""
    import json

    def contains(s, o) -> bool:
        if isinstance(s, dict) and isinstance(o, dict):
            return all(k in o and contains(v, o[k]) for k, v in s.items())
        return s == o

    try:
        return contains(json.loads(selector), json.loads(obj))
    except (ValueError, TypeError):
        raise sqlite3.OperationalError("corro_json_contains: invalid JSON")


def _safe_rollback(conn: sqlite3.Connection) -> None:
    """Best-effort ROLLBACK for exception paths on the write conn.

    An interrupted statement (interrupt_after watchdog / ?timeout=) has
    already rolled the transaction back; a bare ROLLBACK then raises
    'cannot rollback - no transaction is active' and REPLACES the real
    error mid-unwind. Guard on in_transaction and swallow the benign
    race where the interrupt lands between check and rollback."""
    try:
        if conn.in_transaction:
            conn.execute("ROLLBACK")
    except sqlite3.OperationalError as e:
        if conn.in_transaction:
            # a REAL rollback failure (e.g. I/O error): the tx is still
            # open — surfacing beats a mystery 'cannot start a
            # transaction within a transaction' on the next writer
            raise
        log.debug("rollback raced with auto-rollback: %s", e)


# r23: COMMIT-wall observability.  The outer COMMIT (WAL flush) is the
# write path's disk-bound tail; every commit observes its wall, and a
# commit slower than _COMMIT_STALL_S counts a STALL EVENT — the monotone
# counter the `commit-stall` page rule rates over.  (A flush-wall gauge
# would thrash between fast and slow stores sharing the process-global
# registry in the sim; a rate over a monotone counter cannot.)
_COMMIT_STALL_S = 0.025


def _observe_commit_flush(secs: float) -> None:
    from corrosion_tpu_torch.runtime.metrics import METRICS

    METRICS.histogram("corro.store.commit.flush.seconds").observe(secs)
    if secs >= _COMMIT_STALL_S:
        METRICS.counter("corro.store.commit.stall.total").inc()


def _clock_table(t: str) -> str:
    return f"{t}__crdt_clock"


log = logging.getLogger(__name__)


def _native_batch_enabled() -> bool:
    """The columnar native merge engine is on by default; set
    CORRO_NATIVE_BATCH=0 to force the pure-Python decision loop (the
    equivalence tests exercise both)."""
    return os.environ.get("CORRO_NATIVE_BATCH", "1") != "0"


def _finalize_engine() -> str:
    """Engine for the local-commit clock bookkeeping
    (`WriteTx._finalize_pending` / `CrdtStore.finalize_group`).
    "columnar" (default, r21): the r14 bulk IN(...) probes and grouped
    executemany flush, with the phase-B decisions computed over
    per-kind arrays and EVERY cell's wire bytes built in one batched
    encode pass (`types/codec.py write_change_cells`) instead of a
    per-cell emit/encode loop.  "vector" (r14): same probes and flush,
    per-cell in-memory emit loop — the pre-r21 path, kept bit-for-bit
    as the ingest bench's r21 pre mode.  "percell": the per-cell
    reference loop (one SELECT+upsert round-trip per pending cell),
    the semantic reference for the randomized equivalence pin
    (tests/test_finalize_batch.py).  "native" (r24): the phase-B
    decision loop transcribed to C++ (`native/crdt_batch.cpp::
    crdt_finalize_batch`, bit-identical to all three Python engines
    under the randomized pins); hosts where the .so cannot build fall
    back to "columnar", counted by
    `corro.write.finalize.native.unavailable`."""
    eng = os.environ.get("CORRO_FINALIZE", "columnar")
    if eng not in ("columnar", "vector", "percell", "native"):
        raise ValueError(
            f"unknown CORRO_FINALIZE {eng!r} "
            "(expected 'columnar', 'vector', 'percell' or 'native')"
        )
    return eng


# finalize-parity markers (analysis/finalize_parity.py): the native
# finalize ABI — these must match `FINALIZE_ABI_VERSION` /
# `FIN_CID_SENTINEL` in native/crdt_batch.cpp, pinned at lint time.
_NATIVE_FINALIZE_ABI = 1
_NATIVE_SENTINEL_CID = -1  # interned id `_phase_b_native` sends for SENTINEL


def _capture_engine() -> str:
    """Engine for local-write change capture (r15).  "direct" (default):
    `WriteTx.execute`/`executemany` parse-or-cache the statement shape
    and record the written cells in memory — no `__crdt_pending`
    INSERT, no readback SELECT, no DELETE — with the AFTER triggers
    kept installed as the capture path for raw/unrecognized SQL.
    "trigger": every statement captures through the triggers, the
    pre-r15 path, kept as the semantic reference for the randomized
    equivalence pin (tests/test_capture.py) and the ingest bench's pre
    mode.  `[perf] direct_capture = false` forces "trigger" per agent
    (CrdtStore.direct_capture)."""
    eng = os.environ.get("CORRO_CAPTURE", "direct")
    if eng not in ("direct", "trigger"):
        raise ValueError(
            f"unknown CORRO_CAPTURE {eng!r} (expected 'direct' or 'trigger')"
        )
    return eng


# bound-variable budget for the finalize IN(...) probes: 3.32+ builds
# allow 32766 bound parameters, older ones 999 — shrink once on the old
# cap instead of pre-chunking everything to the worst case (the whole
# point is one probe statement per table at real transaction sizes)
_PROBE_CHUNK = [8000]


def _iter_in_chunks(conn, sql_fmt: str, keys: Sequence):
    """Yield rows of `sql_fmt.format(marks=...)` over `keys`, chunked to
    the build's bound-variable budget."""
    i = 0
    while i < len(keys):
        chunk = keys[i : i + _PROBE_CHUNK[0]]
        try:
            marks = ",".join("?" * len(chunk))
            yield from conn.execute(sql_fmt.format(marks=marks), list(chunk))
        except sqlite3.OperationalError as e:
            if "too many" in str(e) and _PROBE_CHUNK[0] > 900:
                _PROBE_CHUNK[0] = 900
                continue
            raise
        i += len(chunk)


def _merge_engine() -> str:
    """Engine order for the batch decision plane (phase B).

    "python" (the reference's default, kept): the pure-Python loop.
    "native": the C++ columnar loop (ctypes), then Python.
    "array": the decision program of `ops/crdt_merge.py` on the store's
    device, then native, then Python for batches the program declines
    (undecidable value ties, ints out of int32 range).
    The store A/B (`crdt_bench.run_ab`) flips this knob over identical
    inputs."""
    eng = os.environ.get("CORRO_CRDT_ENGINE", "python")
    if eng not in ("native", "array", "python"):
        raise ValueError(
            f"unknown CORRO_CRDT_ENGINE {eng!r} "
            "(expected 'native', 'array' or 'python')"
        )
    if eng == "native" and not _native_batch_enabled():
        return "python"
    return eng


def _dedupe_pending(pending):
    """Collapse one sub-transaction's trigger log (same output as the
    per-cell reference's dedupe, O(n)): last write in the tx wins per
    (table, pk, cid); a delete marker drops the row's other pending
    entries; a key re-added after a delete re-appends, so the
    reverse-dedupe keeps each surviving key's LAST fresh insertion slot
    (the reference's `order.remove` + append behavior).

    ``pending`` rows are (tbl, pk, cid, val) tuples — produced by the
    r15 in-memory direct capture, or drained from `__crdt_pending` in
    rowseq order for trigger-captured statements (the two streams merge
    before this point, `WriteTx._take_pending`).

    Returns (cells, order, deleted_rows)."""
    cells: Dict[Tuple[str, bytes, str], SqliteValue] = {}
    order: List[Tuple[str, bytes, str]] = []
    deleted_rows: Dict[Tuple[str, bytes], bool] = {}
    row_keys: Dict[Tuple[str, bytes], set] = {}
    for r in pending:
        tbl, pk, cid, val = r
        if cid == SENTINEL + "X":  # delete marker from the del trigger
            deleted_rows[(tbl, pk)] = True
            for key in row_keys.pop((tbl, pk), ()):
                cells.pop(key, None)
            continue
        if cid == SENTINEL:
            deleted_rows.pop((tbl, pk), None)
        key = (tbl, pk, cid)
        if key not in cells:
            order.append(key)
        cells[key] = val
        row_keys.setdefault((tbl, pk), set()).add(key)
    if len(order) != len(cells):
        # delete/re-insert chains left stale slots: keep the LAST
        # occurrence of each surviving key, preserving relative order
        seen: set = set()
        fresh: List[Tuple[str, bytes, str]] = []
        for key in reversed(order):
            if key in cells and key not in seen:
                seen.add(key)
                fresh.append(key)
        order = fresh[::-1]
    return cells, order, deleted_rows


def _clock_entry(ch: Change, col_version: int) -> tuple:
    """One `__crsql_clock`-equivalent row plan: (col_version, db_version,
    seq, site_id, ts)."""
    return (col_version, ch.db_version, ch.seq, ch.site_id, ch.ts.ntp64)


# shared read-only default for the columnar phase B's batched
# col_version reads (never mutated — writes go through setdefault)
_EMPTY_CV: Dict[str, int] = {}


def _encode_value(v: SqliteValue, i: int, types, ints, reals, offs, lens,
                  arena: bytearray) -> None:
    """Marshal one sqlite value into slot `i` of the tagged-union columns
    handed to the native merge engine (shared by batch and disk values —
    the two sides of every tie compare must encode identically)."""
    tt = value_type(v)
    types[i] = tt
    if tt == TYPE_INTEGER:
        ints[i] = int(v)
    elif tt == TYPE_REAL:
        reals[i] = v
    elif tt == TYPE_TEXT:
        b = v.encode("utf-8")
        offs[i] = len(arena)
        lens[i] = len(b)
        arena += b
    elif tt == TYPE_BLOB:
        b = bytes(v)
        offs[i] = len(arena)
        lens[i] = len(b)
        arena += b


def _rows_table(t: str) -> str:
    return f"{t}__crdt_rows"


class _InterruptWatchdog:
    """One daemon thread interrupting a connection past armed deadlines.

    `arm(seconds)` registers a deadline and returns a token; `disarm`
    removes it. The thread sleeps until the earliest active deadline and
    fires `conn.interrupt()` only if that token is STILL armed (checked
    under the lock), so cancellation is race-free. The thread starts
    lazily on first arm and idles on a condition variable otherwise."""

    def __init__(self, conn: sqlite3.Connection):
        self._conn = conn
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._deadlines: Dict[int, float] = {}
        self._next_token = 0
        self._thread: Optional[threading.Thread] = None

    def arm(self, seconds: float) -> int:
        import time as _time

        with self._cond:
            token = self._next_token
            self._next_token += 1
            self._deadlines[token] = _time.monotonic() + seconds
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="crdt-interrupt-watchdog",
                    daemon=True,
                )
                self._thread.start()
            self._cond.notify()
            return token

    def disarm(self, token: int) -> None:
        with self._cond:
            self._deadlines.pop(token, None)
            self._cond.notify()

    def _run(self) -> None:
        import time as _time

        with self._cond:
            while True:
                if not self._deadlines:
                    self._cond.wait(timeout=60.0)
                    if not self._deadlines:
                        continue
                now = _time.monotonic()
                token, deadline = min(
                    self._deadlines.items(), key=lambda kv: kv[1]
                )
                if deadline > now:
                    self._cond.wait(timeout=deadline - now)
                    continue
                # fire: token still armed here, under the lock
                self._deadlines.pop(token, None)
                try:
                    self._conn.interrupt()
                    from corrosion_tpu_torch.runtime.metrics import METRICS

                    METRICS.counter("corro.sqlite.interrupt").inc()
                except sqlite3.ProgrammingError:
                    return  # connection closed — watchdog retires


@dataclass
class AppliedChanges:
    """Result of applying a remote changeset portion."""

    impactful: List[Change]
    changed_tables: Dict[str, int]


class CrdtStore:
    """One node's database: user tables + CRDT clocks + bookkeeping.

    Thread model: a single writer at a time (enforced with an RLock, the
    SplitPool equivalent provides queuing above this); readers may use
    `read_conn()` snapshots on other threads (WAL mode).
    """

    _mem_counter = 0

    def __init__(self, path: str, site_id: Optional[ActorId] = None, *,
                 device=None):
        if path == ":memory:":
            # shared-cache URI so read_conn() can open real extra
            # connections to the same in-memory database
            CrdtStore._mem_counter += 1
            # (its own prefix: the JAX package's store names its in-memory
            # databases the same way with a counter of its own, and a
            # process holding both must not open the other's database)
            path = f"file:crdtmemport{id(self)}_{CrdtStore._mem_counter}?mode=memory&cache=shared"
        self.path = path
        # where the array engine's decision program runs: None is the
        # card (resolved at the first array merge), "cpu" only by name
        self.device = device
        # batches this store's applies decided on the decision program,
        # and those it declined to the host engines (counted under the
        # store's lock, so per store and exact with concurrent applies)
        self.array_lane = {"decided": 0, "declined": 0}
        # the trigger capture gate (r15): the generated AFTER triggers'
        # WHEN clause calls `corro_capture_on()` (registered per
        # connection in _setup_conn) which reads THIS flag — toggling
        # capture for remote applies / direct-captured statements is a
        # Python list store instead of an UPDATE statement + WAL page
        # per transaction.  Single-writer model: only the write conn
        # fires triggers, and every toggle happens under self._lock.
        self._capture_flag = [1]
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None, uri=True
        )
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._setup_conn(self._conn)
        with self._lock:
            self._conn.executescript(_BOOTSTRAP)
            # one boot-time sweep replaces the old per-transaction
            # defensive DELETE: pending rows cannot survive a committed
            # tx (commit drains them) or a rolled-back one (undone), so
            # anything here is pre-crash junk from an older build
            self._conn.execute("DELETE FROM __crdt_pending")
            row = self._conn.execute("SELECT site_id FROM __crdt_site").fetchone()
            if row is None:
                sid = site_id or ActorId.new_random()
                self._conn.execute(
                    "INSERT INTO __crdt_site (id, site_id) VALUES (1, ?)",
                    (sid.bytes16,),
                )
            else:
                sid = ActorId(bytes(row["site_id"]))
                if site_id is not None and site_id != sid:
                    raise ChangeApplyError(
                        f"db already has site id {sid}, asked for {site_id}"
                    )
        self.site_id: ActorId = sid
        self.schema: Schema = Schema()
        self._pk_unpack_cache: Dict[bytes, tuple] = {}
        # r15 direct capture: per-statement-text shape cache (None =
        # "not capturable, use triggers"); cleared on schema changes.
        # `direct_capture` is the agent-level knob ([perf]
        # direct_capture), ANDed with the CORRO_CAPTURE env engine.
        self.direct_capture = True
        self._shape_cache: Dict[str, Optional[object]] = {}
        # r18 chaos: optional injected disk pathology (chaos/faults.py
        # StoreFaults) consulted at the writer-statement, COMMIT and
        # remote-apply touch points — None (the default) costs one
        # attribute check on each
        self.chaos = None
        # r23: wall of the most recent outer COMMIT (chaos latency
        # included — the injected sleep stands in for a slow fsync).
        # Read by the group committer's write-profile bucket stamps;
        # written under the store lock, so reads after group_tx exits
        # see this group's value
        self.last_flush_secs = 0.0
        # own/remote head-version cache: db_version_for is on every
        # commit's path, and the value only changes through
        # _bump_db_version (cache updated there) — cleared on rollback
        # paths where a bump may have been undone
        self._dv_cache: Dict[bytes, int] = {}
        self._read_pool: List[sqlite3.Connection] = []
        self._read_pool_lock = threading.Lock()
        self._read_out = 0  # checked-out read conns (pool gauges)
        # swap generation (r17 snapshot install): a database-file swap
        # bumps this; read conns checked out before the swap are
        # DISCARDED on release instead of re-pooled — a pre-swap conn's
        # fd points at the replaced inode and would serve stale reads
        self._read_gen = 0
        self._read_conn_gen: Dict[int, int] = {}
        self._closed = False
        # resolve (and on first use, compile) the native merge engine NOW:
        # doing it lazily inside _apply_batch would run a g++ subprocess
        # while holding the store lock and an open write transaction
        self._merge_lib = native.merge_batch_lib()
        self._watchdog = _InterruptWatchdog(self._conn)
        self._load_schema()
        if self.schema.tables:
            # refresh capture triggers to the current DDL generation
            # (r15 moved the gate to corro_capture_on()); one-time at
            # open, inside a single transaction
            with self._lock:
                self._conn.execute("BEGIN IMMEDIATE")
                try:
                    for t in self.schema.tables.values():
                        self._drop_triggers(t.name)
                        self._create_triggers(t)
                    self._conn.execute("COMMIT")
                except BaseException:
                    _safe_rollback(self._conn)
                    raise

    # -- connection setup --------------------------------------------------

    @property
    def _is_memory(self) -> bool:
        return "mode=memory" in self.path

    def _setup_conn(
        self, conn: sqlite3.Connection, writer: bool = True
    ) -> None:
        if not self._is_memory:
            # INCREMENTAL before any table exists so the maintenance
            # loops can reclaim freelist pages (setup.rs:80, the
            # reference opens with auto_vacuum=INCREMENTAL); no-op with a
            # warning on pre-existing dbs created without it
            conn.execute("PRAGMA auto_vacuum = INCREMENTAL")
            conn.execute("PRAGMA journal_mode = WAL")
        conn.execute("PRAGMA synchronous = NORMAL")
        conn.execute("PRAGMA foreign_keys = OFF")
        conn.execute("PRAGMA recursive_triggers = OFF")
        # ingest-path I/O tuning (bench_ingest.py): negative cache_size is
        # KiB — a 64 MiB page cache keeps the clock-table btree hot across
        # sync-flood batches, but ONLY on the single write connection; up
        # to 20 pooled readers each holding 64 MiB would balloon resident
        # memory, so readers keep a modest 8 MiB. temp_store dodges disk
        # spills on the IN(...) prefetch sorts; mmap reads (shared pages)
        # skip the syscall per page
        conn.execute(
            f"PRAGMA cache_size = {-65536 if writer else -8192}"
        )
        conn.execute("PRAGMA temp_store = MEMORY")
        try:
            conn.execute("PRAGMA mmap_size = 268435456")
        except sqlite3.DatabaseError:
            pass
        # native C++ extension keeps Python out of the per-row trigger
        # path (the cr-sqlite-equivalent native layer); Python fallback
        # has identical semantics
        from corrosion_tpu_torch import native

        conn.create_function(
            "corro_json_contains", 2, _corro_json_contains,
            deterministic=True,
        )
        # the trigger capture gate — deliberately NON-deterministic so
        # sqlite re-evaluates it per trigger fire.  NOTE: out-of-band
        # writers (a bare sqlite3 shell) would need this function to
        # write CRR tables; like the reference's crsql extension, all
        # writes are expected to go through the agent.
        flag = self._capture_flag
        conn.create_function("corro_capture_on", 0, lambda: flag[0])
        if not native.load_into(conn):
            conn.create_function(
                "crdt_pack", -1, _sql_pack, deterministic=True
            )
            conn.create_function(
                "crdt_cmp", 2, lambda a, b: cmp_values(a, b),
                deterministic=True,
            )

    @contextlib.contextmanager
    def interrupt_after(self, seconds: float):
        """Arm the shared watchdog to interrupt the write connection if
        the wrapped block runs longer than `seconds` — the
        InterruptibleTransaction counterpart
        (`klukai-types/src/sqlite_pool/mod.rs`: timeout →
        sqlite3_interrupt). The in-flight statement then raises
        sqlite3.OperationalError('interrupted') and the open transaction
        rolls back, instead of wedging the single write path forever.

        One long-lived watchdog thread serves every guarded block (the
        ingestion hot path arms one per apply batch — a fresh
        threading.Timer each time would churn an OS thread per batch),
        and disarm-before-fire is checked under the watchdog lock so a
        block that finishes right at the deadline can never interrupt
        the NEXT writer's healthy transaction."""
        token = self._watchdog.arm(seconds)
        try:
            yield
        finally:
            self._watchdog.disarm(token)

    READ_POOL_MAX = 20  # SplitPool read side: 20 RO conns (agent.rs:478)

    def acquire_read(self) -> sqlite3.Connection:
        """Check a read connection out of the pool (or open a fresh one).
        Return it with `release_read`, or use `pooled_read()`.

        The pool has its own mutex: WAL readers never wait on the writer,
        so a checkout must not block on `self._lock` while a write batch
        holds it across BEGIN IMMEDIATE..COMMIT (the SplitPool read side
        is lock-free with respect to the write side, agent.rs:478-519)."""
        from corrosion_tpu_torch.runtime.metrics import METRICS

        with self._read_pool_lock:
            if self._closed:
                raise sqlite3.ProgrammingError(
                    "cannot acquire read connection: store is closed"
                )
            if self._read_pool:
                conn = self._read_pool.pop()
                self._read_out += 1
                self._read_conn_gen[id(conn)] = self._read_gen
                METRICS.gauge("corro.sqlite.pool.read.connections").set(
                    self._read_out
                )
                METRICS.gauge(
                    "corro.sqlite.pool.read.connections.available"
                ).set(len(self._read_pool))
                return conn
        # open outside the lock; count only a SUCCESSFUL open so a failed
        # sqlite3.connect can't permanently inflate the checked-out gauge
        conn = self.read_conn()
        with self._read_pool_lock:
            self._read_out += 1
            self._read_conn_gen[id(conn)] = self._read_gen
            METRICS.gauge("corro.sqlite.pool.read.connections").set(
                self._read_out
            )
        return conn

    def release_read(
        self, conn: sqlite3.Connection, discard: bool = False
    ) -> None:
        """Return a read connection to the pool.

        Pass ``discard=True`` when releasing on an error path: an
        exception can leave a cursor open on the connection (e.g. a
        half-consumed generator), and a parked open statement pins its
        WAL read snapshot — the next acquirer would read stale data and
        block checkpointing. Discarded conns are closed, not pooled."""
        from corrosion_tpu_torch.runtime.metrics import METRICS

        with self._read_pool_lock:
            self._read_out = max(0, self._read_out - 1)
            gen = self._read_conn_gen.pop(id(conn), self._read_gen)
            METRICS.gauge("corro.sqlite.pool.read.connections").set(
                self._read_out
            )
            if (
                not discard
                and not self._closed
                and gen == self._read_gen
                and len(self._read_pool) < self.READ_POOL_MAX
            ):
                self._read_pool.append(conn)
                METRICS.gauge(
                    "corro.sqlite.pool.read.connections.available"
                ).set(len(self._read_pool))
                return
        # discarding, pool full, or the store closed while this conn was
        # checked out — close it instead of parking it open forever
        conn.close()

    @contextlib.contextmanager
    def pooled_read(self):
        """Context-managed pooled read connection — the SplitPool read
        side (1 RW + 20 RO, agent.rs:478-519): hot read paths (queries,
        sync serves, metrics) skip per-call sqlite connection setup.
        A connection released while an exception unwinds is discarded
        (see release_read)."""
        conn = self.acquire_read()
        try:
            yield conn
        except BaseException:
            self.release_read(conn, discard=True)
            raise
        else:
            self.release_read(conn)

    def read_conn(self) -> sqlite3.Connection:
        """A new read connection (WAL snapshot isolation for file stores,
        shared cache for in-memory). Caller closes."""
        conn = sqlite3.connect(self.path, check_same_thread=False, uri=True)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA query_only = ON")
        # modest read-side tuning: 8 MiB cache (20 pooled readers stay
        # ~160 MiB worst case), shared mmap pages, in-memory sort spills
        conn.execute("PRAGMA cache_size = -8192")
        conn.execute("PRAGMA temp_store = MEMORY")
        try:
            conn.execute("PRAGMA mmap_size = 268435456")
        except sqlite3.DatabaseError:
            pass
        # custom SQL fns must exist on READ connections too — that is
        # where /v1/queries and the pubsub matcher run user SQL
        conn.create_function(
            "corro_json_contains", 2, _corro_json_contains,
            deterministic=True,
        )
        return conn

    def close(self) -> None:
        with self._read_pool_lock:
            self._closed = True
            for conn in self._read_pool:
                conn.close()
            self._read_pool.clear()
        with self._lock:
            self._conn.close()

    # -- live database swap (r17 snapshot bootstrap) -----------------------

    @contextlib.contextmanager
    def swapped_database(self):
        """Replace the database FILE underneath a live store
        (`store/snapshot.py` install): closes every connection, yields
        for the caller to swap the file, then reopens onto the new one
        — fresh write connection and watchdog, caches dropped (pk
        shapes, statement shapes, head versions all describe the OLD
        database), schema + capture triggers reloaded, the tail of
        __init__ replayed against the installed snapshot.

        `self._lock` is held for the WHOLE block, so every direct-conn
        user (maintenance loops, member persistence, bookkeeping reads)
        parks on the lock and resumes against the new connection —
        never observes a closed one.  The caller must still have
        quiesced the write path (the agent's write gate) and run this
        on ONE worker thread (the RLock is reentrant per-thread).
        Readers checked out before the swap are discarded on release
        via the read-generation bump, never re-pooled."""
        with self._read_pool_lock:
            for conn in self._read_pool:
                conn.close()
            self._read_pool.clear()
            self._read_gen += 1
        with self._lock:
            self._conn.close()
            try:
                yield
            finally:
                # reopen even when the swap body failed: restore's
                # os.replace is atomic, so the path holds either the
                # old or the new database — never a torn one
                self._reopen_after_swap()

    def _reopen_after_swap(self) -> None:
        self._conn = sqlite3.connect(
            self.path, check_same_thread=False, isolation_level=None,
            uri=True,
        )
        self._conn.row_factory = sqlite3.Row
        self._setup_conn(self._conn)
        # the old watchdog thread retires on its next closed-conn
        # interrupt attempt; swaps are rare enough that a fresh
        # thread per swap is the simple, correct ownership
        self._watchdog = _InterruptWatchdog(self._conn)
        self._pk_unpack_cache.clear()
        self._shape_cache.clear()
        self._dv_cache.clear()
        self._load_schema()
        if self.schema.tables:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                for t in self.schema.tables.values():
                    self._drop_triggers(t.name)
                    self._create_triggers(t)
                self._conn.execute("COMMIT")
            except BaseException:
                _safe_rollback(self._conn)
                raise

    # -- schema ------------------------------------------------------------

    def _load_schema(self) -> None:
        rows = self._conn.execute(
            "SELECT sql FROM __corro_schema WHERE type IN ('table','index')"
            " ORDER BY rowid"
        ).fetchall()
        if rows:
            self.schema = parse_sql("\n".join(r["sql"] + ";" for r in rows))

    def apply_schema_sql(self, sql: str) -> Schema:
        """Parse + diff + apply new schema DDL (the `/v1/migrations` path,
        reference `api/public/mod.rs:560-667` → `schema.rs:285`)."""
        new_schema = parse_sql(sql)
        diff = diff_schemas(self.schema, new_schema)
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                for t in diff.new_tables:
                    self._conn.execute(t.raw_sql)
                    self._create_crr_machinery(t)
                    for idx in t.indexes.values():
                        self._conn.execute(idx.raw_sql)
                for tname, col, decl in diff.new_columns:
                    self._conn.execute(f'ALTER TABLE "{tname}" ADD COLUMN {decl}')
                    # regenerate triggers to include the new column
                    t = new_schema.tables[tname]
                    self._drop_triggers(tname)
                    self._create_triggers(t)
                for t in diff.rebuild_tables:
                    # 12-step rebuild for changed column definitions
                    # (schema.rs:528-596). The CRDT clock/rows state lives
                    # in separate __crdt tables keyed by packed pk, so
                    # recreating the user table preserves replication
                    # state exactly (pk set changes are refused upstream).
                    old_t = self.schema.tables[t.name]
                    common = [c for c in old_t.columns if c in t.columns]
                    collist = ", ".join(f'"{c}"' for c in common)
                    tmp = f"{t.name}__rebuild_old"
                    self._drop_triggers(t.name)
                    self._conn.execute(
                        f'ALTER TABLE "{t.name}" RENAME TO "{tmp}"'
                    )
                    self._conn.execute(t.raw_sql)  # original name, new def
                    self._conn.execute(
                        f'INSERT INTO "{t.name}" ({collist}) '
                        f'SELECT {collist} FROM "{tmp}"'
                    )
                    self._conn.execute(f'DROP TABLE "{tmp}"')
                    for idx in t.indexes.values():
                        self._conn.execute(
                            f'DROP INDEX IF EXISTS "{idx.name}"'
                        )
                        self._conn.execute(idx.raw_sql)
                    self._create_triggers(t)
                for iname in diff.dropped_indexes:
                    self._conn.execute(f'DROP INDEX IF EXISTS "{iname}"')
                for idx in diff.changed_indexes:
                    self._conn.execute(f'DROP INDEX IF EXISTS "{idx.name}"')
                    self._conn.execute(idx.raw_sql)
                for idx in diff.new_indexes:
                    self._conn.execute(idx.raw_sql)
                # persist schema source
                self._conn.execute("DELETE FROM __corro_schema")
                for t in new_schema.tables.values():
                    self._conn.execute(
                        "INSERT INTO __corro_schema VALUES (?,?,?,?,?)",
                        (t.name, "table", t.name, t.raw_sql, "api"),
                    )
                    for idx in t.indexes.values():
                        self._conn.execute(
                            "INSERT INTO __corro_schema VALUES (?,?,?,?,?)",
                            (t.name, "index", idx.name, idx.raw_sql, "api"),
                        )
                self._conn.execute("COMMIT")
            except BaseException:
                _safe_rollback(self._conn)
                raise
        self.schema = new_schema
        self._shape_cache.clear()  # shapes bind column sets/affinities
        return new_schema

    def capture_shape(self, sql: str):
        """Cached direct-capture shape for one statement text (None =
        not capturable — the triggers handle it).  Callers hold the
        store lock (the write path)."""
        cache = self._shape_cache
        try:
            return cache[sql]
        except KeyError:
            pass
        if len(cache) > 4096:
            cache.clear()  # unbounded ad-hoc SQL must not pin memory
        shape = _capture.parse_shape(sql, self.schema)
        cache[sql] = shape
        return shape

    def _create_crr_machinery(self, t) -> None:
        ct, rt = _clock_table(t.name), _rows_table(t.name)
        self._conn.execute(
            f'CREATE TABLE IF NOT EXISTS "{ct}" ('
            " pk BLOB NOT NULL, cid TEXT NOT NULL,"
            " col_version INTEGER NOT NULL, db_version INTEGER NOT NULL,"
            " seq INTEGER NOT NULL, site_id BLOB NOT NULL, ts INTEGER NOT NULL,"
            " PRIMARY KEY (pk, cid))"
        )
        self._conn.execute(
            f'CREATE INDEX IF NOT EXISTS "{ct}__site_version"'
            f' ON "{ct}" (site_id, db_version)'
        )
        self._conn.execute(
            f'CREATE TABLE IF NOT EXISTS "{rt}" ('
            " pk BLOB PRIMARY KEY, cl INTEGER NOT NULL)"
        )
        self._create_triggers(t)

    def _pk_pack_expr(self, t, prefix: str) -> str:
        cols = ", ".join(f'{prefix}."{c}"' for c in t.pk_cols)
        return f"crdt_pack({cols})"

    def _create_triggers(self, t) -> None:
        name = t.name
        new_pk = self._pk_pack_expr(t, "NEW")
        old_pk = self._pk_pack_expr(t, "OLD")
        # r15: the gate is a connection-registered function over
        # CrdtStore._capture_flag (toggling costs no statement and no
        # WAL page; pre-r15 DDL gated on a __crdt_ctx subselect, and
        # triggers are refreshed at open so old DBs migrate)
        gate = "corro_capture_on() = 1"
        ins_cols = "".join(
            f"INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" VALUES ('{name}', {new_pk}, '{c}', NEW.\"{c}\");\n"
            for c in t.non_pk_cols
        )
        self._conn.execute(
            f'CREATE TRIGGER "{name}__crdt_ins" AFTER INSERT ON "{name}"'
            f" WHEN {gate} BEGIN\n"
            f" INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" VALUES ('{name}', {new_pk}, '{SENTINEL}', NULL);\n"
            f"{ins_cols} END"
        )
        # A pk change is modeled as delete(old row) + create(new row), the
        # way cr-sqlite treats it — otherwise replicas diverge silently.
        pk_changed = f"{new_pk} IS NOT {old_pk}"
        upd_cols = "".join(
            f"INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" SELECT '{name}', {new_pk}, '{c}', NEW.\"{c}\""
            f' WHERE NEW."{c}" IS NOT OLD."{c}" OR {pk_changed};\n'
            for c in t.non_pk_cols
        )
        self._conn.execute(
            f'CREATE TRIGGER "{name}__crdt_upd" AFTER UPDATE ON "{name}"'
            f" WHEN {gate} BEGIN\n"
            f" INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" SELECT '{name}', {old_pk}, '{SENTINEL}X', NULL WHERE {pk_changed};\n"
            f" INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" SELECT '{name}', {new_pk}, '{SENTINEL}', NULL WHERE {pk_changed};\n"
            f"{upd_cols} END"
        )
        self._conn.execute(
            f'CREATE TRIGGER "{name}__crdt_del" AFTER DELETE ON "{name}"'
            f" WHEN {gate} BEGIN\n"
            f" INSERT INTO __crdt_pending (tbl, pk, cid, val)"
            f" VALUES ('{name}', {old_pk}, '{SENTINEL}X', NULL);\n END"
        )

    def _drop_triggers(self, name: str) -> None:
        for suffix in ("ins", "upd", "del"):
            self._conn.execute(f'DROP TRIGGER IF EXISTS "{name}__crdt_{suffix}"')

    # -- db_version accounting --------------------------------------------

    def db_version_for(self, site: ActorId) -> int:
        key = site.bytes16
        v = self._dv_cache.get(key)
        if v is not None:
            return v
        row = self._conn.execute(
            "SELECT db_version FROM __crdt_db_versions WHERE site_id = ?",
            (key,),
        ).fetchone()
        v = row["db_version"] if row else 0
        self._dv_cache[key] = v
        return v

    def _bump_db_version(self, site: ActorId, version: int) -> None:
        self._conn.execute(
            "INSERT INTO __crdt_db_versions (site_id, db_version) VALUES (?, ?)"
            " ON CONFLICT (site_id) DO UPDATE SET db_version ="
            " MAX(db_version, excluded.db_version)",
            (site.bytes16, version),
        )
        key = site.bytes16
        cached = self._dv_cache.get(key, 0)
        if version > cached:
            self._dv_cache[key] = version

    # -- local writes ------------------------------------------------------

    def write_tx(
        self, ts: Timestamp, nested: bool = False, savepoint: bool = True
    ) -> "WriteTx":
        """Begin a local write transaction capturing CRDT changes.

        ``nested=True`` begins a SAVEPOINT sub-transaction for use
        inside a ``group_tx`` scope (r14 group commit): the sub-tx gets
        per-writer rollback isolation while the leader's one
        BEGIN/COMMIT (one fsync, one lock hold) covers the batch.
        ``savepoint=False`` (nested only, r15) skips the savepoint for
        a SOLO batch — no batchmates to isolate, failure aborts the
        whole group tx."""
        return WriteTx(self, ts, nested=nested, savepoint=savepoint)

    def finalize_group(self, items) -> List[Tuple[List[Change], int, int]]:
        """Finalize one or more sub-transactions' pending logs in ONE
        vectorized pass (r14): the dedupe → sentinel → col_version
        decisions run purely in memory over a single bulk-read of the
        current cl/clock state, and the final clock/rows state flushes
        with one executemany per (table × statement shape) for the
        WHOLE batch — the `_apply_batch` shape applied to local commits.

        ``items`` is ``[(pending_rows, ts), ...]`` in commit order; the
        caller holds the store lock and the open (group) transaction,
        and every item's data-table effects are already applied (a
        rolled-back sub-tx must not be passed here).  Items with
        changes get consecutive db_versions.  Returns
        ``[(changes, db_version, last_seq), ...]`` aligned to items
        (db_version 0 = the item produced no changes).

        Cross-item semantics are identical to committing the items as
        separate sequential transactions (pinned in
        tests/test_group_commit.py): later items see earlier items'
        cl/col_version effects through the shared in-memory state the
        way sequential commits see them through the database."""
        conn = self._conn
        site = self.site_id

        deduped = [_dedupe_pending(pending) for pending, _ts in items]

        # -- phase A: ONE bulk read over the union of touched keys ---------
        probe_pks: Dict[str, set] = {}  # rows-table probe (all touched pks)
        clock_pks: Dict[str, set] = {}  # clock probe (pks with col writes)
        clock_need: set = set()  # (tbl, pk, cid) whose cv decides col_version
        for cells, order, deleted_rows in deduped:
            for (tbl, pk) in deleted_rows:
                probe_pks.setdefault(tbl, set()).add(pk)
            for (tbl, pk, cid) in order:
                probe_pks.setdefault(tbl, set()).add(pk)
                if cid != SENTINEL:
                    clock_pks.setdefault(tbl, set()).add(pk)
                    clock_need.add((tbl, pk, cid))
        cur_cl: Dict[Tuple[str, bytes], int] = {}  # absent key = no row yet
        # live col_version view per (tbl, pk): starts as the disk state,
        # mutated by clears/puts so later items (and later cells) see
        # exactly what a sequential re-read would have seen
        cv_state: Dict[Tuple[str, bytes], Dict[str, int]] = {}
        for tbl, pks in probe_pks.items():
            rt = _rows_table(tbl)
            for r in _iter_in_chunks(
                conn,
                f'SELECT pk, cl FROM "{rt}" WHERE pk IN ({{marks}})',
                list(pks),
            ):
                cur_cl[(tbl, bytes(r["pk"]))] = r["cl"]
        for tbl, pks in clock_pks.items():
            ct = _clock_table(tbl)
            for r in _iter_in_chunks(
                conn,
                f'SELECT pk, cid, col_version FROM "{ct}"'
                f" WHERE pk IN ({{marks}})",
                list(pks),
            ):
                key = (tbl, bytes(r["pk"]), r["cid"])
                if key in clock_need:
                    cv_state.setdefault(key[:2], {})[r["cid"]] = (
                        r["col_version"]
                    )

        # -- phase B: per-item in-memory decisions, shared live state ------
        rows_up: Dict[str, Dict[bytes, int]] = {}
        clock_clear: Dict[str, Dict[bytes, None]] = {}  # ordered set
        clock_put: Dict[str, Dict[bytes, Dict[str, tuple]]] = {}
        out: List[List[Change]] = []
        start_dv = self.db_version_for(site)
        next_dv = start_dv + 1

        eng = _finalize_engine()
        if eng == "native":
            next_dv = self._phase_b_native(
                deduped, items, cur_cl, cv_state, rows_up, clock_clear,
                clock_put, out, next_dv,
            )
        elif eng == "columnar":
            next_dv = self._phase_b_columnar(
                deduped, items, cur_cl, cv_state, rows_up, clock_clear,
                clock_put, out, next_dv,
            )
        else:
            next_dv = self._phase_b_percell_emit(
                deduped, items, cur_cl, cv_state, rows_up, clock_clear,
                clock_put, out, next_dv,
            )

        # -- phase C: ONE bulk flush for the whole batch -------------------
        for tbl in {
            t for d in (rows_up, clock_clear, clock_put) for t in d
        }:
            rt, ct = _rows_table(tbl), _clock_table(tbl)
            if rows_up.get(tbl):
                conn.executemany(
                    f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                    " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                    list(rows_up[tbl].items()),
                )
            if clock_clear.get(tbl):
                conn.executemany(
                    f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?',
                    [(pk, SENTINEL) for pk in clock_clear[tbl]],
                )
            if clock_put.get(tbl):
                conn.executemany(
                    f'INSERT INTO "{ct}" (pk, cid, col_version, db_version,'
                    " seq, site_id, ts) VALUES (?,?,?,?,?,?,?)"
                    " ON CONFLICT (pk, cid) DO UPDATE SET"
                    " col_version = excluded.col_version,"
                    " db_version = excluded.db_version,"
                    " seq = excluded.seq, site_id = excluded.site_id,"
                    " ts = excluded.ts",
                    [
                        (pk, cid, cv, dbv, sq, st, ts)
                        for pk, entries in clock_put[tbl].items()
                        for cid, (cv, dbv, sq, st, ts) in entries.items()
                    ],
                )

        if next_dv > start_dv + 1:
            self._bump_db_version(site, next_dv - 1)
        results: List[Tuple[List[Change], int, int]] = []
        for changes in out:
            if changes:
                dv = changes[0].db_version
                last_seq = changes[-1].seq
                self.record_last_seq(site, dv, last_seq)
                results.append((changes, dv, last_seq))
            else:
                results.append(([], 0, 0))
        return results

    def _phase_b_columnar(
        self, deduped, items, cur_cl, cv_state, rows_up, clock_clear,
        clock_put, out, next_dv,
    ) -> int:
        """Columnar finalize phase B (r21): decisions per (table × kind)
        batch, encode in ONE pass.

        The r14/r15 loop paid a Writer allocation, a 4-call field encode
        and a frozen-dataclass construction PER CELL inside the decision
        walk (~180 µs of a 10-row commit).  Here each item's decisions
        run over per-kind arrays — delete-kind causal lengths in one
        comprehension over the deleted-row array, sentinel
        creation/resurrection decisions as their own pass, column-kind
        cl/col_version reads as array comprehensions over the deduped
        keys (unique per item, so the batched reads see exactly the
        sequential state) — producing compact spec tuples; then the
        WHOLE GROUP's wire cells are built by one `write_change_cells`
        batch-encode call and the Change objects materialize in a tight
        zip loop.  Emission order, seq numbering, clock rows and cell
        bytes are pinned identical to `_finalize_pending_percell` /
        CORRO_FINALIZE=vector by tests/test_finalize_batch.py.

        Kind-splitting is only equivalent while every SENTINEL precedes
        its own row's column cells in `order` (true for everything the
        capture planes emit: insert-like statements log sentinel-first,
        updates log no sentinel); a violating item falls back to the
        in-order sequential walk so correctness never rides on the
        capture convention."""
        site = self.site_id
        site_bytes = site.bytes16
        all_specs: List[tuple] = []
        item_slices: List[tuple] = []  # (start, end, ts)
        for (cells, order, deleted_rows), (_pending, ts) in zip(
            deduped, items
        ):
            db_version = next_dv
            ts_ntp = ts.ntp64
            specs: List[tuple] = []
            add = specs.append

            def clear_clocks(tbl, pk):
                clock_clear.setdefault(tbl, {})[pk] = None
                cv_state.pop((tbl, pk), None)
                puts = clock_put.get(tbl, {}).get(pk)
                if puts:
                    for c in [c for c in puts if c != SENTINEL]:
                        del puts[c]

            # delete kind: bumped-even causal lengths over the whole
            # deleted-row array in one pass
            if deleted_rows:
                dr = list(deleted_rows)
                del_cls = [cur_cl.get(k, 1) + 1 for k in dr]
                del_cls = [c + (c & 1) for c in del_cls]
                for (tbl, pk), cl in zip(dr, del_cls):
                    cur_cl[(tbl, pk)] = cl
                    rows_up.setdefault(tbl, {})[pk] = cl
                    clear_clocks(tbl, pk)
                    seq = len(specs)
                    add((tbl, pk, SENTINEL, None, cl, db_version, seq, cl))
                    clock_put.setdefault(tbl, {}).setdefault(pk, {})[
                        SENTINEL
                    ] = (cl, db_version, seq, site_bytes, ts_ntp)

            hazard = False
            col_rows: set = set()
            for tbl, pk, cid in order:
                if cid == SENTINEL:
                    if (tbl, pk) in col_rows:
                        hazard = True
                        break
                else:
                    col_rows.add((tbl, pk))

            if not hazard:
                slots: List[Optional[tuple]] = [None] * len(order)
                # sentinel kind: creation/resurrection over its array
                for i, (tbl, pk, cid) in enumerate(order):
                    if cid != SENTINEL:
                        continue
                    k2 = (tbl, pk)
                    exists = k2 in cur_cl
                    prev_cl = cur_cl.get(k2, 0)
                    cl = prev_cl + 1 if prev_cl % 2 == 0 else prev_cl
                    if not exists or prev_cl % 2 == 0:
                        cur_cl[k2] = cl
                        rows_up.setdefault(tbl, {})[pk] = cl
                        if prev_cl % 2 == 0 and prev_cl > 0:
                            clear_clocks(tbl, pk)
                        slots[i] = (tbl, pk, SENTINEL, None, cl, cl)
                # column kind: cl / col_version reads as one array
                # comprehension each over the (unique) deduped keys
                col_idx = [
                    i for i, key in enumerate(order) if key[2] != SENTINEL
                ]
                cl_get = cur_cl.get
                cv_get = cv_state.get
                col_cls = [
                    cl_get((order[i][0], order[i][1]), 1) for i in col_idx
                ]
                col_cvs = [
                    cv_get((order[i][0], order[i][1]), _EMPTY_CV).get(
                        order[i][2], 0
                    )
                    + 1
                    for i in col_idx
                ]
                for i, cl, cv in zip(col_idx, col_cls, col_cvs):
                    key = order[i]
                    tbl, pk, cid = key
                    cv_state.setdefault((tbl, pk), {})[cid] = cv
                    slots[i] = (tbl, pk, cid, cells[key], cv, cl)
                # compact in emission order; clock rows keyed off the
                # final seqs (put order within an item is upsert-keyed,
                # so deferring past the decisions is state-identical)
                for sl in slots:
                    if sl is None:
                        continue
                    tbl, pk, cid, val, cv, cl = sl
                    seq = len(specs)
                    add((tbl, pk, cid, val, cv, db_version, seq, cl))
                    clock_put.setdefault(tbl, {}).setdefault(pk, {})[
                        cid
                    ] = (cv, db_version, seq, site_bytes, ts_ntp)
            else:
                # in-order sequential fallback: same arithmetic with
                # immediate effects (a later sentinel may clear this
                # item's own earlier column puts here)
                for key in order:
                    tbl, pk, cid = key
                    k2 = (tbl, pk)
                    if cid == SENTINEL:
                        exists = k2 in cur_cl
                        prev_cl = cur_cl.get(k2, 0)
                        cl = prev_cl + 1 if prev_cl % 2 == 0 else prev_cl
                        if not exists or prev_cl % 2 == 0:
                            cur_cl[k2] = cl
                            rows_up.setdefault(tbl, {})[pk] = cl
                            if prev_cl % 2 == 0 and prev_cl > 0:
                                clear_clocks(tbl, pk)
                            seq = len(specs)
                            add((
                                tbl, pk, SENTINEL, None, cl, db_version,
                                seq, cl,
                            ))
                            clock_put.setdefault(tbl, {}).setdefault(
                                pk, {}
                            )[SENTINEL] = (
                                cl, db_version, seq, site_bytes, ts_ntp,
                            )
                        continue
                    cl = cur_cl.get(k2, 1)
                    cv = cv_state.get(k2, {}).get(cid, 0) + 1
                    cv_state.setdefault(k2, {})[cid] = cv
                    seq = len(specs)
                    add((tbl, pk, cid, cells[key], cv, db_version, seq, cl))
                    clock_put.setdefault(tbl, {}).setdefault(pk, {})[
                        cid
                    ] = (cv, db_version, seq, site_bytes, ts_ntp)

            if specs:
                next_dv += 1
            item_slices.append((len(all_specs), len(all_specs) + len(specs), ts))
            all_specs.extend(specs)

        # ONE vectorized pack pass for every cell in the group
        blobs = write_change_cells(all_specs, site_bytes)
        if all_specs:
            from corrosion_tpu_torch.runtime.metrics import METRICS

            METRICS.counter("corro.write.finalize.columnar.total").inc(
                len(all_specs)
            )
        new_change = Change.__new__
        for a, b, ts in item_slices:
            changes: List[Change] = []
            for spec, cell in zip(all_specs[a:b], blobs[a:b]):
                tbl, pk, cid, val, cv, dbv, seq, cl = spec
                ch = new_change(Change)
                ch.__dict__.update(
                    table=tbl, pk=pk, cid=cid, val=val, col_version=cv,
                    db_version=dbv, seq=seq, site_id=site_bytes, cl=cl,
                    ts=ts, wire_cell=cell,
                )
                changes.append(ch)
            out.append(changes)
        return next_dv

    def _phase_b_native(
        self, deduped, items, cur_cl, cv_state, rows_up, clock_clear,
        clock_put, out, next_dv,
    ) -> int:
        """Native finalize phase B (r24, CORRO_FINALIZE=native): the
        decision loop runs in C++ (`native/crdt_batch.cpp::
        crdt_finalize_batch`), Python keeps the value plane.

        The glue interns the group's (table, pk) rows and cids to dense
        integer ids, ships the deduped order keys / deleted-row sets /
        phase-A snapshot as flat arrays, and gets back per-item change
        SPECS (seq implicit by position, db_version derived here — the
        same consecutive-assignment rule every engine uses) plus the
        final rows/clock plans with Python-dict insertion-order
        semantics.  Values never cross the boundary: a column spec
        carries its global order index and the value is fetched from
        the item's own deduped cells, then the WHOLE group encodes via
        the same one-pass `write_change_cells` call the columnar engine
        uses — byte-identity pinned in tests/test_finalize_batch.py.

        A host where the .so cannot build (or the call reports a
        malformed batch, which a correct glue never produces) falls
        back to the columnar engine, silently but COUNTED:
        `corro.write.finalize.native.unavailable`."""
        from corrosion_tpu_torch import native as _native_mod
        from corrosion_tpu_torch.runtime.metrics import METRICS

        lib = _native_mod.finalize_batch_lib()
        if lib is None:
            METRICS.counter(
                "corro.write.finalize.native.unavailable"
            ).inc()
            return self._phase_b_columnar(
                deduped, items, cur_cl, cv_state, rows_up, clock_clear,
                clock_put, out, next_dv,
            )
        import ctypes as C

        # -- intern rows/cids + flatten the group geometry -----------------
        row_ids: Dict[Tuple[str, bytes], int] = {}
        rows: List[Tuple[str, bytes]] = []
        cid_ids: Dict[str, int] = {}
        cids: List[str] = []
        del_off = [0]
        del_rows: List[int] = []
        ord_off = [0]
        ord_rows: List[int] = []
        ord_cids: List[int] = []
        ord_keys: List[tuple] = []  # global order index -> (tbl, pk, cid)
        for cells, order, deleted_rows in deduped:
            for k in deleted_rows:
                i = row_ids.get(k)
                if i is None:
                    i = row_ids[k] = len(rows)
                    rows.append(k)
                del_rows.append(i)
            del_off.append(len(del_rows))
            for key in order:
                tbl, pk, cid = key
                k = (tbl, pk)
                i = row_ids.get(k)
                if i is None:
                    i = row_ids[k] = len(rows)
                    rows.append(k)
                ord_rows.append(i)
                if cid == SENTINEL:
                    ord_cids.append(_NATIVE_SENTINEL_CID)
                else:
                    ci = cid_ids.get(cid)
                    if ci is None:
                        ci = cid_ids[cid] = len(cids)
                        cids.append(cid)
                    ord_cids.append(ci)
                ord_keys.append(key)
            ord_off.append(len(ord_rows))

        cap = len(del_rows) + len(ord_rows)
        if cap == 0:
            for _ in deduped:
                out.append([])
            return next_dv

        n_rows = len(rows)
        row_cl = [0] * n_rows
        row_ex = [0] * n_rows
        for k, i in row_ids.items():
            cl = cur_cl.get(k)
            if cl is not None:
                row_cl[i] = cl
                row_ex[i] = 1
        cv_r: List[int] = []
        cv_c: List[int] = []
        cv_v: List[int] = []
        for k2, entry in cv_state.items():
            i = row_ids.get(k2)
            if i is None:
                continue
            for cid, v in entry.items():
                ci = cid_ids.get(cid)
                if ci is None:
                    continue  # probe row whose cid this group never writes
                cv_r.append(i)
                cv_c.append(ci)
                cv_v.append(v)

        I32, I64, U8 = C.c_int32, C.c_int64, C.c_uint8

        def arr(ctype, lst):
            return (ctype * max(1, len(lst)))(*lst)

        spec_count = (I32 * len(deduped))()
        spec_row = (I32 * cap)()
        spec_cid = (I32 * cap)()
        spec_ord = (I32 * cap)()
        spec_cv = (I64 * cap)()
        spec_cl = (I64 * cap)()
        up_row = (I32 * cap)()
        up_cl = (I64 * cap)()
        n_up = I32()
        clear_row = (I32 * cap)()
        n_clear = I32()
        put_row = (I32 * cap)()
        put_cid = (I32 * cap)()
        put_cv = (I64 * cap)()
        put_item = (I32 * cap)()
        put_seq = (I32 * cap)()
        n_put = I32()
        rc = lib.crdt_finalize_batch(
            len(deduped), arr(I32, del_off), arr(I32, del_rows),
            arr(I32, ord_off), arr(I32, ord_rows), arr(I32, ord_cids),
            n_rows, arr(I64, row_cl), arr(U8, row_ex),
            len(cv_r), arr(I32, cv_r), arr(I32, cv_c), arr(I64, cv_v),
            spec_count, spec_row, spec_cid, spec_ord, spec_cv, spec_cl,
            up_row, up_cl, C.byref(n_up), clear_row, C.byref(n_clear),
            put_row, put_cid, put_cv, put_item, put_seq, C.byref(n_put),
        )
        if rc != 0:
            METRICS.counter(
                "corro.write.finalize.native.unavailable"
            ).inc()
            return self._phase_b_columnar(
                deduped, items, cur_cl, cv_state, rows_up, clock_clear,
                clock_put, out, next_dv,
            )

        # -- materialize specs / plans back into the phase-C shapes --------
        site_bytes = self.site_id.bytes16
        all_specs: List[tuple] = []
        item_slices: List[tuple] = []  # (start, end, ts)
        item_meta: List[tuple] = []  # (db_version, ts_ntp) per item
        pos = 0
        for idx, ((cells, _order, _deleted), (_pending, ts)) in enumerate(
            zip(deduped, items)
        ):
            cnt = spec_count[idx]
            db_version = next_dv
            if cnt:
                next_dv += 1
            item_meta.append((db_version, ts.ntp64))
            for seq in range(cnt):
                j = pos + seq
                tbl, pk = rows[spec_row[j]]
                ci = spec_cid[j]
                if ci == _NATIVE_SENTINEL_CID:
                    cid, val = SENTINEL, None
                else:
                    cid = cids[ci]
                    val = cells[ord_keys[spec_ord[j]]]
                all_specs.append((
                    tbl, pk, cid, val, spec_cv[j], db_version, seq,
                    spec_cl[j],
                ))
            item_slices.append((pos, pos + cnt, ts))
            pos += cnt
        for j in range(n_up.value):
            tbl, pk = rows[up_row[j]]
            rows_up.setdefault(tbl, {})[pk] = up_cl[j]
        for j in range(n_clear.value):
            tbl, pk = rows[clear_row[j]]
            clock_clear.setdefault(tbl, {})[pk] = None
        for j in range(n_put.value):
            tbl, pk = rows[put_row[j]]
            ci = put_cid[j]
            cid = SENTINEL if ci == _NATIVE_SENTINEL_CID else cids[ci]
            dbv, ts_ntp = item_meta[put_item[j]]
            clock_put.setdefault(tbl, {}).setdefault(pk, {})[cid] = (
                put_cv[j], dbv, put_seq[j], site_bytes, ts_ntp,
            )

        # ONE vectorized pack pass — the same batch encoder (and the
        # same Change materialization) as the columnar engine
        blobs = write_change_cells(all_specs, site_bytes)
        if all_specs:
            METRICS.counter("corro.write.finalize.native.total").inc(
                len(all_specs)
            )
        new_change = Change.__new__
        for a, b, ts in item_slices:
            changes: List[Change] = []
            for spec, cell in zip(all_specs[a:b], blobs[a:b]):
                tbl, pk, cid, val, cv, dbv, seq, cl = spec
                ch = new_change(Change)
                ch.__dict__.update(
                    table=tbl, pk=pk, cid=cid, val=val, col_version=cv,
                    db_version=dbv, seq=seq, site_id=site_bytes, cl=cl,
                    ts=ts, wire_cell=cell,
                )
                changes.append(ch)
            out.append(changes)
        return next_dv

    def _phase_b_percell_emit(
        self, deduped, items, cur_cl, cv_state, rows_up, clock_clear,
        clock_put, out, next_dv,
    ) -> int:
        """The r14/r15 per-cell emit loop, kept bit-for-bit as the
        CORRO_FINALIZE=vector engine (the columnar phase B's A/B
        baseline and second semantic witness)."""
        site = self.site_id
        site_bytes = site.bytes16
        new_change = Change.__new__
        for (cells, order, deleted_rows), (_pending, ts) in zip(
            deduped, items
        ):
            db_version = next_dv
            changes: List[Change] = []

            def emit(tbl, pk, cid, val, col_version, cl):
                # fused encode (r15): build the change's wire cell in
                # the SAME pass that emits it, so commit goes captured
                # cells → clocked changes → shared wire bytes in one
                # walk (with_wire_body then just splices cached cells).
                # The Change is built via __dict__ to skip the frozen
                # dataclass's per-field object.__setattr__ — this loop
                # runs once per written cell on every local commit.
                seq = len(changes)
                cw = Writer()
                write_change_fields(
                    cw, tbl, pk, cid, val, col_version, db_version,
                    seq, site_bytes, cl,
                )
                ch = new_change(Change)
                ch.__dict__.update(
                    table=tbl, pk=pk, cid=cid, val=val,
                    col_version=col_version, db_version=db_version,
                    seq=seq, site_id=site_bytes, cl=cl,
                    ts=ts, wire_cell=cw.bytes(),
                )
                changes.append(ch)

            def clear_clocks(tbl, pk):
                clock_clear.setdefault(tbl, {})[pk] = None
                cv_state.pop((tbl, pk), None)
                puts = clock_put.get(tbl, {}).get(pk)
                if puts:
                    for c in [c for c in puts if c != SENTINEL]:
                        del puts[c]

            # deletes first: sentinel change with bumped-even cl
            for (tbl, pk) in deleted_rows:
                cl = cur_cl.get((tbl, pk), 1) + 1
                if cl % 2 == 1:
                    cl += 1  # already deleted? keep even
                cur_cl[(tbl, pk)] = cl
                rows_up.setdefault(tbl, {})[pk] = cl
                clear_clocks(tbl, pk)
                emit(tbl, pk, SENTINEL, None, cl, cl)
                clock_put.setdefault(tbl, {}).setdefault(pk, {})[
                    SENTINEL
                ] = _clock_entry(changes[-1], cl)

            # creations/updates
            for key in order:
                tbl, pk, cid = key
                k2 = (tbl, pk)
                if cid == SENTINEL:
                    # row creation (or resurrection)
                    exists = k2 in cur_cl
                    prev_cl = cur_cl.get(k2, 0)
                    cl = prev_cl + 1 if prev_cl % 2 == 0 else prev_cl
                    if not exists or prev_cl % 2 == 0:
                        cur_cl[k2] = cl
                        rows_up.setdefault(tbl, {})[pk] = cl
                        if prev_cl % 2 == 0 and prev_cl > 0:
                            # resurrection: reset column clocks
                            clear_clocks(tbl, pk)
                        emit(tbl, pk, SENTINEL, None, cl, cl)
                        clock_put.setdefault(tbl, {}).setdefault(pk, {})[
                            SENTINEL
                        ] = _clock_entry(changes[-1], cl)
                    continue
                # column write on a (now) live row
                cl = cur_cl.get(k2, 1)
                col_version = cv_state.get(k2, {}).get(cid, 0) + 1
                emit(tbl, pk, cid, cells[key], col_version, cl)
                cv_state.setdefault(k2, {})[cid] = col_version
                clock_put.setdefault(tbl, {}).setdefault(pk, {})[cid] = (
                    _clock_entry(changes[-1], col_version)
                )

            if changes:
                next_dv += 1
            out.append(changes)
        return next_dv

    @contextlib.contextmanager
    def group_tx(self):
        """Leader scope for a group commit: ONE store-lock hold and ONE
        BEGIN IMMEDIATE..COMMIT shared by several `write_tx(nested=True)`
        sub-transactions (the r14 write-path coalescer).  A failure of
        the outer COMMIT itself rolls back every sub-tx in the batch;
        individual writer failures are contained by their savepoints."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                yield self
                import time as _time

                t0 = _time.monotonic()
                if self.chaos is not None:
                    # r18 slow/sick-disk injection: commit latency and
                    # transient I/O errors land HERE, where a real disk
                    # would surface them — the whole group aborts and
                    # every writer gets a typed error
                    self.chaos.on_commit()
                self._conn.execute("COMMIT")
                self.last_flush_secs = _time.monotonic() - t0
                _observe_commit_flush(self.last_flush_secs)
            except BaseException:
                _safe_rollback(self._conn)
                self._dv_cache.clear()  # bumps may have rolled back
                raise

    # -- serving changes (crsql_changes reads) ----------------------------

    def changes_for_versions(
        self,
        site: ActorId,
        start_version: int,
        end_version: int,
        conn: Optional[sqlite3.Connection] = None,
    ) -> Iterator[Tuple[int, List[Change]]]:
        """Yield (db_version, ordered changes) for every version in the
        range that still has live clock rows from `site`, newest first
        (the sync server scans db_version DESC, peer/mod.rs:620-700).
        Overwritten versions yield nothing — callers emit EmptySet."""
        c = conn or self._conn
        # Pass 1: the distinct live versions in range (index-only, small).
        # Pass 2: ONE version's rows at a time, newest first — a large
        # sync streams with bounded memory instead of materializing every
        # requested version up front (the reference reads grouped by
        # db_version DESC the same way, peer/mod.rs:620-700).
        versions: set = set()
        for tname in self.schema.tables:
            ct = _clock_table(tname)
            versions.update(
                row[0]
                for row in c.execute(
                    f'SELECT DISTINCT db_version FROM "{ct}"'
                    f" WHERE site_id = ? AND db_version BETWEEN ? AND ?",
                    (site.bytes16, start_version, end_version),
                )
            )
        for v in sorted(versions, reverse=True):
            changes: List[Change] = []
            for tname, t in self.schema.tables.items():
                ct, rt = _clock_table(tname), _rows_table(tname)
                rows = c.execute(
                    f'SELECT k.pk AS pk, k.cid AS cid,'
                    f" k.col_version AS col_version, k.seq AS seq,"
                    f' k.ts AS ts, r.cl AS cl FROM "{ct}" k'
                    f' JOIN "{rt}" r ON r.pk = k.pk'
                    f" WHERE k.site_id = ? AND k.db_version = ?",
                    (site.bytes16, v),
                ).fetchall()
                for row in rows:
                    val = None
                    cid = row["cid"]
                    if cid != SENTINEL:
                        val = self._current_value(c, t, bytes(row["pk"]), cid)
                    changes.append(
                        Change(
                            table=tname,
                            pk=bytes(row["pk"]),
                            cid=cid,
                            val=val,
                            col_version=row["col_version"],
                            db_version=v,
                            seq=row["seq"],
                            site_id=site.bytes16,
                            cl=row["cl"],
                            ts=Timestamp(row["ts"]),
                        )
                    )
            changes.sort(key=lambda ch: ch.seq)
            yield v, changes

    def last_seq_for_version(
        self,
        site: ActorId,
        version: int,
        conn: Optional[sqlite3.Connection] = None,
    ) -> Optional[int]:
        """Max seq ever assigned in `version` (needed because later writes
        can erase clock rows; tracked in __corro_state for local versions)."""
        row = (conn or self._conn).execute(
            "SELECT value FROM __corro_state WHERE key = ?",
            (f"last_seq:{site}:{version}",),
        ).fetchone()
        return row["value"] if row else None

    def buffered_last_seq(
        self,
        site: ActorId,
        version: int,
        conn: Optional[sqlite3.Connection] = None,
    ) -> Optional[int]:
        """The true last_seq a partially buffered version will end at
        (carried on every buffered row and in seq bookkeeping)."""
        row = (conn or self._conn).execute(
            "SELECT MAX(last_seq) AS ls FROM __corro_seq_bookkeeping"
            " WHERE site_id = ? AND db_version = ?",
            (site.bytes16, version),
        ).fetchone()
        return row["ls"] if row and row["ls"] is not None else None

    def buffered_seq_ranges(
        self,
        site: ActorId,
        version: int,
        conn: Optional[sqlite3.Connection] = None,
    ) -> RangeSet:
        """Seq ranges actually buffered for a partial version."""
        rows = (conn or self._conn).execute(
            "SELECT start_seq, end_seq FROM __corro_seq_bookkeeping"
            " WHERE site_id = ? AND db_version = ?",
            (site.bytes16, version),
        ).fetchall()
        return RangeSet([(r["start_seq"], r["end_seq"]) for r in rows])

    def record_last_seq(self, site: ActorId, version: int, last_seq: int) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO __corro_state VALUES (?, ?)",
            (f"last_seq:{site}:{version}", last_seq),
        )

    def _snapshot_data_rows(
        self,
        tbl: str,
        chs: Sequence[Change],
        st: Dict[bytes, dict],
    ) -> None:
        """Phase-A prefetch of current data-row values for a batch's pks.

        Equal-(cl, col_version) tie-breaks in phase B compare the incoming
        value against the current cell value (crsql's merge-equal-values
        rule, ref `util.rs:1206-1310`). The data table is only mutated at
        flush (phase C), so one chunked read per table here replaces a
        per-tie SELECT inside the decision loop. Rows whose unpacked-pk
        tuple does not round-trip through SQLite comparison (e.g. column
        affinity rewrote the stored value) simply stay unfetched
        (``disk is None``) and fall back to the per-row read.
        """
        # exact candidate set: a phase-B disk read can only happen for a
        # change whose col_version EQUALS the pre-batch clock value for
        # that (pk, cid) — in-batch wins and causal transitions route the
        # comparison through the s["vals"] cache instead. Everything else
        # never touches the data row, so fetch only the candidates.
        cand: set = set()
        tie_col_set: set = set()
        for ch in chs:
            if ch.cid == SENTINEL:
                continue
            cv = st[ch.pk]["clock"].get(ch.cid)
            if cv is not None and ch.col_version == cv:
                cand.add(ch.pk)
                tie_col_set.add(ch.cid)
        if not cand:
            return
        tie_cols = sorted(tie_col_set)
        t = self.schema.tables[tbl]
        unpack_cache = self._pk_unpack_cache
        by_tuple: Dict[tuple, bytes] = {}
        for pk in cand:
            u = unpack_cache.get(pk)
            if u is None:
                u = unpack_cache[pk] = tuple(unpack_columns(pk))
            by_tuple[u] = pk
        pk_cols = list(t.pk_cols)
        npk = len(pk_cols)
        col_sel = ", ".join(f'"{c}"' for c in pk_cols + tie_cols)
        tuples = [u for u in by_tuple if len(u) == npk]
        step = max(1, 800 // npk)
        conn = self._conn
        for i in range(0, len(tuples), step):
            chunk = tuples[i : i + step]
            if npk == 1:
                marks = ",".join("?" * len(chunk))
                where = f'"{pk_cols[0]}" IN ({marks})'
                args: List = [u[0] for u in chunk]
            else:
                row = "(" + ",".join("?" * npk) + ")"
                cols = ",".join(f'"{c}"' for c in pk_cols)
                values = ",".join([row] * len(chunk))
                where = f"({cols}) IN (VALUES {values})"
                args = [v for u in chunk for v in u]
            for r in conn.execute(
                f'SELECT {col_sel} FROM "{t.name}" WHERE {where}', args
            ):
                pk = by_tuple.get(tuple(r[k] for k in range(npk)))
                if pk is not None:
                    st[pk]["disk"] = {
                        c: r[npk + j] for j, c in enumerate(tie_cols)
                    }

    def _current_value(
        self, conn: sqlite3.Connection, t, pk: bytes, cid: str
    ) -> SqliteValue:
        where = " AND ".join(f'"{c}" IS ?' for c in t.pk_cols)
        row = conn.execute(
            f'SELECT "{cid}" AS v FROM "{t.name}" WHERE {where}',
            unpack_columns(pk),
        ).fetchone()
        return row["v"] if row is not None else None

    # -- remote change application ----------------------------------------

    def apply_changes(self, changes: Sequence[Change]) -> AppliedChanges:
        """Apply remote CRDT changes inside one transaction; returns the
        impactful subset (counterpart of `process_complete_version`,
        util.rs:1206-1310, with crsql's merge rules).

        Batched (round-2 redesign of the ingestion hot path): local clock/
        row state for every pk in the batch is bulk-read up front, the
        merge decisions run as pure in-memory passes over that snapshot
        (no SQL per change), and the *final* state is flushed with a
        handful of executemany statements. Semantics are pinned to the
        per-row reference implementation `_apply_one` by
        `tests/test_crdt_batch.py` (randomized equivalence)."""
        impactful: List[Change] = []
        changed_tables: Dict[str, int] = {}
        if self.chaos is not None:
            # r18 slow-disk injection on the ingest path: a sick-disk
            # node falls behind the cluster, not just its own clients
            self.chaos.on_apply()
        from corrosion_tpu_torch.runtime.trace import timed_query

        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            # gate triggers off for the remote apply — a Python store,
            # restored unconditionally in the finally (r15: the old
            # __crdt_ctx UPDATE needed an interrupt-proof retry dance
            # to guarantee local writes kept replicating; a flag store
            # cannot fail)
            self._capture_flag[0] = 0
            try:
                # r23 statement profiler: the batched merge is ONE
                # shape — bulk reads + executemany flush, no useful
                # per-statement split
                with timed_query("apply batch", shape="apply:batch"):
                    impactful = self._apply_batch(changes, changed_tables)
                site_max: Dict[bytes, int] = {}
                for ch in changes:
                    if ch.db_version > site_max.get(ch.site_id, 0):
                        site_max[ch.site_id] = ch.db_version
                for site, version in site_max.items():
                    self._bump_db_version(ActorId(site), version)
                self._conn.execute("COMMIT")
            except BaseException:
                _safe_rollback(self._conn)
                self._dv_cache.clear()  # bumps may have rolled back
                raise
            finally:
                self._capture_flag[0] = 1
        return AppliedChanges(impactful, changed_tables)

    def _apply_batch(
        self, changes: Sequence[Change], changed_tables: Dict[str, int]
    ) -> List[Change]:
        """In-memory merge of a whole batch + bulk flush. Caller holds the
        lock and an open transaction."""
        conn = self._conn

        # -- phase A: bulk-read local state for every (table, pk) ----------
        by_table: Dict[str, List[Change]] = {}
        by_pos: Dict[str, List[int]] = {}
        for gidx, ch in enumerate(changes):
            t = self.schema.tables.get(ch.table)
            if t is None:
                continue  # unknown table: drop silently (schema lag)
            if ch.cid != SENTINEL and ch.cid not in t.columns:
                continue
            by_table.setdefault(ch.table, []).append(ch)
            by_pos.setdefault(ch.table, []).append(gidx)

        # per table: pk -> {"cl": int, "clock": {cid: col_version}}
        local: Dict[str, Dict[bytes, dict]] = {}
        for tbl, chs in by_table.items():
            rt, ct = _rows_table(tbl), _clock_table(tbl)
            pks = list({ch.pk for ch in chs})
            st: Dict[bytes, dict] = {
                pk: {"cl": 0, "clock": {}, "vals": {}, "disk": None}
                for pk in pks
            }
            for i in range(0, len(pks), 900):
                chunk = pks[i : i + 900]
                marks = ",".join("?" * len(chunk))
                for r in conn.execute(
                    f'SELECT pk, cl FROM "{rt}" WHERE pk IN ({marks})', chunk
                ):
                    st[bytes(r["pk"])]["cl"] = r["cl"]
                for r in conn.execute(
                    f'SELECT pk, cid, col_version FROM "{ct}"'
                    f" WHERE pk IN ({marks})",
                    chunk,
                ):
                    st[bytes(r["pk"])]["clock"][r["cid"]] = r["col_version"]
            self._snapshot_data_rows(tbl, chs, st)
            local[tbl] = st

        # -- phase B: sequential in-memory merge decisions -----------------
        # mutation plans per table (final-state, flushed once at the end);
        # clock/cell plans nest per pk so a causal transition resets a
        # row's pending writes with one dict pop instead of rescanning
        # the whole batch's flat plan (was O(batch) per transition)
        row_cl: Dict[str, Dict[bytes, int]] = {}  # rows-table upserts
        cleared: Dict[str, set] = {}  # pks whose non-sentinel clocks drop
        clock_final: Dict[str, Dict[bytes, Dict[str, tuple]]] = {}
        cell_final: Dict[str, Dict[bytes, Dict[str, SqliteValue]]] = {}
        row_delete: Dict[str, set] = {}
        row_ensure: Dict[str, set] = {}
        impactful: List[Change] = []

        for tbl in by_table:
            row_cl[tbl] = {}
            cleared[tbl] = set()
            clock_final[tbl] = {}
            cell_final[tbl] = {}
            row_delete[tbl] = set()
            row_ensure[tbl] = set()

        # Decisions are independent across tables (state is per
        # (table, pk)), so each table's changes merge separately — through
        # the native columnar engine (`native/crdt_batch.cpp`) when it is
        # available, else the pure-Python loop. Within a table, arrival
        # order is preserved; `impactful` keeps GLOBAL arrival order via
        # the per-table win masks + original positions.
        engine = _merge_engine()
        lib = self._merge_lib if engine in ("native", "array") else None
        array_merge = None
        if engine == "array":
            from corrosion_tpu_torch.ops.crdt_merge import merge_table_array

            array_merge = merge_table_array
        win_global = [False] * len(changes)
        for tbl, chs in by_table.items():
            wins = None
            if array_merge is not None:
                wins = array_merge(
                    self, tbl, chs, local[tbl],
                    row_cl[tbl], cleared[tbl], clock_final[tbl],
                    cell_final[tbl], row_delete[tbl], row_ensure[tbl],
                    device=self.device,
                )
                self.array_lane["declined" if wins is None else "decided"] += 1
            if wins is None and lib is not None:
                wins = self._merge_table_native(
                    lib, tbl, chs, local[tbl],
                    row_cl[tbl], cleared[tbl], clock_final[tbl],
                    cell_final[tbl], row_delete[tbl], row_ensure[tbl],
                )
            if wins is None:
                wins = self._merge_table_python(
                    tbl, chs, local[tbl],
                    row_cl[tbl], cleared[tbl], clock_final[tbl],
                    cell_final[tbl], row_delete[tbl], row_ensure[tbl],
                )
            n_wins = 0
            pos = by_pos[tbl]
            for j, w in enumerate(wins):
                if w:
                    win_global[pos[j]] = True
                    n_wins += 1
            if n_wins:
                changed_tables[tbl] = changed_tables.get(tbl, 0) + n_wins
        for gidx, ch in enumerate(changes):
            if win_global[gidx]:
                impactful.append(ch)

        # -- phase C: bulk flush of final state ----------------------------
        unpack_cache = self._pk_unpack_cache
        if len(unpack_cache) > 200_000:
            unpack_cache.clear()
        return self._flush_batch(
            by_table, row_cl, cleared, clock_final, cell_final,
            row_delete, row_ensure, impactful,
        )

    def _merge_table_python(
        self,
        tbl: str,
        chs: Sequence[Change],
        st: Dict[bytes, dict],
        rcl: Dict[bytes, int],
        clr: set,
        ckf: Dict[bytes, Dict[str, tuple]],
        clf: Dict[bytes, Dict[str, SqliteValue]],
        rdel: set,
        rens: set,
    ) -> List[bool]:
        """Reference decision loop for one table's changes (arrival order).

        Returns the per-change win mask; fills the caller's flush plans.
        (A numpy phase-B was prototyped for VERDICT #9 and measured SLOWER
        at real ingestion batch sizes; the columnar engine that replaced it
        is `native/crdt_batch.cpp`, for which this loop is the semantic
        reference and the fallback.)
        """
        conn = self._conn
        t = self.schema.tables[tbl]
        wins = [False] * len(chs)
        for i, ch in enumerate(chs):
            s = st[ch.pk]
            local_cl = s["cl"]
            if ch.cl < local_cl:
                continue
            win = False
            if ch.cl > local_cl:
                s["cl"] = ch.cl
                rcl[ch.pk] = ch.cl
                # clock rows reset on every causal transition; data cells
                # only reset when the transition is a delete (even cl) —
                # an odd re-create keeps surviving cell values
                s["clock"] = {}
                clr.add(ch.pk)
                ckf[ch.pk] = {SENTINEL: _clock_entry(ch, ch.cl)}
                s["clock"][SENTINEL] = ch.cl
                if ch.cl % 2 == 0:
                    # delete wins: the data row must go (flush deletes run
                    # before ensures, so a later re-create in this same
                    # batch still starts from a fresh row)
                    s["vals"] = {}
                    clf.pop(ch.pk, None)
                    rdel.add(ch.pk)
                    rens.discard(ch.pk)
                    win = True
                else:
                    rens.add(ch.pk)
                    if ch.cid != SENTINEL:
                        clf.setdefault(ch.pk, {})[ch.cid] = ch.val
                        s["vals"][ch.cid] = ch.val
                        ckf[ch.pk][ch.cid] = _clock_entry(
                            ch, ch.col_version
                        )
                        s["clock"][ch.cid] = ch.col_version
                    win = True
            else:
                # equal causal length
                if local_cl % 2 == 0 or ch.cid == SENTINEL:
                    continue
                local_cv = s["clock"].get(ch.cid, 0)
                if ch.col_version < local_cv:
                    continue
                if ch.col_version == local_cv and ch.cid in s["clock"]:
                    # a clock entry for this cid can only exist here if no
                    # causal transition happened in-batch (transitions
                    # reset s["clock"]), so the on-disk value is current
                    # unless an earlier equal-cl win cached it in s["vals"]
                    if ch.cid in s["vals"]:
                        cur = s["vals"][ch.cid]
                    elif s["disk"] is not None and ch.cid in s["disk"]:
                        cur = s["disk"][ch.cid]
                    else:
                        # tie cids are always in the prefetched union; if
                        # that invariant ever breaks, degrade to a per-row
                        # read rather than comparing against a wrong NULL
                        cur = self._current_value(conn, t, ch.pk, ch.cid)
                    if cmp_values(ch.val, cur) <= 0:
                        continue
                rens.add(ch.pk)
                clf.setdefault(ch.pk, {})[ch.cid] = ch.val
                s["vals"][ch.cid] = ch.val
                ckf.setdefault(ch.pk, {})[ch.cid] = _clock_entry(
                    ch, ch.col_version
                )
                s["clock"][ch.cid] = ch.col_version
                win = True
            wins[i] = win
        return wins

    def _merge_table_native(
        self,
        lib,
        tbl: str,
        chs: Sequence[Change],
        st: Dict[bytes, dict],
        rcl: Dict[bytes, int],
        clr: set,
        ckf: Dict[bytes, Dict[str, tuple]],
        clf: Dict[bytes, Dict[str, SqliteValue]],
        rdel: set,
        rens: set,
    ) -> Optional[List[bool]]:
        """Columnar merge of one table's changes through
        `native/crdt_batch.cpp::crdt_merge_batch`; None → caller must run
        the Python reference loop (value out of int64 range, missing
        prefetched tie value, or any native error)."""
        import ctypes
        from array import array

        n = len(chs)
        t = self.schema.tables[tbl]
        col_list = list(t.columns)
        col_idx = {c: k for k, c in enumerate(col_list)}

        pk_list: List[bytes] = []
        pk_idx: Dict[bytes, int] = {}
        for pk in st:
            pk_idx[pk] = len(pk_list)
            pk_list.append(pk)
        n_pks = len(pk_list)

        try:
            # single marshal pass: columnar scalars + the (pk, cid, cv)
            # grouping that decides which values can ever be tie-compared
            a_pk = array("i", bytes(4 * n))
            a_cid = array("i", bytes(4 * n))
            a_cv = array("q", bytes(8 * n))
            a_cl = array("q", bytes(8 * n))
            groups: Dict[tuple, int] = {}
            cand: Dict[bytes, set] = {}
            for i, ch in enumerate(chs):
                pk = ch.pk
                a_pk[i] = pk_idx[pk]
                a_cl[i] = ch.cl
                cid = ch.cid
                if cid == SENTINEL:
                    a_cid[i] = -1
                    continue
                a_cid[i] = col_idx[cid]
                cv = ch.col_version
                a_cv[i] = cv
                key = (pk, cid, cv)
                groups[key] = groups.get(key, 0) + 1
                if st[pk]["clock"].get(cid) == cv:
                    cand.setdefault(pk, set()).add(cid)

            # values reach C lazily: a change's value can only ever be
            # compared if (a) its (pk, cid, col_version) group has 2+
            # members (a later equal-cv change may tie against its cached
            # win), or (b) it ties against the snapshot clock (candidate
            # set). Everything else stays unencoded (VT 0 = absent; the
            # engine returns rc=1 if it ever needs one, falling back to
            # the Python loop).
            vt = bytearray(n)
            vi = array("q", bytes(8 * n))
            vr = array("d", bytes(8 * n))
            voff = array("q", bytes(8 * n))
            vlen = array("q", bytes(8 * n))
            arena = bytearray()
            for i, ch in enumerate(chs):
                cid = ch.cid
                if cid == SENTINEL:
                    continue
                pk = ch.pk
                if (
                    groups[(pk, cid, ch.col_version)] < 2
                    and not (
                        pk in cand and cid in cand[pk]
                        and st[pk]["clock"].get(cid) == ch.col_version
                    )
                ):
                    continue
                _encode_value(ch.val, i, vt, vi, vr, voff, vlen, arena)

            ck_pk = array("i")
            ck_cid = array("i")
            ck_cv = array("q")
            for pk, s in st.items():
                pi = pk_idx[pk]
                for cid, cv in s["clock"].items():
                    ci = col_idx.get(cid)
                    if ci is None:
                        continue  # sentinel / stale column rows
                    ck_pk.append(pi)
                    ck_cid.append(ci)
                    ck_cv.append(cv)
            n_clock = len(ck_pk)

            dk_pk_l: List[int] = []
            dk_cid_l: List[int] = []
            dk_vals: List[SqliteValue] = []
            conn = self._conn
            for pk, cids in cand.items():
                d = st[pk]["disk"]
                for cid in sorted(cids):
                    if d is not None and cid in d:
                        val = d[cid]
                    else:
                        val = self._current_value(conn, t, pk, cid)
                    dk_pk_l.append(pk_idx[pk])
                    dk_cid_l.append(col_idx[cid])
                    dk_vals.append(val)
            n_disk = len(dk_pk_l)
            dk_t = bytearray(n_disk)
            dk_i = (ctypes.c_int64 * n_disk)()
            dk_r = (ctypes.c_double * n_disk)()
            dk_off = (ctypes.c_int64 * n_disk)()
            dk_len = (ctypes.c_int64 * n_disk)()
            dk_arena = bytearray()
            for i, v in enumerate(dk_vals):
                _encode_value(v, i, dk_t, dk_i, dk_r, dk_off, dk_len,
                              dk_arena)

            c_local_cl = (ctypes.c_int64 * n_pks)(
                *[st[pk]["cl"] for pk in pk_list]
            )
            out_win = (ctypes.c_uint8 * n)()
            out_row_cl = (ctypes.c_int64 * n_pks)()
            out_flags = (ctypes.c_uint8 * n_pks)()
            out_sent = (ctypes.c_int32 * n_pks)()
            out_cell_pk = (ctypes.c_int32 * n)()
            out_cell_cid = (ctypes.c_int32 * n)()
            out_cell_idx = (ctypes.c_int32 * n)()
            out_n_cells = ctypes.c_int32(0)
            out_clock_pk = (ctypes.c_int32 * n)()
            out_clock_cid = (ctypes.c_int32 * n)()
            out_clock_idx = (ctypes.c_int32 * n)()
            out_n_clocks = ctypes.c_int32(0)

            # zero-copy views over the array-module buffers
            def u8v(buf, ln):
                return (ctypes.c_uint8 * ln).from_buffer(buf)

            def i32v(arr):
                return (ctypes.c_int32 * len(arr)).from_buffer(arr)

            def i64v(arr):
                return (ctypes.c_int64 * len(arr)).from_buffer(arr)

            def f64v(arr):
                return (ctypes.c_double * len(arr)).from_buffer(arr)

            rc = lib.crdt_merge_batch(
                n, i32v(a_pk), i32v(a_cid), i64v(a_cv), i64v(a_cl),
                u8v(vt, n),
                i64v(vi), f64v(vr), i64v(voff), i64v(vlen), bytes(arena),
                n_pks, c_local_cl,
                n_clock, i32v(ck_pk), i32v(ck_cid), i64v(ck_cv),
                n_disk,
                (ctypes.c_int32 * n_disk)(*dk_pk_l),
                (ctypes.c_int32 * n_disk)(*dk_cid_l),
                u8v(dk_t, n_disk),
                dk_i, dk_r, dk_off, dk_len, bytes(dk_arena),
                out_win, out_row_cl, out_flags, out_sent,
                out_cell_pk, out_cell_cid, out_cell_idx,
                ctypes.byref(out_n_cells),
                out_clock_pk, out_clock_cid, out_clock_idx,
                ctypes.byref(out_n_clocks),
            )
        except (OverflowError, ctypes.ArgumentError, ValueError):
            return None
        if rc != 0:
            if rc != 1:
                log.warning("native merge_batch returned rc=%d; falling "
                            "back to python loop", rc)
            return None

        # -- rebuild the flush plans from the native outputs ---------------
        F_ROWCL, F_CLEARED, F_DELETE, F_ENSURE = 1, 2, 4, 8
        for pi in range(n_pks):
            fl = out_flags[pi]
            if not fl and out_sent[pi] < 0:
                continue
            pk = pk_list[pi]
            if fl & F_ROWCL:
                rcl[pk] = out_row_cl[pi]
            if fl & F_CLEARED:
                clr.add(pk)
            if fl & F_DELETE:
                rdel.add(pk)
            if fl & F_ENSURE:
                rens.add(pk)
            si = out_sent[pi]
            if si >= 0:
                ch = chs[si]
                ckf[pk] = {SENTINEL: _clock_entry(ch, ch.cl)}
        for k in range(out_n_clocks.value):
            pk = pk_list[out_clock_pk[k]]
            cid = col_list[out_clock_cid[k]]
            ch = chs[out_clock_idx[k]]
            ckf.setdefault(pk, {})[cid] = _clock_entry(ch, ch.col_version)
        for k in range(out_n_cells.value):
            pk = pk_list[out_cell_pk[k]]
            cid = col_list[out_cell_cid[k]]
            ch = chs[out_cell_idx[k]]
            clf.setdefault(pk, {})[cid] = ch.val
        return [bool(out_win[i]) for i in range(n)]

    def _flush_batch(
        self,
        by_table: Dict[str, List[Change]],
        row_cl: Dict[str, Dict[bytes, int]],
        cleared: Dict[str, set],
        clock_final: Dict[str, Dict[bytes, Dict[str, tuple]]],
        cell_final: Dict[str, Dict[bytes, Dict[str, SqliteValue]]],
        row_delete: Dict[str, set],
        row_ensure: Dict[str, set],
        impactful: List[Change],
    ) -> List[Change]:
        conn = self._conn
        unpack_cache = self._pk_unpack_cache

        def unpacked(pk: bytes) -> tuple:
            got = unpack_cache.get(pk)
            if got is None:
                got = unpack_cache[pk] = tuple(unpack_columns(pk))
            return got

        for tbl in by_table:
            t = self.schema.tables[tbl]
            rt, ct = _rows_table(tbl), _clock_table(tbl)
            if row_cl[tbl]:
                conn.executemany(
                    f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                    " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                    list(row_cl[tbl].items()),
                )
            if cleared[tbl]:
                conn.executemany(
                    f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?',
                    [(pk, SENTINEL) for pk in cleared[tbl]],
                )
            if row_delete[tbl]:
                where = " AND ".join(f'"{c}" IS ?' for c in t.pk_cols)
                conn.executemany(
                    f'DELETE FROM "{t.name}" WHERE {where}',
                    [unpacked(pk) for pk in row_delete[tbl]],
                )
            if row_ensure[tbl]:
                cols = ", ".join(f'"{c}"' for c in t.pk_cols)
                marks = ", ".join("?" for _ in t.pk_cols)
                conn.executemany(
                    f'INSERT OR IGNORE INTO "{t.name}" ({cols})'
                    f" VALUES ({marks})",
                    [unpacked(pk) for pk in row_ensure[tbl]],
                )
            if cell_final[tbl]:
                # group cell writes by column: one executemany per cid
                where = " AND ".join(f'"{c}" IS ?' for c in t.pk_cols)
                by_cid: Dict[str, List[tuple]] = {}
                for pk, cells in cell_final[tbl].items():
                    for cid, val in cells.items():
                        by_cid.setdefault(cid, []).append(
                            (val, *unpacked(pk))
                        )
                for cid, rows in by_cid.items():
                    conn.executemany(
                        f'UPDATE "{t.name}" SET "{cid}" = ? WHERE {where}',
                        rows,
                    )
            if clock_final[tbl]:
                conn.executemany(
                    f'INSERT INTO "{ct}" (pk, cid, col_version, db_version,'
                    " seq, site_id, ts) VALUES (?,?,?,?,?,?,?)"
                    " ON CONFLICT (pk, cid) DO UPDATE SET"
                    " col_version = excluded.col_version,"
                    " db_version = excluded.db_version,"
                    " seq = excluded.seq, site_id = excluded.site_id,"
                    " ts = excluded.ts",
                    [
                        (pk, cid, cv, dbv, seq, site, ts)
                        for pk, entries in clock_final[tbl].items()
                        for cid, (cv, dbv, seq, site, ts) in entries.items()
                    ],
                )
        return impactful

    def _apply_one(self, ch: Change) -> bool:
        t = self.schema.tables.get(ch.table)
        if t is None:
            # unknown table: drop silently like cr-sqlite (schema lag)
            return False
        if ch.cid != SENTINEL and ch.cid not in t.columns:
            return False
        conn = self._conn
        rt, ct = _rows_table(ch.table), _clock_table(ch.table)
        row = conn.execute(
            f'SELECT cl FROM "{rt}" WHERE pk = ?', (ch.pk,)
        ).fetchone()
        local_cl = row["cl"] if row else 0

        if ch.cl < local_cl:
            return False  # stale causal length: row-level dominance
        if ch.cl > local_cl:
            if ch.cl % 2 == 0:
                # delete wins: drop data row, clear column clocks
                self._delete_row(t, ch.pk)
                conn.execute(
                    f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                    " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                    (ch.pk, ch.cl),
                )
                conn.execute(f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?',
                             (ch.pk, SENTINEL))
                self._upsert_clock(ct, ch, cid=SENTINEL)
                return True
            # (re)create: fresh causal epoch — reset column clocks
            conn.execute(
                f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                (ch.pk, ch.cl),
            )
            conn.execute(
                f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?', (ch.pk, SENTINEL)
            )
            self._ensure_data_row(t, ch.pk)
            self._upsert_clock(ct, ch, cid=SENTINEL)
            if ch.cid != SENTINEL:
                self._set_cell(t, ch.pk, ch.cid, ch.val)
                self._upsert_clock(ct, ch)
            return True

        # equal causal length
        if local_cl % 2 == 0:
            # both deleted; nothing to merge beyond clock freshness
            return False
        if ch.cid == SENTINEL:
            return False  # sentinel at same cl: no-op
        clock = conn.execute(
            f'SELECT col_version FROM "{ct}" WHERE pk = ? AND cid = ?',
            (ch.pk, ch.cid),
        ).fetchone()
        local_cv = clock["col_version"] if clock else 0
        if ch.col_version < local_cv:
            return False
        if ch.col_version == local_cv:
            if clock is None:
                pass  # no local write at all → incoming wins
            else:
                cur = self._current_value(conn, t, ch.pk, ch.cid)
                c = cmp_values(ch.val, cur)
                if c <= 0:
                    return False  # equal values merge; smaller loses
        self._ensure_data_row(t, ch.pk)
        self._set_cell(t, ch.pk, ch.cid, ch.val)
        self._upsert_clock(ct, ch)
        return True

    def _upsert_clock(self, ct: str, ch: Change, cid: Optional[str] = None) -> None:
        self._conn.execute(
            f'INSERT INTO "{ct}" (pk, cid, col_version, db_version, seq,'
            " site_id, ts) VALUES (?,?,?,?,?,?,?)"
            " ON CONFLICT (pk, cid) DO UPDATE SET"
            " col_version = excluded.col_version,"
            " db_version = excluded.db_version, seq = excluded.seq,"
            " site_id = excluded.site_id, ts = excluded.ts",
            (
                ch.pk,
                cid if cid is not None else ch.cid,
                ch.cl if cid is not None else ch.col_version,
                ch.db_version,
                ch.seq,
                ch.site_id,
                ch.ts.ntp64,
            ),
        )

    def _ensure_data_row(self, t, pk: bytes) -> None:
        pk_vals = unpack_columns(pk)
        cols = ", ".join(f'"{c}"' for c in t.pk_cols)
        marks = ", ".join("?" for _ in t.pk_cols)
        self._conn.execute(
            f'INSERT OR IGNORE INTO "{t.name}" ({cols}) VALUES ({marks})', pk_vals
        )

    def _set_cell(self, t, pk: bytes, cid: str, val: SqliteValue) -> None:
        where = " AND ".join(f'"{c}" IS ?' for c in t.pk_cols)
        self._conn.execute(
            f'UPDATE "{t.name}" SET "{cid}" = ? WHERE {where}',
            [val, *unpack_columns(pk)],
        )

    def _delete_row(self, t, pk: bytes) -> None:
        where = " AND ".join(f'"{c}" IS ?' for c in t.pk_cols)
        self._conn.execute(
            f'DELETE FROM "{t.name}" WHERE {where}', unpack_columns(pk)
        )

    # -- buffered partial versions ----------------------------------------

    def buffer_partial_changes(
        self,
        site: ActorId,
        version: int,
        changes: Sequence[Change],
        seqs: Tuple[int, int],
        last_seq: int,
        ts: Timestamp,
    ) -> None:
        """Stash an incomplete version's chunk (process_incomplete_version,
        util.rs:1070-1203)."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                for ch in changes:
                    self._conn.execute(
                        "INSERT OR REPLACE INTO __corro_buffered_changes"
                        " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                        (
                            site.bytes16,
                            version,
                            ch.seq,
                            ch.table,
                            ch.pk,
                            ch.cid,
                            ch.val,
                            ch.col_version,
                            ch.cl,
                            last_seq,
                            ch.ts.ntp64,
                        ),
                    )
                # merge the seq range bookkeeping
                existing = self._conn.execute(
                    "SELECT start_seq, end_seq FROM __corro_seq_bookkeeping"
                    " WHERE site_id = ? AND db_version = ?",
                    (site.bytes16, version),
                ).fetchall()
                rs = RangeSet([(r["start_seq"], r["end_seq"]) for r in existing])
                rs.insert(seqs[0], seqs[1])
                self._conn.execute(
                    "DELETE FROM __corro_seq_bookkeeping"
                    " WHERE site_id = ? AND db_version = ?",
                    (site.bytes16, version),
                )
                for s, e in rs:
                    self._conn.execute(
                        "INSERT INTO __corro_seq_bookkeeping VALUES (?,?,?,?,?,?)",
                        (site.bytes16, version, s, e, last_seq, ts.ntp64),
                    )
                self._conn.execute("COMMIT")
            except BaseException:
                _safe_rollback(self._conn)
                raise

    def take_buffered_version(
        self,
        site: ActorId,
        version: int,
        conn: Optional[sqlite3.Connection] = None,
    ) -> List[Change]:
        """Read a buffered version's rows as Change objects (non-destructive;
        clearing is separate — process_fully_buffered_changes,
        util.rs:552-700)."""
        rows = (conn or self._conn).execute(
            "SELECT * FROM __corro_buffered_changes"
            " WHERE site_id = ? AND db_version = ? ORDER BY seq",
            (site.bytes16, version),
        ).fetchall()
        return [
            Change(
                table=r["tbl"],
                pk=bytes(r["pk"]),
                cid=r["cid"],
                val=r["val"],
                col_version=r["col_version"],
                db_version=version,
                seq=r["seq"],
                site_id=site.bytes16,
                cl=r["cl"],
                ts=Timestamp(r["ts"]),
            )
            for r in rows
        ]

    def clear_buffered_version(self, site: ActorId, version: int) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM __corro_buffered_changes"
                " WHERE site_id = ? AND db_version = ?",
                (site.bytes16, version),
            )
            self._conn.execute(
                "DELETE FROM __corro_seq_bookkeeping"
                " WHERE site_id = ? AND db_version = ?",
                (site.bytes16, version),
            )

    # -- bookkeeping persistence (GapStore) -------------------------------

    def gap_store(self) -> GapStore:
        return _SqliteGapStore(self._conn)

    def load_booked_versions(self, actor_id: ActorId) -> BookedVersions:
        """Rebuild bookkeeping for an actor from durable state
        (BookedVersions::from_conn, agent.rs:1293-1362)."""
        bv = BookedVersions(actor_id)
        bv.max = self.db_version_for(actor_id) or None
        for r in self._conn.execute(
            "SELECT db_version, start_seq, end_seq, last_seq, ts"
            " FROM __corro_seq_bookkeeping WHERE site_id = ?",
            (actor_id.bytes16,),
        ):
            bv.insert_partial(
                r["db_version"],
                PartialVersion(
                    seqs=RangeSet([(r["start_seq"], r["end_seq"])]),
                    last_seq=r["last_seq"],
                    ts=Timestamp(r["ts"]),
                ),
            )
        for r in self._conn.execute(
            "SELECT start, end FROM __corro_bookkeeping_gaps WHERE actor_id = ?",
            (actor_id.bytes16,),
        ):
            bv.needed.insert(r["start"], r["end"])
        return bv

    def present_versions(self, actor_id: ActorId) -> RangeSet:
        """Distinct db_versions this actor's changes actually occupy in the
        clock tables — ground truth for gap reconciliation (the admin
        ReconcileGaps repair, `klukai/src/admin.rs` Command::ReconcileGaps
        rebuilds `__corro_bookkeeping_gaps` against `crsql_changes`)."""
        present = RangeSet()
        with self._lock:
            for t in self.schema.tables:
                for r in self._conn.execute(
                    f'SELECT DISTINCT db_version FROM "{_clock_table(t)}"'
                    " WHERE site_id = ?",
                    (actor_id.bytes16,),
                ):
                    v = r["db_version"]
                    present.insert(v, v)
        return present

    def rewrite_gaps(self, actor_id: ActorId, needed: RangeSet) -> None:
        """Replace the persisted gap rows for an actor wholesale."""
        with self._lock:
            self._conn.execute(
                "DELETE FROM __corro_bookkeeping_gaps WHERE actor_id = ?",
                (actor_id.bytes16,),
            )
            self._conn.executemany(
                "INSERT INTO __corro_bookkeeping_gaps (actor_id, start,"
                ' "end") VALUES (?, ?, ?)',
                [(actor_id.bytes16, s, e) for s, e in needed],
            )
            self._conn.commit()

    # -- member-state persistence (__corro_members) ------------------------

    def update_member_rows(
        self,
        upserts: Sequence[Tuple[bytes, str, str, Optional[float], int]],
        deletes: Sequence[bytes],
    ) -> None:
        """Apply one member-state diff: rows are (actor_id, address,
        foca_state_json, rtt_min, updated_at) (broadcast/mod.rs:814-949)."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                if upserts:
                    self._conn.executemany(
                        "INSERT INTO __corro_members (actor_id, address,"
                        " foca_state, rtt_min, updated_at)"
                        " VALUES (?,?,?,?,?)"
                        " ON CONFLICT (actor_id) DO UPDATE SET"
                        " address = excluded.address,"
                        " foca_state = excluded.foca_state,"
                        " rtt_min = coalesce(excluded.rtt_min, rtt_min),"
                        " updated_at = excluded.updated_at",
                        list(upserts),
                    )
                if deletes:
                    self._conn.executemany(
                        "DELETE FROM __corro_members WHERE actor_id = ?",
                        [(d,) for d in deletes],
                    )
                self._conn.execute("COMMIT")
            except BaseException:
                _safe_rollback(self._conn)
                raise

    def member_state_rows(self) -> List[str]:
        """Persisted foca_state JSON blobs (util.rs:74-111 load)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT foca_state FROM __corro_members"
                " WHERE foca_state IS NOT NULL"
            ).fetchall()
        return [r["foca_state"] for r in rows]

    def random_member_addresses(self, count: int) -> List[str]:
        """Random persisted member addresses (bootstrap.rs:29-50)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT address FROM __corro_members"
                " ORDER BY RANDOM() LIMIT ?",
                (count,),
            ).fetchall()
        return [r["address"] for r in rows]

    def booked_actor_ids(self) -> List[ActorId]:
        """All sites we have any state for (bookie warm-up,
        run_root.rs:136-197). Takes the store lock: callers may run off the
        event loop (admin reconcile in a worker thread) and must not read
        the shared connection inside another thread's open transaction."""
        with self._lock:
            return self._booked_actor_ids_locked()

    def _booked_actor_ids_locked(self) -> List[ActorId]:
        ids = {
            bytes(r["site_id"])
            for r in self._conn.execute("SELECT site_id FROM __crdt_db_versions")
        }
        ids |= {
            bytes(r["site_id"])
            for r in self._conn.execute(
                "SELECT DISTINCT site_id FROM __corro_seq_bookkeeping"
            )
        }
        ids |= {
            bytes(r["actor_id"])
            for r in self._conn.execute(
                "SELECT DISTINCT actor_id FROM __corro_bookkeeping_gaps"
            )
        }
        return [ActorId(b) for b in sorted(ids)]


class WriteTx:
    """A local write transaction; captures triggers' pending log and turns
    it into broadcastable changes on commit (the `/v1/transactions` path:
    make_broadcastable_changes + insert_local_changes,
    `api/public/mod.rs:57-258`, change.rs:188)."""

    def __init__(
        self,
        store: CrdtStore,
        ts: Timestamp,
        nested: bool = False,
        savepoint: bool = True,
    ):
        self.store = store
        self.ts = ts
        self._done = False
        # nested=True: a sub-transaction of a group commit — the caller
        # (CrdtStore.group_tx leader) holds the store lock and the outer
        # BEGIN IMMEDIATE; this tx is a SAVEPOINT so a failed writer
        # rolls back alone without aborting its batchmates.
        # savepoint=False (nested only, r15): a SOLO group batch skips
        # the savepoint round-trip — with one writer there are no
        # batchmates to shield, and a failure aborts the whole group tx
        self._nested = nested
        self._savepoint = savepoint
        # r15 direct capture state: `_captured` is the in-memory
        # pending stream — (tbl, pk, cid, val) tuples in statement
        # order; `_pending_dirty` marks trigger-captured rows sitting
        # in `__crdt_pending` that must be drained (in rowseq order)
        # into `_captured` before anything is appended after them;
        # `_capture_off` shadows the in-tx `__crdt_ctx.capture` value
        # so toggles only run on transitions (restored before COMMIT —
        # a rollback restores the committed 1 on its own)
        self._direct = store.direct_capture and _capture_engine() == "direct"
        self._captured: List[tuple] = []
        self._pending_dirty = False
        self._capture_off = False
        # capture telemetry, flushed ONCE per commit (registry calls
        # are locked — too heavy for the per-statement hot path)
        self._n_direct = 0
        self._n_trigger = 0
        self._n_fallback = 0
        self._capture_secs = 0.0

    def __enter__(self) -> "WriteTx":
        self.store._lock.acquire()
        self.conn = self.store._conn
        if self._nested:
            if self._savepoint:
                self.conn.execute("SAVEPOINT __corro_wtx")
        else:
            self.conn.execute("BEGIN IMMEDIATE")
        return self

    def execute(self, sql: str, params=()) -> int:
        """Run one statement; returns its faithful rows_affected.

        sqlite3 reports -1 for statement classes that have no row count
        (DDL, SELECT) — report those as 0 rather than letting -1 leak
        into summed ExecResult.rows_affected; genuine DML counts
        (including a DELETE/UPDATE matching nothing → 0) pass through
        untouched.  `params` may be a sequence or a dict (named
        parameters), so the /v1/transactions named-param path shares
        this trace/timing point.

        r15: recognized INSERT/UPDATE/DELETE shapes on CRDT-tracked
        tables capture their written cells directly in memory
        (store/capture.py) instead of taking the trigger →
        `__crdt_pending` round-trip; raw/unrecognized SQL keeps the
        trigger path, and the two streams merge in statement order."""
        if self.store.chaos is not None:
            # r18 sick-disk injection: a transient SQLITE_BUSY here
            # aborts THIS writer's sub-transaction only (savepoint
            # isolation in a group commit)
            self.store.chaos.on_statement()
        if self._direct:
            shape = self.store.capture_shape(sql)
            if shape is not None:
                n = self._execute_captured(sql, shape, params, None)
                if n is not None:
                    return n
        return self._execute_raw(sql, params)

    def executemany(self, sql: str, rows: Sequence) -> int:
        """Bulk DML: one prepared statement stepped over many parameter
        rows (the write-side counterpart of the r10 matcher's
        executemany flushes — bulk ingest writers should prefer this
        over a Python loop of `execute`).  Returns total rows affected.

        On the direct-capture path the whole call runs inside a
        SAVEPOINT: a row that fails mid-batch rolls the batch back
        before raising, so the in-memory capture never diverges from
        partially-applied statements."""
        if self.store.chaos is not None:
            self.store.chaos.on_statement()
        rows = list(rows)
        if self._direct and rows:
            shape = self.store.capture_shape(sql)
            if shape is not None:
                n = self._execute_captured(sql, shape, None, rows)
                if n is not None:
                    return n
        return self._executemany_raw(sql, rows)

    # -- capture plumbing (r15) ----------------------------------------

    def _execute_raw(self, sql: str, params) -> int:
        """The pre-r15 statement path: AFTER triggers log written cells
        to `__crdt_pending`."""
        from corrosion_tpu_torch.runtime.trace import timed_query

        self._ensure_capture(True)
        with timed_query(sql, shape="raw"):
            cur = self.conn.execute(
                sql, params if isinstance(params, dict) else tuple(params)
            )
        self._pending_dirty = True
        self._n_trigger += 1
        return cur.rowcount if cur.rowcount >= 0 else 0

    def _executemany_raw(self, sql: str, rows: list) -> int:
        from corrosion_tpu_torch.runtime.trace import timed_query

        self._ensure_capture(True)
        with timed_query(sql, shape="raw"):
            cur = self.conn.executemany(sql, rows)
        self._pending_dirty = True
        self._n_trigger += 1
        return cur.rowcount if cur.rowcount >= 0 else 0

    def _flush_capture_metrics(self) -> None:
        """One registry round per commit for the per-statement capture
        counters (`corro.write.capture.{direct,trigger,fallback}.total`
        + `corro.write.capture.seconds`)."""
        from corrosion_tpu_torch.runtime.metrics import METRICS

        if self._n_direct:
            METRICS.counter("corro.write.capture.direct.total").inc(
                self._n_direct
            )
            METRICS.histogram("corro.write.capture.seconds").observe(
                self._capture_secs
            )
        if self._n_trigger:
            METRICS.counter("corro.write.capture.trigger.total").inc(
                self._n_trigger
            )
        if self._n_fallback:
            METRICS.counter("corro.write.capture.fallback.total").inc(
                self._n_fallback
            )
        self._n_direct = self._n_trigger = self._n_fallback = 0
        self._capture_secs = 0.0

    def _ensure_capture(self, on: bool) -> None:
        """Transition the trigger gate (`CrdtStore._capture_flag`, read
        by the triggers' corro_capture_on()) only when needed — a plain
        Python store, unconditionally restored to ON in __exit__."""
        if self._capture_off == (not on):
            return
        self.store._capture_flag[0] = 1 if on else 0
        self._capture_off = not on

    def _drain_trigger_rows(self) -> None:
        """Move trigger-logged pending rows into the in-memory stream.
        Invariant: rows in `__crdt_pending` always postdate the last
        drained/direct append, so extending at the tail preserves the
        exact rowseq order a pure trigger run would have produced."""
        if not self._pending_dirty:
            return
        conn = self.conn
        rows = conn.execute(
            "SELECT tbl, pk, cid, val FROM __crdt_pending ORDER BY rowseq"
        ).fetchall()
        if rows:
            self._captured.extend(
                (r[0], bytes(r[1]), r[2], r[3]) for r in rows
            )
            conn.execute("DELETE FROM __crdt_pending")
        self._pending_dirty = False

    def _take_pending(self) -> list:
        """The merged capture stream for finalize, leaving the tx clean."""
        self._drain_trigger_rows()
        out, self._captured = self._captured, []
        return out

    def _preimage(
        self, meta, pk_tuples: list, cols: list
    ) -> Dict[tuple, dict]:
        """Current values of `cols` for the given pk tuples (absent key
        = no such row) — ONE chunked read replacing the per-cell state
        the triggers would have materialized."""
        conn = self.conn
        uniq = list(dict.fromkeys(pk_tuples))
        sel = ", ".join(f'"{c}"' for c in (*meta.pk_cols, *cols))
        npk = len(meta.pk_cols)
        out: Dict[tuple, dict] = {}
        if npk == 1:
            step = 900
            col = meta.pk_cols[0]
            for i in range(0, len(uniq), step):
                chunk = uniq[i : i + step]
                marks = ",".join("?" * len(chunk))
                for r in conn.execute(
                    f'SELECT {sel} FROM "{meta.name}" WHERE "{col}"'
                    f" IN ({marks})",
                    [u[0] for u in chunk],
                ):
                    out[(r[0],)] = {
                        c: r[npk + j] for j, c in enumerate(cols)
                    }
        else:
            step = max(1, 800 // npk)
            pk_sel = ",".join(f'"{c}"' for c in meta.pk_cols)
            row_marks = "(" + ",".join("?" * npk) + ")"
            for i in range(0, len(uniq), step):
                chunk = uniq[i : i + step]
                values = ",".join([row_marks] * len(chunk))
                for r in conn.execute(
                    f'SELECT {sel} FROM "{meta.name}"'
                    f" WHERE ({pk_sel}) IN (VALUES {values})",
                    [v for u in chunk for v in u],
                ):
                    out[tuple(r[k] for k in range(npk))] = {
                        c: r[npk + j] for j, c in enumerate(cols)
                    }
        return out

    def _execute_captured(
        self, sql: str, shape, params, many_rows: Optional[list]
    ) -> Optional[int]:
        """Run one recognized statement with triggers gated off and the
        written cells captured in memory.  None → value-level fallback:
        the statement has NOT run and the caller takes the trigger
        path.  Capture metrics accumulate on the tx and flush once per
        commit (`_flush_capture_metrics`) — this runs per statement on
        the hottest write path."""
        import time as _time

        from corrosion_tpu_torch.runtime.trace import timed_query

        t0 = _time.monotonic()
        cap = _capture
        meta = shape.meta
        rows = many_rows if many_rows is not None else [params]
        kind = shape.kind
        if kind == "insert":
            plans = cap.plan_insert_rows(shape, rows, many_rows is None)
        elif kind == "update":
            plans = []
            for p in rows:
                plan = cap.plan_update_row(shape, p)
                if plan is None:
                    plans = None
                    break
                plans.append(plan)
        else:
            plans = []
            for p in rows:
                plan = cap.plan_delete_row(shape, p)
                if plan is None:
                    plans = None
                    break
                plans.append(plan)
        if plans is None:
            self._n_fallback += 1
            return None

        # pre-image: ONE read feeding existence + IS-NOT comparisons
        conn = self.conn
        live: Dict[tuple, Optional[dict]] = {}
        conflicty = kind == "insert" and shape.conflict in (
            "ignore", "nothing", "upsert",
        )
        if kind == "update":
            cols = [c for c, _ in shape.set_slots]
            live = self._preimage(meta, [p[0] for p in plans], cols)
        elif conflicty:
            cols = sorted({c for c, _ in shape.upsert_set})
            live = self._preimage(meta, [p[0] for p in plans], cols)
        elif kind == "delete" and many_rows is not None:
            live = self._preimage(meta, plans, [])

        self._ensure_capture(False)
        savepoint = many_rows is not None and len(rows) > 1
        if savepoint:
            conn.execute("SAVEPOINT __corro_cap")
            try:
                with timed_query(sql, shape=shape.stmt_key):
                    cur = conn.executemany(sql, rows)
            except BaseException:
                conn.execute("ROLLBACK TO __corro_cap")
                conn.execute("RELEASE SAVEPOINT __corro_cap")
                raise
            conn.execute("RELEASE SAVEPOINT __corro_cap")
        elif many_rows is not None:
            with timed_query(sql, shape=shape.stmt_key):
                cur = conn.executemany(sql, rows)
        else:
            with timed_query(sql, shape=shape.stmt_key):
                cur = conn.execute(
                    sql,
                    params if isinstance(params, dict) else tuple(params),
                )

        # emit the trigger-equivalent stream, in statement order
        if self._pending_dirty:
            self._drain_trigger_rows()
        captured = self._captured
        tbl = meta.name
        pack = pack_columns
        if kind == "insert":
            for pk_vals, cells, skip, assigns, assigns_pend in plans:
                if skip:
                    continue
                if pk_vals is None:
                    pk_vals = (cur.lastrowid,)
                if conflicty:
                    old = live.get(pk_vals)
                    if old is not None:
                        if shape.conflict == "upsert":
                            pk = pack(list(pk_vals))
                            for cid, _sv in cap._cells_update(
                                meta, old, assigns
                            ):
                                captured.append(
                                    (tbl, pk, cid, assigns_pend[cid])
                                )
                            old.update(assigns)
                        # ignore / nothing: the row was silently skipped
                        continue
                    # later rows of this batch now conflict against
                    # this fresh row: its cell values (pending domain —
                    # `values_distinct` compares int/real numerically,
                    # so the integral-float munge cannot flip a verdict)
                    live[pk_vals] = {
                        cid: v for cid, v in cells if cid != SENTINEL
                    }
                pk = pack(list(pk_vals))
                captured.extend((tbl, pk, cid, v) for cid, v in cells)
        elif kind == "update":
            for pk_vals, new, new_pend in plans:
                old = live.get(pk_vals)
                if old is None:
                    continue  # no row matched the pk
                cells = cap._cells_update(meta, old, new)
                if cells:
                    pk = pack(list(pk_vals))
                    for cid, _sv in cells:
                        captured.append((tbl, pk, cid, new_pend[cid]))
                old.update(new)
        else:  # delete
            if many_rows is None:
                if cur.rowcount >= 1:
                    pk = pack(list(plans[0]))
                    for cid, val in cap._cells_delete(meta):
                        captured.append((tbl, pk, cid, val))
            else:
                for pk_vals in plans:
                    if live.pop(pk_vals, None) is not None:
                        pk = pack(list(pk_vals))
                        for cid, val in cap._cells_delete(meta):
                            captured.append((tbl, pk, cid, val))

        self._n_direct += 1
        self._capture_secs += _time.monotonic() - t0
        return cur.rowcount if cur.rowcount >= 0 else 0

    def commit(self) -> Tuple[List[Change], int, int]:
        """Finalize: assign db_version/seqs, write clocks, return
        (changes, db_version, last_seq). db_version == 0 → no changes."""
        import time as _time

        from corrosion_tpu_torch.runtime.metrics import METRICS

        conn = self.conn
        try:
            self._ensure_capture(True)
            self._flush_capture_metrics()
            pending = self._take_pending()
            t0 = _time.monotonic()
            changes = self._finalize_pending(pending)
            if pending:
                METRICS.histogram("corro.write.finalize.seconds").observe(
                    _time.monotonic() - t0
                )
            if self._nested:
                if self._savepoint:
                    conn.execute("RELEASE SAVEPOINT __corro_wtx")
            else:
                tc0 = _time.monotonic()
                if self.store.chaos is not None:
                    # r18 slow/sick-disk injection on the solo
                    # (group-commit-off) path — the group path's hook
                    # lives in group_tx
                    self.store.chaos.on_commit()
                conn.execute("COMMIT")
                self.store.last_flush_secs = _time.monotonic() - tc0
                _observe_commit_flush(self.store.last_flush_secs)
            self._done = True
            if changes:
                db_version = changes[0].db_version
                return changes, db_version, changes[-1].seq
            return [], 0, 0
        except BaseException:
            if self._nested:
                self._rollback_nested()
            else:
                _safe_rollback(conn)
                self.store._dv_cache.clear()  # bump may have rolled back
            self._done = True
            raise

    def commit_deferred(self) -> list:
        """Group-commit half-commit (nested mode only): capture + clear
        this sub-tx's pending log and release the savepoint WITHOUT
        finalizing — the leader finalizes the whole batch in one
        vectorized pass (`CrdtStore.finalize_group`), so the batch pays
        one probe/flush round instead of one per writer."""
        conn = self.conn
        try:
            self._ensure_capture(True)
            self._flush_capture_metrics()
            pending = self._take_pending()
            if self._savepoint:
                conn.execute("RELEASE SAVEPOINT __corro_wtx")
            self._done = True
            return pending
        except BaseException:
            self._rollback_nested()
            self._done = True
            raise

    def _rollback_nested(self) -> None:
        """Undo this sub-transaction only; the outer group tx lives on.
        If the OUTER transaction was already rolled back (interrupt),
        the savepoint is gone with it — nothing left to undo.  A
        savepoint-free solo sub-tx has nothing local to undo either:
        its failure propagates and aborts the whole group tx."""
        if not self._savepoint:
            return
        try:
            self.conn.execute("ROLLBACK TO __corro_wtx")
            self.conn.execute("RELEASE SAVEPOINT __corro_wtx")
        except sqlite3.OperationalError as e:
            log.debug("nested rollback raced outer rollback: %s", e)

    def rollback(self) -> None:
        if not self._done:
            if self._nested:
                self._rollback_nested()
            else:
                _safe_rollback(self.conn)
            self._done = True

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if not self._done:
                if exc_type is None:
                    self.commit()
                else:
                    self.rollback()
        finally:
            # the capture gate is process state, not tx state: whatever
            # happened above, triggers must be live for the next writer
            self.store._capture_flag[0] = 1
            self.store._lock.release()
        return False

    def _finalize_pending(self, pending) -> List[Change]:
        if not pending:
            return []
        if _finalize_engine() == "percell":
            return self._finalize_pending_percell(pending)
        return self._finalize_pending_vector(pending)

    def _finalize_pending_vector(self, pending) -> List[Change]:
        """Vectorized finalize (r14): the `_apply_batch` shape on the
        local-commit side — one item's worth of `finalize_group`.
        Semantics are pinned byte/clock-identical to
        `_finalize_pending_percell` by tests/test_finalize_batch.py
        (randomized equivalence)."""
        changes, _dv, _ls = self.store.finalize_group(
            [(pending, self.ts)]
        )[0]
        return changes

    def _finalize_pending_percell(self, pending) -> List[Change]:
        """Per-cell reference finalize: one SELECT/upsert round-trip per
        pending cell.  The semantic reference the vectorized path is
        pinned against — do not optimize this loop."""
        store = self.store
        conn = self.conn
        site = store.site_id
        db_version = store.db_version_for(site) + 1

        # Dedupe cells: last write in the tx wins; deletes ('-1X') override
        # the row's other pending entries for sentinel handling.
        cells: Dict[Tuple[str, bytes, str], SqliteValue] = {}
        order: List[Tuple[str, bytes, str]] = []
        deleted_rows: Dict[Tuple[str, bytes], bool] = {}
        created_rows: Dict[Tuple[str, bytes], bool] = {}
        for r in pending:
            tbl, pk, cid, val = r
            if cid == SENTINEL + "X":  # delete marker from the del trigger
                deleted_rows[(tbl, pk)] = True
                created_rows.pop((tbl, pk), None)
                # drop any pending column writes for the row
                for key in [k for k in cells if k[0] == tbl and k[1] == pk]:
                    del cells[key]
                    order.remove(key)
                continue
            if cid == SENTINEL:
                created_rows[(tbl, pk)] = True
                deleted_rows.pop((tbl, pk), None)
            key = (tbl, pk, cid)
            if key not in cells:
                order.append(key)
            cells[key] = val

        changes: List[Change] = []
        seq = 0

        def emit(tbl: str, pk: bytes, cid: str, val, col_version: int, cl: int):
            nonlocal seq
            changes.append(
                Change(
                    table=tbl,
                    pk=pk,
                    cid=cid,
                    val=val,
                    col_version=col_version,
                    db_version=db_version,
                    seq=seq,
                    site_id=site.bytes16,
                    cl=cl,
                    ts=self.ts,
                )
            )
            seq += 1

        # deletes first: sentinel change with bumped-even cl
        for (tbl, pk) in deleted_rows:
            rt, ct = _rows_table(tbl), _clock_table(tbl)
            row = conn.execute(
                f'SELECT cl FROM "{rt}" WHERE pk = ?', (pk,)
            ).fetchone()
            cl = (row["cl"] if row else 1) + 1
            if cl % 2 == 1:
                cl += 1  # already deleted? keep even
            conn.execute(
                f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                (pk, cl),
            )
            conn.execute(
                f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?', (pk, SENTINEL)
            )
            emit(tbl, pk, SENTINEL, None, cl, cl)
            store._upsert_clock(ct, changes[-1])

        # creations/updates
        for key in order:
            tbl, pk, cid = key
            rt, ct = _rows_table(tbl), _clock_table(tbl)
            rrow = conn.execute(
                f'SELECT cl FROM "{rt}" WHERE pk = ?', (pk,)
            ).fetchone()
            if cid == SENTINEL:
                # row creation (or resurrection)
                prev_cl = rrow["cl"] if rrow else 0
                cl = prev_cl + 1 if prev_cl % 2 == 0 else prev_cl
                if rrow is None or prev_cl % 2 == 0:
                    conn.execute(
                        f'INSERT INTO "{rt}" (pk, cl) VALUES (?, ?)'
                        " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                        (pk, cl),
                    )
                    if prev_cl % 2 == 0 and prev_cl > 0:
                        # resurrection: reset column clocks
                        conn.execute(
                            f'DELETE FROM "{ct}" WHERE pk = ? AND cid != ?',
                            (pk, SENTINEL),
                        )
                    emit(tbl, pk, SENTINEL, None, cl, cl)
                    store._upsert_clock(ct, changes[-1])
                continue
            # column write on a (now) live row
            cl = rrow["cl"] if rrow else 1
            crow = conn.execute(
                f'SELECT col_version FROM "{ct}" WHERE pk = ? AND cid = ?',
                (pk, cid),
            ).fetchone()
            col_version = (crow["col_version"] if crow else 0) + 1
            emit(tbl, pk, cid, cells[key], col_version, cl)
            store._upsert_clock(ct, changes[-1])

        if changes:
            store._bump_db_version(site, db_version)
            store.record_last_seq(site, db_version, changes[-1].seq)
        return changes


class _SqliteGapStore:
    def __init__(self, conn: sqlite3.Connection):
        self._conn = conn

    def delete_gap(self, actor_id: ActorId, start: int, end: int) -> None:
        self._conn.execute(
            "DELETE FROM __corro_bookkeeping_gaps"
            " WHERE actor_id = ? AND start = ? AND end = ?",
            (actor_id.bytes16, start, end),
        )

    def insert_gap(self, actor_id: ActorId, start: int, end: int) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO __corro_bookkeeping_gaps VALUES (?, ?, ?)",
            (actor_id.bytes16, start, end),
        )


def _sql_pack(*args) -> bytes:
    return pack_columns(list(args))
