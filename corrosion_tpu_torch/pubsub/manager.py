"""SubsManager: dedupe, lifecycle, restore and change ROUTING of
live-query matchers.

The port's copy of `corrosion_tpu/pubsub/manager.py`.

Counterpart of `SubsManager` in `klukai-types/src/pubsub.rs:54-256`:
subscriptions are deduped by SQL text hash (`:565`), `get_or_insert`
(`:115`) returns an existing matcher when one already runs the same
query, and `restore` (`:164`) re-attaches matchers persisted under
`<subs_path>/<uuid>/sub.sqlite` on agent start
(`klukai-agent/src/agent/setup.rs:296-349`).

Routing (r10): the change hook used to call every matcher's
`filter_candidates` for every committed batch — O(subs × changes)
Python work under the GIL, on the WRITE path.  The manager now keeps an
inverted index `table → {cid | sentinel} → (handles…)` rebuilt on
(un)subscribe, so `match_changes` does one dict hop per change and
feeds each hit matcher a pre-filtered candidate pk set directly:
O(changes + hits), subscription count out of the write path.  A change
routes to a matcher iff the matcher's parsed column deps contain its
(table, cid) — or it is a sentinel (row create/delete), which reaches
every matcher on the table — exactly `Matcher.filter_candidates`'s
predicate, amortized across matchers.

Serving-plane lifecycle (r16): matchers are REFCOUNTED.  Subscribing
streams dedupe onto one matcher per distinct query — keyed by the exact
SQL hash (the wire-parity `corro-query-hash`) AND by a canonical
token-normalized form, so whitespace/comment variants of the same query
share a matcher — and the last stream's detach arms a linger timer
(`[subs] matcher_linger_secs`); a reconnect inside the window re-uses
the warm matcher + changes log, after it the matcher and its sub db are
reaped.  `admission_reject` bounds total live streams per node
(`[subs] max_streams`), and `fanout` is the shared coalescing writer
every HTTP stream sink is served by (pubsub/fanout.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import shutil
import sqlite3
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from corrosion_tpu_torch.pubsub.executor import DiffExecutor
from corrosion_tpu_torch.pubsub.fanout import FanoutWriter
from corrosion_tpu_torch.pubsub.matcher import (
    Matcher,
    MatcherError,
    MatcherHandle,
    sql_hash,
)
from corrosion_tpu_torch.pubsub.parse import ParseError, parse_select
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.change import SENTINEL, Change

# table -> cid (or SENTINEL) -> handles whose queries the change affects
Router = Dict[str, Dict[str, Tuple[MatcherHandle, ...]]]


def canonical_sql(sql: str) -> str:
    """Token-normalized query text: whitespace and comments collapse so
    textual variants of one query hash alike.  Keywords keep their case
    (identifier semantics stay untouched); unparseable text falls back
    to a stripped literal (it will fail parse_select downstream with
    its own error)."""
    from corrosion_tpu_torch.pubsub.parse import _join_tokens, tokenize

    try:
        return _join_tokens(tokenize(sql))
    except ParseError:
        return sql.strip()


class SubsManager:
    """Registry of running matchers, keyed by id and by SQL hash."""

    def __init__(
        self,
        store,
        subs_path: Optional[str] = None,
        batch_wait: Optional[float] = None,
        cfg=None,
    ):
        from corrosion_tpu_torch.runtime.config import SubsConfig

        self.store = store
        self.subs_path = subs_path
        # matcher candidate-batching window ([pubsub] candidate_batch_wait,
        # r12); None keeps the per-matcher pubsub.rs-parity default
        self.batch_wait = batch_wait
        # [subs] serving-plane knobs (admission, lag bounds, linger)
        self.cfg = cfg if cfg is not None else SubsConfig()
        self._by_id: Dict[str, MatcherHandle] = {}
        self._by_hash: Dict[str, str] = {}  # exact sql hash -> id
        self._by_canon: Dict[str, str] = {}  # canonical sql hash -> id
        self._lock = asyncio.Lock()
        # immutable snapshot, swapped whole on (un)subscribe: worker
        # threads read it lock-free mid-rebuild and see old or new,
        # never a half-built index
        self._router: Router = {}
        self.executor = DiffExecutor(self.cfg.diff_workers)
        self.fanout = FanoutWriter(self.cfg.writer_tick_secs)
        # r22 refuse-bulk deadline (monotonic): while set in the future,
        # NEW streams get the typed admission 503 — the store-faults
        # remediation actuator (agent/remediation.py) arms it so a sick
        # node stops taking on serving work it will only shed; existing
        # reads and the matchers' own queries are untouched
        self.refuse_until: float = 0.0

    def _rebuild_router(self) -> None:
        idx: Dict[str, Dict[str, Set[MatcherHandle]]] = {}
        for handle in self._by_id.values():
            # routing_keys = filter_candidates's predicate, factored to
            # the parse layer (sentinel per table + every dep column)
            for table, cid in handle.matcher.parsed.routing_keys():
                idx.setdefault(table, {}).setdefault(cid, set()).add(
                    handle
                )
        self._router = {
            table: {cid: tuple(hs) for cid, hs in by_cid.items()}
            for table, by_cid in idx.items()
        }
        METRICS.gauge("corro.subs.router.tables").set(len(self._router))

    def get(self, sub_id: str) -> Optional[MatcherHandle]:
        return self._by_id.get(sub_id)

    def get_by_sql(self, sql: str) -> Optional[MatcherHandle]:
        sid = self._by_hash.get(sql_hash(sql))
        if sid is None:
            sid = self._by_canon.get(sql_hash(canonical_sql(sql)))
        return self._by_id.get(sid) if sid else None

    def handles(self) -> List[MatcherHandle]:
        return list(self._by_id.values())

    # -- serving-plane census / admission (r16) ----------------------------

    def stream_count(self) -> int:
        """Live streams across every matcher (HTTP sinks + in-process
        queue subscribers).  O(matchers) — matchers are the deduped
        axis, k distinct queries, not the 100k stream axis."""
        return sum(h.subscriber_count for h in self._by_id.values())

    def admission_reject(self) -> Optional[str]:
        """None = admit; otherwise the typed rejection reason.  Counted
        so a fleet hitting its admission ceiling is visible."""
        if self.refuse_until and time.monotonic() < self.refuse_until:
            METRICS.counter("corro.subs.admission.rejected.total").inc()
            return (
                "node refusing new streams"
                " (remediation refuse-bulk; store faulting)"
            )
        mx = self.cfg.max_streams
        if mx and self.stream_count() >= mx:
            METRICS.counter("corro.subs.admission.rejected.total").inc()
            return (
                f"stream limit reached ({mx} live streams;"
                " [subs] max_streams)"
            )
        return None

    def make_sink(self):
        """A base StreamSink bounded by this manager's lag config —
        HTTP flavors subclass in api/pubsub_http.py; tests attach these
        directly."""
        from corrosion_tpu_torch.pubsub.fanout import StreamSink

        return StreamSink(self.cfg.max_lag_bytes, self.cfg.max_lag_batches)

    # -- refcounted matcher lifecycle (r16) --------------------------------

    def _note_active(self, handle: MatcherHandle) -> None:
        t = getattr(handle, "_linger_timer", None)
        if t is not None:
            t.cancel()
            handle._linger_timer = None
        METRICS.gauge("corro.subs.streams").set(self.stream_count())

    def _note_idle(self, handle: MatcherHandle) -> None:
        """Last ref detached: arm the linger reaper.  A reconnect (or a
        new subscriber deduping onto this matcher) inside the window
        cancels it and reuses the warm matcher + changes log."""
        self._note_active(handle)  # reset any armed timer first
        loop = asyncio.get_event_loop()
        handle._linger_timer = loop.call_later(
            max(0.0, self.cfg.matcher_linger_secs),
            lambda: asyncio.ensure_future(self._reap(handle)),
        )

    async def _reap(self, handle: MatcherHandle) -> None:
        async with self._lock:
            if (
                self._by_id.get(handle.id) is not handle
                or handle.active_refs > 0
            ):
                return
            await self._remove_locked(handle.id, purge=True)

    def _adopt(self, handle: MatcherHandle) -> None:
        handle.on_active = self._note_active
        handle.on_idle = self._note_idle

    async def get_or_insert(
        self, sql: str, lease: bool = False
    ) -> Tuple[MatcherHandle, bool]:
        """Return (handle, created). When created, the initial query has
        materialized into the sub db; subscribers read rows through
        `handle.matcher.snapshot()` (attach-then-snapshot protocol).
        `lease=True` pins the handle against the linger reaper until the
        caller attaches (release with `handle.release_lease()`)."""
        async with self._lock:
            existing = self.get_by_sql(sql)
            if existing is not None:
                if existing.error is None:
                    METRICS.counter("corro.subs.dedupe.hits.total").inc()
                    if lease:
                        existing.lease()
                    else:
                        self._note_active(existing)
                    return existing, False
                # dead matcher: tear it down fully before replacing
                await self._remove_locked(existing.id, purge=True)
            parsed = parse_select(sql, self.store.schema)
            sub_id = str(uuid.uuid4())
            matcher = Matcher(self.store, parsed, sub_id, sql, self.subs_path)
            loop = asyncio.get_running_loop()

            def build():
                matcher.create_sub_db()
                return matcher.run_initial()

            try:
                await asyncio.to_thread(build)
            except (sqlite3.Error, MatcherError) as e:
                matcher.close()
                await asyncio.to_thread(self._purge_dir, sub_id)
                raise ParseError(str(e)) from e
            handle = MatcherHandle(
                matcher, loop, executor=self.executor,
                batch_wait=self.batch_wait, fanout=self.fanout,
            )
            self._adopt(handle)
            handle.start()
            self._by_id[sub_id] = handle
            self._by_hash[sql_hash(sql)] = sub_id
            self._by_canon[sql_hash(canonical_sql(sql))] = sub_id
            self._rebuild_router()
            METRICS.gauge("corro.subs.count").set(len(self._by_id))
            if lease:
                handle.lease()
            else:
                # an unleased, never-attached matcher must not live
                # forever: the linger clock starts at creation
                self._note_idle(handle)
            return handle, True

    async def restore(self) -> int:
        """Re-attach matchers persisted on disk; purge incomplete ones.
        A restored matcher re-checks every pk of its source tables so
        changes applied while the agent was down surface as events (the
        reference catches up via `match_changes_from_db_version`)."""
        if self.subs_path is None:
            return 0
        root = Path(self.subs_path)
        if not root.exists():
            return 0
        n = 0
        for d in sorted(root.iterdir()):
            db = d / "sub.sqlite"
            if not d.is_dir() or not db.exists():
                continue
            try:
                sql = await asyncio.to_thread(self._read_meta_sql, db)
                parsed = parse_select(sql, self.store.schema)
                matcher = Matcher(self.store, parsed, d.name, sql, self.subs_path)
                await asyncio.to_thread(matcher.reattach)
            except (sqlite3.Error, MatcherError, ParseError, KeyError):
                # purge off-loop: an incomplete sub dir can hold a
                # multi-MB sub.sqlite and rmtree would stall the loop
                await asyncio.to_thread(
                    shutil.rmtree, d, ignore_errors=True
                )
                continue
            handle = MatcherHandle(
                matcher, asyncio.get_running_loop(), executor=self.executor,
                batch_wait=self.batch_wait, fanout=self.fanout,
            )
            self._adopt(handle)
            handle.start()
            self._by_id[d.name] = handle
            self._by_hash[sql_hash(sql)] = d.name
            self._by_canon[sql_hash(canonical_sql(sql))] = d.name
            await asyncio.to_thread(self._resync, handle)
            # restored matchers start with zero attached streams: the
            # linger clock decides whether anyone still wants them
            self._note_idle(handle)
            n += 1
        self._rebuild_router()
        METRICS.gauge("corro.subs.count").set(len(self._by_id))
        return n

    def _resync(self, handle: MatcherHandle) -> None:
        """Enqueue a full pk sweep of every source table as candidates:
        live pks ∪ materialized pks, so rows inserted OR deleted while
        the agent was down both get re-checked (the reference catches up
        via match_changes_from_db_version, updates.rs:490)."""
        from corrosion_tpu_torch.types.pack import pack_columns

        with self.store.pooled_read() as conn:
            for t in handle.matcher.parsed.tables:
                pks = self.store.schema.table(t.name).pk_cols
                sel = ", ".join(f'"{c}"' for c in pks)
                rows = conn.execute(f'SELECT {sel} FROM "{t.name}"').fetchall()
                cands = {pack_columns(tuple(r)) for r in rows}
                cands.update(handle.matcher.materialized_pks(t.name))
                if cands:
                    handle.loop.call_soon_threadsafe(
                        handle._queue.put_nowait, ({t.name: cands}, None)
                    )

    def _read_meta_sql(self, db: Path) -> str:
        conn = sqlite3.connect(db)
        try:
            row = conn.execute(
                "SELECT v FROM meta WHERE k = 'sql'"
            ).fetchone()
            if row is None:
                raise KeyError("no sql in sub meta")
            return row[0]
        finally:
            conn.close()

    # -- feeding -----------------------------------------------------------

    def match_changes(self, changes: Sequence[Change], stamp=None) -> None:
        """Change hook: route committed changes through the inverted
        index (updates.rs:424-488). Thread-safe. One dict hop per
        change, candidate pk sets accumulated per hit matcher —
        `filter_candidates` never runs here, and matchers whose
        (table, cid) index misses do no work at all. Dead matchers are
        skipped (their queue has no consumer) and torn down from the
        loop.  `stamp` (runtime/latency.py BatchStamp) rides with the
        candidates so the matcher can attribute apply→event time."""
        router = self._router
        if not router:
            return
        per: Dict[MatcherHandle, Dict[str, Set[bytes]]] = {}
        matched = 0
        fanout = 0
        for ch in changes:
            by_cid = router.get(ch.table)
            if by_cid is None:
                continue
            handles = by_cid.get(
                SENTINEL if ch.is_sentinel() else ch.cid
            )
            if not handles:
                continue
            matched += 1
            fanout += len(handles)
            for h in handles:
                per.setdefault(h, {}).setdefault(
                    ch.table, set()
                ).add(ch.pk)
        METRICS.counter("corro.subs.router.changes.total").inc(len(changes))
        if matched:
            METRICS.counter("corro.subs.router.matched.total").inc(matched)
            METRICS.counter("corro.subs.router.fanout.total").inc(fanout)
        for handle, cands in per.items():
            if handle.error is not None:
                handle.loop.call_soon_threadsafe(
                    self._schedule_removal, handle.id
                )
                continue
            handle.enqueue_candidates(cands, stamp)

    def _schedule_removal(self, sub_id: str) -> None:
        asyncio.ensure_future(self.remove(sub_id, purge=True))

    # -- teardown ----------------------------------------------------------

    async def drain(self) -> int:
        """Drain every matcher home off this node (r22 store-faults
        actuator): each handle stops CLEANLY — attached streams get the
        bare-None terminal frame, so clients end with a typed stop and
        re-subscribe elsewhere (or here, post-revert) via the resume
        path.  Sub dbs are NOT purged: a recovered node re-attaches
        them through `restore()`.  Returns how many homes drained."""
        n = 0
        for sid in list(self._by_id):
            await self.remove(sid)
            n += 1
        return n

    async def remove(self, sub_id: str, purge: bool = False) -> None:
        async with self._lock:
            await self._remove_locked(sub_id, purge)

    async def _remove_locked(self, sub_id: str, purge: bool = False) -> None:
        handle = self._by_id.pop(sub_id, None)
        if handle is None:
            return
        t = getattr(handle, "_linger_timer", None)
        if t is not None:
            t.cancel()
            handle._linger_timer = None
        handle.on_active = handle.on_idle = None
        self._by_hash.pop(sql_hash(handle.sql), None)
        canon = sql_hash(canonical_sql(handle.sql))
        if self._by_canon.get(canon) == sub_id:
            self._by_canon.pop(canon, None)
        self._rebuild_router()
        await handle.stop()
        if purge:
            await asyncio.to_thread(self._purge_dir, sub_id)
        METRICS.gauge("corro.subs.count").set(len(self._by_id))

    def _purge_dir(self, sub_id: str) -> None:
        if self.subs_path is not None:
            shutil.rmtree(Path(self.subs_path) / sub_id, ignore_errors=True)

    async def stop_all(self) -> None:
        for sid in list(self._by_id):
            await self.remove(sid)
        self.fanout.stop()
        self.executor.shutdown()
