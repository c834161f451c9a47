"""UpdatesManager: per-table raw change notifications.

The port's copy of `corrosion_tpu/pubsub/updates.py`.

Counterpart of `klukai-types/src/updates.rs` (`UpdatesManager`,
`UpdateHandle`, `match_changes` :424): clients subscribe to a *table*
(not a query) and receive NotifyEvents classifying each changed row as
insert/update/delete from its causal length (even = deleted, odd =
alive; updates.rs:294-297). Events are batched for 600 ms
(updates.rs:311-422) and a per-pk cl cache guards against out-of-order
delete/update races (updates.rs:329).
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.change import Change
from corrosion_tpu_torch.types.pack import unpack_columns

BATCH_WAIT = 0.6  # 600 ms flush interval (updates.rs:311)
CL_CACHE_MAX = 65536  # bound the per-pk causal-length cache


def _merge(cur: Optional[Tuple[str, int]], kind: str, cl: int) -> Tuple[str, int]:
    """Later causal length wins; at equal cl a delete beats an update
    (a delete and an update of the same epoch can share a batch)."""
    if cur is None or cl > cur[1] or (cl == cur[1] and kind == "delete"):
        return (kind, cl)
    return cur


class UpdateHandle:
    """One watched table: classification, batching, subscriber fan-out."""

    def __init__(self, table: str, loop: asyncio.AbstractEventLoop):
        self.table = table
        self.loop = loop
        self._queue: asyncio.Queue = asyncio.Queue()
        self._subscribers: List[asyncio.Queue] = []
        self._sub_lock = threading.Lock()
        self._task: Optional[asyncio.Task] = None
        self._done = asyncio.Event()
        # pk -> last seen causal length (the cl cache, updates.rs:329);
        # LRU-bounded, guarded by a lock: hooks fire from worker threads
        # (gossip ingestion) and the loop thread (local writes) at once
        self._cl_cache: "OrderedDict[bytes, int]" = OrderedDict()
        self._cl_lock = threading.Lock()
        self.error: Optional[str] = None

    def start(self) -> None:
        self._task = self.loop.create_task(self._run())

    def match_changes(self, changes: Sequence[Change]) -> None:
        """Thread-safe: classify + enqueue rows touched in this batch."""
        rows: Dict[bytes, Tuple[str, int]] = {}
        with self._cl_lock:
            for ch in changes:
                if ch.table != self.table:
                    continue
                prev = self._cl_cache.get(ch.pk, 0)
                if ch.cl < prev:
                    continue  # stale out-of-order change
                if ch.cl % 2 == 0:
                    kind = "delete"
                elif ch.cl > prev:
                    kind = "insert"  # row (re)created in this causal epoch
                else:
                    kind = "update"
                self._cl_cache[ch.pk] = ch.cl
                self._cl_cache.move_to_end(ch.pk)
                rows[ch.pk] = _merge(rows.get(ch.pk), kind, ch.cl)
            while len(self._cl_cache) > CL_CACHE_MAX:
                self._cl_cache.popitem(last=False)
        if rows:
            METRICS.counter("corro.updates.matched.count", table=self.table).inc(len(rows))
            self.loop.call_soon_threadsafe(self._queue.put_nowait, rows)

    async def _run(self) -> None:
        """Flush batches every 600 ms (updates.rs:311-422)."""
        try:
            await self._run_inner()
        except Exception as e:  # flush task died: mark dead, don't zombie
            self.error = str(e)
            METRICS.counter(
                "corro.updates.errors.count", table=self.table
            ).inc()

    async def _run_inner(self) -> None:
        try:
            while True:
                first = await self._queue.get()
                if first is None:
                    break
                batch: Dict[bytes, Tuple[str, int]] = dict(first)
                deadline = self.loop.time() + BATCH_WAIT
                while True:
                    timeout = deadline - self.loop.time()
                    if timeout <= 0:
                        break
                    try:
                        more = await asyncio.wait_for(self._queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    if more is None:
                        self._queue.put_nowait(None)
                        break
                    for pk, v in more.items():
                        batch[pk] = _merge(batch.get(pk), v[0], v[1])
                events = [
                    (kind, list(unpack_columns(pk)))
                    for pk, (kind, _cl) in batch.items()
                ]
                with self._sub_lock:
                    subs = list(self._subscribers)
                for q in subs:
                    for ev in events:
                        q.put_nowait(ev)
        finally:
            # release attached HTTP streams: None = end-of-stream sentinel
            with self._sub_lock:
                subs = list(self._subscribers)
            for q in subs:
                q.put_nowait(None)
            self._done.set()

    def attach(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        with self._sub_lock:
            self._subscribers.append(q)
        return q

    def detach(self, q: asyncio.Queue) -> None:
        with self._sub_lock:
            with contextlib.suppress(ValueError):
                self._subscribers.remove(q)

    @property
    def subscriber_count(self) -> int:
        with self._sub_lock:
            return len(self._subscribers)

    async def stop(self) -> None:
        self._queue.put_nowait(None)
        if self._task is not None:
            await self._done.wait()
            self._task = None


class UpdatesManager:
    """Registry of per-table update handles (updates.rs:29-61)."""

    def __init__(self, store):
        self.store = store
        self._by_table: Dict[str, UpdateHandle] = {}
        self._lock = asyncio.Lock()

    async def get_or_insert(self, table: str) -> Tuple[UpdateHandle, bool]:
        if table not in self.store.schema.tables:
            raise KeyError(f"unknown table: {table}")
        async with self._lock:
            h = self._by_table.get(table)
            if h is not None and h.error is not None:
                # dead flush task: replace the zombie
                self._by_table.pop(table, None)
                h = None
            if h is not None:
                return h, False
            h = UpdateHandle(table, asyncio.get_running_loop())
            h.start()
            self._by_table[table] = h
            METRICS.gauge("corro.updates.count").set(len(self._by_table))
            return h, True

    def handles(self) -> List[UpdateHandle]:
        return list(self._by_table.values())

    def match_changes(self, changes: Sequence[Change], stamp=None) -> None:
        # `stamp` (the batch latency stamp the change hooks pass) is
        # unused here: NotifyEvents carry no per-event payload to bill
        for h in list(self._by_table.values()):
            if h.error is None:  # dead handles drain nothing; skip
                h.match_changes(changes)

    async def stop_all(self) -> None:
        for t in list(self._by_table):
            h = self._by_table.pop(t)
            await h.stop()
