"""Change ingestion: the backpressure heart + the CRDT apply path.

The port's copy of `corrosion_tpu/agent/ingest.py`.

Counterparts:
  - `handle_changes` queue (`klukai-agent/src/agent/handlers.rs:555-789`):
    dedupe against a seen-cache and the bookie, drop oldest beyond
    `processing_queue_len`, batch to `apply_queue_len` cost or a 10 ms
    tick, ≤`max_concurrent_applies` concurrent apply jobs, re-broadcast
    novel broadcast-sourced changes, pull HLC forward from change
    timestamps (`handlers.rs:696-708`).
  - `process_multiple_changes` (`agent/util.rs:703-1054`): one write
    transaction per batch — complete changesets merge into the store,
    incomplete ones buffer with seq-range bookkeeping, empties only move
    the gap set; closing a version's last seq gap schedules a
    fully-buffered apply (`util.rs:1000-1023`); committed impactful rows
    feed the subs/updates hooks (`util.rs:1042-1047`).  The hooks run
    HERE on the apply worker thread: since r10 the subs hook is the
    manager's inverted routing index (O(changes + hits), sub count out
    of the loop) and the per-batch hook cost is recorded as
    `corro.agent.changes.hooks.seconds` — a regression back to
    O(subs × changes) shows up as a rising ingest tax.
  - `process_fully_buffered_changes` (`util.rs:552-700`).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import List, Optional, Set, Tuple

from corrosion_tpu_torch.agent.handle import Agent, BroadcastInput, ChangeSource
from corrosion_tpu_torch.runtime.channels import ChannelClosed
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.store.bookkeeping import PartialVersion
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import (
    ChangeV1,
    ChangesetEmpty,
    ChangesetEmptySet,
    ChangesetFull,
)
from corrosion_tpu_torch.types.rangeset import RangeSet

# seen-cache key: (actor, version range, seq range or None)
_SeenKey = Tuple[ActorId, Tuple[int, int], Optional[Tuple[int, int]]]
_SEEN_CACHE_MAX = 4096


def _seen_key(cv: ChangeV1) -> List[_SeenKey]:
    cs = cv.changeset
    if isinstance(cs, ChangesetFull):
        return [(cv.actor_id, (cs.version, cs.version), cs.seqs)]
    if isinstance(cs, ChangesetEmpty):
        return [(cv.actor_id, cs.versions, None)]
    if isinstance(cs, ChangesetEmptySet):
        return [(cv.actor_id, vr, None) for vr in cs.versions]
    return []


def _bookie_has(agent: Agent, cv: ChangeV1) -> bool:
    booked = agent.bookie.get(cv.actor_id)
    if booked is None:
        return False
    cs = cv.changeset
    with booked.read() as bv:
        if isinstance(cs, ChangesetFull):
            return bv.contains(cs.version, cs.seqs)
        if isinstance(cs, ChangesetEmpty):
            return bv.contains_all(cs.versions)
        if isinstance(cs, ChangesetEmptySet):
            return all(bv.contains_all(vr) for vr in cs.versions)
    return False


async def handle_changes(agent: Agent) -> None:
    """The hot ingestion loop; owns rx_changes."""
    perf = agent.config.perf
    seen: "OrderedDict[_SeenKey, None]" = OrderedDict()
    buf: List[Tuple[ChangeV1, ChangeSource, List[_SeenKey], float]] = []
    apply_sem = asyncio.Semaphore(perf.max_concurrent_applies)
    jobs: Set[asyncio.Task] = set()

    def unsee(keys: List[_SeenKey]) -> None:
        # seen-cache repair: a dropped/failed change must be re-deliverable
        # (handlers.rs:732-751)
        for k in keys:
            seen.pop(k, None)

    async def flush() -> None:
        if not buf:
            return
        batch, buf[:] = buf[:], []
        now = time.monotonic()
        for _, _, _, t_enq in batch:
            METRICS.histogram("corro.agent.changes.queued.seconds").observe(
                now - t_enq
            )
        METRICS.histogram("corro.agent.changes.batch.size").observe(len(batch))
        METRICS.counter("corro.agent.changes.batch.spawned").inc()
        METRICS.counter("corro.agent.changes.processing.started").inc(
            len(batch)
        )
        await apply_sem.acquire()
        METRICS.gauge("corro.agent.changes.processing.jobs").set(len(jobs) + 1)

        async def job():
            try:
                # remote applies queue on the NORMAL write lane so local
                # client writes (PRIORITY) overtake a sync burst
                # (agent.rs:503-519)
                async with agent.write_gate.normal():
                    await asyncio.to_thread(
                        process_multiple_changes,
                        agent,
                        [(cv, src) for cv, src, _, _ in batch],
                    )
            except Exception:
                METRICS.counter("corro.agent.changes.processing.failed").inc()
                for _, _, keys, _ in batch:
                    unsee(keys)
                raise
            finally:
                apply_sem.release()
                METRICS.gauge("corro.agent.changes.processing.jobs").set(
                    max(0, len(jobs) - 1)
                )

        t = asyncio.ensure_future(job())
        jobs.add(t)
        t.add_done_callback(jobs.discard)

    deadline: Optional[float] = None
    epoch = agent.ingest_epoch
    while not agent.tripwire.tripped:
        timeout = None
        if deadline is not None:
            timeout = max(0.0, deadline - time.monotonic())
        try:
            item = await asyncio.wait_for(
                agent.rx_changes.recv(),
                timeout if timeout is not None else perf.sync_interval_max_secs,
            )
        except asyncio.TimeoutError:
            item = None
        except ChannelClosed:
            break

        if agent.ingest_epoch != epoch:
            # r17 snapshot install swapped the database: every "seen"
            # verdict predates the swap and may describe data the swap
            # dropped — a stale entry would make this loop skip the
            # re-served version forever (the catch-up plane's re-pull
            # would grind against it each round).  Checked AFTER the
            # recv so the verdict for THIS item is never the stale one.
            epoch = agent.ingest_epoch
            seen.clear()
        if item is not None:
            cv, source = item
            METRICS.counter("corro.agent.changes.recv").inc()
            keys = _seen_key(cv)
            if all(k in seen for k in keys) or _bookie_has(agent, cv):
                METRICS.counter("corro.agent.changes.skipped").inc()
            else:
                for k in keys:
                    seen[k] = None
                while len(seen) > _SEEN_CACHE_MAX:
                    seen.popitem(last=False)
                # pull our HLC forward from the change's timestamp
                cs = cv.changeset
                ts = getattr(cs, "ts", None)
                if ts and not ts.is_zero():
                    agent.clock.update_with_timestamp(ts)
                # novel broadcast-sourced changes get re-broadcast;
                # a traced change relays with its hop count bumped so
                # downstream apply spans name their distance from the
                # origin (r19 — the forced-keep bit travels untouched)
                if source == ChangeSource.BROADCAST and not _is_empty(cv):
                    if cv.trace_meta is not None:
                        from dataclasses import replace as _replace

                        from corrosion_tpu_torch.runtime.trace import bump_hop

                        relay = _replace(
                            cv, trace_meta=bump_hop(cv.trace_meta)
                        )
                    else:
                        relay = cv
                    agent.tx_bcast.try_send(
                        BroadcastInput(change=relay, is_local=False)
                    )
                buf.append((cv, source, keys, time.monotonic()))
                if len(buf) > perf.processing_queue_len:
                    _, _, old_keys, _ = buf.pop(0)  # drop oldest
                    unsee(old_keys)
                    METRICS.counter("corro.agent.changes.dropped").inc()
                if deadline is None:
                    deadline = (
                        time.monotonic() + perf.apply_queue_timeout_ms / 1000.0
                    )

        METRICS.gauge("corro.agent.changes.in_queue").set(len(buf))
        cost = sum(_cost(cv) for cv, _, _, _ in buf)
        expired = deadline is not None and time.monotonic() >= deadline
        if cost >= perf.apply_queue_len or (expired and buf):
            await flush()
            METRICS.gauge("corro.agent.changes.in_queue").set(0)
            deadline = None
        elif expired:
            deadline = None

    await flush()
    for t in list(jobs):
        try:
            await t
        except Exception:
            pass


def _is_empty(cv: ChangeV1) -> bool:
    cs = cv.changeset
    return isinstance(cs, (ChangesetEmpty, ChangesetEmptySet)) or (
        isinstance(cs, ChangesetFull) and not cs.changes
    )


def _cost(cv: ChangeV1) -> int:
    cs = cv.changeset
    return max(1, len(cs.changes)) if isinstance(cs, ChangesetFull) else 1


def process_multiple_changes(
    agent: Agent, batch: List[Tuple[ChangeV1, ChangeSource]]
) -> None:
    """Apply a batch synchronously (runs on a worker thread).

    Per-actor bookie write locks are taken one actor at a time, sorted,
    like the blocking-write lock dance in util.rs:703-790.
    """
    start = time.monotonic()
    by_actor: "OrderedDict[ActorId, List[ChangeV1]]" = OrderedDict()
    for cv, _source in batch:
        by_actor.setdefault(cv.actor_id, []).append(cv)

    all_impactful = []
    for actor_id in sorted(by_actor, key=lambda a: a.bytes16):
        booked = agent.bookie.ensure(actor_id)
        # interruptible: a wedged apply is interrupted at 60 s (the
        # reference's InterruptibleTransaction timeout on write txs,
        # sqlite_pool/mod.rs) — the OperationalError propagates, the
        # caller repairs the seen cache, and the changes re-deliver
        with agent.store.interrupt_after(60.0), booked.write(
            "process_multiple_changes"
        ) as bv:
            snap = bv.snapshot()
            observed = RangeSet()
            to_apply_later: List[int] = []
            for cv in by_actor[actor_id]:
                impactful = _process_one(
                    agent, actor_id, cv, bv, snap, observed, to_apply_later
                )
                all_impactful.extend(impactful)
            snap.insert_db(agent.store.gap_store(), observed)
            bv.commit_snapshot(snap)
        for version in to_apply_later:
            changes = process_fully_buffered(agent, actor_id, version)
            all_impactful.extend(changes)

    # r11 latency plane: commit→apply per stamped change (the origin
    # wall stamp rode the broadcast/sync envelope here).  Cross-node
    # wall-clock delta: e2e_observe clamps skew-negative values.  The
    # OLDEST origin travels on to the hooks so apply→event and the
    # end-to-end total attribute against the batch's worst element.
    # r19: each traced change also records an `ingest.apply` stage span
    # (origin commit → local apply committed) continuing the origin's
    # trace, and the oldest element's trace context rides the stamp to
    # the match/deliver stages.
    from corrosion_tpu_torch.runtime.latency import e2e_observe
    from corrosion_tpu_torch.runtime.trace import meta_forced, meta_hop, stage_span

    origin_min: Optional[float] = None
    oldest_tp: Optional[str] = None
    oldest_meta: Optional[int] = None
    now_wall = time.time()
    actor_str = str(agent.actor_id)
    for cv, source in batch:
        if cv.origin_ts is None:
            continue
        delta = e2e_observe(
            "apply", now_wall - cv.origin_ts, source=source.value
        )
        if cv.traceparent is not None:
            cs = cv.changeset
            stage_span(
                cv.traceparent, "ingest.apply", "apply", delta,
                forced=meta_forced(cv.trace_meta),
                actor=actor_str, source=source.value,
                hop=meta_hop(cv.trace_meta),
                table=(
                    cs.changes[0].table
                    if isinstance(cs, ChangesetFull) and cs.changes
                    else ""
                ),
            )
        if origin_min is None or cv.origin_ts < origin_min:
            origin_min = cv.origin_ts
            oldest_tp = cv.traceparent
            oldest_meta = cv.trace_meta

    if all_impactful:
        agent.notify_change_hooks(
            all_impactful, origin_min,
            traceparent=oldest_tp, trace_meta=oldest_meta,
        )
    METRICS.histogram("corro.agent.changes.processing.time.seconds").observe(
        time.monotonic() - start
    )


def _process_one(agent, actor_id, cv, bv, snap, observed, to_apply_later) -> list:
    cs = cv.changeset
    store = agent.store

    if isinstance(cs, ChangesetEmptySet):
        for s, e in cs.versions:
            observed.insert(s, e)
        METRICS.counter("corro.agent.changes.empty.applied").inc()
        return []
    if isinstance(cs, ChangesetEmpty):
        observed.insert(*cs.versions)
        return []

    assert isinstance(cs, ChangesetFull)
    if bv.contains(cs.version, cs.seqs):
        return []

    if cs.is_complete():
        applied = store.apply_changes(cs.changes)
        store.record_last_seq(actor_id, cs.version, cs.last_seq)
        observed.insert(cs.version, cs.version)
        METRICS.counter("corro.agent.changes.complete.applied").inc()
        return applied.impactful

    # incomplete: buffer + seq bookkeeping (util.rs:1070-1203)
    store.buffer_partial_changes(
        actor_id, cs.version, cs.changes, cs.seqs, cs.last_seq, cs.ts
    )
    partial = bv.insert_partial(
        cs.version,
        PartialVersion(
            seqs=RangeSet([cs.seqs]), last_seq=cs.last_seq, ts=cs.ts
        ),
    )
    # the batch snapshot predates this insert and commit_snapshot
    # REPLACES bv.partials with the snapshot's dict, so a partial first
    # seen in this batch must be mirrored into the snapshot or it is
    # silently wiped at commit — after which later chunks dedupe as
    # "already present" and generate_sync reports nothing to repair:
    # the version is lost until a full re-sync (r5 chaos-soak find)
    snap.partials[cs.version] = partial
    # partial versions are observed (KnownDbVersion::Partial) — the gap
    # algebra must not re-mark them needed when later versions land
    observed.insert(cs.version, cs.version)
    METRICS.counter("corro.agent.changes.incomplete.buffered").inc()
    if partial.is_complete():
        to_apply_later.append(cs.version)
    return []


def process_fully_buffered(agent: Agent, actor_id: ActorId, version: int):
    """Drain a completed buffered version into the store (util.rs:552-700)."""
    from corrosion_tpu_torch.runtime import invariants

    store = agent.store
    changes = store.take_buffered_version(actor_id, version)
    if changes:
        if invariants.enabled():
            # seqs of a fully-buffered version must be gap-free before
            # the drain (ref assert_always "contiguous seq ranges",
            # util.rs:1170) — the sort is the expensive part, so only
            # the CHECK sits behind the mode gate
            seqs = sorted(c.seq for c in changes)
            invariants.assert_always(
                all(b - a <= 1 for a, b in zip(seqs, seqs[1:])),
                "buffered.seqs_contiguous",
                {"actor": str(actor_id), "version": version},
            )
        # the coverage marker is cheap and must record in every mode —
        # the soak's sometimes-contract depends on it
        invariants.assert_sometimes("buffered version drained")
    impactful = []
    if changes:
        applied = store.apply_changes(changes)
        impactful = applied.impactful
        store.record_last_seq(actor_id, version, changes[-1].seq)
    store.clear_buffered_version(actor_id, version)
    booked = agent.bookie.ensure(actor_id)
    with booked.write("process_fully_buffered") as bv:
        bv.partials.pop(version, None)
        snap = bv.snapshot()
        snap.partials.pop(version, None)
        snap.insert_db(agent.store.gap_store(), RangeSet([(version, version)]))
        bv.commit_snapshot(snap)
    METRICS.counter("corro.agent.changes.buffered.applied").inc()
    return impactful


async def apply_fully_buffered_loop(agent: Agent) -> None:
    """Consume tx_apply requests (actor, version) — scheduled when seq
    gaps close or at startup warm-up (run_root.rs:136-197)."""
    while not agent.tripwire.tripped:
        try:
            item = await agent.rx_apply.recv()
        except ChannelClosed:
            break
        actor_id, version = item
        async with agent.write_gate.normal():
            changes = await asyncio.to_thread(
                process_fully_buffered, agent, actor_id, version
            )
        if changes:
            agent.notify_change_hooks(changes)
