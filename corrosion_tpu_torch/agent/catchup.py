"""Cold-node catch-up: snapshot serve + bootstrap over the sync plane
(r17).

A node that falls far behind — a fresh replica, a long partition, a
restore from old state — used to replay its whole gap change-by-change
through delta sync.  This module adds the fast path on both sides of
the peer protocol's new `SnapshotReq` bi-stream op (`types/codec.py`,
version-gated beside SyncStart):

SERVE: the agent keeps ONE cached compressed snapshot beside its
database (`store/snapshot.py::SnapshotCache`, staleness-bounded by
`[sync] snapshot_max_age_secs`) and streams its frames verbatim to any
requester whose cluster and schema sha match — a burst of cold nodes
amortizes a single VACUUM+compress.  Serves hold their own permit pool
(`Agent.snapshot_serve_sem`), separate from the ≤3 sync serves.

BOOTSTRAP: `maybe_snapshot_bootstrap` runs at the top of every sync
round.  The gap heuristic compares versions we hold against the
freshest peer's digest-advertised `heads_total` (observatory store) —
or, on a cold boot before any digest arrives, against one cheap
state-probe handshake.  Past `[sync] snapshot_min_gap_versions`, the
node fetches the snapshot (chunks decompress to a scratch db as frames
arrive; a schema-sha mismatch aborts after the FIRST frame), quiesces
its write path, swaps the database in through the
`store/restore.py` byte-lock path (`CrdtStore.swapped_database`),
re-pins its own site id, rebuilds the bookie from the
installed bookkeeping, and lets the SAME sync round top up the delta
from the snapshot's watermark.  Every refusal is a counted, safe
fallback to pure delta sync — a peer that can't serve (old version,
busy, schema drift) degrades the transfer, never wedges it (Prime CCL
discipline, arXiv:2505.14065).

Local safety: installing a foreign snapshot DROPS local state, so the
bootstrap refuses unless every version this node ORIGINATED is covered
by the snapshot's watermark (own unsynchronized writes are the one
thing a swap cannot get back; remote-origin overhang is re-fetched by
the top-up).  The guard runs TWICE: once at header time (cheap abort
before the bulk transfer) and again under the write-gate priority
permit right before the swap — own writes can commit during the
multi-second transfer, and only the under-permit check is
race-free.  `corro.snapshot.install.refused.total{reason=
"local_ahead"}` is the witness that the guard fired instead of data
being lost.

The port's copy of `corrosion_tpu/agent/catchup.py`. The swap keeps the
store's device: after an install the delta top-up's remote batches are
decided by the same array engine on the same card
(`CrdtStore.swapped_database` reopens the connections only).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import zlib
from typing import List, Optional, Tuple

from corrosion_tpu_torch.agent.handle import Agent
from corrosion_tpu_torch.net.transport import BiStream, TransportError
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.store import snapshot as snap_mod
from corrosion_tpu_torch.store.bookkeeping import BookedVersions
from corrosion_tpu_torch.store.snapshot import (
    REJECT_BUSY,
    REJECT_CLUSTER,
    REJECT_DISABLED,
    REJECT_SCHEMA,
    SnapshotCache,
    SnapshotDone,
    SnapshotHeader,
    bookie_watermark,
    decode_snapshot_msg,
    encode_snapshot_msg_rejection,
    schema_sha,
)
from corrosion_tpu_torch.sync import held_total, state_held_total
from corrosion_tpu_torch.types.actor import Actor
from corrosion_tpu_torch.types.codec import SnapshotReq, encode_bi_payload_snapshot_req
from corrosion_tpu_torch.types.rangeset import RangeSet

log = logging.getLogger(__name__)

RECV_TIMEOUT = 30.0
SEND_TIMEOUT = 30.0
# decompressed bytes buffered in memory before one worker-thread write
_WRITE_BATCH_BYTES = 4 * 1024 * 1024
# digestless gap probes ride the sync schedule at most this often
_PROBE_MIN_INTERVAL_S = 15.0

_REJECT_NAMES = {
    REJECT_CLUSTER: "cluster",
    REJECT_SCHEMA: "schema",
    REJECT_BUSY: "busy",
    REJECT_DISABLED: "disabled",
}


def local_schema_sha(agent: Agent) -> bytes:
    """This agent's schema generation, runtime-owned canary excluded
    (only opted-in nodes host it; it must not fail the install gate)."""
    return schema_sha(
        agent.store.schema, exclude=(agent.config.slo.canary_table,)
    )


def ensure_snapshot_cache(agent: Agent) -> Optional[SnapshotCache]:
    if agent.store._is_memory:
        return None  # no file to VACUUM INTO / swap
    if agent.snapshots is None:
        agent.snapshots = SnapshotCache(agent.store.path)
    return agent.snapshots


# -- serve side ------------------------------------------------------------


async def serve_snapshot(agent: Agent, stream: BiStream, req: SnapshotReq) -> None:
    """Answer one SnapshotReq on an accepted bi-stream (dispatched from
    the sync serve path)."""

    async def reject(reason: int) -> None:
        METRICS.counter(
            "corro.snapshot.serve.rejected.total",
            reason=_REJECT_NAMES.get(reason, str(reason)),
        ).inc()
        await asyncio.wait_for(
            stream.send(encode_snapshot_msg_rejection(reason)), SEND_TIMEOUT
        )
        await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)

    from corrosion_tpu_torch.runtime.trace import continue_from

    # adopt the cold node's bootstrap trace from the wire (r19): the
    # serve — rejection or full stream — is one span of THAT trace
    with continue_from(
        req.traceparent, "catchup.snapshot.serve",
        peer=str(req.actor_id), actor=str(agent.actor_id),
    ):
        await _serve_snapshot_inner(agent, stream, req, reject)


async def _serve_snapshot_inner(
    agent: Agent, stream: BiStream, req: SnapshotReq, reject
) -> None:
    if req.cluster_id != agent.cluster_id:
        await reject(REJECT_CLUSTER)
        return
    cache = ensure_snapshot_cache(agent)
    if not agent.config.sync.snapshot or cache is None:
        await reject(REJECT_DISABLED)
        return
    local_sha = local_schema_sha(agent)
    if req.schema_sha != local_sha:
        await reject(REJECT_SCHEMA)
        return
    if agent.bulk_refuse_until > time.monotonic():
        # r22 remediation refuse-bulk: this node's store is faulting —
        # a multi-second VACUUM+stream against a sick disk is the last
        # thing to add.  BUSY is the right wire answer: the requester
        # already treats it as "try another peer", a typed degradation
        # instead of a doomed transfer
        await reject(REJECT_BUSY)
        return
    if agent.snapshot_serve_sem.locked():
        await reject(REJECT_BUSY)
        return
    async with agent.snapshot_serve_sem:
        cfg = agent.config.sync
        async with agent.snapshot_build_lock:
            # one builder at a time; within the staleness window this is
            # a no-op for every requester after the first
            await asyncio.to_thread(
                cache.ensure_fresh,
                agent.store.schema,
                agent.store.site_id.bytes16,
                agent.bookie,
                cfg.snapshot_max_age_secs,
                cfg.snapshot_chunk_bytes,
            )
        age = cache.age()
        if age is not None:
            METRICS.gauge("corro.snapshot.age.seconds").set(age)
        sent = 0
        loop = asyncio.get_running_loop()
        gen = snap_mod.iter_snapshot_frames(cache.path)

        def next_batch():
            return next(gen, None)

        while True:
            batch = await loop.run_in_executor(None, next_batch)
            if batch is None:
                break
            for payload in batch:
                await asyncio.wait_for(stream.send(payload), SEND_TIMEOUT)
                sent += len(payload)
        await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
        METRICS.counter("corro.snapshot.serve.total").inc()
        METRICS.counter("corro.snapshot.serve.bytes").inc(sent)


# -- bootstrap (client) side -----------------------------------------------


# census keys that survive state transitions: `last_probe_mono` gates
# the digestless state probe and `installed_mono` gates the post-install
# cooldown — a failure record must not reset either clock, or a cold
# node pays a probe dial / re-bootstrap every sync round.  `traceparent`
# (r19) is the bootstrap's root trace context: the same sync round's
# delta top-up continues it so a cold-node bootstrap reads as ONE trace
_CENSUS_STICKY = ("last_probe_mono", "installed_mono", "traceparent")


def _set_census(agent: Agent, **fields) -> None:
    new = {
        k: agent.catchup_census[k]
        for k in _CENSUS_STICKY
        if k in agent.catchup_census
    }
    new.update(fields)
    agent.catchup_census = new


def _write_chunks(f, chunks: List[bytes]) -> int:
    n = 0
    for c in chunks:
        f.write(c)
        n += len(c)
    return n


def _local_covered_by(agent: Agent, header: SnapshotHeader) -> bool:
    """Every version this node ORIGINATED must be inside the snapshot's
    watermark — own unsynchronized writes are the one thing a swap
    cannot get back.  Remote-origin versions past the watermark (e.g.
    live-fire broadcasts applied while the transfer ran) are dropped by
    the swap but re-fetched by the immediate delta top-up: the state
    exchange sees the peer's head past our post-install bookie and
    re-pulls, so they cost a bounded re-transfer, never data."""
    own = agent.actor_id.bytes16
    ours = bookie_watermark(agent.bookie).get(own)
    if not ours:
        return True
    theirs = RangeSet(header.watermark.get(own, []))
    return all(theirs.contains_range(s, e) for s, e in ours)


async def _fetch_snapshot(
    agent: Agent, peer: Actor, tmp_db: str
) -> Optional[SnapshotHeader]:
    """Stream the peer's snapshot into `tmp_db` (decompressed).  None on
    any refusal/failure — callers fall back to delta sync."""
    from corrosion_tpu_torch.runtime.trace import current_traceparent, span

    local_sha = local_schema_sha(agent)
    stream = await asyncio.wait_for(
        agent.transport.open_bi(peer.addr), RECV_TIMEOUT
    )
    f = None
    header: Optional[SnapshotHeader] = None
    done: Optional[SnapshotDone] = None
    pending: List[bytes] = []
    pending_bytes = 0
    received_chunks = 0
    received_raw = 0
    fetched_wire = 0
    # the fetch is one child span of the catchup.bootstrap root; its
    # W3C context rides the SnapshotReq (trailing eof-tolerant field)
    # so the SERVING peer's serve span joins the same trace
    fetch_span = span("catchup.snapshot.fetch", peer=peer.addr)
    fetch_span.__enter__()
    try:
        await asyncio.wait_for(
            stream.send(
                encode_bi_payload_snapshot_req(
                    SnapshotReq(
                        actor_id=agent.actor_id,
                        schema_sha=local_sha,
                        cluster_id=agent.cluster_id,
                        traceparent=current_traceparent(),
                    )
                )
            ),
            SEND_TIMEOUT,
        )
        f = await asyncio.to_thread(open, tmp_db, "wb")
        while True:
            frame_ = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
            if frame_ is None:
                break
            fetched_wire += len(frame_)
            msg = decode_snapshot_msg(frame_)
            if isinstance(msg, SnapshotHeader):
                header = msg
                # abort BEFORE the bulk transfer when uninstallable
                if msg.schema_sha != local_sha:
                    METRICS.counter(
                        "corro.snapshot.install.refused.total",
                        reason="schema",
                    ).inc()
                    return None
                if not _local_covered_by(agent, msg):
                    METRICS.counter(
                        "corro.snapshot.install.refused.total",
                        reason="local_ahead",
                    ).inc()
                    return None
            elif isinstance(msg, bytes):
                raw = zlib.decompress(msg)
                received_chunks += 1
                received_raw += len(raw)
                pending.append(raw)
                pending_bytes += len(raw)
                if pending_bytes >= _WRITE_BATCH_BYTES:
                    batch, pending, pending_bytes = pending, [], 0
                    await asyncio.to_thread(_write_chunks, f, batch)
            elif isinstance(msg, SnapshotDone):
                done = msg
            elif isinstance(msg, int):  # rejection
                METRICS.counter(
                    "corro.snapshot.bootstrap.rejected.total",
                    reason=_REJECT_NAMES.get(msg, str(msg)),
                ).inc()
                return None
        if pending:
            await asyncio.to_thread(_write_chunks, f, pending)
        await asyncio.to_thread(f.close)
        f = None
        if header is None or done is None:
            return None
        if (
            received_chunks != done.n_chunks
            or received_raw != done.raw_bytes
        ):
            log.warning(
                "torn snapshot transfer from %s: %d/%d chunks %d/%d bytes",
                peer.addr, received_chunks, done.n_chunks,
                received_raw, done.raw_bytes,
            )
            return None
        METRICS.counter("corro.snapshot.fetch.bytes").inc(fetched_wire)
        return header
    finally:
        fetch_span.__exit__(None, None, None)
        if f is not None:
            await asyncio.to_thread(f.close)
        stream.close()


async def snapshot_bootstrap(agent: Agent, peer: Actor) -> bool:
    """Fetch + install one peer's snapshot; True when the database was
    swapped and the bookie rebuilt.  False = safe fallback to delta."""
    store = agent.store
    if store._is_memory:
        return False
    t0 = time.monotonic()
    tmp_db = store.path + ".snap-fetch"
    _set_census(agent, state="fetching", peer=peer.addr, started_mono=t0)
    try:
        try:
            header = await _fetch_snapshot(agent, peer, tmp_db)
        except (
            asyncio.TimeoutError, TransportError, ValueError, OSError,
            zlib.error,
        ):
            METRICS.counter("corro.snapshot.bootstrap.failed.total").inc()
            _set_census(agent, state="failed", peer=peer.addr)
            return False
        if header is None:
            METRICS.counter("corro.snapshot.bootstrap.failed.total").inc()
            _set_census(agent, state="failed", peer=peer.addr)
            return False

        # quiesce the write path for the swap: the PRIORITY lane permit
        # blocks local writers, remote applies and buffered drains alike
        async with agent.write_gate.priority():
            # the header-time _local_covered_by check ran BEFORE the
            # multi-second bulk transfer; own-origin writes committed
            # since (or between fetch completion and permit grant) would
            # be silently dropped by the swap, regressing our version
            # head and re-issuing broadcast version numbers with new
            # contents.  The write path is quiesced under this permit,
            # so rechecking here is authoritative.
            if not _local_covered_by(agent, header):
                METRICS.counter(
                    "corro.snapshot.install.refused.total",
                    reason="local_ahead",
                ).inc()
                METRICS.counter("corro.snapshot.bootstrap.failed.total").inc()
                _set_census(
                    agent, state="failed", peer=peer.addr,
                    reason="local_ahead",
                )
                return False

            def install() -> None:
                with store.swapped_database():
                    snap_mod.install_raw_db(
                        tmp_db, store.path,
                        self_site_id=store.site_id.bytes16,
                        builder_site_id=header.site_id,
                    )

            await asyncio.to_thread(install)

            def rebuild():
                return {
                    aid: store.load_booked_versions(aid)
                    for aid in store.booked_actor_ids()
                }

            # exact replacement, never an insert-merge over the old map:
            # a surviving entry for an actor absent from the snapshot
            # (e.g. broadcast changes applied during the transfer window)
            # would claim versions the swap just dropped, and the delta
            # top-up would never re-fetch them
            loaded = await asyncio.to_thread(rebuild)
            loaded.setdefault(agent.actor_id, BookedVersions(agent.actor_id))
            agent.bookie.replace_all(loaded)
            # the ingest seen-cache predates the swap: anything it
            # remembers may have been dropped with the old database
            agent.ingest_epoch += 1

        # buffered versions the SERVER had completed on disk but not yet
        # drained ride the snapshot — schedule their applies like boot
        for actor_id, booked in agent.bookie.items().items():
            with booked.read() as bv:
                complete = [
                    v for v, p in bv.partials.items() if p.is_complete()
                ]
            for version in complete:
                agent.tx_apply.try_send((actor_id, version))

        elapsed = time.monotonic() - t0
        METRICS.counter("corro.snapshot.install.total").inc()
        METRICS.histogram("corro.snapshot.install.seconds").observe(elapsed)
        _set_census(
            agent,
            state="installed",
            peer=peer.addr,
            seconds=round(elapsed, 3),
            raw_bytes=header.raw_bytes,
            watermark_versions=header.watermark_total(),
            installed_mono=time.monotonic(),
            # the batches the store's decision program had decided and
            # declined when the swapped database took over
            array_lane=dict(store.array_lane),
        )
        log.info(
            "snapshot bootstrap from %s: %d watermark versions, %d bytes, "
            "%.2fs — topping up with delta sync",
            peer.addr, header.watermark_total(), header.raw_bytes, elapsed,
        )
        return True
    finally:
        if os.path.exists(tmp_db):
            await asyncio.to_thread(os.unlink, tmp_db)


# -- the gap heuristic -----------------------------------------------------


def _digest_best_peer(
    agent: Agent, peers: List[Actor], held: int
) -> Tuple[Optional[Actor], int, bool]:
    """(freshest peer, its gap over us, any-digest-known).  The third
    element distinguishes "no gap" from "no information" — only the
    latter warrants a state probe."""
    from corrosion_tpu_torch.agent.syncer import _circuit_allows

    obs = agent.observatory
    if obs is None:
        return None, 0, False
    heads = obs.advertised_heads()
    known = any(p.id.bytes16 in heads for p in peers)
    now = time.monotonic()
    best: Tuple[Optional[Actor], int] = (None, 0)
    for peer in peers:
        if not _circuit_allows(agent, peer.id, now):
            continue  # a flapping peer is the wrong bulk-transfer source
        adv = heads.get(peer.id.bytes16)
        if adv is not None and adv - held > best[1]:
            best = (peer, adv - held)
    return best[0], best[1], known


async def maybe_snapshot_bootstrap(agent: Agent, peers: List[Actor]) -> bool:
    """Called at the top of each sync round: decide whether the gap
    warrants the snapshot fast path, and run it.  Never raises — any
    failure is a counted fallback to the round's normal delta sync."""
    cfg = agent.config.sync
    if not cfg.snapshot or not peers or agent.store._is_memory:
        return False
    if agent.bulk_refuse_until > time.monotonic():
        # r22 remediation refuse-bulk: a store-faulting node must not
        # START a bulk transfer either — installing a snapshot through
        # a sick disk fails mid-swap at best; the delta plane keeps the
        # node converging at retail size until the revert clears this
        return False
    # post-install cooldown: one bootstrap per cold start — under live
    # fire the freshly-installed node still trails by however many
    # (small) versions landed during the transfer, and re-installing a
    # barely-newer snapshot would throw that progress away each round;
    # closing the residual gap is the delta plane's job
    installed_mono = agent.catchup_census.get("installed_mono")
    if (
        installed_mono is not None
        and time.monotonic() - installed_mono < cfg.snapshot_cooldown_secs
    ):
        return False
    held = held_total(agent.bookie)
    peer, gap, any_known = _digest_best_peer(agent, peers, held)
    if peer is None and not any_known:
        # no digest from any candidate yet (cold boot window, or
        # observatory off on the peers): one cheap state-probe
        # handshake — rate-limited so a digestless steady-state
        # cluster doesn't pay a probe dial every sync round
        now = time.monotonic()
        last = agent.catchup_census.get("last_probe_mono")
        if last is not None and now - last < _PROBE_MIN_INTERVAL_S:
            return False
        agent.catchup_census["last_probe_mono"] = now
        from corrosion_tpu_torch.agent.syncer import fetch_peer_state

        peer = peers[0]
        theirs = await fetch_peer_state(agent, peer)
        if theirs is None:
            return False
        gap = state_held_total(theirs) - held
    if peer is None or gap < cfg.snapshot_min_gap_versions:
        return False
    from corrosion_tpu_torch.runtime.trace import span

    # r19: the bootstrap's ROOT span — fetch + serve (via the SnapshotReq
    # traceparent) + install hang off it, and the same round's delta
    # top-up continues it from the census so one trace reads end to end
    bootstrap_span = span(
        "catchup.bootstrap", peer=peer.addr, actor=str(agent.actor_id),
        gap=gap,
    )
    bootstrap_span.__enter__()
    agent.catchup_census["traceparent"] = bootstrap_span.ctx.traceparent()
    try:
        return await asyncio.wait_for(
            snapshot_bootstrap(agent, peer), cfg.snapshot_timeout_secs
        )
    except asyncio.TimeoutError:
        METRICS.counter("corro.snapshot.bootstrap.failed.total").inc()
        _set_census(agent, state="failed", peer=peer.addr)
        return False
    except Exception:
        METRICS.counter("corro.snapshot.bootstrap.failed.total").inc()
        _set_census(agent, state="failed", peer=peer.addr)
        log.exception("snapshot bootstrap from %s failed", peer.addr)
        return False
    finally:
        bootstrap_span.__exit__(None, None, None)
