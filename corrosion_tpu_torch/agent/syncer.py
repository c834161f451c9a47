"""Anti-entropy sync sessions over bi-streams.

The port's copy of `corrosion_tpu/agent/syncer.py`.

Counterparts:
  - client `parallel_sync` (`klukai-agent/src/api/peer/mod.rs:1082-1482`):
    open a bi-stream to N chosen peers concurrently, exchange
    SyncStart + Clock for State + Clock, derive requests with
    `compute_available_needs`, dedupe ranges across peers, stream
    received changesets into the ingestion pipeline.
  - server `serve_sync` (`peer/mod.rs:1485-1728`): reject foreign
    clusters and >3 concurrent sessions, send own State + Clock, then
    serve each request batch from the store (`handle_need`,
    `peer/mod.rs:450-984`) — live versions stream as ≤8 KiB Full chunks,
    overwritten versions collapse into `ChangesetEmptySet`, partially
    buffered versions serve their buffered seq ranges.
  - scheduler (`agent/handlers.rs:796-897`): every 1–15 s pick
    `clamp(members/100, min, max)` peers by (need, last-sync, RTT ring).

The wire protocol frames `SyncMessage`s with the u32-BE length prefix; a
side that has nothing more to say half-closes, and a session ends when
both sides have seen EOF — the same stop condition as the reference's
peer-stopped-stream bookkeeping.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.agent.handle import Agent, ChangeSource
from corrosion_tpu_torch.net.transport import BiStream, TransportError
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.trace import continue_from, span
from corrosion_tpu_torch.sync import (
    chunk_range,
    compute_available_needs,
    generate_sync,
    state_need_len,
)
from corrosion_tpu_torch.types.actor import Actor, ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import (
    ChangeV1,
    ChangesetEmptySet,
    ChangesetFull,
    chunk_changes,
)
from corrosion_tpu_torch.types.codec import (
    NeedEmpty,
    NeedFull,
    NeedPartial,
    SyncRejection,
    SyncState,
    SyncTraceContext,
    decode_sync_msg,
    encode_bi_payload_sync_start,
    encode_sync_msg,
)
from corrosion_tpu_torch.types.rangeset import RangeSet

MAX_NEEDS_PER_TURN = 10  # peer/mod.rs: round-robin ≤10 needs/peer/turn
VERSIONS_PER_CHUNK = 10  # chunk Full ranges to ≤10 versions
RECV_TIMEOUT = 10.0

# r11 latency plane: sync-served changesets carry an origin wall stamp
# (envelope ext) only when the change is FRESH — live catch-up during
# write traffic, the case the e2e `apply{source="sync"}` histogram is
# meant to measure.  Cold bulk catch-up of hours-old versions is gated
# out so it cannot masquerade as write→event latency.
E2E_SYNC_FRESH_S = 60.0


def _sync_origin(ts) -> "float | None":
    if ts is None or ts.is_zero():
        return None
    wall = ts.to_unix()
    return wall if 0 <= time.time() - wall < E2E_SYNC_FRESH_S else None

# adaptive chunk sizing (peer/mod.rs:444-447, 808-869)
CHUNK_TARGET_MAX = 8 * 1024  # grow back up to the 8 KiB target
CHUNK_TARGET_FLOOR = 1024  # never below 1 KiB
ADAPT_SLOW_SEND_S = 0.5  # halve when one send takes > 500 ms
ADAPT_GROW = 1.5
SEND_TIMEOUT = 30.0  # stalled-peer cutoff: frees snapshot conn + permit
# r18 timeout discipline: EVERY network await in this module carries a
# deadline (the zombie-node scenario's bug class — a peer whose kernel
# accepts bytes while its event loop never answers must cost a counted
# timeout, never a stalled round; enforced repo-wide by the
# timeout-discipline corro-analyze rule)
OPEN_TIMEOUT = 10.0  # dial cutoff for open_bi


class AdaptiveChunkSize:
    """Per-session chunk-size controller: a send that takes longer than
    500 ms halves the byte target (slow peer / congested path), a fast
    send grows it ×1.5 back toward 8 KiB, floored at 1 KiB — the
    reference's policy at `peer/mod.rs:808-869`."""

    def __init__(self):
        self.target = CHUNK_TARGET_MAX

    def observe(self, send_seconds: float) -> None:
        if send_seconds > ADAPT_SLOW_SEND_S:
            self.target = max(CHUNK_TARGET_FLOOR, self.target // 2)
        else:
            self.target = min(
                CHUNK_TARGET_MAX, int(self.target * ADAPT_GROW)
            )
        METRICS.gauge("corro.sync.server.chunk_target_bytes").set(self.target)

    async def timed_send(self, stream, frame: bytes) -> None:
        """Send with the session's send timeout: a peer that stops
        reading must not pin the server's snapshot read connection (an
        open reader blocks WAL truncation) nor hold a serve permit
        forever — the timeout tears the session down instead."""
        t0 = time.monotonic()
        await asyncio.wait_for(stream.send(frame), SEND_TIMEOUT)
        self.observe(time.monotonic() - t0)


# -- server ----------------------------------------------------------------


async def serve_sync(agent: Agent, stream: BiStream) -> None:
    """Handle one inbound bi-stream: a SyncStart session, or (r17) a
    SnapshotReq from a cold node bootstrapping (agent/catchup.py).  The
    dispatch is the version gate: a pre-r17 build raises ValueError on
    the snapshot variant and lands in the counted-failure close below,
    which the requester reads as EOF → pure-delta fallback."""
    from corrosion_tpu_torch.types.codec import decode_bi_payload_any

    try:
        first = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
        if first is None:
            return
        kind, payload = decode_bi_payload_any(first)
        if kind == "snapshot":
            from corrosion_tpu_torch.agent.catchup import serve_snapshot

            await serve_snapshot(agent, stream, payload)
            return
        peer_actor_id, trace, cluster_id = payload
        if cluster_id != agent.cluster_id:
            await asyncio.wait_for(
                stream.send(encode_sync_msg(SyncRejection(reason=1))),
                SEND_TIMEOUT,
            )
            await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
            return
        if agent.sync_serve_sem.locked():
            await asyncio.wait_for(
                stream.send(encode_sync_msg(SyncRejection(reason=2))),
                SEND_TIMEOUT,
            )
            await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
            return
        async with agent.sync_serve_sem:
            # adopt the client's W3C trace context from the wire
            # (peer/mod.rs:1494-1496)
            with continue_from(
                trace.traceparent, "sync.server", peer=str(peer_actor_id)
            ):
                await _serve_sync_inner(agent, stream, peer_actor_id)
    except (asyncio.TimeoutError, TransportError, ValueError):
        METRICS.counter("corro.sync.server.failed").inc()
    finally:
        stream.close()


async def _serve_sync_inner(
    agent: Agent, stream: BiStream, peer_actor_id: ActorId
) -> None:
    METRICS.counter("corro.sync.server.started").inc()
    state = generate_sync(agent.bookie, agent.actor_id)
    await asyncio.wait_for(
        stream.send(encode_sync_msg(agent.clock.new_timestamp())),
        SEND_TIMEOUT,
    )
    await asyncio.wait_for(stream.send(encode_sync_msg(state)), SEND_TIMEOUT)

    sent = 0
    chunker = AdaptiveChunkSize()  # per-session adaptation state
    while True:
        frame = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
        if frame is None:
            break
        msg = decode_sync_msg(frame)
        if isinstance(msg, Timestamp):
            agent.clock.update_with_timestamp(msg)
            continue
        if not isinstance(msg, list):
            continue  # unexpected; ignore like unknown requests
        for actor_id, needs in msg:
            for need in needs:
                sent += await _handle_need(
                    agent, stream, actor_id, need, chunker
                )
    await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
    METRICS.counter("corro.sync.server.changes.sent").inc(sent)


async def _handle_need(
    agent: Agent, stream: BiStream, actor_id: ActorId, need,
    chunker: "AdaptiveChunkSize" = None,
) -> int:
    """Serve one need from the store; returns changes sent
    (peer/mod.rs:450-806)."""
    store = agent.store
    sent = 0
    chunker = chunker or AdaptiveChunkSize()
    if isinstance(need, NeedFull):
        start, end = need.versions
        served = RangeSet()
        loop = asyncio.get_running_loop()

        # Stream ONE version at a time off the executor instead of
        # materializing the whole range: a large sync holds a single
        # version's changes in memory (changes_for_versions itself reads
        # per-version, db_version DESC — peer/mod.rs:620-700)
        def open_conn():
            # snapshot-isolated pooled read conn: never observe a writer
            # thread's in-flight BEGIN IMMEDIATE on the write connection
            return store.acquire_read()

        conn = await loop.run_in_executor(None, open_conn)
        ok = False
        try:
            gen = store.changes_for_versions(actor_id, start, end, conn=conn)

            def next_version():
                try:
                    version, changes = next(gen)
                except StopIteration:
                    return None
                return (
                    version,
                    changes,
                    store.last_seq_for_version(actor_id, version, conn=conn),
                )

            while True:
                item = await loop.run_in_executor(None, next_version)
                if item is None:
                    break
                version, changes, last_seq = item
                served.insert(version, version)
                if last_seq is None:
                    last_seq = changes[-1].seq if changes else 0
                for chunk, seqs in chunk_changes(
                    changes, last_seq, max_bytes_fn=lambda: chunker.target
                ):
                    ts = chunk[-1].ts if chunk else Timestamp(0)
                    cv = ChangeV1(
                        actor_id=actor_id,
                        changeset=ChangesetFull(
                            version=version,
                            changes=tuple(chunk),
                            seqs=seqs,
                            last_seq=last_seq,
                            ts=ts,
                        ),
                        origin_ts=_sync_origin(ts),
                    )
                    await chunker.timed_send(stream, encode_sync_msg(cv))
                    sent += len(chunk)
            ok = True
        finally:
            # a send error abandons the half-consumed generator: its open
            # cursor pins the conn's read snapshot, so discard, not pool
            await loop.run_in_executor(None, store.release_read, conn, not ok)
        # versions we know (≤ our head for this actor) but have no live
        # rows for were overwritten/cleared → EmptySet (peer/mod.rs:532-566)
        empties = _empty_versions(agent, actor_id, start, end, served)
        if empties:
            cv = ChangeV1(
                actor_id=actor_id,
                changeset=ChangesetEmptySet(
                    versions=tuple(empties), ts=agent.clock.new_timestamp()
                ),
            )
            await chunker.timed_send(stream, encode_sync_msg(cv))
    elif isinstance(need, NeedPartial):
        version = need.version

        def read_partial():
            with store.pooled_read() as conn:
                buffered = store.take_buffered_version(
                    actor_id, version, conn=conn
                )
                true_last = store.buffered_last_seq(
                    actor_id, version, conn=conn
                )
                covered = store.buffered_seq_ranges(
                    actor_id, version, conn=conn
                )
                live = []
                if not buffered:
                    # maybe fully applied since the peer's summary —
                    # serve from live rows
                    for v2, changes in store.changes_for_versions(
                        actor_id, version, version, conn=conn
                    ):
                        live.append(
                            (
                                v2,
                                changes,
                                store.last_seq_for_version(
                                    actor_id, v2, conn=conn
                                ),
                            )
                        )
                return buffered, true_last, covered, live

        (
            buffered,
            true_last,
            covered,
            live,
        ) = await asyncio.get_running_loop().run_in_executor(None, read_partial)
        # only claim seq ranges we actually hold (wanted ∩ covered)
        requested = RangeSet(list(need.seqs))
        wanted = RangeSet()
        for s, e in requested:
            for cs_, ce in covered.overlapping(s, e):
                wanted.insert(max(s, cs_), min(e, ce))
        chosen = [c for c in buffered if wanted.contains(c.seq)]
        if chosen:
            # the version's REAL final seq — never the buffered max, or a
            # half version would be applied as complete by the peer
            last_seq = (
                true_last
                if true_last is not None
                else max(c.seq for c in buffered)
            )
            for chunk, chunk_seqs in _partial_chunks(
                chosen, wanted, max_bytes_fn=lambda: chunker.target
            ):
                ts = chunk[-1].ts if chunk else Timestamp(0)
                cv = ChangeV1(
                    actor_id=actor_id,
                    changeset=ChangesetFull(
                        version=version,
                        changes=tuple(chunk),
                        seqs=chunk_seqs,
                        last_seq=last_seq,
                        ts=ts,
                    ),
                    origin_ts=_sync_origin(ts),
                )
                await chunker.timed_send(stream, encode_sync_msg(cv))
                sent += len(chunk)
        else:
            for version2, changes, last_seq in live:
                if last_seq is None:
                    last_seq = changes[-1].seq if changes else 0
                for chunk, seqs in chunk_changes(
                    changes, last_seq, max_bytes_fn=lambda: chunker.target
                ):
                    ts = chunk[-1].ts if chunk else Timestamp(0)
                    cv = ChangeV1(
                        actor_id=actor_id,
                        changeset=ChangesetFull(
                            version=version2,
                            changes=tuple(chunk),
                            seqs=seqs,
                            last_seq=last_seq,
                            ts=ts,
                        ),
                        origin_ts=_sync_origin(ts),
                    )
                    await chunker.timed_send(stream, encode_sync_msg(cv))
                    sent += len(chunk)
    elif isinstance(need, NeedEmpty):
        pass  # informational
    return sent


def _partial_chunks(changes, wanted: RangeSet, max_bytes_fn=None):
    """Chunk partial-need serves per requested seq range (≤8 KiB each,
    adaptive when `max_bytes_fn` is given) so each emitted `seqs` range
    covers exactly a served sub-range (peer/mod.rs:568-614)."""
    from corrosion_tpu_torch.types.change import MAX_CHANGES_BYTE_SIZE

    if max_bytes_fn is None:
        max_bytes_fn = lambda: MAX_CHANGES_BYTE_SIZE  # noqa: E731

    for rs, re_ in wanted:
        in_range = [c for c in changes if rs <= c.seq <= re_]
        if not in_range:
            continue
        buf, size, start = [], 0, rs
        for c in in_range:
            buf.append(c)
            size += c.estimated_byte_size()
            if size >= max_bytes_fn():
                yield buf, (start, c.seq)
                start = c.seq + 1
                buf, size = [], 0
        if buf:
            yield buf, (start, re_)


def _empty_versions(
    agent: Agent, actor_id: ActorId, start: int, end: int, served: RangeSet
) -> List[Tuple[int, int]]:
    booked = agent.bookie.get(actor_id)
    if booked is None:
        return []
    with booked.read() as bv:
        head = bv.last() or 0
        empties = RangeSet()
        hi = min(end, head)
        if start <= hi:
            empties.insert(start, hi)
        for s, e in served:
            empties.remove(s, e)
        # don't claim versions we ourselves still need or only have partially
        for s, e in bv.needed:
            empties.remove(s, e)
        for v in bv.partials:
            empties.remove(v, v)
        return list(empties)


# -- client ----------------------------------------------------------------


@dataclass
class PeerCircuit:
    """Per-peer circuit state (r17): `circuit_failures` consecutive
    failed sessions open the breaker for `circuit_reset_secs` — the
    peer is skipped by peer choice and the resume waves until it
    half-opens, instead of burning a slot of every round on a node
    that is down or wedged."""

    failures: int = 0
    open_until: float = 0.0

    def allows(self, now: float) -> bool:
        return now >= self.open_until


def _circuit_allows(agent: Agent, actor_id: ActorId, now: float) -> bool:
    c = agent.sync_circuits.get(actor_id)
    return c is None or c.allows(now)


def _record_failure(agent: Agent, actor_id: ActorId) -> None:
    cfg = agent.config.sync
    c = agent.sync_circuits.setdefault(actor_id, PeerCircuit())
    c.failures += 1
    if c.failures >= cfg.circuit_failures:
        c.failures = 0
        # auto mode tracks the sync cadence: the breaker horizon is a
        # handful of rounds whatever the deployment's interval is
        reset = cfg.circuit_reset_secs or (
            4.0 * agent.config.perf.sync_interval_max_secs
        )
        c.open_until = time.monotonic() + reset
        METRICS.counter("corro.sync.circuit.opened.total").inc()


def _record_success(agent: Agent, actor_id: ActorId) -> None:
    c = agent.sync_circuits.get(actor_id)
    if c is not None:
        c.failures = 0
        c.open_until = 0.0


class _Outstanding:
    """One session's claimed-but-not-yet-received ranges.  Shrinks as
    changesets arrive (stream order guarantees a version whose final
    chunk landed arrived whole); whatever remains at session death is
    handed back to the ledger for a sibling to re-claim."""

    __slots__ = ("full", "partials")

    def __init__(self):
        self.full: Dict[ActorId, RangeSet] = {}
        self.partials: Dict[Tuple[ActorId, int], RangeSet] = {}

    def observe(self, cv: ChangeV1) -> None:
        cs = cv.changeset
        if isinstance(cs, ChangesetFull):
            if cs.seqs[1] >= cs.last_seq:  # final chunk of the version
                rs = self.full.get(cv.actor_id)
                if rs is not None:
                    rs.remove(cs.version, cs.version)
                self.partials.pop((cv.actor_id, cs.version), None)
            else:
                prs = self.partials.get((cv.actor_id, cs.version))
                if prs is not None:
                    prs.remove(cs.seqs[0], cs.seqs[1])
        elif isinstance(cs, ChangesetEmptySet):
            rs = self.full.get(cv.actor_id)
            if rs is not None:
                for s, e in cs.versions:
                    rs.remove(s, e)


class _ClaimLedger:
    """Cross-peer dedupe of requested ranges (peer/mod.rs:1274-1351)
    plus the r17 resume half: a failed session RELEASES its unserved
    claims so a surviving peer's next wave re-claims them — a dropout
    mid-stream costs the un-received tail, never a restart."""

    def __init__(self):
        self.full: Dict[ActorId, RangeSet] = {}
        self.partials: Dict[Tuple[ActorId, int], RangeSet] = {}
        self.lock = asyncio.Lock()

    async def claim(
        self, needs: Dict[ActorId, List[object]], out: _Outstanding
    ) -> List[Tuple[ActorId, List[object]]]:
        request: List[Tuple[ActorId, List[object]]] = []
        async with self.lock:
            for actor_id, need_list in needs.items():
                claimed: List[object] = []
                for need in need_list:
                    if isinstance(need, NeedFull):
                        got = self.full.setdefault(actor_id, RangeSet())
                        s, e = need.versions
                        fresh = RangeSet([(s, e)])
                        for gs, ge in got.overlapping(s, e):
                            fresh.remove(gs, ge)
                        for fs, fe in list(fresh):
                            got.insert(fs, fe)
                            out.full.setdefault(
                                actor_id, RangeSet()
                            ).insert(fs, fe)
                            for cs_, ce in chunk_range(
                                fs, fe, VERSIONS_PER_CHUNK
                            ):
                                claimed.append(NeedFull((cs_, ce)))
                    elif isinstance(need, NeedPartial):
                        key = (actor_id, need.version)
                        got = self.partials.setdefault(key, RangeSet())
                        fresh_seqs = []
                        for s, e in need.seqs:
                            seg = RangeSet([(s, e)])
                            for gs, ge in got.overlapping(s, e):
                                seg.remove(gs, ge)
                            for fs, fe in seg:
                                got.insert(fs, fe)
                                out.partials.setdefault(
                                    key, RangeSet()
                                ).insert(fs, fe)
                                fresh_seqs.append((fs, fe))
                        if fresh_seqs:
                            claimed.append(
                                NeedPartial(need.version, tuple(fresh_seqs))
                            )
                if claimed:
                    request.append((actor_id, claimed))
        return request

    async def release(self, out: _Outstanding) -> int:
        """Un-claim a dead session's outstanding ranges; returns the
        version count handed back."""
        released = 0
        async with self.lock:
            for actor_id, rs in out.full.items():
                got = self.full.get(actor_id)
                for s, e in rs:
                    released += e - s + 1
                    if got is not None:
                        got.remove(s, e)
            for key, rs in out.partials.items():
                got = self.partials.get(key)
                if got is None:
                    continue
                for s, e in rs:
                    got.remove(s, e)
                released += 1 if len(list(rs)) else 0
        out.full.clear()
        out.partials.clear()
        return released


async def parallel_sync(
    agent: Agent, peers: List[Actor], ours: Optional[SyncState] = None
) -> int:
    """Sync with several peers concurrently; returns changes received.

    r17 resumable: runs up to `[sync] max_waves` waves inside ONE call —
    a wave's failed sessions release their unserved ranges and the next
    wave (fresh `generate_sync` against the surviving peers, paced by
    `runtime/backoff.py`) re-claims them, so a peer dropping mid-stream
    degrades the transfer instead of restarting it."""
    cfg = agent.config.sync
    if not peers:
        return 0
    ledger = _ClaimLedger()
    from corrosion_tpu_torch.runtime.backoff import Backoff

    pacing = Backoff(
        min_interval=cfg.resume_backoff_min_secs,
        max_interval=cfg.resume_backoff_max_secs,
    ).iter()
    total = 0
    wave = 0
    while peers:
        wave += 1
        if ours is None:
            ours = generate_sync(agent.bookie, agent.actor_id)
        results = await asyncio.gather(
            *(_sync_one_peer(agent, peer, ours, ledger) for peer in peers),
            return_exceptions=True,
        )
        survivors: List[Actor] = []
        released = 0
        for peer, res in zip(peers, results):
            if isinstance(res, BaseException):
                # unexpected (session code failed before its own error
                # envelope): counted, no resume info to salvage
                METRICS.counter("corro.sync.client.failed").inc()
                _record_failure(agent, peer.id)
                continue
            received, ok, freed = res
            total += received
            if not ok:
                METRICS.counter("corro.sync.client.failed").inc()
                _record_failure(agent, peer.id)
                released += freed
                continue
            _record_success(agent, peer.id)
            survivors.append(peer)
            info = agent.members.get(peer.id)
            if info is not None:
                info.last_sync_ts = agent.clock.new_timestamp().ntp64
        if released == 0 or wave >= cfg.max_waves or not survivors:
            break
        METRICS.counter("corro.sync.resume.waves.total").inc()
        METRICS.counter("corro.sync.resume.versions.total").inc(released)
        await asyncio.sleep(next(pacing))
        peers = survivors
        ours = None  # regenerate: the bookie advanced under wave N
    return total


async def fetch_peer_state(
    agent: Agent, peer: Actor, timeout: Optional[float] = None
) -> Optional[SyncState]:
    """One state-only handshake: SyncStart + clock, read the peer's
    summary, half-close without requesting anything.  The cold-boot gap
    probe (`agent/catchup.py`) — cheap enough to run before the first
    digest arrives.

    The deadline resolves at CALL time (r18): a `timeout=RECV_TIMEOUT`
    default froze the module constant at import, so tuned deadlines
    (the chaos replica's tight tiny-shape timeouts) silently did not
    apply here — the zombie-node scenario caught the cold-boot probe
    blocking a sync round for the stale 10 s."""
    import contextlib

    if timeout is None:
        timeout = RECV_TIMEOUT

    try:
        stream = await asyncio.wait_for(
            agent.transport.open_bi(peer.addr), OPEN_TIMEOUT
        )
    except (TransportError, OSError, asyncio.TimeoutError):
        return None
    try:
        await asyncio.wait_for(
            stream.send(
                encode_bi_payload_sync_start(
                    agent.actor_id, cluster_id=agent.cluster_id
                )
            ),
            SEND_TIMEOUT,
        )
        await asyncio.wait_for(
            stream.send(encode_sync_msg(agent.clock.new_timestamp())),
            SEND_TIMEOUT,
        )
        while True:
            frame = await asyncio.wait_for(stream.recv(), timeout)
            if frame is None:
                return None
            msg = decode_sync_msg(frame)
            if isinstance(msg, Timestamp):
                agent.clock.update_with_timestamp(msg)
            elif isinstance(msg, SyncRejection):
                return None
            elif isinstance(msg, SyncState):
                return msg
    except (asyncio.TimeoutError, TransportError, ValueError):
        return None
    finally:
        with contextlib.suppress(Exception):
            await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
        stream.close()


async def _sync_one_peer(
    agent: Agent,
    peer: Actor,
    ours: SyncState,
    ledger: _ClaimLedger,
) -> Tuple[int, bool, int]:
    """One client session.  Returns (changes received, clean, versions
    released back to the ledger on failure) — expected transport/decode
    faults are turned into a resume record here, never raised."""
    out = _Outstanding()
    received = 0
    try:
        stream = await asyncio.wait_for(
            agent.transport.open_bi(peer.addr), OPEN_TIMEOUT
        )
    except (TransportError, OSError, asyncio.TimeoutError):
        return 0, False, 0
    # the whole client session is one span; its W3C context rides the
    # SyncStart frame (peer/mod.rs:1098-1101 inject)
    sp = span("sync.client", peer=peer.addr)
    sp.__enter__()
    try:
        await asyncio.wait_for(
            stream.send(
                encode_bi_payload_sync_start(
                    agent.actor_id,
                    trace=SyncTraceContext(traceparent=sp.ctx.traceparent()),
                    cluster_id=agent.cluster_id,
                )
            ),
            SEND_TIMEOUT,
        )
        await asyncio.wait_for(
            stream.send(encode_sync_msg(agent.clock.new_timestamp())),
            SEND_TIMEOUT,
        )

        theirs: Optional[SyncState] = None
        while theirs is None:
            frame = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
            if frame is None:
                return 0, True, 0
            msg = decode_sync_msg(frame)
            if isinstance(msg, Timestamp):
                agent.clock.update_with_timestamp(msg)
            elif isinstance(msg, SyncRejection):
                METRICS.counter("corro.sync.client.rejected").inc()
                return 0, True, 0
            elif isinstance(msg, SyncState):
                theirs = msg

        needs = compute_available_needs(ours, theirs)
        # claim ranges not already requested from another peer
        request = await ledger.claim(needs, out)

        # round-robin the claimed needs in ≤MAX_NEEDS_PER_TURN batches
        flat: List[Tuple[ActorId, object]] = [
            (aid, n) for aid, ns in request for n in ns
        ]
        for i in range(0, len(flat), MAX_NEEDS_PER_TURN):
            turn = flat[i : i + MAX_NEEDS_PER_TURN]
            grouped: Dict[ActorId, List[object]] = {}
            for aid, n in turn:
                grouped.setdefault(aid, []).append(n)
            await asyncio.wait_for(
                stream.send(encode_sync_msg(list(grouped.items()))),
                SEND_TIMEOUT,
            )
        await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)

        while True:
            frame = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
            if frame is None:
                break
            msg = decode_sync_msg(frame)
            if isinstance(msg, Timestamp):
                agent.clock.update_with_timestamp(msg)
            elif isinstance(msg, ChangeV1):
                # EmptySets from third parties are rejected
                # (peer/mod.rs:1429-1432)
                if (
                    isinstance(msg.changeset, ChangesetEmptySet)
                    and msg.actor_id != peer.id
                ):
                    continue
                await agent.tx_changes.send((msg, ChangeSource.SYNC))
                out.observe(msg)
                cs = msg.changeset
                received += len(getattr(cs, "changes", ()))
        METRICS.counter("corro.sync.client.changes.received").inc(received)
        return received, True, 0
    except (asyncio.TimeoutError, TransportError, ValueError, OSError):
        released = await ledger.release(out)
        METRICS.counter("corro.sync.client.changes.received").inc(received)
        return received, False, released
    finally:
        sp.__exit__(None, None, None)
        stream.close()


# -- scheduler -------------------------------------------------------------


def choose_sync_peers(agent: Agent, rng: random.Random) -> List[Actor]:
    """clamp(members/100, min, max) peers, sampled 2×, sorted by
    (freshest-advertised-heads, oldest-last-sync, lowest RTT ring)
    (handlers.rs:811-866).

    r17: the uniform-random pick was why a repair could take ~n rounds
    in a mostly-can't-serve population (the r12 test_bridge note —
    virtual kernel peers close bi-streams): peers whose observatory
    digest advertises the most held versions (`heads_total`) sort
    first, so the node most likely to HAVE what we need is asked first.
    With no digests known the sort degrades to the old random-sample
    ordering.  Circuit-open peers are DEPRIORITIZED, never excluded:
    in a small cluster every candidate still gets picked (anti-entropy
    must keep probing through a flap — the repair race against the
    broadcast plane is tight), while at scale an open breaker stops
    burning one of the few want-slots on a dead node."""
    perf = agent.config.perf
    now = time.monotonic()
    candidates = [
        info
        for aid, info in agent.members.states.items()
        if aid != agent.actor_id
    ]
    if not candidates:
        return []
    want = max(
        perf.sync_peers_min,
        min(perf.sync_peers_max, len(candidates) // 100),
    )
    sample = rng.sample(candidates, min(len(candidates), want * 2))
    heads: Dict[bytes, int] = {}
    if agent.observatory is not None:
        heads = agent.observatory.advertised_heads()
    if heads:
        sample.sort(
            key=lambda info: (
                0 if _circuit_allows(agent, info.actor.id, now) else 1,
                -heads.get(info.actor.id.bytes16, -1),
                info.last_sync_ts or 0,
                info.ring if info.ring is not None else 99,
            )
        )
    else:
        sample.sort(
            key=lambda info: (
                0 if _circuit_allows(agent, info.actor.id, now) else 1,
                info.last_sync_ts or 0,
                info.ring if info.ring is not None else 99,
            )
        )
    chosen = sample[:want]
    for info in sample[want:]:
        if not _circuit_allows(agent, info.actor.id, now):
            METRICS.counter("corro.sync.circuit.skipped.total").inc()
    return [info.actor for info in chosen]


async def targeted_sync(
    agent: Agent, timeout: float = 30.0,
    rng: Optional[random.Random] = None,
) -> int:
    """One immediate anti-entropy round OUTSIDE the sync_loop cadence —
    the r22 view-divergence actuator (agent/remediation.py).  The
    steady loop backs off toward `sync_interval_max_secs` exactly when
    nothing has been arriving — i.e. exactly when a divergence episode
    opens — so a firing alert would otherwise wait out the whole
    backoff before the next repair attempt.  Same peer choice (digest-
    freshest first, circuits deprioritized) and the same resumable
    `parallel_sync`; bounded by `timeout` so a wedged round degrades to
    a counted zero instead of pinning the supervisor.  Returns changes
    received."""
    peers = choose_sync_peers(agent, rng or random.Random())
    if not peers:
        return 0
    try:
        received = await asyncio.wait_for(
            parallel_sync(agent, peers), timeout
        )
    except asyncio.TimeoutError:
        received = 0
    METRICS.counter("corro.sync.targeted.rounds.total").inc()
    return received


async def sync_loop(agent: Agent, rng: Optional[random.Random] = None) -> None:
    """Periodic anti-entropy with exponential backoff 1–15 s
    (agent/util.rs:359-405)."""
    perf = agent.config.perf
    rng = rng or random.Random()
    interval = perf.sync_interval_min_secs
    while not agent.tripwire.tripped:
        await asyncio.sleep(interval)
        if agent.tripwire.tripped:
            break
        peers = choose_sync_peers(agent, rng)
        if not peers:
            interval = min(interval * 2, perf.sync_interval_max_secs)
            continue
        # r17 cold-gap check: a node far enough behind bootstraps from a
        # peer snapshot FIRST, then the same round's delta sync tops up
        # from the watermark (agent/catchup.py; never raises)
        from corrosion_tpu_torch.agent.catchup import maybe_snapshot_bootstrap

        installed = await maybe_snapshot_bootstrap(agent, peers)
        start = time.monotonic()
        try:
            if installed and agent.catchup_census.get("traceparent"):
                # r19: the watermark top-up continues the bootstrap's
                # root trace — snapshot fetch + serve + install + delta
                # top-up read as ONE trace on the collector
                with continue_from(
                    agent.catchup_census["traceparent"], "catchup.topup"
                ):
                    received = await asyncio.wait_for(
                        parallel_sync(agent, peers), 300
                    )
            else:
                received = await asyncio.wait_for(
                    parallel_sync(agent, peers), 300
                )
        except asyncio.TimeoutError:
            received = 0
        elapsed = max(time.monotonic() - start, 1e-9)
        if received:
            from corrosion_tpu_torch.runtime.invariants import assert_sometimes

            # ref assert_sometimes "Corrosion syncs with other nodes"
            # (handlers.rs:840)
            assert_sometimes("syncs with other nodes")
        METRICS.counter("corro.sync.client.rounds").inc()
        METRICS.histogram("corro.sync.client.round.seconds").observe(elapsed)
        METRICS.histogram("corro.sync.client.changes_per_sec").observe(
            received / elapsed
        )
        if received:
            interval = perf.sync_interval_min_secs
        else:
            interval = min(interval * 2, perf.sync_interval_max_secs)
