"""Epidemic broadcast dissemination loop.

The port's copy of `corrosion_tpu/agent/broadcast.py`.

Counterpart of `klukai-agent/src/broadcast/mod.rs:410-812`: batches
`AddBroadcast` (fresh local changes) and `Rebroadcast` inputs on a 500 ms
/ 64 KiB cadence; ring-0 members (median RTT < 6 ms) receive local
changes first, everyone else is reached by random infection-style fanout
`max(num_indirect_probes, (members - ring0)/(max_transmissions*10))`;
items re-queue with a linearly growing delay until `max_transmissions`;
a global 10 MiB/s token bucket rate-limits egress and halves the fanout
while saturated; the most-sent items are dropped once the pending queue
exceeds `processing_queue_len`.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from corrosion_tpu_torch.agent.handle import Agent, BroadcastInput
from corrosion_tpu_torch.net.transport import TransportError
from corrosion_tpu_torch.runtime.channels import ChannelClosed
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.actor import Actor
from corrosion_tpu_torch.types.change import ChangesetFull
from corrosion_tpu_torch.types.codec import (
    chunked_change_v1,
    encode_uni_from_prefix,
    encode_uni_prefix,
)

# r18 timeout discipline: bound on one uni-stream dispatch (dial + write
# of a ≤64 KiB payload) — generous for a healthy peer, finite for a
# zombie whose kernel accepts while its event loop never drains
SEND_TIMEOUT = 30.0


class TokenBucket:
    """10 MiB/s egress limiter (governor at broadcast/mod.rs:460-463)."""

    def __init__(self, rate_bytes_per_s: float, burst: Optional[float] = None):
        self.rate = rate_bytes_per_s
        self.capacity = burst or rate_bytes_per_s
        self.tokens = self.capacity
        self.last = time.monotonic()

    def try_take(self, n: int) -> bool:
        now = time.monotonic()
        self.tokens = min(self.capacity, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


@dataclass(order=True)
class _Pending:
    due: float
    seq: int  # tiebreaker
    # encode-once (r14): `payload` is the digest-free bytes, shared by
    # every re-transmission; `prefix` (header + body + cluster id) is
    # what a per-transmission digest ext gets appended to — the
    # changeset body itself is never re-encoded after commit/decode
    payload: bytes = field(compare=False)
    prefix: bytes = field(compare=False)
    origin: bytes = field(compare=False)  # actor id bytes to exclude
    send_count: int = field(compare=False, default=0)
    # origin commit wall clock (r11 latency plane): stamps the
    # commit→wire hop when the FIRST transmission happens
    origin_wall: Optional[float] = field(compare=False, default=None)
    # envelope-ext stamps re-written per transmission with the digest
    ext_origin_ts: Optional[float] = field(compare=False, default=None)
    ext_traceparent: Optional[str] = field(compare=False, default=None)
    ext_trace_meta: Optional[int] = field(compare=False, default=None)


async def broadcast_loop(agent: Agent) -> None:
    perf = agent.config.perf
    bucket = TokenBucket(perf.broadcast_rate_limit_bytes)
    pending: List[_Pending] = []  # heap by due time
    seq = 0
    interval = perf.broadcast_interval_ms / 1000.0

    while not agent.tripwire.tripped:
        # gather inputs for up to one interval or until the byte cutoff
        batch: List[BroadcastInput] = []
        batch_bytes = 0
        deadline = time.monotonic() + interval
        while batch_bytes < perf.broadcast_cutoff_bytes:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = await asyncio.wait_for(agent.rx_bcast.recv(), timeout)
            except asyncio.TimeoutError:
                break
            except ChannelClosed:
                return
            batch.append(item)
            # r21: a local commit (or decoded relay) arrives with its
            # chunk body already stamped — the cutoff accounting reads
            # ONE cached length instead of re-walking every change's
            # field sizes; only a body-less changeset (hand-built in
            # tests) still pays the per-change estimate
            wb = item.change.wire_body
            if wb is not None:
                batch_bytes += len(wb)
            else:
                cs = item.change.changeset
                batch_bytes += sum(
                    c.estimated_byte_size()
                    for c in getattr(cs, "changes", ())
                )

        now = time.monotonic()
        for item in batch:
            # r16 broadcast chunking: an oversize changeset (one that
            # could never pass the token bucket and was previously
            # DROPPED whole) is split into bucket-sized partials whose
            # bodies splice the cached wire_cell bytes — receivers
            # buffer the seq sub-ranges and apply when they close; the
            # common small payload takes the unchanged single-frame path
            for cv in _fit_to_bucket(item.change, bucket.capacity):
                # encode-once: the body bytes were stamped at commit
                # (local), captured at decode (relay), or spliced by the
                # chunker — this wraps, never re-walks
                prefix = encode_uni_prefix(cv, agent.cluster_id)
                seq += 1
                heapq.heappush(
                    pending,
                    _Pending(
                        due=now,
                        seq=seq,
                        payload=encode_uni_from_prefix(
                            prefix, cv.origin_ts, cv.traceparent,
                            trace_meta=cv.trace_meta,
                        ),
                        prefix=prefix,
                        origin=cv.actor_id.bytes16,
                        send_count=0,
                        # only the ORIGIN node's own fresh changes stamp
                        # the commit→wire hop; relayed changes already
                        # counted theirs at their origin
                        origin_wall=(
                            cv.origin_ts if item.is_local else None
                        ),
                        ext_origin_ts=cv.origin_ts,
                        ext_traceparent=cv.traceparent,
                        ext_trace_meta=cv.trace_meta,
                    ),
                )

        # transmit everything due
        max_tx = agent.membership.config.max_transmissions(
            max(1, len(agent.members) + 1)
        )
        requeue: List[_Pending] = []
        while pending and pending[0].due <= now:
            p = heapq.heappop(pending)
            limited = await _transmit(agent, bucket, p)
            p.send_count += 1
            if p.send_count < max_tx:
                # decaying resend: 100–500 ms × count (mod.rs:759-775)
                delay = min(0.5, 0.1 * p.send_count) * p.send_count
                p.due = now + max(0.1, delay)
                requeue.append(p)
            if limited:
                METRICS.counter("corro.broadcast.rate_limited").inc()
        for p in requeue:
            heapq.heappush(pending, p)
        METRICS.gauge("corro.broadcast.pending.count").set(len(pending))
        METRICS.gauge("corro.broadcast.limiter.remaining_burst").set(
            bucket.tokens
        )

        # overflow: drop the most-sent items first (mod.rs:793-812)
        if len(pending) > perf.max_inflight_broadcasts:
            pending.sort(key=lambda p: p.send_count)
            dropped = len(pending) - perf.max_inflight_broadcasts
            del pending[perf.max_inflight_broadcasts :]
            heapq.heapify(pending)
            METRICS.counter("corro.broadcast.dropped").inc(dropped)


def _fit_to_bucket(cv, capacity: float):
    """Split a ChangeV1 whose body can never pass the egress token
    bucket into partial-changeset chunks (spliced from cached cell
    bytes, types/codec.py `chunked_change_v1`).  Anything that fits —
    or is irreducible (not a multi-change full set) — passes through
    unchanged and keeps the byte-identical r14 path."""
    cs = cv.changeset
    body_len = (
        len(cv.wire_body)
        if cv.wire_body is not None
        else sum(
            c.estimated_byte_size() for c in getattr(cs, "changes", ())
        )
    )
    # ~14 bytes of uni header/cluster-id plus the envelope ext ride on
    # top of the body; half-capacity chunks leave slack for both and
    # for the estimator's undershoot
    if body_len + 64 <= capacity or not isinstance(cs, ChangesetFull):
        return (cv,)
    if len(cs.changes) < 2:
        return (cv,)  # irreducible: the oversized-drop counter handles it
    chunks = chunked_change_v1(
        cv.actor_id, cs.version, cs.changes, cs.last_seq, cs.ts,
        origin_ts=cv.origin_ts, traceparent=cv.traceparent,
        max_bytes=max(1, int(capacity) // 2), seq_range=cs.seqs,
        trace_meta=cv.trace_meta,
    )
    METRICS.counter("corro.broadcast.chunked.total").inc(len(chunks))
    return chunks


async def _transmit(agent: Agent, bucket: TokenBucket, p: _Pending) -> bool:
    """Send one payload to its chosen targets; True if rate-limited."""
    exclude = {agent.actor_id}
    members = agent.members
    cfg = agent.membership.config
    limited = False
    # r12/r14: offer the envelope ext to the observatory PER
    # TRANSMISSION — a digest (own or relayed) piggybacks the broadcast
    # plane the same way it rides gossip datagrams, appended to the
    # shared prefix so the changeset body is never re-encoded; uni
    # frames have no packet budget, so any digest size fits
    digest = (
        agent.observatory.pick_ext(1 << 20, plane="broadcast")
        if agent.observatory is not None
        else None
    )
    payload = (
        p.payload
        if digest is None
        else encode_uni_from_prefix(
            p.prefix, p.ext_origin_ts, p.ext_traceparent, digest,
            p.ext_trace_meta,
        )
    )
    if len(payload) > bucket.capacity:
        # can never pass the bucket: drop instead of spinning forever
        METRICS.counter("corro.broadcast.oversized.dropped").inc()
        return False

    targets: List[Actor] = []
    if p.send_count == 0 and p.origin_wall is not None:
        # commit→wire: broadcast batching + queue delay at the origin
        from corrosion_tpu_torch.runtime.latency import e2e_observe

        delta = e2e_observe("broadcast", time.time() - p.origin_wall)
        if p.ext_traceparent is not None:
            # r19: the same hop as a stage span on the write's trace
            from corrosion_tpu_torch.runtime.trace import meta_forced, stage_span

            stage_span(
                p.ext_traceparent, "broadcast.send", "broadcast", delta,
                forced=meta_forced(p.ext_trace_meta),
                actor=str(agent.actor_id),
            )
    if p.send_count == 0:
        # ring0 gets first-transmission priority (mod.rs:591-651)
        targets.extend(
            a for a in members.ring0(exclude) if a.id.bytes16 != p.origin
        )
    others = [
        a
        for a in (members.not_ring0(exclude) if p.send_count == 0 else members.all_actors())
        if a.id.bytes16 != p.origin and a.id not in exclude
    ]
    n_members = len(members)
    fanout = max(
        cfg.num_indirect_probes,
        (n_members - len(targets)) // (cfg.max_transmissions(n_members + 1) * 10),
    )
    agent.membership.rng.shuffle(others)
    targets.extend(others[:fanout])

    i = 0
    while i < len(targets):
        if not bucket.try_take(len(payload)):
            # halve remaining fanout under rate pressure (mod.rs:668-671)
            limited = True
            remaining = targets[i:]
            targets = targets[:i] + remaining[: max(1, len(remaining) // 2)]
            await asyncio.sleep(0.01)  # let the bucket refill a little
            continue
        await _send_one(agent, targets[i], payload)
        i += 1
    return limited


async def _send_one(agent: Agent, actor: Actor, payload: bytes) -> None:
    try:
        # r18 timeout discipline: a peer whose kernel accepts the dial
        # but whose loop is stalled (zombie) must cost a counted failed
        # send, never wedge the broadcast loop behind one uni stream
        await asyncio.wait_for(
            agent.transport.send_uni(actor.addr, payload), SEND_TIMEOUT
        )
        METRICS.counter("corro.broadcast.sent").inc()
        from corrosion_tpu_torch.runtime.invariants import assert_sometimes

        # ref assert_sometimes "changes broadcast" (broadcast.rs:642)
        assert_sometimes("changes broadcast")
    except (TransportError, asyncio.TimeoutError):
        METRICS.counter("corro.broadcast.send.failed").inc()
