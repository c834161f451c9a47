"""Shared coalescing fan-out writer for live subscription streams.

The port's copy of `corrosion_tpu/pubsub/fanout.py`.

Through r15 every HTTP subscription stream owned a drain loop: one
asyncio task parked on a per-stream queue, woken once per diff batch,
issuing its own socket write — O(streams) queue puts, task switches and
write calls per batch, ~10-20 µs of loop time per stream.  At the
production shape named on the ROADMAP (10k-100k concurrent streams per
node) that is 1-2 s of event-loop stall per batch before a single
payload byte moves.

r16 replaces the drain loops with ONE writer task per `SubsManager`:

- `MatcherHandle._fan_out` submits `(sinks, batch)` once per diff batch
  (O(1) — no per-subscriber queue put);
- the writer task encodes the batch's NDJSON payload ONCE
  (`EventBatch.payload()`, the bytes every subscriber shares) and walks
  the subscriber sinks in a tight loop issuing SYNCHRONOUS,
  non-blocking socket writes (`StreamSink.write_some`), yielding to the
  loop every `_YIELD_EVERY` sinks so heartbeats stay honest;
- a sink whose transport stops accepting bytes (kernel/transport buffer
  above bound, h2 flow-control window closed) is CLOGGED: payloads
  accumulate on its pending deque — batches that pile up there coalesce
  into one write when the socket drains (the writev-style batching) —
  and the writer retries it every `tick_secs`;
- a clogged sink past `max_lag_bytes`/`max_lag_batches` is SHED: its
  pending buffer is dropped, `corro.subs.shed.total` counts it, and the
  parked HTTP handler is woken with a `SubLagging` terminal so the
  stream ends with a typed `{"lagging": ...}` frame the client resumes
  from (Prime CCL, arXiv:2505.14065: a slow consumer must degrade,
  never stall the collective — the DiffExecutor and sibling streams
  never wait on a laggard's socket).

Transport specifics (what "non-blocking write" means per flavor) live
in the `StreamSink` subclasses in `api/pubsub_http.py`; this module is
transport-agnostic.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

from corrosion_tpu_torch.runtime.latency import e2e_observe
from corrosion_tpu_torch.runtime.metrics import METRICS

# yield the event loop to other tasks every N sink visits: a 100k-sink
# walk must not starve heartbeats/timers for its full duration
_YIELD_EVERY = 2048
# cap e2e deliver/total histogram observations per batch: one registry
# hit per sink per batch (~2-5 µs each) would dominate the walk at 100k
# streams; a uniform sample across the walk preserves the percentile
# shape (delivery latency varies with walk position, which the stride
# samples evenly)
_OBSERVE_SAMPLE = 256


@dataclass(frozen=True)
class SubLagging:
    """Terminal frame for a shed laggard: the stream was dropped because
    its socket could not keep up, NOT because the query died.  Carries
    the lag at shed time; `api/types.ev_lagging` is the wire form and
    `client.py` resumes from its last change id on receipt."""

    lag_bytes: int
    lag_batches: int


class SinkClosed(Exception):
    """Raised by `write_some` when the peer is gone (transport closing,
    h2 stream reset): routine detach, not an error."""


class StreamSink:
    """One live subscription stream's write side, driven by the shared
    `FanoutWriter`.  Subclasses implement `writable()` (can the
    transport accept bytes NOW without blocking?) and `write_some(data)
    -> int` (synchronous best-effort write, returns bytes accepted,
    raises SinkClosed when the peer is gone).

    Lifecycle: `attach_sink` while HOLDING (snapshot/replay streams
    through the handler directly), `release(replayed_max)` arms live
    delivery, `done` resolves with the terminal (None = clean stop,
    SubDead = matcher death, SubLagging = shed, SinkClosed = peer gone)
    and the parked handler finishes the response."""

    __slots__ = (
        "max_lag_bytes", "max_lag_batches", "pending", "pending_bytes",
        "replayed_max", "hold", "held", "done", "closed", "_oldest_wall",
        "_oldest_origin", "_oldest_tp", "_oldest_meta", "writer",
    )

    def __init__(self, max_lag_bytes: int, max_lag_batches: int):
        self.max_lag_bytes = max_lag_bytes
        self.max_lag_batches = max_lag_batches
        # (payload, offset) pairs; payload objects are SHARED across
        # sinks — a clogged sink costs bookkeeping, not copies
        self.pending: Deque[Tuple[bytes, int]] = deque()
        self.pending_bytes = 0
        self.replayed_max = 0
        self.hold = True
        self.held: List[object] = []  # EventBatch/terminal while holding
        self.done: asyncio.Future = (
            asyncio.get_event_loop().create_future()
        )
        self.closed = False
        # oldest unobserved latency stamps among pending payloads: one
        # conservative (worst-element) observation per flush — the r19
        # trace context rides with them so the deliver stage span
        # stitches to the same write trace
        self._oldest_wall: Optional[float] = None
        self._oldest_origin: Optional[float] = None
        self._oldest_tp: Optional[str] = None
        self._oldest_meta: Optional[int] = None
        self.writer: Optional["FanoutWriter"] = None

    # -- transport interface (overridden per flavor) -----------------------

    def writable(self) -> bool:  # pragma: no cover — interface
        return True

    def write_some(self, data: bytes) -> int:  # pragma: no cover
        return len(data)

    # -- lifecycle ---------------------------------------------------------

    def release(self, replayed_max: int) -> None:
        """End hold mode after the snapshot/replay phase: filter batches
        the replay already covered, then arm live delivery."""
        self.replayed_max = replayed_max
        self.hold = False
        held, self.held = self.held, []
        for item in held:
            self.offer(item)
        if self.pending and self.writer is not None:
            # anything queued while holding flushes on the writer task
            self.writer.poke(self)

    def _resolve(self, outcome) -> None:
        if not self.done.done():
            self.done.set_result(outcome)

    def mark_closed(self) -> None:
        """Handler-side detach (event-loop only — every sink mutation
        lives on the loop thread): drop pending state, stop delivery."""
        self.closed = True
        self.pending.clear()
        self.pending_bytes = 0
        self._resolve(None)

    def _terminal_pending(self) -> bool:
        return bool(self.pending) and self.pending[0][0] is None

    # -- delivery (writer-task side, loop thread) --------------------------

    def offer(self, item) -> None:
        """Queue one EventBatch (or a terminal sentinel) for this sink.
        Shared-payload fast path: when the batch is entirely past the
        replay boundary the ONE bytes object every subscriber shares is
        referenced, not copied."""
        if self.closed or self.done.done():
            return
        if self.hold:
            self.held.append(item)
            return
        if not isinstance(item, list):
            # terminal sentinel (None clean stop / SubDead): queued as a
            # (None, sentinel) marker so it resolves only after the data
            # already queued ahead of it flushes
            self.pending.append((None, item))
            return
        batch = item
        if not batch:
            return
        if batch[0].change_id > self.replayed_max:
            payload = batch.payload()
        elif batch[-1].change_id <= self.replayed_max:
            return  # replay already covered the whole batch
        else:
            lines = [
                ev.line() for ev in batch
                if ev.change_id > self.replayed_max
            ]
            if not lines:
                return
            payload = ("\n".join(lines) + "\n").encode()
        self.pending.append((payload, 0))
        self.pending_bytes += len(payload)
        ew = getattr(batch, "event_wall", None)
        if ew is not None and self._oldest_wall is None:
            self._oldest_wall = ew
            self._oldest_tp = getattr(batch, "traceparent", None)
            self._oldest_meta = getattr(batch, "trace_meta", None)
        og = getattr(batch, "origin", None)
        if og is not None and self._oldest_origin is None:
            self._oldest_origin = og

    def flush(self, observe: bool = True) -> bool:
        """Write as much pending data as the transport accepts RIGHT
        NOW; returns True when fully drained.  Sheds past lag bounds.

        Runs on the event loop only (the fan-out writer); lock-discipline
        reads `flush` as a worker-thread entry by name, from the OTLP
        exporter's `to_thread(exp.flush)`."""
        if self.closed or self.done.done():
            self.pending.clear()  # corro: noqa[lock-discipline] loop-only
            self.pending_bytes = 0
            return True
        wrote = 0
        shipped = 0
        try:
            while self.pending:
                head, sentinel = self.pending[0]
                if head is None:  # terminal sentinel reached
                    self.pending.popleft()
                    self._resolve(sentinel)
                    self._note_stats(wrote, shipped)
                    return True
                if not self.writable():
                    break
                # coalesce the contiguous run of queued payloads into
                # ONE transport write (the writev-style batching: a sink
                # that fell behind ships every backed-up batch in a
                # single call when its socket drains)
                run: List[bytes] = []
                for p, off in self.pending:
                    if p is None:
                        break
                    run.append(p[off:] if off else p)
                data = run[0] if len(run) == 1 else b"".join(run)
                n = self.write_some(data)
                if n == 0:
                    break
                wrote += 1
                self.pending_bytes -= n  # corro: noqa[lock-discipline] loop-only
                while n:  # consume n bytes off the head entries
                    p, off = self.pending[0]
                    rem = len(p) - off
                    if n >= rem:
                        self.pending.popleft()
                        shipped += 1
                        n -= rem
                    else:
                        self.pending[0] = (p, off + n)
                        n = 0
        except SinkClosed as e:
            self.pending.clear()
            self.pending_bytes = 0
            self._resolve(e)
            return True
        self._note_stats(wrote, shipped)
        if not self.pending:
            if observe and self._oldest_wall is not None:
                now = time.time()
                delta = e2e_observe("deliver", now - self._oldest_wall)
                if self._oldest_origin is not None:
                    e2e_observe("total", now - self._oldest_origin)
                if self._oldest_tp is not None:
                    # r19 deliver stage span, stride-sampled exactly
                    # like the latency observation it shares a gate
                    # with — a 100k-sink walk never pays per-sink spans
                    from corrosion_tpu_torch.runtime.trace import (
                        meta_forced,
                        stage_span,
                    )

                    stage_span(
                        self._oldest_tp, "subs.deliver", "deliver", delta,
                        forced=meta_forced(self._oldest_meta),
                    )
            self._oldest_wall = None
            self._oldest_origin = None
            self._oldest_tp = None
            self._oldest_meta = None
            return True
        # clogged: shed once past the lag bounds
        data_batches = sum(1 for p, _ in self.pending if p is not None)
        if (
            self.pending_bytes > self.max_lag_bytes
            or data_batches > self.max_lag_batches
        ):
            self.shed()
            return True
        return False

    def shed(self) -> bool:
        """Drop this sink NOW with the typed `SubLagging` terminal the
        r16 client resume path already handles.  Two callers: `flush`
        when the lag bounds trip, and the r22 slo-burn remediation
        actuator (agent/remediation.py) shedding the laggard tier
        before clients time out — same typed degradation either way,
        never a stall.  Returns False when the sink already ended."""
        if self.closed or self.done.done():
            return False
        METRICS.counter("corro.subs.shed.total").inc()
        shed = SubLagging(
            self.pending_bytes,
            sum(1 for p, _ in self.pending if p is not None),
        )
        self.pending.clear()
        self.pending_bytes = 0
        self._resolve(shed)
        return True

    def _note_stats(self, wrote: int, shipped: int) -> None:
        w = self.writer
        if w is not None and (wrote or shipped):
            w._stat_writes += wrote
            w._stat_batches += shipped


class FanoutWriter:
    """The per-manager shared writer task.  `submit` is O(1) for the
    fan-out caller; the walk, coalescing, clog retries and shedding all
    happen here, off the diff loop and off the write path."""

    def __init__(self, tick_secs: float = 0.05):
        self.tick_secs = tick_secs
        self._queue: Deque[Tuple[Tuple[StreamSink, ...], object]] = deque()
        self._clogged: "dict[int, StreamSink]" = {}
        self._event = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # flush stats, accumulated by sinks and registry-flushed once
        # per writer round (never one registry hit per sink visit)
        self._stat_writes = 0
        self._stat_batches = 0

    # -- feeding (loop thread) ---------------------------------------------

    def submit(self, sinks: Tuple[StreamSink, ...], item) -> None:
        """One diff batch (or terminal sentinel) for `sinks`."""
        if not sinks:
            return
        self._queue.append((sinks, item))
        self._wake()

    def poke(self, sink: StreamSink) -> None:
        """Re-arm delivery for one sink (post-release catch-up)."""
        self._clogged[id(sink)] = sink
        self._wake()

    def _wake(self) -> None:
        self._event.set()
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def clogged_count(self) -> int:
        return len(self._clogged)

    def shed_clogged(self) -> int:
        """Shed the CURRENT laggard tier (every clogged sink) with the
        typed `SubLagging` terminal; returns how many went.  The r22
        slo-burn actuator's lever: laggards are exactly the sinks whose
        sockets stopped draining, the ones soon to trip the lag bounds
        anyway — shedding them early frees writer rounds for the
        healthy tier before clients time out."""
        n = 0
        for key, sink in list(self._clogged.items()):
            if sink.shed():
                n += 1
            self._clogged.pop(key, None)
        return n

    # -- the writer task ---------------------------------------------------

    async def _run(self) -> None:
        clog_gauge = METRICS.gauge("corro.subs.writer.clogged")
        writes_total = METRICS.counter("corro.subs.writer.writes.total")
        batches_total = METRICS.counter(
            "corro.subs.writer.coalesced.batches.total"
        )
        round_secs = METRICS.histogram("corro.subs.writer.round.seconds")
        while True:
            if not self._queue and not self._clogged:
                self._event.clear()
                await self._event.wait()
            elif not self._queue:
                # clogged sinks wait on window credit / buffer drain:
                # bounded retry tick (laggards tolerate latency by
                # definition — healthy sinks never pass through here)
                self._event.clear()
                try:
                    await asyncio.wait_for(
                        self._event.wait(), self.tick_secs
                    )
                except asyncio.TimeoutError:
                    pass
            visited = 0
            t0 = time.monotonic()
            while self._queue:
                sinks, item = self._queue.popleft()
                n = len(sinks)
                stride = max(1, n // _OBSERVE_SAMPLE)
                for i, sink in enumerate(sinks):
                    sink.writer = self
                    sink.offer(item)
                    if not sink.hold and not sink.flush(
                        observe=(i % stride == 0)
                    ):
                        self._clogged[id(sink)] = sink
                    else:
                        self._clogged.pop(id(sink), None)
                    visited += 1
                    if visited % _YIELD_EVERY == 0:
                        await asyncio.sleep(0)
            for key, sink in list(self._clogged.items()):
                sink.writer = self
                if sink.flush():
                    self._clogged.pop(key, None)
                visited += 1
                if visited % _YIELD_EVERY == 0:
                    await asyncio.sleep(0)
            if visited:
                # the fan-out walk's own cost — what the SUBS_SCALE
                # per-event matcher+encode+write number is built from
                round_secs.observe(time.monotonic() - t0)
            if self._stat_writes:
                writes_total.inc(self._stat_writes)
                self._stat_writes = 0
            if self._stat_batches:
                batches_total.inc(self._stat_batches)
                self._stat_batches = 0
            clog_gauge.set(len(self._clogged))
