"""Bounded channels with metrics, the runtime's nervous system.

The port's copy of `corrosion_tpu/runtime/channels.py`.

Counterpart of `klukai-types/src/channel.rs` (mpsc wrappers emitting
send/recv/failed counters, capacity gauges, and send-delay histograms per
named channel) over asyncio queues. The same names flow into the metrics
registry so dashboards match the reference's series.
"""

from __future__ import annotations

import asyncio
import time
from typing import Generic, Optional, Tuple, TypeVar

from corrosion_tpu_torch.runtime.metrics import METRICS

T = TypeVar("T")


class ChannelClosed(Exception):
    pass


class Sender(Generic[T]):
    def __init__(self, ch: "_Chan[T]"):
        self._ch = ch

    async def send(self, item: T) -> None:
        if self._ch.closed:
            METRICS.counter(
                "corro.channel.message.send.failed", channel=self._ch.name
            ).inc()
            raise ChannelClosed(self._ch.name)
        start = time.monotonic()
        await self._ch.queue.put(item)
        METRICS.counter("corro.channel.message.sent", channel=self._ch.name).inc()
        METRICS.gauge(
            "corro.channel.queue.depth", channel=self._ch.name
        ).set(self._ch.queue.qsize())
        METRICS.histogram(
            "corro.channel.message.send.delay.seconds", channel=self._ch.name
        ).observe(time.monotonic() - start)

    async def send_many(self, items) -> None:
        """Enqueue a whole batch with ONE metrics round (r21 group
        fanout): the sent counter bumps by the batch size and the
        depth/delay series are touched once, instead of a counter inc +
        gauge set + histogram observe per item.  Queue puts still
        happen item-by-item so a bounded channel's backpressure keeps
        its per-item semantics."""
        items = list(items)
        if not items:
            return
        if self._ch.closed:
            METRICS.counter(
                "corro.channel.message.send.failed", channel=self._ch.name
            ).inc(len(items))
            raise ChannelClosed(self._ch.name)
        start = time.monotonic()
        put = self._ch.queue.put
        for item in items:
            await put(item)
        METRICS.counter(
            "corro.channel.message.sent", channel=self._ch.name
        ).inc(len(items))
        METRICS.gauge(
            "corro.channel.queue.depth", channel=self._ch.name
        ).set(self._ch.queue.qsize())
        METRICS.histogram(
            "corro.channel.message.send.delay.seconds", channel=self._ch.name
        ).observe(time.monotonic() - start)

    def try_send(self, item: T) -> bool:
        try:
            self._ch.queue.put_nowait(item)
            METRICS.counter(
                "corro.channel.message.sent", channel=self._ch.name
            ).inc()
            return True
        except asyncio.QueueFull:
            METRICS.counter(
                "corro.channel.message.send.failed", channel=self._ch.name
            ).inc()
            return False

    def close(self) -> None:
        self._ch.closed = True
        self._ch.closed_event.set()

    @property
    def capacity_left(self) -> int:
        return max(0, self._ch.queue.maxsize - self._ch.queue.qsize())


class Receiver(Generic[T]):
    def __init__(self, ch: "_Chan[T]"):
        self._ch = ch

    async def recv(self) -> T:
        """Receive the next item; raises ChannelClosed once the channel is
        closed AND drained (the Rust mpsc recv-returns-None contract)."""
        while True:
            if self._ch.closed and self._ch.queue.empty():
                raise ChannelClosed(self._ch.name)
            get = asyncio.ensure_future(self._ch.queue.get())
            closed = asyncio.ensure_future(self._ch.closed_event.wait())
            try:
                done, _ = await asyncio.wait(
                    {get, closed}, return_when=asyncio.FIRST_COMPLETED
                )
            except asyncio.CancelledError:
                # external cancellation (e.g. wait_for timeout): don't lose
                # an item the inner get may already have consumed
                closed.cancel()
                if get.done() and not get.cancelled():
                    q = self._ch.queue
                    q._queue.appendleft(get.result())
                    # appendleft bypasses put_nowait's getter wakeup —
                    # rouse any consumer parked inside queue.get()
                    q._wakeup_next(q._getters)
                else:
                    get.cancel()
                raise
            closed.cancel()
            if get in done:
                METRICS.counter(
                    "corro.channel.message.received", channel=self._ch.name
                ).inc()
                return get.result()
            get.cancel()
            try:
                await get
                # a race can complete the get during cancellation
                METRICS.counter(
                    "corro.channel.message.received", channel=self._ch.name
                ).inc()
                return get.result()
            except asyncio.CancelledError:
                pass

    def try_recv(self) -> Optional[T]:
        try:
            item = self._ch.queue.get_nowait()
            METRICS.counter(
                "corro.channel.message.received", channel=self._ch.name
            ).inc()
            return item
        except asyncio.QueueEmpty:
            return None

    async def recv_timeout(self, timeout: float) -> Optional[T]:
        try:
            return await asyncio.wait_for(self.recv(), timeout)
        except asyncio.TimeoutError:
            return None

    def qsize(self) -> int:
        return self._ch.queue.qsize()


class _Chan(Generic[T]):
    def __init__(self, size: int, name: str):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=size)
        self.name = name
        self.closed = False
        self.closed_event = asyncio.Event()


def bounded(size: int, name: str) -> Tuple[Sender[T], Receiver[T]]:
    ch: _Chan[T] = _Chan(size, name)
    METRICS.gauge("corro.channel.bounded.capacity", channel=name).set(size)
    return Sender(ch), Receiver(ch)
