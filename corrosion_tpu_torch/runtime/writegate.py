"""Three-class priority gate for the single write path.

The port's copy of `corrosion_tpu/runtime/writegate.py`.

Counterpart of the reference's SplitPool write queues
(`klukai-types/src/agent.rs:478-519`): one writable connection, three
FIFO queues in front of it — `priority` (local client writes,
`/v1/transactions`), `normal` (remote change applies), `low`
(background work) — so a burst of sync-applied remote changes can never
starve local write latency.

The gate is an asyncio-level single permit. Work that takes the store's
thread lock (WriteTx, apply_changes) must acquire a lane first; the
store lock then never has more than one waiter, making the asyncio
queue the ONLY ordering that matters.
"""

from __future__ import annotations

import asyncio
import enum
from collections import deque
from typing import Deque, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS


class WritePriority(enum.IntEnum):
    PRIORITY = 0  # local client writes (write_priority, agent.rs:586)
    NORMAL = 1  # remote change applies (write_normal)
    LOW = 2  # background maintenance (write_low)


class PriorityWriteGate:
    """Single-permit async gate with three strict-priority FIFO lanes.

    Release always wakes the highest non-empty lane; within a lane,
    arrival order (FIFO) is preserved. `async with gate:` acquires the
    NORMAL lane; `gate.priority()` / `gate.normal()` / `gate.low()`
    return context managers for explicit lanes.
    """

    def __init__(self):
        self._held = False
        self._waiters: tuple[Deque[asyncio.Future], ...] = (
            deque(),
            deque(),
            deque(),
        )

    def _gauge(self) -> None:
        for lane in WritePriority:
            METRICS.gauge(
                f"corro.write_gate.waiting.{lane.name.lower()}"
            ).set(len(self._waiters[lane]))
        # SplitPool write-side parity (agent.rs:478): 1 permit total
        METRICS.gauge("corro.sqlite.write.permits.available").set(
            0 if self._held else 1
        )
        METRICS.gauge("corro.sqlite.pool.write.connections.waiting").set(
            sum(len(q) for q in self._waiters)
        )

    async def acquire(self, lane: WritePriority = WritePriority.NORMAL) -> None:
        if not self._held and not any(self._waiters):
            self._held = True
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters[lane].append(fut)
        self._gauge()
        try:
            await fut
        except asyncio.CancelledError:
            if not fut.cancelled() and fut.done() and fut.result() is None:
                # woken AND cancelled: pass the permit on
                self.release()
            else:
                try:
                    self._waiters[lane].remove(fut)
                except ValueError:
                    pass
            raise
        finally:
            self._gauge()

    def release(self) -> None:
        for lane_q in self._waiters:
            while lane_q:
                fut = lane_q.popleft()
                if not fut.done():
                    fut.set_result(None)
                    return
        self._held = False

    def locked(self) -> bool:
        return self._held

    def lane(self, lane: WritePriority) -> "_LaneCM":
        return _LaneCM(self, lane)

    def priority(self) -> "_LaneCM":
        return self.lane(WritePriority.PRIORITY)

    def normal(self) -> "_LaneCM":
        return self.lane(WritePriority.NORMAL)

    def low(self) -> "_LaneCM":
        return self.lane(WritePriority.LOW)

    async def __aenter__(self):
        await self.acquire(WritePriority.NORMAL)
        return self

    async def __aexit__(self, *exc):
        self.release()


class _LaneCM:
    def __init__(self, gate: PriorityWriteGate, lane: WritePriority):
        self._gate = gate
        self._lane = lane

    async def __aenter__(self):
        await self._gate.acquire(self._lane)
        return self._gate

    async def __aexit__(self, *exc):
        self._gate.release()
