"""Tripwire: the cooperative shutdown signal every loop checks — the
port's copy of `corrosion_tpu/runtime/tripwire.py`.

The agent's loops and the SWIM prober's (`agent/membership.py`) run
until the tripwire fires; `preemptible` runs an awaitable unless the
tripwire fires first; `TaskTracker` counts the agent's critical tasks so
that shutdown can wait for them.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
from enum import Enum
from typing import Awaitable, Optional, Set, TypeVar

from corrosion_tpu_torch.runtime.records import FLIGHT

T = TypeVar("T")


class Outcome(Enum):
    COMPLETED = "completed"
    PREEMPTED = "preempted"


class Tripwire:
    def __init__(self):
        self._event = asyncio.Event()

    @classmethod
    def from_signals(cls) -> "Tripwire":
        """A tripwire that SIGTERM and SIGINT fire (as incidents), bound
        to the running loop: the CLI agent's."""
        tw = cls()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(
                    sig, tw.trip, f"signal:{signal.Signals(sig).name}"
                )
        return tw

    def trip(self, incident: Optional[str] = None) -> None:
        """Fire the tripwire. `incident` names an abnormal trip (a signal,
        an operator kill): the flight recorder's frame history is then
        dumped to a black-box file first. A graceful shutdown trips with
        no incident and dumps nothing."""
        if incident and not self._event.is_set():
            FLIGHT.snapshot_incident(incident)  # never raises
        self._event.set()

    @property
    def tripped(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        await self._event.wait()

    async def preemptible(self, aw: Awaitable[T]):
        """Run `aw` unless the tripwire fires first.

        Returns (Outcome.COMPLETED, result) or (Outcome.PREEMPTED, None);
        the inner awaitable is cancelled on preemption.
        """
        task = asyncio.ensure_future(aw)
        trip_task = asyncio.ensure_future(self._event.wait())
        try:
            done, _ = await asyncio.wait(
                {task, trip_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if task in done:
                return Outcome.COMPLETED, task.result()
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
            return Outcome.PREEMPTED, None
        finally:
            trip_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await trip_task


class TaskTracker:
    """Counted critical tasks: shutdown waits for them."""

    def __init__(self):
        self._tasks: Set[asyncio.Task] = set()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    @property
    def pending(self) -> int:
        return len(self._tasks)

    async def wait_all(self, timeout: float = 60.0) -> bool:
        """Wait at most `timeout` for every tracked task; returns True if
        they all ended (the rest are cancelled)."""
        if not self._tasks:
            return True
        done, pending = await asyncio.wait(
            set(self._tasks), timeout=timeout
        )
        for t in pending:
            t.cancel()
        return not pending
