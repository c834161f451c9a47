"""Instrumented read/write locks with a central registry + watchdog.

The port's copy of `corrosion_tpu/runtime/locks.py`.

Counterpart of the reference's `CountedTokioRwLock`/`LockRegistry`
(`klukai-types/src/agent.rs:707-1066`) and the setup-time watchdog
(`klukai-agent/src/agent/setup.rs:188-246`): every acquisition registers
{label, kind, state, started_at} in an ordered map so an operator can see,
live, which bookie/member locks are held or queued and for how long. A
watchdog task logs any lock held longer than 10 s and bumps a metric at
60 s (the reference fires an Antithesis invariant there).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

log = logging.getLogger(__name__)

_WARN_HELD_S = 10.0
_INVARIANT_HELD_S = 60.0


@dataclass
class LockMeta:
    id: int
    label: str
    kind: str  # "read" | "write"
    state: str  # "acquiring" | "locked"
    started_at: float

    def held_for(self) -> float:
        return time.monotonic() - self.started_at


class LockRegistry:
    """Ordered map of live lock acquisitions (agent.rs:760-818)."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._live: Dict[int, LockMeta] = {}

    def register(self, label: str, kind: str) -> LockMeta:
        meta = LockMeta(
            id=next(self._ids),
            label=label,
            kind=kind,
            state="acquiring",
            started_at=time.monotonic(),
        )
        self._live[meta.id] = meta
        return meta

    def acquired(self, meta: LockMeta) -> None:
        meta.state = "locked"
        meta.started_at = time.monotonic()

    def release(self, meta: LockMeta) -> None:
        self._live.pop(meta.id, None)

    def snapshot(self, top: Optional[int] = None) -> List[LockMeta]:
        """Longest-held first (the admin `locks` command view)."""
        items = sorted(self._live.values(), key=lambda m: m.started_at)
        return items[:top] if top is not None else items

    async def watchdog(self, interval: float = 1.0) -> None:
        """Logs locks held > 10 s; metric at 60 s (setup.rs:188-246)."""
        warned = set()
        while True:
            await asyncio.sleep(interval)
            for meta in list(self._live.values()):
                held = meta.held_for()
                if held > _WARN_HELD_S and meta.id not in warned:
                    warned.add(meta.id)
                    log.warning(
                        "lock %s (%s/%s) %s for %.1fs",
                        meta.id, meta.label, meta.kind, meta.state, held,
                    )
                if held > _INVARIANT_HELD_S:
                    from corrosion_tpu_torch.runtime.invariants import (
                        InvariantViolation,
                        assert_always,
                    )

                    # metric FIRST — it must fire even in strict mode
                    METRICS.counter(
                        "corro_lock_held_over_invariant", label=meta.label
                    ).inc()
                    # ref assert_always: no lock held past 60s
                    # (setup.rs:231). Contained: strict mode must not
                    # kill the watchdog task itself — the violation is
                    # recorded and monitoring continues
                    try:
                        assert_always(
                            False,
                            "locks.held_under_60s",
                            {"label": meta.label, "held_s": round(held, 1)},
                        )
                    except InvariantViolation:
                        log.error(
                            "lock invariant violated (watchdog continues): "
                            "%s held %.1fs", meta.label, held,
                        )
            warned &= set(self._live)


class CountedRwLock:
    """Async RW lock whose acquisitions are tracked in a LockRegistry.

    Writer-preferring: readers queue behind a waiting writer, matching
    tokio::sync::RwLock fairness closely enough for our uses. `blocking_*`
    variants from the reference (used off the async runtime) map to the
    same async methods here — the whole runtime is one event loop.
    """

    def __init__(self, registry: LockRegistry, label: str):
        self._registry = registry
        self._label = label
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._cond = asyncio.Condition()

    def read(self, label_extra: str = "") -> "_Guard":
        return _Guard(self, "read", label_extra)

    def write(self, label_extra: str = "") -> "_Guard":
        return _Guard(self, "write", label_extra)

    async def _acquire(self, kind: str) -> None:
        async with self._cond:
            if kind == "read":
                while self._writer or self._writers_waiting:
                    await self._cond.wait()
                self._readers += 1
            else:
                self._writers_waiting += 1
                try:
                    while self._writer or self._readers:
                        await self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                    self._cond.notify_all()
                self._writer = True

    async def _release(self, kind: str) -> None:
        async with self._cond:
            if kind == "read":
                self._readers -= 1
            else:
                self._writer = False
            self._cond.notify_all()


class _Guard:
    def __init__(self, lock: CountedRwLock, kind: str, label_extra: str):
        self._lock = lock
        self._kind = kind
        self._label = lock._label + (f":{label_extra}" if label_extra else "")
        self._meta: Optional[LockMeta] = None

    async def __aenter__(self) -> "_Guard":
        self._meta = self._lock._registry.register(self._label, self._kind)
        try:
            await self._lock._acquire(self._kind)
        except BaseException:
            # cancelled while queued: drop the registry entry, don't leak
            self._lock._registry.release(self._meta)
            self._meta = None
            raise
        self._lock._registry.acquired(self._meta)
        return self

    async def __aexit__(self, *exc) -> None:
        await self._lock._release(self._kind)
        if self._meta is not None:
            self._lock._registry.release(self._meta)
