"""Shared bounded executor for live-query diff work.

The port's copy of `corrosion_tpu/pubsub/executor.py`.

Through r9 every `MatcherHandle` ran `handle_candidates` via
`asyncio.to_thread`, i.e. the event loop's DEFAULT ThreadPoolExecutor
(min(32, cpus+4) workers shared with file I/O, DNS, and every other
to_thread in the process).  Under many live subscriptions a write burst
makes every matcher submit at once: the default pool both spawns far
more diff threads than sqlite can use (GIL + one write lock per sub db)
and lets pubsub starve unrelated to_thread users.  The reference keeps
matcher work on a dedicated runtime (`MatcherHandle::cmd_loop` tasks on
tokio's blocking pool, pubsub.rs:1029).

`DiffExecutor` is one small dedicated pool per `SubsManager`: diffs
queue here, concurrency is capped, and the queue depth / wait time are
observable (`corro.subs.executor.*`) so sub-count overload shows up as
a rising gauge instead of an invisible thread pile-up.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

# diff work is sqlite-C-heavy (GIL released inside the library) but one
# sub db admits one writer: a few workers overlap distinct matchers'
# diffs without minting a thread per subscription
DEFAULT_DIFF_WORKERS = 4


class DiffExecutor:
    """Lazily-started bounded ThreadPoolExecutor with depth telemetry.

    `depth` counts submitted-but-unfinished jobs (queued + running);
    anything above `max_workers` is backpressure — matchers waiting for
    a worker while their candidate queues keep batching (the batching
    keeps per-event cost amortized, so a deep queue degrades latency,
    not correctness)."""

    def __init__(self, max_workers: int = DEFAULT_DIFF_WORKERS):
        # sized by [subs] diff_workers since r16 (SubsManager passes it)
        self.max_workers = max_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._depth = 0
        # instrument handles resolved once: at 10k-100k streams the
        # per-diff registry lookups (name+label hashing) were three
        # avoidable dict probes per submission on the event loop
        self._g_depth = METRICS.gauge("corro.subs.executor.depth")
        self._c_submitted = METRICS.counter(
            "corro.subs.executor.submitted.total"
        )
        self._h_wait = METRICS.histogram("corro.subs.executor.wait.seconds")

    def _ensure(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.max_workers,
                    thread_name_prefix="corro-subs-diff",
                )
            return self._pool

    @property
    def depth(self) -> int:
        return self._depth

    async def run(self, fn, *args):
        """Run `fn(*args)` on the shared pool; awaits the result."""
        loop = asyncio.get_running_loop()
        pool = self._ensure()
        submitted = time.monotonic()
        with self._lock:
            self._depth += 1
            depth = self._depth
        self._g_depth.set(depth)
        self._c_submitted.inc()

        def job():
            # time spent queued behind other matchers' diffs — the
            # backpressure signal a sub-count overload raises first
            self._h_wait.observe(time.monotonic() - submitted)
            return fn(*args)

        try:
            return await loop.run_in_executor(pool, job)
        finally:
            with self._lock:
                self._depth -= 1
                depth = self._depth
            self._g_depth.set(depth)

    def shutdown(self) -> None:
        """Stop the pool (running jobs finish; a later `run` restarts)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
