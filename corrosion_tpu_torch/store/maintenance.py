"""Background database maintenance: WAL truncation + incremental vacuum.

The port's copy of `corrosion_tpu/store/maintenance.py`.

Counterpart of the reference's db-maintenance task
(`klukai-agent/src/agent/handlers.rs:379-547`): a long-running node must
(a) truncate its WAL once it outgrows `perf.wal_threshold_gb` — a WAL
only shrinks on a TRUNCATE checkpoint, so an always-busy node otherwise
grows it unboundedly — and (b) return freed pages to the OS with
incremental vacuum once the freelist passes a floor (`:405-459`).

The WAL truncate uses the reference's escalating busy-timeout ladder
(`calc_busy_timeout`, `handlers.rs:529`): a TRUNCATE checkpoint needs
all readers to drain, so each failed attempt doubles the patience —
30 s, 60 s, … capped at 16 min — rather than spinning.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

logger = logging.getLogger(__name__)

BUSY_TIMEOUT_BASE_S = 30.0  # handlers.rs:529 ladder start
BUSY_TIMEOUT_CAP_S = 960.0  # …and its 16-minute cap
VACUUM_CHUNK_PAGES = 1000


def calc_busy_timeout_s(attempt: int) -> float:
    """Escalating patience for a TRUNCATE checkpoint: 30 s doubling per
    failed attempt, capped at 16 min (handlers.rs:529-547)."""
    return min(BUSY_TIMEOUT_BASE_S * (2**attempt), BUSY_TIMEOUT_CAP_S)


def wal_size_bytes(store) -> int:
    """Current WAL file size; 0 for in-memory stores."""
    if store._is_memory:
        return 0
    wal = store.path + "-wal"
    try:
        return os.path.getsize(wal)
    except OSError:
        return 0


def truncate_wal_if_needed(
    store, threshold_bytes: int, attempt: int = 0
) -> Optional[bool]:
    """TRUNCATE-checkpoint the WAL if it exceeds `threshold_bytes`.

    Returns None when below threshold, True when the checkpoint fully
    truncated, False when it could not (readers still held the WAL —
    caller escalates `attempt`)."""
    size = wal_size_bytes(store)
    METRICS.gauge("corro.db.wal_size_bytes").set(size)
    if not store._is_memory:
        try:
            METRICS.gauge("corro.db.size").set(os.path.getsize(store.path))
        except OSError:
            pass
    if size <= threshold_bytes:
        return None
    t_ckpt = time.monotonic()
    timeout_ms = int(calc_busy_timeout_s(attempt) * 1000)
    with store._lock:
        store._conn.execute(f"PRAGMA busy_timeout = {timeout_ms}")
        try:
            row = store._conn.execute(
                "PRAGMA wal_checkpoint(TRUNCATE)"
            ).fetchone()
        finally:
            store._conn.execute("PRAGMA busy_timeout = 5000")
    # row = (busy, wal_pages, checkpointed_pages)
    busy = bool(row[0]) if row is not None else True
    if busy:
        METRICS.counter("corro.db.wal_truncate.busy").inc()
        logger.warning(
            "WAL truncate attempt %d busy (size=%d bytes); next timeout %.0fs",
            attempt,
            size,
            calc_busy_timeout_s(attempt + 1),
        )
        return False
    METRICS.counter("corro.db.wal_truncate.ok").inc()
    METRICS.histogram("corro.db.wal.truncate.seconds").observe(
        time.monotonic() - t_ckpt
    )
    logger.info("WAL truncated (was %d bytes)", size)
    return True


def freelist_pages(store) -> int:
    with store._lock:
        return int(store._conn.execute("PRAGMA freelist_count").fetchone()[0])


def incremental_vacuum_if_needed(
    store, min_freelist_pages: int, chunk_pages: int = VACUUM_CHUNK_PAGES
) -> int:
    """Run incremental_vacuum in bounded chunks while the freelist stays
    over the floor (handlers.rs:405-459). Returns pages reclaimed.

    Requires auto_vacuum=INCREMENTAL (set at store bootstrap); on
    databases created without it this is a no-op (freelist still reported
    but incremental_vacuum reclaims nothing)."""
    reclaimed = 0
    t_vac = time.monotonic()
    while True:
        free = freelist_pages(store)
        METRICS.gauge("corro.db.freelist_pages").set(free)
        if free < min_freelist_pages:
            if reclaimed:
                METRICS.histogram(
                    "corro.db.incremental.vacuum.seconds"
                ).observe(time.monotonic() - t_vac)
            return reclaimed
        with store._lock:
            store._conn.execute(f"PRAGMA incremental_vacuum({chunk_pages})")
        after = freelist_pages(store)
        got = free - after
        reclaimed += max(0, got)
        METRICS.counter("corro.db.vacuum.pages").inc(max(0, got))
        if got <= 0:
            # don't spin — and tell the operator WHY nothing came back:
            # a db created before auto_vacuum=INCREMENTAL can never
            # reclaim incrementally (needs a one-time full VACUUM)
            with store._lock:
                mode = int(
                    store._conn.execute("PRAGMA auto_vacuum").fetchone()[0]
                )
            if mode != 2:
                logger.warning(
                    "freelist has %d pages but auto_vacuum=%d (not "
                    "INCREMENTAL): this database predates incremental "
                    "vacuum support and needs a one-time full VACUUM "
                    "(e.g. via backup/restore) to reclaim disk",
                    free,
                    mode,
                )
            return reclaimed


async def wal_maintenance_loop(agent) -> None:
    """Spawned from agent run: checks the WAL against
    `perf.wal_threshold_gb` every `perf.wal_check_interval_secs`,
    escalating the busy ladder across consecutive failed truncations."""
    perf = agent.config.perf
    threshold = int(perf.wal_threshold_gb * 2**30)
    attempt = 0
    while not agent.tripwire.tripped:
        try:
            # LOW write lane: maintenance must never delay client writes
            # or remote applies (agent.rs:503-519 write_low)
            async with agent.write_gate.low():
                result = await asyncio.to_thread(
                    truncate_wal_if_needed, agent.store, threshold, attempt
                )
            attempt = attempt + 1 if result is False else 0
        except Exception:
            logger.exception("wal maintenance failed")
        try:
            await asyncio.wait_for(
                agent.tripwire.wait(), perf.wal_check_interval_secs
            )
        except asyncio.TimeoutError:
            pass


async def vacuum_loop(agent) -> None:
    """Spawned from agent run: incremental vacuum on a 5-minute cadence
    (handlers.rs:405-459)."""
    perf = agent.config.perf
    while not agent.tripwire.tripped:
        try:
            async with agent.write_gate.low():
                await asyncio.to_thread(
                    incremental_vacuum_if_needed,
                    agent.store,
                    perf.vacuum_min_freelist_pages,
                )
        except Exception:
            logger.exception("incremental vacuum failed")
        try:
            await asyncio.wait_for(
                agent.tripwire.wait(), perf.vacuum_interval_secs
            )
        except asyncio.TimeoutError:
            pass
