"""Periodic agent metrics collection loop.

The port's copy of `corrosion_tpu/agent/agent_metrics.py`.

Counterpart of the reference's metrics loop
(`klukai-agent/src/agent/metrics.rs:18-108`, spawned every 10 s from
`run_root.rs`): per-table row and clock-row counts, per-actor gap and
buffered-version gauges, bookie breadth, membership/cluster gauges, and
sync/write-path saturation gauges. These are what make a perf
investigation diagnosable without code changes (VERDICT r2 #10).
"""

from __future__ import annotations

import asyncio
import logging

from corrosion_tpu_torch.runtime.metrics import METRICS

logger = logging.getLogger(__name__)

COLLECT_INTERVAL_S = 10.0


def collect_once(agent) -> None:
    """One synchronous collection pass (runs on a worker thread)."""
    store = agent.store
    with store.pooled_read() as conn:
        # per-table data + clock-table sizes (metrics.rs:18-60); the
        # "invalid table" signal is clock rows far exceeding data rows
        for tname in list(store.schema.tables):
            try:
                rows = conn.execute(
                    f'SELECT COUNT(*) FROM "{tname}"'
                ).fetchone()[0]
                clock = conn.execute(
                    f'SELECT COUNT(*) FROM "{tname}__crdt_clock"'
                ).fetchone()[0]
            except Exception:
                continue  # table mid-rebuild
            METRICS.gauge("corro.db.table.rows", table=tname).set(rows)
            METRICS.gauge("corro.db.table.clock_rows", table=tname).set(clock)
        # buffered changes + seq bookkeeping backlog (metrics.rs:62-85)
        buffered = conn.execute(
            "SELECT COUNT(*), COUNT(DISTINCT site_id || '-' || db_version)"
            " FROM __corro_buffered_changes"
        ).fetchone()
        METRICS.gauge("corro.db.buffered_changes.rows").set(buffered[0])
        METRICS.gauge("corro.db.buffered_changes.versions").set(buffered[1])
        gaps = conn.execute(
            "SELECT COUNT(*), COALESCE(SUM(end - start + 1), 0)"
            " FROM __corro_bookkeeping_gaps"
        ).fetchone()
        METRICS.gauge("corro.db.gaps.count").set(gaps[0])
        METRICS.gauge("corro.db.gaps.versions").set(gaps[1])
        members = conn.execute(
            "SELECT COUNT(*) FROM __corro_members"
        ).fetchone()[0]
        METRICS.gauge("corro.db.members.persisted").set(members)

    # host-side state gauges (no db access)
    METRICS.gauge("corro.bookie.actors").set(len(agent.bookie.items()))
    METRICS.gauge("corro.members.count").set(len(agent.members.states))
    METRICS.gauge("corro.gossip.cluster_size").set(
        agent.membership.cluster_size
    )
    # effective SWIM config (log-scaled with cluster size — the reference
    # publishes these so operators see the *live* values, agent.rs:29-63)
    cfg = agent.membership.config
    csize = max(1, agent.membership.cluster_size)
    METRICS.gauge("corro.gossip.config.max_transmissions").set(
        cfg.max_transmissions(csize)
    )
    METRICS.gauge("corro.gossip.config.num_indirect_probes").set(
        cfg.num_indirect_probes
    )
    # membership FSM state census (corro.gossip.member.states) — every
    # enum value is written each pass so a count that drops to zero
    # actually reads zero instead of freezing at its last value
    from corrosion_tpu_torch.agent.membership import MemberState

    by_state = {s.name: 0 for s in MemberState}
    # worker thread (metrics_loop's to_thread) vs event-loop mutation:
    # copy under the GIL before iterating
    for m in list(agent.membership.members.values()):
        by_state[m.state.name] = by_state.get(m.state.name, 0) + 1
    for name, count in by_state.items():
        METRICS.gauge("corro.gossip.member.states", state=name).set(count)
    METRICS.gauge("corro.sync.server.permits_available").set(
        getattr(agent.sync_serve_sem, "_value", 0)
    )
    METRICS.gauge("corro.locks.registered").set(
        len(agent.lock_registry.snapshot())
    )


async def metrics_loop(agent) -> None:
    """Spawned from agent run; collects every 10 s until tripwire."""
    while not agent.tripwire.tripped:
        try:
            await asyncio.to_thread(collect_once, agent)
        except Exception:
            logger.exception("metrics collection failed")
        try:
            await asyncio.wait_for(agent.tripwire.wait(), COLLECT_INTERVAL_S)
        except asyncio.TimeoutError:
            pass
