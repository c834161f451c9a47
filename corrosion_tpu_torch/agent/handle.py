"""The Agent handle: shared state every subsystem hangs off.

The port's copy of `corrosion_tpu/agent/handle.py`.

Counterpart of the `Agent` god-handle in `klukai-types/src/agent.rs:64-273`
(actor id, pools, HLC clock, channels, members, booked versions, write
semaphore, schema, subs/updates managers, sync-concurrency limits).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

from corrosion_tpu_torch.agent.members import Members
from corrosion_tpu_torch.agent.membership import Membership
from corrosion_tpu_torch.net.transport import Listener, Transport
from corrosion_tpu_torch.runtime.channels import Receiver, Sender
from corrosion_tpu_torch.runtime.config import Config
from corrosion_tpu_torch.runtime.writegate import PriorityWriteGate
from corrosion_tpu_torch.runtime.locks import LockRegistry
from corrosion_tpu_torch.runtime.tripwire import TaskTracker, Tripwire
from corrosion_tpu_torch.store.bookkeeping import Bookie
from corrosion_tpu_torch.store.crdt import CrdtStore
from corrosion_tpu_torch.types.actor import Actor, ActorId, ClusterId
from corrosion_tpu_torch.types.base import HLClock
from corrosion_tpu_torch.types.change import Change, ChangeV1


class ChangeSource(Enum):
    BROADCAST = "broadcast"
    SYNC = "sync"


@dataclass
class BroadcastInput:
    """AddBroadcast (our own fresh change) or Rebroadcast (relayed)."""

    change: ChangeV1
    is_local: bool  # True = AddBroadcast, False = Rebroadcast


# subs/updates hook: called with every batch of impactful committed
# changes plus the batch's latency stamp (runtime/latency.py BatchStamp;
# origin may be None when no stamp traveled with the changes)
ChangeHook = Callable[..., None]


@dataclass
class Agent:
    actor: Actor
    config: Config
    store: CrdtStore
    bookie: Bookie
    clock: HLClock
    members: Members
    membership: Membership
    transport: Transport
    listener: Listener
    tripwire: Tripwire
    tracker: TaskTracker

    tx_bcast: Sender
    rx_bcast: Receiver
    tx_changes: Sender
    rx_changes: Receiver
    tx_apply: Sender
    rx_apply: Receiver

    # SplitPool write-permit analog: one writer at a time, waiters queued
    # 3-lane priority gate in front of the single write path
    # (SplitPool's priority/normal/low write queues, agent.rs:478-519)
    write_gate: PriorityWriteGate = field(default_factory=PriorityWriteGate)
    # ≤3 concurrent inbound sync serves (agent.rs:144-146)
    sync_serve_sem: asyncio.Semaphore = field(default_factory=lambda: asyncio.Semaphore(3))
    change_hooks: List[ChangeHook] = field(default_factory=list)
    # live-query + raw-update managers (agent.rs:64-273 subs/updates)
    subs: Optional[object] = None  # SubsManager
    updates: Optional[object] = None  # UpdatesManager
    # r11 SLO plane: per-agent latency-objective monitor
    # (runtime/latency.py SloMonitor), checked by /v1/slo + the canary
    slo: Optional[object] = None
    # canary rows this agent's canary loop saw come back through its
    # subscription: its own ("local") and other nodes' ("remote"). The
    # latency histograms are process-global; these count per agent
    canary_seen: Dict[str, int] = field(
        default_factory=lambda: {"local": 0, "remote": 0})
    # r12 cluster observatory (agent/observatory.py): digest
    # anti-entropy store + view-divergence detector, serves /v1/cluster
    observatory: Optional[object] = None
    # r20 alerting plane (runtime/alerts.py): declarative rules over
    # the metrics TSDB with a pending→firing→resolved lifecycle;
    # serves /v1/alerts, summaries ride the observatory digests
    alerts: Optional[object] = None
    # r22 remediation plane (agent/remediation.py): the supervisor
    # that turns alert firings into typed, cooldown-gated actuator
    # runs; serves GET /v1/remediation
    remediation: Optional[object] = None
    # r22 refuse-bulk deadline (monotonic): while in the future this
    # node refuses to SERVE bulk snapshot transfers (catchup.py rejects
    # BUSY) and to START one as a bootstrap client — armed by the
    # store-faults actuator, cleared by its revert hook (or expiry)
    bulk_refuse_until: float = 0.0
    # r14 write-path group commit (agent/run.py GroupCommitter):
    # concurrent local writers coalesce into shared sqlite transactions
    commit_group: Optional[object] = None
    # r17 catch-up plane (agent/catchup.py): serve-side cached snapshot
    # (store/snapshot.py SnapshotCache) + its async build lock/permits,
    # per-peer sync circuit state, and the bootstrap census /v1/status
    # serves
    snapshots: Optional[object] = None  # SnapshotCache
    snapshot_build_lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    # sized from [sync] max_concurrent_snapshot_serves at agent build
    # time (agent/run.py); the default only covers hand-built test agents
    snapshot_serve_sem: asyncio.Semaphore = field(
        default_factory=lambda: asyncio.Semaphore(2)
    )
    # ActorId -> PeerCircuit (agent/syncer.py): consecutive-failure
    # breaker consulted by peer choice and the resumable sync waves
    sync_circuits: dict = field(default_factory=dict)
    # bootstrap census: {"state": idle|fetching|installed|failed, ...}
    catchup_census: dict = field(default_factory=dict)
    # r18 (found by the traffic_sim zombie-node scenario): the
    # announcer picks its sleep while healthy — the 300 s steady
    # period — and used to sleep straight through an isolation that
    # began mid-sleep, leaving an evicted node silent for up to 5
    # minutes after the fault cleared.  This event is set when the
    # SWIM view collapses to self (run.py on_notification) and the
    # announcer waits on it alongside the tripwire, so isolation
    # restarts the jittered announce ramp IMMEDIATELY
    announce_wake: asyncio.Event = field(default_factory=asyncio.Event)
    # bumped by a snapshot install: the ingest seen-cache must drop
    # everything it remembers, because "seen" changes applied BEFORE
    # the database swap were discarded by it — a stale entry would
    # shadow the re-served version forever (agent/ingest.py)
    ingest_epoch: int = 0
    # instrumented-lock registry (agent.rs:707-1066), admin `locks` command
    lock_registry: LockRegistry = field(default_factory=LockRegistry)

    @property
    def actor_id(self) -> ActorId:
        return self.actor.id

    @property
    def cluster_id(self) -> ClusterId:
        return self.actor.cluster_id

    def notify_change_hooks(
        self,
        changes: List[Change],
        origin_wall: Optional[float] = None,
        traceparent: Optional[str] = None,
        trace_meta: Optional[int] = None,
    ) -> None:
        """Feed one committed batch to the subs/updates hooks.  Runs on
        whatever thread committed (write path / ingest worker): the
        histogram makes the per-batch hook cost visible so a routing
        regression back to O(subs × changes) shows up as a rising
        write-path tax, not a mystery throughput loss.

        r11: the batch's latency stamp travels with it — `applied` is
        NOW (the commit that produced these changes just happened on
        this thread), `origin` is the origin node's commit wall clock
        when it rode the envelope here (None otherwise).  The matcher
        measures apply→event against it and the stream write measures
        the end-to-end total.  r19: the origin's W3C trace context +
        tail-sampling meta ride the same stamp so the match/deliver
        stage spans stitch to the write's trace."""
        import time as _time

        from corrosion_tpu_torch.runtime.latency import BatchStamp
        from corrosion_tpu_torch.runtime.metrics import METRICS

        stamp = BatchStamp(
            origin=origin_wall, applied=_time.time(),
            traceparent=traceparent, trace_meta=trace_meta,
        )
        start = _time.monotonic()
        for hook in list(self.change_hooks):
            hook(changes, stamp)
        METRICS.histogram("corro.agent.changes.hooks.seconds").observe(
            _time.monotonic() - start
        )

    def notify_change_hooks_group(
        self,
        batches: List[tuple],
        origin_wall: Optional[float] = None,
    ) -> None:
        """Group-commit form of `notify_change_hooks` (r21): feed every
        committed tx of one group batch through the hooks with ONE
        applied stamp, one hooks-list snapshot and one histogram
        observe, instead of a full per-tx flush for each follower.
        Each tx keeps its OWN BatchStamp (its traceparent/trace_meta
        differ), so subscribers still see per-tx batch boundaries —
        only the bookkeeping around the hook calls amortizes.
        ``batches`` yields ``(changes, traceparent, trace_meta)``."""
        import time as _time

        from corrosion_tpu_torch.runtime.latency import BatchStamp
        from corrosion_tpu_torch.runtime.metrics import METRICS

        applied = _time.time()
        hooks = list(self.change_hooks)
        start = _time.monotonic()
        for changes, traceparent, trace_meta in batches:
            stamp = BatchStamp(
                origin=origin_wall, applied=applied,
                traceparent=traceparent, trace_meta=trace_meta,
            )
            for hook in hooks:
                hook(changes, stamp)
        METRICS.histogram("corro.agent.changes.hooks.seconds").observe(
            _time.monotonic() - start
        )
