"""Agent assembly and lifecycle: setup → run → shutdown.

Counterparts:
  - `setup()` (`klukai-agent/src/agent/setup.rs:74-289`): open the store,
    derive the actor identity from the site id, apply schema files, bind
    the gossip endpoint, create the channel graph from PerfConfig, warm
    the bookie from durable state.
  - `start_with_config`/`run` (`agent/run_root.rs:32-234`): wire the SWIM
    loop, broadcast loop, ingestion loop, apply loop, sync loop, gossip
    server handlers and announcers, then hand back the Agent handle.
  - local write path `make_broadcastable_changes`
    (`api/public/mod.rs:57-258`) + `broadcast_changes`
    (`klukai-types/src/broadcast.rs:605-675`).

The port's copy of `corrosion_tpu/agent/run.py`. What differs:

  - `setup(config, network=None, tripwire=None, device=None)`: `device`
    is where the store's array CRDT engine runs its decision program
    (`runtime/device.py::resolve_device`: `cuda:0` when none is named,
    a RuntimeError without CUDA; the CPU only by name). CUDA is
    initialised on the calling thread before any apply worker runs.
  - With no `network`, the gossip plane binds real sockets as the JAX
    package does: plaintext QUIC (`net/quic.py`) or UDP datagrams plus
    TCP streams, with TLS unless `gossip.plaintext` (`net/tcp.py`,
    `tls.py`). A socket that fails to bind, or TLS settings that do not
    load, are errors: `setup` never falls back to another transport or
    to plaintext.
  - `agent.subs` and `agent.updates` (the live-query and raw-update
    engines, `pubsub/`) are built on every agent and fed every
    committed batch; `slo.canary` runs `canary_loop`, which also counts
    what it saw in `agent.canary_seen`. The cluster observatory
    (`cluster.digests`), the snapshot catch-up plane (`sync.snapshot`)
    and the runtime planes (the trace store, the metrics TSDB, the alert
    engine with its remediation supervisor, the continuous profiler) are
    built as in the JAX package, so a default `Config` boots.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import random
import threading
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from corrosion_tpu_torch.agent.broadcast import broadcast_loop
from corrosion_tpu_torch.agent.handle import Agent, BroadcastInput, ChangeSource
from corrosion_tpu_torch.agent.ingest import (
    apply_fully_buffered_loop,
    handle_changes,
)
from corrosion_tpu_torch.agent.members import Members
from corrosion_tpu_torch.agent.membership import (
    Membership,
    Notification,
    SwimConfig,
)
from corrosion_tpu_torch.agent.syncer import serve_sync, sync_loop
from corrosion_tpu_torch.net.mem import MemNetwork
from corrosion_tpu_torch.net.tcp import TcpListener, TcpTransport, split_addr
from corrosion_tpu_torch.net.transport import BiStream
from corrosion_tpu_torch.runtime import profiler as _rt_profiler
from corrosion_tpu_torch.runtime.channels import bounded
from corrosion_tpu_torch.runtime.config import Config
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.tripwire import TaskTracker, Tripwire
from corrosion_tpu_torch.store.bookkeeping import Bookie
from corrosion_tpu_torch.store.crdt import CrdtStore
from corrosion_tpu_torch.types.actor import Actor, ClusterId
from corrosion_tpu_torch.types.base import HLClock, Timestamp
from corrosion_tpu_torch.types.codec import chunked_change_v1, decode_uni_payload_ext
from corrosion_tpu_torch.types.rangeset import RangeSet

log = logging.getLogger(__name__)

def _init_cuda(dev) -> None:
    """Create the CUDA context on the calling thread, so no apply worker
    pays for it (or races another to make it) inside a batch."""
    if dev.type == "cuda":
        import torch

        torch.cuda.init()
        torch.zeros(1, device=dev).sum().item()


async def _bind_gossip(config: Config):
    """(listener, transport) of the gossip plane on real sockets, as JAX
    `setup` binds them: plaintext QUIC, or UDP + TCP (TLS unless
    `gossip.plaintext`). Whatever was bound is released on an error."""
    if config.gossip.transport == "quic":
        # plaintext QUIC, the reference's native gossip plane
        # (quinn_plaintext.rs:23-35): datagram/uni/bi lanes on one UDP
        # socket
        from corrosion_tpu_torch.net.quic import (
            MAX_UDP,
            QuicEndpoint,
            QuicTransport,
        )

        host, port = split_addr(config.gossip.bind_addr)
        # parse BEFORE binding anything: a malformed client_addr must
        # not leave the gossip socket bound behind a config error
        c_host, c_port = split_addr(config.gossip.client_addr or ":0")
        mtu = min(config.gossip.max_mtu or MAX_UDP, MAX_UDP)
        listener = await QuicEndpoint.bind(
            host or "127.0.0.1", port,
            # gossip.max_mtu (api/peer/mod.rs:121-150 fixed-MTU knob)
            mtu=mtu,
        )
        # outbound spread (transport.rs:57-71): 8 hashed dial-only
        # sockets when client_addr's port is 0 (the default), 1 when an
        # operator pinned a port
        n_client = 8 if c_port == 0 else 1
        client_eps = []
        try:
            for _ in range(n_client):
                client_eps.append(await QuicEndpoint.bind(
                    c_host or host or "127.0.0.1", c_port,
                    mtu=mtu, accept_inbound=False,
                ))
        except OSError:
            # e.g. a pinned client_addr port already in use: release
            # everything bound so far or a setup() retry hits EADDRINUSE
            # on our own gossip port
            for ep in client_eps:
                await ep.close()
            await listener.close()
            raise
        transport = QuicTransport(
            listener, idle_timeout=float(config.gossip.idle_timeout_secs),
            client_endpoints=client_eps,
        )
        return listener, transport
    host, port = split_addr(config.gossip.bind_addr)
    server_ctx = client_ctx = None
    if not config.gossip.plaintext:
        # secured gossip plane (peer/mod.rs:152-373): plaintext stays
        # the explicit opt-in via gossip.plaintext = true. An operator
        # who turned plaintext OFF with a broken/missing [gossip.tls]
        # gets an error here — never a plaintext fallback
        from corrosion_tpu_torch.tls import build_ssl_contexts

        server_ctx, client_ctx = build_ssl_contexts(config.gossip.tls)
    listener = await TcpListener.bind(
        host or "127.0.0.1", int(port), ssl_context=server_ctx
    )
    transport = TcpTransport(
        listener, ssl_context=client_ctx,
        idle_timeout=float(config.gossip.idle_timeout_secs),
    )
    return listener, transport


async def setup(
    config: Config,
    network: Optional[MemNetwork] = None,
    tripwire: Optional[Tripwire] = None,
    device=None,
) -> Agent:
    if network is None and config.gossip.transport not in ("tcp", "quic"):
        raise ValueError(
            f"unknown gossip.transport {config.gossip.transport!r} "
            "(expected 'tcp' or 'quic')"
        )
    if (network is None and config.gossip.transport == "quic"
            and not config.gossip.plaintext):
        # refused before the store opens or anything binds
        raise ValueError(
            "gossip.transport = 'quic' supports plaintext mode only "
            "(set gossip.plaintext = true, or use the tcp transport "
            "with [gossip.tls])"
        )
    dev = resolve_device(device)
    _init_cuda(dev)
    tripwire = tripwire or Tripwire()

    def _boot_store() -> CrdtStore:
        # sqlite open + schema file reads + declarative re-apply are
        # all blocking I/O; a caller embedding setup() next to live
        # traffic must not stall its event loop for a schema apply
        store = CrdtStore(config.db.path, device=dev)
        # [perf] direct_capture gates the in-memory write capture
        # (CORRO_CAPTURE=trigger overrides per process)
        store.direct_capture = config.perf.direct_capture
        # the canary table is system-owned (the SLO canary creates it at
        # runtime) and never appears in the user's schema files: carry a
        # persisted one through the declarative re-apply, or a restart
        # would be refused as a destructive table drop
        canary_t = store.schema.tables.get(config.slo.canary_table)
        canary_ddl = (
            canary_t.raw_sql.rstrip(";") + ";" if canary_t else None
        )
        for schema_path in config.db.schema_paths:
            sql = Path(schema_path).read_text()
            if canary_ddl:
                sql = sql + "\n" + canary_ddl
            store.apply_schema_sql(sql)
        return store

    store = await asyncio.to_thread(_boot_store)
    clock = HLClock()

    if network is not None:
        addr = config.gossip.bind_addr
        listener = network.listener(addr)
        transport = network.transport(addr)
    else:
        try:
            listener, transport = await _bind_gossip(config)
        except BaseException:
            store.close()
            raise

    gossip_addr = config.gossip.external_addr or listener.addr
    actor = Actor(
        id=store.site_id,
        addr=gossip_addr,
        ts=clock.new_timestamp(),
        cluster_id=ClusterId(config.gossip.cluster_id),
    )

    perf = config.perf
    tx_bcast, rx_bcast = bounded(perf.bcast_channel_len, "broadcast")
    tx_changes, rx_changes = bounded(perf.changes_channel_len, "changes")
    tx_apply, rx_apply = bounded(perf.apply_channel_len, "apply")

    members = Members()
    membership = Membership(
        actor,
        transport,
        SwimConfig(),
        rng=random.Random(actor.id.bytes16[:8].hex()),
    )
    transport.set_rtt_sink(members.observe_rtt)

    # instrumented-lock registry: bookie guards register here so the admin
    # `locks` command shows live holds (agent.rs:707-1066)
    from corrosion_tpu_torch.runtime.locks import LockRegistry

    lock_registry = LockRegistry()
    bookie = Bookie(registry=lock_registry)
    for aid in store.booked_actor_ids():
        bookie.insert(aid, store.load_booked_versions(aid))

    agent = Agent(
        lock_registry=lock_registry,
        actor=actor,
        config=config,
        store=store,
        bookie=bookie,
        clock=clock,
        members=members,
        membership=membership,
        transport=transport,
        listener=listener,
        tripwire=tripwire,
        tracker=TaskTracker(),
        tx_bcast=tx_bcast,
        rx_bcast=rx_bcast,
        tx_changes=tx_changes,
        rx_changes=rx_changes,
        tx_apply=tx_apply,
        rx_apply=rx_apply,
        # [sync] max_concurrent_snapshot_serves: the serve-side permit
        # pool is sized here, not in the dataclass default
        snapshot_serve_sem=asyncio.Semaphore(
            max(1, config.sync.max_concurrent_snapshot_serves)
        ),
    )

    # live-query + raw-update engines fed from every committed batch
    from corrosion_tpu_torch.pubsub import SubsManager, UpdatesManager

    agent.subs = SubsManager(
        store,
        config.db.subscriptions_path,
        batch_wait=config.pubsub.candidate_batch_wait,
        cfg=config.subs,
    )
    agent.updates = UpdatesManager(store)

    # r12 cluster observatory: telemetry digests piggyback the gossip
    # datagrams (hooks below) + broadcast envelopes (broadcast_loop);
    # received digests feed the anti-entropy store the catch-up plane's
    # gap heuristic and the divergence detector read
    if config.cluster.digests:
        from corrosion_tpu_torch.agent.observatory import Observatory

        agent.observatory = Observatory(agent)
        membership.digest_source = agent.observatory.pick_ext
        membership.on_digest = (
            lambda _src, data: agent.observatory.receive(data)
        )
    agent.change_hooks.append(agent.subs.match_changes)
    agent.change_hooks.append(agent.updates.match_changes)

    # SLO plane: per-stage latency objectives + error-budget burn
    from corrosion_tpu_torch.runtime.latency import SloMonitor

    agent.slo = SloMonitor(
        targets=config.slo.targets,
        objective=config.slo.objective,
        window_secs=config.slo.window_secs,
        breach_checks=config.slo.breach_checks,
    )

    # tail-based trace capture: stage spans buffer per trace and are
    # kept only on error / SLO breach / lottery (tracestore.py).
    # Process-global like the metrics registry: the first agent's config
    # wins when several share a process
    if config.trace.enabled:
        from corrosion_tpu_torch.runtime import tracestore

        tracestore.ensure(
            targets=config.slo.targets,
            lottery_n=config.trace.lottery_n,
            max_traces=config.trace.max_traces,
            max_spans_per_trace=config.trace.max_spans_per_trace,
            keep_max=config.trace.keep_max,
            idle_close_secs=config.trace.idle_close_secs,
        )

    # alerting plane: the TSDB sampler thread is process-global (first
    # agent's [tsdb] knobs win); the rule engine is per agent so its
    # health score reads THIS node's membership LHM and its summaries
    # ride THIS node's digests
    if config.tsdb.enabled and config.alerts.enabled:
        from corrosion_tpu_torch.agent.remediation import RemediationSupervisor
        from corrosion_tpu_torch.runtime import tsdb as _tsdb
        from corrosion_tpu_torch.runtime.alerts import AlertEngine

        db = _tsdb.ensure(
            sample_interval_secs=config.tsdb.sample_interval_secs,
            slots=config.tsdb.slots,
            max_series=config.tsdb.max_series,
        )
        agent.alerts = AlertEngine(tsdb=db, cfg=config.alerts, agent=agent)
        # remediation plane: always built beside the alert engine;
        # [remediation] enabled=false (the default kill switch) keeps it
        # observe-only (typed "would_act" events, no actions)
        agent.remediation = RemediationSupervisor(
            agent, cfg=config.remediation
        )

    # continuous profiling plane: the wall-clock stack sampler is
    # process-global like the TSDB (first agent's [profile] knobs win);
    # the loop thread registers itself in run() so samples carry
    # subsystem;task prefixes
    if config.profile.enabled:
        _rt_profiler.ensure(
            hz=config.profile.hz,
            shed_hz=config.profile.shed_hz,
            max_overhead_pct=config.profile.max_overhead_pct,
            window_secs=config.profile.window_secs,
            slots=config.profile.slots,
            max_stacks=config.profile.max_stacks,
        )

    # r14: local-commit group coalescer (concurrent writers share one
    # sqlite transaction; see GroupCommitter)
    agent.commit_group = GroupCommitter(agent)

    # SWIM notifications keep the member view current (handlers.rs:283-373)
    def on_notification(note: Notification, peer: Actor) -> None:
        if note == Notification.MEMBER_UP:
            agent.members.add_member(peer)
        elif note == Notification.MEMBER_DOWN:
            agent.members.remove_member(peer)
            if agent.membership.cluster_size <= 1:
                # SWIM view collapsed to self: wake the announcer NOW —
                # it may be mid-way through a 300 s steady-period sleep
                # chosen while the cluster was healthy (the r18 zombie
                # orphaning)
                agent.announce_wake.set()
        elif note == Notification.ACTIVE and peer.id == agent.actor.id:
            agent.actor = peer  # renewed identity after being declared down

    membership.on_notification = on_notification
    return agent


async def run(agent: Agent) -> None:
    """Start every loop; returns immediately (tasks run until tripwire)."""

    async def on_datagram(src: str, data: bytes) -> None:
        await agent.membership.handle_datagram(src, data)

    async def on_uni(src: str, frame: bytes) -> None:
        try:
            cv, cluster_id, dig = decode_uni_payload_ext(frame)
        except (ValueError, IndexError):
            METRICS.counter("corro.agent.uni.decode.failed").inc()
            return
        if cluster_id != agent.cluster_id:
            return
        if dig is not None and agent.observatory is not None:
            # r12: a telemetry digest rode the broadcast envelope ext —
            # adopt it even when the CHANGE is our own reflected back
            # (the relaying peer picked the digest, not the origin)
            agent.observatory.receive(dig)
        if cv.actor_id == agent.actor_id:
            return  # our own broadcast reflected back
        if cv.traceparent:
            # stitch the origin's span on the EAGER dissemination path
            # too (sync already adopts the SyncStart traceparent); the
            # traceparent stays ON the cv so a re-broadcast relays it.
            # stage="recv" buffers the hop marker with the trace in the
            # r19 tail sampler (which node saw the frame, at which hop)
            from corrosion_tpu_torch.runtime.trace import continue_from, meta_hop

            with continue_from(
                cv.traceparent, "broadcast.recv", peer=src,
                stage="recv", actor=str(agent.actor_id),
                hop=meta_hop(cv.trace_meta),
            ):
                agent.tx_changes.try_send((cv, ChangeSource.BROADCAST))
        else:
            agent.tx_changes.try_send((cv, ChangeSource.BROADCAST))

    async def on_bi(stream: BiStream) -> None:
        await serve_sync(agent, stream)

    # register THIS loop thread with the continuous profiler so its
    # samples resolve the running asyncio task name (here, on the loop
    # thread, because the mapping is tid -> loop)
    _prof = _rt_profiler.get()
    if _prof is not None:
        _prof.register_loop_coldpath()
    agent.listener.serve(on_datagram, on_uni, on_bi)
    agent.membership.start(agent.tripwire)
    if agent.subs is not None:
        await agent.subs.restore()  # setup.rs:296-349
    t = agent.tracker
    t.spawn(handle_changes(agent))
    t.spawn(apply_fully_buffered_loop(agent))
    t.spawn(broadcast_loop(agent))
    t.spawn(sync_loop(agent))
    t.spawn(_watchdog(agent))
    # member-state persistence + restart resurrection
    # (broadcast/mod.rs:814-949, util.rs:74-179)
    from corrosion_tpu_torch.agent.member_store import (
        member_states_loop,
        resurrect_and_schedule_rejoin,
    )

    t.spawn(member_states_loop(agent))
    t.spawn(resurrect_and_schedule_rejoin(agent))
    t.spawn(_announcer(agent))
    if agent.config.slo.canary:
        # opt-in end-to-end canary probe (r11): synthetic writes under a
        # self-subscription, continuously measuring true write→event
        # latency on the live cluster
        t.spawn(canary_loop(agent))
    if agent.observatory is not None:
        # r12: periodic digest build/dissemination + divergence checks
        from corrosion_tpu_torch.agent.observatory import observatory_loop

        t.spawn(observatory_loop(agent))
    if agent.alerts is not None:
        # rule evaluation over the TSDB (pending -> firing -> resolved)
        from corrosion_tpu_torch.runtime.alerts import alerts_loop

        t.spawn(alerts_loop(agent))
    if agent.remediation is not None:
        # the acting half: consume firings, drive actuators
        from corrosion_tpu_torch.agent.remediation import remediation_loop

        t.spawn(remediation_loop(agent))
    # db maintenance: WAL truncate ladder + incremental vacuum
    # (handlers.rs:379-547) — this is what makes perf.wal_threshold_gb live
    from corrosion_tpu_torch.store.maintenance import vacuum_loop, wal_maintenance_loop

    t.spawn(wal_maintenance_loop(agent))
    t.spawn(vacuum_loop(agent))
    # periodic per-table/gap/membership gauges (metrics.rs:18-108)
    from corrosion_tpu_torch.agent.agent_metrics import metrics_loop

    t.spawn(metrics_loop(agent))
    # event-loop lag/task gauges — tokio-metrics analog (agent.rs:29-63)
    from corrosion_tpu_torch.runtime import loopmon

    loopmon.start(t, agent.tripwire)
    # schedule fully-buffered applies for partials already complete on disk
    for actor_id, booked in agent.bookie.items().items():
        with booked.read() as bv:
            done = [v for v, p in bv.partials.items() if p.is_complete()]
        for version in done:
            agent.tx_apply.try_send((actor_id, version))


async def _watchdog(agent: Agent) -> None:
    """Lock-registry watchdog (setup.rs:188-246); ends on tripwire."""
    task = asyncio.ensure_future(agent.lock_registry.watchdog())
    await agent.tripwire.wait()
    task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await task


async def _announcer(agent: Agent) -> None:
    """Announce to resolved bootstrap addresses with FULL-JITTER backoff
    5 s → 120 s, then a steady 300 s re-announce (handlers.rs:197-248).
    Full jitter (runtime/backoff.py r9) instead of the old deterministic
    doubling: after a partition heal every isolated node's announce
    timer used to fire in the same beat — a synchronized rejoin storm at
    exactly the moment the survivors are busiest.  Bootstrap entries
    support `host:port[@dns_server]` (bootstrap.rs:60-156); an empty
    bootstrap list falls back to up to 5 random persisted members
    (bootstrap.rs:29-50)."""
    from corrosion_tpu_torch.agent.member_store import stored_bootstrap_addrs
    from corrosion_tpu_torch.net.dns import resolve_bootstrap
    from corrosion_tpu_torch.runtime.backoff import Backoff

    cfg = agent.membership.config

    def fresh_backoff():
        return iter(Backoff(
            min_interval=cfg.announce_backoff_start,
            max_interval=cfg.announce_backoff_max,
            factor=2.0, mode="full", retries=None,
        ))

    boff = fresh_backoff()
    while not agent.tripwire.tripped:
        if agent.config.gossip.bootstrap:
            addrs = await resolve_bootstrap(agent.config.gossip.bootstrap)
            if not addrs:
                log.warning(
                    "bootstrap list %r resolved to no addresses",
                    agent.config.gossip.bootstrap,
                )
        else:
            # no list configured: fall back to persisted members
            addrs = await asyncio.to_thread(
                stored_bootstrap_addrs, agent.store
            )
        for addr in addrs:
            if addr != agent.actor.addr:
                await agent.membership.announce(addr)
        if len(agent.members) > 0:
            delay = cfg.announce_steady_period
            # membership regained: the NEXT isolation restarts the
            # jittered ramp from the bottom instead of resuming capped
            boff = fresh_backoff()
        else:
            # floor keeps full jitter from hot-looping announces when
            # the draw lands near zero
            delay = max(0.05, next(boff))
        # sleep until delay, tripwire, OR the SWIM view collapsing to
        # self (announce_wake, set by on_notification): a steady-period
        # sleep chosen while healthy must not outlive the health it was
        # chosen under — the r18 zombie-node scenario caught an evicted
        # node sleeping silently through the rest of its 300 s period.
        # No wake is lost to the clear(): both the members check above
        # and this clear run without an intervening await, and
        # notifications only fire at await points.
        agent.announce_wake.clear()
        trip = asyncio.ensure_future(agent.tripwire.wait())
        wake = asyncio.ensure_future(agent.announce_wake.wait())
        try:
            await asyncio.wait(
                {trip, wake}, timeout=delay,
                return_when=asyncio.FIRST_COMPLETED,
            )
        finally:
            for t in (trip, wake):
                t.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await t


async def canary_loop(agent: Agent) -> None:
    """The SLO canary (r11): write one tiny synthetic row per interval
    to the canary table through the REAL public write path, watch it
    come back through a REAL self-subscription, and record the observed
    write→event latency — the ground-truth end-to-end measurement the
    per-stage `corro.e2e.*` histograms decompose.

    Every node keys its own row by actor id, so on a cluster each
    node's subscription also receives the OTHER nodes' canary updates:
    those measure true cross-node write→event latency from the origin
    wall stamp embedded in the row (scope="remote", skew-clamped).
    Each cycle also runs the agent's SloMonitor check, which is what
    arms the sustained-breach incident dump on a live cluster. Every
    row seen is counted in `agent.canary_seen`."""
    import time as _time

    from corrosion_tpu_torch.pubsub.matcher import SubDead
    from corrosion_tpu_torch.runtime.latency import e2e_observe
    from corrosion_tpu_torch.runtime.records import FLIGHT

    cfg = agent.config.slo
    table = cfg.canary_table

    def ensure_table() -> None:
        # additive re-apply: the schema engine diffs declaratively, so
        # the canary table must be appended to the FULL current schema
        # (not applied alone — that would unregister the user's tables)
        if table in agent.store.schema.tables:
            return
        parts = []
        for t in agent.store.schema.tables.values():
            parts.append(t.raw_sql.rstrip(";") + ";")
            for idx in t.indexes.values():
                parts.append(idx.raw_sql.rstrip(";") + ";")
        parts.append(
            f'CREATE TABLE "{table}" (src TEXT NOT NULL PRIMARY KEY,'
            " n INTEGER, wall REAL);"
        )
        agent.store.apply_schema_sql("\n".join(parts))

    try:
        await asyncio.to_thread(ensure_table)
        handle, _created = await agent.subs.get_or_insert(
            f'SELECT src, n, wall FROM "{table}"'
        )
    except Exception:
        log.exception("canary disabled: table/subscription setup failed")
        return
    q = handle.attach()
    src = str(agent.actor_id)
    n = 0
    loop = asyncio.get_running_loop()
    try:
        while not agent.tripwire.tripped:
            n += 1
            wall = _time.time()
            try:
                await make_broadcastable_changes(
                    agent,
                    lambda tx: [
                        tx.execute(
                            f'INSERT OR REPLACE INTO "{table}"'
                            " (src, n, wall) VALUES (?, ?, ?)",
                            [src, n, wall],
                        )
                    ],
                )
            except Exception:
                METRICS.counter("corro.slo.canary.missed.total").inc()
                await asyncio.sleep(cfg.canary_interval_secs)
                continue
            METRICS.counter("corro.slo.canary.writes.total").inc()
            # drain subscription events until our own row's event lands
            # (or the wait budget elapses → a miss); remote canary rows
            # observed along the way measure cross-node latency
            deadline = loop.time() + max(2.0, cfg.canary_interval_secs)
            got = False
            while not got:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(q.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if item is None or isinstance(item, SubDead):
                    return  # subscription torn down: canary ends
                for ev in item:
                    vals = ev.values
                    if len(vals) < 3:
                        continue
                    if vals[0] == src:
                        if vals[1] == n:
                            lat = _time.time() - wall
                            e2e_observe("canary", lat, scope="local")
                            METRICS.gauge(
                                "corro.slo.canary.last.seconds"
                            ).set(lat)
                            FLIGHT.record_host_frame(
                                "canary",
                                {"lat_us": int(lat * 1e6), "remote": 0},
                            )
                            agent.canary_seen["local"] += 1
                            got = True
                    elif vals[2]:
                        lat = e2e_observe(
                            "canary",
                            _time.time() - float(vals[2]),
                            scope="remote",
                        )
                        FLIGHT.record_host_frame(
                            "canary",
                            {"lat_us": int(lat * 1e6), "remote": 1},
                        )
                        agent.canary_seen["remote"] += 1
            if not got:
                METRICS.counter("corro.slo.canary.missed.total").inc()
            if agent.slo is not None:
                agent.slo.check()
            remain = (wall + cfg.canary_interval_secs) - _time.time()
            if remain > 0:
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(agent.tripwire.wait(), remain)
    finally:
        handle.detach(q)


async def shutdown(agent: Agent) -> None:
    """Graceful: leave the cluster, trip, drain counted tasks ≤60 s."""
    with contextlib.suppress(Exception):
        await agent.membership.leave()
    agent.tripwire.trip()
    if agent.subs is not None:
        await agent.subs.stop_all()
    if agent.updates is not None:
        await agent.updates.stop_all()
    agent.tx_changes.close()
    agent.tx_bcast.close()
    agent.tx_apply.close()
    await agent.membership.stop()
    await agent.tracker.wait_all(timeout=60.0)
    await agent.transport.close()
    await agent.listener.close()
    if agent.commit_group is not None:
        # r24: join the dedicated committer thread BEFORE the store
        # closes under it (an in-flight commit finishes; new submits
        # get a typed refusal instead of racing the close)
        agent.commit_group.close()
    agent.store.close()


# -- local write path ------------------------------------------------------


@dataclass
class ExecResult:
    rows_affected: int
    results: List[object]
    version: int  # db_version assigned (0 = no changes)


def _cancelled_error() -> BaseException:
    return asyncio.CancelledError("group leader cancelled before commit")


def _count_write_error(e: BaseException) -> None:
    """Typed store-fault accounting on the local write path: every
    sqlite-level writer failure (sick disk: SQLITE_BUSY, I/O errors;
    real or chaos-injected — both raise the same typed error) lands in
    `corro.store.write.errors.total{kind=}`, the series the
    `store-faults` alert rule (runtime/alerts.py) watches."""
    import sqlite3 as _sqlite3

    if not isinstance(e, _sqlite3.Error):
        return
    msg = str(e).lower()
    if "locked" in msg or "busy" in msg:
        kind = "busy"
    elif "i/o" in msg or "disk" in msg:
        kind = "io"
    else:
        kind = "other"
    METRICS.counter("corro.store.write.errors.total", kind=kind).inc()


def _pending_row_bytes(r) -> int:
    """Rough wire-size of one captured-cell row — (tbl, pk, cid, val)
    tuples since r15's in-memory direct capture (the group byte budget:
    Change.estimated_byte_size before the Change exists)."""
    val = r[3]
    return 48 + len(r[1]) + (
        len(val) if isinstance(val, (str, bytes)) else 8
    )


def _group_fanout_enabled(perf) -> bool:
    """r21 per-group fanout gate: `[perf] group_fanout` config, with the
    CORRO_GROUP_FANOUT env var overriding for bench A/B axes (mirrors
    CORRO_CAPTURE / CORRO_FINALIZE — the pre rung runs the per-tx
    post-commit path in the same process tree)."""
    env = os.environ.get("CORRO_GROUP_FANOUT")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off")
    return getattr(perf, "group_fanout", True)


def _committer_thread_enabled(perf) -> bool:
    """r24 dedicated-committer gate: `[perf] committer_thread` config,
    with the CORRO_COMMITTER env var overriding for bench A/B axes
    (mirrors CORRO_GROUP_FANOUT — `to_thread`/`0` restores the
    per-batch `asyncio.to_thread` hop as the r24 pre mode)."""
    env = os.environ.get("CORRO_COMMITTER")
    if env is not None:
        return env.strip().lower() not in (
            "0", "false", "no", "off", "to_thread"
        )
    return getattr(perf, "committer_thread", True)


class _CommitterThread:
    """One long-lived commit thread per store (r24, write-path round 4).

    The r14–r23 path paid one `asyncio.to_thread` per batch: an
    executor submit, a work-queue wakeup, a wrapper future and a
    context copy — measured as the `to_thread_hop`+`asyncio_dispatch`
    share (~37%) of the solo-writer wall in WRITE_PROFILE.json.  Here
    the leader hands the batch over lock-free — a plain `deque.append`
    (GIL-atomic) plus one `threading.Event` set — and parks on an
    asyncio future; the committer drains whole entries in one dequeue
    pass and resolves the parked future with a single
    `loop.call_soon_threadsafe` wakeup.

    Backpressure is unchanged by design: the leader still holds the
    priority write gate for the whole commit, so a wedged committer
    surfaces exactly like a wedged `to_thread` commit did — writers
    queue behind the gate and the existing admission machinery turns
    overload into typed refusals, never a new unbounded hang.  The
    thread is named `corro-committer` so the continuous profiler's
    `_NAME_TAGS` table classifies its samples under the `committer`
    subsystem."""

    def __init__(self, run: Callable):
        self._run = run  # _commit_batch: called on the thread, may raise
        self._q: deque = deque()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def submit(self, loop, batch) -> asyncio.Future:
        """Enqueue one batch (event-loop thread only); returns the
        future the leader parks on.  Lazily starts the thread so agents
        on the `to_thread` path never own an idle thread."""
        import time as _time

        fut = loop.create_future()
        t = self._thread
        if t is None or not t.is_alive():
            if self._stop:  # closed at shutdown: refuse, don't strand
                fut.set_exception(
                    RuntimeError("committer thread is shut down")
                )
                return fut
            self._thread = threading.Thread(
                target=self._main, name="corro-committer", daemon=True
            )
            self._thread.start()
        self._q.append((loop, fut, batch, _time.monotonic()))
        METRICS.gauge("corro.write.committer.queue.depth").set(
            len(self._q)
        )
        self._wake.set()
        return fut

    def close(self, timeout: float = 5.0) -> None:
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _main(self) -> None:
        import time as _time

        q = self._q
        while True:
            self._wake.wait()
            self._wake.clear()
            while q:
                loop, fut, batch, enq = q.popleft()
                METRICS.histogram(
                    "corro.write.committer.handoff.seconds"
                ).observe(_time.monotonic() - enq)
                try:
                    self._run(batch)
                except BaseException as e:
                    err: Optional[BaseException] = e
                else:
                    err = None
                self._resolve(loop, fut, err)
            if self._stop:
                return

    @staticmethod
    def _resolve(loop, fut, err: Optional[BaseException]) -> None:
        def _settle() -> None:
            if fut.done():
                return  # leader's loop died mid-commit; commit stands
            if err is None:
                fut.set_result(None)
            else:
                fut.set_exception(err)

        try:
            loop.call_soon_threadsafe(_settle)
        except RuntimeError:
            # the loop closed under us (hard shutdown): the sqlite
            # commit itself stands — there is nobody left to tell
            pass


@dataclass
class _GroupItem:
    """One writer's slot in a commit group."""

    fn: Callable
    ts: Timestamp  # HLC timestamp of this writer's WriteTx
    fut: asyncio.Future
    enq: float  # monotonic submit time (group wait metric)
    results: Optional[List[object]] = None
    changes: Optional[list] = None
    db_version: int = 0
    last_seq: int = 0
    error: Optional[BaseException] = None
    # r21 per-group fanout: the writer's trace context rides the item
    # so the LEADER can run the whole batch's post-commit block
    traceparent: Optional[str] = None
    write_span: Optional[object] = None
    # True once the leader's single fanout pass covered this tx's
    # hooks+chunk+broadcast (the caller must then skip its own block)
    fanned: bool = False
    # r23 write-profile stamps (monotonic): the leader/commit thread
    # fill these so submit() can attribute the full submit→resolve wall
    # across {asyncio dispatch, write gate, handoff, finalize,
    # sqlite flush} (corro.write.profile.seconds → WRITE_PROFILE.json)
    gate_start: float = 0.0
    gate_acq: float = 0.0
    dispatch: float = 0.0
    thread_start: float = 0.0
    thread_done: float = 0.0
    finalize_secs: float = 0.0
    flush_secs: float = 0.0


class GroupCommitter:
    """Coalesces concurrent local write transactions into shared sqlite
    commits (r14 write-path round).

    Before: every `/v1/transactions` caller ran its own
    BEGIN IMMEDIATE..COMMIT behind the priority write gate — N
    concurrent writers paid N sequential fsyncs, N store-lock holds and
    N bookkeeping rounds.  Now the first caller becomes the LEADER:
    while its batch commits on a worker thread, later callers enqueue;
    the next batch takes them ALL into one transaction (consecutive
    db_versions inside one BEGIN/COMMIT, one gap-store/bookie round for
    the whole group).  Each writer runs in its own SAVEPOINT
    (`WriteTx(nested=True)`), so a failed statement aborts only its own
    sub-tx and surfaces only to its own caller.  A solo writer's batch
    is size 1 and commits immediately — p50 latency of an uncontended
    write is unchanged (`perf.group_commit_wait` > 0 opts into an extra
    coalescing window).  `perf.group_commit_max_writers` /
    `group_commit_max_bytes` bound one shared transaction.
    """

    def __init__(self, agent: Agent):
        self.agent = agent
        self._pending: "deque[_GroupItem]" = deque()
        self._leader = False
        # the in-flight r21 fanout task: at most ONE batch's post-commit
        # fanout runs detached (overlapping the NEXT batch's commit
        # thread); the leader awaits it before scheduling another, so a
        # slow broadcast plane backpressures commits instead of piling
        # unfinished fanouts
        self._fanout_job: Optional[asyncio.Future] = None
        # r24: the dedicated committer thread (lazily started on the
        # first thread-mode batch; close() joins it at shutdown)
        self._committer = _CommitterThread(self._commit_batch)

    def close(self) -> None:
        """Stop the committer thread (agent shutdown)."""
        self._committer.close()

    async def submit(
        self,
        fn: Callable,
        traceparent: Optional[str] = None,
        write_span=None,
    ) -> _GroupItem:
        """Enqueue one writer; returns its completed item (or raises its
        own sub-tx failure).  Runs on the agent's event loop.

        The first free caller leads INLINE (no task hop: a solo writer
        pays zero extra scheduling round-trips over the old per-writer
        path); followers enqueue and await.  If the inline leader is
        cancelled mid-drain, leadership detaches to a task so followers
        can never strand."""
        import time as _time

        loop = asyncio.get_running_loop()
        item = _GroupItem(
            fn=fn,
            ts=self.agent.clock.new_timestamp(),
            fut=loop.create_future(),
            enq=_time.monotonic(),
            traceparent=traceparent,
            write_span=write_span,
        )
        self._pending.append(item)
        if not self._leader:
            self._leader = True
            try:
                await self._lead()
            finally:
                self._release_leadership()
        res = await item.fut
        # bank the five-bucket wall attribution when the continuous
        # profiler is installed (one global None-check otherwise)
        if _rt_profiler.installed():
            _rt_profiler.record_write_buckets(
                enq=item.enq,
                gate_start=item.gate_start,
                gate_acq=item.gate_acq,
                dispatch=item.dispatch,
                thread_start=item.thread_start,
                thread_done=item.thread_done,
                resolved=_time.monotonic(),
                finalize_secs=item.finalize_secs,
            )
        return res

    def _release_leadership(self) -> None:
        self._leader = False
        if self._pending:
            # arrivals raced the drain check (or the leader died with
            # waiters queued): hand leadership to a detached task
            self._leader = True
            asyncio.ensure_future(self._lead_detached())

    async def _lead_detached(self) -> None:
        try:
            await self._lead()
        finally:
            self._release_leadership()

    async def _lead(self) -> None:
        import time as _time

        agent = self.agent
        perf = agent.config.perf
        amortized = _group_fanout_enabled(perf)
        while self._pending:
            if amortized:
                # one loop pass before gathering (r21, gated with the
                # rest of the per-group amortization): writers settled
                # by the previous batch have their wakeups queued
                # BEHIND this coroutine (the new leader is simply
                # whichever of them ran first), and without the yield
                # the leader commits a batch of one while its
                # just-woken peers re-enqueue a batch too late — steady
                # state alternates full and size-1 batches.  An
                # actually-solo writer pays one ready-queue pass (~µs),
                # not a timed wait.
                await asyncio.sleep(0)
            batch: List[_GroupItem] = []
            commit_job = None
            t_gate = _time.monotonic()  # r23 write-profile stamp
            try:
                async with agent.write_gate.priority():
                    t_acq = _time.monotonic()
                    if (
                        perf.group_commit_wait > 0
                        and len(self._pending) == 1
                    ):
                        # opt-in window for bursty single writers
                        await asyncio.sleep(perf.group_commit_wait)
                    while (
                        self._pending
                        and len(batch) < perf.group_commit_max_writers
                    ):
                        batch.append(self._pending.popleft())
                    t_dispatch = _time.monotonic()
                    for it in batch:
                        it.gate_start = t_gate
                        it.gate_acq = t_acq
                        it.dispatch = t_dispatch
                    if _committer_thread_enabled(perf):
                        # r24: lock-free handoff to the long-lived
                        # committer thread — no executor submit, no
                        # wrapper task, one loop wakeup on completion
                        commit_job = self._committer.submit(
                            asyncio.get_running_loop(), batch
                        )
                    else:
                        commit_job = asyncio.ensure_future(
                            asyncio.to_thread(self._commit_batch, batch)
                        )
                    # shielded: a cancelled leader must not abandon a
                    # commit thread mid-flight (the store lock, not this
                    # gate, is the true sqlite guard)
                    await asyncio.shield(commit_job)
            except asyncio.CancelledError:
                if commit_job is not None:
                    # the thread finishes on its own; finish the batch
                    # from its outcome so no follower ever strands
                    commit_job.add_done_callback(
                        lambda job, b=batch: asyncio.ensure_future(
                            self._finish_batch(b, job.exception())
                        )
                    )
                else:
                    self._settle(batch, _cancelled_error())
                raise
            except BaseException as e:
                if not batch and self._pending:
                    # the gate itself failed: fail one waiter, not none,
                    # so the loop cannot spin without progress
                    batch = [self._pending.popleft()]
                self._settle(batch, e)
                continue
            await self._finish_batch(batch, None)

    async def _finish_batch(
        self, batch: List[_GroupItem], error: Optional[BaseException]
    ) -> None:
        """Post-commit half on the event loop: settle every writer's
        future FIRST (marking committed items fanned, so their callers
        return without any per-tx post-commit block), then run the
        group's single fanout pass as a one-deep pipelined task — it
        executes on the loop while the NEXT batch's commit occupies the
        worker thread, preserving the thread/loop overlap the per-tx
        path had (settling after an inline fanout serialized the two
        and LOST throughput at w16)."""
        committed: List[_GroupItem] = []
        if error is None and _group_fanout_enabled(self.agent.config.perf):
            committed = [
                it for it in batch if it.error is None and it.changes
            ]
            for it in committed:
                it.fanned = True
        self._settle(batch, error)
        if committed:
            prev, self._fanout_job = self._fanout_job, None
            if prev is not None:
                await prev
            self._fanout_job = asyncio.ensure_future(
                self._fanout(committed)
            )

    async def _fanout(self, committed: List[_GroupItem]) -> None:
        """ONE post-commit loop re-entry for the whole group (r21): a
        single origin stamp, one amortized hooks flush, one chunk pass
        over the wire cells finalize already stamped, and one channel
        round — instead of every follower paying its own hooks + chunk
        + per-chunk `tx_bcast.send` block after its future resolves
        (~0.4 ms/tx of loop bookkeeping at w16 in the r15 profile).
        Runs detached after the writers' futures settled: a failure
        here (realistically ChannelClosed at shutdown) cannot reach the
        callers — their commits stand — so it is logged, not raised."""
        import time as _time

        agent = self.agent
        try:
            from corrosion_tpu_torch.runtime import tracestore
            from corrosion_tpu_torch.runtime.trace import make_meta

            st = tracestore.store()
            origin_wall = _time.time()
            hook_batches: List[tuple] = []
            inputs: List[BroadcastInput] = []
            for it in committed:
                trace_meta = None
                if it.write_span is not None and st is not None:
                    it.write_span.attrs["table"] = it.changes[0].table
                    trace_meta = make_meta(
                        forced=st.head_forced(it.write_span.ctx.trace_id)
                    )
                hook_batches.append(
                    (it.changes, it.traceparent, trace_meta)
                )
                inputs.extend(
                    BroadcastInput(change=cv, is_local=True)
                    for cv in chunked_change_v1(
                        agent.actor_id, it.db_version, it.changes,
                        it.last_seq, it.ts, origin_ts=origin_wall,
                        traceparent=it.traceparent, trace_meta=trace_meta,
                    )
                )
            agent.notify_change_hooks_group(hook_batches, origin_wall)
            await agent.tx_bcast.send_many(inputs)
            METRICS.counter(
                "corro.write.group.amortized.flush.total"
            ).inc()
            METRICS.counter("corro.write.group.amortized.txs.total").inc(
                len(committed)
            )
        except asyncio.CancelledError:
            raise
        except BaseException:
            log.warning(
                "group fanout failed for %d committed tx(s); commits "
                "stand, broadcast/hooks for the batch were lost",
                len(committed), exc_info=True,
            )

    def _settle(
        self, batch: List[_GroupItem], error: Optional[BaseException]
    ) -> None:
        """Resolve a batch's futures: committed items succeed, items
        whose own sub-tx failed get their error, uncommitted items
        inherit the batch-level failure."""
        for it in batch:
            if it.error is None and it.changes is None and error is not None:
                it.error = error
            if it.fut.done():
                continue  # caller cancelled; the commit stands
            if it.error is not None:
                it.fut.set_exception(it.error)
            else:
                it.fut.set_result(it)

    def _commit_batch(self, batch: List[_GroupItem]) -> None:
        """Worker-thread half: run every writer's statements + finalize
        inside shared transactions, then ONE bookkeeping round for all
        committed versions."""
        import time as _time

        agent = self.agent
        store = agent.store
        max_bytes = agent.config.perf.group_commit_max_bytes
        booked = agent.bookie.ensure(agent.actor_id)
        committed: List[_GroupItem] = []
        t_thread = _time.monotonic()  # r23: the commit-thread handoff landed
        # a SOLO batch skips the per-writer savepoint (r15): with one
        # writer there are no batchmates to isolate, and its failure
        # aborts the whole group tx below — the uncontended fast path
        # saves the SAVEPOINT/RELEASE round-trip on every solo commit
        use_sp = len(batch) > 1
        with booked.write("group_commit") as bv:
            i = 0
            while i < len(batch):
                group: List[tuple] = []  # (item, captured pending rows)
                used = 0
                try:
                    with store.group_tx():
                        while i < len(batch):
                            item = batch[i]
                            i += 1
                            try:
                                with store.write_tx(
                                    item.ts, nested=True, savepoint=use_sp
                                ) as tx:
                                    item.results = item.fn(tx)
                                    pending = tx.commit_deferred()
                            except BaseException as e:
                                item.error = e
                                _count_write_error(e)
                                if not use_sp:
                                    # savepoint-free sub-tx: the shared
                                    # transaction is poisoned — abort it
                                    raise
                                continue
                            group.append((item, pending))
                            used += sum(
                                _pending_row_bytes(r) for r in pending
                            )
                            if used >= max_bytes:
                                break
                        # ONE vectorized finalize + flush for the whole
                        # group (consecutive db_versions assigned inside)
                        t0 = _time.monotonic()
                        finalized = store.finalize_group(
                            [(p, it.ts) for it, p in group]
                        )
                        fin_dur = _time.monotonic() - t0
                        METRICS.histogram(
                            "corro.write.finalize.seconds"
                        ).observe(fin_dur)
                        fin_share = fin_dur / max(1, len(group))
                        for (it, _p), (changes, dv, last_seq) in zip(
                            group, finalized
                        ):
                            it.changes = changes
                            it.db_version = dv
                            it.last_seq = last_seq
                            it.finalize_secs = fin_share
                except BaseException as e:
                    # the shared finalize/COMMIT died: every sub-tx in
                    # this group rolled back with it (a failed
                    # savepoint-free solo writer keeps its OWN error)
                    if not any(it.error is e for it in batch):
                        _count_write_error(e)  # group-level fault
                    for it, _p in group:
                        if it.error is None:
                            it.error = e
                        it.changes = None
                        it.db_version = 0
                    continue
                committed.extend(it for it, _p in group)
                # r23: per-item share of the group's COMMIT flush wall
                # (crdt.group_tx stamps last_flush_secs on exit)
                flush_share = store.last_flush_secs / max(1, len(group))
                for it, _p in group:
                    it.flush_secs = flush_share
                METRICS.histogram("corro.write.group.size").observe(
                    len(group)
                )
            versions = RangeSet()
            if any(it.db_version for it in committed):
                for it in committed:
                    if it.db_version:
                        versions.insert(it.db_version, it.db_version)
                snap = bv.snapshot()
                snap.insert_db(store.gap_store(), versions)
                bv.commit_snapshot(snap)
        now = _time.monotonic()
        for it in committed:
            it.thread_start = t_thread
            it.thread_done = now
            METRICS.histogram("corro.write.group.wait.seconds").observe(
                now - it.enq
            )


async def make_broadcastable_changes(
    agent: Agent, fn: Callable[["object"], List[object]]
) -> ExecResult:
    """Run local statements in one write tx, then broadcast the committed
    changes (the `/v1/transactions` path, api/public/mod.rs:57-258).

    `fn(tx)` executes statements against the WriteTx and returns
    per-statement results.
    """
    from corrosion_tpu_torch.runtime.trace import span

    # one ROOT span per local write: its W3C context rides the broadcast
    # envelope so remote applies stitch to this trace (r11 — the eager
    # path's counterpart of the SyncStart traceparent); stage="write"
    # routes it into the r19 tail sampler when one is configured
    with span(
        "write.local", stage="write", actor=str(agent.actor_id)
    ) as write_span:
        return await _make_broadcastable_changes_inner(
            agent, fn, write_span.ctx.traceparent(), write_span
        )


async def _make_broadcastable_changes_inner(
    agent: Agent, fn: Callable[["object"], List[object]], traceparent: str,
    write_span=None,
) -> ExecResult:
    import time as _time

    gc = agent.commit_group
    if gc is not None and agent.config.perf.group_commit:
        item = await gc.submit(fn, traceparent=traceparent,
                               write_span=write_span)
        results, changes = item.results, item.changes
        db_version, last_seq, ts = item.db_version, item.last_seq, item.ts
        if item.fanned:
            # r21: the group leader's single fanout pass already ran
            # this tx's hooks + chunk + broadcast block — return
            # straight to the caller with zero per-tx loop work
            rows = sum(r for r in _int_results(results))
            return ExecResult(
                rows_affected=rows, results=results, version=db_version
            )
    else:
        # solo path (group commit disabled): per-writer gate + commit —
        # local client writes take the PRIORITY lane (agent.rs:586)
        async with agent.write_gate.priority():
            ts = agent.clock.new_timestamp()
            booked = agent.bookie.ensure(agent.actor_id)

            def txn() -> Tuple[List[object], list, int, int]:
                with booked.write("make_broadcastable_changes"):
                    with agent.store.write_tx(ts) as tx:
                        results = fn(tx)
                        changes, db_version, last_seq = tx.commit()
                    if db_version:
                        agent.store.record_last_seq(
                            agent.actor_id, db_version, last_seq
                        )
                    with booked.write("commit bookkeeping") as bv:
                        if db_version:
                            snap = bv.snapshot()
                            snap.insert_db(
                                agent.store.gap_store(),
                                RangeSet([(db_version, db_version)]),
                            )
                            bv.commit_snapshot(snap)
                    return results, changes, db_version, last_seq

            try:
                results, changes, db_version, last_seq = (
                    await asyncio.to_thread(txn)
                )
            except BaseException as e:
                _count_write_error(e)
                raise

    if changes:
        # the ORIGIN stamp: wall clock at local commit — every
        # corro.e2e.* stage downstream measures against this instant
        origin_wall = _time.time()
        # r19 trace meta: the origin's cached head decision (lottery on
        # the trace id) rides the envelope so every node on the path
        # keeps the same trace without coordination; hop starts at 0
        trace_meta = None
        if write_span is not None:
            from corrosion_tpu_torch.runtime import tracestore
            from corrosion_tpu_torch.runtime.trace import make_meta

            st = tracestore.store()
            if st is not None:
                write_span.attrs["table"] = changes[0].table
                trace_meta = make_meta(
                    forced=st.head_forced(write_span.ctx.trace_id)
                )
        agent.notify_change_hooks(
            changes, origin_wall, traceparent=traceparent,
            trace_meta=trace_meta,
        )
        # encode-once, spliced (r16): each chunk's body is assembled
        # from the wire_cell bytes finalize_group already stamped — one
        # header/tail pack + a join per chunk, no per-value re-walk
        # (byte-identity with the r14 with_wire_body path pinned in
        # test_codec.py); broadcast and every re-transmission/relay
        # wrap the shared bytes
        for cv in chunked_change_v1(
            agent.actor_id, db_version, changes, last_seq, ts,
            origin_ts=origin_wall, traceparent=traceparent,
            trace_meta=trace_meta,
        ):
            await agent.tx_bcast.send(BroadcastInput(change=cv, is_local=True))
    rows = sum(r for r in _int_results(results))
    return ExecResult(rows_affected=rows, results=results, version=db_version)


def _int_results(results: List[object]):
    for r in results:
        if isinstance(r, int):
            yield r
