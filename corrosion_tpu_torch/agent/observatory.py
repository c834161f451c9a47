"""Cluster observatory: digest anti-entropy + the view-divergence
(split-brain) detector (r12).

Every observability plane before this one was node-local: answering
"how is the CLUSTER doing" meant scraping N agents.  The observatory
closes that gap with the machinery the cluster already runs — each node
periodically builds a compact `NodeDigest` (runtime/digest.py) and
piggybacks it on the gossip datagrams (`Membership` ext hook) and the
broadcast envelopes (`agent/broadcast.py`); received digests are kept
freshest-per-node and RELAYED with the same infection-style
transmission budget membership updates get, so every node converges on
every node's digest without any new connection, poll loop, or central
scraper.  On top of the aggregated store:

- `GET /v1/cluster` (api/http.py) serves cluster-merged write→event
  stage percentiles (exact: the digests carry mergeable histograms),
  a per-node health roll-up, and digest coverage/staleness — from ANY
  single node.
- the divergence detector compares the canonical membership-view
  hashes the digests carry: nodes that disagree about who is in the
  cluster (or that went digest-silent while still held ACTIVE) are a
  partition/split-brain observable (`corro.cluster.divergence.*`), and
  a divergence sustained for `divergence_checks` consecutive checks
  trips ONE flight-recorder incident dump per episode — the standing
  pview split-brain failure class, made a first-class page.

Load tolerance: a 1-core host that deschedules this whole process
would, on resume, see every peer's digest as "old" at once.  The loop
therefore tracks its own wakeup lag and suppresses the SILENCE signal
for rounds where it was itself late (the Lifeguard discipline of r9:
never turn your own sickness into accusations of peers); the view-hash
comparison is timing-free and stays armed.

The port's copy of `corrosion_tpu/agent/observatory.py`. The port's
HTTP API (`api/http.py`) serves `cluster_report` at `GET /v1/cluster`,
`cluster_alerts` at `GET /v1/alerts?scope=cluster` and
`cluster_hotspots` at `GET /v1/profile?scope=cluster`. What differs: the
port has no continuous profiler or alert engine yet (ROADMAP §1 item
9.5), so a port digest's hotspot and alert blocks are empty
(`agent.alerts` stays None), as a JAX node's are with those planes off.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from corrosion_tpu_torch.runtime import latency as lat
from corrosion_tpu_torch.runtime.digest import (
    NodeDigest,
    decode_digest,
    encode_digest,
    merge_stage_hists,
    view_hash,
)
from corrosion_tpu_torch.runtime.metrics import METRICS, kernel_event_totals
from corrosion_tpu_torch.runtime.records import FLIGHT
from corrosion_tpu_torch.types.actor import ActorId

log = logging.getLogger(__name__)

# gossip-ext byte overhead on top of the encoded digest (version byte +
# u32 length prefix, net/gossip_codec.py / types/codec.py ext v2)
_EXT_OVERHEAD = 8


@dataclass
class _Held:
    digest: NodeDigest
    encoded: bytes
    sends_left: int
    received_mono: float  # LOCAL receipt/build clock — staleness basis


class Observatory:
    """One agent's digest store + divergence tracker.

    Thread contract: `build_and_store` runs on a WORKER thread
    (observatory_loop's `asyncio.to_thread` — the bookie read locks and
    histogram encodes must not stall the loop) while `receive` /
    `pick_ext` mutate the same digest store from transport callbacks on
    the event loop, and `cluster_report` iterates it from the API
    handler.  Every `_store`/`_seq` touch therefore holds `_lock` (the
    r7 metrics-lock discipline); the divergence episode counters are
    loop-only and stay lock-free."""

    def __init__(self, agent):
        self.agent = agent
        self.cfg = agent.config.cluster
        self._lock = threading.Lock()
        self._store: Dict[bytes, _Held] = {}
        self._seq = 0
        self._pick_rr = 0
        self._div_streak = 0
        self._clean_streak = 0
        self._episode_open = False
        self._episodes = 0
        self._last_wake: Optional[float] = None
        self._self_lagged = False
        self._armed = True

    def disarm(self) -> None:
        """Stop opening/closing divergence episodes (checks still
        report).  Called before a planned teardown — peers winding down
        one by one otherwise read as a silence divergence in the gap
        between their last digest and their LEAVE propagating."""
        self._armed = False

    # -- knobs -------------------------------------------------------------

    @property
    def silent_after(self) -> float:
        if self.cfg.silent_after_secs > 0:
            return self.cfg.silent_after_secs
        return self.cfg.silent_after_mult * self.cfg.digest_interval_secs

    # -- building ----------------------------------------------------------

    def snapshot_local(self) -> NodeDigest:
        """Build this node's digest from the planes it already runs.
        Registry reads are non-mutating snapshots; the bookie read locks
        are brief (same pattern as the sync scheduler)."""
        mship = self.agent.membership
        from corrosion_tpu_torch.agent.membership import MemberState

        members = list(mship.members.values())
        active_ids = [self.agent.actor_id.bytes16] + [
            m.actor.id.bytes16
            for m in members
            if m.state != MemberState.DOWN
        ]
        alive = 1 + sum(1 for m in members if m.state == MemberState.ALIVE)
        suspect = sum(1 for m in members if m.state == MemberState.SUSPECT)

        backlog: Dict[bytes, int] = {}
        heads_total = 0  # r17: versions held, the catch-up freshness ad
        for aid, booked in self.agent.bookie.items().items():
            with booked.read() as bv:
                need = sum(e - s + 1 for s, e in bv.needed)
                need += sum(
                    1 for p in bv.partials.values() if not p.is_complete()
                )
                heads_total += (bv.last() or 0) - need
            if need:
                backlog[aid.bytes16] = need

        loop_lag = 0.0
        for kind, name, _labels, value in METRICS.snapshot():
            if kind == "gauge" and name == "corro.runtime.loop.lag.max.seconds":
                loop_lag = max(loop_lag, value)

        events: Dict[str, int] = {}
        for _kernel, by_event in kernel_event_totals(METRICS).items():
            for ev, v in by_event.items():
                events[ev] = events.get(ev, 0) + int(v)

        # r20: the node's active alerts ride the digest so any node can
        # serve the cluster alert view (bounded, firing-first)
        eng = getattr(self.agent, "alerts", None)
        alerts = eng.active_summaries() if eng is not None else []

        # r23: the node's top self-time profile frames would ride here;
        # the port has no profiler, so the block is empty (a JAX node
        # with `profile.enabled = false` sends the same)
        hotspots: List[dict] = []

        with self._lock:
            self._seq += 1
            seq = self._seq
        return NodeDigest(
            actor_id=self.agent.actor_id.bytes16,
            seq=seq,
            wall=time.time(),
            view_hash=view_hash(active_ids),
            view_size=len(active_ids),
            alive=alive,
            suspect=suspect,
            downed=len(mship.downed),
            lhm=mship.lhm,
            loop_lag=loop_lag,
            sync_backlog=backlog,
            heads_total=max(0, heads_total),
            alerts=alerts,
            hotspots=hotspots,
            events=events,
            stages=lat.stage_hists(window_secs=None),
        )

    def advertised_heads(self) -> Dict[bytes, int]:
        """actor id -> that node's digest-advertised `heads_total` —
        the r17 catch-up plane's freshness map (peer-choice bias +
        snapshot-bootstrap gap estimate).  Lock: vs the worker-thread
        builder."""
        with self._lock:
            return {
                aid: held.digest.heads_total
                for aid, held in self._store.items()
            }

    def build_and_store(self) -> NodeDigest:
        """Refresh the local digest and queue it for dissemination with
        a full infection-style transmission budget.

        The digest must FIT the gossip plane or it never ships: pick_ext
        skips anything over the frame's leftover budget, and since the
        stage histograms are cumulative the overflow is permanent once
        crossed — with an open divergence episode inflating the alert
        block, oversize is self-sustaining (no digests → silence →
        episode stays open → alert block stays on).  Degrade tiers keep
        the view/census core shipping: drop the profile hotspots first
        (r23 — flamegraph color, never load-bearing), then the
        non-total stage histograms, then all stages/events and the
        alert tail."""
        d = self.snapshot_local()
        enc = encode_digest(d)
        if len(enc) > self.cfg.max_wire_bytes and d.hotspots:
            d.hotspots = []
            enc = encode_digest(d)
            METRICS.counter(
                "corro.digest.degraded.total", level="profile"
            ).inc()
        if len(enc) > self.cfg.max_wire_bytes:
            d.stages = {k: v for k, v in d.stages.items() if k == "total"}
            enc = encode_digest(d)
            METRICS.counter(
                "corro.digest.degraded.total", level="stages"
            ).inc()
            if len(enc) > self.cfg.max_wire_bytes:
                d.stages = {}
                d.events = {}
                d.alerts = d.alerts[:3]
                enc = encode_digest(d)
                METRICS.counter(
                    "corro.digest.degraded.total", level="census"
                ).inc()
        with self._lock:
            self._store[d.actor_id] = _Held(
                digest=d,
                encoded=enc,
                sends_left=self._transmissions(),
                received_mono=time.monotonic(),
            )
            nodes = len(self._store)
        METRICS.counter("corro.digest.built.total").inc()
        METRICS.gauge("corro.digest.size.bytes").set(len(enc))
        METRICS.gauge("corro.digest.nodes").set(nodes)
        return d

    def _transmissions(self) -> int:
        return self.agent.membership.config.max_transmissions(
            self.agent.membership.cluster_size
        )

    # -- dissemination -----------------------------------------------------

    def pick_ext(self, budget: int, plane: str = "gossip") -> Optional[bytes]:
        """One digest that still has sends left and fits `budget`
        encoded bytes, round-robin across nodes (own digest and relays
        compete equally — the same epidemic fairness the membership
        piggyback uses).  Returns the encoded bytes or None."""
        if not self.cfg.digests or not self._store:
            return None
        skipped_oversize = False
        picked = None
        with self._lock:  # vs build_and_store on the worker thread
            keys = sorted(self._store)
            n = len(keys)
            for i in range(n):
                held = self._store[keys[(self._pick_rr + i) % n]]
                if held.sends_left <= 0:
                    continue
                if len(held.encoded) + _EXT_OVERHEAD > budget:
                    skipped_oversize = True
                    continue
                self._pick_rr = (self._pick_rr + i + 1) % n
                held.sends_left -= 1
                picked = held.encoded
                break
        if picked is not None:
            METRICS.counter("corro.digest.sent.total", plane=plane).inc()
            return picked
        if skipped_oversize:
            METRICS.counter("corro.digest.oversize.skipped.total").inc()
        return None

    def receive(self, data: bytes) -> Optional[NodeDigest]:
        """Adopt a gossiped digest if it is the freshest we have seen
        from its origin node; fresh adoptions re-enter the relay queue
        (anti-entropy: digests reach nodes the origin never talks to)."""
        try:
            d = decode_digest(data)
        except (ValueError, IndexError):
            METRICS.counter("corro.digest.decode.failed").inc()
            return None
        if d.actor_id == self.agent.actor_id.bytes16:
            return None  # our own digest relayed back — ours is fresher
        with self._lock:  # vs build_and_store on the worker thread
            known = self._store.get(d.actor_id)
            if not d.fresher_than(known.digest if known else None):
                stale = True
            else:
                stale = False
                self._store[d.actor_id] = _Held(
                    digest=d,
                    encoded=bytes(data),
                    sends_left=self._transmissions(),
                    received_mono=time.monotonic(),
                )
            nodes = len(self._store)
        if stale:
            METRICS.counter("corro.digest.stale.total").inc()
            return None
        METRICS.counter("corro.digest.received.total").inc()
        METRICS.gauge("corro.digest.nodes").set(nodes)
        return d

    # -- divergence detection ----------------------------------------------

    def _active_member_ids(self) -> List[bytes]:
        from corrosion_tpu_torch.agent.membership import MemberState

        return [
            m.actor.id.bytes16
            for m in self.agent.membership.members.values()
            if m.state != MemberState.DOWN
        ]

    def check_divergence(self) -> dict:
        """One detector pass: compare the view hashes of every ACTIVE
        member's remembered digest (within `divergence_memory_secs`)
        against our own, and flag active members whose digests went
        silent.  A divergence sustained `divergence_checks` consecutive
        passes opens an episode: ONE incident dump + episode counter;
        a clean pass closes it and re-arms."""
        now_mono = time.monotonic()
        my_ids = self._active_member_ids()
        my_hash = view_hash(my_ids + [self.agent.actor_id.bytes16])
        views: Dict[int, List[str]] = {
            my_hash: [str(self.agent.actor_id)]
        }
        silent: List[str] = []
        with self._lock:  # snapshot vs the worker-thread builder
            store = dict(self._store)
        for mid in my_ids:
            held = store.get(mid)
            if held is None:
                continue  # never reported — no evidence either way
            age = now_mono - held.received_mono
            if age > self.cfg.divergence_memory_secs:
                continue
            name = str(ActorId(mid))
            views.setdefault(held.digest.view_hash, []).append(name)
            if age > self.silent_after and not self._self_lagged:
                silent.append(name)
        groups = len(views)
        divergent = groups > 1 or bool(silent)

        # one kernel="cluster" host frame per check: the black box then
        # holds the divergence timeline that preceded an incident dump
        # (and guarantees the dump is never skipped-as-empty on agents
        # that host no kernel sim)
        FLIGHT.record_host_frame(
            "cluster",
            {
                "groups": groups,
                "silent": len(silent),
                "streak": self._div_streak,
                "episode_open": int(self._episode_open),
                "digest_nodes": len(store),
                "view_size": len(my_ids) + 1,
            },
        )
        METRICS.counter("corro.cluster.divergence.checks.total").inc()
        METRICS.gauge("corro.cluster.divergence.groups").set(groups)
        METRICS.gauge("corro.cluster.divergence.silent").set(len(silent))
        if not self._armed:
            pass  # episode state frozen (planned teardown)
        elif divergent:
            self._div_streak += 1
            self._clean_streak = 0
            if (
                self._div_streak >= self.cfg.divergence_checks
                and not self._episode_open
            ):
                self._episode_open = True
                self._episodes += 1
                METRICS.counter(
                    "corro.cluster.divergence.episodes.total"
                ).inc()
                FLIGHT.snapshot_incident("cluster_divergence")
                log.warning(
                    "cluster view divergence: %d view group(s), "
                    "%d silent active node(s)", groups, len(silent),
                )
        elif self._self_lagged and self._episode_open:
            # a lagged round suppressed the silence signal, so "clean"
            # is not evidence: hold the open episode instead of closing
            # it and double-counting the same fault on the next round
            pass
        else:
            self._div_streak = 0
            self._clean_streak += 1
            # symmetric hysteresis: an episode closes only after the
            # SAME number of consecutive clean checks that opened it —
            # a single bounced check can neither open nor split one
            if self._clean_streak >= self.cfg.divergence_checks:
                self._episode_open = False
        METRICS.gauge("corro.cluster.divergence.active").set(
            1.0 if self._episode_open else 0.0
        )
        return {
            "divergent": divergent,
            "episode_open": self._episode_open,
            "episodes": self._episodes,
            "streak": self._div_streak,
            "groups": groups,
            "silent": silent,
            "view_hash": format(my_hash, "016x"),
            "views": {
                format(h, "016x"): sorted(nodes)
                for h, nodes in views.items()
            },
        }

    # -- the any-node cluster plane ----------------------------------------

    def cluster_alerts(self) -> dict:
        """What `GET /v1/alerts?scope=cluster` serves: every node's
        digest-carried active alerts plus a per-rule rollup — from ANY
        single node, over the same anti-entropy store /v1/cluster
        reads.  The serving node's own digest is rebuilt at read time
        (same discipline as cluster_report)."""
        self.build_and_store()
        now_mono = time.monotonic()
        stale_after = self.cfg.stale_after_secs
        nodes: Dict[str, dict] = {}
        rollup: Dict[str, dict] = {}
        with self._lock:  # snapshot vs the worker-thread builder
            held_all = list(self._store.values())
        for held in held_all:
            d = held.digest
            age = now_mono - held.received_mono
            name = str(ActorId(d.actor_id))
            nodes[name] = {
                "age_secs": round(age, 3),
                "fresh": age <= stale_after,
                "alerts": list(d.alerts),
            }
            if age > stale_after:
                continue  # stale digests list but never roll up
            for a in d.alerts:
                row = rollup.setdefault(a["rule"], {
                    "severity": a["severity"],
                    "firing": [], "pending": [], "drill": False,
                })
                row[a["state"]].append(name)
                row["drill"] = row["drill"] or bool(a.get("drill"))
        for row in rollup.values():
            row["firing"].sort()
            row["pending"].sort()
        return {
            "actor_id": str(self.agent.actor_id),
            "scope": "cluster",
            "coverage": {
                "known": len(nodes),
                "fresh": sum(1 for n in nodes.values() if n["fresh"]),
                "stale_after_secs": stale_after,
            },
            "rollup": rollup,
            "nodes": nodes,
        }

    def cluster_hotspots(self) -> dict:
        """What `GET /v1/profile?scope=cluster` serves: every node's
        digest-carried top self-time frames plus a cluster-merged
        hotspot table — from ANY single node, over the anti-entropy
        store.  Same rebuild-at-read + fresh-only-rollup discipline as
        cluster_alerts; a node whose digest shed its hotspot block
        under the wire-budget ladder simply contributes none."""
        self.build_and_store()
        now_mono = time.monotonic()
        stale_after = self.cfg.stale_after_secs
        nodes: Dict[str, dict] = {}
        merged: Dict[str, int] = {}
        with self._lock:  # snapshot vs the worker-thread builder
            held_all = list(self._store.values())
        for held in held_all:
            d = held.digest
            age = now_mono - held.received_mono
            name = str(ActorId(d.actor_id))
            nodes[name] = {
                "age_secs": round(age, 3),
                "fresh": age <= stale_after,
                "hotspots": list(d.hotspots),
            }
            if age > stale_after:
                continue  # stale digests list but never roll up
            for h in d.hotspots:
                merged[h["frame"]] = (
                    merged.get(h["frame"], 0) + int(h["samples"])
                )
        rollup = [
            {"frame": fr, "samples": n}
            for fr, n in sorted(
                merged.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        return {
            "actor_id": str(self.agent.actor_id),
            "scope": "cluster",
            "coverage": {
                "known": len(nodes),
                "fresh": sum(1 for n in nodes.values() if n["fresh"]),
                "stale_after_secs": stale_after,
            },
            "rollup": rollup,
            "nodes": nodes,
        }

    def cluster_report(self) -> dict:
        """What `GET /v1/cluster` serves: digest coverage, per-node
        health roll-up, EXACT cluster-merged stage percentiles, and the
        divergence verdict.  The serving node's own digest is rebuilt
        at read time so 'any node' includes the one you asked."""
        self.build_and_store()
        now_mono = time.monotonic()
        stale_after = self.cfg.stale_after_secs
        nodes: Dict[str, dict] = {}
        fresh: List[NodeDigest] = []
        with self._lock:  # snapshot vs the worker-thread builder
            held_all = list(self._store.values())
        for held in held_all:
            d = held.digest
            age = now_mono - held.received_mono
            is_fresh = age <= stale_after
            if is_fresh:
                fresh.append(d)
            nodes[str(ActorId(d.actor_id))] = {
                "age_secs": round(age, 3),
                "fresh": is_fresh,
                "seq": d.seq,
                "view_hash": format(d.view_hash, "016x"),
                "view_size": d.view_size,
                "alive": d.alive,
                "suspect": d.suspect,
                "downed": d.downed,
                "lhm": d.lhm,
                "loop_lag_seconds": d.loop_lag,
                "sync_backlog_versions": sum(d.sync_backlog.values()),
                "sync_backlog_peers": len(d.sync_backlog),
                "events": dict(d.events),
                "stage_counts": {
                    s: h.count for s, h in d.stages.items() if h.count
                },
            }
        merged = merge_stage_hists(fresh)
        stages = {}
        for stage, h in merged.items():
            row = {lat._qname(q): h.quantile(q) for q in lat.QUANTILES}
            row["count"] = h.count
            row["mean"] = (h.total / h.count) if h.count else None
            stages[stage] = row
        expected = 1 + len(self._active_member_ids())
        return {
            "actor_id": str(self.agent.actor_id),
            "coverage": {
                "expected": expected,
                "known": len(nodes),
                "fresh": len(fresh),
                "stale_after_secs": stale_after,
                "digest_interval_secs": self.cfg.digest_interval_secs,
            },
            "nodes": nodes,
            "stages": stages,
            "divergence": self.check_divergence(),
        }


async def observatory_loop(agent) -> None:
    """Build + disseminate the local digest and run the divergence
    detector every `digest_interval_secs` until tripwire.  Wakeup lag
    beyond `2 × interval` marks the NEXT check self-lagged (silence
    suppression — see module docstring)."""
    obs = agent.observatory
    if obs is None:
        return
    interval = obs.cfg.digest_interval_secs
    while not agent.tripwire.tripped:
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(agent.tripwire.wait(), interval)
        if agent.tripwire.tripped:
            return
        now = time.monotonic()
        lagged = (
            obs._last_wake is not None
            and now - obs._last_wake > 2.0 * interval
        )
        obs._last_wake = now
        obs._self_lagged = lagged
        if lagged:
            METRICS.counter("corro.cluster.self.lagged.total").inc()
        try:
            await asyncio.to_thread(obs.build_and_store)
            obs.check_divergence()
        except Exception:
            log.exception("observatory tick failed")
