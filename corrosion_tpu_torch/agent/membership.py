"""Per-node SWIM failure detector and membership gossip: the port's copy
of `corrosion_tpu/agent/membership.py`, the agent's SWIM layer.

Round-robin probing with direct and indirect pings, suspicion with
incarnation-numbered refutation, piggybacked membership updates with
infection-style retransmission decay, announce/feed join, identity
`renew()` when declared down, and Lifeguard (off by default). It is the
event-driven path for real nodes; in the port it is the prober that the
kernel-peer bridge (`models/bridge.py`) is driven with, wired as the
agent wires it: a listener whose datagram handler calls
`handle_datagram`, and a `Tripwire` for `start` (`bridge_scale.py`).
There the observatory digest hooks stay `None`, so the prober sends
digest-free packets; an agent with `cluster.digests` on sets them to
its observatory (`agent/observatory.py`).

Config scaling follows foca's `new_wan`: probe cadence and suspicion
windows grow with log(cluster size); packets stay under 1178 B.

The agent (`agent/run.py`) also uses `leave` (a graceful departure at
shutdown), `apply_many` (restart resurrection of the persisted members,
`agent/member_store.py`), `active_members`, and the admin commands
`rejoin` and `change_cluster_id`.

`random` and `time` here are the standard library's (see `net/mem.py`
on running the package with `-m`).
"""

from __future__ import annotations

import asyncio
import contextlib
import math
import random
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from corrosion_tpu_torch.net.gossip_codec import (
    MAX_PACKET,
    MemberState,
    MemberUpdate,
    MsgKind,
    SwimMessage,
    actor_wire_size,
    decode_swim,
    encode_swim,
    fill_updates,
    update_wire_size,
)
from corrosion_tpu_torch.net.transport import Transport, TransportError
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.tripwire import Tripwire
from corrosion_tpu_torch.types.actor import Actor, ActorId


@dataclass
class SwimConfig:
    probe_period: float = 1.0
    probe_rtt: float = 0.4  # wait for a direct ack
    num_indirect_probes: int = 3
    suspicion_mult: float = 4.0  # suspect window = mult * log2(n+2) * period
    max_transmissions_base: int = 10  # scaled down for big clusters
    # carrier-budget multiplier for DOWN updates: a DOWN that goes
    # extinct before full coverage costs a straggler its entire
    # self-discovery round (own probe-ring pass + suspicion window —
    # measured 13-20 periods vs ~8 cluster-wide at n=8 with mult 1;
    # tail gone over 20 trials at mult 3). The batched kernel closes
    # the same hole with its anti-entropy tail pushes
    # (ops/swim.py `antientropy`); the full agent additionally repairs
    # via the steady announce/feed loop (run.py)
    down_transmissions_mult: int = 3
    remove_down_after: float = 48 * 3600.0  # broadcast/mod.rs:953
    announce_backoff_start: float = 5.0
    announce_backoff_max: float = 120.0
    announce_steady_period: float = 300.0
    # ---- Lifeguard (r9, arXiv:1707.00788) --------------------------------
    # Off by default: the vanilla timings above are what every existing
    # timing-sensitive test and the batched kernels' default mode pin.
    lifeguard: bool = False
    lhm_max: int = 8  # Local Health Multiplier score ceiling: probe
    # period, ack waits and suspicion windows scale by (1 + score)
    susp_ceiling: float = 3.0  # a suspect's window OPENS at
    # susp_ceiling * suspect_timeout(n) and shrinks toward the floor as
    # independent peers confirm the suspicion
    susp_k: int = 3  # confirmers needed to shrink to the floor

    def suspect_timeout(self, n: int) -> float:
        return self.suspicion_mult * math.log2(n + 2) * self.probe_period

    def suspect_timeout_confirmed(self, n: int, confirmers: int) -> float:
        """Lifeguard LHA-Suspicion window for a suspect with
        `confirmers` INDEPENDENT suspectors (the suspecting peers we
        received the assertion from, ourselves included): starts at the
        ceiling, decays logarithmically to the plain `suspect_timeout`
        floor at susp_k confirmers — a lone (possibly sick) accuser
        leaves the target the whole ceiling to refute, a cluster-wide
        suspicion fires at the floor."""
        lo = self.suspect_timeout(n)
        if not self.lifeguard:
            return lo
        hi = lo * self.susp_ceiling
        k = max(1, self.susp_k)
        c = min(max(confirmers - 1, 0), k)
        return max(lo, hi - (hi - lo) * math.log2(c + 1) / math.log2(k + 1))

    def max_transmissions(self, n: int) -> int:
        # infection-style: O(log n) sends suffice; foca's new_wan keeps ~10
        return max(3, min(self.max_transmissions_base, int(math.log2(n + 2)) + 3))


class Notification(Enum):
    MEMBER_UP = "up"
    MEMBER_DOWN = "down"
    ACTIVE = "active"  # we joined / rejoined a cluster
    DEFUNCT = "defunct"  # our identity was declared down (pre-renew)


# precedence within one incarnation: Down > Suspect > Alive
_PREC = {MemberState.ALIVE: 0, MemberState.SUSPECT: 1, MemberState.DOWN: 2}


def _supersedes(
    new_state: MemberState, new_inc: int, old_state: MemberState, old_inc: int
) -> bool:
    """Standard SWIM update-precedence rule."""
    if new_inc != old_inc:
        return new_inc > old_inc
    return _PREC[new_state] > _PREC[old_state]


@dataclass
class _Member:
    actor: Actor
    incarnation: int = 0
    state: MemberState = MemberState.ALIVE
    state_since: float = field(default_factory=time.monotonic)
    # Lifeguard LHA-Suspicion: the distinct peers we received the
    # current suspicion from (ourselves included when we raised it) —
    # each independent confirmer shrinks the suspect→down window
    # (`SwimConfig.suspect_timeout_confirmed`). Reset on every state
    # transition.
    suspectors: set = field(default_factory=set)


@dataclass
class _Dissemination:
    update: MemberUpdate
    sends_left: int


@dataclass
class _Probe:
    target: Actor
    started: float
    indirect_sent: bool = False


class Membership:
    """One node's SWIM instance driving the three-way datagram dance."""

    def __init__(
        self,
        identity: Actor,
        transport: Transport,
        config: Optional[SwimConfig] = None,
        rng: Optional[random.Random] = None,
        on_notification: Optional[Callable[[Notification, Actor], None]] = None,
    ):
        self.identity = identity
        self.transport = transport
        self.config = config or SwimConfig()
        self.rng = rng or random.Random()
        self.on_notification = on_notification or (lambda n, a: None)
        self.members: Dict[ActorId, _Member] = {}
        self.downed: Dict[ActorId, float] = {}  # id -> when declared down
        # Lifeguard LHA-Probe: saturating local-health score in
        # [0, lhm_max]; +1 per missed ack / failed probe / hearing
        # ourselves suspected, -1 per acked probe. Timer multiplier is
        # (1 + score) — a node that is itself sick probes slower and
        # waits longer instead of falsely accusing healthy peers.
        self._lhm = 0
        # dissemination queue keyed by subject: one live assertion per
        # actor (a newer assertion replaces the queued one in O(1));
        # insertion order doubles as freshness order for _piggyback
        self._queue: Dict[ActorId, _Dissemination] = {}
        self._incarnation = 0
        self._probe_no = 0
        self._pending: Dict[int, _Probe] = {}
        self._probe_ring: List[ActorId] = []
        self._ring_set: set = set()  # O(1) membership for the hot add path
        self._probe_pos = 0
        self._tasks: List[asyncio.Task] = []
        self._escalations: set = set()  # in-flight _probe_escalation tasks
        # cluster-observatory hooks (agent/observatory.py, set by
        # the agent's setup): every outgoing
        # datagram offers its spare packet budget to
        # `digest_source(budget) -> encoded digest | None`, and every
        # received digest ext is handed to `on_digest(src, bytes)`.
        # Both default None — a standalone Membership gossips
        # digest-free bytes.
        self.digest_source: Optional[Callable[[int], Optional[bytes]]] = None
        self.on_digest: Optional[Callable[[str, bytes], None]] = None

    # -- public surface ----------------------------------------------------

    @property
    def lhm(self) -> int:
        """Current Local Health Multiplier score (0 = healthy)."""
        return self._lhm

    @property
    def lhm_multiplier(self) -> float:
        """Effective timer multiplier: 1 + score (1.0 with lifeguard
        off — every wait below multiplies by this unconditionally)."""
        if not self.config.lifeguard:
            return 1.0
        return 1.0 + min(self._lhm, self.config.lhm_max)

    def _lhm_bump(self, why: str) -> None:
        if not self.config.lifeguard:
            return
        if self._lhm < self.config.lhm_max:
            self._lhm += 1
        METRICS.gauge("corro.gossip.lhm").set(self._lhm)
        METRICS.counter("corro.gossip.lhm.bumped", why=why).inc()

    def _lhm_relax(self) -> None:
        if not self.config.lifeguard or self._lhm == 0:
            return
        self._lhm -= 1
        METRICS.gauge("corro.gossip.lhm").set(self._lhm)

    @property
    def cluster_size(self) -> int:
        # members never retains DOWN entries (every DOWN transition
        # deletes, _apply_update:278/308), so the active count is just
        # the dict size — this is on the per-update hot path during mass
        # absorption and an O(N) sum here made absorption quadratic
        return 1 + len(self.members)

    def active_members(self) -> List[Actor]:
        return [
            m.actor
            for m in self.members.values()
            if m.state != MemberState.DOWN
        ]

    def start(self, tripwire: Tripwire) -> None:
        self._tasks = [
            asyncio.ensure_future(self._probe_loop(tripwire)),
            asyncio.ensure_future(self._suspicion_loop(tripwire)),
        ]

    async def stop(self) -> None:
        """Cancel the two loops and every probe escalation in flight."""
        for t in self._tasks + list(self._escalations):
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t

    async def leave(self) -> None:
        """Graceful departure: tell peers we're down at our own incarnation
        (broadcast/mod.rs:327-366 leave_cluster)."""
        update = MemberUpdate(
            self.identity, self._incarnation, MemberState.DOWN
        )
        targets = self.active_members()
        self.rng.shuffle(targets)
        for actor in targets[: max(3, self.config.num_indirect_probes)]:
            msg = SwimMessage(
                MsgKind.LEAVE, 0, self.identity, updates=[update]
            )
            await self._send(actor.addr, msg)

    def apply_many(self, states: List[Tuple[Actor, int, MemberState]]) -> None:
        """Resurrect persisted member states on startup (util.rs:74-111)."""
        for actor, incarnation, state in states:
            self._apply_update(MemberUpdate(actor, incarnation, state))

    async def rejoin(self) -> Actor:
        """Operator-triggered full rejoin (admin Cluster Rejoin →
        FocaCmd::Rejoin, `klukai/src/admin.rs`): renew identity and
        re-announce to every active member."""
        self.identity = self.identity.renew()
        self._incarnation = 0
        self._disseminate(MemberUpdate(self.identity, 0, MemberState.ALIVE))
        for actor in self.active_members():
            await self.announce(actor.addr)
        return self.identity

    async def change_cluster_id(self, cluster_id) -> Actor:
        """Admin Cluster SetId → ChangeIdentity: same node id, new cluster.
        Peers in the old cluster will drop our datagrams from now on."""
        from dataclasses import replace

        self.identity = replace(
            self.identity.renew(), cluster_id=cluster_id
        )
        self._incarnation = 0
        self._disseminate(MemberUpdate(self.identity, 0, MemberState.ALIVE))
        return self.identity

    async def announce(self, addr: str) -> None:
        """Join via a bootstrap address (handlers.rs:197-248)."""
        await self._send(addr, SwimMessage(MsgKind.ANNOUNCE, 0, self.identity))

    # -- sending -----------------------------------------------------------

    async def _send(self, addr: str, msg: SwimMessage) -> None:
        self._piggyback(msg)
        data = encode_swim(msg)
        if self.digest_source is not None:
            # offer the packet's remaining budget to the observatory;
            # the trailing ext keeps digest-free bytes byte-identical
            ext = self.digest_source(MAX_PACKET - len(data))
            if ext is not None:
                msg.digest = ext
                data = encode_swim(msg)
        try:
            await self.transport.send_datagram(addr, data)
            METRICS.counter("corro.gossip.message.sent", kind=msg.kind.name).inc()
        except TransportError:
            METRICS.counter("corro.gossip.send.failed").inc()

    def _piggyback(self, msg: SwimMessage) -> None:
        """Fill the remaining packet budget with queued updates, newest
        assertions first (infection-style dissemination: fresh updates
        have the most sends left — iterating insertion order backwards
        gives the same priority as the old sort without the O(Q log Q)
        per packet, and the fill stops at the packet budget instead of
        scanning the whole queue)."""
        budget = MAX_PACKET - 64 - actor_wire_size(msg.sender)
        if msg.target:
            budget -= actor_wire_size(msg.target)
        if msg.origin:
            budget -= actor_wire_size(msg.origin)
        if not self._queue:
            return
        spent: List[ActorId] = []
        for aid in reversed(list(self._queue)):
            d = self._queue[aid]
            size = update_wire_size(d.update)
            if budget - size < 0 or len(msg.updates) >= 64:
                break
            msg.updates.append(d.update)
            budget -= size
            d.sends_left -= 1
            if d.sends_left <= 0:
                spent.append(aid)
        for aid in spent:
            self._queue.pop(aid, None)

    def _disseminate(self, update: MemberUpdate) -> None:
        n = self.cluster_size
        sends = self.config.max_transmissions(n)
        if update.state == MemberState.DOWN:
            # deaths are rare and extinction of a DOWN is expensive;
            # see down_transmissions_mult in SwimConfig
            sends *= self.config.down_transmissions_mult
        # replace any queued assertion about the same actor (O(1): the
        # queue is keyed by subject), re-entering at the fresh end
        self._queue.pop(update.actor.id, None)
        self._queue[update.actor.id] = _Dissemination(update, sends)

    # -- update application -------------------------------------------------

    def _apply_update(
        self, u: MemberUpdate, via: Optional[ActorId] = None
    ) -> bool:
        """Merge one membership assertion; True if it changed our view.
        `via` names the peer the assertion arrived from — Lifeguard's
        independent-confirmer signal (SWIM updates carry no origin, so
        the forwarding peer is the independence proxy)."""
        if u.actor.id == self.identity.id:
            return self._apply_self_update(u)
        cur = self.members.get(u.actor.id)
        # LHA-Suspicion confirmation: a suspect assertion about an
        # already-suspect member does NOT supersede (equal precedence)
        # but a new distinct peer asserting it shrinks the window
        if (
            self.config.lifeguard
            and via is not None
            and u.state == MemberState.SUSPECT
            and cur is not None
            and cur.state == MemberState.SUSPECT
            and u.incarnation >= cur.incarnation
            and via not in cur.suspectors
        ):
            cur.suspectors.add(via)
            METRICS.counter("corro.gossip.suspicion.confirmed").inc()
        replaced_old: Optional[_Member] = None
        if cur is not None:
            cur_identity = (cur.actor.ts, cur.actor.bump)
            new_identity = (u.actor.ts, u.actor.bump)
            if new_identity < cur_identity:
                return False  # stale assertion about a renewed identity
            if new_identity > cur_identity:
                # renewed identity: brand-new member lifecycle
                replaced_old = cur
                cur = None
        if cur is None:
            if u.state == MemberState.DOWN:
                self.downed.setdefault(u.actor.id, time.monotonic())
                if replaced_old is not None:
                    # the renewed identity died: retire the stale record
                    del self.members[u.actor.id]
                    self._disseminate(u)
                    if replaced_old.state != MemberState.DOWN:
                        self.on_notification(
                            Notification.MEMBER_DOWN, u.actor
                        )
                        METRICS.counter("corro.gossip.member.removed").inc()
                    return True
                return False
            self.members[u.actor.id] = _Member(
                actor=u.actor, incarnation=u.incarnation, state=u.state
            )
            self.downed.pop(u.actor.id, None)
            if u.actor.id not in self._ring_set:
                self._probe_ring.append(u.actor.id)
                self._ring_set.add(u.actor.id)
            self._disseminate(u)
            # fires for renewed identities too: Members.add_member must
            # refresh to the new ts/bump
            self.on_notification(Notification.MEMBER_UP, u.actor)
            METRICS.counter("corro.gossip.member.added").inc()
            return True
        if not _supersedes(u.state, u.incarnation, cur.state, cur.incarnation):
            return False
        was_active = cur.state != MemberState.DOWN
        cur.actor = u.actor
        cur.incarnation = u.incarnation
        cur.state = u.state
        cur.state_since = time.monotonic()
        # fresh state transition: the confirmer set restarts (a NEW
        # suspicion epoch begins with just the asserting peer)
        cur.suspectors = (
            {via} if (u.state == MemberState.SUSPECT and via is not None)
            else set()
        )
        self._disseminate(u)
        if u.state == MemberState.DOWN:
            del self.members[u.actor.id]
            self.downed[u.actor.id] = time.monotonic()
            if was_active:
                self.on_notification(Notification.MEMBER_DOWN, u.actor)
                METRICS.counter("corro.gossip.member.removed").inc()
        return True

    def _apply_self_update(self, u: MemberUpdate) -> bool:
        """Refute suspicion; renew identity if declared down (actor.rs:199)."""
        if (u.actor.ts, u.actor.bump) < (self.identity.ts, self.identity.bump):
            return False  # about an identity we already renewed past
        if u.state == MemberState.SUSPECT and u.incarnation >= self._incarnation:
            # hearing ourselves suspected is direct evidence our own
            # timers/replies are running late (Lifeguard LHA-Probe)
            self._lhm_bump("self_suspected")
            self._incarnation = u.incarnation + 1
            self._disseminate(
                MemberUpdate(
                    self.identity, self._incarnation, MemberState.ALIVE
                )
            )
            METRICS.counter("corro.gossip.self.refuted").inc()
            return True
        if u.state == MemberState.DOWN and u.incarnation >= self._incarnation:
            self.on_notification(Notification.DEFUNCT, self.identity)
            self.identity = self.identity.renew()
            self._incarnation = 0
            self._disseminate(
                MemberUpdate(self.identity, 0, MemberState.ALIVE)
            )
            self.on_notification(Notification.ACTIVE, self.identity)
            METRICS.counter("corro.gossip.self.renewed").inc()
            return True
        return False

    # -- inbound -----------------------------------------------------------

    async def handle_datagram(self, src: str, data: bytes) -> None:
        try:
            msg = decode_swim(data)
        except (ValueError, IndexError):
            METRICS.counter("corro.gossip.decode.failed").inc()
            return
        if msg.sender.cluster_id != self.identity.cluster_id:
            return
        if msg.sender.id != self.identity.id:
            self._apply_update(
                MemberUpdate(msg.sender, 0, MemberState.ALIVE)
            )
        for u in msg.updates:
            self._apply_update(u, via=msg.sender.id)
        if msg.digest is not None and self.on_digest is not None:
            self.on_digest(src, msg.digest)

        k, me = msg.kind, self.identity
        if k == MsgKind.PING:
            await self._send(
                msg.sender.addr, SwimMessage(MsgKind.ACK, msg.probe_no, me)
            )
        elif k == MsgKind.ACK:
            self._on_ack(msg.probe_no, msg.sender)
        elif k == MsgKind.PING_REQ and msg.target is not None:
            await self._send(
                msg.target.addr,
                SwimMessage(
                    MsgKind.INDIRECT_PING,
                    msg.probe_no,
                    me,
                    target=msg.target,
                    origin=msg.sender,
                ),
            )
        elif k == MsgKind.INDIRECT_PING and msg.origin is not None:
            await self._send(
                msg.sender.addr,
                SwimMessage(
                    MsgKind.INDIRECT_ACK,
                    msg.probe_no,
                    me,
                    origin=msg.origin,
                ),
            )
        elif k == MsgKind.INDIRECT_ACK and msg.origin is not None:
            await self._send(
                msg.origin.addr,
                SwimMessage(
                    MsgKind.FORWARDED_ACK,
                    msg.probe_no,
                    me,
                    target=msg.sender,
                ),
            )
        elif k == MsgKind.FORWARDED_ACK:
            acked = msg.target or msg.sender
            self._on_ack(msg.probe_no, acked)
        elif k == MsgKind.ANNOUNCE:
            await self._on_announce(msg.sender)
        elif k == MsgKind.FEED:
            pass  # updates already applied above
        elif k == MsgKind.LEAVE:
            pass  # the DOWN update rode in msg.updates

    async def _on_announce(self, joiner: Actor) -> None:
        """Reply with a membership snapshot that fits one packet."""
        self._disseminate(MemberUpdate(joiner, 0, MemberState.ALIVE))
        feed = SwimMessage(MsgKind.FEED, 0, self.identity)
        sample = [
            MemberUpdate(m.actor, m.incarnation, m.state)
            for m in self.members.values()
            if m.actor.id != joiner.id
        ]
        self.rng.shuffle(sample)
        fill_updates(feed, sample)
        await self.transport.send_datagram(joiner.addr, encode_swim(feed))

    def _on_ack(self, probe_no: int, from_actor: Actor) -> None:
        probe = self._pending.get(probe_no)
        if probe is None or probe.target.id != from_actor.id:
            return
        del self._pending[probe_no]
        rtt = time.monotonic() - probe.started
        self.transport.observe_rtt(probe.target.addr, rtt)
        self._lhm_relax()  # a completed probe round: health evidence
        m = self.members.get(from_actor.id)
        if m is not None and m.state == MemberState.SUSPECT:
            # direct evidence of life clears our own suspicion
            self._apply_update(
                MemberUpdate(m.actor, m.incarnation + 1, MemberState.ALIVE)
            )

    # -- probe cycle ---------------------------------------------------------

    def _next_probe_target(self) -> Optional[Actor]:
        # departed members are skipped inline and compacted out once per
        # ring cycle — rebuilding the whole ring per probe was O(N) on
        # the probe cadence
        while self._probe_ring:
            if self._probe_pos >= len(self._probe_ring):
                self._probe_ring = [
                    aid for aid in self._probe_ring if aid in self.members
                ]
                self._ring_set = set(self._probe_ring)
                self._probe_pos = 0
                if not self._probe_ring:
                    return None
                self.rng.shuffle(self._probe_ring)
                continue
            actor_id = self._probe_ring[self._probe_pos]
            self._probe_pos += 1
            m = self.members.get(actor_id)
            if m is not None and m.state != MemberState.DOWN:
                return m.actor
        return None

    async def _probe_loop(self, tripwire: Tripwire) -> None:
        cfg = self.config
        while not tripwire.tripped:
            # LHA-Probe: a sick node (high LHM) probes SLOWER — its own
            # lateness would otherwise read as everyone else's failure
            # (multiplier is 1.0 with lifeguard off)
            await asyncio.sleep(cfg.probe_period * self.lhm_multiplier)
            target = self._next_probe_target()
            if target is None:
                continue
            self._probe_no += 1
            probe_no = self._probe_no
            self._pending[probe_no] = _Probe(target, time.monotonic())
            msg = SwimMessage(MsgKind.PING, probe_no, self.identity)
            if cfg.lifeguard:
                # LHA-Refute buddy system: if we hold the target as
                # SUSPECT, tell it IN the ping — it refutes immediately
                # instead of waiting for the rumor to gossip its way
                # around (the ping already flows; zero extra packets)
                m = self.members.get(target.id)
                if m is not None and m.state == MemberState.SUSPECT:
                    msg.updates.append(
                        MemberUpdate(
                            m.actor, m.incarnation, MemberState.SUSPECT
                        )
                    )
                    METRICS.counter("corro.gossip.buddy.notified").inc()
            await self._send(target.addr, msg)
            esc = asyncio.ensure_future(self._probe_escalation(probe_no))
            self._escalations.add(esc)
            esc.add_done_callback(self._escalations.discard)

    async def _probe_escalation(self, probe_no: int) -> None:
        cfg = self.config
        # ack windows stretch with our OWN health score: if we are the
        # slow one, the ack is probably sitting in our queue already
        await asyncio.sleep(cfg.probe_rtt * self.lhm_multiplier)
        probe = self._pending.get(probe_no)
        if probe is None:
            return  # acked
        probe.indirect_sent = True
        self._lhm_bump("direct_miss")
        target = probe.target
        helpers = [
            m.actor
            for m in self.members.values()
            if m.state == MemberState.ALIVE and m.actor.id != target.id
        ]
        self.rng.shuffle(helpers)
        for helper in helpers[: cfg.num_indirect_probes]:
            await self._send(
                helper.addr,
                SwimMessage(
                    MsgKind.PING_REQ,
                    probe_no,
                    self.identity,
                    target=target,
                ),
            )
        await asyncio.sleep(2 * cfg.probe_rtt * self.lhm_multiplier)
        probe = self._pending.pop(probe_no, None)
        if probe is None:
            return  # indirectly acked
        self._lhm_bump("probe_failed")
        m = self.members.get(target.id)
        if m is not None and m.state == MemberState.ALIVE:
            self._apply_update(
                MemberUpdate(m.actor, m.incarnation, MemberState.SUSPECT),
                via=self.identity.id,
            )
            METRICS.counter("corro.gossip.member.suspected").inc()

    async def _suspicion_loop(self, tripwire: Tripwire) -> None:
        """Expire suspects to Down; forget long-Down members."""
        cfg = self.config
        while not tripwire.tripped:
            await asyncio.sleep(cfg.probe_period)
            now = time.monotonic()
            n = self.cluster_size
            # per-suspect Lifeguard window: ceiling shrunk by that
            # suspect's independent confirmer count, stretched by our
            # OWN health multiplier (with lifeguard off both collapse
            # to the vanilla fixed suspect_timeout)
            mult = self.lhm_multiplier
            expired = [
                m
                for m in self.members.values()
                if m.state == MemberState.SUSPECT
                and now - m.state_since
                > cfg.suspect_timeout_confirmed(
                    n, max(1, len(m.suspectors))
                ) * mult
            ]
            for m in expired:
                self._apply_update(
                    MemberUpdate(m.actor, m.incarnation, MemberState.DOWN)
                )
            cutoff = now - cfg.remove_down_after
            self.downed = {
                aid: t for aid, t in self.downed.items() if t > cutoff
            }
