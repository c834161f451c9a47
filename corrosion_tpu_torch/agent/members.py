"""Cluster-member view with RTT rings.

The port's copy of `corrosion_tpu/agent/members.py`.

Counterpart of `klukai-types/src/members.rs:38-178`: the agent-side
registry of known peers (distinct from SWIM's internal state), keyed by
ActorId, each with a gossip address and an RTT ring assignment. Ring 0
(median RTT < 6 ms) gets priority broadcast delivery
(`broadcast/mod.rs:591-651`); higher rings are reached through random
fanout. RTT observations stream in from the transport.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Set

from corrosion_tpu_torch.types.actor import Actor, ActorId

# ring upper bounds in milliseconds; index = ring number
RING_BOUNDS_MS = [6.0, 15.0, 50.0, 100.0, 200.0]
RTT_WINDOW = 20  # observations kept per address


def ring_for_rtt(rtt_ms: float) -> int:
    for ring, bound in enumerate(RING_BOUNDS_MS):
        if rtt_ms < bound:
            return ring
    return len(RING_BOUNDS_MS)


@dataclass
class MemberInfo:
    actor: Actor
    ring: Optional[int] = None
    last_sync_ts: Optional[int] = None  # HLC value of last successful sync


@dataclass
class Members:
    states: Dict[ActorId, MemberInfo] = field(default_factory=dict)
    by_addr: Dict[str, ActorId] = field(default_factory=dict)
    rtts: Dict[str, Deque[float]] = field(default_factory=dict)

    def add_member(self, actor: Actor) -> bool:
        """Insert/refresh a member; True if it is new (members.rs:52-92)."""
        existing = self.states.get(actor.id)
        is_new = existing is None
        info = existing or MemberInfo(actor=actor)
        info.actor = actor
        self.states[actor.id] = info
        self.by_addr[actor.addr] = actor.id
        self._recompute_ring(actor.addr)
        return is_new

    def remove_member(self, actor: Actor) -> bool:
        """Drop a member; True if it was present and removed."""
        existing = self.states.get(actor.id)
        if existing is None:
            return False
        # a renewed identity (newer ts/bump) must not be clobbered by a
        # stale Down about the old identity
        if (existing.actor.ts, existing.actor.bump) > (actor.ts, actor.bump):
            return False
        del self.states[actor.id]
        if self.by_addr.get(actor.addr) == actor.id:
            del self.by_addr[actor.addr]
        return True

    def observe_rtt(self, addr: str, rtt_seconds: float) -> None:
        window = self.rtts.setdefault(addr, deque(maxlen=RTT_WINDOW))
        window.append(rtt_seconds * 1000.0)
        self._recompute_ring(addr)

    def _recompute_ring(self, addr: str) -> None:
        actor_id = self.by_addr.get(addr)
        if actor_id is None:
            return
        window = self.rtts.get(addr)
        if not window:
            return
        self.states[actor_id].ring = ring_for_rtt(statistics.median(window))

    # -- selection helpers used by broadcast + sync ------------------------

    def ring0(self, exclude: Set[ActorId] = frozenset()) -> List[Actor]:
        return [
            info.actor
            for aid, info in self.states.items()
            if info.ring == 0 and aid not in exclude
        ]

    def not_ring0(self, exclude: Set[ActorId] = frozenset()) -> List[Actor]:
        return [
            info.actor
            for aid, info in self.states.items()
            if info.ring != 0 and aid not in exclude
        ]

    def all_actors(self) -> List[Actor]:
        return [info.actor for info in self.states.values()]

    def get(self, actor_id: ActorId) -> Optional[MemberInfo]:
        return self.states.get(actor_id)

    def __len__(self) -> int:
        return len(self.states)
