"""Member-state persistence + startup resurrection + bootstrap fallback.

The port's copy of `corrosion_tpu/agent/member_store.py`.

Counterparts:
  - `diff_member_states` (`klukai-agent/src/broadcast/mod.rs:814-949`):
    every 60 s, diff live SWIM membership against the last persisted
    snapshot and upsert JSON member states + min RTT into
    `__corro_members`, deleting rows for actors that vanished.
  - `initialise_foca`/`load_member_states` + scheduled rejoin
    (`klukai-agent/src/agent/util.rs:74-179`): on startup, re-apply the
    persisted states so a restarted node remembers the cluster, then do a
    full re-announce 25 s (+ jitter) later to refresh what changed while
    we were down.
  - stored-member bootstrap fallback (`klukai-agent/src/agent/
    bootstrap.rs:29-50`): when the configured bootstrap list is empty,
    announce to up to 5 random persisted members.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.net.gossip_codec import MemberState
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.actor import Actor, ActorId, ClusterId
from corrosion_tpu_torch.types.base import Timestamp

log = logging.getLogger(__name__)

DIFF_PERIOD_S = 60.0  # broadcast/mod.rs:190 member-state diff tick
REJOIN_DELAY_S = 25.0  # util.rs:114-133 scheduled full rejoin
REJOIN_JITTER_S = 10.0
BOOTSTRAP_FALLBACK_COUNT = 5  # bootstrap.rs:29-50


def _state_json(actor: Actor, incarnation: int, state: MemberState) -> str:
    return json.dumps(
        {
            "id": str(actor.id),
            "addr": actor.addr,
            "ts": actor.ts.ntp64,
            "cluster_id": actor.cluster_id.value,
            "bump": actor.bump,
            "incarnation": incarnation,
            "state": state.name,
        },
        sort_keys=True,
    )


def _state_from_json(text: str) -> Optional[Tuple[Actor, int, MemberState]]:
    try:
        d = json.loads(text)
        actor = Actor(
            id=ActorId.from_uuid_str(d["id"]),
            addr=d["addr"],
            ts=Timestamp(d["ts"]),
            cluster_id=ClusterId(d["cluster_id"]),
            bump=d["bump"],
        )
        return actor, d["incarnation"], MemberState[d["state"]]
    except (ValueError, KeyError, TypeError):
        return None


def snapshot_membership(agent) -> Dict[ActorId, str]:
    """Serialize the live SWIM view (non-down members, like the reference
    which persists foca's active member set)."""
    out: Dict[ActorId, str] = {}
    # runs on a worker thread (member_states_loop's to_thread) while the
    # event loop mutates membership: dict(d) is a single GIL-held copy,
    # iterating the live dict raised "changed size during iteration"
    # under absorption load
    for aid, m in dict(agent.membership.members).items():
        if m.state == MemberState.DOWN:
            continue
        out[aid] = _state_json(m.actor, m.incarnation, m.state)
    return out


def _min_rtt_ms(agent, addr: str) -> Optional[float]:
    # worker thread (diff_member_states' to_thread) vs event-loop
    # appends: copy the deque in one GIL-held C call before iterating,
    # same idiom as snapshot_membership's dict(...) above
    window = agent.members.rtts.get(addr)
    if not window:
        return None
    return min(window.copy())


def diff_member_states(
    agent, last: Dict[ActorId, str]
) -> Dict[ActorId, str]:
    """One diff pass: upsert changed states, delete gone actors; returns
    the new snapshot (broadcast/mod.rs:814-949)."""
    current = snapshot_membership(agent)
    now = int(time.time())
    upserts = []
    for aid, state_json in current.items():
        if last.get(aid) == state_json:
            continue
        d = json.loads(state_json)
        upserts.append(
            (
                aid.bytes16,
                d["addr"],
                state_json,
                _min_rtt_ms(agent, d["addr"]),
                now,
            )
        )
    gone = [aid.bytes16 for aid in last.keys() - current.keys()]
    if upserts or gone:
        agent.store.update_member_rows(upserts, gone)
        METRICS.counter("corro.members.persisted").inc(len(upserts))
        METRICS.counter("corro.members.deleted").inc(len(gone))
    return current


async def member_states_loop(agent) -> None:
    """60 s cadence diff loop; a final diff runs on shutdown so the next
    start sees the freshest view."""
    last: Dict[ActorId, str] = {}
    while not agent.tripwire.tripped:
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(agent.tripwire.wait(), DIFF_PERIOD_S)
        try:
            last = await asyncio.to_thread(diff_member_states, agent, last)
        except Exception:
            log.exception("member-state diff failed")


def load_member_states(store) -> List[Tuple[Actor, int, MemberState]]:
    """Persisted member states for resurrection (util.rs:74-111)."""
    out = []
    for text in store.member_state_rows():
        parsed = _state_from_json(text)
        if parsed is not None:
            out.append(parsed)
    return out


def stored_bootstrap_addrs(store, count=BOOTSTRAP_FALLBACK_COUNT) -> List[str]:
    """Random persisted member addresses, the bootstrap fallback when no
    bootstrap list is configured (bootstrap.rs:29-50)."""
    return store.random_member_addresses(count)


async def resurrect_and_schedule_rejoin(agent) -> None:
    """Apply persisted states, then a full re-announce after 25 s + jitter
    (util.rs:114-133: the cluster may have moved on while we were down)."""
    states = await asyncio.to_thread(load_member_states, agent.store)
    if states:
        states = [
            s
            for s in states
            if s[0].id != agent.actor_id
            and s[0].cluster_id == agent.cluster_id
        ]
        agent.membership.apply_many(states)
        log.info("resurrected %d persisted members", len(states))
        METRICS.counter("corro.members.resurrected").inc(len(states))

    delay = REJOIN_DELAY_S + random.random() * REJOIN_JITTER_S
    with contextlib.suppress(asyncio.TimeoutError):
        await asyncio.wait_for(agent.tripwire.wait(), delay)
    if agent.tripwire.tripped:
        return
    for actor in agent.membership.active_members():
        with contextlib.suppress(Exception):
            await agent.membership.announce(actor.addr)
