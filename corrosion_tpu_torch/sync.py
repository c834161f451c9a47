"""Anti-entropy sync protocol: state summaries and need computation.

The port's copy of `corrosion_tpu/sync.py`.

Behavioral counterpart of `klukai-types/src/sync.rs` (SyncStateV1,
compute_available_needs, generate_sync) and the client/server loops in
`klukai-agent/src/api/peer/mod.rs:1082,1485`. The set algebra here is the
correctness-critical piece: given my summary and a peer's summary, derive
exactly which version ranges and seq sub-ranges to request.

Wire shapes live in `corrosion_tpu_torch.types.codec` (SyncState/NeedFull/
NeedPartial/NeedEmpty); this module supplies the algebra + generation from
a Bookie.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.store.bookkeeping import Bookie
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.codec import (
    NeedEmpty,
    NeedFull,
    NeedPartial,
    SyncState,
)
from corrosion_tpu_torch.types.rangeset import RangeSet

Range = Tuple[int, int]


def generate_sync(bookie: Bookie, actor_id: ActorId) -> SyncState:
    """Summarize what we have/need per origin actor (sync.rs:446-540)."""
    heads: Dict[ActorId, int] = {}
    need: Dict[ActorId, List[Range]] = {}
    partial_need: Dict[ActorId, Dict[int, List[Range]]] = {}

    for aid, booked in bookie.items().items():
        with booked.read() as bv:
            last = bv.last()
            if last is None:
                continue
            heads[aid] = last
            needed = list(bv.needed)
            if needed:
                need[aid] = needed
            partials = {
                version: list(pv.gaps())
                for version, pv in bv.partials.items()
                if not pv.is_complete()
            }
            partials = {v: g for v, g in partials.items() if g}
            if partials:
                partial_need[aid] = partials

    return SyncState(
        actor_id=actor_id,
        heads=heads,
        need=need,
        partial_need=partial_need,
        last_cleared_ts=None,
    )


def compute_available_needs(
    ours: SyncState, theirs: SyncState
) -> Dict[ActorId, List[object]]:
    """What can we usefully request from this peer? (sync.rs:126-248)

    For every origin actor the peer has heard of:
      - intersect our needed gaps with the versions the peer *fully* has
        (their head minus their own needs/partials)
      - for our partial versions: request remaining seqs if the peer has
        the version fully, or the seq overlap both of us are missing-less
        (peer further along the same partial)
      - request everything above our head up to their head
    """
    needs: Dict[ActorId, List[object]] = {}

    for actor_id, head in theirs.heads.items():
        if actor_id == ours.actor_id:
            continue
        if head == 0:
            continue

        other_haves = RangeSet([(1, head)])
        for s, e in theirs.need.get(actor_id, ()):
            other_haves.remove(s, e)
        for v in theirs.partial_need.get(actor_id, {}):
            other_haves.remove(v, v)

        our_need = ours.need.get(actor_id)
        if our_need:
            for s, e in our_need:
                for os_, oe in other_haves.overlapping(s, e):
                    needs.setdefault(actor_id, []).append(
                        NeedFull((max(s, os_), min(e, oe)))
                    )

        our_partials = ours.partial_need.get(actor_id)
        if our_partials:
            for version, seq_gaps in our_partials.items():
                if other_haves.contains(version):
                    needs.setdefault(actor_id, []).append(
                        NeedPartial(version, tuple(seq_gaps))
                    )
                    continue
                their_gaps = theirs.partial_need.get(actor_id, {}).get(version)
                if their_gaps:
                    # the peer is also partial on this version: request only
                    # the seqs we're missing that the peer is NOT missing
                    max_their = max(e for _, e in their_gaps)
                    max_ours = max(e for _, e in seq_gaps)
                    end = max(max_their, max_ours)
                    their_haves = RangeSet([(0, end)])
                    for s, e in their_gaps:
                        their_haves.remove(s, e)
                    seqs: List[Range] = []
                    for s, e in seq_gaps:
                        for os_, oe in their_haves.overlapping(s, e):
                            seqs.append((max(s, os_), min(e, oe)))
                    if seqs:
                        needs.setdefault(actor_id, []).append(
                            NeedPartial(version, tuple(seqs))
                        )

        our_head = ours.heads.get(actor_id)
        if our_head is None:
            needs.setdefault(actor_id, []).append(NeedFull((1, head)))
        elif head > our_head:
            needs.setdefault(actor_id, []).append(NeedFull((our_head + 1, head)))

    return needs


def need_count(need) -> int:
    if isinstance(need, NeedFull):
        return need.versions[1] - need.versions[0] + 1
    return 1


def state_need_len(state: SyncState) -> int:
    """Total version-count a node is missing (sync.rs:89-107); used for
    peer choice ordering in the sync scheduler."""
    total = sum(
        e - s + 1 for ranges in state.need.values() for s, e in ranges
    )
    partial_chunks = (
        sum(
            e - s + 1
            for versions in state.partial_need.values()
            for ranges in versions.values()
            for s, e in ranges
        )
        // 50
    )
    return total + partial_chunks


def held_total(bookie: Bookie) -> int:
    """Versions this node actually HOLDS across all origin actors: head
    minus needed gaps minus incomplete partials.  The local half of the
    r17 snapshot-bootstrap gap heuristic (the remote half is a peer's
    digest-advertised `heads_total` or a probed SyncState)."""
    total = 0
    for _aid, booked in bookie.items().items():
        with booked.read() as bv:
            last = bv.last()
            if last is None:
                continue
            total += last
            total -= sum(e - s + 1 for s, e in bv.needed)
            total -= sum(
                1 for p in bv.partials.values() if not p.is_complete()
            )
    return total


def state_held_total(state: SyncState) -> int:
    """Versions a peer holds, from its sync summary — what a state
    probe yields when no digest has arrived yet (cold boot)."""
    total = sum(state.heads.values())
    total -= sum(
        e - s + 1 for ranges in state.need.values() for s, e in ranges
    )
    total -= sum(len(v) for v in state.partial_need.values())
    return total


def chunk_range(start: int, end: int, size: int) -> List[Range]:
    """Split an inclusive version range into ≤size chunks
    (peer/mod.rs:986-1004)."""
    out = []
    s = start
    while s <= end:
        e = min(s + size - 1, end)
        out.append((s, e))
        s = e + 1
    return out
