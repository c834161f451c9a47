"""Per-actor version bookkeeping: max / needed gaps / partial versions.

Behavioral counterpart of `klukai-types/src/agent.rs:1068-1609`
(PartialVersion, KnownDbVersion, VersionsSnapshot, BookedVersions, Booked,
Bookie). A node tracks, for every origin actor:

  - `max`:     highest db_version ever observed from that actor
  - `needed`:  RangeSet of version gaps it still needs (anti-entropy pulls
               these during sync)
  - `partials`: versions received incompletely (seq sub-ranges buffered,
               waiting for the seq range to close before applying)

Mutations go through a snapshot/commit protocol: take `snapshot()`, apply
version observations (which both mutates the snapshot and writes the gap
delta through a `GapStore`), then `commit_snapshot()` under the write lock —
mirroring the reference's transactional `insert_db` + `commit_snapshot`
(`agent.rs:1119-1179,1408-1413`).

Note: the reference's `PartialVersion::full_range` starts at seq 1
(`agent.rs:1083`) even though change seqs start at 0 — an off-by-one its
sync path compensates for. We use the correct 0..=last_seq range.

The port's copy of `corrosion_tpu/store/bookkeeping.py`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Protocol, Tuple

from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.rangeset import Range, RangeSet


@dataclass
class PartialVersion:
    """Seq coverage of a version received in pieces (agent.rs:1069-1086)."""

    seqs: RangeSet
    last_seq: int
    ts: Timestamp

    def full_range(self) -> Range:
        return (0, self.last_seq)

    def is_complete(self) -> bool:
        return next(self.seqs.gaps(0, self.last_seq), None) is None

    def gaps(self) -> Iterable[Range]:
        return self.seqs.gaps(0, self.last_seq)


class GapStore(Protocol):
    """Persistence hooks for the needed-gap delta (``__corro_bookkeeping_gaps``)."""

    def delete_gap(self, actor_id: ActorId, start: int, end: int) -> None: ...

    def insert_gap(self, actor_id: ActorId, start: int, end: int) -> None: ...


class _NullGapStore:
    def delete_gap(self, actor_id: ActorId, start: int, end: int) -> None:
        pass

    def insert_gap(self, actor_id: ActorId, start: int, end: int) -> None:
        pass


NULL_GAP_STORE = _NullGapStore()


class VersionsSnapshot:
    """Mutable working copy; write gap deltas through a GapStore, then
    commit back into the owning BookedVersions."""

    def __init__(
        self,
        actor_id: ActorId,
        needed: RangeSet,
        partials: Dict[int, PartialVersion],
        max_version: Optional[int],
    ):
        self.actor_id = actor_id
        self.needed = needed
        self.partials = partials
        self.max = max_version

    def insert_db(self, store: GapStore, versions: RangeSet) -> None:
        """Record observed (applied/buffered/cleared) versions.

        Equivalent of `agent.rs:1119-1246`: versions between the previous
        max and a new range's start become needed gaps; observed versions
        are removed from the gaps; the delta is persisted via `store`.
        Processing sorted ranges with an incrementally-updated max yields
        the same result as the reference's original-max algebra because
        RangeSet iteration is sorted ascending.
        """
        before = self.needed.copy()
        for start, end in versions:
            gap_start = (self.max or 0) + 1
            if gap_start < start:
                self.needed.insert(gap_start, start - 1)
            self.needed.remove(start, end)
            if self.max is None or end > self.max:
                self.max = end
        # persist the row-level delta: gap rows are stored as (start, end)
        # pairs, so diff the structural rows (reference deletes overlapping
        # stored ranges and re-inserts the collapsed ones, agent.rs:1131-1177)
        rows_before = set(before)
        rows_after = set(self.needed)
        for s, e in rows_before - rows_after:
            store.delete_gap(self.actor_id, s, e)
        for s, e in rows_after - rows_before:
            store.insert_gap(self.actor_id, s, e)
        # gap deletion must be effective: no observed version may remain
        # needed after the algebra runs (ref assert_always, agent.rs:1144).
        # Condition guarded by enabled(): off mode must not pay the scan
        from corrosion_tpu_torch.runtime import invariants

        if invariants.enabled():
            invariants.assert_always(
                not any(
                    next(self.needed.overlapping(s, e), None) is not None
                    for s, e in versions
                ),
                "gaps.observed_versions_not_needed",
                {"actor": str(self.actor_id)},
            )

    def insert_gaps(self, versions: Iterable[Range]) -> None:
        for s, e in versions:
            self.needed.insert(s, e)


@dataclass
class BookedVersions:
    """All version knowledge about one origin actor (agent.rs:1272-1455)."""

    actor_id: ActorId
    partials: Dict[int, PartialVersion] = field(default_factory=dict)
    needed: RangeSet = field(default_factory=RangeSet)
    max: Optional[int] = None

    def contains_version(self, version: int) -> bool:
        # known if it's ≤ max and not a needed gap (agent.rs:1365-1375)
        return not self.needed.contains(version) and (self.max or 0) >= version

    def get_partial(self, version: int) -> Optional[PartialVersion]:
        return self.partials.get(version)

    def contains(self, version: int, seqs: Optional[Range] = None) -> bool:
        if not self.contains_version(version):
            return False
        if seqs is None:
            return True
        partial = self.partials.get(version)
        if partial is None:
            return True  # fully applied or cleared
        return partial.seqs.contains_range(seqs[0], seqs[1])

    def contains_all(self, versions: Range, seqs: Optional[Range] = None) -> bool:
        return all(self.contains(v, seqs) for v in range(versions[0], versions[1] + 1))

    def last(self) -> Optional[int]:
        return self.max

    def snapshot(self) -> VersionsSnapshot:
        return VersionsSnapshot(
            self.actor_id,
            self.needed.copy(),
            dict(self.partials),
            self.max,
        )

    def commit_snapshot(self, snap: VersionsSnapshot) -> None:
        self.needed = snap.needed
        self.partials = snap.partials
        self.max = snap.max

    def insert_partial(self, version: int, partial: PartialVersion) -> PartialVersion:
        """Merge seq coverage for a buffered version (agent.rs:1424-1447)."""
        existing = self.partials.get(version)
        if existing is None:
            self.partials[version] = partial
            if self.max is None or version > self.max:
                self.max = version
            return partial
        existing.seqs = existing.seqs.union(partial.seqs)
        existing.last_seq = max(existing.last_seq, partial.last_seq)
        return existing


class Booked:
    """A BookedVersions behind a reader/writer lock.

    The reference wraps each actor's bookkeeping in an instrumented tokio
    RwLock (`CountedTokioRwLock`, agent.rs:707-1066) with a watchdog for
    long holds. Host-side we guard with a reentrant mutex; asyncio tasks in
    this runtime never block across awaits while holding it.
    """

    def __init__(self, bv: BookedVersions, registry=None):
        self._bv = bv
        self._lock = threading.RLock()
        self._registry = registry
        self._label = f"booked:{bv.actor_id}"

    def read(self) -> "_BookedGuard":
        return _BookedGuard(
            self._bv, self._lock, self._registry, self._label, "read"
        )

    def write(self, label: str = "") -> "_BookedGuard":
        full = f"{self._label}:{label}" if label else self._label
        return _BookedGuard(self._bv, self._lock, self._registry, full, "write")


class _BookedGuard:
    __slots__ = ("bv", "_lock", "_registry", "_label", "_kind", "_meta")

    def __init__(self, bv: BookedVersions, lock, registry, label, kind):
        self.bv = bv
        self._lock = lock
        self._registry = registry
        self._label = label
        self._kind = kind
        self._meta = None

    def __enter__(self) -> BookedVersions:
        if self._registry is not None:
            self._meta = self._registry.register(self._label, self._kind)
        self._lock.acquire()
        if self._registry is not None:
            self._registry.acquired(self._meta)
        return self.bv

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        if self._registry is not None and self._meta is not None:
            self._registry.release(self._meta)
            self._meta = None
        return False


class Bookie:
    """actor_id → Booked map (agent.rs:1558-1609)."""

    def __init__(self, registry=None):
        self._map: Dict[ActorId, Booked] = {}
        self._lock = threading.Lock()
        # LockRegistry (runtime/locks.py) so admin `locks` sees holds
        self._registry = registry

    def ensure(self, actor_id: ActorId) -> Booked:
        with self._lock:
            b = self._map.get(actor_id)
            if b is None:
                b = Booked(BookedVersions(actor_id), self._registry)
                self._map[actor_id] = b
            return b

    def get(self, actor_id: ActorId) -> Optional[Booked]:
        with self._lock:
            return self._map.get(actor_id)

    def insert(self, actor_id: ActorId, bv: BookedVersions) -> Booked:
        """Install pre-loaded bookkeeping (startup warm-up from durable
        state, run_root.rs:136-197)."""
        with self._lock:
            b = Booked(bv, self._registry)
            self._map[actor_id] = b
            return b

    def replace_all(self, mapping: Dict[ActorId, BookedVersions]) -> None:
        """Atomically replace the whole actor map with exactly `mapping`
        (snapshot install, agent/catchup.py).  Actors absent from
        `mapping` are DROPPED: after a database swap the old map
        describes state that no longer exists, and a stale survivor
        would claim versions the swap discarded, hiding them from the
        delta top-up forever."""
        with self._lock:
            self._map = {
                aid: Booked(bv, self._registry)
                for aid, bv in mapping.items()
            }

    def items(self) -> Dict[ActorId, Booked]:
        with self._lock:
            return dict(self._map)
