"""The CRDT change unit and changesets.

Counterpart of `klukai-types/src/change.rs` (Change, ChunkedChanges,
MAX_CHANGES_BYTE_SIZE) and the Changeset/ChangeV1 wire enums from
`klukai-types/src/broadcast.rs:98-283`.

A `Change` is one column-level CRDT delta: a (table, pk, column) cell with
its value and clock metadata. `cl` is the causal length of the row: odd =
alive, even = deleted. Row create/delete travels as a change whose cid is
the `SENTINEL` column id ("-1"); a sentinel change with even cl is a delete.
A version's changes are sequenced 0..=last_seq; changesets may carry a
sub-range (partial version) — receivers buffer partials until the seq range
closes (reference `agent/util.rs:1070-1203`).

The port's copy of `corrosion_tpu/types/change.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Tuple

from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.values import SqliteValue

# cr-sqlite sentinel column id (observable in crsql_changes rows; the
# reference checks `ColumnName::is_crsql_sentinel` == "-1", api.rs:790).
# A sentinel change tracks row create/delete: its row's causal length `cl`
# is odd while alive, even when deleted.
SENTINEL = "-1"

MAX_CHANGES_BYTE_SIZE = 8 * 1024  # change.rs:179


@dataclass(frozen=True)
class Change:
    table: str
    pk: bytes  # pack_columns-encoded primary key
    cid: str  # column name or sentinel
    val: SqliteValue
    col_version: int
    db_version: int
    seq: int
    site_id: bytes  # 16 bytes == ActorId
    cl: int  # causal length (odd=alive, even=deleted)
    ts: Timestamp = field(default=Timestamp(0), compare=False)
    # r15 fused encode: this change's speedy cell bytes (the exact
    # `write_change` output), built in the SAME pass that emits the
    # Change at local commit (`CrdtStore.finalize_group`), so every
    # changeset encode splices cached bytes instead of re-walking the
    # values.  Pure cache: never part of identity, never required.
    wire_cell: Optional[bytes] = field(
        default=None, compare=False, repr=False
    )

    def estimated_byte_size(self) -> int:
        # change.rs:34-52: rough wire-size estimate
        val_sz = (
            len(self.val)
            if isinstance(self.val, (str, bytes))
            else 8
            if self.val is not None
            else 0
        )
        return len(self.table) + len(self.pk) + len(self.cid) + val_sz + 8 * 5 + 16

    def is_sentinel(self) -> bool:
        return self.cid == SENTINEL

    def is_delete(self) -> bool:
        return self.cid == SENTINEL and self.cl % 2 == 0


@dataclass(frozen=True)
class ChangesetEmpty:
    """Versions known to carry no changes (cleared/compacted)."""

    versions: Tuple[int, int]  # inclusive range
    ts: Optional[Timestamp] = None


@dataclass(frozen=True)
class ChangesetEmptySet:
    versions: Tuple[Tuple[int, int], ...]
    ts: Timestamp = Timestamp(0)


@dataclass(frozen=True)
class ChangesetFull:
    version: int
    changes: Tuple[Change, ...]
    seqs: Tuple[int, int]  # inclusive seq range carried here
    last_seq: int  # final seq of the full version
    ts: Timestamp = Timestamp(0)

    def is_complete(self) -> bool:
        return self.seqs == (0, self.last_seq)

    def is_empty(self) -> bool:
        return not self.changes


Changeset = object  # union: ChangesetEmpty | ChangesetEmptySet | ChangesetFull


@dataclass(frozen=True)
class ChangeV1:
    actor_id: ActorId
    changeset: object  # Changeset union
    # r11 latency-plane envelope metadata (compare=False: identity is
    # the change content; these ride the version-gated trailing ext of
    # the broadcast/sync envelopes — types/codec.py — and old peers
    # simply never see them).  `origin_ts` is the wall clock at the
    # ORIGIN node's commit, the stamp every corro.e2e.* stage histogram
    # measures against; `traceparent` stitches cross-node spans on the
    # eager broadcast path (sync already carries one in SyncStart).
    origin_ts: Optional[float] = field(default=None, compare=False)
    traceparent: Optional[str] = field(default=None, compare=False)
    # r19 tail-sampling trace meta (one byte on the wire, the envelope
    # ext v3 gate): bit 0 = forced-keep — the ORIGIN's head decision
    # (lottery win) so every node on the path keeps the same trace
    # without coordination; bits 2..7 = relay hop count, bumped by the
    # re-broadcast path.  Bit layout owned by runtime/trace.py.
    trace_meta: Optional[int] = field(default=None, compare=False)
    # r14 encode-once: the speedy-encoded `actor_id + changeset` body
    # (types/codec.py `encode_change_v1_body`).  Stamped ONCE at local
    # commit and on broadcast decode (the receiver already holds the
    # bytes), then reused verbatim by every uni/sync encode instead of
    # re-serializing the changeset per transmission/relay.  Pure cache:
    # never part of identity, never required to be present.
    wire_body: Optional[bytes] = field(
        default=None, compare=False, repr=False
    )

    @property
    def versions(self) -> Tuple[int, int]:
        cs = self.changeset
        if isinstance(cs, ChangesetFull):
            return (cs.version, cs.version)
        if isinstance(cs, ChangesetEmpty):
            return cs.versions
        raise TypeError("EmptySet has multiple ranges")


def chunk_changes(
    changes: Iterable[Change],
    last_seq: int,
    max_bytes: int = MAX_CHANGES_BYTE_SIZE,
    max_bytes_fn=None,
    range_start: int = 0,
) -> Iterator[Tuple[List[Change], Tuple[int, int]]]:
    """Group ordered same-version changes into chunks of ≤ max_bytes,
    preserving contiguous seq coverage across gaps (change.rs:65-177):
    each emitted seq range starts where the previous ended + 1, and the
    final range extends to `last_seq`.

    `max_bytes_fn`, when given, is consulted per chunk — the sync
    server's adaptive sizing (halve on slow sends, regrow ×1.5;
    peer/mod.rs:808-869) shrinks or grows the target between chunks of
    the same version.

    `range_start` (r16): where the FIRST chunk's claimed seq coverage
    begins — 0 for a complete version (the default), or the source
    changeset's own `seqs[0]` when re-chunking an already-partial
    changeset (broadcast oversize splitting): a partial must never claim
    coverage of seqs it does not carry.

    Yields (chunk, (seq_start, seq_end)).
    """
    buf: List[Change] = []
    size = 0
    last_emitted_end: Optional[int] = None
    it = iter(changes)
    for ch in it:
        buf.append(ch)
        size += ch.estimated_byte_size()
        if size >= (max_bytes_fn() if max_bytes_fn is not None else max_bytes):
            end = buf[-1].seq
            yield buf, (range_start, end)
            last_emitted_end = end
            range_start = end + 1
            buf, size = [], 0
    if buf:
        yield buf, (range_start, last_seq)
    elif last_emitted_end is not None and last_emitted_end < last_seq:
        yield [], (range_start, last_seq)
    elif last_emitted_end is None:
        # no changes at all: single empty full range
        yield [], (range_start, last_seq)
