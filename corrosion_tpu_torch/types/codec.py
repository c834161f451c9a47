"""Binary wire codecs modeled byte-for-byte on the reference's speedy
layouts: the port's copy of `corrosion_tpu/types/codec.py` (values,
changes and changesets; the broadcast envelopes with their trace and
digest exts, `chunked_change_v1`, the uni and bi payloads and the sync
messages), so a port node and a JAX-package node read each other's bytes.

The reference serializes peer wire types with speedy 0.8 (little-endian):
  - derived enums: u32 LE variant tag (speedy's default)
  - hand-written enum codecs (Changeset, SyncNeedV1, SyncStateV1,
    SqliteValue): u8 tags / u64 ("usize") lengths exactly as in
    `klukai-types/src/broadcast.rs:285-375`, `sync.rs:258-346,371-437`,
    `api.rs:657-707`
  - Vec/String/HashMap: u32 LE length prefix; Option: u8 presence byte
  - uuid/[u8;16]: 16 raw bytes; u64/i64/f64: LE fixed width

Frames on uni/bi streams are length-delimited with a u32 BE length prefix
(tokio LengthDelimitedCodec default), max frame 100 MiB
(`klukai-agent/src/agent/uni.rs:50` / `api/peer/mod.rs`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.types.actor import ActorId, ClusterId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import (
    Change,
    ChangeV1,
    ChangesetEmpty,
    ChangesetEmptySet,
    ChangesetFull,
)
from corrosion_tpu_torch.types.values import (
    SqliteValue,
    value_type,
    TYPE_BLOB,
    TYPE_INTEGER,
    TYPE_NULL,
    TYPE_REAL,
    TYPE_TEXT,
)

MAX_FRAME = 100 * 1024 * 1024


class Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v)

    def i64(self, v: int):
        self.buf += struct.pack("<q", v)

    def f64(self, v: float):
        self.buf += struct.pack("<d", v)

    def raw(self, b: bytes):
        self.buf += b

    def string(self, s: str):
        raw = s.encode("utf-8")
        self.u32(len(raw))
        self.buf += raw

    def vec_u8(self, b: bytes):
        self.u32(len(b))
        self.buf += b

    def opt(self, v, write_fn):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            write_fn(v)

    def uvarint(self, v: int):
        """LEB128 unsigned varint — the compact-integer encoding the
        telemetry-digest codec uses (runtime/digest.py); NOT part of
        any reference speedy layout."""
        if v < 0:
            raise ValueError(f"uvarint of negative {v}")
        while v >= 0x80:
            self.buf.append((v & 0x7F) | 0x80)
            v >>= 7
        self.buf.append(v)

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated buffer")
        mv = self.data[self.pos : self.pos + n]
        self.pos += n
        return mv

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def string(self) -> str:
        return self.raw(self.u32()).decode("utf-8")

    def vec_u8(self) -> bytes:
        return self.raw(self.u32())

    def opt(self, read_fn):
        return read_fn() if self.u8() else None

    def uvarint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("uvarint too long")

    def eof(self) -> bool:
        return self.pos >= len(self.data)


# -- SqliteValue (api.rs:657-707, u8 tags) --------------------------------


def write_value(w: Writer, v: SqliteValue) -> None:
    t = value_type(v)
    if t == TYPE_NULL:
        w.u8(0)
    elif t == TYPE_INTEGER:
        w.u8(1)
        w.i64(int(v))
    elif t == TYPE_REAL:
        w.u8(2)
        w.f64(v)
    elif t == TYPE_TEXT:
        w.u8(3)
        w.string(v)
    else:
        w.u8(4)
        w.vec_u8(bytes(v))


def read_value(r: Reader) -> SqliteValue:
    tag = r.u8()
    if tag == 0:
        return None
    if tag == 1:
        return r.i64()
    if tag == 2:
        return r.f64()
    if tag == 3:
        return r.string()
    if tag == 4:
        return r.vec_u8()
    raise ValueError(f"unknown SqliteValue tag {tag}")


# -- Change (derive order: change.rs:19-29) --------------------------------


_CHANGE_TAIL = struct.Struct("<qQQ")


def write_change_fields(
    w: Writer,
    table: str,
    pk: bytes,
    cid: str,
    val: SqliteValue,
    col_version: int,
    db_version: int,
    seq: int,
    site_id: bytes,
    cl: int,
) -> None:
    """One change cell from raw fields — the single source of truth for
    the cell layout, shared by `write_change` and the r15 fused local
    commit (`finalize_group` builds `Change.wire_cell` in the same pass
    that emits the Change)."""
    w.string(table)
    w.vec_u8(pk)
    w.string(cid)
    write_value(w, val)
    buf = w.buf
    buf += _CHANGE_TAIL.pack(col_version, db_version, seq)
    buf += site_id
    buf += struct.pack("<q", cl)


_LEN32 = struct.Struct("<I")
# the whole fixed-width cell suffix in one pack: col_version/db_version/
# seq (<qQQ, _CHANGE_TAIL) + 16 raw site-id bytes + <q cl — "<" packing
# has no alignment, so the bytes equal _CHANGE_TAIL.pack + site + pack
_CELL_SUFFIX = struct.Struct("<qQQ16sq")


def write_change_cells(cells, site_id: bytes) -> List[bytes]:
    """Batch form of `write_change_fields` (r21 columnar finalize
    phase B): encode MANY change cells in one pass over a shared
    buffer — length-prefixed table/cid headers are interned once per
    distinct string (a 10-row commit repeats each cid 10 times), the
    fixed-width tail is a single struct pack per cell, and the per-cell
    Writer allocation + 4-call encode sequence of the per-cell path
    disappears.  ``cells`` yields
    ``(table, pk, cid, val, col_version, db_version, seq, cl)`` tuples
    sharing one ``site_id``; returns the per-cell wire bytes in order,
    byte-identical to `write_change_fields` (pinned in test_codec.py
    and by the finalize equivalence suite)."""
    w = Writer()
    buf = w.buf
    pack_len = _LEN32.pack
    pack_suffix = _CELL_SUFFIX.pack
    # tables and cids share the cache: both encode as u32 len + utf-8
    hdrs: Dict[str, bytes] = {}
    bounds = [0]
    mark = bounds.append
    for table, pk, cid, val, col_version, db_version, seq, cl in cells:
        h = hdrs.get(table)
        if h is None:
            raw = table.encode("utf-8")
            hdrs[table] = h = pack_len(len(raw)) + raw
        buf += h
        buf += pack_len(len(pk))
        buf += pk
        h = hdrs.get(cid)
        if h is None:
            raw = cid.encode("utf-8")
            hdrs[cid] = h = pack_len(len(raw)) + raw
        buf += h
        write_value(w, val)
        buf += pack_suffix(col_version, db_version, seq, site_id, cl)
        mark(len(buf))
    mv = memoryview(buf)
    return [bytes(mv[a:b]) for a, b in zip(bounds, bounds[1:])]


def write_change(w: Writer, c: Change) -> None:
    # hot path (every broadcast/sync encode walks one of these per cell
    # when no wire_body is cached): a change carrying its r15 cached
    # cell bytes splices them verbatim; otherwise the fixed-width tail
    # is fused into single packs — byte layout identical either way
    # (pinned in test_codec.py goldens + test_capture.py)
    if c.wire_cell is not None:
        w.buf += c.wire_cell
        return
    write_change_fields(
        w, c.table, c.pk, c.cid, c.val, c.col_version, c.db_version,
        c.seq, c.site_id, c.cl,
    )


def read_change(r: Reader) -> Change:
    return Change(
        table=r.string(),
        pk=r.vec_u8(),
        cid=r.string(),
        val=read_value(r),
        col_version=r.i64(),
        db_version=r.u64(),
        seq=r.u64(),
        site_id=r.raw(16),
        cl=r.i64(),
    )


# -- Changeset (hand-written u8 tags, broadcast.rs:285-375) ----------------


def write_changeset(w: Writer, cs) -> None:
    if isinstance(cs, ChangesetEmpty):
        w.u8(0)
        w.u64(cs.versions[0])
        w.u64(cs.versions[1])
        w.opt(cs.ts, lambda ts: w.u64(ts.ntp64))
    elif isinstance(cs, ChangesetFull):
        w.u8(1)
        w.u64(cs.version)
        w.u32(len(cs.changes))
        for c in cs.changes:
            write_change(w, c)
        w.u64(cs.seqs[0])
        w.u64(cs.seqs[1])
        w.u64(cs.last_seq)
        w.u64(cs.ts.ntp64)
    elif isinstance(cs, ChangesetEmptySet):
        w.u8(2)
        w.u64(len(cs.versions))  # usize
        for s, e in cs.versions:
            w.u64(s)
            w.u64(e)
        w.u64(cs.ts.ntp64)
    else:
        raise TypeError(f"not a changeset: {cs!r}")


def read_changeset(r: Reader):
    tag = r.u8()
    if tag == 0:
        start, end = r.u64(), r.u64()
        ts = r.opt(lambda: Timestamp(r.u64()))
        return ChangesetEmpty(versions=(start, end), ts=ts)
    if tag == 1:
        version = r.u64()
        changes = tuple(read_change(r) for _ in range(r.u32()))
        seqs = (r.u64(), r.u64())
        last_seq = r.u64()
        ts = Timestamp(r.u64())
        return ChangesetFull(version, changes, seqs, last_seq, ts)
    if tag == 2:
        n = r.u64()
        versions = tuple((r.u64(), r.u64()) for _ in range(n))
        ts = Timestamp(r.u64())
        return ChangesetEmptySet(versions, ts)
    raise ValueError(f"unknown Changeset tag {tag}")


def write_change_v1(w: Writer, cv: ChangeV1) -> None:
    w.raw(cv.actor_id.bytes16)
    write_changeset(w, cv.changeset)


def read_change_v1(r: Reader) -> ChangeV1:
    return ChangeV1(actor_id=ActorId(r.raw(16)), changeset=read_changeset(r))


# -- envelope extension (r11 latency plane, r12 telemetry digests) ---------
#
# A version-gated OPTIONAL trailing block appended after the last field
# old decoders read.  Compatibility is structural in both directions:
# old peers stop reading before the ext (trailing bytes are ignored, the
# same default_on_eof tolerance the cluster_id field already relies on),
# and new peers treat eof-before-ext as "no ext".  The block is only
# written when it has content, so pre-r11 byte layouts are reproduced
# exactly for unstamped payloads (golden tests stay valid).
#
#   ext v1 := u8 version(=1) · opt<f64 origin_ts> · opt<string traceparent>
#   ext v2 := u8 version(=2) · opt<f64 origin_ts> · opt<string traceparent>
#             · vec<u8> digest          (r12: an encoded telemetry digest,
#                                        runtime/digest.py — opaque here)
#   ext v3 := u8 version(=3) · opt<f64 origin_ts> · opt<string traceparent>
#             · vec<u8> digest · opt<u8 trace_meta>
#                                        (r19: tail-sampling trace meta —
#                                         bit 0 forced-keep from the origin's
#                                         head decision, bits 2..7 relay hop
#                                         count; runtime/trace.py owns the
#                                         bit layout)
#
# v2 is only written when a digest rides along, so v1 readers (which
# read the stamps and ignore anything after) parse v2 payloads, and
# digest-free payloads stay byte-identical to the r11 layout.  v3 is
# only written when trace meta rides along: a pre-v3 peer reads the
# stamps (and the digest — 3 passes its `>= v2` gate; a meta-only v3
# payload writes an EMPTY digest vec, which the v3 reader normalizes
# back to None) and leaves the trailing meta byte unread, while a v3
# reader over a v1/v2 body hits eof before the meta and yields None —
# the same structural tolerance in both directions as v1/v2.

_ENVELOPE_EXT_V1 = 1
_ENVELOPE_EXT_V2 = 2
_ENVELOPE_EXT_V3 = 3


def _write_envelope_ext(
    w: Writer,
    origin_ts: Optional[float],
    traceparent: Optional[str],
    digest: Optional[bytes] = None,
    trace_meta: Optional[int] = None,
) -> None:
    if (
        origin_ts is None
        and traceparent is None
        and digest is None
        and trace_meta is None
    ):
        return
    if trace_meta is not None:
        w.u8(_ENVELOPE_EXT_V3)
    elif digest is not None:
        w.u8(_ENVELOPE_EXT_V2)
    else:
        w.u8(_ENVELOPE_EXT_V1)
    w.opt(origin_ts, w.f64)
    w.opt(traceparent, w.string)
    if digest is not None or trace_meta is not None:
        w.vec_u8(digest if digest is not None else b"")
    if trace_meta is not None:
        w.opt(trace_meta, w.u8)


def _read_envelope_ext(
    r: Reader,
) -> Tuple[Optional[float], Optional[str], Optional[bytes], Optional[int]]:
    if r.eof():
        return None, None, None, None
    ver = r.u8()
    if ver < _ENVELOPE_EXT_V1:  # pragma: no cover — never written
        return None, None, None, None
    origin_ts = r.opt(r.f64)
    traceparent = r.opt(r.string)
    digest = (
        r.vec_u8() if ver >= _ENVELOPE_EXT_V2 and not r.eof() else None
    )
    trace_meta = (
        r.opt(r.u8) if ver >= _ENVELOPE_EXT_V3 and not r.eof() else None
    )
    # a meta-only v3 payload carries an empty digest vec as padding;
    # consumers (observatory.receive) must never see b"" as a digest
    return origin_ts, traceparent, digest or None, trace_meta


def _with_ext(
    cv: ChangeV1,
    origin_ts: Optional[float],
    traceparent: Optional[str],
    wire_body: Optional[bytes] = None,
    trace_meta: Optional[int] = None,
) -> ChangeV1:
    if (
        origin_ts is None
        and traceparent is None
        and wire_body is None
        and trace_meta is None
    ):
        return cv
    from dataclasses import replace

    return replace(
        cv,
        origin_ts=origin_ts,
        traceparent=traceparent,
        trace_meta=trace_meta,
        wire_body=wire_body if wire_body is not None else cv.wire_body,
    )


# -- UniPayload / BiPayload (derived, u32 tags) ----------------------------
#
# r14 encode-once: the `actor_id + changeset` body dominates every uni
# payload's bytes and never changes between transmissions — so it is
# serialized ONCE (at local commit, or captured from the received frame
# on decode) and carried on `ChangeV1.wire_body`; `encode_uni_prefix`
# splices the shared bytes instead of re-walking the changeset, and only
# the cheap trailing envelope ext (origin stamp / traceparent / per-
# transmission digest) is re-written per send.  `encode_uni_payload`
# output is byte-identical either way (pinned in test_codec.py).


def encode_change_v1_body(cv: ChangeV1) -> bytes:
    """The shareable uni/sync body: actor_id + changeset, speedy layout."""
    w = Writer()
    write_change_v1(w, cv)
    return w.bytes()


def with_wire_body(cv: ChangeV1) -> ChangeV1:
    """Return `cv` carrying its encoded body (encode-once stamp point)."""
    if cv.wire_body is not None:
        return cv
    from dataclasses import replace

    return replace(cv, wire_body=encode_change_v1_body(cv))


# r16 write-path round-3 opener: chunked uni bodies are SPLICED from
# cached per-cell bytes, never re-walked.  A ChangesetFull body is
#   actor16 · u8(1) · u64(version) · u32(n) · cells… ·
#   u64 seqs0 · u64 seqs1 · u64 last_seq · u64 ts
# so given each change's `wire_cell` (stamped by finalize_group at local
# commit, or built here once for decoded relays) every chunk body is a
# header pack + a join of cached cells + a tail pack — byte-identical to
# `encode_change_v1_body` over the equivalent ChangesetFull (pinned in
# test_codec.py).

_CHUNK_HEAD = struct.Struct("<BQI")
_CHUNK_TAIL = struct.Struct("<QQQQ")


def _cell_bytes(c: Change) -> bytes:
    cell = c.wire_cell
    if cell is None:
        w = Writer()
        write_change_fields(
            w, c.table, c.pk, c.cid, c.val, c.col_version, c.db_version,
            c.seq, c.site_id, c.cl,
        )
        cell = w.bytes()
        # backfill the cache (compare=False field on a frozen
        # dataclass): a relayed change re-chunked once never rebuilds
        # its cell for later transmissions
        object.__setattr__(c, "wire_cell", cell)
    return cell


def chunked_change_v1(
    actor_id: ActorId,
    version: int,
    changes,
    last_seq: int,
    ts,
    origin_ts: Optional[float] = None,
    traceparent: Optional[str] = None,
    max_bytes: int = 8 * 1024,  # MAX_CHANGES_BYTE_SIZE (change.rs:179)
    seq_range: Optional[Tuple[int, int]] = None,
    trace_meta: Optional[int] = None,
) -> List[ChangeV1]:
    """Split one version's ordered changes into broadcast-sized
    ChangeV1 chunks, each carrying its spliced `wire_body`.  Grouping is
    `chunk_changes` verbatim (same estimator, same seq-coverage rules),
    so receivers buffer the partials and apply when the range closes.
    `seq_range` is the SOURCE changeset's claimed coverage — pass it
    when re-chunking an already-partial changeset so no chunk claims
    seqs it does not carry; default (0, last_seq) = a complete local
    commit."""
    from corrosion_tpu_torch.types.change import ChangesetFull, chunk_changes

    lo, hi = seq_range if seq_range is not None else (0, last_seq)
    actor16 = actor_id.bytes16
    out: List[ChangeV1] = []
    for chunk, seqs in chunk_changes(
        changes, hi, max_bytes=max_bytes, range_start=lo
    ):
        parts = [actor16, _CHUNK_HEAD.pack(1, version, len(chunk))]
        parts.extend(_cell_bytes(c) for c in chunk)
        parts.append(_CHUNK_TAIL.pack(seqs[0], seqs[1], last_seq, ts.ntp64))
        out.append(
            ChangeV1(
                actor_id=actor_id,
                changeset=ChangesetFull(
                    version=version,
                    changes=tuple(chunk),
                    seqs=seqs,
                    last_seq=last_seq,
                    ts=ts,
                ),
                origin_ts=origin_ts,
                traceparent=traceparent,
                trace_meta=trace_meta,
                wire_body=b"".join(parts),
            )
        )
    return out


def _write_body(w: Writer, cv: ChangeV1) -> None:
    if cv.wire_body is not None:
        from corrosion_tpu_torch.runtime.metrics import METRICS

        METRICS.counter("corro.codec.encode.shared.total").inc()
        w.raw(cv.wire_body)
    else:
        write_change_v1(w, cv)


def encode_uni_prefix(
    cv: ChangeV1, cluster_id: ClusterId = ClusterId(0)
) -> bytes:
    """Everything up to (excluding) the envelope ext: variant header +
    shared body + cluster id.  Reused across a payload's
    re-transmissions, which only re-write the trailing ext."""
    w = Writer()
    w.u32(0)  # UniPayload::V1
    w.u32(0)  # UniPayloadV1::Broadcast
    w.u32(0)  # BroadcastV1::Change
    _write_body(w, cv)
    w.u16(cluster_id.value)
    return w.bytes()


def encode_uni_from_prefix(
    prefix: bytes,
    origin_ts: Optional[float],
    traceparent: Optional[str],
    digest: Optional[bytes] = None,
    trace_meta: Optional[int] = None,
) -> bytes:
    w = Writer()
    w.raw(prefix)
    _write_envelope_ext(w, origin_ts, traceparent, digest, trace_meta)
    return w.bytes()


def encode_uni_payload(
    cv: ChangeV1,
    cluster_id: ClusterId = ClusterId(0),
    digest: Optional[bytes] = None,
) -> bytes:
    """`digest` (r12): an encoded telemetry digest piggybacking the
    broadcast plane (agent/observatory.py) — rides the trailing envelope
    ext, never changes digest-free bytes."""
    return encode_uni_from_prefix(
        encode_uni_prefix(cv, cluster_id),
        cv.origin_ts,
        cv.traceparent,
        digest,
        cv.trace_meta,
    )


def decode_uni_payload_ext(
    data: bytes,
) -> Tuple[ChangeV1, ClusterId, Optional[bytes]]:
    """Like `decode_uni_payload` but also surfaces the piggybacked
    telemetry digest bytes (None when the payload carries none)."""
    r = Reader(data)
    if r.u32() != 0 or r.u32() != 0 or r.u32() != 0:
        raise ValueError("unknown UniPayload variant")
    body_start = r.pos
    cv = read_change_v1(r)
    # encode-once (r14): the receiver already holds the encoded body —
    # keep it so a relay wraps these bytes instead of re-serializing
    body = bytes(r.data[body_start : r.pos])
    cluster_id = ClusterId(r.u16()) if not r.eof() else ClusterId(0)  # default_on_eof
    origin_ts, traceparent, digest, trace_meta = _read_envelope_ext(r)
    return (
        _with_ext(cv, origin_ts, traceparent, wire_body=body,
                  trace_meta=trace_meta),
        cluster_id,
        digest,
    )


def decode_uni_payload(data: bytes) -> Tuple[ChangeV1, ClusterId]:
    cv, cluster_id, _digest = decode_uni_payload_ext(data)
    return cv, cluster_id


@dataclass(frozen=True)
class SyncTraceContext:
    traceparent: Optional[str] = None
    tracestate: Optional[str] = None


def encode_bi_payload_sync_start(
    actor_id: ActorId,
    trace: SyncTraceContext = SyncTraceContext(),
    cluster_id: ClusterId = ClusterId(0),
) -> bytes:
    w = Writer()
    w.u32(0)  # BiPayload::V1
    w.u32(0)  # BiPayloadV1::SyncStart
    w.raw(actor_id.bytes16)
    w.opt(trace.traceparent, w.string)
    w.opt(trace.tracestate, w.string)
    w.u16(cluster_id.value)
    return w.bytes()


def decode_bi_payload(data: bytes) -> Tuple[ActorId, SyncTraceContext, ClusterId]:
    r = Reader(data)
    if r.u32() != 0 or r.u32() != 0:
        raise ValueError("unknown BiPayload variant")
    actor_id = ActorId(r.raw(16))
    trace = SyncTraceContext(
        traceparent=r.opt(r.string) if not r.eof() else None,
        tracestate=r.opt(r.string) if not r.eof() else None,
    )
    cluster_id = ClusterId(r.u16()) if not r.eof() else ClusterId(0)
    return actor_id, trace, cluster_id


# -- BiPayloadV1::SnapshotReq (r17 catch-up plane, version-gated) ----------
#
# A SECOND bi-stream op beside SyncStart: a cold node requesting the
# serving peer's cached compressed snapshot (agent/catchup.py).  The
# gate is structural: variant tag 1 makes a pre-r17 server raise the
# same "unknown BiPayload variant" ValueError its serve path already
# maps to a counted, closed session — the requester reads EOF and falls
# back to pure delta sync.  New servers keep decoding tag-0 SyncStart
# frames from old clients unchanged.

_BI_SYNC_START = 0
_BI_SNAPSHOT_REQ = 1


@dataclass(frozen=True)
class SnapshotReq:
    """What a cold node sends: who it is, which cluster, and the schema
    generation it runs (the server refuses on sha mismatch instead of
    shipping an uninstallable snapshot).  `traceparent` (r19) is a
    TRAILING optional field, eof-tolerant both ways like the SyncStart
    trace context: an r17 server stops reading at cluster_id and never
    sees it; an r19 reader over an r17 frame hits eof and yields None —
    so a cold-node bootstrap stitches into one readable trace."""

    actor_id: ActorId
    schema_sha: bytes
    cluster_id: ClusterId = ClusterId(0)
    traceparent: Optional[str] = None


def encode_bi_payload_snapshot_req(req: SnapshotReq) -> bytes:
    w = Writer()
    w.u32(0)  # BiPayload::V1
    w.u32(_BI_SNAPSHOT_REQ)  # BiPayloadV1::SnapshotReq (r17)
    w.raw(req.actor_id.bytes16)
    w.vec_u8(req.schema_sha)
    w.u16(req.cluster_id.value)
    if req.traceparent is not None:
        # only written when present: r17 request bytes stay identical
        w.opt(req.traceparent, w.string)
    return w.bytes()


def decode_bi_payload_any(data: bytes):
    """Dispatching decoder for the bi-stream's first frame:
    ("sync", (actor_id, trace, cluster_id)) or ("snapshot", SnapshotReq).
    Unknown variants raise ValueError (the version gate)."""
    r = Reader(data)
    if r.u32() != 0:
        raise ValueError("unknown BiPayload version")
    tag = r.u32()
    if tag == _BI_SYNC_START:
        actor_id = ActorId(r.raw(16))
        trace = SyncTraceContext(
            traceparent=r.opt(r.string) if not r.eof() else None,
            tracestate=r.opt(r.string) if not r.eof() else None,
        )
        cluster_id = ClusterId(r.u16()) if not r.eof() else ClusterId(0)
        return "sync", (actor_id, trace, cluster_id)
    if tag == _BI_SNAPSHOT_REQ:
        actor_id = ActorId(r.raw(16))
        sha = r.vec_u8()
        cluster_id = ClusterId(r.u16()) if not r.eof() else ClusterId(0)
        traceparent = r.opt(r.string) if not r.eof() else None
        return "snapshot", SnapshotReq(
            actor_id=actor_id, schema_sha=sha, cluster_id=cluster_id,
            traceparent=traceparent,
        )
    raise ValueError("unknown BiPayload variant")


# -- Sync messages (sync.rs) ----------------------------------------------


@dataclass
class SyncState:
    """SyncStateV1: what this node has and what it's missing, per origin."""

    actor_id: ActorId
    heads: Dict[ActorId, int]
    need: Dict[ActorId, List[Tuple[int, int]]]
    partial_need: Dict[ActorId, Dict[int, List[Tuple[int, int]]]]
    last_cleared_ts: Optional[Timestamp] = None


@dataclass(frozen=True)
class NeedFull:
    versions: Tuple[int, int]

    def count(self) -> int:
        return self.versions[1] - self.versions[0] + 1


@dataclass(frozen=True)
class NeedPartial:
    version: int
    seqs: Tuple[Tuple[int, int], ...]

    def count(self) -> int:
        return 1


@dataclass(frozen=True)
class NeedEmpty:
    ts: Optional[Timestamp] = None

    def count(self) -> int:
        return 1


@dataclass(frozen=True)
class SyncRejection:
    reason: int  # 0 = MaxConcurrencyReached, 1 = DifferentCluster

    MAX_CONCURRENCY = 0
    DIFFERENT_CLUSTER = 1


# SyncMessage variants (SyncMessageV1 derived tags)
_SYNC_STATE, _SYNC_CHANGESET, _SYNC_CLOCK, _SYNC_REJECTION, _SYNC_REQUEST = range(5)


def _write_sync_state(w: Writer, st: SyncState) -> None:
    w.raw(st.actor_id.bytes16)
    w.u32(len(st.heads))
    for aid, head in st.heads.items():
        w.raw(aid.bytes16)
        w.u64(head)
    w.u64(len(st.need))  # usize in the manual impl
    for aid, ranges in st.need.items():
        w.raw(aid.bytes16)
        w.u64(len(ranges))
        for s, e in ranges:
            w.u64(s)
            w.u64(e)
    w.u64(len(st.partial_need))
    for aid, versions in st.partial_need.items():
        w.raw(aid.bytes16)
        w.u64(len(versions))
        for version, seq_ranges in versions.items():
            w.u64(version)
            w.u64(len(seq_ranges))
            for s, e in seq_ranges:
                w.u64(s)
                w.u64(e)
    w.opt(st.last_cleared_ts, lambda ts: w.u64(ts.ntp64))


def _read_sync_state(r: Reader) -> SyncState:
    actor_id = ActorId(r.raw(16))
    heads = {ActorId(r.raw(16)): r.u64() for _ in range(r.u32())}
    need = {}
    for _ in range(r.u64()):
        aid = ActorId(r.raw(16))
        need[aid] = [(r.u64(), r.u64()) for _ in range(r.u64())]
    partial_need = {}
    for _ in range(r.u64()):
        aid = ActorId(r.raw(16))
        versions = {}
        for _ in range(r.u64()):
            v = r.u64()
            versions[v] = [(r.u64(), r.u64()) for _ in range(r.u64())]
        partial_need[aid] = versions
    last_cleared_ts = r.opt(lambda: Timestamp(r.u64()))
    return SyncState(actor_id, heads, need, partial_need, last_cleared_ts)


def _write_need(w: Writer, n) -> None:
    if isinstance(n, NeedFull):
        w.u8(0)
        w.u64(n.versions[0])
        w.u64(n.versions[1])
    elif isinstance(n, NeedPartial):
        w.u8(1)
        w.u64(n.version)
        w.u64(len(n.seqs))
        for s, e in n.seqs:
            w.u64(s)
            w.u64(e)
    elif isinstance(n, NeedEmpty):
        w.u8(2)
        w.opt(n.ts, lambda ts: w.u64(ts.ntp64))
    else:
        raise TypeError(f"not a need: {n!r}")


def _read_need(r: Reader):
    tag = r.u8()
    if tag == 0:
        return NeedFull((r.u64(), r.u64()))
    if tag == 1:
        version = r.u64()
        seqs = tuple((r.u64(), r.u64()) for _ in range(r.u64()))
        return NeedPartial(version, seqs)
    if tag == 2:
        return NeedEmpty(r.opt(lambda: Timestamp(r.u64())))
    raise ValueError(f"unknown SyncNeedV1 tag {tag}")


def encode_sync_msg(msg) -> bytes:
    """msg: SyncState | ChangeV1 | Timestamp | SyncRejection | request list."""
    w = Writer()
    w.u32(0)  # SyncMessage::V1
    if isinstance(msg, SyncState):
        w.u32(_SYNC_STATE)
        _write_sync_state(w, msg)
    elif isinstance(msg, ChangeV1):
        w.u32(_SYNC_CHANGESET)
        _write_body(w, msg)  # encode-once: shared body bytes when stamped
        # next to the W3C traceparent that already rides SyncStart:
        # the origin wall stamp (freshness-gated by the sync server)
        # and, since r19, the tail-sampling trace meta
        _write_envelope_ext(
            w, msg.origin_ts, msg.traceparent, trace_meta=msg.trace_meta
        )
    elif isinstance(msg, Timestamp):
        w.u32(_SYNC_CLOCK)
        w.u64(msg.ntp64)
    elif isinstance(msg, SyncRejection):
        w.u32(_SYNC_REJECTION)
        w.u32(msg.reason)
    elif isinstance(msg, list):  # SyncRequestV1
        w.u32(_SYNC_REQUEST)
        w.u32(len(msg))
        for aid, needs in msg:
            w.raw(aid.bytes16)
            w.u32(len(needs))
            for n in needs:
                _write_need(w, n)
    else:
        raise TypeError(f"not a sync message: {msg!r}")
    return w.bytes()


def decode_sync_msg(data: bytes):
    r = Reader(data)
    if r.u32() != 0:
        raise ValueError("unknown SyncMessage version")
    tag = r.u32()
    if tag == _SYNC_STATE:
        return _read_sync_state(r)
    if tag == _SYNC_CHANGESET:
        cv = read_change_v1(r)
        origin_ts, traceparent, _digest, trace_meta = _read_envelope_ext(r)
        return _with_ext(cv, origin_ts, traceparent, trace_meta=trace_meta)
    if tag == _SYNC_CLOCK:
        return Timestamp(r.u64())
    if tag == _SYNC_REJECTION:
        return SyncRejection(r.u32())
    if tag == _SYNC_REQUEST:
        out = []
        for _ in range(r.u32()):
            aid = ActorId(r.raw(16))
            needs = [_read_need(r) for _ in range(r.u32())]
            out.append((aid, needs))
        return out
    raise ValueError(f"unknown SyncMessageV1 tag {tag}")


# -- length-delimited framing (u32 BE, tokio LengthDelimitedCodec default) --


def frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ValueError("frame too large")
    return struct.pack(">I", len(payload)) + payload


def deframe(buf: bytes, pos: int = 0) -> Tuple[Optional[bytes], int]:
    """Try to read one frame at `pos`; returns (payload|None, new_pos)."""
    if len(buf) - pos < 4:
        return None, pos
    (n,) = struct.unpack_from(">I", buf, pos)
    if n > MAX_FRAME:
        raise ValueError("frame too large")
    if len(buf) - pos - 4 < n:
        return None, pos
    return bytes(buf[pos + 4 : pos + 4 + n]), pos + 4 + n
