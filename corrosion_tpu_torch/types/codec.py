"""Little-endian byte writer and reader of the wire codecs: the port's
copy of `Writer` and `Reader` from `corrosion_tpu/types/codec.py`, with
the methods the SWIM wire uses (`net/gossip_codec.py`), and the value,
change and changeset codecs the store and the replica exchange use
(`write_value` .. `read_changeset`, byte for byte the reference's). The
broadcast envelopes and sync messages are not ported.

Layouts: u16/u32/u64 little-endian fixed width, i64/f64 too; strings and
byte vectors carry a u32 LE length prefix; an Option is a u8 presence
byte; SqliteValue and Changeset carry u8 tags.
"""

from __future__ import annotations

import struct
from typing import Dict, List

from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import (
    Change,
    ChangesetEmpty,
    ChangesetEmptySet,
    ChangesetFull,
)
from corrosion_tpu_torch.types.values import (
    TYPE_INTEGER,
    TYPE_NULL,
    TYPE_REAL,
    TYPE_TEXT,
    SqliteValue,
    value_type,
)


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

    def eof(self) -> bool:
        return self.pos >= len(self.data)


# -- SqliteValue, Change and Changeset ----------------------------------------


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
