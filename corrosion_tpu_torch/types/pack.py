"""Compact binary primary-key encoding in the cr-sqlite wire format.

Format (reference `klukai-types/src/pubsub.rs:2257-2410`):
    [num_columns:u8, ...per value: (intlen<<3 | type):u8,
                     big-endian signed int of `intlen` bytes (int value or
                     text/blob length), then raw bytes for text/blob]
Floats are always 8 big-endian IEEE bytes with intlen 0. NULL has no payload.
Type tags are the ColumnType values in `values.py` (Integer=1, Float=2,
Text=3, Blob=4, Null=5).

Compatibility contract: the DECODER reads any reference-encoded bytes to
exactly the values the reference itself would read (including its
sign-extension of 1-byte 0x80..0xFF). The ENCODER deviates on one point:
positive values whose top encoded bit would be set get one extra byte
(see `_num_bytes_needed`), because the reference's unsigned-width encode
plus sign-extending decode never round-trips such values — upstream,
integer pks in 128..255 (each sign-boundary band) and 128..255-byte
text/blob pks are silently dropped by the subscription matcher. The
consequence: OUR packed bytes for those values differ from the
reference's, and since packed pk bytes are the CRDT row identity, a
mixed old/new-encoder cluster would see such rows as distinct. All nodes
of a cluster must run the same encoder (wire-level interop with
reference nodes already requires QUIC, which this build does not speak).

The port's copy of `corrosion_tpu/types/pack.py`.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

from corrosion_tpu_torch.types.values import (
    SqliteValue,
    TYPE_BLOB,
    TYPE_INTEGER,
    TYPE_NULL,
    TYPE_REAL,
    TYPE_TEXT,
    value_type,
)


def _num_bytes_needed(val: int) -> int:
    """Bytes for a big-endian signed int — the reference's byte-mask
    probing (pubsub.rs:2315-2340: negatives always take 8 bytes, 0 takes
    0 bytes) PLUS one audited deviation: a positive value whose top
    encoded bit would be set gets one extra byte. The reference's
    encoder/decoder pair is asymmetric there — `put_int(128, 1)` emits
    0x80 which sign-extending `get_int` reads back as -128 — so integer
    pks in 128..255 (and each higher sign-boundary band) and text/blob
    pks 128..255 bytes long do not round-trip upstream (their matcher
    temp-table path drops such rows). Widening the encode keeps every
    value bijective while the decoder stays bug-compatible: any byte
    string a reference node could emit still decodes to exactly what the
    reference itself would decode.

    Compatibility note (packed pk bytes are CRDT row IDENTITY): the
    widened encoding changes the stored pk bytes for sign-boundary-band
    values (ints 128..255 and each higher band, 128..255-byte
    text/blob) relative to BOTH reference nodes and pre-widening builds
    of this repo. In a mixed cluster such rows exist under two
    identities until every writer runs the widened encoder — and a
    persisted store created by a pre-widening build keeps its
    old-identity rows: new writes to the same logical pk form a second
    row rather than merging. For an upgraded-in-place store, repack the
    affected rows once (identity changed iff decode->re-encode differs:
    SELECT, DELETE, re-INSERT under the new encoder), or re-seed the
    store from a fresh sync off an upgraded peer."""
    u = val & 0xFFFFFFFFFFFFFFFF
    for n in range(8, 0, -1):
        if u >> ((n - 1) * 8) & 0xFF:
            if val > 0 and n < 8 and (u >> ((n - 1) * 8)) & 0x80:
                return n + 1  # top bit would sign-flip on decode
            return n
    return 0


def _put_int(buf: bytearray, val: int, nbytes: int) -> None:
    u = val & 0xFFFFFFFFFFFFFFFF
    buf += u.to_bytes(8, "big")[8 - nbytes :] if nbytes else b""


def _get_int(data: memoryview, pos: int, nbytes: int) -> int:
    if nbytes == 0:
        return 0
    raw = bytes(data[pos : pos + nbytes])
    val = int.from_bytes(raw, "big", signed=True)
    return val


def pack_columns(values: Sequence[SqliteValue]) -> bytes:
    if len(values) > 0xFF:
        raise ValueError("too many columns to pack")
    buf = bytearray([len(values)])
    for v in values:
        t = value_type(v)
        if t == TYPE_NULL:
            buf.append(TYPE_NULL)
        elif t == TYPE_INTEGER:
            v = int(v)
            n = _num_bytes_needed(v)
            buf.append((n << 3) | TYPE_INTEGER)
            _put_int(buf, v, n)
        elif t == TYPE_REAL:
            buf.append(TYPE_REAL)
            buf += struct.pack(">d", v)
        elif t == TYPE_TEXT:
            raw = v.encode("utf-8")
            n = _num_bytes_needed(len(raw)) if raw else 0
            buf.append((n << 3) | TYPE_TEXT)
            _put_int(buf, len(raw), n)
            buf += raw
        else:  # blob
            raw = bytes(v)
            n = _num_bytes_needed(len(raw)) if raw else 0
            buf.append((n << 3) | TYPE_BLOB)
            _put_int(buf, len(raw), n)
            buf += raw
    return bytes(buf)


def unpack_columns(data: bytes) -> List[SqliteValue]:
    mv = memoryview(data)
    if not mv:
        raise ValueError("empty pk buffer")
    n = mv[0]
    pos = 1
    out: List[SqliteValue] = []
    for _ in range(n):
        if pos >= len(mv):
            raise ValueError("truncated pk buffer")
        tb = mv[pos]
        pos += 1
        t = tb & 0x07
        intlen = tb >> 3
        if t == TYPE_NULL:
            out.append(None)
        elif t == TYPE_INTEGER:
            out.append(_get_int(mv, pos, intlen))
            pos += intlen
        elif t == TYPE_REAL:
            out.append(struct.unpack(">d", mv[pos : pos + 8])[0])
            pos += 8
        elif t == TYPE_TEXT:
            ln = _get_int(mv, pos, intlen)
            pos += intlen
            out.append(bytes(mv[pos : pos + ln]).decode("utf-8"))
            pos += ln
        elif t == TYPE_BLOB:
            ln = _get_int(mv, pos, intlen)
            pos += intlen
            out.append(bytes(mv[pos : pos + ln]))
            pos += ln
        else:
            raise ValueError(f"bad column type tag {t}")
    if pos != len(mv):
        raise ValueError("trailing bytes in pk buffer")
    return out
