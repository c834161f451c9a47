"""Compressed store snapshots: the cold-node bootstrap format (r17).

The catch-up plane's fast path: instead of replaying a multi-month gap
change-by-change over delta sync, a cold node fetches ONE compressed
snapshot of a serving peer's database, installs it through the
`store/restore.py` locked-swap path, and tops up with delta sync from
the snapshot's embedded watermark.  The file format is the reference's
backup plane (`corrosion backup`: VACUUM INTO + per-node-state scrub,
`klukai/src/main.rs:157-223`) wrapped in a framed, chunked, zlib
container whose header embeds:

  - the builder's **schema sha** — a canonical digest of the CRR table
    DDL.  Install refuses on mismatch: a snapshot from a node running a
    different schema generation would resurrect dropped columns or lose
    new ones mid-swap (`SnapshotSchemaMismatch`).
  - the **bookie watermark** — per-origin-actor version rangesets the
    builder had fully applied at build time.  The watermark is computed
    BEFORE `VACUUM INTO`, so the database copy is always a superset of
    it: resuming delta sync from the watermark can re-fetch a version
    the copy already holds (idempotent CRDT merge), never miss one.

Frames are the codec's u32-BE length-delimited layout, so the cached
snapshot file is served verbatim frame-by-frame over a sync bi-stream
(`agent/catchup.py`) — no re-framing on the serve path.

File layout:   HeaderFrame · ChunkFrame* · DoneFrame
  header  := u8 format(=1) · vec<u8> schema_sha · raw16 site_id ·
             f64 wall · u64 raw_bytes · u32 chunk_bytes ·
             u32 n_actors · (raw16 actor · u64 n · (u64 lo · u64 hi)*)*
  chunk   := vec<u8> zlib(db_bytes[i*chunk : (i+1)*chunk])
  done    := u64 n_chunks · u64 raw_bytes · u64 compressed_bytes

Chunks are INDEPENDENTLY compressed (no shared dict/stream state), so a
receiver can decompress as frames arrive and a torn transfer is
detectable by the done-frame totals.

Thread contract: everything here does blocking sqlite/file I/O and MUST
be called from a worker thread when an event loop is running — the
async halves live in `agent/catchup.py` and route through
`asyncio.to_thread` (corro-analyze's async-blocking rule pins this).

The port's copy of `corrosion_tpu/store/snapshot.py`: the header, the
wire messages and `schema_sha` are byte-equal to the JAX package's, so
a snapshot built by either package installs in the other.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from corrosion_tpu_torch.store import restore as restore_mod
from corrosion_tpu_torch.types.codec import Reader, Writer, deframe, frame
from corrosion_tpu_torch.types.rangeset import RangeSet

SNAPSHOT_FORMAT = 1
DEFAULT_CHUNK_BYTES = 256 * 1024

Range = Tuple[int, int]


class SnapshotError(Exception):
    pass


class SnapshotSchemaMismatch(SnapshotError):
    pass


def schema_sha(schema, exclude: Tuple[str, ...] = ()) -> bytes:
    """Canonical 32-byte digest of a Schema's CRR surface: table DDL +
    index DDL, whitespace-normalized, sorted by name.  Two nodes agree
    on the sha iff their declarative schemas are equivalent — the gate
    that makes a snapshot installable.  `exclude` names runtime-owned
    tables (the SLO canary) that exist only on nodes that opted in and
    must not fail the gate between otherwise-identical peers."""
    h = hashlib.sha256()
    for name in sorted(schema.tables):
        if name in exclude:
            continue
        t = schema.tables[name]
        h.update(b"T\x00" + _norm(t.raw_sql))
        for iname in sorted(t.indexes):
            h.update(b"I\x00" + _norm(t.indexes[iname].raw_sql))
    return h.digest()


def _norm(sql: str) -> bytes:
    return (" ".join(sql.strip().lower().split()).rstrip(";") + "\n").encode()


@dataclass
class SnapshotHeader:
    """The metadata frame a cold node reads before any chunk bytes."""

    schema_sha: bytes
    site_id: bytes  # builder's 16-byte site id (scrubbed on install)
    wall: float  # builder's wall clock at build time
    raw_bytes: int  # uncompressed database size
    chunk_bytes: int
    # per-origin-actor version coverage at build time (16-byte actor id
    # -> sorted disjoint inclusive ranges)
    watermark: Dict[bytes, List[Range]] = field(default_factory=dict)

    def watermark_total(self) -> int:
        return sum(
            e - s + 1 for ranges in self.watermark.values() for s, e in ranges
        )


@dataclass
class SnapshotDone:
    n_chunks: int
    raw_bytes: int
    compressed_bytes: int


def encode_header(h: SnapshotHeader) -> bytes:
    w = Writer()
    w.u8(SNAPSHOT_FORMAT)
    w.vec_u8(h.schema_sha)
    w.raw(h.site_id)
    w.f64(h.wall)
    w.u64(h.raw_bytes)
    w.u32(h.chunk_bytes)
    w.u32(len(h.watermark))
    for aid in sorted(h.watermark):
        ranges = h.watermark[aid]
        w.raw(aid)
        w.u64(len(ranges))
        for s, e in ranges:
            w.u64(s)
            w.u64(e)
    return w.bytes()


def decode_header(data: bytes) -> SnapshotHeader:
    r = Reader(data)
    fmt = r.u8()
    if fmt != SNAPSHOT_FORMAT:
        raise SnapshotError(f"unknown snapshot format {fmt}")
    h = SnapshotHeader(
        schema_sha=r.vec_u8(),
        site_id=r.raw(16),
        wall=r.f64(),
        raw_bytes=r.u64(),
        chunk_bytes=r.u32(),
    )
    for _ in range(r.u32()):
        aid = r.raw(16)
        h.watermark[aid] = [(r.u64(), r.u64()) for _ in range(r.u64())]
    return h


def bookie_watermark(bookie) -> Dict[bytes, List[Range]]:
    """Fully-applied version coverage per origin actor: head minus
    needed gaps minus incomplete partials.  Bookie read locks are brief
    (the sync scheduler's pattern)."""
    wm: Dict[bytes, List[Range]] = {}
    for aid, booked in bookie.items().items():
        with booked.read() as bv:
            last = bv.last()
            if last is None:
                continue
            have = RangeSet([(1, last)])
            for s, e in bv.needed:
                have.remove(s, e)
            for v, p in bv.partials.items():
                if not p.is_complete():
                    have.remove(v, v)
            ranges = list(have)
        if ranges:
            wm[aid.bytes16] = ranges
    return wm


def build_snapshot_file(
    db_path: str,
    out_path: str,
    schema,
    site_id: bytes,
    watermark: Dict[bytes, List[Range]],
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> SnapshotHeader:
    """VACUUM INTO + scrub (restore.backup) then compress into the
    framed container at `out_path` (replaced atomically).  Blocking —
    worker threads only."""
    tmp_db = out_path + ".build-db"
    tmp_out = out_path + ".build"
    for p in (tmp_db, tmp_out):
        if os.path.exists(p):
            os.unlink(p)
    restore_mod.backup(db_path, tmp_db)
    try:
        raw_bytes = os.path.getsize(tmp_db)
        header = SnapshotHeader(
            schema_sha=schema_sha(schema),
            site_id=site_id,
            wall=time.time(),
            raw_bytes=raw_bytes,
            chunk_bytes=chunk_bytes,
            watermark=watermark,
        )
        n_chunks = 0
        compressed = 0
        with open(tmp_db, "rb") as src, open(tmp_out, "wb") as out:
            out.write(frame(encode_snapshot_msg_header(header)))
            while True:
                chunk = src.read(chunk_bytes)
                if not chunk:
                    break
                z = zlib.compress(chunk, 6)
                out.write(frame(encode_snapshot_msg_chunk(z)))
                n_chunks += 1
                compressed += len(z)
            out.write(
                frame(
                    encode_snapshot_msg_done(
                        SnapshotDone(n_chunks, raw_bytes, compressed)
                    )
                )
            )
        os.replace(tmp_out, out_path)
    finally:
        for p in (tmp_db, tmp_db + "-wal", tmp_db + "-shm", tmp_out):
            if os.path.exists(p):
                os.unlink(p)
    return header


def iter_snapshot_frames(path: str, batch: int = 64) -> Iterator[List[bytes]]:
    """The cached snapshot file's frames, in batches — the serve path
    reads a batch per executor hop instead of a syscall per frame."""
    with open(path, "rb") as f:
        buf = b""
        pos = 0
        out: List[bytes] = []
        while True:
            payload, pos = deframe(buf, pos)
            if payload is None:
                if out:
                    yield out
                    out = []
                more = f.read(1 << 20)
                if not more:
                    return
                buf = buf[pos:] + more
                pos = 0
                continue
            out.append(payload)
            if len(out) >= batch:
                yield out
                out = []


# -- wire messages (served verbatim from the cache file) -------------------
#
# SnapshotMessage := u32 version(=0) · u32 tag · body
#   tag 0 Header    body = vec<u8> encoded SnapshotHeader
#   tag 1 Chunk     body = vec<u8> zlib bytes
#   tag 2 Done      body = u64 n_chunks · u64 raw · u64 compressed
#   tag 3 Rejection body = u32 reason

SNAP_HEADER, SNAP_CHUNK, SNAP_DONE, SNAP_REJECTION = range(4)

# rejection reasons
REJECT_CLUSTER = 1
REJECT_SCHEMA = 2
REJECT_BUSY = 3
REJECT_DISABLED = 4


def encode_snapshot_msg_header(h: SnapshotHeader) -> bytes:
    w = Writer()
    w.u32(0)
    w.u32(SNAP_HEADER)
    w.vec_u8(encode_header(h))
    return w.bytes()


def encode_snapshot_msg_chunk(z: bytes) -> bytes:
    w = Writer()
    w.u32(0)
    w.u32(SNAP_CHUNK)
    w.vec_u8(z)
    return w.bytes()


def encode_snapshot_msg_done(d: SnapshotDone) -> bytes:
    w = Writer()
    w.u32(0)
    w.u32(SNAP_DONE)
    w.u64(d.n_chunks)
    w.u64(d.raw_bytes)
    w.u64(d.compressed_bytes)
    return w.bytes()


def encode_snapshot_msg_rejection(reason: int) -> bytes:
    w = Writer()
    w.u32(0)
    w.u32(SNAP_REJECTION)
    w.u32(reason)
    return w.bytes()


def decode_snapshot_msg(data: bytes):
    """-> SnapshotHeader | bytes (zlib chunk) | SnapshotDone | int
    (rejection reason)."""
    r = Reader(data)
    if r.u32() != 0:
        raise ValueError("unknown SnapshotMessage version")
    tag = r.u32()
    if tag == SNAP_HEADER:
        return decode_header(r.vec_u8())
    if tag == SNAP_CHUNK:
        return r.vec_u8()
    if tag == SNAP_DONE:
        return SnapshotDone(r.u64(), r.u64(), r.u64())
    if tag == SNAP_REJECTION:
        return r.u32()
    raise ValueError(f"unknown SnapshotMessage tag {tag}")


# -- install ---------------------------------------------------------------


@dataclass
class InstallResult:
    raw_bytes: int
    watermark_versions: int
    header: SnapshotHeader


def decompress_snapshot_file(snap_path: str, out_db_path: str) -> SnapshotHeader:
    """Framed container -> raw sqlite db file; verifies chunk totals
    against the done frame.  Blocking — worker threads only."""
    header: Optional[SnapshotHeader] = None
    done: Optional[SnapshotDone] = None
    n = 0
    written = 0
    with open(out_db_path, "wb") as out:
        for batch in iter_snapshot_frames(snap_path):
            for payload in batch:
                msg = decode_snapshot_msg(payload)
                if isinstance(msg, SnapshotHeader):
                    header = msg
                elif isinstance(msg, bytes):
                    raw = zlib.decompress(msg)
                    out.write(raw)
                    written += len(raw)
                    n += 1
                elif isinstance(msg, SnapshotDone):
                    done = msg
                elif isinstance(msg, int):
                    raise SnapshotError(f"snapshot file holds rejection {msg}")
    if header is None or done is None:
        raise SnapshotError("truncated snapshot: missing header/done frame")
    if n != done.n_chunks or written != done.raw_bytes:
        raise SnapshotError(
            f"torn snapshot: {n}/{done.n_chunks} chunks, "
            f"{written}/{done.raw_bytes} bytes"
        )
    return header


def install_raw_db(
    tmp_db_path: str,
    db_path: str,
    self_site_id: Optional[bytes],
    builder_site_id: bytes,
) -> None:
    """Locked swap of a decompressed snapshot db over `db_path`,
    re-pinning the installing node's own site id (a bootstrap must keep
    the cold node's identity, not adopt the builder's).  Blocking —
    worker threads only; live stores must quiesce connections first
    (CrdtStore.swapped_database)."""
    import uuid

    restore_mod.restore(tmp_db_path, db_path)
    if self_site_id is not None and self_site_id != builder_site_id:
        restore_mod.set_self_site_id(
            db_path, uuid.UUID(bytes=self_site_id).hex
        )


def install_snapshot_file(
    snap_path: str,
    db_path: str,
    expect_schema_sha: Optional[bytes] = None,
    self_site_id: Optional[bytes] = None,
) -> InstallResult:
    """Decompress + verify + locked swap over `db_path` — the CLI /
    cold-boot (container-file) install path.  Blocking — worker threads
    only."""
    tmp_db = db_path + ".snap-install"
    if os.path.exists(tmp_db):
        os.unlink(tmp_db)
    try:
        header = decompress_snapshot_file(snap_path, tmp_db)
        if (
            expect_schema_sha is not None
            and header.schema_sha != expect_schema_sha
        ):
            raise SnapshotSchemaMismatch(
                f"snapshot schema sha {header.schema_sha.hex()[:12]} != "
                f"local {expect_schema_sha.hex()[:12]}"
            )
        install_raw_db(tmp_db, db_path, self_site_id, header.site_id)
        return InstallResult(
            raw_bytes=header.raw_bytes,
            watermark_versions=header.watermark_total(),
            header=header,
        )
    finally:
        for p in (tmp_db, tmp_db + "-wal", tmp_db + "-shm"):
            if os.path.exists(p):
                os.unlink(p)


# -- serve-side cache ------------------------------------------------------


class SnapshotCache:
    """The serving agent's cached, staleness-bounded snapshot.

    One compressed container file beside the database
    (`<db>.snapshot`); `ensure_fresh` rebuilds it when older than
    `max_age_secs` (or absent) and is idempotent within the window, so
    a burst of cold nodes amortizes ONE VACUUM+compress.  All methods
    blocking — the async serve path wraps them in `asyncio.to_thread`
    under a per-agent build lock."""

    def __init__(self, db_path: str, cache_path: Optional[str] = None):
        self.db_path = db_path
        self.path = cache_path or (db_path + ".snapshot")
        self.header: Optional[SnapshotHeader] = None
        self.built_mono: Optional[float] = None
        self.compressed_bytes: int = 0

    def age(self) -> Optional[float]:
        if self.built_mono is None:
            return None
        return time.monotonic() - self.built_mono

    def ensure_fresh(
        self,
        schema,
        site_id: bytes,
        bookie,
        max_age_secs: float,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ) -> SnapshotHeader:
        from corrosion_tpu_torch.runtime.metrics import METRICS

        age = self.age()
        if (
            self.header is not None
            and age is not None
            and age <= max_age_secs
            and os.path.exists(self.path)
        ):
            return self.header
        t0 = time.monotonic()
        # watermark BEFORE the VACUUM: the copy is then a superset of
        # the coverage the header claims (see module docstring)
        wm = bookie_watermark(bookie)
        header = build_snapshot_file(
            self.db_path, self.path, schema, site_id, wm, chunk_bytes
        )
        self.header = header
        self.built_mono = time.monotonic()
        self.compressed_bytes = os.path.getsize(self.path)
        METRICS.counter("corro.snapshot.built.total").inc()
        METRICS.histogram("corro.snapshot.build.seconds").observe(
            self.built_mono - t0
        )
        METRICS.gauge("corro.snapshot.bytes").set(self.compressed_bytes)
        return header

    def drop(self) -> None:
        self.header = None
        self.built_mono = None
        try:
            os.unlink(self.path)
        except OSError:
            pass
