"""Backup + live restore of the store database under real SQLite file locks.

Counterparts:
  - `corrosion backup` (`klukai/src/main.rs:157-223`): `VACUUM INTO`, then
    scrub per-node state from the copy. The reference also rewrites the
    cr-sqlite site-id *ordinal* (its clock tables intern site ids); our
    clock tables store the 16-byte site id directly, so attribution
    survives a backup/restore with no rewrite.
  - `sqlite3_restore` (`klukai-types/src/sqlite3_restore.rs:57,152`):
    byte-range fcntl locks on SQLite's PENDING/RESERVED/SHARED lock bytes
    plus the WAL-shm lock bytes, so the database file can be swapped out
    from under a running process without corruption.
  - `corrosion restore` (`klukai/src/main.rs:224-330`): refuses when an
    agent is live (admin ping), optionally re-pins the self site id, then
    byte-copies under the full lock set.

The port's copy of `corrosion_tpu/store/restore.py`; the two packages'
database files are interchangeable, so either restores the other's.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import sqlite3
import struct
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

# Database file lock bytes (sqlite3_restore.rs:16-29)
PENDING = 0x40000000
RESERVED = 0x40000001
SHARED_FIRST = 0x40000002
SHARED_SIZE = 510

# SHM file lock bytes: WRITE..READ4 = 120..127, DMS = 128. Every live WAL
# connection holds a SHARED lock on DMS for its lifetime, so DMS must be
# taken shared, not exclusive, or locking against a live process always
# times out (sqlite3_restore.rs:185 takes a read lock there for the same
# reason).
SHM_FIRST = 120
SHM_COUNT = 8
SHM_DMS = 128
# A zeroed shm header (first 136 bytes: 2×48-byte WalIndexHdr + 40-byte
# WalCkptInfo) forces the next reader to re-run recovery
# (sqlite3_restore.rs:113-114).
SHM_HEADER_SIZE = 136


class RestoreError(Exception):
    pass


class LockTimedOut(RestoreError):
    pass


def _try_wrlock(fd: int, start: int, length: int) -> bool:
    try:
        fcntl.lockf(fd, fcntl.LOCK_EX | fcntl.LOCK_NB, length, start, os.SEEK_SET)
        return True
    except (BlockingIOError, PermissionError):
        return False


def _try_rdlock(fd: int, start: int, length: int) -> bool:
    try:
        fcntl.lockf(fd, fcntl.LOCK_SH | fcntl.LOCK_NB, length, start, os.SEEK_SET)
        return True
    except (BlockingIOError, PermissionError):
        return False


class _HeldLocks:
    def __init__(self):
        self.fds: List[int] = []

    def release(self) -> None:
        for fd in self.fds:
            try:
                fcntl.lockf(fd, fcntl.LOCK_UN, 0, 0, os.SEEK_SET)
            except OSError:
                pass
            try:
                os.close(fd)
            except OSError:
                pass
        self.fds = []


def lock_all(db_path: str, timeout: float = 30.0) -> _HeldLocks:
    """Exclusive byte-range locks on the db file's PENDING/RESERVED/SHARED
    bytes and all WAL-shm lock bytes — equivalent to holding every SQLite
    lock, so no reader or writer can proceed (sqlite3_restore.rs lock_all).
    Returns a handle whose .release() drops everything."""
    held = _HeldLocks()
    deadline = time.monotonic() + timeout

    def acquire(path: str, ranges, shared=()) -> None:
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        held.fds.append(fd)
        for start, length, trylock in [
            (s, l, _try_wrlock) for s, l in ranges
        ] + [(s, l, _try_rdlock) for s, l in shared]:
            while not trylock(fd, start, length):
                if time.monotonic() > deadline:
                    held.release()
                    raise LockTimedOut(
                        f"lock on {path} bytes {start}+{length} timed out"
                    )
                time.sleep(0.05)

    try:
        acquire(
            db_path,
            [
                (PENDING, 1),
                (RESERVED, 1),
                (SHARED_FIRST, SHARED_SIZE),
            ],
        )
        shm = db_path + "-shm"
        if os.path.exists(shm):
            acquire(
                shm,
                [(SHM_FIRST, SHM_COUNT)],
                shared=[(SHM_DMS, 1)],
            )
    except BaseException:
        held.release()
        raise
    return held


@dataclass
class Restored:
    old_len: int
    new_len: int
    is_wal: bool


def _is_wal(db_path: str) -> bool:
    """SQLite header bytes 18/19 are the read/write format: 2 = WAL."""
    with open(db_path, "rb") as f:
        hdr = f.read(20)
    if len(hdr) < 20:
        raise RestoreError(f"header read too short ({len(hdr)} bytes)")
    read_fmt, write_fmt = hdr[18], hdr[19]
    if read_fmt != write_fmt:
        raise RestoreError(
            f"read/write format mismatch: {read_fmt} != {write_fmt}"
        )
    return read_fmt == 2


def restore(src: str, dst: str, timeout: float = 30.0) -> Restored:
    """Copy `src` over `dst` while holding every SQLite lock on `dst`,
    then drop stale -wal/-shm files so the next reader starts clean
    (sqlite3_restore.rs:57-150)."""
    old_len = os.path.getsize(dst) if os.path.exists(dst) else 0
    locks = lock_all(dst, timeout)
    try:
        is_wal = _is_wal(src)
        tmp = dst + ".restore-tmp"
        shutil.copyfile(src, tmp)
        expected = os.path.getsize(src)
        actual = os.path.getsize(tmp)
        if expected != actual:
            os.unlink(tmp)
            raise RestoreError(
                f"inconsistent copy: expected {expected}, got {actual}"
            )
        os.replace(tmp, dst)
        # Live WAL connections keep fds/mappings to the old -wal/-shm
        # inodes, so neither file may be unlinked (a survivor would rebuild
        # the shared shm index from a wal inode new connections can't see).
        # Instead truncate the wal in place and zero the shm header: every
        # connection, old or new, then agrees on an empty wal and re-runs
        # recovery on next use (sqlite3_restore.rs:113-114).
        wal = dst + "-wal"
        if os.path.exists(wal):
            with open(wal, "r+b") as f:
                f.truncate(0)
        shm = dst + "-shm"
        if os.path.exists(shm):
            with open(shm, "r+b") as f:
                f.write(b"\x00" * SHM_HEADER_SIZE)
        return Restored(old_len=old_len, new_len=actual, is_wal=is_wal)
    finally:
        locks.release()


def backup(db_path: str, out_path: str) -> None:
    """`VACUUM INTO` + scrub per-node state from the copy
    (main.rs:157-223). The copy keeps all CRDT clocks and bookkeeping —
    those are cluster state — but drops member snapshots and consul
    bookkeeping, which are per-process."""
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    if os.path.exists(out_path):
        raise RestoreError(f"backup target exists: {out_path}")
    conn = sqlite3.connect(db_path)
    try:
        conn.execute("VACUUM INTO ?", (out_path,))
    finally:
        conn.close()

    copy = sqlite3.connect(out_path)
    try:
        copy.execute("DELETE FROM __corro_members")
        for tbl in ("__corro_consul_services", "__corro_consul_checks"):
            try:
                copy.execute(f"DROP TABLE {tbl}")
            except sqlite3.OperationalError:
                pass
        copy.commit()
        copy.execute("PRAGMA journal_mode = WAL")
        copy.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    finally:
        copy.close()


def set_self_site_id(db_path: str, site_id_hex: str) -> None:
    """Re-pin the restored database's self identity (`corrosion restore
    --self-actor-id`, main.rs:224-330 site-id swap)."""
    import uuid

    blob = uuid.UUID(site_id_hex).bytes
    conn = sqlite3.connect(db_path)
    try:
        conn.execute("UPDATE __crdt_site SET site_id = ? WHERE id = 1", (blob,))
        conn.commit()
    finally:
        conn.close()
