"""Fresh file-backed SQLite paths for ephemeral agents.

The port's copy of `corrosion_tpu/runtime/tmpdb.py`.

Shared-cache in-memory SQLite (what CrdtStore turns ":memory:" into) has
table-level reader/writer locks — no real WAL — which flakes concurrent
read+apply as "database is locked" under load. Ephemeral multi-agent
harnesses (DevCluster, the integration tests) should use file-backed dbs
on the production WAL path instead; this module is the single copy of
that workaround. The per-process directory is removed at interpreter
exit; callers owning shorter lifetimes (DevCluster.stop) may also remove
individual files early.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import uuid
from typing import Optional

_dir: Optional[str] = None


def fresh_db_path(prefix: str = "agent") -> str:
    """A unique path for a new file-backed SQLite db in the per-process
    scratch directory (created lazily, removed at exit). The prefix is
    sanitized — node names can be bind addresses ('[::1]:8080') and must
    not leak glob/path metacharacters into filenames."""
    global _dir
    if _dir is None:
        _dir = tempfile.mkdtemp(prefix="corro-dbs-")
        atexit.register(_cleanup)
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in prefix)
    return os.path.join(_dir, f"{safe or 'agent'}-{uuid.uuid4().hex}.db")


def _cleanup() -> None:
    global _dir
    if _dir is not None:
        shutil.rmtree(_dir, ignore_errors=True)
        _dir = None
