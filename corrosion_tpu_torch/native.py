"""Build and load the store's host C++ libraries: the port's loader of
`native/crdt_ext.cpp` (the SQLite extension: `crdt_pack`, `crdt_cmp`) and
`native/crdt_batch.cpp` (the columnar merge engine `crdt_merge_batch` and
the finalize engine `crdt_finalize_batch`), the counterpart of
`corrosion_tpu/native.py`.

Each library compiles with g++ at first use into `corrosion_tpu_torch/
_build/` (git-ignored). Its file name carries a hash of the source and
the command, so an edited source is rebuilt and a stale library is never
loaded; the compiler writes a file named for its process and the result
is renamed into place, so processes that build at once each load a whole
library.

Where a library cannot build (no g++, no SQLite headers) the store keeps
the reference's behaviour: the extension's functions are registered in
Python, and the `python` engines stand in for `native`. Both are host
code with the same semantics. `status()` says which loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import logging
import os
import sqlite3
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
EXT_SRC = _NATIVE / "crdt_ext.cpp"
BATCH_SRC = _NATIVE / "crdt_batch.cpp"
ENTRYPOINT = "sqlite3_crdtext_init"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.RLock()
# source path -> library path, or "" when the build failed (not retried)
_built = {}
_batch_lib = None  # ctypes.CDLL, or False = unavailable (not retried)
_finalize_lib = None


def _sqlite_include_dir() -> Optional[Path]:
    """The directory holding `sqlite3ext.h`: a standard include directory,
    or the copy that tensorflow vendors (found without importing it)."""
    name = "sqlite3ext.h"
    for d in (Path(sysconfig.get_paths()["include"]), Path("/usr/include"),
              Path("/usr/local/include")):
        if (d / name).exists():
            return d
    spec = importlib.util.find_spec("tensorflow")
    if spec is not None and spec.origin:
        cand = (Path(spec.origin).parent / "include" / "external"
                / "org_sqlite")
        if (cand / name).exists():
            return cand
    return None


def _command(src: Path, out: Path, include: Optional[Path]) -> list:
    cmd = ["g++", *CXX_FLAGS]
    if include is not None:
        cmd.append(f"-I{include}")
    return cmd + [str(src), "-o", str(out)]


def library_path(src: Path, include: Optional[Path] = None) -> Path:
    """Where the library built from `src` lives: named by a hash of the
    source and the compile command."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_command(src, Path("-"), include)).encode())
    stem = "crdtext" if src == EXT_SRC else src.stem
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def build(src: Path, include: Optional[Path] = None) -> Optional[str]:
    """Compile `src` once per process (reusing a library already built
    from the same source and command); its path, or None when g++ fails."""
    with _lock:
        done = _built.get(src)
        if done is not None:
            return done or None
        out = library_path(src, include)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(_command(src, tmp, include), check=True,
                               capture_output=True, text=True, timeout=300)
                os.replace(tmp, out)  # a reader never sees half a file
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired, OSError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                log.warning("native build of %s failed: %s", src.name,
                            detail[:500])
                tmp.unlink(missing_ok=True)
                _built[src] = ""
                return None
        _built[src] = str(out)
        return str(out)


def extension_path() -> Optional[str]:
    """The SQLite extension's path (built at first use), or None when it
    cannot be built here."""
    include = _sqlite_include_dir()
    if include is None:
        with _lock:
            if EXT_SRC not in _built:
                log.warning("native crdt extension unavailable: no sqlite "
                            "headers")
                _built[EXT_SRC] = ""
        return None
    return build(EXT_SRC, include)


def _open_batch(symbol: str):
    path = build(BATCH_SRC)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        return lib, getattr(lib, symbol)
    except (OSError, AttributeError) as e:
        log.warning("could not load %s from the native batch library: %s",
                    symbol, e)
        return None


def merge_batch_lib():
    """ctypes handle to the columnar merge engine
    (`native/crdt_batch.cpp::crdt_merge_batch`), or None when the native
    path is unavailable. Loaded once per process."""
    global _batch_lib
    with _lock:
        if _batch_lib is None:
            _batch_lib = _bind_merge() or False
        return _batch_lib or None


def _bind_merge():
    opened = _open_batch("crdt_merge_batch")
    if opened is None:
        return None
    lib, fn = opened
    c = ctypes
    fn.restype = c.c_int
    fn.argtypes = [
        # batch
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.POINTER(c.c_double),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_char_p,
        # snapshot
        c.c_int32, c.POINTER(c.c_int64),
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64),
        # disk values
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.POINTER(c.c_double),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_char_p,
        # outputs
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int64), c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
    ]
    return lib


def finalize_batch_lib():
    """ctypes handle to the local-commit finalize engine
    (`native/crdt_batch.cpp::crdt_finalize_batch`, `CORRO_FINALIZE=
    native`), or None when the native path is unavailable; the store then
    uses the columnar Python engine and counts
    `corro.write.finalize.native.unavailable`. Loaded once per process."""
    global _finalize_lib
    with _lock:
        if _finalize_lib is None:
            _finalize_lib = _bind_finalize() or False
        return _finalize_lib or None


def _bind_finalize():
    opened = _open_batch("crdt_finalize_batch")
    if opened is None:
        return None
    lib, fn = opened
    c = ctypes
    fn.restype = c.c_int
    fn.argtypes = [
        # group geometry
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        # row snapshot
        c.c_int32, c.POINTER(c.c_int64), c.POINTER(c.c_uint8),
        # cv snapshot
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64),
        # spec outputs
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        # rows_up / clock_clear / clock_put plans
        c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    return lib


def load_into(conn) -> bool:
    """Load the extension into a sqlite3 connection; False means the
    caller registers the Python functions instead."""
    path = extension_path()
    if path is None:
        return False
    try:
        conn.enable_load_extension(True)
        try:
            conn.load_extension(path, entrypoint=ENTRYPOINT)
        finally:
            conn.enable_load_extension(False)
        return True
    except (sqlite3.Error, AttributeError) as e:
        # AttributeError: a Python built without extension loading
        log.warning("could not load native crdt extension: %s", e)
        return False


def status() -> dict:
    """Which host libraries load here: the SQLite extension, the merge
    engine and the finalize engine."""
    return {"sqlite_extension": extension_path() is not None,
            "merge_batch": merge_batch_lib() is not None,
            "finalize_batch": finalize_batch_lib() is not None}
