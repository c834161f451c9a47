"""SQLite-style dynamic values.

Counterpart of `klukai-types/src/api.rs:463` (`SqliteValue`). On the Python
side values are native: None | int | float | str | bytes. This module holds
the type-tag constants shared by the pk pack format (`pack.py`) and the wire
codec (`codec.py`), plus helpers for JSON (serde-untagged-compatible) and
stable hashing of floats (reference hashes f64 via integer_decode,
`api.rs:484-500`; we use the IEEE bit pattern which is equally stable).

The port's copy of `corrosion_tpu/types/values.py`.
"""

from __future__ import annotations

import base64
from typing import Union

SqliteValue = Union[None, int, float, str, bytes]

# ColumnType tags (api.rs:342-348); also used by pack_columns.
TYPE_INTEGER = 1
TYPE_REAL = 2  # "Float"
TYPE_TEXT = 3
TYPE_BLOB = 4
TYPE_NULL = 5

# pack_columns uses a 3-bit type field, so NULL's tag 5 fits; the same
# constants serve both formats.


def value_type(v: SqliteValue) -> int:
    if v is None:
        return TYPE_NULL
    if isinstance(v, bool):
        return TYPE_INTEGER
    if isinstance(v, int):
        return TYPE_INTEGER
    if isinstance(v, float):
        return TYPE_REAL
    if isinstance(v, str):
        return TYPE_TEXT
    if isinstance(v, (bytes, bytearray, memoryview)):
        return TYPE_BLOB
    raise TypeError(f"unsupported sqlite value: {type(v)!r}")


def to_json_value(v: SqliteValue):
    """serde-untagged JSON shape; blobs become base64 strings with a marker."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return {"blob": base64.b64encode(bytes(v)).decode()}
    return v


def from_json_value(v) -> SqliteValue:
    if isinstance(v, dict) and set(v) == {"blob"}:
        return base64.b64decode(v["blob"])
    if isinstance(v, bool):
        return int(v)
    return v


def hash_key(v: SqliteValue):
    """Hashable, type-discriminated key for dedupe/cache maps."""
    t = value_type(v)
    if t == TYPE_REAL:
        import struct

        return (t, struct.pack(">d", v))
    if t == TYPE_BLOB:
        return (t, bytes(v))
    return (t, v)


def cmp_values(a: SqliteValue, b: SqliteValue) -> int:
    """Total order over sqlite values, matching SQLite's cross-type ordering:
    NULL < INTEGER/REAL < TEXT < BLOB. Used for LWW tie-breaking on equal
    col_version (cr-sqlite: "largest value wins").
    """
    ranks = {TYPE_NULL: 0, TYPE_INTEGER: 1, TYPE_REAL: 1, TYPE_TEXT: 2, TYPE_BLOB: 3}
    ta, tb = value_type(a), value_type(b)
    ra, rb = ranks[ta], ranks[tb]
    if ra != rb:
        return -1 if ra < rb else 1
    if ra == 0:
        return 0
    if isinstance(a, (bytes, bytearray, memoryview)):
        a, b = bytes(a), bytes(b)
    if a < b:
        return -1
    if a > b:
        return 1
    return 0
