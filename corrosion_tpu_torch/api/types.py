"""JSON payload (de)serialization for the public API.

The port's copy of `corrosion_tpu/api/types.py`.

Byte-compatible with the serde layouts in `klukai-types/src/api.rs`:
  - `Statement` (untagged, api.rs:231-240): "sql" | ["sql", [params]] |
    ["sql", {named}] | {"query": ..., "params"/"named_params": ...}
  - `QueryEvent` (externally tagged, api.rs:67-78): {"columns": [...]},
    {"row": [rowid, [values]]}, {"eoq": {"time": t, "change_id"?: id}},
    {"change": [type, rowid, [values], change_id]}, {"error": "..."}
  - `ExecResponse`/`ExecResult` (api.rs:260-272)
  - SqliteValue: untagged JSON scalar; blobs as byte arrays
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from corrosion_tpu_torch.types.values import SqliteValue


@dataclass
class Statement:
    query: str
    params: List[SqliteValue] = field(default_factory=list)
    named_params: Optional[Dict[str, SqliteValue]] = None


def parse_value(v: Any) -> SqliteValue:
    if v is None or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, list):  # blob as byte array
        return bytes(v)
    raise ValueError(f"unsupported param: {v!r}")


def dump_value(v: SqliteValue) -> Any:
    if isinstance(v, (bytes, bytearray, memoryview)):
        return list(bytes(v))
    return v


def parse_statement(obj: Any) -> Statement:
    if isinstance(obj, str):
        return Statement(query=obj)
    if isinstance(obj, list) and obj and isinstance(obj[0], str):
        if len(obj) == 2 and isinstance(obj[1], list):
            return Statement(obj[0], [parse_value(p) for p in obj[1]])
        if len(obj) == 2 and isinstance(obj[1], dict):
            return Statement(
                obj[0],
                named_params={
                    k: parse_value(v) for k, v in obj[1].items()
                },
            )
        # flat params variant: ["sql", p1, p2, ...]
        return Statement(obj[0], [parse_value(p) for p in obj[1:]])
    if isinstance(obj, dict) and "query" in obj:
        return Statement(
            obj["query"],
            [parse_value(p) for p in obj.get("params") or []],
            named_params=(
                {k: parse_value(v) for k, v in obj["named_params"].items()}
                if obj.get("named_params")
                else None
            ),
        )
    raise ValueError(f"malformed statement: {obj!r}")


# -- events ---------------------------------------------------------------


def ev_columns(cols: List[str]) -> str:
    return json.dumps({"columns": cols}, separators=(",", ":"))


def ev_row(rowid: int, values: List[SqliteValue]) -> str:
    return json.dumps(
        {"row": [rowid, [dump_value(v) for v in values]]},
        separators=(",", ":"),
    )


def ev_eoq(time_s: float, change_id: Optional[int] = None) -> str:
    body: Dict[str, Any] = {"time": time_s}
    if change_id is not None:
        body["change_id"] = change_id
    return json.dumps({"eoq": body}, separators=(",", ":"))


def ev_error(err: str) -> str:
    return json.dumps({"error": err}, separators=(",", ":"))


def ev_lagging(lag_bytes: int, lag_batches: int) -> str:
    """Typed terminal frame for a SHED laggard stream (r16 admission
    control): the subscription itself is healthy — the client's socket
    fell `lag_bytes`/`lag_batches` behind the live fan-out and the node
    dropped the stream rather than stall its siblings.  Clients resume
    from their last observed change id (client.py reconnects on it)."""
    return json.dumps(
        {"lagging": {"lag_bytes": lag_bytes, "lag_batches": lag_batches}},
        separators=(",", ":"),
    )


def ev_notify(kind: str, pk_values: List[SqliteValue]) -> str:
    return json.dumps(
        {"notify": [kind, [dump_value(v) for v in pk_values]]},
        separators=(",", ":"),
    )


def exec_response(
    results: List[Dict[str, Any]],
    time_s: float,
    version: Optional[int],
    actor_id: Optional[str],
) -> Dict[str, Any]:
    return {
        "results": results,
        "time": time_s,
        "version": version,
        "actor_id": actor_id,
    }
