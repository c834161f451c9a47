"""Subscription SQL expansion — the port's copy of `expand_sql` (and its
`_literal`) from `corrosion_tpu/api/pubsub_http.py`.

The HTTP handlers of that module (subscribe, updates streams) need the
API server and come with it in a later slice; `expand_sql` needs none of
it: it turns a subscription statement and its parameters into the SQL
text the live-query engine dedupes on.
"""

from __future__ import annotations

from typing import Any

from corrosion_tpu_torch.pubsub.parse import ParseError


def expand_sql(stmt) -> str:
    """Interpolate params into the SQL text so identical subscriptions
    dedupe on the final query (pubsub.rs:258-363 uses sqlite's
    expanded_sql). Token-level substitution: placeholders inside string
    literals or prefix-colliding names are never touched."""
    from corrosion_tpu_torch.pubsub.parse import tokenize, _join_tokens

    if not stmt.params and not stmt.named_params:
        return stmt.query
    tokens = tokenize(stmt.query)
    # a bare key binds any placeholder style (sqlite accepts :k, @k, $k)
    named = {}
    for k, v in (stmt.named_params or {}).items():
        if k[0] in ":@$":
            named[k] = v
        else:
            for prefix in ":@$":
                named[prefix + k] = v
    out = []
    params = stmt.params or []
    # sqlite ?N semantics: ?N binds params[N-1]; bare ? binds one past the
    # largest index assigned so far
    max_idx = 0
    for tok in tokens:
        if tok.kind == "param":
            if tok.text.startswith("?"):
                idx = int(tok.text[1:]) if len(tok.text) > 1 else max_idx + 1
                if not 1 <= idx <= len(params):
                    raise ParseError(
                        f"parameter {tok.text} out of range"
                        f" (got {len(params)} params)"
                    )
                max_idx = max(max_idx, idx)
                out.append(type(tok)("num", _literal(params[idx - 1])))
                continue
            if tok.text in named:
                out.append(type(tok)("num", _literal(named[tok.text])))
                continue
            raise ParseError(f"unbound parameter {tok.text}")
        out.append(tok)
    if params and max_idx != len(params):
        raise ParseError(
            f"statement uses {max_idx} positional params,"
            f" got {len(params)}"
        )
    return _join_tokens(out)


def _literal(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "X'" + bytes(v).hex() + "'"
    return "'" + str(v).replace("'", "''") + "'"
