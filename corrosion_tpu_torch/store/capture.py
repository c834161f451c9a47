"""Direct change capture: statement-shape metadata for the write API (r15).

The r14 profile measured ~60% of a 10-row local commit in the
AFTER-trigger → `__crdt_pending` INSERT → SELECT-back → DELETE
round-trip plus per-change encode.  This module lets
`WriteTx.execute`/`executemany` capture the cells a statement writes IN
MEMORY instead: `parse_shape` classifies the statement text ONCE
(cached per store) into a `Shape` — table, kind, parameter slots,
per-column affinity converters — and the per-execution planner resolves
the actual written cells from the bound parameters, falling back to the
unchanged trigger path whenever anything is outside the
provably-identical set.

Equivalence contract (pinned by tests/test_capture.py randomized
direct-vs-trigger runs): for every captured statement the emitted
(tbl, pk, cid, val) stream is byte- and order-identical to what the
AFTER triggers would have logged to `__crdt_pending`, including

  - sqlite column-affinity conversion of bound parameters (NEW."c" is
    the STORED value, not the bound one) — `_col_convert`;
  - the pending table's own `val ANY` column affinity (NUMERIC on this
    sqlite: a TEXT-column '5' arrives in the trigger log as INTEGER 5,
    a REAL-column 3.0 as INTEGER 3) — `pending_affinity`;
  - `INSERT OR REPLACE` firing ONLY the insert trigger under the
    store's `recursive_triggers = OFF` (no delete marker for the
    displaced row), with NULL values on NOT NULL-with-DEFAULT columns
    replaced by the column default (sqlite's REPLACE semantics);
  - `UPDATE` logging only columns whose NEW value IS NOT the OLD value,
    in table column order (pre-images read with one SELECT per
    statement instead of per-cell trigger rows);
  - `INSERT OR IGNORE` / `ON CONFLICT DO NOTHING` skipping conflicting
    rows silently (existence read from the same pre-image pass).

Anything not provably identical — expressions in SET/VALUES, non-pk
WHERE clauses, numeric-looking text bound into any column (the NUMERIC
conversion grammar is sqlite's, not ours), float→TEXT formatting,
`OR FAIL`/`OR ROLLBACK`, RETURNING, `?N` params — makes `parse_shape`
(statement level) or the planner (value level) decline, and the
statement runs through the triggers exactly as before this round.

The port's copy of `corrosion_tpu/store/capture.py`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.types.change import SENTINEL

# The statement-kind ↔ trigger-suffix contract: one entry per generated
# AFTER trigger in `CrdtStore._create_triggers` (store/crdt.py).  The
# `capture-parity` static rule (analysis/capture_parity.py) pins this
# mapping — and the `_cells_*` column sources below — against the
# trigger DDL so the two capture paths cannot drift silently.
CAPTURED_KINDS = {"insert": "ins", "update": "upd", "delete": "del"}

# the del/upd triggers' row-delete marker (`'{SENTINEL}X'` in the DDL)
DELETE_MARKER = SENTINEL + "X"


class _Unsafe:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return "<unsafe>"


# sentinel: "this value/statement cannot be captured provably-identically"
UNSAFE = _Unsafe()


# -- sqlite affinity -------------------------------------------------------


def column_affinity(decl: Optional[str]) -> str:
    """Sqlite's declared-type → affinity rules (datatype3.html §3.1)."""
    d = (decl or "").upper()
    if "INT" in d:
        return "INTEGER"
    if "CHAR" in d or "CLOB" in d or "TEXT" in d:
        return "TEXT"
    if "BLOB" in d or not d:
        return "BLOB"
    if "REAL" in d or "FLOA" in d or "DOUB" in d:
        return "REAL"
    return "NUMERIC"


# any text that even STARTS numeric-looking is handed back to the
# triggers: sqlite's text→number conversion grammar (well-formedness,
# whitespace trim, int/real split) is not re-implemented here
_NUMERIC_TEXT = re.compile(r"^[\s]*[+-]?(\d|\.\d)")


def _col_convert(aff: str, v):
    """NEW."c" for a bound parameter: sqlite's column-affinity storage
    conversion, restricted to cases where the converted value is
    provably what sqlite stores (UNSAFE otherwise)."""
    if v is None:
        return None
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)  # blobs pass through every affinity unchanged
    if aff == "BLOB":
        return v
    if aff == "TEXT":
        if isinstance(v, str):
            return v
        if isinstance(v, int):
            return str(v)
        return UNSAFE  # float→text rendering drift risk
    # numeric affinities (INTEGER / REAL / NUMERIC)
    if isinstance(v, str):
        return v if not _NUMERIC_TEXT.match(v) else UNSAFE
    if isinstance(v, float):
        if v != v:
            return UNSAFE  # NaN binds as NULL
        if aff == "REAL":
            return v
        return int(v) if v.is_integer() and abs(v) < 2**63 else v
    if isinstance(v, int):
        return float(v) if aff == "REAL" else v
    return UNSAFE


def pending_affinity(v):
    """What `__crdt_pending.val ANY` (NUMERIC affinity on this sqlite)
    stores for a user-table NEW value — the munging every
    trigger-logged cell went through, reproduced for in-memory capture
    (e.g. REAL 2.0 → INTEGER 2; numeric-looking text → UNSAFE)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float):
        return int(v) if v.is_integer() and abs(v) < 2**63 else v
    if isinstance(v, str) and _NUMERIC_TEXT.match(v):
        return UNSAFE
    return v


def values_distinct(a, b) -> bool:
    """`NEW."c" IS NOT OLD."c"` over user-table stored values: NULL-safe,
    int/real comparable across storage classes, text/blob equal only
    within their own class."""
    if a is None or b is None:
        return (a is None) != (b is None)
    if isinstance(a, bool):
        a = int(a)
    if isinstance(b, bool):
        b = int(b)
    na = isinstance(a, (int, float))
    nb = isinstance(b, (int, float))
    if na or nb:
        return a != b if (na and nb) else True
    if isinstance(a, bytes) != isinstance(b, bytes):
        return True
    return a != b


# -- table metadata --------------------------------------------------------


def _const_default(text: Optional[str], aff: str):
    """A column DEFAULT as a stored-domain constant (UNSAFE when the
    default is an expression we will not evaluate, e.g. CURRENT_TIME)."""
    if text is None:
        return None
    s = text.strip()
    while s.startswith("(") and s.endswith(")"):
        s = s[1:-1].strip()
    u = s.upper()
    if u == "NULL":
        return None
    if u == "TRUE":
        return _col_convert(aff, 1)
    if u == "FALSE":
        return _col_convert(aff, 0)
    if len(s) >= 2 and s[0] == "'" and s[-1] == "'":
        return _col_convert(aff, s[1:-1].replace("''", "'"))
    body = s[1:] if s[:1] in "+-" else s
    try:
        v = int(body)
    except ValueError:
        try:
            v = float(body)
        except ValueError:
            return UNSAFE
    return _col_convert(aff, -v if s[:1] == "-" else v)


@dataclass(frozen=True)
class TableMeta:
    """Per-table capture metadata derived from the Schema Table — the
    direct-capture mirror of what `_create_triggers` bakes into DDL."""

    name: str
    pk_cols: Tuple[str, ...]
    non_pk_cols: Tuple[str, ...]
    affinity: Dict[str, str]
    defaults: Dict[str, object]  # non-pk col → stored-domain constant
    notnull: frozenset  # non-pk NOT NULL columns
    ipk_alias: bool  # single INTEGER pk aliasing rowid
    plain_insert_ok: bool  # no CHECK constraints (OR IGNORE gate)


def table_meta(t) -> TableMeta:
    raw = (t.raw_sql or "").upper()
    pk_cols = tuple(t.pk_cols)
    aff = {c.name: column_affinity(c.sql_type) for c in t.columns.values()}
    defaults: Dict[str, object] = {}
    notnull = set()
    for c in t.columns.values():
        if c.primary_key:
            continue
        defaults[c.name] = _const_default(c.default, aff[c.name])
        if not c.nullable:
            notnull.add(c.name)
    ipk = (
        len(pk_cols) == 1
        and t.columns[pk_cols[0]].sql_type.strip().upper() == "INTEGER"
        and "WITHOUT" not in raw
    )
    return TableMeta(
        name=t.name,
        pk_cols=pk_cols,
        non_pk_cols=tuple(t.non_pk_cols),
        affinity=aff,
        defaults=defaults,
        notnull=frozenset(notnull),
        ipk_alias=ipk,
        plain_insert_ok="CHECK" not in raw,
    )


# -- pending-stream cell builders (the trigger bodies, in memory) ----------


def _cells_insert(meta: TableMeta, vals: Dict[str, object]) -> list:
    """The ins-trigger stream for one inserted row: the row sentinel,
    then every non-pk column's NEW value in table column order (columns
    absent from the statement take their DEFAULT)."""
    cells = [(SENTINEL, None)]
    for c in meta.non_pk_cols:
        cells.append((c, vals[c] if c in vals else meta.defaults[c]))
    return cells


def _cells_update(
    meta: TableMeta, old: Dict[str, object], new: Dict[str, object]
) -> list:
    """The upd-trigger stream for an unchanged-pk UPDATE of one row:
    only columns whose NEW value IS NOT the OLD value, in table column
    order (a no-op assignment logs nothing, exactly like the trigger's
    `WHERE NEW."c" IS NOT OLD."c"`)."""
    return [
        (c, new[c])
        for c in meta.non_pk_cols
        if c in new and values_distinct(new[c], old.get(c))
    ]


def _cells_delete(meta: TableMeta) -> list:
    """The del-trigger stream: one row-delete marker."""
    return [(DELETE_MARKER, None)]


# -- SQL tokenizer ---------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s+|--[^\n]*|/\*.*?\*/"""
    r"""|'(?:[^']|'')*'"""
    r'''|"(?:[^"]|"")*"|`[^`]*`|\[[^\]]*\]'''
    r"""|[A-Za-z_][A-Za-z0-9_]*"""
    r"""|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"""
    r"""|\?\d*|[:@$][A-Za-z_][A-Za-z0-9_]*"""
    r"""|!=|==|<>|<=|>=|\|\||[(),=;.*<>+\-/%]""",
    re.S,
)


def _tokenize(sql: str) -> Optional[List[str]]:
    out: List[str] = []
    pos = 0
    for m in _TOKEN_RE.finditer(sql):
        if m.start() != pos:
            return None  # unrecognized character → not ours to parse
        pos = m.end()
        tok = m.group(0)
        if tok[0].isspace() or tok.startswith("--") or tok.startswith("/*"):
            continue
        out.append(tok)
    return out if pos == len(sql) else None


def _ident(tok: str) -> Optional[str]:
    """Unquote an identifier token; None if the token is not one."""
    if not tok:
        return None
    c0 = tok[0]
    if c0 == '"':
        return tok[1:-1].replace('""', '"')
    if c0 == "`" or c0 == "[":
        return tok[1:-1]
    if c0.isalpha() or c0 == "_":
        return tok
    return None


class _Cur:
    __slots__ = ("t", "i")

    def __init__(self, toks: List[str]):
        self.t = toks
        self.i = 0

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.t[j] if j < len(self.t) else ""

    def peek_u(self, k: int = 0) -> str:
        return self.peek(k).upper()

    def next(self) -> str:
        tok = self.peek()
        self.i += 1
        return tok

    def eat(self, *kws: str) -> bool:
        """Consume the exact keyword/punct sequence, or nothing."""
        save = self.i
        for kw in kws:
            if self.peek_u() != kw:
                self.i = save
                return False
            self.i += 1
        return True

    def done(self) -> bool:
        while self.peek() == ";":
            self.i += 1
        return self.i >= len(self.t)


# -- slots ------------------------------------------------------------------
#
# A slot is how one value arrives at execution time:
#   ("l", value)  literal baked into the statement text
#   ("p", index)  positional `?` parameter (0-based)
#   ("n", name)   named `:x` / `@x` / `$x` parameter
#   ("x", col)    upsert `excluded."col"` reference


def _num(tok: str):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def _parse_slot(toks: _Cur, state: dict):
    t = toks.peek()
    if t == "?":
        toks.next()
        i = state["pos"]
        state["pos"] = i + 1
        state["uses_pos"] = True
        return ("p", i)
    if t[:1] == "?":
        return UNSAFE  # ?NNN numbered params — not supported
    if t[:1] in ":@$":
        toks.next()
        state["uses_named"] = True
        return ("n", t[1:])
    if t in ("+", "-"):
        nxt = toks.peek(1)
        if nxt and (nxt[0].isdigit() or nxt[0] == "."):
            toks.next()
            v = _num(toks.next())
            return ("l", -v if t == "-" else v)
        return UNSAFE
    if t and (t[0].isdigit() or (t[0] == "." and len(t) > 1)):
        toks.next()
        return ("l", _num(t))
    if t[:1] == "'":
        toks.next()
        return ("l", t[1:-1].replace("''", "'"))
    u = t.upper()
    if u == "NULL":
        toks.next()
        return ("l", None)
    if u == "TRUE":
        toks.next()
        return ("l", 1)
    if u == "FALSE":
        toks.next()
        return ("l", 0)
    return UNSAFE


def resolve_slot(slot, params):
    """The bound value for a slot (UNSAFE when params don't carry it)."""
    k, v = slot
    if k == "l":
        return v
    try:
        return params[v]
    except (KeyError, IndexError, TypeError):
        return UNSAFE


# -- shapes -----------------------------------------------------------------


@dataclass(frozen=True)
class Shape:
    """One recognized statement's capture metadata (cached per store by
    statement text; schema changes clear the cache)."""

    kind: str  # a CAPTURED_KINDS key
    meta: TableMeta
    uses_pos: bool
    uses_named: bool
    n_pos: int
    # insert
    columns: Tuple[str, ...] = ()
    value_rows: Tuple[Tuple[object, ...], ...] = ()
    conflict: str = ""  # "" | "replace" | "ignore" | "nothing" | "upsert"
    upsert_set: Tuple[Tuple[str, object], ...] = ()
    # update / delete
    set_slots: Tuple[Tuple[str, object], ...] = ()
    pk_slots: Tuple[object, ...] = ()  # aligned to meta.pk_cols
    # r23 statement-profiler key ("kind:table"), precomputed once per
    # cached shape so the per-statement timed_query tap never builds a
    # string on the hot write path
    stmt_key: str = ""


def parse_shape(sql: str, schema) -> Optional[Shape]:
    """Classify a statement for direct capture; None → trigger path."""
    toks_l = _tokenize(sql)
    if toks_l is None:
        return None
    toks = _Cur(toks_l)
    state = {"pos": 0, "uses_pos": False, "uses_named": False}
    u0 = toks.peek_u()
    if u0 in ("INSERT", "REPLACE"):
        shape = _parse_insert(toks, schema, state)
    elif u0 == "UPDATE":
        shape = _parse_update(toks, schema, state)
    elif u0 == "DELETE":
        shape = _parse_delete(toks, schema, state)
    else:
        return None
    if shape is None or not toks.done():
        return None
    if shape.uses_pos and shape.uses_named:
        return None  # mixed param styles — let sqlite sort it out
    return replace(shape, stmt_key=f"{shape.kind}:{shape.meta.name}")


def _schema_table(toks: _Cur, schema):
    name = _ident(toks.peek())
    if name is None:
        return None
    t = schema.tables.get(name)
    if t is None:
        return None
    toks.next()
    return t


def _parse_insert(toks: _Cur, schema, state) -> Optional[Shape]:
    conflict = ""
    if toks.eat("REPLACE"):
        conflict = "replace"
    else:
        toks.next()  # INSERT
        if toks.eat("OR"):
            res = toks.peek_u()
            if res == "REPLACE":
                conflict = "replace"
            elif res == "IGNORE":
                conflict = "ignore"
            elif res == "ABORT":
                conflict = ""
            else:
                return None  # OR FAIL / OR ROLLBACK: partial-effect modes
            toks.next()
    if not toks.eat("INTO"):
        return None
    t = _schema_table(toks, schema)
    if t is None or not toks.eat("("):
        return None
    meta = table_meta(t)
    cols: List[str] = []
    while True:
        c = _ident(toks.peek())
        if c is None or c not in t.columns or c in cols:
            return None
        cols.append(c)
        toks.next()
        if toks.eat(")"):
            break
        if not toks.eat(","):
            return None
    if not toks.eat("VALUES"):
        return None
    rows: List[Tuple[object, ...]] = []
    while True:
        if not toks.eat("("):
            return None
        row: List[object] = []
        while True:
            s = _parse_slot(toks, state)
            if s is UNSAFE:
                return None
            row.append(s)
            if toks.eat(")"):
                break
            if not toks.eat(","):
                return None
        if len(row) != len(cols):
            return None
        rows.append(tuple(row))
        if not toks.eat(","):
            break
    upsert_set: List[Tuple[str, object]] = []
    if toks.eat("ON", "CONFLICT"):
        if conflict:
            return None  # OR REPLACE/IGNORE + ON CONFLICT: let sqlite rule
        if toks.eat("("):
            target: List[str] = []
            while True:
                c = _ident(toks.peek())
                if c is None:
                    return None
                target.append(c)
                toks.next()
                if toks.eat(")"):
                    break
                if not toks.eat(","):
                    return None
            if set(target) != set(meta.pk_cols):
                return None  # only the pk can conflict in a CRR schema
        if not toks.eat("DO"):
            return None
        if toks.eat("NOTHING"):
            conflict = "nothing"
        elif toks.eat("UPDATE", "SET"):
            conflict = "upsert"
            seen: set = set()
            while True:
                c = _ident(toks.peek())
                if c is None or c not in t.columns or c in meta.pk_cols:
                    return None
                if c in seen:
                    return None
                seen.add(c)
                toks.next()
                if not toks.eat("="):
                    return None
                if toks.peek_u() == "EXCLUDED" and toks.peek(1) == ".":
                    toks.next()
                    toks.next()
                    ec = _ident(toks.peek())
                    if ec is None or ec != c:
                        # excluded.<other col>: legal SQL, but keep the
                        # capture matrix simple — trigger path
                        return None
                    toks.next()
                    upsert_set.append((c, ("x", ec)))
                else:
                    s = _parse_slot(toks, state)
                    if s is UNSAFE:
                        return None
                    upsert_set.append((c, s))
                if not toks.eat(","):
                    break
            if toks.peek_u() == "WHERE":
                return None  # conditional DO UPDATE: trigger path
        else:
            return None
    # every pk col must be listed, or be the rowid alias (NULL-assigned)
    missing_pk = [c for c in meta.pk_cols if c not in cols]
    if missing_pk and not (meta.ipk_alias and missing_pk == list(meta.pk_cols)):
        return None
    if conflict == "ignore" and not meta.plain_insert_ok:
        return None  # OR IGNORE swallows CHECK violations we can't see
    # unlisted non-pk columns take their DEFAULT on the insert branch:
    # that constant (and its pending form) must be representable
    for c in meta.non_pk_cols:
        if c not in cols:
            d = meta.defaults[c]
            if d is UNSAFE or pending_affinity(d) is UNSAFE:
                return None
    return Shape(
        kind="insert",
        meta=meta,
        uses_pos=state["uses_pos"],
        uses_named=state["uses_named"],
        n_pos=state["pos"],
        columns=tuple(cols),
        value_rows=tuple(rows),
        conflict=conflict,
        upsert_set=tuple(upsert_set),
    )


def _parse_pk_where(toks: _Cur, meta: TableMeta, state):
    """`WHERE pk1 = ? AND pk2 = ?` covering exactly the pk — the ≤1-row
    guarantee that keeps capture order independent of scan order."""
    if not toks.eat("WHERE"):
        return None
    by_col: Dict[str, object] = {}
    while True:
        c = _ident(toks.peek())
        if c is None or c not in meta.pk_cols or c in by_col:
            return None
        toks.next()
        if not (toks.eat("=") or toks.eat("IS") or toks.eat("==")):
            return None
        s = _parse_slot(toks, state)
        if s is UNSAFE:
            return None
        by_col[c] = s
        if not toks.eat("AND"):
            break
    if set(by_col) != set(meta.pk_cols):
        return None
    return tuple(by_col[c] for c in meta.pk_cols)


def _parse_update(toks: _Cur, schema, state) -> Optional[Shape]:
    toks.next()  # UPDATE
    if toks.peek_u() == "OR":
        return None  # UPDATE OR ...: conflict-resolution modes
    t = _schema_table(toks, schema)
    if t is None or not toks.eat("SET"):
        return None
    meta = table_meta(t)
    sets: List[Tuple[str, object]] = []
    seen: set = set()
    while True:
        c = _ident(toks.peek())
        if c is None or c not in t.columns or c in meta.pk_cols or c in seen:
            return None  # pk reassignment = delete+create: trigger path
        seen.add(c)
        toks.next()
        if not toks.eat("="):
            return None
        s = _parse_slot(toks, state)
        if s is UNSAFE:
            return None
        sets.append((c, s))
        if not toks.eat(","):
            break
    pk_slots = _parse_pk_where(toks, meta, state)
    if pk_slots is None:
        return None
    return Shape(
        kind="update",
        meta=meta,
        uses_pos=state["uses_pos"],
        uses_named=state["uses_named"],
        n_pos=state["pos"],
        set_slots=tuple(sets),
        pk_slots=pk_slots,
    )


def _parse_delete(toks: _Cur, schema, state) -> Optional[Shape]:
    toks.next()  # DELETE
    if not toks.eat("FROM"):
        return None
    t = _schema_table(toks, schema)
    if t is None:
        return None
    meta = table_meta(t)
    pk_slots = _parse_pk_where(toks, meta, state)
    if pk_slots is None:
        return None
    return Shape(
        kind="delete",
        meta=meta,
        uses_pos=state["uses_pos"],
        uses_named=state["uses_named"],
        n_pos=state["pos"],
        pk_slots=pk_slots,
    )


# -- execution-time planning -----------------------------------------------
#
# Plans are plain tuples, fully pre-validated: by the time a statement
# executes, every captured value already exists in its FINAL pending
# form, so the post-execution emit is a bare list extend.
#
#   insert row plan: (pk_tuple|None, cells, skip, assigns, assigns_pend)
#       pk None        → the rowid alias assigns it (lastrowid)
#       cells          → the insert-branch pending stream (pending domain)
#       skip           → OR IGNORE row sqlite will silently drop
#       assigns        → upsert DO UPDATE SET values (stored domain,
#                        for the IS-NOT comparison against the OLD row)
#       assigns_pend   → the same values in pending domain
#   update row plan: (pk_tuple, new_stored, new_pend)
#   delete row plan: pk_tuple


def _params_ok(shape: Shape, params) -> bool:
    if shape.uses_named:
        return isinstance(params, dict)
    if isinstance(params, dict):
        return False
    try:
        return len(params) == shape.n_pos
    except TypeError:
        return False


def plan_insert_rows(
    shape: Shape, param_rows: Sequence, single: bool
) -> Optional[list]:
    meta = shape.meta
    aff = meta.affinity
    conflicty = shape.conflict in ("ignore", "nothing", "upsert")
    out: list = []
    for params in param_rows:
        if not _params_ok(shape, params):
            return None
        for vrow in shape.value_rows:
            vals: Dict[str, object] = {}
            for c, slot in zip(shape.columns, vrow):
                v = resolve_slot(slot, params)
                if v is UNSAFE:
                    return None
                v = _col_convert(aff[c], v)
                if v is UNSAFE:
                    return None
                vals[c] = v
            skip = False
            # NULL into a NOT NULL column: REPLACE substitutes the
            # default, IGNORE drops the row silently — both reproduced;
            # plain/upsert INSERTs will raise at execution (no capture)
            for c in meta.notnull:
                if c in vals and vals[c] is None:
                    if shape.conflict == "replace":
                        d = meta.defaults[c]
                        if d is UNSAFE or pending_affinity(d) is UNSAFE:
                            return None
                        vals[c] = d
                    elif shape.conflict == "ignore":
                        skip = True
            pk: Optional[Tuple] = None
            if all(c in vals for c in meta.pk_cols):
                pk = tuple(vals[c] for c in meta.pk_cols)
                # a NULL value for the rowid-alias pk means sqlite
                # assigns the rowid (filled from lastrowid after the
                # statement); NULL in any other pk is stored as-is by
                # rowid tables — captured like every other value
                if meta.ipk_alias and pk[0] is None:
                    pk = None
            if pk is None and not skip:
                if not meta.ipk_alias:
                    return None
                if not single or len(out) > 0 or len(param_rows) > 1:
                    return None  # lastrowid only identifies ONE new row
            # the insert-branch stream, final pending domain
            cells = []
            for cid, v in _cells_insert(meta, vals):
                pv = pending_affinity(v)
                if pv is UNSAFE:
                    return None
                cells.append((cid, pv))
            assigns: Dict[str, object] = {}
            assigns_pend: Dict[str, object] = {}
            if shape.conflict == "upsert":
                for c, slot in shape.upsert_set:
                    if slot[0] == "x":
                        v = (
                            vals[slot[1]]
                            if slot[1] in vals
                            else meta.defaults.get(slot[1])
                        )
                    else:
                        v = resolve_slot(slot, params)
                        if v is UNSAFE:
                            return None
                        v = _col_convert(aff[c], v)
                    if v is UNSAFE:
                        return None
                    pv = pending_affinity(v)
                    if pv is UNSAFE:
                        return None
                    assigns[c] = v
                    assigns_pend[c] = pv
            out.append((pk, cells, skip, assigns, assigns_pend))
            if conflicty and pk is None:
                return None  # conflict modes need the pk up front
    return out


def _plan_pk(shape: Shape, params) -> Optional[Tuple]:
    if not _params_ok(shape, params):
        return None
    meta = shape.meta
    pk: List[object] = []
    for c, slot in zip(meta.pk_cols, shape.pk_slots):
        v = resolve_slot(slot, params)
        if v is UNSAFE:
            return None
        v = _col_convert(meta.affinity[c], v)
        if v is UNSAFE:
            return None
        pk.append(v)
    return tuple(pk)


def plan_update_row(shape: Shape, params) -> Optional[tuple]:
    pk = _plan_pk(shape, params)
    if pk is None:
        return None
    meta = shape.meta
    new: Dict[str, object] = {}
    new_pend: Dict[str, object] = {}
    for c, slot in shape.set_slots:
        v = resolve_slot(slot, params)
        if v is UNSAFE:
            return None
        v = _col_convert(meta.affinity[c], v)
        if v is UNSAFE:
            return None
        pv = pending_affinity(v)
        if pv is UNSAFE:
            return None
        new[c] = v
        new_pend[c] = pv
    return (pk, new, new_pend)


def plan_delete_row(shape: Shape, params) -> Optional[Tuple]:
    return _plan_pk(shape, params)
