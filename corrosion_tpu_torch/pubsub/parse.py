"""SELECT analysis for the live-query matcher.

The port's copy of `corrosion_tpu/pubsub/parse.py`.

Counterpart of the AST walk in `klukai-types/src/pubsub.rs:1735-2050`
(`extract_select_columns`): the reference parses the subscription SELECT
with sqlite3-parser and collects, per source table, the referenced
columns and aliases, so committed changes can be filtered down to the
subscriptions they might affect, and so the query can be rewritten with
pk alias columns + a pk-membership predicate per driving table
(`pubsub.rs:616-658,2123`).

We do the same with a small tokenizer instead of a full AST: split the
statement into top-level clauses (SELECT list, FROM, WHERE, tail),
resolve table references + aliases in FROM/JOIN, and attribute column
identifiers to tables (qualified `alias.col` exactly; bare identifiers
to whichever source table has the column). Anything unresolvable makes
the dependency set conservative (all columns), never unsound.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from corrosion_tpu_torch.store.schema import Schema


class ParseError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<comment>--[^\n]*|/\*.*?\*/)
    | (?P<str>'(?:[^']|'')*')
    | (?P<qid>"(?:[^"]|"")*"|\[[^\]]*\]|`(?:[^`]|``)*`)
    | (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+)
    | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<param>[?][0-9]*|[:@$][A-Za-z0-9_]+)
    | (?P<op><=|>=|<>|!=|==|\|\||[-+*/%<>=(),.;])
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass(frozen=True)
class Token:
    kind: str
    text: str

    @property
    def upper(self) -> str:
        return self.text.upper()


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise ParseError(f"cannot tokenize SQL at offset {pos}: {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup or "op"
        if kind in ("ws", "comment"):
            continue
        out.append(Token(kind, m.group()))
    return out


def _unquote(tok: Token) -> str:
    t = tok.text
    if tok.kind == "qid":
        if t.startswith('"'):
            return t[1:-1].replace('""', '"')
        if t.startswith("["):
            return t[1:-1]
        if t.startswith("`"):
            return t[1:-1].replace("``", "`")
    return t


# clauses that end the FROM clause at depth 0
_FROM_ENDERS = {"WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "WINDOW"}
_JOIN_WORDS = {"JOIN", "LEFT", "RIGHT", "FULL", "INNER", "OUTER", "CROSS", "NATURAL"}
_RESERVED = _FROM_ENDERS | _JOIN_WORDS | {
    "SELECT", "FROM", "AS", "ON", "USING", "AND", "OR", "NOT", "IN", "IS",
    "NULL", "LIKE", "GLOB", "BETWEEN", "CASE", "WHEN", "THEN", "ELSE", "END",
    "DISTINCT", "ALL", "BY", "ASC", "DESC", "COLLATE", "EXISTS", "CAST",
    "UNION", "INTERSECT", "EXCEPT", "VALUES", "WITH", "INDEXED",
}


@dataclass
class TableRef:
    name: str  # schema table name
    alias: str  # alias (or name when unaliased) as written
    left_joined: bool = False


@dataclass
class ParsedSelect:
    sql: str
    select_list: str  # text between SELECT and FROM (incl. DISTINCT)
    from_clause: str  # text after FROM up to WHERE/GROUP/...
    where_clause: Optional[str]  # text after WHERE (excl.) up to tail
    tail: str  # GROUP BY/HAVING/ORDER BY/LIMIT ... ("" if none)
    tables: List[TableRef] = field(default_factory=list)
    # table name -> referenced column names (non-pk); pks tracked separately
    col_deps: Dict[str, Set[str]] = field(default_factory=dict)

    def table_names(self) -> List[str]:
        return [t.name for t in self.tables]

    def routing_keys(self):
        """(table, cid) pairs the SubsManager's inverted change-routing
        index files this query under — one per referenced column, plus
        the sentinel per table (row create/delete reaches every query on
        the table regardless of projected columns).  This is
        `Matcher.filter_candidates`'s match predicate, factored to the
        parse layer so the router and the filter cannot drift."""
        from corrosion_tpu_torch.types.change import SENTINEL

        for table, deps in self.col_deps.items():
            yield table, SENTINEL
            for cid in deps:
                yield table, cid


def _split_clauses(tokens: List[Token], sql: str) -> Tuple[str, str, Optional[str], str]:
    """Split a SELECT into (select_list, from, where, tail) at paren depth 0."""
    if not tokens or tokens[0].upper not in ("SELECT", "WITH"):
        raise ParseError("subscription statement must be a SELECT")
    if tokens[0].upper == "WITH":
        raise ParseError("WITH/CTE subscriptions are not supported")

    depth = 0
    idx_from = idx_where = idx_tail = None
    for i, tok in enumerate(tokens):
        if tok.text == "(":
            depth += 1
        elif tok.text == ")":
            depth -= 1
        elif depth == 0 and tok.kind == "id":
            u = tok.upper
            if u == "FROM" and idx_from is None:
                idx_from = i
            elif u == "WHERE" and idx_from is not None and idx_where is None:
                idx_where = i
            elif (
                u in ("GROUP", "HAVING", "ORDER", "LIMIT", "WINDOW")
                and idx_from is not None
                and idx_tail is None
            ):
                idx_tail = i
            elif u in ("UNION", "INTERSECT", "EXCEPT") and idx_from is not None:
                raise ParseError("compound (UNION/...) subscriptions are not supported")
    if idx_from is None:
        raise ParseError("subscription SELECT must have a FROM clause")

    def text(a: int, b: Optional[int]) -> str:
        return _join_tokens(tokens[a : b if b is not None else len(tokens)])

    sel = text(1, idx_from)
    from_end = idx_where if idx_where is not None else idx_tail
    frm = text(idx_from + 1, from_end)
    where = None
    if idx_where is not None:
        where = text(idx_where + 1, idx_tail)
    tail = text(idx_tail, None) if idx_tail is not None else ""
    # only ORDER BY survives as a tail (it shapes the initial fill); the
    # incremental diff model cannot honor aggregation or row limits
    tail_head = tokens[idx_tail].upper if idx_tail is not None else ""
    if tail_head in ("GROUP", "HAVING", "LIMIT", "WINDOW"):
        raise ParseError(
            f"{tail_head} is not supported in subscriptions"
        )
    if tail and "LIMIT" in tail.upper().split():
        raise ParseError("LIMIT is not supported in subscriptions")
    return sel, frm, where, tail


def _join_tokens(tokens: List[Token]) -> str:
    parts: List[str] = []
    prev: Optional[Token] = None
    for tok in tokens:
        if prev is not None:
            if tok.text in (",", ")", ".", ";") or prev.text in ("(", "."):
                pass
            else:
                parts.append(" ")
        parts.append(tok.text)
        prev = tok
    return "".join(parts).strip().rstrip(";").strip()


def _parse_from(from_clause: str, schema: Schema) -> List[TableRef]:
    """Resolve table refs + aliases in the FROM/JOIN clause."""
    tokens = tokenize(from_clause)
    refs: List[TableRef] = []
    i = 0
    depth = 0
    expect_table = True
    pending_left = False
    while i < len(tokens):
        tok = tokens[i]
        if tok.text == "(":
            if expect_table and depth == 0:
                raise ParseError("subquery in FROM is not supported for subscriptions")
            depth += 1
            i += 1
            continue
        if tok.text == ")":
            depth -= 1
            i += 1
            continue
        if depth > 0:
            i += 1
            continue
        u = tok.upper if tok.kind == "id" else None
        if u in _JOIN_WORDS:
            if u == "LEFT":
                pending_left = True
            if u == "JOIN":
                expect_table = True
            i += 1
            continue
        if u in ("ON", "USING"):
            expect_table = False
            i += 1
            continue
        if tok.text == ",":
            expect_table = True
            i += 1
            continue
        if expect_table and tok.kind in ("id", "qid") and (u is None or u not in _RESERVED):
            name = _unquote(tok)
            if name not in schema.tables:
                raise ParseError(f"unknown table in subscription: {name}")
            alias = name
            j = i + 1
            if j < len(tokens) and tokens[j].kind == "id" and tokens[j].upper == "AS":
                j += 1
            if (
                j < len(tokens)
                and tokens[j].kind in ("id", "qid")
                and tokens[j].upper not in _RESERVED
            ):
                alias = _unquote(tokens[j])
                i = j
            refs.append(TableRef(name=name, alias=alias, left_joined=pending_left))
            pending_left = False
            expect_table = False
            i += 1
            continue
        i += 1
    if not refs:
        raise ParseError("no tables found in FROM clause")
    return refs


def _collect_col_deps(
    tokens: List[Token], refs: List[TableRef], schema: Schema
) -> Dict[str, Set[str]]:
    """Attribute column identifiers to source tables.

    Qualified `alias.col` goes to the aliased table; bare identifiers go
    to every source table that has such a column (conservative). A bare
    `*` marks every column of every table as referenced
    (pubsub.rs:1834-1860 equivalent behavior).
    """
    by_alias = {r.alias: r.name for r in refs}
    deps: Dict[str, Set[str]] = {r.name: set() for r in refs}

    def mark_all() -> None:
        for r in refs:
            deps[r.name].update(schema.table(r.name).columns)

    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.text == "*" and (i == 0 or tokens[i - 1].text != "."):
            def is_operand(t: Token, opening: str) -> bool:
                if t.kind == "id" and t.upper in _RESERVED:
                    return False
                return t.kind in ("num", "str", "id", "qid", "param") or t.text == opening

            prev_is_operand = i > 0 and is_operand(tokens[i - 1], ")")
            next_is_operand = i + 1 < len(tokens) and is_operand(tokens[i + 1], "(")
            if not (prev_is_operand and next_is_operand):  # projection *, not multiply
                mark_all()
            i += 1
            continue
        if tok.kind in ("id", "qid") and tok.upper not in _RESERVED:
            name = _unquote(tok)
            # qualified: alias . col  /  alias . *
            if i + 2 < len(tokens) and tokens[i + 1].text == ".":
                col_tok = tokens[i + 2]
                tbl = by_alias.get(name)
                if tbl is not None:
                    if col_tok.text == "*":
                        deps[tbl].update(schema.table(tbl).columns)
                    elif col_tok.kind in ("id", "qid"):
                        deps[tbl].add(_unquote(col_tok))
                i += 3
                continue
            # function call name?
            if i + 1 < len(tokens) and tokens[i + 1].text == "(":
                i += 1
                continue
            if name in by_alias:
                i += 1
                continue
            # bare column
            for r in refs:
                cols = set(schema.table(r.name).columns)
                if name in cols:
                    deps[r.name].add(name)
            i += 1
            continue
        i += 1
    return deps


def parse_select(sql: str, schema: Schema) -> ParsedSelect:
    tokens = tokenize(sql)
    sel, frm, where, tail = _split_clauses(tokens, sql)
    refs = _parse_from(frm, schema)
    seen: Dict[str, int] = {}
    for r in refs:
        seen[r.name] = seen.get(r.name, 0) + 1
        if seen[r.name] > 1 and r.alias == r.name:
            raise ParseError(f"self-join of {r.name} requires aliases")
    deps = _collect_col_deps(tokens, refs, schema)
    # pk columns always matter: row create/delete reaches every query on
    # the table regardless of projected columns (updates.rs:424-488)
    for r in refs:
        deps[r.name].update(schema.table(r.name).pk_cols)
    return ParsedSelect(
        sql=sql,
        select_list=sel,
        from_clause=frm,
        where_clause=where,
        tail=tail,
        tables=refs,
        col_deps=deps,
    )
