"""Schema engine: parse, constrain, diff, and apply CRR table schemas.

Counterpart of `klukai-types/src/schema.rs`. The reference parses SQL with
sqlite3-parser; we let SQLite itself parse by applying the DDL to a scratch
in-memory database and introspecting pragmas — same accepted syntax as the
storage engine, zero extra dependencies.

Constraints on CRR tables (schema.rs:115-172):
  - every table needs a primary key; no PK expressions
  - no UNIQUE indexes / unique column constraints (other than the PK)
  - no foreign keys
  - NOT NULL non-pk columns must have a DEFAULT
`apply_schema` (schema.rs:285-667) diffs old vs new: creates new tables,
adds columns, creates/drops/replaces indexes; destructive ops (dropping
tables/columns) are refused.

The port's copy of `corrosion_tpu/store/schema.py`.
"""

from __future__ import annotations

import re
import sqlite3
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class SchemaError(Exception):
    pass


@dataclass
class Column:
    name: str
    sql_type: str
    nullable: bool
    default: Optional[str]  # raw SQL default expression text
    primary_key: bool
    pk_order: int = 0  # 1-based position within the pk, 0 if not pk


@dataclass
class Table:
    name: str
    columns: Dict[str, Column]  # ordered
    raw_sql: str
    indexes: Dict[str, "Index"] = field(default_factory=dict)

    @property
    def pk_cols(self) -> List[str]:
        pks = [c for c in self.columns.values() if c.primary_key]
        pks.sort(key=lambda c: c.pk_order)
        return [c.name for c in pks]

    @property
    def non_pk_cols(self) -> List[str]:
        return [c.name for c in self.columns.values() if not c.primary_key]


@dataclass
class Index:
    name: str
    table: str
    raw_sql: str
    unique: bool


@dataclass
class Schema:
    tables: Dict[str, Table] = field(default_factory=dict)

    def table(self, name: str) -> Table:
        try:
            return self.tables[name]
        except KeyError:
            raise SchemaError(f"unknown table {name!r}") from None


_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_RESERVED_PREFIXES = ("__corro_", "__crdt_", "sqlite_", "crsql_")


def parse_sql(sql: str) -> Schema:
    """Parse CREATE TABLE / CREATE INDEX statements into a Schema by
    executing them against a scratch in-memory SQLite database."""
    scratch = sqlite3.connect(":memory:")
    try:
        try:
            scratch.executescript(sql)
        except sqlite3.Error as e:
            raise SchemaError(f"invalid schema SQL: {e}") from e

        schema = Schema()
        rows = scratch.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master"
            " WHERE name NOT LIKE 'sqlite_%' ORDER BY rowid"
        ).fetchall()
        for typ, name, tbl_name, raw in rows:
            if typ == "table":
                schema.tables[name] = _introspect_table(scratch, name, raw)
            elif typ == "index":
                if raw is None:
                    continue  # auto-indexes (pk/unique) have NULL sql
                unique = bool(
                    re.match(r"(?is)\s*create\s+unique\s+index", raw)
                )
                idx = Index(name=name, table=tbl_name, raw_sql=raw, unique=unique)
                if tbl_name in schema.tables:
                    schema.tables[tbl_name].indexes[name] = idx
            elif typ in ("view", "trigger"):
                raise SchemaError(f"{typ}s are not allowed in CRR schemas: {name}")
        _constrain(scratch, schema)
        return schema
    finally:
        scratch.close()


def _introspect_table(conn: sqlite3.Connection, name: str, raw: str) -> Table:
    cols: Dict[str, Column] = {}
    for cid, cname, ctype, notnull, dflt, pk in conn.execute(
        f'PRAGMA table_info("{name}")'
    ):
        cols[cname] = Column(
            name=cname,
            sql_type=ctype or "",
            nullable=not notnull,
            default=dflt,
            primary_key=pk > 0,
            pk_order=pk,
        )
    return Table(name=name, columns=cols, raw_sql=raw)


def _constrain(conn: sqlite3.Connection, schema: Schema) -> None:
    """Enforce CRR-compatibility constraints (schema.rs:115-172)."""
    for t in schema.tables.values():
        if not _IDENT_RE.match(t.name):
            raise SchemaError(f"invalid table name {t.name!r}")
        if t.name.startswith(_RESERVED_PREFIXES):
            raise SchemaError(f"table name {t.name!r} uses a reserved prefix")
        if not t.pk_cols:
            raise SchemaError(f"table {t.name!r} requires a primary key")
        # WITHOUT ROWID etc are fine; pk expressions are impossible in
        # sqlite CREATE TABLE (only via indexes, checked below)
        for c in t.columns.values():
            if not _IDENT_RE.match(c.name):
                raise SchemaError(
                    f"{t.name}.{c.name!r}: invalid column name"
                    " (identifiers must match [A-Za-z_][A-Za-z0-9_]*)"
                )
            if c.name.startswith(_RESERVED_PREFIXES) or c.name == "-1":
                raise SchemaError(f"{t.name}.{c.name!r}: reserved column name")
            if not c.primary_key and not c.nullable and c.default is None:
                raise SchemaError(
                    f"{t.name}.{c.name}: NOT NULL columns need a DEFAULT"
                    " (conflict-free inserts must be able to fill them)"
                )
        # unique indexes (incl. UNIQUE column constraints → auto indexes)
        for r in conn.execute(f'PRAGMA index_list("{t.name}")'):
            # row: (seq, name, unique, origin, partial); origin 'pk' is fine
            _, iname, unique, origin, _ = r
            if unique and origin != "pk":
                raise SchemaError(
                    f"table {t.name!r}: UNIQUE indexes are not allowed"
                    " (uniqueness cannot be enforced across sites)"
                )
        if conn.execute(f'PRAGMA foreign_key_list("{t.name}")').fetchall():
            raise SchemaError(f"table {t.name!r}: foreign keys are not allowed")


@dataclass
class SchemaDiff:
    new_tables: List[Table] = field(default_factory=list)
    new_columns: List[Tuple[str, Column, str]] = field(default_factory=list)
    # (table, column, raw ADD COLUMN sql)
    new_indexes: List[Index] = field(default_factory=list)
    dropped_indexes: List[str] = field(default_factory=list)
    changed_indexes: List[Index] = field(default_factory=list)
    # tables whose column definitions changed (type/default/nullability):
    # applied via the 12-step rebuild (schema.rs:528-596) — the user table
    # is recreated and data copied; clock/rows CRDT state is untouched
    # because it lives in separate __crdt tables keyed by pk
    rebuild_tables: List[Table] = field(default_factory=list)


def diff_schemas(old: Schema, new: Schema) -> SchemaDiff:
    """Compute the migration from `old` to `new`; destructive changes are
    refused (schema.rs:242-258)."""
    d = SchemaDiff()
    for name, t in new.tables.items():
        if name not in old.tables:
            d.new_tables.append(t)
            continue
        ot = old.tables[name]
        for cname in ot.columns:
            if cname not in t.columns:
                raise SchemaError(
                    f"dropping column {name}.{cname} is destructive — refused"
                )
        if ot.pk_cols != t.pk_cols:
            raise SchemaError(f"changing the primary key of {name} is not supported")
        needs_rebuild = False
        new_cols: List[Tuple[str, Column, str]] = []
        for cname, c in t.columns.items():
            if cname not in ot.columns:
                if not c.nullable and c.default is None:
                    raise SchemaError(
                        f"new column {name}.{cname} must be nullable or have a default"
                    )
                decl = f'"{cname}" {c.sql_type}'
                if c.default is not None:
                    decl += f" DEFAULT {c.default}"
                if not c.nullable:
                    decl += " NOT NULL"
                new_cols.append((name, c, decl))
            else:
                oc = ot.columns[cname]
                if (
                    (oc.sql_type or "").upper() != (c.sql_type or "").upper()
                    or str(oc.default) != str(c.default)
                    or oc.nullable != c.nullable
                ):
                    # changed column definition → whole-table rebuild
                    # (schema.rs:528-596), not a refusal
                    needs_rebuild = True
        if needs_rebuild:
            # the rebuild recreates the table from the NEW definition
            # (including any added columns and its indexes) — don't also
            # emit piecewise column/index deltas for it
            d.rebuild_tables.append(t)
            continue
        d.new_columns.extend(new_cols)
        # indexes
        for iname, idx in t.indexes.items():
            if iname not in ot.indexes:
                d.new_indexes.append(idx)
            elif _norm_sql(ot.indexes[iname].raw_sql) != _norm_sql(idx.raw_sql):
                d.changed_indexes.append(idx)
        for iname in ot.indexes:
            if iname not in t.indexes:
                d.dropped_indexes.append(iname)
    for name in old.tables:
        if name not in new.tables:
            raise SchemaError(f"dropping table {name} is destructive — refused")
    return d


def _norm_sql(sql: str) -> str:
    return re.sub(r"\s+", " ", sql.strip().lower())
