"""capture-parity: trigger DDL and direct-capture metadata in lockstep.

The bug class (new with r15's direct change capture): local writes are
captured by TWO parallel implementations — the generated AFTER-trigger
DDL (`CrdtStore._create_triggers`, store/crdt.py) for raw SQL, and the
in-memory statement planner (store/capture.py) for recognized shapes —
and the randomized equivalence test only proves the shapes it happens
to generate.  A structural drift (a fourth trigger kind added without a
capture counterpart, a `_cells_*` builder iterating a different column
source than the trigger DDL, a changed delete-marker spelling) would
silently fork the replication streams for some statement class.

Mechanics (pure AST, no imports of the checked modules):

- TRIGGER SIDE: `_create_triggers`/`_drop_triggers` are scanned for the
  `__crdt_<suffix>` trigger-name suffixes (string constants, including
  f-string fragments), the column-source attributes they iterate
  (`non_pk_cols`, `pk_cols`), and the `{SENTINEL}X` delete-marker
  f-string (a FormattedValue of SENTINEL immediately followed by a
  constant starting with "X").
- CAPTURE SIDE: `CAPTURED_KINDS` must be a dict literal whose values
  cover every trigger suffix; every kind needs a `_cells_<kind>`
  builder; the insert/update builders must reference the same
  `non_pk_cols` column source the DDL iterates; `DELETE_MARKER` must be
  the `SENTINEL + "X"` expression matching the DDL marker.
- FINALIZE SIDE (r21): the columnar phase B is a THIRD consumer of the
  same conventions — `_dedupe_pending` must still recognize the
  `SENTINEL + "X"` marker the DDL emits (it is how captured deletes
  reach the finalize at all), and `_phase_b_columnar` must reference
  `SENTINEL` (the sentinel-kind decision batch) and the
  `write_change_cells` batch encoder so the columnar builders cannot
  drift away from the trigger/capture cell conventions unnoticed.

Findings anchor on the module owning the drifted contract — the capture
module (CAPTURED_KINDS / DELETE_MARKER / the drifting `_cells_*` def)
or the store module (`_dedupe_pending` / `_phase_b_columnar`) — where a
`# corro: noqa[capture-parity]` belongs next to the contract being
waived.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

CRDT_FILE = "corrosion_tpu_torch/store/crdt.py"
CAPTURE_FILE = "corrosion_tpu_torch/store/capture.py"

# trigger-NAME fragments only (`..."{name}__crdt_ins"...`): the closing
# quote keeps internal-table references (__crdt_pending, __crdt_clock)
# out of the kind set
_SUFFIX_RE = re.compile(r'__crdt_([a-z]+)"')


def _string_constants(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value


def _attr_names(node: ast.AST) -> Set[str]:
    return {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }


def _has_sentinel_x(node: ast.AST) -> bool:
    """An f-string fragment `...{SENTINEL}X...` (the delete marker)."""
    for n in ast.walk(node):
        if not isinstance(n, ast.JoinedStr):
            continue
        parts = n.values
        for i, p in enumerate(parts[:-1]):
            if (
                isinstance(p, ast.FormattedValue)
                and isinstance(p.value, ast.Name)
                and p.value.id == "SENTINEL"
            ):
                nxt = parts[i + 1]
                if (
                    isinstance(nxt, ast.Constant)
                    and isinstance(nxt.value, str)
                    and nxt.value.startswith("X")
                ):
                    return True
    return False


def _find_function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for n in ast.walk(tree):
        if isinstance(n, ast.FunctionDef) and n.name == name:
            return n
    return None


def _module_assign(tree: ast.Module, name: str) -> Optional[ast.Assign]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == name:
                return node
    return None


class CaptureParityChecker(Checker):
    rule = "capture-parity"
    description = (
        "trigger-DDL kinds/column sources/markers stay in lockstep with "
        "the direct-capture statement metadata"
    )

    def __init__(self, crdt=CRDT_FILE, capture=CAPTURE_FILE):
        self.crdt = crdt
        self.capture = capture

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        crdt_sf = ctx.file(self.crdt)
        cap_sf = ctx.file(self.capture)
        if crdt_sf is None or cap_sf is None:
            return findings

        def cap_finding(line, symbol, message, snippet):
            findings.append(
                Finding(
                    rule=self.rule, path=self.capture, line=line,
                    symbol=symbol, message=message, snippet=snippet,
                )
            )

        # -- trigger side ---------------------------------------------------
        creator = _find_function(crdt_sf.tree, "_create_triggers")
        dropper = _find_function(crdt_sf.tree, "_drop_triggers")
        ddl_suffixes: Set[str] = set()
        ddl_attrs: Set[str] = set()
        ddl_marker = False
        for fn in (creator, dropper):
            if fn is None:
                continue
            for s in _string_constants(fn):
                ddl_suffixes.update(_SUFFIX_RE.findall(s))
        if dropper is not None:
            # the drop loop's ("ins", "upd", "del") tuple names every
            # generated trigger kind even where the name is split
            # across f-string fragments in the creator
            for n in ast.walk(dropper):
                if isinstance(n, (ast.Tuple, ast.List)):
                    for el in n.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, str
                        ):
                            ddl_suffixes.add(el.value)
        if creator is not None:
            ddl_attrs = _attr_names(creator)
            ddl_marker = _has_sentinel_x(creator)
        if creator is None or not ddl_suffixes:
            return findings  # nothing to be in lockstep with

        # -- capture side ---------------------------------------------------
        kinds_assign = _module_assign(cap_sf.tree, "CAPTURED_KINDS")
        kinds: Dict[str, str] = {}
        kinds_line = 1
        if kinds_assign is None or not isinstance(
            kinds_assign.value, ast.Dict
        ):
            cap_finding(
                1, "<module>",
                "CAPTURED_KINDS dict literal is missing — the "
                "capture module no longer declares which trigger "
                "kinds it mirrors",
                "CAPTURED_KINDS:missing",
            )
        else:
            kinds_line = kinds_assign.lineno
            for k, v in zip(
                kinds_assign.value.keys, kinds_assign.value.values
            ):
                if isinstance(k, ast.Constant) and isinstance(
                    v, ast.Constant
                ):
                    kinds[str(k.value)] = str(v.value)

        covered = set(kinds.values())
        for suffix in sorted(ddl_suffixes):
            if suffix not in covered:
                cap_finding(
                    kinds_line, "CAPTURED_KINDS",
                    f"trigger kind '__crdt_{suffix}' (store/crdt.py "
                    "_create_triggers) has no CAPTURED_KINDS entry — "
                    "the direct-capture path would silently miss the "
                    "statement class this trigger logs",
                    f"uncovered-trigger-kind:{suffix}",
                )
        for kind, suffix in sorted(kinds.items()):
            if suffix not in ddl_suffixes:
                cap_finding(
                    kinds_line, "CAPTURED_KINDS",
                    f"CAPTURED_KINDS maps '{kind}' to trigger suffix "
                    f"'{suffix}' which no generated trigger uses — "
                    "stale capture metadata",
                    f"stale-capture-kind:{kind}",
                )

        # per-kind cell builders + column-source lockstep
        for kind in sorted(kinds):
            fn = _find_function(cap_sf.tree, f"_cells_{kind}")
            if fn is None:
                cap_finding(
                    kinds_line, "CAPTURED_KINDS",
                    f"no `_cells_{kind}` builder for captured kind "
                    f"'{kind}' — the trigger body has no in-memory "
                    "counterpart",
                    f"missing-cells-builder:{kind}",
                )
                continue
            if kind in ("insert", "update") and "non_pk_cols" in ddl_attrs:
                if "non_pk_cols" not in _attr_names(fn):
                    cap_finding(
                        fn.lineno, f"_cells_{kind}",
                        f"`_cells_{kind}` does not iterate "
                        "`non_pk_cols` while the trigger DDL does — "
                        "the two capture paths emit different column "
                        "sets or orders",
                        f"column-source-drift:{kind}",
                    )

        # delete-marker lockstep
        if ddl_marker:
            marker = _module_assign(cap_sf.tree, "DELETE_MARKER")
            ok = False
            line = kinds_line
            if marker is not None:
                line = marker.lineno
                v = marker.value
                ok = (
                    isinstance(v, ast.BinOp)
                    and isinstance(v.op, ast.Add)
                    and isinstance(v.left, ast.Name)
                    and v.left.id == "SENTINEL"
                    and isinstance(v.right, ast.Constant)
                    and v.right.value == "X"
                )
            if not ok:
                cap_finding(
                    line, "DELETE_MARKER",
                    "DELETE_MARKER is not `SENTINEL + \"X\"` while the "
                    "trigger DDL emits the '{SENTINEL}X' row-delete "
                    "marker — deletes would fork between the paths",
                    "delete-marker-drift",
                )

        # -- finalize side (r21 columnar phase B lockstep) ------------------
        def crdt_finding(line, symbol, message, snippet):
            findings.append(
                Finding(
                    rule=self.rule, path=self.crdt, line=line,
                    symbol=symbol, message=message, snippet=snippet,
                )
            )

        def _has_marker_binop(fn) -> bool:
            return any(
                isinstance(n, ast.BinOp)
                and isinstance(n.op, ast.Add)
                and isinstance(n.left, ast.Name)
                and n.left.id == "SENTINEL"
                and isinstance(n.right, ast.Constant)
                and n.right.value == "X"
                for n in ast.walk(fn)
            )

        if ddl_marker:
            dedupe = _find_function(crdt_sf.tree, "_dedupe_pending")
            if dedupe is not None and not _has_marker_binop(dedupe):
                crdt_finding(
                    dedupe.lineno, "_dedupe_pending",
                    "`_dedupe_pending` no longer recognizes the "
                    "`SENTINEL + \"X\"` marker the trigger DDL emits — "
                    "captured row deletes would never reach finalize",
                    "finalize-marker-drift",
                )

        engine_fn = _find_function(crdt_sf.tree, "_finalize_engine")
        columnar = _find_function(crdt_sf.tree, "_phase_b_columnar")
        declares_columnar = engine_fn is not None and "columnar" in set(
            _string_constants(engine_fn)
        )
        if declares_columnar and columnar is None:
            crdt_finding(
                engine_fn.lineno, "_finalize_engine",
                "`_finalize_engine` accepts 'columnar' but no "
                "`_phase_b_columnar` builder exists — the default "
                "finalize engine would be undefined",
                "missing-columnar-builder",
            )
        if columnar is not None:
            names = {
                n.id for n in ast.walk(columnar)
                if isinstance(n, ast.Name)
            }
            if "SENTINEL" not in names:
                crdt_finding(
                    columnar.lineno, "_phase_b_columnar",
                    "`_phase_b_columnar` never references SENTINEL — "
                    "the sentinel-kind decision batch has drifted away "
                    "from the trigger/capture row-lifecycle convention",
                    "columnar-sentinel-drift",
                )
            if "write_change_cells" not in names:
                crdt_finding(
                    columnar.lineno, "_phase_b_columnar",
                    "`_phase_b_columnar` does not encode through "
                    "`write_change_cells` — cell bytes would fork from "
                    "the `write_change_fields` single-cell truth the "
                    "equivalence pins assume",
                    "columnar-encoder-drift",
                )
        return findings
