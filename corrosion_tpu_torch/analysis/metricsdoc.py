"""metrics-doc: emitted series <-> COMPONENTS.md table, both directions.

The metric-name lint of the corro-analyze framework, over the port's
tree: `corrosion_tpu_torch.lint_metrics` re-exports
`scan_call_sites`/`parse_components_table`/`lint` as the JAX package's
`scripts/lint_metrics.py` does.  The port has no `scripts/` (its
commands are package modules), so only the package is scanned.  The
contract is the reference's: every series the code can emit (`<registry>.counter/gauge/histogram/latency("literal")`, with
f-string names matched as one-label wildcards) must have a row in the
COMPONENTS.md observability table, and every row must still have an
emitting call site — the inventory IS the contract, dashboards must not
rot silently.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

_CALL_RE = re.compile(
    r"\.(counter|gauge|histogram|latency)\(\s*(f?)\"([^\"\n]+)\"", re.S
)
_TABLE_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")

TABLE_BEGIN = "<!-- metrics-table:begin -->"
TABLE_END = "<!-- metrics-table:end -->"

SCAN_DIRS = ("corrosion_tpu_torch",)
COMPONENTS = "COMPONENTS.md"


def scan_call_sites(
    root: str,
) -> Tuple[Dict[str, Set[str]], List[str]]:
    """(literal series name -> emitting files, f-string wildcard
    regexes) — regex-based on raw text, deliberately: call sites inside
    strings/templates counted the same way the r7 tool did, so the fold
    is drop-in."""
    literals: Dict[str, Set[str]] = {}
    wildcards: List[str] = []
    for top in SCAN_DIRS:
        for dirpath, _dirs, files in os.walk(os.path.join(root, top)):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                for m in _CALL_RE.finditer(text):
                    is_f, name = m.group(2), m.group(3)
                    if is_f:
                        # {expr} holes become wildcards over one label
                        # segment; the pattern must cover >= 1 table row
                        pat = "^" + re.sub(
                            r"\\\{[^}]*\\\}", "[^.]+", re.escape(name)
                        ) + "$"
                        wildcards.append(pat)
                    else:
                        literals.setdefault(name, set()).add(rel)
    return literals, wildcards


def parse_components_table(root: str) -> List[str]:
    """Backticked series names from column 1 of the fenced table."""
    path = os.path.join(root, COMPONENTS)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if TABLE_BEGIN not in text or TABLE_END not in text:
        raise SystemExit(
            f"{COMPONENTS} is missing the {TABLE_BEGIN}/{TABLE_END} "
            "markers around the observability table"
        )
    section = text.split(TABLE_BEGIN, 1)[1].split(TABLE_END, 1)[0]
    names = []
    for line in section.splitlines():
        m = _TABLE_ROW_RE.match(line.strip())
        if m:
            names.append(m.group(1))
    return names


def lint(root: str) -> List[str]:
    """Drift complaints (empty = clean) — same strings the r7 tool
    printed, so operators' muscle memory and the shim both survive."""
    literals, wildcards = scan_call_sites(root)
    table = parse_components_table(root)
    table_set = set(table)
    problems: List[str] = []

    dupes = {n for n in table_set if table.count(n) > 1}
    for n in sorted(dupes):
        problems.append(f"duplicate table row: {n}")

    for name in sorted(literals):
        if name not in table_set:
            where = ", ".join(sorted(literals[name]))
            problems.append(
                f"emitted but undocumented: {name} ({where}) — add a row "
                "to the COMPONENTS.md observability table"
            )

    covered_by_wildcard: Set[str] = set()
    for pat in wildcards:
        hits = {n for n in table_set if re.match(pat, n)}
        if not hits:
            problems.append(
                f"f-string call site matches no table row: /{pat}/"
            )
        covered_by_wildcard |= hits

    for name in sorted(table_set):
        if name not in literals and name not in covered_by_wildcard:
            problems.append(
                f"documented but never emitted: {name} — remove the row "
                "or restore the call site"
            )
    return problems


class MetricsDocChecker(Checker):
    rule = "metrics-doc"
    description = (
        "metric series emitted by the tree and the COMPONENTS.md "
        "observability table match exactly, both directions"
    )

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        return [
            Finding(
                rule=self.rule,
                path=COMPONENTS,
                line=0,
                symbol="observability-table",
                message=problem,
                snippet=problem[:72],
            )
            for problem in lint(ctx.root)
        ]
