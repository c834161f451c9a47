"""Checker framework: file cache, findings, noqa suppression, baseline.

Design rules (what keeps the suite honest AND cheap):

- ONE parse per file.  `AnalysisContext` loads and `ast.parse`s every
  scanned file once; checkers share the cache.  The whole repo pass is
  a few hundred milliseconds — cheap enough for tier-1.
- Findings are keyed WITHOUT line numbers (`rule|path|symbol|snippet`),
  so unrelated edits above a grandfathered finding do not churn the
  committed baseline.
- Suppression is per-finding and self-documenting: a
  `# corro: noqa[rule]` comment on the flagged statement's first line.
  Blanket per-file opt-outs are deliberately not offered.
- The baseline (`ANALYSIS_BASELINE_TORCH.json`, the port's own; the
  JAX package keeps `ANALYSIS_BASELINE.json`) is for *proven-benign*
  grandfathered findings only; every entry carries a one-line
  justification and STALE entries (no longer firing) fail the run so
  the list can only shrink deliberately (same two-direction hygiene as
  the metrics table lint).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BASELINE_FILE = "ANALYSIS_BASELINE_TORCH.json"

_NOQA_RE = re.compile(r"#\s*corro:\s*noqa\[([a-z0-9_,\- ]+)\]")


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


@dataclass(frozen=True)
class Finding:
    rule: str  # checker id, e.g. "async-blocking"
    path: str  # repo-relative posix path
    line: int  # 1-based line of the flagged node (0 = whole-file)
    symbol: str  # enclosing Class.method / function / "<module>"
    message: str
    snippet: str = ""  # normalized source of the flagged node

    @property
    def key(self) -> str:
        """Line-free stable identity used by the baseline."""
        return f"{self.rule}|{self.path}|{self.symbol}|{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    path: str  # repo-relative
    text: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    def noqa_rules(self, line: int) -> List[str]:
        """Rules suppressed on `line` (1-based) via `# corro: noqa[rule]`."""
        if 1 <= line <= len(self.lines):
            m = _NOQA_RE.search(self.lines[line - 1])
            if m:
                return [r.strip() for r in m.group(1).split(",")]
        return []


class AnalysisContext:
    """Shared parsed-file cache + repo location for one analysis run."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or repo_root()
        self._files: Dict[str, SourceFile] = {}

    def file(self, rel: str) -> Optional[SourceFile]:
        """Parsed source for one repo-relative path (None if unreadable)."""
        rel = rel.replace(os.sep, "/")
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                tree = ast.parse(text)
            except (OSError, SyntaxError):
                self._files[rel] = None  # type: ignore[assignment]
                return None
            self._files[rel] = SourceFile(
                path=rel, text=text, tree=tree, lines=text.splitlines()
            )
        return self._files[rel]

    def walk(self, *tops: str) -> List[SourceFile]:
        """Every parseable .py file under the given repo-relative dirs."""
        out: List[SourceFile] = []
        for top in tops:
            top_abs = os.path.join(self.root, top)
            if os.path.isfile(top_abs):
                sf = self.file(top)
                if sf is not None:
                    out.append(sf)
                continue
            for dirpath, _dirs, files in sorted(os.walk(top_abs)):
                for fn in sorted(files):
                    if not fn.endswith(".py"):
                        continue
                    rel = os.path.relpath(
                        os.path.join(dirpath, fn), self.root
                    ).replace(os.sep, "/")
                    sf = self.file(rel)
                    if sf is not None:
                        out.append(sf)
        return out

    def read_text(self, rel: str) -> str:
        """Raw text of any repo file ('' if unreadable) — for checkers
        that cross-reference non-Python artifacts (COMPONENTS.md,
        tests)."""
        try:
            with open(os.path.join(self.root, rel), encoding="utf-8") as f:
                return f.read()
        except OSError:
            return ""


class Checker:
    """One rule.  Subclasses set `rule`/`description` and implement
    `run(ctx)` returning raw findings; `run_analysis` applies noqa and
    baseline filtering afterwards (checkers stay filter-agnostic)."""

    rule: str = "abstract"
    description: str = ""

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        raise NotImplementedError

    # -- shared AST helpers -------------------------------------------------

    @staticmethod
    def snippet_of(node: ast.AST, limit: int = 72) -> str:
        try:
            s = ast.unparse(node)
        except Exception:
            s = type(node).__name__
        s = " ".join(s.split())
        return s[:limit]


def enclosing_symbols(tree: ast.AST) -> Dict[ast.AST, str]:
    """node -> dotted enclosing symbol name, for stable finding keys."""
    out: Dict[ast.AST, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                name = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = name
                visit(child, name)
            else:
                out[child] = prefix or "<module>"
                visit(child, prefix)

    visit(tree, "")
    return out


# -- baseline ---------------------------------------------------------------


def load_baseline(root: str) -> Dict[str, str]:
    """key -> justification; empty when the file is absent."""
    path = os.path.join(root, BASELINE_FILE)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {e["key"]: e.get("justification", "") for e in data["entries"]}


def save_baseline(
    root: str, findings: List[Finding], keep: Dict[str, str]
) -> str:
    """Re-bank: current findings become the baseline.  Justifications of
    surviving entries are preserved; new entries get an UNREVIEWED
    placeholder that a human must replace before committing."""
    entries = []
    seen = set()
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append(
            {
                "key": f.key,
                "justification": keep.get(
                    f.key, "UNREVIEWED — justify or fix before committing"
                ),
            }
        )
    path = os.path.join(root, BASELINE_FILE)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {"version": 1, "entries": entries}, f, indent=2, sort_keys=True
        )
        f.write("\n")
    return path


# -- running the rules ------------------------------------------------------


def all_checkers() -> List[Checker]:
    # imported lazily so `core` has no checker-module dependencies
    from corrosion_tpu_torch.analysis.actuators import (
        ActuatorDisciplineChecker,
    )
    from corrosion_tpu_torch.analysis.blocking import AsyncBlockingChecker
    from corrosion_tpu_torch.analysis.capture_parity import (
        CaptureParityChecker,
    )
    from corrosion_tpu_torch.analysis.codecext import CodecExtChecker
    from corrosion_tpu_torch.analysis.finalize_parity import (
        FinalizeParityChecker,
    )
    from corrosion_tpu_torch.analysis.lockcheck import LockDisciplineChecker
    from corrosion_tpu_torch.analysis.metricsdoc import MetricsDocChecker
    from corrosion_tpu_torch.analysis.parity import LaneParityChecker
    from corrosion_tpu_torch.analysis.profiler_safety import (
        ProfilerSafetyChecker,
    )
    from corrosion_tpu_torch.analysis.purity import KernelPurityChecker
    from corrosion_tpu_torch.analysis.timeouts import (
        TimeoutDisciplineChecker,
    )

    return [
        KernelPurityChecker(),
        LaneParityChecker(),
        AsyncBlockingChecker(),
        LockDisciplineChecker(),
        CodecExtChecker(),
        CaptureParityChecker(),
        FinalizeParityChecker(),
        MetricsDocChecker(),
        TimeoutDisciplineChecker(),
        ActuatorDisciplineChecker(),
        ProfilerSafetyChecker(),
    ]


@dataclass
class AnalysisResult:
    new: List[Finding]  # fail the run
    baselined: List[Tuple[Finding, str]]  # grandfathered (justified)
    suppressed: List[Finding]  # # corro: noqa[rule]
    stale_keys: List[str]  # baseline entries that no longer fire

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale_keys


def run_analysis(
    ctx: Optional[AnalysisContext] = None,
    checkers: Optional[List[Checker]] = None,
    baseline: Optional[Dict[str, str]] = None,
) -> AnalysisResult:
    ctx = ctx or AnalysisContext()
    checkers = checkers if checkers is not None else all_checkers()
    baseline = (
        baseline if baseline is not None else load_baseline(ctx.root)
    )

    raw: List[Finding] = []
    for checker in checkers:
        raw.extend(checker.run(ctx))

    new: List[Finding] = []
    baselined: List[Tuple[Finding, str]] = []
    suppressed: List[Finding] = []
    fired_keys = set()
    for f in raw:
        fired_keys.add(f.key)
        sf = ctx.file(f.path)
        if sf is not None and f.rule in sf.noqa_rules(f.line):
            suppressed.append(f)
        elif f.key in baseline:
            baselined.append((f, baseline[f.key]))
        else:
            new.append(f)

    active_rules = {c.rule for c in checkers}
    stale = [
        k
        for k in sorted(baseline)
        if k not in fired_keys and k.split("|", 1)[0] in active_rules
    ]
    return AnalysisResult(
        new=new, baselined=baselined, suppressed=suppressed, stale_keys=stale
    )
