"""profiler-safety: code reachable from the stack sampler's hot path
stays allocation-free, lock-free (but for the sanctioned fold lock) and
asyncio-free.

The bug class (r23 continuous profiling plane): the sampler thread runs
inside every other subsystem's timing — `sys._current_frames()` at
67 Hz while the event loop schedules, the store commits and the fanout
drains.  A sampler that takes the wrong lock can deadlock against the
thread it is observing (the classic in-process profiler failure); one
that calls asyncio APIs races the loop it samples; one that allocates
per sample (comprehensions, f-strings, sorting, json, logging) turns
the observer into measurable load and invalidates its own overhead
budget.  None of these survive review as a *convention* — the r22
actuator-discipline lesson is that unattended machinery needs its
safety contract CHECKED, not documented.

The contract, enforced over `runtime/profiler.py` +
`runtime/profstore.py`:

- the scan walks the call graph reachable from `sample_once` by name:
  a called name (including simple `alias = obj.method` rebinding) that
  matches a function defined in the scanned files joins the reachable
  set.  Functions suffixed ``_coldpath`` are exempt BY NAME — they are
  bounded by cache size or window cadence (tid-cache miss, frame
  intern miss, window seal, the per-block adapt pass), not by the
  sample rate, and the suffix makes the exemption grep-able.
- inside reachable code the checker rejects:
  - any ``asyncio.*`` call (the `_current_tasks` dict read is the
    sanctioned lock-free alternative),
  - acquiring any lock other than ``_fold_lock`` (``with <lock>:`` or
    ``.acquire()``),
  - traversing ``agent`` / ``.store`` objects (the sampler observes
    stacks, never the object graph they run on),
  - per-sample allocation beyond the fold-map update: comprehensions,
    generator expressions, f-strings, ``sorted``, ``json.*``,
    logging, and registry/METRICS calls (metrics flush belongs in
    `_adapt_coldpath`).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from corrosion_tpu_torch.analysis.core import (
    AnalysisContext,
    Checker,
    Finding,
    enclosing_symbols,
)

SCOPE = (
    "corrosion_tpu_torch/runtime/profiler.py",
    "corrosion_tpu_torch/runtime/profstore.py",
)

ROOTS = ("sample_once",)

# the one lock the sampler may take (profstore's fold-map guard)
SANCTIONED_LOCK = "_fold_lock"

COLD_SUFFIX = "_coldpath"

_ALLOC_NODES = (
    ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
    ast.JoinedStr,
)

_REGISTRY_METHODS = {"counter", "gauge", "histogram", "latency"}
_LOGGING_ROOTS = {"log", "logging", "logger"}


def _root_name(node: ast.AST) -> str:
    """Leftmost Name id of an attribute chain ('' when not a chain)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _called_names(fn: ast.AST) -> Set[str]:
    """Names this function CALLS: direct call-position names plus
    simple `alias = obj.method` rebinds later called through the
    alias — the hot path's `add = self.ring.add_sample` idiom must
    not hide an edge from the scan."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            v = node.value
            if isinstance(v, ast.Attribute):
                aliases[node.targets[0].id] = v.attr
            elif isinstance(v, ast.Name):
                aliases[node.targets[0].id] = v.id
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            out.add(f.id)
            if f.id in aliases:
                out.add(aliases[f.id])
        elif isinstance(f, ast.Attribute):
            out.add(f.attr)
    return out


class ProfilerSafetyChecker(Checker):
    rule = "profiler-safety"
    description = (
        "code reachable from the stack sampler's hot path "
        "(sample_once and everything it calls, `_coldpath`-suffixed "
        "functions exempt) must not call asyncio, must not take any "
        "lock but the sanctioned _fold_lock, must not traverse "
        "agent/.store, and must not allocate per sample "
        "(comprehensions, f-strings, sorted, json, logging, registry "
        "calls)"
    )

    def __init__(self, scope=SCOPE, roots=ROOTS):
        self.scope = scope
        self.roots = roots

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        # one def table across every scanned file (the sampler half
        # lives in profiler.py, the fold-map half in profstore.py)
        files = [sf for sf in (ctx.file(p) for p in self.scope) if sf]
        defs: Dict[str, List[Tuple[object, ast.AST]]] = {}
        for sf in files:
            for node in ast.walk(sf.tree):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    defs.setdefault(node.name, []).append((sf, node))

        reachable: Dict[str, List[Tuple[object, ast.AST]]] = {}
        work = [r for r in self.roots if r in defs]
        while work:
            name = work.pop()
            if name in reachable:
                continue
            reachable[name] = defs[name]
            for _sf, fn in defs[name]:
                for called in sorted(_called_names(fn)):
                    if called.endswith(COLD_SUFFIX):
                        continue  # bounded by cache/cadence, not rate
                    if called in defs and called not in reachable:
                        work.append(called)

        findings: List[Finding] = []
        for name in sorted(reachable):
            for sf, fn in reachable[name]:
                findings.extend(self._check_fn(sf, fn))
        return findings

    def _check_fn(self, sf, fn: ast.AST) -> List[Finding]:
        symbols = enclosing_symbols(sf.tree)
        out: List[Finding] = []

        def flag(node: ast.AST, message: str) -> None:
            out.append(
                Finding(
                    rule=self.rule,
                    path=sf.path,
                    line=getattr(node, "lineno", fn.lineno),
                    symbol=symbols.get(fn, fn.name),
                    message=f"sampler-reachable `{fn.name}`: {message}",
                    snippet=self.snippet_of(node),
                )
            )

        for node in ast.walk(fn):
            if isinstance(node, _ALLOC_NODES):
                what = (
                    "f-string"
                    if isinstance(node, ast.JoinedStr)
                    else "comprehension/generator"
                )
                flag(
                    node,
                    f"per-sample {what} allocates on every tick — "
                    "build strings with %-format/concat or move the "
                    "work to a `_coldpath` function",
                )
                continue
            if isinstance(node, ast.withitem):
                ce = node.context_expr
                held = (
                    ce.attr if isinstance(ce, ast.Attribute)
                    else ce.id if isinstance(ce, ast.Name) else ""
                )
                if "lock" in held.lower() and held != SANCTIONED_LOCK:
                    flag(
                        ce,
                        f"acquires `{held}` — the sampler may only "
                        f"take {SANCTIONED_LOCK} (any other lock can "
                        "deadlock against the thread being sampled)",
                    )
                continue
            if isinstance(node, ast.Attribute) and node.attr in (
                "agent", "store"
            ):
                flag(
                    node,
                    f"traverses `.{node.attr}` — the sampler reads "
                    "stacks, never the agent/store object graph",
                )
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            root = _root_name(f)
            if root == "asyncio":
                flag(
                    node,
                    "calls an asyncio API — resolve tasks via the "
                    "lock-free `_current_tasks` dict read instead",
                )
            elif isinstance(f, ast.Attribute) and f.attr == "acquire":
                held = (
                    f.value.attr
                    if isinstance(f.value, ast.Attribute)
                    else root
                )
                if held != SANCTIONED_LOCK:
                    flag(
                        node,
                        f"acquires `{held or '<lock>'}` — the sampler "
                        f"may only take {SANCTIONED_LOCK}",
                    )
            elif isinstance(f, ast.Name) and f.id == "sorted":
                flag(
                    node,
                    "per-sample sorted() allocates — sort on the "
                    "read/serving side, never while sampling",
                )
            elif root == "json":
                flag(
                    node,
                    "per-sample json call — serialization belongs on "
                    "the serving side",
                )
            elif root in _LOGGING_ROOTS:
                flag(
                    node,
                    "per-sample logging — a hot sampler log line is "
                    "self-inflicted load; log from cold paths only",
                )
            elif (
                isinstance(f, ast.Attribute)
                and f.attr in _REGISTRY_METHODS
                and (
                    root in ("METRICS", "reg", "registry")
                    or (
                        isinstance(f.value, ast.Attribute)
                        and f.value.attr == "registry"
                    )
                )
            ):
                flag(
                    node,
                    "per-sample registry call — metrics flush belongs "
                    "in `_adapt_coldpath` (per block, not per sample)",
                )
        return out
