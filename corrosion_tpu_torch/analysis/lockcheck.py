"""lock-discipline: thread/loop-shared state mutated without a lock.

The bug class: the r7 metrics races — `Counter.inc` was `self.value +=
1` with the agent-metrics worker thread and the event loop both calling
it, silently losing increments under the GIL's bytecode-boundary
switches.  The repo's pattern since: any state touched from BOTH a
worker thread (`asyncio.to_thread`, `run_in_executor`,
`threading.Thread`) and the event loop takes an instance lock
(runtime/metrics.py per-instrument locks, records.py FlightRecorder),
or copies under the GIL in ONE C-level call with a comment
(member_store's `dict(...)` snapshot idiom).

Static evidence model (documented approximation — honest about what a
name-based analysis can and cannot see):

1. THREAD ENTRY POINTS: any function/method referenced as the callable
   of `asyncio.to_thread(f, ...)`, `loop.run_in_executor(pool, f)`,
   `threading.Thread(target=f)` or `threading.Timer(t, f)`, anywhere in
   the scanned tree.  `self.m` / `obj.m` references resolve by method
   name against every scanned class that defines `m` (cross-object
   aliasing is invisible to AST analysis; the baseline absorbs the
   rare false match with a justification).
2. Closure within a class: a thread-entered method taints the methods
   it `self.`-calls.
3. MUTATIONS: assignments/augmented assignments to `self.<attr>`,
   `self.<attr>[...] = ...`, and mutating container methods
   (`.append/.add/.update/...`) on `self.<attr>`, recorded per method
   with whether they sit under a `with`/`async with` whose context
   expression mentions a lock (`lock`/`mutex`/`cond`, case-insensitive).
4. FINDING: an attribute mutated WITHOUT a lock in a thread-entered
   method AND also mutated (locked or not) in a method outside the
   thread closure -> both sides race.  Module-level mutable globals get
   the same treatment with module functions in place of methods.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

SCOPE = ("corrosion_tpu_torch",)

_MUTATORS = {
    "append", "add", "update", "pop", "popitem", "clear", "extend",
    "insert", "remove", "discard", "setdefault", "appendleft",
}
_LOCK_TOKENS = ("lock", "mutex", "cond", "sem")


def _is_lockish(expr_src: str) -> bool:
    low = expr_src.lower()
    return any(tok in low for tok in _LOCK_TOKENS)


def _thread_entry_names(ctx: AnalysisContext, scope) -> Set[str]:
    """Names of functions/methods handed to worker threads anywhere."""
    out: Set[str] = set()

    def callable_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    for sf in ctx.walk(*scope):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            src = ast.unparse(node.func)
            target: Optional[ast.AST] = None
            if src.endswith("to_thread") and node.args:
                target = node.args[0]
            elif src.endswith("run_in_executor") and len(node.args) >= 2:
                target = node.args[1]
            elif src.endswith(("threading.Thread", "Thread")):
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif src.endswith(("threading.Timer", "Timer")):
                if len(node.args) >= 2:
                    target = node.args[1]
            if target is not None:
                name = callable_name(target)
                if name:
                    out.add(name)
    return out


@dataclass
class _Mutation:
    attr: str
    line: int
    locked: bool
    snippet: str


class _MethodScanner(ast.NodeVisitor):
    """Mutations of `self.<attr>` (or of module globals, when
    `owner_names` is given) inside one function, with lock context."""

    def __init__(self, owner_names: Optional[Set[str]] = None):
        self.owner_names = owner_names  # None => scan `self.`
        self.mutations: List[_Mutation] = []
        self.self_calls: Set[str] = set()
        self._lock_depth = 0

    def _target_attr(self, node: ast.AST) -> Optional[Tuple[str, ast.AST]]:
        """('attrname', flagged_node) when node mutates tracked state."""
        if self.owner_names is None:
            # self.X = / self.X[...] = / self.X.mutator()
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return node.attr, node
            if isinstance(node, ast.Subscript):
                return self._target_attr(node.value)
        else:
            if isinstance(node, ast.Name) and node.id in self.owner_names:
                return node.id, node
            if isinstance(node, ast.Subscript):
                return self._target_attr(node.value)
        return None

    def _record(self, node: ast.AST, hit: Tuple[str, ast.AST]) -> None:
        self.mutations.append(
            _Mutation(
                attr=hit[0],
                line=getattr(node, "lineno", 0),
                locked=self._lock_depth > 0,
                snippet=Checker.snippet_of(node),
            )
        )

    def _visit_with(self, node) -> None:
        lockish = any(
            _is_lockish(ast.unparse(item.context_expr))
            for item in node.items
        )
        if lockish:
            self._lock_depth += 1
        self.generic_visit(node)
        if lockish:
            self._lock_depth -= 1

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            hit = self._target_attr(t)
            # plain rebinding of self.X = ... in __init__-style code is
            # not a container mutation; only subscript stores and
            # augmented ops are read-modify-write.  BUT a rebind of a
            # tracked attr from a thread IS a racy publish when the
            # loop mutates the same attr, so record subscript stores
            # and rebinds alike — __init__ noise is filtered by the
            # "both contexts mutate" rule (no __init__ runs on a
            # worker thread).
            if hit is not None and isinstance(t, ast.Subscript):
                self._record(node, hit)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        hit = self._target_attr(node.target)
        if hit is not None:
            self._record(node, hit)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _MUTATORS:
                hit = self._target_attr(f.value)
                if hit is not None:
                    self._record(node, hit)
            # track self.method() calls for the thread closure
            if (
                isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and self.owner_names is None
            ):
                self.self_calls.add(f.attr)
        self.generic_visit(node)

    # nested defs execute in the same context they were created in
    # often enough (closures run by the enclosing method); keep
    # descending — their mutations belong to the enclosing method's
    # context for this analysis.


class LockDisciplineChecker(Checker):
    rule = "lock-discipline"
    description = (
        "state mutated from both worker-thread and event-loop contexts "
        "must hold a lock"
    )

    def __init__(self, scope=SCOPE):
        self.scope = scope

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        thread_entries = _thread_entry_names(ctx, self.scope)

        for sf in ctx.walk(*self.scope):
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    findings.extend(
                        self._check_class(sf, node, thread_entries)
                    )
            findings.extend(self._check_globals(sf, thread_entries))
        return findings

    def _check_class(
        self, sf, cls: ast.ClassDef, thread_entries: Set[str]
    ) -> List[Finding]:
        methods = {
            m.name: m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        scans: Dict[str, _MethodScanner] = {}
        for name, m in methods.items():
            sc = _MethodScanner()
            sc.visit(m)
            scans[name] = sc

        # thread closure within the class.  Only SYNC methods can be
        # to_thread/run_in_executor targets — an `async def` sharing a
        # name with a threaded method elsewhere (every class has a
        # `close`) must not be swept in by the name match.
        threaded: Set[str] = {
            n
            for n in methods
            if n in thread_entries
            and isinstance(methods[n], ast.FunctionDef)
        }
        frontier = list(threaded)
        while frontier:
            n = frontier.pop()
            for callee in scans[n].self_calls:
                if callee in methods and callee not in threaded:
                    threaded.add(callee)
                    frontier.append(callee)
        if not threaded:
            return []

        by_attr_thread: Dict[str, List[Tuple[str, _Mutation]]] = {}
        by_attr_loop: Dict[str, List[Tuple[str, _Mutation]]] = {}
        for name, sc in scans.items():
            side = by_attr_thread if name in threaded else by_attr_loop
            if name == "__init__":
                continue  # construction precedes sharing
            for mut in sc.mutations:
                side.setdefault(mut.attr, []).append((name, mut))

        findings: List[Finding] = []
        for attr, tmuts in sorted(by_attr_thread.items()):
            unlocked = [
                (n, m) for n, m in tmuts if not m.locked
            ]
            loop_side = by_attr_loop.get(attr, [])
            if not unlocked or not loop_side:
                continue
            tn, tm = unlocked[0]
            ln, _lm = loop_side[0]
            findings.append(
                Finding(
                    rule=self.rule,
                    path=sf.path,
                    line=tm.line,
                    symbol=f"{cls.name}.{tn}",
                    message=(
                        f"{cls.name}.{attr} is mutated without a lock in "
                        f"{tn}() (runs on a worker thread via "
                        f"to_thread/run_in_executor) AND in {ln}() on the "
                        "event loop — the r7 GIL-race class; guard both "
                        "sides with one threading.Lock"
                    ),
                    snippet=f"{attr}:{tm.snippet}",
                )
            )
        return findings

    def _check_globals(
        self, sf, thread_entries: Set[str]
    ) -> List[Finding]:
        tree = sf.tree
        globals_: Set[str] = set()
        for node in tree.body:
            if isinstance(node, ast.Assign):
                v = node.value
                mutable = isinstance(v, (ast.Dict, ast.List, ast.Set))
                if isinstance(v, ast.Call):
                    fn = v.func
                    nm = (
                        fn.id
                        if isinstance(fn, ast.Name)
                        else getattr(fn, "attr", "")
                    )
                    mutable = nm in (
                        "dict", "list", "set", "deque",
                        "defaultdict", "Counter", "OrderedDict",
                    )
                if mutable:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and not t.id.isupper():
                            # UPPER_CASE module constants (lookup tables
                            # populated at import) are excluded
                            globals_.add(t.id)
        if not globals_:
            return []
        fns = {
            n.name: n
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        thread_muts: List[Tuple[str, _Mutation]] = []
        loop_muts: List[Tuple[str, _Mutation]] = []
        for name, fn in fns.items():
            sc = _MethodScanner(owner_names=globals_)
            sc.visit(fn)
            side = (
                thread_muts if name in thread_entries else loop_muts
            )
            side.extend((name, m) for m in sc.mutations)
        findings: List[Finding] = []
        flagged: Set[str] = set()
        for tn, tm in thread_muts:
            if tm.locked or tm.attr in flagged:
                continue
            others = [n for n, m in loop_muts if m.attr == tm.attr]
            if not others:
                continue
            flagged.add(tm.attr)
            findings.append(
                Finding(
                    rule=self.rule,
                    path=sf.path,
                    line=tm.line,
                    symbol=tn,
                    message=(
                        f"module global {tm.attr!r} is mutated without "
                        f"a lock in thread-entered {tn}() and in "
                        f"{others[0]}() on the event loop — guard with "
                        "one module lock"
                    ),
                    snippet=f"{tm.attr}:{tm.snippet}",
                )
            )
        return findings
