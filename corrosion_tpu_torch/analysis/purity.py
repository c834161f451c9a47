"""kernel-purity: host syncs inside the port's device code.

The bug class: a host sync or host materialization inside code that is
meant to run on the card without the host — `.item()` / `float()` on a
tensor, a Python `if` on a tensor (its `__bool__` copies the value to
the host and waits for the card), `np.*` or `time.*` inside a tick, an
op whose output shape depends on the data (`nonzero`, `x[mask]`), or a
host list copied to the card.  Each one stops the host until the card
has drained its queue; inside a `torch.cuda.graph` capture each one is
an error, so every such site stands between a tick and its capture as
one graph.

Scope: functions REACHABLE FROM A DEVICE ROOT in
`corrosion_tpu_torch/ops/*.py`.  A device root is

- every module-level function called inside a `with torch.cuda.graph(
  ...)` body (the program a CUDA graph captures), and
- every function a module names in its `DEVICE_ROOTS` tuple: the tick
  bodies and stats passes meant to be captured one graph per tick.

Reachability follows same-module calls and bare-name references, but
not into a function under `functools.cache` / `lru_cache`: its body
runs once per key (a host constant built on first use), not per tick.
Host-side wrappers in the same files (`run_to_coverage`, `_readback`,
`read_decisions`, `run_packed`, ...) are NOT in the closure: their
readbacks are the chunk's one sync, and they may do host work freely.

Tensor-derived approximation (documented, deliberately simple; the
reference's taint-lite rule with torch in place of jnp):
- In a root, a parameter is a tensor unless its annotation says
  otherwise: unannotated, `torch.Tensor` and `*State` parameters are
  tensors; `int`, `str`, `*Params`, `jr.Key` (a host pair of ints) and
  any other annotation are host values.
- A local name assigned from an expression holding a tensor name, a
  `torch.*` call or a tensor-method call (`x.gather(...)`, `x.any()`)
  is a tensor ("taint-lite": one forward pass, no fixpoint).
- Metadata reads are host values: `x.shape`, `x.dtype`, `x.device`,
  `x.ndim`, `x.size(...)`, `x.numel()`, `x.dim()`.
- `x is None` / `x is not None` tests are exempt: they read no data.
- A bool tensor is one made by a comparison, `~`/`&`/`|` of bool
  tensors, `torch.logical_*`, `.bool()`, `.to(torch.bool)`, `.any()`,
  `.all()` or a `dtype=torch.bool` constructor; indexing with one is
  `nonzero()`, and so is storing a tensor through one (`x[mask] = 0`,
  a number, is `masked_fill` and no sync: the card reports none).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from corrosion_tpu_torch.analysis.core import (
    AnalysisContext,
    Checker,
    Finding,
    enclosing_symbols,
)

SCOPE = ("corrosion_tpu_torch/ops",)

# the module-level tuple naming a module's tick bodies and stats passes
ROOTS_NAME = "DEVICE_ROOTS"

# modules whose mere use inside device code is a host escape
_HOST_MODULES = {"np", "numpy", "time"}
# builtins that force a tensor's value onto the host
_CONCRETIZERS = {
    "float", "int", "bool", "complex", "range", "max", "min", "print",
    "str", "repr",
}
# methods that copy a tensor's data to the host
_READBACKS = {"item", "tolist", "cpu", "numpy"}
# torch functions that build a device tensor from host data
_H2D = {"tensor", "as_tensor", "from_numpy"}
# ops whose output shape depends on the data: the host waits for it
_DATA_SHAPED = {"nonzero", "argwhere", "unique", "unique_consecutive",
                "masked_select"}
# tensor methods whose result is a tensor (the taint's method half)
_TENSOR_METHODS = frozenset((
    "abs", "add", "all", "amax", "amin", "any", "argmax", "argmin",
    "argsort", "bitwise_and", "bitwise_not", "bitwise_or", "bool",
    "clamp", "clamp_", "clone", "contiguous", "cummax", "cumsum", "diagonal",
    "div", "eq", "expand", "expand_as", "flatten", "float", "gather", "ge",
    "gt", "index_add_", "index_copy", "index_copy_", "index_fill_",
    "index_select", "int", "le", "logical_and", "logical_not",
    "logical_or", "long", "lt", "masked_fill", "masked_fill_", "max",
    "maximum", "mean", "min", "minimum", "mul", "ne", "neg", "new_full",
    "new_zeros", "permute", "prod", "remainder", "repeat",
    "repeat_interleave", "reshape", "scatter", "scatter_",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "squeeze", "sub",
    "sum", "to", "topk", "transpose", "unsqueeze", "view", "where",
))
_BOOL_METHODS = {"bool", "logical_and", "logical_or", "logical_not",
                 "eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf",
                 "isfinite", "isin"}
# metadata reads: host values, never a sync
_STATIC_ATTRS = frozenset(("shape", "ndim", "dtype", "device", "size",
                           "numel", "dim", "is_cuda"))


def _graph_roots(tree: ast.Module,
                 fns: Dict[str, ast.FunctionDef]) -> Set[str]:
    """Module functions called inside a `with torch.cuda.graph(...)`."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        if not any(
            isinstance(item.context_expr, ast.Call)
            and ast.unparse(item.context_expr.func).endswith("cuda.graph")
            for item in node.items
        ):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id in fns
                ):
                    out.add(sub.func.id)
    return out


def _declared_roots(tree: ast.Module) -> Set[str]:
    """Names listed in the module's `DEVICE_ROOTS` tuple."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == ROOTS_NAME
            for t in node.targets
        ):
            for elt in ast.walk(node.value):
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    out.add(elt.value)
    return out


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """A root's parameters that are tensors (see the module docstring)."""
    out: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = ast.unparse(a.annotation) if a.annotation is not None else ""
        if (
            not ann
            or "Tensor" in ann
            or ann.strip("\"'").endswith("State")
        ):
            out.add(a.arg)
    return out


def _cached(fn: ast.FunctionDef) -> bool:
    """Under `functools.cache` / `functools.lru_cache(...)`."""
    for dec in fn.decorator_list:
        src = ast.unparse(dec.func if isinstance(dec, ast.Call) else dec)
        if src.split(".")[-1] in ("cache", "lru_cache"):
            return True
    return False


def _called_names(fn: ast.FunctionDef) -> Set[str]:
    """Bare names called OR referenced inside fn (a reference covers a
    function handed on to be called, as in the reference)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.add(node.id)
    return out


def _bound_names(target: ast.AST) -> Set[str]:
    """Names an assignment target (re)binds or stores into: `x`, the
    elements of `a, b`, and the base `x` of `x[i] = ...` — never the
    index's names."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound_names(e) for e in target.elts))
    if isinstance(target, (ast.Starred, ast.Subscript, ast.Attribute)):
        return _bound_names(target.value)
    return set()


def _scalar(node: ast.AST) -> bool:
    """A Python number or bool literal (`0`, `-1`, `True`)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float, bool)
    )


def _method(node: ast.AST) -> str:
    """`m` of a call `x.m(...)`, '' otherwise."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


class _TaintVisitor(ast.NodeVisitor):
    """Flags host escapes inside ONE device function (nested defs
    included — they run with their parent)."""

    def __init__(
        self,
        path: str,
        symbol: str,
        tensor_params: Set[str],
        findings: List[Finding],
    ):
        self.path = path
        self.symbol = symbol
        self.tainted: Set[str] = set(tensor_params)
        self.bools: Set[str] = set()
        self.findings = findings
        self._tests: Set[int] = set()  # ids of if/while/assert tests

    def _expr_tainted(self, node: ast.AST) -> bool:
        stack = [node]
        while stack:
            sub = stack.pop()
            if (
                isinstance(sub, ast.Attribute)
                and sub.attr in _STATIC_ATTRS
            ):
                continue  # don't descend: metadata reads are host values
            if isinstance(sub, ast.Name) and sub.id in self.tainted:
                return True
            if isinstance(sub, ast.Call):
                src = ast.unparse(sub.func)
                if (src.startswith("torch.")
                        or _method(sub) in _TENSOR_METHODS):
                    return True
            stack.extend(ast.iter_child_nodes(sub))
        return False

    def _expr_bool(self, node: ast.AST) -> bool:
        """A bool tensor (see the module docstring)."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return not all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
            ) and self._expr_tainted(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._expr_bool(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
        ):
            return self._expr_bool(node.left) or self._expr_bool(node.right)
        if isinstance(node, ast.Subscript):
            return self._expr_bool(node.value)
        if isinstance(node, ast.Call):
            src = ast.unparse(node.func)
            m = _method(node)
            if "dtype=torch.bool" in ast.unparse(node).replace(" ", ""):
                return True
            if m == "to" and any(
                ast.unparse(a) == "torch.bool" for a in node.args
            ):
                return True
            if src.startswith("torch.") and m in _BOOL_METHODS:
                return True
            if m in _BOOL_METHODS and self._expr_tainted(node.func):
                return True
            if m in ("any", "all"):
                return True
        return False

    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=KernelPurityChecker.rule,
                path=self.path,
                line=getattr(node, "lineno", 0),
                symbol=self.symbol,
                message=message,
                snippet=Checker.snippet_of(node),
            )
        )

    # -- taint propagation --------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript) and self._bool_index(t):
                # `x[mask] = scalar` is masked_fill: no sync
                if not _scalar(node.value):
                    self._flag(
                        t,
                        "assigning a tensor through a bool-tensor index "
                        "is nonzero(): a data-dependent shape (host sync)",
                    )
        self.generic_visit(node)
        tainted = self._expr_tainted(node.value)
        is_bool = self._expr_bool(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                (self.bools.add if is_bool else self.bools.discard)(t.id)
            if tainted:
                self.tainted.update(_bound_names(t))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self._expr_tainted(node.value) and isinstance(
            node.target, ast.Name
        ):
            self.tainted.add(node.target.id)

    # -- escapes ------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        m = _method(node)
        src = ast.unparse(f)
        if m in _READBACKS:
            self._flag(node, f".{m}() copies a tensor to the host (sync)")
        elif m == "synchronize":
            self._flag(node, f"{src}() waits for the card (host sync)")
        elif m in _DATA_SHAPED:
            self._flag(
                node,
                f"{m}() has a data-dependent output shape: the host "
                "waits for the card to size it",
            )
        elif (
            src == "torch.where"
            and len(node.args) == 1
            and not node.keywords
        ):
            self._flag(
                node,
                "torch.where(cond) with one argument is nonzero(): a "
                "data-dependent shape (host sync)",
            )
        elif m == "repeat_interleave" and not any(
            kw.arg == "output_size" for kw in node.keywords
        ) and not (node.args and isinstance(node.args[0], ast.Constant)):
            self._flag(
                node,
                "repeat_interleave without output_size= sizes its "
                "output from the data (host sync)",
            )
        elif src.startswith("torch.") and m in _H2D:
            self._flag(
                node,
                f"torch.{m}() copies host data to the card: a pageable "
                "host-to-device copy blocks the host",
            )
        if (
            isinstance(f, ast.Name)
            and f.id in _CONCRETIZERS
            and any(self._expr_tainted(a) for a in node.args)
        ):
            self._flag(
                node,
                f"{f.id}() on a tensor reads its value on the host "
                "(host sync)",
            )
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.value, ast.Name)
            and node.value.id in _HOST_MODULES
        ):
            mod = node.value.id
            what = (
                "wall-clock reads inside device code"
                if mod == "time"
                else "host/numpy work inside device code"
            )
            self._flag(node, f"{mod}.{node.attr}: {what}")
        self.generic_visit(node)

    def _bool_index(self, node: ast.Subscript) -> bool:
        idx = node.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        return any(self._expr_bool(p) for p in parts)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # stores are judged with their value (visit_Assign)
        if isinstance(node.ctx, ast.Load) and self._bool_index(node):
            self._flag(
                node,
                "indexing with a bool tensor is nonzero(): a "
                "data-dependent shape (host sync) — use torch.where",
            )
        self.generic_visit(node)

    def _check_test(self, node, kind: str) -> None:
        test = node.test
        self._tests.add(id(test))
        # `x is (not) None` alone reads no data
        if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return
        if self._expr_tainted(test):
            self._flag(
                node,
                f"Python `{kind}` on a tensor calls bool() on it (host "
                "sync) — use torch.where",
            )

    def visit_If(self, node: ast.If) -> None:
        self._check_test(node, "if")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_test(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_test(node, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_test(node, "assert")
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        # every operand but the last is read as a bool (a test reads
        # them all, and is flagged as its if/while/assert)
        if id(node) not in self._tests and any(
            self._expr_tainted(v) for v in node.values[:-1]
        ):
            kind = "and" if isinstance(node.op, ast.And) else "or"
            self._flag(
                node,
                f"Python `{kind}` on a tensor calls bool() on it (host "
                "sync) — use & / |",
            )
        self.generic_visit(node)


class KernelPurityChecker(Checker):
    rule = "kernel-purity"
    description = (
        "no host syncs / host materialization / Python branches on "
        "tensors inside ops/* device code (CUDA-graph bodies and "
        "DEVICE_ROOTS, with their same-module closure)"
    )

    def __init__(self, scope=SCOPE):
        self.scope = scope

    @staticmethod
    def closure(tree: ast.Module) -> Dict[str, Set[str]]:
        """root name -> the module functions reachable from it (the
        root included)."""
        fns = {
            n.name: n
            for n in tree.body
            if isinstance(n, ast.FunctionDef) and not _cached(n)
        }
        roots = (_graph_roots(tree, fns) | _declared_roots(tree)) & set(fns)
        out: Dict[str, Set[str]] = {}
        for root in roots:
            reach = {root}
            frontier = [root]
            while frontier:
                for callee in _called_names(fns[frontier.pop()]) & set(fns):
                    if callee not in reach:
                        reach.add(callee)
                        frontier.append(callee)
            out[root] = reach
        return out

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        for sf in ctx.walk(*self.scope):
            tree = sf.tree
            # module-level functions only: nested defs are visited
            # through their parent's visitor (shared taint state)
            fns = {
                n.name: n
                for n in tree.body
                if isinstance(n, ast.FunctionDef)
            }
            closure = self.closure(tree)
            traced: Set[str] = set().union(*closure.values())
            symbols = enclosing_symbols(tree)
            for name in sorted(traced):
                fn = fns[name]
                _TaintVisitor(
                    sf.path,
                    symbols.get(fn, name),
                    _tensor_params(fn) if name in closure else set(),
                    findings,
                ).visit(fn)
        return findings
