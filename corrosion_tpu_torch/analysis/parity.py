"""lane-parity: SwimState <-> PViewState <-> mesh routing drift.

The bug class this guards: every kernel round so far (telemetry r7,
flight ring r8, Lifeguard r9) edited `ops/swim.py` and
`ops/swim_pview.py` in lockstep — 30+ protocol lanes duplicated by
hand, with `parallel/mesh.py` routing the non-per-member lanes BY NAME.
One missed edit ships a kernel whose states silently disagree on lane
names, dtypes or ordering (a wire-format change for every state
snapshot), or a new replicated lane that the mesh happily member-shards.
This checker parses both state NamedTuples, their init constructors and
the mesh's by-name special cases, and fails on any divergence outside
the two documented ones.

The port spells dtypes the torch way: module constants
`NAME = torch.<dtype>`, function-local ones (`i32 = torch.int32`), and
a local constructor helper whose `dtype=` default fills the lanes that
name none (`def zeros(*shape, dtype=i32)` ... `inc=zeros(n)`).  All
three resolve to the canonical token (`int32`, `bool`, ...), so the
model of the port's states is the model of the JAX package's.  The
port has no `parallel/mesh.py` yet: the mesh leg is silent until it
does.

Documented divergences (everything else must match exactly):
- the table lane: dense `view` [N, N] int16  <->  pview `slot_packed`
  [N, K] int32 (packed words need 31 bits) — same position in the
  carry, different representation by design;
- the r6 at-rest int16 diet: pview `buf_key`/`buf_sent`/`susp_inc` are
  LANE_DTYPE (int16) where the dense kernel keeps int32.

Also pinned here: `FLIGHT_LANES = KERNEL_EVENTS + FLIGHT_CENSUS` in
that order (ring-row wire format), the census builder's arity matching
FLIGHT_CENSUS, and the shared `_event_vector`/`_census_frame` imports
(one lane-layout implementation, not two).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

DENSE = "corrosion_tpu_torch/ops/swim.py"
PVIEW = "corrosion_tpu_torch/ops/swim_pview.py"
MESH = "corrosion_tpu_torch/parallel/mesh.py"
METRICS = "corrosion_tpu_torch/runtime/metrics.py"

# (dense_name, pview_name) pairs allowed to differ at the same position
ALLOWED_NAME_PAIRS = {("view", "slot_packed")}
# fields allowed to differ in dtype (dense, pview)
ALLOWED_DTYPE_DIVERGENCE = {
    "view/slot_packed": ("int16", "int32"),  # packed words need 31 bits
    "buf_key": ("int32", "int16"),  # r6 at-rest diet
    "buf_sent": ("int32", "int16"),
    "susp_inc": ("int32", "int16"),
}

_DTYPE_KW_RE = re.compile(r"dtype\s*=\s*([A-Za-z_][A-Za-z_.0-9]*)")
_TORCH_DTYPE_RE = re.compile(r"torch\.(\w+)")
# constructors whose first argument is the lane's shape
_CONSTRUCTORS = ("zeros", "ones", "full", "empty")


@dataclass
class LaneInfo:
    name: str
    dtype: Optional[str]  # canonical token ("int32", "bool", ...) or None
    kind: str  # "member" | "other" | "scalar"
    line: int


class _KernelModel:
    """Parsed lane layout of one kernel module."""

    def __init__(self, sf) -> None:
        self.path = sf.path
        self.tree = sf.tree
        self.consts = self._module_dtype_consts()
        self.state_class = self._find_state_class()
        self.fields = self._state_fields()
        self.lanes = self._resolve_lanes()

    def _module_dtype_consts(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    src = ast.unparse(node.value)
                    m = _TORCH_DTYPE_RE.fullmatch(src)
                    if m:
                        out[t.id] = m.group(1)
        return out

    def _local_dtypes(self, fn: ast.FunctionDef) -> None:
        """`name = torch.<dtype>` assignments inside the init builder,
        and the `dtype=` default of each constructor helper it defines
        (`def zeros(*shape, dtype=i32)`)."""
        self.local_consts: Dict[str, str] = {}
        self.helper_dtypes: Dict[str, Optional[str]] = {}
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                m = _TORCH_DTYPE_RE.fullmatch(ast.unparse(node.value))
                if m:
                    self.local_consts[node.targets[0].id] = m.group(1)
        for node in ast.walk(fn):
            if isinstance(node, ast.FunctionDef) and node is not fn:
                args = node.args
                named = list(zip(args.args[::-1], args.defaults[::-1]))
                named += list(zip(args.kwonlyargs, args.kw_defaults))
                for arg, default in named:
                    if arg.arg == "dtype" and default is not None:
                        self.helper_dtypes[node.name] = self._canonical(
                            ast.unparse(default)
                        )

    def _canonical(self, token: str) -> str:
        token = token.split(".")[-1]
        return self.local_consts.get(token, self.consts.get(token, token))

    def _find_state_class(self) -> Optional[ast.ClassDef]:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef) and node.name.endswith(
                "State"
            ):
                return node
        return None

    def _state_fields(self) -> List[Tuple[str, int]]:
        if self.state_class is None:
            return []
        return [
            (stmt.target.id, stmt.lineno)
            for stmt in self.state_class.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
        ]

    def _init_constructor(self) -> Optional[ast.Call]:
        """The `return <State>(...)` call of the init builder — the one
        place every lane's dtype/shape is spelled out."""
        if self.state_class is None:
            return None
        best: Optional[Tuple[bool, ast.Call, ast.FunctionDef]] = None
        for fn in ast.walk(self.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id == self.state_class.name
                    and node.value.keywords
                ):
                    is_init = "init" in fn.name
                    if best is None or (is_init and not best[0]):
                        best = (is_init, node.value, fn)
        if best is None:
            return None
        self._init_fn = best[2]
        return best[1]

    def _resolve_expr(
        self, fn: ast.FunctionDef, value: ast.AST
    ) -> ast.AST:
        """Chase one level of local-name indirection to the first
        construction that names a dtype (`buf_key = torch.zeros(...,
        dtype=...)` ... later `buf_key[:, 0] = ...`)."""
        if not isinstance(value, ast.Name):
            return value
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Name)
                        and t.id == value.id
                        and "dtype=" in ast.unparse(node.value)
                    ):
                        return node.value
        return value

    def _dtype_of(self, expr: ast.AST) -> Optional[str]:
        src = ast.unparse(expr)
        m = _DTYPE_KW_RE.search(src)
        if m:
            return self._canonical(m.group(1))
        # a local constructor helper called without `dtype=`: its default
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name)
            and expr.func.id in self.helper_dtypes
        ):
            return self.helper_dtypes[expr.func.id]
        return None

    def _kind_of(self, expr: ast.AST) -> str:
        """'member' if the first constructed dim is `n`, 'other' for
        non-member arrays (events/ring), 'scalar' when no array
        construction is visible (the tick counter)."""
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _CONSTRUCTORS
            ) or (
                isinstance(f, ast.Name) and f.id in self.helper_dtypes
            ):
                first = node.args[0]
                if isinstance(first, ast.Tuple):
                    if not first.elts:
                        return "scalar"  # torch.zeros(()): a 0-d lane
                    first = first.elts[0]
                if isinstance(first, ast.Name) and first.id == "n":
                    return "member"
                return "other"
        return "scalar"

    def _resolve_lanes(self) -> Dict[str, LaneInfo]:
        ctor = self._init_constructor()
        out: Dict[str, LaneInfo] = {}
        by_name = dict(self.fields)
        self.local_consts, self.helper_dtypes = {}, {}
        if ctor is None:
            return out
        self._local_dtypes(self._init_fn)
        for kw in ctor.keywords:
            if kw.arg is None:
                continue
            expr = self._resolve_expr(self._init_fn, kw.value)
            out[kw.arg] = LaneInfo(
                name=kw.arg,
                dtype=self._dtype_of(expr),
                kind=self._kind_of(expr),
                line=by_name.get(kw.arg, kw.value.lineno),
            )
        return out


def _mesh_replicated_names(sf) -> Optional[Tuple[List[str], int]]:
    """The by-name replicated-lane tuple in `_state_shardings`
    (`... or name in ("events", "ring")`)."""
    for node in ast.walk(sf.tree):
        if (
            isinstance(node, ast.Compare)
            and len(node.ops) == 1
            and isinstance(node.ops[0], ast.In)
            and isinstance(node.left, ast.Name)
            and node.left.id == "name"
            and isinstance(node.comparators[0], (ast.Tuple, ast.List, ast.Set))
        ):
            names = [
                e.value
                for e in node.comparators[0].elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
            return names, node.lineno
    return None


def _tuple_const(tree: ast.AST, name: str) -> Optional[List[str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            if isinstance(node.value, (ast.Tuple, ast.List)):
                return [
                    e.value
                    for e in node.value.elts
                    if isinstance(e, ast.Constant)
                ]
    return None


class LaneParityChecker(Checker):
    rule = "lane-parity"
    description = (
        "SwimState/PViewState lane names, dtypes and ordering stay in "
        "lockstep with each other and with parallel/mesh.py's by-name "
        "replication routing"
    )

    def __init__(
        self,
        dense: str = DENSE,
        pview: str = PVIEW,
        mesh: str = MESH,
        metrics: str = METRICS,
    ):
        self.dense = dense
        self.pview = pview
        self.mesh = mesh
        self.metrics = metrics

    def _finding(
        self, path: str, line: int, symbol: str, message: str, snippet: str
    ) -> Finding:
        return Finding(
            rule=self.rule,
            path=path,
            line=line,
            symbol=symbol,
            message=message,
            snippet=snippet,
        )

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        dense_sf, pview_sf = ctx.file(self.dense), ctx.file(self.pview)
        mesh_sf = ctx.file(self.mesh)
        if dense_sf is None or pview_sf is None:
            return findings
        d, p = _KernelModel(dense_sf), _KernelModel(pview_sf)

        # 1. field-name ordering, modulo the allowed table-lane pair
        d_names = [n for n, _ in d.fields]
        p_names = [n for n, _ in p.fields]
        for i in range(max(len(d_names), len(p_names))):
            dn = d_names[i] if i < len(d_names) else "<missing>"
            pn = p_names[i] if i < len(p_names) else "<missing>"
            if dn == pn or (dn, pn) in ALLOWED_NAME_PAIRS:
                continue
            findings.append(
                self._finding(
                    self.pview,
                    p.fields[i][1] if i < len(p.fields) else 0,
                    f"{p.state_class.name if p.state_class else '?'}",
                    f"lane #{i} diverges: dense carries {dn!r}, pview "
                    f"carries {pn!r} — state field order is a wire "
                    "format; add the lane to both kernels (or extend "
                    "ALLOWED_NAME_PAIRS with a justification)",
                    f"lane#{i}:{dn}!={pn}",
                )
            )

        # 2. dtype parity, modulo the documented int16 diet
        for dn, pn in zip(d_names, p_names):
            key = dn if dn == pn else f"{dn}/{pn}"
            di, pi = d.lanes.get(dn), p.lanes.get(pn)
            if di is None or pi is None or di.dtype is None or pi.dtype is None:
                continue
            if di.dtype == pi.dtype:
                continue
            if ALLOWED_DTYPE_DIVERGENCE.get(key) == (di.dtype, pi.dtype):
                continue
            findings.append(
                self._finding(
                    self.pview,
                    pi.line,
                    f"{p.state_class.name}.{pn}",
                    f"lane {key!r} dtype diverges: dense={di.dtype} "
                    f"pview={pi.dtype} — at-rest dtype is a wire format "
                    "(extend ALLOWED_DTYPE_DIVERGENCE only with a "
                    "measured diet rationale like r6's int16 lanes)",
                    f"dtype:{key}:{di.dtype}!={pi.dtype}",
                )
            )

        # 3. mesh by-name replication routing covers exactly the
        #    non-per-member array lanes of BOTH kernels
        if mesh_sf is not None:
            mesh_info = _mesh_replicated_names(mesh_sf)
            if mesh_info is None:
                findings.append(
                    self._finding(
                        self.mesh, 0, "_state_shardings",
                        "could not locate the by-name replicated-lane "
                        "tuple (`name in (...)`) — lane-parity cannot "
                        "verify replication routing",
                        "mesh:no-replicated-tuple",
                    )
                )
            else:
                replicated, mesh_line = mesh_info
                for model in (d, p):
                    for lane in model.lanes.values():
                        if lane.kind == "other" and lane.name not in replicated:
                            findings.append(
                                self._finding(
                                    self.mesh,
                                    mesh_line,
                                    "_state_shardings",
                                    f"{model.path} lane {lane.name!r} is "
                                    "not per-member (leading dim is not "
                                    "n) but missing from mesh.py's "
                                    "replicated-by-name tuple — it would "
                                    "be member-sharded and all-gathered "
                                    "wrong",
                                    f"mesh:unrouted:{lane.name}",
                                )
                            )
                    for name in replicated:
                        lane = model.lanes.get(name)
                        if lane is None:
                            findings.append(
                                self._finding(
                                    self.mesh,
                                    mesh_line,
                                    "_state_shardings",
                                    f"mesh.py replicates lane {name!r} "
                                    f"by name but {model.path} has no "
                                    "such state field",
                                    f"mesh:orphan:{name}:{model.path}",
                                )
                            )
                        elif lane.kind == "member":
                            findings.append(
                                self._finding(
                                    self.mesh,
                                    mesh_line,
                                    "_state_shardings",
                                    f"mesh.py replicates {name!r} but "
                                    f"{model.path} constructs it "
                                    "per-member (leading dim n) — a "
                                    "member lane must be sharded, not "
                                    "replicated",
                                    f"mesh:misrouted:{name}:{model.path}",
                                )
                            )

        # 4. ring-row wire format: FLIGHT_LANES = KERNEL_EVENTS +
        #    FLIGHT_CENSUS in that order, census builder arity matches
        metrics_sf = ctx.file(self.metrics)
        if metrics_sf is not None:
            ok = False
            for node in ast.walk(metrics_sf.tree):
                if (
                    isinstance(node, ast.Assign)
                    and any(
                        isinstance(t, ast.Name) and t.id == "FLIGHT_LANES"
                        for t in node.targets
                    )
                    and isinstance(node.value, ast.BinOp)
                    and isinstance(node.value.op, ast.Add)
                ):
                    left = ast.unparse(node.value.left)
                    right = ast.unparse(node.value.right)
                    ok = left == "KERNEL_EVENTS" and right == "FLIGHT_CENSUS"
            if not ok:
                findings.append(
                    self._finding(
                        self.metrics, 0, "FLIGHT_LANES",
                        "FLIGHT_LANES must be exactly KERNEL_EVENTS + "
                        "FLIGHT_CENSUS (ring-row order is a wire format "
                        "for every drained snapshot)",
                        "flight-lanes-order",
                    )
                )
            census = _tuple_const(metrics_sf.tree, "FLIGHT_CENSUS")
            if census is not None:
                for node in ast.walk(dense_sf.tree):
                    if (
                        isinstance(node, ast.FunctionDef)
                        and node.name == "_census_frame"
                    ):
                        for sub in ast.walk(node):
                            if (
                                isinstance(sub, ast.Call)
                                and ast.unparse(sub.func) == "torch.stack"
                                and sub.args
                                and isinstance(sub.args[0], ast.List)
                            ):
                                got = len(sub.args[0].elts)
                                if got != len(census):
                                    findings.append(
                                        self._finding(
                                            self.dense,
                                            sub.lineno,
                                            "_census_frame",
                                            f"census frame stacks {got} "
                                            "lanes but FLIGHT_CENSUS "
                                            f"names {len(census)} — the "
                                            "ring row and its schema "
                                            "disagree",
                                            "census-arity",
                                        )
                                    )

        # 5. one lane-layout implementation: the pview kernel must share
        #    the dense kernel's _event_vector/_census_frame (or import
        #    the canonical KERNEL_EVENTS itself), never hand-roll order
        shared = set()
        for node in ast.walk(pview_sf.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    shared.add(alias.name)
        if not (
            {"_event_vector", "_census_frame"} <= shared
            or "KERNEL_EVENTS" in shared
        ):
            findings.append(
                self._finding(
                    self.pview, 0, "<module>",
                    "pview kernel neither imports the dense kernel's "
                    "_event_vector/_census_frame nor KERNEL_EVENTS — "
                    "a hand-rolled lane order will drift",
                    "pview:no-shared-lane-impl",
                )
            )
        return findings
