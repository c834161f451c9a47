"""actuator-discipline: every registered remediation actuator is safe
to fire unattended.

The bug class (r22 remediation plane): an actuator is a lever the
supervisor pulls WITHOUT a human in the loop, so a sloppy one is worse
than no automation — an uncooled actuator flaps (act, fail to help,
act again next tick, forever); an actuator blind to the chaos CENSUS
"fixes" drill injections and poisons the A/B recovery numbers; an
actuator that leaves no flight frame makes the post-incident question
"what did the machine do to itself?" unanswerable.

The discipline, checkable per `Actuator(...)` registration:

- `cooldown_secs=` must be present, and when it is a literal it must
  be positive (config-sourced expressions like
  ``cfg.sync_cooldown_secs`` are accepted — their positivity is the
  config's contract).
- `act=` must name a module-level function (resolvable for this scan —
  lambdas and imported callables hide the body), and that body must
  contain BOTH disciplined calls:
  - ``CENSUS.snapshot()`` — the drill marker check against the chaos
    census, so every action/event records whether it ran under an
    injected fault;
  - ``FLIGHT.record_host_frame(...)`` — the flight-recorder emit, so
    incident dumps carry the action.

Deliberately NOT flagged: `Actuator(...)` constructions outside
`corrosion_tpu_torch/` (tests build synthetic probe actuators on purpose)
and the `Actuator` dataclass definition itself.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from corrosion_tpu_torch.analysis.core import (
    AnalysisContext,
    Checker,
    Finding,
    enclosing_symbols,
)

SCOPE = ("corrosion_tpu_torch",)

# the two calls an act body must make, receiver -> method
_REQUIRED_CALLS = {
    "CENSUS": "snapshot",
    "FLIGHT": "record_host_frame",
}


def _module_functions(tree: ast.AST) -> Dict[str, ast.AST]:
    return {
        n.name: n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _body_calls(fn: ast.AST, receiver: str, method: str) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == method
            and isinstance(f.value, ast.Name)
            and f.value.id == receiver
        ):
            return True
    return False


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class ActuatorDisciplineChecker(Checker):
    rule = "actuator-discipline"
    description = (
        "every Actuator(...) registration must carry a positive "
        "cooldown, and its act body must check the chaos CENSUS "
        "(drill marker) and emit a FLIGHT frame (remediation plane "
        "safety discipline)"
    )

    def __init__(self, scope=SCOPE):
        self.scope = scope

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        for sf in ctx.walk(*self.scope):
            symbols = enclosing_symbols(sf.tree)
            funcs = _module_functions(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if not (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "Actuator"
                ):
                    continue
                findings.extend(
                    self._check_registration(sf, symbols, funcs, node)
                )
        return findings

    def _check_registration(
        self, sf, symbols, funcs, node: ast.Call
    ) -> List[Finding]:
        out: List[Finding] = []

        def flag(message: str) -> None:
            out.append(
                Finding(
                    rule=self.rule,
                    path=sf.path,
                    line=node.lineno,
                    symbol=symbols.get(node, "<module>"),
                    message=message,
                    snippet=self.snippet_of(node),
                )
            )

        name_kw = _kwarg(node, "name")
        label = (
            name_kw.value
            if isinstance(name_kw, ast.Constant)
            and isinstance(name_kw.value, str)
            else "<actuator>"
        )

        cd = _kwarg(node, "cooldown_secs")
        if cd is None:
            flag(
                f"actuator {label!r} registered without cooldown_secs "
                "— an uncooled actuator flaps (acts every supervisor "
                "tick); pass a positive cooldown"
            )
        elif isinstance(cd, ast.Constant) and (
            not isinstance(cd.value, (int, float))
            or isinstance(cd.value, bool)
            or cd.value <= 0
        ):
            flag(
                f"actuator {label!r} has non-positive cooldown_secs="
                f"{cd.value!r} — the cooldown gate is what stops "
                "act/flap loops; use a positive number"
            )

        act = _kwarg(node, "act")
        fn = (
            funcs.get(act.id)
            if isinstance(act, ast.Name)
            else None
        )
        if fn is None:
            flag(
                f"actuator {label!r} act= is not a module-level "
                "function (lambda/imported callable) — the discipline "
                "scan cannot verify its CENSUS drill check and FLIGHT "
                "emit; define the act in this module"
            )
            return out
        for receiver, method in _REQUIRED_CALLS.items():
            if not _body_calls(fn, receiver, method):
                what = (
                    "chaos drill marker check"
                    if receiver == "CENSUS"
                    else "flight-recorder emit"
                )
                flag(
                    f"actuator {label!r} act `{fn.name}` never calls "
                    f"{receiver}.{method}(...) — every act needs the "
                    f"{what} so unattended actions stay attributable"
                )
        return out
