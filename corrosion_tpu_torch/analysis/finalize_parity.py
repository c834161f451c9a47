"""finalize-parity: the native finalize ABI stays in lockstep with its
Python glue.

The bug class (new with r24's `CORRO_FINALIZE=native`): the local-commit
decision loop now exists in TWO languages — the columnar Python phase B
(`_phase_b_columnar`, store/crdt.py) and its C++ transcription
(`crdt_finalize_batch`, native/crdt_batch.cpp) — glued by a hand-rolled
flat-array ABI (`_phase_b_native`).  The randomized equivalence pins in
tests/test_finalize_batch.py prove value parity for the mixes they
generate, but only on hosts that can BUILD the .so; a structural drift
(the cpp sentinel id diverging from the Python intern convention, an
ABI field added on one side only, the counted columnar fallback quietly
dropped) would ship green on a no-compiler CI host and corrupt clocks
on the first host with g++.

Mechanics (Python side pure AST; cpp side raw-text markers via
`ctx.read_text`, the COMPONENTS.md precedent — no C parser exists
here and none is needed for lockstep pins):

- GLUE SIDE: when `_finalize_engine` declares "native", the
  `_phase_b_native` builder must exist, reference `SENTINEL` and the
  `write_change_cells` batch encoder (the same conventions
  capture-parity pins on the columnar engine), delegate to
  `_phase_b_columnar` for its fallback, and count that fallback on the
  `corro.write.finalize.native.unavailable` series.  The module must
  pin `_NATIVE_FINALIZE_ABI` and `_NATIVE_SENTINEL_CID` as int
  literals — they are the Python half of the cross-language contract.
- NATIVE SIDE: native/crdt_batch.cpp must export `crdt_finalize_batch`
  under `extern "C"`, `#define FINALIZE_ABI_VERSION` equal to the
  Python `_NATIVE_FINALIZE_ABI`, define `FIN_CID_SENTINEL` equal to
  `_NATIVE_SENTINEL_CID`, and still contain the even/odd causal-length
  decision arithmetic (`% 2 == 0` live-row tests and the `& 1` delete
  bump) — the convention every engine's emitted `cl` encodes.

Findings anchor on the side owning the drifted half — the store module
(missing builder / dropped fallback / missing pins) or the cpp file
(missing export / ABI or sentinel drift) — where a
`# corro: noqa[finalize-parity]` (or the cpp-comment equivalent on the
flagged line) belongs next to the contract being waived.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

CRDT_FILE = "corrosion_tpu_torch/store/crdt.py"
CPP_FILE = "native/crdt_batch.cpp"

UNAVAILABLE_METRIC = "corro.write.finalize.native.unavailable"

_ABI_RE = re.compile(r"#define\s+FINALIZE_ABI_VERSION\s+(-?\d+)")
_SENT_RE = re.compile(
    r"FIN_CID_SENTINEL\s*=\s*(-?\d+)"
)
_EXPORT_RE = re.compile(
    r'extern\s+"C"[^;{]*\bint\s+crdt_finalize_batch\s*\(', re.S
)


def _find_function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for n in ast.walk(tree):
        if isinstance(n, ast.FunctionDef) and n.name == name:
            return n
    return None


def _module_int(tree: ast.Module, name: str) -> Optional[int]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == name:
                v = node.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    return v.value
                if (
                    isinstance(v, ast.UnaryOp)
                    and isinstance(v.op, ast.USub)
                    and isinstance(v.operand, ast.Constant)
                    and isinstance(v.operand.value, int)
                ):
                    return -v.operand.value
    return None


def _string_constants(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


class FinalizeParityChecker(Checker):
    rule = "finalize-parity"
    description = (
        "the native finalize ABI (crdt_finalize_batch) stays in "
        "lockstep with its Python glue and fallback accounting"
    )

    def __init__(self, crdt=CRDT_FILE, cpp=CPP_FILE):
        self.crdt = crdt
        self.cpp = cpp

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        crdt_sf = ctx.file(self.crdt)
        if crdt_sf is None:
            return findings

        engine_fn = _find_function(crdt_sf.tree, "_finalize_engine")
        declares_native = engine_fn is not None and "native" in set(
            _string_constants(engine_fn)
        )
        if not declares_native:
            return findings  # no native engine declared, nothing to pin

        def py_finding(line, symbol, message, snippet):
            findings.append(
                Finding(
                    rule=self.rule, path=self.crdt, line=line,
                    symbol=symbol, message=message, snippet=snippet,
                )
            )

        # -- glue side ------------------------------------------------------
        native_fn = _find_function(crdt_sf.tree, "_phase_b_native")
        if native_fn is None:
            py_finding(
                engine_fn.lineno, "_finalize_engine",
                "`_finalize_engine` accepts 'native' but no "
                "`_phase_b_native` builder exists — the selected engine "
                "would be undefined",
                "missing-native-builder",
            )
            return findings
        names = {
            n.id for n in ast.walk(native_fn) if isinstance(n, ast.Name)
        }
        attrs = {
            n.attr for n in ast.walk(native_fn)
            if isinstance(n, ast.Attribute)
        }
        if "SENTINEL" not in names:
            py_finding(
                native_fn.lineno, "_phase_b_native",
                "`_phase_b_native` never references SENTINEL — the "
                "sentinel-cid intern convention has drifted away from "
                "the row-lifecycle contract the other engines share",
                "native-sentinel-drift",
            )
        if "write_change_cells" not in names:
            py_finding(
                native_fn.lineno, "_phase_b_native",
                "`_phase_b_native` does not encode through "
                "`write_change_cells` — cell bytes would fork from the "
                "single-cell truth the equivalence pins assume",
                "native-encoder-drift",
            )
        if "_phase_b_columnar" not in names | attrs:
            py_finding(
                native_fn.lineno, "_phase_b_native",
                "`_phase_b_native` no longer delegates to "
                "`_phase_b_columnar` — no-compiler hosts would lose "
                "their finalize engine instead of degrading",
                "native-fallback-drift",
            )
        if UNAVAILABLE_METRIC not in set(_string_constants(native_fn)):
            py_finding(
                native_fn.lineno, "_phase_b_native",
                "`_phase_b_native` does not count its columnar "
                f"fallback on `{UNAVAILABLE_METRIC}` — degraded hosts "
                "would be invisible to fleet dashboards",
                "native-fallback-uncounted",
            )

        py_abi = _module_int(crdt_sf.tree, "_NATIVE_FINALIZE_ABI")
        py_sent = _module_int(crdt_sf.tree, "_NATIVE_SENTINEL_CID")
        for pin, name in ((py_abi, "_NATIVE_FINALIZE_ABI"),
                          (py_sent, "_NATIVE_SENTINEL_CID")):
            if pin is None:
                py_finding(
                    1, "<module>",
                    f"`{name}` int pin is missing from the store module "
                    "— the Python half of the native finalize contract "
                    "is undeclared",
                    f"missing-pin:{name}",
                )

        # -- native side ----------------------------------------------------
        text = ctx.read_text(self.cpp)
        if not text:
            py_finding(
                native_fn.lineno, "_phase_b_native",
                f"`{self.cpp}` is missing while `_finalize_engine` "
                "declares 'native' — the engine cannot exist",
                "missing-native-source",
            )
            return findings

        def cpp_finding(line, symbol, message, snippet):
            findings.append(
                Finding(
                    rule=self.rule, path=self.cpp, line=line,
                    symbol=symbol, message=message, snippet=snippet,
                )
            )

        m = _EXPORT_RE.search(text)
        if m is None:
            cpp_finding(
                1, "crdt_finalize_batch",
                "no `extern \"C\"` export of `crdt_finalize_batch` — "
                "the ctypes glue would load a library without its "
                "entrypoint",
                "missing-native-export",
            )
        m = _ABI_RE.search(text)
        if m is None or (py_abi is not None and int(m.group(1)) != py_abi):
            cpp_finding(
                _line_of(text, m.start()) if m else 1,
                "FINALIZE_ABI_VERSION",
                "FINALIZE_ABI_VERSION "
                + (f"= {m.group(1)} " if m else "is missing ")
                + f"while the Python glue pins _NATIVE_FINALIZE_ABI = "
                f"{py_abi} — the flat-array layout may have changed on "
                "one side only",
                "abi-version-drift",
            )
        m = _SENT_RE.search(text)
        if m is None or (py_sent is not None and int(m.group(1)) != py_sent):
            cpp_finding(
                _line_of(text, m.start()) if m else 1,
                "FIN_CID_SENTINEL",
                "FIN_CID_SENTINEL "
                + (f"= {m.group(1)} " if m else "is missing ")
                + f"while the Python glue interns SENTINEL as "
                f"{py_sent} — sentinel cells would be treated as a "
                "regular column on one side",
                "sentinel-id-drift",
            )
        if "% 2 == 0" not in text or "& 1" not in text:
            cpp_finding(
                1, "crdt_finalize_batch",
                "the even/odd causal-length decision arithmetic "
                "(`% 2 == 0` live tests, `& 1` delete bump) is gone "
                "from the cpp decision loop — the cl parity convention "
                "every engine encodes would fork",
                "decision-arithmetic-missing",
            )
        return findings
