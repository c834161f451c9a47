"""codec-ext: every version-gated codec extension is exhaustive.

The bug class: the r11/r12 trailing-ext pattern (envelope ext v1/v2 in
`types/codec.py`, `_SWIM_EXT_V1` in `net/gossip_codec.py`) demands that
each version gate have BOTH directions implemented — a write path that
emits the gated block and a read path that tolerates its absence — and
an old<->new compat test pinning both, because the compat story is
re-proved by hand every PR that touches an envelope.  A gate with a
writer and no reader (or vice versa) ships a one-way wire format; a
gate no test references loses its compat pin silently the next time the
test file is reorganized.

Mechanics: module-level integer constants matching `*_EXT_V<n>` (or
`_EXT_*` / `*_VERSION_*` gates, conservatively: name contains "EXT" and
ends in a version digit) are collected from the codec modules.  For
each gate:

- WRITE PATH: the constant is referenced inside a function whose name
  contains "encode"/"write";
- READ PATH: referenced inside a function whose name contains
  "decode"/"read";
- COMPAT TEST: the gate's referencing functions — plus their
  same-module callers, one hop, since ext helpers are private
  (`_write_envelope_ext` is reached via `encode_uni_payload`) — include
  at least one name that appears in the configured test files.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from corrosion_tpu_torch.analysis.core import AnalysisContext, Checker, Finding

CODEC_FILES = (
    "corrosion_tpu_torch/types/codec.py",
    "corrosion_tpu_torch/net/gossip_codec.py",
)
# the port's own compat tests
TEST_FILES = (
    "tests/test_torch_store.py",
    "tests/test_torch_agent_wire.py",
    "tests/test_torch_bridge.py",
    "tests/test_torch_snapshot.py",
    "tests/test_torch_store_writes.py",
)

_GATE_RE = re.compile(r"^_?[A-Z0-9_]*EXT[A-Z0-9_]*?_?V?\d+$")


def _gate_constants(tree: ast.Module) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Name)
                and _GATE_RE.match(t.id)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
            ):
                out[t.id] = node.lineno
    return out


class CodecExtChecker(Checker):
    rule = "codec-ext"
    description = (
        "every version-gated codec ext has a write path, a read path "
        "and a compat test referencing it"
    )

    def __init__(self, codec_files=CODEC_FILES, test_files=TEST_FILES):
        self.codec_files = codec_files
        self.test_files = test_files

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        test_text = "\n".join(
            ctx.read_text(t) for t in self.test_files
        )
        for rel in self.codec_files:
            sf = ctx.file(rel)
            if sf is None:
                continue
            gates = _gate_constants(sf.tree)
            if not gates:
                continue
            fns = {
                n.name: n
                for n in sf.tree.body
                if isinstance(n, ast.FunctionDef)
            }
            # function -> referenced gate names; function -> called fns
            refs: Dict[str, Set[str]] = {}
            calls: Dict[str, Set[str]] = {}
            for name, fn in fns.items():
                r: Set[str] = set()
                c: Set[str] = set()
                for node in ast.walk(fn):
                    if isinstance(node, ast.Name):
                        if node.id in gates:
                            r.add(node.id)
                        if node.id in fns:
                            c.add(node.id)
                refs[name] = r
                calls[name] = c
            callers: Dict[str, Set[str]] = {n: set() for n in fns}
            for name, callees in calls.items():
                for callee in callees:
                    callers[callee].add(name)

            for gate, line in sorted(gates.items()):
                writers = [
                    n
                    for n, r in refs.items()
                    if gate in r and ("encode" in n or "write" in n)
                ]
                readers = [
                    n
                    for n, r in refs.items()
                    if gate in r and ("decode" in n or "read" in n)
                ]
                if not writers:
                    findings.append(
                        Finding(
                            rule=self.rule,
                            path=rel,
                            line=line,
                            symbol=gate,
                            message=(
                                f"version gate {gate} has no write path "
                                "(no encode*/write* function references "
                                "it) — a read-only gate is dead compat "
                                "surface or a missing emitter"
                            ),
                            snippet=f"{gate}:no-writer",
                        )
                    )
                if not readers:
                    findings.append(
                        Finding(
                            rule=self.rule,
                            path=rel,
                            line=line,
                            symbol=gate,
                            message=(
                                f"version gate {gate} has no read path "
                                "(no decode*/read* function references "
                                "it) — new peers would emit bytes old "
                                "and new readers both drop"
                            ),
                            snippet=f"{gate}:no-reader",
                        )
                    )
                # compat test: referencing fns + their 1-hop callers
                surface = {
                    n for n, r in refs.items() if gate in r
                }
                for n in list(surface):
                    surface |= callers.get(n, set())
                tested = any(
                    re.search(rf"\b{re.escape(n)}\b", test_text)
                    for n in surface
                ) or gate in test_text
                if surface and not tested:
                    findings.append(
                        Finding(
                            rule=self.rule,
                            path=rel,
                            line=line,
                            symbol=gate,
                            message=(
                                f"version gate {gate}: none of its "
                                "read/write functions "
                                f"({', '.join(sorted(surface))}) appear "
                                f"in {' / '.join(self.test_files)} — "
                                "the old<->new compat pin is missing"
                            ),
                            snippet=f"{gate}:no-compat-test",
                        )
                    )
        return findings
