"""async-blocking: blocking calls directly in `async def` bodies.

The bug class: the r10 matcher deaths — synchronous SQLite work on the
event loop starved heartbeats and subscription streams until the whole
pubsub plane cascaded.  The repo's discipline is to route blocking work
through `asyncio.to_thread` / `loop.run_in_executor` / the bounded
`DiffExecutor`; this checker enforces it where the loops live
(`agent/`, `api/`, `pubsub/`).

What counts as blocking when called with the *async function itself* as
the nearest enclosing function (calls inside nested sync `def`s and
lambdas are exempt — those are exactly the bodies handed to worker
threads):

- sqlite cursor/connection work: `.execute/.executemany/.executescript/
  .fetchone/.fetchall/.commit/.rollback`, `sqlite3.connect`
- `time.sleep` (any import alias of the `time` module)
- file I/O: builtin `open`, `Path.read_text/write_text/read_bytes/
  write_bytes/unlink/mkdir/touch`, `shutil.rmtree/copy*/move`,
  `os.remove/rename/replace/makedirs`
- `subprocess.run/call/check_call/check_output/Popen`

Deliberately NOT flagged (documented tolerance): µs-scale stat calls
(`Path.exists/is_dir/iterdir/stat`) and in-memory helpers whose names
collide with the list but resolve to non-blocking imports
(`dataclasses.replace` vs `os.replace` — import-resolved per module).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from corrosion_tpu_torch.analysis.core import (
    AnalysisContext,
    Checker,
    Finding,
    enclosing_symbols,
)

SCOPE = (
    "corrosion_tpu_torch/agent",
    "corrosion_tpu_torch/api",
    "corrosion_tpu_torch/pubsub",
)

_SQLITE_METHODS = {
    "execute", "executemany", "executescript",
    "fetchone", "fetchall", "commit", "rollback",
}
_PATH_METHODS = {
    "read_text", "write_text", "read_bytes", "write_bytes",
    "unlink", "mkdir", "touch",
}
_SHUTIL_FNS = {"rmtree", "copy", "copy2", "copytree", "move"}
_OS_FNS = {"remove", "rename", "replace", "makedirs", "rmdir"}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "Popen"}


def _module_aliases(tree: ast.AST) -> Dict[str, str]:
    """local name -> module it refers to ('time', 'os', ...), plus
    names imported FROM modules ('replace' -> 'dataclasses')."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = (
                    alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
    return out


class _AsyncBodyVisitor(ast.NodeVisitor):
    """Walks one async def; does NOT descend into nested function
    scopes (sync defs/lambdas are thread bodies, nested async defs get
    their own visit from the checker's top-level walk)."""

    def __init__(self, checker, sf, symbol, aliases, findings):
        self.checker = checker
        self.sf = sf
        self.symbol = symbol
        self.aliases = aliases
        self.findings = findings

    def visit_FunctionDef(self, node):  # nested sync def: thread body
        return

    def visit_AsyncFunctionDef(self, node):
        return  # visited separately with its own symbol

    def visit_Lambda(self, node):
        return

    def _flag(self, node: ast.Call, message: str) -> None:
        self.findings.append(
            Finding(
                rule=AsyncBlockingChecker.rule,
                path=self.sf.path,
                line=node.lineno,
                symbol=self.symbol,
                message=message,
                snippet=Checker.snippet_of(node),
            )
        )

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            base = ast.unparse(f.value)
            base_mod = self.aliases.get(base, base)
            attr = f.attr
            if attr == "sleep" and base_mod == "time":
                self._flag(
                    node,
                    "time.sleep blocks the event loop — "
                    "await asyncio.sleep instead",
                )
            elif attr in _SQLITE_METHODS and base_mod not in (
                "asyncio", "anyio"
            ):
                self._flag(
                    node,
                    f".{attr}() (blocking SQL) directly in an async "
                    "body — route through asyncio.to_thread / the "
                    "DiffExecutor (the r10 matcher-death class)",
                )
            elif attr == "connect" and base_mod == "sqlite3":
                self._flag(
                    node,
                    "sqlite3.connect opens and locks a database file "
                    "on the event loop — open it on a worker thread",
                )
            elif attr in _PATH_METHODS and base_mod in ("Path", "pathlib"):
                self._flag(
                    node,
                    f"Path.{attr} is synchronous file I/O on the "
                    "event loop — wrap in asyncio.to_thread",
                )
            elif attr in _SHUTIL_FNS and base_mod == "shutil":
                self._flag(
                    node,
                    f"shutil.{attr} is synchronous (possibly large) "
                    "file-tree I/O on the event loop — wrap in "
                    "asyncio.to_thread",
                )
            elif attr in _OS_FNS and base_mod == "os":
                self._flag(
                    node,
                    f"os.{attr} is synchronous file I/O on the event "
                    "loop — wrap in asyncio.to_thread",
                )
            elif attr in _SUBPROCESS_FNS and base_mod == "subprocess":
                self._flag(
                    node,
                    f"subprocess.{attr} blocks the loop — use "
                    "asyncio.create_subprocess_exec",
                )
            # Path(...).read_text() — receiver is a Call, not a Name
            elif attr in _PATH_METHODS and isinstance(f.value, ast.Call):
                callee = ast.unparse(f.value.func)
                if callee == "Path" or callee.endswith(".Path"):
                    self._flag(
                        node,
                        f"Path.{attr} is synchronous file I/O on the "
                        "event loop — wrap in asyncio.to_thread",
                    )
        elif isinstance(f, ast.Name):
            mod = self.aliases.get(f.id)
            if f.id == "open" and mod is None:
                self._flag(
                    node,
                    "builtin open() in an async body — wrap the file "
                    "work in asyncio.to_thread",
                )
            elif f.id == "sleep" and mod == "time":
                self._flag(
                    node,
                    "time.sleep blocks the event loop — "
                    "await asyncio.sleep instead",
                )
            elif f.id == "rmtree" and mod == "shutil":
                self._flag(
                    node,
                    "shutil.rmtree on the event loop — wrap in "
                    "asyncio.to_thread",
                )
        self.generic_visit(node)


class AsyncBlockingChecker(Checker):
    rule = "async-blocking"
    description = (
        "no blocking SQL / sleeps / file I/O directly in async def "
        "bodies under agent/, api/, pubsub/"
    )

    def __init__(self, scope=SCOPE):
        self.scope = scope

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        for sf in ctx.walk(*self.scope):
            aliases = _module_aliases(sf.tree)
            symbols = enclosing_symbols(sf.tree)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.AsyncFunctionDef):
                    visitor = _AsyncBodyVisitor(
                        self,
                        sf,
                        symbols.get(node, node.name),
                        aliases,
                        findings,
                    )
                    for stmt in node.body:
                        visitor.visit(stmt)
        return findings
