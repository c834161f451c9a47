"""Template engine: render files from live query results.

The port's copy of `corrosion_tpu/tpl.py`.

Counterpart of the reference's rhai-tpl engine (`klukai/src/tpl/mod.rs`,
`klukai/src/command/tpl.rs`, ~1131 LoC): templates embed script blocks
that call `sql("SELECT ...")` and iterate rows; `.to_json()` / `.to_csv()`
render whole result sets; `hostname()` is available. Specs are
`SRC:DST[:CMD]` — render to a temp file, atomically rename over DST, then
run CMD. Watch mode re-renders when any queried data changes (100 ms
debounce, like the reference's TemplateCommand::Render loop) and
recompiles when the template file itself changes.

Template syntax (classic mini-template, compiled to Python):
    text …
    <%= expr %>                 emit str(expr)
    <% for row in sql("…") %>   statements / control flow
    …
    <% end %>                   closes for/if blocks

Script blocks run a *Python expression subset* in a namespace exposing
only the template API (sql, hostname, row/cell helpers). Templates are
operator-supplied — the same trust model as the reference's rhai
templates, which can also run `exec_cmd`.
"""

from __future__ import annotations

import asyncio
import csv
import io
import json
import os
import re
import socket
import tempfile
import zlib
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple


class TemplateError(Exception):
    pass


# -- result-set objects ----------------------------------------------------


class Row:
    """One result row: index by position or column name."""

    __slots__ = ("_cols", "_vals")

    def __init__(self, cols: Sequence[str], vals: Sequence[Any]):
        self._cols = cols
        self._vals = list(vals)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._vals[key]
        return self._vals[self._cols.index(key)]

    def __getattr__(self, name):
        try:
            return self._vals[self._cols.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def __iter__(self):
        return iter(self._vals)

    def __len__(self):
        return len(self._vals)

    def to_json(self) -> str:
        return json.dumps(dict(zip(self._cols, self._vals)))

    def cells(self) -> List["Cell"]:
        """The row as (name, value) cells — the reference's Cell type
        with name()/value()/is_null()/to_json()/to_string()
        (tpl/mod.rs:493-500)."""
        return [Cell(c, v) for c, v in zip(self._cols, self._vals)]


class Cell:
    """One (column, value) pair (tpl/mod.rs Cell + SqliteValueWrap)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Any):
        self.name = name
        self.value = value

    def is_null(self) -> bool:
        return self.value is None

    def to_json(self) -> str:
        return json.dumps(self.value)

    def to_string(self) -> str:
        return _stringify(self.value)


class QueryResponse:
    """Iterable result set with to_json()/to_csv() (tpl/mod.rs:38-98)."""

    def __init__(self, cols: List[str], rows: List[List[Any]]):
        self.columns = cols
        self._rows = rows

    def __iter__(self):
        return (Row(self.columns, r) for r in self._rows)

    def __len__(self):
        return len(self._rows)

    def to_json(self, pretty: bool = False) -> str:
        data = [dict(zip(self.columns, r)) for r in self._rows]
        return json.dumps(data, indent=2 if pretty else None)

    def to_csv(self, header: bool = True) -> str:
        buf = io.StringIO()
        w = csv.writer(buf)
        if header:
            w.writerow(self.columns)
        for r in self._rows:
            w.writerow(r)
        return buf.getvalue()


# -- compiler --------------------------------------------------------------

_TAG = re.compile(r"<%(=?)(.*?)%>", re.DOTALL)
_BLOCK_OPEN = re.compile(r"^\s*(for|if|while|elif|else)\b")
_DEDENT = re.compile(r"^\s*(elif|else)\b")


def compile_template(text: str) -> Callable[[dict], str]:
    """Compile template text into a callable(namespace) -> rendered str."""
    src: List[str] = ["def __render__(__ns__):", " __out__ = []"]
    indent = 1

    def emit(line: str) -> None:
        src.append(" " * indent + line.lstrip())

    pos = 0
    for m in _TAG.finditer(text):
        literal = text[pos : m.start()]
        if literal:
            emit(f" __out__.append({literal!r})")
        is_expr, body = m.group(1), m.group(2).strip()
        if is_expr:
            emit(f" __out__.append(__str__({body}))")
        elif body == "end":
            indent -= 1
            if indent < 1:
                raise TemplateError("unbalanced <% end %>")
        elif _DEDENT.match(body):
            indent -= 1
            if indent < 1:
                raise TemplateError(f"unbalanced <% {body} %>")
            emit(f" {body}:")
            indent += 1
        elif _BLOCK_OPEN.match(body):
            emit(f" {body}:")
            indent += 1
        else:
            emit(f" {body}")
        pos = m.end()
    if text[pos:]:
        emit(f" __out__.append({text[pos:]!r})")
    if indent != 1:
        raise TemplateError("unclosed block: missing <% end %>")
    src.append(" return ''.join(__out__)")

    code_obj = compile("\n".join(src), "<template>", "exec")

    def run(ns: dict) -> str:
        # the template body resolves names (sql, hostname, …) through its
        # globals, so inject the namespace there
        g = {"__str__": _stringify, **ns}
        exec(code_obj, g)
        return g["__render__"](ns)

    return run


def _stringify(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# -- render state ----------------------------------------------------------


class TemplateState:
    """Per-render context: the sql() binding plus collected subscriptions
    (tpl/mod.rs TemplateState: cmd channel + cancellation)."""

    def __init__(self, api_addr: str, token: Optional[str], loop, watch: bool):
        self.api_addr = api_addr
        self.token = token
        self.loop = loop
        self.watch = watch
        # watch mode: (client, live aiter) pairs still streaming change
        # events after the initial snapshot was consumed
        self.streams: List[Tuple[Any, Any]] = []

    # sql() runs on the render thread; the HTTP round-trip happens on the
    # main loop (the reference equally block_in_place()s rhai evaluation)
    def sql(self, stmt: Any) -> QueryResponse:
        fut = asyncio.run_coroutine_threadsafe(self._sql(stmt), self.loop)
        return fut.result(timeout=30)

    async def _sql(self, stmt: Any) -> QueryResponse:
        from corrosion_tpu_torch.client import CorrosionApiClient

        if not self.watch:
            async with CorrosionApiClient(
                self.api_addr, token=self.token
            ) as c:
                cols: List[str] = []
                rows: List[List[Any]] = []
                async for ev in c.query(stmt):
                    if "columns" in ev:
                        cols = ev["columns"]
                    elif "row" in ev:
                        rows.append(ev["row"][1])
                    elif "error" in ev:
                        raise TemplateError(ev["error"])
                return QueryResponse(cols, rows)
        # watch mode: subscribe so data changes re-render; keep the live
        # stream past eoq — further events are the re-render signal
        c = CorrosionApiClient(self.api_addr, token=self.token)
        it = c.subscribe(stmt).__aiter__()
        cols = []
        rows = []
        async for ev in it:
            if "columns" in ev:
                cols = ev["columns"]
            elif "row" in ev:
                rows.append(ev["row"][1])
            elif "eoq" in ev:
                break
            elif "error" in ev:
                raise TemplateError(ev["error"])
        self.streams.append((c, it))
        return QueryResponse(cols, rows)

    async def close(self) -> None:
        for c, it in self.streams:
            with _suppress(Exception):
                await it.aclose()
            with _suppress(Exception):
                await c.close()
        self.streams = []

    def exec_cmd(self, cmd: str, *args: str, timeout: float = 10.0) -> str:
        """Run a subprocess from inside a template and return its stdout.

        The upstream templating engine exposes user scripting with
        command execution; this reference snapshot's rhai engine stops at
        the write/to_json/to_csv surface (tpl/mod.rs:451-500), so the
        contract here is the minimal safe form: argv (no shell), bounded
        by `timeout`, non-zero exit raises. Renders run in a worker
        thread (render_once), so blocking is fine.

        OFF by default: a template file is data, and silently granting it
        command execution would widen the agent's attack surface to
        anything that can write a .tpl. Enable explicitly with
        CORRO_TPL_ALLOW_EXEC=1 in the agent's environment."""
        import subprocess

        if os.environ.get("CORRO_TPL_ALLOW_EXEC", "") not in ("1", "true"):
            raise TemplateError(
                "exec_cmd is disabled; set CORRO_TPL_ALLOW_EXEC=1 to allow"
                " templates to run commands"
            )

        try:
            res = subprocess.run(
                [cmd, *args],
                capture_output=True,
                text=True,
                timeout=timeout,
            )
        except subprocess.TimeoutExpired:
            raise TemplateError(
                f"exec_cmd {cmd!r} timed out after {timeout}s"
            ) from None
        except OSError as e:
            raise TemplateError(f"exec_cmd {cmd!r} failed: {e}") from None
        if res.returncode != 0:
            raise TemplateError(
                f"exec_cmd {cmd!r} exited {res.returncode}:"
                f" {res.stderr.strip()[:200]}"
            )
        return res.stdout

    def namespace(self) -> dict:
        return {
            "sql": self.sql,
            "hostname": lambda: socket.gethostname(),
            "exec_cmd": self.exec_cmd,
        }


# -- spec handling ---------------------------------------------------------


def parse_spec(spec: str) -> Tuple[str, str, Optional[str]]:
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise TemplateError(f"spec needs SRC:DST[:CMD], got {spec!r}")
    src, dst = parts[0], parts[1]
    cmd = parts[2] if len(parts) > 2 else None
    return src, dst, cmd


async def render_once(
    api_addr: str,
    token: Optional[str],
    src: str,
    dst: str,
    cmd: Optional[str],
    watch: bool = False,
) -> TemplateState:
    """Render one template spec: compile, evaluate, atomic-replace DST,
    run CMD (command/tpl.rs render loop body)."""
    text = Path(src).read_text()
    template = compile_template(text)
    loop = asyncio.get_running_loop()
    state = TemplateState(api_addr, token, loop, watch)
    rendered = await asyncio.to_thread(template, state.namespace())

    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(Path(dst).parent))
    try:
        with os.fdopen(fd, "w") as f:
            f.write(rendered)
        os.replace(tmp, dst)
    except BaseException:
        with _suppress(OSError):
            os.unlink(tmp)
        raise

    if cmd:
        import shlex

        proc = await asyncio.create_subprocess_exec(*shlex.split(cmd))
        await proc.wait()
    return state


class _suppress:
    def __init__(self, *exc):
        self.exc = exc

    def __enter__(self):
        return self

    def __exit__(self, et, e, tb):
        return et is not None and issubclass(et, self.exc)


async def render_specs(cfg, specs: List[str]) -> int:
    """One-shot render of every spec (template --once path)."""
    api_addr = cfg.api.bind_addr[0]
    for spec in specs:
        src, dst, cmd = parse_spec(spec)
        await render_once(api_addr, cfg.api.authz_bearer, src, dst, cmd)
        print(f"rendered {src} -> {dst}")
    return 0


async def watch_specs(cfg, specs: List[str], tripwire=None) -> None:
    """Continuous mode: re-render on data-change events from any
    subscription the template opened, or when the template file changes
    (mtime + crc32, command/tpl.rs:154-216). 100 ms debounce."""
    api_addr = cfg.api.bind_addr[0]
    tasks = [
        asyncio.ensure_future(
            _watch_one(api_addr, cfg.api.authz_bearer, spec, tripwire)
        )
        for spec in specs
    ]
    try:
        await asyncio.gather(*tasks)
    finally:
        for t in tasks:
            t.cancel()


async def _watch_one(
    api_addr: str, token: Optional[str], spec: str, tripwire
) -> None:
    src, dst, cmd = parse_spec(spec)
    checksum = zlib.crc32(Path(src).read_bytes())
    mtime = os.path.getmtime(src)

    while tripwire is None or not tripwire.tripped:
        state = await render_once(api_addr, token, src, dst, cmd, watch=True)

        # wake on: any subscription change event, or template file change
        wake = asyncio.Event()

        async def sub_listener(it) -> None:
            try:
                async for ev in it:
                    if "change" in ev:
                        wake.set()
            except Exception:
                pass
            wake.set()  # stream died: re-render to resubscribe

        listeners = [
            asyncio.ensure_future(sub_listener(it))
            for _c, it in state.streams
        ]

        async def file_poller() -> None:
            nonlocal checksum, mtime
            while True:
                await asyncio.sleep(1.0)
                try:
                    new_mtime = os.path.getmtime(src)
                except FileNotFoundError:
                    continue
                if new_mtime != mtime:
                    mtime = new_mtime
                    new_sum = zlib.crc32(Path(src).read_bytes())
                    if new_sum != checksum:
                        checksum = new_sum
                        wake.set()
                        return

        poller = asyncio.ensure_future(file_poller())
        try:
            if tripwire is not None:
                from corrosion_tpu_torch.runtime.tripwire import Outcome

                outcome, _ = await tripwire.preemptible(wake.wait())
                if outcome is Outcome.PREEMPTED:
                    return
            else:
                await wake.wait()
            await asyncio.sleep(0.1)  # debounce (DEBOUNCE_DEADLINE)
        finally:
            poller.cancel()
            for t in listeners:
                t.cancel()
            await state.close()
