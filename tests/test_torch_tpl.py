"""The port's template engine (`corrosion_tpu_torch/tpl.py`) against the
JAX package's (`corrosion_tpu/tpl.py`).

`tests/test_tpl.py`'s cases through both packages: the compiled program
of each template (its bytecode and constants) and what it renders are
equal, and so are the errors, the query-response helpers and the spec
parser. Against a live agent of each package (the port's store on the
CPU), `render_once`, the JSON render with its command, `exec_cmd` (off
unless `CORRO_TPL_ALLOW_EXEC`) and watch mode write the same bytes.
Everything is compared exactly.
"""

from __future__ import annotations

import asyncio

import pytest

import corrosion_tpu.tpl as JT
import corrosion_tpu_torch.tpl as TT
from tests.test_torch_consul import PKGS, _boot
from tests.test_torch_planes import planes_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _planes_uninstalled(planes_reset):
    """The agents these tests boot install the process-global planes
    (trace store, TSDB, profiler): uninstalled, threads joined, around
    every test."""
    yield


TEST_SCHEMA = "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"

COMPILE_CASES = [
    ("hello <%= 1 + 2 %> world", {}),
    ("<% for x in items %><% if x > 1 %><%= x %>,<% end %><% end %>",
     {"items": [1, 2, 3]}),
    ("<% for x in items %><% if x % 2 == 0 %>e<% else %>o<% end %><% end %>",
     {"items": [1, 2, 3, 4]}),
    ("<% for x in items %><% if x == 1 %>a<% elif x == 2 %>b<% else %>c"
     "<% end %><% end %>", {"items": [1, 2, 3]}),
    ("v=<%= v %>|<%= f %>|<%= n %>", {"v": None, "f": 2.0, "n": 2.5}),
    ("literal only\n", {}),
]


def _code(run):
    """The compiled template's own code object (`run`'s closure cell)."""
    (code,) = [c.cell_contents for c in run.__closure__
               if hasattr(c.cell_contents, "co_code")]
    inner = [k for k in code.co_consts if hasattr(k, "co_code")][0]
    return inner.co_code, [k for k in inner.co_consts
                           if not hasattr(k, "co_code")], inner.co_names


@pytest.mark.parametrize("text,ns", COMPILE_CASES)
def test_compiled_templates_match(text, ns):
    j, t = JT.compile_template(text), TT.compile_template(text)
    assert _code(t) == _code(j)
    assert t(dict(ns)) == j(dict(ns))


@pytest.mark.parametrize("text", [
    "<% for x in items %>never closed", "<% end %>", "<% else %>"])
def test_unbalanced_templates_raise_alike(text):
    errs = []
    for mod in (JT, TT):
        with pytest.raises(mod.TemplateError) as e:
            mod.compile_template(text)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_query_response_helpers_match():
    def read(m):
        qr = m.QueryResponse(["id", "name"], [[1, "ann"], [2, None]])
        rows = list(qr)
        cells = rows[1].cells()
        return (qr.to_json(pretty=True), qr.to_json(), qr.to_csv(),
                rows[0]["name"], rows[0].name, rows[1][0],
                [(c.name, c.value, c.is_null(), c.to_json(), c.to_string())
                 for c in cells])
    assert read(TT) == read(JT)


@pytest.mark.parametrize("spec", ["a.tpl:out.txt", "a.tpl:out.txt:echo hi",
                                  "just-a-src"])
def test_parse_spec_matches(spec):
    def read(m):
        try:
            return m.parse_spec(spec)
        except m.TemplateError as e:
            return ("error", str(e))
    assert read(TT) == read(JT)


async def _insert(pkg, agent, rowid, text):
    await pkg.run.make_broadcastable_changes(
        agent, lambda tx: [tx.execute(
            "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
            [rowid, text])])


async def _renders(pkg, tpl, tmp_path, monkeypatch) -> dict:
    """Render through one package's engine against its own agent."""
    agent, api = await _boot(pkg, TEST_SCHEMA)
    out = {}
    try:
        await _insert(pkg, agent, 1, "alpha")
        await _insert(pkg, agent, 2, "beta")
        src = tmp_path / "t.tpl"
        src.write_text(
            "entries:\n"
            "<% for row in sql('SELECT id, text FROM tests ORDER BY id') %>"
            "- <%= row.id %>: <%= row.text %>\n"
            "<% end %>"
            "host: <%= hostname() %>\n"
            "<%= sql('SELECT id, text FROM tests').to_csv() %>")
        dst = tmp_path / "out.txt"
        await tpl.render_once(api.addrs[0], None, str(src), str(dst), None)
        out["rows"] = dst.read_bytes()

        src.write_text("<%= sql('SELECT id, text FROM tests').to_json() %>")
        marker = tmp_path / "ran.marker"
        await tpl.render_once(api.addrs[0], None, str(src), str(dst),
                              f"touch {marker}")
        out["json"] = dst.read_bytes()
        out["cmd_ran"] = marker.exists()
        marker.unlink()

        loop = asyncio.get_running_loop()
        locked = tpl.TemplateState(api.addrs[0], None, loop, False)
        with pytest.raises(tpl.TemplateError, match="disabled"):
            locked.exec_cmd("echo", "hi")
        monkeypatch.setenv("CORRO_TPL_ALLOW_EXEC", "1")
        src.write_text("v=<%= exec_cmd('echo', 'hi').strip() %>")
        await tpl.render_once(api.addrs[0], None, str(src), str(dst), None)
        out["exec"] = dst.read_bytes()
        state = tpl.TemplateState(api.addrs[0], None, loop, False)
        errs = []
        for argv, kw in ((("sh", "-c", "exit 3"), {}),
                         (("sleep", "5"), {"timeout": 0.2}),
                         (("definitely-not-a-binary",), {})):
            with pytest.raises(tpl.TemplateError) as e:
                state.exec_cmd(*argv, **kw)
            errs.append(str(e.value).split(":")[0])
        out["exec_errors"] = errs
        monkeypatch.delenv("CORRO_TPL_ALLOW_EXEC")

        # watch mode: the initial render, then a re-render on a change
        src.write_text("<% for r in sql('SELECT text FROM tests ORDER BY id')"
                       " %><%= r.text %>;<% end %>")
        watch_dst = tmp_path / "watch.txt"
        task = asyncio.ensure_future(
            tpl._watch_one(api.addrs[0], None, f"{src}:{watch_dst}", None))
        seen = []
        for want in ("alpha;beta;", "alpha;beta;gamma;"):
            if want.endswith("gamma;"):
                await _insert(pkg, agent, 3, "gamma")
            for _ in range(200):
                if watch_dst.exists() and watch_dst.read_text() == want:
                    break
                await asyncio.sleep(0.05)
            seen.append(watch_dst.read_text())
        out["watch"] = seen
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    finally:
        await api.stop()
        await pkg.run.shutdown(agent)
    return out


async def test_renders_against_live_agents_match(tmp_path, monkeypatch):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = await _renders(PKGS["jax"], JT, tmp_path / "j", monkeypatch)
    t = await _renders(PKGS["torch"], TT, tmp_path / "t", monkeypatch)
    assert t == j
    assert b"- 2: beta\n" in t["rows"]
    assert t["json"] == (b'[{"id": 1, "text": "alpha"},'
                         b' {"id": 2, "text": "beta"}]')
    assert t["cmd_ran"] and t["exec"] == b"v=hi"
    assert t["watch"] == ["alpha;beta;", "alpha;beta;gamma;"]
