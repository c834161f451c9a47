"""The port's operator surface (`corrosion_tpu_torch/cli.py`, `__main__.py`,
`admin.py`) against the JAX package's.

- the parser trees are equal apart from the port's global `--device`;
  `--help` lists the JAX CLI's commands; a client command imports no
  torch; importing `__main__` runs nothing; `agent` with no `--device`
  refuses a host without CUDA;
- the admin frames are the same bytes, and every admin command answers
  the same at the same store state (one agent of each package, the
  port's store on the CPU, actor ids masked), whichever package's
  `AdminClient` asks;
- against a JAX agent and a port agent (`--device cpu`), each a
  `python -m ... agent` process, both packages' CLIs print the same
  lines for `exec` (times masked), `query`, the admin commands and the
  HTTP reads;
- backups and snapshots made by one package's CLI restore and install
  with the other's; `db lock` and `tls ... generate` work alike;
- (`slow`) `cli_checks.scenario_cli` on the port equals the JAX
  package's at 400 rows, and the JAX run at `CHIP_CLI` equals
  `chip_smoke.CLI_REF` (each about a minute: a dozen agent processes
  and ~40 CLI subprocesses).

    JAX_PLATFORMS=cpu python -m tests.test_torch_cli

prints `CLI_REF` (the JAX package's CLI on the CPU at `CHIP_CLI`).
"""

from __future__ import annotations

import ast
import asyncio
import json
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import corrosion_tpu.admin as JA
import corrosion_tpu.cli as JCLI
import corrosion_tpu_torch.admin as TA
import corrosion_tpu_torch.cli as TCLI
from corrosion_tpu_torch import cli_checks
from corrosion_tpu_torch.devcluster import free_port
from tests.test_cli import write_config
from tests.test_torch_consul import PKGS
from tests.test_torch_planes import planes_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _planes_uninstalled(planes_reset):
    """The agents these tests boot install the process-global planes
    (trace store, TSDB, profiler): uninstalled, threads joined, around
    every test."""
    yield


REPO = Path(__file__).resolve().parent.parent
SCHEMA = "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
MODULES = {"jax": "corrosion_tpu", "torch": "corrosion_tpu_torch"}


def jax_cli_api() -> SimpleNamespace:
    """`cli_checks`' namespace for the JAX package's CLI and agents."""
    from corrosion_tpu.devcluster import ProcessCluster, Topology

    return SimpleNamespace(
        module="corrosion_tpu", ProcessCluster=ProcessCluster,
        Topology=Topology, cluster_kw={}, device_args=[],
        env={"JAX_PLATFORMS": "cpu"})


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def run_cli(pkg: str, *args, timeout=60):
    return subprocess.run([sys.executable, "-m", MODULES[pkg], *args],
                          capture_output=True, text=True, env=cli_env(),
                          timeout=timeout, cwd=str(REPO))


# ---------------------------------------------------------------------------
# the command tree


def _tree(parser) -> dict:
    """Every argument of a parser and its subparsers, recursively."""
    import argparse

    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out[a.dest] = {name: _tree(sp) for name, sp in a.choices.items()}
            out[a.dest + ".required"] = a.required
        else:
            out[tuple(a.option_strings) or a.dest] = (
                a.dest, a.default, a.nargs, getattr(a.type, "__name__", None),
                a.choices, a.help, type(a).__name__)
    return out


def test_parser_trees_equal_apart_from_device():
    j, t = _tree(JCLI._build_parser()), _tree(TCLI._build_parser())
    assert t.pop(("--device",))[:2] == ("device", None)
    assert t == j
    assert sorted(j["command"]) == sorted((
        "agent", "backup", "restore", "snapshot", "cluster", "consul",
        "query", "exec", "reload", "sync", "locks", "traces", "alerts",
        "profile", "actor", "template", "tls", "db", "subs", "log",
        "devcluster"))


class _NoDevice(ast.NodeTransformer):
    """The port's CLI with its one addition taken out: `device`
    parameters and keywords, the `--device` argument, and the parser's
    description."""

    def visit_arguments(self, node):
        self.generic_visit(node)
        keep = [(a, d) for a, d in zip(
            node.args[len(node.args) - len(node.defaults):],
            node.defaults)]
        node.args = [a for a in node.args if a.arg != "device"]
        node.defaults = [d for a, d in keep if a.arg != "device"]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords
                         if k.arg not in ("device", "description")]
        return node

    def visit_Expr(self, node):
        c = node.value
        if (isinstance(c, ast.Call) and c.args
                and isinstance(c.args[0], ast.Constant)
                and c.args[0].value == "--device"):
            return None
        return self.generic_visit(node)


def _cli_functions(path: Path) -> dict:
    tree = _NoDevice().visit(ast.parse(path.read_text().replace(
        "corrosion_tpu_torch", "corrosion_tpu")))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_cli_code_is_the_jax_clis_but_the_device():
    """Every function of the port's `cli.py` (the agent's OTLP from
    `OTEL_EXPORTER_OTLP_ENDPOINT`, Prometheus, the admin socket, each
    command) is the JAX module's, names aside, once the `device`
    parameters, keywords and flag are taken out."""
    t = _cli_functions(REPO / "corrosion_tpu_torch" / "cli.py")
    j = _cli_functions(REPO / "corrosion_tpu" / "cli.py")
    assert sorted(t) == sorted(j)
    for name in j:
        assert t[name] == j[name], name


def _module_body(path: Path) -> str:
    """A module's syntax tree without its docstring, names evened out."""
    tree = ast.parse(path.read_text().replace("corrosion_tpu_torch",
                                              "corrosion_tpu"))
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("rel", [
    "admin.py", "tpl.py", "consul.py", "chaos/scenarios.py",
    "chaos/workload.py", "runtime/tmpdb.py"])
def test_copied_modules_are_the_jax_modules(rel):
    assert _module_body(REPO / "corrosion_tpu_torch" / rel) == _module_body(
        REPO / "corrosion_tpu" / rel)


def test_help_lists_the_jax_clis_commands():
    out = run_cli("torch", "--help")
    assert out.returncode == 0
    for word in sorted(_tree(JCLI._build_parser())["command"]):
        assert word in out.stdout, word
    assert "--device" in out.stdout


def test_client_commands_import_no_torch(tmp_path):
    """An admin command and an HTTP read run (and fail to connect) with
    no torch imported: client subprocesses start fast."""
    code = (
        "import sys\n"
        "from corrosion_tpu_torch import cli\n"
        "rcs = []\n"
        f"for argv in (['--admin-path', {str(tmp_path / 'none.sock')!r},"
        " 'sync', 'generate'], ['--api-addr', '127.0.0.1:1', 'alerts']):\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "    except SystemExit as e:\n"
        "        rcs.append(e.code)\n"
        "print(rcs, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=cli_env(), timeout=60, cwd=str(REPO))
    assert out.stdout.strip().splitlines()[-1] == "[1, 1] False", out.stderr


def test_importing_main_runs_nothing():
    code = ("import sys\nsys.argv = ['x', '--bogus']\n"
            "import corrosion_tpu_torch.__main__ as m\n"
            "print(m.main.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=cli_env(), timeout=60, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "corrosion_tpu_torch.cli"


def test_agent_without_device_refuses_a_host_without_cuda(tmp_path):
    """No CPU fallback: `agent` with no `--device` takes the card, so on
    this host it fails (CUDA is not available) before binding anything."""
    cfg = write_config(tmp_path, free_port(), free_port())
    out = run_cli("torch", "-c", cfg, "agent")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "admin.sock").exists()


# ---------------------------------------------------------------------------
# the runtime pieces the agent command needs


def test_registry_guard_and_prometheus_text_match():
    from corrosion_tpu.runtime import metrics as jm
    from corrosion_tpu_torch.runtime import metrics as tm

    def read(m):
        r = m.Registry()
        r.max_label_sets = 3
        for i in range(5):
            r.counter("x.total", a=str(i)).inc(i)
        r.gauge("g", q='a"b\\c\nd').set(2)
        for v in (0.0005, 0.3, 30.0):
            r.histogram("h.seconds", path="/v1").observe(v)
        for v in (0.01, 0.5, 0.5, 3.0):
            r.latency("l.seconds", stage="w").observe(v)
        return r.render_prometheus(), sorted(map(repr, r.snapshot()))

    assert read(tm) == read(jm)
    assert "corro_metrics_cardinality_dropped_total" in read(tm)[0]


async def test_serve_prometheus_serves_the_registry():
    import aiohttp

    from corrosion_tpu_torch.runtime.metrics import Registry, serve_prometheus

    reg = Registry()
    reg.counter("corro.x.total", kind="a").inc(3)
    port = free_port()
    runner = await serve_prometheus(f"127.0.0.1:{port}", reg)
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{port}/metrics") as resp:
                assert resp.status == 200
                assert await resp.text() == reg.render_prometheus()
    finally:
        await runner.cleanup()


@pytest.mark.parametrize("sig", ["SIGTERM", "SIGINT"])
def test_tripwire_trips_on_signals(sig, tmp_path):
    code = (
        "import asyncio, os, signal\n"
        "from corrosion_tpu_torch.runtime.tripwire import Tripwire\n"
        "async def main():\n"
        "    tw = Tripwire.from_signals()\n"
        f"    os.kill(os.getpid(), signal.{sig})\n"
        "    await asyncio.wait_for(tw.wait(), 10)\n"
        "    print('tripped', tw.tripped)\n"
        "asyncio.run(main())\n")
    env = cli_env()
    env["CORRO_FLIGHT_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=60, cwd=str(REPO))
    assert out.stdout.strip() == "tripped True", out.stderr


# ---------------------------------------------------------------------------
# the admin socket


class _Buf:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b


@pytest.mark.parametrize("obj", [
    {"cmd": "ping"}, {"kind": "json", "value": {"a": [1, 2.5, None]}},
    {"kind": "error", "msg": "ünïcode"}, {}])
def test_admin_frames_are_the_same_bytes(obj):
    j, t = _Buf(), _Buf()
    JA.write_frame(j, obj)
    TA.write_frame(t, obj)
    assert t.data == j.data

    async def read(mod, data):
        r = asyncio.StreamReader()
        r.feed_data(data)
        r.feed_eof()
        return await mod.read_frame(r), await mod.read_frame(r)

    assert asyncio.run(read(TA, j.data)) == (obj, None)
    assert asyncio.run(read(JA, t.data)) == (obj, None)


ADMIN_CMDS = [
    {"cmd": "ping"},
    {"cmd": "sync", "sub": "generate"},
    {"cmd": "sync", "sub": "reconcile-gaps"},
    {"cmd": "locks", "top": 5},
    {"cmd": "cluster", "sub": "members"},
    {"cmd": "cluster", "sub": "membership-states"},
    {"cmd": "actor", "sub": "version", "actor_id": "<self>", "version": 2},
    {"cmd": "actor", "sub": "version", "actor_id": "<self>", "version": 99},
    {"cmd": "actor", "sub": "version",
     "actor_id": "00000000-0000-4000-8000-000000000001", "version": 1},
    {"cmd": "subs", "sub": "list"},
    {"cmd": "subs", "sub": "info", "id": "nope"},
    {"cmd": "subs", "sub": "info", "hash": "nope"},
    {"cmd": "log", "sub": "set", "filter": "corrosion_x=DEBUG,WARNING"},
    {"cmd": "log", "sub": "reset"},
    {"cmd": "bogus"},
]


def _masked(obj, agent):
    """A reply with the agent's own actor id and address masked (they
    are random per boot)."""
    text = json.dumps(obj).replace(str(agent.actor_id), "<self>")
    return json.loads(text.replace(agent.actor.addr, "<addr>"))


async def _admin_replies(pkg, tmp: Path, client_mod) -> list:
    agent, api = await _boot_agent(pkg)
    path = str(tmp / "admin.sock")
    server = pkg.admin.AdminServer(agent, path)
    await server.start()
    out = []
    try:
        for i in range(3):
            await pkg.run.make_broadcastable_changes(
                agent, lambda tx, i=i: [tx.execute(
                    "INSERT INTO tests (id, text) VALUES (?, ?)",
                    (i, f"t{i}"))])
        async with client_mod.AdminClient(path) as c:
            for cmd in ADMIN_CMDS:
                cmd = json.loads(json.dumps(cmd).replace(
                    "<self>", str(agent.actor_id)))
                r = await c.call(cmd)
                if cmd.get("cmd") == "locks":
                    for v in r["json"][0]:
                        v["held_s"] = "<t>"
                out.append(_masked(r, agent))
    finally:
        await server.stop()
        await api.stop()
        await pkg.run.shutdown(agent)
    return out


async def _boot_agent(pkg):
    from tests.test_torch_consul import _boot

    return await _boot(pkg, SCHEMA)


ADMIN_PKGS = {
    "jax": SimpleNamespace(**vars(PKGS["jax"]), admin=JA),
    "torch": SimpleNamespace(**vars(PKGS["torch"]), admin=TA),
}


async def test_admin_replies_match_across_packages(tmp_path):
    """Each package's server, asked by each package's client."""
    got = {}
    for server in ("jax", "torch"):
        for client, mod in (("jax", JA), ("torch", TA)):
            d = Path(tempfile.mkdtemp(dir=tmp_path, prefix=server[0]))
            got[server, client] = await _admin_replies(
                ADMIN_PKGS[server], d, mod)
    ref = got["jax", "jax"]
    for key, replies in got.items():
        assert replies == ref, key
    by_cmd = dict(zip((json.dumps(c) for c in ADMIN_CMDS), ref))
    assert by_cmd['{"cmd": "ping"}']["json"] == ["pong"]
    assert ref[6]["json"] == [{"state": "current"}]
    assert ref[7]["json"] == [{"state": "unknown"}]
    assert not ref[8]["ok"] and not ref[-1]["ok"]


# ---------------------------------------------------------------------------
# both CLIs against both packages' agents


@pytest.fixture(scope="module")
def live_agents(tmp_path_factory):
    """A JAX agent and a port agent (`--device cpu`), each a process."""
    procs, cfgs = {}, {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path_factory.mktemp(f"cli_{pkg}")
        api_port = free_port()
        cfgs[pkg] = write_config(tmp, api_port, free_port())
        dev = ["--device", "cpu"] if pkg == "torch" else []
        with open(tmp / "agent.log", "w") as log:
            procs[pkg] = (subprocess.Popen(
                [sys.executable, "-m", MODULES[pkg], "-c", cfgs[pkg], *dev,
                 "agent"], stdout=log, stderr=subprocess.STDOUT,
                env=cli_env(), cwd=str(REPO)), api_port, tmp)
    try:
        for pkg, (proc, port, tmp) in procs.items():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    socket.create_connection(("127.0.0.1", port), 0.2).close()
                    if (tmp / "admin.sock").exists():
                        break
                except OSError:
                    pass
                assert proc.poll() is None, (
                    f"{pkg} agent exited:\n"
                    f"{(tmp / 'agent.log').read_text()[-3000:]}")
                time.sleep(0.1)
        yield cfgs
    finally:
        for proc, _port, _tmp in procs.values():
            proc.send_signal(signal.SIGTERM)
        for proc, _port, _tmp in procs.values():
            try:
                proc.wait(20)
            except subprocess.TimeoutExpired:
                proc.kill()


def _exec_lines(stdout: str) -> dict:
    """`exec`'s reply without its times and the version it made (which
    counts the agent's earlier writes)."""
    body = json.loads(stdout)
    for r in body["results"]:
        r.pop("time", None)
    body.pop("time", None)
    body.pop("version", None)
    return body


def _commands(cfg: str, id0: int) -> list:
    return [
        ("exec", [f"INSERT INTO tests (id, text) VALUES ({id0}, 'a'),"
                  f" ({id0 + 1}, NULL)",
                  f"UPDATE tests SET text = 'b' WHERE id = {id0}"]),
        ("query", [f"SELECT id, text FROM tests WHERE id >= {id0}"
                   " ORDER BY id", "--columns"]),
        ("query", ["SELECT ? + 1", "--param", "41"]),
        ("query", ["SELECT nope FROM tests"]),
        ("cluster", ["membership-states"]),
        ("subs", ["info", "--id", "nope"]),
    ]


def _cli_lines(pkg: str, cfg: str, id0: int) -> list:
    out = []
    for cmd, args in _commands(cfg, id0):
        r = run_cli(pkg, "-c", cfg, cmd, *args)
        text = r.stdout
        if cmd == "exec" and r.returncode == 0:
            text = _exec_lines(text)
        elif cmd == "cluster" and args == ["membership-states"]:
            text = [{k: v for k, v in s.items() if k not in ("id", "addr")}
                    for s in json.loads(text)]
        out.append(json.loads(json.dumps(
            (cmd, args[:1], r.returncode, text,
             r.stderr.strip().splitlines()[-1:]))
            .replace(str(id0 + 1), "<id1>").replace(str(id0), "<id0>")))
    gen = run_cli(pkg, "-c", cfg, "sync", "generate")
    out.append(("sync", gen.returncode, sorted(json.loads(gen.stdout))))
    locks = run_cli(pkg, "-c", cfg, "locks", "--top", "3")
    out.append(("locks", locks.returncode,
                isinstance(json.loads(locks.stdout), list)))
    alerts = run_cli(pkg, "-c", cfg, "alerts", "--json")
    out.append(("alerts", alerts.returncode,
                sorted(r["rule"] for r in json.loads(alerts.stdout)["rules"])))
    return out


@pytest.mark.parametrize("agent", ["jax", "torch"])
def test_both_clis_print_alike_against_each_agent(live_agents, agent):
    cfg = live_agents[agent]
    base = 1000 if agent == "jax" else 2000
    # each CLI writes its own two rows (ids masked in the lines)
    j = _cli_lines("jax", cfg, base)
    t = _cli_lines("torch", cfg, base + 100)
    assert t == j
    assert j[1][3].splitlines() == ["id|text", "<id0>|b", "<id1>|"]
    assert j[2][3] == "42\n" and j[3][2] == 1


# ---------------------------------------------------------------------------
# backups, snapshots, db lock, tls


def _seed_db(pkg_name: str, db: Path, rows: int) -> None:
    if pkg_name == "jax":
        from corrosion_tpu.store.crdt import CrdtStore
        from corrosion_tpu.types.base import Timestamp
        kw = {}
    else:
        from corrosion_tpu_torch.store.crdt import CrdtStore
        from corrosion_tpu_torch.types.base import Timestamp
        kw = {"device": "cpu"}
    store = CrdtStore(str(db), **kw)
    store.apply_schema_sql(SCHEMA)
    for i in range(rows):
        with store.write_tx(Timestamp(i + 1)) as tx:
            tx.execute("INSERT INTO tests (id, text) VALUES (?, ?)",
                       (i, f"s{i}"))
    store.close()


def _read(db: Path, sql: str) -> list:
    conn = sqlite3.connect(db)
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def _rows(db: Path) -> list:
    return _read(db, "SELECT id, text FROM tests ORDER BY id")


@pytest.mark.parametrize("maker,user", [("jax", "torch"), ("torch", "jax")])
def test_backups_and_snapshots_cross_packages(tmp_path, maker, user):
    src = tmp_path / "src"
    src.mkdir()
    cfg = write_config(src, free_port(), free_port())
    _seed_db(maker, src / "corrosion.db", 4)
    want = _rows(src / "corrosion.db")

    bak = tmp_path / "backup.db"
    r = run_cli(maker, "-c", cfg, "backup", str(bak))
    assert r.returncode == 0, r.stderr
    dst = tmp_path / "dst"
    dst.mkdir()
    dst_cfg = write_config(dst, free_port(), free_port())
    _seed_db(user, dst / "corrosion.db", 1)
    r = run_cli(user, "-c", dst_cfg, "restore", str(bak))
    assert r.returncode == 0, r.stderr
    assert _rows(dst / "corrosion.db") == want

    snap = tmp_path / "a.snapshot"
    r = run_cli(maker, "-c", cfg, "snapshot", "dump", str(snap))
    assert r.returncode == 0, r.stderr
    cold = tmp_path / "cold"
    cold.mkdir()
    cold_cfg = write_config(cold, free_port(), free_port())
    _seed_db(user, cold / "corrosion.db", 0)
    site = _read(cold / "corrosion.db", "SELECT site_id FROM __crdt_site")
    r = run_cli(user, "-c", cold_cfg, "snapshot", "install", str(snap))
    assert r.returncode == 0, r.stderr
    assert "4 watermark versions" in r.stdout
    assert _rows(cold / "corrosion.db") == want
    assert _read(cold / "corrosion.db",
                 "SELECT site_id FROM __crdt_site") == site


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_db_lock_runs_a_command_under_the_lock(tmp_path, pkg):
    cfg = write_config(tmp_path, free_port(), free_port())
    sqlite3.connect(tmp_path / "corrosion.db").close()
    r = run_cli(pkg, "-c", cfg, "db", "lock", "echo locked-ok")
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines()
             if not ln.startswith("Lock acquired")]
    assert lines == [f"Opening DB file at {tmp_path / 'corrosion.db'}",
                     "Launching command echo locked-ok", "locked-ok",
                     "Exited with code: 0"]


def test_tls_generate_alike(tmp_path):
    pytest.importorskip(
        "cryptography",
        reason="`tls generate` needs the optional `cryptography` package")
    from cryptography import x509

    subjects = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        ca, ca_key = d / "ca-cert.pem", d / "ca-key.pem"
        runs = [
            ("tls", "ca", "generate", "--cert-file", str(ca),
             "--key-file", str(ca_key)),
            ("tls", "server", "generate", "127.0.0.1", "--ca-cert", str(ca),
             "--ca-key", str(ca_key), "--cert-file", str(d / "s.pem"),
             "--key-file", str(d / "s.key")),
            ("tls", "client", "generate", "--ca-cert", str(ca),
             "--ca-key", str(ca_key), "--cert-file", str(d / "c.pem"),
             "--key-file", str(d / "c.key")),
        ]
        outs = []
        for args in runs:
            r = run_cli(pkg, *args)
            assert r.returncode == 0, r.stderr
            outs.append(r.stdout.replace(str(d), "<d>"))
        cas = x509.load_pem_x509_certificate(ca.read_bytes())
        srv = x509.load_pem_x509_certificate((d / "s.pem").read_bytes())
        srv.verify_directly_issued_by(cas)
        subjects[pkg] = (outs, cas.subject.rfc4514_string(),
                         srv.subject.rfc4514_string())
    assert subjects["torch"] == subjects["jax"]


# ---------------------------------------------------------------------------
# the whole scenario


@pytest.mark.slow
def test_scenario_matches_the_jax_clis(tmp_path):
    """`cli_checks.scenario_cli` at 400 rows: the port (agents with
    `--device cpu`) and the JAX package give the same outcome."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = cli_checks.scenario_cli(jax_cli_api(), str(tmp_path / "j"))
    t = cli_checks.scenario_cli(cli_checks.port_api("cpu"),
                                str(tmp_path / "t"))
    assert cli_checks.cli_checks(t, cli_checks.cli_outcome(j)) == []
    assert not cli_checks.cli_checks(j, None)


@pytest.mark.slow
def test_cli_ref_is_the_jax_packages(tmp_path):
    import chip_smoke

    rec = cli_checks.scenario_cli(jax_cli_api(), str(tmp_path),
                                  **cli_checks.CHIP_CLI)
    assert cli_checks.cli_outcome(rec) == chip_smoke.CLI_REF


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        rec = cli_checks.scenario_cli(jax_cli_api(), tmp,
                                      **cli_checks.CHIP_CLI)
    assert not cli_checks.cli_checks(rec, None), cli_checks.cli_checks(
        rec, None)
    print("CLI_REF = " + json.dumps(cli_checks.cli_outcome(rec), indent=4))
