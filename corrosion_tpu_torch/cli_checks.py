"""The operator-surface scenario: agents started and driven through the CLI.

A `ProcessCluster` of three agents (topology `A -> C`, `B -> C`), each a
`python -m <module> -c <config> agent` process, is driven only through
the CLI, each command a subprocess of its own, as an operator drives it:

1. `exec` writes `rows` rows on A (`per_stmt` rows per INSERT statement,
   `per_exec` statements per call, so a few hundred statements in all);
2. `query` on A, B and C gives the same row lines once B and C hold
   them (a digest of the lines, their count and the first three);
3. `cluster members` on each node lists its members;
4. `sync generate`, `subs list` and `locks` answer over the admin socket;
5. `template` renders one query to a file on B;
6. `backup` on A, then `restore` of that copy into a fresh path (another
   admin path, so no live agent refuses it): the restored rows' digest;
7. A stops; `snapshot dump` of A's database; B writes `extra` rows; a
   fourth node D gets the snapshot by `snapshot install` (with its own
   actor id) and boots by `agent --from-snapshot`, bootstrapping from B
   and C; it must catch up to B's rows by sync.

`scenario_cli(api, tmp, ...)` runs it over an `api` namespace: `module`
(the package run with `-m`), `ProcessCluster` and `Topology` (the
package's `devcluster`), `device_args` (the global flags that name the
agents' device; empty for a package without them), `env` (added to
the subprocesses' environment) and `kernel_libs` (the package's kernel
libraries by name, whose loading `device_holders` reads in each agent
process). `port_api(device)` is the port's; the tests build the JAX
package's. D's config is written by the port's `devcluster.node_config`,
the template of `ProcessCluster.generate_configs` (the JAX package's
writes the same text, `tests/test_torch_devcluster.py`). `cli_outcome(rec)` is what a reference
run must equal; `cli_checks(rec, ref)` lists what failed.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

from corrosion_tpu_torch.devcluster import (ProcessCluster, Topology,
                                            free_port, node_config)
from corrosion_tpu_torch.ops import _build
from corrosion_tpu_torch.runtime.config import load_config

REPO = Path(__file__).resolve().parent.parent

TOPOLOGY = "A -> C\nB -> C\n"
SCHEMA = "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
# one query rendered by the template engine
TEMPLATE = (
    '<% for row in sql("SELECT id, text FROM tests WHERE id % 97 = 0'
    ' ORDER BY id") %><%= row.id %>=<%= row.text %>\n<% end %>'
)
ROWS_SQL = "SELECT id, text FROM tests ORDER BY id"
# D's own identity: a snapshot install keeps the installer's actor id
D_ACTOR_ID = "00000000-0000-4000-8000-00000000000d"
# the chip phase's shape; the CPU tests run a smaller one
CHIP_CLI = dict(rows=10_000, per_stmt=50, per_exec=40, extra=100)

CLI_TIMEOUT_S = 120.0


def port_api(device: Optional[str] = None) -> SimpleNamespace:
    """The port's CLI scenario namespace; `device` is handed to every
    agent as `--device` (none: the agents take the card)."""
    return SimpleNamespace(
        module="corrosion_tpu_torch", ProcessCluster=ProcessCluster,
        Topology=Topology, cluster_kw={"device": device},
        device_args=["--device", str(device)] if device else [], env={},
        kernel_libs={n: str(_build.library_path(n))
                     for n in _build.sources()})


def lines_digest(lines: List[str]) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def rows_lines(db_path: str) -> List[str]:
    """`query`'s rendering of `ROWS_SQL`, read from a database file."""
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(ROWS_SQL).fetchall()
    finally:
        conn.close()
    return ["|".join("" if v is None else str(v) for v in r) for r in rows]


def _insert(ids) -> str:
    return "INSERT INTO tests (id, text) VALUES " + ", ".join(
        f"({i}, 'r{i}')" for i in ids)


def _after_bytes(line: str) -> str:
    """A snapshot command's report after its byte count (the bytes depend
    on the database file's layout)."""
    return line.split(", ", 1)[1].strip()


def _gossip_port(cfg: Path) -> int:
    return int(load_config(str(cfg)).gossip.bind_addr.rsplit(":", 1)[1])


def _wait_port(port: int, proc, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(f"agent exited early ({proc.returncode})")
            time.sleep(0.1)
    raise TimeoutError(f"agent api on {port} never came up")


def scenario_cli(api, tmp: str, rows: int = 400, per_stmt: int = 50,
                 per_exec: int = 40, extra: int = 20,
                 timeout: float = 300.0) -> dict:
    """Run the scenario; returns the record (outcome, walls, and per
    agent process whether it holds the card)."""
    tmp = Path(tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(api.env)
    walls: Dict[str, float] = {}
    t_start = time.monotonic()

    def cli(cfg: Path, *args: str, check: bool = True, flags=()):
        out = subprocess.run(
            [sys.executable, "-m", api.module, "-c", str(cfg), *flags,
             *args],
            capture_output=True, text=True, env=env, timeout=CLI_TIMEOUT_S,
            cwd=str(REPO))
        if check and out.returncode != 0:
            raise AssertionError(
                f"{' '.join(args[:3])}: rc {out.returncode}\n"
                f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        return out

    def query_lines(cfg: Path) -> List[str]:
        return cli(cfg, "query", ROWS_SQL).stdout.splitlines()

    def count(cfg: Path) -> int:
        out = cli(cfg, "query", "SELECT COUNT(*) FROM tests", check=False)
        return int(out.stdout.strip()) if out.returncode == 0 else -1

    def wait_rows(cfgs, want: int) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(count(c) == want for c in cfgs):
                return
            time.sleep(0.5)
        raise AssertionError(
            f"rows never reached {want}: {[count(c) for c in cfgs]}")

    cluster = api.ProcessCluster(api.Topology.parse(TOPOLOGY),
                                 str(tmp / "cluster"), SCHEMA,
                                 **api.cluster_kw)
    procs: dict = {}
    try:
        cluster.start(env=env)
        procs.update(cluster.procs)
        cluster.wait_up(timeout=timeout)
        walls["up_s"] = time.monotonic() - t_start
        cfg = {n: tmp / "cluster" / n / "config.toml" for n in "ABC"}

        # 3. membership: every node lists the other two (polled: SWIM
        # takes a few probe periods)
        def members(name: str) -> list:
            out = cli(cfg[name], "cluster", "members")
            return json.loads(out.stdout) if out.stdout.strip() else []

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            sizes = {n: len(members(n)) for n in "ABC"}
            if all(s == 2 for s in sizes.values()):
                break
            time.sleep(0.5)
        walls["members_s"] = time.monotonic() - t_start
        member_counts = {n: len(members(n)) for n in "ABC"}

        # 1. the writes, a few hundred multi-row statements
        t0 = time.monotonic()
        ids = list(range(1, rows + 1))
        stmts = [_insert(ids[i:i + per_stmt])
                 for i in range(0, rows, per_stmt)]
        affected = []
        for i in range(0, len(stmts), per_exec):
            out = cli(cfg["A"], "exec", *stmts[i:i + per_exec])
            affected += [r.get("rows_affected")
                         for r in json.loads(out.stdout)["results"]]
        walls["exec_s"] = time.monotonic() - t0

        # 2. B and C hold the rows; the three give the same lines
        wait_rows([cfg["B"], cfg["C"]], rows)
        walls["replicated_s"] = time.monotonic() - t0
        lines = {n: query_lines(cfg[n]) for n in "ABC"}
        head = cli(cfg["B"], "query", ROWS_SQL + " LIMIT 2",
                   "--columns").stdout.splitlines()

        # every agent process holds the card (A read while it lives; B
        # and C again once D caught up)
        libs = getattr(api, "kernel_libs", {})
        card = device_holders({n: p.pid for n, p in procs.items()}, libs)

        # 4. the admin socket
        gen = json.loads(cli(cfg["A"], "sync", "generate").stdout)
        subs = json.loads(cli(cfg["B"], "subs", "list").stdout)
        locks = json.loads(cli(cfg["C"], "locks", "--top", "5").stdout)
        states = json.loads(cli(cfg["C"], "cluster",
                                "membership-states").stdout)

        # 5. one template rendered to a file
        tpl = tmp / "rows.tpl"
        tpl.write_text(TEMPLATE)
        rendered = tmp / "rows.txt"
        cli(cfg["B"], "template", f"{tpl}:{rendered}")
        template_bytes = rendered.read_bytes()

        # 6. backup on A, restored into a fresh path
        backup = tmp / "backup.db"
        cli(cfg["A"], "backup", str(backup))
        restored = tmp / "restored.db"
        cli(cfg["A"], "restore", str(backup),
            flags=("--db-path", str(restored),
                   "--admin-path", str(tmp / "none.sock")))
        restored_lines = rows_lines(str(restored))

        # 7. A stops; its snapshot boots a fourth node D
        a = cluster.procs["A"]
        a.send_signal(signal.SIGTERM)
        a.wait(60)
        snap = tmp / "a.snapshot"
        dump = cli(cfg["A"], "snapshot", "dump", str(snap))
        t0 = time.monotonic()
        extra_ids = list(range(rows + 1, rows + extra + 1))
        cli(cfg["B"], "exec", _insert(extra_ids))
        d_api = free_port()
        cfg["D"] = node_config(tmp / "D", SCHEMA, d_api, free_port(),
                               [_gossip_port(cfg["B"]),
                                _gossip_port(cfg["C"])])
        install = cli(cfg["D"], "snapshot", "install", str(snap),
                      "--self-actor-id", D_ACTOR_ID)
        d_log = open(tmp / "D" / "agent.log", "w")
        d = subprocess.Popen(
            [sys.executable, "-m", api.module, "-c", str(cfg["D"]),
             *api.device_args, "agent", "--from-snapshot", str(snap)],
            stdout=d_log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO))
        procs["D"] = d
        try:
            _wait_port(d_api, d, timeout)
            walls["d_up_s"] = time.monotonic() - t0
            wait_rows([cfg["B"], cfg["C"], cfg["D"]], rows + extra)
            walls["d_caught_up_s"] = time.monotonic() - t0
            final = {n: query_lines(cfg[n]) for n in "BCD"}
            d_states = json.loads(cli(cfg["D"], "cluster",
                                      "membership-states").stdout)
            card.update(device_holders(
                {"B": procs["B"].pid, "C": procs["C"].pid, "D": d.pid},
                libs))
        finally:
            d.send_signal(signal.SIGTERM)
            try:
                d.wait(30)
            except subprocess.TimeoutExpired:
                d.kill()
            d_log.close()
    finally:
        cluster.stop()
    walls["total_s"] = time.monotonic() - t_start
    return {
        "rows": rows, "extra": extra, "statements": len(stmts),
        "exec_calls": -(-len(stmts) // per_exec),
        "rows_affected": sum(a or 0 for a in affected),
        "digests": {n: lines_digest(v) for n, v in lines.items()},
        "lines": {n: len(v) for n, v in lines.items()},
        "first_lines": lines["B"][:3],
        "columns_head": head,
        "members": member_counts,
        "membership_states": len(states),
        "sync_generate_keys": sorted(gen),
        "subs": len(subs), "locks_answered": isinstance(locks, list),
        "template_sha": hashlib.sha256(template_bytes).hexdigest()[:16],
        "template_lines": template_bytes.decode().count("\n"),
        "restored_digest": lines_digest(restored_lines),
        # the watermark versions and the schema sha each command reports
        "snapshot_dump": _after_bytes(dump.stdout.split(": ", 1)[1]),
        "snapshot_install": _after_bytes(install.stdout),
        "final_digests": {n: lines_digest(v) for n, v in final.items()},
        "final_lines": {n: len(v) for n, v in final.items()},
        "d_self_id": next((s["id"] for s in d_states if s.get("self")),
                          None),
        "device_holders": card, "walls": walls,
    }


CARD_FILE = re.compile(r"^/dev/nvidia\d+$")
UVM_FILE = "/dev/nvidia-uvm"


def device_holders(pids: Dict[str, int],
                   libs: Optional[Dict[str, str]] = None
                   ) -> Dict[str, dict]:
    """Per node, what `/proc/<pid>` shows of its process: the NVIDIA
    device files it has open (`device_files`) and maps (`mapped`),
    whether it holds a context on a card (`context`: a `/dev/nvidia<N>`
    file open and `/dev/nvidia-uvm` mapped; `cuInit` alone opens the
    card's file and the control nodes but maps no uvm, a context maps
    it), and which of the libraries `libs` (name -> path) it has loaded
    (`libs_loaded`). A kernel whose library a process never loaded made
    no launch there."""
    holders = {}
    for name, pid in pids.items():
        devs, mapped = set(), set()
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    target = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if target.startswith("/dev/nvidia"):
                    devs.add(target)
            with open(f"/proc/{pid}/maps") as f:
                for line in f:
                    parts = line.split(None, 5)
                    if len(parts) == 6:
                        mapped.add(parts[5].strip())
        except OSError:
            pass
        holders[name] = {
            "pid": pid, "device_files": sorted(devs),
            "mapped": sorted(m for m in mapped
                             if m.startswith("/dev/nvidia")),
            "context": (any(CARD_FILE.match(d) for d in devs)
                        and UVM_FILE in mapped),
            "libs_loaded": sorted(n for n, path in (libs or {}).items()
                                  if path in mapped)}
    return holders


def cli_outcome(rec: dict) -> dict:
    """What a reference run must equal (no walls, no pids)."""
    return {k: rec[k] for k in (
        "rows", "extra", "statements", "exec_calls", "rows_affected",
        "digests", "lines", "first_lines", "columns_head", "members",
        "membership_states", "sync_generate_keys", "subs",
        "locks_answered", "template_sha", "template_lines",
        "restored_digest", "snapshot_dump", "snapshot_install",
        "final_digests", "final_lines", "d_self_id")}


def cli_checks(rec: dict, ref: Optional[dict]) -> List[str]:
    """What failed: replicas and the restored copy equal, D caught up,
    and (with a reference) the outcome equal to it."""
    bad = []
    if len(set(rec["digests"].values())) != 1:
        bad.append(f"replicas differ: {rec['digests']}")
    if rec["restored_digest"] != rec["digests"]["A"]:
        bad.append("restored copy differs from A")
    if len(set(rec["final_digests"].values())) != 1:
        bad.append(f"D did not catch up: {rec['final_digests']}")
    if rec["rows_affected"] != rec["rows"]:
        bad.append(f"rows affected {rec['rows_affected']}")
    if ref is not None and cli_outcome(rec) != ref:
        got = cli_outcome(rec)
        bad.append("outcome differs from the reference: " + json.dumps(
            {k: (got[k], ref.get(k)) for k in got if got[k] != ref.get(k)}))
    return bad
