"""Devcluster: topology DSL → N local agents + measurement harness.

The port's copy of `corrosion_tpu/devcluster.py`, with one addition: the
device the agents' stores decide on. `DevCluster(device=)` hands it to
`agent.run.setup`, and `ProcessCluster(device=)` passes `--device` to
each `python -m corrosion_tpu_torch agent` it spawns; with none named an
agent takes the card (`runtime/device.py::resolve_device`).

Counterpart of `klukai-devcluster` (`src/topology/mod.rs:22` edge parser,
`src/main.rs:107-232` config generation + process spawning): parse
`A -> B` lines into a bootstrap graph, generate per-node configs with
random ports, launch the nodes — here either as in-process agents (fast,
deterministic, used by tests and the convergence bench) or as real
`python -m corrosion_tpu_torch agent` subprocesses like the reference's built
binaries.

The measurement harness fills the BASELINE.md "reference point to
measure" rows: time-to-stable-membership and broadcast propagation
latency for a small devcluster (`scale_ladder.py` rung 0); the 10⁴–10⁶
member rungs run on the batched SWIM tick instead
(`corrosion_tpu_torch.models.cluster.ClusterSim`, the same protocol in
array form).
"""

from __future__ import annotations

import asyncio
import re
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_EDGE = re.compile(r"^\s*([A-Za-z][A-Za-z0-9_]*)\s*->\s*([A-Za-z][A-Za-z0-9_]*)\s*$")


class TopologyError(Exception):
    pass


@dataclass
class Topology:
    """Graph edges: node -> nodes it bootstraps from (topology/mod.rs)."""

    edges: Dict[str, List[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "Topology":
        topo = cls()
        for lineno, line in enumerate(text.splitlines(), 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = _EDGE.match(line)
            if m is None:
                raise TopologyError(f"line {lineno}: expected 'A -> B', got {line!r}")
            a, b = m.group(1), m.group(2)
            self_edges = topo.edges.setdefault(a, [])
            if b not in self_edges:
                self_edges.append(b)
            topo.edges.setdefault(b, [])
        return topo

    def nodes(self) -> List[str]:
        return sorted(self.edges)

    def responders(self) -> List[str]:
        """Nodes with no outgoing bootstrap edges — started first."""
        return [n for n in self.nodes() if not self.edges[n]]

    def initiators(self) -> List[str]:
        return [n for n in self.nodes() if self.edges[n]]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- in-process cluster ----------------------------------------------------


class DevCluster:
    """All topology nodes as in-process agents over loopback TCP (or an
    in-memory network): the harness for convergence measurements and
    multi-node tests without process overhead."""

    def __init__(
        self,
        topology: Topology,
        schema_sql: str = "",
        network=None,
        swim_config=None,
        device=None,
    ):
        self.topology = topology
        self.schema_sql = schema_sql
        self.network = network
        self.swim_config = swim_config
        self.device = device
        self.agents: Dict[str, object] = {}
        self.started_at: Optional[float] = None
        self._db_paths: List[str] = []

    async def start(self) -> None:
        from corrosion_tpu_torch.agent.run import run, setup
        from corrosion_tpu_torch.runtime.config import Config

        self.started_at = time.monotonic()
        addrs: Dict[str, str] = {}

        async def boot(name: str) -> None:
            from corrosion_tpu_torch.runtime.tmpdb import fresh_db_path

            cfg = Config()
            # file-backed, not :memory: (see runtime/tmpdb.py: the
            # shared-cache in-memory fallback has no real WAL and flakes
            # concurrent read+apply)
            cfg.db.path = fresh_db_path(name)
            self._db_paths.append(cfg.db.path)
            if self.network is not None:
                cfg.gossip.bind_addr = name
            else:
                cfg.gossip.bind_addr = "127.0.0.1:0"
            cfg.gossip.bootstrap = [
                addrs[peer]
                for peer in self.topology.edges[name]
                if peer in addrs
            ]
            agent = await setup(cfg, network=self.network,
                                device=self.device)
            if self.swim_config is not None:
                agent.membership.config = self.swim_config
            if self.schema_sql:
                agent.store.apply_schema_sql(self.schema_sql)
            await run(agent)
            self.agents[name] = agent
            addrs[name] = agent.actor.addr

        # responders first, then initiators (main.rs:163-172)
        for name in self.topology.responders():
            await boot(name)
        for name in self.topology.initiators():
            await boot(name)

    async def stop(self) -> None:
        import glob
        import os

        from corrosion_tpu_torch.agent.run import shutdown

        for agent in self.agents.values():
            await shutdown(agent)
        self.agents.clear()
        for path in self._db_paths:
            # escape: node names feed the path prefix, and a glob
            # metacharacter (e.g. an IPv6 '[::1]' bind addr) must not
            # break cleanup or match another cluster's files
            for f in glob.glob(glob.escape(path) + "*"):
                try:
                    os.unlink(f)  # db + -wal/-shm sidecars
                except OSError:
                    pass
        self._db_paths.clear()

    # -- measurements ------------------------------------------------------

    def membership_counts(self) -> Dict[str, int]:
        return {
            name: agent.membership.cluster_size
            for name, agent in self.agents.items()
        }

    def converged(self) -> bool:
        n = len(self.agents)
        return all(c == n for c in self.membership_counts().values())

    async def wait_converged(self, timeout: float = 60.0) -> float:
        """Seconds from cluster start to full membership convergence —
        the BASELINE 'time-to-stable-membership' metric."""
        assert self.started_at is not None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.converged():
                return time.monotonic() - self.started_at
            await asyncio.sleep(0.02)
        raise TimeoutError(
            f"membership did not converge: {self.membership_counts()}"
        )

    async def measure_broadcast_latency(
        self, writer: str, table: str, rowid: int, value: str,
        timeout: float = 30.0,
    ) -> Dict[str, float]:
        """Write on one node; seconds until each other node sees the row
        via epidemic broadcast (BASELINE propagation-latency row)."""
        from corrosion_tpu_torch.agent.run import make_broadcastable_changes

        agent = self.agents[writer]
        t0 = time.monotonic()
        await make_broadcastable_changes(
            agent,
            lambda tx: [
                tx.execute(
                    f"INSERT OR REPLACE INTO {table} (id, text) VALUES (?, ?)",
                    [rowid, value],
                )
            ],
        )
        latency: Dict[str, float] = {writer: 0.0}
        pending = {n for n in self.agents if n != writer}
        deadline = t0 + timeout
        while pending and time.monotonic() < deadline:
            for name in list(pending):
                conn = self.agents[name].store.read_conn()
                try:
                    row = conn.execute(
                        f"SELECT text FROM {table} WHERE id = ?", (rowid,)
                    ).fetchone()
                finally:
                    conn.close()
                if row is not None and row[0] == value:
                    latency[name] = time.monotonic() - t0
                    pending.discard(name)
            if pending:
                await asyncio.sleep(0.01)
        if pending:
            raise TimeoutError(f"broadcast never reached: {sorted(pending)}")
        return latency


# -- subprocess cluster ----------------------------------------------------


def node_config(node_dir: Path, schema_sql: str, api_port: int,
                gossip_port: int, bootstrap: List[int]) -> Path:
    """Write one node's `schema.sql` and `config.toml` under `node_dir`
    (its database `state.db` and admin socket `admin.sock` there too,
    bootstrapping from the loopback gossip ports `bootstrap`); returns
    the config's path."""
    node_dir.mkdir(parents=True, exist_ok=True)
    schema_path = node_dir / "schema.sql"
    schema_path.write_text(schema_sql)
    boot = ", ".join(f'"127.0.0.1:{p}"' for p in bootstrap)
    cfg = node_dir / "config.toml"
    cfg.write_text(
        f"""
[db]
path = "{node_dir / 'state.db'}"
schema_paths = ["{schema_path}"]

[api]
bind_addr = ["127.0.0.1:{api_port}"]

[gossip]
bind_addr = "127.0.0.1:{gossip_port}"
bootstrap = [{boot}]

[admin]
uds_path = "{node_dir / 'admin.sock'}"
"""
    )
    return cfg


class ProcessCluster:
    """Real `python -m corrosion_tpu_torch agent` subprocesses, like the
    reference spawning built binaries (main.rs run_corrosion)."""

    def __init__(
        self,
        topology: Topology,
        state_dir: str,
        schema_sql: str = "",
        device: Optional[str] = None,
    ):
        self.topology = topology
        self.state_dir = Path(state_dir)
        self.schema_sql = schema_sql
        self.device = device
        self.procs: Dict[str, subprocess.Popen] = {}
        self.api_ports: Dict[str, int] = {}
        self.admin_paths: Dict[str, str] = {}

    def generate_configs(self) -> Dict[str, Path]:
        """Random ports + bootstrap edges per node (main.rs:110-160)."""
        gossip_ports = {n: free_port() for n in self.topology.nodes()}
        configs: Dict[str, Path] = {}
        for name in self.topology.nodes():
            node_dir = self.state_dir / name
            api_port = free_port()
            self.api_ports[name] = api_port
            self.admin_paths[name] = str(node_dir / "admin.sock")
            configs[name] = node_config(
                node_dir, self.schema_sql, api_port, gossip_ports[name],
                [gossip_ports[p] for p in self.topology.edges[name]])
        return configs

    def start(self, env: Optional[dict] = None) -> None:
        configs = self.generate_configs()
        order = self.topology.responders() + self.topology.initiators()
        for name in order:
            log_path = self.state_dir / name / "agent.log"
            dev = ["--device", self.device] if self.device else []
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "corrosion_tpu_torch",
                 "-c", str(configs[name]), *dev, "agent"],
                stdout=open(log_path, "w"),
                stderr=subprocess.STDOUT,
                env=env,
            )

    def wait_up(self, timeout: float = 60.0) -> None:
        """Block until every node's API port accepts AND its admin socket
        answers a ping.

        The admin check is load-bearing: the agent binds the admin socket
        before the API listener, but callers that connect to admin.sock the
        instant the API port opens were racing socket creation on slow
        machines (the r3 flake).  Ready means both surfaces answer.
        """
        deadline = time.monotonic() + timeout
        for name, port in self.api_ports.items():
            while time.monotonic() < deadline:
                try:
                    s = socket.create_connection(("127.0.0.1", port), 0.2)
                    s.close()
                    break
                except OSError:
                    if self.procs[name].poll() is not None:
                        raise RuntimeError(f"node {name} exited early")
                    time.sleep(0.1)
            else:
                raise TimeoutError(f"node {name} api never came up")
        for name, path in self.admin_paths.items():
            while time.monotonic() < deadline:
                if self._admin_ping(path):
                    break
                if self.procs[name].poll() is not None:
                    raise RuntimeError(f"node {name} exited early")
                time.sleep(0.1)
            else:
                raise TimeoutError(f"node {name} admin never answered ping")

    @staticmethod
    def _admin_ping(path: str) -> bool:
        """Synchronous UDS ping using the admin frame protocol
        (4-byte BE length + JSON; admin.py read_frame/write_frame)."""
        import struct

        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(1.0)
            s.connect(path)
            body = b'{"cmd":"ping"}'
            s.sendall(struct.pack(">I", len(body)) + body)
            hdr = s.recv(4)
            ok = len(hdr) == 4
            s.close()
            return ok
        except OSError:
            return False

    def stop(self, timeout: float = 15.0) -> None:
        import signal as _signal

        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(_signal.SIGTERM)
        for p in self.procs.values():
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()


async def run_devcluster_cli(cfg, topology_path: str, schema_sql: str,
                             device: Optional[str] = None) -> int:
    """`corrosion devcluster TOPOLOGY` — spawn and babysit the cluster."""
    import tempfile

    topo = Topology.parse(Path(topology_path).read_text())
    state_dir = tempfile.mkdtemp(prefix="corrosion-devcluster-")
    cluster = ProcessCluster(topo, state_dir, schema_sql, device=device)
    cluster.start()
    try:
        cluster.wait_up()
        print(f"devcluster up: {len(topo.nodes())} nodes, state in {state_dir}")
        for name, port in sorted(cluster.api_ports.items()):
            print(f"  {name}: api 127.0.0.1:{port}"
                  f" admin {cluster.admin_paths[name]}")
        while True:
            await asyncio.sleep(1)
            for name, p in cluster.procs.items():
                if p.poll() is not None:
                    print(f"node {name} exited ({p.returncode}); stopping")
                    return 1
    except KeyboardInterrupt:
        return 0
    finally:
        cluster.stop()
