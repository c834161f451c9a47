"""The port's devcluster (`corrosion_tpu_torch/devcluster.py`), its
scratch databases (`runtime/tmpdb.py`) and the scale ladder's rung 0
against the JAX package's.

- `Topology.parse`: equal graphs, node orders and errors on the same
  texts;
- `ProcessCluster`: the same config files (ports drawn from one seeded
  sequence in both) and the same agent command lines apart from the
  module name and the port's `--device`;
- an in-process 3-node `DevCluster` over each package's `MemNetwork`
  (the port's stores on the CPU): equal membership counts and the same
  row on every node after one broadcast;
- `scale_ladder.rung0` on the port (default SWIM, the 5 s healthy
  soak): the script's record with FP 0;
- `fresh_db_path`: the same file names apart from the random part.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path

import pytest

import corrosion_tpu.devcluster as JD
import corrosion_tpu.runtime.tmpdb as JTmp
import corrosion_tpu_torch.devcluster as TD
import corrosion_tpu_torch.runtime.tmpdb as TTmp
from corrosion_tpu.agent.membership import SwimConfig as JSwim
from corrosion_tpu.net.mem import MemNetwork as JMem
from corrosion_tpu_torch import scale_ladder
from corrosion_tpu_torch.agent.membership import SwimConfig as TSwim
from corrosion_tpu_torch.net.mem import MemNetwork as TMem
from tests.test_torch_planes import planes_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _planes_uninstalled(planes_reset):
    """The agents these tests boot install the process-global planes
    (trace store, TSDB, profiler): uninstalled, threads joined, around
    every test."""
    yield


TEST_SCHEMA = "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
TOPOLOGIES = [
    "# a comment\nA -> B\nB -> C\nA -> C\n",
    "A -> B\nA -> B\n",
    "A -> C\nB -> C\n",
    "  x1 -> y_2  # trailing\n\n",
    "A => B",
    "A ->",
    "A -> B\n1 -> C",
]


def _parse(mod, text):
    try:
        t = mod.Topology.parse(text)
    except mod.TopologyError as e:
        return ("error", str(e))
    return (t.edges, t.nodes(), t.responders(), t.initiators())


@pytest.mark.parametrize("text", TOPOLOGIES)
def test_topology_parse_matches(text):
    assert _parse(TD, text) == _parse(JD, text)


def _process_cluster(mod, tmp: Path, monkeypatch, **kw):
    """Configs and command lines of a `ProcessCluster` whose ports come
    from one fixed sequence and whose processes are only recorded."""
    ports = iter(range(20_000, 20_100))
    monkeypatch.setattr(mod, "free_port", lambda: next(ports))
    argv = []

    class Rec:
        def __init__(self, args, **_):
            argv.append([a.replace(str(tmp), "<d>") for a in args])

    monkeypatch.setattr(mod.subprocess, "Popen", Rec)
    cluster = mod.ProcessCluster(mod.Topology.parse("A -> C\nB -> C\n"),
                                 str(tmp), TEST_SCHEMA, **kw)
    cluster.start()
    texts = {n: (tmp / n / "config.toml").read_text().replace(str(tmp), "<d>")
             for n in "ABC"}
    return texts, argv, cluster.api_ports, cluster.admin_paths


@pytest.mark.parametrize("device", [None, "cpu"])
def test_process_cluster_configs_and_commands_match(tmp_path, monkeypatch,
                                                    device):
    j = _process_cluster(JD, tmp_path / "j", monkeypatch)
    t = _process_cluster(TD, tmp_path / "t", monkeypatch, device=device)
    assert t[0] == j[0]
    assert t[2] == j[2]
    flags = ["--device", device] if device else []
    for ja, ta in zip(j[1], t[1]):
        assert ja[:3] == [ja[0], "-m", "corrosion_tpu"]
        assert ta == ja[:2] + ["corrosion_tpu_torch"] + ja[3:5] + flags + [
            "agent"]
    assert [Path(p).name for p in t[3].values()] == ["admin.sock"] * 3


async def _in_process(topo_mod, mem, swim, **kw) -> dict:
    cluster = topo_mod.DevCluster(
        topo_mod.Topology.parse("A -> C\nB -> C\n"), TEST_SCHEMA,
        network=mem(), swim_config=swim(probe_period=0.05, probe_rtt=0.02,
                                        suspicion_mult=1.0), **kw)
    await cluster.start()
    try:
        t = await cluster.wait_converged(timeout=20.0)
        counts = cluster.membership_counts()
        lat = await cluster.measure_broadcast_latency(
            "A", "tests", 1, "hello", timeout=20.0)
        rows = {}
        for name, agent in cluster.agents.items():
            conn = agent.store.read_conn()
            try:
                rows[name] = [tuple(r) for r in conn.execute(
                    "SELECT id, text FROM tests")]
            finally:
                conn.close()
    finally:
        await cluster.stop()
    assert t < 20.0 and all(v < 20.0 for v in lat.values())
    return {"counts": counts, "landed": sorted(lat), "rows": rows}


async def test_in_process_cluster_matches():
    j = await _in_process(JD, JMem, JSwim)
    t = await _in_process(TD, TMem, TSwim, device="cpu")
    assert t == j
    assert t["counts"] == {"A": 3, "B": 3, "C": 3}
    assert t["rows"]["B"] == [(1, "hello")]


def test_rung0_is_the_scripts_record():
    (rec,) = scale_ladder.rung0(device="cpu")
    assert set(rec) == {"rung", "name", "convergence_s",
                        "broadcast_latency_s", "false_positive", "platform"}
    assert (rec["rung"], rec["name"], rec["platform"]) == (
        0, "devcluster_3node_default_swim", "host-asyncio")
    assert rec["false_positive"] == 0.0
    assert 0 < rec["convergence_s"] < 60 and rec["broadcast_latency_s"] < 60


@pytest.mark.parametrize("prefix", ["agent", "[::1]:8080", "", "a/b*c"])
def test_fresh_db_path_matches(prefix):
    j, t = JTmp.fresh_db_path(prefix), TTmp.fresh_db_path(prefix)
    strip = re.compile(r"-[0-9a-f]{32}\.db$")
    assert strip.sub("", os.path.basename(t)) == strip.sub(
        "", os.path.basename(j))
    assert os.path.isdir(os.path.dirname(t))
    assert os.path.basename(os.path.dirname(t)).startswith("corro-dbs-")
    assert strip.search(t)


def test_process_cluster_spawns_the_port(tmp_path):
    """`ProcessCluster.start` runs `python -m corrosion_tpu_torch`, whose
    agent names its device: a real process with `--device cpu` comes up
    and answers on its admin socket."""
    cluster = TD.ProcessCluster(TD.Topology.parse("A -> B\n"), str(tmp_path),
                                TEST_SCHEMA, device="cpu")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    cluster.start(env=env)
    try:
        cluster.wait_up(timeout=60.0)
        assert all(TD.ProcessCluster._admin_ping(p)
                   for p in cluster.admin_paths.values())
    finally:
        procs = list(cluster.procs.values())
        cluster.stop()
    assert all(p.returncode is not None for p in procs)
    assert subprocess is TD.subprocess
