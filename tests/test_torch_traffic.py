"""The port's chaos harness (`corrosion_tpu_torch/chaos/scenarios.py`,
`chaos/workload.py`, `traffic_sim.py`) and the chaos soak's agent phases
(`chaos_soak.run_soak`, `slo_baseline_phase`) against the JAX package's.

- every injection of the scenario matrix, applied and reverted through
  each package's `ChaosEngine` on a seeded `MemNetwork` and a stand-in
  store: the network's partitions, down and zombie sets and link faults,
  the store's `StoreFaults` (and its seeded draws), the chaos census and
  the driver tasks' calls are equal after apply and after revert;
- `StageStats`, `_slo_percentiles` and `_cluster_digestion` give equal
  reports on the same inputs;
- the port's `traffic_sim` bars, matrix and harness are the script's
  (`scripts/traffic_sim.py`: the functions' syntax trees equal, names
  aside), and its full matrix's ids are the banked `TRAFFIC_SIM.json`'s;
- `run_matrix(tiny=True)` on the port (stores on the CPU) passes
  `_assert_bars`: one scenario here, the whole tiny matrix with its
  armed addendum under `slow` (it takes 35-50 s);
- `run_soak` at one seed under strict invariants, and (`slow`, three
  scenarios of a few seconds each) `slo_baseline_phase` at 3 writes.
"""

from __future__ import annotations

import ast
import asyncio
import json
import random
import sys
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import pytest

import chip_smoke
import corrosion_tpu.chaos.faults as JF
import corrosion_tpu.chaos.scenarios as JS
import corrosion_tpu.chaos.workload as JW
import corrosion_tpu.net.mem as JM
import corrosion_tpu_torch.chaos.faults as TF
import corrosion_tpu_torch.chaos.scenarios as TS
import corrosion_tpu_torch.chaos.workload as TW
import corrosion_tpu_torch.net.mem as TM
from corrosion_tpu_torch import chaos_soak, traffic_sim
from tests.test_torch_planes import planes_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _planes_uninstalled(planes_reset):
    """The agents these tests boot install the process-global planes
    (trace store, TSDB, profiler): uninstalled, threads joined, around
    every test."""
    yield


REPO = Path(__file__).resolve().parent.parent
NAMES = ["n0", "n1", "n2", "n3"]


def _net_state(net) -> dict:
    f = net.faults
    return {
        "partitions": sorted(net._partitions), "down": sorted(net._down),
        "zombies": sorted(net._zombies),
        "faults": {k: (sorted(v.items()) if isinstance(v, dict) else v)
                   for k, v in asdict(f).items()},
    }


def _store_state(store) -> dict:
    c = store.chaos
    if c is None:
        return None
    draws = [c._rng.random() for _ in range(4)]
    return {k: getattr(c, k) for k in (
        "statement_busy_rate", "commit_io_error_rate", "commit_latency_secs",
        "apply_latency_secs", "seed")} | {"draws": draws}


def _census(census) -> dict:
    snap = census.snapshot()
    return {"active": snap["active"], "scenario": snap["scenario"],
            "since_set": snap["since"] is not None,
            "injections": sorted(snap["injections"].values())}


def _injections(S, net, store, calls):
    async def stop(name):
        calls.append(("stop", name))

    async def start(name):
        calls.append(("start", name))

    regions = {n: ("us" if i < 2 else "eu") for i, n in enumerate(NAMES)}
    return {
        "geo-latency": [S.geo_latency(net, regions, {("us", "eu"): 0.08})],
        "asym-partition": [S.asymmetric_partition(net, "n1",
                                                  ["n0", "n2", "n3"])],
        "flap-storm": [S.flap_storm(net, "n0", "n3", 0.02)],
        "churn-storm": [S.churn_storm(["n3"], stop, start, 0.02)],
        "zombie-node": [S.zombie_node(net, "n3")],
        "slow-disk": [S.slow_disk(store, 0.05)],
        "sick-disk": [S.sick_disk(store, busy_rate=0.25, io_error_rate=0.1,
                                  seed=4)],
        "combined": [S.zombie_node(net, "n2"),
                     S.geo_latency(net, regions, {("us", "eu"): 0.04}),
                     S.sick_disk(store, busy_rate=1.0, io_error_rate=0.0)],
    }


async def _apply_revert(S, M, F, sid) -> list:
    net = M.MemNetwork(seed=31)
    store = SimpleNamespace(chaos=None)
    calls = []
    engine = S.ChaosEngine()
    injections = _injections(S, net, store, calls)[sid]
    out = [_net_state(net)]
    await engine.apply(S.Scenario(sid, injections))
    # the drivers (flap, churn) take a few beats of their own
    await asyncio.sleep(0.05)
    out += [engine.active, _net_state(net), _store_state(store),
            _census(F.CENSUS),
            [(i.layer, i.summary) for i in injections]]
    await engine.restore()
    out += [engine.active, _net_state(net), _store_state(store),
            _census(F.CENSUS), calls[:2], len(calls) % 2]
    return out


@pytest.mark.parametrize("sid", ["geo-latency", "asym-partition",
                                 "flap-storm", "churn-storm", "zombie-node",
                                 "slow-disk", "sick-disk", "combined"])
async def test_injections_apply_and_revert_alike(sid):
    j = await _apply_revert(JS, JM, JF, sid)
    t = await _apply_revert(TS, TM, TF, sid)
    if sid in ("flap-storm",):
        # the flap driver's phase at the sampling instant is timing:
        # compare everything but the network state read mid-run
        j[2] = t[2] = None
    assert t == j
    assert t[-5] == t[0]  # reverted: the network as it was
    assert t[-4] is None and not t[-3]["active"]


def test_stage_stats_and_scrape_digests_match():
    rng = random.Random(5)
    seq = [(rng.choice(["ok", "ok", "ok", "refusals", "errors", "timeouts"]),
            rng.uniform(0.001, 2.0)) for _ in range(400)]

    def report(W):
        st = W.StageStats()
        empty = W.StageStats().report()
        for outcome, secs in seq:
            st.record(outcome, secs)
        return st.report(), empty, st.availability

    assert report(TW) == report(JW)
    slo = {"stages": {s: {"cumulative": {"p50": 0.01 * i, "p99": 0.1 * i,
                                         "count": 10 * i}}
                      for i, s in enumerate(("broadcast", "apply", "total"))}}
    cluster = {"coverage": {"known": 4, "fresh": 3},
               "divergence": {"divergent": True, "groups": 2}}
    for arg in (slo, None, {}, {"stages": {"x": {}}}):
        assert TW._slo_percentiles(arg) == JW._slo_percentiles(arg)
    for arg in (cluster, None, {"coverage": {}}):
        assert TW._cluster_digestion(arg) == JW._cluster_digestion(arg)
    assert TW.RENDER_TEMPLATE == JW.RENDER_TEMPLATE


def _functions(path: Path, names) -> dict:
    """`names` (top level or `Class.method`) of a source file, as syntax
    tree dumps with the package names evened out."""
    tree = ast.parse(path.read_text().replace("corrosion_tpu_torch",
                                              "corrosion_tpu"))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return {n: ast.dump(out[n]) for n in names}


def test_traffic_sim_bars_and_matrix_are_the_scripts():
    names = ("_assert_bars", "_stage_timeouts", "TrafficSim.scenario_matrix",
             "TrafficSim.measure_recovery", "TrafficSim.run_scenario",
             "TrafficSim._await_alert_state", "TrafficSim.start_cluster",
             "SimNode.stop", "SimNode.workload_node")
    port = _functions(REPO / "corrosion_tpu_torch" / "traffic_sim.py", names)
    script = _functions(REPO / "scripts" / "traffic_sim.py", names)
    assert port == script


def test_full_matrix_ids_are_the_banked_ones():
    banked = json.loads((REPO / "TRAFFIC_SIM.json").read_text())
    assert chip_smoke.TRAFFIC_SCENARIOS == tuple(
        s["scenario"] for s in banked["scenarios"])
    assert banked["nodes"] == 4 and banked["duration_per_scenario_secs"] == 6


def test_tier1_one_scenario_serves_under_faults():
    """The port's tiny matrix, its sick-disk scenario alone: every bar of
    `_assert_bars` (asserted inside `run_matrix`), with the store-faults
    page alert raised drill-marked and its profile attached."""
    record = asyncio.run(traffic_sim.run_matrix(tiny=True, device="cpu",
                                                only=("sick-disk",)))
    (rec,) = record["scenarios"]
    assert rec["scenario"] == "sick-disk"
    assert rec["stages"]["write"]["refusals"] > 0
    assert rec["alerts"]["raised"] and rec["alerts"]["drill"] == "sick-disk"
    assert record["nodes"] == 3 and record["mode"] == "tier1"


@pytest.mark.slow
def test_tier1_replica_serves_under_faults():
    """The whole tiny matrix on the port, with the armed zombie-node
    addendum (`tests/test_traffic_sim.py`'s replica)."""
    record = asyncio.run(traffic_sim.run_matrix(tiny=True, device="cpu"))
    assert [s["scenario"] for s in record["scenarios"]] == [
        "baseline", "zombie-node", "slow-disk", "sick-disk",
        "zombie-node-remediated"]
    assert record["scenarios"][-1]["remediation"]["armed"] is True


def test_run_soak_strict(monkeypatch):
    monkeypatch.setenv("CORRO_INVARIANTS", "strict")
    summary = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(chaos_soak.run_soak(1337, device="cpu"), 600))
    assert [p["phase"] for p in summary["phases"]] == [
        "concurrent-writers", "partition-heal", "agent-restart",
        "crash-detection", "post-chaos-write", "cold-join-catchup"]
    assert set(summary["sometimes"]) >= chaos_soak.EXPECTED_SOMETIMES


@pytest.mark.slow
def test_slo_baseline_phase_small():
    out = chaos_soak.slo_baseline_phase(writes=3, device="cpu")
    assert sorted(out["scenarios"]) == ["churn", "degraded", "quiet"]
    for rec in out["scenarios"].values():
        assert all(rec["stages"][s]["count"] > 0
                   for s in ("broadcast", "apply", "match", "deliver",
                             "total"))


def test_soak_is_the_tests_and_slo_the_scripts():
    """`chaos_soak.run_soak` is `tests/test_chaos_soak.py::run_soak` and
    `slo_baseline_phase` the script's, apart from the device they hand
    to `setup`/`DevCluster` and the package names."""
    def norm(path, name):
        tree = ast.parse(path.read_text().replace("corrosion_tpu_torch",
                                                  "corrosion_tpu"))
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.name == name)
        calls = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                calls.append(getattr(f, "attr", getattr(f, "id", "")))
        # the test's module-local aliases of `shutdown`
        alias = {"_sd": "shutdown", "_shutdown": "shutdown"}
        return sorted(alias.get(c, c) for c in calls if c)

    port = REPO / "corrosion_tpu_torch" / "chaos_soak.py"
    assert norm(port, "run_soak") == norm(
        REPO / "tests" / "test_chaos_soak.py", "run_soak")
    assert norm(port, "slo_baseline_phase") == norm(
        REPO / "scripts" / "chaos_soak.py", "slo_baseline_phase")
    assert "tests" not in sys.modules.get(
        "corrosion_tpu_torch.chaos_soak").__dict__
