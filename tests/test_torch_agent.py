"""The port's agent against the JAX package's agent on the CPU.

The reference's agent scenarios (`tests/test_agent.py`) run in both
packages through the same code (`corrosion_tpu_torch/agent_checks.py`),
the port's stores deciding remote batches with the array engine's
decision program on the CPU: their converged parts must be equal to each
other and to the rows written. Then a mixed cluster: a port agent and a
JAX agent on one JAX `MemNetwork` replicate each other's writes by
broadcast and by a late joiner's delta sync, and a JAX agent that asks
a port agent with the catch-up plane off for a snapshot falls back to
delta. Database files are opened both ways; `setup` refuses an unknown
transport, binds loopback sockets when no network is given, and takes
the card when no device is named (the runtime planes' own boots are in
`tests/test_torch_planes.py`).

Every wait is capped and every agent is shut down in a `finally`.

    JAX_PLATFORMS=cpu python -m tests.test_torch_agent --ref

prints `chip_smoke.AGENT_REF`, `SYNC_REF` and `INGEST_LOCAL_REF`, the
JAX package's agents on the CPU (about a minute).
"""

import asyncio
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import ingest_bench, sync_bench
from corrosion_tpu_torch.agent import run as trun

def jax_api() -> SimpleNamespace:
    """The JAX package's agent, in the namespace `agent_checks` drives."""
    from corrosion_tpu.agent import run as jrun
    from corrosion_tpu.agent.membership import SwimConfig
    from corrosion_tpu.agent.syncer import parallel_sync
    from corrosion_tpu.net.mem import MemNetwork
    from corrosion_tpu.runtime.config import Config
    from corrosion_tpu.runtime.metrics import METRICS
    from corrosion_tpu.sync import held_total

    return SimpleNamespace(
        name="jax", setup=jrun.setup, run=jrun.run, shutdown=jrun.shutdown,
        make_broadcastable_changes=jrun.make_broadcastable_changes,
        parallel_sync=parallel_sync, MemNetwork=MemNetwork, Config=Config,
        SwimConfig=SwimConfig, held_total=held_total, METRICS=METRICS,
    )


def _dropped(api):
    return lambda: api.METRICS.counter("corro.agent.changes.dropped").value


def _run(api, engine, coro_fn, *args):
    with cb.engine_env(engine):
        return asyncio.run(asyncio.wait_for(coro_fn(api, *args), 120.0))


def _both(tmp_path, coro_fn, *extra):
    """The scenario in the JAX package (python engine) and in the port
    (array engine, decision program on the CPU)."""
    out = []
    for name, api, engine in (("jax", jax_api(), "python"),
                              ("port", ac.port_api("cpu"), "array")):
        d = tmp_path / name
        d.mkdir()
        args = [e(api) if callable(e) else e for e in extra]
        out.append(_run(api, engine, coro_fn, str(d), *args))
    return out


def test_insert_rows_and_gossip(tmp_path):
    j, t = _both(tmp_path, ac.scenario_gossip)
    assert j == t
    assert t["replicated"] == [True, True] and t["booked"] == [True, True]
    assert t["rows"][0] == [(1, "hello"), (2, "world")]


def test_lww_conflict_converges(tmp_path):
    j, t = _both(tmp_path, ac.scenario_lww)
    assert j["converged"] and t["converged"]
    assert t["value"] in ([(7, "from-a")], [(7, "from-b")])


def test_late_joiner_catches_up_via_sync(tmp_path):
    j, t = _both(tmp_path, ac.scenario_late_joiner)
    assert j == t and t["caught_up"] and t["booked"] and t["last"] == 20


def test_direct_parallel_sync_roundtrip(tmp_path):
    j, t = _both(tmp_path, ac.scenario_parallel_sync)
    assert j["received"] > 0 and t["received"] > 0
    assert (j["applied"], j["rows"]) == (t["applied"], t["rows"])
    assert t["applied"] and len(t["rows"]) == 5


def test_large_tx_multichunk_broadcast_replicates(tmp_path):
    j, t = _both(tmp_path, ac.scenario_large_tx)
    assert j == t and t["replicated"]


def test_loadshed_then_sync_repairs(tmp_path):
    j, t = _both(tmp_path, ac.scenario_loadshed, _dropped)
    assert j == t
    assert t["shed"] and t["repaired"] and t["booked"]


def test_stress_random_topology_concurrent_writers(tmp_path):
    j, t = _both(tmp_path, ac.cluster_run)
    assert ac.cluster_checks(j) == [] and ac.cluster_checks(t) == []
    assert j["disjoint_digest"] == t["disjoint_digest"]
    assert j["versions_per_writer"] == t["versions_per_writer"] == 8
    assert t["array_lane"]["decided"] > 0 and j["array_lane"] is None


# -- one mixed cluster --------------------------------------------------------


def test_mixed_cluster_replicates_both_ways(tmp_path):
    """A JAX agent and a port agent on one JAX `MemNetwork` (the port's
    `setup` uses it by duck typing): each one's writes reach the other by
    broadcast, and late joiners of both packages catch up by delta sync
    from a cluster holding both packages' versions."""
    japi, tapi = jax_api(), ac.port_api("cpu")
    d = str(tmp_path)

    async def main():
        net = japi.MemNetwork(seed=41)
        agents = []
        try:
            a = await ac.boot(japi, net, "jax-a", d)
            agents.append(a)
            b = await ac.boot(tapi, net, "port-b", d, ["jax-a"])
            agents.append(b)
            await ac._sizes([a, b], 2, 10.0)
            await ac.insert_many(japi, a, [(1, "from-jax")])
            await ac.insert_many(tapi, b, [(2, "from-port")])
            assert await ac.wait_until(
                lambda: ac.count_rows(a) == 2 and ac.count_rows(b) == 2)
            for i in range(10, 30):
                await ac.insert_many(japi if i % 2 else tapi,
                                     a if i % 2 else b, [(i, f"r{i}")])
            want = [(1, "from-jax"), (2, "from-port")] + [
                (i, f"r{i}") for i in range(10, 30)]
            assert await ac.wait_until(
                lambda: ac.rows(a) == want and ac.rows(b) == want)
            c = await ac.boot(tapi, net, "port-c", d, ["jax-a"])
            agents.append(c)
            e = await ac.boot(japi, net, "jax-e", d, ["port-b"])
            agents.append(e)
            assert await ac.wait_until(
                lambda: ac.rows(c) == want and ac.rows(e) == want
                and all(ac.booked_contains(ag, w.actor_id, 1, 11)
                        for ag in (c, e) for w in (a, b)),
                timeout=20.0), (ac.count_rows(c), ac.count_rows(e))
            return [ag.membership.cluster_size for ag in agents]
        finally:
            for x in agents[::-1]:
                port = type(x).__module__.startswith("corrosion_tpu_torch.")
                await (tapi if port else japi).shutdown(x)

    with cb.engine_env("python"):
        sizes = asyncio.run(asyncio.wait_for(main(), 120.0))
    assert sizes == [4, 4, 4, 4]


def test_jax_snapshot_request_to_the_port_falls_back_to_delta(tmp_path):
    """A cold JAX agent with the catch-up plane on asks the port agent
    (its only peer, `sync.snapshot` off) for a snapshot: the port
    rejects it as disabled, the JAX agent counts the rejection and
    catches up by delta sync."""
    from corrosion_tpu.runtime.metrics import METRICS as JM
    from corrosion_tpu_torch.runtime.metrics import METRICS as TM

    japi, tapi = jax_api(), ac.port_api("cpu")
    d = str(tmp_path)

    def snapshot_on(cfg):
        cfg.sync.snapshot = True
        cfg.sync.snapshot_min_gap_versions = 1

    def snapshot_off(cfg):
        cfg.sync.snapshot = False

    def rejected(reg, name):
        return reg.counter(name, reason="disabled").value

    async def main():
        net = japi.MemNetwork(seed=43)
        agents = []
        try:
            p = await ac.boot(tapi, net, "port-p", d, tune=snapshot_off)
            agents.append(p)
            for i in range(30):
                await ac.insert_many(tapi, p, [(i, f"v{i}")])
            served0 = rejected(TM, "corro.snapshot.serve.rejected.total")
            asked0 = rejected(JM, "corro.snapshot.bootstrap.rejected.total")
            q = await ac.boot(japi, net, "jax-q", d, ["port-p"],
                              tune=snapshot_on)
            agents.append(q)
            ok = await ac.wait_until(lambda: ac.count_rows(q) == 30,
                                     timeout=30.0)
            return (ok, rejected(TM, "corro.snapshot.serve.rejected.total")
                    - served0,
                    rejected(JM, "corro.snapshot.bootstrap.rejected.total")
                    - asked0, dict(q.catchup_census),
                    ac.rows(q) == ac.rows(p))
        finally:
            if len(agents) > 1:
                await japi.shutdown(agents[1])
            await tapi.shutdown(agents[0])

    with cb.engine_env("python"):
        ok, served, asked, census, same = asyncio.run(
            asyncio.wait_for(main(), 120.0))
    assert ok and same
    # the port counts a rejection as it sends it, the JAX agent as it
    # reads it: one may still be in flight when the rows are there
    assert served >= asked >= 1, census
    assert census.get("state") != "installed", census


# -- state carried across ---------------------------------------------------


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_database_files_open_both_ways(tmp_path, first, second):
    """An agent of one package shut down, then one of the other package
    started on its database: same site id and actor, the bookie restored
    from the booked versions, the persisted members resurrected."""
    apis = {"jax": jax_api(), "port": ac.port_api("cpu")}
    d = str(tmp_path)

    async def first_run():
        api = apis[first]
        net = api.MemNetwork(seed=47)
        agents = []
        try:
            agents.append(await ac.boot(api, net, "keep-a", d))
            agents.append(await ac.boot(api, net, "keep-b", d, ["keep-a"]))
            a, b = agents
            await ac._sizes(agents, 2, 10.0)
            for i in range(3):
                await ac.insert(api, a, i, f"a{i}")
            await ac.insert(api, b, 10, "b")
            assert await ac.wait_until(lambda: ac.count_rows(b) == 4)
            return (b.actor_id.bytes16, a.actor_id.bytes16,
                    _bookie(b), ac.rows(b))
        finally:
            # b first: a's LEAVE would take a out of b's persisted view
            await ac.shutdown_all(api, agents[::-1])

    async def second_run():
        api = apis[second]
        net = api.MemNetwork(seed=53)
        cfg = ac.fast_config(api, "keep-b", d)
        agent = await api.setup(cfg, network=net)
        try:
            agent.membership.config = api.SwimConfig(**ac.FAST_SWIM)
            restored = (agent.actor_id.bytes16, _bookie(agent),
                        ac.rows(agent))
            seen = []

            def resurrected():
                if agent.membership.cluster_size == 2:
                    seen.extend(m.id.bytes16 for m in
                                agent.membership.active_members())
                    return True
                return False

            await api.run(agent)
            ok = await ac.wait_until(resurrected, timeout=5.0, step=0.002)
            return restored, ok, sorted(seen)
        finally:
            await api.shutdown(agent)

    with cb.engine_env("python"):
        b_id, a_id, bookie, rows = asyncio.run(
            asyncio.wait_for(first_run(), 60.0))
        (sid, bookie2, rows2), resurrected, members = asyncio.run(
            asyncio.wait_for(second_run(), 60.0))
    assert sid == b_id and bookie2 == bookie and rows2 == rows
    assert resurrected and members == [a_id]


def _bookie(agent):
    out = []
    for aid, booked in sorted(agent.bookie.items().items(),
                              key=lambda kv: kv[0].bytes16):
        with booked.read() as bv:
            out.append((aid.bytes16, bv.last(), list(bv.needed),
                        sorted(bv.partials)))
    return out


# -- refusals and the default device --------------------------------------------


def test_setup_refuses_a_missing_network(tmp_path):
    """No `network`: the agent binds loopback sockets of the configured
    transport (never the in-memory network), and an unknown transport is
    refused."""
    api = ac.port_api("cpu")

    async def boot_and_stop(cfg):
        agent = await trun.setup(cfg, device="cpu")
        try:
            return type(agent.transport).__name__, agent.listener.addr
        finally:
            await trun.shutdown(agent)

    for transport, kind in (("tcp", "TcpTransport"),
                            ("quic", "QuicTransport")):
        cfg = ac.fast_config(api, "127.0.0.1:0", str(tmp_path),
                             transport=transport)
        cfg.db.path = str(tmp_path / f"{transport}.db")
        name, addr = asyncio.run(asyncio.wait_for(boot_and_stop(cfg), 60))
        assert name == kind and addr.startswith("127.0.0.1:")
        assert not addr.endswith(":0")
    cfg = ac.fast_config(api, "127.0.0.1:0", str(tmp_path))
    cfg.gossip.transport = "carrier-pigeon"
    with pytest.raises(ValueError, match="unknown gossip.transport"):
        asyncio.run(trun.setup(cfg, device="cpu"))


def test_agent_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    api = ac.port_api()
    net = api.MemNetwork(seed=1)
    cfg = ac.fast_config(api, "card", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(trun.setup(cfg, network=net))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(sync_bench.run_rung(2000, False, "delta", 17))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(sync_bench.chaos_phase(29, rows=(10, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(ingest_bench.local_write(1))
    assert not os.path.exists(cfg.db.path)


def test_sync_rung_and_local_write_rung_equal_the_reference(tmp_path):
    """`sync_bench.run_rung` and `ingest_bench.local_write` at a small
    size in both packages: the bar met, equal rows and clock rows."""
    recs = []
    for api, engine in ((jax_api(), "python"),
                        (ac.port_api("cpu"), "array")):
        with cb.engine_env(engine):
            rec = asyncio.run(sync_bench.run_rung(4000, False, "delta", 17,
                                                  api=api))
            loc = asyncio.run(ingest_bench.local_write(4, api=api))
        recs.append((rec, loc))
    (j, jl), (t, tl) = recs
    for k in ("rows_final", "clock_rows_final", "held_total",
              "origin_held_total", "rows_digest", "versions"):
        assert j[k] == t[k], k
    assert (t["rows_final"], t["clock_rows_final"], t["held_total"]) == (
        4000, 8000, 2)
    assert t["array_lane"]["decided"] > 0 and j["array_lane"] is None
    for r in (j, t):
        assert r["changes_in_by_source"]["sync"] == r[
            "delta_changes_received"]
        assert r["rows_per_s"] > 0
    assert jl["digest"] == tl["digest"] and tl["rows"] == 5760


@pytest.mark.slow
def test_sync_100k_quiet_delta_equals_the_reference():
    """The chip's `agent_sync_100k` rung at full size, port (array
    engine on the CPU) against the JAX package."""
    from chip_smoke import SYNC_REF

    for api, engine in ((jax_api(), "python"),
                        (ac.port_api("cpu"), "array")):
        with cb.engine_env(engine):
            rec = asyncio.run(sync_bench.run_rung(100_000, False, "delta",
                                                  17, api=api))
        assert {k: rec[k] for k in SYNC_REF} == SYNC_REF, api.name


# -- the references of chip_smoke.py ----------------------------------------------


def jax_refs() -> dict:
    import tempfile

    api = jax_api()
    with cb.engine_env("python"):
        with tempfile.TemporaryDirectory() as d:
            rec = asyncio.run(ac.cluster_run(api, d, **ac.CHIP_CLUSTER,
                                             timeout=600.0))
        assert ac.cluster_checks(rec) == []
        agent_ref = {"disjoint_digest": rec["disjoint_digest"][0],
                     "versions_per_writer": rec["versions_per_writer"],
                     "rows_total": rec["rows_total"],
                     "held_total": rec["held_total"][0]}
        s = asyncio.run(sync_bench.run_rung(100_000, False, "delta", 17,
                                            api=api))
        sync_ref = {k: s[k] for k in ("rows_final", "clock_rows_final",
                                      "held_total", "rows_digest")}
        local = {r["rung"]: r["digest"]
                 for r in ingest_bench.run_local(api=api)}
    return {"AGENT_REF": agent_ref, "SYNC_REF": sync_ref,
            "INGEST_LOCAL_REF": local}


if __name__ == "__main__":
    if "--ref" in sys.argv:
        for name, ref in jax_refs().items():
            print(f"{name} = {ref!r}", flush=True)
