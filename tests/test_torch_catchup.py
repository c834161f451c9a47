"""The port's catch-up plane and observatory in its agents, against the
JAX package's agents, on the CPU.

The scenarios of `tests/test_sync_resume.py` (a cold node's snapshot
bootstrap, the schema refusal over the wire, a stale snapshot's delta
top-up against pure delta) run through one body on each package's agents
(`agent_checks` api; the port's stores decide remote batches with the
array engine's decision program on the CPU), and what each saw must
match: installs, serves, rows and clock rows. Then mixed clusters: a
port cold node bootstraps from a JAX origin's snapshot and a JAX cold
node from a port origin's. `sync_bench`'s snapshot rung and
`chaos_phase` run at a small size in both packages with equal outcomes.

Every wait is capped and every agent is shut down in a `finally`.

    JAX_PLATFORMS=cpu python -m tests.test_torch_catchup --ref

prints `chip_smoke.CHAOS_REF` (the JAX package's chaos loop at the
script's sizes) and checks that the JAX package's 100k snapshot rung at
the script's seed ends at `chip_smoke.SYNC_REF` (a few minutes).
"""

from __future__ import annotations

import asyncio
import os
import sys

import pytest

from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import sync_bench as sb
from corrosion_tpu_torch.agent import run as trun
from tests.test_torch_agent import jax_api

CLOCK_SQL = ("SELECT pk, cid, col_version, db_version, seq, site_id"
             " FROM tests__crdt_clock ORDER BY pk, cid, db_version, seq")


def catchup_of(api):
    if api.name == "jax":
        from corrosion_tpu.agent import catchup
    else:
        from corrosion_tpu_torch.agent import catchup
    return catchup


def clock_rows(agent) -> list:
    return ac.query(agent, CLOCK_SQL)


async def load_versions(api, agent, n, rows_per=2, base=0) -> None:
    """`tests/test_sync_resume.py::load_versions`: n versions of
    `rows_per` rows each."""
    for v in range(base, base + n):
        await ac.insert_many(api, agent, [
            (v * rows_per + k, f"r{v}-{k}") for k in range(rows_per)])


async def drained(api, agent) -> bool:
    """Wait for the broadcast backlog to drain (the settle nap first:
    fresh changes take a loop interval to reach the pending heap); a
    surviving backlog floods a cold joiner with every version, and the
    snapshot path never runs."""
    await asyncio.sleep(0.3)
    return await ac.wait_until(
        lambda: sb.peek(api, "corro.broadcast.pending.count") == 0,
        timeout=30.0)


def _run(api, engine, coro_fn, *args, cap=90.0):
    with cb.engine_env(engine):
        return asyncio.run(asyncio.wait_for(coro_fn(api, *args), cap))


def _both(tmp_path, coro_fn, *extra):
    out = []
    for name, api, engine in (("jax", jax_api(), "python"),
                              ("port", ac.port_api("cpu"), "array")):
        d = tmp_path / name
        d.mkdir()
        out.append(_run(api, engine, coro_fn, str(d), *extra))
    return out


# -- the reference's agent scenarios ------------------------------------------------


async def scenario_cold_bootstrap(api, db_dir: str) -> dict:
    """`test_cold_node_snapshot_bootstrap_converges`: a cold node whose
    gap passes the heuristic installs the origin's snapshot and tops up
    by delta."""
    net = api.MemNetwork(seed=7)
    agents = []
    try:
        a = await ac.boot(api, net, "agent-a", db_dir)
        agents.append(a)
        await load_versions(api, a, 30, rows_per=3)
        quiet = await drained(api, a)
        installs0 = sb.peek(api, "corro.snapshot.install.total")
        serves0 = sb.peek(api, "corro.snapshot.serve.total")

        def tune(cfg):
            cfg.sync.snapshot_min_gap_versions = 10

        c = await ac.boot(api, net, "agent-c", db_dir, ("agent-a",),
                          tune=tune)
        agents.append(c)
        installed = await ac.wait_until(
            lambda: sb.peek(api, "corro.snapshot.install.total")
            == installs0 + 1, timeout=60.0)
        rows = await ac.wait_until(lambda: ac.count_rows(c) == 90,
                                   timeout=60.0)
        clocks = await ac.wait_until(
            lambda: clock_rows(c) == clock_rows(a), timeout=10.0)
        return {
            "quiet": quiet, "installed": installed, "rows": rows,
            "clocks": clocks,
            "installs": sb.peek(api, "corro.snapshot.install.total")
            - installs0,
            "serves": sb.peek(api, "corro.snapshot.serve.total") - serves0,
            "state": c.catchup_census.get("state"),
            "watermark_ok": c.catchup_census.get("watermark_versions", 0)
            >= 30,
            "site_is_actor": c.store.site_id == c.actor_id,
            "rows_digest": ac.digest(ac.rows(c)),
            "held": api.held_total(c.bookie) == api.held_total(a.bookie),
            "lane": ac.array_lane([c]),
        }
    finally:
        await ac.shutdown_all(api, agents[::-1])


async def scenario_schema_refusal(api, db_dir: str) -> dict:
    """`test_snapshot_schema_mismatch_refused_over_wire`: the serving
    side rejects a node of another schema; no swap, and the refused
    node still writes."""
    net = api.MemNetwork(seed=11)
    agents = []
    try:
        a = await ac.boot(api, net, "agent-a", db_dir)
        agents.append(a)
        await load_versions(api, a, 20)
        cfg = ac.fast_config(api, "agent-x", db_dir)
        cfg.sync.snapshot_min_gap_versions = 5
        x = await api.setup(cfg, network=net)
        agents.append(x)
        x.store.apply_schema_sql(
            "CREATE TABLE other (id INTEGER NOT NULL PRIMARY KEY, v TEXT);")
        rejected0 = sb.peek(api, "corro.snapshot.serve.rejected.total",
                            reason="schema")
        installs0 = sb.peek(api, "corro.snapshot.install.total")
        ok = await catchup_of(api).maybe_snapshot_bootstrap(x, [a.actor])
        with x.store.write_tx(x.clock.new_timestamp()) as tx:
            tx.execute("INSERT INTO other (id, v) VALUES (1, 'alive')")
        return {
            "bootstrapped": ok,
            "rejected": sb.peek(api, "corro.snapshot.serve.rejected.total",
                                reason="schema") - rejected0,
            "installs": sb.peek(api, "corro.snapshot.install.total")
            - installs0,
            "state": x.catchup_census.get("state"),
            "other": ac.query(x, "SELECT * FROM other"),
        }
    finally:
        await ac.shutdown_all(api, agents[::-1])


async def scenario_stale_topup(api, db_dir: str) -> dict:
    """`test_stale_snapshot_topup_matches_pure_delta`: a snapshot frozen
    at version 10 of 20, topped up by delta, lands where pure delta and
    the origin are."""
    net = api.MemNetwork(seed=13)
    agents = []
    try:
        a = await ac.boot(api, net, "agent-a", db_dir)
        agents.append(a)
        await load_versions(api, a, 10)
        cache = catchup_of(api).ensure_snapshot_cache(a)
        cache.ensure_fresh(a.store.schema, a.store.site_id.bytes16,
                           a.bookie, 3600.0)
        frozen = cache.header.watermark_total()
        a.config.sync.snapshot_max_age_secs = 3600.0  # keep it stale
        await load_versions(api, a, 10, base=10)
        await asyncio.sleep(0.7)  # let the broadcast backlog expire

        def snap_tune(cfg):
            cfg.sync.snapshot_min_gap_versions = 5

        def delta_tune(cfg):
            cfg.sync.snapshot = False

        c = await ac.boot(api, net, "agent-c", db_dir, ("agent-a",),
                          tune=snap_tune)
        agents.append(c)
        d = await ac.boot(api, net, "agent-d", db_dir, ("agent-a",),
                          tune=delta_tune)
        agents.append(d)
        # the install first: the top-up can land the last rows while the
        # swap is still in flight
        await ac.wait_until(
            lambda: c.catchup_census.get("state") == "installed",
            timeout=60.0)
        rows = await ac.wait_until(
            lambda: ac.count_rows(c) == 40 and ac.count_rows(d) == 40,
            timeout=60.0)
        clocks = await ac.wait_until(
            lambda: clock_rows(c) == clock_rows(a) == clock_rows(d),
            timeout=10.0)
        return {
            "frozen": frozen, "rows": rows, "clocks": clocks,
            "state": c.catchup_census.get("state"),
            "watermark": c.catchup_census.get("watermark_versions"),
            "delta_state": d.catchup_census.get("state"),
            "same_rows": ac.rows(c) == ac.rows(d) == ac.rows(a),
            "rows_digest": ac.digest(ac.rows(c)),
        }
    finally:
        await ac.shutdown_all(api, agents[::-1])


def test_cold_node_snapshot_bootstrap(tmp_path):
    j, t = _both(tmp_path, scenario_cold_bootstrap)
    lane = t.pop("lane")
    assert j.pop("lane") is None and lane["declined"] == 0
    assert j == t
    assert t["quiet"] and t["installed"] and t["rows"] and t["clocks"]
    assert (t["installs"], t["serves"], t["state"]) == (1, 1, "installed")
    assert t["watermark_ok"] and t["site_is_actor"] and t["held"]


def test_schema_mismatch_refused_over_the_wire(tmp_path):
    j, t = _both(tmp_path, scenario_schema_refusal)
    assert j == t
    assert (t["bootstrapped"], t["rejected"], t["installs"]) == (False, 1, 0)
    assert t["state"] == "failed" and t["other"] == [(1, "alive")]


def test_stale_snapshot_topup_equals_pure_delta(tmp_path):
    j, t = _both(tmp_path, scenario_stale_topup)
    assert j == t
    assert t["frozen"] == 10 and t["watermark"] == 10
    assert t["rows"] and t["clocks"] and t["same_rows"]
    assert t["state"] == "installed" and t["delta_state"] is None


# -- mixed clusters --------------------------------------------------------------------


@pytest.mark.parametrize("origin,cold", [("jax", "port"), ("port", "jax")])
def test_mixed_cluster_snapshot_bootstrap(tmp_path, origin, cold):
    """A cold node of one package installs the snapshot that an origin of
    the other package serves, on one JAX `MemNetwork`, and tops up to
    the origin's rows, clock rows and `held_total`."""
    apis = {"jax": jax_api(), "port": ac.port_api("cpu")}
    oapi, capi = apis[origin], apis[cold]
    d = str(tmp_path)

    async def main():
        net = apis["jax"].MemNetwork(seed=59)
        agents = []
        try:
            a = await ac.boot(oapi, net, f"{origin}-a", d)
            agents.append((oapi, a))
            await load_versions(oapi, a, 24, rows_per=3)
            quiet = await drained(oapi, a)
            serves0 = sb.peek(oapi, "corro.snapshot.serve.total")
            installs0 = sb.peek(capi, "corro.snapshot.install.total")

            def tune(cfg):
                cfg.sync.snapshot_min_gap_versions = 10

            c = await ac.boot(capi, net, f"{cold}-c", d, (f"{origin}-a",),
                              tune=tune)
            agents.append((capi, c))
            # the install first, then the top-up to the origin's state
            await ac.wait_until(
                lambda: sb.peek(capi, "corro.snapshot.install.total")
                == installs0 + 1, timeout=60.0)
            ok = await ac.wait_until(
                lambda: ac.count_rows(c) == 72
                and clock_rows(c) == clock_rows(a)
                and capi.held_total(c.bookie) == oapi.held_total(a.bookie),
                timeout=60.0)
            return (quiet and ok,
                    sb.peek(capi, "corro.snapshot.install.total")
                    - installs0,
                    sb.peek(oapi, "corro.snapshot.serve.total") - serves0,
                    c.catchup_census.get("state"),
                    c.store.site_id.bytes16 == c.actor_id.bytes16,
                    capi.held_total(c.bookie) == oapi.held_total(a.bookie),
                    ac.rows(c) == ac.rows(a))
        finally:
            for api, ag in agents[::-1]:
                await api.shutdown(ag)

    with cb.engine_env("python"):
        got = asyncio.run(asyncio.wait_for(main(), 90.0))
    assert got == (True, 1, 1, "installed", True, True, True)


# -- the bench's snapshot rung and chaos loop --------------------------------------


@pytest.mark.parametrize("rows,fire,mode,seed", [
    (100_000, False, "delta", 17), (100_000, False, "snapshot", 18),
    (100_000, True, "delta", 19), (100_000, True, "snapshot", 20),
    (1_000_000, False, "delta", 17), (1_000_000, False, "snapshot", 18),
    (1_000_000, True, "snapshot", 19), (1_000_000, True, "delta", None),
])
def test_seed_of_is_the_scripts_plan(rows, fire, mode, seed):
    """`seed_of` gives `scripts/bench_sync.py`'s seed (17 + the rung's
    place in its plan) and refuses a rung the script does not run."""
    if seed is None:
        with pytest.raises(ValueError, match="no fire delta rung"):
            sb.seed_of(rows, fire, mode)
    else:
        assert sb.seed_of(rows, fire, mode) == seed


def test_snapshot_rungs_equal_the_reference():
    """`sync_bench.run_rung` in snapshot mode at a small size (8,000 rows,
    4 versions, gap threshold 2: half of them), quiet in both packages
    and under fire in the port: one install, one serve, the bar met, the identity kept,
    equal rows; under fire the top-up's batches are decided after the
    install."""
    recs = []
    for api, engine in ((jax_api(), "python"), (ac.port_api("cpu"), "array")):
        with cb.engine_env(engine):
            recs.append(asyncio.run(asyncio.wait_for(sb.run_rung(
                8000, False, "snapshot", 18, api=api, cap_s=60.0), 90.0)))
    j, t = recs
    for k in ("rows_final", "clock_rows_final", "held_total",
              "origin_held_total", "rows_digest", "snapshot_installed",
              "snapshot_served", "site_id_is_actor_id", "mode", "seed"):
        assert j[k] == t[k], k
    assert (t["rows_final"], t["clock_rows_final"], t["held_total"]) == (
        8000, 16000, 4)
    assert (t["snapshot_installed"], t["snapshot_served"]) == (1, 1)
    assert t["site_id_is_actor_id"] and t["snapshot_raw_bytes"] > 0
    assert t["snapshot_install_s"] is not None
    assert t["array_lane_after_install"] is not None
    with cb.engine_env("array"):
        f = asyncio.run(asyncio.wait_for(sb.run_rung(
            8000, True, "snapshot", 20, device="cpu", cap_s=60.0), 90.0))
    rows = 8000 + f["fire_rows_written"]
    assert (f["rows_final"], f["clock_rows_final"]) == (rows, 2 * rows)
    assert f["held_total"] == f["origin_held_total"]
    assert f["snapshot_installed"] == 1
    assert f["array_lane_after_install"]["decided"] > 0


def test_chaos_phase_closes_alike():
    """`sync_bench.chaos_phase` at 1,000 rows plus 400 in the partition:
    in both packages the partition opens an episode, all three agents
    converge to the same rows, and the episode closes with one group and
    nothing silent; the port's partitioned node decided its catch-up
    batches on its decision program."""
    recs = []
    for api, engine in ((jax_api(), "python"), (ac.port_api("cpu"), "array")):
        with cb.engine_env(engine):
            recs.append(asyncio.run(asyncio.wait_for(sb.chaos_phase(
                29, api=api, rows=(1000, 400), cap_s=60.0), 120.0)))
    j, t = recs
    for r in (j, t):
        assert r["divergence_zero"] and r["episodes"] >= 1
        assert (r["final_groups"], r["final_silent"],
                r["final_divergent"]) == (1, 0, False)
        assert r["rows"] == 1400 and len(set(r["held_total"])) == 1
    assert j["rows_digest"] == t["rows_digest"]
    assert len(set(t["rows_digest"])) == 1
    assert t["array_lane_after_heal"]["decided"] > 0
    assert j["array_lane_after_heal"] is None


# -- setup ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["cluster.digests", "sync.snapshot"])
def test_setup_builds_the_ported_plane(tmp_path, plane):
    """`setup` no longer refuses the two planes: with the flag on it
    builds them (the observatory and its gossip hooks; the snapshot
    serve permits), and with it off it leaves them out."""
    api = ac.port_api("cpu")
    section, flag = plane.split(".")
    got = {}
    for on in (True, False):
        cfg = ac.fast_config(api, f"plane-{on}", str(tmp_path))
        setattr(getattr(cfg, section), flag, on)
        cfg.sync.max_concurrent_snapshot_serves = 3

        async def boot():
            agent = await trun.setup(cfg, network=api.MemNetwork(seed=1),
                                     device="cpu")
            try:
                await trun.run(agent)
                await asyncio.sleep(0.05)
                return {"observatory": agent.observatory is not None,
                        "hooked": agent.membership.digest_source is not None,
                        "permits": agent.snapshot_serve_sem._value,
                        "snapshot": agent.config.sync.snapshot}
            finally:
                await trun.shutdown(agent)

        got[on] = asyncio.run(asyncio.wait_for(boot(), 30.0))
    if plane == "cluster.digests":
        assert got[True]["observatory"] and got[True]["hooked"]
        assert not got[False]["observatory"] and not got[False]["hooked"]
    else:
        assert got[True]["snapshot"] and not got[False]["snapshot"]
        assert got[True]["observatory"]
    assert got[True]["permits"] == got[False]["permits"] == 3


# -- the pins and the references of chip_smoke.py -------------------------------------


@pytest.mark.slow
def test_chip_rungs_equal_the_references():
    """The chip's `agent_sync_100k_snapshot` rung and `agent_chaos` at
    full size, the port (array engine on the CPU) against `SYNC_REF`
    and `CHAOS_REF`."""
    from chip_smoke import CHAOS_REF, SYNC_REF

    with cb.engine_env("array"):
        rec = asyncio.run(sb.run_rung(100_000, False, "snapshot", 18,
                                      device="cpu"))
        chaos = asyncio.run(sb.chaos_phase(29, device="cpu"))
    assert {k: rec[k] for k in SYNC_REF} == SYNC_REF
    assert rec["snapshot_installed"] == 1
    assert chaos["rows_digest"] == [CHAOS_REF["rows_digest"]] * 3
    assert chaos["held_total"] == [CHAOS_REF["held_total"]] * 3


def jax_refs() -> dict:
    from chip_smoke import SYNC_REF

    api = jax_api()
    with cb.engine_env("python"):
        rec = asyncio.run(sb.run_rung(100_000, False, "snapshot", 18,
                                      api=api))
        got = {k: rec[k] for k in SYNC_REF}
        assert got == SYNC_REF, got
        assert rec["snapshot_installed"] == 1, rec
        chaos = asyncio.run(sb.chaos_phase(29, api=api))
    assert len(set(chaos["rows_digest"])) == 1, chaos
    assert len(set(chaos["held_total"])) == 1, chaos
    return {"CHAOS_REF": {"rows": chaos["rows"],
                          "rows_digest": chaos["rows_digest"][0],
                          "held_total": chaos["held_total"][0],
                          "episodes": chaos["episodes"]}}


if __name__ == "__main__":
    if "--ref" in sys.argv:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        for name, ref in jax_refs().items():
            print(f"{name} = {ref!r}", flush=True)
