"""The chaos soak on the card — the port's copy of `scripts/chaos_soak.py`
(its phases) and of `tests/test_chaos_soak.py::run_soak` (the invariant
soak the script runs).

    python -m corrosion_tpu_torch.chaos_soak [seed ...]
        the script's default mode under CORRO_INVARIANTS=strict: the
        cluster observatory, the invariant soak at each seed (default
        1337 and 4242), the kernel flight and Lifeguard phases and the
        SLO baseline; writes CHAOS_SOAK_H100.json, SLO_BASELINE_H100.json
        and CLUSTER_OBS_H100.json at the repo root. The script runs the
        cluster phase last; after the other phases in one process its
        exact-aggregation pin fails in both packages (the merged
        broadcast, apply and match counts stay 0), so it runs first
    python -m corrosion_tpu_torch.chaos_soak --phase kernel|slo|cluster
        one part alone, written to its file (`--out` names another)

- `run_soak(seed)`: four in-process agents on the in-memory network with
  10 % datagram loss and Lifeguard SWIM; concurrent writers and an
  80-row multi-chunk transaction, a partition with writes on both sides
  then a heal, a restart from disk, a permanent crash (detected
  everywhere, no persistent false positive), a write after it all, and a
  cold node that catches up by sync. Every phase waits on progress, not
  on the wall clock. Under strict invariants a violated always-invariant
  raises, and the run fails unless the three sometimes markers fired.
- `kernel_flight_phase`: a pview cluster (n=256, K=64, 2 feeds of 16,
  suspicion 4, fingers seeds) boots through `run_until_converged(400,
  25)`, 3 % of its members crash, and it steps 10 ticks at a time until
  every crash is detected with FP 0 (at most 200 ticks); the answer is
  the suspicion/down/refute timeline of the flight recorder's frames
  since the crash, which must show a down declaration.
- `flaky_node_phase`: `flaky_node_ab` on the dense tick (n=96, member 1
  lagging 2 ticks for 240 ticks, then member 2 crashed) at each seed,
  with the script's four inequalities asserted: Lifeguard cuts false
  suspicions and wrongful downs at least 5x, and still detects the crash
  within 2x the vanilla ticks.

Each kernel phase publishes its frames into a fresh `FlightRecorder`, so
frames that other sims in the same process left in the global `FLIGHT`
cannot enter its timeline.

- `slo_baseline_phase`: a 3-node `DevCluster` (topology `A -> C`,
  `B -> C`) under quiet, churn (B bounced twice) and degraded (A's
  traffic delayed 50 ms) writes with the canary probe on every node: the
  write→event percentiles of every stage, which must each have observed
  something, and `/v1/slo`'s breach flags.
- `cluster_obs_phase`: `models/cluster.py::cluster_observatory_scenario`
  on three port agents under quiet, partition then heal, and churn, each
  with a fresh `$CORRO_FLIGHT_DIR`: the `cluster_divergence` incident
  dumps must equal the divergence episodes the agents recorded.

The agents' stores decide on the card (or the device `--device` names);
put their remote merges there with `CORRO_CRDT_ENGINE=array`. The JAX
package's banked CHAOS_SOAK.json, SLO_BASELINE.json and CLUSTER_OBS.json
are never written. One JSON line is printed at the end. Run it as a
module from the repo root (`-m`): the package's `random.py` must not
shadow the stdlib's, which the soak uses.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import hashlib
import json
import os
import random
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from corrosion_tpu_torch.models.cluster import (
    PViewClusterSim,
    cluster_observatory_scenario,
    flaky_node_ab,
)
from corrosion_tpu_torch.pview_converge import timeline_digest
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime import invariants
from corrosion_tpu_torch.runtime.records import FlightRecorder

REPO = Path(__file__).resolve().parent.parent
CHAOS_SOAK_OUT = REPO / "CHAOS_SOAK_H100.json"
SLO_BASELINE_OUT = REPO / "SLO_BASELINE_H100.json"
# the port's cluster-observatory record, beside the JAX package's banked
# CLUSTER_OBS.json (git-ignored: a card run's output)
CLUSTER_OBS_OUT = REPO / "CLUSTER_OBS_H100.json"

TEST_SCHEMA = (
    "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
)

# the coverage contract: every marker the agent registers must fire
# under the soak (syncer, broadcast, ingest)
EXPECTED_SOMETIMES = {
    "changes broadcast",
    "syncs with other nodes",
    "buffered version drained",
}


def fast_config(addr: str, bootstrap=()):
    """`tests/test_agent.py::fast_config`: a file-backed store, 20 ms
    broadcasts, 5 ms apply batches, 0.1-0.5 s sync rounds."""
    from corrosion_tpu_torch.runtime.config import Config
    from corrosion_tpu_torch.runtime.tmpdb import fresh_db_path

    cfg = Config()
    cfg.db.path = fresh_db_path(addr.replace(":", "_"))
    cfg.gossip.bind_addr = addr
    cfg.gossip.bootstrap = list(bootstrap)
    cfg.perf.broadcast_interval_ms = 20
    cfg.perf.apply_queue_timeout_ms = 5
    cfg.perf.sync_interval_min_secs = 0.1
    cfg.perf.sync_interval_max_secs = 0.5
    return cfg


async def wait_progress(pred, progress, stall=30.0, cap=900.0, step=0.05):
    """Wait for `pred()`; fail only on a stall, not on the wall clock
    (`tests/test_agent.py::wait_progress`). `progress()` returns any
    comparable snapshot: while it keeps changing the wait goes on;
    `stall` bounds how long it may freeze, `cap` bounds a livelock. A
    monitor wakeup far past its `step` means the process was descheduled
    (the agents on this loop with it), so such a gap counts one step."""
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    last = progress()
    silence = 0.0
    prev = t0
    while True:
        if pred():
            return True
        now = loop.time()
        dt, prev = now - prev, now
        silence += dt if dt <= 5 * step else step
        cur = progress()
        if cur != last:
            last, silence = cur, 0.0
        if silence > stall:
            return pred()  # stalled: one final check
        if now - t0 > cap:
            return pred()
        await asyncio.sleep(step)


def count_rows(agent, where="1=1"):
    conn = agent.store.read_conn()
    try:
        return conn.execute(
            f"SELECT COUNT(*) AS n FROM tests WHERE {where}"
        ).fetchone()["n"]
    finally:
        conn.close()


async def insert(agent, rowid, text):
    from corrosion_tpu_torch.agent.run import make_broadcastable_changes

    return await make_broadcastable_changes(
        agent,
        lambda tx: [
            tx.execute(
                "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
                (rowid, text),
            )
        ],
    )


async def run_soak(seed: int, device=None) -> dict:
    """One full soak; returns the summary dict (asserts internally)."""
    from corrosion_tpu_torch.agent.membership import SwimConfig
    from corrosion_tpu_torch.agent.run import (
        make_broadcastable_changes,
        run,
        setup,
        shutdown,
    )
    from corrosion_tpu_torch.net.mem import LinkFaults, MemNetwork

    rng = random.Random(seed)
    invariants.reset_sometimes()
    net = MemNetwork(seed=seed, faults=LinkFaults(datagram_loss=0.10))
    summary: dict = {"seed": seed, "phases": []}

    # fast SWIM with Lifeguard on: a descheduled host widens its own
    # timers instead of accusing healthy peers
    soak_swim = SwimConfig(
        probe_period=0.05, probe_rtt=0.02, suspicion_mult=1.0,
        lifeguard=True,
    )

    async def boot_one(addr, bootstrap=(), cfg=None):
        cfg = cfg or fast_config(addr, bootstrap)
        agent = await setup(cfg, network=net, device=device)
        agent.membership.config = soak_swim
        agent.store.apply_schema_sql(TEST_SCHEMA)
        await run(agent)
        return agent

    names = [f"chaos-{i}" for i in range(4)]
    agents = {}
    cfgs = {}
    for i, name in enumerate(names):
        boots = tuple(rng.sample(names[:i], min(i, 2))) if i else ()
        cfgs[name] = fast_config(name, boots)
        agents[name] = await boot_one(name, cfg=cfgs[name])
    a, b, c, d = (agents[n] for n in names)

    try:
        # phase 1: concurrent writers + a multi-chunk transaction (the
        # chunked changeset forces partial-version buffering downstream,
        # firing "buffered version drained")
        for i, name in enumerate(names):
            await insert(agents[name], 100 + i, f"from-{name}")
        big = "x" * 400
        await make_broadcastable_changes(
            a,
            lambda tx: [
                tx.execute(
                    "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
                    (1000 + k, big),
                )
                for k in range(80)
            ],
        )
        want = len(names) + 80

        def all_converged(n_rows):
            return lambda: all(
                count_rows(ag) == n_rows for ag in agents.values()
            )

        def sync_diag() -> dict:
            """Per-agent bookie state (heads by origin, open gaps,
            incomplete partials): why a node is short."""
            out = {}
            for name, ag in agents.items():
                rows = {}
                for aid, booked in ag.bookie.items().items():
                    with booked.read() as bv:
                        rows[str(aid)[:8]] = {
                            "head": bv.last() or 0,
                            "needed": list(bv.needed)[:4],
                            "partials": sum(
                                1 for p in bv.partials.values()
                                if not p.is_complete()
                            ),
                        }
                out[name] = rows
            return out

        assert await wait_progress(
            all_converged(want),
            lambda: tuple(count_rows(ag) for ag in agents.values()),
            stall=60.0, cap=300.0,
        ), (
            f"phase1 rows: {[count_rows(ag) for ag in agents.values()]}\n"
            f"bookie: {sync_diag()}"
        )
        summary["phases"].append({"phase": "concurrent-writers", "rows": want})

        # phase 2: partition d from everyone; write on both sides; heal;
        # anti-entropy must repair (fires "syncs with other nodes")
        for name in names[:3]:
            net.partition(name, "chaos-3")
        await insert(a, 2001, "majority-side")
        await insert(d, 2002, "minority-side")
        await asyncio.sleep(rng.uniform(0.5, 1.5))
        for name in names[:3]:
            net.heal(name, "chaos-3")
        want += 2
        assert await wait_progress(
            all_converged(want),
            lambda: tuple(count_rows(ag) for ag in agents.values()),
        ), f"post-heal rows: {[count_rows(ag) for ag in agents.values()]}"
        summary["phases"].append({"phase": "partition-heal", "rows": want})

        # phase 3: restart c from its on-disk state (bookie rebuild +
        # member resurrection), then write more
        await shutdown(c)
        agents["chaos-2"] = c = await boot_one("chaos-2", cfg=cfgs["chaos-2"])
        await insert(b, 3001, "post-restart")
        want += 1
        assert await wait_progress(
            all_converged(want),
            lambda: tuple(count_rows(ag) for ag in agents.values()),
        ), f"post-restart rows: {[count_rows(ag) for ag in agents.values()]}"
        summary["phases"].append({"phase": "agent-restart", "rows": want})

        # phase 4: permanent crash of d — the others must down it via
        # their own SWIM pipeline, with no other member downed for good
        net.take_down("chaos-3")
        await shutdown(d)
        agents.pop("chaos-3")
        d_id = d.actor.id

        assert await wait_progress(
            lambda: all(
                d_id in ag.membership.downed for ag in agents.values()
            ),
            lambda: tuple(
                (len(ag.membership.downed), ag.membership._probe_no)
                for ag in agents.values()
            ),
            stall=60.0, cap=300.0,
        ), "crash of chaos-3 never detected cluster-wide"
        # a descheduled host may wrongfully down a live member for a
        # beat, but the victim refutes; only a down that never heals
        # fails the soak
        live_ids = {ag.actor.id for ag in agents.values()}

        def fp_downs():
            return {
                name: sorted(
                    str(aid)
                    for aid in (set(ag.membership.downed) - {d_id})
                    & live_ids
                )
                for name, ag in agents.items()
                if (set(ag.membership.downed) - {d_id}) & live_ids
            }

        transient_fp = fp_downs()
        assert await wait_progress(
            lambda: not fp_downs(),
            fp_downs,
            stall=60.0, cap=300.0,
        ), f"persistent false-positive downs: {fp_downs()}"
        summary["phases"].append(
            {
                "phase": "crash-detection",
                "downed": 1,
                "transient_fp_downs": sum(
                    len(v) for v in transient_fp.values()
                ),
            }
        )

        # replication still flows after all of it
        await insert(a, 4001, "after-chaos")
        want += 1
        assert await wait_progress(
            lambda: all(count_rows(ag) == want for ag in agents.values()),
            lambda: tuple(count_rows(ag) for ag in agents.values()),
        )
        summary["phases"].append({"phase": "post-chaos-write", "rows": want})

        # phase 6: a cold node joins after every write happened — its
        # whole table can only arrive through the pull plane, so "syncs
        # with other nodes" fires deterministically here
        agents["chaos-cold"] = cold = await boot_one(
            "chaos-cold", bootstrap=tuple(rng.sample(names[:3], 2))
        )
        assert await wait_progress(
            lambda: count_rows(cold) == want,
            lambda: (count_rows(cold), cold.membership.cluster_size,
                     cold.membership._probe_no),
            stall=60.0, cap=300.0,
        ), f"cold join stalled at {count_rows(cold)}/{want}"
        summary["phases"].append({"phase": "cold-join-catchup", "rows": want})
    finally:
        for ag in agents.values():
            await shutdown(ag)

    fired = invariants.sometimes_registry()
    summary["sometimes"] = dict(fired)
    missing = EXPECTED_SOMETIMES - set(fired)
    assert not missing, f"coverage contract unmet, never fired: {missing}"
    return summary


def kernel_flight_phase(seed: int = 7, device=None) -> dict:
    """Kernel-level churn episode with a tick-resolved verdict (the
    script's body)."""
    dev = resolve_device(device)
    recorder = FlightRecorder()
    n = 256
    sim = PViewClusterSim(
        n, slots=64, seed=seed, seed_mode="fingers", device=dev,
        feeds_per_tick=2, feed_entries=16, suspicion_ticks=4,
    )
    sim.flight = recorder
    sim.run_until_converged(max_ticks=400, check_every=25)
    kill = np.random.default_rng(seed).choice(
        n, size=max(1, n * 3 // 100), replace=False
    )
    base = sim.ticks
    sim.crash_many(kill)
    det = None
    while sim.ticks - base < 200:
        sim.step(10)
        cs = sim.stats()  # drains the ring into the recorder as it goes
        if cs["detected"] >= 1.0 and cs["false_positive"] == 0.0:
            det = sim.ticks - base
            break
    timeline = [
        {
            "tick": f["tick"] - base,
            "suspect_raised": f["events"]["suspect_raised"],
            "down_declared": f["events"]["down_declared"],
            "refuted": f["events"]["refuted"],
            "open_timers": f["census"]["census_suspect"],
        }
        for f in recorder.window(4096, kernel="pview")
        if f["tick"] >= base
        and (
            f["events"]["suspect_raised"]
            or f["events"]["down_declared"]
            or f["events"]["refuted"]
        )
    ][-128:]
    assert det is not None, "kernel flight phase: churn never detected"
    assert any(r["down_declared"] for r in timeline), (
        "flight ring shows no down_declared tick for a detected churn"
    )
    return {
        "n": n,
        "killed": int(len(kill)),
        "detect_ticks": det,
        "timeline": timeline,
    }


def flaky_node_phase(seeds=(3, 11), device=None) -> dict:
    """The Lifeguard A/B at each seed, the script's inequalities
    asserted before the result is returned."""
    dev = resolve_device(device)
    recorder = FlightRecorder()
    runs = []
    for seed in seeds:
        r = flaky_node_ab(
            kernel="dense", seed=seed, n=96, boot_ticks=40, window=240,
            lag=2, chunk=20, detect_chunk=5, drain_flight=True,
            flight=recorder, device=dev,
        )
        v, lf = r["vanilla"], r["lifeguard"]
        assert v["suspect_fp"] >= 5 * max(1, lf["suspect_fp"]), (
            f"seed {seed}: FP suspicions did not collapse 5x: {r}"
        )
        assert v["down_fp"] >= 5 * max(1, lf["down_fp"]), (
            f"seed {seed}: wrongful downs did not collapse 5x: {r}"
        )
        assert v["detect_ticks"] is not None and lf["detect_ticks"], (
            f"seed {seed}: crash never detected: {r}"
        )
        assert lf["detect_ticks"] <= 2 * v["detect_ticks"], (
            f"seed {seed}: lifeguard detection too slow: {r}"
        )
        assert lf["timeline"], f"seed {seed}: no flight timeline: {r}"
        runs.append(r)
        print(
            f"flaky-node seed {seed}: suspect_fp {v['suspect_fp']} -> "
            f"{lf['suspect_fp']}, down_fp {v['down_fp']} -> "
            f"{lf['down_fp']}, detect {v['detect_ticks']} -> "
            f"{lf['detect_ticks']}", flush=True,
        )
    return {"scenario": "one member lag=2 ticks, alive throughout",
            "runs": runs}


def checked(kernel_flight: dict, flaky: dict) -> dict:
    """What a reference run of both phases must equal: the flight
    phase's crash count, detection ticks and timeline (row count and
    digest), and per A/B seed each mode's counts, detection ticks and
    timeline digest."""
    keys = ("suspect_fp", "down_fp", "suspect_raised", "refuted",
            "confirmations", "lhm_degraded", "detect_ticks", "detect_base")
    tl = kernel_flight["timeline"]
    return {
        "kernel_flight": (kernel_flight["killed"],
                          kernel_flight["detect_ticks"], len(tl),
                          timeline_digest(tl)),
        "flaky": [(r["seed"],) + tuple(
            tuple(r[m][k] for k in keys) + (timeline_digest(r[m]["timeline"]),)
            for m in ("vanilla", "lifeguard")) for r in flaky["runs"]],
    }


def cluster_obs_phase(device=None) -> dict:
    """The cluster-observatory baseline: quiet, partition then heal, and
    churn on three port agents through the shared scenario harness, whose
    own checks pin exact cluster aggregation; here each scenario also
    runs with a fresh `$CORRO_FLIGHT_DIR`, and its `cluster_divergence`
    incident dumps must equal its divergence episodes (one per episode,
    none in quiet)."""
    dev = resolve_device(device)
    out: dict = {"scenarios": {}}
    for i, name in enumerate(("quiet", "partition", "churn")):
        with tempfile.TemporaryDirectory() as flight_dir:
            old = os.environ.get("CORRO_FLIGHT_DIR")
            os.environ["CORRO_FLIGHT_DIR"] = flight_dir
            try:
                t0 = time.monotonic()
                timeline: list = []
                rec = asyncio.new_event_loop().run_until_complete(
                    asyncio.wait_for(
                        cluster_observatory_scenario(
                            name, seed=211 + i, timeline=timeline,
                            device=dev,
                        ),
                        300,
                    )
                )
                rec["wall_s"] = round(time.monotonic() - t0, 1)
                dumps = len(glob.glob(
                    os.path.join(flight_dir, "*cluster_divergence*")))
            finally:
                if old is None:
                    os.environ.pop("CORRO_FLIGHT_DIR", None)
                else:
                    os.environ["CORRO_FLIGHT_DIR"] = old
        expected_dumps = rec.get("episodes_total", 0)
        assert dumps == expected_dumps, (
            f"cluster obs {name}: {dumps} incident dumps for "
            f"{expected_dumps} divergence episodes"
        )
        rec["incident_dumps"] = dumps
        rec["timeline"] = timeline[-64:]
        out["scenarios"][name] = rec
        msg = f"cluster obs {name}: coverage_rounds={rec['coverage_rounds']}"
        if "detect_rounds" in rec:
            msg += (
                f" detect_rounds={rec['detect_rounds']}"
                f" ({rec['detect_secs']}s)"
                f" heal_rounds={rec['heal_rounds']}"
                f" episodes={rec['episodes_total']} dumps={dumps}"
            )
        print(msg, flush=True)
    return out


def slo_baseline_phase(writes: int = 40, device=None) -> dict:
    """The write→event SLO baseline: per-stage percentiles
    (`corro.e2e.*`) of a 3-node devcluster under quiet writes, churn (B
    bounced at a third and two thirds of the writes: sync catch-up and
    regossip while writes flow) and degraded (A's traffic delayed 50 ms
    one way), with the canary probe on every node. Every stage must
    observe something in every scenario; `latency.stage_report(before=)`
    keeps the scenarios apart in the shared registry."""
    from corrosion_tpu_torch.agent.membership import SwimConfig
    from corrosion_tpu_torch.devcluster import DevCluster, Topology
    from corrosion_tpu_torch.net.mem import MemNetwork
    from corrosion_tpu_torch.runtime import latency as lat

    schema = (
        "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
    )

    async def run_scenario(name: str, seed: int) -> dict:
        import aiohttp

        from corrosion_tpu_torch.agent.run import (
            canary_loop,
            make_broadcastable_changes,
        )
        from corrosion_tpu_torch.api.http import ApiServer
        from corrosion_tpu_torch.client import CorrosionApiClient

        net = MemNetwork(seed=seed)
        cluster = DevCluster(
            Topology.parse("A -> C\nB -> C\n"),
            schema,
            network=net,
            swim_config=SwimConfig(
                probe_period=0.05, probe_rtt=0.02, suspicion_mult=1.0
            ),
            device=device,
        )
        await cluster.start()
        api = client = None
        canaries = []
        try:
            await cluster.wait_converged(timeout=30.0)
            writer = cluster.agents["A"]
            subber = cluster.agents["C"]
            subber.config.api.bind_addr = ["127.0.0.1:0"]
            api = ApiServer(subber)
            await api.start()
            client = CorrosionApiClient(api.addrs[0])
            stream = client.subscribe("SELECT id, text FROM tests")
            it = stream.__aiter__()
            while True:
                ev = await asyncio.wait_for(it.__anext__(), 10)
                if "eoq" in ev:
                    break
            for ag in cluster.agents.values():
                ag.config.slo.canary = True
                ag.config.slo.canary_interval_secs = 0.25
                canaries.append(asyncio.ensure_future(canary_loop(ag)))
            before = lat.snapshot_stages()
            if name == "degraded":
                net.degrade("A", latency=0.05)
            got = 0
            for i in range(writes):
                if name == "churn" and i in (writes // 3, 2 * writes // 3):
                    net.take_down("B")
                    await asyncio.sleep(0.2)
                    net.bring_up("B")
                await make_broadcastable_changes(
                    writer,
                    lambda tx, i=i: [
                        tx.execute(
                            "INSERT OR REPLACE INTO tests (id, text) "
                            "VALUES (?, ?)",
                            [i, f"{name}-{i}"],
                        )
                    ],
                )
                while got <= i:
                    ev = await asyncio.wait_for(it.__anext__(), 30)
                    if "change" in ev:
                        got += 1
            await asyncio.sleep(1.2)  # canary cycles + sync stragglers
            rep = lat.stage_report(before=before)
            for stage in lat.E2E_STAGES:
                assert rep[stage]["count"] > 0, (
                    f"slo baseline {name}: stage {stage} observed nothing"
                )
            # the live plane serves the same stages over HTTP
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://{api.addrs[0]}/v1/slo") as resp:
                    assert resp.status == 200
                    slo_body = await resp.json()
            canary_n = sum(
                w.snapshot_cumulative().count
                for _n, _l, w in lat._registry().latency_family(
                    "corro.e2e.canary.seconds"
                )
            )
            return {
                "writes": writes,
                "stages": rep,
                "canary_probes_cumulative": canary_n,
                "slo_breached_now": {
                    s: slo_body["stages"][s]["breached"]
                    for s in slo_body["stages"]
                },
            }
        finally:
            for c in canaries:
                c.cancel()
            for c in canaries:
                try:
                    await c
                except (asyncio.CancelledError, Exception):
                    pass
            if client is not None:
                await client.close()
            if api is not None:
                await api.stop()
            await cluster.stop()

    out: dict = {"scenarios": {}}
    for i, name in enumerate(("quiet", "churn", "degraded")):
        t0 = time.monotonic()
        rec = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(run_scenario(name, seed=97 + i), 600)
        )
        rec["wall_s"] = round(time.monotonic() - t0, 1)
        out["scenarios"][name] = rec
        p99 = rec["stages"]["total"]["p99"]
        print(
            f"slo baseline {name}: total p99="
            f"{p99 * 1e3 if p99 else float('nan'):.1f}ms "
            f"counts={{"
            + ", ".join(
                f"{s}: {rec['stages'][s]['count']}"
                for s in rec["stages"]
            )
            + "}}",
            flush=True,
        )
    return out


def soak_runs(seeds=(1337, 4242), device=None) -> list:
    """The invariant soak at each seed under strict invariants (the
    script's flake-free repeat)."""
    old = os.environ.get("CORRO_INVARIANTS")
    os.environ["CORRO_INVARIANTS"] = "strict"
    try:
        runs = []
        for seed in seeds:
            t0 = time.monotonic()
            # outer bound > the inner wait_progress livelock cap
            summary = asyncio.new_event_loop().run_until_complete(
                asyncio.wait_for(run_soak(seed, device=device), 1200)
            )
            summary["wall_s"] = round(time.monotonic() - t0, 1)
            runs.append(summary)
            print(f"seed {seed}: {len(summary['phases'])} phases, "
                  f"{summary['wall_s']}s, sometimes={summary['sometimes']}",
                  flush=True)
        return runs
    finally:
        if old is None:
            os.environ.pop("CORRO_INVARIANTS", None)
        else:
            os.environ["CORRO_INVARIANTS"] = old


def code_sha() -> str:
    """A digest over the port's Python sources: the code a record ran."""
    h = hashlib.sha256()
    for path in sorted((REPO / "corrosion_tpu_torch").rglob("*.py")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _write(path, rec: dict) -> None:
    rec["code_sha"] = code_sha()
    rec["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", nargs="*", type=int,
                    help="soak seeds (default 1337 4242)")
    ap.add_argument("--phase", choices=("kernel", "slo", "cluster"),
                    default=None,
                    help="run one part alone (default: all of them)")
    ap.add_argument("--out", help="the file of a --phase run's record")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.environ["CORRO_INVARIANTS"] = "strict"
    seeds = tuple(args.seeds) or (1337, 4242)
    phase = args.phase
    # `--out` names a one-part run's file; a full run writes all three
    out = args.out if phase else None
    rec: dict = {}
    parts: dict = {}
    if phase in (None, "cluster"):
        # first, as a workaround (the JAX script runs it last, where it
        # fails in either package): a node digest carries the process's
        # cumulative stage histograms, which the other phases fill until
        # the digest passes `max_wire_bytes` and `build_and_store` sheds
        # every stage but `total`, so the exact-aggregation pin reads
        # merged counts of 0 (ROADMAP §3)
        t0 = time.monotonic()
        parts["cluster"] = cluster_obs_phase(device=dev)
        parts["cluster"]["wall_s"] = round(time.monotonic() - t0, 1)
        _write(out or CLUSTER_OBS_OUT, parts["cluster"])
    if phase is None:
        rec["mode"] = "strict"
        rec["runs"] = soak_runs(seeds, device=dev)
    if phase in (None, "kernel"):
        t0 = time.monotonic()
        rec["kernel_flight"] = kernel_flight_phase(device=dev)
        rec["kernel_flight"]["wall_s"] = round(time.monotonic() - t0, 1)
        t0 = time.monotonic()
        rec["flaky_node"] = flaky_node_phase(device=dev)
        rec["flaky_node"]["wall_s"] = round(time.monotonic() - t0, 1)
    if rec:
        _write(out or CHAOS_SOAK_OUT, rec)
    if phase in (None, "slo"):
        t0 = time.monotonic()
        parts["slo"] = slo_baseline_phase(device=dev)
        parts["slo"]["wall_s"] = round(time.monotonic() - t0, 1)
        _write(out or SLO_BASELINE_OUT, parts["slo"])
    rec.update(parts)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
