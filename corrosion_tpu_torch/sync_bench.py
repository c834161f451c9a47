"""`scripts/bench_sync.py` on the port's agent: the cold-join rungs and
the chaos loop.

    python -m corrosion_tpu_torch.sync_bench [--rows 100000|1000000]
        [--mode delta|snapshot] [--fire] [--engine array|python|native]
        [--out PATH]
    python -m corrosion_tpu_torch.sync_bench --chaos [--engine ...]
        [--out PATH]

A cold node joins a cluster whose origin holds a table of `--rows` rows,
written as transactions of `ROWS_PER_TX` rows (one version each), and
catches up: by delta sync alone (`--mode delta`, `sync.snapshot` off on
the cold node), or by installing the origin's compressed snapshot and
topping up by delta sync from its watermark (`--mode snapshot`: the
catch-up plane, `agent/catchup.py`). With `--fire` a concurrent writer
on the origin adds `FIRE_ROWS` rows every `FIRE_PERIOD` seconds until
the cold node is within five of its transactions, and then stops. The
bar is the script's, in three terms: the cold node's row count equals
the origin's, its `held_total` equals the origin's (no gap left,
nothing buffered), and so does its count of CRDT clock rows. Each rung
runs at the script's seed for it (`seed_of`).

`--chaos` runs the script's `chaos_phase`: three agents hold 10,000
rows, the third is partitioned away while the first writes 4,000 more,
the first agent's observatory must open a divergence episode, and after
the heal all three converge and the detector closes the episode (one
view group, nothing silent).

Every remote changeset a node applies goes through its store's merge
engine (`CORRO_CRDT_ENGINE`, `--engine`); under `array` the decision
program runs on the card, and the record's `array_lane` counts the
batches it decided and declined there (`array_lane_after_install`: those
after the snapshot's swap; the chaos record's `array_lane_after_heal`:
the partitioned node's after the heal). A rung's record has the script's
fields (with `snapshot_installed`, `snapshot_raw_bytes` and
`snapshot_install_s`) plus the engine, the snapshots the origin served,
whether the cold node kept its identity (`site_id_is_actor_id`),
changes received by sync per second of the wall to convergence, the cold
node's rows per second of that wall, the changes that entered the cold
node by broadcast and by sync (`changes_in_by_source`), a digest of the
cold node's rows, the array lane and the card's name and power limit. It
is printed as one JSON line and written only to `--out`;
`SYNC_SCALE.json` is the JAX package's and is never touched. Runs on the
card unless given device="cpu" (or another package's `api`, as the
tests do).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import tempfile
import time

from corrosion_tpu_torch import agent_checks as ac

ROWS_PER_TX = 2000  # one version per tx: 1M rows = 500 versions
FIRE_ROWS = 10  # concurrent writer: rows per tx
FIRE_PERIOD = 0.05  # seconds between fire txs
FIRE_BASE = 10_000_000
MODES = ("delta", "snapshot")
# the script's chaos sizes: rows before the partition, rows written on
# the majority side during it
CHAOS_ROWS = (10_000, 4_000)


def script_plan(n_rows: int) -> list:
    """(fire, mode) of the script's rungs at `n_rows`, in its order."""
    plan = [(False, "delta"), (False, "snapshot"), (True, "snapshot")]
    if n_rows == 100_000:
        plan.insert(2, (True, "delta"))
    return plan


def seed_of(n_rows: int, fire: bool, mode: str) -> int:
    """The script's seed for a rung: 17 + its place in the plan."""
    plan = script_plan(n_rows)
    if (fire, mode) not in plan:
        raise ValueError(f"the script runs no {'fire' if fire else 'quiet'}"
                         f" {mode} rung at {n_rows} rows")
    return 17 + plan.index((fire, mode))


def peek(api, name: str, **labels) -> float:
    for _kind, sname, slabels, value in api.METRICS.snapshot():
        if sname == name and slabels == labels:
            return value
    return 0.0


class SourceCount:
    """An agent's changes channel (`tx_changes`) that counts the changes
    entering it by source (`ChangeSource.value`: "broadcast", "sync")."""

    def __init__(self, inner):
        self.inner = inner
        self.changes = {"broadcast": 0, "sync": 0}

    def _count(self, item) -> None:
        cv, source = item
        n = len(getattr(cv.changeset, "changes", ()))
        self.changes[source.value] = self.changes.get(source.value, 0) + n

    async def send(self, item):
        self._count(item)
        return await self.inner.send(item)

    def try_send(self, item):
        self._count(item)
        return self.inner.try_send(item)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def tune_boot(cfg) -> None:
    """The script's `boot` tuning."""
    cfg.perf.sync_interval_min_secs = 0.2
    cfg.perf.sync_interval_max_secs = 1.0
    cfg.cluster.digest_interval_secs = 0.5


def tune_rung(mode: str, n_rows: int):
    """The script's cold-node tuning in `mode` on top of `tune_boot`."""

    def tune(cfg) -> None:
        tune_boot(cfg)
        cfg.sync.snapshot = mode == "snapshot"
        # the load writes ROWS_PER_TX-row versions: 100k rows = 50
        # versions, so the script's threshold of 20 sits below that; a
        # smaller table takes half its versions
        cfg.sync.snapshot_min_gap_versions = max(
            1, min(20, n_rows // ROWS_PER_TX // 2))

    return tune


def lane_since(agent, before) -> dict:
    """Batches `agent`'s store decided and declined since `before`."""
    now = ac.array_lane([agent])
    if now is None or before is None:
        return now
    return {k: now[k] - before[k] for k in now}


async def load_rows(api, agent, n_rows: int, base: int = 0) -> int:
    """`n_rows` rows in ROWS_PER_TX-row transactions (one version
    each); returns versions written."""
    versions = 0
    for start in range(base, base + n_rows, ROWS_PER_TX):
        count = min(ROWS_PER_TX, base + n_rows - start)
        await ac.insert_many(api, agent, ((start + k, f"row-{start + k}")
                                          for k in range(count)))
        versions += 1
    return versions


async def run_rung(n_rows: int, fire: bool, mode: str, seed: int, api=None,
                   device=None, cap_s: float = 3600.0) -> dict:
    """One cold join (the script's `run_rung`; mode is "snapshot" or
    "delta"), its database files in a temporary directory. `api` is an
    `agent_checks` namespace (default: the port's on `device`); `cap_s`
    bounds the wait for the cold node to catch up."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    api = api or ac.port_api(device)
    with tempfile.TemporaryDirectory(prefix="sync_bench") as tmp:
        return await _run_rung(api, n_rows, fire, mode, seed, tmp, cap_s)


async def _run_rung(api, n_rows, fire, mode, seed, db_dir, cap_s) -> dict:
    net = api.MemNetwork(seed=seed)
    a = c = None
    fire_task = None
    fire_state = {"rows": 0, "stop": False}
    try:
        a = await ac.boot(api, net, "origin", db_dir, tune=tune_boot)
        t_load = time.monotonic()
        await load_rows(api, a, n_rows)
        load_s = time.monotonic() - t_load
        await asyncio.sleep(1.0)  # retire the broadcast backlog

        installs0 = peek(api, "corro.snapshot.install.total")
        served0 = peek(api, "corro.snapshot.serve.total")
        delta0 = peek(api, "corro.sync.client.changes.received")
        waves0 = peek(api, "corro.sync.resume.waves.total")

        async def fire_writer():
            while not fire_state["stop"]:
                rows = fire_state["rows"]
                await ac.insert_many(api, a, ((FIRE_BASE + rows + k, "fire")
                                              for k in range(FIRE_ROWS)))
                fire_state["rows"] += FIRE_ROWS
                await asyncio.sleep(FIRE_PERIOD)

        counts = []

        def before_run(agent) -> None:
            agent.tx_changes = SourceCount(agent.tx_changes)
            counts.append(agent.tx_changes)

        t0 = time.monotonic()
        c = await ac.boot(api, net, "cold", db_dir, ("origin",),
                          tune=tune_rung(mode, n_rows),
                          before_run=before_run)
        if fire:
            fire_task = asyncio.ensure_future(fire_writer())

        def caught_up() -> bool:
            if not fire:
                return ac.count_rows(c) >= n_rows
            # under fire the target moves: "caught" = within a handful of
            # fire txs; the writer then stops and the exact bar must close
            return ac.count_rows(a) - ac.count_rows(c) <= 5 * FIRE_ROWS

        if not await ac.wait_until(caught_up, timeout=cap_s, step=0.25):
            raise AssertionError(
                f"cold node stalled at {ac.count_rows(c)} rows")
        if fire:
            fire_state["stop"] = True
            await asyncio.wait_for(fire_task, 60.0)
            fire_task = None

        def fully_converged() -> bool:
            if ac.count_rows(c) != ac.count_rows(a):
                return False
            if api.held_total(c.bookie) != api.held_total(a.bookie):
                return False
            return ac.clock_count(c) == ac.clock_count(a)

        if not await ac.wait_until(fully_converged, timeout=600, step=0.25):
            raise AssertionError(
                f"final convergence stalled: rows {ac.count_rows(c)}/"
                f"{ac.count_rows(a)} held {api.held_total(c.bookie)}/"
                f"{api.held_total(a.bookie)}")
        wall = time.monotonic() - t0
        received = int(peek(api, "corro.sync.client.changes.received")
                       - delta0)
        # the port's census holds its store's array lane at the install
        census = c.catchup_census
        rec = {
            "rung": f"sync-{n_rows // 1000}k-"
                    f"{'fire' if fire else 'quiet'}-{mode}",
            "rows": n_rows,
            "fire": fire,
            "fire_rows_written": fire_state["rows"],
            "mode": mode,
            "seed": seed,
            "versions": (n_rows + ROWS_PER_TX - 1) // ROWS_PER_TX,
            "load_wall_s": load_s,
            "wall_to_converged_s": wall,
            "converged": True,
            "rows_final": ac.count_rows(c),
            "clock_rows_final": ac.clock_count(c),
            "held_total": api.held_total(c.bookie),
            "origin_held_total": api.held_total(a.bookie),
            "snapshot_installed": int(
                peek(api, "corro.snapshot.install.total") - installs0),
            "snapshot_served": int(
                peek(api, "corro.snapshot.serve.total") - served0),
            "site_id_is_actor_id": c.store.site_id == c.actor_id,
            "delta_changes_received": received,
            "changes_per_s": received / wall,
            "rows_per_s": ac.count_rows(c) / wall,
            "changes_in_by_source": dict(counts[0].changes),
            "resume_waves": int(peek(api, "corro.sync.resume.waves.total")
                                - waves0),
            "rows_digest": ac.digest(ac.rows(c)),
            "engine": os.environ.get("CORRO_CRDT_ENGINE", "python"),
            "array_lane": ac.array_lane([c]),
            "array_lane_after_install": (
                lane_since(c, census["array_lane"])
                if "array_lane" in census else None),
            "origin_array_lane": ac.array_lane([a]),
        }
        if mode == "snapshot":
            rec["snapshot_raw_bytes"] = census.get("raw_bytes", 0)
            rec["snapshot_install_s"] = census.get("seconds")
        return rec
    finally:
        if fire_task is not None:
            fire_state["stop"] = True
            fire_task.cancel()
        await ac.shutdown_all(api, [c, a])


async def chaos_phase(seed: int = 29, api=None, device=None,
                      rows: tuple = CHAOS_ROWS,
                      cap_s: float = 600.0) -> dict:
    """The script's `chaos_phase`: partition → heal → catch-up →
    converge, with the observatory's divergence detector as the oracle.
    The partition must open a divergence episode on the first agent, and
    after heal and catch-up the detector must report one view group, no
    silent node, the episode closed, while every replica holds the
    origin's rows. `rows` is (before, during) the partition; `cap_s`
    bounds the post-heal convergence."""
    api = api or ac.port_api(device)
    with tempfile.TemporaryDirectory(prefix="sync_chaos") as tmp:
        return await _chaos_phase(api, seed, rows, tmp, cap_s)


async def _chaos_phase(api, seed, rows, db_dir, cap_s) -> dict:
    before, during = rows
    total = before + during
    net = api.MemNetwork(seed=seed)

    def tune(cfg):
        tune_boot(cfg)
        # circuits open DURING the partition (the breaker working); a
        # short reset keeps the post-heal catch-up prompt — the knob an
        # operator running frequent-partition topologies would set
        cfg.sync.circuit_reset_secs = 3.0

    # suspicion window longer than the partition: members stay (at
    # worst SUSPECT, refuted on heal) so the measured catch-up is the
    # SYNC plane's, not a full SWIM eviction/rejoin cycle; divergence
    # detection rides the digest-silence signal
    gentle = api.SwimConfig(probe_period=0.25, probe_rtt=0.1,
                            suspicion_mult=4)
    agents = []
    try:
        a = await ac.boot(api, net, "chaos-a", db_dir, tune=tune,
                          swim=gentle)
        agents.append(a)
        for name in ("chaos-b", "chaos-c"):
            agents.append(await ac.boot(api, net, name, db_dir,
                                        ("chaos-a",), tune=tune,
                                        swim=gentle))
        _a, b, c = agents
        await load_rows(api, a, before)
        if not await ac.wait_until(
                lambda: ac.count_rows(b) == before
                and ac.count_rows(c) == before, timeout=300, step=0.25):
            raise AssertionError("pre-chaos convergence stalled")

        # partition C away and keep writing on the majority side
        t0 = time.monotonic()
        for name in ("chaos-a", "chaos-b"):
            net.partition(name, "chaos-c")
        await load_rows(api, a, during, base=before)

        def detected() -> bool:
            return a.observatory.check_divergence()["episode_open"]

        if not await ac.wait_until(detected, timeout=60, step=0.25):
            raise AssertionError("divergence never detected during "
                                 "partition")
        detect_s = time.monotonic() - t0

        lane_heal = ac.array_lane([c])
        for name in ("chaos-a", "chaos-b"):
            net.heal(name, "chaos-c")
        t_heal = time.monotonic()

        def converged() -> bool:
            return (
                ac.count_rows(c) == ac.count_rows(a) == total
                and ac.count_rows(b) == total
                and api.held_total(c.bookie) == api.held_total(a.bookie)
            )

        if not await ac.wait_until(converged, timeout=cap_s, step=0.25):
            raise AssertionError(f"post-heal convergence stalled: "
                                 f"{ac.count_rows(c)}")
        catchup_s = time.monotonic() - t_heal

        def divergence_zero() -> bool:
            v = a.observatory.check_divergence()
            return (not v["divergent"] and not v["episode_open"]
                    and v["groups"] == 1 and not v["silent"])

        if not await ac.wait_until(divergence_zero, timeout=120, step=0.5):
            raise AssertionError(f"divergence never closed: "
                                 f"{a.observatory.check_divergence()}")
        verdict = a.observatory.check_divergence()
        return {
            "rows": total,
            "partition_writes": during,
            "seed": seed,
            "detect_s": detect_s,
            "catchup_s": catchup_s,
            "divergence_zero": True,
            "episodes": verdict["episodes"],
            "final_groups": verdict["groups"],
            "final_silent": len(verdict["silent"]),
            "final_divergent": verdict["divergent"],
            "rows_digest": [ac.digest(ac.rows(ag)) for ag in agents],
            "held_total": [api.held_total(ag.bookie) for ag in agents],
            "engine": os.environ.get("CORRO_CRDT_ENGINE", "python"),
            "array_lane": ac.array_lane(agents),
            "array_lane_after_heal": lane_since(c, lane_heal),
        }
    finally:
        await ac.shutdown_all(api, agents[::-1])


def main(argv=None) -> None:
    from corrosion_tpu_torch.crdt_bench import engine_env
    from corrosion_tpu_torch.runtime.device import card_line, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=100_000,
                   choices=(100_000, 1_000_000))
    p.add_argument("--mode", default="delta", choices=MODES)
    p.add_argument("--fire", action="store_true")
    p.add_argument("--chaos", action="store_true",
                   help="run the chaos loop instead of a rung")
    p.add_argument("--engine", default="array",
                   choices=("array", "python", "native"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not args.chaos:
        try:
            seed = seed_of(args.rows, args.fire, args.mode)
        except ValueError as e:
            p.error(str(e))
    dev = resolve_device()
    t0 = time.monotonic()
    with engine_env(args.engine):
        if args.chaos:
            rec = asyncio.run(chaos_phase(device=dev))
        else:
            rec = asyncio.run(run_rung(args.rows, args.fire, args.mode,
                                       seed, device=dev))
    rec["rung_wall_s"] = time.monotonic() - t0
    rec.update(card_line(dev))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
