"""The delta rungs of `scripts/bench_sync.py` on the port's agent.

    python -m corrosion_tpu_torch.sync_bench [--rows 100000|1000000]
        [--fire] [--engine array|python|native] [--out PATH]

A cold node joins a cluster whose origin holds a table of `--rows` rows,
written as transactions of `ROWS_PER_TX` rows (one version each), and
catches up by delta sync alone: the catch-up plane's snapshot rungs and
the script's `chaos_phase` are not here (ROADMAP §1 item 9.1). With
`--fire` a concurrent writer on the origin adds `FIRE_ROWS` rows every
`FIRE_PERIOD` seconds until the cold node is within five of its
transactions, and then stops. The bar is the script's, in three terms:
the cold node's row count equals the origin's, its `held_total` equals
the origin's (no gap left, nothing buffered), and so does its count of
CRDT clock rows.

Every remote changeset the cold node applies goes through its store's
merge engine (`CORRO_CRDT_ENGINE`, `--engine`); under `array` the
decision program runs on the card, and the record's `array_lane` counts
the batches it decided and declined there. The record has the script's
fields plus the engine, changes received by sync per second of the
wall to convergence, the cold node's rows per second of that wall, the
changes that entered the cold node by broadcast and by sync
(`changes_in_by_source`: the origin's broadcast backlog reaches a node
that joins while it drains), a digest of the cold node's rows, the
array lane and the card's name and power limit. It is printed as one JSON line and written
only to `--out`; `SYNC_SCALE.json` is the JAX package's and is never
touched. Runs on the card unless `run_rung` is given device="cpu" (or
another package's `api`, as the tests do).
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
SEEDS = {False: 17, True: 19}  # the script's seeds of the 100k delta rungs


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


def tune_rung(cfg) -> None:
    """The script's `boot` tuning and its delta mode."""
    cfg.perf.sync_interval_min_secs = 0.2
    cfg.perf.sync_interval_max_secs = 1.0
    cfg.cluster.digest_interval_secs = 0.5
    cfg.sync.snapshot = False
    cfg.sync.snapshot_min_gap_versions = 20


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


async def run_rung(n_rows: int, fire: bool, seed: int, api=None,
                   device=None, cap_s: float = 3600.0) -> dict:
    """One cold join by delta sync (the script's `run_rung` in delta
    mode), its two database files in a temporary directory. `api` is an
    `agent_checks` namespace (default: the port's on `device`); `cap_s`
    bounds the wait for the cold node to catch up."""
    api = api or ac.port_api(device)
    with tempfile.TemporaryDirectory(prefix="sync_bench") as tmp:
        return await _run_rung(api, n_rows, fire, seed, tmp, cap_s)


async def _run_rung(api, n_rows, fire, seed, db_dir, cap_s) -> dict:
    net = api.MemNetwork(seed=seed)
    a = c = None
    fire_task = None
    fire_state = {"rows": 0, "stop": False}
    try:
        a = await ac.boot(api, net, "origin", db_dir, tune=tune_rung)
        t_load = time.monotonic()
        await load_rows(api, a, n_rows)
        load_s = time.monotonic() - t_load
        await asyncio.sleep(1.0)  # retire the broadcast backlog

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

        def count_sources(agent) -> None:
            agent.tx_changes = SourceCount(agent.tx_changes)
            counts.append(agent.tx_changes)

        t0 = time.monotonic()
        c = await ac.boot(api, net, "cold", db_dir, ("origin",),
                          tune=tune_rung, before_run=count_sources)
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
        return {
            "rung": f"sync-{n_rows // 1000}k-"
                    f"{'fire' if fire else 'quiet'}-delta",
            "rows": n_rows,
            "fire": fire,
            "fire_rows_written": fire_state["rows"],
            "mode": "delta",
            "versions": (n_rows + ROWS_PER_TX - 1) // ROWS_PER_TX,
            "load_wall_s": load_s,
            "wall_to_converged_s": wall,
            "converged": True,
            "rows_final": ac.count_rows(c),
            "clock_rows_final": ac.clock_count(c),
            "held_total": api.held_total(c.bookie),
            "origin_held_total": api.held_total(a.bookie),
            "delta_changes_received": received,
            "changes_per_s": received / wall,
            "rows_per_s": ac.count_rows(c) / wall,
            "changes_in_by_source": dict(counts[0].changes),
            "resume_waves": int(peek(api, "corro.sync.resume.waves.total")
                                - waves0),
            "rows_digest": ac.digest(ac.rows(c)),
            "engine": os.environ.get("CORRO_CRDT_ENGINE", "python"),
            "array_lane": ac.array_lane([c]),
            "origin_array_lane": ac.array_lane([a]),
        }
    finally:
        if fire_task is not None:
            fire_state["stop"] = True
            fire_task.cancel()
        await ac.shutdown_all(api, [c, a])


def main(argv=None) -> None:
    from corrosion_tpu_torch.crdt_bench import engine_env
    from corrosion_tpu_torch.runtime.device import card_line, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=100_000,
                   choices=(100_000, 1_000_000))
    p.add_argument("--fire", action="store_true")
    p.add_argument("--engine", default="array",
                   choices=("array", "python", "native"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device()
    seed = SEEDS[args.fire]
    t0 = time.monotonic()
    with engine_env(args.engine):
        rec = asyncio.run(run_rung(args.rows, args.fire, seed, device=dev))
    rec["rung_wall_s"] = time.monotonic() - t0
    rec.update(card_line(dev))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
