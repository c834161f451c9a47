"""The scale ladder on the card — the port's copy of
`scripts/scale_ladder.py` rungs 0, 1, 2 and 3.

    python -m corrosion_tpu_torch.scale_ladder [rung ...] [--out PATH]
                                   (default: the kernel rungs, 1 2 3)

  0. a 3-node `DevCluster` (topology `A -> C`, `B -> C`) of host agents
     on the in-memory network, default SWIM: seconds to full membership,
     the broadcast latency of one write, and the false positive after a
     5 s healthy soak (the agents' stores on the card, or the device
     named);
  1. 128 members (seed 2), converged, then 5 % crashed at once: ticks to
     full detection and the false positives after the churn;
  2. 1,000 members, fanout 3 (seed 3), suspicion 3, 6 and 9 ticks:
     converged, then one crash and the ticks until every live member
     downed it;
  3. 10,000 members (`LADDER_R3_N`), single device, bench widths (4
     feeds of n // 16), fingers seeds: the steady per-tick time, the
     converged tick (checked every 50) and 1 % crashed at once.

Each rung is a `ClusterSim` on the card (or the device named) driven as
the script drives the JAX one: the same seeds, the same warm-up steps
(they advance the rng chain), the same `_converge` and `_churn`, so the
ticks, detections and false positives are the JAX package's. Rung 4
(the sharded mesh) is not ported. One JSON line is printed per record;
the records are merged into `--out` (by `name`) only when that is
given. Run it as a module
from the repo root (`-m`): the package's own `random.py` must not
shadow the standard library's.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from corrosion_tpu_torch.models.cluster import ClusterSim
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.device import sync as device_sync
from corrosion_tpu_torch.runtime.records import merge_records

# the kernel rungs (the default); rung 0 runs when named
RUNGS = (1, 2, 3)

# the fields of a record that the JAX package's run fixes exactly
CHECKED = ("convergence_ticks", "detect_one_ticks", "detect_all_ticks",
           "churn_crashed", "false_positive", "false_positive_healthy",
           "false_positive_after_churn", "coverage")


def checked(rec: dict) -> tuple:
    """(rung key, the record's `CHECKED` fields): what a reference run
    must equal. Rung 2's key holds its suspicion ticks."""
    key = str(rec["rung"])
    if "suspicion_ticks" in rec:
        key += f"/{rec['suspicion_ticks']}"
    return key, {k: rec[k] for k in CHECKED if k in rec}


def emit(rung: int, name: str, **fields) -> dict:
    rec = {"rung": rung, "name": name, **fields}
    print(json.dumps(rec), flush=True)
    return rec


def sync(sim) -> None:
    """Wait for the sim's work on the card (nothing to wait for on the
    CPU)."""
    device_sync(sim.state.view.device)


def platform_of(sim) -> str:
    view = sim.state.view
    return "gpu" if view.is_cuda else view.device.type


def sim_factory(device) -> Callable:
    """`new(n, **kw)`: a `ClusterSim` on `device` (the card unless the
    CPU is named)."""
    dev = resolve_device(device)

    def new(n, **kw):
        return ClusterSim(n, device=dev, **kw)
    return new


def _converge(sim, target=0.999, max_ticks=3000, every=5):
    t0 = time.monotonic()
    tick = sim.run_until_stable(
        coverage_target=target, max_ticks=max_ticks, record_every=every
    )
    return tick, time.monotonic() - t0


def _churn(sim, frac: int, seed: int, max_extra: int) -> dict:
    """Crash 1/frac of the members at once; measure full cluster-wide
    detection and post-churn FP (the script's one churn methodology)."""
    n = sim.params.n
    rng = np.random.default_rng(seed)
    crashed = rng.choice(n, size=max(1, n // frac), replace=False)
    for m in crashed:
        sim.crash(int(m))
    det_ticks = sim.run_until_detected(
        detect_target=1.0, max_extra_ticks=max_extra
    )
    s2 = sim.stats()
    return {
        "churn_crashed": len(crashed),
        "detect_all_ticks": det_ticks,
        "false_positive_after_churn": s2["false_positive"],
    }


def rung0(device=None) -> List[dict]:
    """The script's rung 0: three in-process agents over `DevCluster`."""
    from corrosion_tpu_torch.agent.membership import SwimConfig
    from corrosion_tpu_torch.devcluster import DevCluster, Topology
    from corrosion_tpu_torch.net.mem import MemNetwork

    schema = (
        "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY,"
        " text TEXT NOT NULL DEFAULT '');"
    )

    async def main():
        cluster = DevCluster(
            Topology.parse("A -> C\nB -> C\n"),
            schema,
            network=MemNetwork(seed=1),
            swim_config=SwimConfig(),  # default params
            device=device,
        )
        await cluster.start()
        try:
            t = await cluster.wait_converged(timeout=60.0)
            lat = await cluster.measure_broadcast_latency(
                "A", "tests", 1, "ladder", timeout=60.0
            )
            # healthy soak: a false positive is anyone losing a member
            await asyncio.sleep(5.0)
            sizes = list(cluster.membership_counts().values())
            return [emit(
                0,
                "devcluster_3node_default_swim",
                convergence_s=round(t, 3),
                broadcast_latency_s=round(max(lat.values()), 3),
                false_positive=0.0 if all(s == 3 for s in sizes) else 1.0,
                platform="host-asyncio",
            )]
        finally:
            await cluster.stop()

    return asyncio.run(main())


def rung1(device=None, new_sim: Optional[Callable] = None) -> List[dict]:
    new_sim = new_sim or sim_factory(device)
    n = 128
    sim = new_sim(n, seed=2)
    sim.step()  # the script's compile step: it advances the rng chain
    tick, wall = _converge(sim)
    s = sim.stats()
    return [emit(
        1,
        "batched_128_churn5pct",
        n=n,
        convergence_ticks=tick,
        convergence_wall_s=wall,
        false_positive_healthy=s["false_positive"],
        platform=platform_of(sim),
        **_churn(sim, frac=20, seed=7, max_extra=300),
    )]


def rung2(device=None, new_sim: Optional[Callable] = None,
          suspicion=(3, 6, 9)) -> List[dict]:
    new_sim = new_sim or sim_factory(device)
    n = 1000
    out = []
    for susp in suspicion:
        sim = new_sim(n, seed=3, fanout=3, suspicion_ticks=susp)
        sim.step()
        tick, wall = _converge(sim)
        s = sim.stats()
        sim.crash(n - 1)
        det = sim.run_until_detected(1.0, max_extra_ticks=200)
        out.append(emit(
            2,
            "batched_1k_fanout3_suspect_sweep",
            n=n,
            suspicion_ticks=susp,
            convergence_ticks=tick,
            convergence_wall_s=wall,
            false_positive=s["false_positive"],
            detect_one_ticks=det,
            platform=platform_of(sim),
        ))
    return out


def rung3(device=None, new_sim: Optional[Callable] = None,
          n: Optional[int] = None) -> List[dict]:
    new_sim = new_sim or sim_factory(device)
    if n is None:
        n = int(os.environ.get("LADDER_R3_N", "10000"))
    # bench.py's boot-tuned configuration (W = n/4 feed bandwidth)
    sim = new_sim(
        n, seed=0, seed_mode="fingers",
        feeds_per_tick=4, feed_entries=max(25, n // 16),
        piggyback=4, incoming_slots=8, buffer_slots=12,
        probe_candidates=2, antientropy=1,
    )
    sim.step()
    sim.step(5)  # the first 5-tick chunk outside the clock
    sync(sim)
    t0 = time.monotonic()
    sim.step(5)
    sync(sim)
    per_tick = (time.monotonic() - t0) / 5
    tick, wall = _converge(sim, every=50)
    s = sim.stats()
    return [emit(
        3,
        "batched_10k_single_device",
        n=n,
        seed_mode="fingers",
        per_tick_s=per_tick,
        convergence_ticks=tick,
        convergence_wall_s=wall,
        coverage=s["coverage"],
        false_positive_healthy=s["false_positive"],
        platform=platform_of(sim),
        # 1 % crashed at once
        **_churn(sim, frac=100, seed=11, max_extra=400),
    )]


RUNG_FNS = {0: rung0, 1: rung1, 2: rung2, 3: rung3}


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rungs", nargs="*", type=int, choices=(0,) + RUNGS,
                    help="rungs to run (default: 1 2 3)")
    ap.add_argument("--out", help="merge the records into this JSON list "
                                  "file (by their 'name')")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    results = []
    for r in args.rungs or RUNGS:
        results += RUNG_FNS[r]()
    if args.out:
        merge_records(args.out, results, key="name")
    print(json.dumps({"ladder_wall_s": time.monotonic() - t0,
                      "out": args.out}))
    return results


if __name__ == "__main__":
    main()
