"""The per-PR pview smoke on the card — the port's copy of
`scripts/bench_smoke.py`.

    python -m corrosion_tpu_torch.bench_smoke [--n 2048] [--slots 256]
        [--max-ticks 600] [--skip-churn] [--out PATH]

The script's workload: `PViewClusterSim(n, slots=K, seed=0,
seed_mode="fingers", feeds_per_tick=4, feed_entries=max(16, K // 16),
tie_epoch=512)` boots to the four-term bar through
`run_until_converged_device(max_ticks, check_every=25)`, then 1 % of
its members crash (`default_rng(7).choice(n, n // 100)`, `crash_many`)
and it steps 25 ticks at a time, reading `stats()` after each, until
every crash is detected with FP 0 (at most `max_ticks` more ticks).

The script's warm-up is an XLA compile on a throwaway sim; here a
throwaway sim of the same shapes (seed 1) ticks twice and reads its
stats, so every op of the measured path has launched once before the
clock starts (`warm_s`).

One JSON line is printed: the script's record (its `detail` fields,
`platform` "gpu") plus the card's name and power limit, and the
unrounded stats and event totals. It is written to `--out` only when
that is given, never to a banked `BENCH_PR<tag>.json`. Run it as a
module from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from corrosion_tpu_torch.models.cluster import PViewClusterSim
from corrosion_tpu_torch.pview_converge import stats_row
from corrosion_tpu_torch.runtime.device import card_line, resolve_device, sync

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MEASURED_FILES = (
    "corrosion_tpu_torch/ops/swim_pview.py",
    "corrosion_tpu_torch/ops/swim.py",
    "corrosion_tpu_torch/models/cluster.py",
)


def code_fingerprint() -> dict:
    out = {}
    for rel in _MEASURED_FILES:
        with open(os.path.join(_ROOT, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()[:12]
    return out



def new_sim(n: int, slots: int, seed: int, device) -> PViewClusterSim:
    """The script's sim (scripts/bench_smoke.py:84-87)."""
    return PViewClusterSim(
        n, slots=slots, seed=seed, seed_mode="fingers", device=device,
        feeds_per_tick=4, feed_entries=max(16, slots // 16), tie_epoch=512,
    )


def run(n: int = 2048, slots: int = 256, max_ticks: int = 600,
        skip_churn: bool = False, device=None) -> dict:
    """The script's workload on one device; returns its record."""
    dev = resolve_device(device)
    code_sha = code_fingerprint()  # at run start, as the script
    t0 = time.monotonic()
    sim = new_sim(n, slots, 0, dev)
    sync(dev)
    init_s = time.monotonic() - t0

    t0 = time.monotonic()
    warm = new_sim(n, slots, 1, dev)
    warm.step(2)  # every op of the measured path, outside the clock
    warm.stats()
    del warm
    sync(dev)
    warm_s = time.monotonic() - t0

    t0 = time.monotonic()
    stable_tick = sim.run_until_converged_device(max_ticks=max_ticks,
                                                 check_every=25)
    boot_wall = time.monotonic() - t0
    stats = sim.stats()

    det_ticks = None
    churn_wall = 0.0
    cs = {}
    n_kill = max(1, n // 100)
    if skip_churn:
        n_kill = 0
    elif stable_tick is not None:
        kill = np.random.default_rng(7).choice(n, size=n_kill, replace=False)
        sim.crash_many(kill)
        t0 = time.monotonic()
        base = sim.ticks
        while sim.ticks - base < max_ticks:
            sim.step(25)
            cs = sim.stats()
            if cs["detected"] >= 1.0 and cs["false_positive"] == 0.0:
                det_ticks = sim.ticks - base
                break
        churn_wall = time.monotonic() - t0

    return {
        "metric": f"pview_smoke_n{n}_k{slots}",
        "value": round(boot_wall, 3),
        "unit": "s",
        "detail": {
            "n": n,
            "slots": slots,
            "seed_mode": "fingers",
            "tick_mode": sim.params.tick_mode,
            "gossip_mode": sim.params.gossip_mode,
            "init_s": round(init_s, 2),
            "warm_s": round(warm_s, 2),
            "stable_tick": stable_tick,
            "boot_wall_s": round(boot_wall, 3),
            "churn_killed": n_kill,
            "churn_detect_all_ticks": det_ticks,
            "churn_wall_s": round(churn_wall, 3),
            "stats": {m: round(float(v), 6) for m, v in stats.items()},
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            **card_line(dev),
            "code_sha": code_sha,
            "measured_at": time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()),
            "raw": {"stats": stats, "churn_stats": cs,
                    "events": sim.state.events.cpu().numpy()
                    .astype(np.uint32).tolist()},
        },
    }


def ok(rec: dict) -> bool:
    """The script's exit rule."""
    det = rec["detail"]
    return det["stable_tick"] is not None and (
        det["churn_killed"] == 0 or det["churn_detect_all_ticks"] is not None)


def checked(rec: dict) -> tuple:
    """What a reference run must equal: the stable tick, its six stats,
    the detection ticks, the stats there and the 14 event totals."""
    det = rec["detail"]
    raw = det["raw"]
    return (det["stable_tick"], stats_row(raw["stats"]),
            det["churn_detect_all_ticks"], stats_row(raw["churn_stats"]),
            tuple(raw["events"]))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--max-ticks", type=int, default=600)
    ap.add_argument("--skip-churn", action="store_true")
    ap.add_argument("--out", help="write the record to this JSON file")
    args = ap.parse_args(argv)
    rec = run(args.n, args.slots, args.max_ticks, args.skip_churn)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    sys.exit(0 if ok(main()) else 1)
