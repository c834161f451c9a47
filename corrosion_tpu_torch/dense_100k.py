"""The north-star scale on one card: 100,000 members on the dense tick,
run to convergence (coverage >= 0.999 with FP 0) — the port's copy of
`scripts/dense_100k.py`.

    python -m corrosion_tpu_torch.dense_100k [n] [chunk] [--out PATH]
                                                 (default 100000 25)

The reference runs the program on an 8-device member mesh; one H100
holds the whole int16 [N, N] view (2x10^10 B at n=100,000), so here it
runs unsharded. The program is the script's: its parameters (16 feeds
of max(25, n // 64) entries, piggyback 4, 8 incoming slots, 12 buffer
slots, 2 probe candidates, antientropy 1, shift gossip), fingers seeds
from `PRNGKey(0)`, then `PRNGKey(1)` split once per `chunk`-tick
dispatch of `swim.tick_n` (the unsharded counterpart of the reference's
`sharded_tick(params, mesh, k=chunk)`), with `membership_stats` after
every chunk, up to 400 ticks. The first dispatch stays outside the
timed window.

One JSON line is printed: the script's record (`n_devices` 1, its
per-tick time as `ms_per_tick`) plus the card's name and power limit and
the run's peak device memory. It is merged into `--out` (by `name`)
only when that is given. Run it as a module from the repo root (`-m`):
the package's own `random.py` must not shadow the standard library's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim
from corrosion_tpu_torch.runtime.device import card_line, resolve_device, sync
from corrosion_tpu_torch.runtime.records import merge_records

MAX_TICKS = 400


def dense_params(n: int, feeds: Optional[int] = None) -> swim.SwimParams:
    """The script's parameters (scripts/dense_100k.py:68-72): `feeds`
    windows of max(25, n // (4 * feeds)) entries per tick, W = n/4 feed
    bandwidth; `feeds` defaults to DENSE_100K_FEEDS or 16."""
    if feeds is None:
        feeds = int(os.environ.get("DENSE_100K_FEEDS", "16"))
    return swim.SwimParams(
        n=n, feeds_per_tick=feeds, feed_entries=max(25, n // (4 * feeds)),
        piggyback=4, incoming_slots=8, buffer_slots=12, probe_candidates=2,
        antientropy=1,
    )



def run(n: int = 100_000, chunk: int = 25, device=None,
        on_chunk: Optional[Callable] = None, log=print) -> dict:
    """The script's program on one device; returns its record.
    `on_chunk(ticks, state)` is called after every dispatch, the first
    one included (the tick updates the view in place: copy what must
    outlive the call)."""
    dev = resolve_device(device)
    params = dense_params(n)
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's stats exist only after it
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    state = swim.init_state(params, jr.PRNGKey(0), seed_mode="fingers",
                            device=dev)
    sync(dev)
    init_s = time.monotonic() - t0
    log(f"init {init_s:.1f}s")

    rng = jr.PRNGKey(1)
    t0 = time.monotonic()
    rng, key = jr.split(rng)
    state = swim.tick_n(state, key, params, chunk)
    sync(dev)
    first_s = time.monotonic() - t0
    log(f"first-dispatch {first_s:.1f}s")
    ticks = chunk
    if on_chunk is not None:
        on_chunk(ticks, state)

    t0 = time.monotonic()
    stats = {"coverage": 0.0, "detected": 0.0, "false_positive": 1.0}
    history = []  # (ticks, coverage, false_positive) per check
    converged = False
    while ticks < MAX_TICKS:
        rng, key = jr.split(rng)
        state = swim.tick_n(state, key, params, chunk)
        ticks += chunk
        if on_chunk is not None:
            on_chunk(ticks, state)
        stats = swim.membership_stats(state)  # ends in a readback
        history.append((ticks, stats["coverage"], stats["false_positive"]))
        log(f"tick {ticks}: coverage {stats['coverage']:.6f} "
            f"fp {stats['false_positive']}")
        if stats["coverage"] >= 0.999 and stats["false_positive"] == 0.0:
            converged = True
            break
    loop_s = time.monotonic() - t0
    measured = ticks - chunk  # ticks after the first dispatch
    events = state.events.cpu().numpy().astype("uint32").tolist()
    return {
        "rung": 5,
        # n in the name: a run at another size never replaces this one
        "name": f"dense_convergence_n{n}",
        "n": n,
        "n_devices": 1,
        "chunk": chunk,
        "feeds_per_tick": params.feeds_per_tick,
        "feed_entries": params.feed_entries,
        "seed_mode": "fingers",
        "view_dtype": "int16",
        "init_s": init_s,
        "compile_s": first_s,
        "ms_per_tick": 1e3 * loop_s / max(1, measured),
        "convergence_ticks": ticks,
        "convergence_wall_s": loop_s + first_s,
        "coverage": stats["coverage"],
        "detected": stats["detected"],
        "false_positive": stats["false_positive"],
        "converged": converged,
        "history": history,
        "events": events,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        **card_line(dev),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100_000)
    ap.add_argument("chunk", nargs="?", type=int, default=25)
    ap.add_argument("--out", help="merge the record into this JSON list "
                                  "file (by its 'name')")
    args = ap.parse_args(argv)
    rec = run(args.n, args.chunk, log=lambda s: print(s, flush=True))
    if args.out:
        merge_records(args.out, [rec], key="name")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    sys.exit(0 if main()["converged"] else 1)
