"""The true convergence tick of the bench configuration for one
`feeds_per_tick`, on the card — the port's copy of
`scripts/feed_sweep.py`.

    python -m corrosion_tpu_torch.feed_sweep <feeds> [n] [start] [step]
                                             [stop] [--out PATH]
                                        (default 10000 70 10 300)

The bench's widths with `feeds` windows of max(25, n // (4 * feeds))
entries: a warm-up sim (seed 1) takes one `step`-tick chunk, then the
measured sim (seed 0) steps `step` ticks at a time and reads its stats
only from tick `start` on (the probe stays cheap), until coverage
reaches 0.999 or `stop` ticks ran. One line is printed; it is appended
to `--out` only when that is given. Run it as a module from the repo
root (`-m`).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

from corrosion_tpu_torch.scale_ladder import sim_factory, sync


def params_for(n: int, feeds: int) -> dict:
    return dict(
        feeds_per_tick=feeds, feed_entries=max(25, n // (4 * feeds)),
        piggyback=4, incoming_slots=8, buffer_slots=12, probe_candidates=2,
        antientropy=1,
    )


def run(feeds: int, n: int = 10_000, start: int = 70, step: int = 10,
        stop: int = 300, device=None,
        new_sim: Optional[Callable] = None) -> str:
    """The sweep's line for `feeds`. `new_sim(n, **params)` makes the
    sims (default: a `ClusterSim` on `device`)."""
    new_sim = new_sim or sim_factory(device)
    params = params_for(n, feeds)
    fe = params["feed_entries"]
    # one chunk length for every dispatch, as the script
    warm = new_sim(n, seed=1, **params)
    warm.step(step)
    warm.stats()
    del warm

    sim = new_sim(n, seed=0, **params)
    sync(sim)
    t0 = time.monotonic()
    ticks = 0
    while ticks < stop:
        sim.step(step)
        ticks += step
        if ticks < start:
            continue
        sync(sim)  # the wall ends with the device's work, not its enqueue
        wall = time.monotonic() - t0
        s = sim.stats()
        if s["coverage"] >= 0.999:
            return (f"n={n} feeds={feeds} fe={fe}: tick={ticks} "
                    f"tick_wall={wall:.1f}s cov={s['coverage']:.5f} "
                    f"fp={s['false_positive']}")
    return f"n={n} feeds={feeds} fe={fe}: NOT converged by {ticks}"


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("feeds", type=int)
    ap.add_argument("n", nargs="?", type=int, default=10_000)
    ap.add_argument("start", nargs="?", type=int, default=70)
    ap.add_argument("step", nargs="?", type=int, default=10)
    ap.add_argument("stop", nargs="?", type=int, default=300)
    ap.add_argument("--out", help="append the line to this file")
    args = ap.parse_args(argv)
    line = run(args.feeds, args.n, args.start, args.step, args.stop)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return line


if __name__ == "__main__":
    main()
