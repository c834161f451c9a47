"""Ticks to coverage and ms per tick of the dense tick on the card — the
port's copy of `scripts/convergence_probe.py`.

    python -m corrosion_tpu_torch.convergence_probe [n] [feeds] [chunk]
                                (default 4096, max(4, n // 1250), 10)

A `ClusterSim(n, seed=0, feeds_per_tick=feeds)` (the kernel's defaults
otherwise) takes one warm-up tick, then `chunk`-tick steps with a stats
readback after each: one line per chunk with the tick, coverage, FP and
the cumulative wall seconds, until coverage reaches PROBE_COVERAGE
(0.999) or PROBE_MAX_TICKS (2000) ticks ran. Used to compare kernel
variants: ticks to converge must not regress when the tick gets cheaper.
Run it as a module from the repo root (`-m`).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Sequence

from corrosion_tpu_torch.scale_ladder import platform_of, sim_factory, sync


def run(n: int = 4096, feeds: Optional[int] = None, chunk: int = 10,
        device=None, new_sim: Optional[Callable] = None,
        log=print) -> Optional[int]:
    """The probe; returns the tick at which coverage reached the target,
    or None. `new_sim(n, **params)` makes the sim (default: a
    `ClusterSim` on `device`)."""
    feeds = feeds if feeds is not None else max(4, n // (25 * 50))
    target = float(os.environ.get("PROBE_COVERAGE", "0.999"))
    max_ticks = int(os.environ.get("PROBE_MAX_TICKS", "2000"))
    new_sim = new_sim or sim_factory(device)
    sim = new_sim(n, seed=0, feeds_per_tick=feeds)
    sim.step()  # warm-up: the first launches of every op
    sync(sim)
    log(f"platform={platform_of(sim)} n={n} feeds={feeds}")
    t0 = time.monotonic()
    done = 0
    while done < max_ticks:
        sim.step(chunk)
        done += chunk
        s = sim.stats()  # ends in a readback
        el = time.monotonic() - t0
        log(f"tick={sim.ticks:5d} cov={s['coverage']:.5f} "
            f"fp={s['false_positive']:.6f} wall={el:8.2f}s "
            f"({el / done * 1000:7.1f} ms/tick)")
        if s["coverage"] >= target:
            log(f"CONVERGED tick={sim.ticks} wall={el:.2f}s")
            return sim.ticks
    log("DID NOT CONVERGE")
    return None


def main(argv: Optional[Sequence[str]] = None) -> Optional[int]:
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else 4096
    feeds = int(argv[1]) if len(argv) > 1 else None
    chunk = int(argv[2]) if len(argv) > 2 else 10
    return run(n, feeds, chunk, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
