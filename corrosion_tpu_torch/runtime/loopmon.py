"""Event-loop instrumentation — the asyncio analog of tokio-metrics.

The port's copy of `corrosion_tpu/runtime/loopmon.py`.

The reference samples its tokio runtime every 5 s and publishes worker/
scheduling gauges (`klukai/src/command/agent.rs:29-63`: park counts,
steal counts, queue depths, `corro.tokio.*`). asyncio has no worker pool,
so the translation keeps what is diagnosable on a single-threaded loop:

  corro.runtime.loop.lag.seconds       sampled scheduling lag histogram —
                                       sleep(dt) vs actual wakeup delta;
                                       the single most useful stall signal
  corro.runtime.loop.lag.max.seconds   gauge: worst lag in the last window
  corro.runtime.loop.tasks.alive       gauge: len(asyncio.all_tasks())
  corro.runtime.loop.ticks             counter: monitor wakeups

The thread-pool analogs of tokio's stealing/park metrics
(corro.tokio.total_steal_count etc.) have no asyncio counterpart and are
itemized as inapplicable in COMPONENTS.md §metrics.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

SAMPLE_INTERVAL = 0.5
REPORT_EVERY = 10  # samples per max-lag window (≈5 s, agent.rs:63 cadence)


async def loop_lag_monitor(
    tripwire=None,
    interval: float = None,
    report_every: int = None,
    registry=None,
    max_samples: int = None,
) -> None:
    """Run forever (until cancelled, tripped, or `max_samples` — the
    test hook), publishing loop health.  The r20 alerting plane rides
    on the gauges published here: the TSDB samples
    `corro.runtime.loop.lag.max.seconds` into its rings, the
    `loop-lag` default rule thresholds it, and the alert engine's
    Lifeguard health score reads it back to widen for-durations."""
    interval = SAMPLE_INTERVAL if interval is None else interval
    report_every = REPORT_EVERY if report_every is None else report_every
    registry = METRICS if registry is None else registry
    lag_hist = registry.histogram("corro.runtime.loop.lag.seconds")
    lag_max = registry.gauge("corro.runtime.loop.lag.max.seconds")
    tasks_g = registry.gauge("corro.runtime.loop.tasks.alive")
    ticks = registry.counter("corro.runtime.loop.ticks")
    window_max = 0.0
    i = 0
    while tripwire is None or not tripwire.tripped:
        t0 = time.monotonic()
        await asyncio.sleep(interval)
        lag = max(0.0, time.monotonic() - t0 - interval)
        lag_hist.observe(lag)
        window_max = max(window_max, lag)
        ticks.inc()
        i += 1
        if i % report_every == 0:
            lag_max.set(window_max)
            window_max = 0.0
            tasks_g.set(len(asyncio.all_tasks()))
        if max_samples is not None and i >= max_samples:
            return


def start(tracker, tripwire=None) -> Optional[asyncio.Task]:
    """Spawn the monitor on the agent's task tracker (spawn_counted)."""
    return tracker.spawn(loop_lag_monitor(tripwire))
