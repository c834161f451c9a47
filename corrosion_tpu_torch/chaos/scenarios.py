"""Composable chaos scenarios over the three fault layers.

The port's copy of `corrosion_tpu/chaos/scenarios.py`.

An `Injection` is one revertible knob turn at one layer:

- NETWORK — `net/mem.py`'s knobs composed into shapes the single knobs
  can't express: geo-latency matrices (per-directed-link delay),
  asymmetric partitions (`partition_oneway` — the half-open link),
  flap storms (a driver task partitioning/healing on a beat).
- STORE — `chaos/faults.py::StoreFaults` profiles installed on a
  node's `CrdtStore` (slow disk: commit/apply latency; sick disk:
  transient SQLITE_BUSY + I/O errors).
- PROCESS — zombie nodes (`MemNetwork.zombie`: sockets open, event
  loop stalled, nothing ever answers) and kill/restart churn (driver
  task calling harness-supplied stop/start callables, so the restart
  rides the real r17 catch-up plane).

A `Scenario` is a named list of injections; the `ChaosEngine` applies
them, runs their driver tasks, and reverts everything on `restore()` —
registering each step in the process-global `CENSUS` so `/v1/status`
can tell an operator this is a drill.  Scenario shapes follow Potato
(arXiv:2308.12698) heterogeneous/slow-node scenarios and the Prime CCL
(arXiv:2505.14065) bar: every injection must DEGRADE the serving
plane, never deadlock or restart it.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.chaos.faults import CENSUS, StoreFaults

_inj_seq = itertools.count(1)


@dataclass
class Injection:
    """One revertible fault. `driver`, when set, is a coroutine factory
    run as a background task for the injection's lifetime (flap storms,
    churn loops); it is cancelled before `revert` runs."""

    layer: str  # "net" | "store" | "process"
    summary: str
    apply: Callable[[], None]
    revert: Callable[[], None]
    driver: Optional[Callable[[], Awaitable[None]]] = None
    inj_id: str = field(default_factory=lambda: f"inj-{next(_inj_seq)}")


@dataclass
class Scenario:
    scenario_id: str
    injections: List[Injection]


class ChaosEngine:
    """Applies/reverts one scenario at a time and owns its driver tasks.

    `restore()` is the recovery edge every scenario's SLO must return
    to baseline after — the engine guarantees every knob it turned is
    turned back, in reverse order, even when a driver task died."""

    def __init__(self) -> None:
        self._active: Optional[Scenario] = None
        self._tasks: List[asyncio.Task] = []

    @property
    def active(self) -> Optional[str]:
        return self._active.scenario_id if self._active else None

    async def apply(self, scenario: Scenario) -> None:
        if self._active is not None:
            raise RuntimeError(
                f"scenario {self._active.scenario_id!r} still active"
            )
        CENSUS.begin(scenario.scenario_id)
        self._active = scenario
        for inj in scenario.injections:
            inj.apply()
            CENSUS.add(inj.inj_id, f"[{inj.layer}] {inj.summary}", inj.layer)
            if inj.driver is not None:
                self._tasks.append(asyncio.ensure_future(inj.driver()))

    async def restore(self) -> None:
        if self._active is None:
            return
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._tasks.clear()
        for inj in reversed(self._active.injections):
            inj.revert()
            CENSUS.remove(inj.inj_id)
        self._active = None
        CENSUS.end()


# -- injection builders ------------------------------------------------------


def geo_latency(
    net, regions: Dict[str, str], matrix: Dict[Tuple[str, str], float]
) -> Injection:
    """Geo-latency matrix: `regions` maps node addr -> region label,
    `matrix` maps (region, region) -> one-way delay.  Intra-region
    pairs absent from the matrix stay at LAN speed."""

    def apply() -> None:
        for a, ra in regions.items():
            for b, rb in regions.items():
                if a == b:
                    continue
                delay = matrix.get((ra, rb), matrix.get((rb, ra), 0.0))
                if delay:
                    net.set_link_latency(a, b, delay, symmetric=False)

    def revert() -> None:
        net.clear_link_latency()

    return Injection(
        layer="net",
        summary=f"geo-latency matrix over {len(regions)} nodes",
        apply=apply,
        revert=revert,
    )


def asymmetric_partition(net, src: str, dsts: Sequence[str]) -> Injection:
    """Half-open link: `src`'s traffic toward each dst is dropped while
    the reverse direction still flows."""

    def apply() -> None:
        for d in dsts:
            net.partition_oneway(src, d)

    def revert() -> None:
        for d in dsts:
            net.heal(src, d)

    return Injection(
        layer="net",
        summary=f"asymmetric partition {src} -/-> {len(dsts)} peers",
        apply=apply,
        revert=revert,
    )


def flap_storm(
    net, a: str, b: str, period_secs: float = 0.5
) -> Injection:
    """Link flapping: the a<->b link partitions and heals on a beat —
    the pathology that used to synchronize rejoin storms (the r9
    full-jitter announcer fix exists because of it)."""

    async def drive() -> None:
        try:
            while True:
                net.partition(a, b)
                await asyncio.sleep(period_secs)
                net.heal(a, b)
                await asyncio.sleep(period_secs)
        finally:
            net.heal(a, b)

    return Injection(
        layer="net",
        summary=f"flap storm {a}<->{b} @ {period_secs}s",
        apply=lambda: None,
        revert=lambda: net.heal(a, b),
        driver=drive,
    )


def zombie_node(net, addr: str) -> Injection:
    """Process-layer zombie: event loop stalled, sockets open (see
    MemNetwork.zombie)."""

    return Injection(
        layer="process",
        summary=f"zombie {addr} (sockets open, loop stalled)",
        apply=lambda: net.zombie(addr),
        revert=lambda: net.restore(addr),
    )


def churn_storm(
    nodes: Sequence[str],
    stop: Callable[[str], Awaitable[None]],
    start: Callable[[str], Awaitable[None]],
    period_secs: float = 1.0,
) -> Injection:
    """Kill/restart churn: cycles through `nodes`, stopping one, waiting
    a beat, restarting it (through the harness's real boot path, so the
    rejoin rides the r17 catch-up plane), then the next.  The revert
    guarantee is that every node it stopped has been started again."""

    downed: List[str] = []

    async def drive() -> None:
        i = 0
        try:
            while True:
                node = nodes[i % len(nodes)]
                i += 1
                downed.append(node)
                await stop(node)
                await asyncio.sleep(period_secs)
                await start(node)
                downed.remove(node)
                await asyncio.sleep(period_secs)
        finally:
            # restore() cancels this driver mid-cycle: restart anything
            # still down so the revert edge leaves the cluster whole
            # (shielded — the restart must survive the cancellation)
            for node in list(downed):
                with contextlib.suppress(Exception):
                    await asyncio.shield(start(node))
                downed.remove(node)

    return Injection(
        layer="process",
        summary=f"churn storm over {len(nodes)} nodes @ {period_secs}s",
        apply=lambda: None,
        revert=lambda: None,
        driver=drive,
    )


def slow_disk(store, latency_secs: float = 0.05) -> Injection:
    """Slow disk: every commit and remote apply pays `latency_secs` of
    injected fsync time on the worker thread."""

    def apply() -> None:
        store.chaos = StoreFaults(
            commit_latency_secs=latency_secs,
            apply_latency_secs=latency_secs,
        )

    def revert() -> None:
        store.chaos = None

    return Injection(
        layer="store",
        summary=f"slow disk (+{latency_secs * 1000:.0f}ms commit/apply)",
        apply=apply,
        revert=revert,
    )


def sick_disk(
    store,
    busy_rate: float = 0.05,
    io_error_rate: float = 0.02,
    seed: int = 0,
) -> Injection:
    """Sick disk: transient SQLITE_BUSY per writer statement and disk
    I/O errors at COMMIT — the writers must fail typed and isolated,
    the store must stay writable."""

    def apply() -> None:
        store.chaos = StoreFaults(
            statement_busy_rate=busy_rate,
            commit_io_error_rate=io_error_rate,
            seed=seed,
        )

    def revert() -> None:
        store.chaos = None

    return Injection(
        layer="store",
        summary=(
            f"sick disk (busy {busy_rate:.0%}, io {io_error_rate:.0%})"
        ),
        apply=apply,
        revert=revert,
    )
