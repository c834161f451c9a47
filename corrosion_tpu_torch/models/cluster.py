"""ClusterSim: drive the batched SWIM tick as a simulated devcluster.

The counterpart of `corrosion_tpu/models/cluster.py::ClusterSim`: n
members advance as tensor rows through `ops.swim`, on the card unless
`device="cpu"` is asked for. The rng chain is the reference's, so a
simulation from the same seed follows the same trajectory tick for tick.

Each stats readback also drains the device telemetry lane and the flight
ring, as the reference computes them: `last_event_delta` holds the uint32
growth of the event totals since the previous drain, and `last_flight`
the latest `FlightDrain`. Publishing them into a metrics registry, a
flight recorder and trace spans is not part of this port yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import _build, swim
from corrosion_tpu_torch.runtime.device import resolve_device


@dataclass
class TickMetrics:
    tick: int
    coverage: float
    detected: float
    false_positive: float
    wall_s: float


class ClusterSim:
    """A simulated SWIM cluster of `n` members on one device."""

    def __init__(
        self,
        n: int,
        seed: int = 0,
        seeds_per_member: int = 3,
        seed_mode: str = "ring",
        device=None,
        **param_overrides,
    ):
        self.device = resolve_device(device)
        self.params = swim.SwimParams(n=n, **param_overrides)
        self._rng = jr.PRNGKey(seed)
        self._rng, init_key = jr.split(self._rng)
        self.state = swim.init_state(
            self.params, init_key, seeds_per_member, seed_mode, self.device
        )
        self.history: List[TickMetrics] = []
        self.ticks = 0  # host-side mirror of state.t (no device readback)
        self._ev_prev = np.zeros(swim.N_EVENTS, dtype=np.uint32)
        self._flight_next = 0  # flight cursor: first tick not yet drained
        self.last_event_delta = np.zeros(swim.N_EVENTS, dtype=np.uint32)
        self.last_flight: Optional[swim.FlightDrain] = None

    def _drain(self, ev: np.ndarray, flight: swim.FlightDrain) -> None:
        """Take the event lane's wrap-safe uint32 growth since the last
        drain and the latest flight ring."""
        self.last_event_delta = (ev - self._ev_prev).astype(np.uint32)
        self._ev_prev = ev
        self.last_flight = flight
        self._flight_next = flight.t

    def step(self, ticks: int = 1) -> None:
        """Advance `ticks` protocol periods (no host sync)."""
        self._rng, key = jr.split(self._rng)
        if ticks == 1:
            self.state = swim.tick_impl(self.state, key, self.params)
        else:
            self.state = swim.tick_n(self.state, key, self.params, ticks)
        self.ticks += ticks

    def crash(self, member: int) -> None:
        self.state = swim.set_alive(self.state, member, False)

    def restart(self, member: int) -> None:
        self.state = swim.set_alive(self.state, member, True)

    def degrade(self, members, loss: float = 0.0, lag: int = 0) -> None:
        """Degraded-node fault injection: flaky, not dead (loss=0, lag=0
        restores)."""
        self.state = swim.set_degraded(self.state, members, loss, lag)

    def stats(self) -> Dict[str, float]:
        """Convergence stats; drains the event lane and the flight ring in
        the same readback."""
        s, ev, fl = swim.stats_and_events(self.state)
        self._drain(ev, fl)
        return s

    def run_until_stable(
        self,
        coverage_target: float = 0.999,
        max_ticks: int = 10_000,
        record_every: int = 1,
        fine_every: Optional[int] = None,
        fine_threshold: float = 0.9,
    ) -> Optional[int]:
        """Advance up to `max_ticks` further ticks until live-member
        coverage reaches the target, checking every `record_every` ticks
        (`fine_every` once coverage passes `fine_threshold`); returns the
        tick at stability or None, and records the history."""
        start = time.monotonic()
        done = 0
        step_size = record_every
        while done < max_ticks:
            batch = min(step_size, max_ticks - done)
            self.step(batch)
            done += batch
            s = self.stats()
            self.history.append(
                TickMetrics(
                    tick=self.ticks,
                    coverage=s["coverage"],
                    detected=s["detected"],
                    false_positive=s["false_positive"],
                    wall_s=time.monotonic() - start,
                )
            )
            if s["coverage"] >= coverage_target:
                return self.ticks
            if fine_every is not None and s["coverage"] >= fine_threshold:
                step_size = fine_every
        return None

    def run_until_stable_device(
        self,
        coverage_target: float = 0.999,
        max_ticks: int = 10_000,
        check_every: int = 5,
    ) -> Optional[int]:
        """Tick in `check_every`-tick chunks with one coverage readback per
        chunk (swim.run_to_coverage); returns the absolute tick at
        stability, rounded up to `check_every`, or None."""
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self._rng, key = jr.split(self._rng)
        limit = self.ticks + max_ticks
        self.state, cov = swim.run_to_coverage(
            self.state, key, self.params,
            float(coverage_target), int(check_every), int(limit),
        )
        # one readback: the telemetry lane and the flight ring the loop
        # accumulated while it ran unobserved
        ev, fl = swim.events_and_flight(self.state)
        self.ticks = fl.t
        self._drain(ev, fl)
        # the verdict compares in float32, as the loop's predicate did
        return self.ticks if cov >= np.float32(coverage_target) else None

    def warm_device_loop(
        self,
        coverage_target: float = 0.999,
        max_ticks: int = 10_000,
        check_every: int = 5,
    ) -> None:
        """Prepare `run_until_stable_device` without advancing a tick:
        build the kernels its path launches (the CUDA inbox kernel when
        `inbox_impl="cuda"` runs on the card), then run the loop on a
        state already at its tick limit, which runs no tick."""
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.device.type == "cuda" and self.params.inbox_impl == "cuda":
            _build.load("inbox")
        limit = self.ticks + max_ticks
        capped = self.state._replace(t=torch.full_like(self.state.t, limit))
        out, _ = swim.run_to_coverage(
            capped, jr.PRNGKey(0), self.params,
            float(coverage_target), int(check_every), int(limit),
        )
        self.state = out._replace(t=torch.full_like(out.t, self.ticks))

    def run_until_detected(
        self, detect_target: float = 1.0, max_extra_ticks: int = 200
    ) -> Optional[int]:
        """After a crash, advance until every live member marked the dead
        ones down; returns ticks taken or None."""
        for i in range(1, max_extra_ticks + 1):
            self.step()
            if self.stats()["detected"] >= detect_target:
                return i
        return None
