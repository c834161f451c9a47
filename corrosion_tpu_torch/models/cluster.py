"""Simulation drivers: the counterparts of `corrosion_tpu/models/
cluster.py`'s `ClusterSim` (the dense tick, `ops.swim`), `PViewClusterSim`
(the partial-view tick, `ops.swim_pview`) and the Lifeguard A/B harness
`flaky_node_ab`; and `cluster_observatory_scenario`, the JAX module's
agent-level observatory episode on the port's agents.

n members advance as tensor rows, on the card unless `device="cpu"` is
asked for. The rng chain is the reference's, so a simulation from the
same seed follows the same trajectory tick for tick.

Each stats readback also drains the device telemetry lane and the flight
ring, and publishes them as the reference does: the event totals' uint32
growth since the previous drain into
`corro.kernel.events.total{kernel, event}` of the process-global
`runtime.metrics.METRICS`, and the new per-tick frames into the
process-global `runtime.records.FLIGHT`, each inside a `runtime.trace`
span. `last_event_delta` and `last_flight` keep the latest drain.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import _build, swim, swim_pview
from corrosion_tpu_torch.runtime import trace
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.metrics import (
    KERNEL_EVENTS,
    record_kernel_events,
    record_phase_seconds,
)
from corrosion_tpu_torch.runtime.records import FLIGHT, FlightRecorder


@dataclass
class TickMetrics:
    tick: int
    coverage: float
    detected: float
    false_positive: float
    wall_s: float


class _Drains:
    """The telemetry drain both simulation drivers share. `flight` is the
    recorder the frames go to: the process-global `FLIGHT` unless a
    caller gives the sim a recorder of its own."""

    kernel = ""
    flight: FlightRecorder = FLIGHT

    def _reset_drain(self) -> None:
        self._ev_prev = np.zeros(swim.N_EVENTS, dtype=np.uint32)
        self._flight_next = 0  # flight cursor: first tick not yet drained
        self.last_event_delta = np.zeros(swim.N_EVENTS, dtype=np.uint32)
        self.last_flight: Optional[swim.FlightDrain] = None

    def _drain(self, ev: np.ndarray, flight: swim.FlightDrain) -> None:
        """Publish the event lane's growth since the last drain (the
        device totals wrap mod 2^32, so the uint32 difference is exact
        while one drain window stays under 2^32 events) and the ring's new
        frames, each in a span, and keep both."""
        self.last_event_delta = (ev - self._ev_prev).astype(np.uint32)
        self._ev_prev = ev
        with trace.span("sim.events.publish", kernel=self.kernel):
            record_kernel_events(self.kernel, self.last_event_delta.tolist())
        self.last_flight = flight
        with trace.span("sim.flight.drain", kernel=self.kernel,
                        tick=flight.t):
            self.flight.record_ring(self.kernel, flight,
                                    since=self._flight_next)
        self._flight_next = flight.t


class ClusterSim(_Drains):
    """A simulated SWIM cluster of `n` members on one device."""

    kernel = "dense"

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
        self._reset_drain()

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


class PViewClusterSim(_Drains):
    """A simulated cluster on the bounded partial-view tick: the driver
    shape of `ClusterSim` past the dense view's memory wall. Convergence
    is the four-term bar of `swim_pview.run_to_converged`.

    `step` publishes its wall seconds per tick, measured after a
    synchronize on the card, as
    `corro.kernel.phase.seconds{kernel="pview", phase="tick"}`."""

    kernel = "pview"

    def __init__(
        self,
        n: int,
        slots: int = 1024,
        seed: int = 0,
        seed_mode: str = "fingers",
        device=None,
        **param_overrides,
    ):
        self.device = resolve_device(device)
        self.params = swim_pview.PViewParams(n=n, slots=slots,
                                             **param_overrides)
        self._rng = jr.PRNGKey(seed)
        self._rng, init_key = jr.split(self._rng)
        self.state = swim_pview.init_state(self.params, init_key,
                                           seed_mode=seed_mode,
                                           device=self.device)
        self.ticks = 0  # host-side mirror of state.t (no device readback)
        self._reset_drain()

    def step(self, ticks: int = 1) -> None:
        """Advance `ticks` protocol periods (always `tick_n`, as the
        reference: one tick runs on `split(key, 1)[0]`)."""
        self._rng, key = jr.split(self._rng)
        t0 = time.monotonic()
        self.state = swim_pview.tick_n(self.state, key, self.params, ticks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        record_phase_seconds("pview", "tick",
                             (time.monotonic() - t0) / max(1, ticks))
        self.ticks += ticks

    def crash_many(self, members) -> None:
        self.state = swim_pview.set_alive_many(self.state, members, False)

    def restart_many(self, members) -> None:
        self.state = swim_pview.set_alive_many(self.state, members, True)

    def degrade(self, members, loss: float = 0.0, lag: int = 0) -> None:
        """Degraded-node fault injection: flaky, not dead (loss=0, lag=0
        restores)."""
        self.state = swim_pview.set_degraded(self.state, members, loss, lag)

    def stats(self) -> Dict[str, float]:
        """The four-term bar's stats; drains the event lane and the flight
        ring in the same readback."""
        s, ev, fl = swim_pview.stats_and_events(self.state, self.params)
        self._drain(ev, fl)
        return s

    def converged(self, stats: Dict[str, float], cov_target: float = 0.99,
                  quorum: int = 8) -> bool:
        return (
            stats["pv_coverage"] >= cov_target
            and stats["min_in_degree"] >= quorum
            and stats["mean_in_degree"]
            >= swim_pview.saturation_floor(self.params.n, self.params.slots)
            and stats["false_positive"] == 0.0
        )

    def run_until_converged(
        self,
        cov_target: float = 0.99,
        quorum: int = 8,
        max_ticks: int = 2000,
        check_every: int = 10,
    ) -> Optional[int]:
        """Step `check_every` ticks at a time and check the bar on the
        host; returns the tick count at convergence or None."""
        while self.ticks < max_ticks:
            self.step(min(check_every, max_ticks - self.ticks))
            if self.converged(self.stats(), cov_target, quorum):
                return self.ticks
        return None

    def run_until_converged_device(
        self,
        cov_target: float = 0.99,
        quorum: int = 8,
        max_ticks: int = 2000,
        check_every: int = 10,
    ) -> Optional[int]:
        """Tick in `check_every`-tick chunks with one 6-value readback per
        chunk (swim_pview.run_to_converged); returns the absolute tick at
        convergence or None. `last_vals` keeps the final stats row."""
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self._rng, key = jr.split(self._rng)
        limit = self.ticks + max_ticks
        self.state, vals = swim_pview.run_to_converged(
            self.state, key, self.params,
            float(cov_target), int(quorum), int(check_every), int(limit),
        )
        # one readback: the lane and the ring the loop accumulated
        ev, fl = swim.events_and_flight(self.state)
        self.ticks = fl.t
        self._drain(ev, fl)
        self.last_vals = vals
        ok = swim_pview._converged(vals, self.params, cov_target, quorum)
        return self.ticks if ok else None


# ---------------------------------------------------------------------------
# Lifeguard A/B harness: one degraded member, both kernels

_EV = {name: i for i, name in enumerate(KERNEL_EVENTS)}


def _mk_sim(kernel: str, n: int, slots: int, seed: int, lifeguard: bool,
            **overrides):
    lg = dict(lhm_max=8, susp_ceiling=3, susp_k=3) if lifeguard else {}
    if kernel == "dense":
        return ClusterSim(n, seed=seed, **lg, **overrides)
    if kernel == "pview":
        return PViewClusterSim(n, slots=slots, seed=seed,
                               seed_mode="fingers", **lg, **overrides)
    raise ValueError(f"unknown kernel {kernel!r}")


def _events(sim) -> np.ndarray:
    return sim.state.events.cpu().numpy().astype(np.int64)


def flaky_node_ab(
    kernel: str = "dense",
    seed: int = 0,
    n: int = 96,
    slots: int = 48,
    boot_ticks: int = 40,
    window: int = 240,
    lag: int = 2,
    loss: float = 0.0,
    chunk: int = 20,
    detect_chunk: int = 5,
    detect_cap: int = 200,
    suspicion_ticks: int = 4,
    drain_flight: bool = False,
    flight: Optional[FlightRecorder] = None,
    **overrides,
) -> dict:
    """One seeded vanilla-vs-Lifeguard A/B (the reference's harness).

    Boot `n` members; phase A degrades member 1 (lag `lag`, loss `loss`,
    alive throughout) for `window` ticks and counts ground-truth false
    suspicions and downs from the event lane; phase B crashes member 2
    and counts ticks until every live observer has it detected. Both
    modes replay the same seed, vanilla with lhm_max=0 and Lifeguard with
    lhm_max=8. Returns per-mode counts and detection ticks, and with
    `drain_flight` the Lifeguard run's suspicion timeline from the
    sims' recorder (`flight`, else `FLIGHT`). `overrides` carries
    `device` and parameter overrides."""
    recorder = FLIGHT if flight is None else flight
    out: dict = {"kernel": kernel, "seed": seed, "n": n, "lag": lag,
                 "loss": loss, "window": window}
    for mode in ("vanilla", "lifeguard"):
        mode_wall = time.time()
        sim = _mk_sim(kernel, n, slots, seed, mode == "lifeguard",
                      suspicion_ticks=suspicion_ticks, **overrides)
        sim.flight = recorder
        done = 0
        while done < boot_ticks:
            sim.step(min(chunk, boot_ticks - done))
            done += chunk
        # ---- phase A: one flaky member, count false accusations ----
        sim.degrade([1], loss=loss, lag=lag)
        ev0 = _events(sim)
        done = 0
        while done < window:
            sim.step(min(chunk, window - done))
            done += chunk
            if drain_flight:
                sim.stats()  # drain the device ring into FLIGHT per chunk
        delta = _events(sim) - ev0
        rec = {
            "suspect_fp": int(delta[_EV["suspect_fp"]]),
            "down_fp": int(delta[_EV["down_fp"]]),
            "suspect_raised": int(delta[_EV["suspect_raised"]]),
            "refuted": int(delta[_EV["refuted"]]),
            "confirmations": int(delta[_EV["suspicion_confirmations"]]),
            "lhm_degraded": int(sim.state.lhm[1]),
        }
        # ---- phase B: a real crash must still be detected fast ----
        if kernel == "dense":
            sim.crash(2)
        else:
            sim.crash_many([2])
        base = sim.ticks
        det = None
        while sim.ticks - base < detect_cap:
            sim.step(detect_chunk)
            if sim.stats()["detected"] >= 1.0:
                det = sim.ticks - base
                break
        rec["detect_ticks"] = det
        rec["detect_base"] = base
        if drain_flight:
            # this mode's frames: stamped at drain, after mode_wall
            frames = [f for f in recorder.window(4096, kernel=kernel)
                      if f["wall"] >= mode_wall]
            rec["timeline"] = [
                {
                    "tick": f["tick"],
                    "suspect_raised": f["events"]["suspect_raised"],
                    "suspect_fp": f["events"]["suspect_fp"],
                    "down_declared": f["events"]["down_declared"],
                    "down_fp": f["events"]["down_fp"],
                    "refuted": f["events"]["refuted"],
                    "confirmations": f["events"]["suspicion_confirmations"],
                    "lhm_max": f["census"].get("lhm_max", 0),
                    "open_timers": f["census"].get("census_suspect", 0),
                }
                for f in frames
                if f["events"]["suspect_raised"]
                or f["events"]["down_declared"]
                or f["events"]["refuted"]
            ][-64:]
        out[mode] = rec
    v, lf = out["vanilla"], out["lifeguard"]
    out["fp_ratio"] = (
        v["suspect_fp"] / max(1, lf["suspect_fp"])
        if lf["suspect_fp"] or v["suspect_fp"] else None
    )
    out["detect_ratio"] = (
        lf["detect_ticks"] / v["detect_ticks"]
        if lf["detect_ticks"] and v["detect_ticks"] else None
    )
    return out


# ---------------------------------------------------------------------------
# r12 cluster-observatory scenario harness (agent-level, mem-net)


async def cluster_observatory_scenario(
    scenario: str,
    seed: int = 0,
    nodes: int = 3,
    writes: int = 12,
    interval: float = 0.15,
    batch_wait: float = 0.1,
    hold_secs: float = 2.5,
    timeline: Optional[List[dict]] = None,
    device=None,
) -> dict:
    """One cluster-observatory episode on a real in-process devcluster
    (shared by `scripts/chaos_soak.py --phase cluster`, the obs_report
    cluster section, and the tier-1 live replica in
    tests/test_cluster_obs.py).

    Boots `nodes` agents over a mem network with a LONG suspicion
    window (the realistic regime where a partition is not instantly
    indistinguishable from a crash), runs a small write→event workload
    so the gossiped digests carry non-empty stage histograms, waits for
    full digest coverage on every node, then injects the scenario:

      quiet      — nothing; pins full coverage + exact aggregation
                   (cluster-merged stage percentiles == the merge of
                   the per-node /v1/slo cumulative histograms)
      partition  — the last node is cut from everyone for `hold_secs`,
                   then healed: the divergence detector must open ONE
                   episode per observing side within a bounded number
                   of digest rounds, dump ONE incident per episode, and
                   clear after heal
      churn      — the last node is taken down (crash-style silence)
                   and brought back: same detection surface, but the
                   episode must ALSO clear once digests flow again

    `timeline`, when given, receives one row per digest round with the
    first node's divergence gauges — the obs_report render feed.

    The port's agents boot through `agent_checks.boot` (the JAX module
    takes `boot`, `fast_config` and `wait_until` from its agent tests)
    with the runtime planes on, as the JAX tests' config has them, their
    stores' decision program on `device` (None: the card) and their
    databases in a temporary directory.
    """
    import asyncio
    import contextlib
    import tempfile

    from corrosion_tpu_torch import agent_checks as ac
    from corrosion_tpu_torch.agent.membership import SwimConfig
    from corrosion_tpu_torch.agent.run import make_broadcastable_changes, shutdown
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.client import CorrosionApiClient
    from corrosion_tpu_torch.net.mem import MemNetwork
    from corrosion_tpu_torch.runtime import latency as lat

    if scenario not in ("quiet", "partition", "churn"):
        raise ValueError(f"unknown scenario {scenario!r}")

    wait_until = ac.wait_until
    api = ac.port_api(device)
    db_dir = tempfile.TemporaryDirectory(prefix="cluster_obs")

    def tune(cfg):
        for section, flag in ac.PLANES_OFF:
            setattr(getattr(cfg, section), flag, True)
        cfg.pubsub.candidate_batch_wait = batch_wait
        cfg.cluster.digest_interval_secs = interval
        cfg.cluster.silent_after_mult = 3.0
        cfg.cluster.divergence_checks = 2

    net = MemNetwork(seed=seed)
    names = [f"cobs-{seed}-{i}" for i in range(nodes)]
    agents = []
    for i, name in enumerate(names):
        # fast probing, LONG suspicion: the observatory must win the
        # race against the failure detector's down-eviction
        ag = await ac.boot(
            api, net, name, db_dir.name, tuple(names[:i][-2:]), tune=tune,
            swim=SwimConfig(probe_period=0.05, probe_rtt=0.02,
                            suspicion_mult=60.0),
        )
        agents.append(ag)
    first, last = agents[0], agents[-1]
    api = client = it = None
    out: dict = {"scenario": scenario, "seed": seed, "nodes": nodes,
                 "digest_interval_secs": interval}
    try:
        assert await wait_until(
            lambda: all(len(a.members) == nodes - 1 for a in agents),
            timeout=30.0,
        ), "membership never converged"

        api = ApiServer(first)
        first.config.api.bind_addr = ["127.0.0.1:0"]
        await api.start()
        client = CorrosionApiClient(api.addrs[0])
        stream = client.subscribe("SELECT id, text FROM tests")
        it = stream.__aiter__()
        while True:
            ev = await asyncio.wait_for(it.__anext__(), 10)
            if "eoq" in ev:
                break
        got = 0
        for i in range(writes):
            await make_broadcastable_changes(
                last,
                lambda tx, i=i: [tx.execute(
                    "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)",
                    [i, f"{scenario}-{i}"],
                )],
            )
            while got <= i:
                ev = await asyncio.wait_for(it.__anext__(), 30)
                if "change" in ev:
                    got += 1

        # full digest coverage on EVERY node, timed in digest rounds
        t0 = time.monotonic()
        assert await wait_until(
            lambda: all(
                len(a.observatory._store) == nodes for a in agents
            ),
            timeout=30.0,
        ), "digest coverage never completed"
        out["coverage_rounds"] = max(
            1, int((time.monotonic() - t0) / interval) + 1
        )

        # the exact-aggregation pin: the shared in-process registry
        # makes every node's cumulative stage histogram identical, so
        # once the gossiped digests have caught up with the last sample
        # the cluster merge must hold exactly nodes × the local counts
        # and reproduce the local quantiles bucket-for-bucket (merging
        # k identical histograms scales counts, never quantiles)
        local = lat.stage_hists(window_secs=None)
        rep = None

        def merged_caught_up() -> bool:
            nonlocal rep
            rep = first.observatory.cluster_report()
            return all(
                rep["stages"][s]["count"] == nodes * h.count
                for s, h in local.items()
            )

        assert await wait_until(
            merged_caught_up, timeout=15.0, step=interval
        ), {s: (rep["stages"][s]["count"], nodes * h.count)
            for s, h in local.items()}
        out["coverage"] = rep["coverage"]
        out["nodes_report"] = rep["nodes"]  # per-node digest roll-up rows
        assert rep["coverage"]["fresh"] == nodes, rep["coverage"]
        # the same rows over the wire: GET /v1/cluster on one node
        import aiohttp

        async with aiohttp.ClientSession() as sess:
            async with sess.get(
                f"http://{api.addrs[0]}/v1/cluster"
            ) as resp:
                assert resp.status == 200
                http_rep = await resp.json()
        assert http_rep["coverage"]["fresh"] == nodes
        assert len(http_rep["nodes"]) == nodes
        for stage, h in local.items():
            assert (
                http_rep["stages"][stage]["count"] == nodes * h.count
            ), (stage, http_rep["stages"][stage])
        for stage, h in local.items():
            crow = rep["stages"][stage]
            if h.count == 0:
                continue
            for q in lat.QUANTILES:
                assert crow[lat._qname(q)] == h.quantile(q), (
                    stage, q, crow, h.quantile(q),
                )
        out["stages"] = {
            s: {k: v for k, v in r.items()}
            for s, r in rep["stages"].items()
        }
        out["divergence_quiet"] = rep["divergence"]["divergent"]

        if scenario == "quiet":
            assert not rep["divergence"]["episode_open"]
            return out

        # -- fault injection ------------------------------------------------
        victim = names[-1]
        observers = agents[:-1]
        if scenario == "partition":
            for name in names[:-1]:
                net.partition(name, victim)
        else:  # churn: crash-style silence, then return
            net.take_down(victim)
        t0 = time.monotonic()

        async def sample_rounds(pred, cap_s: float) -> Optional[int]:
            """Poll once per digest round; rows feed `timeline`."""
            deadline = time.monotonic() + cap_s
            while time.monotonic() < deadline:
                if timeline is not None:
                    d = first.observatory.check_divergence()
                    timeline.append({
                        "t": round(time.monotonic() - t0, 2),
                        "groups": d["groups"],
                        "silent": len(d["silent"]),
                        "episode_open": d["episode_open"],
                    })
                if pred():
                    return max(
                        1, int((time.monotonic() - t0) / interval) + 1
                    )
                await asyncio.sleep(interval)
            return None

        detect = await sample_rounds(
            lambda: all(a.observatory._episode_open for a in observers),
            cap_s=30.0,
        )
        assert detect is not None, "divergence episode never opened"
        out["detect_rounds"] = detect
        out["detect_secs"] = round(time.monotonic() - t0, 2)
        await asyncio.sleep(max(0.0, hold_secs - (time.monotonic() - t0)))

        # -- heal -----------------------------------------------------------
        if scenario == "partition":
            for name in names[:-1]:
                net.heal(name, victim)
        else:
            net.bring_up(victim)
        t0 = time.monotonic()
        heal = await sample_rounds(
            lambda: not any(a.observatory._episode_open for a in agents),
            cap_s=30.0,
        )
        assert heal is not None, "divergence episode never cleared"
        out["heal_rounds"] = heal
        out["episodes"] = {
            names[i]: a.observatory._episodes
            for i, a in enumerate(agents)
        }
        # exactly ONE episode per node that observed the fault
        for a in observers:
            assert a.observatory._episodes == 1, out["episodes"]
        out["episodes_total"] = sum(
            a.observatory._episodes for a in agents
        )
        return out
    finally:
        for ag in agents:
            if ag.observatory is not None:
                # planned teardown: peers going quiet one by one must
                # not read as fresh divergence episodes
                ag.observatory.disarm()
        if it is not None:
            with contextlib.suppress(Exception):
                await it.aclose()
        if client is not None:
            await client.close()
        if api is not None:
            await api.stop()
        for ag in agents:
            await shutdown(ag)
        with contextlib.suppress(OSError):
            db_dir.cleanup()
