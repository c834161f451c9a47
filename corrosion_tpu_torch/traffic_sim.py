"""Production traffic simulator + chaos scenario matrix on the port →
TRAFFIC_SIM_H100.json.

The port's program of `scripts/traffic_sim.py`, with one addition: the
device the agents' stores decide on (`--device`, handed to
`agent.run.setup`; with none named the card, or a RuntimeError without
CUDA). Put the stores' remote merges on the card with
`CORRO_CRDT_ENGINE=array`: the agents run no SWIM tick, so the CRDT
decision program is their only device work. `_MEASURED_FILES` covers the
port's own files.

The standing "does the whole system still serve under X" gate: an
N-agent devcluster (gossip over MemNetwork, REAL HTTP APIs per node)
runs the mixed workload (`chaos/workload.py`: writes, point queries,
live subscriptions, template renders) while the `ChaosEngine`
(`chaos/scenarios.py`) lands one scenario at a time across the three
fault layers — then restores and measures recovery.

Per scenario the record banks:
- per-stage client-observed p50/p99 + the four-way op accounting
  (ok / typed refusals / fast errors / TIMEOUTS — the hang witness),
- availability = (ok + refusals) / attempts,
- the cluster's OWN scorecard scraped from /v1/slo (windowed
  write→event stage percentiles) and /v1/cluster (digest coverage +
  divergence verdict),
- recovery: seconds from restore() until a fresh probe write converges
  on every node, row counts agree everywhere, and the divergence
  detector reports one view group — the closing zero-divergence
  verdict.

Bars asserted BEFORE banking (the same ones tests/test_traffic_sim.py
guards against the banked artifact): zero op timeouts in EVERY
scenario (faults may shrink `ok`, never convert requests into stalls —
Prime CCL, arXiv:2505.14065), availability floors, recovery under the
cap, zero divergence at close.  Scenario shapes follow Potato
(arXiv:2308.12698): geo-latency matrices, slow/heterogeneous nodes.

r22 adds the remediation A/B axis: `--remediation` runs the full
matrix TWICE at steady (production-shaped) sync cadence — once
observe-only (the `[remediation]` kill-switch default) and once armed
— and banks the per-scenario recovery walls side by side under the
`remediation_ab` key (`r22`-tagged, BESIDE the preserved r18 top-level
records, not over them).  The bar: the armed side strictly improves
recovery-to-zero-divergence on ≥3 faulted scenarios, with zero
regressions (timeouts==0 everywhere, availability floors held) and
every fired action a typed cooldown-stamped flight-recorded event
served by `GET /v1/remediation`.

Usage (from the repo root, with `-m`: the package's `random.py` must not
shadow the stdlib's, which `chaos/workload.py` uses):
    python -m corrosion_tpu_torch.traffic_sim [--out PATH] [--device D]
        the full matrix → TRAFFIC_SIM_H100.json (or PATH)
    python -m corrosion_tpu_torch.traffic_sim --tier1
        the tiny-shape subset, printed, nothing written
    python -m corrosion_tpu_torch.traffic_sim --remediation
        the A/B → the `remediation_ab` key of the same file
The JAX package's banked TRAFFIC_SIM.json is never written.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from corrosion_tpu_torch.agent.run import (
    make_broadcastable_changes,
    run as run_agent,
    setup,
    shutdown,
)
from corrosion_tpu_torch.agent import syncer
from corrosion_tpu_torch.agent.membership import SwimConfig
from corrosion_tpu_torch.api.http import ApiServer
from corrosion_tpu_torch.chaos.scenarios import (
    ChaosEngine,
    Injection,
    Scenario,
    asymmetric_partition,
    churn_storm,
    flap_storm,
    geo_latency,
    sick_disk,
    slow_disk,
    zombie_node,
)
from corrosion_tpu_torch.chaos.workload import (
    MixedWorkload,
    WorkloadNode,
)
from corrosion_tpu_torch.client import CorrosionApiClient
from corrosion_tpu_torch.net.mem import MemNetwork
from corrosion_tpu_torch.runtime.config import Config
from corrosion_tpu_torch.runtime.tmpdb import fresh_db_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = "TRAFFIC_SIM_H100.json"

TEST_SCHEMA = (
    "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
)

_MEASURED_FILES = (
    "corrosion_tpu_torch/chaos/faults.py",
    "corrosion_tpu_torch/chaos/scenarios.py",
    "corrosion_tpu_torch/chaos/workload.py",
    "corrosion_tpu_torch/net/mem.py",
    "corrosion_tpu_torch/agent/syncer.py",
    "corrosion_tpu_torch/agent/remediation.py",
    "corrosion_tpu_torch/traffic_sim.py",
)


def _code_fingerprint() -> dict:
    out = {}
    for rel in _MEASURED_FILES:
        try:
            with open(os.path.join(REPO, rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()[:12]
        except OSError:
            out[rel] = "missing"
    return out


class SimNode:
    """One node's full lifecycle: agent + HTTP API + client, restartable
    in place (same db file, same gossip addr) so churn rides the real
    boot/rejoin path."""

    def __init__(self, name: str, net: MemNetwork, bootstrap: Tuple[str, ...],
                 tune, swim: SwimConfig, device=None):
        self.name = name
        self.device = device
        self.net = net
        self.bootstrap = bootstrap
        self.tune = tune
        self.swim = swim
        self.db_path = fresh_db_path(f"tsim-{name}")
        self.agent = None
        self.api: Optional[ApiServer] = None
        self.client: Optional[CorrosionApiClient] = None

    async def start(self) -> None:
        cfg = Config()
        cfg.db.path = self.db_path
        cfg.gossip.bind_addr = self.name
        cfg.gossip.bootstrap = list(self.bootstrap)
        cfg.perf.broadcast_interval_ms = 20
        cfg.perf.apply_queue_timeout_ms = 5
        cfg.perf.sync_interval_min_secs = 0.1
        cfg.perf.sync_interval_max_secs = 0.5
        cfg.cluster.digest_interval_secs = 0.3
        cfg.api.bind_addr = ["127.0.0.1:0"]
        if self.tune:
            self.tune(cfg)
        agent = await setup(cfg, network=self.net, device=self.device)
        agent.membership.config = self.swim
        agent.store.apply_schema_sql(TEST_SCHEMA)
        await run_agent(agent)
        self.agent = agent
        self.api = ApiServer(agent)
        await self.api.start()
        self.client = CorrosionApiClient(self.api.addrs[0])

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None
        if self.api is not None:
            await self.api.stop()
            self.api = None
        if self.agent is not None:
            await shutdown(self.agent)
            self.agent = None

    @property
    def workload_node(self) -> Optional[WorkloadNode]:
        if self.agent is None or self.client is None or self.api is None:
            return None
        return WorkloadNode(
            name=self.name,
            agent=self.agent,
            client=self.client,
            api_addr=self.api.addrs[0],
        )


class TrafficSim:
    """The harness: cluster lifecycle + one scenario run at a time."""

    def __init__(self, tiny: bool = False, seed: int = 31,
                 remediation: bool = False, steady_sync: bool = False,
                 device=None):
        self.tiny = tiny
        self.remediation = remediation
        self.steady_sync = steady_sync
        self.net = MemNetwork(seed=seed)
        self.engine = ChaosEngine()
        n = 3 if tiny else 4
        # suspicion window longer than any fault window (the bench_sync
        # chaos-phase discipline): members stay at worst SUSPECT through
        # a scenario and refute on restore, so recovery measures the
        # SYNC/serving planes, not a full SWIM eviction/rejoin cycle
        self.swim = SwimConfig(
            probe_period=0.12 if tiny else 0.25,
            probe_rtt=0.05 if tiny else 0.1,
            suspicion_mult=8,
            # prompt re-announce after an eviction window: the knob an
            # operator running frequent-fault topologies would set (the
            # announce_wake fix makes isolation START this ramp at
            # once; the ramp bounds how fast it then lands)
            announce_backoff_start=0.3,
            announce_backoff_max=2.0,
        )
        self.duration = 0.8 if tiny else 6.0
        self.recovery_cap = 8.0 if tiny else 45.0
        # alert settle caps: how long after the workload window (faults
        # still injected) the expected typed alert may take to reach
        # FIRING, and how long after recovery it may take to resolve.
        # The tiny caps are sized for FULL-SUITE load, not a quiet
        # host: the 0.08 s TSDB/eval cadence is an asyncio task that a
        # loaded 1-core runner starves, so the rate rule can need
        # several extra seconds to see the error samples (r21 — the
        # poll exits early on success, so the nominal wall is
        # unchanged; only a genuinely late alert spends the headroom).
        self.alert_fire_cap = 8.0 if tiny else 10.0
        self.alert_resolve_cap = 8.0 if tiny else 12.0
        self.nodes: Dict[str, SimNode] = {}

        def tune(cfg):
            cfg.sync.circuit_reset_secs = 1.0 if tiny else 3.0
            # r20 alerting plane at scenario-window timescales: fast
            # TSDB sampling/eval and for-durations scaled so a typed
            # alert can complete pending→firing inside the fault window
            # and resolve inside the recovery window (the health score
            # may still widen them Lifeguard-style — the caps above
            # leave room for the worst-case ×4)
            cfg.tsdb.sample_interval_secs = 0.08 if tiny else 0.25
            cfg.alerts.eval_interval_secs = 0.08 if tiny else 0.2
            cfg.alerts.for_scale = 0.04 if tiny else 0.15
            if self.steady_sync:
                # the A/B axis runs at production-shaped anti-entropy
                # cadence on BOTH sides (same config, only the arming
                # bit differs): recovery-off is then dominated by the
                # sync backoff — exactly the gap the view-divergence
                # actuator exists to close
                cfg.perf.sync_interval_min_secs = 1.0
                cfg.perf.sync_interval_max_secs = 4.0
            # r23 continuous profiler at scenario timescales: short
            # fold windows so a capture's lookback is dominated by the
            # scenario that triggered it, and a loosened overhead
            # budget — the loaded 1-core tiny replica would otherwise
            # shed to 11 Hz instantly and starve the fault window of
            # samples (the production ≤2% budget is proven where it
            # belongs, on the quiet ingest-bench rung)
            cfg.profile.window_secs = 1.0 if tiny else 5.0
            cfg.profile.max_overhead_pct = 4.0 if tiny else 1.0
            # the supervisor TICK is scaled for observe-only runs too
            # (the same timescale discipline the tsdb/alert cadences
            # above get): a tiny-shape firing window is ~0.5 s, so the
            # 2 s production tick would make the would_act audit trail
            # a phase race instead of a recorded fact
            cfg.remediation.tick_secs = 0.1 if tiny else 0.25
            if self.remediation:
                # r22: arm the plane, cooldowns/sustain scaled to the
                # scenario-window timescale (the same scaling the
                # alerting plane above gets)
                cfg.remediation.enabled = True
                cfg.remediation.act_timeout_secs = 0.8 if tiny else 1.5
                cfg.remediation.sync_cooldown_secs = 0.4 if tiny else 0.75
                cfg.remediation.drain_cooldown_secs = 1.0 if tiny else 2.0
                cfg.remediation.shed_cooldown_secs = 0.5 if tiny else 1.0
                cfg.remediation.slo_sustain_secs = 0.3 if tiny else 1.0
                cfg.remediation.refuse_bulk_secs = 1.5 if tiny else 3.0

        names = [f"n{i}" for i in range(n)]
        for name in names:
            bootstrap = () if name == "n0" else ("n0",)
            self.nodes[name] = SimNode(
                name, self.net, bootstrap, tune, self.swim, device
            )
        self._probe_id = 50_000_000
        self._id_base = 0

    def live_nodes(self) -> Dict[str, WorkloadNode]:
        out = {}
        for name, node in self.nodes.items():
            wn = node.workload_node
            if wn is not None:
                out[name] = wn
        return out

    async def start_cluster(self) -> None:
        for node in self.nodes.values():
            await node.start()
        # full membership before any scenario lands
        deadline = time.monotonic() + 30
        n = len(self.nodes)
        while time.monotonic() < deadline:
            if all(
                node.agent.membership.cluster_size == n
                for node in self.nodes.values()
            ):
                return
            await asyncio.sleep(0.05)
        raise RuntimeError("cluster never converged at boot")

    async def stop_cluster(self) -> None:
        for node in self.nodes.values():
            await node.stop()

    # -- measurement helpers ------------------------------------------------

    def _row_counts(self) -> Dict[str, int]:
        out = {}
        for name, node in self.nodes.items():
            if node.agent is None:
                continue
            conn = node.agent.store.read_conn()
            try:
                out[name] = conn.execute(
                    "SELECT COUNT(*) FROM tests"
                ).fetchone()[0]
            finally:
                conn.close()
        return out

    def _divergence_zero(self) -> bool:
        obs = self.nodes["n0"].agent.observatory
        v = obs.check_divergence()
        return not v["divergent"] and v["groups"] == 1 and not v["silent"]

    async def measure_recovery(self) -> dict:
        """Seconds from restore() until a fresh probe write converges on
        every node, row counts agree, and the divergence detector reports
        one view group."""
        t0 = time.monotonic()
        deadline = t0 + self.recovery_cap
        self._probe_id += 1
        probe = self._probe_id
        wrote = False
        recovered_at = None
        while time.monotonic() < deadline:
            if not wrote:
                try:
                    await make_broadcastable_changes(
                        self.nodes["n0"].agent,
                        lambda tx: [tx.execute(
                            "INSERT OR REPLACE INTO tests (id, text)"
                            " VALUES (?, ?)", [probe, "probe"],
                        )],
                    )
                    wrote = True
                except Exception:
                    await asyncio.sleep(0.1)
                    continue
            counts = self._row_counts()
            same_rows = len(set(counts.values())) == 1
            if same_rows and self._divergence_zero():
                recovered_at = time.monotonic()
                break
            await asyncio.sleep(0.1)
        counts = self._row_counts()
        return {
            "secs": (
                round(recovered_at - t0, 3)
                if recovered_at is not None else None
            ),
            "converged": len(set(counts.values())) == 1,
            "rows": max(counts.values()) if counts else 0,
            "divergence_zero": self._divergence_zero(),
        }

    # -- alert observation --------------------------------------------------

    # the drill-vs-outage proof (r20): each fault scenario that has a
    # typed alert in the default pack must RAISE it while injected
    # (with the drill mark, since the chaos census is populated) and
    # RESOLVE it after restore()
    EXPECTED_ALERTS = {
        "sick-disk": "store-faults",
        "slow-disk": "commit-stall",
        "zombie-node": "view-divergence",
    }

    async def _scrape_alerts(self) -> Optional[dict]:
        wn = self.nodes["n0"].workload_node
        if wn is None:
            return None
        from corrosion_tpu_torch.chaos.workload import MixedWorkload

        return await MixedWorkload(self.live_nodes).scrape(
            wn, "/v1/alerts?history=0"
        )

    @staticmethod
    def _alert_row(report: Optional[dict], rule: str) -> Optional[dict]:
        for r in (report or {}).get("rules", []):
            if r["rule"] == rule:
                return r
        return None

    async def _await_alert_state(
        self, rule: str, want_firing: bool, cap: float
    ) -> Optional[dict]:
        """Poll n0's /v1/alerts until `rule` reaches (or leaves) the
        FIRING state; returns the final report (never raises — the
        bars judge the banked outcome)."""
        deadline = time.monotonic() + cap
        report = None
        while time.monotonic() < deadline:
            report = await self._scrape_alerts()
            row = self._alert_row(report, rule)
            if row is not None and (row["state"] == "firing") == want_firing:
                break
            await asyncio.sleep(0.1)
        return report

    # -- one scenario -------------------------------------------------------

    async def run_scenario(
        self, scenario_id: str, injections: List[Injection]
    ) -> dict:
        self._id_base += 1_000_000  # fresh pk range per scenario
        scenario_wall0 = time.time()  # to window remediation events
        workload = MixedWorkload(
            self.live_nodes,
            op_timeout_secs=3.0 if self.tiny else 5.0,
            write_period_secs=0.04 if self.tiny else 0.03,
            query_period_secs=0.05 if self.tiny else 0.04,
            render_period_secs=0.3 if self.tiny else 0.25,
            seed=zlib.crc32(scenario_id.encode()) & 0xFFFF,
            id_base=self._id_base,
        )
        await self.engine.apply(Scenario(scenario_id, injections))
        await workload.start()
        await asyncio.sleep(self.duration)
        await workload.stop()
        # scrape the cluster's own scorecard from a node no scenario
        # injects faults into (n0 is the sim's designated control node)
        summary = await workload.summary(
            scrape_node=self.nodes["n0"].workload_node
        )
        # r20 alert proof, injection half: faults are STILL live here —
        # the scenario's typed alert must be firing (drill-marked) on
        # the alerting plane before restore() is allowed to clear it
        expected_alert = self.EXPECTED_ALERTS.get(scenario_id)
        alerts_during = None
        if expected_alert is not None:
            alerts_during = await self._await_alert_state(
                expected_alert, want_firing=True, cap=self.alert_fire_cap
            )
        await self.engine.restore()
        recovery = await self.measure_recovery()
        alerts_after = None
        if expected_alert is not None:
            alerts_after = await self._await_alert_state(
                expected_alert, want_firing=False,
                cap=self.alert_resolve_cap,
            )
        rec = {
            "scenario": scenario_id,
            "injections": [
                f"[{i.layer}] {i.summary}" for i in injections
            ],
            "duration_secs": self.duration,
            "recovery": recovery,
            **summary,
        }
        # r22: scrape every live node's GET /v1/remediation and bank
        # THIS scenario's decision trail (the supervisor history is
        # process-lived, so window it by the scenario's wall start) —
        # armed runs bank acted/reverted events, observe-only runs
        # bank the kill-switch's would_act audit trail
        rem_events: List[dict] = []
        rem_counts: Dict[str, dict] = {}
        for name in self.nodes:
            wn = self.nodes[name].workload_node
            if wn is None:
                continue
            rep = await workload.scrape(wn, "/v1/remediation")
            if not rep:
                continue
            rem_counts[name] = rep.get("counts", {})
            for ev in rep.get("history", []):
                if ev.get("wall", 0.0) >= scenario_wall0:
                    rem_events.append({"node": name, **ev})
        rec["remediation"] = {
            "armed": self.remediation,
            "events": rem_events,
            "counts": rem_counts,
        }
        if expected_alert is not None:
            during_row = self._alert_row(alerts_during, expected_alert)
            after_row = self._alert_row(alerts_after, expected_alert)
            rec["alerts"] = {
                "expected": expected_alert,
                "during": during_row,
                "after": after_row,
                "raised": bool(during_row)
                and during_row["state"] == "firing",
                "drill": (during_row or {}).get("drill"),
                "resolved": bool(after_row)
                and after_row["state"] != "firing",
            }
        if scenario_id == "churn-storm":
            # r19 (closes the r18 ROADMAP sub-item): the churned node
            # restarted through the real boot path and recovered over
            # the r17 catch-up plane — bank ITS /v1/status catch-up
            # census so the record says HOW it caught up (bootstrap
            # state, held versions, resume waves, open circuits), not
            # just that row counts converged
            churned = self.nodes[list(self.nodes)[-1]].workload_node
            status = (
                await workload.scrape(churned, "/v1/status")
                if churned is not None
                else None
            )
            rec["catchup"] = (status or {}).get("sync", {}).get("catchup")
        return rec

    def scenario_matrix(self) -> List[Tuple[str, List[Injection]]]:
        names = list(self.nodes)
        n = len(names)
        store = lambda i: self.nodes[names[i % n]].agent.store  # noqa: E731

        async def stop_node(name: str) -> None:
            await self.nodes[name].stop()

        async def start_node(name: str) -> None:
            await self.nodes[name].start()

        regions = {
            name: ("us" if i < (n + 1) // 2 else "eu")
            for i, name in enumerate(names)
        }
        lat = 0.04 if self.tiny else 0.08
        flap = 0.3 if self.tiny else 0.5
        churn = 0.6 if self.tiny else 1.0
        matrix: List[Tuple[str, List[Injection]]] = [
            ("baseline", []),
            (
                "geo-latency",
                [geo_latency(self.net, regions, {("us", "eu"): lat})],
            ),
            (
                "asym-partition",
                [asymmetric_partition(
                    self.net, names[1], [m for m in names if m != names[1]]
                )],
            ),
            (
                "flap-storm",
                [flap_storm(self.net, names[0], names[-1], flap)],
            ),
            (
                "churn-storm",
                [churn_storm([names[-1]], stop_node, start_node, churn)],
            ),
            ("zombie-node", [zombie_node(self.net, names[-1])]),
            (
                "slow-disk",
                [slow_disk(store(1), 0.03 if self.tiny else 0.05)],
            ),
            (
                "sick-disk",
                # tiny mode fails EVERY statement on the sick node: the
                # ~0.8 s window sees only a handful of writes there, and
                # a transient rate would make the refusals>0 bar a coin
                # flip (deterministic pins only — the r15 noise lesson).
                # The full matrix keeps transient rates but pins seed=4,
                # whose first draw (0.236 < 0.25) fires on the sick
                # node's FIRST statement — this 1-core host runs few
                # enough ops per window that an unlucky seed (0: no
                # draw under 0.25 in its first 16) banked zero refusals
                [sick_disk(store(2), busy_rate=1.0, io_error_rate=0.0)
                 if self.tiny else
                 sick_disk(store(2), busy_rate=0.25, io_error_rate=0.1,
                           seed=4)],
            ),
        ]
        if self.tiny:
            # slow-disk rides the tier-1 replica since r23: it is the
            # scenario that proves the commit-stall page alert AND the
            # alert-triggered profile capture pinning store/ frames
            keep = {"baseline", "zombie-node", "slow-disk", "sick-disk"}
            matrix = [m for m in matrix if m[0] in keep]
        return matrix


def _assert_bars(rec: dict, tiny: bool) -> None:
    """The serving bars every scenario must clear before banking — and
    the tier-1 replica asserts live."""
    sid = rec["scenario"]
    stages = rec["stages"]
    for stage, st in stages.items():
        assert st["timeouts"] == 0, (
            f"{sid}/{stage}: {st['timeouts']} op(s) hit the deadline — "
            "a fault converted requests into stalls"
        )
    for stage in ("write", "query"):
        st = stages[stage]
        assert st["attempts"] > 0, f"{sid}/{stage}: no traffic ran"
        floor = 0.98 if sid == "baseline" else 0.5
        assert st["availability"] >= floor, (
            f"{sid}/{stage}: availability {st['availability']} < {floor}"
        )
    assert rec["events_delivered"] > 0, f"{sid}: no subscription events"
    r = rec["recovery"]
    assert r["secs"] is not None, f"{sid}: never recovered"
    assert r["converged"], f"{sid}: row counts never converged"
    assert r["divergence_zero"], f"{sid}: divergence open at close"
    if sid == "sick-disk":
        assert stages["write"]["refusals"] > 0, (
            "sick-disk: injected store faults never surfaced as typed "
            "refusals"
        )
    # r20 alert bars: the scenario's typed alert raised while injected
    # (drill-marked — the chaos census was live) and resolved after
    # restore().  Tier-1 replica asserts the sick-disk store-fault and
    # slow-disk commit-stall alerts; the full matrix additionally holds
    # zombie-node's view-divergence alert to the same bar.
    if sid in ("sick-disk", "slow-disk") or (
        sid == "zombie-node" and not tiny
    ):
        al = rec.get("alerts")
        assert al, f"{sid}: no alert observation in the record"
        assert al["raised"], (
            f"{sid}: typed alert {al['expected']!r} never reached "
            f"FIRING while the fault was injected: {al['during']}"
        )
        assert al["drill"], (
            f"{sid}: alert fired without the drill mark while the "
            f"chaos census was active: {al['during']}"
        )
        assert al["resolved"], (
            f"{sid}: alert {al['expected']!r} still firing after "
            f"restore + recovery: {al['after']}"
        )
    # r23 profile-attachment bars: a disk-pathology page alert must
    # arrive with the continuous profiler's hot-window capture pinned
    # to it, and that capture's dominant store-worker stack must name
    # the store commit path — the incident record says WHERE the wall
    # went, not just that a threshold tripped
    if sid in ("sick-disk", "slow-disk"):
        prof = (rec["alerts"]["during"] or {}).get("profile")
        assert prof, (
            f"{sid}: page alert fired without an attached profile "
            "capture"
        )
        assert prof["reason"] == f"alert_{rec['alerts']['expected']}"
        assert prof["samples"] > 0, prof
        store_stacks = {
            k: v for k, v in prof["folded"].items()
            if k.startswith("store;")
        }
        assert store_stacks, (
            f"{sid}: attached profile holds no store-worker stacks: "
            f"{sorted(prof['folded'])[:8]}"
        )
        top = max(store_stacks, key=store_stacks.get)
        assert "store/crdt.py" in top, (
            f"{sid}: top store-worker stack does not name the commit "
            f"path: {top}"
        )
    if sid == "churn-storm":
        cc = rec.get("catchup")
        assert cc, (
            "churn-storm: the restarted node's /v1/status catch-up "
            "census was not scraped into the record"
        )
        assert "held_versions" in cc and "bootstrap" in cc, cc
    # r22: every remediation event the scenario banked is fully typed
    # — action, rule, outcome mode, wall stamp, cooldown stamp, drill
    # mark (the flight-record contract GET /v1/remediation serves)
    rem = rec.get("remediation")
    if rem is not None:
        for ev in rem["events"]:
            missing = {
                "node", "action", "rule", "mode", "wall",
                "cooldown_secs", "drill", "detail",
            } - set(ev)
            assert not missing, f"{sid}: untyped remediation event {ev}"
            assert ev["mode"] in (
                "acted", "would_act", "deferred", "refused",
                "failed", "reverted",
            ), ev
            assert ev["cooldown_secs"] > 0, ev


async def run_matrix(
    tiny: bool,
    remediation: bool = False,
    steady_sync: bool = False,
    seed: int = 31,
    only: Optional[Tuple[str, ...]] = None,
    device=None,
) -> dict:
    from corrosion_tpu_torch.runtime import profiler as _prof
    from corrosion_tpu_torch.runtime import tsdb as _tsdb

    saved = (syncer.RECV_TIMEOUT, syncer.OPEN_TIMEOUT)
    # fresh global TSDB at the sim's sampling cadence: an in-suite
    # replica must not inherit (or leave behind) another test's
    # sampler config or ring history — agent setup's ensure() then
    # adopts this instance for every sim node
    _tsdb.configure(
        sample_interval_secs=0.08 if tiny else 0.25,
        slots=600,
        max_series=4096,
    )
    # same discipline for the r23 continuous profiler (the knobs tune()
    # writes into each node's cfg.profile — configured up front so the
    # first node's ensure() adopts THIS instance, not a leftover): the
    # page-alert captures the slow/sick-disk bars assert ride on it
    _prof.configure(
        window_secs=1.0 if tiny else 5.0,
        max_overhead_pct=4.0 if tiny else 1.0,
    )
    if tiny:
        # tiny-shape deadlines: the zombie window is ~1 s, so the sync
        # plane's deadlines must be proportionally tight for recovery
        # to fit the replica budget (module globals, read per call —
        # restored in the finally so an in-suite replica run leaves the
        # production constants untouched for later tests)
        syncer.RECV_TIMEOUT = 2.0
        syncer.OPEN_TIMEOUT = 1.0
    sim = TrafficSim(tiny=tiny, seed=seed, remediation=remediation,
                     steady_sync=steady_sync, device=device)
    records: List[dict] = []
    t0 = time.monotonic()
    await sim.start_cluster()
    try:
        for scenario_id, injections in sim.scenario_matrix():
            if only is not None and scenario_id not in only:
                continue
            rec = await sim.run_scenario(scenario_id, injections)
            _assert_bars(rec, tiny)
            records.append(rec)
            print(json.dumps({
                "scenario": scenario_id,
                "remediation": remediation,
                "write_avail": rec["stages"]["write"]["availability"],
                "events": rec["events_delivered"],
                "recovery_s": rec["recovery"]["secs"],
            }), flush=True)
    finally:
        await sim.stop_cluster()
        syncer.RECV_TIMEOUT, syncer.OPEN_TIMEOUT = saved
        _tsdb.configure()  # uninstall: later tests ensure() their own
        _prof.configure()  # ditto — the sampler thread must not leak
    out = {
        "metric": "traffic_sim",
        "mode": "tier1" if tiny else "full",
        "nodes": len(sim.nodes),
        "remediation": remediation,
        "duration_per_scenario_secs": sim.duration,
        "wall_secs": round(time.monotonic() - t0, 2),
        "scenarios": records,
    }
    if tiny and not remediation and only is None:
        # the r22 tier-1 replica addendum: one remediation-ARMED
        # zombie-node scenario on a fresh tiny cluster — the plane
        # boots, ticks, serves GET /v1/remediation, and every bar
        # (timeouts==0, recovery, zero divergence) holds with the
        # actuators live
        armed = await run_matrix(
            True, remediation=True, seed=37, only=("zombie-node",),
            device=device,
        )
        rec = armed["scenarios"][0]
        assert rec["remediation"]["armed"] is True
        rec["scenario"] = "zombie-node-remediated"
        out["scenarios"].append(rec)
    return out


def _stage_timeouts(rec: dict) -> int:
    return sum(st["timeouts"] for st in rec["stages"].values())


async def run_remediation_ab(device=None) -> dict:
    """The r22 proof harness: the full matrix twice at steady sync
    cadence — observe-only, then armed — returning the banked A/B
    record.  Bars asserted here (the same ones
    tests/test_traffic_sim.py guards against the banked artifact):
    the armed side strictly improves recovery on ≥3 faulted scenarios,
    zero regressions, every fired action typed."""
    off = await run_matrix(False, remediation=False, steady_sync=True,
                           device=device)
    on = await run_matrix(False, remediation=True, steady_sync=True,
                          seed=32, device=device)
    by_off = {r["scenario"]: r for r in off["scenarios"]}
    by_on = {r["scenario"]: r for r in on["scenarios"]}
    scenarios: Dict[str, dict] = {}
    improved: List[str] = []
    for sid in by_off:
        a, b = by_off[sid], by_on[sid]
        row = {
            "recovery_off_secs": a["recovery"]["secs"],
            "recovery_on_secs": b["recovery"]["secs"],
            "improved": b["recovery"]["secs"] < a["recovery"]["secs"],
            "timeouts_off": _stage_timeouts(a),
            "timeouts_on": _stage_timeouts(b),
            "write_availability_off":
                a["stages"]["write"]["availability"],
            "write_availability_on":
                b["stages"]["write"]["availability"],
        }
        scenarios[sid] = row
        if row["improved"] and sid != "baseline":
            improved.append(sid)
    actions = [
        ev
        for rec in on["scenarios"]
        for ev in rec["remediation"]["events"]
    ]
    would_act = sum(
        1
        for rec in off["scenarios"]
        for ev in rec["remediation"]["events"]
        if ev["mode"] == "would_act"
    )
    # the acceptance bars, asserted BEFORE banking
    assert len(improved) >= 3, (
        f"remediation improved recovery on only {improved} — "
        "the A/B must show ≥3 faulted scenarios strictly better"
    )
    for sid, row in scenarios.items():
        assert row["timeouts_on"] == 0 and row["timeouts_off"] == 0, (
            f"{sid}: timeouts in the A/B run"
        )
    fired = [ev for ev in actions if ev["mode"] == "acted"]
    assert fired, "armed run fired no actions at all"
    assert would_act > 0, (
        "observe-only run recorded no would_act events — the "
        "kill-switch audit trail is empty"
    )
    return {
        "tag": "r22",
        "sync_profile": {
            "sync_interval_min_secs": 1.0,
            "sync_interval_max_secs": 4.0,
        },
        "scenarios": scenarios,
        "improved_faulted": sorted(improved),
        "actions": actions,
        "observe_only_would_act": would_act,
        "code_sha": _code_fingerprint(),
        "measured_at": time.strftime(
            "%Y-%m-%d %H:%M:%S", time.gmtime()
        ),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier1", action="store_true",
                    help="the tiny-shape subset, printed, nothing written")
    ap.add_argument("--remediation", action="store_true",
                    help="the observe-only/armed A/B of the full matrix")
    ap.add_argument("--out", default=OUT,
                    help=f"the record's file (default {OUT})")
    ap.add_argument("--device", default=None,
                    help="torch device of the stores (default: the card)")
    args = ap.parse_args(argv)
    out = args.out
    if args.remediation and not args.tier1:
        # A/B axis: set the one key beside the matrix's records
        ab_rec = asyncio.run(run_remediation_ab(device=args.device))
        try:
            with open(out) as f:
                banked = json.load(f)
        except (OSError, ValueError):
            banked = {}
        banked["remediation_ab"] = ab_rec
        with open(out, "w") as f:
            json.dump(banked, f, indent=1)
            f.write("\n")
        print(
            f"banked {out} remediation_ab: improved="
            f"{ab_rec['improved_faulted']}, "
            f"{len(ab_rec['actions'])} action events"
        )
        return
    record = asyncio.run(run_matrix(args.tier1, device=args.device))
    record["code_sha"] = _code_fingerprint()
    record["measured_at"] = time.strftime(
        "%Y-%m-%d %H:%M:%S", time.gmtime()
    )
    if args.tier1:
        print(json.dumps(record, indent=1))
        return
    try:
        with open(out) as f:
            prior = json.load(f)
    except (OSError, ValueError):
        prior = {}
    if "remediation_ab" in prior:
        # a full re-measure keeps the A/B axis
        record["remediation_ab"] = prior["remediation_ab"]
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"banked {out}: {len(record['scenarios'])} scenarios, "
          f"wall {record['wall_secs']}s")


if __name__ == "__main__":
    main()
