"""The kernel half of the observability report on the card — the port's
copy of `scripts/obs_report.py`'s pview boot and its registry and flight
renders.

    python -m corrosion_tpu_torch.obs_report [--n 2048] [--slots 256]
                                             [--max-ticks 600] [--out PATH]

A `PViewClusterSim(n, slots=K, seed=0, seed_mode="fingers",
feeds_per_tick=4, feed_entries=max(16, K // 16), tie_epoch=512)` boots
through `run_until_converged(max_ticks, check_every=25)`, draining the
device event lane and flight ring into a registry and a flight recorder
at each check; then the report renders, in the script's fixed-width
layout:

- the kernel event totals (`corro.kernel.events.total`) with their
  per-tick rates, and the kernel phase gauges
  (`corro.kernel.phase.seconds`): `render_registry_tables`;
- the flight recorder's last 64 ticks, one sparkline with min, max and
  last per lane: `render_flight_section`.

Then the script's host sections (`run_host`), which boot port agents on
the in-memory network, their stores' decision program on the card, in
the script's layout:

- the SLO plane: a two-agent workload of cross-node writes under a
  subscription with the canary on both nodes, then the per-stage
  write-to-event percentiles and the canary's round trips:
  `render_slo_section` (`_run_e2e_workload`);
- the trace store's slowest kept traces: `render_traces_section`;
- a two-node partition replayed through `models/cluster.py::
  cluster_observatory_scenario`: digest coverage and the divergence
  timeline, `render_cluster_section`;
- the default rule pack over a TSDB sampled from the registry:
  `render_alerts_section`.

The text is printed, and written to `--out` only when that is given.
Run it as a module from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import io
import sys
import time
from typing import Optional, Sequence

from corrosion_tpu_torch.bench_smoke import new_sim
from corrosion_tpu_torch.runtime.device import card_line, resolve_device
from corrosion_tpu_torch.runtime.metrics import (
    EVENTS_BY_KERNEL,
    METRICS,
    Registry,
    kernel_event_totals,
)
from corrosion_tpu_torch.runtime.records import FLIGHT, FlightRecorder


def render_registry_tables(emit, ticks_run: int,
                           registry: Registry = METRICS) -> None:
    """The event totals and phase gauges of `registry`, in the script's
    fixed-width table style."""
    totals = kernel_event_totals(registry)
    emit("## kernel event totals (corro.kernel.events.total)")
    emit(f"{'kernel':<12} {'event':<20} {'total':>14} {'per_tick':>12}")
    for kernel in sorted(totals):
        order = {n: i for i, n in enumerate(EVENTS_BY_KERNEL.get(kernel, ()))}
        for event in sorted(totals[kernel], key=lambda e: order.get(e, 99)):
            v = totals[kernel][event]
            per_tick = v / ticks_run if ticks_run else 0.0
            emit(
                f"{kernel:<12} {event:<20} {v:>14.0f} {per_tick:>12.2f}"
            )
    emit()

    emit("## kernel phase gauges (corro.kernel.phase.seconds)")
    emit(f"{'kernel':<12} {'phase':<32} {'ms':>12}")
    for kind, name, labels, value in sorted(
        registry.snapshot(), key=lambda r: (r[1], sorted(r[2].items()))
    ):
        if kind == "gauge" and name == "corro.kernel.phase.seconds":
            emit(
                f"{labels.get('kernel', '?'):<12} "
                f"{labels.get('phase', '?'):<32} {value * 1e3:>12.3f}"
            )
    emit()


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values) -> str:
    """Unicode block sparkline of a numeric sequence (flat -> all ▁)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in vals
    )


# the per-tick shapes an operator reads first: dissemination pressure,
# loss and overflow, and the suspicion -> down -> refute lifecycle
_FLIGHT_EVENT_LANES = (
    "gossip_emitted", "gossip_lost", "inbox_overflowed", "merge_won",
    "suspect_raised", "down_declared", "refuted",
)
_FLIGHT_CENSUS_LANES = (
    "census_alive", "census_suspect", "census_down",
    "inbox_highwater", "inc_max",
)


def render_flight_section(emit, kernel: str = "pview", window: int = 64,
                          flight: FlightRecorder = FLIGHT) -> None:
    """The recorder's tick-resolved timeline: one sparkline with min, max
    and last per lane over the last `window` frames of `kernel`."""
    frames = flight.window(window, kernel=kernel)
    emit(f"## flight recorder — last {len(frames)} ticks "
         f"(kernel={kernel}, corro.flight.*)")
    if not frames:
        emit("(no frames drained)")
        emit()
        return
    t0, t1 = frames[0]["tick"], frames[-1]["tick"]
    emit(f"ticks {t0}..{t1}; per-tick event deltas then census levels")
    emit(f"{'lane':<20} {'min':>8} {'max':>8} {'last':>8}  trend")
    for group, lanes in (
        ("events", _FLIGHT_EVENT_LANES),
        ("census", _FLIGHT_CENSUS_LANES),
    ):
        for lane in lanes:
            series = [f[group].get(lane, 0) for f in frames]
            emit(
                f"{lane:<20} {min(series):>8} {max(series):>8} "
                f"{series[-1]:>8}  {sparkline(series)}"
            )
    emit()


def run(n: int = 2048, slots: int = 256, max_ticks: int = 600,
        device=None) -> dict:
    """The script's pview boot and its two kernel renders; returns
    {"text", "stable_tick", "ticks", "stats", "wall_s"}. The frames go to
    a fresh recorder; the event totals go to the process-global
    registry, as the sim publishes them."""
    dev = resolve_device(device)
    recorder = FlightRecorder()
    out = io.StringIO()

    def emit(line: str = "") -> None:
        print(line, flush=True)
        out.write(line + "\n")

    card = card_line(dev)
    emit("# observability report (device telemetry lane -> registry render)")
    emit(f"platform={'gpu' if dev.type == 'cuda' else dev.type} "
         f"device={card['device_kind']} power_limit_w={card['power_limit_w']}"
         f" n={n} slots={slots} max_ticks={max_ticks}")
    emit("measured_at="
         + time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()) + " UTC")
    emit()

    t0 = time.monotonic()
    sim = new_sim(n, slots, 0, dev)  # the bench smoke's sim
    sim.flight = recorder
    stable_tick = sim.run_until_converged(max_ticks=max_ticks, check_every=25)
    wall = time.monotonic() - t0
    stats = sim.stats()  # final drain of the lane

    emit(
        f"workload: pview boot to the four-term bar — stable_tick="
        f"{stable_tick} wall={wall:.2f}s "
        f"pv_coverage={stats['pv_coverage']:.4f} "
        f"fp={stats['false_positive']:.0f}"
    )
    emit()
    render_registry_tables(emit, sim.ticks)
    render_flight_section(emit, kernel="pview", flight=recorder)
    return {"text": out.getvalue(), "stable_tick": stable_tick,
            "ticks": sim.ticks, "stats": stats, "wall_s": wall}



def _run_e2e_workload(writes: int, device=None) -> None:
    """Drive the write→event path so the SLO section has real samples:
    two in-process agents over a mem network, an HTTP subscription on B,
    `writes` cross-node writes on A, and the canary probe running on
    both nodes for a few cycles (its remote rows measure cross-node
    latency from the embedded origin wall stamp). The stores' decision
    program runs on `device` (None: the card); the databases live in a
    temporary directory."""
    import asyncio
    import tempfile

    # a denser lottery than the production default (1/64 would keep ~0
    # of this tiny workload's traces): the report's slowest-traces table
    # should show real rows, and breach/error keeps are unaffected
    from corrosion_tpu_torch.runtime import tracestore
    from corrosion_tpu_torch.runtime.config import SloConfig

    tracestore.configure(targets=SloConfig().targets, lottery_n=4)

    async def workload() -> None:
        from corrosion_tpu_torch.agent.run import (
            canary_loop,
            make_broadcastable_changes,
            run,
            setup,
            shutdown,
        )
        from corrosion_tpu_torch.api.http import ApiServer
        from corrosion_tpu_torch.client import CorrosionApiClient
        from corrosion_tpu_torch.net.mem import MemNetwork
        from corrosion_tpu_torch.runtime.config import Config

        db_dir = tempfile.TemporaryDirectory(prefix="obs_e2e")
        net = MemNetwork(seed=41)
        agents, apis, clients = [], [], []

        async def boot(name: str, bootstrap=()):
            cfg = Config()
            cfg.db.path = f"{db_dir.name}/{name}.db"
            cfg.gossip.bind_addr = name
            cfg.gossip.bootstrap = list(bootstrap)
            cfg.perf.broadcast_interval_ms = 20
            cfg.perf.apply_queue_timeout_ms = 5
            cfg.api.bind_addr = ["127.0.0.1:0"]
            a = await setup(cfg, network=net, device=device)
            a.store.apply_schema_sql(
                "CREATE TABLE obs_e2e "
                "(id INTEGER NOT NULL PRIMARY KEY, text TEXT);"
            )
            await run(a)
            api = ApiServer(a)
            await api.start()
            agents.append(a)
            apis.append(api)
            clients.append(CorrosionApiClient(api.addrs[0]))
            return a

        a = await boot("obs-a")
        b = await boot("obs-b", ["obs-a"])
        canaries = []
        try:
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 15
            while (
                len(a.members) < 1 or len(b.members) < 1
            ) and loop.time() < deadline:
                await asyncio.sleep(0.02)
            stream = clients[1].subscribe("SELECT id, text FROM obs_e2e")
            it = stream.__aiter__()
            while True:
                ev = await asyncio.wait_for(it.__anext__(), 10)
                if "eoq" in ev:
                    break
            for ag in (a, b):
                ag.config.slo.canary = True
                ag.config.slo.canary_interval_secs = 0.25
                canaries.append(asyncio.ensure_future(canary_loop(ag)))
            got = 0
            for i in range(writes):
                await make_broadcastable_changes(
                    a,
                    lambda tx, i=i: [
                        tx.execute(
                            "INSERT OR REPLACE INTO obs_e2e (id, text) "
                            "VALUES (?, ?)",
                            [i, f"w{i}"],
                        )
                    ],
                )
                while got <= i:
                    ev = await asyncio.wait_for(it.__anext__(), 10)
                    if "change" in ev:
                        got += 1
            await asyncio.sleep(1.5)  # a few canary cycles on each node
        finally:
            for c in canaries:
                c.cancel()
            for c in canaries:
                try:
                    await c
                except (asyncio.CancelledError, Exception):
                    pass
            for cl in clients:
                await cl.close()
            for api in apis:
                await api.stop()
            for ag in agents:
                await shutdown(ag)
            db_dir.cleanup()

    asyncio.run(workload())


def render_slo_section(emit, writes: int = 30, device=None) -> None:
    """r11: the SLO latency plane — run a tiny e2e workload, then render
    the per-stage write→event percentile table (what GET /v1/slo serves)
    and the canary's measured round-trip sparkline."""
    from corrosion_tpu_torch.runtime import latency as lat

    before = lat.snapshot_stages(METRICS)
    frames_before = len(FLIGHT.window(10_000, kernel="canary"))
    _run_e2e_workload(writes, device)
    rep = lat.stage_report(before=before, registry=METRICS)

    emit("## SLO latency plane (corro.e2e.*, write→event hop stamps)")
    emit(
        f"two-agent mem-net workload: {writes} cross-node writes + the "
        "canary probe on both nodes; per-stage percentiles in ms "
        "(~5 % log-bucket resolution, GET /v1/slo serves the same rows)"
    )

    def ms(v) -> str:
        return f"{v * 1e3:>9.3f}" if v is not None else f"{'—':>9}"

    emit(
        f"{'stage':<10} {'count':>6} {'p50':>9} {'p90':>9} {'p99':>9} "
        f"{'p999':>9} {'mean':>9}"
    )
    for stage in lat.E2E_STAGES:
        row = rep[stage]
        emit(
            f"{stage:<10} {row['count']:>6} "
            + " ".join(
                ms(row[k]) for k in ("p50", "p90", "p99", "p999", "mean")
            )
        )
    skew = sum(
        v
        for _k, name, labels, v in METRICS.snapshot()
        if name == "corro.e2e.skew.clamped.total"
    )
    emit(f"skew_clamped_total={skew:.0f}")
    emit()

    frames = FLIGHT.window(10_000, kernel="canary")[frames_before:]
    emit("## canary round trips (corro.e2e.canary.seconds)")
    if not frames:
        emit("(no canary frames recorded)")
        emit()
        return
    series = [f["events"].get("lat_us", 0) / 1e3 for f in frames]
    remote = sum(f["events"].get("remote", 0) for f in frames)
    emit(
        f"{len(series)} probes ({remote} cross-node); ms "
        f"min={min(series):.3f} max={max(series):.3f} "
        f"last={series[-1]:.3f}"
    )
    emit(f"trend {sparkline(series[-64:])}")
    emit()


def render_traces_section(emit, n: int = 8) -> None:
    """r19: the tail sampler's slowest kept traces — per-trace stage
    breakdown (the same rows GET /v1/traces serves), rendered after the
    SLO section's e2e workload so the kept ring holds that workload's
    lottery/breach winners."""
    from corrosion_tpu_torch.runtime import tracestore

    st = tracestore.store()
    emit("## slowest kept traces (corro.trace.*, GET /v1/traces)")
    if st is None:
        emit("(trace plane not configured)")
        emit()
        return
    st.sweep(now=st._clock() + st.idle_close_secs + 1)  # close stragglers
    census = st.census()
    emit(
        f"kept={census['kept_total']} dropped={census['dropped_total']} "
        f"lottery=1/{census['lottery_n']} "
        f"idle_close={census['idle_close_secs']}s"
    )
    traces = st.kept(n=n)
    if not traces:
        emit("(no traces kept)")
        emit()
        return
    emit(
        f"{'trace_id':<16} {'ms':>9} {'reason':<12} {'spans':>5} "
        f"{'hops':>4}  stage breakdown (sum ms)"
    )
    for t in traces:
        breakdown = " ".join(
            f"{stage}={row['seconds'] * 1e3:.2f}"
            for stage, row in t["stages"].items()
        )
        emit(
            f"{t['trace_id'][:16]:<16} {t['duration_secs'] * 1e3:>9.3f} "
            f"{t['reason']:<12} {t['n_spans']:>5} {t['hops']:>4}  "
            f"{breakdown}"
        )
    emit()


def render_alerts_section(emit) -> None:
    """r20: the alerting plane — sample the now-populated registry into
    a short-ring TSDB, evaluate the default rule pack, and render the
    rule-state table (the same rows GET /v1/alerts serves).  A healthy
    report shows every rule ok with its current evaluation value; the
    point here is the end-to-end plumbing registry → TSDB → rules."""
    from corrosion_tpu_torch.runtime.alerts import AlertEngine
    from corrosion_tpu_torch.runtime.config import AlertsConfig
    from corrosion_tpu_torch.runtime.tsdb import MetricsTSDB

    db = MetricsTSDB(
        registry=METRICS, sample_interval_secs=0.05, slots=64
    )
    eng = AlertEngine(
        tsdb=db, cfg=AlertsConfig(for_scale=0.01), registry=METRICS
    )
    for _ in range(4):  # a few ticks so counters get real rate points
        db.sample_once()
        time.sleep(0.06)
        eng.evaluate()
    rep = eng.report(history=True)
    c = db.census()

    emit("## alerting plane (corro.alerts.* / corro.tsdb.*, "
         "GET /v1/alerts)")
    emit(
        f"tsdb: {c['series']} series / {c['points']} points over "
        f"{c['samples']} samples; local health score "
        f"{rep['health_score']} (for-duration widening "
        f"×{1 + rep['health_score']:.2f})"
    )
    emit(
        f"{'rule':<20} {'sev':<5} {'kind':<10} {'state':<8} "
        f"{'value':>12}  series"
    )
    for r in rep["rules"]:
        v = "—" if r["value"] is None else f"{r['value']:.4g}"
        emit(
            f"{r['rule']:<20} {r['severity']:<5} {r['kind']:<10} "
            f"{r['state']:<8} {v:>12}  {r['series']}"
        )
    for h in rep.get("history", []):
        emit(
            f"  transition: {h['rule']} {h['event']}"
            + (f" [drill: {h['drill']}]" if h.get("drill") else "")
        )
    emit()


def render_cluster_section(emit, writes: int = 6, device=None) -> None:
    """r12: the cluster observatory — replay a two-node mem-net
    partition through the shared scenario harness and render what the
    gossiped digests saw: the any-node digest coverage table (what
    `GET /v1/cluster` serves per node) and the divergence detector's
    round-by-round timeline across fault and heal."""
    import asyncio

    from corrosion_tpu_torch.models.cluster import cluster_observatory_scenario

    timeline: list = []
    rec = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(
            cluster_observatory_scenario(
                "partition", seed=73, nodes=2, writes=writes,
                hold_secs=1.5, timeline=timeline, device=device,
            ),
            240,
        )
    )

    emit("## cluster observatory (corro.cluster.* / corro.digest.*, "
         "GET /v1/cluster)")
    emit(
        f"two-node mem-net partition replay: {writes} cross-node writes, "
        f"digest interval {rec['digest_interval_secs']}s; partition "
        f"detected in {rec['detect_rounds']} digest rounds "
        f"({rec['detect_secs']}s), cleared {rec['heal_rounds']} rounds "
        f"after heal; {rec['episodes_total']} episode(s), one incident "
        "dump each"
    )
    emit()
    emit("digest coverage at full aggregation (pre-fault):")
    emit(
        f"{'node':<26} {'fresh':>5} {'seq':>5} {'age_s':>7} "
        f"{'view':>7} {'samples':>8}  view_hash"
    )
    for name, row in sorted(rec["nodes_report"].items()):
        emit(
            f"{name:<26} {str(row['fresh']):>5} {row['seq']:>5} "
            f"{row['age_secs']:>7.3f} {row['view_size']:>7} "
            f"{sum(row['stage_counts'].values()):>8}  "
            f"{row['view_hash']}"
        )
    emit()
    emit("divergence timeline (one row per digest round, t from fault "
         "or heal):")
    emit(f"{'t':>6} {'groups':>7} {'silent':>7} {'episode':>8}")
    for row in timeline[-24:]:
        emit(
            f"{row['t']:>6.2f} {row['groups']:>7} {row['silent']:>7} "
            f"{'OPEN' if row['episode_open'] else '-':>8}"
        )
    emit(
        "episode trend "
        + sparkline([int(r["episode_open"]) for r in timeline])
    )
    emit()

def run_host(device=None, e2e_writes: int = 30,
             cluster_writes: int = 6) -> dict:
    """The script's host sections, in its order (SLO, traces, cluster,
    alerts); returns {"text", "wall_s"}. They boot port agents on the
    in-memory network, their stores' decision program on `device`."""
    dev = resolve_device(device)
    out = io.StringIO()

    def emit(line: str = "") -> None:
        print(line, flush=True)
        out.write(line + "\n")

    t0 = time.monotonic()
    render_slo_section(emit, writes=e2e_writes, device=dev)
    render_traces_section(emit)
    render_cluster_section(emit, writes=cluster_writes, device=dev)
    render_alerts_section(emit)
    return {"text": out.getvalue(), "wall_s": time.monotonic() - t0}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--max-ticks", type=int, default=600)
    ap.add_argument("--out", help="write the report to this file")
    args = ap.parse_args(argv)
    rep = run(args.n, args.slots, args.max_ticks)
    host = run_host()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(rep["text"] + host["text"])
    return rep


if __name__ == "__main__":
    sys.exit(0 if main()["stable_tick"] is not None else 1)
