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

The script's SLO, traces, cluster and alerts sections boot host agents
and run no kernel; they are not ported. The text is printed, and
written to `--out` only when that is given. Run it as a module from the
repo root (`-m`).
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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--max-ticks", type=int, default=600)
    ap.add_argument("--out", help="write the report to this file")
    args = ap.parse_args(argv)
    rep = run(args.n, args.slots, args.max_ticks)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(rep["text"])
    return rep


if __name__ == "__main__":
    sys.exit(0 if main()["stable_tick"] is not None else 1)
