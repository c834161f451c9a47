"""The kernel phases and the cluster-observatory phase of the chaos soak
on the card — the port's copy of `scripts/chaos_soak.py`'s
`kernel_flight_phase`, `flaky_node_phase` and `cluster_obs_phase`.

    python -m corrosion_tpu_torch.chaos_soak [--out PATH]
    python -m corrosion_tpu_torch.chaos_soak --phase cluster

- `kernel_flight_phase`: a pview cluster (n=256, K=64, 2 feeds of 16,
  suspicion 4, fingers seeds) boots through `run_until_converged(400,
  25)`, 3 % of its members crash, and it steps 10 ticks at a time until
  every crash is detected with FP 0 (at most 200 ticks); the answer is
  the suspicion/down/refute timeline of the flight recorder's frames
  since the crash, which must show a down declaration.
- `flaky_node_phase`: `flaky_node_ab` on the dense tick (n=96, member 1
  lagging 2 ticks for 240 ticks, then member 2 crashed) at each seed,
  with the script's four inequalities asserted: Lifeguard cuts false
  suspicions and wrongful downs at least 5x, and still detects the crash
  within 2x the vanilla ticks.

Each phase publishes its frames into a fresh `FlightRecorder`, so
frames that other sims in the same process left in the global `FLIGHT`
cannot enter its timeline.

- `cluster_obs_phase`: `models/cluster.py::cluster_observatory_scenario`
  on three port agents under quiet, partition then heal, and churn, each
  with a fresh `$CORRO_FLIGHT_DIR`: the `cluster_divergence` incident
  dumps must equal the divergence episodes the agents recorded. With
  `--phase cluster` it runs alone and its record is written to
  `CLUSTER_OBS_H100.json` at the repo root (the banked `CLUSTER_OBS.json`
  is the JAX package's and is never written).

The invariant soak and the SLO baseline (`slo_baseline_phase`, which
needs the JAX package's `DevCluster`) are not ported (ROADMAP §1 item
9.6). One JSON line is printed; it is written to `--out` only when that
is given. Run it as a module from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from corrosion_tpu_torch.models.cluster import (
    PViewClusterSim,
    cluster_observatory_scenario,
    flaky_node_ab,
)
from corrosion_tpu_torch.pview_converge import timeline_digest
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.records import FlightRecorder


def kernel_flight_phase(seed: int = 7, device=None) -> dict:
    """Kernel-level churn episode with a tick-resolved verdict (the
    script's body)."""
    dev = resolve_device(device)
    recorder = FlightRecorder()
    n = 256
    sim = PViewClusterSim(
        n, slots=64, seed=seed, seed_mode="fingers", device=dev,
        feeds_per_tick=2, feed_entries=16, suspicion_ticks=4,
    )
    sim.flight = recorder
    sim.run_until_converged(max_ticks=400, check_every=25)
    kill = np.random.default_rng(seed).choice(
        n, size=max(1, n * 3 // 100), replace=False
    )
    base = sim.ticks
    sim.crash_many(kill)
    det = None
    while sim.ticks - base < 200:
        sim.step(10)
        cs = sim.stats()  # drains the ring into the recorder as it goes
        if cs["detected"] >= 1.0 and cs["false_positive"] == 0.0:
            det = sim.ticks - base
            break
    timeline = [
        {
            "tick": f["tick"] - base,
            "suspect_raised": f["events"]["suspect_raised"],
            "down_declared": f["events"]["down_declared"],
            "refuted": f["events"]["refuted"],
            "open_timers": f["census"]["census_suspect"],
        }
        for f in recorder.window(4096, kernel="pview")
        if f["tick"] >= base
        and (
            f["events"]["suspect_raised"]
            or f["events"]["down_declared"]
            or f["events"]["refuted"]
        )
    ][-128:]
    assert det is not None, "kernel flight phase: churn never detected"
    assert any(r["down_declared"] for r in timeline), (
        "flight ring shows no down_declared tick for a detected churn"
    )
    return {
        "n": n,
        "killed": int(len(kill)),
        "detect_ticks": det,
        "timeline": timeline,
    }


def flaky_node_phase(seeds=(3, 11), device=None) -> dict:
    """The Lifeguard A/B at each seed, the script's inequalities
    asserted before the result is returned."""
    dev = resolve_device(device)
    recorder = FlightRecorder()
    runs = []
    for seed in seeds:
        r = flaky_node_ab(
            kernel="dense", seed=seed, n=96, boot_ticks=40, window=240,
            lag=2, chunk=20, detect_chunk=5, drain_flight=True,
            flight=recorder, device=dev,
        )
        v, lf = r["vanilla"], r["lifeguard"]
        assert v["suspect_fp"] >= 5 * max(1, lf["suspect_fp"]), (
            f"seed {seed}: FP suspicions did not collapse 5x: {r}"
        )
        assert v["down_fp"] >= 5 * max(1, lf["down_fp"]), (
            f"seed {seed}: wrongful downs did not collapse 5x: {r}"
        )
        assert v["detect_ticks"] is not None and lf["detect_ticks"], (
            f"seed {seed}: crash never detected: {r}"
        )
        assert lf["detect_ticks"] <= 2 * v["detect_ticks"], (
            f"seed {seed}: lifeguard detection too slow: {r}"
        )
        assert lf["timeline"], f"seed {seed}: no flight timeline: {r}"
        runs.append(r)
        print(
            f"flaky-node seed {seed}: suspect_fp {v['suspect_fp']} -> "
            f"{lf['suspect_fp']}, down_fp {v['down_fp']} -> "
            f"{lf['down_fp']}, detect {v['detect_ticks']} -> "
            f"{lf['detect_ticks']}", flush=True,
        )
    return {"scenario": "one member lag=2 ticks, alive throughout",
            "runs": runs}


def checked(kernel_flight: dict, flaky: dict) -> dict:
    """What a reference run of both phases must equal: the flight
    phase's crash count, detection ticks and timeline (row count and
    digest), and per A/B seed each mode's counts, detection ticks and
    timeline digest."""
    keys = ("suspect_fp", "down_fp", "suspect_raised", "refuted",
            "confirmations", "lhm_degraded", "detect_ticks", "detect_base")
    tl = kernel_flight["timeline"]
    return {
        "kernel_flight": (kernel_flight["killed"],
                          kernel_flight["detect_ticks"], len(tl),
                          timeline_digest(tl)),
        "flaky": [(r["seed"],) + tuple(
            tuple(r[m][k] for k in keys) + (timeline_digest(r[m]["timeline"]),)
            for m in ("vanilla", "lifeguard")) for r in flaky["runs"]],
    }


def cluster_obs_phase(device=None) -> dict:
    """The cluster-observatory baseline: quiet, partition then heal, and
    churn on three port agents through the shared scenario harness, whose
    own checks pin exact cluster aggregation; here each scenario also
    runs with a fresh `$CORRO_FLIGHT_DIR`, and its `cluster_divergence`
    incident dumps must equal its divergence episodes (one per episode,
    none in quiet)."""
    dev = resolve_device(device)
    out: dict = {"scenarios": {}}
    for i, name in enumerate(("quiet", "partition", "churn")):
        with tempfile.TemporaryDirectory() as flight_dir:
            old = os.environ.get("CORRO_FLIGHT_DIR")
            os.environ["CORRO_FLIGHT_DIR"] = flight_dir
            try:
                t0 = time.monotonic()
                timeline: list = []
                rec = asyncio.new_event_loop().run_until_complete(
                    asyncio.wait_for(
                        cluster_observatory_scenario(
                            name, seed=211 + i, timeline=timeline,
                            device=dev,
                        ),
                        300,
                    )
                )
                rec["wall_s"] = round(time.monotonic() - t0, 1)
                dumps = len(glob.glob(
                    os.path.join(flight_dir, "*cluster_divergence*")))
            finally:
                if old is None:
                    os.environ.pop("CORRO_FLIGHT_DIR", None)
                else:
                    os.environ["CORRO_FLIGHT_DIR"] = old
        expected_dumps = rec.get("episodes_total", 0)
        assert dumps == expected_dumps, (
            f"cluster obs {name}: {dumps} incident dumps for "
            f"{expected_dumps} divergence episodes"
        )
        rec["incident_dumps"] = dumps
        rec["timeline"] = timeline[-64:]
        out["scenarios"][name] = rec
        msg = f"cluster obs {name}: coverage_rounds={rec['coverage_rounds']}"
        if "detect_rounds" in rec:
            msg += (
                f" detect_rounds={rec['detect_rounds']}"
                f" ({rec['detect_secs']}s)"
                f" heal_rounds={rec['heal_rounds']}"
                f" episodes={rec['episodes_total']} dumps={dumps}"
            )
        print(msg, flush=True)
    return out


# the port's cluster-observatory record, beside the JAX package's banked
# CLUSTER_OBS.json (git-ignored: a card run's output)
CLUSTER_OBS_OUT = Path(__file__).resolve().parent.parent / "CLUSTER_OBS_H100.json"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the record to this JSON file")
    ap.add_argument("--phase", choices=("kernel", "cluster"), default="kernel",
                    help="kernel: the flight and Lifeguard phases (default); "
                         "cluster: the observatory phase, written to "
                         "CLUSTER_OBS_H100.json")
    args = ap.parse_args(argv)
    dev = resolve_device()
    if args.phase == "cluster":
        rec = cluster_obs_phase(device=dev)
        rec["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
        with open(args.out or CLUSTER_OBS_OUT, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec), flush=True)
        return rec
    rec = {"kernel_flight": kernel_flight_phase(device=dev),
           "flaky_node": flaky_node_phase(device=dev)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
