"""Churn-detection sweep of the partial-view tick on the card — the port's
copy of `scripts/churn_sweep.py`.

    python -m corrosion_tpu_torch.churn_sweep [n] [slots] [--out PATH]
                                                    (default 8192 512)

Per configuration (the script's seven: baseline, ae8, pb16, mt20,
pb16-mt20, ae8-pb16-mt20, lifeguard), at `PViewParams(n, K,
feeds_per_tick=8, feed_entries=max(16, K // 16), tie_epoch=512)` plus
the configuration's overrides: fingers seeds from `PRNGKey(0)`, then
`PRNGKey(1)` split once per 10-tick dispatch of `swim_pview.tick_n`,
with the stats read after every dispatch. The boot stops at the script's
three-term bar (pv_coverage >= 0.99, min in-degree >= 8, FP 0; no
saturation term) within 1,500 ticks; then 1 % of the members crash
(`default_rng(7).choice(n, n // 100)`) and it ticks until every crash is
detected, within 3,000 ticks. A false positive under churn ends the
configuration early, as in the script.

One JSON line per configuration, then the list; the records are merged
into `--out` (by `rung`) only when that is given. Run it as a module
from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim_pview
from corrosion_tpu_torch.pview_converge import stats_row
from corrosion_tpu_torch.runtime.device import card_line, resolve_device
from corrosion_tpu_torch.runtime.records import merge_records

CHUNK = 10
QUORUM = 8
BOOT_CAP = 1500
CHURN_CAP = 3000
CONFIGS = [
    ("baseline", {}),
    ("ae8", {"antientropy": 8}),
    ("pb16", {"piggyback": 16}),
    ("mt20", {"max_transmissions": 20}),
    ("pb16-mt20", {"piggyback": 16, "max_transmissions": 20}),
    ("ae8-pb16-mt20", {"antientropy": 8, "piggyback": 16,
                       "max_transmissions": 20}),
    # Lifeguard on: what the suspicion ceiling costs in detect-all ticks
    # when the churned members really are dead
    ("lifeguard", {"lhm_max": 8}),
]


def run_config(label: str, n: int, slots: int, device=None,
               **overrides) -> dict:
    """One configuration, the script's `run_config`; its record, or an
    `error` record where the boot never converged or a false positive
    showed under churn."""
    dev = resolve_device(device)
    params = swim_pview.PViewParams(
        n=n, slots=slots, feeds_per_tick=8,
        feed_entries=max(16, slots // 16), tie_epoch=512, **overrides
    )
    state = swim_pview.init_state(params, jr.PRNGKey(0), seed_mode="fingers",
                                  device=dev)
    rng = jr.PRNGKey(1)

    def advance(s, key):
        return swim_pview.tick_n(s, key, params, CHUNK)

    # bootstrap to convergence
    ticks = 0
    converged = False
    while ticks < BOOT_CAP:
        rng, key = jr.split(rng)
        state = advance(state, key)
        ticks += CHUNK
        st = swim_pview.membership_stats(state, params)
        converged = (
            st["pv_coverage"] >= 0.99
            and st["min_in_degree"] >= QUORUM
            and st["false_positive"] == 0.0
        )
        if converged:
            break
    if not converged:
        return {"label": label, "error": "no bootstrap convergence",
                "boot_ticks": ticks}
    boot_stats = st

    # 1% churn -> detect-all
    kill = np.random.default_rng(7).choice(n, size=n // 100, replace=False)
    state = swim_pview.set_alive_many(state, kill, False)
    t0 = time.monotonic()
    det_ticks = 0
    detected = False
    while det_ticks < CHURN_CAP:
        rng, key = jr.split(rng)
        state = advance(state, key)
        det_ticks += CHUNK
        st = swim_pview.membership_stats(state, params)
        if st["false_positive"] > 0:
            return {"label": label, "error": "false positive under churn",
                    "stats": {k: round(v, 5) for k, v in st.items()}}
        if st["detected"] >= 1.0:
            detected = True
            break
    wall = time.monotonic() - t0
    rec = {
        "rung": f"{label}-{n}",
        "label": label,
        "n": n, "slots": slots,
        "overrides": overrides,
        "boot_ticks": ticks,
        "detect_all_ticks": det_ticks if detected else None,
        "churn_wall_s": round(wall, 1),
        "s_per_tick": round(wall / max(1, det_ticks), 4),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        **card_line(dev),
        "raw": {"boot_stats": boot_stats, "churn_stats": st,
                "events": state.events.cpu().numpy().astype(np.uint32)
                .tolist()},
    }
    print(json.dumps(rec), flush=True)
    return rec


def checked(rec: dict) -> tuple:
    """What a reference run of one configuration must equal: boot and
    detection ticks, the stats at each end as float32, the event totals
    (or the error record as it stands)."""
    if "error" in rec:
        return (rec["label"], rec["error"])
    raw = rec["raw"]
    return (rec["label"], rec["boot_ticks"], rec["detect_all_ticks"],
            stats_row(raw["boot_stats"]), stats_row(raw["churn_stats"]),
            tuple(raw["events"]))


def run(n: int = 8192, slots: int = 512, device=None) -> List[dict]:
    """The script's sweep over `CONFIGS`."""
    dev = resolve_device(device)
    out = []
    for label, ov in CONFIGS:
        print(f"--- {label} ---", flush=True)
        out.append(run_config(label, n, slots, device=dev, **ov))
    for r in out:
        r.setdefault("rung", f"{r['label']}-{n}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8192)
    ap.add_argument("slots", nargs="?", type=int, default=512)
    ap.add_argument("--out", help="merge the records into this JSON list "
                                  "file (by 'rung')")
    args = ap.parse_args(argv)
    out = run(args.n, args.slots)
    if args.out:
        merge_records(args.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
