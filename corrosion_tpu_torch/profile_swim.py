"""Per-phase time of the dense SWIM tick on the card — the port's copy of
`scripts/profile_swim.py`.

    python -m corrosion_tpu_torch.profile_swim [n] [feeds] [--out PATH]
                                    (default 10000, max(4, n // 1250))

At `SwimParams(n=n, feeds_per_tick=feeds)` (the kernel's defaults
otherwise: shift gossip, 16 incoming slots, feed windows of 25) it times
the whole tick and the phases the reference's phase jits cut out of it:

  - tick(1), tick_n(50)/50: whole ticks, chained on one state;
  - pick:    `_pick_known_alive` target selection (4 tries);
  - inbox:   the flat inbox build (stable sort by destination, ranks,
             [N, R] scatter) over M = n * fanout * (piggyback +
             antientropy) messages, then the grouped [G, m] form through
             each implementation: sort, gsort and the Hopper kernel
             ("cuda", the reference's "pallas" rows);
  - tick(1)[impl]: the whole tick with each `inbox_impl` (in the default
             shift mode the inbox is not dispatched, so these rows are
             the tick(1) row again: a check of the table itself);
  - viewupd: the row-aligned gather and scatter-max of an [N, R] inbox
             into the view;
  - feed:    one feed exchange (partner pick, window pull at column 0),
             and times `feeds` as the tick runs it;
  - bufmrg:  `_buffer_merge`'s packed row sorts;
  - stats:   `membership_stats` with its readback.

Each row is the median of its timed calls, with their min and max, after
warm-up calls outside the window; on the card each call is timed by CUDA
events around it, the card idle before each (stream time: a phase bound
by host launches shows its launch time). The phases update the view in
place as the tick does, so their inputs differ from call to call; no row
depends on that. On the CPU (`device="cpu"`, the tests) the host clock
times the same calls and the kernel rows take the plain version. One
JSON line follows the table; it is merged into `--out` (by `name`) only
when that is given. Run it as a module from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim
from corrosion_tpu_torch.runtime.device import card_line, resolve_device
from corrosion_tpu_torch.runtime.records import merge_records

IMPLS = ("sort", "gsort", "cuda")


# ---------------------------------------------------------------------------
# the phases: each computes what the reference's phase jit computes
# (its inbox, grouped-inbox and buffer-merge phases are
# `swim.build_inbox`, `swim.dispatch_inbox` and `swim._buffer_merge`)


def ph_pick(view, key, params):
    idx = torch.arange(params.n, device=view.device)
    return swim._pick_known_alive(view, idx, key, params, 4)


def ph_viewupd(view, in_subj, in_key):
    """The inbox merged into the view (IN PLACE) by a row-aligned
    scatter-max; returns the view and the [N, R] improved mask."""
    n = view.shape[0]
    safe = torch.clamp(in_subj, 0, n - 1).long()
    eff = swim.to_view_key(torch.where(in_subj < n, in_key, 0))
    prev = view.gather(1, safe)
    improved = eff > prev
    swim._row_scatter_max_(view, safe, eff, prev)
    return view, improved


def ph_feed(view, key, params, fe):
    """One feed exchange (IN PLACE): every member pulls the window at
    column 0 of a known-alive partner's row."""
    n = params.n
    idx = torch.arange(n, device=view.device)
    partner = swim._pick_known_alive(view, idx, key, params, 2)
    psafe = torch.clamp(partner, 0, n - 1).long()
    every = torch.ones(n, dtype=torch.bool, device=view.device)
    t0 = torch.zeros((), dtype=torch.int32, device=view.device)
    swim._window_pull_(view, t0, fe, max(1, -(-n // fe)), psafe, every)
    return view


def phase_inputs(params, seed: int, device) -> Dict[str, torch.Tensor]:
    """The phases' message inputs, made with numpy from `seed`: flat
    [M] dst/subj/key, grouped [G, m] dst/subj/key/ok, and [N, R + 6]
    buffer-merge inputs."""
    n, f = params.n, params.fanout
    m = params.piggyback + params.antientropy
    rng = np.random.default_rng(seed)
    mlen, g = n * f * m, n * f
    arrays = {
        "dst": rng.integers(0, n, mlen),
        "subj": rng.integers(0, n, mlen),
        "key": rng.integers(0, 40, mlen),
        "gdst": rng.integers(0, n, g),
        "gsubj": rng.integers(0, n, (g, m)),
        "gkey": rng.integers(1, 40, (g, m)),
        "bin_subj": rng.integers(0, n + 1, (n, params.incoming_slots + 6)),
        "bin_key": rng.integers(0, 40, (n, params.incoming_slots + 6)),
    }
    out = {k: torch.from_numpy(v.astype(np.int32)).to(device)
           for k, v in arrays.items()}
    out["gok"] = torch.from_numpy(rng.random((g, m)) < 0.8).to(device)
    return out


def profiled_state(params, device):
    """The state the phases read: booted from `PRNGKey(0)` and ticked
    once with `PRNGKey(1)`, as the reference populates it."""
    state = swim.init_state(params, jr.PRNGKey(0), device=device)
    return swim.tick_impl(state, jr.PRNGKey(1), params)


# ---------------------------------------------------------------------------
# timing


def timeit(fn: Callable[[int], object], dev: torch.device, iters: int = 20,
           warmup: int = 2) -> tuple:
    """(median, min, max) ms of `fn(i)` over `iters` timed calls after
    `warmup` untimed ones: CUDA events around each call on the card (the
    card idle before each), the host clock on the CPU."""
    for i in range(warmup):
        fn(-1 - i)
    times = []
    for i in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(i)
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), min(times), max(times)


def table(n: int = 10_000, feeds: Optional[int] = None, device=None,
          iters: Optional[int] = None) -> List[dict]:
    """The phase table's rows: {"phase", "ms", "min_ms", "max_ms",
    "calls"}. `iters` replaces every row's count of timed calls and
    drops the warm-up calls, for a quick pass."""
    dev = resolve_device(device)
    feeds = feeds if feeds is not None else max(4, n // (25 * 50))
    params = swim.SwimParams(n=n, feeds_per_tick=feeds)
    state = profiled_state(params, dev)
    rng = jr.PRNGKey(0)
    rows = []

    def row(name, fn, it=20, warmup=2, scale=1.0):
        if iters is not None:
            it, warmup = iters, 0
        med, lo, hi = timeit(fn, dev, it, warmup)
        rows.append({"phase": name, "ms": med * scale, "min_ms": lo * scale,
                     "max_ms": hi * scale, "calls": it})

    held = {"state": state}

    def ticker(p, k=1):
        def fn(i):
            key = jr.fold_in(rng, i + 1_000)
            held["state"] = (swim.tick_impl(held["state"], key, p) if k == 1
                             else swim.tick_n(held["state"], key, p, k))
        return fn

    row("tick(1)", ticker(params), it=10)
    row("tick_n(50)/50", ticker(params, 50), it=3, warmup=1, scale=1 / 50)
    view = held["state"].view
    row("pick x1", lambda i: ph_pick(view, jr.fold_in(rng, i + 1_000),
                                     params))

    x = phase_inputs(params, 2, dev)
    f, m = params.fanout, params.piggyback + params.antientropy
    slots = params.incoming_slots
    row(f"inbox M={n * f * m}",
        lambda i: swim.build_inbox(n, slots, x["dst"], x["subj"], x["key"]))
    for impl in IMPLS:
        row(f"inbox[{impl}] G={n * f}",
            lambda i, impl=impl: swim.dispatch_inbox(
                impl, n, slots, x["gdst"], x["gsubj"], x["gkey"], x["gok"]))
    for impl in IMPLS:
        row(f"tick(1)[{impl}]", ticker(params._replace(inbox_impl=impl)),
            it=10)

    view = held["state"].view
    in_subj, in_key = swim.build_inbox(n, slots, x["dst"], x["subj"],
                                       x["key"])
    row(f"viewupd [N,{slots}]", lambda i: ph_viewupd(view, in_subj, in_key))
    fe = min(params.feed_entries, n)
    row("feed x1", lambda i: ph_feed(view, jr.fold_in(rng, i + 1_000),
                                     params, fe))
    one = rows[-1]
    rows.append({**one, "phase": f"feed x{feeds} (extrap)",
                 **{k: one[k] * feeds for k in ("ms", "min_ms", "max_ms")}})
    st = held["state"]
    row("bufmrg", lambda i: swim._buffer_merge(
        params, st.buf_subj, st.buf_key, st.buf_sent, x["bin_subj"],
        x["bin_key"]))
    row("stats", lambda i: swim.membership_stats(held["state"]), it=5)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=10_000)
    ap.add_argument("feeds", nargs="?", type=int, default=None)
    ap.add_argument("--out", help="merge the record into this JSON list "
                                  "file (by its 'name')")
    args = ap.parse_args(argv)
    dev = resolve_device()
    feeds = args.feeds if args.feeds is not None else max(4, args.n // 1250)
    card = card_line(dev)
    print(f"platform=gpu device={card['device_kind']} "
          f"power_limit_w={card['power_limit_w']} n={args.n} feeds={feeds}",
          flush=True)
    rows = table(args.n, feeds, dev)
    print(f"{'phase':<24} {'ms':>10} {'min ms':>10} {'max ms':>10} calls")
    for r in rows:
        print(f"{r['phase']:<24} {r['ms']:>10.3f} {r['min_ms']:>10.3f} "
              f"{r['max_ms']:>10.3f} {r['calls']:>5}")
    rec = {"name": f"profile_swim_n{args.n}", "n": args.n, "feeds": feeds,
           "platform": "gpu", **card, "rows": rows}
    if args.out:
        merge_records(args.out, [rec], key="name")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
