"""Per-phase time and peak memory of the partial-view tick on the card —
the port's copy of `scripts/pview_profile.py`.

    python -m corrosion_tpu_torch.pview_profile [n] [slots] [feeds]
        [--shapes N1xK1,N2xK2,...] [--no-ladder] [--iters N] [--out PATH]
                                                   (default 100000 2048 8)

1. **Phase table.** At `PViewParams(n, K, feeds_per_tick=feeds,
   feed_entries=max(16, K // 16), tie_epoch=512)`, on a state booted
   from `PRNGKey(0)` with fingers seeds and ticked once with
   `PRNGKey(1)` (the script's inputs), it times:

   - tick(1) in the four (fused|r5, shift|pick) combinations (pick
     builds its inbox with the Hopper kernel), and tick_n(5)/5;
   - pick:     `_pick_known_alive` (4 tries);
   - lookup:   `_lookup` of [N, 4] subjects;
   - inbox[shift]: the shift delivery's row gather and stable
               compaction to the incoming slots;
   - inbox[gsort], inbox[cuda]: the grouped build at the pick tick's
               shape (G = n * fanout packets of m = piggyback +
               antientropy), torch ops and the Hopper kernel;
   - feedpull: one partner pick and its window gather;
   - merge:    the fused tick's `_scatter_max_` chain of (feeds + 1)
               windows, into a copy of the table;
   - bufmrg:   `_buffer_merge`'s packed row sorts;
   - stats:    `membership_stats` with its readback.

   Each row is the median of its timed calls with their min and max,
   after warm-up calls outside the window, by `profile_swim.timeit`: CUDA
   events around each call on the card (stream time; a phase bound by
   host launches shows its launch time), the host clock on the CPU. The
   rows are published as `corro.kernel.phase.seconds{kernel="pview"}`.

2. **Memory ladder.** The script's second half counts XLA's live
   buffers of a compiled tick, which has no torch counterpart. Here, per
   (n, K) of `--shapes` (default: the table's) and per tick mode, a state
   is built and `torch.cuda.max_memory_allocated` is read after one tick
   and after one stats pass, each from `reset_peak_memory_stats`: the
   table's GB, the live state's, each peak and its ratio to the table.
   On the CPU the memory columns read n/a.

The text is printed, then one JSON line; the text is written to `--out`
only when that is given. Run it as a module from the repo root (`-m`).
"""

from __future__ import annotations

import argparse
import io
import json
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from corrosion_tpu_torch.pview_converge import pview_params
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim, swim_pview
from corrosion_tpu_torch.profile_swim import timeit
from corrosion_tpu_torch.runtime.device import card_line, resolve_device
from corrosion_tpu_torch.runtime.metrics import record_phase_seconds

TICK_COMBOS = (("fused", "shift"), ("fused", "pick"), ("r5", "shift"),
               ("r5", "pick"))


def profiled_state(params, device):
    """The state the phases read: booted from `PRNGKey(0)` with fingers
    seeds and ticked once with `PRNGKey(1)`, as the script populates it."""
    state = swim_pview.init_state(params, jr.PRNGKey(0), seed_mode="fingers",
                                  device=device)
    return swim_pview.tick_impl(state, jr.PRNGKey(1), params)


# ---------------------------------------------------------------------------
# the phases: each computes what the script's phase jit computes


def ph_inbox_shift(params, subj_gm, key_gm, ok_gm, off):
    """The shift delivery: row gather from the senders `off` rows back,
    then a stable compaction of the valid messages to the first
    `incoming_slots` columns."""
    n, f = params.n, params.fanout
    m = subj_gm.shape[2]
    idx = torch.arange(n, device=subj_gm.device)
    src = (idx[:, None] - off[None, :]) % n
    sub_m = torch.where(ok_gm, subj_gm, n)
    key_m = torch.where(ok_gm, key_gm, 0)
    jj = torch.arange(f, device=subj_gm.device)[None, :]
    in_subj = sub_m[src, jj].reshape(n, f * m)
    in_key = key_m[src, jj].reshape(n, f * m)
    if f * m > params.incoming_slots:
        order = torch.argsort((in_subj == n).to(torch.uint8), dim=1,
                              stable=True)
        take = order[:, : params.incoming_slots]
        in_subj = in_subj.gather(1, take)
        in_key = in_key.gather(1, take)
    return in_subj, in_key


def ph_feedpull(params, packed, mask, key):
    """One feed's partner pick and its window gather at column 0."""
    n, fe = params.n, params.feed_entries
    partner = swim_pview._pick_known_alive(params, packed, mask, key, 2)
    psafe = torch.clamp(partner, 0, n - 1).long()
    return packed[:, :fe].index_select(0, psafe)


def ph_merge(packed, mvals, mcols, fe: int):
    """The fused tick's merge chain: one scatter-max per fe-wide window,
    IN PLACE."""
    for w0 in range(0, mvals.shape[1], fe):
        swim_pview._scatter_max_(packed, mcols[:, w0: w0 + fe],
                                 mvals[:, w0: w0 + fe])
    return packed


def phase_inputs(params, seed: int, device) -> dict:
    """The phases' synthetic inputs, made with numpy from `seed` at the
    script's shapes and ranges."""
    n, k, f = params.n, params.slots, params.fanout
    m = params.piggyback + params.antientropy
    fe = params.feed_entries
    wtot = (params.feeds_per_tick + 1) * fe
    bw = params.incoming_slots + 4
    rng = np.random.default_rng(seed)
    arrays = {
        "subjs": rng.integers(0, n, (n, 4)),
        "subj_gm": rng.integers(0, n, (n, f, m)),
        "key_gm": rng.integers(1, 40, (n, f, m)),
        "gdst": rng.integers(0, n, n * f),
        "mvals": rng.integers(0, 2**30, (n, wtot)),
        "mcols": rng.integers(0, k, (n, wtot)),
        "bin_subj": rng.integers(0, n + 1, (n, bw)),
        "bin_key": rng.integers(0, 40, (n, bw)),
        "off": np.array([3, 1709]) % n,
    }
    out = {name: torch.from_numpy(v.astype(np.int32)).to(device)
           for name, v in arrays.items()}
    out["ok_gm"] = torch.from_numpy(rng.random((n, f, m)) < 0.8).to(device)
    return out


def table(n: int = 100_000, slots: int = 2048, feeds: int = 8, device=None,
          iters: Optional[int] = None) -> List[dict]:
    """The phase table's rows: {"phase", "ms", "min_ms", "max_ms",
    "calls"}. `iters` replaces every row's count of timed calls and drops
    the warm-up calls, for a quick pass."""
    dev = resolve_device(device)
    params = pview_params(n, slots, feeds=feeds)
    held = {"state": profiled_state(params, dev)}
    rng = jr.PRNGKey(0)
    it = 20 if n <= 25_000 else 6  # the script's sample counts
    rows = []

    def row(name, fn: Callable[[int], object], calls=it, warmup=1):
        if iters is not None:
            calls, warmup = iters, 0
        med, lo, hi = timeit(fn, dev, calls, warmup)
        rows.append({"phase": name, "ms": med, "min_ms": lo, "max_ms": hi,
                     "calls": calls})

    def ticker(p, k=1):
        def fn(i):
            key = jr.fold_in(rng, i + 1_000)
            held["state"] = (swim_pview.tick_impl(held["state"], key, p)
                             if k == 1 else
                             swim_pview.tick_n(held["state"], key, p, k))
        return fn

    for tm, gm in TICK_COMBOS:
        row(f"tick(1)[{tm},{gm}]", ticker(pview_params(n, slots, tm, gm,
                                                       feeds)), calls=3)
    chunk = 5
    row(f"tick_n({chunk})/{chunk} [fused,shift]", ticker(params, chunk),
        calls=2)
    rows[-1].update({k: rows[-1][k] / chunk
                     for k in ("ms", "min_ms", "max_ms")})

    state = held["state"]
    packed = state.slot_packed
    idx = torch.arange(n, device=dev)
    mask = swim_pview._mask(params, idx, 0)
    x = phase_inputs(params, 2, dev)
    row("pick x1", lambda i: swim_pview._pick_known_alive(
        params, packed, mask, jr.fold_in(rng, i + 1_000), 4))
    row("lookup [N,4]", lambda i: swim_pview._lookup(params, packed, mask,
                                                     x["subjs"]))
    f, m = params.fanout, params.piggyback + params.antientropy
    slots_in = params.incoming_slots
    row(f"inbox[shift] f*m={f * m}", lambda i: ph_inbox_shift(
        params, x["subj_gm"], x["key_gm"], x["ok_gm"], x["off"]))
    grouped = (x["gdst"], x["subj_gm"].reshape(-1, m),
               x["key_gm"].reshape(-1, m), x["ok_gm"].reshape(-1, m))
    for impl in ("gsort", "cuda"):
        row(f"inbox[{impl}] G={n * f}",
            lambda i, impl=impl: swim.dispatch_inbox(impl, n, slots_in,
                                                     *grouped))
    row("feedpull x1", lambda i: ph_feedpull(params, packed, mask,
                                             jr.fold_in(rng, i + 1_000)))
    scratch = packed.clone()
    row(f"merge scatter [N,{x['mvals'].shape[1]}]", lambda i: ph_merge(
        scratch, x["mvals"], x["mcols"], params.feed_entries))
    del scratch
    row("bufmrg", lambda i: swim._buffer_merge(
        params, state.buf_subj, state.buf_key.to(torch.int32),
        state.buf_sent.to(torch.int32), x["bin_subj"], x["bin_key"]))
    row("stats", lambda i: swim_pview.membership_stats(state, params),
        calls=3)
    for r in rows:
        record_phase_seconds("pview", r["phase"], r["ms"] / 1e3)
    return rows


def memory_ladder(shapes, feeds: int = 8, device=None) -> List[dict]:
    """Per (n, K) and tick mode: the table's GB, the live state's after
    init, and the peak allocated GB of one tick and of one stats pass,
    each from a reset (None on the CPU)."""
    dev = resolve_device(device)
    out = []
    for n, k in shapes:
        for tm in ("fused", "r5"):
            params = pview_params(n, k, tm, feeds=feeds)
            table_b = n * k * 4
            t0 = time.monotonic()
            state = swim_pview.init_state(params, jr.PRNGKey(0),
                                          seed_mode="fingers", device=dev)
            rec = {"n": n, "slots": k, "tick_mode": tm,
                   "table_gb": table_b / 2**30, "live_gb": None,
                   "tick_peak_gb": None, "stats_peak_gb": None}
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize(dev)
                rec["live_gb"] = torch.cuda.memory_allocated(dev) / 2**30
                torch.cuda.reset_peak_memory_stats(dev)
            state = swim_pview.tick_impl(state, jr.PRNGKey(1), params)
            if cuda:
                torch.cuda.synchronize(dev)
                rec["tick_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                       / 2**30)
                torch.cuda.reset_peak_memory_stats(dev)
            swim_pview.membership_stats(state, params)
            if cuda:
                rec["stats_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                        / 2**30)
            rec["wall_s"] = time.monotonic() - t0
            del state
            if cuda:
                torch.cuda.empty_cache()
            out.append(rec)
    return out


def _gb(v) -> str:
    return f"{v:>8.3f}" if v is not None else f"{'n/a':>8}"


def _ratio(v, table_gb) -> str:
    return f"{v / table_gb:>6.2f}" if v is not None else f"{'n/a':>6}"


def render(emit, rows: List[dict], ladder: List[dict]) -> None:
    emit(f"{'phase':<32} {'ms':>12} {'min ms':>10} {'max ms':>10} calls")
    for r in rows:
        emit(f"{r['phase']:<32} {r['ms']:>12.3f} {r['min_ms']:>10.3f} "
             f"{r['max_ms']:>10.3f} {r['calls']:>5}")
    emit()
    if not ladder:
        return
    emit("# peak device memory: one tick and one stats pass, each from a "
         "reset (torch.cuda.max_memory_allocated)")
    emit(f"{'n':>9} {'K':>5} {'mode':<6} {'tbl_gb':>7} {'live_gb':>8} "
         f"{'tick_gb':>8} {'t/tbl':>6} {'stats_gb':>8} {'s/tbl':>6} "
         f"{'wall_s':>7}")
    for r in ladder:
        tbl = r["table_gb"]
        emit(f"{r['n']:>9} {r['slots']:>5} {r['tick_mode']:<6} {tbl:>7.2f} "
             f"{_gb(r['live_gb'])} {_gb(r['tick_peak_gb'])} "
             f"{_ratio(r['tick_peak_gb'], tbl)} {_gb(r['stats_peak_gb'])} "
             f"{_ratio(r['stats_peak_gb'], tbl)} {r['wall_s']:>7.1f}")
    emit()


def run(n: int = 100_000, slots: int = 2048, feeds: int = 8, shapes=None,
        ladder: bool = True, iters: Optional[int] = None, device=None,
        log: Callable[[str], None] = print) -> dict:
    """The table, then the memory ladder over `shapes` (default [(n,
    slots)]); returns {"text", "rows", "ladder", ...}."""
    dev = resolve_device(device)
    out = io.StringIO()

    def emit(line: str = "") -> None:
        log(line)
        out.write(line + "\n")

    card = card_line(dev)
    emit("# pview kernel phase profile")
    emit(f"platform={'gpu' if dev.type == 'cuda' else dev.type} "
         f"device={card['device_kind']} power_limit_w={card['power_limit_w']}"
         f" n={n} slots={slots} feeds={feeds} fe={max(16, slots // 16)}")
    emit("measured_at="
         + time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()) + " UTC")
    emit()
    rows = table(n, slots, feeds, dev, iters)
    lad = memory_ladder(shapes or [(n, slots)], feeds, dev) if ladder else []
    render(emit, rows, lad)
    return {"text": out.getvalue(), "n": n, "slots": slots, "feeds": feeds,
            "platform": "gpu" if dev.type == "cuda" else dev.type, **card,
            "rows": rows, "ladder": lad}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100_000)
    ap.add_argument("slots", nargs="?", type=int, default=2048)
    ap.add_argument("feeds", nargs="?", type=int, default=8)
    ap.add_argument("--shapes", help="memory ladder: N1xK1,N2xK2,...")
    ap.add_argument("--no-ladder", action="store_true")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--out", help="write the text to this file")
    args = ap.parse_args(argv)
    shapes = ([tuple(int(v) for v in s.split("x"))
               for s in args.shapes.split(",")] if args.shapes else None)
    rec = run(args.n, args.slots, args.feeds, shapes, not args.no_ladder,
              args.iters, log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(rec["text"])
    print(json.dumps({k: v for k, v in rec.items() if k != "text"}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
