"""Where a tick's time goes on the card: a slice's tick, profiled.

    python -m corrosion_tpu_torch.profile_tick [--n 10000] [--mode pick]
    python -m corrosion_tpu_torch.profile_tick --kernel pview [--n 262144]
        [--mode pick]

Builds the dense slice's `ClusterSim` (fingers seeds, the bench's widths)
or, with `--kernel pview`, the partial-view slice's `PViewClusterSim`
(`bench.pview_params`: K=2048, fingers seeds, 8 feeds of 128 entries,
tie epoch 512), in pick mode with
the CUDA inbox kernel or in shift mode, warms it up for 10 ticks, then
prints one JSON line each for:

- `tick`: host wall per tick over 20 ticks ending in a synchronize;
- `profile`: `torch.profiler` over 5 ticks: device busy time per tick
  (the sum of the kernels' device time), the busy and idle shares of the
  profiled wall, kernel launches per tick, and the top ops by device time
  and by count;
- `parts`: the host wall of the tick's parts run alone — all its
  threefry bit planes, one inbox kernel call at its pick-mode shape, one
  coverage pass (dense) or stats pass (pview).

It runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.bench import PVIEW_N, bench_params, pview_params
from corrosion_tpu_torch.models.cluster import ClusterSim, PViewClusterSim
from corrosion_tpu_torch.ops import inbox_cuda, swim, swim_pview
from corrosion_tpu_torch.runtime.device import resolve_device


def _wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t0) / reps


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _planes(params):
    """Sizes of the threefry bit planes one tick draws: the dense and the
    partial-view `tick_impl` draw the same planes from their params."""
    n, ip = params.n, params.indirect_probes
    m = params.piggyback + params.antientropy
    sizes = [n * max(params.probe_candidates, 2)] * 2  # probe target pick
    sizes += [n * ip] * 2 + [n * (ip + 1)]  # helpers, probe-leg draws
    if params.gossip_mode == "pick":
        sizes += [n * 2] * 2 * params.fanout  # gossip target picks
    else:
        sizes += [params.fanout] * 2  # shift offsets
    if params.antientropy:
        sizes += [n * params.antientropy] * 2
    sizes += [n * params.fanout * m]  # loss draws
    sizes += [n * 2] * 2 * params.feeds_per_tick  # feed partner picks
    return sizes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("dense", "pview"), default="dense")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--mode", choices=("pick", "shift"), default="pick")
    args = ap.parse_args(argv)
    dev = resolve_device()
    impl = "cuda" if args.mode == "pick" else "gsort"
    pview = args.kernel == "pview"
    if pview:
        args.n = args.n or PVIEW_N
        sim = PViewClusterSim(args.n, seed=0, device=dev,
                              gossip_mode=args.mode, inbox_impl=impl,
                              **pview_params())
    else:
        args.n = args.n or 10_000
        sim = ClusterSim(args.n, seed=0, seed_mode="fingers", device=dev,
                         gossip_mode=args.mode, inbox_impl=impl,
                         **bench_params(args.n))
        sim.warm_device_loop(0.999, 5000, 5)
    sim.step(10)

    def tick():
        sim.step(1)

    base = {"kernel": args.kernel, "n": args.n, "mode": args.mode,
            "device": torch.cuda.get_device_name(dev)}
    if pview:
        base["slots"] = sim.params.slots
    print(json.dumps({"what": "tick", **base,
                      "ms_per_tick": _wall_ms(tick, 20)}), flush=True)

    ticks = 5
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.monotonic() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    by_dev = sorted(ops, key=_device_us, reverse=True)[:12]
    by_count = sorted(ops, key=lambda e: e.count, reverse=True)[:12]
    print(json.dumps({
        "what": "profile", **base, "ticks": ticks,
        "profiled_wall_ms_per_tick": wall_us / 1e3 / ticks,
        "device_busy_ms_per_tick": busy_us / 1e3 / ticks,
        "device_busy_share": busy_us / wall_us,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches_per_tick": len(kernels) / ticks,
        "top_by_device_ms_per_tick": {
            e.key: _device_us(e) / 1e3 / ticks for e in by_dev},
        "top_by_calls_per_tick": {e.key: e.count / ticks for e in by_count},
    }), flush=True)

    sizes = _planes(sim.params)
    key = jr.PRNGKey(5)
    p = sim.params
    g, m = args.n * p.fanout, p.piggyback + p.antientropy
    gen = torch.Generator(device=dev).manual_seed(0)
    dst = torch.randint(0, args.n, (g,), device=dev, generator=gen,
                        dtype=torch.int32)
    subj = torch.randint(0, args.n, (g, m), device=dev, generator=gen,
                         dtype=torch.int32)
    keyv = torch.randint(4, 2**15, (g, m), device=dev, generator=gen,
                         dtype=torch.int32)
    ok = torch.rand((g, m), device=dev, generator=gen) < 0.8
    st = sim.state
    if pview:
        check = ("stats_pass_ms", lambda: swim_pview._stats_impl(
            p, st.slot_packed, st.alive, st.t))
    else:
        check = ("coverage_pass_ms",
                 lambda: swim._coverage_impl(st.view, st.alive))
    print(json.dumps({
        "what": "parts", **base,
        "threefry_planes_per_tick": len(sizes),
        "threefry_ms_per_tick": _wall_ms(
            lambda: [jr.random_bits(key, s, dev) for s in sizes], 20),
        "inbox_kernel_ms": _wall_ms(
            lambda: inbox_cuda.build_inbox(args.n, p.incoming_slots, dst,
                                           subj, keyv, ok), 100),
        check[0]: _wall_ms(check[1], 5),
    }), flush=True)


if __name__ == "__main__":
    main()
