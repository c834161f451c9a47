#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`corrosion_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before the
result line is printed:

1. the card's `nvidia-smi` name and power limit, then the build of every
   CUDA source of the port (one nvcc per source, all started together);
2. the inbox kernel against its plain PyTorch version on the card, at the
   dense tick's shapes (n=10,000, G=20,000, m=5, slots=8, several seeds),
   at n=10^5 and n=10^6 (`inbox_bench.SHAPES`), on five degenerate cases
   and on four more (2,000,000 packets to 4 destinations; n not a multiple
   of the kernel's range per cluster; G=0; m=1): outputs must be exactly
   equal;
3. the port's tick on the card against the same tick on the CPU (n=256,
   10 ticks; pick+cuda, pick+cuda with Lifeguard, loss and a partition,
   and shift): every state field must be bit-equal;
4. the slice: `ClusterSim(10_000, seed=0, seed_mode="fingers",
   gossip_mode="pick", inbox_impl="cuda")` at the bench's widths boots to
   99.9% coverage through `run_until_stable_device`; it must end at the
   JAX package's stable tick (70) with FP 0, and the inbox kernel must be
   launched exactly once per tick run;
5. the same with `gossip_mode="shift"`: stable tick 55;
6. `torch.profiler` must see exactly one device kernel, and no memset,
   in one `build_inbox` call (after the slice phases, so that no
   profiling precedes their clocks); then the kernels line: per kernel
   its launches on the main path, its median time over 100 launches at
   the slice's shapes, the plain version's, and the bound; for the inbox
   kernel also per shape of
   `inbox_bench.SHAPES` its ms, device ms, plain ms, bound and host us
   per call, the floor of CUDA-event timing, the kernel's cluster size
   (its `kCluster`) and its device kernels per call. Every bound is
   computed from this run's inputs.

The last line is `{"ok": true, "device": {"platform": "gpu", ...}}`.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from corrosion_tpu_torch import inbox_bench as ib
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.bench import bench_params
from corrosion_tpu_torch.models.cluster import ClusterSim
from corrosion_tpu_torch.ops import _build, inbox_cuda, swim

SLICE_N = 10_000
SLICE_EXPECT = {"pick": 70, "shift": 55}  # JAX package, same config + seed

# (n, g, m, slots, p_ok, dst_spread): tests/test_inbox_impls.py's cases
DEGENERATE_CASES = [
    (64, 128, 10, 16, 0.8, 64),
    (64, 128, 10, 4, 0.8, 8),
    (16, 400, 3, 2, 0.5, 16),
    (32, 64, 10, 16, 0.0, 32),
    (32, 64, 10, 16, 1.0, 1),
]
# (name, n, g, m, slots, p_ok, dst_spread or 0 for n)
EDGE_CASES = [
    ("skew", 10_000, 2_000_000, 5, 8, 0.8, 4),
    ("ragged_n", 10_007, 20_014, 5, 8, 0.8, 0),  # prime n
    ("G=0", 10_000, 0, 5, 8, 0.8, 0),
    ("m=1", 10_000, 20_000, 1, 8, 0.8, 0),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def slice_inbox_case(seed, dev):
    """Inputs at the pick-mode tick's inbox shapes: G = n * fanout
    packets of m = piggyback + antientropy messages."""
    p = bench_params(SLICE_N)
    g, m = SLICE_N * 2, p["piggyback"] + p["antientropy"]
    return (SLICE_N, p["incoming_slots"],
            ib.inputs(seed, SLICE_N, g, m, dev))


def phase_build() -> dict:
    smi = ib.nvidia_smi()
    print(smi, flush=True)
    t0 = time.monotonic()
    logs = _build.build()
    for name in _build.sources():
        _build.load(name)
    return {"phase": "build", "ok": True, "nvidia_smi": smi,
            "sources": _build.sources(), "build_s": time.monotonic() - t0,
            "ptxas": {k: [ln for ln in v.splitlines() if "ptxas info" in ln]
                      for k, v in logs.items()}}


def phase_inbox_kernel(dev) -> dict:
    cases = [slice_inbox_case(seed, dev) for seed in range(4)]
    for i, (n, g, m, slots, p_ok, spread) in enumerate(DEGENERATE_CASES):
        cases.append((n, slots, ib.inputs(99 + i, n, g, m, dev, p_ok, spread,
                                          2**20)))
    for i, (_, n, g, m, slots) in enumerate(ib.SHAPES[1:]):
        cases.append((n, slots, ib.inputs(120 + i, n, g, m, dev)))
    for i, (_, n, g, m, slots, p_ok, spread) in enumerate(EDGE_CASES):
        cases.append((n, slots, ib.inputs(130 + i, n, g, m, dev, p_ok,
                                          spread)))
    max_err = 0
    for n, slots, args in cases:
        got = inbox_cuda.build_inbox(n, slots, *args)
        ref = inbox_cuda.build_inbox_plain(n, slots, *args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"inbox kernel differs from the plain "
                                     f"version at n={n}, slots={slots}")
        del got, ref
    return {"phase": "inbox_kernel", "ok": True, "cases": len(cases),
            "max_abs_err": max_err}


def kernels_per_call(n, slots, args) -> int:
    """The device operations `torch.profiler` sees in one `build_inbox`
    call: it must be exactly one kernel and no memset or copy."""
    inbox_cuda.build_inbox(n, slots, *args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        inbox_cuda.build_inbox(n, slots, *args)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in on_device]
    if len(on_device) != 1 or any(
            w in names[0].lower() for w in ("memset", "memcpy")):
        raise AssertionError(f"one build_inbox call ran {names} on the "
                             f"device, not exactly one kernel")
    return len(on_device)


def phase_tick_parity(dev) -> dict:
    n = 256
    base = bench_params(n)

    def partition(state):
        state = swim.set_partition(state, (np.arange(n) % 2).astype(np.int32))
        state = swim.set_degraded(state, [3, 17, 101], loss=0.3, lag=2)
        return swim.set_alive(state, 7, False)

    configs = [
        ("pick+cuda", dict(gossip_mode="pick", inbox_impl="cuda"), None),
        ("pick+cuda+lifeguard+loss+partition",
         dict(gossip_mode="pick", inbox_impl="cuda", lhm_max=4, loss=0.1),
         partition),
        ("shift", dict(gossip_mode="shift"), None),
    ]
    for name, kw, setup in configs:
        params = swim.SwimParams(n=n, **base, **kw)
        key = jr.PRNGKey(11)
        states = [swim.init_state(params, key, 3, "fingers", d)
                  for d in ("cpu", dev)]
        if setup:
            states = [setup(s) for s in states]
        for t in range(10):
            k = jr.fold_in(key, t)
            states = [swim.tick_impl(s, k, params) for s in states]
        cpu, gpu = states
        for field in swim.SwimState._fields:
            if not torch.equal(getattr(cpu, field), getattr(gpu, field).cpu()):
                raise AssertionError(f"{name}: field {field} differs between "
                                     f"the card and the CPU after 10 ticks")
    return {"phase": "tick_parity", "ok": True, "n": n, "ticks": 10,
            "configs": [c[0] for c in configs]}


def phase_slice(dev, gossip_mode: str, inbox_impl: str) -> dict:
    params = dict(bench_params(SLICE_N), gossip_mode=gossip_mode,
                  inbox_impl=inbox_impl)
    warm = ClusterSim(SLICE_N, seed=1, seed_mode="fingers", device=dev,
                      **params)
    warm.warm_device_loop(0.999, 5000, 5)
    warm.step(5)  # first launches of every op outside the clock
    warm.stats()
    del warm
    sim = ClusterSim(SLICE_N, seed=0, seed_mode="fingers", device=dev,
                     **params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inbox_cuda.build_inbox.launches = 0
    t0 = time.monotonic()
    tick = sim.run_until_stable_device(0.999, 5000, 5)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = inbox_cuda.build_inbox.launches
    stats = sim.stats()
    out = {
        "phase": f"slice_{gossip_mode}", "n": SLICE_N, "gossip_mode":
        gossip_mode, "inbox_impl": inbox_impl, "stable_tick": tick,
        "coverage": stats["coverage"], "false_positive":
        stats["false_positive"], "wall_s": wall,
        "ms_per_tick": 1e3 * wall / max(1, sim.ticks),
        "inbox_kernel_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    expect = SLICE_EXPECT[gossip_mode]
    want_launches = sim.ticks if inbox_impl == "cuda" and \
        gossip_mode == "pick" else 0
    if (tick != expect or stats["false_positive"] != 0.0
            or not np.float32(stats["coverage"]) >= np.float32(0.999)
            or launches != want_launches):
        raise AssertionError(f"slice run off its reference: {out}, expected "
                             f"stable tick {expect} and {want_launches} "
                             f"kernel launches")
    out["ok"] = True
    return out


def phase_kernels(dev, launches: dict, max_err: dict) -> dict:
    kernels = kernels_per_call(*slice_inbox_case(0, dev))
    shapes = ib.time_shapes(inbox_cuda.build_inbox,
                            inbox_cuda.build_inbox_plain, dev)
    at_slice = shapes[0]
    return {"kernels": [{
        "name": "inbox_build",
        "route": "cuda",
        "source": "corrosion_tpu_torch/csrc/inbox.cu",
        "replaces": "corrosion_tpu/ops/inbox_pallas.py:140",
        "launches": launches["inbox_build"],
        "max_abs_err": max_err["inbox_build"],
        "ms": at_slice["ms"],
        "plain_ms": at_slice["plain_ms"],
        "bound_ms": at_slice["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": shapes,
        "host_us": at_slice["host_us"],
        "event_floor_ms": ib.event_floor_ms(),
        "cluster_size": int(re.search(
            r"constexpr int kCluster = (\d+);",
            (_build.CSRC / "inbox.cu").read_text())[1]),
        "device_kernels_per_call": kernels,
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    emit(phase_build())
    inbox = phase_inbox_kernel(dev)
    emit(inbox)
    emit(phase_tick_parity(dev))
    pick = phase_slice(dev, "pick", "cuda")
    emit(pick)
    emit(phase_slice(dev, "shift", "gsort"))
    emit(phase_kernels(dev, {"inbox_build": pick["inbox_kernel_launches"]},
                       {"inbox_build": inbox["max_abs_err"]}))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
