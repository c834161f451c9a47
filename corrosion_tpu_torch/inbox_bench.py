"""Times of the gossip-inbox kernel on the card, at the dense slice's
shape, at two larger ones and at the partial-view slice's.

    python -m corrosion_tpu_torch.inbox_bench
    PYTHONPATH=<other checkout> python -P corrosion_tpu_torch/inbox_bench.py

Prints one JSON line: the card's `nvidia-smi` name and power limit, the
floor of CUDA-event timing (an event pair with nothing between them),
and per shape of `SHAPES` the kernel's median ms per call (CUDA events
around each call, the card idle before each: this holds the wrapper's
host work before the launch), its device ms per call and device
operations per call (`torch.profiler`), the plain version's median ms,
the bytes bound of these inputs, and the host us per `build_inbox` call
(wall time over 1,000 calls with no sync between them; where the card is
slower than the host the launch queue may fill, and then the host us
follow the device time).

The second form times the `build_inbox` of another checkout of the port, an
earlier commit's kernel, with the same code: run by its path (`-P` keeps
this file's directory off `sys.path`) it imports the
`corrosion_tpu_torch` that PYTHONPATH names. `chip_smoke.py`
uses the same shapes and timers.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from corrosion_tpu_torch.runtime.device import nvidia_smi

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# (name, n, G, m, slots): the dense slice's pick-mode tick (G = n *
# fanout, m = piggyback + antientropy); n = 10^5 and 10^6, at which bytes
# and not launches set the time; and the partial-view slice's pick-mode
# tick (n = 262,144, m = 8 + 4, its default inbox of 16)
SHAPES = (
    ("slice", 10_000, 20_000, 5, 8),
    ("100k", 100_000, 200_000, 5, 8),
    ("1M", 1_000_000, 2_000_000, 5, 16),
    ("pview", 262_144, 524_288, 12, 16),
)


def inputs(seed: int, n: int, g: int, m: int, dev, p_ok: float = 0.8,
           spread: int = 0, key_hi: int = 2**15):
    """dst_g [g] uniform in [0, spread or n), subj [g, m] in [0, n), key
    [g, m] in [1, key_hi), ok [g, m] true with probability p_ok; made with
    numpy from `seed`."""
    rng = np.random.default_rng(seed)
    arrays = (
        rng.integers(0, spread or n, size=g).astype(np.int32),
        rng.integers(0, n, size=(g, m)).astype(np.int32),
        rng.integers(1, key_hi, size=(g, m)).astype(np.int32),
        rng.random((g, m)) < p_ok,
    )
    return [torch.from_numpy(a).to(dev) for a in arrays]


def bound_ms(n: int, slots: int, dst_g: torch.Tensor,
             ok: torch.Tensor) -> float:
    """The least time the card could take for these inputs, at its memory
    rate: dst (4G B) and ok (Gm B) read once, subj and key read (8 B) only
    for the messages that land in a cell (a destination keeps at most
    `slots` of its valid messages), both outputs written once (8n * slots
    B)."""
    g, m = ok.shape
    valid = (dst_g >= 0) & (dst_g < n)
    per_dst = torch.zeros(n, dtype=torch.int64, device=ok.device)
    per_dst.index_add_(0, dst_g[valid].long(), ok[valid].sum(dim=1))
    kept = int(per_dst.clamp(max=slots).sum())
    return 1e3 * (4 * g + g * m + 8 * kept + 8 * n * slots) / HBM_BYTES_PER_S


def median_ms(fn, reps: int = 100) -> float:
    """Median over `reps` calls of the device time of one call (CUDA
    events around it, the card idle before each)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def event_floor_ms(reps: int = 100) -> float:
    """What `median_ms` reads for an event pair with nothing between."""
    return median_ms(lambda: None, reps)


def host_us(fn, calls: int = 1000) -> float:
    """Host wall time per call over `calls` calls with no sync between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * wall / calls


def device_ms(fn, reps: int = 20):
    """Device time per call from `torch.profiler`'s CUDA activity over
    `reps` calls, and the device operations per call (kernels, memsets).
    Per operation name: its mean duration times its count per call,
    rounded, since the profiler may miss one event of a profiled run."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    per_call = {k: round(len(v) / reps) for k, v in by_name.items()}
    busy_us = sum(per_call[k] * statistics.fmean(v)
                  for k, v in by_name.items())
    return busy_us / 1e3, sum(per_call.values())


def time_case(build_inbox, build_inbox_plain, name: str, n: int,
              slots: int, args) -> dict:
    """One shape's row: the kernel's and the plain version's median ms,
    the device ms and operations per call, the bound and the host us per
    call; the kernel's output is checked equal to the plain version's
    first."""
    got = build_inbox(n, slots, *args)
    ref = build_inbox_plain(n, slots, *args)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"inbox kernel differs from the plain "
                             f"version at shape {name}")
    del got, ref
    g, m = args[1].shape
    dev_ms, dev_ops = device_ms(lambda: build_inbox(n, slots, *args))
    return {
        "shape": name, "n": n, "G": g, "m": m, "slots": slots,
        "ms": median_ms(lambda: build_inbox(n, slots, *args)),
        "device_ms": dev_ms,
        "device_ops_per_call": dev_ops,
        "plain_ms": median_ms(lambda: build_inbox_plain(n, slots, *args),
                              20),
        "bound_ms": bound_ms(n, slots, args[0], args[3]),
        "host_us": host_us(lambda: build_inbox(n, slots, *args)),
    }


def time_shapes(build_inbox, build_inbox_plain, dev) -> list:
    """`time_case` at every shape of `SHAPES`, on seeded inputs."""
    return [time_case(build_inbox, build_inbox_plain, name, n, slots,
                      inputs(70 + i, n, g, m, dev))
            for i, (name, n, g, m, slots) in enumerate(SHAPES)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("inbox_bench: needs an NVIDIA card")
    from corrosion_tpu_torch.ops import inbox_cuda

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    print(json.dumps({
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "package": inbox_cuda.__file__,
        "event_floor_ms": event_floor_ms(),
        "shapes": time_shapes(inbox_cuda.build_inbox,
                              inbox_cuda.build_inbox_plain, dev),
    }), flush=True)


if __name__ == "__main__":
    main()
