"""Benchmark: time to stable membership of a simulated SWIM devcluster on
the card (the counterpart of the repo root's `bench.py::child_main`).

Boots BENCH_N members (default 10,000) to 99.9% live-member coverage and
prints exactly one JSON line, in the same record shape as the JAX bench.
It runs on the card: without CUDA it raises, and it never falls back to
the CPU or replays a stored record.

    python -m corrosion_tpu_torch.bench

Env knobs, as in the JAX bench: BENCH_N, BENCH_COVERAGE, BENCH_FEEDS,
BENCH_INBOX_IMPL (sort | gsort | cuda), BENCH_GOSSIP_MODE (shift |
pick), BENCH_SEED_MODE, BENCH_RECORD_EVERY, BENCH_DEVICE_LOOP,
BENCH_CHECK_EVERY.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import torch

from corrosion_tpu_torch.models.cluster import ClusterSim
from corrosion_tpu_torch.ops import inbox_cuda
from corrosion_tpu_torch.runtime.device import resolve_device, sync

# the measured code surface, fingerprinted into every record
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MEASURED_FILES = (
    "corrosion_tpu_torch/ops/swim.py",
    "corrosion_tpu_torch/ops/inbox_cuda.py",
    "corrosion_tpu_torch/csrc/inbox.cu",
    "corrosion_tpu_torch/random.py",
    "corrosion_tpu_torch/models/cluster.py",
)

MAX_TICKS = 5000


def code_fingerprint() -> dict:
    out = {}
    for rel in _MEASURED_FILES:
        with open(os.path.join(_ROOT, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()[:12]
    return out


def bench_params(n: int, feeds: int = 4) -> dict:
    """The JAX bench's boot-convergence widths (bench.py:81-95): feed
    bandwidth sized at about n/4 entries per member per tick, trimmed
    gossip and probe widths."""
    feeds = max(1, feeds)
    return dict(
        feeds_per_tick=feeds,
        feed_entries=max(25, n // (4 * feeds)),
        piggyback=4,
        incoming_slots=8,
        buffer_slots=12,
        probe_candidates=2,
        antientropy=1,
    )


PVIEW_N = 262_144


def pview_params() -> dict:
    """The partial-view slice's settings: `scripts/pview_converge.py`'s
    at its n=262,144 rung (K=2048, 8 feeds of 2048 // 16 = 128 entries,
    tie epoch 512) with fingers seeds; the other widths are the kernel's
    defaults."""
    return dict(
        slots=2048,
        seed_mode="fingers",
        feeds_per_tick=8,
        feed_entries=128,
        tie_epoch=512,
    )


def config_from_env(env=os.environ) -> dict:
    n = int(env.get("BENCH_N", "10000"))
    params = bench_params(n, int(env.get("BENCH_FEEDS", "4")))
    if env.get("BENCH_INBOX_IMPL"):
        params["inbox_impl"] = env["BENCH_INBOX_IMPL"]
    if env.get("BENCH_GOSSIP_MODE"):
        params["gossip_mode"] = env["BENCH_GOSSIP_MODE"]
    return dict(
        n=n,
        target=float(env.get("BENCH_COVERAGE", "0.999")),
        params=params,
        seed_mode=env.get("BENCH_SEED_MODE", "fingers"),
        record_every=int(env.get("BENCH_RECORD_EVERY", "25")),
        device_loop=env.get("BENCH_DEVICE_LOOP", "1") != "0",
        check_every=max(1, int(env.get("BENCH_CHECK_EVERY", "5"))),
    )



def measure(n: int, target: float, params: dict, seed_mode: str = "fingers",
            record_every: int = 25, device_loop: bool = True,
            check_every: int = 5, device=None) -> dict:
    """One bench record: warm up on a throwaway sim (seed 1) so the kernel
    build and first launches fall outside the clock, then time the boot
    of a fresh sim (seed 0) to `target` coverage. On the card the record
    also holds the peak device memory of both sims (the timed one takes
    the warm one's freed blocks) and the inbox kernel's launches in the
    timed run."""
    code_sha = code_fingerprint()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's stats exist only after it
        torch.cuda.reset_peak_memory_stats(dev)
    warm = ClusterSim(n, seed=1, seed_mode=seed_mode, device=dev, **params)
    if device_loop:
        warm.warm_device_loop(target, MAX_TICKS, check_every)
    warm.step(record_every)
    warm.step(10)
    warm.stats()
    del warm

    sim = ClusterSim(n, seed=0, seed_mode=seed_mode, device=dev, **params)
    sync(dev)
    launches0 = inbox_cuda.build_inbox.launches
    t0 = time.monotonic()
    if device_loop:
        stable_tick = sim.run_until_stable_device(target, MAX_TICKS,
                                                  check_every)
    else:
        stable_tick = sim.run_until_stable(target, MAX_TICKS, record_every,
                                           fine_every=10)
    sync(dev)
    elapsed = time.monotonic() - t0
    launches = inbox_cuda.build_inbox.launches - launches0
    stats = sim.stats()
    return {
        "metric": f"time_to_stable_membership_n{n}",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(60.0 / elapsed, 3) if elapsed > 0 else 0.0,
        "detail": {
            "n_members": n,
            "coverage": round(stats["coverage"], 5),
            "false_positive": round(stats["false_positive"], 6),
            "stable_tick": stable_tick,
            "feeds_per_tick": params["feeds_per_tick"],
            "feed_entries": params["feed_entries"],
            "seed_mode": seed_mode,
            "record_every": record_every,
            "coverage_target": target,
            "inbox_impl": sim.params.inbox_impl,
            "gossip_mode": sim.params.gossip_mode,
            "device_loop": device_loop,
            "check_every": check_every if device_loop else None,
            "code_sha": code_sha,
            "measured_at": time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()),
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else None),
            "inbox_kernel_launches": launches,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
        },
    }


def main() -> None:
    record = measure(**config_from_env())
    print(json.dumps(record))
    if record["detail"]["stable_tick"] is None:
        sys.exit(1)


if __name__ == "__main__":
    main()
