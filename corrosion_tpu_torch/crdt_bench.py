"""The CRDT merge engine's decision plane at sync-flood batch sizes.

    python -m corrosion_tpu_torch.crdt_bench [--profile]

The port's counterpart of the decision part of
`scripts/bench_crdt_merge.py`, with its schedule: `random.Random(1234)`,
batch sizes 512, 4,096, 16,384 and 65,536 over 2,048 hot rows, and per
size a warm batch of min(size, 2,048) changes, then three batches
(`schedule`). `run_rung` decides a size's warm batch on a fresh state,
then its three batches in sequence through `ops.crdt_merge.
merge_table_array` on one state dict: a pk starts fresh (cl 0, an empty
clock) and each later batch sees the earlier ones' results, its prefetched
values (`disk`) being the cell values so far (`vals`). Per batch it
records the decision's digest and its time split: host marshal,
host-to-device copy, device (CUDA events around the decision program),
readback and plan rebuild.

Prints one JSON line: the card's `nvidia-smi` name and power limit, per
size the decisions per second, each batch's split and the peak device
memory, and the decision program's device ms alone on 2^20 rows
(`scale_inputs`: the same mix of groups, cells, sentinels, even and odd
causal lengths and inexact digests, made with numpy from a seed), which
shows how the device part scales past the largest batch. `--profile`
instead runs one 65,536 batch under `torch.profiler` and prints the top
device ops and the op count per batch. It runs on the card only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from corrosion_tpu_torch.convert import crdt_inputs_to_torch
from corrosion_tpu_torch.inbox_bench import median_ms
from corrosion_tpu_torch.ops import crdt_merge
from corrosion_tpu_torch.ops.crdt_merge import SENTINEL, _pad, value_digest
from corrosion_tpu_torch.profile_tick import _device_us
from corrosion_tpu_torch.runtime.device import nvidia_smi, resolve_device

SIZES = (512, 4096, 16384, 65536)
HOT_ROWS = 2048
SEED = 1234
SCALE_ROWS = 2**20


@dataclass(frozen=True)
class Timestamp:
    """An NTP64 timestamp: seconds in the upper 32 bits, the fraction in
    the lower."""

    ntp64: int = 0

    @classmethod
    def from_unix(cls, secs: float) -> "Timestamp":
        whole = int(secs)
        return cls((whole << 32) | (int((secs - whole) * 2**32) & 0xFFFFFFFF))


@dataclass
class Change:
    """One `crsql_changes` row, with the fields the merge engine reads."""

    table: str
    pk: bytes
    cid: str
    val: object
    col_version: int
    db_version: int
    seq: int
    site_id: bytes
    cl: int
    ts: Timestamp = Timestamp(0)


def pk_bytes(row: int) -> bytes:
    """The pk of an integer row id: opaque identity, one per row."""
    return row.to_bytes(8, "big", signed=True)


def synth_batch(rng: random.Random, n: int, hot_rows: int) -> list:
    """A sync-flood-shaped batch: column updates dominate, with occasional
    delete/re-create chains and several sites racing. The draws are
    `scripts/bench_crdt_merge.py::synth_batch`'s, in its order."""
    sites = [bytes([i]) * 16 for i in (1, 2, 3, 4, 5)]
    out = []
    dbv = {s: 0 for s in sites}
    for _ in range(n):
        site = rng.choice(sites)
        pk = pk_bytes(rng.randint(1, hot_rows))
        r = rng.random()
        if r < 0.05:
            cl, cid, val, cv = rng.choice([2, 4]), SENTINEL, None, 1
        elif r < 0.10:
            cl, cid, val, cv = rng.choice([1, 3, 5]), SENTINEL, None, 1
        else:
            cl = rng.choice([1, 1, 1, 1, 3])
            cid = rng.choice(["a", "b"])
            cv = rng.randint(1, 6)
            val = (
                rng.randint(0, 10**6)
                if cid == "b"
                else rng.choice(["x", "yy", "zzz", "abcdef", ""])
            )
        dbv[site] += rng.choice([0, 1])
        seq = rng.randint(0, 3)
        out.append(Change(
            table="kv", pk=pk, cid=cid, val=val, col_version=cv,
            db_version=max(1, dbv[site]), seq=seq, site_id=site, cl=cl,
            ts=Timestamp.from_unix(rng.randint(1, 100)),
        ))
    return out


def schedule(sizes=SIZES, hot_rows: int = HOT_ROWS, seed: int = SEED):
    """Yield (size, warm batch, three batches) in the reference's order:
    every size's batches come from one `random.Random(seed)`."""
    rng = random.Random(seed)
    for size in sizes:
        warm = synth_batch(rng, min(size, 2048), hot_rows)
        yield size, warm, [synth_batch(rng, size, hot_rows)
                           for _ in range(3)]


def rung_batches(size: int):
    """(warm batch, three batches) of one size of the schedule."""
    for s, warm, batches in schedule(SIZES[:SIZES.index(size) + 1]):
        if s == size:
            return warm, batches
    raise ValueError(size)


def fresh_state() -> dict:
    """A pk's local state before its first change: cl 0, empty clock."""
    return {"cl": 0, "clock": {}, "vals": {}, "disk": {}}


def outputs_digest(outs) -> str:
    """sha256 of the win mask, final_cl, cell_winner and clock_winner."""
    h = hashlib.sha256()
    for i in (0, 2, 6, 7):
        h.update(np.ascontiguousarray(outs[i]).astype("<i4").tobytes())
    return h.hexdigest()


def decide(batch, st: dict, device) -> dict:
    """One batch through `merge_table_array` on `st` (new pks start
    fresh): its decision summary and time split."""
    for ch in batch:
        if ch.pk not in st:
            st[ch.pk] = fresh_state()
    rec: dict = {}
    plans = ({}, set(), {}, {}, set(), set())
    t0 = time.perf_counter()
    wins = crdt_merge.merge_table_array(None, "kv", batch, st, *plans,
                                        device=device, record=rec)
    wall = time.perf_counter() - t0
    outs = rec.pop("outputs")
    return {
        "changes": len(batch), "declined": wins is None,
        "events": [int(v) for v in outs[9]], "digest": outputs_digest(outs),
        "wall_ms": 1e3 * wall, **rec,
    }


def run_rung(size: int, device, batches=None) -> dict:
    """A size's warm batch on a fresh state, then its three batches in
    sequence on one state dict, each later batch's `disk` being the cell
    values so far. `batches` is `rung_batches(size)` when given. Returns
    the warm batch's and each batch's `decide` summary, decisions per
    second over the three, and the peak device memory (bytes, on the
    card)."""
    dev = resolve_device(device)
    warm, batches = batches or rung_batches(size)
    cuda = dev.type == "cuda"
    warm_rec = decide(warm, {}, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    st: dict = {}
    recs = []
    for batch in batches:
        for s in st.values():
            s["disk"] = dict(s["vals"])
        recs.append(decide(batch, st, dev))
    wall_s = sum(r["wall_ms"] for r in recs) / 1e3
    return {
        "size": size, "device": str(dev), "warm": warm_rec, "batches": recs,
        "decisions_per_s": sum(r["changes"] for r in recs) / wall_s,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
    }


def scale_inputs(rows: int, seed: int) -> dict:
    """Decision-program inputs of `rows` rows (a power of two, at least
    64) made with numpy from `seed`, in the sync-flood mix: 7/8 of the
    rows are changes, 32 per pk (10 % sentinel, half of those even-cl
    deletes; column updates at cl 1 or 3 over cids a and b, col_version
    1-6, values from a pool of 16 digests of which 4 are inexact), then
    per pk a sentinel baseline at an even or odd local cl and, for each of
    its two cells with probability 1/2, a clocked baseline whose value is
    prefetched with probability 9/10, then padding."""
    rng = np.random.default_rng(seed)
    n_ch = rows * 7 // 8
    n_pk = max(1, n_ch // 32)
    pool = np.array([value_digest(v)[:5] for v in (
        "x", "yy", "zzz", "abcdef", "", 0, 7, 10**6, -3, 2**53, 2**53 + 1,
        "y" * 20, "y" * 30, b"blob", "abcdefghijklmnop", 0.5)], np.int64)
    grp = rng.integers(0, n_pk, n_ch)
    kind = rng.random(n_ch)
    sent = kind < 0.10
    cl = np.where(kind < 0.05, rng.choice([2, 4], n_ch),
                  np.where(sent, rng.choice([1, 3, 5], n_ch),
                           rng.choice([1, 1, 1, 1, 3], n_ch)))
    cid = np.where(sent, 0, rng.integers(1, 3, n_ch))  # 0: the sentinel
    cv = np.where(sent, 0, rng.integers(1, 7, n_ch))
    dig = np.where(sent[:, None], [0, 0, 0, 0, 1],
                   pool[rng.integers(0, len(pool), n_ch)])
    # per pk: its sentinel baseline, then its clocked cid baselines
    local_cl = rng.integers(0, 6, n_pk)
    b_grp = np.repeat(np.arange(n_pk), 2)
    b_cid = np.tile([1, 2], n_pk)
    keep = rng.random(2 * n_pk) < 0.5
    b_grp, b_cid = b_grp[keep], b_cid[keep]
    n_b = len(b_grp)
    fake = rng.random(n_b) < 0.1
    b_dig = np.where(fake[:, None], [0, 0, 0, 0, 0],
                     pool[rng.integers(0, len(pool), n_b)])
    total = n_ch + n_pk + n_b
    if total > rows:
        raise ValueError(f"{rows} rows cannot hold {total}")
    num_groups, num_cells = _pad(n_pk + 1), _pad(3 * n_pk + 1)

    def arr(*parts, fill=0, dtype=np.int32):
        a = np.full(rows, fill, dtype=dtype)
        a[:total] = np.concatenate(parts)
        return a

    zeros = np.zeros(n_pk, np.int64)
    return dict(
        grp=arr(grp, np.arange(n_pk), b_grp, fill=num_groups - 1),
        cellg=arr(3 * grp + cid, 3 * np.arange(n_pk), 3 * b_grp + b_cid,
                  fill=num_cells - 1),
        cl=arr(cl, local_cl, local_cl[b_grp]),
        cv=arr(cv, zeros, rng.integers(1, 7, n_b)),
        **{f"d{k}": arr(dig[:, k], zeros, b_dig[:, k]) for k in range(4)},
        exact=arr(dig[:, 4], zeros + 1, b_dig[:, 4], dtype=bool),
        fake=arr(np.zeros(n_ch), zeros, fake, dtype=bool),
        pos=arr(np.arange(n_ch), zeros - 1, np.full(n_b, -1), fill=-1),
        is_sent=arr(sent, zeros + 1, np.zeros(n_b), dtype=bool),
        valid=arr(np.ones(total), dtype=bool),
        num_groups=num_groups, num_cells=num_cells,
    )


def scale_point_ms(device, rows: int = SCALE_ROWS, seed: int = 0) -> float:
    """Median device ms (CUDA events, 5 calls after a warm one) of the
    decision program alone on `scale_inputs(rows, seed)`."""
    inputs = crdt_inputs_to_torch(scale_inputs(rows, seed), device)
    return median_ms(lambda: crdt_merge._merge_kernel(**inputs), reps=5)


def profile_batch(device, size: int = SIZES[-1], top: int = 12) -> dict:
    """The first batch of `size` on a fresh state under `torch.profiler`,
    after its warm batch: device busy ms, device ops (kernels, copies,
    memsets) per batch, the host-to-device and device-to-host copies, and
    the top aten ops by device time and by count."""
    warm, batches = rung_batches(size)
    decide(warm, {}, device)
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rec = decide(batches[0], {}, device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    return {
        "size": size, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_ops": len(on_device),
        "htod_copies": sum("HtoD" in e.name for e in on_device),
        "dtoh_copies": sum("DtoH" in e.name for e in on_device),
        "split_ms": {k: rec[k] for k in ("marshal_ms", "h2d_ms", "device_ms",
                                         "readback_ms", "rebuild_ms")},
        "top_by_device_ms": {
            e.key: _device_us(e) / 1e3
            for e in sorted(ops, key=_device_us, reverse=True)[:top]},
        "top_by_calls": {
            e.key: e.count
            for e in sorted(ops, key=lambda e: e.count, reverse=True)[:top]},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one 65,536 batch instead")
    args = ap.parse_args(argv)
    dev = resolve_device()
    out = {"nvidia_smi": nvidia_smi(), "kind": torch.cuda.get_device_name(dev)}
    if args.profile:
        out["profile"] = profile_batch(dev)
    else:
        out["rungs"] = [run_rung(size, dev, (warm, batches))
                        for size, warm, batches in schedule()]
        out["scale_rows"] = SCALE_ROWS
        out["scale_device_ms"] = scale_point_ms(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
