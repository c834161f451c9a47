"""The CRDT merge engines at sync-flood batch sizes: the port's
`scripts/bench_crdt_merge.py`, the decision plane alone and the store A/B.

    python -m corrosion_tpu_torch.crdt_bench [--profile]
    python -m corrosion_tpu_torch.crdt_bench --ab [--sizes 512,4096]
        [--hot-rows 2048] [--out PATH]

The schedule is the script's: `random.Random(1234)`, batch sizes 512,
4,096, 16,384 and 65,536 over 2,048 hot rows, and per size a warm batch
of min(size, 2,048) changes, then three batches (`schedule`).

Decision plane: `run_rung` decides a size's warm batch on a fresh
state, then its three batches in sequence through `ops.crdt_merge.
merge_table_array` on one state dict: a pk starts fresh (cl 0, an empty
clock) and each later batch sees the earlier ones' results, its
prefetched values (`disk`) being the cell values so far (`vals`). Per
batch it records the decision's digest and its time split: host marshal,
host-to-device copy, device (CUDA events around the decision program),
readback and plan rebuild. It prints one JSON line: the card's
`nvidia-smi` name and power limit, per size the decisions per second,
each batch's split and the peak device memory, and the decision
program's device ms alone on 2^20 rows (`scale_inputs`), which shows how
the device part scales past the largest batch. `--profile` instead runs
one 65,536 batch under `torch.profiler` and prints the top device ops
and the op count per batch.

Store A/B (`--ab`, `run_ab`): the script's three engines (`python`,
`native`, `array`, selected by `CORRO_CRDT_ENGINE`) through the same
store path, `CrdtStore.apply_changes` into SQLite on `:memory:`: phase A
snapshot reads, phase B decisions, phase C flush. Per size and engine,
end to end (`bench_engine`: a warm batch, then the three batches, each
applied as a deep copy) with the final state's digest, and phase B alone
on a fresh-store snapshot (`bench_decision_only`: 5 reps after a warm
one; the array engine's last rep adds its phase split). For the array
engine the `crdt_merge` lane says how many batches the decision program
decided and how many it declined to the host engines. A record is
written only to `--out`. Every mode runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import random
import time

import numpy as np
import torch

from corrosion_tpu_torch.ops import crdt_merge
from corrosion_tpu_torch.ops.crdt_merge import _pad, value_digest
from corrosion_tpu_torch.profile_tick import _device_us
from corrosion_tpu_torch.runtime.device import (
    card_line,
    nvidia_smi,
    resolve_device,
    sync,
)
from corrosion_tpu_torch.runtime.metrics import (
    CRDT_MERGE_EVENTS,
    METRICS,
    kernel_event_totals,
)
from corrosion_tpu_torch.runtime.records import FLIGHT
from corrosion_tpu_torch.store.crdt import CrdtStore
from corrosion_tpu_torch.types.actor import ActorId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import SENTINEL, Change
from corrosion_tpu_torch.types.pack import pack_columns

SIZES = (512, 4096, 16384, 65536)
HOT_ROWS = 2048
SEED = 1234
SCALE_ROWS = 2**20
ENGINES = ("python", "native", "array")
KV_SCHEMA = (
    "CREATE TABLE kv (id INTEGER NOT NULL PRIMARY KEY,"
    " a TEXT NOT NULL DEFAULT '', b INTEGER NOT NULL DEFAULT 0);"
)


def synth_batch(rng: random.Random, n: int, hot_rows: int) -> list:
    """A sync-flood-shaped batch: column updates dominate, with occasional
    delete/re-create chains and several sites racing. The draws are
    `scripts/bench_crdt_merge.py::synth_batch`'s, in its order."""
    sites = [bytes([i]) * 16 for i in (1, 2, 3, 4, 5)]
    out = []
    dbv = {s: 0 for s in sites}
    for _ in range(n):
        site = rng.choice(sites)
        pk = pack_columns([rng.randint(1, hot_rows)])
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
    """Median device ms (CUDA events around the graph replay, 5 calls
    after a warm one that captures it) of the decision program alone on
    `scale_inputs(rows, seed)`, run as `merge_table_array` runs it
    (`crdt_merge.run_packed`)."""
    arrays = scale_inputs(rows, seed)
    packed = crdt_merge.pack_inputs(arrays)

    def device_ms() -> float:
        return crdt_merge.run_packed(packed, arrays["num_groups"],
                                     arrays["num_cells"], device,
                                     timed=True)[1]

    device_ms()
    return float(np.median([device_ms() for _ in range(5)]))


def profile_batch(device, size: int = SIZES[-1], top: int = 12) -> dict:
    """The first batch of `size` on a fresh state under `torch.profiler`,
    after its warm batch and after the same batch once unprofiled: device
    busy ms, device ops (kernels, copies, memsets) per batch, the
    host-to-device and device-to-host copies, and the top aten ops by
    device time and by count."""
    warm, batches = rung_batches(size)
    decide(warm, {}, device)
    # the same batch once on a throwaway state: its shape's program graph
    # is captured before the profiler starts
    decide(batches[0], {}, device)
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


# ---------------------------------------------------------------------------
# the store A/B


@contextlib.contextmanager
def engine_env(engine: str, var: str = "CORRO_CRDT_ENGINE"):
    """`var` set to `engine` inside the block, restored after it."""
    old = os.environ.get(var)
    os.environ[var] = engine
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old


def mk_store(device=None, path: str = ":memory:",
             schema: str = KV_SCHEMA) -> CrdtStore:
    """The script's store: site id 9, the `kv` schema (a, b)."""
    st = CrdtStore(path, site_id=ActorId(bytes([9]) * 16), device=device)
    st.apply_schema_sql(schema)
    return st


def dump_state(store, clock_ts: bool = True) -> dict:
    """A store's replicated state, read by SQL (either package's store):
    every user table's rows, its `__crdt_rows` and `__crdt_clock` tables,
    and `__crdt_db_versions`. `clock_ts=False` leaves the clocks' `ts`
    out, as the reference's replica checks do: it is the origin's own
    bookkeeping, and a replica applying a changeset stores 0 there."""
    conn = store._conn
    clock_cols = "*" if clock_ts else \
        "pk, cid, col_version, db_version, seq, site_id"
    out = {}
    for tbl in sorted(store.schema.tables):
        out[tbl] = [tuple(r) for r in conn.execute(
            f'SELECT * FROM "{tbl}" ORDER BY 1, 2')]
        out[tbl + "__crdt_rows"] = [tuple(r) for r in conn.execute(
            f'SELECT * FROM "{tbl}__crdt_rows" ORDER BY pk')]
        out[tbl + "__crdt_clock"] = [tuple(r) for r in conn.execute(
            f'SELECT {clock_cols} FROM "{tbl}__crdt_clock"'
            " ORDER BY pk, cid")]
    out["versions"] = [tuple(r) for r in conn.execute(
        "SELECT site_id, db_version FROM __crdt_db_versions"
        " ORDER BY site_id")]
    return out


def state_digest(store) -> str:
    """sha256 of `dump_state` (its repr: values keep their SQLite
    types)."""
    return hashlib.sha256(repr(dump_state(store)).encode()).hexdigest()


def lane_mark(flight=FLIGHT, registry=METRICS,
              totals=kernel_event_totals) -> tuple:
    """Where the `crdt_merge` lane stands: its next host-frame tick and
    its event totals (`lane_since` reads what came after)."""
    last = flight.window(1, kernel="crdt_merge")
    tick = last[-1]["tick"] + 1 if last else 0
    return tick, dict(totals(registry).get("crdt_merge", {}))


def lane_since(mark: tuple, flight=FLIGHT, registry=METRICS,
               totals=kernel_event_totals) -> dict:
    """The batches the decision program decided and declined since
    `mark` (one host frame each; a declined one carries only its
    ambiguity count), and the lane's event deltas."""
    tick0, before = mark
    frames = [f for f in flight.window(1 << 20, kernel="crdt_merge")
              if f["tick"] >= tick0]
    declined = sum(f["events"].get("decide_ambiguous", 0) > 0
                   for f in frames)
    after = totals(registry).get("crdt_merge", {})
    return {"decided": len(frames) - declined, "declined": declined,
            "events": {k: after.get(k, 0.0) - before.get(k, 0.0)
                       for k in CRDT_MERGE_EVENTS}}


def bench_engine(engine: str, batches, warm_batch, device=None,
                 new_store=None, lane=None) -> dict:
    """The script's end-to-end rung of one engine: a fresh store, the warm
    batch, then the batches, each applied as a deep copy, on the host
    clock (ending in a sync of `device`). Adds the final state's digest
    and, with `lane` (a (flight, registry, totals) triple), what the
    `crdt_merge` lane saw over the timed batches."""
    dev = resolve_device(device) if new_store is None else None
    with engine_env(engine):
        st = mk_store(dev) if new_store is None else new_store()
        st.apply_changes(copy.deepcopy(warm_batch))
        mark = lane_mark(*lane) if lane else None
        t0 = time.monotonic()
        total = 0
        for batch in batches:
            st.apply_changes(copy.deepcopy(batch))
            total += len(batch)
        if dev is not None:
            sync(dev)
        wall = time.monotonic() - t0
    rec = {
        "engine": engine,
        "changes": total,
        "wall_s": wall,
        "changes_per_s": total / wall if wall > 0 else None,
        "digest": state_digest(st),
    }
    if lane:
        rec["lane"] = lane_since(mark, *lane)
    st.close()
    return rec


def bench_decision_only(engine: str, batch, device=None) -> dict:
    """Phase B alone on a fresh-store snapshot (empty local state): 5 reps
    after a warm one. The array engine's last rep records its phase split
    (marshal, h2d, device, readback, rebuild ms)."""
    dev = resolve_device(device)
    with engine_env(engine):
        st = mk_store(dev)
    base = {pk: {"cl": 0, "clock": {}, "vals": {}, "disk": {}}
            for pk in {c.pk for c in batch}}
    split: dict = {}

    def run_once():
        stx = copy.deepcopy(base)
        plans = ({}, set(), {}, {}, set(), set())
        if engine == "array":
            split.clear()
            return crdt_merge.merge_table_array(
                st, "kv", batch, stx, *plans, device=dev, record=split)
        if engine == "native":
            return st._merge_table_native(st._merge_lib, "kv", batch, stx,
                                          *plans)
        return st._merge_table_python("kv", batch, stx, *plans)

    run_once()  # warm
    reps = 5
    t0 = time.monotonic()
    for _ in range(reps):
        out = run_once()
    wall = (time.monotonic() - t0) / reps
    st.close()
    rec = {
        "engine": engine,
        "declined": out is None,
        "decision_wall_s": wall,
        "decisions_per_s": len(batch) / wall if wall > 0 else None,
    }
    if split:
        split.pop("outputs", None)
        rec["split_ms"] = split
    return rec


def run_ab(sizes=SIZES, hot_rows: int = HOT_ROWS, device=None,
           engines=ENGINES) -> dict:
    """The script's A/B over `schedule(sizes, hot_rows)`: per size, each
    engine end to end (`bench_engine`, the array engine's lane included)
    and decision-only on the first batch (`bench_decision_only`), with
    the card's name and power limit."""
    dev = resolve_device(device)
    out = {**card_line(dev), "device": str(dev), "hot_rows": hot_rows,
           "rungs": []}
    for size, warm, batches in schedule(sizes, hot_rows):
        rung = {"batch_size": size, "end_to_end": [], "decision_only": []}
        for engine in engines:
            lane = ((FLIGHT, METRICS, kernel_event_totals)
                    if engine == "array" else None)
            rung["end_to_end"].append(
                bench_engine(engine, batches, warm, dev, lane=lane))
            rung["decision_only"].append(
                bench_decision_only(engine, batches[0], dev))
        out["rungs"].append(rung)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one 65,536 batch instead")
    ap.add_argument("--ab", action="store_true",
                    help="the store A/B of the three engines instead")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--hot-rows", type=int, default=HOT_ROWS)
    ap.add_argument("--out", default=None,
                    help="write the --ab record here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)
    dev = resolve_device()
    out = {"nvidia_smi": nvidia_smi(), "kind": torch.cuda.get_device_name(dev)}
    if args.ab:
        sizes = [int(x) for x in args.sizes.split(",")]
        out.update(run_ab(sizes, args.hot_rows, dev))
        out["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S",
                                           time.gmtime())
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    elif args.profile:
        out["profile"] = profile_batch(dev)
    else:
        out["rungs"] = [run_rung(size, dev, (warm, batches))
                        for size, warm, batches in schedule()]
        out["scale_rows"] = SCALE_ROWS
        out["scale_device_ms"] = scale_point_ms(dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
