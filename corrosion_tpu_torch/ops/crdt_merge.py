"""The array CRDT merge engine on torch ops: the counterpart of
`corrosion_tpu/ops/crdt_merge.py`.

For a whole batch of one table's incoming `crsql_changes` rows, the
decision program `_merge_kernel` decides which changes win under
column-level last-writer-wins and causal length (the semantics of the
store's Python merge loop, after cr-sqlite's `agent/util.rs:703-1310`):

1. a stable sort by (pk group, arrival) and a segmented exclusive prefix
   max over causal lengths: which changes are causal transitions, which
   are equal-cl candidates, each row's final cl and erasure watermark;
2. a stable sort by ((pk, cid) cell, arrival) and a segmented exclusive
   prefix max over (cl, col_version, value digest): a change wins iff it
   strictly beats everything before it, the local baseline included;
3. two masked per-cell arg-lex-maxes: the final clock-row writer and the
   final cell writer of each (pk, cid).

Values enter as 112-bit order-preserving digests (`value_digest`). A tie
at an inexact digest cannot be decided on the device: it sets
`ambiguous`, and `merge_table_array` returns None so that the store
re-decides the batch with a host engine.

Every output equals the reference's bit for bit, padding included
(tests/test_torch_crdt.py). torch has neither `associative_scan` nor
`lexsort`, so:

- a lexsort is a chain of stable sorts from the least significant key,
  two int32 keys packed into each int64 pass;
- the segmented lex-max scan dense-ranks the key tuple and runs one
  `cummax` over (segment, rank, n - 1 - i) packed into one int64, so the
  earliest maximal element wins a tie, as in the reference's combine, and
  the payload bits carried with the max are that element's.

The program makes no host sync. `merge_table_array` packs the thirteen
inputs into one int32 [13, rows] array, copies it to the device once,
and reads all ten outputs back in one copy (counted, as `read_decisions`
counts its calls, in `read_decisions.readbacks`). On the card the
program is captured once per padded shape (rows, groups, cells) as a
CUDA graph and replayed (`_Replay`): a batch is one input copy, one
graph launch and one readback, where the ops one by one are ~800
launches. Each launch gives up the interpreter lock, and while other
threads run Python (the agent's event loop, other stores' applies) a
thread that gives it up waits up to a switch interval (5 ms) to get it
back, so an eager batch among busy threads took seconds (PERF.md §5,
the agent). On the CPU the same packed program runs eagerly.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from corrosion_tpu_torch.convert import _CRDT_BOOL, CRDT_INPUTS
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.metrics import (
    CRDT_MERGE_EVENTS,
    record_kernel_events,
)
from corrosion_tpu_torch.runtime.records import FLIGHT
from corrosion_tpu_torch.store.crdt import _clock_entry
from corrosion_tpu_torch.types.change import SENTINEL

_F64_EXACT = 1 << 53
_I32_MIN = -(2**31)


# ---------------------------------------------------------------------------
# host helpers


def value_digest(val) -> tuple:
    """(d0, d1, d2, d3, exact): a 112-bit order-preserving digest as four
    words that each fit int32 (at most 28 payload bits each). Order
    matches SQLite's value order: NULL < numeric < TEXT < BLOB; numerics
    by value, text and blobs bytewise.

    exact=True means the digest captures the full value order: NULLs,
    numerics representable exactly in float64, text and blobs of at most
    13 bytes (a 13-byte prefix and a capped length: equal prefixes order
    by length, which is the bytewise rule when one side is captured
    whole)."""
    if val is None:
        return 0, 0, 0, 0, True
    if isinstance(val, bool):
        val = int(val)
    if isinstance(val, (int, float)):
        if isinstance(val, int):
            exact = -_F64_EXACT <= val <= _F64_EXACT
        else:
            exact = True
        f = float(val)
        # total-order map of float64 to uint64: flip the sign bit of
        # positives, every bit of negatives
        bits = struct.unpack(">Q", struct.pack(">d", f))[0]
        if bits & (1 << 63):
            bits = (~bits) & 0xFFFFFFFFFFFFFFFF
        else:
            bits |= 1 << 63
        d0 = (1 << 28) | (bits >> 40)  # rank 1 + top 24 bits
        d1 = (bits >> 12) & 0xFFFFFFF
        d2 = (bits & 0xFFF) << 16
        return d0, d1, d2, 0, exact
    if isinstance(val, str):
        rank, data = 2, val.encode("utf-8")
    elif isinstance(val, (bytes, bytearray, memoryview)):
        rank, data = 3, bytes(val)
    else:  # pragma: no cover - the schema admits only SQLite types
        return (4 << 28) - 1, 0, 0, 0, False
    exact = len(data) <= 13
    # two values of 14 bytes or more with equal prefixes tie at length 14
    # and are inexact
    w = int.from_bytes(
        data[:13].ljust(13, b"\x00") + bytes([min(len(data), 14)]), "big"
    )
    d0 = (rank << 28) | ((w >> 84) & 0xFFFFFFF)
    d1 = (w >> 56) & 0xFFFFFFF
    d2 = (w >> 28) & 0xFFFFFFF
    d3 = w & 0xFFFFFFF
    return d0, d1, d2, d3, exact


def _pad(n: int) -> int:
    p = 64
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the decision program


def _lex_gt(a, b) -> torch.Tensor:
    """Strict lexicographic a > b over tuples of equal-length tensors."""
    gt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for xa, xb in zip(a, b):
        gt = gt | (eq & (xa > xb))
        eq = eq & (xa == xb)
    return gt


def _packed_keys(keys) -> List[torch.Tensor]:
    """int64 keys, most significant first, that order like `keys` (int32,
    `jnp.lexsort` order: the last is the primary): each packs two keys as
    hi * 2^32 + (lo + 2^31), which spans exactly the int64 range."""
    keys = list(keys)
    out = []
    while keys:
        hi = keys.pop().long()
        out.append(hi * 2**32 + (keys.pop().long() + 2**31) if keys else hi)
    return out


def _stable_order(packed) -> torch.Tensor:
    """The stable ascending order of rows by `packed` (most significant
    first): one stable sort per key, from the least significant."""
    order = torch.sort(packed[-1], stable=True).indices
    for k in reversed(packed[:-1]):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _lexsort(keys) -> torch.Tensor:
    """`jnp.lexsort(keys)` for int32 keys: equal keys keep input order."""
    return _stable_order(_packed_keys(keys))


def _seg_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    start = torch.ones_like(sorted_ids, dtype=torch.bool)
    start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return start


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _seg_exclusive_lexmax(keys, seg_start, neg, n_key: int):
    """Exclusive segmented prefix lexicographic max in sorted order.

    keys: tuple of int32 tensors; the first `n_key` order the max and the
    rest are payload carried with the winning element. seg_start: bool
    tensor; neg: per-component 'minus infinity' / default values. Element
    i gets the max of its segment's elements before it, or `neg` at a
    segment start; on a tie the earliest element's payload wins."""
    n = keys[0].shape[0]
    b = max(1, (n - 1).bit_length())
    if 3 * b > 63:
        raise ValueError(f"{n} rows: the packed scan key holds at most 2^21")
    start = seg_start.clone()
    start[:1].fill_(True)  # a kernel, where `start[0] = True` copies
    # shift right by one, `neg` at each segment start: the inclusive scan
    # of `reset` is the exclusive scan of `keys`
    reset = tuple(k.roll(1).masked_fill(start, nv) for k, nv in zip(keys, neg))
    packed = _packed_keys(reversed(reset[:n_key]))
    order = _stable_order(packed)
    new = torch.zeros(n, dtype=torch.bool, device=start.device)
    for k in packed:
        ks = k[order]
        new[1:] |= ks[1:] != ks[:-1]
    rank = torch.empty(n, dtype=torch.int64, device=start.device)
    rank[order] = torch.cumsum(new, 0)
    seg = torch.cumsum(start, 0) - 1
    later = torch.arange(n - 1, -1, -1, device=start.device)
    # segments ascend, so the segment id resets the running max; within a
    # segment the larger rank wins, then the earlier row; all distinct
    _, arg = torch.cummax((seg << (2 * b)) | (rank << b) | later, 0)
    return tuple(r[arg] for r in reset)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """`jax.ops.segment_max` of int32 values: an empty segment holds the
    int32 minimum."""
    out = torch.full((num_segments,), _I32_MIN, dtype=torch.int32,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amax", include_self=True)


def _merge_kernel(grp, cellg, cl, cv, d0, d1, d2, d3, exact, fake, pos,
                  is_sent, valid, num_groups: int, num_cells: int):
    """All-batch merge decisions, on the device of the inputs.

    Inputs are 1-D int32/bool tensors over changes and baseline rows
    (baselines carry pos = -1). Padding rows have valid = False; valid
    rows have grp < num_groups - 1 and cellg < num_cells - 1 (the last
    group and cell are reserved for padding). Returns, as the reference:
    win, transition [rows] bool; final_cl [num_groups] int32;
    any_transition, any_delete [num_groups] bool; max_erase [num_groups]
    int32; cell_winner, clock_winner [num_cells] int32 (a row or -1);
    ambiguous, a 0-d bool; events [4] int32 in `CRDT_MERGE_EVENTS` order.
    """
    neg = -1
    is_change = valid & (pos >= 0)

    # ---- pass 1: row-cl prefix maxima in arrival order -------------------
    order1 = _lexsort((pos, grp))
    v1 = valid[order1]
    cl1 = cl[order1].masked_fill(~v1, neg)
    (prev_max,) = _seg_exclusive_lexmax((cl1,), _seg_starts(grp[order1]),
                                        (neg,), n_key=1)
    is_change1 = is_change[order1]
    inv1 = _inverse(order1)
    transition = (is_change1 & (cl1 > prev_max))[inv1]
    equal_cl = (is_change1 & (cl1 == prev_max))[inv1]
    candidate = ((cl1 >= prev_max) & v1)[inv1]

    # per-group aggregates
    gsafe = torch.where(valid, grp, num_groups - 1).long()
    final_cl = _segment_max(cl.masked_fill(~valid, neg), gsafe, num_groups)
    any_transition = _segment_max(transition.int(), gsafe, num_groups) > 0
    applied_even = transition & (cl % 2 == 0)
    max_erase = _segment_max(cl.masked_fill(~applied_even, neg), gsafe,
                             num_groups)
    any_delete = _segment_max(applied_even.int(), gsafe, num_groups) > 0

    # ---- pass 2: per-(pk, cid) key scans ---------------------------------
    key = (cl, cv, d0, d1, d2, d3)
    order2 = _lexsort((pos, cellg))
    v2 = valid[order2]
    key2 = tuple(k[order2].masked_fill(~v2, neg) for k in key)
    # exactness and fake-digest bits ride along as payload of the running
    # max element
    exact2 = exact[order2].int().masked_fill(~v2, 1)
    fake2 = fake[order2].int().masked_fill(~v2, 0)
    scanned = _seg_exclusive_lexmax(
        key2 + (exact2, fake2), _seg_starts(cellg[order2]),
        (neg,) * 6 + (1, 0), n_key=6)
    prev_key2, prev_exact2, prev_fake2 = scanned[:6], scanned[6], scanned[7]
    beats_prev2 = _lex_gt(key2, prev_key2)
    # a digest-level tie with EITHER side inexact cannot be decided here
    eq_prev2 = ~beats_prev2 & ~_lex_gt(prev_key2, key2)
    fuzzy2 = eq_prev2 & ((exact2 == 0) | (prev_exact2 == 0))
    # a (cl, cv)-level tie against a FAKE baseline digest (the local value
    # was not prefetched): the digest comparison means nothing either way
    clcv_eq2 = (key2[0] == prev_key2[0]) & (key2[1] == prev_key2[1])
    fuzzy2 = fuzzy2 | (clcv_eq2 & (prev_fake2 == 1))
    inv2 = _inverse(order2)
    beats_prev = beats_prev2[inv2]
    eq_fuzzy = fuzzy2[inv2]

    # the win mask: each change's outcome at its position
    odd = cl % 2 == 1
    live_col = equal_cl & odd & ~is_sent
    win = (transition | (live_col & beats_prev)) & is_change
    # an equal-cl non-sentinel candidate tying the running max on a digest
    # either side of which is inexact: the host must re-decide the batch
    tie_risk = live_col & eq_fuzzy & is_change
    ambiguous = tie_risk.any()

    # ---- final writers per (pk, cid) -------------------------------------
    csafe = torch.where(valid, cellg, num_cells - 1)
    erase_of = max_erase[gsafe]
    final_of = final_cl[gsafe]
    cell_live = candidate & (cl > erase_of) & ~is_sent & valid
    # clock rows come only from ODD-cl writes: an even (delete) transition
    # carrying a non-sentinel cid records only its sentinel entry
    clock_live = candidate & (cl == final_of) & ~is_sent & valid & win & odd
    # baselines count only when no transition reset the clock rows
    base_clock_live = (pos < 0) & ~is_sent & valid & (cl == final_of)
    clock_cand = clock_live | base_clock_live
    cell_cand = cell_live & (win | (pos < 0))
    full = key + (-pos,)  # later arrivals lose ties: the first writer keeps

    def seg_arglexmax(mask):
        # the winner is the lexicographically largest (key, -pos) among
        # the mask's rows: sort by (cell, key, -pos), take each segment's
        # last row
        masked = tuple(k.masked_fill(~mask, neg) for k in full)
        o = _lexsort(tuple(reversed(masked)) + (csafe,))
        cs = csafe[o]
        is_last = torch.ones_like(mask)
        is_last[:-1] = cs[1:] != cs[:-1]
        rows = torch.where(is_last & mask[o], o.int(), neg)
        # every row but its segment's last writes -1 to the reserved last
        # cell: amax over -1 and at most one row per cell is the
        # reference's scatter
        at = torch.where(is_last, cs, num_cells - 1).long()
        winners = torch.full((num_cells,), neg, dtype=torch.int32,
                             device=mask.device)
        return winners.scatter_reduce_(0, at, rows, "amax", include_self=True)

    cell_winner = seg_arglexmax(cell_cand)
    clock_winner = seg_arglexmax(clock_cand)

    # the events lane, in CRDT_MERGE_EVENTS order
    events = torch.stack([
        win.sum(dtype=torch.int32),  # decide_won
        transition.sum(dtype=torch.int32),  # decide_transition
        (is_change & ~win).sum(dtype=torch.int32),  # decide_stale
        tie_risk.sum(dtype=torch.int32),  # decide_ambiguous
    ])
    return (win, transition, final_cl, any_transition, any_delete, max_erase,
            cell_winner, clock_winner, ambiguous, events)


# the outputs of `_merge_kernel` that are bool on the host
_BOOL_OUT = (0, 1, 3, 4, 8)


def read_decisions(out) -> tuple:
    """The ten outputs of `_merge_kernel` as numpy arrays, in one
    device-to-host copy: one int32 buffer, split on the host."""
    parts = [o.reshape(-1).to(torch.int32) for o in out]
    flat = torch.cat(parts).cpu().numpy()
    _count_readback()
    return _split(flat, [p.numel() for p in parts])


read_decisions.readbacks = 0
_READBACKS_LOCK = threading.Lock()


def _count_readback() -> None:
    with _READBACKS_LOCK:  # stores apply from worker threads at once
        read_decisions.readbacks += 1


def _split(flat: np.ndarray, sizes) -> list:
    """The ten outputs from their flattened int32 readback."""
    res, at = [], 0
    for i, k in enumerate(sizes):
        a = flat[at:at + k]
        at += k
        res.append(a.astype(bool) if i in _BOOL_OUT else a)
    res[8] = res[8].reshape(())
    return tuple(res)


# ---------------------------------------------------------------------------
# host wrapper (the engine contract of the store's native merge engine)


class Marshaled(NamedTuple):
    """A batch as the decision program's inputs (`arrays`, the argument
    of `convert.crdt_inputs_to_torch`) and the ids that map its outputs
    back: pks by group, group by pk, cell by (group, cid)."""
    arrays: dict
    pks: List[bytes]
    pk_ids: Dict[bytes, int]
    cell_ids: Dict[tuple, int]


def marshal(chs: Sequence, st: Dict[bytes, dict]) -> Optional[Marshaled]:
    """The rows of one batch: one per change in arrival order, then per pk
    a sentinel baseline at the local cl and one baseline per locally
    clocked cid the batch touches. None where a cl or col_version does not
    fit int32."""
    pks: List[bytes] = []
    pk_ids: Dict[bytes, int] = {}
    cell_ids: Dict[tuple, int] = {}
    rows_grp: List[int] = []
    rows_cell: List[int] = []
    rows_cl: List[int] = []
    rows_cv: List[int] = []
    rows_d = [[], [], [], []]
    rows_exact: List[bool] = []
    rows_fake: List[bool] = []
    rows_pos: List[int] = []
    rows_sent: List[bool] = []

    def add_row(g, c, cl, cv, dig, exact, pos, sent, fake=False):
        if not (0 <= cl < 2**31 and 0 <= cv < 2**31):
            raise OverflowError
        rows_grp.append(g)
        rows_cell.append(c)
        rows_cl.append(cl)
        rows_cv.append(cv)
        for k in range(4):
            rows_d[k].append(dig[k])
        rows_exact.append(exact)
        rows_fake.append(fake)
        rows_pos.append(pos)
        rows_sent.append(sent)

    def cell_id(g: int, cid: str) -> int:
        key = (g, cid)
        cid_idx = cell_ids.get(key)
        if cid_idx is None:
            cid_idx = len(cell_ids)
            cell_ids[key] = cid_idx
        return cid_idx

    try:
        # change rows (arrival order = pos)
        for j, ch in enumerate(chs):
            g = pk_ids.get(ch.pk)
            if g is None:
                g = len(pk_ids)
                pk_ids[ch.pk] = g
                pks.append(ch.pk)
            sent = ch.cid == SENTINEL
            d0, d1, d2, d3, exact = value_digest(None if sent else ch.val)
            add_row(
                g, cell_id(g, ch.cid), ch.cl,
                0 if sent else ch.col_version,
                (d0, d1, d2, d3), exact, j, sent,
            )
        # baseline rows: one per pk (row cl, as sentinel) + one per
        # locally clocked cid that appears in this batch
        for pk, g in pk_ids.items():
            s = st[pk]
            local_cl = s["cl"]
            add_row(
                g, cell_id(g, SENTINEL), local_cl, 0,
                (0, 0, 0, 0), True, -1, True,
            )
            disk = s["disk"] or {}
            for cid, cv in s["clock"].items():
                if cid == SENTINEL or (g, cid) not in cell_ids:
                    continue
                if cid in disk:
                    d0, d1, d2, d3, exact = value_digest(disk[cid])
                    fake = False
                else:
                    # value not prefetched: the digest is a placeholder,
                    # and ANY equal-(cl, cv) comparison against it must
                    # send the batch to a host engine
                    d0, d1, d2, d3, exact, fake = 0, 0, 0, 0, False, True
                add_row(
                    g, cell_ids[(g, cid)], local_cl, cv,
                    (d0, d1, d2, d3), exact, -1, False, fake=fake,
                )
    except OverflowError:
        return None

    total = len(rows_grp)
    pad_n = _pad(total)
    num_groups = _pad(len(pk_ids) + 1)
    num_cells = _pad(len(cell_ids) + 1)

    def arr(xs, dtype=np.int32, fill=0):
        a = np.full(pad_n, fill, dtype=dtype)
        a[:total] = xs
        return a

    valid = np.zeros(pad_n, dtype=bool)
    valid[:total] = True
    arrays = dict(
        grp=arr(rows_grp, fill=num_groups - 1),
        cellg=arr(rows_cell, fill=num_cells - 1),
        cl=arr(rows_cl), cv=arr(rows_cv),
        d0=arr(rows_d[0]), d1=arr(rows_d[1]), d2=arr(rows_d[2]),
        d3=arr(rows_d[3]),
        exact=arr(rows_exact, dtype=bool), fake=arr(rows_fake, dtype=bool),
        pos=arr(rows_pos, fill=-1), is_sent=arr(rows_sent, dtype=bool),
        valid=valid, num_groups=num_groups, num_cells=num_cells,
    )
    return Marshaled(arrays, pks, pk_ids, cell_ids)


def merge_table_array(
    store,
    tbl: str,
    chs: Sequence,
    st: Dict[bytes, dict],
    rcl: Dict[bytes, int],
    clr: set,
    ckf: Dict[bytes, Dict[str, tuple]],
    clf: Dict[bytes, Dict[str, object]],
    rdel: set,
    rens: set,
    *,
    device=None,
    record: Optional[dict] = None,
) -> Optional[List[bool]]:
    """Merge one table's changes through the decision program; None means
    the caller must use another engine (an ambiguous value tie, or an int
    out of int32 range).

    The engine contract of the store's other engines: `chs` are change
    objects (pk, cid, val, col_version, db_version, seq, site_id, cl,
    ts.ntp64), `st` the local state per pk (cl, clock, vals, disk), and
    the six plans (row cls, cleared rows, clock and cell flushes, row
    deletes and ensures) are filled in place. `store` and `tbl` are not
    read. Runs on `device` (`runtime.device.resolve_device`: the card
    unless the CPU is named). With `record`, the dict receives the batch's
    phase times in ms (marshal, h2d, device, readback, rebuild; the device
    time from CUDA events on the card) and the ten outputs."""
    n = len(chs)
    if n == 0:
        return []
    dev = resolve_device(device)
    t0 = time.perf_counter()
    batch = marshal(chs, st)
    if batch is None:
        return None
    return _decide_and_rebuild(batch, chs, st, rcl, clr, ckf, clf, rdel,
                               rens, dev, record, t0)


def pack_inputs(arrays) -> np.ndarray:
    """The program's thirteen inputs (`convert.CRDT_INPUTS` order, all of
    one length) as one C-contiguous int32 [13, rows] array."""
    n = len(arrays["grp"])
    packed = np.empty((len(CRDT_INPUTS), n), dtype=np.int32)
    for i, name in enumerate(CRDT_INPUTS):
        a = arrays[name]
        if a.shape != (n,):
            raise ValueError(f"crdt input {name}: need [{n}], got {a.shape}")
        packed[i] = a
    return packed


def _program(buf: torch.Tensor, num_groups: int,
             num_cells: int) -> torch.Tensor:
    """`_merge_kernel` on packed inputs; its ten outputs flattened into one
    int32 vector (`_out_sizes` order)."""
    kw = {name: (buf[i] != 0) if name in _CRDT_BOOL else buf[i]
          for i, name in enumerate(CRDT_INPUTS)}
    out = _merge_kernel(**kw, num_groups=num_groups, num_cells=num_cells)
    return torch.cat([o.reshape(-1).to(torch.int32) for o in out])


def _out_sizes(n: int, num_groups: int, num_cells: int) -> tuple:
    return (n, n) + (num_groups,) * 4 + (num_cells, num_cells, 1, 4)


class _Replay:
    """The decision program captured as a CUDA graph for one padded shape
    on one card: a static input buffer, the graph, its static output.
    One batch at a time uses it (`lock`)."""

    def __init__(self, dev: torch.device, n: int, num_groups: int,
                 num_cells: int):
        self.lock = threading.Lock()
        self.buf = torch.zeros((len(CRDT_INPUTS), n), dtype=torch.int32,
                               device=dev)
        # a warm-up run first: lazy library set-up and the
        # allocator's blocks happen outside the capture
        _program(self.buf, num_groups, num_cells)
        torch.cuda.current_stream(dev).synchronize()
        self.graph = torch.cuda.CUDAGraph()
        # other threads keep launching their own batches meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = _program(self.buf, num_groups, num_cells)


# captured programs by (device, rows, groups, cells), all powers of two,
# least recently used first; past `_MAX_REPLAYS` the least recently used
# is dropped (a batch still replaying it holds its own reference) and
# its memory pool goes with it. The agent's runs use a few shapes each
# (`replay_stats`, PERF.md §5). A capture synchronizes the card and
# runs `gc.collect` (`torch.cuda.graph`), and two captures must not
# share the capture stream: captures take `_CAPTURE_LOCK` one at a time,
# while batches of shapes already captured go on replaying.
_REPLAYS: "OrderedDict[tuple, _Replay]" = OrderedDict()
_REPLAYS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_MAX_REPLAYS = 64
_STATS = {"captures": 0, "evicted": 0, "capture_s": 0.0,
          "captured_bytes": 0}


def replay_stats() -> dict:
    """The cache in this process: shapes held, captures made and the
    seconds they took, shapes evicted, and the device memory the
    captures reserved (the growth of `torch.cuda.memory_reserved` across
    each capture, the graphs' private pools and static buffers)."""
    with _REPLAYS_LOCK:
        return {"shapes": len(_REPLAYS), **_STATS}


def _cached(key) -> Optional[_Replay]:
    with _REPLAYS_LOCK:
        rep = _REPLAYS.get(key)
        if rep is not None:
            _REPLAYS.move_to_end(key)
        return rep


def _replay_for(dev: torch.device, n: int, num_groups: int,
                num_cells: int) -> _Replay:
    key = (dev.index, n, num_groups, num_cells)
    rep = _cached(key)
    if rep is not None:
        return rep
    with _CAPTURE_LOCK:
        rep = _cached(key)
        if rep is not None:
            return rep
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        rep = _Replay(dev, n, num_groups, num_cells)
        grown = torch.cuda.memory_reserved(dev) - reserved
        with _REPLAYS_LOCK:
            _REPLAYS[key] = rep
            while len(_REPLAYS) > _MAX_REPLAYS:
                _REPLAYS.popitem(last=False)
                _STATS["evicted"] += 1
            _STATS["captures"] += 1
            _STATS["capture_s"] += time.perf_counter() - t0
            _STATS["captured_bytes"] += max(0, grown)
    return rep


def run_packed(packed: np.ndarray, num_groups: int, num_cells: int, dev,
               timed: bool = False):
    """The ten outputs of the program on `packed` inputs (`pack_inputs`),
    read back in one copy: a graph replay on the card, the ops one by one
    on the CPU. Returns (outputs as `read_decisions` gives them, device
    ms or None, the host-to-device copy's ms)."""
    n = packed.shape[1]
    sizes = _out_sizes(n, num_groups, num_cells)
    host = torch.from_numpy(packed)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        buf = host.to(dev)
        t1 = time.perf_counter()
        flat = _program(buf, num_groups, num_cells).cpu().numpy()
        _count_readback()
        return _split(flat, sizes), None, 1e3 * (t1 - t0)
    rep = _replay_for(dev, n, num_groups, num_cells)
    with rep.lock:
        t0 = time.perf_counter()
        rep.buf.copy_(host)
        t1 = time.perf_counter()
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        rep.graph.replay()
        if timed:
            events[1].record()
        flat = rep.out.cpu().numpy()
    _count_readback()
    device_ms = events[0].elapsed_time(events[1]) if timed else None
    return _split(flat, sizes), device_ms, 1e3 * (t1 - t0)


def _decide_and_rebuild(batch, chs, st, rcl, clr, ckf, clf, rdel, rens, dev,
                        record, t0):
    """`merge_table_array` past the marshal."""
    n = len(chs)
    packed = pack_inputs(batch.arrays)
    t2 = time.perf_counter()
    outs, device_ms, h2d_ms = run_packed(
        packed, batch.arrays["num_groups"], batch.arrays["num_cells"], dev,
        timed=record is not None)
    (win, transition, final_cl, any_tr, any_del, max_erase, cell_winner,
     clock_winner, ambiguous, ev) = outs
    t4 = time.perf_counter()
    if record is not None:
        # with one graph launch there is no host-side split of device
        # time and readback: device ms from CUDA events on the card (the
        # CPU's program time otherwise), readback the rest
        run_ms = 1e3 * (t4 - t2) - h2d_ms
        dev_ms = device_ms if device_ms is not None else run_ms
        record.update(
            marshal_ms=1e3 * (t2 - t0), h2d_ms=h2d_ms, device_ms=dev_ms,
            readback_ms=max(0.0, run_ms - dev_ms), rebuild_ms=0.0,
            rows=len(batch.arrays["grp"]), outputs=outs,
        )
    if bool(ambiguous):
        # the batch goes to a host engine: only the ambiguity count is real
        # telemetry (the fallback re-makes the win/stale decisions, and
        # recording them here would count them twice)
        ev_list = [0, 0, 0, int(ev[3])]
        record_kernel_events("crdt_merge", ev_list)
        FLIGHT.record_host_frame("crdt_merge",
                                 dict(zip(CRDT_MERGE_EVENTS, ev_list)))
        return None
    record_kernel_events("crdt_merge", ev)
    # the engine has no scan carry, so its flight frames are host-side:
    # one per decided batch, the same lanes as the counters
    FLIGHT.record_host_frame(
        "crdt_merge", dict(zip(CRDT_MERGE_EVENTS, (int(v) for v in ev))))

    # ---- rebuild the engine-contract flush plans -------------------------
    pks, pk_ids, cell_ids = batch.pks, batch.pk_ids, batch.cell_ids
    wins = [bool(win[j]) for j in range(n)]
    # one pass over the changes: per pk the final-transition change and
    # whether any change won
    final_transition: Dict[bytes, object] = {}
    any_win_pk: Dict[bytes, bool] = {}
    for j, ch in enumerate(chs):
        if wins[j]:
            any_win_pk[ch.pk] = True
        if transition[j] and ch.cl == int(final_cl[pk_ids[ch.pk]]):
            final_transition.setdefault(ch.pk, ch)
    for pk, g in pk_ids.items():
        s = st[pk]
        fcl = int(final_cl[g])
        if bool(any_tr[g]):
            s["cl"] = fcl
            rcl[pk] = fcl
            clr.add(pk)
            # the sentinel clock entry of the transition that reached fcl
            ckf[pk] = {SENTINEL: _clock_entry(final_transition[pk], fcl)}
            s["clock"] = {SENTINEL: fcl}
        if bool(any_del[g]):
            rdel.add(pk)
            if fcl % 2 == 0:
                s["vals"] = {}
                clf.pop(pk, None)
        if fcl % 2 == 1 and any_win_pk.get(pk):
            rens.add(pk)

    # cell and clock winners
    for (g, cid), cidx in cell_ids.items():
        if cid == SENTINEL:
            continue
        pk = pks[g]
        if int(final_cl[g]) % 2 == 0:
            continue  # dead row: no cells
        cw = int(cell_winner[cidx])
        if 0 <= cw < n:
            ch = chs[cw]
            clf.setdefault(pk, {})[cid] = ch.val
            st[pk]["vals"][cid] = ch.val
        kw = int(clock_winner[cidx])
        if 0 <= kw < n:
            ch = chs[kw]
            ckf.setdefault(pk, {})[cid] = _clock_entry(ch, ch.col_version)
            st[pk]["clock"][cid] = ch.col_version
    if record is not None:
        record["rebuild_ms"] = 1e3 * (time.perf_counter() - t4)
    return wins
