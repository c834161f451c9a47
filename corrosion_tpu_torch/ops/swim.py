"""Batched SWIM failure detection and infection-style dissemination on
PyTorch: the counterpart of `corrosion_tpu/ops/swim.py`.

Every member advances one protocol period per `tick_impl`; the state is a
`SwimState` of tensors with the reference's field names, and each tick is
bit-equal to the JAX tick from the same key (tests/test_torch_swim.py).
The key encoding, the protocol phases and the telemetry lanes are the
reference's; see its module docstring for the protocol itself:

    key = 0                     unknown
    key = (inc + 1) * 4 + prec  known at incarnation inc, prec 0 alive /
                                1 suspect / 2 down

so the protocol merge of any number of updates is a max.

PyTorch idiom: plain functions on tensors, an explicit device, no jit.
Two departures from the functional reference, both stated where they
happen:

- the [N, N] int16 view is updated IN PLACE (`tick_impl`, `set_*` leave
  it alone): a tick returns a new `SwimState` whose `view` is the input
  state's tensor, so a caller must not reuse the input state, just as
  the JAX drivers never reuse a donated one;
- the tick index `t` stays a 0-d device tensor, and the windows that
  depend on it are read with device index tensors, so a tick makes no
  host sync.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import inbox_cuda
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.metrics import FLIGHT_CENSUS, KERNEL_EVENTS

INT32_MAX = 2**31 - 1
_I16_MIN = -(2**15)

N_EVENTS = len(KERNEL_EVENTS)
N_CENSUS = len(FLIGHT_CENSUS)
N_FLIGHT_LANES = N_EVENTS + N_CENSUS

PREC_ALIVE = 0
PREC_SUSPECT = 1
PREC_DOWN = 2


class SwimParams(NamedTuple):
    """Static protocol parameters: the reference's fields and defaults
    (see `corrosion_tpu/ops/swim.py::SwimParams` for each one's meaning).
    `inbox_impl` takes "sort", "gsort" or "cuda" (the Hopper kernel, the
    counterpart of the reference's "pallas")."""

    n: int
    fanout: int = 2
    piggyback: int = 8
    buffer_slots: int = 16
    incoming_slots: int = 16
    susp_slots: int = 4
    max_transmissions: int = 10
    direct_timeout: int = 1
    indirect_timeout: int = 1
    indirect_probes: int = 3
    suspicion_ticks: int = 6
    probe_candidates: int = 4
    antientropy: int = 2
    feed_entries: int = 25
    feeds_per_tick: int = 4
    announce_period: int = 8
    loss: float = 0.0
    inbox_impl: str = "gsort"
    gossip_mode: str = "shift"
    ring_ticks: int = 128
    lhm_max: int = 0
    lhm_decay_ticks: int = 8
    susp_ceiling: int = 3
    susp_k: int = 3


VIEW_DTYPE = torch.int16
INC_CAP = 8189  # incarnations saturate here: (INC_CAP+1)*4 + prec < 2^15
_KEY_CLAMP_BASE = (INC_CAP + 1) * 4  # multiple of 4: prec bits survive


class SwimState(NamedTuple):
    t: torch.Tensor  # () int32 current tick
    alive: torch.Tensor  # [N] bool ground-truth liveness
    inc: torch.Tensor  # [N] int32 own incarnation
    view: torch.Tensor  # [N, N] int16 key matrix view[obs, subj]
    buf_subj: torch.Tensor  # [N, B] int32 (N = empty)
    buf_key: torch.Tensor  # [N, B] int32
    buf_sent: torch.Tensor  # [N, B] int32 send counts
    probe_phase: torch.Tensor  # [N] int32 0 idle / 1 direct / 2 indirect
    probe_subj: torch.Tensor  # [N] int32
    probe_deadline: torch.Tensor  # [N] int32
    probe_ok: torch.Tensor  # [N] bool
    susp_subj: torch.Tensor  # [N, S] int32 (N = empty)
    susp_inc: torch.Tensor  # [N, S] int32
    susp_deadline: torch.Tensor  # [N, S] int32
    partition: torch.Tensor  # [N] int32 network partition group
    events: torch.Tensor  # [N_EVENTS] int32 cumulative, wraps mod 2^32
    ring: torch.Tensor  # [ring_ticks, N_FLIGHT_LANES] int32 flight ring
    lhm: torch.Tensor  # [N] int32 Local Health Multiplier score
    susp_conf: torch.Tensor  # [N, S] int32 confirmations per open timer
    susp_start: torch.Tensor  # [N, S] int32 tick the timer opened
    deg_loss: torch.Tensor  # [N] float32 injected outbound loss
    deg_lag: torch.Tensor  # [N] int32 injected detector lag (ticks)


class FlightDrain(NamedTuple):
    """Host snapshot of the device flight ring: the raw [R, L] rows and
    the absolute tick they were drained at (ticks [max(0, t - R), t) are
    live; row j holds tick j + k*R)."""

    ring: object  # np.ndarray [ring_ticks, N_FLIGHT_LANES] int32
    t: int


# ---------------------------------------------------------------------------
# key encoding


def make_key(inc, prec):
    return (inc + 1) * 4 + prec


def key_inc(key):
    return torch.div(key, 4, rounding_mode="floor") - 1


def key_prec(key):
    return key % 4


def key_known(key):
    return key > 0


def to_view_key(key: torch.Tensor) -> torch.Tensor:
    """Cast int32 keys to the int16 view; out-of-range keys saturate at
    incarnation INC_CAP without changing their precedence class."""
    over = key > (INC_CAP + 1) * 4 + 3
    return torch.where(over, _KEY_CLAMP_BASE + (key & 3), key).to(VIEW_DTYPE)


def finger_offsets(n: int, device=None) -> torch.Tensor:
    """Chord-style bootstrap offsets 1, 2, 4, ... below n (int32)."""
    bits = max(1, (n - 1).bit_length())
    return (2 ** torch.arange(bits, device=device)).to(torch.int32)


# ---------------------------------------------------------------------------
# telemetry lanes


def _bsum(mask: torch.Tensor) -> torch.Tensor:
    """Exact int32 count of a bool mask."""
    return mask.sum(dtype=torch.int32)


def _event_vector(**counts) -> torch.Tensor:
    """Stack per-event 0-d int32 counts into the KERNEL_EVENTS order."""
    vals = [counts.pop(name).to(torch.int32) for name in KERNEL_EVENTS]
    if counts:  # a typo'd event name must not vanish silently
        raise ValueError(f"unknown kernel events: {sorted(counts)}")
    return torch.stack(vals)


def _census_frame(n: int, alive, susp_subj, inc, in_subj, lhm) -> torch.Tensor:
    """[N_CENSUS] int32 census in FLIGHT_CENSUS order ([N]-shaped
    reductions only, never a whole-view pass)."""
    return torch.stack(
        [
            _bsum(alive),
            _bsum(susp_subj < n),
            _bsum(~alive),
            (in_subj < n).sum(dim=1, dtype=torch.int32).max(),
            inc.max(),
            lhm.max(),
        ]
    )


@functools.lru_cache(maxsize=64)
def _susp_shrink_table(params: SwimParams, device) -> torch.Tensor:
    """[susp_k + 1] int32 Lifeguard LHA-Suspicion deadline table: the
    open-timer duration after c confirmations, from the ceiling
    suspicion_ticks * susp_ceiling down to suspicion_ticks at c = susp_k.
    Built once per (params, device): the host-to-device copy of the table
    waits for the card, so a tick must not make it every time. Callers
    only read it."""
    lo = params.suspicion_ticks
    hi = params.suspicion_ticks * params.susp_ceiling
    k = max(1, params.susp_k)
    table = [
        max(lo, math.ceil(hi - (hi - lo) * math.log2(c + 1) / math.log2(k + 1)))
        for c in range(k + 1)
    ]
    return torch.tensor(table, dtype=torch.int32, device=device)


def _ring_write(ring, t, ring_ticks: int, frame) -> torch.Tensor:
    """A copy of `ring` with row t % ring_ticks set to `frame` (t is a
    device scalar: no host sync)."""
    row = torch.remainder(t, ring_ticks).to(torch.int64).reshape(1)
    return ring.index_copy(0, row, frame[None, :])


# ---------------------------------------------------------------------------
# boot


def init_state(
    params: SwimParams,
    key: jr.Key,
    seeds_per_member: int = 3,
    seed_mode: str = "ring",
    device=None,
) -> SwimState:
    """Freshly booted cluster on `device` (the card unless "cpu" is asked
    for): every member knows itself plus a few bootstrap seeds — "ring"
    (the next k members), "hub" (members 0..k-1) or "fingers"
    (power-of-two offsets). `key` is unused, as in the reference."""
    del key
    dev = resolve_device(device)
    n, b, s = params.n, params.buffer_slots, params.susp_slots
    i32 = torch.int32
    alive_key = make_key(0, PREC_ALIVE)
    view = torch.zeros((n, n), dtype=VIEW_DTYPE, device=dev)
    idx = torch.arange(n, device=dev)
    view[idx, idx] = alive_key
    if seed_mode == "ring":
        for k in range(1, seeds_per_member + 1):
            view[idx, (idx + k) % n] = alive_key
    elif seed_mode == "hub":
        view[:, : min(seeds_per_member, n)] = alive_key
        view[idx, idx] = alive_key
    elif seed_mode == "fingers":
        strides = finger_offsets(n, dev).to(torch.int64)
        view[idx[:, None], (idx[:, None] + strides[None, :]) % n] = alive_key
    else:
        raise ValueError(f"unknown seed_mode {seed_mode!r}")

    buf_subj = torch.full((n, b), n, dtype=i32, device=dev)
    buf_key = torch.zeros((n, b), dtype=i32, device=dev)
    buf_sent = torch.full((n, b), INT32_MAX, dtype=i32, device=dev)
    buf_subj[:, 0] = idx.to(i32)
    buf_key[:, 0] = alive_key
    buf_sent[:, 0] = 0

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SwimState(
        t=zeros(),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        inc=zeros(n),
        view=view,
        buf_subj=buf_subj,
        buf_key=buf_key,
        buf_sent=buf_sent,
        probe_phase=zeros(n),
        probe_subj=torch.full((n,), n, dtype=i32, device=dev),
        probe_deadline=zeros(n),
        probe_ok=zeros(n, dtype=torch.bool),
        susp_subj=torch.full((n, s), n, dtype=i32, device=dev),
        susp_inc=zeros(n, s),
        susp_deadline=zeros(n, s),
        partition=zeros(n),
        events=zeros(N_EVENTS),
        ring=zeros(params.ring_ticks, N_FLIGHT_LANES),
        lhm=zeros(n),
        susp_conf=zeros(n, s),
        susp_start=zeros(n, s),
        deg_loss=zeros(n, dtype=torch.float32),
        deg_lag=zeros(n),
    )


# ---------------------------------------------------------------------------
# row helpers


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where none
    (`jnp.argmax` of a bool array)."""
    k = mask.shape[-1]
    pos = torch.arange(k, device=mask.device)
    first = torch.where(mask, pos, k).amin(dim=-1)
    return torch.where(first == k, 0, first)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (`jnp.argmax`)."""
    return _first_true(x == x.amax(dim=-1, keepdim=True))


def _pick_known_alive(view_rows, self_idx, key: jr.Key, params: SwimParams,
                      tries: int) -> torch.Tensor:
    """Per member, a subject its view holds as alive (not itself), n if
    none: `tries` random offsets, then two small ring offsets.

    The reference draws both offset sets with `randint` from the SAME key,
    so they share one split and one counter range: the ring draw's bits
    are the first 2N counters of the same planes, and one pair of planes
    serves both."""
    n = params.n
    rows = view_rows.shape[0]
    hi, lo = jr.randint_planes(key, rows * max(tries, 2), view_rows.device)
    offs = jr.randint_from_planes(hi[: rows * tries], lo[: rows * tries], 1, n)
    ring = jr.randint_from_planes(hi[: rows * 2], lo[: rows * 2], 1, 4)
    offs = torch.cat([offs.reshape(rows, tries), ring.reshape(rows, 2)], dim=1)
    cands = (self_idx[:, None] + offs) % n  # int64
    keys = view_rows.gather(1, cands)
    ok = key_known(keys) & (key_prec(keys) == PREC_ALIVE) & (
        cands != self_idx[:, None]
    )
    pick = cands.gather(1, _first_true(ok)[:, None])[:, 0]
    return torch.where(ok.any(dim=1), pick, n).to(torch.int32)


# (key, sent) pack into one non-negative int31 (see the reference's note:
# keys stay below 2^15 in the dense kernel, send counts clamp at 2^15 - 1)
_KEY_BITS = 15
_KEY_MAX = (1 << _KEY_BITS) - 1
_SENT_CLAMP = (1 << _KEY_BITS) - 1


def _lex_sort2(a: torch.Tensor, b: torch.Tensor):
    """Row-wise ascending sort by (a, b), both int32: one int64 sort of
    the packed pair (b offset to unsigned so the pack keeps its order)."""
    packed = (a.to(torch.int64) << 32) | (b.to(torch.int64) + 2**31)
    s = torch.sort(packed, dim=1).values
    return (s >> 32).to(torch.int32), ((s & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _dup_mask(subj_s: torch.Tensor) -> torch.Tensor:
    """True where a row-sorted subject repeats its left neighbour."""
    first = torch.zeros_like(subj_s[:, :1], dtype=torch.bool)
    return torch.cat([first, subj_s[:, 1:] == subj_s[:, :-1]], dim=1)


def _merge_inputs(n, buf_subj, buf_key, buf_sent, in_subj, in_key):
    subj = torch.cat([buf_subj, in_subj], dim=1)
    key = torch.cat([buf_key, in_key], dim=1)
    sent = torch.cat([buf_sent, torch.where(in_subj < n, 0, INT32_MAX)], dim=1)
    return subj, key, sent.to(torch.int32)


def buffer_merge_lex(params, buf_subj, buf_key, buf_sent, in_subj, in_key):
    """Three-operand lexicographic buffer merge, correct for full int32
    keys: dedupe by subject keeping (key desc, sent asc) first, then keep
    the `buffer_slots` least-sent entries. The three-key sort is three
    stable sorts, least significant key first."""
    n = params.n
    subj, key, sent = _merge_inputs(n, buf_subj, buf_key, buf_sent,
                                    in_subj, in_key)
    perm = torch.argsort(sent, dim=1, stable=True)
    for col in (-key, subj):
        perm = perm.gather(
            1, torch.argsort(col.gather(1, perm), dim=1, stable=True)
        )
    subj_s, key_s, sent_s = (x.gather(1, perm) for x in (subj, key, sent))
    dup = _dup_mask(subj_s)
    subj_s = torch.where(dup, n, subj_s)
    key_s = torch.where(dup, 0, key_s)
    sent_s = torch.where(dup, INT32_MAX, sent_s)
    sent_f, order = torch.sort(sent_s, dim=1, stable=True)
    b = params.buffer_slots
    return (subj_s.gather(1, order)[:, :b], key_s.gather(1, order)[:, :b],
            sent_f[:, :b])


def _buffer_merge(params: SwimParams, buf_subj, buf_key, buf_sent,
                  in_subj, in_key):
    """Merge incoming updates (send count 0) into each member's buffer:
    dedupe by subject keeping the highest key, then keep the
    `buffer_slots` least-sent entries (fresher keys first on ties).
    Dense kernel only: keys must stay below 2^15 (see the pack note)."""
    n = params.n
    subj, key, sent = _merge_inputs(n, buf_subj, buf_key, buf_sent,
                                    in_subj, in_key)
    sent_c = torch.clamp(sent, max=_SENT_CLAMP)
    # sort 1: subject asc, then (key desc, sent asc) as one packed word
    combo = ((_KEY_MAX - key) << _KEY_BITS) | sent_c
    subj_s, combo_s = _lex_sort2(subj, combo)
    key_s = _KEY_MAX - (combo_s >> _KEY_BITS)
    sent_s = combo_s & _SENT_CLAMP
    dup = _dup_mask(subj_s)
    subj_s = torch.where(dup, n, subj_s)
    # sort 2 (stable): least-sent first, fresher keys first on a tie
    combo2 = torch.where(
        dup,
        (_SENT_CLAMP << _KEY_BITS) | _KEY_MAX,
        (sent_s << _KEY_BITS) | (_KEY_MAX - key_s),
    )
    combo2_f, order = torch.sort(combo2, dim=1, stable=True)
    b = params.buffer_slots
    combo2_f = combo2_f[:, :b]
    return (
        subj_s.gather(1, order)[:, :b],
        _KEY_MAX - (combo2_f & _KEY_MAX),
        combo2_f >> _KEY_BITS,
    )


# ---------------------------------------------------------------------------
# gossip inbox


def _scatter_cells(n: int, slots: int, ok, row, col, subj, key):
    """Write messages into [n, slots] inboxes at unique cells (row, col)
    where `ok`; the rest go to one spare cell that is cut off. A real
    cell receives at most one message, so a plain scatter is exact; min
    with the empty subject and max with the empty key keep the
    reference's scatter-min/max semantics."""
    dev = subj.device
    ok = ok & (row >= 0) & (row < n)
    cell = torch.where(ok, row.to(torch.int64) * slots + col, n * slots)
    cell = cell.reshape(-1)
    out_s = torch.full((n * slots + 1,), n, dtype=torch.int32, device=dev)
    out_k = torch.zeros((n * slots + 1,), dtype=torch.int32, device=dev)
    out_s.scatter_(0, cell, torch.where(ok, torch.clamp(subj, max=n), n)
                   .reshape(-1))
    out_k.scatter_(0, cell, torch.where(ok, torch.clamp(key, min=0), 0)
                   .reshape(-1))
    return out_s[:-1].reshape(n, slots), out_k[:-1].reshape(n, slots)


def build_inbox(n: int, slots: int, dst, subj, key) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Flat inbox build: stable sort of the [M] messages by destination
    (masked ones carry dst = n), in-group ranks by a running max, then a
    unique-cell scatter into [n, slots]."""
    dst_s, order = torch.sort(dst, stable=True)
    subj_s, key_s = subj[order], key[order]
    pos = torch.arange(dst_s.shape[0], device=dst.device)
    is_start = torch.ones_like(dst_s, dtype=torch.bool)
    is_start[1:] = dst_s[1:] != dst_s[:-1]
    first = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = pos - first
    ok = (dst_s < n) & (rank < slots)
    return _scatter_cells(n, slots, ok, dst_s, rank, subj_s, key_s)


def build_inbox_grouped(n: int, slots: int, dst_g, subj, key, ok):
    """Grouped inbox build, bit-equal to `build_inbox` over the flattened
    messages: only the G packet heads are stably sorted by destination; a
    message's column is the valid count of earlier same-destination
    packets plus its valid prefix within its packet."""
    g = dst_g.shape[0]
    dev = dst_g.device
    cnt = ok.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(ok, dim=1, dtype=torch.int32) - ok.to(torch.int32)
    dst_s, idx_s = torch.sort(dst_g, stable=True)
    cnt_s = cnt[idx_s]
    cum_before = torch.cumsum(cnt_s, dim=0, dtype=torch.int32) - cnt_s
    is_start = torch.ones((g,), dtype=torch.bool, device=dev)
    is_start[1:] = dst_s[1:] != dst_s[:-1]
    # cum_before is non-decreasing: a running max of segment-start values
    # is each packet's segment base
    seg_start = torch.cummax(torch.where(is_start, cum_before, 0), dim=0).values
    base = torch.empty((g,), dtype=torch.int32, device=dev)
    base[idx_s] = cum_before - seg_start
    col = base[:, None] + pos
    keep = ok & (col < slots)
    rows = dst_g[:, None].expand_as(col)
    return _scatter_cells(n, slots, keep, rows, col, subj, key)


def dispatch_inbox(impl: str, n: int, slots: int, dst_g, subj_gm, key_gm,
                   ok_gm):
    """Build the bounded inbox with the selected implementation; all three
    consume the grouped [G, m] form and are bit-equal."""
    if impl == "gsort":
        return build_inbox_grouped(n, slots, dst_g, subj_gm, key_gm, ok_gm)
    if impl == "cuda":
        return inbox_cuda.build_inbox(n, slots, dst_g, subj_gm, key_gm, ok_gm)
    if impl != "sort":
        # a typo must not silently select the slowest path
        raise ValueError(f"unknown inbox_impl {impl!r}")
    dst = torch.where(ok_gm, dst_g[:, None], n).reshape(-1)
    subj = torch.where(ok_gm, subj_gm, n).reshape(-1)
    key = torch.where(ok_gm, key_gm, 0).reshape(-1)
    return build_inbox(n, slots, dst, subj, key)


def _window_pull_(view, t_off, fe: int, steps: int, src, ok) -> None:
    """Feed/seed exchange on the view, IN PLACE: window
    w = min(((t_off) % steps) * fe, n - fe) of every row takes the max
    with the same window of row src[i] where ok[i]. `t_off` is a device
    scalar, so the window is addressed by an index tensor, not a slice."""
    n = view.shape[0]
    w = torch.clamp(torch.remainder(t_off, steps) * fe, max=n - fe)
    cols = w.to(torch.int64) + torch.arange(fe, device=view.device)
    vw = view.index_select(1, cols)
    pulled = torch.where(ok[:, None], vw.index_select(0, src), 0)
    view.index_copy_(1, cols, torch.maximum(vw, pulled))


def _row_scatter_max_(view, cols, vals, prev) -> None:
    """view[i, cols[i, j]] = max(view[i, cols[i, j]], vals[i, j]), IN
    PLACE, given prev = view.gather(1, cols). Each row writes only its
    own row; duplicate columns within a row are reduced first, so the
    scatter needs no atomics."""
    same = cols[:, :, None] == cols[:, None, :]
    grp = torch.where(same, vals[:, None, :], _I16_MIN).amax(dim=2)
    view.scatter_(1, cols, torch.maximum(prev, grp))


# ---------------------------------------------------------------------------
# the tick


# the device code that one CUDA graph per tick would capture: the
# analyzer's kernel-purity rule lists every host sync in these functions
# and the module functions they reach
DEVICE_ROOTS = ("tick_impl", "_stats_sums")

def tick_impl(state: SwimState, key: jr.Key, params: SwimParams) -> SwimState:
    """Advance every member one SWIM protocol period. `state.view` is
    updated IN PLACE and carried into the returned state."""
    n = params.n
    view = state.view
    dev = view.device
    i32 = torch.int32
    idx = torch.arange(n, device=dev)
    idx32 = idx.to(i32)
    t = state.t
    r_probe, r_ack, r_helpers, r_gossip, r_loss = jr.split(key, 5)
    loss = float(np.float32(params.loss))  # compared in float32, as in JAX

    inc = state.inc
    alive = state.alive
    part = state.partition
    buf_subj, buf_key, buf_sent = state.buf_subj, state.buf_key, state.buf_sent
    susp_subj = state.susp_subj
    susp_inc = state.susp_inc
    susp_deadline = state.susp_deadline
    susp_conf = state.susp_conf
    susp_start = state.susp_start
    lhm = state.lhm
    deg_loss = state.deg_loss
    deg_lag = state.deg_lag

    lifeguard = params.lhm_max > 0
    mult = 1 + torch.clamp(lhm, 0, params.lhm_max) if lifeguard else 1
    open_ticks = params.suspicion_ticks * (
        params.susp_ceiling if lifeguard else 1
    )

    # own announcements this tick: suspect / down / refute / self-announce
    own_upd_subj = torch.full((n, 4), n, dtype=i32, device=dev)
    own_upd_key = torch.zeros((n, 4), dtype=i32, device=dev)

    # ---- 1. probe FSM ----------------------------------------------------
    phase, psubj, pdl, pok = (
        state.probe_phase,
        state.probe_subj,
        state.probe_deadline,
        state.probe_ok,
    )

    # 1a. escalate expired indirect probes to suspicion
    expire2 = (phase == 2) & (t >= pdl) & alive
    fail2 = expire2 & ~pok
    tgt_key = view[idx, torch.clamp(psubj, 0, n - 1).long()].to(i32)
    binc = torch.clamp(key_inc(tgt_key), min=0)
    own_upd_subj[:, 0] = torch.where(fail2, psubj, n)
    own_upd_key[:, 0] = torch.where(fail2, make_key(binc, PREC_SUSPECT), 0)
    # register a suspicion timer in a free slot (or steal the oldest);
    # every row writes exactly its own (row, slot) cell
    slot_score = torch.where(susp_subj == n, INT32_MAX, -susp_deadline)
    free = _argmax_first(slot_score)[:, None]

    def set_slot(lane, value):
        return lane.scatter(1, free, torch.where(
            fail2, value, lane.gather(1, free)[:, 0])[:, None].to(lane.dtype))

    susp_subj = set_slot(susp_subj, psubj)
    susp_inc = set_slot(susp_inc, binc)
    susp_deadline = set_slot(susp_deadline, t + open_ticks)
    susp_conf = set_slot(susp_conf, torch.zeros_like(psubj))
    susp_start = set_slot(susp_start, t.expand(n))
    phase = torch.where(expire2, 0, phase)
    if lifeguard:
        # LHA-Probe: a completed probe cycle cools down mult-1 ticks
        pdl = torch.where(expire2, t + mult - 1, pdl)

    # 1b. escalate expired direct probes to indirect probes
    expire1 = (phase == 1) & (t >= pdl) & alive
    fail1 = expire1 & ~pok
    helpers = jr.randint(r_helpers, (n, params.indirect_probes), 0, n, dev)
    helpers = helpers.long()
    psafe_t = torch.clamp(psubj, 0, n - 1).long()
    tgt_alive = alive[psafe_t] & (psubj < n)
    leg_u = jr.uniform(r_ack, (n, params.indirect_probes + 1), dev)
    path_loss = torch.clamp(
        torch.maximum(
            torch.maximum(deg_loss[:, None], deg_loss[helpers]),
            deg_loss[psafe_t][:, None],
        ),
        min=loss,
    )
    ind_win = params.indirect_timeout * mult
    ind_window_ok = ind_win >= params.indirect_timeout + deg_lag
    helper_reach = (part[helpers] == part[:, None]) & (
        part[helpers] == part[psafe_t][:, None]
    )
    helper_ok = (
        alive[helpers] & (leg_u[:, 1:] >= path_loss)
        & tgt_alive[:, None] & helper_reach
    )
    ind_ok = helper_ok.any(dim=1) & ind_window_ok
    phase = torch.where(fail1, 2, torch.where(expire1, 0, phase))
    pok = torch.where(fail1, ind_ok, pok)
    pdl = torch.where(fail1, t + ind_win, pdl)
    if lifeguard:
        pdl = torch.where(expire1 & ~fail1, t + mult - 1, pdl)

    # 1c. idle members start a new probe
    start = (phase == 0) & alive
    if lifeguard:
        start = start & (t >= pdl)
    target = _pick_known_alive(view, idx, r_probe, params,
                               params.probe_candidates)
    will = start & (target < n)
    tsafe = torch.clamp(target, 0, n - 1).long()
    d_loss = torch.clamp(torch.maximum(deg_loss, deg_loss[tsafe]), min=loss)
    d_win = params.direct_timeout * mult
    direct_ok = (
        alive[tsafe] & (target < n) & (leg_u[:, 0] >= d_loss)
        & (part[tsafe] == part)
        & (d_win >= params.direct_timeout + deg_lag)
    )
    phase = torch.where(will, 1, phase)
    psubj = torch.where(will, target, psubj)
    pdl = torch.where(will, t + d_win, pdl)
    pok = torch.where(will, direct_ok, pok)

    # ---- 2. suspicion timers ---------------------------------------------
    sdl_hit = (susp_subj < n) & (t >= susp_deadline) & alive[:, None]
    cur = view.gather(1, torch.clamp(susp_subj, 0, n - 1).long()).to(i32)
    still = sdl_hit & (key_prec(cur) == PREC_SUSPECT) & (
        key_inc(cur) == susp_inc
    )
    down_key = make_key(susp_inc, PREC_DOWN)
    # at most one down-declaration per member per tick
    fire_col = _first_true(still)
    fire = still.any(dim=1)
    fired_subj = susp_subj.gather(1, fire_col[:, None])[:, 0]
    fired_key = down_key.gather(1, fire_col[:, None])[:, 0]
    own_upd_subj[:, 1] = torch.where(fire, fired_subj, n)
    own_upd_key[:, 1] = torch.where(fire, fired_key, 0)
    slot_ids = torch.arange(params.susp_slots, device=dev)
    clear = (slot_ids[None, :] == fire_col[:, None]) & fire[:, None]
    clear = clear | (sdl_hit & ~still)  # refuted timers just clear
    susp_subj = torch.where(clear, n, susp_subj)
    susp_conf = torch.where(clear, 0, susp_conf)

    # ---- 3. gossip send --------------------------------------------------
    m, f = params.piggyback, params.fanout
    if params.gossip_mode == "shift":
        shift_off = jr.randint(jr.fold_in(r_gossip, 65537), (f,), 1, n, dev)
        tg = (idx32[:, None] + shift_off[None, :]) % n  # [N, f]
    else:
        tg = torch.stack(
            [
                _pick_known_alive(view, idx, jr.fold_in(r_gossip, j), params, 2)
                for j in range(f)
            ],
            dim=1,
        )
    send_subj = buf_subj[:, :m]
    send_key = buf_key[:, :m]
    sendable = (send_subj < n) & (buf_sent[:, :m] < params.max_transmissions)
    valid_tgt = tg < n
    nt = (valid_tgt & alive[:, None]).sum(dim=1, dtype=i32)
    buf_sent = buf_sent.clone()
    buf_sent[:, :m] = torch.where(
        sendable & (nt[:, None] > 0), buf_sent[:, :m] + nt[:, None],
        buf_sent[:, :m],
    )

    # anti-entropy tail: a few random entries of the sender's own view
    ae = params.antientropy
    if ae > 0:
        ae_subj = jr.randint(jr.fold_in(r_gossip, 7919), (n, ae), 0, n, dev)
        ae_key = view.gather(1, ae_subj.long()).to(i32)
        send_subj = torch.cat([send_subj, ae_subj], dim=1)
        send_key = torch.cat([send_key, ae_key], dim=1)
        sendable = torch.cat([sendable, ae_key > 0], dim=1)
        m = m + ae

    tg_safe = torch.clamp(tg, 0, n - 1).long()
    msg_ok = (
        sendable[:, None, :]
        & valid_tgt[:, :, None]
        & alive[:, None, None]
        & alive[tg_safe][:, :, None]
        & (part[tg_safe] == part[:, None])[:, :, None]
    )
    drop = jr.uniform(r_loss, msg_ok.shape, dev) < torch.clamp(
        deg_loss, min=loss
    )[:, None, None]
    ev_emitted = _bsum(msg_ok)
    ev_lost = _bsum(msg_ok & drop)
    msg_ok = msg_ok & ~drop

    # ---- 4. inbox: bounded per-member inboxes ----------------------------
    subj_gm = send_subj[:, None, :].expand(msg_ok.shape)
    key_gm = send_key[:, None, :].expand(msg_ok.shape)
    if params.gossip_mode == "shift":
        # receiver r's slot-j packet comes from sender (r - off_j) mod n:
        # an exact row gather, then a stable row compaction to the cap
        src = ((idx32[:, None] - shift_off[None, :]) % n).long()
        sub_m = torch.where(msg_ok, subj_gm, n)
        key_m = torch.where(msg_ok, key_gm, 0)
        jj = torch.arange(f, device=dev)[None, :]
        in_subj = sub_m[src, jj].reshape(n, f * m)
        in_key = key_m[src, jj].reshape(n, f * m)
        if f * m > params.incoming_slots:
            order = torch.argsort((in_subj == n).to(torch.uint8), dim=1,
                                  stable=True)
            take = order[:, : params.incoming_slots]
            in_subj = in_subj.gather(1, take)
            in_key = in_key.gather(1, take)
    else:
        in_subj, in_key = dispatch_inbox(
            params.inbox_impl,
            n,
            params.incoming_slots,
            tg_safe.reshape(-1).to(i32),
            subj_gm.reshape(-1, m),
            key_gm.reshape(-1, m),
            msg_ok.reshape(-1, m),
        )
    ev_delivered = _bsum(in_subj < n)

    # ---- 4b. announce/feed exchange (view updated in place) -------------
    fe = min(params.feed_entries, n)
    nfeeds = params.feeds_per_tick
    steps_per_sweep = -(-n // fe) if fe > 0 else 1
    ev_feed = torch.zeros((), dtype=i32, device=dev)
    ev_seed = torch.zeros((), dtype=i32, device=dev)
    if fe > 0 and nfeeds > 0:
        spacing = max(1, steps_per_sweep // nfeeds)
        for k in range(nfeeds):
            r_feed = jr.fold_in(r_gossip, 104729 + k)
            partner = _pick_known_alive(view, idx, r_feed, params, 2)
            psafe = torch.clamp(partner, 0, n - 1).long()
            has_partner = (
                (partner < n) & alive & alive[psafe] & (part[psafe] == part)
            )
            _window_pull_(view, t + k * spacing, fe, steps_per_sweep, psafe,
                          has_partner)
            ev_feed = ev_feed + _bsum(has_partner)

    # ---- 4c. bootstrap-seed exchange (view updated in place) ------------
    if fe > 0:
        seed_off = 1 + torch.div(
            t, max(1, params.announce_period), rounding_mode="floor") % 3
        sp = (idx + seed_off) % n
        seed_ok = alive & alive[sp] & (part[sp] == part)
        _window_pull_(view, t, fe, steps_per_sweep, sp, seed_ok)
        ev_seed = _bsum(seed_ok)

    # ---- 5. refutation ---------------------------------------------------
    about_self = (in_subj == idx32[:, None]) & (
        key_prec(in_key) >= PREC_SUSPECT
    )
    worst_msg = torch.where(about_self, key_inc(in_key), -1).amax(dim=1)
    selfk = torch.diagonal(view).to(i32)
    worst_diag = torch.where(
        key_prec(selfk) >= PREC_SUSPECT, key_inc(selfk), -1
    )
    worst = torch.maximum(worst_msg, worst_diag)
    if lifeguard:
        # LHA-Refute buddy system: a prober holding a suspect entry about
        # its new target tells the target in the ping
        tkey = view[idx, tsafe].to(i32)
        tell = (
            will & alive & alive[tsafe] & (part[tsafe] == part)
            & (leg_u[:, 0] >= d_loss)
            & (key_prec(tkey) == PREC_SUSPECT)
        )
        buddy = torch.full((n + 1,), -1, dtype=i32, device=dev)
        buddy.scatter_reduce_(
            0,
            torch.where(tell, tsafe, n),
            torch.where(tell, torch.clamp(key_inc(tkey), min=0), -1),
            reduce="amax",
        )
        worst = torch.maximum(worst, buddy[:n])
    refute = alive & (worst >= 0) & (worst >= inc)
    inc = torch.where(refute, torch.clamp(worst + 1, max=INC_CAP), inc)
    own_upd_subj[:, 2] = torch.where(refute, idx32, n)
    own_upd_key[:, 2] = torch.where(refute, make_key(inc, PREC_ALIVE), 0)

    # ---- 5b. periodic self-announce ---------------------------------------
    ev_announce = torch.zeros((), dtype=i32, device=dev)
    if params.announce_period > 0:
        due = ((t + idx32) % params.announce_period == 0) & alive
        own_upd_subj[:, 3] = torch.where(due, idx32, n)
        own_upd_key[:, 3] = torch.where(due, make_key(inc, PREC_ALIVE), 0)
        ev_announce = _bsum(due)

    # ---- 5c. Lifeguard bookkeeping ----------------------------------------
    ev_conf = torch.zeros((), dtype=i32, device=dev)
    if lifeguard:
        open_t = susp_subj < n
        conf_msg = (
            (in_subj[:, None, :] == susp_subj[:, :, None])
            & (key_prec(in_key) == PREC_SUSPECT)[:, None, :]
            & (key_inc(in_key)[:, None, :] >= susp_inc[:, :, None])
        )
        conf_add = conf_msg.sum(dim=2, dtype=i32) * open_t
        ev_conf = conf_add.sum(dtype=i32)
        susp_conf = torch.clamp(susp_conf + conf_add, max=params.susp_k)
        shrink = _susp_shrink_table(params, dev)
        susp_deadline = torch.where(
            open_t,
            susp_start + shrink[torch.clamp(susp_conf, 0, params.susp_k).long()],
            susp_deadline,
        )
        succ = (expire1 & ~fail1) | (expire2 & ~fail2)
        dec = succ & (torch.remainder(t, params.lhm_decay_ticks) == 0)
        lhm = torch.clamp(
            lhm + fail1.to(i32) + fail2.to(i32) + refute.to(i32)
            - dec.to(i32),
            0,
            params.lhm_max,
        )

    # ---- 6. row-aligned view update (in place) + relay --------------------
    all_subj = torch.cat([in_subj, own_upd_subj], dim=1)
    all_key = torch.cat([in_key, own_upd_key], dim=1)
    safe = torch.clamp(all_subj, 0, n - 1).long()
    eff_key16 = to_view_key(torch.where(all_subj < n, all_key, 0))
    # improvement judged on the stored (clamped) key
    prev = view.gather(1, safe)
    improved = eff_key16 > prev
    _row_scatter_max_(view, safe, eff_key16, prev)
    diag = torch.diagonal(view)
    diag.copy_(torch.maximum(
        diag, to_view_key(torch.where(alive, make_key(inc, PREC_ALIVE), 0))))

    relay_ok = improved & (all_subj != idx32[:, None]) & (all_subj < n)
    bin_subj = torch.cat([torch.where(relay_ok, all_subj, n), own_upd_subj],
                         dim=1)
    bin_key = torch.cat([torch.where(relay_ok, all_key, 0), own_upd_key],
                        dim=1)
    buf_subj, buf_key, buf_sent = _buffer_merge(
        params, buf_subj, buf_key, buf_sent, bin_subj, bin_key
    )

    # telemetry lane: exact counts of masks the tick already holds
    ev_suspect_fp = _bsum(fail2 & (psubj < n) & alive[psafe_t])
    fired_safe = torch.clamp(fired_subj, 0, n - 1).long()
    ev_down_fp = _bsum(fire & (fired_subj < n) & alive[fired_safe])
    ev_delta = _event_vector(
        gossip_emitted=ev_emitted,
        gossip_lost=ev_lost,
        inbox_delivered=ev_delivered,
        inbox_overflowed=ev_emitted - ev_lost - ev_delivered,
        merge_won=_bsum(improved),
        feed_pulls=ev_feed,
        seed_pulls=ev_seed,
        suspect_raised=_bsum(fail2),
        down_declared=_bsum(fire),
        refuted=_bsum(refute),
        self_announced=ev_announce,
        suspicion_confirmations=ev_conf,
        suspect_fp=ev_suspect_fp,
        down_fp=ev_down_fp,
    )
    events = state.events + ev_delta  # int32: wraps mod 2^32

    ring = state.ring
    if params.ring_ticks > 0:
        ring = _ring_write(
            ring, t, params.ring_ticks,
            torch.cat([
                ev_delta,
                _census_frame(n, alive, susp_subj, inc, in_subj, lhm),
            ]),
        )

    return SwimState(
        t=t + 1,
        alive=alive,
        inc=inc,
        view=view,
        buf_subj=buf_subj,
        buf_key=buf_key,
        buf_sent=buf_sent,
        probe_phase=phase,
        probe_subj=psubj,
        probe_deadline=pdl,
        probe_ok=pok,
        susp_subj=susp_subj,
        susp_inc=susp_inc,
        susp_deadline=susp_deadline,
        partition=part,
        events=events,
        ring=ring,
        lhm=lhm,
        susp_conf=susp_conf,
        susp_start=susp_start,
        deg_loss=deg_loss,
        deg_lag=deg_lag,
    )


def tick_n(state: SwimState, key: jr.Key, params: SwimParams,
           k: int) -> SwimState:
    """Advance `k` protocol periods with the reference's key chain
    (`split(key, k)`, one subkey per tick). No host sync."""
    for sub in jr.split(key, k):
        state = tick_impl(state, sub, params)
    return state


# ---------------------------------------------------------------------------
# churn, partition and fault injection


def set_alive(state: SwimState, member: int, value: bool) -> SwimState:
    """Crash or (re)start a member; a restart renews its incarnation."""
    alive = state.alive.clone()
    alive[member] = bool(value)
    inc = state.inc
    if value:
        inc = inc.clone()
        inc[member] += 1
        inc = torch.clamp(inc, max=INC_CAP)
    return state._replace(alive=alive, inc=inc)


def set_partition(state: SwimState, groups) -> SwimState:
    """Members in different groups exchange no traffic; zeros heal."""
    return state._replace(partition=torch.as_tensor(
        np.asarray(groups), dtype=torch.int32, device=state.alive.device))


def set_degraded(state: SwimState, members, loss: float = 0.0,
                 lag: int = 0) -> SwimState:
    """Mark `members` flaky without killing them: outbound loss `loss`
    and failure-detector lag `lag` ticks. loss=0, lag=0 restores."""
    idx = torch.as_tensor(np.asarray(members, dtype=np.int64),
                          device=state.alive.device)
    deg_loss = state.deg_loss.clone()
    deg_lag = state.deg_lag.clone()
    deg_loss[idx] = float(np.float32(loss))
    deg_lag[idx] = int(lag)
    return state._replace(deg_loss=deg_loss, deg_lag=deg_lag)


# ---------------------------------------------------------------------------
# stats

_STATS_BLOCK = 512  # the reference's [B, N] row blocks


def _stats_sums(view, alive):
    """(cov_num, det_num, fp_num, n_alive) as float32 device scalars,
    streamed over [512, N] row blocks like the reference. Each block's
    three totals are exact integer counts; they are added into float32
    accumulators block by block, in the reference's order."""
    n = view.shape[0]
    b = min(n, _STATS_BLOCK)
    nblocks = (n + b - 1) // b
    dev = view.device
    acc = torch.zeros(3, dtype=torch.float32, device=dev)
    alive_row = alive[None, :]
    for i in range(nblocks):
        start = min(i * b, n - b)
        rows = view[start: start + b]
        prec = key_prec(rows)
        known = key_known(rows)
        row_ka = (known & (prec == PREC_ALIVE) & alive_row).sum(dim=1)
        row_td = (known & (prec == PREC_DOWN) & ~alive_row).sum(dim=1)
        row_fp = (known & (prec >= PREC_SUSPECT) & alive_row).sum(dim=1)
        rg = torch.arange(start, start + b, device=dev)
        w = alive[start: start + b] & (rg >= i * b)  # fresh live observers
        block = torch.stack([row_ka, row_td, row_fp]) * w
        acc = acc + block.sum(dim=1).to(torch.float32)
    n_alive = alive.sum().to(torch.float32)
    return acc[0] - n_alive, acc[1], acc[2], n_alive


def _stats_impl(view, alive) -> torch.Tensor:
    """[3] float32: coverage, detected, false_positive."""
    n = view.shape[0]
    cov_num, det_num, fp_num, n_alive = _stats_sums(view, alive)
    n_alive_pairs = torch.clamp(n_alive * (n_alive - 1.0), min=1.0)
    n_dead_pairs = torch.clamp(n_alive * (n - n_alive), min=1.0)
    return torch.stack([cov_num / n_alive_pairs, det_num / n_dead_pairs,
                        fp_num / n_alive_pairs])


def _coverage_impl(view, alive) -> torch.Tensor:
    num, _, _, n_alive = _stats_sums(view, alive)
    return num / torch.clamp(n_alive * (n_alive - 1.0), min=1.0)


def run_to_coverage(state: SwimState, key: jr.Key, params: SwimParams,
                    target: float, check_every: int, max_ticks: int):
    """Tick in `check_every`-tick chunks until live-member coverage
    reaches `target`; returns (state, coverage as np.float32).

    The reference's device while_loop becomes a host loop that reads one
    coverage scalar per chunk and nothing per tick. It keeps the
    reference's key chain, its float32 predicate and its budget rule:
    only whole chunks with t + check_every <= max_ticks run, so a state
    already at the limit runs no tick."""
    t = int(state.t)
    tgt = np.float32(target)
    cov = np.float32(-1.0)
    while cov < tgt and t + check_every <= max_ticks:
        key, sub = jr.split(key)
        state = tick_n(state, sub, params, check_every)
        t += check_every
        cov = np.float32(_coverage_impl(state.view, state.alive).item())
    return state, cov


def _readback(state: SwimState, head: torch.Tensor):
    """`head` (int32), the event totals, t and the ring in ONE
    device-to-host copy: (head, uint32 events, FlightDrain)."""
    k = head.shape[0]
    packed = torch.cat([
        head, state.events, state.t.reshape(1), state.ring.reshape(-1),
    ]).cpu().numpy()
    ev = packed[k: k + N_EVENTS].astype(np.uint32)
    ring = packed[k + N_EVENTS + 1:].reshape(tuple(state.ring.shape))
    return packed[:k], ev, FlightDrain(ring=ring, t=int(packed[k + N_EVENTS]))


def events_and_flight(state: SwimState):
    """([N_EVENTS] uint32 event totals, FlightDrain) in one readback."""
    _, ev, flight = _readback(state, state.events[:0])
    return ev, flight


def stats_and_events(state: SwimState):
    """(stats dict, [N_EVENTS] uint32 event totals, FlightDrain) in ONE
    device-to-host copy."""
    vals = _stats_impl(state.view, state.alive).view(torch.int32)
    vals, ev, flight = _readback(state, vals)
    vals = vals.view(np.float32)
    stats = {
        "coverage": float(vals[0]),
        "detected": float(vals[1]),
        "false_positive": float(vals[2]),
    }
    return stats, ev, flight


def membership_stats(state: SwimState) -> dict:
    """Convergence metrics over live observers (coverage, detected,
    false_positive), in one device-to-host copy."""
    return stats_and_events(state)[0]

