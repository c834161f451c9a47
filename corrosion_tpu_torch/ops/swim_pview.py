"""Bounded partial-view SWIM on PyTorch: the counterpart of
`corrosion_tpu/ops/swim_pview.py`.

The dense tick (`ops/swim.py`) keeps an [N, N] int16 view, which passes
the card's memory near n = 200,000. This kernel keeps instead a bounded
per-member hash-slot table:

    slot_packed [N, K] int32   packed = (subj ^ mask) * KEYCAP + key,
                               0 = empty (see `_mask`, `_pack`)

Subject s lives in slot h(s) = (s * 2654435761 mod 2^32) mod K of every
row. The packed word orders by (masked subject, key), and keys grow with
information, so every merge (gossip delivery, feed pull, own update) is
one row-aligned scatter-max, and hash collisions resolve as eviction.
With `identity_hash=True` and K = n the table is the dense view and the
tick is the dense tick (tests/test_torch_pview.py pins it). See the
reference's module docstring for the design.

Each tick is bit-equal to the reference's from the same key
(tests/test_torch_pview.py). PyTorch idiom as in `ops/swim.py`: plain
functions, an explicit device, no jit, the tick index a 0-d device
tensor, and the slot table updated IN PLACE (a tick returns a state
whose `slot_packed` is the input's tensor).

Two traps of the translation, handled where they arise:

- uint32 arithmetic: `_hash` and `_mask` multiply uint32 values mod
  2^32. torch's uint32 is partial and an int64 product of two 32-bit
  values leaves the signed range, so `_mul32` splits each constant into
  16-bit halves; no product exceeds 2^49.
- read before write: the table is mutated in place by
  `scatter_reduce_`, so every value the tick reads from it (lookups,
  picks, anti-entropy lanes, feed pulls, the relay's `prev`) is a
  gathered copy taken before the first scatter that must not see it.
  In "fused" mode all of them read the tick-start table; in "r5" mode
  the feeds merge in turn and later phases read the merged table, as in
  the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops.swim import (  # noqa: F401 (re-exported)
    INC_CAP,
    INT32_MAX,
    N_EVENTS,
    N_FLIGHT_LANES,
    PREC_ALIVE,
    PREC_DOWN,
    PREC_SUSPECT,
    _SENT_CLAMP,
    _argmax_first,
    _bsum,
    _buffer_merge,
    _census_frame,
    _event_vector,
    _first_true,
    _readback,
    _ring_write,
    _susp_shrink_table,
    dispatch_inbox,
    finger_offsets,
    key_inc,
    key_known,
    key_prec,
    make_key,
    set_alive,
    set_degraded,
    set_partition,
)
from corrosion_tpu_torch.runtime.device import resolve_device

_M32 = 0xFFFFFFFF
_HASH_MULT = 2654435761  # Knuth's multiplicative constant

SLOT_DTYPE = torch.int32  # packed words need 31 bits
LANE_DTYPE = torch.int16  # at-rest dtype of buf_key, buf_sent, susp_inc


class PViewParams(NamedTuple):
    """Static parameters: the reference's fields and defaults (see
    `corrosion_tpu/ops/swim_pview.py::PViewParams` for each one's
    meaning). `inbox_impl` takes "sort", "gsort" or "cuda"."""

    n: int
    slots: int = 1024
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
    antientropy: int = 4
    feed_entries: int = 25
    feeds_per_tick: int = 4
    announce_period: int = 4
    tie_epoch: int = 48
    loss: float = 0.0
    identity_hash: bool = False
    inbox_impl: str = "gsort"
    feed_mode: str = "seq"
    tick_mode: str = "fused"
    gossip_mode: str = "shift"
    ring_ticks: int = 128
    lhm_max: int = 0
    lhm_decay_ticks: int = 8
    susp_ceiling: int = 3
    susp_k: int = 3


def _pow2(n: int) -> int:
    """Smallest power of two >= n: the packed tie-field domain."""
    return 1 << (n - 1).bit_length()


def _keycap(n: int) -> int:
    """Key-field capacity of the packed word (a power of two)."""
    return 2**31 // _pow2(n)


def inc_cap(n: int) -> int:
    """Largest incarnation representable in the packed word for n."""
    return (_keycap(n) - 7) // 4


# ---------------------------------------------------------------------------
# uint32 arithmetic in int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int tensor's values as uint32 bit patterns, held in int64."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c:
    c splits into 16-bit halves, so no product exceeds 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash(params: PViewParams, subj: torch.Tensor) -> torch.Tensor:
    """Slot column of each subject (int32 in, int32 out)."""
    if params.identity_hash:
        if params.slots < params.n:
            raise ValueError("identity_hash requires slots >= n")
        return subj
    k = params.slots
    if k <= 2**15 and k & (k - 1) == 0:
        # K divides 2^32, so the low bits of the product depend only on
        # the low bits of its operands: exact in int32, no int64 temp
        return ((subj & (k - 1)) * (_HASH_MULT & (k - 1))) & (k - 1)
    return (_mul32(_u32(subj), _HASH_MULT) % k).to(torch.int32)


def _mask(params: PViewParams, rows: torch.Tensor, t) -> torch.Tensor:
    """Per-(observer, epoch) XOR mask of the packed word's tie-break
    field, int32 in [0, _pow2(n)) (see the reference's `_mask` for why
    this construction). The tick computes it once per row, as an [N]
    tensor, and broadcasts it."""
    epoch = torch.as_tensor(t, device=rows.device) // max(1, params.tie_epoch)
    mixed = _fmix32(_mul32(_u32(rows), 2246822519)
                    ^ _mul32(_u32(epoch), 2654435761))
    return (mixed & (_pow2(params.n) - 1)).to(torch.int32)


def _pack(params: PViewParams, subj, key, mask) -> torch.Tensor:
    """packed = (subj ^ mask) * KEYCAP + key (int32)."""
    return (subj ^ mask) * _keycap(params.n) + key


def _unpack(params: PViewParams, packed, mask):
    """(subj, key) of packed words (KEYCAP is a power of two: a shift and
    a mask are the reference's floor division and modulus)."""
    kc = _keycap(params.n)
    return (packed >> (kc.bit_length() - 1)) ^ mask, packed & (kc - 1)


# ---------------------------------------------------------------------------
# state


class PViewState(NamedTuple):
    t: torch.Tensor  # () int32
    alive: torch.Tensor  # [N] bool ground-truth liveness
    inc: torch.Tensor  # [N] int32 own incarnation
    slot_packed: torch.Tensor  # [N, K] int32 packed words, 0 = empty
    buf_subj: torch.Tensor  # [N, B] int32 (N = empty)
    buf_key: torch.Tensor  # [N, B] int16
    buf_sent: torch.Tensor  # [N, B] int16, empty slots hold _SENT_CLAMP
    probe_phase: torch.Tensor  # [N] int32
    probe_subj: torch.Tensor  # [N] int32
    probe_deadline: torch.Tensor  # [N] int32
    probe_ok: torch.Tensor  # [N] bool
    susp_subj: torch.Tensor  # [N, S] int32 (N = empty)
    susp_inc: torch.Tensor  # [N, S] int16
    susp_deadline: torch.Tensor  # [N, S] int32
    partition: torch.Tensor  # [N] int32
    events: torch.Tensor  # [N_EVENTS] int32 cumulative, wraps mod 2^32
    ring: torch.Tensor  # [ring_ticks, N_FLIGHT_LANES] int32 flight ring
    lhm: torch.Tensor  # [N] int32
    susp_conf: torch.Tensor  # [N, S] int32
    susp_start: torch.Tensor  # [N, S] int32
    deg_loss: torch.Tensor  # [N] float32
    deg_lag: torch.Tensor  # [N] int32


def init_state(
    params: PViewParams,
    key: jr.Key,
    seeds_per_member: int = 3,
    seed_mode: str = "ring",
    device=None,
) -> PViewState:
    """Freshly booted cluster on `device` (the card unless "cpu" is asked
    for): every member knows itself plus its bootstrap seeds, "ring" (the
    next k members) or "fingers" (power-of-two offsets). `key` is unused,
    as in the reference.

    The reference builds the table from blocked [B, F, K] one-hots, a
    workaround for its compiler; the cells are those of a scatter-max,
    which is what this does, in one `scatter_reduce_`."""
    del key
    dev = resolve_device(device)
    n, k, b, s = params.n, params.slots, params.buffer_slots, params.susp_slots
    i32 = torch.int32
    idx = torch.arange(n, dtype=i32, device=dev)
    alive_key = make_key(0, PREC_ALIVE)
    if seed_mode == "ring":
        offs = torch.arange(1, seeds_per_member + 1, dtype=i32, device=dev)
    elif seed_mode == "fingers":
        offs = finger_offsets(n, dev)
    else:
        raise ValueError(f"unknown seed_mode {seed_mode!r}")
    offs = torch.cat([torch.zeros(1, dtype=i32, device=dev), offs])
    peers = (idx[:, None] + offs[None, :]) % n  # [N, F+1]: self + seeds
    vals = _pack(params, peers, alive_key, _mask(params, idx, 0)[:, None])
    packed = torch.zeros((n, k), dtype=SLOT_DTYPE, device=dev)
    packed.scatter_reduce_(1, _hash(params, peers).long(), vals, "amax")

    buf_subj = torch.full((n, b), n, dtype=i32, device=dev)
    buf_key = torch.zeros((n, b), dtype=LANE_DTYPE, device=dev)
    buf_sent = torch.full((n, b), _SENT_CLAMP, dtype=LANE_DTYPE, device=dev)
    buf_subj[:, 0] = idx
    buf_key[:, 0] = alive_key
    buf_sent[:, 0] = 0

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PViewState(
        t=zeros(),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        inc=zeros(n),
        slot_packed=packed,
        buf_subj=buf_subj,
        buf_key=buf_key,
        buf_sent=buf_sent,
        probe_phase=zeros(n),
        probe_subj=torch.full((n,), n, dtype=i32, device=dev),
        probe_deadline=zeros(n),
        probe_ok=zeros(n, dtype=torch.bool),
        susp_subj=torch.full((n, s), n, dtype=i32, device=dev),
        susp_inc=zeros(n, s, dtype=LANE_DTYPE),
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
# table reads (each returns a copy, never a view of the table)


def _pick_known_alive(params: PViewParams, packed, mask, key: jr.Key,
                      tries: int) -> torch.Tensor:
    """Per member, an alive subject sampled from its own row (n if none):
    `tries` random slot columns relative to itself, then two small ring
    offsets. `mask` is the rows' [N] tie-break masks. Both draws use the
    same key, so one pair of bit planes serves both (see
    `ops/swim.py::_pick_known_alive`)."""
    n, k = params.n, params.slots
    rows = packed.shape[0]
    dev = packed.device
    hi, lo = jr.randint_planes(key, rows * max(tries, 2), dev)
    offs = jr.randint_from_planes(hi[: rows * tries], lo[: rows * tries], 1, k)
    ring = jr.randint_from_planes(hi[: rows * 2], lo[: rows * 2], 1, 4)
    offs = torch.cat([offs.reshape(rows, tries), ring.reshape(rows, 2)], dim=1)
    self_idx = torch.arange(rows, device=dev)
    cols = (self_idx[:, None] + offs) % k
    subj, keys = _unpack(params, packed.gather(1, cols), mask[:, None])
    ok = key_known(keys) & (key_prec(keys) == PREC_ALIVE) & (
        subj != self_idx[:, None]
    )
    pick = subj.gather(1, _first_true(ok)[:, None])[:, 0]
    return torch.where(ok.any(dim=1), pick, n)


def _lookup(params: PViewParams, packed, mask, subjs) -> torch.Tensor:
    """Believed key of `subjs` ([N] or [N, S]) in each row; 0 if absent."""
    squeeze = subjs.dim() == 1
    if squeeze:
        subjs = subjs[:, None]
    safe = torch.clamp(subjs, 0, params.n - 1)
    cur = packed.gather(1, _hash(params, safe).long())
    cs, ck = _unpack(params, cur, mask[:, None])
    out = torch.where((cs == safe) & (subjs < params.n), ck, 0)
    return out[:, 0] if squeeze else out


def _scatter_max_(packed, cols, vals) -> None:
    """packed[i, cols[i, j]] = max(packed[i, cols[i, j]], vals[i, j]) IN
    PLACE. Hash collisions put several updates in one cell; max does not
    depend on their order, so the result is exact."""
    packed.scatter_reduce_(1, cols.long(), vals, "amax")


# ---------------------------------------------------------------------------
# the tick


# the device code that one CUDA graph per tick would capture: the
# analyzer's kernel-purity rule lists every host sync in these functions
# and the module functions they reach
DEVICE_ROOTS = ("tick_impl", "_stats_impl")

def tick_impl(state: PViewState, key: jr.Key,
              params: PViewParams) -> PViewState:
    """One SWIM protocol period for every member, phase for phase the
    reference's `tick_impl` (both `tick_mode`s, both `gossip_mode`s, both
    `feed_mode`s). `state.slot_packed` is updated IN PLACE and carried
    into the returned state."""
    if params.tick_mode not in ("fused", "r5"):
        raise ValueError(f"unknown tick_mode: {params.tick_mode!r}")
    if params.gossip_mode not in ("shift", "pick"):
        raise ValueError(f"unknown gossip_mode: {params.gossip_mode!r}")
    fused = params.tick_mode == "fused"
    n, k = params.n, params.slots
    packed = state.slot_packed
    dev = packed.device
    i32 = torch.int32
    idx = torch.arange(n, device=dev)
    idx32 = idx.to(i32)
    t = state.t
    r_probe, r_ack, r_helpers, r_gossip, r_loss = jr.split(key, 5)
    loss = float(np.float32(params.loss))  # compared in float32, as in JAX
    m_t = _mask(params, idx, t)  # every row's mask at this tick
    m_row = m_t[:, None]

    inc = state.inc
    alive = state.alive
    part = state.partition
    # the int16 at-rest lanes widen for the tick's arithmetic
    buf_subj = state.buf_subj
    buf_key = state.buf_key.to(i32)
    buf_sent = state.buf_sent.to(i32)
    susp_subj = state.susp_subj
    susp_inc = state.susp_inc.to(i32)
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

    expire2 = (phase == 2) & (t >= pdl) & alive
    fail2 = expire2 & ~pok
    binc = torch.clamp(key_inc(_lookup(params, packed, m_t, psubj)), min=0)
    own_upd_subj[:, 0] = torch.where(fail2, psubj, n)
    own_upd_key[:, 0] = torch.where(fail2, make_key(binc, PREC_SUSPECT), 0)
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
        pdl = torch.where(expire2, t + mult - 1, pdl)

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

    start = (phase == 0) & alive
    if lifeguard:
        start = start & (t >= pdl)
    target = _pick_known_alive(params, packed, m_t, r_probe,
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
    cur = _lookup(params, packed, m_t, susp_subj)
    still = sdl_hit & (key_prec(cur) == PREC_SUSPECT) & (
        key_inc(cur) == susp_inc
    )
    down_key = make_key(susp_inc, PREC_DOWN)
    fire_col = _first_true(still)
    fire = still.any(dim=1)
    fired_subj = susp_subj.gather(1, fire_col[:, None])[:, 0]
    fired_key = down_key.gather(1, fire_col[:, None])[:, 0]
    own_upd_subj[:, 1] = torch.where(fire, fired_subj, n)
    own_upd_key[:, 1] = torch.where(fire, fired_key, 0)
    slot_ids = torch.arange(params.susp_slots, device=dev)
    clear = (slot_ids[None, :] == fire_col[:, None]) & fire[:, None]
    clear = clear | (sdl_hit & ~still)
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
                _pick_known_alive(params, packed, m_t,
                                  jr.fold_in(r_gossip, j), 2)
                for j in range(f)
            ],
            dim=1,
        )
    send_subj = buf_subj[:, :m]
    send_key = buf_key[:, :m]
    sendable = (send_subj < n) & (buf_sent[:, :m] < params.max_transmissions)
    valid_tgt = tg < n
    nt = (valid_tgt & alive[:, None]).sum(dim=1, dtype=i32)
    buf_sent = torch.cat([
        torch.where(sendable & (nt[:, None] > 0),
                    buf_sent[:, :m] + nt[:, None], buf_sent[:, :m]),
        buf_sent[:, m:],
    ], dim=1)

    ae = params.antientropy
    if ae > 0:
        ae_cols = jr.randint(jr.fold_in(r_gossip, 7919), (n, ae), 0, k, dev)
        ae_subj, ae_key = _unpack(params, packed.gather(1, ae_cols.long()),
                                  m_row)
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

    # ---- 4. delivery: bounded per-member inboxes -------------------------
    subj_gm = send_subj[:, None, :].expand(msg_ok.shape)
    key_gm = send_key[:, None, :].expand(msg_ok.shape)
    if params.gossip_mode == "shift":
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

    # ---- 4b. feed exchange over slot space -------------------------------
    fe = min(params.feed_entries, k)
    nfeeds = params.feeds_per_tick
    steps = -(-k // fe) if fe > 0 else 1
    spacing = max(1, steps // nfeeds) if nfeeds > 0 else 1
    win = torch.arange(max(fe, 0), device=dev)

    def window_pull(pk, t_off, src, ok):
        """Window min((t_off % steps) * fe, k - fe) of row src[i], or
        zeros where not ok: a gathered [N, fe] copy."""
        w = torch.clamp(torch.remainder(t_off, steps) * fe, max=k - fe)
        pulled = pk[src[:, None], (w.long() + win)[None, :]]
        return torch.where(ok[:, None], pulled, 0)

    def feed_pull(pk, fk):
        """One feed: (pulled window, partner masks, exchange count)."""
        partner = _pick_known_alive(params, pk, m_t,
                                    jr.fold_in(r_gossip, 104729 + fk), 2)
        psafe = torch.clamp(partner, 0, n - 1).long()
        has = (partner < n) & alive & alive[psafe] & (part[psafe] == part)
        pulled = window_pull(pk, t + fk * spacing, psafe, has)
        return pulled, m_t[psafe], _bsum(has)

    def seed_pull(pk):
        """Bootstrap-seed window pull (see the reference's 4c)."""
        seed_off = 1 + torch.div(
            t, max(1, params.announce_period), rounding_mode="floor") % 3
        sp = (idx + seed_off) % n
        seed_ok = alive & alive[sp] & (part[sp] == part)
        return window_pull(pk, t, sp, seed_ok), m_t[sp], _bsum(seed_ok)

    def feed_updates(pulled, pmask):
        """(hash columns, values re-encoded into the receiver's mask) of
        one pulled window: the scatter-max operands."""
        p_subj, p_key = _unpack(params, pulled, pmask[:, None])
        vals = torch.where(pulled > 0, _pack(params, p_subj, p_key, m_row), 0)
        cols = _hash(params, p_subj)
        if params.identity_hash:
            # an empty cell decodes to a subject in [n, pow2(n)), out of
            # the table: the reference's scatter drops it, torch's would
            # fault, so its zero update goes to column 0 instead
            cols = torch.where(pulled > 0, cols, 0)
        return cols, vals

    ev_feed = torch.zeros((), dtype=i32, device=dev)
    ev_seed = torch.zeros((), dtype=i32, device=dev)
    feed_ups = []  # fused: the windows merge after every read (step 6)
    if fused:
        if fe > 0 and nfeeds > 0:
            for fk in range(nfeeds):
                pulled, pmask, c = feed_pull(packed, fk)
                ev_feed = ev_feed + c
                feed_ups.append(feed_updates(pulled, pmask))
        if fe > 0:
            pulled, pmask, ev_seed = seed_pull(packed)
            feed_ups.append(feed_updates(pulled, pmask))
    elif fe > 0:
        if nfeeds > 0:
            if params.feed_mode not in ("seq", "batched"):
                raise ValueError(f"unknown feed_mode: {params.feed_mode!r}")
            if params.feed_mode == "batched":
                # every partner pick and pull reads the pre-feed table
                pulls = [feed_pull(packed, fk) for fk in range(nfeeds)]
                for pulled, pmask, c in pulls:
                    ev_feed = ev_feed + c
                for pulled, pmask, _ in pulls:
                    _scatter_max_(packed, *feed_updates(pulled, pmask))
            else:
                for fk in range(nfeeds):
                    pulled, pmask, c = feed_pull(packed, fk)
                    ev_feed = ev_feed + c
                    _scatter_max_(packed, *feed_updates(pulled, pmask))
        pulled, pmask, ev_seed = seed_pull(packed)
        _scatter_max_(packed, *feed_updates(pulled, pmask))

    # ---- 5. refutation (inbox + own slot) --------------------------------
    about_self = (in_subj == idx32[:, None]) & (
        key_prec(in_key) >= PREC_SUSPECT
    )
    worst_msg = torch.where(about_self, key_inc(in_key), -1).amax(dim=1)
    selfk = _lookup(params, packed, m_t, idx32)
    worst_diag = torch.where(
        key_prec(selfk) >= PREC_SUSPECT, key_inc(selfk), -1
    )
    worst = torch.maximum(worst_msg, worst_diag)
    if lifeguard:
        tkey = _lookup(params, packed, m_t, target)
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
    # the packed word needs key * pow2(n) < 2^31 (inc_cap) and the packed
    # buffer merge keys < 2^15 (INC_CAP): both bounds bind
    cap = min(inc_cap(n), INC_CAP)
    inc = torch.where(refute, torch.clamp(worst + 1, max=cap), inc)
    own_upd_subj[:, 2] = torch.where(refute, idx32, n)
    own_upd_key[:, 2] = torch.where(refute, make_key(inc, PREC_ALIVE), 0)

    # ---- 5b. periodic self-announce --------------------------------------
    ev_announce = torch.zeros((), dtype=i32, device=dev)
    if params.announce_period > 0:
        due = ((t + idx32) % params.announce_period == 0) & alive
        own_upd_subj[:, 3] = torch.where(due, idx32, n)
        own_upd_key[:, 3] = torch.where(due, make_key(inc, PREC_ALIVE), 0)
        ev_announce = _bsum(due)

    # ---- 5c. Lifeguard bookkeeping ---------------------------------------
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

    # ---- 6. row-aligned slot update + relay ------------------------------
    all_subj = torch.cat([in_subj, own_upd_subj], dim=1)
    all_key = torch.cat([in_key, own_upd_key], dim=1)
    safe = torch.clamp(all_subj, 0, n - 1)
    new_packed = torch.where(
        all_subj < n, _pack(params, safe, all_key, m_row), 0
    )
    cols = _hash(params, safe)
    prev = packed.gather(1, cols.long())  # the last read before the merge
    improved = new_packed > prev
    # the merge chain: fused mode's feed windows, then inbox and own
    # updates, then the own entry pinned (written, not maxed) for live
    # members; dead rows keep their cell
    for fcols, vals in feed_ups:
        _scatter_max_(packed, fcols, vals)
    _scatter_max_(packed, cols, new_packed)
    self_col = _hash(params, idx32).long()[:, None]
    pin = _pack(params, idx32, make_key(inc, PREC_ALIVE), m_t)
    packed.scatter_(1, self_col, torch.where(
        alive, pin, packed.gather(1, self_col)[:, 0])[:, None])

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
        ring = _ring_write(ring, t, params.ring_ticks, torch.cat([
            ev_delta, _census_frame(n, alive, susp_subj, inc, in_subj, lhm),
        ]))

    relay_ok = improved & (all_subj != idx32[:, None]) & (all_subj < n)
    bin_subj = torch.cat([torch.where(relay_ok, all_subj, n), own_upd_subj],
                         dim=1)
    bin_key = torch.cat([torch.where(relay_ok, all_key, 0), own_upd_key],
                        dim=1)

    # re-encode the tie-break field for the next tick, in place and in
    # int32: (subj ^ m_t) ^ (m_t ^ m_t1) = subj ^ m_t1, so every occupied
    # word XORs its row's mask change into the subject field
    delta = (m_t ^ _mask(params, idx, t + 1)) * _keycap(n)
    packed ^= torch.where(packed > 0, delta[:, None], 0)

    buf_subj, buf_key, buf_sent = _buffer_merge(
        params, buf_subj, buf_key, buf_sent, bin_subj, bin_key
    )

    return PViewState(
        t=t + 1,
        alive=alive,
        inc=inc,
        slot_packed=packed,
        buf_subj=buf_subj,
        # narrow the at-rest lanes: keys < 2^15, sent <= _SENT_CLAMP,
        # incarnations <= INC_CAP
        buf_key=buf_key.to(LANE_DTYPE),
        buf_sent=torch.clamp(buf_sent, max=_SENT_CLAMP).to(LANE_DTYPE),
        probe_phase=phase,
        probe_subj=psubj,
        probe_deadline=pdl,
        probe_ok=pok,
        susp_subj=susp_subj,
        susp_inc=susp_inc.to(LANE_DTYPE),
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


def tick_n(state: PViewState, key: jr.Key, params: PViewParams,
           k: int) -> PViewState:
    """Advance `k` protocol periods with the reference's key chain
    (`split(key, k)`, one subkey per tick). No host sync."""
    for sub in jr.split(key, k):
        state = tick_impl(state, sub, params)
    return state


# ---------------------------------------------------------------------------
# churn injection (set_alive, set_partition and set_degraded are the dense
# kernel's: they touch only lanes both states share)


def set_alive_many(state: PViewState, members, value: bool) -> PViewState:
    """Crash or restart many members at once; a restart renews each one's
    incarnation (once per listing, as the reference's `.at[].add`)."""
    idx = torch.as_tensor(np.asarray(members, dtype=np.int64),
                          device=state.alive.device)
    alive = state.alive.clone()
    alive[idx] = bool(value)
    inc = state.inc
    if value:
        inc = torch.clamp(inc.clone().index_add_(
            0, idx, torch.ones_like(idx, dtype=inc.dtype)), max=INC_CAP)
    return state._replace(alive=alive, inc=inc)


# ---------------------------------------------------------------------------
# stats

_STATS_BLOCK_ROWS = 4096  # the reference's [B, K] row blocks


def _stats_impl(params: PViewParams, packed, alive, t) -> torch.Tensor:
    """[6] float32: pv_coverage, mean_in_degree, min_in_degree, occupancy,
    false_positive, detected (see `membership_stats`), streamed over
    [4096, K] row blocks like the reference. In-degrees count as int32;
    each block's three totals are exact integer counts added into float32
    accumulators block by block, in the reference's order."""
    n, k = params.n, params.slots
    dev = packed.device
    f32 = torch.float32
    af = alive.to(f32)
    n_alive = torch.clamp(af.sum(), min=1.0)
    b = min(n, _STATS_BLOCK_ROWS)
    nblocks = (n + b - 1) // b
    masks = _mask(params, torch.arange(n, device=dev), t)
    # entries that count nothing land in k spare bins past the n subjects
    # (one per column), so no single bin takes every atomic add
    spare = n + torch.arange(k, device=dev)[None, :]
    indeg = torch.zeros(n + k, dtype=torch.int32, device=dev)
    stale = torch.zeros(n + k, dtype=torch.int32, device=dev)
    acc = torch.zeros(3, dtype=f32, device=dev)  # total, fp, occupied
    for i in range(nblocks):
        start = min(i * b, n - b)
        rows = torch.arange(start, start + b, device=dev)[:, None]
        subj, key = _unpack(params, packed[start: start + b],
                            masks[start: start + b, None])
        occupied = key > 0
        prec = key_prec(key)
        # a clamped last block leaves rows an earlier block counted
        live_obs = (alive[start: start + b] & (rows[:, 0] >= i * b))[:, None]
        subj_alive = alive[torch.clamp(subj, 0, n - 1).long()]
        held = occupied & live_obs
        ka = held & (prec == PREC_ALIVE) & (subj != rows)
        indeg.index_add_(0, torch.where(ka, subj, spare).reshape(-1),
                         ka.to(torch.int32).reshape(-1))
        stale_e = held & (prec == PREC_ALIVE) & ~subj_alive
        stale.index_add_(0, torch.where(stale_e, subj, spare).reshape(-1),
                         stale_e.to(torch.int32).reshape(-1))
        acc = acc + torch.stack([
            (ka & subj_alive).sum(),
            (held & (prec >= PREC_SUSPECT) & subj_alive).sum(),
            held.sum(),
        ]).to(f32)
    indeg, stale = indeg[:n], stale[:n]
    expected = acc[0] / n_alive  # mean in-degree over live subjects
    min_in = torch.where(alive, indeg, INT32_MAX).min()
    pv_cov = (alive & (indeg.to(f32) >= expected * 0.5)).sum().to(f32) / n_alive
    fp = acc[1] / torch.clamp(af.sum() * (n_alive - 1), min=1.0)
    occ = acc[2] / (n_alive * k)
    n_dead = (~alive).sum()
    detected = torch.where(
        n_dead > 0,
        ((~alive) & (stale == 0)).sum().to(f32)
        / torch.clamp(n_dead, min=1).to(f32),
        torch.ones((), dtype=f32, device=dev),
    )
    return torch.stack([pv_cov, expected, min_in.to(f32), occ, fp, detected])


def saturation_floor(n: int, slots: int) -> float:
    """85% of the expected distinct-subject load of a K-slot row with
    n - 1 candidates: the mean-in-degree term of the convergence bar."""
    return 0.85 * min(
        n - 1, slots * (1.0 - (1.0 - 1.0 / slots) ** (n - 1))
    )


def _converged(vals: np.ndarray, params: PViewParams, cov_target: float,
               quorum: int) -> bool:
    """The four-term bar on a stats row, compared in float32 as the
    reference's device predicate compares."""
    sat = np.float32(saturation_floor(params.n, params.slots))
    return bool(
        vals[0] >= np.float32(cov_target)
        and vals[2] >= np.float32(quorum)
        and vals[1] >= sat
        and vals[4] == 0.0
    )


def run_to_converged(state: PViewState, key: jr.Key, params: PViewParams,
                     cov_target: float, quorum: int, check_every: int,
                     max_ticks: int):
    """Tick in `check_every`-tick chunks until the four-term bar holds:
    pv_coverage >= cov_target, min_in_degree >= quorum, mean_in_degree >=
    the saturation floor, false_positive == 0. Returns (state, the last
    [6] float32 stats row as numpy, all -1 if no chunk ran).

    The reference's device while_loop becomes a host loop with one
    6-value readback per chunk and nothing per tick. It keeps the
    reference's key chain and budget rule: only whole chunks with
    t + check_every <= max_ticks run."""
    t = int(state.t)
    vals = np.full(6, -1.0, dtype=np.float32)
    while (not _converged(vals, params, cov_target, quorum)
           and t + check_every <= max_ticks):
        key, sub = jr.split(key)
        state = tick_n(state, sub, params, check_every)
        t += check_every
        vals = _stats_impl(params, state.slot_packed, state.alive,
                           state.t).cpu().numpy()
    return state, vals


def stats_and_events(state: PViewState, params: PViewParams):
    """(stats dict, [N_EVENTS] uint32 event totals, FlightDrain) in ONE
    device-to-host copy."""
    vals = _stats_impl(params, state.slot_packed, state.alive,
                       state.t).view(torch.int32)
    vals, ev, flight = _readback(state, vals)
    vals = vals.view(np.float32)
    names = ("pv_coverage", "mean_in_degree", "min_in_degree", "occupancy",
             "false_positive", "detected")
    return dict(zip(names, map(float, vals))), ev, flight


def membership_stats(state: PViewState, params: PViewParams) -> dict:
    """Partial-view stability metrics. pv_coverage: fraction of live
    members whose in-degree (live observers holding them alive) is at
    least half the mean. mean_in_degree: that mean. min_in_degree: the
    worst-known live member. occupancy: live members' slot-fill fraction.
    false_positive: live subject entries marked suspect/down, per live
    observer pair. detected: dead members no live observer holds alive."""
    return stats_and_events(state, params)[0]


def memory_gb(n: int, slots: int) -> dict:
    """Memory of a state of `n` members x `slots` slots on one card, in
    GiB: the int32 slot table, and the gossip/FSM lanes (one int32
    subject and two int16 lanes per buffer slot, ~10 int32 fields per
    member), and their total."""
    table_gb = n * slots * 4 / 2**30
    bufs_gb = n * (16 * (4 + 2 * 2) + 10 * 4) / 2**30
    return {
        "slot_table_gb": round(table_gb, 2),
        "buffers_fsm_gb": round(bufs_gb, 2),
        "total_gb": round(table_gb + bufs_gb, 2),
    }
