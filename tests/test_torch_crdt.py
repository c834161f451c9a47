"""The port's CRDT merge engine against the JAX package's.

Every comparison is exact (integers and bools): the port's
`value_digest`, event lane, segmented lex-max scan, decision program
(`_merge_kernel`, all ten outputs) and host wrapper (`merge_table_array`:
win masks, plans, local state, declines) equal the reference's on the
same inputs; the JAX store routed through the port's wrapper leaves the
same database as its Python engine; the bench's batches are the
reference script's; and `chip_smoke.CRDT_REF` is the JAX engine's
decision on the bench's chained batches.

    JAX_PLATFORMS=cpu python -m tests.test_torch_crdt

prints `CRDT_REF` for every size of the schedule (about a minute).
"""

import copy
import importlib.util
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrosion_tpu.ops.crdt_merge as jcm
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.types.base import Timestamp
from corrosion_tpu.types.change import Change
from corrosion_tpu.types.pack import pack_columns
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch.convert import crdt_inputs_to_torch
from corrosion_tpu_torch.ops import crdt_merge as tcm
from corrosion_tpu_torch.runtime import metrics as tmetrics
from corrosion_tpu_torch.runtime.records import FLIGHT
from tests.test_crdt_batch import (
    SITES,
    apply_reference,
    dump_state,
    mk_store,
    random_changes,
    random_rich_changes,
)

ROOT = Path(__file__).resolve().parent.parent

# tests/test_crdt_array.py's digest pool, then the exactness boundaries
DIGEST_VALUES = [
    None, 0, 1, -1, 2**40, -(2**40), 0.5, -0.5, 1.0, 3.14,
    "", "a", "ab", "abc", "zz", "abc\x00", "abcdefghijklm",
    b"", b"\x00", b"\xff", b"abc", bytearray(b"zz"),
    "x" * 13, "x" * 14, 2**53, 2**53 + 1, -(2**53), -(2**53) - 1,
    "y" * 20, "y" * 30, "abcd", True, False, -0.0, float("inf"),
    memoryview(b"mv"), b"\x00" * 14, "é" * 7,
]


def test_value_digest_matches_reference():
    for v in DIGEST_VALUES:
        assert tcm.value_digest(v) == jcm.value_digest(v), v


def test_crdt_event_lane_matches_reference():
    assert tmetrics.CRDT_MERGE_EVENTS == jmetrics.CRDT_MERGE_EVENTS
    assert (tmetrics.EVENTS_BY_KERNEL["crdt_merge"]
            == jmetrics.EVENTS_BY_KERNEL["crdt_merge"])


# the reference function itself, compiled once rather than dispatched op
# by op (about 10 s on one core)
_jax_lexmax = jax.jit(jcm._seg_exclusive_lexmax, static_argnums=(2, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_exclusive_lexmax_matches_reference(seed):
    """Few distinct keys, so ties are common, with payload bits that
    differ between tied elements: the earliest element's must win."""
    rng = np.random.default_rng(seed)
    n = 300
    keys = [rng.integers(-1, 3, n).astype(np.int32) for _ in range(6)]
    payload = [rng.integers(0, 2, n).astype(np.int32) for _ in range(2)]
    seg = rng.random(n) < 0.1
    neg = (-1,) * 6 + (1, 0)
    for n_key, comps, nv in ((6, keys + payload, neg), (1, keys[:1], (-1,))):
        want = _jax_lexmax(tuple(jnp.asarray(k) for k in comps),
                           jnp.asarray(seg), nv, n_key)
        got = tcm._seg_exclusive_lexmax(
            tuple(torch.from_numpy(k) for k in comps), torch.from_numpy(seg),
            nv, n_key)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the tie case itself: equal keys, the later one's payload differs
    k = np.array([5, 5, 5], np.int32)
    p = np.array([1, 0, 0], np.int32)
    start = np.array([True, False, False])
    got = tcm._seg_exclusive_lexmax(
        (torch.from_numpy(k), torch.from_numpy(p)), torch.from_numpy(start),
        (-1, 1), 1)
    assert got[1].tolist() == [1, 1, 1]


def _jax_outputs(arrays):
    out = jcm._merge_kernel(**arrays)
    return [np.asarray(o) for o in out]


def _assert_outputs_equal(got, want):
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


@pytest.mark.parametrize("rows,seed", [(64, 0), (64, 1), (1024, 2),
                                       (1024, 3)])
def test_merge_kernel_matches_reference(rows, seed):
    arrays = cb.scale_inputs(rows, seed)
    got = tcm._merge_kernel(**crdt_inputs_to_torch(arrays, "cpu"))
    _assert_outputs_equal(got, _jax_outputs(arrays))
    # and through the one readback
    _assert_outputs_equal(tcm.read_decisions(got), _jax_outputs(arrays))


def _ch(pk_row, cid, val, cl, cv, dbv, site=0, ts=1):
    return Change(table="kv", pk=pack_columns([pk_row]), cid=cid, val=val,
                  col_version=cv, db_version=dbv, seq=0,
                  site_id=SITES[site].bytes16, cl=cl,
                  ts=Timestamp.from_unix(ts))


def _local_state(rng, chs):
    """Local state for every pk of `chs`: a random cl, clock entries for
    some cids, and prefetched values for most of those."""
    st = {}
    for ch in chs:
        if ch.pk in st:
            continue
        clock = {}
        disk = {}
        for cid in ("a", "b", "v"):
            if rng.random() < 0.5:
                clock[cid] = rng.randint(1, 4)
                if rng.random() < 0.8:
                    disk[cid] = rng.choice(["x", "zz", 3, None, "y" * 20])
        st[ch.pk] = {"cl": rng.choice([0, 1, 2, 3]), "clock": clock,
                     "vals": {}, "disk": disk if rng.random() < 0.9 else None}
    return st


def _wrapper_batches():
    rng = random.Random(77)
    out = [random_changes(rng, 80) for _ in range(3)]
    out += [random_rich_changes(rng, 80) for _ in range(3)]
    out += cb.rung_batches(512)[1][:1]
    out.append([_ch(1, "a", "y" * 20, 1, 2, 1), _ch(1, "a", "y" * 30, 1, 2,
                                                    2)])
    out.append([_ch(1, "b", 2**53, 1, 1, 1), _ch(1, "b", 2**53 + 1, 1, 1, 2)])
    return out


@pytest.mark.parametrize("i", range(9))
def test_wrapper_matches_reference(i):
    chs = _wrapper_batches()[i]
    # the bench's batch and the two digest ties run on a fresh state
    st0 = ({ch.pk: cb.fresh_state() for ch in chs} if i >= 6
           else _local_state(random.Random(i), chs))
    res = []
    for fn, kw in ((jcm.merge_table_array, {}),
                   (tcm.merge_table_array, {"device": "cpu"})):
        st = copy.deepcopy(st0)
        plans = ({}, set(), {}, {}, set(), set())
        wins = fn(None, "kv", chs, st, *plans, **kw)
        res.append((wins, st, plans))
    assert res[0] == res[1]
    if i >= 6:
        assert (res[0][0] is None) == (i >= 7)


def _port_engine(monkeypatch):
    """Route the JAX store's array engine through the port's wrapper on
    the CPU; returns the counts of decided and declined batches."""
    calls = {"decided": 0, "declined": 0}

    def port(*args):
        out = tcm.merge_table_array(*args, device="cpu")
        calls["decided" if out is not None else "declined"] += 1
        return out

    monkeypatch.setattr(jcm, "merge_table_array", port)
    return calls


def _engines_agree(monkeypatch, changes, split=None):
    monkeypatch.setenv("CORRO_CRDT_ENGINE", "array")
    a = mk_store()
    if split:
        for i in range(0, len(changes), split):
            a.apply_changes(changes[i:i + split])
        b = mk_store()
        apply_reference(b, changes)
    else:
        got_a = a.apply_changes(list(changes)).impactful
        monkeypatch.setenv("CORRO_CRDT_ENGINE", "python")
        b = mk_store()
        got_b = b.apply_changes(list(changes)).impactful
        assert got_a == got_b
    assert dump_state(a) == dump_state(b)
    a.close()
    b.close()


def _even_cl_cases():
    """tests/test_crdt_array.py's even-cl changes with a non-sentinel
    cid."""
    return [
        [_ch(1, "a", "ghost", 2, 3, 1)],
        [_ch(1, "a", "ghost", 2, 3, 1), _ch(1, "b", 7, 3, 1, 2, ts=2)],
        [_ch(1, "a", "x", 1, 1, 1), _ch(1, "b", "ghost", 2, 9, 2, ts=2),
         _ch(1, "a", "y", 3, 1, 3, ts=3)],
        [_ch(1, "-1", None, 2, 1, 1), _ch(1, "a", "ghost", 2, 5, 2, ts=2)],
    ]


STORE_CASES = {
    "randomized": lambda: [(random_changes(random.Random(3000 + s), 120),
                            None) for s in range(8)],
    "rich_values": lambda: [(random_rich_changes(random.Random(4000 + s),
                                                 150), None)
                            for s in range(6)],
    "split_batches": lambda: [(random_changes(random.Random(5151), 180),
                               13)],
    "even_cl_with_cid": lambda: [(c, None) for c in _even_cl_cases()],
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_through_port_matches_python_engine(monkeypatch, case):
    calls = _port_engine(monkeypatch)
    for changes, split in STORE_CASES[case]():
        _engines_agree(monkeypatch, changes, split)
    assert calls["decided"] > 0, calls


def _reference_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_crdt_merge", ROOT / "scripts" / "bench_crdt_merge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(ch):
    return (ch.table, ch.cid, ch.val, ch.col_version, ch.db_version, ch.seq,
            ch.site_id, ch.cl, ch.ts.ntp64)


def test_synth_batch_matches_reference():
    ref = _reference_bench()
    for seed, n in ((1234, 600), (5, 300)):
        got = cb.synth_batch(random.Random(seed), n, 64)
        want = ref.synth_batch(random.Random(seed), n, 64)
        assert [_fields(c) for c in got] == [_fields(c) for c in want]
        # pks are opaque: the same rows, so the same groups
        pairs = {(a.pk, b.pk) for a, b in zip(got, want)}
        assert len(pairs) == len({a for a, _ in pairs}) \
            == len({b for _, b in pairs})


def jax_rung_ref(size: int) -> list:
    """The JAX engine's decisions on the bench's rung of `size`, chained as
    `crdt_bench.run_rung` chains them, on the reference script's own
    batches: per batch (events, declined, outputs digest)."""
    ref = _reference_bench()
    rng = random.Random(cb.SEED)
    for s in cb.SIZES:
        ref.synth_batch(rng, min(s, 2048), cb.HOT_ROWS)
        batches = [ref.synth_batch(rng, s, cb.HOT_ROWS) for _ in range(3)]
        if s == size:
            break
    seen = []
    real = jcm._merge_kernel

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append([np.asarray(o) for o in out])
        return out

    st, out = {}, []
    jcm._merge_kernel = spy
    try:
        for batch in batches:
            for s in st.values():
                s["disk"] = dict(s["vals"])
            for ch in batch:
                st.setdefault(ch.pk, cb.fresh_state())
            plans = ({}, set(), {}, {}, set(), set())
            wins = jcm.merge_table_array(None, "kv", batch, st, *plans)
            outs = seen[-1]
            out.append((tuple(int(v) for v in outs[9]), wins is None,
                        cb.outputs_digest(outs)))
    finally:
        jcm._merge_kernel = real
    return out


@pytest.mark.parametrize("size", [512, 4096])
def test_chip_smoke_crdt_ref_is_the_jax_engines(size):
    import chip_smoke

    assert chip_smoke.CRDT_REF[size] == jax_rung_ref(size)
    got = cb.run_rung(size, "cpu")["batches"]
    assert [(tuple(r["events"]), r["declined"], r["digest"])
            for r in got] == chip_smoke.CRDT_REF[size]


@pytest.mark.parametrize("ambiguous", [False, True])
def test_telemetry_follows_the_reference_rule(ambiguous):
    """A decided batch publishes its four event counts; a declined one
    only its ambiguity count; each adds one host frame. The reference's
    registry moves the same way on the same batch."""
    chs = (_wrapper_batches()[7] if ambiguous
           else cb.rung_batches(512)[1][0])

    def run(mod, metrics, **kw):
        before = metrics.kernel_event_totals().get("crdt_merge", {})
        st = {ch.pk: cb.fresh_state() for ch in chs}
        plans = ({}, set(), {}, {}, set(), set())
        wins = mod.merge_table_array(None, "kv", chs, st, *plans, **kw)
        assert (wins is None) == ambiguous
        after = metrics.kernel_event_totals().get("crdt_merge", {})
        return {k: after.get(k, 0.0) - before.get(k, 0.0)
                for k in tmetrics.CRDT_MERGE_EVENTS}

    want_delta = run(jcm, jmetrics)
    frames = FLIGHT.window(1, kernel="crdt_merge")
    rec = {}
    assert run(tcm, tmetrics, device="cpu", record=rec) == want_delta
    ev = [int(v) for v in rec["outputs"][9]]
    want = dict(zip(tmetrics.CRDT_MERGE_EVENTS,
                    [0, 0, 0, ev[3]] if ambiguous else ev))
    assert want_delta == {k: float(v) for k, v in want.items()}
    assert (want["decide_ambiguous"] > 0) == ambiguous
    last = FLIGHT.window(1, kernel="crdt_merge")[-1]
    assert last["events"] == want
    assert last["tick"] == (frames[-1]["tick"] + 1 if frames else 0)


def test_merge_table_array_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chs = cb.rung_batches(512)[1][0][:10]
    st = {ch.pk: cb.fresh_state() for ch in chs}
    with pytest.raises(RuntimeError, match="CUDA"):
        tcm.merge_table_array(None, "kv", chs, st, {}, set(), {}, {}, set(),
                              set())
    with pytest.raises(RuntimeError, match="CUDA"):
        crdt_inputs_to_torch(cb.scale_inputs(64, 0), None)


if __name__ == "__main__":
    print("CRDT_REF = {")
    for s in cb.SIZES:
        print(f"    {s}: [")
        for row in jax_rung_ref(s):
            print(f"        {row!r},")
        print("    ],")
    print("}")
