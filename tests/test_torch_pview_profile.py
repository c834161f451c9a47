"""The port's pview phase profile (`corrosion_tpu_torch.pview_profile`)
against `scripts/pview_profile.py` and the JAX package.

- the table and the memory ladder run at a toy size on the CPU: the
  script's rows (plus the Hopper kernel's `inbox[cuda]` row, which takes
  the plain version here), published as phase gauges, and the ladder's
  rows in both tick modes with the memory columns read n/a;
- the row names are the script's, formatted at the same shape;
- every phase computes what the script's phase jit computes on the same
  inputs: the profiled state (one tick from `init_state`), the pick, the
  lookup, both inbox builds, the feed pull, the merge chain and the
  buffer merge equal the JAX package's, bit for bit;
- the CLI writes its text only to `--out`.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import swim as JS
from corrosion_tpu.ops import swim_pview as J
from corrosion_tpu_torch import convert
from corrosion_tpu_torch import pview_converge as pc
from corrosion_tpu_torch import pview_profile as pp
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim as TS
from corrosion_tpu_torch.ops import swim_pview as T
from corrosion_tpu_torch.runtime.metrics import METRICS

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "pview_profile.py"
N, K, FEEDS = 256, 64, 2


def _rows(n, k, feeds):
    """The script's row names at (n, K, feeds), with the kernel's row."""
    p = pc.pview_params(n, k, feeds=feeds)
    f, m = p.fanout, p.piggyback + p.antientropy
    wtot = (feeds + 1) * p.feed_entries
    return ([f"tick(1)[{tm},{gm}]" for tm, gm in pp.TICK_COMBOS]
            + ["tick_n(5)/5 [fused,shift]", "pick x1", "lookup [N,4]",
               f"inbox[shift] f*m={f * m}", f"inbox[gsort] G={n * f}",
               f"inbox[cuda] G={n * f}", "feedpull x1",
               f"merge scatter [N,{wtot}]", "bufmrg", "stats"])


def test_row_names_are_the_scripts():
    src = SCRIPT.read_text()
    for template in ('f"tick(1)[{tm},{gm}]"',
                     'f"tick_n({chunk})/{chunk} [fused,shift]"',
                     '"pick x1"', '"lookup [N,4]"',
                     'f"inbox[shift] f*m={f * m}"',
                     'f"inbox[gsort] G={n * f}"', '"feedpull x1"',
                     'f"merge scatter [N,{wtot}]"', '"bufmrg"', '"stats"'):
        assert template in src, template
    assert re.search(r"for tm, gm in \(\(\"fused\", \"shift\"\), "
                     r"\(\"fused\", \"pick\"\),\s+\(\"r5\", \"shift\"\), "
                     r"\(\"r5\", \"pick\"\)\)", src)
    assert "it = 20 if n <= 25_000 else 6" in src
    assert "feed_entries=fe" in src and "fe = max(16, k // 16)" in src


def test_table_and_ladder_run_on_the_cpu():
    rec = pp.run(N, K, FEEDS, shapes=[(N, K), (2 * N, K)], iters=1,
                 device="cpu", log=lambda s: None)
    assert [r["phase"] for r in rec["rows"]] == _rows(N, K, FEEDS)
    assert all(r["ms"] > 0 and r["calls"] == 1 for r in rec["rows"])
    gauges = {labels["phase"] for kind, name, labels, _ in METRICS.snapshot()
              if name == "corro.kernel.phase.seconds"
              and labels["kernel"] == "pview"}
    assert set(_rows(N, K, FEEDS)) <= gauges
    assert [(r["n"], r["tick_mode"]) for r in rec["ladder"]] == [
        (N, "fused"), (N, "r5"), (2 * N, "fused"), (2 * N, "r5")]
    for r in rec["ladder"]:
        assert r["table_gb"] == r["n"] * K * 4 / 2**30
        assert r["tick_peak_gb"] is r["stats_peak_gb"] is r["live_gb"] is None
    ladder = [ln for ln in rec["text"].split("# peak device memory")[1]
              .splitlines()[2:] if ln]
    assert len(ladder) == 4 and all(ln.count("n/a") == 5 for ln in ladder)
    assert rec["platform"] == "cpu" and rec["device_kind"] is None


def _jnp(x):
    return jnp.asarray(x.numpy())


def test_phases_match_jax():
    params = pc.pview_params(N, K, feeds=FEEDS)
    jp = J.PViewParams(**{**params._asdict(), "inbox_impl": "gsort"})
    jstate = J.init_state(jp, jax.random.PRNGKey(0), seed_mode="fingers")
    jstate = J.tick(jstate, jax.random.PRNGKey(1), jp)
    state = pp.profiled_state(params, "cpu")
    for f in T.PViewState._fields:
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)
    packed, jpacked = state.slot_packed, jstate.slot_packed
    idx = torch.arange(N)
    jidx = jnp.arange(N, dtype=jnp.int32)
    mask = T._mask(params, idx, 0)
    key = jr.fold_in(jr.PRNGKey(0), 1_000)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 1_000)
    assert convert.key_from_numpy(np.asarray(jkey)) == key
    x = pp.phase_inputs(params, 2, "cpu")

    def eq(got, want):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # each reference phase jitted whole, as the script's phase jits are
    pick = jax.jit(lambda pk, k, tries: J._pick_known_alive(
        jp, pk, jidx, k, tries, 0), static_argnums=2)
    eq(T._pick_known_alive(params, packed, mask, key, 4),
       pick(jpacked, jkey, 4))
    eq(T._lookup(params, packed, mask, x["subjs"]),
       jax.jit(lambda pk, s: J._lookup(jp, pk, s, 0))(
           jpacked, _jnp(x["subjs"])))

    f, m = jp.fanout, jp.piggyback + jp.antientropy

    @jax.jit
    def inbox_shift(subj_gm, key_gm, ok_gm, off):
        # scripts/pview_profile.py's ph_inbox_shift body
        sub_m = jnp.where(ok_gm, subj_gm, N)
        key_m = jnp.where(ok_gm, key_gm, 0)
        src = (jidx[:, None] - off[None, :]) % N
        jj = jnp.arange(f, dtype=jnp.int32)[None, :]
        in_subj = sub_m[src, jj].reshape(N, f * m)
        in_key = key_m[src, jj].reshape(N, f * m)
        order = jnp.argsort(in_subj == N, axis=1, stable=True)[:, :16]
        return (jnp.take_along_axis(in_subj, order, axis=1),
                jnp.take_along_axis(in_key, order, axis=1))

    eq(pp.ph_inbox_shift(params, x["subj_gm"], x["key_gm"], x["ok_gm"],
                         x["off"]),
       inbox_shift(*(_jnp(x[k]) for k in ("subj_gm", "key_gm", "ok_gm",
                                          "off"))))

    grouped = (x["gdst"], x["subj_gm"].reshape(-1, m),
               x["key_gm"].reshape(-1, m), x["ok_gm"].reshape(-1, m))
    want = jax.jit(lambda *a: JS.dispatch_inbox("gsort", N, 16, *a))(
        *(_jnp(a) for a in grouped))
    for impl in ("gsort", "cuda"):
        eq(TS.dispatch_inbox(impl, N, 16, *grouped), want)

    # the feed pull's gather side (ph_feedpull), then the merge chain
    fe = jp.feed_entries
    eq(pp.ph_feedpull(params, packed, mask, key),
       jnp.take(jpacked[:, :fe], jnp.clip(pick(jpacked, jkey, 2), 0, N - 1),
                axis=0))

    @jax.jit
    def merge(jm, mvals, mcols):
        for w0 in range(0, mvals.shape[1], fe):
            jm = jm.at[jidx[:, None], mcols[:, w0:w0 + fe]].max(
                mvals[:, w0:w0 + fe])
        return jm

    eq(pp.ph_merge(packed.clone(), x["mvals"], x["mcols"], fe),
       merge(jpacked, _jnp(x["mvals"]), _jnp(x["mcols"])))

    eq(TS._buffer_merge(params, state.buf_subj, state.buf_key.to(torch.int32),
                        state.buf_sent.to(torch.int32), x["bin_subj"],
                        x["bin_key"]),
       jax.jit(lambda *a: JS._buffer_merge(jp, *a))(
           jstate.buf_subj, jstate.buf_key.astype(jnp.int32),
           jstate.buf_sent.astype(jnp.int32), _jnp(x["bin_subj"]),
           _jnp(x["bin_key"])))


def test_cli_writes_only_with_out(tmp_path, monkeypatch, capsys):
    calls = []

    def fake_run(*args, **kw):
        calls.append((args, kw))
        return {"text": "a table\n", "rows": [], "ladder": []}

    monkeypatch.setattr(pp, "run", fake_run)
    pp.main([])
    assert calls[-1][0] == (100_000, 2048, 8, None, True, None)
    assert not list(tmp_path.iterdir())
    out = tmp_path / "profile.txt"
    pp.main(["4096", "256", "4", "--shapes", "4096x256,8192x256",
             "--iters", "2", "--out", str(out)])
    assert calls[-1][0] == (4096, 256, 4, [(4096, 256), (8192, 256)], True,
                            2)
    assert out.read_text() == "a table\n"
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["rows"] == []


@pytest.mark.parametrize("fn", [pp.table, pp.memory_ladder, pp.run])
def test_profile_defaults_to_the_card(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ([(N, K)],) if fn is pp.memory_ladder else (N, K)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(*args)
