"""The port's dense phase profile (`corrosion_tpu_torch.profile_swim`)
against the phase jits of the JAX package's `scripts/profile_swim.py`.

At n=256 on the CPU, each phase the port times (its `ph_*` functions
and the `ops/swim.py` functions it times directly) gives exactly the
outputs of the reference's phase computation (copied below from the
script's `main`, whose closures cannot be imported) on the same
numpy-seeded inputs and the same state: the pick, the flat inbox, the
grouped inbox through every implementation (the port's "cuda" against
the JAX "gsort", which the reference pins bit-equal to its "pallas"), the
view update with its improved mask, one feed exchange, the buffer merge
and the stats. The table run on the CPU has every row of the script's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrosion_tpu.ops import swim as J
from corrosion_tpu_torch import profile_swim as ps
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim as T

N = 256
FEEDS = 4


@pytest.fixture(scope="module")
def setup():
    params = T.SwimParams(n=N, feeds_per_tick=FEEDS)
    jparams = J.SwimParams(n=N, feeds_per_tick=FEEDS)
    state = ps.profiled_state(params, "cpu")
    jstate = J.tick(J.init_state(jparams, jax.random.PRNGKey(0)),
                    jax.random.PRNGKey(1), jparams)
    np.testing.assert_array_equal(state.view.numpy(), np.asarray(jstate.view))
    x = ps.phase_inputs(params, 2, "cpu")
    jx = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    return params, jparams, state, jstate, x, jx


_jax_gsort = jax.jit(lambda *a: J.dispatch_inbox("gsort", *a),
                     static_argnums=(0, 1))


def _eq(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick(setup):
    params, jparams, state, jstate, _, _ = setup
    idx = jnp.arange(N, dtype=jnp.int32)
    ref = jax.jit(lambda v, k: J._pick_known_alive(v, idx, k, jparams, 4))
    for s in range(3):
        _eq(ps.ph_pick(state.view, jr.PRNGKey(s), params),
            ref(jstate.view, jax.random.PRNGKey(s)))


def test_flat_inbox(setup):
    params, _, _, _, x, jx = setup
    slots = params.incoming_slots

    @jax.jit
    def ref(dst, subj, key):  # scripts/profile_swim.py's ph_inbox
        dst_s, subj_s, key_s = jax.lax.sort(
            (dst, subj, key), dimension=0, num_keys=1, is_stable=True
        )
        pos = jnp.arange(dst_s.shape[0], dtype=jnp.int32)
        is_start = jnp.concatenate(
            [jnp.ones((1,), bool), dst_s[1:] != dst_s[:-1]]
        )
        first = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_start, pos, 0)
        )
        rank = pos - first
        ok = (dst_s < N) & (rank < slots)
        rows_ = jnp.where(ok, dst_s, 0)
        cols_ = jnp.where(ok, rank, 0)
        in_subj = jnp.full((N, slots), N, dtype=jnp.int32)
        in_key = jnp.zeros((N, slots), dtype=jnp.int32)
        in_subj = in_subj.at[rows_, cols_].min(jnp.where(ok, subj_s, N))
        in_key = in_key.at[rows_, cols_].max(jnp.where(ok, key_s, 0))
        return in_subj, in_key

    _eq(T.build_inbox(N, slots, x["dst"], x["subj"], x["key"]),
        ref(jx["dst"], jx["subj"], jx["key"]))


@pytest.mark.parametrize("impl", ps.IMPLS)
def test_grouped_inbox(setup, impl):
    params, _, _, _, x, jx = setup
    slots = params.incoming_slots
    want = _jax_gsort(N, slots, jx["gdst"], jx["gsubj"], jx["gkey"],
                      jx["gok"])
    _eq(T.dispatch_inbox(impl, N, slots, x["gdst"], x["gsubj"], x["gkey"],
                         x["gok"]), want)


def test_viewupd_feed_bufmrg_and_stats(setup):
    params, jparams, state, jstate, x, jx = setup
    slots = params.incoming_slots
    idx = jnp.arange(N, dtype=jnp.int32)
    in_subj, in_key = T.build_inbox(N, slots, x["dst"], x["subj"], x["key"])
    j_in_subj, j_in_key = jnp.asarray(in_subj.numpy()), jnp.asarray(
        in_key.numpy())

    @jax.jit
    def ref_viewupd(view, in_subj, in_key):
        safe = jnp.clip(in_subj, 0, N - 1)
        eff = J.to_view_key(jnp.where(in_subj < N, in_key, 0))
        prev = view[idx[:, None], safe]
        improved = eff > prev
        return view.at[idx[:, None], safe].max(eff), improved

    # the port updates in place: give it its own copy of the view
    view = state.view.clone()
    _eq(ps.ph_viewupd(view, in_subj, in_key),
        ref_viewupd(jstate.view, j_in_subj, j_in_key))

    fe = min(params.feed_entries, N)

    @jax.jit
    def ref_feed(view, key):
        partner = J._pick_known_alive(view, idx, key, jparams, 2)
        psafe = jnp.clip(partner, 0, N - 1)
        w = jnp.int32(0)
        vw = jax.lax.dynamic_slice(view, (jnp.int32(0), w), (N, fe))
        pulled = jnp.take(vw, psafe, axis=0)
        return jax.lax.dynamic_update_slice(
            view, jnp.maximum(vw, pulled), (jnp.int32(0), w)
        )

    view = state.view.clone()
    _eq(ps.ph_feed(view, jr.PRNGKey(9), params, fe),
        ref_feed(jstate.view, jax.random.PRNGKey(9)))
    assert not np.array_equal(view.numpy(), state.view.numpy())

    _eq(T._buffer_merge(params, state.buf_subj, state.buf_key,
                        state.buf_sent, x["bin_subj"], x["bin_key"]),
        jax.jit(J._buffer_merge, static_argnums=0)(
            jparams, jstate.buf_subj, jstate.buf_key, jstate.buf_sent,
            jx["bin_subj"], jx["bin_key"]))

    want = J.membership_stats(jstate)
    assert T.membership_stats(state) == want  # n=256: exact sums


def test_cpu_table_has_every_row():
    rows = ps.table(N, FEEDS, device="cpu", iters=1)
    names = [r["phase"] for r in rows]
    m = T.SwimParams(n=N).piggyback + T.SwimParams(n=N).antientropy
    assert names == [
        "tick(1)", "tick_n(50)/50", "pick x1", f"inbox M={N * 2 * m}",
        *(f"inbox[{i}] G={N * 2}" for i in ps.IMPLS),
        *(f"tick(1)[{i}]" for i in ps.IMPLS),
        "viewupd [N,16]", "feed x1", f"feed x{FEEDS} (extrap)", "bufmrg",
        "stats",
    ]
    for r in rows:
        assert 0 <= r["min_ms"] <= r["ms"] <= r["max_ms"] and r["calls"] == 1
    feed, extrap = rows[-4], rows[-3]
    assert extrap["ms"] == pytest.approx(feed["ms"] * FEEDS)
