"""The port's partial-view SWIM tick (`corrosion_tpu_torch.ops.swim_pview`)
against the JAX package's, bit for bit.

The same seeded inputs go through both: the hash, mask and pack helpers
on edge values; init_state in both seed modes; then 8 ticks at n=96,
K=32 per configuration (fused + shift; fused + pick with the gsort and
the cuda inbox builds; r5 + pick + sequential feeds; r5 + batched feeds;
Lifeguard with loss, a partition, a crash and degraded members), with
every state field equal after every tick. `tie_epoch=3` puts two
tie-break re-encodes inside each run. The JAX side runs pick mode with
its "gsort" build, which its own suite pins bit-equal to "pallas". Stats
are held to rtol 1e-6 (float32 sums, as in tests/test_stats_blocked.py).
The drivers (`PViewClusterSim`, `flaky_node_ab`) must return the JAX
package's results; the identity-hash table (K = n) must reproduce the
port's dense tick, as tests/test_swim_pview.py pins the reference.
"""

import functools

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import convert
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.models import cluster as tcluster
from corrosion_tpu_torch.ops import swim as TD
from corrosion_tpu_torch.ops import swim_pview as T

N, K, TICKS = 96, 32, 8
BASE = dict(feeds_per_tick=2, feed_entries=8, tie_epoch=3)
# the reference tick compiled without XLA's costly backend passes: the
# same program and the same integer and float32 results, in about half
# the compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}

CONFIGS = {
    # name: (jax overrides, port overrides, inject faults?)
    "fused-shift": (dict(), dict(), False),
    "fused-pick-gsort": (dict(gossip_mode="pick"),
                         dict(gossip_mode="pick", inbox_impl="gsort"), False),
    "fused-pick-cuda": (dict(gossip_mode="pick"),
                        dict(gossip_mode="pick", inbox_impl="cuda"), False),
    "r5-pick-seq": (dict(tick_mode="r5", gossip_mode="pick"),
                    dict(tick_mode="r5", gossip_mode="pick"), False),
    "r5-batched": (dict(tick_mode="r5", feed_mode="batched"),
                   dict(tick_mode="r5", feed_mode="batched"), False),
    "lifeguard-faults": (dict(lhm_max=4, loss=0.1),
                         dict(lhm_max=4, loss=0.1), True),
}
_REFS = {}  # (jax overrides, faults) -> (params, states after each tick)


@functools.lru_cache(maxsize=None)
def _ref():
    """(jax, jax.numpy, the reference's swim_pview, its models.cluster),
    imported on first use: the card-only test below runs where JAX is not
    installed (`pytest --noconftest -m cuda tests/test_torch_pview.py`)."""
    import jax
    import jax.numpy as jnp

    from corrosion_tpu.models import cluster
    from corrosion_tpu.ops import swim_pview

    return jax, jnp, swim_pview, cluster


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in T.PViewState._fields}


def _assert_state_equal(ref, got, what):
    for f in T.PViewState._fields:
        a, b = ref[f], getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: field {f}")


def _inject(state, mod):
    """Degraded members, a crash and a partition, through each package's
    own injectors."""
    state = mod.set_degraded(state, [1, 5, 9], 0.3, 2)
    state = mod.set_alive_many(state, [7, 11], False)
    state = mod.set_alive_many(state, [11], True)
    return mod.set_partition(state, (np.arange(N) % 3 == 0).astype(np.int32))


def _jax_run(cfg):
    jax, _, J = _ref()[:3]
    jkw, _, faults = CONFIGS[cfg]
    ref_key = (tuple(sorted(jkw.items())), faults)
    if ref_key not in _REFS:
        params = J.PViewParams(n=N, slots=K, **BASE, **jkw)
        rng = jax.random.PRNGKey(3)
        state = J.init_state(params, rng, seed_mode="fingers")
        if faults:
            state = _inject(state, J)
        tick = jax.jit(J.tick_impl, static_argnames="params").lower(
            state, rng, params=params).compile(compiler_options=_FAST_COMPILE)
        states = [_np_state(state)]
        for t in range(TICKS):
            state = tick(state, jax.random.fold_in(rng, t))
            states.append(_np_state(state))
        _REFS[ref_key] = (params, states)
    return _REFS[ref_key]


def _key(jkey):
    return convert.key_from_numpy(np.asarray(jkey))


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_tick_bit_equal(cfg):
    jax = _ref()[0]
    jparams, states = _jax_run(cfg)
    _, tkw, faults = CONFIGS[cfg]
    params = convert.pview_params_from_dict({**jparams._asdict(), **tkw})
    rng = jax.random.PRNGKey(3)
    state = T.init_state(params, _key(rng), seed_mode="fingers", device="cpu")
    if faults:
        state = _inject(state, T)
    _assert_state_equal(states[0], state, f"{cfg} init")
    for t in range(TICKS):
        state = T.tick_impl(state, _key(jax.random.fold_in(rng, t)), params)
        _assert_state_equal(states[t + 1], state, f"{cfg} tick {t}")


def test_state_carries_across_from_jax():
    """A JAX state mid-run, converted to the port, gives the JAX package's
    next tick; the port's state round-trips through numpy."""
    jax, _, J = _ref()[:3]
    jparams, states = _jax_run("fused-shift")
    params = convert.pview_params_from_dict(jparams._asdict())
    state = convert.pview_state_from_numpy(states[4], "cpu")
    key = _key(jax.random.fold_in(jax.random.PRNGKey(3), 4))
    _assert_state_equal(states[5], T.tick_impl(state, key, params), "carry")
    back = convert.pview_state_to_numpy(
        convert.pview_state_from_numpy(states[2], "cpu"))
    for f in T.PViewState._fields:
        np.testing.assert_array_equal(back[f], states[2][f])
    with pytest.raises(ValueError, match="fields differ"):
        convert.pview_state_from_numpy({"t": np.int32(0)}, "cpu")
    assert convert.pview_params_from_dict(J.PViewParams(
        n=8, inbox_impl="pallas")._asdict()).inbox_impl == "cuda"


@pytest.mark.parametrize("seed_mode,k", [("ring", 32), ("fingers", 32),
                                         ("fingers", 48)])
def test_init_state_equal(seed_mode, k):
    jax, _, J = _ref()[:3]
    jp = J.PViewParams(n=N, slots=k, tie_epoch=3)
    ref = _np_state(J.init_state(jp, jax.random.PRNGKey(1),
                                 seed_mode=seed_mode))
    got = T.init_state(convert.pview_params_from_dict(jp._asdict()), (0, 1),
                       seed_mode=seed_mode, device="cpu")
    _assert_state_equal(ref, got, f"init {seed_mode} K={k}")


def test_params_and_fields_match_reference():
    J = _ref()[2]
    assert T.PViewParams._fields == J.PViewParams._fields
    assert T.PViewParams._field_defaults == {**J.PViewParams._field_defaults}
    assert T.PViewState._fields == J.PViewState._fields
    assert T.SLOT_DTYPE == torch.int32 and T.LANE_DTYPE == torch.int16
    assert np.dtype(J.SLOT_DTYPE) == np.int32
    assert np.dtype(J.LANE_DTYPE) == np.int16


# hash inputs: the edge values 0, 2^31 - 1 and 2^32 - 1 (as int32: -1),
# subjects up to 2^21, then seeded ones
_EDGE = np.array([0, 1, 2**31 - 1, -1, 2**21 - 1, 2**21, 2**31 - 2, -2**31],
                 dtype=np.int32)


@pytest.mark.parametrize("k", [32, 48, 2048, 2**16, 1000003])
def test_hash_equal(k):
    jnp, J = _ref()[1:3]
    rng = np.random.default_rng(k)
    subj = np.concatenate([_EDGE, rng.integers(-2**31, 2**31, 500,
                                               dtype=np.int64)
                           .astype(np.int32)])
    jp, tp = J.PViewParams(n=2**21, slots=k), T.PViewParams(n=2**21, slots=k)
    ref = np.asarray(J._hash(jp, jnp.asarray(subj)))
    got = T._hash(tp, torch.from_numpy(subj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fmix_mask_pack_unpack_equal():
    jnp, J = _ref()[1:3]
    rng = np.random.default_rng(5)
    x = np.concatenate([np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                                 dtype=np.uint32),
                        rng.integers(0, 2**32, 500, dtype=np.uint64)
                        .astype(np.uint32)])
    np.testing.assert_array_equal(
        T._fmix32(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(J._fmix32(jnp.asarray(x))).astype(np.int64))
    for n in (96, 1000, 2**21):
        jp = J.PViewParams(n=n, slots=64, tie_epoch=7)
        tp = convert.pview_params_from_dict(jp._asdict())
        rows = np.concatenate([[0, n - 1], rng.integers(0, n, 300)]).astype(
            np.int32)
        subj = np.concatenate([[0, n - 1], rng.integers(0, n, 300)]).astype(
            np.int32)
        key = rng.integers(0, T._keycap(n), subj.shape).astype(np.int32)
        for t in (0, 6, 7, 1000, 2**31 - 1):
            mask = T._mask(tp, torch.from_numpy(rows), t)
            np.testing.assert_array_equal(
                mask.numpy(), np.asarray(J._mask(jp, jnp.asarray(rows), t)))
            packed = T._pack(tp, torch.from_numpy(subj),
                             torch.from_numpy(key), mask)
            jpacked = np.asarray(J._pack(jp, jnp.asarray(subj),
                                         jnp.asarray(key), rows, t))
            np.testing.assert_array_equal(packed.numpy(), jpacked)
            for a, b in zip(T._unpack(tp, packed, mask),
                            J._unpack(jp, jnp.asarray(jpacked), rows, t)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_identity_hash_pins_dense_tick():
    """slots == n with the identity hash: the port's pview tick (r5, pick)
    is the port's dense tick, bit for bit, through a crash and a restart,
    as the reference's kernels are (tests/test_swim_pview.py)."""
    n = 64
    common = dict(feeds_per_tick=2, feed_entries=16, announce_period=8,
                  antientropy=2, gossip_mode="pick")
    dp = TD.SwimParams(n=n, **common)
    pp = T.PViewParams(n=n, slots=n, identity_hash=True, tick_mode="r5",
                       **common)
    ds = TD.init_state(dp, (0, 0), device="cpu")
    ps = T.init_state(pp, (0, 0), device="cpu")
    for i in range(30):
        key = jr.fold_in(jr.PRNGKey(7), i)
        if i in (10, 20):
            ds = TD.set_alive(ds, 5, i == 20)
            ps = T.set_alive(ps, 5, i == 20)
        ds = TD.tick_impl(ds, key, dp)
        ps = T.tick_impl(ps, key, pp)
    idx = torch.arange(n)[:, None]
    subj, key = T._unpack(pp, ps.slot_packed, T._mask(pp, idx[:, 0], ps.t)
                          [:, None])
    recon = torch.zeros((n, n), dtype=torch.int32)
    occ = key > 0
    recon[idx.expand(n, n)[occ], subj[occ].long()] = key[occ]
    np.testing.assert_array_equal(recon.numpy(), ds.view.numpy())
    for f in ("inc", "buf_subj", "buf_key", "probe_phase", "probe_subj",
              "susp_subj", "events", "ring"):
        np.testing.assert_array_equal(
            getattr(ps, f).numpy().astype(np.int32),
            getattr(ds, f).numpy().astype(np.int32), err_msg=f)


def test_stats_and_events_equal():
    """The one-readback drain (stats, uint32 events, flight ring) equals
    the reference's over 4096-row blocks with a clamped, overlapping last
    block (n=5000), dead members, suspect/down entries and empty cells."""
    jax, jnp, J = _ref()[:3]
    n, k, t = 5000, 16, 9
    rng = np.random.default_rng(4)
    jp = J.PViewParams(n=n, slots=k, tie_epoch=4, ring_ticks=4)
    tp = convert.pview_params_from_dict(jp._asdict())
    fields = _np_state(J.init_state(jp, jax.random.PRNGKey(0)))
    rows = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, k))
    subj = rng.integers(0, n, (n, k)).astype(np.int32)
    subj[:, 0] = np.arange(n)  # self entries
    key = (4 * rng.integers(1, 6, (n, k)) + rng.choice(
        [0, 0, 0, 0, 1, 2], (n, k))).astype(np.int32)
    packed = np.asarray(J._pack(jp, jnp.asarray(subj), jnp.asarray(key),
                                rows, t))
    fields["slot_packed"] = np.where(rng.random((n, k)) < 0.2, 0, packed)
    fields["alive"] = rng.random(n) < 0.9
    fields["events"] = rng.integers(-2**31, 2**31 - 1, size=len(
        fields["events"])).astype(np.int32)
    fields["ring"] = rng.integers(0, 99, size=fields["ring"].shape).astype(
        np.int32)
    fields["t"] = np.int32(t)
    js = J.PViewState(**{f: jnp.asarray(v) for f, v in fields.items()})
    jstats, jev, jfl = J.stats_and_events(js, jp)
    tstats, tev, tfl = T.stats_and_events(
        convert.pview_state_from_numpy(fields, "cpu"), tp)
    assert 0.0 < jstats["false_positive"] and jstats["detected"] < 1.0
    for name in jstats:
        np.testing.assert_allclose(tstats[name], jstats[name], rtol=1e-6)
    assert tev.dtype == np.uint32
    np.testing.assert_array_equal(tev, jev)
    np.testing.assert_array_equal(tfl.ring, jfl.ring)
    assert tfl.t == jfl.t == t


def test_floor_caps_and_memory_match_reference():
    J = _ref()[2]
    for n, k in ((96, 32), (512, 64), (262_144, 2048), (2**21, 2048)):
        assert T.saturation_floor(n, k) == J.saturation_floor(n, k)
        assert T.inc_cap(n) == J.inc_cap(n)
        ref, got = J.memory_gb(n, k), T.memory_gb(n, k)
        assert got["slot_table_gb"] == ref["slot_table_gb"]
        assert got["buffers_fsm_gb"] == ref["buffers_fsm_gb"]
        assert got["total_gb"] == pytest.approx(
            got["slot_table_gb"] + got["buffers_fsm_gb"], abs=0.011)


_SIM = dict(slots=64, seed=0, seed_mode="fingers", feeds_per_tick=2,
            feed_entries=16, gossip_mode="pick")


@pytest.fixture(scope="module")
def jax_converged():
    jcluster = _ref()[3]
    sim = jcluster.PViewClusterSim(512, inbox_impl="gsort", **_SIM)
    tick = sim.run_until_converged_device(0.99, 8, 400, 10)
    return tick, sim.stats(), np.asarray(sim.state.events).astype(np.uint32)


def test_run_until_converged_device_matches_jax(jax_converged):
    jtick, jstats, jevents = jax_converged
    sim = tcluster.PViewClusterSim(512, device="cpu", inbox_impl="cuda",
                                   **_SIM)
    tick = sim.run_until_converged_device(0.99, 8, 400, 10)
    assert jtick is not None and tick == jtick
    np.testing.assert_array_equal(sim.last_event_delta, jevents)
    assert sim.last_flight.t == tick
    stats = sim.stats()
    assert sim.converged(stats)
    for name in jstats:
        np.testing.assert_allclose(stats[name], jstats[name], rtol=1e-6)


def test_flaky_node_ab_pview_matches_jax():
    """The Lifeguard A/B on the pview kernel, at tests/test_lifeguard.py's
    shapes, returns the JAX package's record."""
    jcluster = _ref()[3]
    kw = dict(kernel="pview", seed=3, n=64, boot_ticks=20, window=80, lag=2,
              chunk=20, detect_chunk=20, slots=32, feeds_per_tick=2,
              feed_entries=16)
    ref = jcluster.flaky_node_ab(**kw)
    got = tcluster.flaky_node_ab(device="cpu", **kw)
    assert got == ref
    assert ref["vanilla"]["suspect_fp"] > 0


def test_entry_points_need_the_card_or_the_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_state(T.PViewParams(n=16, slots=8), (0, 0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcluster.PViewClusterSim(16, slots=8)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_tick_on_card_equals_cpu(cfg):
    """The pview tick on the card against the same tick on the CPU: every
    field bit-equal after each of 8 ticks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the inbox kernel has no CPU mode")
    _, tkw, faults = CONFIGS[cfg]
    params = T.PViewParams(n=N, slots=K, **BASE, **tkw)
    states = [T.init_state(params, (0, 3), seed_mode="fingers", device=d)
              for d in ("cpu", "cuda")]
    if faults:
        states = [_inject(s, T) for s in states]
    for t in range(TICKS):
        key = jr.fold_in((0, 3), t)
        states = [T.tick_impl(s, key, params) for s in states]
        for f in T.PViewState._fields:
            assert torch.equal(getattr(states[0], f),
                               getattr(states[1], f).cpu()), (cfg, t, f)
