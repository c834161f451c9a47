"""The port's dense SWIM tick (`corrosion_tpu_torch.ops.swim`) against the
JAX package's, bit for bit.

The same seeded inputs go through both: init_state for every seed mode,
then 5 ticks at n=64 and n=100 for shift; pick with the sort, gsort and
cuda inbox builds; Lifeguard with degraded members; loss 0.1; and a
partition. Every state field must be equal after every tick (integer and
float lanes alike: the loss draws are float32 bits). The JAX side runs
its pick mode with its default "gsort" build, which its own suite pins
bit-equal to "sort" and "pallas" (tests/test_inbox_impls.py). Stats are
held to rtol 1e-6 (float32 sums in another order, as in
tests/test_stats_blocked.py).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import swim as J
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.ops import swim as T
from corrosion_tpu_torch.runtime import metrics as tmetrics

_REFS = {}  # (n, jax config) -> JAX states after each tick, as numpy
_TICKS = {}  # SwimParams -> compiled JAX tick
# The reference tick is compiled without XLA's costly backend passes: the
# same program, about half the compile time, the same integer and
# float32 results.
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jtick(state, key, params):
    fn = _TICKS.get(params)
    if fn is None:
        fn = _TICKS[params] = jax.jit(
            J.tick_impl, static_argnames="params"
        ).lower(state, key, params=params).compile(
            compiler_options=_FAST_COMPILE)
    return fn(state, key)


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in J.SwimState._fields}


def _assert_state_equal(ref, got, what):
    for f in T.SwimState._fields:
        a, b = ref[f], getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: field {f}")


def _inject(state, mod, n):
    """Degraded members, a crash and a partition (the `partition` and
    `lifeguard` configs), through each package's own injectors."""
    state = mod.set_degraded(state, [1, 5, 9], 0.3, 2)
    state = mod.set_alive(state, 7, False)
    state = mod.set_alive(state, 11, False)
    state = mod.set_alive(state, 11, True)
    return mod.set_partition(state, (np.arange(n) % 3 == 0).astype(np.int32))


CONFIGS = {
    # name: (jax params overrides, port overrides, inject faults?)
    "shift": (dict(), dict(), False),
    "pick-sort": (dict(gossip_mode="pick"),
                  dict(gossip_mode="pick", inbox_impl="sort"), False),
    "pick-gsort": (dict(gossip_mode="pick"),
                   dict(gossip_mode="pick", inbox_impl="gsort"), False),
    "pick-cuda": (dict(gossip_mode="pick"),
                  dict(gossip_mode="pick", inbox_impl="cuda"), False),
    "lifeguard-degraded": (dict(lhm_max=4), dict(lhm_max=4), True),
    "loss": (dict(loss=0.1), dict(loss=0.1), False),
    "partition": (dict(), dict(), True),
}
BASE = dict(feeds_per_tick=2, feed_entries=16)


def _jax_run(n, cfg):
    jkw, _, faults = CONFIGS[cfg]
    ref_key = (n, tuple(sorted(jkw.items())), faults)
    if ref_key not in _REFS:
        params = J.SwimParams(n=n, **BASE, **jkw)
        rng = jax.random.PRNGKey(3)
        state = J.init_state(params, rng, 3, "fingers")
        if faults:
            state = _inject(state, J, n)
        states = [_np_state(state)]
        for t in range(5):
            state = _jtick(state, jax.random.fold_in(rng, t), params)
            states.append(_np_state(state))
        stats = np.asarray(J._stats_impl(state.view, state.alive))
        _REFS[ref_key] = (params, states, stats)
    return _REFS[ref_key]


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_tick_bit_equal(n, cfg):
    jparams, states, jstats = _jax_run(n, cfg)
    _, tkw, _ = CONFIGS[cfg]
    params = convert.params_from_dict({**jparams._asdict(), **tkw})
    state = convert.swim_state_from_numpy(states[0], "cpu")
    rng = jax.random.PRNGKey(3)
    for t in range(5):
        key = convert.key_from_numpy(np.asarray(jax.random.fold_in(rng, t)))
        state = T.tick_impl(state, key, params)
        _assert_state_equal(states[t + 1], state, f"{cfg} n={n} tick {t}")
    np.testing.assert_allclose(
        T._stats_impl(state.view, state.alive).numpy(), jstats, rtol=1e-6)


@pytest.mark.parametrize("seed_mode", ["ring", "hub", "fingers"])
@pytest.mark.parametrize("n", [64, 100])
def test_init_state_equal(seed_mode, n):
    jp = J.SwimParams(n=n)
    rng = jax.random.PRNGKey(1)
    ref = _np_state(J.init_state(jp, rng, 3, seed_mode))
    got = T.init_state(convert.params_from_dict(jp._asdict()),
                       convert.key_from_numpy(np.asarray(rng)), 3, seed_mode,
                       device="cpu")
    _assert_state_equal(ref, got, f"init {seed_mode}")
    np.testing.assert_array_equal(
        T.finger_offsets(n).numpy(), np.asarray(J.finger_offsets(n)))


def test_params_and_lanes_match_reference():
    assert T.SwimParams._fields == J.SwimParams._fields
    assert T.SwimParams._field_defaults == {
        **J.SwimParams._field_defaults}
    assert T.SwimState._fields == J.SwimState._fields
    assert tmetrics.KERNEL_EVENTS == jmetrics.KERNEL_EVENTS
    assert tmetrics.FLIGHT_CENSUS == jmetrics.FLIGHT_CENSUS
    assert tmetrics.FLIGHT_LANES == jmetrics.FLIGHT_LANES
    assert T.INC_CAP == J.INC_CAP and T.N_FLIGHT_LANES == J.N_FLIGHT_LANES
    assert convert.params_from_dict(
        J.SwimParams(n=8, inbox_impl="pallas")._asdict()).inbox_impl == "cuda"
    for k in range(6):
        jp = J.SwimParams(n=8, susp_k=k, suspicion_ticks=4, susp_ceiling=5)
        np.testing.assert_array_equal(
            T._susp_shrink_table(convert.params_from_dict(jp._asdict()),
                                 "cpu").numpy(),
            np.asarray(J._susp_shrink_table(jp)))


def test_stats_and_events_equal():
    """The one-readback drain (stats, uint32 events, flight ring) equals
    the reference's, and the blocked stats match across a clamped,
    overlapping last block (n=1100: 512-row blocks)."""
    n = 1100
    rng = np.random.default_rng(4)
    fields = _np_state(J.init_state(J.SwimParams(n=n, ring_ticks=4),
                                    jax.random.PRNGKey(0)))
    fields["view"] = rng.integers(0, 40, size=(n, n)).astype(np.int16)
    fields["alive"] = rng.random(n) < 0.9
    fields["events"] = rng.integers(-2**31, 2**31 - 1, size=len(
        tmetrics.KERNEL_EVENTS)).astype(np.int32)
    fields["ring"] = rng.integers(0, 99, size=(4, T.N_FLIGHT_LANES)).astype(
        np.int32)
    fields["t"] = np.int32(9)
    js = J.SwimState(**{k: jax.numpy.asarray(v) for k, v in fields.items()})
    jstats, jev, jfl = J.stats_and_events(js)
    tstats, tev, tfl = T.stats_and_events(
        convert.swim_state_from_numpy(fields, "cpu"))
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-6)
    assert tev.dtype == np.uint32
    np.testing.assert_array_equal(tev, jev)
    np.testing.assert_array_equal(tfl.ring, jfl.ring)
    assert tfl.t == jfl.t == 9


def test_buffer_merge_lex_equal():
    """The three-operand merge for full int32 keys (the partial-view
    kernel's form) on random buffers with duplicate subjects."""
    n, b, r = 50, 6, 9
    rng = np.random.default_rng(8)
    args = (
        rng.integers(0, n + 1, size=(n, b)).astype(np.int32),
        rng.integers(0, 2**24, size=(n, b)).astype(np.int32),
        rng.integers(0, 12, size=(n, b)).astype(np.int32),
        rng.integers(0, n + 1, size=(n, r)).astype(np.int32),
        rng.integers(0, 2**24, size=(n, r)).astype(np.int32),
    )
    params = J.SwimParams(n=n, buffer_slots=b)
    ref = J.buffer_merge_lex(params, *map(jax.numpy.asarray, args))
    got = T.buffer_merge_lex(convert.params_from_dict(params._asdict()),
                             *map(torch.from_numpy, args))
    for a, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(a))


def test_state_round_trips_through_numpy():
    params = T.SwimParams(n=16)
    state = T.init_state(params, (0, 1), device="cpu")
    back = convert.swim_state_from_numpy(convert.swim_state_to_numpy(state),
                                         "cpu")
    for f in T.SwimState._fields:
        assert torch.equal(getattr(back, f), getattr(state, f))
    with pytest.raises(ValueError, match="fields differ"):
        convert.swim_state_from_numpy({"t": np.int32(0)}, "cpu")
    with pytest.raises(ValueError):
        convert.key_from_numpy(np.zeros(2, np.int64))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imports without
    loading `jax`, any module of `corrosion_tpu` or any of `tests`."""
    root = Path(__file__).resolve().parent.parent
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "corrosion_tpu_torch").rglob("*.py")
    )
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    # the API slice's modules and the runtime planes' among them
    assert {f"corrosion_tpu_torch.{m}" for m in (
        "net.hpack", "net.h2", "chaos.faults", "api.http", "api.h2front",
        "api.pubsub_http", "client", "pubsub_bench")} <= set(mods)
    assert {f"corrosion_tpu_torch.{m}" for m in (
        "runtime.profstore", "runtime.tsdb", "runtime.alerts",
        "runtime.tracestore", "runtime.otel", "runtime.profiler",
        "agent.remediation", "planes_checks")} <= set(mods)
    # the operator surface and the chaos harness among them
    assert {f"corrosion_tpu_torch.{m}" for m in (
        "admin", "tpl", "consul", "devcluster", "cli", "__main__",
        "runtime.tmpdb", "chaos.scenarios", "chaos.workload",
        "traffic_sim", "cli_checks")} <= set(mods)
    # the analyzer and its drivers among them
    assert {f"corrosion_tpu_torch.{m}" for m in (
        "analysis", "analysis.core", "analysis.purity", "analysis.parity",
        "corro_lint", "lint_metrics")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'corrosion_tpu' or "
        "m.startswith('corrosion_tpu.') or m == 'tests' or "
        "m.startswith('tests.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_port_source_names_neither_jax_nor_the_jax_package():
    """No source line of the port, or of chip_smoke.py, imports jax or
    names a module of `corrosion_tpu`, even inside a function body that
    the import check never runs (a lazy import of the store, say)."""
    root = Path(__file__).resolve().parent.parent
    bad = re.compile(r"\bimport jax\b|\bfrom jax\b|\bcorrosion_tpu\."
                     r"|\bcorrosion_tpu import\b")
    files = sorted((root / "corrosion_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    hits = [f"{p.relative_to(root)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.search(line)]
    assert not hits, hits
    assert bad.search("    from corrosion_tpu.store.crdt import x")
    assert not bad.search("from corrosion_tpu_torch.ops import crdt_merge")
