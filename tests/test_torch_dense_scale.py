"""The port's dense scale driver (`corrosion_tpu_torch.dense_100k`) against
the JAX package's program, and the view's index arithmetic at the
north-star size.

- `dense_100k.run` at n=512, chunk 5, on the CPU: the state equals the
  JAX `_tick_n_impl` chain's (the unsharded program of
  `scripts/dense_100k.py`: `init_state(PRNGKey(0))`, then `PRNGKey(1)`
  split once per dispatch) field by field after every chunk, and the
  converged tick, stats and event lane are equal;
- the parameters at n=100,000 are the script's (16 feeds of 1,562);
- the tick's reads of the [N, N] view at n=100,000 address the cell they
  name: a view whose cell (i, j) holds a value of i + j, with 10^10
  cells over 200,000 B of memory (stride (1, 1)), so an index computed
  in 32 bits past 2^31 reads the wrong value;
- the bench configuration's host loop over `tick_n_donated` (one view
  alive, for the n=100,000 reference below) gives the JAX device loop's
  tick, stats and events at n=512;
- `chip_smoke.DENSE_REF` is what the JAX package gives at n=32,768
  (marked slow: the two JAX runs take minutes on the CPU).

    JAX_PLATFORMS=cpu python -m tests.test_torch_dense_scale

prints `DENSE_REF`: at n=32,768, the `dense_100k` program (chunk 25,
shift) through the JAX `_tick_n_impl`, and `bench.py`'s configuration
(pick, check every 5) through the JAX `ClusterSim.run_until_stable_device`
with its "gsort" inbox (bit-equal to the port's "cuda" one): the stable
tick, the three stats as float32 and the 14 event totals.

    JAX_PLATFORMS=cpu python -m tests.test_torch_dense_scale --ref-100k

builds the bench configuration at n=100,000 on the JAX package, prints
the compiled 5-tick dispatch's temporary bytes beside the view's and
the host's available memory, and runs the host loop to its stable tick
(`DENSE_100K_REF`) only if the view and the temporaries together fit in
90 % of the memory available before the sim was built.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.models.cluster import ClusterSim as JClusterSim
from corrosion_tpu.ops import swim as J
from corrosion_tpu_torch import bench, dense_100k
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim as T

# the reference's chunk program compiled without XLA's costly backend
# passes (as tests/test_torch_swim.py does): the same integer and float32
# results, about half the compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}
STATS = ("coverage", "detected", "false_positive")


def jax_params(n):
    return J.SwimParams(**dense_100k.dense_params(n)._asdict())


def jax_dense_chain(n, chunk, fast=False, on_chunk=None):
    """`scripts/dense_100k.py`'s program, unsharded, on the JAX package:
    (converged tick or None, stats, event totals)."""
    params = jax_params(n)
    state = J.init_state(params, jax.random.PRNGKey(0), seed_mode="fingers")
    rng = jax.random.PRNGKey(1)
    if fast:
        tick_k = jax.jit(J._tick_n_impl, static_argnames=("params", "k")
                         ).lower(state, rng, params=params, k=chunk
                                 ).compile(compiler_options=_FAST_COMPILE)
    else:
        def tick_k(s, key):
            return J.tick_n_donated(s, key, params, chunk)
    ticks = 0
    stats = None
    while ticks < dense_100k.MAX_TICKS:
        rng, key = jax.random.split(rng)
        state = tick_k(state, key)
        ticks += chunk
        if on_chunk is not None:
            on_chunk(ticks, state)
        if ticks == chunk:
            continue  # the script reads no stats after its first dispatch
        stats = J.membership_stats(state)
        if stats["coverage"] >= 0.999 and stats["false_positive"] == 0.0:
            return ticks, stats, _events(state)
    return None, stats, _events(state)


def jax_bench_run(n):
    """`bench.py`'s configuration on the JAX package: pick with the
    "gsort" inbox, fingers, check every 5 on the device loop."""
    sim = JClusterSim(n, seed=0, seed_mode="fingers", gossip_mode="pick",
                      inbox_impl="gsort", **bench.bench_params(n))
    tick = sim.run_until_stable_device(0.999, bench.MAX_TICKS, 5)
    return tick, sim.stats(), _events(sim.state)


def jax_bench_host_loop(n, check_every=5):
    """`jax_bench_run` as a host loop: the device loop's key chain and
    coverage predicate around `tick_n_donated`, so one view lives. Its
    state is built but not run when `check_every` is 0: (sim, key)."""
    sim = JClusterSim(n, seed=0, seed_mode="fingers", gossip_mode="pick",
                      inbox_impl="gsort", **bench.bench_params(n))
    sim._rng, rng = jax.random.split(sim._rng)
    if not check_every:
        return sim, rng
    state, sim.state = sim.state, None
    coverage = jax.jit(J._coverage_impl)
    cov = np.float32(-1.0)
    while (cov < np.float32(0.999)
           and int(state.t) + check_every <= bench.MAX_TICKS):
        rng, key = jax.random.split(rng)
        state = J.tick_n_donated(state, key, sim.params, check_every)
        cov = np.float32(coverage(state.view, state.alive))
    tick = int(state.t) if cov >= np.float32(0.999) else None
    return tick, J.membership_stats(state), _events(state)


def _events(state):
    return tuple(np.asarray(state.events).astype(np.uint32).tolist())


def _ref_row(tick, stats, events):
    return (tick, tuple(float(np.float32(stats[k])) for k in STATS), events)


def test_driver_matches_the_jax_chain():
    n, chunk = 512, 5
    ref = {}

    def keep(ticks, state):
        ref[ticks] = {f: np.asarray(getattr(state, f))
                      for f in J.SwimState._fields}

    jtick, jstats, jevents = jax_dense_chain(n, chunk, fast=True,
                                             on_chunk=keep)
    seen = []

    def check(ticks, state):
        seen.append(ticks)
        for f in T.SwimState._fields:
            np.testing.assert_array_equal(
                getattr(state, f).numpy(), ref[ticks][f],
                err_msg=f"field {f} after {ticks} ticks")

    rec = dense_100k.run(n, chunk, device="cpu", on_chunk=check,
                         log=lambda s: None)
    assert jtick is not None and rec["converged"]
    assert rec["convergence_ticks"] == jtick and seen == sorted(ref)
    for k in STATS:  # bit for bit: n=512 blocks sum exactly in float32
        assert np.float32(rec[k]) == np.float32(jstats[k]), k
    assert tuple(rec["events"]) == jevents
    assert rec["n_devices"] == 1 and rec["platform"] == "cpu"
    assert rec["peak_mem_bytes"] is None and rec["device_kind"] is None


def test_params_are_the_scripts_at_100k():
    p = dense_100k.dense_params(100_000)
    # scripts/dense_100k.py:67-72
    feeds = 16
    assert p.feeds_per_tick == feeds
    assert p.feed_entries == max(25, 100_000 // (4 * feeds)) == 1562
    assert (p.piggyback, p.incoming_slots, p.buffer_slots,
            p.probe_candidates, p.antientropy) == (4, 8, 12, 2, 1)
    assert p.gossip_mode == "shift" and p.inbox_impl == "gsort"
    assert dense_100k.dense_params(100_000, 4).feed_entries == 6250
    assert dense_100k.dense_params(1000).feed_entries == 25
    assert J.SwimParams(n=100_000) == J.SwimParams(
        **T.SwimParams(n=100_000)._asdict())


def _diag_view(n, mod=32_749):
    """An [n, n] int16 view with cell (i, j) = (i + j) % mod, over 2n
    elements of memory: no cell is allocated, every index is real."""
    base = (torch.arange(2 * n, dtype=torch.int64) % mod).to(torch.int16)
    return base.as_strided((n, n), (1, 1)), mod


def test_view_reads_address_their_cell_at_100k():
    n = 100_000
    view, mod = _diag_view(n)
    assert n * n > 2**33
    idx = torch.arange(n)
    rows = torch.tensor([0, 1, n // 2, n - 2, n - 1])
    cols = torch.tensor([[n - 1, 7, 0], [n - 2, n - 1, 3],
                         [12_345, n - 1, 99_998], [n - 1, 0, 1], [n - 1] * 3])
    got = view[rows].gather(1, cols)
    assert torch.equal(got.long(), (rows[:, None] + cols) % mod)
    # the tick's advanced-index read of one cell per row
    psubj = (idx * 7919) % n
    got = view[idx, psubj]
    assert torch.equal(got.long(), (idx + psubj) % mod)
    # the feed window's column read past column 2^31 / n
    fe = dense_100k.dense_params(n, 4).feed_entries
    t_off = torch.tensor(3, dtype=torch.int32)
    steps = -(-n // fe)
    w = torch.clamp(torch.remainder(t_off, steps) * fe, max=n - fe)
    cols = w.to(torch.int64) + torch.arange(fe)
    vw = view[n - 3:].index_select(1, cols)
    want = (torch.arange(n - 3, n)[:, None] + cols[None, :]) % mod
    assert torch.equal(vw.long(), want)
    # `_pick_known_alive`'s candidates (two random offsets, then two ring
    # offsets from the same planes) and the keys it reads for them
    params = T.SwimParams(n=n)
    pick = T._pick_known_alive(view, idx, jr.PRNGKey(5), params, 2)
    hi, lo = jr.randint_planes(jr.PRNGKey(5), 2 * n, torch.device("cpu"))
    offs = torch.cat([jr.randint_from_planes(hi, lo, 1, n).reshape(n, 2),
                      jr.randint_from_planes(hi, lo, 1, 4).reshape(n, 2)], 1)
    cands = (idx[:, None] + offs) % n
    keys = (idx[:, None] + cands) % mod  # what cell (i, cand) holds
    ok = (keys > 0) & (keys % 4 == 0) & (cands != idx[:, None])
    first = torch.where(ok, torch.arange(4), 4).amin(dim=1)
    want = torch.where(first < 4, cands.gather(
        1, first.clamp(max=3)[:, None])[:, 0], n)
    assert torch.equal(pick.long(), want)
    assert (pick < n).sum() > n // 2


def test_bench_host_loop_is_the_device_loop():
    want = _ref_row(*jax_bench_run(512))
    assert _ref_row(*jax_bench_host_loop(512)) == want
    assert want[0] is not None


def ref_100k():
    import os
    import time
    n = 100_000
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    sim, key = jax_bench_host_loop(n, check_every=0)
    temp = J.tick_n_donated.lower(sim.state, key, sim.params, 5).compile(
        ).memory_analysis().temp_size_in_bytes
    view = sim.state.view.nbytes
    print(f"n={n:_}: view {view:_} B, 5-tick dispatch temporaries "
          f"{temp:_} B, host memory available {avail:_} B", flush=True)
    del sim
    if view + temp > 0.9 * avail:
        print("DENSE_100K_REF not run: the view and the temporaries do "
              "not fit")
        return
    t0 = time.monotonic()
    row = _ref_row(*jax_bench_host_loop(n))
    print(f"DENSE_100K_REF = {row!r}  # {time.monotonic() - t0:.0f} s")


@pytest.mark.slow
def test_dense_ref_is_the_jax_packages():
    n = chip_smoke.DENSE_REF_N
    assert chip_smoke.DENSE_REF["shift"] == _ref_row(*jax_dense_chain(n, 25))
    assert chip_smoke.DENSE_REF["pick"] == _ref_row(*jax_bench_run(n))


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--ref-100k"]:
        ref_100k()
        sys.exit()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.DENSE_REF_N
    print(f"DENSE_REF_N = {n:_}")
    print("DENSE_REF = {")
    print(f'    "shift": {_ref_row(*jax_dense_chain(n, 25))!r},', flush=True)
    print(f'    "pick": {_ref_row(*jax_bench_run(n))!r},')
    print("}")
