"""The port's gossip-inbox builds against the JAX package's.

`build_inbox_plain` (the CUDA kernel's plain version), the port's "cuda"
impl on CPU tensors (which takes the plain version), "gsort" and the flat
"sort" must equal JAX's `build_inbox_pallas` (interpret mode, as
tests/test_inbox_impls.py runs it), `build_inbox_grouped` and the flat
`build_inbox` exactly (int32 ==), on the five degenerate cases of
tests/test_inbox_impls.py and on one case at the slice's m=5, slots=8.
The kernel itself runs only on the card: its test compares it with the
plain version there, one launch per call, on these cases and on larger
ones (skew, a ragged n, G=0, m=1, slots=16), and skips elsewhere."""

import functools

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import inbox_bench
from corrosion_tpu_torch.ops import inbox_cuda
from corrosion_tpu_torch.ops import swim as tswim

# (n, g, m, slots, p_ok, dst_spread)
CASES = [
    (64, 128, 10, 16, 0.8, 64),  # typical shape
    (64, 128, 10, 4, 0.8, 8),  # heavy collisions, tight slots
    (16, 400, 3, 2, 0.5, 16),  # overflow everywhere
    (32, 64, 10, 16, 0.0, 32),  # all masked
    (32, 64, 10, 16, 1.0, 1),  # single destination takes all
    (300, 600, 5, 8, 0.8, 300),  # the slice's m and slots
]
# cases for the kernel alone, at the card's sizes
CARD_CASES = CASES + [
    (10_000, 2_000_000, 5, 8, 0.8, 4),  # skew: every packet to 4 members
    (10_007, 20_014, 5, 8, 0.8, 10_007),  # prime n: ragged last range
    (10_000, 0, 5, 8, 0.8, 10_000),  # G = 0: every row empty
    (10_000, 20_000, 1, 8, 0.8, 10_000),  # m = 1
    (100_000, 200_000, 5, 16, 0.8, 100_000),  # slots = 16
]


def _case(seed, n, g, m, p_ok, spread):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, spread, size=g).astype(np.int32),
        rng.integers(0, n, size=(g, m)).astype(np.int32),
        rng.integers(1, 2**20, size=(g, m)).astype(np.int32),
        rng.random((g, m)) < p_ok,
    )


@functools.lru_cache(maxsize=None)
def _jax_builds():
    """The JAX package's three inbox builds, imported on first use: the
    card-only tests below run where JAX is not installed
    (`pytest --noconftest -m cuda tests/test_torch_inbox.py`)."""
    import jax

    from corrosion_tpu.ops import swim as jswim
    from corrosion_tpu.ops.inbox_pallas import build_inbox_pallas

    return (jax.jit(jswim.build_inbox, static_argnums=(0, 1)),
            jax.jit(jswim.build_inbox_grouped, static_argnums=(0, 1)),
            build_inbox_pallas)


def _jax_refs(n, slots, dst, subj, key, ok):
    import jax.numpy as jnp

    flat_build, grouped_build, pallas_build = _jax_builds()
    d, s, k, o = map(jnp.asarray, (dst, subj, key, ok))
    flat = flat_build(
        n, slots,
        jnp.where(o, d[:, None], n).reshape(-1),
        jnp.where(o, s, n).reshape(-1),
        jnp.where(o, k, 0).reshape(-1),
    )
    return {
        "pallas": pallas_build(n, slots, d, s, k, o),
        "grouped": grouped_build(n, slots, d, s, k, o),
        "flat": flat,
    }


@pytest.mark.parametrize("case", CASES)
def test_port_inbox_builds_equal_jax(case):
    n, g, m, slots, p_ok, spread = case
    arrays = _case(17, n, g, m, p_ok, spread)
    refs = _jax_refs(n, slots, *arrays)
    t = [torch.from_numpy(a) for a in arrays]
    got = {
        "plain": inbox_cuda.build_inbox_plain(n, slots, *t),
        "cuda": tswim.dispatch_inbox("cuda", n, slots, *t),
        "gsort": tswim.dispatch_inbox("gsort", n, slots, *t),
        "sort": tswim.dispatch_inbox("sort", n, slots, *t),
    }
    for ref_name, (rs, rk) in refs.items():
        for name, (gs, gk) in got.items():
            assert gs.dtype == torch.int32 and gk.dtype == torch.int32
            np.testing.assert_array_equal(gs.numpy(), np.asarray(rs),
                                          err_msg=f"{name} vs {ref_name}")
            np.testing.assert_array_equal(gk.numpy(), np.asarray(rk),
                                          err_msg=f"{name} vs {ref_name}")


def test_plain_drops_out_of_range_destinations():
    """A packet whose destination lies outside [0, n) reaches no inbox,
    and does not shift the columns of the packets that do."""
    n, slots = 8, 4
    dst, subj, key, ok = _case(3, n, 40, 3, 0.9, n)
    bad = dst.copy()
    bad[::5] = n + 3
    keep = np.ones(len(dst), bool)
    keep[::5] = False
    t = lambda *a: [torch.from_numpy(np.ascontiguousarray(x)) for x in a]
    got = inbox_cuda.build_inbox_plain(n, slots, *t(bad, subj, key, ok))
    ref = inbox_cuda.build_inbox_plain(
        n, slots, *t(dst[keep], subj[keep], key[keep], ok[keep]))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_dispatch_rejects_unknown_impl():
    n, g, m, slots = 16, 32, 4, 8
    t = [torch.from_numpy(a) for a in _case(5, n, g, m, 0.7, n)]
    for impl in ("definitely-not", "pallas"):
        with pytest.raises(ValueError, match="inbox_impl"):
            tswim.dispatch_inbox(impl, n, slots, *t)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    n, g, m, slots = 16, 32, 4, 8
    t = [torch.from_numpy(a) for a in _case(6, n, g, m, 0.7, n)]
    before = inbox_cuda.build_inbox.launches
    got = inbox_cuda.build_inbox(n, slots, *t)
    ref = inbox_cuda.build_inbox_plain(n, slots, *t)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert inbox_cuda.build_inbox.launches == before  # no kernel launched
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        inbox_cuda.build_inbox(n, slots, *meta)


def test_bound_counts_only_the_messages_that_land_in_a_cell():
    """`inbox_bench.bound_ms` reads subj and key only for the cells the
    output fills: as many as the plain version's non-empty cells."""
    for n, g, m, slots, p_ok, spread in CASES:
        t = [torch.from_numpy(a) for a in _case(29, n, g, m, p_ok, spread)]
        out_subj, _ = inbox_cuda.build_inbox_plain(n, slots, *t)
        filled = int((out_subj != n).sum())
        want = 4 * g + g * m + 8 * filled + 8 * n * slots
        got = inbox_bench.bound_ms(n, slots, t[0], t[3])
        assert got == pytest.approx(1e3 * want / inbox_bench.HBM_BYTES_PER_S)


@pytest.mark.cuda
def test_wrapper_rejects_slots_beyond_shared_memory():
    """A destination's list of `slots` ids has to fit in one block's
    shared memory; the kernel refuses the launch and the wrapper raises.
    The limit is the card's, so this runs only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the limit is the card's")
    n, g, m = 16, 32, 4
    t = [torch.from_numpy(a).cuda() for a in _case(7, n, g, m, 0.7, n)]
    before = inbox_cuda.build_inbox.launches
    with pytest.raises(ValueError, match="shared memory"):
        inbox_cuda.build_inbox(n, 1 << 16, *t)
    assert inbox_cuda.build_inbox.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    n, g, m, slots, p_ok, spread = case
    t = [torch.from_numpy(a).cuda() for a in _case(23, n, g, m, p_ok, spread)]
    before = inbox_cuda.build_inbox.launches
    got = inbox_cuda.build_inbox(n, slots, *t)
    ref = inbox_cuda.build_inbox_plain(n, slots, *t)
    torch.cuda.synchronize()
    assert inbox_cuda.build_inbox.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
