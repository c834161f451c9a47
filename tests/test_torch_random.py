"""The port's threefry (`corrosion_tpu_torch.random`) is bit-equal to
`jax.random` for every call the SWIM tick makes: PRNGKey, split (2 and k),
fold_in, randint (int32, [lo, hi), the tick's ranges with
non-power-of-two n) and uniform (float32)."""

import jax
import numpy as np
import pytest

from corrosion_tpu_torch import random as jr


def _key(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


def _as_tuple(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prngkey_split_fold_in(seed):
    jk, tk = _key(seed)
    assert _as_tuple(jk) == tk
    for num in (2, 5, 70):
        assert [_as_tuple(k) for k in jax.random.split(jk, num)] == \
            jr.split(tk, num)
    for data in (0, 7, 7919, 65537, 104729 + 3, 2**32 - 1):
        assert _as_tuple(jax.random.fold_in(jk, data)) == jr.fold_in(tk, data)
    # chains: split of a fold_in of a split, as the tick derives its keys
    j2 = jax.random.fold_in(jax.random.split(jk, 5)[3], 65537)
    t2 = jr.fold_in(jr.split(tk, 5)[3], 65537)
    assert _as_tuple(j2) == t2


@pytest.mark.parametrize(
    "shape,lo,hi",
    [
        ((100, 4), 1, 100),  # probe candidates, n=100
        ((100, 2), 1, 4),  # ring fallback offsets
        ((64, 3), 0, 64),  # indirect-probe helpers
        ((2,), 1, 10_000),  # shift offsets at the slice's n
        ((37, 1), 0, 9_999),  # anti-entropy subjects, odd n
        ((5, 7), 3, 3),  # empty range returns minval
        # spans past 2^16, where the reference's uint32 multiplier wraps
        ((2,), 1, 262_144),  # shift offsets at the pview slice's n
        ((50, 3), 0, 100_003),  # helpers, odd n past 2^16
        ((40, 3), 0, 262_144),  # helpers, a power of two past 2^16
    ],
)
def test_randint_bit_equal(shape, lo, hi):
    for seed in (0, 3, 99):
        jk, tk = _key(seed)
        ref = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = jr.randint(tk, shape, lo, hi, "cpu").numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1,), (64, 4), (100, 2, 10), (33, 5)])
def test_uniform_bit_equal(shape):
    for seed in (0, 5):
        jk, tk = _key(seed)
        ref = np.asarray(jax.random.uniform(jk, shape))
        got = jr.uniform(tk, shape, "cpu").numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        jr.PRNGKey(-1)
