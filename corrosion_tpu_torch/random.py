"""Bit-exact threefry2x32 counterpart of the `jax.random` calls the SWIM
tick makes.

The JAX tick draws its randomness inside itself, so the only way to hold
the port's tick against it bit for bit is to reproduce those bits. This
module follows jax 0.9's algorithms with `jax_threefry_partitionable=True`
(`jax/_src/prng.py`: `threefry_seed`, `_threefry_split_foldlike`,
`_threefry_fold_in`, `_threefry_random_bits_partitionable`;
`jax/_src/random.py`: `_randint`, `_uniform`).

A key is a pair of uint32 words held as Python ints on the host, so
`split` and `fold_in` cost no device work and no sync. Random bits are
computed on the device from 64-bit counters (`iota_2x32_shape`). torch's
uint32 support is partial, so device arithmetic runs in int64 and every
step masks back to 32 bits.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds on (x0, x1). Works on Python ints and
    on int64 tensors holding values in [0, 2^32) alike."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a non-negative int32 seed."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return (0, seed)


def split(key: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(key, num)` as a list of `num` host keys."""
    k0, k1 = key
    return [
        _threefry2x32(k0, k1, (i >> 32) & _M32, i & _M32) for i in range(num)
    ]


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32)


def random_bits(key: Key, size: int, device) -> torch.Tensor:
    """[size] int64 tensor of 32 random bits each: the flat counters
    0..size-1 of `_random_bits(key, 32, shape)` for any shape of that size."""
    c = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(key[0], key[1], c >> 32, c & _M32)
    return b0 ^ b1


def randint_planes(key: Key, size: int, device):
    """The two bit planes `_randint` draws: split the key, then 32 bits
    from each half over the same counters."""
    k1, k2 = split(key)
    return random_bits(k1, size, device), random_bits(k2, size, device)


def randint_from_planes(higher, lower, minval: int,
                        maxval: int) -> torch.Tensor:
    """`_randint`'s modulus reduction of two uint32 planes to int32 values
    in [minval, maxval), with its uint32 wraparound emulated in int64."""
    span = maxval - minval if maxval > minval else 1
    # the reference squares 2^16 % span in uint32, so for spans past 2^16
    # the square wraps (to 0)
    multiplier = (((2**16 % span) ** 2) & _M32) % span
    off = ((higher % span) * multiplier) & _M32
    off = ((off + lower % span) & _M32) % span
    return (off + minval).to(torch.int32)


def randint(key: Key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32) for int32
    bounds."""
    shape = tuple(shape)
    hi, lo = randint_planes(key, math.prod(shape), device)
    return randint_from_planes(hi, lo, int(minval), int(maxval)).reshape(shape)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    shape = tuple(shape)
    bits = random_bits(key, math.prod(shape), device)
    # 23 mantissa bits under the exponent of 1.0, then subtract 1.0
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(shape)
