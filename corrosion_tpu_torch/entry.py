"""The single-step entry point: the counterpart of the JAX package's
`__graft_entry__.py::entry()`.

    fn, (state, key) = entry()
    state = fn(state, key)

`entry()` returns one dense SWIM protocol period over a 1,024-member
cluster (`ops.swim.tick_impl`) and its example arguments: the state booted
from key `PRNGKey(0)` and the tick key `PRNGKey(1)`. It runs on `cuda:0`
(raising without CUDA) or on the device the caller names. The tick
updates the state's view in place, so each state is passed to `fn` once.
"""

from __future__ import annotations

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops import swim
from corrosion_tpu_torch.runtime.device import resolve_device


def entry(device=None):
    """(fn, (state, key)): one tick of the flagship model on `device`."""
    dev = resolve_device(device)
    params = swim.SwimParams(n=1024)
    state = swim.init_state(params, jr.PRNGKey(0), device=dev)

    def fn(state, key):
        return swim.tick_impl(state, key, params)

    return fn, (state, jr.PRNGKey(1))
