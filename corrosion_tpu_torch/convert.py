"""Carrying state across from the JAX package, through numpy.

The JAX side hands over `np.asarray` of each field, so nothing here
imports JAX: the reference's `SwimState` becomes a dict of numpy arrays
with the same field names, a key becomes a [2] uint32 array, and
`SwimParams` becomes its `_asdict()`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops.swim import SwimParams, SwimState
from corrosion_tpu_torch.runtime.device import resolve_device


def swim_state_from_numpy(fields: Dict[str, np.ndarray], device) -> SwimState:
    """A `SwimState` on `device` from numpy arrays keyed by field name
    (dtypes kept: bool, int16, int32, float32)."""
    missing = set(SwimState._fields) - set(fields)
    extra = set(fields) - set(SwimState._fields)
    if missing or extra:
        raise ValueError(f"state fields differ: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    dev = resolve_device(device)
    return SwimState(**{
        name: torch.from_numpy(np.array(fields[name], copy=True)).to(dev)
        for name in SwimState._fields
    })


def swim_state_to_numpy(state: SwimState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays on the host."""
    return {name: getattr(state, name).cpu().numpy()
            for name in SwimState._fields}


def key_from_numpy(key: np.ndarray) -> jr.Key:
    """A port key from a [2] uint32 array (`np.asarray(jax_key)`)."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"need a [2] uint32 key, got {k.shape} {k.dtype}")
    return (int(k[0]), int(k[1]))


def params_from_dict(d: dict) -> SwimParams:
    """`SwimParams` from the reference's `_asdict()`; its
    `inbox_impl="pallas"` becomes the port's "cuda"."""
    d = dict(d)
    if d.get("inbox_impl") == "pallas":
        d["inbox_impl"] = "cuda"
    return SwimParams(**d)
