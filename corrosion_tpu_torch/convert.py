"""Carrying state across from the JAX package, through numpy.

The JAX side hands over `np.asarray` of each field, so nothing here
imports JAX: the reference's `SwimState` or `PViewState` becomes a dict
of numpy arrays with the same field names, a key becomes a [2] uint32
array, and `SwimParams` or `PViewParams` becomes its `_asdict()`. The
CRDT merge engine has no weights and no state on the device: what it
carries across is the reference `_merge_kernel`'s inputs, the thirteen
row arrays and two segment counts. The store's state is its database
file, which either package opens; its inputs are changes, which
`changes_to_port` carries across field by field.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.ops.swim import SwimParams, SwimState
from corrosion_tpu_torch.ops.swim_pview import PViewParams, PViewState
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import Change


def _state_from_numpy(cls, fields: Dict[str, np.ndarray], device):
    missing = set(cls._fields) - set(fields)
    extra = set(fields) - set(cls._fields)
    if missing or extra:
        raise ValueError(f"state fields differ: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    dev = resolve_device(device)
    return cls(**{
        name: torch.from_numpy(np.array(fields[name], copy=True)).to(dev)
        for name in cls._fields
    })


def _state_to_numpy(state) -> Dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy()
            for name in state._fields}


def swim_state_from_numpy(fields: Dict[str, np.ndarray], device) -> SwimState:
    """A `SwimState` on `device` from numpy arrays keyed by field name
    (dtypes kept: bool, int16, int32, float32)."""
    return _state_from_numpy(SwimState, fields, device)


def swim_state_to_numpy(state: SwimState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays on the host."""
    return _state_to_numpy(state)


def pview_state_from_numpy(fields: Dict[str, np.ndarray],
                           device) -> PViewState:
    """A `PViewState` on `device` from numpy arrays keyed by field name."""
    return _state_from_numpy(PViewState, fields, device)


def pview_state_to_numpy(state: PViewState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays on the host."""
    return _state_to_numpy(state)


def key_from_numpy(key: np.ndarray) -> jr.Key:
    """A port key from a [2] uint32 array (`np.asarray(jax_key)`)."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"need a [2] uint32 key, got {k.shape} {k.dtype}")
    return (int(k[0]), int(k[1]))


def _port_params(d: dict) -> dict:
    d = dict(d)
    if d.get("inbox_impl") == "pallas":
        d["inbox_impl"] = "cuda"
    return d


def params_from_dict(d: dict) -> SwimParams:
    """`SwimParams` from the reference's `_asdict()`; its
    `inbox_impl="pallas"` becomes the port's "cuda"."""
    return SwimParams(**_port_params(d))


def pview_params_from_dict(d: dict) -> PViewParams:
    """`PViewParams` from the reference's `_asdict()`, with "pallas"
    becoming "cuda" as in `params_from_dict`."""
    return PViewParams(**_port_params(d))


# The row inputs of `ops/crdt_merge.py::_merge_kernel`, in its order.
CRDT_INPUTS = ("grp", "cellg", "cl", "cv", "d0", "d1", "d2", "d3", "exact",
               "fake", "pos", "is_sent", "valid")
_CRDT_BOOL = frozenset(("exact", "fake", "is_sent", "valid"))


def crdt_inputs_to_torch(arrays, device) -> dict:
    """The keyword arguments of `ops.crdt_merge._merge_kernel` on `device`
    from the reference `_merge_kernel`'s inputs: `arrays` maps each name
    of `CRDT_INPUTS` to a 1-D numpy array (all of one length; bool for
    exact, fake, is_sent and valid, int32 for the rest) and holds
    `num_groups` and `num_cells`. One host-to-device copy per array."""
    want = set(CRDT_INPUTS) | {"num_groups", "num_cells"}
    if set(arrays) != want:
        raise ValueError(f"crdt inputs differ: missing "
                         f"{sorted(want - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - want)}")
    dev = resolve_device(device)
    n = len(arrays["grp"])
    out = {}
    for name in CRDT_INPUTS:
        a = arrays[name]
        dtype = np.bool_ if name in _CRDT_BOOL else np.int32
        if not isinstance(a, np.ndarray) or a.dtype != dtype \
                or a.shape != (n,):
            raise ValueError(f"crdt input {name}: need a [{n}] "
                             f"{np.dtype(dtype)} array")
        out[name] = torch.from_numpy(a).to(dev)
    out["num_groups"] = int(arrays["num_groups"])
    out["num_cells"] = int(arrays["num_cells"])
    return out


def change_to_port(ch) -> Change:
    """The port's `Change` from any object with the reference `Change`'s
    fields (table, pk, cid, val, col_version, db_version, seq, site_id,
    cl, and ts with `ntp64`). The cached wire bytes are not carried: the
    port's codec re-encodes them to the same bytes."""
    return Change(
        table=ch.table, pk=bytes(ch.pk), cid=ch.cid, val=ch.val,
        col_version=ch.col_version, db_version=ch.db_version, seq=ch.seq,
        site_id=bytes(ch.site_id), cl=ch.cl, ts=Timestamp(ch.ts.ntp64),
    )


def changes_to_port(chs) -> list:
    """`change_to_port` of each change, in order."""
    return [change_to_port(ch) for ch in chs]
