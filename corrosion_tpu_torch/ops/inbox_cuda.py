"""The gossip-inbox build on Hopper: the counterpart of
`corrosion_tpu/ops/inbox_pallas.py`.

`build_inbox` is the wrapper of the hand-written kernel `csrc/inbox.cu`:
for CUDA tensors it checks device, dtype, shape and contiguity, allocates
the two outputs (the kernel needs no scratch), makes one launch on the
current stream, raises if the launch status is not 0 (a ValueError where
the kernel does not take the shape: one destination's list of `slots` ids
must fit in a block's shared memory), and counts the launch in
`build_inbox.launches`.
For CPU tensors it returns `build_inbox_plain`, the plain PyTorch version
of the same function, because a CPU tensor cannot reach the kernel. There
is no fallback from the kernel to the plain version.

Contract (the reference's): dst_g [G] int32 in [0, n), subj/key [G, m]
int32, ok [G, m] bool; returns ([n, slots] subj with n for empty,
[n, slots] key with 0 for empty). Each destination receives its first
`slots` valid messages in group-major order; the rest are dropped.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from corrosion_tpu_torch.ops import _build


def build_inbox_plain(n: int, slots: int, dst_g: torch.Tensor,
                      subj: torch.Tensor, key: torch.Tensor,
                      ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. A message's column is the
    number of valid messages in earlier packets to the same destination
    (a global running count in destination-then-packet order, minus the
    count before the destination's segment) plus its valid prefix within
    its own packet."""
    dev = dst_g.device
    valid = (dst_g >= 0) & (dst_g < n)
    ok = ok & valid[:, None]
    okl = ok.to(torch.int64)
    cnt = okl.sum(dim=1)
    pos = torch.cumsum(okl, dim=1) - okl
    d = torch.where(valid, dst_g, n).to(torch.int64)
    order = torch.sort(d, stable=True).indices
    cnt_o = cnt[order]
    run_before = torch.cumsum(cnt_o, dim=0) - cnt_o
    per_dst = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    per_dst.index_add_(0, d, cnt)
    seg_before = torch.cumsum(per_dst, dim=0) - per_dst
    base = torch.empty_like(cnt)
    base[order] = run_before - seg_before[d[order]]
    col = base[:, None] + pos
    keep = ok & (col < slots)
    cell = torch.where(keep, d[:, None] * slots + col, n * slots)
    out_s = torch.full((n * slots + 1,), n, dtype=torch.int32, device=dev)
    out_k = torch.zeros((n * slots + 1,), dtype=torch.int32, device=dev)
    out_s.scatter_(0, cell.reshape(-1),
                   torch.where(keep, torch.clamp(subj, max=n), n).reshape(-1))
    out_k.scatter_(0, cell.reshape(-1),
                   torch.where(keep, torch.clamp(key, min=0), 0).reshape(-1))
    return out_s[:-1].reshape(n, slots), out_k[:-1].reshape(n, slots)


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


@functools.cache
def _kernel():
    """The kernel's C entry point, its ctypes signature set once, at load."""
    fn = _build.load("inbox").inbox_build
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"build_inbox: {name} is on {x.device}, dst_g on "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"build_inbox: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"build_inbox: {name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"build_inbox: {name} must be contiguous")


def build_inbox(n: int, slots: int, dst_g: torch.Tensor, subj: torch.Tensor,
                key: torch.Tensor, ok: torch.Tensor):
    """The inbox build: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring)."""
    if dst_g.device.type == "cpu":
        return build_inbox_plain(n, slots, dst_g, subj, key, ok)
    if n <= 0 or slots <= 0:
        raise ValueError(f"build_inbox: need n > 0 and slots > 0, got {n}, "
                         f"{slots}")
    g, m = subj.shape
    if n >= 2**31 or g * (m + 1) >= 2**31 - 1:
        raise ValueError(f"build_inbox: need n < 2**31 and G * (m + 1) < "
                         f"2**31 - 1 (the kernel packs a packet id and a count "
                         f"in an int32), got n={n}, G={g}, m={m}")
    if dst_g.device.type != "cuda":
        raise ValueError(f"build_inbox: unsupported device {dst_g.device}")
    dev = dst_g.device
    _check("dst_g", dst_g, torch.int32, (g,), dev)
    _check("subj", subj, torch.int32, (g, m), dev)
    _check("key", key, torch.int32, (g, m), dev)
    _check("ok", ok, torch.bool, (g, m), dev)
    launch = _kernel()
    out_subj = torch.empty((n, slots), dtype=torch.int32, device=dev)
    out_key = torch.empty((n, slots), dtype=torch.int32, device=dev)
    status = launch(
        dst_g.data_ptr(), subj.data_ptr(), key.data_ptr(), ok.data_ptr(),
        out_subj.data_ptr(), out_key.data_ptr(), g, m, n, slots,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if status == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"build_inbox: slots={slots} does not fit: one "
                         f"destination's list of {slots} ids must fit in a "
                         f"block's shared memory")
    if status != 0:
        raise RuntimeError(f"inbox_build kernel launch failed: CUDA error "
                           f"{status}")
    build_inbox.launches += 1
    return out_subj, out_key


build_inbox.launches = 0  # kernel launches since the last reset
