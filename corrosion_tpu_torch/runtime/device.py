"""Device selection for the PyTorch port (the counterpart of
`corrosion_tpu/runtime/jaxenv.py`).

There is one rule: the port runs on the card. `resolve_device()` with no
argument returns `cuda:0` and raises when CUDA is missing; the CPU is
taken only when a caller asks for it by name (the CPU tests do). Nothing
here probes plugins or falls back to another backend. `sync` waits for
the card before a wall clock is read; `card_line` names the card and its
power limit beside a measurement.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: `cuda:0` by default (raises
    RuntimeError without CUDA), or exactly the device the caller names."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default;"
                " pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda:0")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def card_line(dev: torch.device) -> dict:
    """The card's name and power limit in W, from `nvidia-smi`; None on
    the CPU."""
    if dev.type != "cuda":
        return {"device_kind": None, "power_limit_w": None}
    name, limit = (s.strip() for s in nvidia_smi().rsplit(",", 1))
    return {"device_kind": name, "power_limit_w": float(limit.split()[0])}
