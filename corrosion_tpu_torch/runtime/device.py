"""Device selection for the PyTorch port (the counterpart of
`corrosion_tpu/runtime/jaxenv.py`).

There is one rule: the port runs on the card. `resolve_device()` with no
argument returns `cuda:0` and raises when CUDA is missing; the CPU is
taken only when a caller asks for it by name (the CPU tests do). Nothing
here probes plugins or falls back to another backend.
"""

from __future__ import annotations

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
