"""The NTP64 timestamp of an actor's identity: the port's copy of
`Timestamp` from `corrosion_tpu/types/base.py` (the hybrid logical
clock `HLClock` is not ported: nothing on the bridge path stamps
changes)."""

from __future__ import annotations

import time
from dataclasses import dataclass

_FRAC = 1 << 32  # NTP64: upper 32 bits = seconds, lower 32 = fraction


@dataclass(frozen=True, order=True)
class Timestamp:
    """NTP64 timestamp (uhlc-compatible): u64 = secs<<32 | frac."""

    ntp64: int = 0

    @classmethod
    def from_unix(cls, secs: float) -> "Timestamp":
        whole = int(secs)
        frac = int((secs - whole) * _FRAC) & 0xFFFFFFFF
        return cls((whole << 32) | frac)

    @classmethod
    def now(cls) -> "Timestamp":
        return cls.from_unix(time.time())

    @classmethod
    def zero(cls) -> "Timestamp":
        return cls(0)
