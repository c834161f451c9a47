"""Base newtypes and the hybrid logical clock: the port's copy of
`corrosion_tpu/types/base.py`.

Counterparts of the reference's `klukai-types/src/base.rs` (CrsqlDbVersion /
CrsqlSeq u64 newtypes) and its uhlc-based HLC (`Timestamp` NTP64 wrapper,
`klukai-types/src/broadcast.rs:383`). We keep versions/seqs as plain ints at
API boundaries (Python ints are arbitrary precision; wire codecs clamp to
u64) and provide a compact HLC with the same 300 ms max-delta semantics
(`klukai-agent/src/agent/setup.rs:101-106`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

# Versions and sequences are plain non-negative ints on the Python side.
DbVersion = int
Seq = int

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

    def is_zero(self) -> bool:
        return self.ntp64 == 0

    @property
    def secs(self) -> int:
        return self.ntp64 >> 32

    @property
    def subsec_nanos(self) -> int:
        return ((self.ntp64 & 0xFFFFFFFF) * 1_000_000_000) >> 32

    def to_unix(self) -> float:
        return self.secs + (self.ntp64 & 0xFFFFFFFF) / _FRAC

    def __str__(self) -> str:  # humantime-ish, for logs
        return f"{self.to_unix():.6f}"


class HLClock:
    """Hybrid logical clock over NTP64 timestamps.

    Mirrors uhlc behavior used by the reference: timestamps are monotonic,
    `update_with_timestamp` refuses (but records) peer timestamps further
    than `max_delta` in the future, matching the 300 ms configured at
    `klukai-agent/src/agent/setup.rs:101-106`.
    """

    def __init__(self, max_delta_ms: int = 300):
        self._last = 0
        self._max_delta = (max_delta_ms << 32) // 1000
        self._lock = threading.Lock()

    def new_timestamp(self) -> Timestamp:
        with self._lock:
            now = Timestamp.now().ntp64
            self._last = max(self._last + 1, now)
            return Timestamp(self._last)

    def update_with_timestamp(self, ts: Timestamp) -> bool:
        """Merge a peer timestamp. Returns False if rejected (too far ahead)."""
        with self._lock:
            now = Timestamp.now().ntp64
            if ts.ntp64 > now + self._max_delta:
                return False
            self._last = max(self._last, ts.ntp64)
            return True

    def peek(self) -> Timestamp:
        with self._lock:
            return Timestamp(self._last)
