"""Exponential backoff iterator with jitter.

The port's copy of `corrosion_tpu/runtime/backoff.py`.

Counterpart of `klukai-types/src/backoff.rs:7-149` (a vendored
exponential-backoff crate): an iterator yielding sleep durations that grow
by `factor` from `min_interval` up to `max_interval`, each multiplied by a
random jitter in [1-jitter, 1+jitter]. `retries=None` yields forever —
the reference's sync loop uses `.iter()` endlessly with 1–15 s bounds
(`klukai-agent/src/agent/util.rs:359-405`).

r9 adds `mode="full"` — AWS-style FULL jitter: each yield is uniform in
[0, min(base, max_interval)] while the base still grows exponentially.
Multiplicative jitter keeps retriers loosely synchronized (every client
sleeps ≈ the same base ± 30%); full jitter spreads them over the whole
window, which is what breaks the rejoin/announce storm after a partition
heal — every healed node's backoff otherwise fires in the same beat
(the thundering-herd analysis in the AWS architecture blog's
"Exponential Backoff And Jitter").
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class Backoff:
    min_interval: float = 1.0
    max_interval: float = 15.0
    factor: float = 2.0
    jitter: float = 0.3
    retries: Optional[int] = None
    mode: str = "equal"  # "equal" (multiplicative ±jitter) | "full"
    # (uniform in [0, base] — use for fleet-synchronized retry storms)
    _rng: Optional[random.Random] = None

    def with_seed(self, seed: int) -> "Backoff":
        self._rng = random.Random(seed)
        return self

    def iter(self) -> Iterator[float]:
        if self.mode not in ("equal", "full"):
            raise ValueError(f"unknown backoff mode {self.mode!r}")
        rng = self._rng or random
        base = self.min_interval
        n = 0
        while self.retries is None or n < self.retries:
            if self.mode == "full":
                yield rng.random() * min(base, self.max_interval)
            else:
                jit = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
                yield min(base * jit, self.max_interval)
            base = min(base * self.factor, self.max_interval)
            n += 1

    def __iter__(self) -> Iterator[float]:
        return self.iter()
