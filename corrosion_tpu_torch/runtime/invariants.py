"""Always/sometimes invariant hooks woven through production code.

Counterpart of the reference's Antithesis SDK usage (SURVEY §4): the
reference sprinkles `assert_always!` (invariants that must hold on every
evaluation), `assert_sometimes!` (coverage markers that must fire at
least once under a thorough workload) and `assert_unreachable!` through
production paths — e.g. gap deletion effective (`agent.rs:1144`),
contiguous seq ranges (`util.rs:1170`), locks held < 60 s
(`setup.rs:231`), "Corrosion syncs with other nodes"
(`handlers.rs:840`). They are inert in CI and evaluated under the
deterministic-hypervisor environment.

Here the same three primitives are driven by `CORRO_INVARIANTS`:

  off     — zero work beyond a truthiness check (production default)
  log     — violations log + count via METRICS (the CI default: the
            test suite runs with invariants observable)
  strict  — violations raise InvariantViolation (chaos/soak harnesses)

`sometimes_registry()` exposes which coverage markers have fired, so a
soak test can assert the workload actually exercised the paths it
claims to (the Antithesis "sometimes" contract).

The port's copy of `corrosion_tpu/runtime/invariants.py`.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

logger = logging.getLogger(__name__)

_MODE_ENV = "CORRO_INVARIANTS"


class InvariantViolation(AssertionError):
    pass


_lock = threading.Lock()
_sometimes: Dict[str, int] = {}


def _mode() -> str:
    return os.environ.get(_MODE_ENV, "off")


def enabled() -> bool:
    """Fast-path guard for call sites whose CONDITION is expensive to
    compute: `if invariants.enabled(): assert_always(costly(), ...)`.
    Off mode (the production default) then costs one env lookup."""
    return _mode() != "off"


def assert_always(
    condition: bool, name: str, details: Optional[dict] = None
) -> bool:
    """The property must hold on EVERY evaluation (assert_always!)."""
    if condition:
        return True
    mode = _mode()
    if mode == "off":
        return False
    METRICS.counter("corro.invariant.violated", invariant=name).inc()
    logger.error("invariant violated: %s %s", name, details or {})
    if mode == "strict":
        # chaos trip: before the violation kills the harness, dump the
        # flight recorder's per-tick history — the black box a post-
        # mortem replays the churn/suspicion timeline from (best-effort,
        # a second failure must not mask the invariant itself)
        try:
            from corrosion_tpu_torch.runtime.records import FLIGHT

            FLIGHT.snapshot_incident(f"invariant:{name}")
        except Exception:  # pragma: no cover - diagnostics never mask
            pass
        raise InvariantViolation(f"{name}: {details or {}}")
    return False


def assert_sometimes(name: str, condition: bool = True) -> None:
    """Coverage marker: a thorough workload must reach this at least
    once (assert_sometimes!). Cheap enough to leave on everywhere."""
    if not condition:
        return
    with _lock:
        _sometimes[name] = _sometimes.get(name, 0) + 1
    if _mode() != "off":
        METRICS.counter("corro.invariant.sometimes", invariant=name).inc()


def assert_unreachable(name: str, details: Optional[dict] = None) -> None:
    """This line must never execute (assert_unreachable!)."""
    assert_always(False, f"unreachable:{name}", details)


def sometimes_registry() -> Dict[str, int]:
    """Snapshot of fired coverage markers (name → count)."""
    with _lock:
        return dict(_sometimes)


def reset_sometimes() -> None:
    with _lock:
        _sometimes.clear()
