"""Store-layer fault injection + the process-global chaos census.

The port's copy of `corrosion_tpu/chaos/faults.py`.

The network layer has had per-node fault knobs since r9
(`net/mem.py degrade()/partition()`); this module adds the layer no
bench had ever simulated — the DISK.  `StoreFaults` is an injectable
profile a `CrdtStore` consults at its three writer-thread touch points:

- per writer statement (`on_statement`): transient ``SQLITE_BUSY`` —
  the sick disk / lock-contention pathology.  Raised inside one
  writer's sub-transaction of a group commit, it must abort ONLY that
  writer (savepoint isolation) and leave the store writable.
- at COMMIT (`on_commit`): added fsync/commit latency (the slow disk)
  and a transient ``disk I/O error`` that aborts the whole shared
  transaction — the path every writer in the group must surface as a
  typed error, never a hang.
- at remote apply (`on_apply`): the same latency on the ingest path,
  so a slow-disk node lags the cluster instead of just its own clients.

Faults run ON the worker thread that owns the sqlite connection
(`time.sleep` is correct there), and the injector costs one attribute
check when absent (`store.chaos is None` — the default).

`ChaosCensus` is the operator's drill-vs-outage discriminator: the
`ChaosEngine` registers every active injection here and `/v1/status`
serves it, so a node reporting elevated p99s alongside a populated
chaos census is a drill, not a page.  Process-global like the flight
recorder (`runtime/records.FLIGHT`) — an in-process devcluster shares
one census, and a production deployment runs one agent per process.
"""

from __future__ import annotations

import random
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS


@dataclass
class StoreFaults:
    """One node's injected disk pathology (all rates in [0, 1])."""

    commit_latency_secs: float = 0.0  # slow disk: added to every COMMIT
    statement_busy_rate: float = 0.0  # sick disk: SQLITE_BUSY per statement
    commit_io_error_rate: float = 0.0  # sick disk: I/O error at COMMIT
    apply_latency_secs: float = 0.0  # slow disk on the remote-apply path
    seed: int = 0
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        # own RNG: deterministic per scenario seed, and never contended
        # with the network layer's
        self._rng = random.Random(self.seed)

    def on_statement(self) -> None:
        """Writer-statement touch point (WriteTx.execute/executemany)."""
        if (
            self.statement_busy_rate
            and self._rng.random() < self.statement_busy_rate
        ):
            METRICS.counter(
                "corro.chaos.store.faults.total", kind="busy"
            ).inc()
            raise sqlite3.OperationalError(
                "database is locked [chaos-injected]"
            )

    def on_commit(self) -> None:
        """COMMIT touch point (group_tx leader / solo WriteTx.commit)."""
        if self.commit_latency_secs:
            METRICS.counter(
                "corro.chaos.store.faults.total", kind="latency"
            ).inc()
            time.sleep(self.commit_latency_secs)
        if (
            self.commit_io_error_rate
            and self._rng.random() < self.commit_io_error_rate
        ):
            METRICS.counter("corro.chaos.store.faults.total", kind="io").inc()
            raise sqlite3.OperationalError("disk I/O error [chaos-injected]")

    def on_apply(self) -> None:
        """Remote-apply touch point (CrdtStore.apply_changes)."""
        if self.apply_latency_secs:
            METRICS.counter(
                "corro.chaos.store.faults.total", kind="apply"
            ).inc()
            time.sleep(self.apply_latency_secs)


class ChaosCensus:
    """Active-injection registry behind /v1/status's ``chaos`` block.

    Thread contract: mutated by the ChaosEngine (event loop) and by
    scenario driver tasks; read by HTTP handlers and worker threads —
    every access is under the lock and reads return copies."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scenario: Optional[str] = None
        self._injections: Dict[str, str] = {}  # injection id -> summary
        self._since: Optional[float] = None

    def begin(self, scenario: str) -> None:
        with self._lock:
            self._scenario = scenario
            self._since = time.time()

    def add(self, inj_id: str, summary: str, layer: str) -> None:
        with self._lock:
            self._injections[inj_id] = summary
            n = len(self._injections)
        METRICS.counter("corro.chaos.injected.total", layer=layer).inc()
        METRICS.gauge("corro.chaos.injections.active").set(n)

    def remove(self, inj_id: str) -> None:
        with self._lock:
            self._injections.pop(inj_id, None)
            n = len(self._injections)
        METRICS.gauge("corro.chaos.injections.active").set(n)

    def end(self) -> None:
        with self._lock:
            self._scenario = None
            self._since = None
            self._injections.clear()
        METRICS.counter("corro.chaos.restored.total").inc()
        METRICS.gauge("corro.chaos.injections.active").set(0)

    def snapshot(self) -> dict:
        """The /v1/status block: is a drill running, which, what's hurt."""
        with self._lock:
            return {
                "active": bool(self._injections) or self._scenario is not None,
                "scenario": self._scenario,
                "since": self._since,
                "injections": dict(self._injections),
            }


CENSUS = ChaosCensus()
