"""The flight recorder: the port's counterpart of the host half of
`corrosion_tpu/runtime/records.py`.

Both SWIM kernels keep a device flight ring, `[ring_ticks,
N_FLIGHT_LANES]` int32: row t % ring_ticks holds tick t's event deltas
and census. The simulation drivers drain it beside their stats readback
and hand the snapshot to `FLIGHT.record_ring`, which stitches the new
frames into a bounded history stamped with the drain's wall clock.
`FLIGHT` is process-global, like `runtime.metrics.METRICS`; every method
takes the instance lock, since sims publish from whatever thread steps
them.

`merge_records` is the measurement scripts' replace-by-key merge of
records into a shared JSON list file, serialized across processes by a
sidecar `flock`.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from corrosion_tpu_torch.runtime.metrics import (
    FLIGHT_CENSUS,
    FLIGHT_LANES,
    KERNEL_EVENTS,
    METRICS,
    Registry,
)


def merge_records(
    path: str, records: Sequence[dict], key: str = "rung"
) -> List[dict]:
    """Replace-by-``key`` merge of ``records`` into the JSON list at
    ``path`` (existing records whose key value is re-measured are
    dropped; everything else is preserved). Returns the merged list.

    Every new record must carry ``key``: a keyless record would otherwise
    match (and delete) unrelated keyless entries, so it raises instead.
    The read-merge-write holds an exclusive ``flock`` on the sidecar
    ``<path>.lock`` (a lock on the file itself would not survive the
    ``os.replace``), so two processes recording at once keep both's
    records."""
    missing = [r for r in records if key not in r]
    if missing:
        raise KeyError(
            f"record(s) missing merge key {key!r}: {missing[:2]!r}"
        )
    with open(path + ".lock", "a") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = []
        mine = {r[key] for r in records}
        merged = [
            r for r in existing if not (key in r and r[key] in mine)
        ] + list(records)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=2)
        os.replace(tmp, path)
    return merged


def frames_from_ring(ring, t: int):
    """Yield (tick, row) for the live rows of a drained ring: row j of an
    [R, L] ring holds the frame of the largest tick < t that is j mod R,
    so ticks [max(0, t - R), t) are live."""
    r = ring.shape[0] if hasattr(ring, "shape") else len(ring)
    for tick in range(max(0, int(t) - r), int(t)):
        yield tick, ring[tick % r]


def _frame_dict(kernel: str, tick: int, wall: float, row) -> dict:
    """One JSON-ready frame: event deltas and census lanes by name."""
    vals = [int(v) for v in row]
    n_ev = len(KERNEL_EVENTS)
    return {
        "kernel": kernel,
        "tick": tick,
        "wall": wall,
        "events": dict(zip(KERNEL_EVENTS, vals[:n_ev])),
        "census": dict(zip(FLIGHT_CENSUS, vals[n_ev:])),
    }


class FlightRecorder:
    """Bounded wall-clock-stamped history of per-tick flight frames."""

    def __init__(self, capacity: int = 4096):
        self._frames: deque = deque(maxlen=capacity)
        self._host_tick: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._incident_seq = 0

    def record_ring(self, kernel: str, drain, since: int = 0,
                    registry: Registry = METRICS) -> int:
        """Append the frames of a drained ring (a `FlightDrain`) for ticks
        >= `since`, the caller's cursor (each sim keeps its own, so sims
        of one kernel can share the recorder); returns how many. Ticks
        the ring overwrote before any drain saw them are counted in
        `corro.flight.frames.dropped`."""
        ring, t = drain.ring, int(drain.t)
        wall = time.time()
        since = max(0, int(since))
        if t <= since:
            return 0
        r = ring.shape[0] if hasattr(ring, "shape") else len(ring)
        lo = max(since, t - r)
        added = 0
        with self._lock:
            for tick, row in frames_from_ring(ring, t):
                if tick >= lo:
                    self._frames.append(_frame_dict(kernel, tick, wall, row))
                    added += 1
        if added:
            registry.counter("corro.flight.frames.total",
                             kernel=kernel).inc(added)
        if lo > since:
            registry.counter("corro.flight.frames.dropped",
                             kernel=kernel).inc(lo - since)
        return added

    def record_host_frame(self, kernel: str, events: Dict[str, int],
                          registry: Registry = METRICS) -> None:
        """Append one host-side frame (a kernel with no protocol period:
        `tick` counts its batches)."""
        wall = time.time()
        with self._lock:
            tick = self._host_tick.get(kernel, 0)
            self._host_tick[kernel] = tick + 1
            self._frames.append({
                "kernel": kernel,
                "tick": tick,
                "wall": wall,
                "events": {k: int(v) for k, v in events.items()},
                "census": {},
            })
        registry.counter("corro.flight.frames.total", kernel=kernel).inc()

    def window(self, k: int, kernel: Optional[str] = None) -> List[dict]:
        """The last `k` frames in record order (optionally one kernel's)."""
        with self._lock:
            frames = list(self._frames)
        if kernel is not None:
            frames = [f for f in frames if f["kernel"] == kernel]
        return frames[-max(0, int(k)):]

    def snapshot_incident(self, reason: str, path: Optional[str] = None,
                          registry: Registry = METRICS,
                          extra: Optional[dict] = None) -> Optional[str]:
        """Write the whole frame history to a JSON file and return its path
        (None when there is nothing to dump or the write fails: callers
        are abnormal-exit paths, so this never raises). Without `path`
        the file goes to $CORRO_FLIGHT_DIR, else `corrosion_flight/` in
        the temp dir, under a sequence that wraps at 16 per process."""
        with self._lock:
            frames = list(self._frames)
            seq = self._incident_seq
            self._incident_seq += 1
        if not frames:
            return None
        record = {
            "reason": reason,
            "wall": time.time(),
            "pid": os.getpid(),
            "lanes": list(FLIGHT_LANES),
            "frames": frames,
        }
        if extra:
            record.update(extra)
        try:
            if path is None:
                d = os.environ.get("CORRO_FLIGHT_DIR") or os.path.join(
                    tempfile.gettempdir(), "corrosion_flight")
                os.makedirs(d, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in reason)[:48]
                path = os.path.join(d, f"flight_incident_{os.getpid()}_"
                                       f"{seq % 16:02d}_{safe}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except OSError:
            return None
        registry.counter("corro.flight.incidents.total").inc()
        return path


FLIGHT = FlightRecorder()
