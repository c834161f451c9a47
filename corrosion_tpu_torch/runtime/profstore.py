"""Profile store: the bounded ring of per-window folded-stack maps the
continuous profiler (runtime/profiler.py, r23) aggregates into — the
TSDB ring discipline (r20) applied to stacks instead of scalars.

The sampler thread folds one stack per thread per tick into the OPEN
window's `{folded_stack: samples}` map; every `window_secs` the open
window is sealed into a deque bounded by `slots`, so memory is capped
twice — per window by `max_stacks` (excess distinct stacks collapse
into the `~overflow` key, typed, never dropped silently) and globally
by the ring depth.  Readers (`GET /v1/profile`, the alert-triggered
capture, the digest hotspot summary) merge the windows that intersect
their lookback and return copies.

The statement-shape half lives here too: `record_stmt` accumulates
per-shape wall totals for writer/finalize/apply/matcher statements
(keyed by the r15 capture-shape cache key, fed from the
`timed_query` sqlite trace-callback path in runtime/trace.py), bounded
the same way.

Thread contract — the r7 lock discipline with one extra, profiler-
specific rule (enforced by the `profiler-safety` static rule,
analysis/profiler_safety.py): everything the SAMPLER thread touches
per sample is guarded by ``_fold_lock`` ONLY, and the critical
sections are plain dict updates — no asyncio objects, no store locks,
no allocation beyond the fold-map update.  Sealing a window (a dict
swap) and every read path run under the same lock; reads copy.

The port's copy of `corrosion_tpu/runtime/profstore.py`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# per-window distinct-stack cap: past it, new stacks fold into this key
# (bounded memory under pathological stack churn, accounted not hidden)
OVERFLOW_KEY = "~overflow"


class _Window:
    __slots__ = ("start_wall", "end_wall", "folded", "samples")

    def __init__(self, start_wall: float):
        self.start_wall = start_wall
        self.end_wall = 0.0
        self.folded: Dict[str, int] = {}
        self.samples = 0


class ProfStore:
    """Bounded folded-stack ring + statement-shape aggregation."""

    def __init__(
        self,
        window_secs: float = 5.0,
        slots: int = 24,
        max_stacks: int = 512,
        max_shapes: int = 128,
        wall=time.time,
    ):
        self.window_secs = float(window_secs)
        self.slots = int(slots)
        self.max_stacks = int(max_stacks)
        self.max_shapes = int(max_shapes)
        self._wall = wall
        self._fold_lock = threading.Lock()
        self._open = _Window(self._wall())
        self._ring: deque = deque(maxlen=self.slots)
        # shape key -> [count, total_secs] (cumulative; bounded)
        self._shapes: Dict[str, list] = {}
        self.sealed_total = 0

    # -- sampler-thread half (profiler-safety scoped) ----------------------

    def add_sample(self, key: str) -> None:
        """Fold one sampled stack into the open window.  THE per-sample
        mutation: one dict update under `_fold_lock`, nothing else."""
        with self._fold_lock:
            folded = self._open.folded
            n = folded.get(key)
            if n is None and len(folded) >= self.max_stacks:
                key = OVERFLOW_KEY
                n = folded.get(key)
            folded[key] = 1 if n is None else n + 1
            self._open.samples += 1

    def seal_coldpath(self) -> None:
        """Close the open window into the ring and open a fresh one.
        Cold path: runs once per `window_secs`, not per sample."""
        now = self._wall()
        with self._fold_lock:
            w = self._open
            w.end_wall = now
            self._open = _Window(now)
            if w.samples:
                self._ring.append(w)
                self.sealed_total += 1

    # -- statement shapes (worker threads via timed_query) -----------------

    def record_stmt(self, shape: str, secs: float) -> None:
        with self._fold_lock:
            row = self._shapes.get(shape)
            if row is None:
                if len(self._shapes) >= self.max_shapes:
                    shape = OVERFLOW_KEY
                    row = self._shapes.get(shape)
                if row is None:
                    row = self._shapes[shape] = [0, 0.0]
            row[0] += 1
            row[1] += secs

    # -- read side (loop / worker threads; copies) -------------------------

    def merged(self, window_secs: Optional[float] = None) -> Dict[str, int]:
        """Folded map merged over every window intersecting the
        lookback (open window included).  `None` → everything held."""
        lo = (
            self._wall() - float(window_secs)
            if window_secs is not None else float("-inf")
        )
        out: Dict[str, int] = {}
        with self._fold_lock:
            windows: List[_Window] = [
                w for w in self._ring if w.end_wall >= lo
            ]
            windows.append(self._open)
            for w in windows:
                for key, n in w.folded.items():
                    out[key] = out.get(key, 0) + n
        return out

    def stmt_rows(self) -> List[dict]:
        """Per-shape statement rows, heaviest total wall first."""
        with self._fold_lock:
            rows = [
                {
                    "shape": shape,
                    "count": row[0],
                    "total_secs": round(row[1], 6),
                }
                for shape, row in self._shapes.items()
            ]
        rows.sort(key=lambda r: -r["total_secs"])
        return rows

    def census(self) -> dict:
        with self._fold_lock:
            open_samples = self._open.samples
            ring_samples = sum(w.samples for w in self._ring)
            windows = len(self._ring)
            stacks = len(self._open.folded) + sum(
                len(w.folded) for w in self._ring
            )
            shapes = len(self._shapes)
        return {
            "window_secs": self.window_secs,
            "slots": self.slots,
            "windows_sealed": windows,
            "samples_held": open_samples + ring_samples,
            "distinct_stacks": stacks,
            "stmt_shapes": shapes,
        }


# -- folded map post-processing (serving side, never the sampler) ----------


def self_times(folded: Dict[str, int]) -> List[Tuple[str, int]]:
    """Per-frame SELF sample counts: each folded stack's sample count is
    charged to its LEAF frame — the flamegraph's 'who is actually on
    CPU' column.  Heaviest first."""
    acc: Dict[str, int] = {}
    for key, n in folded.items():
        leaf = key.rsplit(";", 1)[-1]
        acc[leaf] = acc.get(leaf, 0) + n
    return sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))


def to_folded_text(folded: Dict[str, int]) -> str:
    """The collapsed-stack text format every flamegraph tool ingests:
    one `stack count` line per distinct folded stack."""
    lines = [f"{key} {n}" for key, n in sorted(folded.items())]
    return "\n".join(lines) + ("\n" if lines else "")


def to_speedscope(folded: Dict[str, int], name: str = "corrosion") -> dict:
    """The speedscope file format (sampled profile): shared frame table
    + per-stack sample/weight arrays — importable straight into
    https://www.speedscope.app."""
    frame_index: Dict[str, int] = {}
    frames: List[dict] = []
    samples: List[List[int]] = []
    weights: List[int] = []
    for key in sorted(folded):
        stack = []
        for frame in key.split(";"):
            idx = frame_index.get(frame)
            if idx is None:
                idx = frame_index[frame] = len(frames)
                frames.append({"name": frame})
            stack.append(idx)
        samples.append(stack)
        weights.append(folded[key])
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": name,
                "unit": "none",
                "startValue": 0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            }
        ],
        "exporter": "corrosion-tpu-profiler",
    }
