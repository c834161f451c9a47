"""Continuous profiling plane (r23): an always-on wall-clock stack
sampler + the statement-shape profiler hook, Prime CCL discipline
(arXiv:2505.14065) — bounded overhead, and when the budget is exceeded
the plane DEGRADES (sheds its own sample rate), never the serving path.

The sampler is a daemon thread (`prof-sample`, the tsdb/tracestore
pattern) that walks ``sys._current_frames()`` at an adaptive rate:
`hz` (default 67) while its own measured duty cycle stays under
`max_overhead_pct`, auto-shedding to `shed_hz` (default 11) past it —
every shed counted by `corro.profile.shed.total`, the live overhead
published as `corro.profile.overhead.pct`, and the rate restored once
the projected full-rate overhead falls back under half the budget.

Each sampled thread is CLASSIFIED into a subsystem tag (event loop /
store worker / fanout / observability / the sampler itself) from its
thread name plus one stack-derived refinement (a worker thread with a
`store/` frame on its stack is the store worker); for a registered
event-loop thread the running asyncio task's name is resolved (the
lock-free ``asyncio.tasks._current_tasks`` dict read — the py-spy
trick, no asyncio API call on the sample path), so folded stacks carry
a ``subsystem;task;frames…`` prefix.  Samples aggregate into the
bounded `ProfStore` ring (runtime/profstore.py) and serve
``GET /v1/profile?window=…&format=folded|speedscope``.

Sampler-thread safety is a STATIC contract, not just a convention: the
`profiler-safety` rule (analysis/profiler_safety.py) walks the call
graph reachable from `_sample_once` across this module and profstore.py
and rejects asyncio calls, any lock but the sanctioned `_fold_lock`,
`agent`/`.store` object traversal, and per-sample allocation beyond the
fold-map update (comprehensions, f-strings, sorting, json, logging,
per-sample registry calls).  Cache-miss fills and once-per-window work
are explicitly cold paths — functions suffixed ``_coldpath`` are
bounded by cache size or window cadence, not by the sample rate.

Process-global install (`configure`/`ensure`/`get`, the tsdb.py
contract): the first agent's `[profile]` knobs win; tests drive
`Profiler.sample_once()` directly with the thread stopped.

The port's copy of `corrosion_tpu/runtime/profiler.py`. Its thread
names, and so its subsystem tags, are the JAX package's. The
`profiler-safety` static rule is not run over the port yet (ROADMAP §1
item 9.7).
"""

from __future__ import annotations

import sys
import threading
import time
from asyncio.tasks import _current_tasks  # lock-free dict, read-only
from typing import Dict, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.profstore import (
    ProfStore,
    self_times,
    to_folded_text,
    to_speedscope,
)

# how many samples between overhead-accounting / adaptation passes —
# metrics flush and shed decisions are per-BLOCK, never per-sample
ADAPT_EVERY = 32

# deepest stack folded per sample: beyond it the stack is truncated at
# the leaf end (the hot frames), bounded key size under deep recursion
MAX_DEPTH = 48

# thread-name prefix -> subsystem tag (the add-a-subsystem-tag table:
# extend it when a new named thread family appears — COMPONENTS.md
# "Continuous profiling" documents the procedure)
_NAME_TAGS = (
    ("corro-committer", "committer"),
    ("corro-subs-diff", "fanout"),
    ("asyncio_", "worker"),
    ("ThreadPoolExecutor", "worker"),
    ("crdt-interrupt-watchdog", "store"),
    ("tsdb-sample", "obs"),
    ("trace-sweep", "obs"),
    ("otlp-export", "obs"),
    ("prof-sample", "sampler"),
)


class Profiler:
    """The adaptive wall-clock sampler + its serving/read side."""

    def __init__(
        self,
        hz: float = 67.0,
        shed_hz: float = 11.0,
        max_overhead_pct: float = 1.0,
        window_secs: float = 5.0,
        slots: int = 24,
        max_stacks: int = 512,
        registry=METRICS,
    ):
        self.hz = float(hz)
        self.shed_hz = float(shed_hz)
        self.max_overhead_pct = float(max_overhead_pct)
        self.registry = registry
        self.ring = ProfStore(
            window_secs=window_secs, slots=slots, max_stacks=max_stacks
        )
        self.shed = False
        self.sheds_total = 0
        self.captures_total = 0
        self.overhead_pct = 0.0
        self.samples_total = 0
        # monotone sample-path wall accumulator: never reset by the
        # per-block flush, so an external reader (bench_ingest
        # --profile) can difference it across any span for an exact
        # duty measurement independent of block boundaries
        self.busy_secs_total = 0.0
        self._interval = 1.0 / self.hz
        self._own_tid = 0
        # tid -> subsystem tag (bounded: cleared past 512 entries);
        # loop-thread tids additionally map to their loop object so the
        # running task name can be resolved per sample
        self._tids: Dict[int, str] = {}
        self._loops: Dict[int, object] = {}
        # guards _tids/_loops MUTATION only (register_loop_coldpath on
        # the loop thread vs _classify_coldpath on the sampler thread);
        # the hot path reads both dicts lock-free — a stale read is
        # harmless, the next sample reclassifies
        self._reg_lock = threading.Lock()
        # code object -> (display frame string, is_store_frame) — the
        # per-frame intern table; filled on miss (cold path), read hot
        self._codes: Dict[object, tuple] = {}
        self._keybuf: list = []  # reused per-sample frame buffer
        # per-block overhead accounting (flushed by _adapt_coldpath)
        self._busy = 0.0
        self._block_started = time.monotonic()
        self._block_samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="prof-sample", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        self._own_tid = threading.get_ident()
        # a (re)started thread opens a FRESH accounting block: busy
        # carried across a stop() gap would divide by an elapsed that
        # excludes the gap and read as phantom duty
        self._busy = 0.0
        self._block_samples = 0
        self._block_started = time.monotonic()
        while not self._stop.wait(self._interval):
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - defensive
                # the profiler must never take the process down; one
                # bad sample is dropped, the plane keeps running
                pass

    def register_loop_coldpath(self, loop=None, tid: int = 0) -> None:
        """Map an event-loop thread (caller's thread by default) to its
        loop so the sampler resolves running task names.  Called once
        per agent boot from the loop thread — never on the sample path."""
        import asyncio

        if loop is None:
            loop = asyncio.get_running_loop()
        tid = tid or threading.get_ident()
        with self._reg_lock:
            self._loops[tid] = loop
            self._tids[tid] = "loop"

    # -- the sample path (profiler-safety scoped) ---------------------------

    def sample_once(self) -> None:
        """One pass over every live thread's current stack.  Runs on
        the sampler thread (or a test driver).  Everything here and
        below is inside the `profiler-safety` static contract."""
        t0 = time.monotonic()
        if self._own_tid == 0:
            self._own_tid = threading.get_ident()
        self._sample_once(t0)
        spent = time.monotonic() - t0
        self._busy += spent
        self.busy_secs_total += spent
        self._block_samples += 1
        if self._block_samples >= ADAPT_EVERY:
            self._adapt_coldpath(t0)

    def _sample_once(self, t0: float) -> None:
        frames = sys._current_frames()
        tids = self._tids
        codes = self._codes
        buf = self._keybuf
        add = self.ring.add_sample
        for tid, frame in frames.items():
            if tid == self._own_tid:
                add("sampler;-;prof-sample")
                continue
            sub = tids.get(tid)
            if sub is None:
                sub = self._classify_coldpath(tid)
            del buf[:]
            store_hit = False
            f = frame
            depth = 0
            while f is not None and depth < MAX_DEPTH:
                code = f.f_code
                info = codes.get(code)
                if info is None:
                    info = self._code_info_coldpath(code)
                buf.append(info[0])
                if info[1]:
                    store_hit = True
                f = f.f_back
                depth += 1
            buf.reverse()
            if store_hit and sub == "worker":
                sub = "store"
            task_name = "-"
            if sub == "loop":
                loop = self._loops.get(tid)
                if loop is not None:
                    task = _current_tasks.get(loop)
                    if task is not None:
                        task_name = task.get_name()
            key = sub + ";" + task_name + ";" + ";".join(buf)
            add(key)
        # window roll check: `_open` is swapped only by this thread, so
        # the unlocked read of its start stamp is single-writer-safe
        if time.time() - self.ring._open.start_wall >= self.ring.window_secs:
            self.ring.seal_coldpath()

    def _classify_coldpath(self, tid: int) -> str:
        """Thread-name classification on tid-cache miss — bounded by
        the number of live threads, not the sample rate."""
        name = ""
        th = threading._active.get(tid)
        if th is not None:
            name = th.name or ""
        sub = "other"
        if tid in self._loops:
            sub = "loop"
        else:
            for prefix, tag in _NAME_TAGS:
                if name.startswith(prefix):
                    sub = tag
                    break
        with self._reg_lock:
            if len(self._tids) > 512:
                self._tids.clear()  # dead-tid churn must not pin memory
            self._tids[tid] = sub
        return sub

    def _code_info_coldpath(self, code) -> tuple:
        """Frame intern-table fill on code-object miss — bounded by the
        number of distinct code objects, not the sample rate."""
        fname = code.co_filename
        short = fname.rsplit("/", 2)
        short = "/".join(short[1:]) if len(short) > 2 else fname
        info = (
            "%s:%s" % (short, code.co_name),
            "/store/" in fname,
        )
        if len(self._codes) > 8192:
            self._codes.clear()
        self._codes[code] = info
        return info

    def _adapt_coldpath(self, now: float) -> None:
        """Per-block overhead accounting + the adaptive shed: runs once
        per ADAPT_EVERY samples.  Metrics flush lives here so the
        sample path never takes a registry lock."""
        elapsed = max(1e-9, now - self._block_started)
        duty = self._busy / elapsed
        self.overhead_pct = round(100.0 * duty, 4)
        reg = self.registry
        reg.counter("corro.profile.samples.total").inc(self._block_samples)
        self.samples_total += self._block_samples
        reg.gauge("corro.profile.overhead.pct").set(self.overhead_pct)
        if not self.shed and self.overhead_pct > self.max_overhead_pct:
            self.shed = True
            self.sheds_total += 1
            self._interval = 1.0 / self.shed_hz
            reg.counter("corro.profile.shed.total").inc()
        elif self.shed:
            # projected duty at FULL rate from the per-sample cost; the
            # plane recovers only once full rate would fit half the
            # budget (hysteresis against shed/restore flapping)
            per_sample = self._busy / max(1, self._block_samples)
            projected = 100.0 * per_sample * self.hz
            if projected < 0.5 * self.max_overhead_pct:
                self.shed = False
                self._interval = 1.0 / self.hz
        self._busy = 0.0
        self._block_samples = 0
        self._block_started = time.monotonic()

    # -- statement shapes ---------------------------------------------------

    def stmt(self, shape: str, secs: float) -> None:
        """One statement-shape observation (timed_query's exit hook,
        worker threads): the registry histogram + the profile payload's
        cumulative per-shape rows."""
        self.registry.histogram(
            "corro.store.stmt.seconds", shape=shape
        ).observe(secs)
        self.ring.record_stmt(shape, secs)

    # -- read side ----------------------------------------------------------

    def folded(self, window_secs: Optional[float] = None) -> Dict[str, int]:
        return self.ring.merged(window_secs)

    def capture(self, reason: str, window_secs: float = 30.0, top: int = 10) -> dict:
        """The alert-triggered hot-window grab (pinned to flight-
        recorder incidents): top folded stacks + self-time frames +
        statement shapes, bounded and JSON-ready."""
        folded = self.ring.merged(window_secs)
        stacks = sorted(folded.items(), key=lambda kv: -kv[1])[: 4 * top]
        tops = self_times(folded)[:top]
        self.captures_total += 1
        self.registry.counter("corro.profile.captures.total").inc()
        return {
            "reason": reason,
            "window_secs": window_secs,
            "samples": sum(folded.values()),
            "folded": dict(stacks),
            "top_self": [
                {"frame": fr, "samples": n} for fr, n in tops
            ],
            "stmt": self.ring.stmt_rows()[:top],
            "overhead_pct": self.overhead_pct,
            "shed": self.shed,
        }

    def hotspots(self, window_secs: float = 60.0, top: int = 3) -> list:
        """Digest-plane summary: top-N self-time frames as compact
        (frame, samples) pairs — what rides the gossiped NodeDigest."""
        return [
            {"frame": fr, "samples": n}
            for fr, n in self_times(self.ring.merged(window_secs))[:top]
        ]

    def export(
        self, window_secs: Optional[float] = None, fmt: str = "json"
    ):
        """The /v1/profile serving surface: 'folded' → collapsed-stack
        text, 'speedscope' → the speedscope JSON document, anything
        else → the census+tops JSON summary."""
        folded = self.ring.merged(window_secs)
        if fmt == "folded":
            return to_folded_text(folded)
        if fmt == "speedscope":
            return to_speedscope(folded)
        return {
            "enabled": True,
            "window_secs": window_secs,
            "samples": sum(folded.values()),
            "hz": self.hz if not self.shed else self.shed_hz,
            "shed": self.shed,
            "overhead_pct": self.overhead_pct,
            "top_self": [
                {"frame": fr, "samples": n}
                for fr, n in self_times(folded)[:20]
            ],
            "stmt": self.ring.stmt_rows()[:20],
            "census": self.census(),
        }

    def census(self) -> dict:
        out = {
            "enabled": True,
            "hz": self.hz,
            "shed_hz": self.shed_hz,
            "shed": self.shed,
            "sheds_total": self.sheds_total,
            "max_overhead_pct": self.max_overhead_pct,
            "overhead_pct": self.overhead_pct,
            "samples_total": self.samples_total,
            "busy_secs_total": round(self.busy_secs_total, 6),
            "captures_total": self.captures_total,
        }
        out.update(self.ring.census())
        return out


# -- process-global install (the tsdb.py configure/ensure/get contract) ----

_PROFILER: Optional[Profiler] = None


def configure(auto_start: bool = True, **kw) -> Optional[Profiler]:
    """(Re)install the process profiler.  No kwargs = uninstall."""
    global _PROFILER
    if _PROFILER is not None:
        _PROFILER.stop()
        _PROFILER = None
    if not kw:
        return None
    _PROFILER = Profiler(**kw)
    if auto_start:
        _PROFILER.start()
    return _PROFILER


def ensure(auto_start: bool = True, **kw) -> Profiler:
    """Install if absent (first agent's [profile] config wins)."""
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = Profiler(**kw)
        if auto_start:
            _PROFILER.start()
    return _PROFILER


def get() -> Optional[Profiler]:
    return _PROFILER


def installed() -> bool:
    return _PROFILER is not None


def record_stmt(shape: str, secs: float) -> None:
    """The timed_query exit hook (runtime/trace.py): a no-op until a
    profiler is installed — one global read on the uninstalled path."""
    p = _PROFILER
    if p is not None:
        p.stmt(shape, secs)


# the five-bucket write-path attribution (WRITE_PROFILE.json / ROADMAP
# write-path round 4): agent/run.py stamps the commit pipeline and
# calls this per settled tx when a profiler is installed.  The buckets
# PARTITION the submit→resolve wall: `sqlite_flush` is the worker-
# thread wall minus finalize (statement exec + COMMIT fsync +
# bookkeeping — the in-sqlite residual), `asyncio_dispatch` the
# loop-side scheduling on both ends.  r24 renamed `to_thread_hop` →
# `handoff`: the gate_acq→thread_start span is now the committer
# thread's deque pickup latency (on CORRO_COMMITTER=to_thread it is
# the old executor hop again), same partition arithmetic either way.
WRITE_BUCKETS = (
    "asyncio_dispatch",
    "write_gate",
    "handoff",
    "finalize",
    "sqlite_flush",
)


def record_write_buckets(
    enq: float,
    gate_start: float,
    gate_acq: float,
    dispatch: float,
    thread_start: float,
    thread_done: float,
    resolved: float,
    finalize_secs: float,
) -> None:
    p = _PROFILER
    if p is None:
        return
    if not (enq <= gate_start <= gate_acq <= dispatch
            <= thread_start <= thread_done <= resolved):
        return  # a stamp is missing/reordered; don't bank garbage
    reg = p.registry
    hist = reg.histogram
    wall = resolved - enq
    thread_wall = thread_done - thread_start
    finalize_secs = min(finalize_secs, thread_wall)
    # first call stays unaliased: metrics-doc matches dotted
    # registry-method call sites textually, and the series must not
    # vanish from the inventory behind the local alias
    reg.histogram("corro.write.profile.seconds", bucket="wall").observe(wall)
    hist("corro.write.profile.seconds", bucket="asyncio_dispatch").observe(
        (gate_start - enq) + (resolved - thread_done)
    )
    hist("corro.write.profile.seconds", bucket="write_gate").observe(
        gate_acq - gate_start
    )
    hist("corro.write.profile.seconds", bucket="handoff").observe(
        thread_start - dispatch + (dispatch - gate_acq)
    )
    hist("corro.write.profile.seconds", bucket="finalize").observe(
        finalize_secs
    )
    hist("corro.write.profile.seconds", bucket="sqlite_flush").observe(
        thread_wall - finalize_secs
    )
