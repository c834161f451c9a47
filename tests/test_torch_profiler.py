"""The port's continuous profiler (`runtime/profstore.py`,
`runtime/profiler.py`) against the JAX package's on the CPU.

Folded stacks name source files, so the stores and their renders are
held equal on identical synthetic folds and statement rows, on the same
injected wall clock. The sampler itself is held equal on threads this
test starts the same way for both packages, each parked in a function of
this file, with the sampler thread stopped: every stack that passes
through this file folds to the same key in both, with the same subsystem
tag from its thread name, and a registered event loop's running task
names its stack. The five-bucket write attribution, the capture an alert
pins to its incident and the digest's hotspot block (as bytes) are
compared too. Counts are compared exactly.
"""

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest

from corrosion_tpu.runtime import digest as jdigest
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.runtime import profiler as jprofiler
from corrosion_tpu.runtime import profstore as jprofstore
from corrosion_tpu_torch.runtime import digest as tdigest
from corrosion_tpu_torch.runtime import metrics as tmetrics
from corrosion_tpu_torch.runtime import profiler as tprofiler
from corrosion_tpu_torch.runtime import profstore as tprofstore

from tests.test_torch_planes import planes_reset  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(store=jprofstore, prof=jprofiler, metrics=jmetrics,
                           digest=jdigest),
    "port": SimpleNamespace(store=tprofstore, prof=tprofiler,
                            metrics=tmetrics, digest=tdigest),
}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    return fn(PKGS["jax"]), fn(PKGS["port"])


FOLDS = [
    ("loop;handle_changes;asyncio/base_events.py:_run_once;"
     "agent/run.py:handle_changes", 7),
    ("store;-;threading.py:run;store/crdt.py:apply_batch;"
     "store/crdt.py:_flush_batch", 11),
    ("committer;-;threading.py:run;agent/run.py:_commit;"
     "store/crdt.py:_flush_batch", 4),
    ("obs;-;threading.py:run;runtime/tsdb.py:sample_once", 2),
    ("sampler;-;prof-sample", 3),
]
STMTS = [("apply:batch", 0.004), ("insert:tests", 0.001),
         ("apply:batch", 0.006), ("match:batch", 0.002)]


def _filled(pkg, **kw):
    """A ProfStore fed `FOLDS` over three windows, two of them sealed,
    and `STMTS`, on an injected wall clock."""
    clock = Clock()
    st = pkg.store.ProfStore(window_secs=5.0, slots=4, wall=clock, **kw)
    for w in range(3):
        for key, n in FOLDS[w:]:
            for _ in range(n):
                st.add_sample(key)
        for shape, secs in STMTS:
            st.record_stmt(shape, secs)
        clock.t += 5.0
        if w < 2:
            st.seal_coldpath()
    return st, clock


@pytest.mark.parametrize("window", [None, 4.0, 9.0, 60.0])
def test_profstore_windows_and_renders_match(window):
    """The merged fold over a lookback, its self times, the folded text,
    the speedscope document, the statement rows and the census."""
    def read(pkg):
        st, _clock = _filled(pkg)
        folded = st.merged(window)
        return (folded, pkg.store.self_times(folded),
                pkg.store.to_folded_text(folded),
                pkg.store.to_speedscope(folded), st.stmt_rows(), st.census())
    j, t = _both(read)
    assert t == j
    assert t[0] and t[2].count("\n") == len(t[0])


def test_profstore_overflow_and_ring_bound_match():
    """Past `max_stacks` new stacks fold into the typed overflow key;
    past `max_shapes` new statement shapes do too; the ring keeps
    `slots` windows."""
    def read(pkg):
        clock = Clock()
        st = pkg.store.ProfStore(window_secs=1.0, slots=2, max_stacks=3,
                                 max_shapes=2, wall=clock)
        for w in range(4):
            for k in range(5):
                st.add_sample(f"other;-;f{w}{k}")
            st.record_stmt(f"shape{w}", 0.001)
            clock.t += 1.0
            st.seal_coldpath()
        return st.merged(None), st.stmt_rows(), st.census(), st.sealed_total
    j, t = _both(read)
    assert t == j
    assert tprofstore.OVERFLOW_KEY in t[0] and t[2]["windows_sealed"] == 2


def _parked_in_test(ready, stop):
    ready.set()
    stop.wait()


def _sample(pkg, names, loop_tid=None, loop=None):
    """Sampler passes of a fresh profiler over threads named `names`,
    each parked in `_parked_in_test`: the folds that pass through this
    file, and the census."""
    p = pkg.prof.Profiler(window_secs=600.0, registry=pkg.metrics.Registry())
    if loop is not None:
        p.register_loop_coldpath(loop=loop, tid=loop_tid)
    for _ in range(5):
        p.sample_once()
    folded = {k: n for k, n in p.folded().items()
              if "test_torch_profiler.py" in k}
    return folded


@pytest.mark.parametrize("names", [
    ("corro-committer", "corro-subs-diff-0", "asyncio_3"),
    ("ThreadPoolExecutor-0_0", "crdt-interrupt-watchdog", "tsdb-sample"),
    ("trace-sweep", "otlp-export", "worker-x"),
])
def test_sampler_folds_and_tags_match(names):
    """Threads started the same way for both packages, sampled with the
    sampler thread stopped: the same folded keys (subsystem tag from the
    thread name, then the frames), the same counts."""
    ready = [threading.Event() for _ in names]
    stop = threading.Event()
    threads = [threading.Thread(target=_parked_in_test, args=(r, stop),
                                name=n, daemon=True)
               for n, r in zip(names, ready)]
    for th in threads:
        th.start()
    try:
        for r in ready:
            assert r.wait(10.0)
        j, t = _both(lambda pkg: _sample(pkg, names))
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
    assert t == j
    tags = {k.split(";", 1)[0] for k in t}
    want = {"committer" if n.startswith("corro-committer") else
            "fanout" if n.startswith("corro-subs-diff") else
            "worker" if n.startswith(("asyncio_", "ThreadPoolExecutor")) else
            "store" if n.startswith("crdt-interrupt") else
            "obs" if n.startswith(("tsdb-", "trace-", "otlp-")) else "other"
            for n in names}
    assert tags == want and sum(t.values()) == 5 * len(names)


def test_loop_task_name_rides_the_fold():
    """A registered event loop's thread folds as `loop;<task name>;…`
    while the named task holds it."""
    started = threading.Event()
    release = threading.Event()
    loop = asyncio.new_event_loop()
    info = {}

    async def hot():
        started.set()
        _parked_in_test(threading.Event(), release)

    def serve():
        info["tid"] = threading.get_ident()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(loop.create_task(hot(), name="hot-task"))

    th = threading.Thread(target=serve, name="loop-thread", daemon=True)
    th.start()
    try:
        assert started.wait(10.0)
        time.sleep(0.05)
        j, t = _both(lambda pkg: _sample(pkg, (), loop_tid=info["tid"],
                                         loop=loop))
    finally:
        release.set()
        th.join(timeout=10.0)
        loop.close()
    assert t == j
    assert t and all(k.startswith("loop;hot-task;") for k in t)


def test_write_buckets_and_stmt_tap_match(planes_reset):
    """`record_write_buckets` partitions the wall into the same five
    histograms, refuses a reordered chain, and `record_stmt` fills the
    same statement rows, through each package's installed profiler."""
    def run(pkg):
        reg = pkg.metrics.Registry()
        p = pkg.prof.configure(auto_start=False, registry=reg)
        t = 100.0
        pkg.prof.record_write_buckets(
            enq=t, gate_start=t + 0.001, gate_acq=t + 0.003,
            dispatch=t + 0.004, thread_start=t + 0.006,
            thread_done=t + 0.016, resolved=t + 0.017, finalize_secs=0.004)
        pkg.prof.record_write_buckets(
            enq=t, gate_start=t - 1.0, gate_acq=t, dispatch=t,
            thread_start=t, thread_done=t, resolved=t, finalize_secs=0.0)
        for shape, secs in STMTS:
            pkg.prof.record_stmt(shape, secs)
        rows = sorted((n, tuple(sorted(lab.items())), v)
                      for kind, n, lab, v in reg.snapshot()
                      if kind == "histogram")
        out = rows, p.ring.stmt_rows(), list(pkg.prof.WRITE_BUCKETS)
        pkg.prof.configure()
        return out
    j, t = _both(run)
    assert t == j
    counts = {lab: v for n, lab, v in t[0]
              if n == "corro.write.profile.seconds_count"}
    assert set(counts.values()) == {1} and len(counts) == 6


def test_capture_hotspots_export_and_digest_block_match():
    """The alert capture, the digest hotspots, the JSON export and the
    census over the same ring; the hotspot block of a digest as bytes."""
    def run(pkg):
        reg = pkg.metrics.Registry()
        p = pkg.prof.Profiler(window_secs=600.0, registry=reg)
        for key, n in FOLDS:
            for _ in range(n):
                p.ring.add_sample(key)
        for shape, secs in STMTS:
            p.stmt(shape, secs)
        cap = p.capture("alert_store-faults", top=3)
        hot = p.hotspots(top=3)
        exp = p.export(window_secs=None)
        census = p.census()
        d = pkg.digest.NodeDigest(actor_id=bytes(range(16)), seq=3,
                                  wall=5000.0, view_hash=9, view_size=2,
                                  alive=2, hotspots=hot)
        return cap, hot, exp, census, pkg.digest.encode_digest(d)
    j, t = _both(run)
    assert t == j
    assert [h["frame"] for h in t[1]][:1] == ["store/crdt.py:_flush_batch"]
    assert tdigest.decode_digest(t[4]).hotspots == t[1]


def test_adaptive_shed_matches():
    """An overhead budget no sampler meets: both shed to `shed_hz` after
    one accounting block, count one shed, and publish the overhead."""
    def run(pkg):
        reg = pkg.metrics.Registry()
        p = pkg.prof.Profiler(hz=67.0, shed_hz=11.0, max_overhead_pct=1e-9,
                              registry=reg)
        for _ in range(pkg.prof.ADAPT_EVERY):
            p.sample_once()
        shed = reg.counter("corro.profile.shed.total").value
        return (p.shed, p.sheds_total, shed, p._interval,
                p.samples_total, reg.gauge("corro.profile.overhead.pct")
                .value > 0)
    j, t = _both(run)
    assert t == j and t[0] is True and t[3] == 1.0 / 11.0
