"""The port's telemetry publishing and `entry()` against the JAX package's.

After the same short runs of `ClusterSim` and `PViewClusterSim` on both
sides (a 4-tick ring that wraps between drains), the port's registry
deltas (`kernel_event_totals` and the flight-frame counters) and its
`FLIGHT` frames equal the JAX package's. The flight recorder's ring
arithmetic, host frames and incident dump, the `EVENTS_BY_KERNEL` table
and the span log are pinned too, and `entry()` on the CPU gives the
reference tick's state.
"""

import json
import time

import jax
import numpy as np
import pytest

from corrosion_tpu.models import cluster as jcluster
from corrosion_tpu.ops import swim as JS
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.runtime import records as jrecords
from corrosion_tpu_torch import entry as tentry
from corrosion_tpu_torch.models import cluster as tcluster
from corrosion_tpu_torch.runtime import metrics as tmetrics
from corrosion_tpu_torch.runtime import records as trecords
from corrosion_tpu_torch.runtime import trace as ttrace

_FAMILIES = ("corro.kernel.events.total", "corro.flight.frames.total",
             "corro.flight.frames.dropped")


def _counters(registry):
    return {
        (name, tuple(sorted(labels.items()))): value
        for kind, name, labels, value in registry.snapshot()
        if kind == "counter" and name in _FAMILIES
    }


def _frames(recorder, kernel, since_wall):
    return [
        {k: f[k] for k in ("kernel", "tick", "events", "census")}
        for f in recorder.window(4096, kernel=kernel)
        if f["wall"] >= since_wall
    ]


def _drive(sim):
    """Two drains 6 ticks apart: the 4-tick ring wraps and 2 frames drop
    each time."""
    for _ in range(2):
        sim.step(6)
        sim.stats()


_RUNS = {
    "dense": lambda mod, **kw: mod.ClusterSim(
        64, seed=1, seed_mode="fingers", feeds_per_tick=2, feed_entries=16,
        ring_ticks=4, **kw),
    "pview": lambda mod, **kw: mod.PViewClusterSim(
        64, slots=32, seed=1, feeds_per_tick=2, feed_entries=16,
        ring_ticks=4, **kw),
}


@pytest.mark.parametrize("kernel", list(_RUNS))
def test_published_deltas_and_frames_equal_jax(kernel):
    deltas, frames = [], []
    for mod, registry, recorder, kw in (
        (jcluster, jmetrics.METRICS, jrecords.FLIGHT, {}),
        (tcluster, tmetrics.METRICS, trecords.FLIGHT, {"device": "cpu"}),
    ):
        before = _counters(registry)
        wall = time.time()
        _drive(_RUNS[kernel](mod, **kw))
        after = _counters(registry)
        deltas.append({k: v - before.get(k, 0.0) for k, v in after.items()
                       if v != before.get(k, 0.0)})
        frames.append(_frames(recorder, kernel, wall))
    assert deltas[1] == deltas[0]
    assert frames[1] == frames[0]
    assert [f["tick"] for f in frames[1]] == [2, 3, 4, 5, 8, 9, 10, 11]
    dropped = ("corro.flight.frames.dropped", (("kernel", kernel),))
    assert deltas[1][dropped] == 4.0


def test_kernel_event_totals_and_phase_seconds():
    reg = tmetrics.Registry()
    tmetrics.record_kernel_events("pview", [3, 0, 5] + [0] * 11, reg)
    tmetrics.record_kernel_events("pview", [1] + [0] * 13, reg)
    tmetrics.record_phase_seconds("pview", "tick", 0.25, reg)
    assert tmetrics.kernel_event_totals(reg) == {
        "pview": {"gossip_emitted": 4.0, "inbox_delivered": 5.0}}
    assert ("gauge", "corro.kernel.phase.seconds",
            {"kernel": "pview", "phase": "tick"}, 0.25) in reg.snapshot()
    sim = tcluster.PViewClusterSim(32, slots=16, device="cpu")
    sim.step(2)
    phase = [v for kind, name, labels, v in tmetrics.METRICS.snapshot()
             if name == "corro.kernel.phase.seconds"
             and labels == {"kernel": "pview", "phase": "tick"}]
    assert len(phase) == 1 and phase[0] > 0.0


def test_events_by_kernel_matches_reference():
    assert set(tmetrics.EVENTS_BY_KERNEL) == set(jmetrics.EVENTS_BY_KERNEL)
    for kernel, names in tmetrics.EVENTS_BY_KERNEL.items():
        assert names == jmetrics.EVENTS_BY_KERNEL[kernel]


@pytest.mark.parametrize("t", [0, 3, 5, 13])
def test_frames_from_ring_equal_on_a_wrapped_ring(t):
    ring = np.random.default_rng(t).integers(
        0, 1000, (5, len(tmetrics.FLIGHT_LANES))).astype(np.int32)
    got = [(k, r.tolist()) for k, r in trecords.frames_from_ring(ring, t)]
    ref = [(k, r.tolist()) for k, r in jrecords.frames_from_ring(ring, t)]
    assert got == ref and len(got) == min(t, 5)
    assert trecords._frame_dict("dense", 2, 1.5, ring[0]) == \
        jrecords._frame_dict("dense", 2, 1.5, ring[0])


def test_host_frames_and_incident_dump_equal_reference(tmp_path):
    records = []
    for mod, reg in ((jrecords, jmetrics.Registry()),
                     (trecords, tmetrics.Registry())):
        rec = mod.FlightRecorder(capacity=8)
        rec.record_host_frame("crdt_merge", {"decide_won": 3}, reg)
        rec.record_host_frame("crdt_merge", {"decide_won": 1}, reg)
        path = rec.snapshot_incident(
            "strict violation", str(tmp_path / f"{mod.__name__}.json"), reg,
            extra={"why": "test"})
        with open(path) as f:
            rec = json.load(f)
        for frame in rec["frames"]:
            frame.pop("wall")
        records.append({k: rec[k] for k in ("reason", "lanes", "frames",
                                            "why")})
        assert [v for kind, name, _, v in reg.snapshot()
                if name == "corro.flight.incidents.total"] == [1.0]
    assert records[1] == records[0]
    assert trecords.FlightRecorder().snapshot_incident("empty") is None


def test_span_logs_name_attrs_and_wall():
    wall = time.time()
    with pytest.raises(KeyError):
        with ttrace.span("sim.test", kernel="pview", tick=7):
            raise KeyError("boom")
    last = ttrace.SPANS.recent(1)[0]
    assert last.name == "sim.test" and last.error
    assert last.attrs == {"kernel": "pview", "tick": "7"}
    assert last.wall >= wall and last.seconds >= 0.0


_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def test_entry_tick_equals_reference():
    """`entry(device="cpu")` boots and ticks as the reference's
    `swim.tick` does with the same params and keys."""
    params = JS.SwimParams(n=1024)
    state = JS.init_state(params, jax.random.PRNGKey(0))
    tick = jax.jit(JS.tick_impl, static_argnames="params").lower(
        state, jax.random.PRNGKey(1), params=params).compile(
        compiler_options=_FAST_COMPILE)
    ref = tick(state, jax.random.PRNGKey(1))
    fn, (tstate, key) = tentry.entry(device="cpu")
    got = fn(tstate, key)
    for f in JS.SwimState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
