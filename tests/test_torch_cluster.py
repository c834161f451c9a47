"""The port's `ClusterSim` against the JAX package's, and the port's
entry-point rules.

At n=256 on the CPU, `run_until_stable_device` reaches the same stable
tick, the same coverage and the same event lane as the JAX `ClusterSim`
with the same configuration and seed (the slice's pick mode and bench
widths; the port's "cuda" inbox takes its plain version on the CPU, the
JAX side its bit-equal "gsort"). The entry points refuse to carry on
without a card unless the CPU is asked for."""

import numpy as np
import pytest
import torch

from corrosion_tpu.models.cluster import ClusterSim as JaxClusterSim
from corrosion_tpu_torch import (
    bench,
    convergence_probe,
    dense_100k,
    feed_sweep,
    profile_swim,
    scale_ladder,
)
from corrosion_tpu_torch.models.cluster import ClusterSim
from corrosion_tpu_torch.runtime.device import resolve_device

N = 256


def _params(impl):
    return dict(bench.bench_params(N), gossip_mode="pick", inbox_impl=impl)


@pytest.fixture(scope="module")
def jax_run():
    sim = JaxClusterSim(N, seed=0, seed_mode="fingers", **_params("gsort"))
    sim.warm_device_loop(0.999, 500, 5)
    tick = sim.run_until_stable_device(0.999, 500, 5)
    stats = sim.stats()
    return tick, stats, np.asarray(sim.state.events).astype(np.uint32)


def test_run_until_stable_device_matches_jax(jax_run):
    jtick, jstats, jevents = jax_run
    sim = ClusterSim(N, seed=0, seed_mode="fingers", device="cpu",
                     **_params("cuda"))
    sim.warm_device_loop(0.999, 500, 5)
    assert sim.ticks == 0 and int(sim.state.t) == 0  # warm-up ran no tick
    tick = sim.run_until_stable_device(0.999, 500, 5)
    assert jtick is not None and tick == jtick
    # the drain took the lane's growth over the run (from zero)
    np.testing.assert_array_equal(sim.last_event_delta, jevents)
    assert sim.last_flight.t == tick
    stats = sim.stats()
    np.testing.assert_array_equal(sim.last_event_delta, 0)
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-6)
    assert stats["false_positive"] == 0.0


def test_crash_detection_and_host_loop():
    """Crash, restart, degrade and the host-driven loops on the port."""
    sim = ClusterSim(64, seed=2, seed_mode="fingers", device="cpu",
                     feeds_per_tick=2, feed_entries=16)
    assert sim.run_until_stable(0.999, 200, record_every=5,
                                fine_every=1) is not None
    assert sim.history and sim.history[-1].coverage >= 0.999
    sim.crash(5)
    sim.degrade([9], loss=0.2, lag=1)
    took = sim.run_until_detected(1.0, 200)
    assert took is not None and sim.stats()["detected"] == 1.0
    sim.restart(5)
    assert bool(sim.state.alive[5]) and int(sim.state.inc[5]) == 1


def test_bench_record_on_explicit_cpu():
    rec = bench.measure(64, 0.999, bench.bench_params(64), "fingers",
                        record_every=5, check_every=5, device="cpu")
    det = rec["detail"]
    assert rec["metric"] == "time_to_stable_membership_n64"
    assert det["stable_tick"] is not None and det["false_positive"] == 0.0
    assert det["platform"] == "cpu" and det["device_kind"] is None
    assert set(det["code_sha"]) == set(bench._MEASURED_FILES)


def test_default_device_is_the_card():
    """With no device named, the entry points take cuda:0 or raise; they
    never carry on on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterSim(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure(16, 0.999, bench.bench_params(16))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


SCALE_ENTRY_POINTS = {
    "dense_100k.run": lambda: dense_100k.run(16, 5),
    "dense_100k.main": lambda: dense_100k.main(["16", "5"]),
    "scale_ladder.rung1": lambda: scale_ladder.rung1(),
    "scale_ladder.rung2": lambda: scale_ladder.rung2(suspicion=(3,)),
    "scale_ladder.rung3": lambda: scale_ladder.rung3(n=64),
    "scale_ladder.main": lambda: scale_ladder.main(["1"]),
    "profile_swim.table": lambda: profile_swim.table(16),
    "profile_swim.main": lambda: profile_swim.main(["16"]),
    "convergence_probe.run": lambda: convergence_probe.run(16),
    "feed_sweep.run": lambda: feed_sweep.run(4, 16),
}


@pytest.mark.parametrize("name", list(SCALE_ENTRY_POINTS))
def test_scale_drivers_default_to_the_card(name):
    """The dense scale drivers, with no device named, run on cuda:0 or
    raise before they allocate anything."""
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SCALE_ENTRY_POINTS[name]()
