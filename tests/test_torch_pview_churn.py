"""The port's partial-view churn drivers against the JAX package's same
programs: `pview_converge` (bootstrap to the four-term bar, then 1 %
churn to full detection), `bench_smoke`, `churn_sweep.run_config` and the
kernel parts of `chaos_soak` and `obs_report`.

The same seeds go through both packages on the CPU, at small sizes
(n=256-512, K=64): the boot tick, the detection tick, the six stats and
the 14 event totals at each end, and the flight-ring timeline must be
equal, in shift and in pick (the port's pick path takes the inbox
kernel's plain version on CPU tensors; the JAX side uses its "gsort"
build, which its own suite pins bit-equal to the Pallas kernel). The JAX
side of each program lives here, as helpers that follow the reference
script's body; each port body is held to its script's body over a
recording fake, without importing the script (each script re-launches
its process under its own JAX setup at import).

    JAX_PLATFORMS=cpu python -m tests.test_torch_pview_churn
        [--ref-25k | --ref-1m [200]]

prints `chip_smoke.PVIEW_CHURN_REF` (n=8,192, K=512 in shift and pick),
`SMOKE_REF` (`bench_smoke`'s defaults), `FLIGHT_REF` (`chaos_soak`'s
kernel flight phase at seed 7, the flaky-node A/B at seeds 3 and 11) and
`SWEEP_REF` (`churn_sweep`'s baseline and lifeguard at n=2,048, K=256);
with `--ref-25k`, `PVIEW_CHURN_25K_REF` (n=25,000, K=512 through churn,
every check: ~10 minutes); with `--ref-1m 200`, `PVIEW_1M_REF` (the
1,048,576-member bootstrap, K=2,048, every check to tick 200: about an
hour and ~42 GB on 8 CPU cores); with `--ref-1m` alone, the same run to
the bar (hours).
"""

import ast
import collections
import contextlib
import functools
import json
import re
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from corrosion_tpu.models import cluster as JC
from corrosion_tpu.ops import swim_pview as J
from corrosion_tpu.runtime import records as JR
from corrosion_tpu.runtime.metrics import KERNEL_EVENTS as J_EVENTS
from corrosion_tpu_torch import (
    bench_smoke,
    chaos_soak,
    churn_sweep,
    obs_report,
)
from corrosion_tpu_torch import pview_converge as pc
from corrosion_tpu_torch.models.cluster import PViewClusterSim
from corrosion_tpu_torch.runtime.records import FLIGHT

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
# the reference's chunk program compiled without XLA's costly backend
# passes (as tests/test_torch_swim.py does): the same integer and float32
# results, about half the compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


# ---------------------------------------------------------------------------
# the JAX side of each program


@functools.lru_cache(maxsize=None)
def _tick_n(params, k, fast):
    """The reference's k-tick dispatch, jitted whole (one scan)."""
    if not fast:
        return lambda s, key: J.tick_n_donated(s, key, params, k)
    compiled = {}

    def call(s, key):
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(
                J._tick_n_impl, static_argnames=("params", "k")).lower(
                    s, key, params=params, k=k).compile(
                        compiler_options=_FAST_COMPILE)
        return compiled["fn"](s, key)
    return call


def jax_params(n, slots, tick_mode="fused", gossip_mode="shift", **kw):
    """`pview_converge.pview_params` on the JAX package, with its "gsort"
    inbox."""
    d = pc.pview_params(n, slots, tick_mode, gossip_mode, **kw)._asdict()
    return J.PViewParams(**{**d, "inbox_impl": "gsort"})


def jax_flight_timeline(state, max_rows=128):
    """`scripts/pview_converge.py::flight_timeline` on a JAX state."""
    idx = {name: i for i, name in enumerate(J_EVENTS)}
    ring, t = np.asarray(state.ring), int(state.t)
    rows = []
    for tick, row in JR.frames_from_ring(ring, t):
        vals = {lane: int(row[idx[lane]])
                for lane in ("suspect_raised", "down_declared", "refuted")}
        if any(vals.values()):
            vals["tick"] = tick
            vals["census_suspect"] = int(row[len(J_EVENTS) + 1])
            rows.append(vals)
    return rows[-max_rows:]


def jax_pview_converge(n, slots, gossip_mode="shift", tick_mode="fused",
                       chunk=25, max_ticks=2000, check_every=10,
                       skip_churn=False, fast=True, log=None):
    """`scripts/pview_converge.py`'s program on the JAX package, one
    device: the fields of its record that `pview_converge.checked`
    reads, and the per-check `history` as the port keeps it; `log`, if
    given, gets each history row as it is read."""
    params = jax_params(n, slots, tick_mode, gossip_mode)
    state = J.init_state(params, jax.random.PRNGKey(0), seed_mode="fingers")
    advance = _tick_n(params, chunk, fast)
    rng = jax.random.PRNGKey(1)
    rng, key = jax.random.split(rng)
    state = advance(state, key)

    history = []

    def read(state, tick):
        s, ev, _ = J.stats_and_events(state, params)
        history.append([tick] + [s[k] for k in pc.STATS])
        if log is not None:
            log(history[-1])
        return s, ev.tolist()

    def run_until(state, rng, done, target):
        while done < target:
            rng, key = jax.random.split(rng)
            state = advance(state, key)
            done += chunk
        return state, rng, done

    ticks, stats, events, converged = chunk, {}, [], False
    check_every = max(chunk, check_every)
    while ticks < max_ticks:
        state, rng, ticks = run_until(state, rng, ticks,
                                      min(ticks + check_every, max_ticks))
        stats, events = read(state, ticks)
        converged = pc.converged_bar(stats, n, slots)
        if converged:
            break
    det, cstats, cevents, timeline = None, {}, [], []
    if converged and not skip_churn:
        kill = np.random.default_rng(7).choice(n, size=max(1, n // 100),
                                               replace=False)
        state = J.set_alive_many(state, kill, False)
        extra = 0
        while extra < max_ticks:
            state, rng, extra = run_until(state, rng, extra,
                                          min(extra + check_every,
                                              max_ticks))
            cstats, cevents = read(state, ticks + extra)
            if cstats["detected"] >= 1.0 and cstats["false_positive"] == 0.0:
                det = extra
                break
        timeline = jax_flight_timeline(state)
    churn = ({"skipped": True} if skip_churn else
             {"detect_all_ticks": det, "timeline": timeline})
    return {"ticks": ticks, "converged": converged, "churn": churn,
            "history": history, "raw": {"boot_stats": stats, "boot_events": events,
                    "churn_stats": cstats, "churn_events": cevents}}


@contextlib.contextmanager
def clean_jax_flight():
    """The JAX package's sims publish into a fresh recorder inside the
    block (its module-global `FLIGHT`, swapped); yields the recorder."""
    rec, saved = JR.FlightRecorder(), JC.FLIGHT
    JC.FLIGHT = rec
    try:
        yield rec
    finally:
        JC.FLIGHT = saved


def _np_events(state):
    return np.asarray(state.events).astype(np.uint32).tolist()


def jax_bench_smoke(n=2048, slots=256, max_ticks=600):
    """`scripts/bench_smoke.py`'s measured sim on the JAX package (its
    compile warm-up sim has its own seed and changes nothing here)."""
    sim = JC.PViewClusterSim(n, slots=slots, seed=0, seed_mode="fingers",
                             feeds_per_tick=4,
                             feed_entries=max(16, slots // 16),
                             tie_epoch=512)
    stable = sim.run_until_converged_device(max_ticks=max_ticks,
                                            check_every=25)
    stats, cs, det = sim.stats(), {}, None
    n_kill = max(1, n // 100)
    if stable is not None:
        sim.crash_many(np.random.default_rng(7).choice(n, size=n_kill,
                                                       replace=False))
        base = sim.ticks
        while sim.ticks - base < max_ticks:
            sim.step(25)
            cs = sim.stats()
            if cs["detected"] >= 1.0 and cs["false_positive"] == 0.0:
                det = sim.ticks - base
                break
    return {"detail": {"stable_tick": stable, "churn_killed": n_kill,
                       "churn_detect_all_ticks": det,
                       "raw": {"stats": stats, "churn_stats": cs,
                               "events": _np_events(sim.state)}}}


def jax_kernel_flight(seed=7):
    """`scripts/chaos_soak.py::kernel_flight_phase` on the JAX package,
    its sim publishing into a clean recorder."""
    n = 256
    with clean_jax_flight() as flight:
        sim = JC.PViewClusterSim(n, slots=64, seed=seed, seed_mode="fingers",
                                 feeds_per_tick=2, feed_entries=16,
                                 suspicion_ticks=4)
        sim.run_until_converged(max_ticks=400, check_every=25)
        kill = np.random.default_rng(seed).choice(
            n, size=max(1, n * 3 // 100), replace=False)
        base = sim.ticks
        sim.crash_many(kill)
        det = None
        while sim.ticks - base < 200:
            sim.step(10)
            cs = sim.stats()
            if cs["detected"] >= 1.0 and cs["false_positive"] == 0.0:
                det = sim.ticks - base
                break
        frames = flight.window(4096, kernel="pview")
    timeline = [{"tick": f["tick"] - base,
                 "suspect_raised": f["events"]["suspect_raised"],
                 "down_declared": f["events"]["down_declared"],
                 "refuted": f["events"]["refuted"],
                 "open_timers": f["census"]["census_suspect"]}
                for f in frames if f["tick"] >= base and (
                    f["events"]["suspect_raised"]
                    or f["events"]["down_declared"]
                    or f["events"]["refuted"])][-128:]
    return {"n": n, "killed": int(len(kill)), "detect_ticks": det,
            "timeline": timeline}


def jax_flaky(seeds=(3, 11)):
    """`scripts/chaos_soak.py::flaky_node_phase`'s A/B runs on the JAX
    package (its asserts are the port's, checked on the port's runs)."""
    with clean_jax_flight():
        return {"runs": [JC.flaky_node_ab(
            kernel="dense", seed=seed, n=96, boot_ticks=40, window=240,
            lag=2, chunk=20, detect_chunk=5, drain_flight=True)
            for seed in seeds]}


def jax_sweep_config(label, n, slots, **overrides):
    """`scripts/churn_sweep.py::run_config` on the JAX package: the
    fields `churn_sweep.checked` reads."""
    params = J.PViewParams(n=n, slots=slots, feeds_per_tick=8,
                           feed_entries=max(16, slots // 16), tie_epoch=512,
                           **overrides)
    state = J.init_state(params, jax.random.PRNGKey(0), seed_mode="fingers")
    rng = jax.random.PRNGKey(1)
    advance = _tick_n(params, 10, True)
    ticks, converged = 0, False
    while ticks < 1500:
        rng, key = jax.random.split(rng)
        state = advance(state, key)
        ticks += 10
        st = J.membership_stats(state, params)
        converged = (st["pv_coverage"] >= 0.99 and st["min_in_degree"] >= 8
                     and st["false_positive"] == 0.0)
        if converged:
            break
    if not converged:
        return {"label": label, "error": "no bootstrap convergence",
                "boot_ticks": ticks}
    boot_stats = st
    kill = np.random.default_rng(7).choice(n, size=n // 100, replace=False)
    state = J.set_alive_many(state, kill, False)
    det, detected = 0, False
    while det < 3000:
        rng, key = jax.random.split(rng)
        state = advance(state, key)
        det += 10
        st = J.membership_stats(state, params)
        if st["false_positive"] > 0:
            return {"label": label, "error": "false positive under churn",
                    "stats": {k: round(v, 5) for k, v in st.items()}}
        if st["detected"] >= 1.0:
            detected = True
            break
    return {"label": label, "boot_ticks": ticks,
            "detect_all_ticks": det if detected else None,
            "raw": {"boot_stats": boot_stats, "churn_stats": st,
                    "events": _np_events(state)}}


# ---------------------------------------------------------------------------
# pview_converge


@pytest.mark.parametrize("gossip_mode", ["shift", "pick"])
def test_pview_converge_matches_jax(gossip_mode):
    kw = dict(gossip_mode=gossip_mode, chunk=10)
    got = pc.run(256, 64, device="cpu", log=lambda s: None, **kw)
    want = jax_pview_converge(256, 64, **kw)
    assert pc.checked(got) == pc.checked(want)
    assert np.array_equal(np.float32(got["history"]),
                          np.float32(want["history"]))
    assert got["converged"] and got["churn"]["detect_all_ticks"]
    assert got["churn"]["killed"] == 2 and got["churn"]["timeline"]
    assert pc.ok(got) and got["platform"] == "cpu" and got["devices"] == 1
    assert got["peak_mem_bytes"] is None and got["inbox_kernel_launches"] == 0


# ---------------------------------------------------------------------------
# bench_smoke, churn_sweep, chaos_soak, obs_report


def test_bench_smoke_matches_jax():
    got = bench_smoke.run(256, 64, 600, device="cpu")
    want = jax_bench_smoke(256, 64, 600)
    assert bench_smoke.checked(got) == bench_smoke.checked(want)
    det = got["detail"]
    assert bench_smoke.ok(got) and det["churn_killed"] == 2
    assert det["stable_tick"] % 25 == 0 and det["churn_detect_all_ticks"]
    assert det["platform"] == "cpu" and det["device_kind"] is None


@pytest.mark.parametrize("label", ["baseline", "lifeguard"])
def test_churn_sweep_matches_jax(label):
    ov = dict(churn_sweep.CONFIGS)[label]
    got = churn_sweep.run_config(label, 256, 64, device="cpu", **ov)
    want = jax_sweep_config(label, 256, 64, **ov)
    assert churn_sweep.checked(got) == churn_sweep.checked(want)
    assert got["detect_all_ticks"] and got["rung"] == f"{label}-256"


def _dirty_global_flight():
    """Another pview sim's frames in the global `FLIGHT`, with suspicions
    and downs at ticks a later phase's filter (tick >= its boot tick, at
    least 25) would let in."""
    other = PViewClusterSim(64, slots=16, seed=5, device="cpu",
                            feeds_per_tick=2, feed_entries=16,
                            suspicion_ticks=4)
    other.step(30)
    other.crash_many(list(range(0, 64, 4)))
    for _ in range(6):
        other.step(10)
        other.stats()
    late = [f for f in FLIGHT.window(4096, kernel="pview")
            if f["tick"] >= 25]
    assert any(f["events"]["suspect_raised"] or f["events"]["down_declared"]
               for f in late)


def test_kernel_flight_phase_matches_jax_in_a_dirty_process():
    _dirty_global_flight()
    got = chaos_soak.kernel_flight_phase(7, device="cpu")
    want = jax_kernel_flight(7)
    assert got == want
    assert got["killed"] == 7 and got["detect_ticks"]
    assert any(r["down_declared"] for r in got["timeline"])


@pytest.mark.slow
def test_flaky_node_phase_matches_jax():
    # the JAX package's runs of this phase are `FLIGHT_REF` (pinned to
    # them by the slow `test_flight_ref_is_the_jax_packages`); ~15 s of
    # dense ticks on one core, so slow: `chip_smoke.py`'s pview_flight
    # holds the port to FLIGHT_REF on every card run
    got = chaos_soak.flaky_node_phase((3,), device="cpu")
    empty = {"timeline": [], "killed": 0, "detect_ticks": None}
    assert (chaos_soak.checked(empty, got)["flaky"]
            == chip_smoke.FLIGHT_REF["flaky"][:1])


def script_functions(script, names, **ns):
    """The named module-level functions and assignments of a script,
    compiled from its source into a namespace holding `ns` (importing the
    script would re-launch the process under its own JAX setup)."""
    tree = ast.parse((SCRIPTS / script).read_text())
    keep = [node for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module == "__future__"
            or isinstance(node, ast.FunctionDef) and node.name in names
            or isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in names
                for t in node.targets)]
    exec(compile(ast.Module(body=keep, type_ignores=[]), script, "exec"), ns)
    return ns


def _lines(render, *args, **kw):
    """What `render(emit, ...)` emits, as a list of lines."""
    lines = []
    render(lambda line="": lines.append(line), *args, **kw)
    return lines


def test_obs_report_boot_matches_jax():
    got = obs_report.run(256, 64, 300, device="cpu")
    with clean_jax_flight() as flight:
        sim = JC.PViewClusterSim(256, slots=64, seed=0, seed_mode="fingers",
                                 feeds_per_tick=4, feed_entries=16,
                                 tie_epoch=512)
        want = sim.run_until_converged(max_ticks=300, check_every=25)
        stats = sim.stats()
    assert got["stable_tick"] == want is not None
    assert got["stats"] == pytest.approx(stats, rel=1e-6)
    script = script_functions(
        "obs_report.py", ("render_flight_section", "sparkline", "_SPARK",
                          "_FLIGHT_EVENT_LANES", "_FLIGHT_CENSUS_LANES"),
        FLIGHT=flight)
    section = "\n".join(_lines(script["render_flight_section"],
                               kernel="pview"))
    assert f"last {min(64, want)} ticks" in section
    assert section in got["text"]
    assert "## kernel event totals" in got["text"]


# ---------------------------------------------------------------------------
# the port's bodies against the scripts', over recording fakes

_FakeState = collections.namedtuple("_FakeState",
                                    "t slot_packed ring events killed")
_RING = np.zeros((128, 20), dtype=np.int32)
_RING[[3, 40, 41, 90], [7, 8, 9, 7]] = [2, 1, 1, 3]  # lifecycle lanes
_RING[:, 15] = 4  # census_suspect


def _fake_keys(log):
    """PRNGKey/split whose keys name their chain, so two bodies that
    split alike pass equal keys."""
    return types.SimpleNamespace(
        PRNGKey=lambda seed: ("key", seed),
        split=lambda key, num=2: [("L", key), ("R", key)])


class FakePview:
    """The `swim_pview` functions both bodies call, recording each call.
    The stats converge at tick `boot_at` (never if None) and, after a
    crash, detect at `detect_at` ticks past it; `fp_after` puts a false
    positive into the churn stats from that many ticks on."""

    def __init__(self, log, boot_at=75, detect_at=50, fp_after=None):
        self.log, self.boot_at, self.detect_at = log, boot_at, detect_at
        self.fp_after, self.kill_t = fp_after, None

    def PViewParams(self, **kw):
        kw.pop("inbox_impl", None)  # the port's pick path names its kernel
        self.log.append(("params", kw))
        return types.SimpleNamespace(**kw)

    def init_state(self, params, key, seeds_per_member=3, seed_mode="ring",
                   device=None):
        self.log.append(("init", key, seed_mode))
        return _FakeState(0, None, torch.from_numpy(_RING), torch.zeros(14),
                          False)

    def tick_n_donated(self, state, key, params, k):
        self.log.append(("tick_n", key, k))
        return state._replace(t=state.t + k)

    tick_n = tick_n_donated

    def membership_stats(self, state, params):
        self.log.append(("stats", state.t))
        boot = self.boot_at is not None and state.t >= self.boot_at
        st = {"pv_coverage": 0.995 if boot else 0.5, "mean_in_degree": 300.0,
              "min_in_degree": 9.0 if boot else 2.0, "occupancy": 0.5,
              "false_positive": 0.0, "detected": 1.0}
        if state.killed:
            past = state.t - self.kill_t
            st["detected"] = 1.0 if past >= self.detect_at else 0.5
            if self.fp_after is not None and past >= self.fp_after:
                st["false_positive"] = 0.25
        return st

    def stats_and_events(self, state, params):
        return (self.membership_stats(state, params),
                np.arange(14, dtype=np.uint32), None)

    def saturation_floor(self, n, slots):
        return 200.0

    def set_alive_many(self, state, members, value):
        self.log.append(("alive", sorted(int(m) for m in members), value))
        self.kill_t = state.t
        return state._replace(killed=True)


def _fake_jax(pv):
    return types.SimpleNamespace(
        random=_fake_keys(pv.log),
        devices=lambda: [types.SimpleNamespace(platform="cpu")],
        block_until_ready=lambda x: x,
        device_get=lambda xs: tuple(
            x.numpy() if isinstance(x, torch.Tensor) else x for x in xs))


def _script_env(env, argv):
    return (types.SimpleNamespace(environ=env, path=__import__("os").path),
            types.SimpleNamespace(argv=["script"] + argv, exit=sys.exit))


# (script env, script argv, port run() keywords, FakePview keywords)
CONVERGE_CASES = {
    "default": ({}, [], {}, {}),
    "pick-chunk10": ({"PVIEW_GOSSIP_MODE": "pick", "PVIEW_CHUNK": "10"},
                     ["4096", "512"], dict(n=4096, slots=512,
                                           gossip_mode="pick", chunk=10),
                     dict(detect_at=20)),
    "r5-no-boot": ({"PVIEW_TICK_MODE": "r5", "PVIEW_MAX_TICKS": "100"}, [],
                   dict(tick_mode="r5", max_ticks=100), dict(boot_at=None)),
    "skip-churn": ({"PVIEW_SKIP_CHURN": "1", "PVIEW_CHECK_EVERY": "50"},
                   ["2048"], dict(n=2048, skip_churn=True, check_every=50),
                   {}),
    "no-detect": ({"PVIEW_MAX_TICKS": "150"}, [], dict(max_ticks=150),
                  dict(detect_at=1000)),
}


@pytest.mark.parametrize("case", list(CONVERGE_CASES))
def test_pview_converge_body_is_the_scripts(case, monkeypatch, capsys):
    env, argv, kw, fake_kw = CONVERGE_CASES[case]
    want_log, recs = [], []
    pv = FakePview(want_log, **fake_kw)
    os_, sys_ = _script_env(env, argv)
    ns = script_functions(
        "pview_converge.py", ("main", "flight_timeline", "print_timeline",
                              "_TIMELINE_LANES", "_EV_IDX", "_CEN_SUSPECT"),
        jax=_fake_jax(pv), swim_pview=pv, np=np, os=os_, sys=sys_, json=json,
        time=__import__("time"), DEVICES=1, REPO="/repo",
        KERNEL_EVENTS=J_EVENTS, frames_from_ring=JR.frames_from_ring,
        merge_records=lambda path, r: recs.extend(r))
    with pytest.raises(SystemExit) as exit_:
        ns["main"]()
    log = []
    pv = FakePview(log, **fake_kw)
    monkeypatch.setattr(pc, "swim_pview", pv)
    monkeypatch.setattr(pc, "jr", _fake_keys(log))
    got = pc.run(**kw, device="cpu", log=lambda s: None)
    assert log == want_log
    assert pc.ok(got) == (exit_.value.code == 0)
    (want,) = recs
    timeless = ("init_s", "compile_s", "wall_s", "s_per_tick", "platform")
    for k, v in want.items():
        if k == "churn":
            assert {c: x for c, x in got["churn"].items() if c != "wall_s"} \
                == {c: x for c, x in v.items() if c != "wall_s"}
        elif k not in timeless:
            assert got[k] == v, k


def test_churn_sweep_body_is_the_scripts(monkeypatch, capsys):
    for fake_kw in ({}, {"boot_at": None}, {"fp_after": 20}):
        want_log = []
        pv = FakePview(want_log, **fake_kw)
        ns = script_functions(
            "churn_sweep.py", ("run_config", "CHUNK", "QUORUM"),
            jax=_fake_jax(pv), swim_pview=pv, np=np, json=json,
            time=__import__("time"))
        want = ns["run_config"]("ae8", 4096, 512, antientropy=8)
        log = []
        pv = FakePview(log, **fake_kw)
        monkeypatch.setattr(churn_sweep, "swim_pview", pv)
        monkeypatch.setattr(churn_sweep, "jr", _fake_keys(log))
        got = churn_sweep.run_config("ae8", 4096, 512, device="cpu",
                                     antientropy=8)
        assert log == want_log
        assert {k: v for k, v in got.items() if k in want
                and k not in ("churn_wall_s", "s_per_tick", "platform")} \
            == {k: v for k, v in want.items()
                if k not in ("churn_wall_s", "s_per_tick", "platform")}
    main = next(node for node in ast.parse(
        (SCRIPTS / "churn_sweep.py").read_text()).body
        if isinstance(node, ast.FunctionDef) and node.name == "main")
    configs = next(node.value for node in ast.walk(main)
                   if isinstance(node, ast.Assign)
                   and node.targets[0].id == "configs")
    assert [tuple(c) for c in ast.literal_eval(configs)] == \
        churn_sweep.CONFIGS


class RecordingSim:
    """A stand-in for `PViewClusterSim` recording its constructor's
    arguments and the calls made on it (arguments bound to their names),
    with the stats of a cluster that converges and, 30 ticks after a
    crash, detects it."""

    def __init__(self, log, n, **kw):
        kw.pop("device", None)
        self.log, self.id = log, sum(e[0] == "new" for e in log)
        self.ticks, self.crashed_at = 0, None
        self.params = types.SimpleNamespace(n=n, tick_mode="fused",
                                            gossip_mode="shift")
        self.state = _FakeState(0, None, None, torch.zeros(14), False)
        self.flight = None
        log.append(("new", n, kw))

    def _rec(self, name, **args):
        self.log.append((self.id, name, args))

    def step(self, ticks=1):
        self._rec("step", ticks=ticks)
        self.ticks += ticks

    def crash_many(self, members):
        self._rec("crash_many", members=sorted(int(m) for m in members))
        self.crashed_at = self.ticks

    def stats(self):
        self._rec("stats")
        done = self.crashed_at is None or self.ticks - self.crashed_at >= 30
        return {"pv_coverage": 1.0, "mean_in_degree": 50.0,
                "min_in_degree": 10.0, "occupancy": 1.0,
                "false_positive": 0.0, "detected": 1.0 if done else 0.5}

    def run_until_converged(self, cov_target=0.99, quorum=8, max_ticks=2000,
                            check_every=10):
        self._rec("run_until_converged", cov_target=cov_target,
                  quorum=quorum, max_ticks=max_ticks, check_every=check_every)
        self.ticks = 75
        return 75

    def run_until_converged_device(self, cov_target=0.99, quorum=8,
                                   max_ticks=2000, check_every=10):
        self._rec("run_until_converged_device", cov_target=cov_target,
                  quorum=quorum, max_ticks=max_ticks, check_every=check_every)
        self.ticks = max(self.ticks, 75) if max_ticks else self.ticks
        return 75 if max_ticks else None


def test_bench_smoke_body_is_the_scripts(monkeypatch, tmp_path, capsys):
    want_log = []
    os_, sys_ = _script_env({"BENCH_SMOKE_OUT": str(tmp_path / "b.json")},
                            ["07"])
    ns = script_functions(
        "bench_smoke.py", ("main", "_code_fingerprint", "_MEASURED_FILES"),
        PViewClusterSim=lambda n, **kw: RecordingSim(want_log, n, **kw),
        jax=types.SimpleNamespace(
            block_until_ready=lambda x: x,
            devices=lambda: [types.SimpleNamespace(platform="cpu")]),
        np=np, os=os_, sys=sys_, json=json, time=__import__("time"),
        REPO="/nonexistent", glob=None, re=re)
    with pytest.raises(SystemExit):
        ns["main"]()
    want = json.loads((tmp_path / "b.json").read_text())
    log = []
    monkeypatch.setattr(bench_smoke, "PViewClusterSim",
                        lambda n, **kw: RecordingSim(log, n, **kw))
    got = bench_smoke.run(device="cpu")

    def measured(entries):  # the seed-0 sim: the warm-up sims differ
        first = next(i for i, e in enumerate(entries) if e[0] == "new")
        return [e for e in entries if e[0] == 0 or e is entries[first]]
    assert measured(log) == measured(want_log)
    assert log[0][2]["seed"] == 0 and log[1][2]["seed"] == 1
    skip = ("init_s", "compile_s", "warm_s", "boot_wall_s", "churn_wall_s",
            "code_sha", "measured_at", "platform", "device_kind",
            "power_limit_w", "raw")
    assert {k: v for k, v in got["detail"].items() if k not in skip} == {
        k: v for k, v in want["detail"].items() if k not in skip}
    assert got["metric"] == want["metric"] == "pview_smoke_n2048_k256"


class FakeRecorder:
    """A flight recorder that serves two frames past any boot tick."""

    def window(self, k, kernel=None):
        ev = {"suspect_raised": 3, "down_declared": 0, "refuted": 0}
        return [{"tick": 80, "events": ev, "census": {"census_suspect": 3}},
                {"tick": 85, "events": {**ev, "down_declared": 2},
                 "census": {"census_suspect": 1}}]


def test_chaos_soak_bodies_are_the_scripts(monkeypatch, capsys):
    want_log, ab = [], []

    def fake_ab(**kw):
        kw.pop("flight", None), kw.pop("device", None)
        ab.append(kw)
        mode = {"suspect_fp": 10, "down_fp": 10, "detect_ticks": 10,
                "timeline": [1]}
        return {"seed": kw["seed"], "vanilla": mode,
                "lifeguard": {**mode, "suspect_fp": 1, "down_fp": 0}}

    monkeypatch.setattr(JC, "PViewClusterSim",
                        lambda n, **kw: RecordingSim(want_log, n, **kw))
    monkeypatch.setattr(JC, "flaky_node_ab", fake_ab)
    monkeypatch.setattr(JR, "FLIGHT", FakeRecorder())
    ns = script_functions("chaos_soak.py", ("kernel_flight_phase",
                                            "flaky_node_phase"))
    want = ns["kernel_flight_phase"](7), ns["flaky_node_phase"]((3, 11))
    want_ab, ab[:] = list(ab), []
    log = []
    monkeypatch.setattr(chaos_soak, "PViewClusterSim",
                        lambda n, **kw: RecordingSim(log, n, **kw))
    monkeypatch.setattr(chaos_soak, "flaky_node_ab", fake_ab)
    monkeypatch.setattr(chaos_soak, "FlightRecorder", FakeRecorder)
    got = (chaos_soak.kernel_flight_phase(7, "cpu"),
           chaos_soak.flaky_node_phase((3, 11), "cpu"))
    assert log == want_log and ab == want_ab and got == want


def test_obs_report_boot_is_the_scripts(monkeypatch, tmp_path, capsys):
    want_log, renders = [], []
    os_, sys_ = _script_env({"OBS_REPORT_OUT": str(tmp_path / "o.md")}, [])
    stubs = {name: (lambda *a, name=name, **kw: renders.append(name))
             for name in ("render_registry_tables", "render_flight_section",
                          "render_slo_section", "render_traces_section",
                          "render_cluster_section", "render_alerts_section")}
    ns = script_functions(
        "obs_report.py", ("main",), **stubs,
        PViewClusterSim=lambda n, **kw: RecordingSim(want_log, n, **kw),
        jax=types.SimpleNamespace(
            devices=lambda: [types.SimpleNamespace(platform="cpu")]),
        os=os_, sys=sys_, io=__import__("io"), json=json,
        time=__import__("time"), _code_sha=lambda: {}, REPO="/nonexistent")
    with pytest.raises(SystemExit):
        ns["main"]()
    assert renders[:2] == ["render_registry_tables", "render_flight_section"]
    log = []
    monkeypatch.setattr(bench_smoke, "PViewClusterSim",
                        lambda n, **kw: RecordingSim(log, n, **kw))
    got = obs_report.run(device="cpu")
    assert log == want_log and got["stable_tick"] == 75


# ---------------------------------------------------------------------------
# the registry and flight renders against the script's


def _publish(registry, flight, metrics_mod, records_mod):
    """The same event totals, phase gauges and frames into one package's
    registry and recorder."""
    rng = np.random.default_rng(3)
    for kernel in ("pview", "dense"):
        for _ in range(3):
            metrics_mod.record_kernel_events(
                kernel, rng.integers(0, 1000, 14).tolist(), registry)
    metrics_mod.record_kernel_events("crdt_merge", [5, 4, 3, 0], registry)
    for phase, secs in (("tick", 0.0123), ("stats", 0.0456)):
        metrics_mod.record_phase_seconds("pview", phase, secs, registry)
    ring = np.random.default_rng(4).integers(0, 50, (128, 20)).astype(
        np.int32)
    flight.record_ring("pview", types.SimpleNamespace(ring=ring, t=150),
                       registry=registry)


def test_renders_are_the_scripts():
    from corrosion_tpu.runtime import metrics as JM
    from corrosion_tpu_torch.runtime import metrics as TM
    from corrosion_tpu_torch.runtime import records as TR
    jreg, jfl = JM.Registry(), JR.FlightRecorder()
    treg, tfl = TM.Registry(), TR.FlightRecorder()
    _publish(jreg, jfl, JM, JR)
    _publish(treg, tfl, TM, TR)
    script = script_functions(
        "obs_report.py", ("render_registry_tables", "render_flight_section",
                          "sparkline", "_SPARK", "_FLIGHT_EVENT_LANES",
                          "_FLIGHT_CENSUS_LANES"),
        METRICS=jreg, FLIGHT=jfl, EVENTS_BY_KERNEL=JM.EVENTS_BY_KERNEL,
        kernel_event_totals=JM.kernel_event_totals)
    want = (_lines(script["render_registry_tables"], 150)
            + _lines(script["render_flight_section"], kernel="pview")
            + _lines(script["render_flight_section"], kernel="dense"))
    got = (_lines(obs_report.render_registry_tables, 150, registry=treg)
           + _lines(obs_report.render_flight_section, kernel="pview",
                    flight=tfl)
           + _lines(obs_report.render_flight_section, kernel="dense",
                    flight=tfl))
    assert got == want and len(want) > 40
    for vals in ([], [3, 3, 3], [0, 1, 2, 7, 3.5]):
        assert obs_report.sparkline(vals) == script["sparkline"](vals)


# ---------------------------------------------------------------------------
# entry points and CLIs

ENTRY_POINTS = {
    "pview_converge.run": lambda: pc.run(256, 64),
    "bench_smoke.run": lambda: bench_smoke.run(256, 64),
    "churn_sweep.run_config": lambda: churn_sweep.run_config("baseline",
                                                             256, 64),
    "churn_sweep.run": lambda: churn_sweep.run(256, 64),
    "chaos_soak.kernel_flight_phase": lambda: chaos_soak.kernel_flight_phase(),
    "chaos_soak.flaky_node_phase": lambda: chaos_soak.flaky_node_phase(),
    "obs_report.run": lambda: obs_report.run(256, 64),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_clis_write_only_with_out(monkeypatch, tmp_path, capsys):
    calls = []
    rec = {"rung": "A-convergence-7", "converged": True,
           "churn": {"skipped": True}}
    monkeypatch.setattr(pc, "run", lambda *a, **kw: calls.append((a, kw))
                        or dict(rec))
    pc.main([])
    assert calls[-1] == ((100_000, 2048), dict(
        chunk=25, max_ticks=2000, check_every=10, skip_churn=False,
        gossip_mode="shift", tick_mode="fused", log=calls[-1][1]["log"]))
    assert not list(tmp_path.iterdir())
    out = tmp_path / "scale.json"
    pc.main(["8192", "512", "--skip-churn", "--gossip-mode", "pick",
             "--out", str(out)])
    assert calls[-1][0] == (8192, 512) and calls[-1][1]["skip_churn"]
    assert json.loads(out.read_text()) == [rec]

    monkeypatch.setattr(bench_smoke, "run", lambda *a: calls.append(a)
                        or {"detail": {}})
    bench_smoke.main([])
    assert calls[-1] == (2048, 256, 600, False)
    bench_smoke.main(["--out", str(tmp_path / "smoke.json")])
    monkeypatch.setattr(churn_sweep, "run", lambda *a: calls.append(a)
                        or [{"rung": "x"}])
    churn_sweep.main([])
    assert calls[-1] == (8192, 512)
    churn_sweep.main(["2048", "256", "--out", str(tmp_path / "sweep.json")])
    assert calls[-1] == (2048, 256)
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".json"
                  ) == ["scale.json", "smoke.json", "sweep.json"]


# ---------------------------------------------------------------------------
# the reference constants


@pytest.mark.slow
def test_pview_churn_ref_is_the_jax_packages():
    for mode in ("shift", "pick"):
        rec = jax_pview_converge(*chip_smoke.PVIEW_CHURN_N, gossip_mode=mode,
                                 fast=False)
        assert pc.checked(rec) == chip_smoke.PVIEW_CHURN_REF[mode], mode


@pytest.mark.slow
def test_pview_churn_25k_ref_is_the_jax_packages():
    rec = jax_pview_converge(*chip_smoke.PVIEW_25K, fast=False)
    ref = chip_smoke.PVIEW_CHURN_25K_REF
    assert pc.checked(rec) == ref["checked"]
    assert tuple(_ref_row(r) for r in rec["history"]) == ref["history"]


_HISTORY = [[50, 0.9536399841308594, 511.0, 102.0, 1.0, 0.0, 1.0],
            [75, 0.9589200019836426, 511.0, 121.0, 1.0, 0.0, 1.0]]


@pytest.mark.parametrize("drift", [
    None,
    lambda h: h[:1],                              # a check missing
    lambda h: [h[0], [100] + h[1][1:]],           # another check's tick
    lambda h: [h[0], h[1][:1] + [0.95893] + h[1][2:]],  # coverage off
    lambda h: [h[0], h[1][:6] + [0.99]],          # detected short
])
def test_history_check_holds_every_check(drift):
    want = tuple(_ref_row(r) for r in _HISTORY)
    got = {"history": drift(_HISTORY) if drift else _HISTORY}
    if drift is None:
        chip_smoke._history_check("x", got, want)
    else:
        with pytest.raises(AssertionError, match="x: history"):
            chip_smoke._history_check("x", got, want)


@pytest.mark.slow
def test_smoke_ref_is_the_jax_packages():
    assert bench_smoke.checked(jax_bench_smoke()) == chip_smoke.SMOKE_REF


@pytest.mark.slow
def test_flight_ref_is_the_jax_packages():
    assert chaos_soak.checked(jax_kernel_flight(7), jax_flaky((3, 11))) \
        == chip_smoke.FLIGHT_REF


@pytest.mark.slow
def test_sweep_ref_is_the_jax_packages():
    n, k = chip_smoke.SWEEP_N
    got = {label: churn_sweep.checked(jax_sweep_config(
        label, n, k, **dict(churn_sweep.CONFIGS)[label]))
        for label in chip_smoke.SWEEP_REF}
    assert got == chip_smoke.SWEEP_REF




def _ref_row(row) -> tuple:
    """A history row as a reference pins it: the tick, then the six
    stats as float32 in their shortest repr."""
    return (row[0],) + tuple(float(str(np.float32(v))) for v in row[1:])


def ref_scale(name, n, k, skip_churn, max_ticks=2000):
    """One of the runs too large for a test, on the JAX package, run only
    where the table and XLA's temporaries for one dispatch fit in 90 % of
    the host's available memory; prints the arithmetic either way, then
    each check's history row as it is read, then the constant
    `chip_smoke.<name>`: the history, and `pview_converge.checked` of
    the run (without churn, the last check's event totals)."""
    import os
    import time
    chunk = 25
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    params = jax_params(n, k)
    shapes = jax.eval_shape(lambda: J.init_state(
        params, jax.random.PRNGKey(0), seed_mode="fingers"))
    key = jax.ShapeDtypeStruct((2,), np.uint32)
    temp = J.tick_n_donated.lower(shapes, key, params, chunk).compile(
        ).memory_analysis().temp_size_in_bytes
    table = n * k * 4
    print(f"n={n:_} K={k}: table {table:_} B, {chunk}-tick dispatch "
          f"temporaries {temp:_} B, host memory available {avail:_} B",
          flush=True)
    if table + temp > 0.9 * avail:
        print(f"{name} not run: the table and the temporaries do not fit")
        return
    t0 = time.monotonic()
    rec = jax_pview_converge(
        n, k, skip_churn=skip_churn, fast=False, max_ticks=max_ticks,
        log=lambda row: print(f"    {_ref_row(row)!r},  "
                              f"# {time.monotonic() - t0:.0f} s",
                              flush=True))
    ref = {"history": tuple(_ref_row(r) for r in rec["history"])}
    if skip_churn:
        ref["events"] = tuple(rec["raw"]["boot_events"])
    else:
        ref["checked"] = pc.checked(rec)
    print(f"{name} = {ref!r}  # converged={rec['converged']}, "
          f"{time.monotonic() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--ref-1m"]:
        ref_scale("PVIEW_1M_REF", *chip_smoke.PVIEW_1M, True,
                  *map(int, sys.argv[2:3]))
        sys.exit()
    if sys.argv[1:2] == ["--ref-25k"]:
        ref_scale("PVIEW_CHURN_25K_REF", *chip_smoke.PVIEW_25K, False)
        sys.exit()
    print("PVIEW_CHURN_REF = {")
    for mode in ("shift", "pick"):
        rec = jax_pview_converge(*chip_smoke.PVIEW_CHURN_N, gossip_mode=mode,
                                 fast=False)
        print(f"    {mode!r}: {pc.checked(rec)!r},", flush=True)
    print("}")
    print(f"SMOKE_REF = {bench_smoke.checked(jax_bench_smoke())!r}",
          flush=True)
    ref = chaos_soak.checked(jax_kernel_flight(7), jax_flaky((3, 11)))
    print(f"FLIGHT_REF = {ref!r}", flush=True)
    n, k = chip_smoke.SWEEP_N
    print("SWEEP_REF = {")
    for label in ("baseline", "lifeguard"):
        rec = jax_sweep_config(label, n, k,
                               **dict(churn_sweep.CONFIGS)[label])
        print(f"    {label!r}: {churn_sweep.checked(rec)!r},", flush=True)
    print("}")
