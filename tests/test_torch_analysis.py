"""Tier-1 gate for the port's corro-analyze (`corrosion_tpu_torch/analysis/`).

What the port's analyzer promises, each held here:

(a) THE PORT'S TREE IS CLEAN: every rule runs over `corrosion_tpu_torch/`
    against `ANALYSIS_BASELINE_TORCH.json` with no new finding and no
    stale entry, every entry justified, and
    `python -m corrosion_tpu_torch.corro_lint` exits 0 in under 10 s.
(b) THE SAME RAW FINDINGS AS THE REFERENCE: for the nine rules that do
    not depend on the framework's idiom, the JAX package's checkers with
    their scopes pointed at the port's tree and the port's own checkers
    find the same (rule, path, line, symbol, message, snippet).
(c) LANE MODELS: the port's model of SwimState and PViewState equals the
    reference's model of the JAX package's two states.
(d) SEEDED FIXTURES: every fixture of tests/test_static_analysis.py runs
    through both analyzers, written under `corrosion_tpu/` for the
    reference and `corrosion_tpu_torch/` for the port: both fire with
    the same findings, the minimal fix passes in both, noqa suppresses
    in both.  The idiom rules' fixtures are translated (jnp -> torch,
    jit roots -> DEVICE_ROOTS) line for line.
(e) TORCH KERNEL-PURITY: the rewritten rule's own fixtures.

All pure AST: no tracing, no card, no sqlite, no network.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import corrosion_tpu.analysis as r_analysis  # noqa: E402
import corrosion_tpu_torch.analysis as p_analysis  # noqa: E402
from corrosion_tpu.analysis import (  # noqa: E402
    actuators as r_actuators,
    blocking as r_blocking,
    capture_parity as r_capture,
    codecext as r_codecext,
    finalize_parity as r_finalize,
    lockcheck as r_lockcheck,
    metricsdoc as r_metricsdoc,
    parity as r_parity,
    profiler_safety as r_profiler,
    purity as r_purity,
    timeouts as r_timeouts,
)
from corrosion_tpu_torch import corro_lint, lint_metrics  # noqa: E402
from corrosion_tpu_torch.analysis import (  # noqa: E402
    actuators as p_actuators,
    blocking as p_blocking,
    capture_parity as p_capture,
    codecext as p_codecext,
    core as p_core,
    finalize_parity as p_finalize,
    lockcheck as p_lockcheck,
    metricsdoc as p_metricsdoc,
    parity as p_parity,
    profiler_safety as p_profiler,
    purity as p_purity,
    timeouts as p_timeouts,
)

REF = SimpleNamespace(
    pkg="corrosion_tpu", analysis=r_analysis, actuators=r_actuators,
    blocking=r_blocking, capture=r_capture, codecext=r_codecext,
    finalize=r_finalize, lockcheck=r_lockcheck, metricsdoc=r_metricsdoc,
    parity=r_parity, profiler=r_profiler, purity=r_purity,
    timeouts=r_timeouts,
)
PORT = SimpleNamespace(
    pkg="corrosion_tpu_torch", analysis=p_analysis, actuators=p_actuators,
    blocking=p_blocking, capture=p_capture, codecext=p_codecext,
    finalize=p_finalize, lockcheck=p_lockcheck, metricsdoc=p_metricsdoc,
    parity=p_parity, profiler=p_profiler, purity=p_purity,
    timeouts=p_timeouts,
)


def _write(root, rel, body):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(textwrap.dedent(body))
    return rel


def _norm(findings, pkg=None):
    """Findings as sortable tuples; with `pkg`, the package's name taken
    out of paths and messages, so the reference's fixture findings and
    the port's can be compared."""
    def cut(text):
        return text.replace(pkg, "{pkg}") if pkg else text

    def snippet(f):
        # metrics-doc's snippet is its message cut at 72 characters,
        # which a longer package name cuts elsewhere
        if pkg and f.message.startswith(f.snippet):
            return "<message>"
        return cut(f.snippet)

    return sorted(
        (f.rule, cut(f.path), f.line, f.symbol, cut(f.message), snippet(f))
        for f in findings
    )


@pytest.fixture(scope="module")
def port_ctx():
    """One parse of the tree for the module: the reference's checkers
    read it through the same cache (a context is only a file cache)."""
    return p_analysis.AnalysisContext(REPO)


# -- (a) the port's tree ----------------------------------------------------


def test_port_tree_runs_clean_against_baseline(port_ctx):
    t0 = time.monotonic()
    result = p_analysis.run_analysis(port_ctx)
    elapsed = time.monotonic() - t0
    assert result.new == [], "\n".join(f.render() for f in result.new)
    assert result.stale_keys == [], result.stale_keys
    assert elapsed < 10.0, f"corro-analyze took {elapsed:.1f}s (budget 10s)"
    # the three lock-discipline name collisions are suppressed on their
    # lines, and kernel-purity's baselined sites are the device roots'
    assert sorted(
        (f.rule, f.path) for f in result.suppressed
    ) == [
        ("lock-discipline", "corrosion_tpu_torch/net/quic.py"),
        ("lock-discipline", "corrosion_tpu_torch/pubsub/fanout.py"),
        ("lock-discipline", "corrosion_tpu_torch/pubsub/fanout.py"),
    ]
    assert {f.rule for f, _ in result.baselined} == {"kernel-purity"}


def test_port_baseline_file_is_committed_and_justified():
    with open(os.path.join(REPO, p_core.BASELINE_FILE)) as f:
        data = json.load(f)
    assert p_core.BASELINE_FILE == "ANALYSIS_BASELINE_TORCH.json"
    assert data["version"] == 1
    assert data["entries"], "kernel-purity's sites are the roots' to-do list"
    for e in data["entries"]:
        assert e.get("justification"), f"unjustified baseline entry {e}"
        assert "UNREVIEWED" not in e["justification"], e
        assert e["key"].split("|")[1].startswith("corrosion_tpu_torch/"), e


def test_corro_lint_module_is_clean_and_fast():
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "corrosion_tpu_torch.corro_lint"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    elapsed = time.monotonic() - t0
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK — 11 rule(s) clean" in out.stdout, out.stdout
    assert elapsed < 10.0, f"corro_lint took {elapsed:.1f}s (budget 10s)"


@pytest.mark.parametrize("argv, code", [
    (["--rules", "metrics-doc"], 0),
    (["--rules", "nonsense"], 2),
])
def test_corro_lint_rules_and_exit_codes(argv, code):
    assert corro_lint.main(argv) == code


def test_corro_lint_lists_kernel_purity_baseline(capsys):
    assert corro_lint.main(["--rules", "kernel-purity", "-v"]) == 0
    listed = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("corro_lint: baselined")]
    assert listed and all("[kernel-purity]" in ln for ln in listed)
    assert all("corrosion_tpu_torch/ops/" in ln for ln in listed)


def test_corro_lint_finds_a_new_finding(tmp_path, monkeypatch):
    # corro_lint's exit 1: a fresh tree with one racy class and no
    # baseline
    _write(tmp_path, "corrosion_tpu_torch/pkg/store.py", _RACY_CLASS)
    monkeypatch.setattr(corro_lint, "repo_root", lambda: str(tmp_path))
    assert corro_lint.main(["--rules", "lock-discipline"]) == 1


def test_lint_metrics_module_matches_reference_inventory():
    """The port's metric-name lint keeps the shim's API, is clean, and
    sees the same series the JAX package emits."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import lint_metrics as ref_lint  # scripts/lint_metrics.py

    assert lint_metrics.lint() == []
    literals, wildcards = lint_metrics.scan_call_sites()
    ref_literals, ref_wildcards = ref_lint.scan_call_sites()
    assert set(literals) == set(ref_literals)
    assert len(wildcards) == len(ref_wildcards) == 2
    assert all(
        p.startswith("corrosion_tpu_torch/")
        for paths in literals.values() for p in paths
    )
    names = lint_metrics.parse_components_table()
    assert len(names) == len(set(names))
    assert set(literals) <= set(names)


# -- (b) the same raw findings as the reference, on the real tree -----------

# rule -> (reference checker with the port's scopes, port checker)
REAL_TREE_PAIRS = {
    "async-blocking": lambda: (
        r_blocking.AsyncBlockingChecker(scope=p_blocking.SCOPE),
        p_blocking.AsyncBlockingChecker()),
    "timeout-discipline": lambda: (
        r_timeouts.TimeoutDisciplineChecker(scope=p_timeouts.SCOPE),
        p_timeouts.TimeoutDisciplineChecker()),
    "lock-discipline": lambda: (
        r_lockcheck.LockDisciplineChecker(scope=p_lockcheck.SCOPE),
        p_lockcheck.LockDisciplineChecker()),
    "codec-ext": lambda: (
        r_codecext.CodecExtChecker(codec_files=p_codecext.CODEC_FILES,
                                   test_files=p_codecext.TEST_FILES),
        p_codecext.CodecExtChecker()),
    "capture-parity": lambda: (
        r_capture.CaptureParityChecker(crdt=p_capture.CRDT_FILE,
                                       capture=p_capture.CAPTURE_FILE),
        p_capture.CaptureParityChecker()),
    "finalize-parity": lambda: (
        r_finalize.FinalizeParityChecker(crdt=p_finalize.CRDT_FILE,
                                         cpp=p_finalize.CPP_FILE),
        p_finalize.FinalizeParityChecker()),
    "actuator-discipline": lambda: (
        r_actuators.ActuatorDisciplineChecker(scope=p_actuators.SCOPE),
        p_actuators.ActuatorDisciplineChecker()),
    "profiler-safety": lambda: (
        r_profiler.ProfilerSafetyChecker(scope=p_profiler.SCOPE,
                                         roots=p_profiler.ROOTS),
        p_profiler.ProfilerSafetyChecker()),
    "metrics-doc": lambda: (
        r_metricsdoc.MetricsDocChecker(), p_metricsdoc.MetricsDocChecker()),
}


@pytest.mark.parametrize("rule", sorted(REAL_TREE_PAIRS))
def test_real_tree_raw_findings_match_reference(rule, port_ctx, monkeypatch):
    monkeypatch.setattr(r_metricsdoc, "SCAN_DIRS", p_metricsdoc.SCAN_DIRS)
    ref, port = REAL_TREE_PAIRS[rule]()
    assert ref.rule == port.rule == rule
    got = port.run(port_ctx)
    want = ref.run(port_ctx)
    assert _norm(got) == _norm(want)
    if rule == "lock-discipline":
        # the three name collisions, raw: both analyzers see them
        assert [(f[1], f[3]) for f in _norm(got)] == [
            ("corrosion_tpu_torch/net/quic.py",
             "QuicConnection._build_packet"),
            ("corrosion_tpu_torch/pubsub/fanout.py", "StreamSink.flush"),
            ("corrosion_tpu_torch/pubsub/fanout.py", "StreamSink.flush"),
        ]


def test_real_tree_scopes_are_the_ports(port_ctx):
    for scope in (p_blocking.SCOPE, p_timeouts.SCOPE, p_lockcheck.SCOPE,
                  p_actuators.SCOPE, p_profiler.SCOPE, p_purity.SCOPE,
                  p_codecext.CODEC_FILES, p_metricsdoc.SCAN_DIRS,
                  (p_capture.CRDT_FILE, p_capture.CAPTURE_FILE,
                   p_finalize.CRDT_FILE, p_parity.DENSE, p_parity.PVIEW,
                   p_parity.METRICS)):
        assert all(s.startswith("corrosion_tpu_torch") for s in scope), scope
    assert all(t.startswith("tests/test_torch_")
               for t in p_codecext.TEST_FILES)
    # codec-ext actually saw the port's gates
    gates = {}
    for rel in p_codecext.CODEC_FILES:
        gates.update(p_codecext._gate_constants(port_ctx.file(rel).tree))
    assert {"_SWIM_EXT_V1", "_ENVELOPE_EXT_V1", "_ENVELOPE_EXT_V2"} <= set(
        gates)


# -- (c) lane models ---------------------------------------------------------


@pytest.mark.parametrize("module", ["swim", "swim_pview"])
def test_lane_model_equals_reference(module, port_ctx):
    def model(mod, ctx, pkg):
        m = mod._KernelModel(ctx.file(f"{pkg}/ops/{module}.py"))
        return (
            m.state_class.name,
            [name for name, _ in m.fields],
            [(lane.name, lane.dtype, lane.kind) for lane in m.lanes.values()],
        )

    got = model(p_parity, port_ctx, "corrosion_tpu_torch")
    want = model(r_parity, port_ctx, "corrosion_tpu")
    assert got == want
    assert all(dtype is not None for _n, dtype, _k in got[2])


def test_lane_parity_real_tree_is_clean(port_ctx):
    assert p_parity.LaneParityChecker().run(port_ctx) == []


# -- (d) the reference's seeded fixtures, through both analyzers ------------

_PURE_KERNEL = """
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("params",))
    def tick_impl(state, rng, params):
        mask = jnp.greater(state, 0)
        if params.fancy:              # static branch: fine
            extra = jnp.sum(mask)
        else:
            extra = jnp.int32(0)
        return jnp.where(mask, state + extra, state)
"""

_IMPURE_KERNEL = """
    import functools
    import time
    import numpy as np
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("params",))
    def tick_impl(state, rng, params):
        t0 = time.monotonic()
        host = np.asarray(state)
        total = float(jnp.sum(state))
        peek = state.sum().item()
        if jnp.any(state > 0):
            state = state + 1
        mask = jnp.greater(state, 0)
        while mask.all():
            break
        return state
"""

# the same two kernels in the port's idiom, line for line
_PURE_TORCH = """
    import torch

    DEVICE_ROOTS = ("tick_impl",)


    def tick_impl(state, rng, params: "Params"):
        mask = torch.gt(state, 0)
        if params.fancy:              # static branch: fine
            extra = torch.sum(mask)
        else:
            extra = torch.zeros((), dtype=torch.int32)
        return torch.where(mask, state + extra, state)
"""

_IMPURE_TORCH = """
    import time
    import numpy as np
    import torch

    DEVICE_ROOTS = ("tick_impl",)


    def tick_impl(state, rng, params: "Params"):
        t0 = time.monotonic()
        host = np.asarray(state)
        total = float(torch.sum(state))
        peek = state.sum().item()
        if torch.any(state > 0):
            state = state + 1
        mask = torch.gt(state, 0)
        while mask.all():
            break
        return state
"""

_HOST_WRAPPER = """
    def stats_and_events(state):
        import numpy as np
        return float(np.asarray(state).sum())
"""

_PURITY_KINDS = ("time.", "numpy", "float()", ".item()", "`if`", "`while`")


def _purity_kinds(findings):
    """(line, symbol, kind) per finding: the two rules word their
    messages for their own framework, but name the same kinds."""
    return sorted(
        (f.line, f.symbol, next(k for k in _PURITY_KINDS if k in f.message))
        for f in findings
    )


def _purity_case(tmp_path, ref_body, port_body, noqa=False):
    out = {}
    for side, body in ((REF, ref_body), (PORT, port_body)):
        if noqa:
            body = body.replace(
                "peek = state.sum().item()",
                "peek = state.sum().item()  # corro: noqa[kernel-purity]",
            )
        root = tmp_path / side.pkg
        _write(root, f"{side.pkg}/ops/kern.py", body)
        ctx = side.analysis.AnalysisContext(str(root))
        checker = side.purity.KernelPurityChecker(scope=(f"{side.pkg}/ops",))
        if noqa:
            out[side.pkg] = side.analysis.run_analysis(ctx, [checker], {})
        else:
            out[side.pkg] = checker.run(ctx)
    return out["corrosion_tpu"], out["corrosion_tpu_torch"]


def test_kernel_purity_fires_on_seeded_violations_in_both(tmp_path):
    ref, port = _purity_case(tmp_path, _IMPURE_KERNEL, _IMPURE_TORCH)
    assert _purity_kinds(port) == _purity_kinds(ref)
    assert {k for _l, _s, k in _purity_kinds(port)} == set(_PURITY_KINDS)
    assert all(f.path == "corrosion_tpu_torch/ops/kern.py"
               and f.symbol == "tick_impl" for f in port)


@pytest.mark.parametrize("extra", ["", _HOST_WRAPPER],
                         ids=["minimal_fix", "host_wrapper"])
def test_kernel_purity_minimal_fix_and_host_wrappers_pass_in_both(
        tmp_path, extra):
    ref, port = _purity_case(tmp_path, _PURE_KERNEL + extra,
                             _PURE_TORCH + extra)
    assert ref == [] and port == []


def test_kernel_purity_noqa_suppresses_in_both(tmp_path):
    ref, port = _purity_case(tmp_path, _IMPURE_KERNEL, _IMPURE_TORCH,
                             noqa=True)
    for result in (ref, port):
        assert any(".item()" in f.message for f in result.suppressed)
        assert not any(".item()" in f.message for f in result.new)
        assert result.new  # the other violations still fail
    assert _purity_kinds(port.new) == _purity_kinds(ref.new)


def _parity_fixture(root, pkg, torch_idiom, pview_lane="lhm",
                    pview_dtype="int32", mesh_names='"events"',
                    extra_dense_lane="", census_lanes=2):
    """The reference's lane-parity fixture, in jnp for the reference and
    in torch (module and local dtype constants, a local `zeros` helper)
    for the port."""
    if torch_idiom:
        np_, arr = "torch", "torch.Tensor"
        pview_dt = (pview_dtype if pview_dtype == "LANE_DTYPE"
                    else f"torch.{pview_dtype}")
        dense_init = """
            i32 = torch.int32

            def zeros(*shape, dtype=i32):
                return torch.zeros(shape, dtype=dtype)

            return SwimState(
                t=zeros(),
                alive=torch.ones(n, dtype=torch.bool),
                events=zeros(4),
                lhm=zeros(n),
                {ring}
            )"""
        ring = "ring=zeros(8, 4)," if extra_dense_lane else ""
        pview_init = f"""
            return PViewState(
                t=torch.zeros((), dtype=torch.int32),
                alive=torch.ones(n, dtype=torch.bool),
                events=torch.zeros(4, dtype=torch.int32),
                {pview_lane}=torch.zeros(n, dtype={pview_dt}),
            )"""
        lane_dtype = "torch.int16"
    else:
        np_, arr = "jnp", "jax.Array"
        pview_dt = (pview_dtype if pview_dtype == "LANE_DTYPE"
                    else f"jnp.{pview_dtype}")
        dense_init = """
            return SwimState(
                t=jnp.int32(0),
                alive=jnp.ones(n, dtype=bool),
                events=jnp.zeros(4, dtype=jnp.int32),
                lhm=jnp.zeros(n, dtype=jnp.int32),
                {ring}
            )"""
        ring = ("ring=jnp.zeros((8, 4), dtype=jnp.int32),"
                if extra_dense_lane else "")
        pview_init = f"""
            return PViewState(
                t=jnp.int32(0),
                alive=jnp.ones(n, dtype=bool),
                events=jnp.zeros(4, dtype=jnp.int32),
                {pview_lane}=jnp.zeros(n, dtype={pview_dt}),
            )"""
        lane_dtype = "jnp.int16"
    stacked = ", ".join(f"{np_}.sum(alive)" for _ in range(census_lanes))
    extra = extra_dense_lane.replace("jax.Array", arr)
    _write(root, f"{pkg}/ops/swim.py", f"""
        import jax
        import jax.numpy as jnp
        import torch
        from {pkg}.runtime.metrics import FLIGHT_CENSUS, KERNEL_EVENTS

        class SwimState:
            t: {arr}
            alive: {arr}
            events: {arr}
            lhm: {arr}
            {extra}

        def _census_frame(n, alive):
            return {np_}.stack([{stacked}])

        def _event_vector(**counts):
            return {np_}.stack([counts[k] for k in KERNEL_EVENTS])

        def _init_state_impl(params, n):"""
           + textwrap.indent(textwrap.dedent(
               dense_init.replace("{ring}", ring)), " " * 12) + "\n")
    _write(root, f"{pkg}/ops/swim_pview.py", f"""
        import jax
        import jax.numpy as jnp
        import torch
        from {pkg}.ops.swim import _census_frame, _event_vector

        LANE_DTYPE = {lane_dtype}

        class PViewState:
            t: {arr}
            alive: {arr}
            events: {arr}
            {pview_lane}: {arr}

        def _init_impl(params, n):"""
           + textwrap.indent(textwrap.dedent(pview_init), " " * 12) + "\n")
    _write(root, f"{pkg}/mesh.py", f"""
        def _state_shardings(state, mesh):
            out = {{}}
            for name, arr in state._asdict().items():
                if getattr(arr, "ndim", 0) == 0 or name in ({mesh_names},):
                    out[name] = None
            return out
        """)
    _write(root, f"{pkg}/metrics.py", """
        KERNEL_EVENTS = ("a", "b", "c")
        FLIGHT_CENSUS = ("census_alive", "inc_max")
        FLIGHT_LANES = KERNEL_EVENTS + FLIGHT_CENSUS
        """)


PARITY_CASES = {
    "clean": (dict(), lambda fs: fs == []),
    "name_drift": (dict(pview_lane="lhm_score"), lambda fs: any(
        "diverges" in f.message and "lhm" in f.message for f in fs)),
    "dtype_drift": (dict(pview_dtype="LANE_DTYPE"), lambda fs: any(
        "dtype diverges" in f.message and "int16" in f.message
        for f in fs)),
    "unrouted_replicated_lane": (
        dict(extra_dense_lane="ring: jax.Array"), lambda fs: any(
            "ring" in f.message and "replicated" in f.message for f in fs)),
    "census_arity": (dict(census_lanes=3), lambda fs: [
        f.snippet for f in fs] == ["census-arity"]),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_lane_parity_fixture_in_both(tmp_path, case):
    kw, check = PARITY_CASES[case]
    found = {}
    for side in (REF, PORT):
        root = tmp_path / side.pkg
        _parity_fixture(root, side.pkg, side is PORT, **kw)
        found[side.pkg] = side.parity.LaneParityChecker(
            dense=f"{side.pkg}/ops/swim.py",
            pview=f"{side.pkg}/ops/swim_pview.py",
            mesh=f"{side.pkg}/mesh.py",
            metrics=f"{side.pkg}/metrics.py",
        ).run(side.analysis.AnalysisContext(str(root)))
    port = found["corrosion_tpu_torch"]
    assert _norm(port, "corrosion_tpu_torch") == _norm(
        found["corrosion_tpu"], "corrosion_tpu")
    assert check(port), "\n".join(f.render() for f in port)


# the idiom-free rules' fixtures, verbatim from tests/test_static_analysis.py

_BLOCKING_ASYNC = """
    import asyncio
    import shutil
    import sqlite3
    import time
    from pathlib import Path

    async def handler(conn, path):
        time.sleep(0.1)
        conn.execute("SELECT 1")
        sqlite3.connect("x.db")
        open(path).read()
        Path(path).read_text()
        shutil.rmtree(path)
"""

_ROUTED_ASYNC = """
    import asyncio
    import shutil
    import sqlite3
    import time
    from pathlib import Path

    async def handler(conn, path):
        def work():
            time.sleep(0.1)
            conn.execute("SELECT 1")
            sqlite3.connect("x.db")
            open(path).read()
            Path(path).read_text()
            shutil.rmtree(path)
        await asyncio.to_thread(work)
        await asyncio.sleep(0.1)
"""

_IMPORT_RESOLVED_ASYNC = """
    from dataclasses import replace
    from asyncio import sleep

    async def handler(obj):
        await sleep(0.1)
        return replace(obj, x=1)
"""

_RACY_CLASS = """
    import asyncio

    class Store:
        def __init__(self):
            self.data = {}

        def rebuild(self):
            self.data["fresh"] = 1

        def on_packet(self, k, v):
            self.data[k] = v

        async def loop(self):
            await asyncio.to_thread(self.rebuild)
"""

_LOCKED_CLASS = """
    import asyncio
    import threading

    class Store:
        def __init__(self):
            self.data = {}
            self._lock = threading.Lock()

        def rebuild(self):
            with self._lock:
                self.data["fresh"] = 1

        def on_packet(self, k, v):
            with self._lock:
                self.data[k] = v

        async def loop(self):
            await asyncio.to_thread(self.rebuild)
"""

_SYNC_CLOSE_WORKER = """
    import asyncio

    class Worker:
        def close(self):
            pass

    async def run(w):
        await asyncio.to_thread(w.close)
"""

_ASYNC_CLOSE_TRANSPORT = """
    class Transport:
        def __init__(self):
            self.conns = {}

        async def close(self):
            self.conns.clear()

        def on_open(self, k, v):
            self.conns[k] = v
"""

_CODEC_WRITER = """
    _FRAME_EXT_V1 = 1

    def encode_frame(payload, ext=False):
        out = bytes(payload)
        if ext:
            out += bytes([_FRAME_EXT_V1])
        return out
"""

_CODEC_READER = """
    def decode_frame(data):
        if data and data[-1] >= _FRAME_EXT_V1:
            return data[:-1]
        return data
"""

_CODEC_TEST = """
    def test_frame_ext_old_new_compat():
        from codec import encode_frame
        assert encode_frame(b"x") == b"x"
"""

_TRIG_OK = """
    SENTINEL = "-1"

    class Store:
        def _create_triggers(self, t):
            name = t.name
            cols = "".join(f"({c})" for c in t.non_pk_cols)
            self._conn.execute(
                f'CREATE TRIGGER "{name}__crdt_ins" AFTER INSERT {cols}'
            )
            self._conn.execute(
                f'CREATE TRIGGER "{name}__crdt_upd" AFTER UPDATE'
                f" VALUES ('{name}', '{SENTINEL}X', NULL) {cols}"
            )
            self._conn.execute(
                f'CREATE TRIGGER "{name}__crdt_del" AFTER DELETE'
                f" VALUES ('{name}', '{SENTINEL}X', NULL)"
            )

        def _drop_triggers(self, name):
            for suffix in ("ins", "upd", "del"):
                self._conn.execute(f'DROP TRIGGER "{name}__crdt_{suffix}"')
"""

_CAP_OK = """
    SENTINEL = "-1"
    DELETE_MARKER = SENTINEL + "X"
    CAPTURED_KINDS = {"insert": "ins", "update": "upd", "delete": "del"}

    def _cells_insert(meta, vals):
        return [(c, vals.get(c)) for c in meta.non_pk_cols]

    def _cells_update(meta, old, new):
        return [(c, new[c]) for c in meta.non_pk_cols if c in new]

    def _cells_delete(meta):
        return [(DELETE_MARKER, None)]
"""

_FINALIZE_OK = _TRIG_OK + """

    def _dedupe_pending(pending):
        marker = SENTINEL + "X"
        return [p for p in pending if p[1] != marker]

    def _finalize_engine():
        return "columnar"

    def _phase_b_columnar(self, specs):
        cells = [s for s in specs if s[2] != SENTINEL]
        return write_change_cells(cells, b"site")
"""

_NATIVE_CRDT_OK = """
    SENTINEL = "-1"
    _NATIVE_FINALIZE_ABI = 2
    _NATIVE_SENTINEL_CID = -1

    def _finalize_engine():
        return "native"

    class Store:
        def _phase_b_columnar(self, specs):
            return [s for s in specs if s[2] != SENTINEL]

        def _phase_b_native(self, specs):
            lib = finalize_batch_lib()
            if lib is None:
                METRICS.counter(
                    "corro.write.finalize.native.unavailable"
                ).inc()
                return self._phase_b_columnar(specs)
            cells = [s for s in specs if s[2] != SENTINEL]
            return write_change_cells(cells, b"site")
"""

_NATIVE_CPP_OK = """
    #define FINALIZE_ABI_VERSION 2
    constexpr int32_t FIN_CID_SENTINEL = -1;
    extern "C" int crdt_finalize_batch(int32_t n_items) {
      int64_t cl = 3;
      cl += (cl & 1);
      if (cl % 2 == 0) return 0;
      return 0;
    }
"""

_UNBOUNDED_NET_AWAITS = """
    async def session(stream, transport, addr):
        stream2 = await transport.open_bi(addr)
        await stream.send(b"hello")
        frame = await stream.recv()
        await transport.send_uni(addr, b"payload")
        await stream.finish()
        return frame
"""

_BOUNDED_NET_AWAITS = """
    import asyncio

    RECV_TIMEOUT = 10.0
    SEND_TIMEOUT = 30.0

    async def session(stream, transport, addr):
        stream2 = await asyncio.wait_for(
            transport.open_bi(addr), SEND_TIMEOUT
        )
        await asyncio.wait_for(stream.send(b"hello"), SEND_TIMEOUT)
        frame = await asyncio.wait_for(stream.recv(), RECV_TIMEOUT)
        await asyncio.wait_for(
            transport.send_uni(addr, b"payload"), SEND_TIMEOUT
        )
        await asyncio.wait_for(stream.finish(), SEND_TIMEOUT)
        return frame
"""

_CHANNEL_AWAITS = """
    async def pump(agent, addr, data):
        item = await agent.rx_apply.recv()
        await agent.tx_bcast.send(item)
        await agent.transport.send_datagram(addr, data)
"""

_DISCIPLINED_ACTUATOR = """
    from corrosion_tpu.chaos.faults import CENSUS
    from corrosion_tpu.runtime.records import FLIGHT

    async def _act_restart(agent):
        drill = CENSUS.snapshot()
        FLIGHT.record_host_frame("remediation", {"restart": 1})
        return {"drill": drill.get("scenario")}

    def registry(cfg):
        return {
            "restart": Actuator(
                name="restart", rule="loop-lag", summary="s",
                cooldown_secs=30.0, act=_act_restart,
            )
        }
"""

_SLOPPY_ACTUATORS = """
    from corrosion_tpu.chaos.faults import CENSUS
    from corrosion_tpu.runtime.records import FLIGHT

    async def _act_no_census(agent):
        FLIGHT.record_host_frame("remediation", {"x": 1})
        return {}

    async def _act_no_flight(agent):
        CENSUS.snapshot()
        return {}

    def registry(cfg):
        return {
            # no cooldown at all: flaps every supervisor tick
            "a": Actuator(name="a", rule="r", summary="s",
                          act=_act_no_census),
            # zero cooldown: same flap, dressed up
            "b": Actuator(name="b", rule="r", summary="s",
                          cooldown_secs=0, act=_act_no_flight),
            # lambda act: body invisible to the discipline scan
            "c": Actuator(name="c", rule="r", summary="s",
                          cooldown_secs=5.0, act=lambda agent: None),
        }
"""

_HOT_SAMPLER_SLOPPY = """
    import asyncio
    import json

    log = None
    METRICS = None


    class Ring:
        def add_sample(self, key):
            with self._map_lock:
                self.folded[key] = self.folded.get(key, 0) + 1


    class Sampler:
        def sample_once(self):
            loop = asyncio.get_event_loop()
            self._gate.acquire()
            key = f"{loop}"
            frames = [f for f in (1, 2)]
            top = sorted(frames)
            payload = json.dumps(key)
            log.debug("sampled %s", payload)
            METRICS.counter("x").inc()
            db = self.agent
            add = self.ring.add_sample
            add(key)
            self._flush_coldpath()

        def _flush_coldpath(self):
            # exempt by suffix: bounded by cadence, not sample rate
            with self._big_lock:
                return sorted(json.dumps("x"))
"""

_HOT_SAMPLER_CLEAN = """
    import sys
    import time


    class Ring:
        def add_sample(self, key):
            with self._fold_lock:
                fmap = self._open.folded
                n = fmap.get(key)
                fmap[key] = 1 if n is None else n + 1


    class Sampler:
        def sample_once(self):
            t0 = time.monotonic()
            add = self.ring.add_sample
            for tid, frame in sys._current_frames().items():
                sub = self._tids.get(tid)
                if sub is None:
                    sub = self._classify_coldpath(tid)
                add(sub + ";" + str(frame.f_lineno))
            self._adapt_coldpath(t0)

        def _classify_coldpath(self, tid):
            # a cold function MAY take its own lock and touch metrics
            with self._reg_lock:
                self._tids[tid] = "other"
            return "other"

        def _adapt_coldpath(self, t0):
            self.registry.gauge("corro.profile.overhead.pct").set(0.0)
"""

_METRICS_EMITTER = """
    def publish(METRICS, kind):
        METRICS.counter("corro.demo.total").inc()
        METRICS.gauge(f"corro.demo.{kind}.depth").set(1)
"""

_COMPONENTS_TABLE = """
    # Components

    <!-- metrics-table:begin -->
    | series | meaning |
    |---|---|
    | `corro.demo.total` | demo counter |
    | `corro.demo.queue.depth` | demo gauge |
    {extra}
    <!-- metrics-table:end -->
"""


def _fixture(*files):
    """{path with `{pkg}` for the package: body}."""
    return dict(files)


def _sub(body, old, new):
    assert old in body, old
    return body.replace(old, new)


_CAP_NOQA = _sub(
    _CAP_OK,
    'CAPTURED_KINDS = {"insert": "ins", "update": "upd", "delete": "del"}',
    'CAPTURED_KINDS = {"insert": "ins", "update": "upd"}'
    "  # corro: noqa[capture-parity]",
)


def _raw(files, make, check):
    return ("raw", files, make, check)


def _filtered(files, make, check):
    return ("filtered", files, make, check)


def _msgs(fs):
    return "\n".join(f.message for f in fs)


def _blocking(s, pkg):
    return s.blocking.AsyncBlockingChecker(scope=(f"{pkg}/agent",))


def _lock(s, pkg):
    return s.lockcheck.LockDisciplineChecker(scope=(f"{pkg}/pkg",))


def _codec(s, pkg):
    return s.codecext.CodecExtChecker(
        codec_files=(f"{pkg}/codec.py",), test_files=("tests/test_codec.py",))


def _capture(s, pkg):
    return s.capture.CaptureParityChecker(
        crdt=f"{pkg}/store/crdt.py", capture=f"{pkg}/store/capture.py")


def _finalize(s, pkg):
    return s.finalize.FinalizeParityChecker(
        crdt=f"{pkg}/store/crdt.py", cpp="native/crdt_batch.cpp")


def _timeouts(s, pkg):
    return s.timeouts.TimeoutDisciplineChecker(scope=(f"{pkg}/agent",))


def _actuators(s, pkg):
    return s.actuators.ActuatorDisciplineChecker()  # the default scope


def _profiler(s, pkg):
    return s.profiler.ProfilerSafetyChecker(scope=(f"{pkg}/pkg/sampler.py",))


def _metrics(s, pkg):
    return s.metricsdoc.MetricsDocChecker()  # the package, COMPONENTS.md


def _snippets(*want):
    return lambda fs: any(f.snippet in want for f in fs)


_LOOPY = "{pkg}/agent/loopy.py"
_STORE = "{pkg}/pkg/store.py"
_CRDT, _CAP = "{pkg}/store/crdt.py", "{pkg}/store/capture.py"
_CPP = "native/crdt_batch.cpp"
_REMED = "{pkg}/agent/remed.py"
_SAMPLER = "{pkg}/pkg/sampler.py"

FIXTURES = {
    # async-blocking
    "async_blocking_fires": _raw(
        _fixture((_LOOPY, _BLOCKING_ASYNC)), _blocking,
        lambda fs: len(fs) == 6 and all(k in _msgs(fs) for k in (
            "time.sleep", ".execute", "sqlite3.connect", "open()",
            "Path.read_text", "rmtree"))),
    "async_blocking_nested_thread_bodies_pass": _raw(
        _fixture((_LOOPY, _ROUTED_ASYNC)), _blocking, lambda fs: fs == []),
    "async_blocking_import_resolution": _raw(
        _fixture((_LOOPY, _IMPORT_RESOLVED_ASYNC)), _blocking,
        lambda fs: fs == []),
    "async_blocking_noqa": _filtered(
        _fixture((_LOOPY, _sub(
            _BLOCKING_ASYNC, "time.sleep(0.1)",
            "time.sleep(0.1)  # corro: noqa[async-blocking]"))),
        _blocking, lambda r: len(r.suppressed) == 1 and len(r.new) == 5),
    # lock-discipline
    "lock_discipline_fires": _raw(
        _fixture((_STORE, _RACY_CLASS)), _lock,
        lambda fs: len(fs) == 1 and "Store.data" in fs[0].message
        and "rebuild" in fs[0].message),
    "lock_discipline_locked_fix_passes": _raw(
        _fixture((_STORE, _LOCKED_CLASS)), _lock, lambda fs: fs == []),
    "lock_discipline_async_name_collision_exempt": _raw(
        _fixture(("{pkg}/pkg/other.py", _SYNC_CLOSE_WORKER),
                 ("{pkg}/pkg/transport.py", _ASYNC_CLOSE_TRANSPORT)),
        _lock, lambda fs: fs == []),
    "lock_discipline_noqa": _filtered(
        _fixture((_STORE, _sub(
            _RACY_CLASS, 'self.data["fresh"] = 1',
            'self.data["fresh"] = 1  # corro: noqa[lock-discipline]'))),
        _lock, lambda r: r.new == [] and len(r.suppressed) == 1),
    # codec-ext
    "codec_ext_clean_when_exhaustive": _raw(
        _fixture(("{pkg}/codec.py", _CODEC_WRITER + _CODEC_READER),
                 ("tests/test_codec.py", _CODEC_TEST)),
        _codec, lambda fs: fs == []),
    "codec_ext_missing_reader": _raw(
        _fixture(("{pkg}/codec.py", _CODEC_WRITER),
                 ("tests/test_codec.py", _CODEC_TEST)),
        _codec, lambda fs: any("no read path" in f.message for f in fs)),
    "codec_ext_missing_compat_test": _raw(
        _fixture(("{pkg}/codec.py", _CODEC_WRITER + _CODEC_READER),
                 ("tests/test_codec.py", "\n")),
        _codec,
        lambda fs: any("compat pin is missing" in f.message for f in fs)),
    # capture-parity
    "capture_parity_clean_when_lockstep": _raw(
        _fixture((_CRDT, _TRIG_OK), (_CAP, _CAP_OK)), _capture,
        lambda fs: fs == []),
    "capture_parity_uncovered_trigger_kind": _raw(
        _fixture((_CRDT, _TRIG_OK),
                 (_CAP, _sub(_CAP_OK, ', "delete": "del"', ""))),
        _capture, lambda fs: any("__crdt_del" in f.message for f in fs)),
    "capture_parity_column_source_drift": _raw(
        _fixture((_CRDT, _TRIG_OK), (_CAP, _sub(
            _CAP_OK, "[(c, new[c]) for c in meta.non_pk_cols if c in new]",
            "[(c, v) for c, v in new.items()]"))),
        _capture, lambda fs: any(
            "column" in f.message and "_cells_update" in f.message
            for f in fs)),
    "capture_parity_delete_marker_drift": _raw(
        _fixture((_CRDT, _TRIG_OK), (_CAP, _sub(
            _CAP_OK, 'DELETE_MARKER = SENTINEL + "X"',
            'DELETE_MARKER = SENTINEL + "D"'))),
        _capture, lambda fs: any("delete-marker" in f.snippet for f in fs)),
    "capture_parity_missing_cells_builder": _raw(
        _fixture((_CRDT, _TRIG_OK), (_CAP, _sub(
            _CAP_OK, "def _cells_update", "def _other_update"))),
        _capture, lambda fs: any("_cells_update" in f.message for f in fs)),
    "capture_parity_noqa": _filtered(
        _fixture((_CRDT, _TRIG_OK), (_CAP, _CAP_NOQA)), _capture,
        lambda r: r.new == [] and r.suppressed),
    "capture_parity_clean_with_columnar_finalize": _raw(
        _fixture((_CRDT, _FINALIZE_OK), (_CAP, _CAP_OK)), _capture,
        lambda fs: fs == []),
    "capture_parity_finalize_marker_drift": _raw(
        _fixture((_CRDT, _sub(_FINALIZE_OK, 'marker = SENTINEL + "X"',
                              'marker = SENTINEL + "D"')), (_CAP, _CAP_OK)),
        _capture, lambda fs: _snippets("finalize-marker-drift")(fs)
        and all(f.path.endswith("store/crdt.py") for f in fs)),
    "capture_parity_columnar_encoder_drift": _raw(
        _fixture((_CRDT, _sub(_FINALIZE_OK,
                              'return write_change_cells(cells, b"site")',
                              "return cells")), (_CAP, _CAP_OK)),
        _capture, _snippets("columnar-encoder-drift")),
    "capture_parity_missing_columnar_builder": _raw(
        _fixture((_CRDT, _sub(_FINALIZE_OK, "def _phase_b_columnar",
                              "def _phase_b_other")), (_CAP, _CAP_OK)),
        _capture, _snippets("missing-columnar-builder")),
    # finalize-parity
    "finalize_parity_clean_when_lockstep": _raw(
        _fixture((_CRDT, _NATIVE_CRDT_OK), (_CPP, _NATIVE_CPP_OK)),
        _finalize, lambda fs: fs == []),
    "finalize_parity_silent_when_no_native_engine": _raw(
        _fixture((_CRDT, _sub(_NATIVE_CRDT_OK, 'return "native"',
                              'return "columnar"')),
                 (_CPP, _NATIVE_CPP_OK)),
        _finalize, lambda fs: fs == []),
    "finalize_parity_abi_version_drift": _raw(
        _fixture((_CRDT, _NATIVE_CRDT_OK), (_CPP, _sub(
            _NATIVE_CPP_OK, "#define FINALIZE_ABI_VERSION 2",
            "#define FINALIZE_ABI_VERSION 3"))),
        _finalize, lambda fs: _snippets("abi-version-drift")(fs)
        and all(f.path == _CPP for f in fs)),
    "finalize_parity_sentinel_id_drift": _raw(
        _fixture((_CRDT, _NATIVE_CRDT_OK), (_CPP, _sub(
            _NATIVE_CPP_OK, "FIN_CID_SENTINEL = -1",
            "FIN_CID_SENTINEL = -2"))),
        _finalize, _snippets("sentinel-id-drift")),
    "finalize_parity_missing_native_builder": _raw(
        _fixture((_CRDT, _sub(_NATIVE_CRDT_OK, "def _phase_b_native",
                              "def _phase_b_other")),
                 (_CPP, _NATIVE_CPP_OK)),
        _finalize, _snippets("missing-native-builder")),
    "finalize_parity_missing_export": _raw(
        _fixture((_CRDT, _NATIVE_CRDT_OK), (_CPP, _sub(
            _NATIVE_CPP_OK, 'extern "C" int crdt_finalize_batch',
            "static int finalize_impl"))),
        _finalize, _snippets("missing-native-export")),
    "finalize_parity_uncounted_fallback": _raw(
        _fixture((_CRDT, _sub(_NATIVE_CRDT_OK, """            if lib is None:
                METRICS.counter(
                    "corro.write.finalize.native.unavailable"
                ).inc()
                return self._phase_b_columnar(specs)
""", """            if lib is None:
                return self._phase_b_columnar(specs)
""")), (_CPP, _NATIVE_CPP_OK)),
        _finalize, _snippets("native-fallback-uncounted")),
    "finalize_parity_dropped_fallback": _raw(
        _fixture((_CRDT, _sub(_NATIVE_CRDT_OK,
                              "return self._phase_b_columnar(specs)",
                              "raise RuntimeError(lib)")),
                 (_CPP, _NATIVE_CPP_OK)),
        _finalize, _snippets("native-fallback-drift")),
    "finalize_parity_noqa": _filtered(
        _fixture((_CRDT, _sub(_sub(
            _NATIVE_CRDT_OK, "def _phase_b_native(self, specs):",
            "def _phase_b_native(self, specs):"
            "  # corro: noqa[finalize-parity]"),
            'return write_change_cells(cells, b"site")', "return cells")),
            (_CPP, _NATIVE_CPP_OK)),
        _finalize, lambda r: r.new == [] and r.suppressed),
    # timeout-discipline
    "timeout_discipline_fires": _raw(
        _fixture(("{pkg}/agent/sessions.py", _UNBOUNDED_NET_AWAITS)),
        _timeouts, lambda fs: len(fs) == 5 and all(
            "wrap in asyncio.wait_for" in f.message for f in fs)
        and any(".recv()" in f.snippet for f in fs)
        and any("open_bi" in f.snippet for f in fs)),
    "timeout_discipline_minimal_fix_passes": _raw(
        _fixture(("{pkg}/agent/sessions.py", _BOUNDED_NET_AWAITS)),
        _timeouts, lambda fs: fs == []),
    "timeout_discipline_exempts_channels_and_datagrams": _raw(
        _fixture(("{pkg}/agent/loops.py", _CHANNEL_AWAITS)),
        _timeouts, lambda fs: fs == []),
    "timeout_discipline_noqa": _filtered(
        _fixture(("{pkg}/agent/sessions.py", _sub(
            _UNBOUNDED_NET_AWAITS, 'await stream.send(b"hello")',
            'await stream.send(b"hello")  # corro: noqa[timeout-discipline]'
        ))),
        _timeouts, lambda r: len(r.suppressed) == 1 and len(r.new) == 4),
    # actuator-discipline
    "actuator_discipline_fires": _raw(
        _fixture((_REMED, _SLOPPY_ACTUATORS)), _actuators,
        lambda fs: len(fs) == 5 and all(k in _msgs(fs) for k in (
            "without cooldown_secs", "non-positive cooldown_secs=0",
            "CENSUS.snapshot", "FLIGHT.record_host_frame",
            "lambda/imported callable"))),
    "actuator_discipline_minimal_fix_passes": _raw(
        _fixture((_REMED, _DISCIPLINED_ACTUATOR)), _actuators,
        lambda fs: fs == []),
    "actuator_discipline_config_sourced_cooldown": _raw(
        _fixture((_REMED, _sub(_DISCIPLINED_ACTUATOR, "cooldown_secs=30.0",
                               "cooldown_secs=cfg.sync_cooldown_secs"))),
        _actuators, lambda fs: fs == []),
    "actuator_discipline_ignores_out_of_scope_probes": _raw(
        _fixture(("tests/test_probe.py", _SLOPPY_ACTUATORS)), _actuators,
        lambda fs: fs == []),
    "actuator_discipline_noqa": _filtered(
        _fixture((_REMED, _sub(
            _SLOPPY_ACTUATORS,
            '"c": Actuator(name="c", rule="r", summary="s",',
            '"c": Actuator(  # corro: noqa[actuator-discipline]\n'
            '              name="c", rule="r", summary="s",'))),
        _actuators, lambda r: len(r.suppressed) == 1 and len(r.new) == 4),
    # profiler-safety
    "profiler_safety_fires": _raw(
        _fixture((_SAMPLER, _HOT_SAMPLER_SLOPPY)), _profiler,
        lambda fs: len(fs) == 10 and all(k in _msgs(fs) for k in (
            "asyncio API", "acquires `_gate`", "acquires `_map_lock`",
            "f-string", "comprehension", "sorted()", "json call", "logging",
            "registry call", "traverses `.agent`"))
        and "_flush_coldpath" not in _msgs(fs)
        and any(f.symbol == "Ring.add_sample" for f in fs)),
    "profiler_safety_minimal_fix_passes": _raw(
        _fixture((_SAMPLER, _HOT_SAMPLER_CLEAN)), _profiler,
        lambda fs: fs == []),
    "profiler_safety_scope_is_explicit_files": _raw(
        _fixture(("{pkg}/pkg/other.py", _HOT_SAMPLER_SLOPPY)), _profiler,
        lambda fs: fs == []),
    "profiler_safety_noqa": _filtered(
        _fixture((_SAMPLER, _sub(
            _HOT_SAMPLER_SLOPPY, 'METRICS.counter("x").inc()',
            'METRICS.counter("x").inc()  # corro: noqa[profiler-safety]'))),
        _profiler, lambda r: len(r.suppressed) == 1 and len(r.new) == 9),
    # metrics-doc (the reference holds it on the real tree only; a seeded
    # drift in both directions here)
    "metrics_doc_clean": _raw(
        _fixture(("{pkg}/emit.py", _METRICS_EMITTER),
                 ("COMPONENTS.md", _COMPONENTS_TABLE.replace("{extra}", ""))),
        _metrics, lambda fs: fs == []),
    "metrics_doc_drift_both_directions": _raw(
        _fixture(("{pkg}/emit.py", _METRICS_EMITTER.replace(
            "corro.demo.total", "corro.x.total")),
                 ("COMPONENTS.md", _COMPONENTS_TABLE.replace(
                     "{extra}", "| `corro.demo.gone` | retired |"))),
        _metrics, lambda fs: {m.split(":")[0] for m in _msgs(fs).split(
            "\n")} == {"emitted but undocumented",
                       "documented but never emitted"}),
}


def _run_fixture(tmp_path, side, name):
    mode, files, make, _check = FIXTURES[name]
    root = tmp_path / side.pkg
    for rel, body in files.items():
        _write(root, rel.replace("{pkg}", side.pkg), body)
    ctx = side.analysis.AnalysisContext(str(root))
    checker = make(side, side.pkg)
    if mode == "raw":
        return checker.run(ctx)
    return side.analysis.run_analysis(ctx, [checker], baseline={})


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_same_findings_in_both(tmp_path, name):
    ref = _run_fixture(tmp_path, REF, name)
    port = _run_fixture(tmp_path, PORT, name)
    if FIXTURES[name][0] == "raw":
        assert _norm(port, PORT.pkg) == _norm(ref, REF.pkg)
    else:
        for part in ("new", "suppressed"):
            assert _norm(getattr(port, part), PORT.pkg) == _norm(
                getattr(ref, part), REF.pkg), part
    shown = port if FIXTURES[name][0] == "raw" else port.new
    assert FIXTURES[name][3](port), "\n".join(f.render() for f in shown)


@pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])
def test_baseline_grandfathers_and_goes_stale(tmp_path, side):
    _write(tmp_path, f"{side.pkg}/pkg/store.py", _RACY_CLASS)
    ctx = side.analysis.AnalysisContext(str(tmp_path))
    checker = _lock(side, side.pkg)
    finding = checker.run(ctx)[0]
    result = side.analysis.run_analysis(
        ctx, [checker], baseline={finding.key: "proven benign in test"})
    assert result.new == [] and result.ok
    assert [w for _, w in result.baselined] == ["proven benign in test"]
    _write(tmp_path, f"{side.pkg}/pkg/store.py", _LOCKED_CLASS)
    result2 = side.analysis.run_analysis(
        side.analysis.AnalysisContext(str(tmp_path)), [checker],
        baseline={finding.key: "proven benign in test"})
    assert result2.new == [] and not result2.ok
    assert result2.stale_keys == [finding.key]


def test_baseline_keys_are_line_number_free(tmp_path):
    keys = []
    for prefix in ("", "X = 1\nY = 2\n"):
        _write(tmp_path, "corrosion_tpu_torch/pkg/store.py",
               prefix + textwrap.dedent(_RACY_CLASS))
        keys.append(_lock(PORT, PORT.pkg).run(
            p_analysis.AnalysisContext(str(tmp_path)))[0].key)
    assert keys[0] == keys[1]


def test_save_baseline_round_trips(tmp_path):
    _write(tmp_path, "corrosion_tpu_torch/pkg/store.py", _RACY_CLASS)
    fs = _lock(PORT, PORT.pkg).run(p_analysis.AnalysisContext(str(tmp_path)))
    path = p_analysis.save_baseline(str(tmp_path), fs, {})
    assert os.path.basename(path) == "ANALYSIS_BASELINE_TORCH.json"
    got = p_analysis.load_baseline(str(tmp_path))
    assert list(got) == [fs[0].key] and "UNREVIEWED" in got[fs[0].key]


# -- (e) torch kernel-purity -------------------------------------------------


def _purity(tmp_path, body):
    _write(tmp_path, "corrosion_tpu_torch/ops/kern.py", body)
    ctx = p_analysis.AnalysisContext(str(tmp_path))
    return p_purity.KernelPurityChecker(
        scope=("corrosion_tpu_torch/ops",)), ctx


_ROOT_SYNCS = """
    import torch

    DEVICE_ROOTS = ("tick",)


    def tick(state: "SwimState", t: torch.Tensor, n: int):
        peek = t.sum().item()
        if t.any():
            t = t + 1
        return t


    def host_wrapper(state, t, n):
        peek = t.sum().item()
        if t.any():
            t = t + 1
        return t
"""


def test_purity_item_and_if_any_fire_in_a_device_root(tmp_path):
    checker, ctx = _purity(tmp_path, _ROOT_SYNCS)
    fs = checker.run(ctx)
    assert [(f.line, f.symbol) for f in fs] == [(8, "tick"), (9, "tick")]
    assert ".item()" in fs[0].message and "`if`" in fs[1].message


def test_purity_host_wrapper_is_out_of_scope(tmp_path):
    body = _ROOT_SYNCS.replace('DEVICE_ROOTS = ("tick",)',
                               "DEVICE_ROOTS = ()")
    checker, ctx = _purity(tmp_path, body)
    assert checker.run(ctx) == []


_GRAPH_ROOT = """
    import torch


    def _helper(x):
        return x.nonzero()


    def _program(buf, num_groups: int):
        if num_groups > 4:
            buf = buf + 1
        return _helper(buf) + buf.sum().item()


    def _unused(buf):
        return buf.item()


    class Replay:
        def __init__(self, buf):
            self.buf = buf
            _program(self.buf, 8)
            torch.cuda.current_stream().synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = _program(self.buf, 8)
"""


def test_purity_cuda_graph_body_calls_are_roots(tmp_path):
    checker, ctx = _purity(tmp_path, _GRAPH_ROOT)
    assert checker.closure(ctx.file("corrosion_tpu_torch/ops/kern.py")
                           .tree) == {"_program": {"_program", "_helper"}}
    fs = checker.run(ctx)
    # the int-annotated `num_groups` branch is a host branch; the
    # warm-up's stream synchronize is the host wrapper's
    assert sorted((f.symbol, f.line) for f in fs) == [
        ("_helper", 6), ("_program", 12)]
    assert "data-dependent" in fs[0].message or "data-dependent" in fs[
        1].message


_BOOL_INDEX = """
    import torch

    DEVICE_ROOTS = ("tick",)


    def tick(x, y):
        mask = x > 0
        picked = x[mask]
        x[mask] = 0
        x[~mask] = -1
        x[mask & (y < 3)] = y
        rows = x[:, 0]
        same = x[y.long()]
        return picked, rows, same
"""


def test_purity_bool_index_fires(tmp_path):
    checker, ctx = _purity(tmp_path, _BOOL_INDEX)
    fs = checker.run(ctx)
    # a load through a mask and a tensor stored through one sync; a
    # number stored through one is masked_fill; int and slice indexing
    # are plain gathers
    assert [f.line for f in fs] == [9, 12]
    assert all("bool" in f.message for f in fs)


_NONE_TESTS = """
    import torch

    DEVICE_ROOTS = ("tick",)


    def tick(x, y, bias=None):
        if bias is None:
            bias = torch.zeros_like(x)
        if y is not None:
            x = x + y
        return x + bias
"""


def test_purity_is_none_is_exempt(tmp_path):
    checker, ctx = _purity(tmp_path, _NONE_TESTS)
    assert checker.run(ctx) == []


def test_purity_noqa_suppresses(tmp_path):
    body = _ROOT_SYNCS.replace(
        "peek = t.sum().item()\n        if t.any():",
        "peek = t.sum().item()  # corro: noqa[kernel-purity]\n"
        "        if t.any():", 1)
    checker, ctx = _purity(tmp_path, body)
    result = p_analysis.run_analysis(ctx, [checker], baseline={})
    assert [f.line for f in result.suppressed] == [8]
    assert [f.line for f in result.new] == [9]


_MORE_SYNCS = """
    import functools
    import torch

    DEVICE_ROOTS = ("tick",)


    @functools.lru_cache(maxsize=8)
    def _table(k: int, device):
        return torch.tensor(list(range(k)), device=device)


    def _helper(x):
        return torch.where(x > 0)


    def tick(x, counts, k: int):
        table = _table(k, x.device)
        a = torch.unique(x)
        b = x.masked_select(x > 0)
        c = x.repeat_interleave(counts)
        d = x.repeat_interleave(counts, output_size=4)
        e = x.repeat_interleave(2)
        f = torch.tensor([1, 2], device=x.device)
        g = int(x.max()) + len(x) + x.shape[0] + int(k)
        h = x.any() and x.all()
        torch.cuda.synchronize()
        return _helper(x), table[x], a, b, c, d, e, f, g, h
"""


def test_purity_data_shaped_ops_copies_and_cached_tables(tmp_path):
    checker, ctx = _purity(tmp_path, _MORE_SYNCS)
    fs = checker.run(ctx)
    got = sorted((f.line, f.symbol) for f in fs)
    # unique, masked_select, repeat_interleave without output_size, the
    # host list copied in, int() of a tensor, `and` on tensors, the
    # synchronize, one-argument torch.where in the helper; the cached
    # table's body runs once per key and is not device code
    assert got == [(14, "_helper"), (19, "tick"), (20, "tick"),
                   (21, "tick"), (24, "tick"), (25, "tick"), (26, "tick"),
                   (27, "tick")]


def test_purity_real_tree_roots_and_host_wrappers(port_ctx):
    roots = {}
    for sf in port_ctx.walk(*p_purity.SCOPE):
        for root, reach in p_purity.KernelPurityChecker.closure(
                sf.tree).items():
            roots[f"{sf.path.rsplit('/', 1)[1]}::{root}"] = reach
    assert sorted(roots) == [
        "crdt_merge.py::_program", "swim.py::_stats_sums",
        "swim.py::tick_impl", "swim_pview.py::_stats_impl",
        "swim_pview.py::tick_impl",
    ]
    assert "_merge_kernel" in roots["crdt_merge.py::_program"]
    assert "dispatch_inbox" in roots["swim.py::tick_impl"]
    reach = set().union(*roots.values())
    for wrapper in ("run_to_coverage", "run_to_converged", "_readback",
                    "read_decisions", "merge_table_array", "run_packed",
                    "stats_and_events", "_susp_shrink_table"):
        assert wrapper not in reach, wrapper
    # the JAX package's jit-root rule finds nothing on the port's tree:
    # vacuous there, which is why the port's rule is its own
    assert r_purity.KernelPurityChecker(scope=p_purity.SCOPE).run(
        port_ctx) == []
