"""The port's runtime planes against the JAX package's on the CPU: the
trace store (`runtime/tracestore.py`), OTLP export (`runtime/otel.py`),
the span routing and statement tap of `runtime/trace.py`, the planes
`setup` builds, the plane-on endpoints of `api/http.py`, the host
sections of `obs_report.py`, `models/cluster.py::
cluster_observatory_scenario` and `planes_checks.scenario_planes`.

The TSDB, the rules and remediation are in `tests/test_torch_alerts.py`,
the profile store and the sampler in `tests/test_torch_profiler.py`.

The trace store, TSDB, profiler and exporter are process-global in each
package; every test that installs one uses `planes_reset`, which
uninstalls both packages' before and after the test and joins their
threads.

    JAX_PLATFORMS=cpu python -m tests.test_torch_planes --ref

prints `chip_smoke.PLANES_REF`: `planes_outcome` of the JAX package's
`scenario_planes` at `agent_checks.CHIP_NET` over plaintext QUIC (a few
minutes).
"""

import asyncio
import json
import re
import sys
import urllib.request
from pathlib import Path

import pytest

from corrosion_tpu.chaos import faults as jfaults
from corrosion_tpu.net.transport import TransportError as JTransportError
from corrosion_tpu.runtime import otel as jotel
from corrosion_tpu.runtime import profiler as jprofiler
from corrosion_tpu.runtime import records as jrecords
from corrosion_tpu.runtime import trace as jtrace
from corrosion_tpu.runtime import tracestore as jtracestore
from corrosion_tpu.runtime import tsdb as jtsdb
from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import obs_report as tobs
from corrosion_tpu_torch import planes_checks as pc
from corrosion_tpu_torch.chaos import faults as tfaults
from corrosion_tpu_torch.models import cluster as tcluster
from corrosion_tpu_torch.runtime import otel as totel
from corrosion_tpu_torch.runtime import profiler as tprofiler
from corrosion_tpu_torch.runtime import trace as ttrace
from corrosion_tpu_torch.runtime import tracestore as ttracestore
from corrosion_tpu_torch.runtime import tsdb as ttsdb

from tests.test_torch_api import jax_http_api

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
IO_S = 10.0

PLANE_MODS = {
    "jax": (jtsdb, jtracestore, jprofiler, jotel),
    "port": (ttsdb, ttracestore, tprofiler, totel),
}


def _reset_planes() -> None:
    for tsdb, tracestore, profiler, otel in PLANE_MODS.values():
        tsdb.configure()
        tracestore.configure()
        profiler.configure()
        otel.configure(None)


@pytest.fixture
def planes_reset():
    """Both packages' process-global planes uninstalled, and their
    sampler, sweep, profiler and exporter threads joined, before and
    after the test."""
    _reset_planes()
    yield
    _reset_planes()


def jax_planes_api():
    """`jax_http_api()` with the JAX package's planes, chaos census and
    transport error: the namespace `planes_checks` drives."""
    api = jax_http_api()
    api.TransportError = JTransportError
    api.CENSUS, api.StoreFaults = jfaults.CENSUS, jfaults.StoreFaults
    api.otel, api.profiler = jotel, jprofiler
    api.tracestore, api.tsdb = jtracestore, jtsdb
    api.FLIGHT = jrecords.FLIGHT
    return api


PKGS = {"jax": (jax_planes_api, "python"),
        "port": (lambda: ac.port_api("cpu"), "array")}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    return fn("jax"), fn("port")


# -- the trace store -------------------------------------------------------------

TARGETS = {"apply": 0.05, "write": 0.5}


def _span(tid: str, k: int, stage: str = "apply", secs: float = 0.01,
          **kw) -> dict:
    start = 1_700_000_000_000_000_000 + k * 1_000_000
    return {"name": f"{stage}.span", "trace_id": tid,
            "span_id": f"{k:016x}", "parent_span_id": None,
            "start_ns": start, "end_ns": start + int(secs * 1e9),
            "attrs": {"stage": stage, "actor": f"n{k % 3}", "table": "tests",
                      "hop": str(k % 2)},
            "error": False, "forced": False, **kw}


LOTTERY_ID = "00000004" + "a" * 24  # int(id[:8], 16) % 4 == 0
PLAIN_ID = "00000001" + "b" * 24

TRACE_CASES = {
    "error": [_span(PLAIN_ID, 1), _span(PLAIN_ID, 2, error=True)],
    "breach": [_span(PLAIN_ID, 1), _span(PLAIN_ID, 2, secs=0.2)],
    "forced": [_span(PLAIN_ID, 1, forced=True)],
    "lottery": [_span(LOTTERY_ID, 1), _span(LOTTERY_ID, 2, stage="write")],
    "dropped": [_span(PLAIN_ID, 1), _span(PLAIN_ID, 2, stage="write")],
    "evicted": [_span(f"{k:08x}" + "c" * 24, k, error=True)
                for k in range(1, 6)],
    "capped": [_span(PLAIN_ID, k, error=k == 1) for k in range(1, 9)],
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_store_keep_decisions_match(case, planes_reset):
    """The same spans into each package's store on the same clock: what
    an early sweep closes (nothing: the traces are not idle yet), the
    keep decision and reason at the idle close, the summaries, the
    slowest ids and the census."""
    def run(pkg):
        tracestore = PLANE_MODS[pkg][1]
        clock = Clock()
        st = tracestore.TraceStore(targets=TARGETS, lottery_n=4,
                                   max_traces=3, max_spans_per_trace=4,
                                   keep_max=2, idle_close_secs=1.0,
                                   clock=clock)
        for rec in TRACE_CASES[case]:
            st.add_span(dict(rec, attrs=dict(rec["attrs"])))
            clock.t += 0.1
        early = st.sweep()
        clock.t += 1.0
        closed = st.sweep()
        return (early, closed, st.kept(n=8), st.kept(n=8, stage="write"),
                st.slowest_ids("apply"), st.census())
    j, t = _both(run)
    assert t == j
    early, closed, kept, _w, _ids, census = t
    assert early == 0 and closed >= 1
    want = {"error": "error", "breach": "slo:apply", "forced": "forced",
            "lottery": "lottery", "evicted": "error",
            "capped": "error"}.get(case)
    assert [k["reason"] for k in kept][:1] == ([want] if want else [])


def test_trace_store_chaos_tag_matches(planes_reset):
    """A trace captured while a chaos drill is live carries its name."""
    def run(pkg):
        tracestore = PLANE_MODS[pkg][1]
        census = (jfaults if pkg == "jax" else tfaults).CENSUS
        clock = Clock()
        st = tracestore.TraceStore(targets=TARGETS, clock=clock)
        census.begin("sick-disk")
        try:
            st.add_span(_span(PLAIN_ID, 1, error=True))
        finally:
            census.end()
        clock.t += 2.0
        st.sweep()
        return st.kept()
    j, t = _both(run)
    assert t == j and t[0]["chaos"] == "sick-disk"


# -- OTLP export --------------------------------------------------------------------

OTLP_SPANS = [
    ("write.local", "ab" * 16, "01" * 8, None, 1_700_000_000_000_000_000,
     1_700_000_000_002_500_000, {"stage": "write", "actor": "n1"}, False),
    ("sync.client", "cd" * 16, "02" * 8, "01" * 8, 1_700_000_000_100_000_000,
     1_700_000_000_300_000_000, {"peer": "127.0.0.1:1"}, True),
    ("apply.remote", "ab" * 16, "03" * 8, "01" * 8, 1_700_000_000_004_000_000,
     1_700_000_000_009_000_000, {"stage": "apply", "hop": "2"}, False),
]


class _Resp:
    status = 200

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("batch_max", [512, 2])
def test_otlp_bodies_match(batch_max, monkeypatch, planes_reset):
    """The same finished spans through each package's exporter: the
    requests' URLs, methods, headers and JSON bodies (OTLP/HTTP JSON, one
    request per `batch_max` spans)."""
    posted = []

    def urlopen(req, timeout=None):
        posted.append((req.full_url, req.get_method(),
                       sorted(req.header_items()), json.loads(req.data)))
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def run(pkg):
        otel = PLANE_MODS[pkg][3]
        del posted[:]
        otel.configure("http://127.0.0.1:9/", flush_interval_s=3600.0,
                       batch_max=batch_max,
                       resource_attrs={"deployment": "test"})
        for name, tid, sid, parent, t0, t1, attrs, err in OTLP_SPANS:
            otel.record_span(name, tid, sid, parent, t0, t1, attrs, error=err)
        otel.exporter().flush()
        otel.configure(None)
        return list(posted)
    j, t = _both(run)
    assert t == j
    assert len(t) == -(-len(OTLP_SPANS) // batch_max)
    assert t[0][0] == "http://127.0.0.1:9/v1/traces"


def test_spans_route_to_the_store_and_the_exporter(monkeypatch, planes_reset):
    """`runtime/trace.py`'s routing in both packages: a stage span from
    the wire buffers in the trace store (and leaves through the exporter
    only once its trace is kept), a plain span goes straight to the
    exporter, and a shaped `timed_query` feeds the profiler's statement
    table."""
    posted = []

    def urlopen(req, timeout=None):
        posted.extend(s["name"] for rs in json.loads(req.data)["resourceSpans"]
                      for ss in rs["scopeSpans"] for s in ss["spans"])
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def run(pkg):
        tsdb, tracestore, profiler, otel = PLANE_MODS[pkg]
        trace = jtrace if pkg == "jax" else ttrace
        del posted[:]
        clock = Clock()
        st = tracestore.configure(targets=TARGETS, auto_sweep=False,
                                  lottery_n=0, clock=clock)
        otel.configure("http://127.0.0.1:9/", flush_interval_s=3600.0)
        prof = profiler.configure(auto_start=False, hz=67.0)
        parent = "00-" + "ab" * 16 + "-" + "01" * 8 + "-01"
        trace.stage_span(parent, "apply.remote", "apply", 0.2, hop=1)
        trace.stage_span(parent, "apply.remote", "apply", 0.01, forced=True)
        with trace.span("sync.client", peer="p"):
            pass
        otel.exporter().flush()
        before = list(posted)
        clock.t += 2.0
        st.sweep()
        otel.exporter().flush()
        with trace.timed_query("SELECT 1", shape="apply:batch"):
            pass
        with trace.timed_query("SELECT 2"):
            pass
        kept = [(k["reason"], k["n_spans"], sorted(k["stages"]))
                for k in st.kept()]
        rows = [(r["shape"], r["count"]) for r in prof.ring.stmt_rows()]
        return before, list(posted), kept, rows
    j, t = _both(run)
    assert t == j
    before, after, kept, rows = t
    assert before == ["sync.client"]
    assert sorted(after) == ["apply.remote", "apply.remote", "sync.client"]
    assert kept == [("forced", 2, ["apply"])] and rows == [("apply:batch", 1)]


# -- setup ------------------------------------------------------------------------------

PLANE_FLAGS = ("trace", "tsdb", "alerts", "profile")


def _built(pkg, agent) -> dict:
    tsdb, tracestore, profiler, _otel = PLANE_MODS[pkg]
    prof = profiler.get()
    return {"trace": tracestore.store() is not None,
            "tsdb": tsdb.get() is not None,
            "alerts": agent.alerts is not None,
            "remediation": agent.remediation is not None,
            "profile": prof is not None,
            "sampler_alive": bool(prof and prof._thread
                                  and prof._thread.is_alive())}


async def _boot_one(pkg, tmp: Path, addr: str, tune, transport="mem",
                    with_api=False):
    make_api, _engine = PKGS[pkg]
    api = make_api()
    net = api.MemNetwork(seed=5) if transport == "mem" else None
    if transport != "mem":
        addr = ac.loopback_addr(transport)
    d = tmp / pkg
    d.mkdir(parents=True, exist_ok=True)
    if with_api:
        return api, await ac.boot_with_api(api, net, addr, str(d), tune=tune,
                                           transport=transport)
    return api, (await ac.boot(api, net, addr, str(d), tune=tune,
                               transport=transport), None, None)


def _planes_on(cfg, off=()):
    for section, flag in ac.PLANES_OFF:
        setattr(getattr(cfg, section), flag, section not in off)


@pytest.mark.parametrize("plane", PLANE_FLAGS)
def test_setup_builds_each_plane(plane, tmp_path, planes_reset):
    """`setup` with every plane on builds every plane; with `plane` off
    it builds all but that one (the TSDB and the alert engine need each
    other, and remediation rides the engine), as the JAX package's
    `setup` does."""
    def boot(pkg):
        _reset_planes()

        async def go():
            api, (agent, _s, _c) = await _boot_one(
                pkg, tmp_path, f"built-{plane}",
                lambda cfg: _planes_on(cfg, off=(plane,)))
            try:
                return _built(pkg, agent)
            finally:
                await api.shutdown(agent)
        with cb.engine_env(PKGS[pkg][1]):
            return asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    j, t = _both(boot)
    assert t == j
    engine = plane not in ("tsdb", "alerts")
    assert t == {"trace": plane != "trace", "tsdb": engine,
                 "alerts": engine, "remediation": engine,
                 "profile": plane != "profile",
                 "sampler_alive": plane != "profile"}


@pytest.mark.parametrize("transport", ["mem", "quic"])
def test_default_config_boots_the_port(transport, tmp_path, planes_reset):
    """A default `Config` (all four planes on) boots a port agent, which
    takes a write, serves every plane's endpoint and runs every plane's
    thread; QUIC needs `gossip.plaintext`."""
    async def go():
        api = ac.port_api("cpu")
        cfg = api.Config()
        d = tmp_path / "default"
        d.mkdir()
        cfg.db.path = str(d / "a.db")
        if transport == "mem":
            cfg.gossip.bind_addr = "default-a"
            net = api.MemNetwork(seed=3)
        else:
            cfg.gossip.transport, cfg.gossip.plaintext = "quic", True
            cfg.gossip.bind_addr = ac.loopback_addr("quic")
            net = None
        agent = await api.setup(cfg, network=net)
        server = client = None
        try:
            agent.store.apply_schema_sql(ac.TEST_SCHEMA)
            await api.run(agent)
            server = api.ApiServer(agent)
            agent.config.api.bind_addr = ["127.0.0.1:0"]
            await server.start()
            client = api.CorrosionApiClient(server.addrs[0])
            await client.execute([["INSERT INTO tests VALUES (1, 'x')", []]])
            bodies = {}
            for path in ("/v1/traces", "/v1/alerts", "/v1/remediation",
                         "/v1/profile"):
                code, body = await ac._get_json(client, path)
                bodies[path] = (code, body.get("enabled", True))
            names = {t.name for t in __import__("threading").enumerate()}
            return _built("port", agent), bodies, names
        finally:
            if client is not None:
                await client.close()
            if server is not None:
                await server.stop()
            await api.shutdown(agent)
    with cb.engine_env("array"):
        built, bodies, names = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    assert all(built.values()), built
    assert all(code == 200 and enabled for code, enabled in bodies.values())
    assert {"tsdb-sample", "trace-sweep", "prof-sample"} <= names


# -- the plane-on endpoints ---------------------------------------------------------


def _quiet(cfg):
    """Planes on, their loops idle: nothing evaluates or acts on its own
    during the comparison."""
    _planes_on(cfg)
    cfg.alerts.eval_interval_secs = 3600.0
    cfg.remediation.tick_secs = 3600.0


# three kept traces (an error, an apply-stage breach, a forced keep) and
# one dropped, none a lottery winner at the default 1-in-64
ENDPOINT_SPANS = [
    _span("0000000a" + "1" * 24, 1, error=True),
    _span("0000000b" + "2" * 24, 2, secs=0.3),
    _span("0000000b" + "2" * 24, 3, stage="write"),
    _span("0000000c" + "3" * 24, 4, forced=True),
    _span("0000000d" + "4" * 24, 5),
]


def _install_quiet_planes(pkg) -> None:
    """Each plane installed before the agent boots (its `ensure` keeps
    them) without threads, and fed the same content."""
    tsdb, tracestore, profiler, _otel = PLANE_MODS[pkg]
    tsdb.configure(auto_sample=False, sample_interval_secs=5.0)
    clock = Clock()
    st = tracestore.configure(targets=TARGETS, auto_sweep=False, clock=clock)
    for rec in ENDPOINT_SPANS:
        st.add_span(dict(rec, attrs=dict(rec["attrs"])))
    clock.t += 5.0
    st.sweep()
    prof = profiler.configure(auto_start=False, hz=67.0)
    for key, n in FOLDS.items():
        for _ in range(n):
            prof.ring.add_sample(key)


FOLDS = {
    "loop;handle_changes;asyncio/base_events.py:run_forever;"
    "agent/run.py:handle_changes": 9,
    "store;-;threading.py:run;store/crdt.py:apply_batch": 14,
    "committer;-;threading.py:run;agent/run.py:_commit": 5,
    "sampler;-;prof-sample": 3,
}


def _mask(body, keys=("actor_id", "time", "age_secs")):
    """`actor_id`, times and ages masked; a dict keyed by actor ids gets
    positional keys."""
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k in keys:
                out[k] = "<masked>"
            else:
                out[k] = _mask(v, keys)
        if out and all(re.fullmatch(r"[0-9a-f-]{36}", k) for k in out):
            return [v for _k, v in sorted(out.items())]
        return out
    if isinstance(body, (list, tuple)):
        return [_mask(v, keys) for v in body]
    return body


async def _endpoints(pkg, tmp: Path, paths) -> dict:
    _reset_planes()
    _install_quiet_planes(pkg)
    api, (agent, server, client) = await _boot_one(
        pkg, tmp, "ep-a", _quiet, with_api=True)
    try:
        out = {}
        for path in paths:
            session = await client._ensure()
            async with session.get(f"{client.base}{path}") as resp:
                text = await resp.text()
                try:
                    out[path] = (resp.status, json.loads(text))
                except json.JSONDecodeError:
                    out[path] = (resp.status, text)
        return out
    finally:
        await asyncio.wait_for(client.close(), IO_S)
        await asyncio.wait_for(server.stop(), IO_S)
        await asyncio.wait_for(api.shutdown(agent), TIMEOUT_S)


def _endpoint_pair(tmp_path, paths):
    def run(pkg):
        with cb.engine_env(PKGS[pkg][1]):
            return asyncio.run(asyncio.wait_for(
                _endpoints(pkg, tmp_path, paths), TIMEOUT_S))
    return _both(run)


def test_traces_and_slo_exemplars_match(tmp_path, planes_reset):
    j, t = _endpoint_pair(tmp_path, ("/v1/traces", "/v1/traces?n=1",
                                     "/v1/traces?stage=write&spans=0",
                                     "/v1/slo"))
    for path in ("/v1/traces", "/v1/traces?n=1",
                 "/v1/traces?stage=write&spans=0"):
        assert _mask(t[path]) == _mask(j[path]), path
    assert t["/v1/traces"][1]["census"]["kept_total"] == 3
    ids = {s: r["slowest_trace_ids"]
           for s, r in t["/v1/slo"][1]["stages"].items()}
    assert ids == {s: r["slowest_trace_ids"]
                   for s, r in j["/v1/slo"][1]["stages"].items()}
    assert ids["apply"][0] == ENDPOINT_SPANS[1]["trace_id"]


def test_alerts_and_remediation_bodies_match(tmp_path, planes_reset):
    paths = ("/v1/alerts", "/v1/alerts?history=0", "/v1/alerts?scope=cluster",
             "/v1/remediation", "/v1/remediation?history=0")
    j, t = _endpoint_pair(tmp_path, paths)
    for path in paths:
        assert _mask(t[path]) == _mask(j[path]), path
    assert len(t["/v1/alerts"][1]["rules"]) == 8
    assert t["/v1/remediation"][1]["armed"] is False


def test_profile_and_status_blocks_match(tmp_path, planes_reset):
    paths = ("/v1/profile", "/v1/profile?window=30",
             "/v1/profile?format=folded", "/v1/profile?format=speedscope",
             "/v1/profile?scope=cluster", "/v1/status")
    j, t = _endpoint_pair(tmp_path, paths)
    # statement shapes are timed on the host clock as the agents boot
    keys = ("actor_id", "time", "age_secs", "stmt", "stmt_shapes",
            "total_secs")
    for path in paths[:-1]:
        assert _mask(t[path], keys) == _mask(j[path], keys), path
    for block in ("traces", "alerts", "remediation", "profile"):
        assert _mask(t["/v1/status"][1][block], keys) == \
            _mask(j["/v1/status"][1][block], keys), block
    assert t["/v1/profile?format=folded"][1].count("\n") == len(FOLDS)
    assert t["/v1/profile?format=speedscope"][1]["profiles"][0][
        "endValue"] == sum(FOLDS.values())


# -- obs_report's host sections ----------------------------------------------------


def _script(*names, **ns):
    from tests.test_torch_pview_churn import script_functions

    return script_functions("obs_report.py", names, **ns)


def _lines(render, *args, **kw):
    lines = []
    render(lambda line="": lines.append(line), *args, **kw)
    return lines


def _numbers_masked(lines):
    """Digits, hex ids and sparklines masked; runs of equal lines (the
    divergence timeline's rounds) collapsed to one."""
    out = []
    for line in lines:
        line = re.sub(r"[0-9a-f]{8}-[0-9a-f-]{27}", "<id>", line)
        line = re.sub(r"\b[0-9a-f]{16}\b", "<hex>", line)
        line = re.sub(r"[▁▂▃▄▅▆▇█]+", "<spark>", line)
        line = re.sub(r"\d+(\.\d+)?", "#", line)
        line = re.sub(r" +", " ", line)
        if not out or out[-1] != line:
            out.append(line)
    return out


def _jax_obs_ns():
    from corrosion_tpu.runtime.metrics import METRICS
    from corrosion_tpu.runtime.records import FLIGHT
    import time

    ns = _script("sparkline", "_SPARK", "render_traces_section",
                 "render_alerts_section", "render_slo_section",
                 "_run_e2e_workload", "render_cluster_section",
                 METRICS=METRICS, FLIGHT=FLIGHT, time=time)
    return ns


def test_traces_and_alerts_sections_match(monkeypatch, planes_reset):
    """The trace section over identical stores is the same text; the
    alert section over a fresh registry of each package's is the same
    text with its numbers masked (its TSDB samples on the host clock)."""
    ns = _jax_obs_ns()
    from corrosion_tpu.runtime.metrics import Registry as JRegistry
    from corrosion_tpu_torch.runtime.metrics import Registry as TRegistry

    texts = {}
    for pkg in ("jax", "port"):
        _reset_planes()
        _install_quiet_planes(pkg)
        if pkg == "jax":
            ns["METRICS"] = JRegistry()
            traces = _lines(ns["render_traces_section"])
            alerts = _lines(ns["render_alerts_section"])
        else:
            monkeypatch.setattr(tobs, "METRICS", TRegistry())
            traces = _lines(tobs.render_traces_section)
            alerts = _lines(tobs.render_alerts_section)
        texts[pkg] = (traces, _numbers_masked(alerts))
    assert texts["port"] == texts["jax"]
    assert any("error" in line for line in texts["port"][0])


def test_slo_section_matches(planes_reset):
    """The SLO section after each package's two-agent workload: the same
    layout, stages and counts of rows, numbers masked."""
    ns = _jax_obs_ns()
    with cb.engine_env("python"):
        j = _lines(ns["render_slo_section"], writes=6)
    _reset_planes()
    with cb.engine_env("array"):
        t = _lines(tobs.render_slo_section, writes=6, device="cpu")
    assert _numbers_masked(t) == _numbers_masked(j)
    assert any(line.startswith("total ") for line in t)


def test_cluster_section_and_partition_outcome_match(monkeypatch,
                                                    planes_reset):
    """The cluster section's two-node partition replay in each package:
    the rendered text with its numbers masked, and the scenario's
    outcome (full coverage, one divergence episode per node, episodes
    closed after the heal)."""
    import corrosion_tpu.models.cluster as jcluster

    recs = {}

    def keep(pkg, real):
        async def wrapped(*a, **kw):
            recs[pkg] = await real(*a, **kw)
            return recs[pkg]
        return wrapped

    monkeypatch.setattr(jcluster, "cluster_observatory_scenario",
                        keep("jax", jcluster.cluster_observatory_scenario))
    monkeypatch.setattr(tcluster, "cluster_observatory_scenario",
                        keep("port", tcluster.cluster_observatory_scenario))
    ns = _jax_obs_ns()
    with cb.engine_env("python"):
        j = _lines(ns["render_cluster_section"], writes=4)
    _reset_planes()
    with cb.engine_env("array"):
        t = _lines(tobs.render_cluster_section, writes=4, device="cpu")
    assert _numbers_masked(t)[:8] == _numbers_masked(j)[:8]

    def outcome(rec):
        return {"nodes": rec["nodes"], "coverage": rec["coverage"],
                "episodes": sorted(rec["episodes"].values()),
                "episodes_total": rec["episodes_total"],
                "stage_keys": sorted(rec["stages"])}
    assert outcome(recs["port"]) == outcome(recs["jax"])
    assert recs["port"]["episodes_total"] == 2


# -- the chip phase's scenario ------------------------------------------------------


def test_scenario_planes_matches_jax(tmp_path, planes_reset):
    """`scenario_planes` at 400 rows over plaintext QUIC (the digest
    interval cut to 0.5 s for the small run): the port's outcome is the
    JAX package's, and every bound holds in both."""
    recs = {}
    for pkg in ("jax", "port"):
        make_api, engine = PKGS[pkg]
        d = tmp_path / pkg
        d.mkdir()
        with cb.engine_env(engine):
            recs[pkg] = asyncio.run(asyncio.wait_for(pc.scenario_planes(
                make_api(), str(d), "quic", rows=400, txs=4,
                cluster={"digest_interval_secs": 0.5,
                         "silent_after_mult": 3.0}), 300.0))
    want = pc.planes_outcome(recs["jax"])
    assert pc.planes_checks(recs["jax"], want) == []
    assert pc.planes_checks(recs["port"], want) == []
    assert want["episode_opened"] == {"a": True, "b": True, "c": True}
    assert want["incident_per_episode"] is True


def _print_ref() -> None:
    import tempfile

    # the native engine: with the python one the JAX agents' process is
    # saturated at this size on a CPU host, and its observatory flaps
    # for minutes after the heal
    with cb.engine_env("native"), tempfile.TemporaryDirectory(
            prefix="planes_ref") as tmp:
        rec = asyncio.run(pc.scenario_planes(
            jax_planes_api(), tmp, "quic", **ac.CHIP_NET, timeout=900.0))
    bad = pc.planes_checks(rec, pc.planes_outcome(rec))
    if bad:
        raise SystemExit(f"the JAX run fails its own bounds: {bad}")
    print("PLANES_REF = " + json.dumps(pc.planes_outcome(rec), indent=1))
    print("# walls " + json.dumps(rec["walls"]), file=sys.stderr)


if __name__ == "__main__":
    if sys.argv[1:] != ["--ref"]:
        raise SystemExit("usage: python -m tests.test_torch_planes --ref")
    _print_ref()
