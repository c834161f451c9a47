"""The port's scale-ladder rungs (`corrosion_tpu_torch.scale_ladder`)
against the JAX package's `ClusterSim` driven by the same rung code.

Each rung function takes the sim constructor as an argument, so one body
(the script's seeds, warm-up steps, `_converge` and `_churn`) drives the
port's `ClusterSim` on the CPU and the JAX package's; the ticks to
converge, the detection ticks, the crash count and the false positives
must be equal, and so must the float32 coverage (the n <= 1,000 stats
sum exactly in both).

- rung 1 in full (n=128, 5 % churn), equal to `chip_smoke.LADDER_REF`;
- rung 2's loop at suspicion 3 (n=1,000, fanout 3), equal to
  `chip_smoke.LADDER_REF`;
- rung 3's structure at n=512 (the `LADDER_R3_N` counterpart);
- the CLI's rung list and `--out`;
- `convergence_probe` (n=128) and `feed_sweep` (n=512) print the JAX
  package's lines through the same code, but for the wall times;
- the rung bodies of `scripts/scale_ladder.py` itself and the port's
  make the same sims and the same calls on them, in the same order,
  over a recording fake sim (so the port's copy cannot drift from the
  script unseen).

    JAX_PLATFORMS=cpu python -m tests.test_torch_ladder

prints `LADDER_REF`: the JAX package's rungs 1, 2 and 3 (n=10,000)
through the same code, on the CPU.
"""

import ast
import inspect
import json
import re
import time
import types
from pathlib import Path

import pytest
import torch

import chip_smoke
from corrosion_tpu.models.cluster import ClusterSim as JClusterSim
from corrosion_tpu_torch import convergence_probe, feed_sweep
from corrosion_tpu_torch import scale_ladder as sl

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "scale_ladder.py"


class JaxSim:
    """The JAX package's `ClusterSim` behind the port drivers' seam. The
    drivers read `state.view` only to wait for the card and to name the
    platform, so it shows them an empty CPU tensor once the JAX view is
    ready; every other attribute is the JAX sim's."""

    def __init__(self, n, **kw):
        self._sim = JClusterSim(n, **kw)

    @property
    def state(self):
        self._sim.state.view.block_until_ready()
        return types.SimpleNamespace(view=torch.empty(0))

    def __getattr__(self, name):
        return getattr(self._sim, name)


def _pair(fn, **kw):
    port = fn(device="cpu", **kw)
    ref = fn(new_sim=JaxSim, **kw)
    assert [sl.checked(r) for r in port] == [sl.checked(r) for r in ref]
    return port, ref


def test_rung1_matches_jax_and_ladder_ref():
    (port,), _ = _pair(sl.rung1)
    key, got = sl.checked(port)
    assert got == chip_smoke.LADDER_REF[key]
    assert port["convergence_ticks"] is not None
    assert port["churn_crashed"] == 128 // 20
    assert port["detect_all_ticks"] is not None
    assert port["platform"] == "cpu"


def test_rung2_one_suspicion_matches_jax_and_ladder_ref():
    (port,), _ = _pair(sl.rung2, suspicion=(3,))
    key, got = sl.checked(port)
    assert key == "2/3" and got == chip_smoke.LADDER_REF[key]
    assert port["detect_one_ticks"] is not None


def test_rung3_structure_at_512_matches_jax():
    (port,), _ = _pair(sl.rung3, n=512)
    assert port["n"] == 512 and port["churn_crashed"] == 5
    assert port["convergence_ticks"] % 50 == 11  # 1 + 5 + 5, then 50s
    assert port["detect_all_ticks"] is not None
    assert port["false_positive_after_churn"] == 0.0


def test_cli_runs_rungs_and_writes_only_with_out(tmp_path, monkeypatch,
                                                 capsys):
    calls = []
    monkeypatch.setattr(sl, "RUNG_FNS", {
        r: (lambda r=r: calls.append(r) or [{"rung": r, "name": f"r{r}"}])
        for r in sl.RUNGS})
    sl.main(["2"])
    assert calls == [2] and not list(tmp_path.iterdir())
    out = tmp_path / "ladder.json"
    recs = sl.main(["--out", str(out)])
    assert calls == [2, 1, 2, 3] and len(recs) == 3
    assert json.loads(out.read_text()) == recs
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["out"]
    with pytest.raises(SystemExit):
        sl.main(["4"])  # the sharded rung is not ported


def _no_walls(lines):
    return [re.sub(r"wall=\s*[\d.]+s( \(\s*[\d.]+ ms/tick\))?", "", ln)
            for ln in lines]


def test_convergence_probe_matches_jax():
    # n=128 with 4 feeds is rung 1's configuration: the JAX side reuses
    # its compiled ticks
    port, ref = [], []
    got = convergence_probe.run(128, 4, 5, device="cpu", log=port.append)
    want = convergence_probe.run(128, 4, 5, new_sim=JaxSim,
                                 log=ref.append)
    assert got == want and got is not None
    assert port[0] == "platform=cpu n=128 feeds=4"
    assert _no_walls(port) == _no_walls(ref)
    assert port[-1].startswith(f"CONVERGED tick={got} ")


def test_feed_sweep_matches_jax(tmp_path, monkeypatch, capsys):
    # n=512 with 4 feeds of 32 is rung 3's configuration at n=512
    args = dict(feeds=4, n=512, start=10, step=5, stop=100)
    got = feed_sweep.run(**args, device="cpu")
    want = feed_sweep.run(**args, new_sim=JaxSim)
    assert _no_walls([got]) == _no_walls([want])
    assert got.startswith("n=512 feeds=4 fe=32: tick=")
    assert "fp=0.0" in got
    monkeypatch.setattr(feed_sweep, "run", lambda *a: "a line")
    feed_sweep.main(["4"])
    assert not list(tmp_path.iterdir())
    out = tmp_path / "sweep.txt"
    feed_sweep.main(["4", "--out", str(out)])
    feed_sweep.main(["8", "--out", str(out)])
    assert out.read_text() == "a line\na line\n"
    assert capsys.readouterr().out == "a line\n" * 3


class RecordingSim:
    """A stand-in for `ClusterSim` that records its constructor's
    arguments and every call made on it into `log`, with each method's
    arguments bound to their names (so positional and keyword calls of
    the same thing record alike). Its answers are exact in a few decimals,
    so the script's rounding leaves them unchanged."""

    def __init__(self, log, n, **kw):
        self.log, self.id = log, sum(e[0] == "new" for e in log)
        self.params = types.SimpleNamespace(n=n)
        self.state = types.SimpleNamespace(view=torch.empty(0))
        log.append(("new", n, kw))

    def _rec(self, name, *args, **kw):
        fn = getattr(type(self), name).__wrapped__
        bound = inspect.signature(fn).bind(self, *args, **kw)
        bound.apply_defaults()
        args = dict(list(bound.arguments.items())[1:])  # less `self`
        self.log.append((self.id, name, args))
        return 10 * len(self.log)

    def _recorded(fn):
        def method(self, *args, **kw):
            return self._rec(fn.__name__, *args, **kw)
        method.__wrapped__ = fn
        return method

    @_recorded
    def step(self, k=1): ...

    @_recorded
    def crash(self, m): ...

    @_recorded
    def run_until_stable(self, coverage_target=0.999, max_ticks=10_000,
                         record_every=10): ...

    @_recorded
    def run_until_detected(self, detect_target=1.0, max_extra_ticks=500): ...

    def stats(self):
        self.log.append((self.id, "stats", {}))
        return {"coverage": 0.875, "detected": 0.5, "false_positive": 0.25}


def _script_rungs(log, syncs):
    """`scripts/scale_ladder.py`'s `emit`, `_converge`, `_churn` and
    rungs 1-3, compiled from its source over `RecordingSim` (importing
    the script would re-launch the process under its own JAX setup)."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [node for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module == "__future__"
            or isinstance(node, ast.FunctionDef) and node.name in (
                "emit", "_converge", "_churn", "rung1", "rung2", "rung3")]
    fake_jax = types.SimpleNamespace(
        devices=lambda: [types.SimpleNamespace(platform="cpu")],
        block_until_ready=lambda view: syncs.append(len(log)))
    ns = {"ClusterSim": lambda n, **kw: RecordingSim(log, n, **kw),
          "jax": fake_jax, "json": json, "os": __import__("os"),
          "time": time, "RESULTS": []}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    return ns


@pytest.mark.parametrize("rung", sl.RUNGS)
def test_rung_bodies_are_the_scripts(rung, monkeypatch, capsys):
    monkeypatch.setenv("LADDER_R3_N", "512")
    want_log, want_syncs = [], []
    script = _script_rungs(want_log, want_syncs)
    script[f"rung{rung}"]()
    log, syncs = [], []
    monkeypatch.setattr(sl, "sync", lambda sim: syncs.append(len(log)))
    got = sl.RUNG_FNS[rung](
        new_sim=lambda n, **kw: RecordingSim(log, n, **kw))
    assert log == want_log and syncs == want_syncs
    assert any(e[1] == "crash" for e in log if e[0] != "new")

    def timeless(rec):
        return {k: v for k, v in rec.items()
                if not k.endswith(("wall_s", "per_tick_s"))}
    assert [timeless(r) for r in got] == [timeless(r)
                                          for r in script["RESULTS"]]


if __name__ == "__main__":
    rows = [sl.checked(rec) for fn in (sl.rung1, sl.rung2, sl.rung3)
            for rec in fn(new_sim=JaxSim)]
    print("LADDER_REF = {")
    for key, fields in rows:
        print(f"    {key!r}: {fields!r},")
    print("}")
