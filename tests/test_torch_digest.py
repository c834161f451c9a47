"""The port's telemetry digests and cluster observatory against the JAX
package's, on the CPU.

The digest bytes must be equal (port and JAX nodes read each other's
digests off the same gossip datagrams and broadcast envelopes), so every
codec case builds the same digest in both packages from one seeded
`random.Random` and compares bytes, then decodes each package's bytes
with the other. The observatory cases of `tests/test_digest.py` (the
freshest digest per node, `pick_ext`'s budget and rotation, the
divergence episode state machine, silence only after a prior report,
the oversize degrade, and the cluster report and alert views over the
same held digests) run through one script on each package's
`Observatory` over a fabricated agent, and what each saw must be equal.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from corrosion_tpu.agent import membership, observatory
        from corrosion_tpu.runtime import config, digest, latency
        from corrosion_tpu.types import actor, codec
    else:
        from corrosion_tpu_torch.agent import membership, observatory
        from corrosion_tpu_torch.runtime import config, digest, latency
        from corrosion_tpu_torch.types import actor, codec
    return SimpleNamespace(name=name, membership=membership,
                           observatory=observatory, config=config,
                           digest=digest, lat=latency, actor=actor,
                           codec=codec)


JAX, PORT = _pkg("jax"), _pkg("port")
BOTH = (JAX, PORT)


# -- the same random digest in both packages --------------------------------


def _samples(rng, n_samples=200, scale=2.0) -> list:
    return [rng.lognormvariate(-6.0, scale)
            for _ in range(rng.randrange(n_samples))]


def _hist(pkg, samples):
    h = pkg.lat.LatencyHistogram()
    for v in samples:
        h.observe(v)
    return h


def _digest_fields(rng, seq=1) -> dict:
    """A random digest as plain data (`tests/test_digest.py::_rand_digest`
    widened with the trailing heads, alert and hotspot blocks)."""
    stages = {s: _samples(rng) for s in ("broadcast", "apply", "match",
                                         "deliver", "total")
              if rng.random() < 0.8}
    return dict(
        actor_id=rng.randbytes(16), seq=seq,
        wall=1.7e9 + rng.uniform(-5, 5), view_hash=rng.getrandbits(64),
        view_size=rng.randrange(1, 1000), alive=rng.randrange(1000),
        suspect=rng.randrange(50), downed=rng.randrange(50),
        lhm=rng.randrange(9), loop_lag=rng.random(),
        sync_backlog={rng.randbytes(16): rng.randrange(1, 1 << 40)
                      for _ in range(rng.randrange(4))},
        heads_total=rng.randrange(1 << 30),
        alerts=[{"rule": f"rule-{i}",
                 "severity": rng.choice(("info", "warn", "page")),
                 "state": rng.choice(("pending", "firing")),
                 "drill": rng.random() < 0.3,
                 "since": rng.uniform(0, 1e9), "value": rng.random()}
                for i in range(rng.randrange(3))],
        hotspots=[{"frame": f"mod.py:f{i}", "samples": rng.randrange(1000)}
                  for i in range(rng.randrange(3))],
        events={f"ev_{i}": rng.randrange(1 << 32)
                for i in range(rng.randrange(6))},
        stages=stages,
    )


def _digest(pkg, fields: dict):
    f = dict(fields)
    f["stages"] = {s: _hist(pkg, v) for s, v in fields["stages"].items()}
    return pkg.digest.NodeDigest(**f)


def _plain(d) -> dict:
    """A decoded digest of either package as comparable data."""
    out = {k: getattr(d, k) for k in (
        "actor_id", "seq", "wall", "view_hash", "view_size", "alive",
        "suspect", "downed", "lhm", "loop_lag", "sync_backlog",
        "heads_total", "alerts", "hotspots", "events")}
    out["stages"] = {s: (h.nonzero_buckets(), h.count, h.total)
                     for s, h in d.stages.items()}
    return out


@pytest.mark.parametrize("seed", range(4))
def test_digest_bytes_equal_and_decode_across(seed):
    rng = random.Random(100 + seed)
    for trial in range(12):
        fields = _digest_fields(rng, seq=trial)
        jb = JAX.digest.encode_digest(_digest(JAX, fields))
        tb = PORT.digest.encode_digest(_digest(PORT, fields))
        assert jb == tb
        jd, td = JAX.digest.decode_digest(tb), PORT.digest.decode_digest(jb)
        assert _plain(jd) == _plain(td)
        assert PORT.digest.encode_digest(td) == jb
        assert JAX.digest.encode_digest(jd) == tb


def test_digest_without_trailing_blocks_decodes_alike():
    """An old digest that stops before the heads / alert / hotspot blocks
    decodes to the same defaults in both packages."""
    rng = random.Random(7)
    fields = _digest_fields(rng)
    fields.update(heads_total=0, alerts=[], hotspots=[])
    full = JAX.digest.encode_digest(_digest(JAX, fields))
    old = full[:-3]  # the three trailing uvarint counts, all zero
    assert full[-3:] == b"\x00\x00\x00"
    assert _plain(JAX.digest.decode_digest(old)) == _plain(
        PORT.digest.decode_digest(old))


def test_sparse_hist_and_hist_codec_equal():
    rng = random.Random(1)
    for _ in range(30):
        samples = _samples(rng, scale=rng.uniform(0.5, 4.0))
        jh, th = _hist(JAX, samples), _hist(PORT, samples)
        assert jh.to_sparse() == th.to_sparse()
        pairs, total = th.to_sparse()
        back = PORT.lat.LatencyHistogram.from_sparse(pairs + [(3, 0)], total)
        assert back.nonzero_buckets() == th.nonzero_buckets()
        assert (back.count, back.total) == (th.count, th.total)
        jw, tw = JAX.codec.Writer(), PORT.codec.Writer()
        JAX.digest.write_hist(jw, jh)
        PORT.digest.write_hist(tw, th)
        assert jw.bytes() == tw.bytes()
        got = PORT.digest.read_hist(PORT.codec.Reader(jw.bytes()))
        assert got.to_sparse() == jh.to_sparse()
        for q in PORT.lat.QUANTILES:
            assert got.quantile(q) == jh.quantile(q)


def test_uvarint_bytes_equal():
    rng = random.Random(2)
    vals = [0, 1, 127, 128, 300, (1 << 63) - 1] + [
        rng.getrandbits(rng.randrange(1, 64)) for _ in range(200)]
    jw, tw = JAX.codec.Writer(), PORT.codec.Writer()
    for v in vals:
        jw.uvarint(v)
        tw.uvarint(v)
    assert jw.bytes() == tw.bytes()
    r = PORT.codec.Reader(jw.bytes())
    assert [r.uvarint() for _ in vals] == vals and r.eof()
    with pytest.raises(ValueError):
        PORT.codec.Writer().uvarint(-1)
    with pytest.raises(ValueError, match="too long"):
        PORT.codec.Reader(b"\xff" * 10).uvarint()


def test_view_hash_and_merge_stage_hists_equal():
    rng = random.Random(5)
    for n in (0, 1, 5, 40):
        ids = [rng.randbytes(16) for _ in range(n)]
        shuffled = rng.sample(ids, len(ids))
        assert PORT.digest.view_hash(ids) == JAX.digest.view_hash(shuffled)
    for pkg in BOTH:
        with pytest.raises(ValueError):
            pkg.digest.view_hash([b"\x01" * 15])
    fields = [_digest_fields(rng) for _ in range(3)]
    merged = [pkg.digest.merge_stage_hists([_digest(pkg, f) for f in fields])
              for pkg in BOTH]
    assert {s: h.to_sparse() for s, h in merged[0].items()} == {
        s: h.to_sparse() for s, h in merged[1].items()}
    assert set(merged[1]) >= set(PORT.lat.E2E_STAGES)


def test_garbage_and_wrong_version_rejected_alike():
    good = JAX.digest.encode_digest(_digest(JAX, _digest_fields(
        random.Random(4))))
    for bad in (b"", b"\x63" + good[1:], good[: len(good) // 2],
                b"\x01" + b"\x00" * 5):
        errs = []
        for pkg in BOTH:
            try:
                pkg.digest.decode_digest(bad)
                errs.append(None)
            except (ValueError, IndexError) as e:
                errs.append(type(e).__name__)
        assert errs[0] == errs[1] and errs[0] is not None, (bad, errs)
    with pytest.raises(ValueError, match="unknown digest version"):
        PORT.digest.decode_digest(b"\x63" + good[1:])


# -- the observatory over a fabricated agent -----------------------------------


class _FakeMembership:
    def __init__(self, pkg):
        self.members = {}
        self.downed = {}
        self.config = pkg.membership.SwimConfig()
        self.lhm = 0

    @property
    def cluster_size(self):
        return 1 + len(self.members)


class _FakeBookie:
    def items(self):
        return {}


class _FakeAgent:
    def __init__(self, pkg, name: bytes):
        self.config = pkg.config.Config()
        self.actor = pkg.actor.Actor(id=pkg.actor.ActorId(name), addr="fake")
        self.membership = _FakeMembership(pkg)
        self.bookie = _FakeBookie()

    @property
    def actor_id(self):
        return self.actor.id


ME, PEER, THIRD = b"\x01" * 16, b"\x02" * 16, b"\x03" * 16


def _obs(pkg):
    return pkg.observatory.Observatory(_FakeAgent(pkg, ME))


def _offer(pkg, obs, actor_id, seq=1, wall=None, vh=0):
    d = pkg.digest.NodeDigest(
        actor_id=actor_id, seq=seq,
        wall=wall if wall is not None else time.time(), view_hash=vh,
        view_size=1)
    got = obs.receive(pkg.digest.encode_digest(d))
    return None if got is None else (got.actor_id, got.seq)


def _add_peer(pkg, obs, peer=PEER):
    m = pkg.membership
    obs.agent.membership.members[pkg.actor.ActorId(peer)] = m._Member(
        actor=pkg.actor.Actor(id=pkg.actor.ActorId(peer), addr="peer"),
        state=m.MemberState.ALIVE)


def _verdict(r: dict) -> tuple:
    return (r["divergent"], r["episode_open"], r["episodes"], r["groups"],
            len(r["silent"]))


def script_freshest(pkg) -> list:
    obs = _obs(pkg)
    return [
        _offer(pkg, obs, PEER, seq=5, wall=100.0),
        _offer(pkg, obs, PEER, seq=9, wall=50.0),  # older wall: dropped
        obs._store[PEER].digest.seq,
        _offer(pkg, obs, PEER, seq=6, wall=200.0),  # newer: adopted
        obs._store[PEER].digest.seq,
        _offer(pkg, obs, ME, seq=99, wall=1e12),  # our own relayed back
        sorted(obs.advertised_heads()),
    ]


def script_pick_ext(pkg) -> list:
    obs = _obs(pkg)
    _offer(pkg, obs, PEER, wall=1.0)
    _offer(pkg, obs, THIRD, wall=1.0)
    order = [pkg.digest.decode_digest(obs.pick_ext(10_000)).actor_id
             for _ in range(4)]
    hopeless = obs.pick_ext(4)
    total = 0
    while obs.pick_ext(10_000) is not None:
        total += 1
        assert total < 100, "sends never exhausted"
    return [order, hopeless, total]


def script_episodes(pkg, flight_dir) -> list:
    obs = _obs(pkg)
    obs.cfg.divergence_checks = 2
    obs.cfg.digest_interval_secs = 10.0  # silence never fires here
    _add_peer(pkg, obs)
    my_hash = pkg.digest.view_hash([ME, PEER])
    seen = []
    _offer(pkg, obs, PEER, seq=1, vh=my_hash)
    seen.append(_verdict(obs.check_divergence()))
    _offer(pkg, obs, PEER, seq=2, vh=my_hash ^ 0xDEAD)
    seen += [_verdict(obs.check_divergence()) for _ in range(3)]
    _offer(pkg, obs, PEER, seq=3, vh=my_hash)
    seen += [_verdict(obs.check_divergence()) for _ in range(2)]
    _offer(pkg, obs, PEER, seq=4, vh=my_hash ^ 0xBEEF)
    seen += [_verdict(obs.check_divergence()) for _ in range(2)]
    _offer(pkg, obs, PEER, seq=5, vh=my_hash)
    obs.disarm()
    seen += [_verdict(obs.check_divergence()) for _ in range(2)]
    seen.append((obs._episode_open, obs._episodes))
    seen.append(len(list(flight_dir.glob("*cluster_divergence*"))))
    return seen


def script_silence(pkg) -> list:
    obs = _obs(pkg)
    obs.cfg.divergence_checks = 1
    obs.cfg.digest_interval_secs = 0.01  # silent_after = 25 ms
    _add_peer(pkg, obs)
    seen = [_verdict(obs.check_divergence())]  # never reported
    _offer(pkg, obs, PEER, seq=1, vh=pkg.digest.view_hash([ME, PEER]))
    seen.append(_verdict(obs.check_divergence()))  # fresh
    time.sleep(0.05)
    seen.append(_verdict(obs.check_divergence()))  # went silent
    obs._self_lagged = True
    seen.append(_verdict(obs.check_divergence()))  # own lag suppresses
    return seen


def script_oversize(pkg, monkeypatch) -> list:
    obs = _obs(pkg)
    cap = obs.cfg.max_wire_bytes
    rng = random.Random(7)
    fields = dict(
        actor_id=ME, seq=1, wall=1.7e9, view_hash=1234, view_size=4,
        alive=4, heads_total=755,
        alerts=[{"rule": "view-divergence", "severity": "page",
                 "state": "firing", "since": 1.0, "value": 1.0}],
        hotspots=[{"frame": f"f{i}", "samples": i} for i in range(40)],
        stages={s: [rng.lognormvariate(-6.0, 4.0) for _ in range(600)]
                for s in pkg.lat.E2E_STAGES})
    d = _digest(pkg, fields)
    before = len(pkg.digest.encode_digest(d))
    monkeypatch.setattr(obs, "snapshot_local", lambda: d)
    obs.build_and_store()
    enc = obs._store[ME].encoded
    got = pkg.digest.decode_digest(enc)
    return [before > cap, len(enc) <= cap, enc, got.view_hash,
            got.heads_total, sorted(got.stages), got.hotspots,
            obs.pick_ext(cap + 64) is not None]


def test_observatory_freshest_per_node():
    j, t = script_freshest(JAX), script_freshest(PORT)
    assert j == t
    assert t[:6] == [(PEER, 5), None, 5, (PEER, 6), 6, None]


def test_observatory_pick_ext_budget_and_rotation():
    j, t = script_pick_ext(JAX), script_pick_ext(PORT)
    assert j == t
    assert set(t[0]) == {PEER, THIRD} and t[0][0] != t[0][1]
    assert t[1] is None and t[2] > 0


def test_observatory_divergence_episodes(tmp_path, monkeypatch):
    got = []
    for pkg in BOTH:
        d = tmp_path / pkg.name
        d.mkdir()
        monkeypatch.setenv("CORRO_FLIGHT_DIR", str(d))
        got.append(script_episodes(pkg, d))
    assert got[0] == got[1]
    t = got[1]
    assert t[0] == (False, False, 0, 1, 0)
    assert t[1][:2] == (True, False) and t[2][1] and t[2][2] == 1
    assert t[-2] == (True, 2) and t[-1] == 2


def test_observatory_silence_needs_a_prior_report():
    j, t = script_silence(JAX), script_silence(PORT)
    assert j == t
    assert not t[0][0] and not t[1][0] and t[2][0] and t[2][4] == 1
    assert t[3][4] == 0


def test_observatory_oversize_digest_degrades_alike(monkeypatch):
    j = script_oversize(JAX, monkeypatch)
    t = script_oversize(PORT, monkeypatch)
    assert j == t
    assert t[0] and t[1] and t[3:5] == [1234, 755]
    assert set(t[5]) <= {"total"} and t[6] == [] and t[7]


def test_port_digest_carries_the_kernel_event_totals():
    """The digest a port agent builds carries its process's kernel event
    totals, so the `crdt_merge` events of the card travel the cluster."""
    from corrosion_tpu_torch.runtime.metrics import (
        EVENTS_BY_KERNEL, METRICS, kernel_event_totals, record_kernel_events)

    first = EVENTS_BY_KERNEL["crdt_merge"][0]
    record_kernel_events("crdt_merge", [3] + [0] * (
        len(EVENTS_BY_KERNEL["crdt_merge"]) - 1))
    obs = _obs(PORT)
    d = obs.build_and_store()
    want = {}
    for by_event in kernel_event_totals(METRICS).values():
        for ev, v in by_event.items():
            want[ev] = want.get(ev, 0) + int(v)
    assert d.events == want and d.events[first] >= 3
    assert d.hotspots == [] and d.alerts == []
    back = JAX.digest.decode_digest(obs._store[ME].encoded)
    assert back.events == d.events and back.view_size == 1


def script_cluster_views(pkg, monkeypatch) -> list:
    """`cluster_report` and `cluster_alerts` over the same held digests
    (own digest fixed, two peers', one of them with alerts); the ages
    depend on the clock and are left out."""
    obs = _obs(pkg)
    _add_peer(pkg, obs)
    rng = random.Random(11)
    own = _digest_fields(rng)
    own.update(actor_id=ME, alerts=[], hotspots=[])
    monkeypatch.setattr(obs, "snapshot_local", lambda: _digest(pkg, own))
    for peer in (PEER, THIRD):
        f = _digest_fields(rng)
        f.update(actor_id=peer, wall=time.time(), hotspots=[])
        obs.receive(pkg.digest.encode_digest(_digest(pkg, f)))
    report = obs.cluster_report()
    alerts = obs.cluster_alerts()
    for view in (report, alerts):
        for node in view["nodes"].values():
            del node["age_secs"]
    return [report, alerts]


def test_observatory_cluster_views_alike(monkeypatch):
    j = script_cluster_views(JAX, monkeypatch)
    t = script_cluster_views(PORT, monkeypatch)
    assert j == t
    report, alerts = t
    assert report["coverage"]["known"] == 3 == alerts["coverage"]["known"]
    assert report["divergence"]["groups"] >= 1
    assert any(n["alerts"] for n in alerts["nodes"].values())
