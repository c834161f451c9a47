"""The port's kernel-peer bridge path (`corrosion_tpu_torch.models.bridge`
and the host modules it speaks through) against the JAX package's, on
the same inputs.

- the SWIM wire: every message kind with and without target, origin,
  updates and digest encodes to the same bytes, each side decodes the
  other's, `fill_updates` takes the same updates, and undecodable bytes
  raise the same exception types;
- the in-memory network: the same seed and faults deliver the same
  datagrams (and `random` in it is the standard library's);
- the SWIM prober: the same datagrams leave the same member table,
  downed set, dissemination queue and sent bytes; `SwimConfig`'s scaling
  agrees for n from 1 to 10^6;
- the bridge: its replies to `bridge_scale.wire_datagrams` equal the JAX
  bridge's at n=64 and n=192, and hash to `chip_smoke.BRIDGE_REF`;
- end to end: the JAX package's real agent against the port's bridge,
  and the port's own prober, each absorb 193 members and down exactly
  the three silent crashes; a small gossip rung of the driver;
- `ops/swim.py::membership_stats`, the histogram and `merge_records`.

    JAX_PLATFORMS=cpu python -m tests.test_torch_bridge

prints `BRIDGE_REF` (the JAX bridge's replies to the script, hashed).
"""

import asyncio
import json
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import corrosion_tpu.agent.membership as jms
import corrosion_tpu.models.bridge as jbridge
import corrosion_tpu.net.gossip_codec as jgc
import corrosion_tpu.net.mem as jmem
from corrosion_tpu.models.cluster import ClusterSim as JClusterSim
from corrosion_tpu.ops import swim as J
from corrosion_tpu.runtime import metrics as jmetrics
from corrosion_tpu.runtime import records as jrecords
from corrosion_tpu.types import actor as jactor
from corrosion_tpu.types import base as jbase
import corrosion_tpu_torch.agent.membership as tms
import corrosion_tpu_torch.models.bridge as tbridge
import corrosion_tpu_torch.net.gossip_codec as tgc
import corrosion_tpu_torch.net.mem as tmem
from corrosion_tpu_torch import bridge_scale as bs
from corrosion_tpu_torch import convert
from corrosion_tpu_torch.models.cluster import ClusterSim as TClusterSim
from corrosion_tpu_torch.ops import swim as T
from corrosion_tpu_torch.runtime import metrics as tmetrics
from corrosion_tpu_torch.runtime import records as trecords
from corrosion_tpu_torch.types import actor as tactor
from corrosion_tpu_torch.types import base as tbase

JAX_SIDE = (jactor, jbase, jgc)
PORT_SIDE = (tactor, tbase, tgc)


def _actor(side, i, addr=None, ts=0, cluster=0, bump=0):
    actor, base, _ = side
    return actor.Actor(
        id=actor.ActorId(bytes([i]) * 16),
        addr=addr if addr is not None else f"node-{i}:{7000 + i}",
        ts=base.Timestamp(ts),
        cluster_id=actor.ClusterId(cluster),
        bump=bump,
    )


def _message(side, kind, target=False, origin=False, updates=0,
             digest=None):
    gc = side[2]
    return gc.SwimMessage(
        gc.MsgKind(kind), 4_000_000_000 + kind, _actor(side, 1, ts=2**40),
        target=_actor(side, 2, ts=5, bump=3) if target else None,
        origin=_actor(side, 3, addr="ô:1", cluster=9) if origin else None,
        updates=[gc.MemberUpdate(_actor(side, 10 + u, ts=u, bump=u % 2),
                                 u * 7, gc.MemberState(u % 3))
                 for u in range(updates)],
        digest=digest,
    )


VARIANTS = [
    dict(),
    dict(target=True),
    dict(origin=True),
    dict(target=True, origin=True),
    dict(updates=3),
    dict(digest=b""),
    dict(digest=b"\x01digest\xff"),
    dict(target=True, origin=True, updates=5, digest=b"d" * 40),
]


@pytest.mark.parametrize("kind", [k.value for k in tgc.MsgKind])
def test_codec_bytes_equal(kind):
    for v in VARIANTS:
        jb = jgc.encode_swim(_message(JAX_SIDE, kind, **v))
        tb = tgc.encode_swim(_message(PORT_SIDE, kind, **v))
        assert tb == jb, v
        # each side decodes the other's bytes to the same message
        jm, tm = jgc.decode_swim(tb), tgc.decode_swim(jb)
        assert tgc.encode_swim(tm) == jb and jgc.encode_swim(jm) == tb
        assert tm.digest == v.get("digest") and len(tm.updates) == v.get(
            "updates", 0)


def test_fill_updates_takes_the_same_updates():
    for v in VARIANTS[:4]:
        msgs = [_message(side, 5, **v) for side in (JAX_SIDE, PORT_SIDE)]
        pool = [[side[2].MemberUpdate(_actor(side, u % 250,
                                              addr=f"sim:{u}"), u,
                                      side[2].MemberState.ALIVE)
                 for u in range(200)] for side in (JAX_SIDE, PORT_SIDE)]
        jgc.fill_updates(msgs[0], pool[0])
        tgc.fill_updates(msgs[1], pool[1])
        assert 0 < len(msgs[1].updates) == len(msgs[0].updates) < 200
        tb = tgc.encode_swim(msgs[1])
        assert tb == jgc.encode_swim(msgs[0])
        assert len(tb) <= tgc.MAX_PACKET == jgc.MAX_PACKET == 1178


def test_undecodable_bytes_raise_the_same_types():
    good = tgc.encode_swim(_message(PORT_SIDE, 2, target=True, updates=2))
    cases = [b"", b"\x09", b"\x00\x01", good[:-1], good[:40],
             good[:5] + b"\xff" * 40,
             good[:-1] + b"\x07",  # a member state that does not exist
             tgc.encode_swim(_message(PORT_SIDE, 0)).replace(b"node-1",
                                                             b"\xff\xfe-1")]
    for data in cases:
        errs = []
        for dec in (jgc.decode_swim, tgc.decode_swim):
            with pytest.raises(Exception) as ei:
                dec(data)
            errs.append(type(ei.value))
        assert errs[0].__name__ == errs[1].__name__, data
        assert issubclass(errs[1], ValueError)


def _deliveries(mem, seed):
    """200 datagrams over 5 nodes under 30 % loss, one partition and one
    downed node; returns the delivered (src, dst, payload) in order."""
    got = []

    async def main():
        net = mem.MemNetwork(seed=seed,
                             faults=mem.LinkFaults(datagram_loss=0.3))
        addrs = [f"n{i}" for i in range(5)]
        for a in addrs:
            async def on_dg(src, data, a=a):
                got.append((src, a, data))

            async def on_uni(src, data):
                pass

            async def on_bi(stream):
                stream.close()

            net.listener(a).serve(on_dg, on_uni, on_bi)
        net.partition("n0", "n1")
        net.take_down("n4")
        pick = random.Random(seed + 1)
        for k in range(200):
            src, dst = pick.sample(addrs, 2)
            await net.transport(src).send_datagram(dst, b"%d" % k)
        for _ in range(5):
            await asyncio.sleep(0)

    asyncio.run(main())
    return got


def test_mem_network_delivers_the_same_datagrams():
    assert tmem.random is random  # the stdlib, not the port's random.py
    for seed in (0, 7):
        got = _deliveries(tmem, seed)
        assert got == _deliveries(jmem, seed)
        assert 60 < len(got) < 140
        assert not any({s, d} == {"n0", "n1"} or "n4" in (s, d)
                       for s, d, _ in got)


class _Capture:
    """A transport that records every datagram sent."""

    def __init__(self):
        self.sent = []

    async def send_datagram(self, addr, data):
        self.sent.append((addr, data))

    def observe_rtt(self, addr, rtt):
        pass


def _scripted(side, ms_mod):
    """Run one datagram sequence through a standalone Membership; return
    its table, downed ids, queue and sent bytes."""
    gc = side[2]
    me = _actor(side, 0, addr="me:0", ts=100)
    cap = _Capture()
    ms = ms_mod.Membership(me, cap, ms_mod.SwimConfig(),
                           rng=random.Random(3))
    U = gc.MemberUpdate
    S = gc.MemberState

    def dg(kind, sender, *updates, probe=0, target=None, origin=None):
        return gc.encode_swim(gc.SwimMessage(
            gc.MsgKind(kind), probe, sender, target=target, origin=origin,
            updates=list(updates)))

    a, b, c, d = (_actor(side, i, ts=10 * i) for i in range(1, 5))
    b2 = _actor(side, 2, ts=99, bump=1)  # b's renewed identity
    seq = [
        dg(0, a, U(b, 0, S.ALIVE), U(c, 2, S.SUSPECT), probe=1),
        dg(6, d),
        dg(1, b, U(c, 2, S.ALIVE), U(c, 3, S.ALIVE), probe=9),
        dg(2, a, U(me, 0, S.SUSPECT), probe=2, target=c),
        dg(3, c, probe=3, target=me, origin=a),
        dg(4, a, U(b, 0, S.DOWN), probe=4, origin=d),
        dg(5, b2, U(b2, 0, S.ALIVE), probe=5, target=c),
        dg(0, a, U(c, 3, S.DOWN), U(d, 1, S.SUSPECT), probe=6),
        dg(7, c, *[U(_actor(side, 20 + k, ts=k), k, S(k % 3))
                   for k in range(30)]),
        dg(8, d, U(d, 1, S.DOWN)),
        b"\x01garbage",
        dg(0, _actor(side, 5, cluster=7), U(a, 9, S.DOWN)),  # other cluster
    ]

    async def main():
        for data in seq:
            await ms.handle_datagram("peer", data)

    asyncio.run(main())
    members = {k.bytes16: (m.actor.ts.ntp64, m.actor.bump, m.incarnation,
                           int(m.state)) for k, m in ms.members.items()}
    queue = [(k.bytes16, gc.encode_swim(gc.SwimMessage(
        gc.MsgKind.FEED, 0, me, updates=[q.update])), q.sends_left)
        for k, q in ms._queue.items()]
    return (members, sorted(k.bytes16 for k in ms.downed), queue,
            ms._incarnation, ms.cluster_size, cap.sent,
            [k.bytes16 for k in ms._probe_ring])


def test_membership_tables_equal():
    got = _scripted(PORT_SIDE, tms)
    want = _scripted(JAX_SIDE, jms)
    assert got == want
    members, downed, queue, inc, size, sent, _ = got
    assert len(members) > 20 and len(downed) >= 3 and len(sent) >= 4
    assert inc == 1  # refuted the suspicion about itself


def test_swim_config_scaling_equal():
    ns = sorted(set(range(1, 300)) | {10**k for k in range(3, 7)}
                | {2**k + d for k in range(9, 20) for d in (-1, 0, 1)})
    for lifeguard in (False, True):
        jc = jms.SwimConfig(lifeguard=lifeguard)
        tc = tms.SwimConfig(lifeguard=lifeguard)
        assert tc == tms.SwimConfig(**vars(jc))
        for n in ns:
            assert tc.suspect_timeout(n) == jc.suspect_timeout(n)
            assert tc.max_transmissions(n) == jc.max_transmissions(n)
            for k in range(6):
                assert (tc.suspect_timeout_confirmed(n, k)
                        == jc.suspect_timeout_confirmed(n, k))


def _jax_wire(n):
    net = jmem.MemNetwork(seed=0)
    bridge = jbridge.KernelPeerBridge(net, JClusterSim(n, seed=3))
    return asyncio.run(bs.wire_replies(bridge, net))


@pytest.mark.parametrize("n", [64, 192])
def test_bridge_replies_equal_jax(n):
    import chip_smoke

    net = tmem.MemNetwork(seed=0)
    bridge = tbridge.KernelPeerBridge(
        net, TClusterSim(n, seed=3, device="cpu"))
    got = asyncio.run(bs.wire_replies(bridge, net))
    assert isinstance(bridge._alive, np.ndarray)
    assert isinstance(bridge._inc, np.ndarray)
    want = _jax_wire(n)
    assert got == want
    # ACK, FEED, FORWARDED_ACK, INDIRECT_PING, INDIRECT_ACK, relayed
    # FORWARDED_ACK and ACK per round; nothing from the crashed member
    assert len(got) == 3 * 7 + 2  # the restarted member answers in round 3
    assert bs.wire_digest(got) == chip_smoke.BRIDGE_REF[n]


async def _jax_agent(net, addr):
    from corrosion_tpu.agent.run import shutdown
    from tests.test_agent import boot

    agent = await boot(net, addr)
    return SimpleNamespace(membership=agent.membership,
                           close=lambda: shutdown(agent))


def test_jax_agent_absorbs_port_bridge_and_detects_crashes():
    """tests/test_bridge.py's scenario with the JAX package's real agent
    on its own MemNetwork, in front of the port's bridge over a port
    ClusterSim."""
    rec = asyncio.run(bs.silent_pipeline(
        "cpu", net=jmem.MemNetwork(seed=11), start=_jax_agent))
    assert rec["cluster_size"] == 193 - 3


def test_port_prober_absorbs_and_detects_silent_crashes():
    rec = asyncio.run(bs.silent_pipeline("cpu"))
    assert rec["cluster_size"] == 190 and rec["device"] == "cpu"


def test_gossip_rung_downs_exactly_the_crashed_members():
    rec = asyncio.run(bs.rung(400, 8, "gossip", device="cpu"))
    assert rec["absorbed"] and rec["detected"]
    assert rec["false_positives"] == 0 and rec["n_crash"] == 8
    assert rec["cluster_size"] == 400 + 1 - 8
    assert rec["rung"] == "bridge-400-gossip" and rec["device"] == "cpu"
    assert bs.crash_set(100_000, 50) == list(range(0, 100_000, 2000))


def test_membership_stats_equal():
    """The dense sim's stats after 10 ticks at n=256 (three members
    crashed first), through both packages' `membership_stats`."""
    sim = TClusterSim(256, seed=3, device="cpu")
    for j in (5, 100, 200):
        sim.crash(j)
    sim.step(10)
    fields = convert.swim_state_to_numpy(sim.state)
    js = J.SwimState(**{k: jax.numpy.asarray(v) for k, v in fields.items()})
    want = J.membership_stats(js)
    got = T.membership_stats(sim.state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert 0 < got["coverage"] < 1


def test_histogram_matches_reference():
    values = [0.0, 0.001, 0.0011, 0.02, 0.5, 3.0, 11.0, 0.05]
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    for v in values:
        jreg.histogram("corro.transport.rtt.seconds", addr="a").observe(v)
        treg.histogram("corro.transport.rtt.seconds", addr="a").observe(v)
    jh = jreg.histogram("corro.transport.rtt.seconds", addr="a")
    th = treg.histogram("corro.transport.rtt.seconds", addr="a")
    assert (th.buckets, th.counts, th.total, th.count) == (
        jh.buckets, jh.counts, jh.total, jh.count)
    rows = [sorted(r for r in reg.snapshot() if r[0] == "histogram")
            for reg in (treg, jreg)]
    assert rows[0] == rows[1] and len(rows[0]) == 2


def test_merge_records_matches_reference(tmp_path):
    for mod, name in ((jrecords, "j.json"), (trecords, "t.json")):
        path = str(tmp_path / name)
        mod.merge_records(path, [{"rung": "a", "v": 1}, {"rung": "b"}])
        mod.merge_records(path, [{"rung": "a", "v": 2}, {"rung": "c"}])
        with pytest.raises(KeyError):
            mod.merge_records(path, [{"v": 3}])
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text())
            == [{"rung": "b"}, {"rung": "a", "v": 2}, {"rung": "c"}])


def test_bridge_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(bs.rung(16, 1, "gossip"))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(bs.silent_pipeline())


if __name__ == "__main__":
    print("BRIDGE_REF = {")
    for n in (64, 192):
        print(f'    {n}: "{bs.wire_digest(_jax_wire(n))}",')
    print("}")
