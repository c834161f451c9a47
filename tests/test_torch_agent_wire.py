"""The agent's wire and pure functions in the port against the JAX
package's: the broadcast envelopes and sync messages byte for byte, the
sync set algebra, the hybrid logical clock, the member RTT rings and the
persisted member states, the membership additions, the egress token
bucket, `load_config`, and `process_multiple_changes` driven directly.

Every comparison is exact, on inputs made from seeds.
"""

import asyncio
import os
import random

import pytest

from corrosion_tpu.agent import broadcast as jbroadcast
from corrosion_tpu.agent import ingest as jingest
from corrosion_tpu.agent import member_store as jms
from corrosion_tpu.agent import members as jmembers
from corrosion_tpu.agent.handle import ChangeSource as JSource
from corrosion_tpu.net import mem as jmem
from corrosion_tpu.runtime import config as jconfig
from corrosion_tpu.store.bookkeeping import (
    Bookie as JBookie,
    PartialVersion as JPartial,
)
from corrosion_tpu import sync as jsync
from corrosion_tpu.types import actor as jactor
from corrosion_tpu.types import base as jbase
from corrosion_tpu.types import change as jchange
from corrosion_tpu.types import codec as jcodec
from corrosion_tpu.types.rangeset import RangeSet as JRangeSet
from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch import sync as tsync
from corrosion_tpu_torch.agent import broadcast as tbroadcast
from corrosion_tpu_torch.agent import ingest as tingest
from corrosion_tpu_torch.agent import member_store as tms
from corrosion_tpu_torch.agent import members as tmembers
from corrosion_tpu_torch.agent import run as trun
from corrosion_tpu_torch.agent.handle import ChangeSource as TSource
from corrosion_tpu_torch.net import mem as tmem
from corrosion_tpu_torch.runtime import config as tconfig
from corrosion_tpu_torch.runtime import trace as ttrace
from corrosion_tpu_torch.store.bookkeeping import (
    Bookie as TBookie,
    PartialVersion as TPartial,
)
from corrosion_tpu_torch.types import actor as tactor
from corrosion_tpu_torch.types import base as tbase
from corrosion_tpu_torch.types import change as tchange
from corrosion_tpu_torch.types import codec as tcodec
from corrosion_tpu_torch.types.rangeset import RangeSet as TRangeSet
from corrosion_tpu.runtime import trace as jtrace

# one namespace per package: (actor, base, change, codec) modules
J = (jactor, jbase, jchange, jcodec)
T = (tactor, tbase, tchange, tcodec)
TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def _changes(pkg, rng: random.Random, n: int, version: int, site: bytes):
    _actor, base, change, _codec = pkg
    vals = [None, 7, -3, 2.5, "txt", "x" * 300, b"\x00\xffblob"]
    out = []
    for seq in range(n):
        out.append(change.Change(
            table=rng.choice(["tests", "kv"]),
            pk=bytes([1, 9, rng.randint(0, 255)]),
            cid=rng.choice(["text", "a", change.SENTINEL]),
            val=rng.choice(vals), col_version=rng.randint(1, 5),
            db_version=version, seq=seq, site_id=site,
            cl=rng.choice([1, 1, 2, 3]),
            ts=base.Timestamp(rng.getrandbits(63))))
    return out


def _change_v1s(pkg, seed: int):
    """Complete, partial, empty and empty-set changesets of one actor,
    with and without the envelope's origin stamp, traceparent and trace
    meta."""
    actor, base, change, _codec = pkg
    rng = random.Random(seed)
    aid = actor.ActorId(bytes(range(16)))
    ts = base.Timestamp(123456789 << 20)
    chs = _changes(pkg, rng, 6, 4, aid.bytes16)
    full = change.ChangesetFull(version=4, changes=tuple(chs), seqs=(0, 5),
                                last_seq=5, ts=ts)
    part = change.ChangesetFull(version=9, changes=tuple(chs[2:4]),
                                seqs=(2, 3), last_seq=5, ts=ts)
    empty = change.ChangesetEmpty(versions=(3, 8), ts=ts)
    eset = change.ChangesetEmptySet(versions=((1, 2), (5, 7)), ts=ts)
    out = []
    for cs in (full, part, empty, eset):
        for origin_ts, tp, meta in ((None, None, None), (1.5e9, None, None),
                                    (1.25e9, TP, None), (None, TP, 5),
                                    (2e9, TP, 0x0D)):
            out.append(change.ChangeV1(actor_id=aid, changeset=cs,
                                       origin_ts=origin_ts, traceparent=tp,
                                       trace_meta=meta))
    return out


def test_uni_payloads_are_byte_equal():
    """Uni payloads (envelope ext absent, v1/v2 with a digest, v3 with
    trace meta), each way decodable by the other package."""
    jcvs, tcvs = _change_v1s(J, 1), _change_v1s(T, 1)
    for jcv, tcv in zip(jcvs, tcvs):
        for cluster, dig in ((0, None), (7, None), (3, b"\x01digest"),
                             (0, b"")):
            jb = jcodec.encode_uni_payload(jcv, jactor.ClusterId(cluster),
                                           digest=dig)
            tb = tcodec.encode_uni_payload(tcv, tactor.ClusterId(cluster),
                                           digest=dig)
            assert jb == tb
            jp = jcodec.encode_uni_prefix(jcv, jactor.ClusterId(cluster))
            tp = tcodec.encode_uni_prefix(tcv, tactor.ClusterId(cluster))
            assert jp == tp
            assert (jcodec.encode_uni_from_prefix(
                        jp, jcv.origin_ts, jcv.traceparent, dig,
                        jcv.trace_meta)
                    == tcodec.encode_uni_from_prefix(
                        tp, tcv.origin_ts, tcv.traceparent, dig,
                        tcv.trace_meta))
            tcv2, tcl, tdig = tcodec.decode_uni_payload_ext(jb)
            jcv2, jcl, jdig = jcodec.decode_uni_payload_ext(jb)
            assert (tcl.value, tdig) == (jcl.value, jdig)
            assert (tcodec.encode_uni_payload(tcv2, tcl, digest=tdig)
                    == jcodec.encode_uni_payload(jcv2, jcl, digest=jdig))
            assert (tcv2.origin_ts, tcv2.traceparent, tcv2.trace_meta) == (
                jcv.origin_ts, jcv.traceparent, jcv.trace_meta)
        assert (jcodec.encode_change_v1_body(jcv)
                == tcodec.encode_change_v1_body(tcv))
        jw = jcodec.Writer()
        jcodec.write_change_v1(jw, jcv)
        tw = tcodec.Writer()
        tcodec.write_change_v1(tw, tcv)
        assert jw.bytes() == tw.bytes()
        assert (tcodec.with_wire_body(tcv).wire_body
                == jcodec.with_wire_body(jcv).wire_body)


def test_chunked_change_v1_is_byte_equal_over_many_chunks():
    for seed in (2, 3):
        rng_j, rng_t = random.Random(seed), random.Random(seed)
        site = bytes([seed]) * 16
        jch = _changes(J, rng_j, 60, 11, site)
        tch = _changes(T, rng_t, 60, 11, site)
        kw = dict(origin_ts=1.7e9, traceparent=TP, trace_meta=4)
        for max_bytes, seq_range in ((8 * 1024, None), (700, None),
                                     (500, (10, 40))):
            jc = jcodec.chunked_change_v1(
                jactor.ActorId(site), 11, jch, 59, jbase.Timestamp(99),
                max_bytes=max_bytes, seq_range=seq_range, **kw)
            tc = tcodec.chunked_change_v1(
                tactor.ActorId(site), 11, tch, 59, tbase.Timestamp(99),
                max_bytes=max_bytes, seq_range=seq_range, **kw)
            assert len(jc) == len(tc) and (max_bytes > 1000 or len(jc) > 2)
            for a, b in zip(jc, tc):
                assert a.wire_body == b.wire_body
                assert (jcodec.encode_uni_payload(a)
                        == tcodec.encode_uni_payload(b))


def test_bi_payloads_are_byte_equal():
    jaid, taid = jactor.ActorId(b"\x05" * 16), tactor.ActorId(b"\x05" * 16)
    for trace in ((None, None), (TP, None), (TP, "k=v")):
        jb = jcodec.encode_bi_payload_sync_start(
            jaid, jcodec.SyncTraceContext(*trace), jactor.ClusterId(4))
        tb = tcodec.encode_bi_payload_sync_start(
            taid, tcodec.SyncTraceContext(*trace), tactor.ClusterId(4))
        assert jb == tb
        kind, (aid, tr, cl) = tcodec.decode_bi_payload_any(jb)
        assert kind == "sync" and aid == taid and cl == tactor.ClusterId(4)
        assert (tr.traceparent, tr.tracestate) == trace
    for tp in (None, TP):
        jr = jcodec.SnapshotReq(jaid, b"s" * 32, jactor.ClusterId(2), tp)
        tr_ = tcodec.SnapshotReq(taid, b"s" * 32, tactor.ClusterId(2), tp)
        jb = jcodec.encode_bi_payload_snapshot_req(jr)
        assert jb == tcodec.encode_bi_payload_snapshot_req(tr_)
        kind, req = tcodec.decode_bi_payload_any(jb)
        assert kind == "snapshot" and req == tr_


def _sync_msgs(pkg, codec):
    actor, base, _change, _codec = pkg
    a = [actor.ActorId(bytes([i]) * 16) for i in (1, 2, 3)]
    state = codec.SyncState(
        actor_id=a[0], heads={a[1]: 40, a[2]: 7},
        need={a[1]: [(3, 5), (9, 9)]},
        partial_need={a[2]: {6: [(0, 2), (5, 9)]}},
        last_cleared_ts=base.Timestamp(77))
    request = [(a[1], [codec.NeedFull((3, 5)),
                       codec.NeedPartial(6, ((0, 2), (5, 9))),
                       codec.NeedEmpty(base.Timestamp(5)),
                       codec.NeedEmpty(None)]),
               (a[2], [])]
    return [state, codec.SyncState(a[2], {}, {}, {}),
            base.Timestamp(1 << 40), codec.SyncRejection(0),
            codec.SyncRejection(1), request] + _change_v1s(pkg, 5)


def test_sync_messages_and_frames_are_byte_equal():
    jm, tm = _sync_msgs(J, jcodec), _sync_msgs(T, tcodec)
    stream_j, stream_t = b"", b""
    for a, b in zip(jm, tm):
        jb, tb = jcodec.encode_sync_msg(a), tcodec.encode_sync_msg(b)
        assert jb == tb
        back = tcodec.decode_sync_msg(jb)
        assert tcodec.encode_sync_msg(back) == jb
        stream_j += jcodec.frame(jb)
        stream_t += tcodec.frame(tb)
    assert stream_j == stream_t
    pos, n = 0, 0
    while True:
        payload, pos2 = tcodec.deframe(stream_j, pos)
        if payload is None:
            break
        assert payload == jcodec.deframe(stream_j, pos)[0]
        pos, n = pos2, n + 1
    assert n == len(jm) and pos == len(stream_j)
    assert tcodec.deframe(stream_j[:3]) == jcodec.deframe(stream_j[:3])


@pytest.mark.parametrize("data", [
    b"", b"\x01", b"\x00\x00\x00\x00\x09\x00\x00\x00",
    b"\x01\x00\x00\x00\x00", b"\xff" * 40, bytes(range(64)),
])
def test_undecodable_bytes_raise_the_same_errors(data):
    for fn in ("decode_sync_msg", "decode_uni_payload_ext",
               "decode_bi_payload_any"):
        errs = []
        for codec in (jcodec, tcodec):
            try:
                getattr(codec, fn)(data)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 - compared by type
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1], (fn, errs)
    with pytest.raises(ValueError):
        tcodec.frame(b"x" * (tcodec.MAX_FRAME + 1))


# -- pure functions -------------------------------------------------------------


def _bookie(pkg_bookie, partial_cls, rs_cls, aid_cls, ts_cls, seed: int):
    """A bookie with gaps and partials over four actors, from a seed."""
    rng = random.Random(seed)
    bk = pkg_bookie()
    for a in range(1, 5):
        aid = aid_cls(bytes([a]) * 16)
        booked = bk.ensure(aid)
        with booked.write("test") as bv:
            snap = bv.snapshot()
            seen = rs_cls()
            for _ in range(rng.randint(0, 6)):
                lo = rng.randint(1, 60)
                seen.insert(lo, lo + rng.randint(0, 5))
            snap.insert_db(_NullGaps(), seen)
            bv.commit_snapshot(snap)
            for _ in range(rng.randint(0, 3)):
                v = rng.randint(1, 70)
                last = rng.randint(3, 12)
                lo = rng.randint(0, last)
                bv.insert_partial(v, partial_cls(
                    seqs=rs_cls([(lo, min(last, lo + rng.randint(0, 4)))]),
                    last_seq=last, ts=ts_cls(v)))
    return bk


class _NullGaps:
    def delete_gap(self, *a):
        pass

    def insert_gap(self, *a):
        pass


def _state_tuple(st):
    return (st.actor_id.bytes16, sorted((k.bytes16, v) for k, v in
                                        st.heads.items()),
            sorted((k.bytes16, v) for k, v in st.need.items()),
            sorted((k.bytes16, sorted(v.items()))
                   for k, v in st.partial_need.items()))


def _needs_tuple(needs):
    return sorted((k.bytes16, [repr(n) for n in v]) for k, v in needs.items())


@pytest.mark.parametrize("seed", range(6))
def test_generate_sync_and_available_needs_are_equal(seed):
    me_j, me_t = jactor.ActorId(b"\xee" * 16), tactor.ActorId(b"\xee" * 16)
    states = []
    for pkg_bk, pcls, rcls, acls, tcls, sync_mod, me in (
            (JBookie, JPartial, JRangeSet, jactor.ActorId, jbase.Timestamp,
             jsync, me_j),
            (TBookie, TPartial, TRangeSet, tactor.ActorId, tbase.Timestamp,
             tsync, me_t)):
        ours = sync_mod.generate_sync(
            _bookie(pkg_bk, pcls, rcls, acls, tcls, seed), me)
        theirs = sync_mod.generate_sync(
            _bookie(pkg_bk, pcls, rcls, acls, tcls, seed + 100), me)
        states.append((ours, theirs, sync_mod))
    (jo, jt, _), (to, tt, _) = states
    assert _state_tuple(jo) == _state_tuple(to)
    assert _state_tuple(jt) == _state_tuple(tt)
    assert (_needs_tuple(jsync.compute_available_needs(jo, jt))
            == _needs_tuple(tsync.compute_available_needs(to, tt)))
    assert jsync.state_need_len(jo) == tsync.state_need_len(to)
    assert jsync.state_held_total(jt) == tsync.state_held_total(tt)
    assert (jcodec.encode_sync_msg(jo) == tcodec.encode_sync_msg(to))
    for args in ((1, 100, 7), (5, 5, 3), (1, 10, 100)):
        assert jsync.chunk_range(*args) == tsync.chunk_range(*args)


def test_hlc_with_a_fixed_clock(monkeypatch):
    now = [1_700_000_000.25]
    for mod in (jbase, tbase):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
    out = []
    for mod in (jbase, tbase):
        clk = mod.HLClock()
        seq = [clk.new_timestamp().ntp64 for _ in range(3)]
        ahead = mod.Timestamp.from_unix(now[0] + 0.2)
        far = mod.Timestamp.from_unix(now[0] + 5.0)
        seq += [clk.update_with_timestamp(ahead),
                clk.update_with_timestamp(far), clk.peek().ntp64,
                clk.new_timestamp().ntp64]
        out.append(seq)
    assert out[0] == out[1] and out[0][3] is True and out[0][4] is False


def test_member_rtt_rings_are_equal():
    rng = random.Random(3)
    ops = []
    for i in range(200):
        ops.append((rng.choice(["add", "rtt", "rtt", "remove"]),
                    rng.randint(0, 9), rng.random() * 0.4))
    res = []
    for actor, members in ((jactor, jmembers), (tactor, tmembers)):
        m = members.Members()
        trail = []
        for op, k, v in ops:
            a = actor.Actor(id=actor.ActorId(bytes([k]) * 16),
                            addr=f"n{k}", ts=_ts(actor, k),
                            cluster_id=actor.ClusterId(0))
            if op == "add":
                trail.append(m.add_member(a))
            elif op == "remove":
                trail.append(m.remove_member(a))
            else:
                m.observe_rtt(f"n{k}", v)
        trail.append(sorted((aid.bytes16, i.ring)
                            for aid, i in m.states.items()))
        trail.append([x.addr for x in m.ring0()])
        trail.append(sorted(x.addr for x in m.not_ring0()))
        res.append(trail)
    assert res[0] == res[1]
    assert [jmembers.ring_for_rtt(x) for x in (1, 10, 50, 100, 500)] == [
        tmembers.ring_for_rtt(x) for x in (1, 10, 50, 100, 500)]


def _ts(actor_mod, k):
    base = jbase if actor_mod is jactor else tbase
    return base.Timestamp(1000 + k)


def test_member_state_json_round_trips_both_ways():
    from corrosion_tpu.net.gossip_codec import MemberState as JState
    from corrosion_tpu_torch.net.gossip_codec import MemberState as TState

    for k, (js, ts_) in enumerate(zip(JState, TState)):
        ja = jactor.Actor(jactor.ActorId(bytes([k + 1]) * 16), f"h{k}:1",
                          jbase.Timestamp(5 + k), jactor.ClusterId(k), k)
        ta = tactor.Actor(tactor.ActorId(bytes([k + 1]) * 16), f"h{k}:1",
                          tbase.Timestamp(5 + k), tactor.ClusterId(k), k)
        jt = jms._state_json(ja, 3 + k, js)
        tt = tms._state_json(ta, 3 + k, ts_)
        assert jt == tt
        back = tms._state_from_json(jt)
        assert (back[0], back[1], back[2].value) == (ta, 3 + k, ts_.value)
        jb = jms._state_from_json(tt)
        assert (jb[0], jb[1], jb[2].value) == (ja, 3 + k, js.value)
    assert tms._state_from_json("not json") == jms._state_from_json(
        "not json")


def test_token_bucket_and_fit_to_bucket(monkeypatch):
    clock = [100.0]
    for mod in (jbroadcast, tbroadcast):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    jb, tb = jbroadcast.TokenBucket(1000.0), tbroadcast.TokenBucket(1000.0)
    rng = random.Random(4)
    for _ in range(100):
        clock[0] += rng.random() * 0.2
        n = rng.randint(1, 600)
        assert jb.try_take(n) == tb.try_take(n)
        assert jb.tokens == tb.tokens
    jcv = [c for c in _change_v1s(J, 9) if c.traceparent][0]
    tcv = [c for c in _change_v1s(T, 9) if c.traceparent][0]
    for cap in (10_000.0, 1000.0, 400.0):
        ja, ta = jbroadcast._fit_to_bucket(jcv, cap), \
            tbroadcast._fit_to_bucket(tcv, cap)
        assert [jcodec.encode_uni_payload(c) for c in ja] == [
            tcodec.encode_uni_payload(c) for c in ta]


def test_trace_propagation_is_the_reference():
    for tp in (TP, TP.upper(), "00-" + "0" * 32 + "-b7ad6b7169203331-01",
               "garbage", None, "00-0af7651916cd43dd8448eb211c80319c-"
               "b7ad6b7169203331-00"):
        j, t = jtrace.parse_traceparent(tp), ttrace.parse_traceparent(tp)
        assert (j is None) == (t is None)
        if j is not None:
            assert (j.trace_id, j.span_id, j.sampled, j.traceparent()) == (
                t.trace_id, t.span_id, t.sampled, t.traceparent())
    for forced in (False, True):
        for hop in (-1, 0, 5, 63, 100):
            m = jtrace.make_meta(forced, hop)
            assert m == ttrace.make_meta(forced, hop)
            assert jtrace.bump_hop(m) == ttrace.bump_hop(m)
            assert (jtrace.meta_hop(m), jtrace.meta_forced(m)) == (
                ttrace.meta_hop(m), ttrace.meta_forced(m))
    assert ttrace.bump_hop(None) is None
    with ttrace.continue_from(TP, "sync.server", peer="x") as sp:
        assert sp.ctx.trace_id == TP.split("-")[1]
        with ttrace.span("child") as child:
            pass
    assert (child.ctx.trace_id, child.parent.span_id) == (
        sp.ctx.trace_id, sp.ctx.span_id)
    with ttrace.span("after") as after:
        pass
    assert after.parent is None and after.ctx.trace_id != sp.ctx.trace_id
    ctx = ttrace.stage_span(TP, "ingest.apply", "apply", 0.25, actor="a")
    last = ttrace.SPANS.recent(1)[0]
    assert (last.name, last.trace_id, last.parent_span_id) == (
        "ingest.apply", ctx.trace_id, TP.split("-")[2])
    assert last.attrs == {"stage": "apply", "actor": "a"}


def test_load_config_gives_equal_dataclasses(tmp_path):
    toml = tmp_path / "corro.toml"
    toml.write_text("""
[db]
path = "/var/lib/corro/state.db"
schema_paths = ["/etc/corro/schema"]
[api]
bind_addr = "127.0.0.1:9000"
[gossip]
bind_addr = "0.0.0.0:8787"
bootstrap = ["a:1", "b:2@127.0.0.1:53"]
plaintext = true
cluster_id = 3
transport = "quic"
[perf]
apply_queue_len = 77
broadcast_interval_ms = 40
group_commit = false
[slo]
objective = 0.95
canary = false
[trace]
enabled = false
lottery_n = 9
[tsdb]
enabled = false
[profile]
enabled = false
hz = 11
[alerts]
enabled = false
[remediation]
enabled = true
[pubsub]
candidate_batch_wait = 0.02
[subs]
max_subs = 17
[sync]
snapshot = false
max_concurrent_snapshot_serves = 4
[cluster]
digests = false
[admin]
uds_path = "/tmp/admin.sock"
[consul]
enabled = false
[telemetry]
prometheus_addr = "127.0.0.1:9090"
[log]
format = "json"
""")
    env = {"CORRO_PERF__SYNC_INTERVAL_MIN_SECS": "0.5",
           "CORRO_GOSSIP__BOOTSTRAP": "x:1,y:2",
           "CORRO_SYNC__SNAPSHOT": "true", "CORRO_API__BIND_ADDR": "h:1",
           "CORRO_NOPE__X": "1", "CORRO_CRDT_ENGINE": "array"}
    j = jconfig.load_config(str(toml), env=env)
    t = tconfig.load_config(str(toml), env=env)
    import dataclasses

    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.perf.apply_queue_len == 77 and t.sync.snapshot is True
    assert dataclasses.asdict(jconfig.Config()) == dataclasses.asdict(
        tconfig.Config())


# -- process_multiple_changes, driven -----------------------------------------


def _script(pkg, seed: int):
    """Changesets of two origins: complete versions, a version in three
    chunks delivered out of order, a duplicate, a stale re-delivery and
    an empty set."""
    actor, base, change, codec = pkg
    rng = random.Random(seed)
    out = []
    for a in (1, 2):
        aid = actor.ActorId(bytes([a]) * 16)
        cvs = []
        for v in range(1, 7):
            chs = []
            for seq in range(rng.randint(2, 5) if v != 4 else 9):
                chs.append(change.Change(
                    table="tests", pk=bytes([1, 9, rng.randint(0, 20)]),
                    cid="text", val=f"{a}-{v}-{seq}",
                    col_version=rng.randint(1, 4), db_version=v, seq=seq,
                    site_id=aid.bytes16, cl=1, ts=base.Timestamp(v)))
            last = len(chs) - 1
            if v == 4:
                for lo, hi in ((6, 8), (0, 2), (3, 5)):
                    cvs.append(change.ChangeV1(aid, change.ChangesetFull(
                        v, tuple(chs[lo:hi + 1]), (lo, hi), last,
                        base.Timestamp(v))))
            else:
                cvs.append(change.ChangeV1(aid, change.ChangesetFull(
                    v, tuple(chs), (0, last), last, base.Timestamp(v))))
        cvs.append(cvs[0])  # duplicate
        cvs.insert(2, cvs[5])  # out of order
        cvs.append(change.ChangeV1(aid, change.ChangesetEmptySet(
            ((8, 9),), base.Timestamp(9))))
        out.extend(cvs)
    rng.shuffle(out)
    return out


def _bookie_dump(bookie):
    out = []
    for aid, booked in sorted(bookie.items().items(),
                              key=lambda kv: kv[0].bytes16):
        with booked.read() as bv:
            out.append((aid.bytes16, bv.last(), list(bv.needed),
                        sorted((v, list(p.seqs), p.last_seq)
                               for v, p in bv.partials.items())))
    return out


def _driven(api, ingest, source, pkg, db_dir, engine):
    async def boot():
        cfg = ac.fast_config(api, "driven", db_dir)
        return await api.setup(cfg, network=api.MemNetwork(seed=1))

    agent = asyncio.run(boot())
    try:
        agent.store.apply_schema_sql(ac.TEST_SCHEMA)
        script = _script(pkg, 7)
        with cb.engine_env(engine):
            for i in range(0, len(script), 4):
                ingest.process_multiple_changes(
                    agent, [(cv, source.SYNC) for cv in script[i:i + 4]])
        return cb.dump_state(agent.store), _bookie_dump(agent.bookie)
    finally:
        asyncio.run(api.shutdown(agent))


def _jax_api():
    from tests.test_torch_agent import jax_api

    return jax_api()


@pytest.mark.parametrize("engine", ["python", "array"])
def test_process_multiple_changes_driven_equals_the_reference(tmp_path,
                                                              engine):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    j = _driven(_jax_api(), jingest, JSource, J, str(tmp_path / "j"),
                "python")
    t = _driven(ac.port_api("cpu"), tingest, TSource, T,
                str(tmp_path / "t"), engine)
    assert t == j
    assert len(j[0]["tests"]) > 0 and j[1][0][1] == 9


def test_membership_additions_are_the_reference(monkeypatch):
    """`leave`, `apply_many`, `active_members`, `lhm`, `rejoin` and
    `change_cluster_id` on the two packages' Membership, datagrams
    captured (the renewed identities' clock fixed)."""
    for mod in (jbase, tbase):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.5)
    from corrosion_tpu.agent.membership import Membership as JM, \
        SwimConfig as JC
    from corrosion_tpu.net.gossip_codec import MemberState as JS
    from corrosion_tpu_torch.agent.membership import Membership as TM, \
        SwimConfig as TC
    from corrosion_tpu_torch.net.gossip_codec import MemberState as TS

    async def drive(M, C, S, actor, base, mem):
        net = mem.MemNetwork(seed=3)
        sent = []

        class Capture:
            async def send_datagram(self, addr, data):
                sent.append((addr, bytes(data)))

            def set_rtt_sink(self, sink):
                pass

        me = actor.Actor(actor.ActorId(b"\x01" * 16), "me",
                         base.Timestamp(10), actor.ClusterId(0))
        import random as stdrandom

        m = M(me, Capture(), C(), rng=stdrandom.Random(5))
        peers = [actor.Actor(actor.ActorId(bytes([i]) * 16), f"p{i}",
                             base.Timestamp(i), actor.ClusterId(0))
                 for i in range(2, 8)]
        m.apply_many([(p, i % 3, [S.ALIVE, S.SUSPECT, S.DOWN][i % 3])
                      for i, p in enumerate(peers)])
        act = sorted(a.addr for a in m.active_members())
        await m.leave()
        ident = await m.rejoin()
        ident2 = await m.change_cluster_id(actor.ClusterId(9))
        del net
        return (act, m.lhm, m.lhm_multiplier, m.cluster_size, sent,
                (ident.bump, ident2.bump, ident2.cluster_id.value
                 if hasattr(ident2.cluster_id, "value") else
                 int(ident2.cluster_id)))

    j = asyncio.run(drive(JM, JC, JS, jactor, jbase, jmem))
    t = asyncio.run(drive(TM, TC, TS, tactor, tbase, tmem))
    assert j == t and j[0] and j[4]


def test_concurrent_applies_count_every_batch(tmp_path):
    """Several stores applied from more threads than cores at once, the
    interpreter switching threads every 10 µs: every batch is counted
    exactly once in its store's array lane and in the readbacks, and
    each store ends with the rows one thread alone would give it."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from corrosion_tpu_torch import ingest_bench
    from corrosion_tpu_torch.ops import crdt_merge
    from corrosion_tpu_torch.store.crdt import CrdtStore
    from corrosion_tpu_torch.store_checks import converged_part

    def state(st):
        return converged_part(cb.dump_state(st))

    changes = ingest_bench.gen_uniform(1200, 60)
    batches = [changes[i:i + 40] for i in range(0, len(changes), 40)]

    def new_store(name):
        st = CrdtStore(str(tmp_path / f"{name}.db"), device="cpu")
        st.apply_schema_sql(ingest_bench.SCHEMA)
        return st

    with cb.engine_env("array"):
        alone = new_store("alone")
        for b in batches:
            alone.apply_changes(b)
        want = state(alone)
        alone.close()
        stores = [new_store(f"s{i}") for i in range(4)]
        reads0 = crdt_merge.read_decisions.readbacks
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ThreadPoolExecutor(4 * (os.cpu_count() or 1) + 4) as ex:
                futs = [ex.submit(st.apply_changes, b)
                        for b in batches for st in stores]
                for f in futs:
                    f.result(timeout=120)
        finally:
            sys.setswitchinterval(old)
    lanes = [st.array_lane for st in stores]
    reads = crdt_merge.read_decisions.readbacks - reads0
    states = [state(st) for st in stores]
    for st in stores:
        st.close()
    assert lanes == [{"decided": len(batches), "declined": 0}] * 4
    assert reads == 4 * len(batches)
    # a store's batches land in any order here: every order reaches one
    # converged part (the rest of a clock row keeps the first arrival)
    assert all(s == want for s in states)


def test_latency_plane_is_the_reference(monkeypatch):
    """The same samples through both packages' latency plane: windowed
    percentiles, `e2e_observe` (skew clamped) into a registry of each, and
    an `SloMonitor` whose breach streak fires one incident."""
    from corrosion_tpu.runtime import latency as jl
    from corrosion_tpu.runtime import metrics as jm
    from corrosion_tpu_torch.runtime import latency as tl
    from corrosion_tpu_torch.runtime import metrics as tm

    rng = random.Random(6)
    samples = [(rng.random() * 200, rng.lognormvariate(-4, 1.5) - 0.002)
               for _ in range(3000)]
    samples.sort()
    out = []
    for lat, met in ((jl, jm), (tl, tm)):
        now = [0.0]
        w = lat.WindowedLatency(clock=lambda: now[0])
        reg = met.Registry()
        for t, v in samples:
            now[0] = t
            w.observe(abs(v))
            lat.e2e_observe("apply", v, registry=reg, source="sync")
        qs = [w.window_hist(60.0).quantile(q) for q in (0.5, 0.9, 0.99)]
        qs += [w.snapshot_cumulative().quantile(q) for q in (0.5, 0.999)]
        clamped = reg.counter("corro.e2e.skew.clamped.total",
                              stage="apply").value
        monkeypatch.setattr(lat.time, "monotonic", lambda: 1e9)
        slo = lat.SloMonitor({"apply": 0.001}, objective=0.99,
                             window_secs=1e12, breach_checks=2,
                             registry=reg)
        reports = [slo.check()["apply"] for _ in range(3)]
        incidents = reg.counter("corro.slo.incidents.total",
                                stage="apply").value
        out.append((qs, clamped, [(r["p99"], r["burn_rate"], r["breached"])
                                  for r in reports], incidents))
    assert out[0] == out[1]
    assert out[1][1] > 0 and out[1][3] == 1


def test_remote_applies_from_threads_of_several_stores_on_the_cpu(tmp_path):
    """`ingest_bench.apply_concurrently` at a small size: every store, fed
    from a thread of its own under `array`, ends at the digest its rung
    reaches applied alone under `python`, and decided batches."""
    from corrosion_tpu_torch import ingest_bench

    streams = {r: ch[:1500] for r, ch in ingest_bench.rungs().items()}
    want = {r: ingest_bench.apply_rung(r, ch, ingest_bench.BATCH, "python",
                                       str(tmp_path), "cpu")["digest"]
            for r, ch in streams.items()}
    got = ingest_bench.apply_concurrently("cpu", 2, streams)
    assert sorted(g["rung"] for g in got) == sorted(2 * list(streams))
    assert [g["digest"] for g in got] == [want[g["rung"]] for g in got]
    assert all(g["lane"]["decided"] > 0 for g in got)
