"""The port's gossip planes (`net/seahash.py`, `net/quic.py`,
`net/tcp.py`, `tls.py` and the transport branch of `agent/run.py::
setup`) against the JAX package's on the CPU.

The wire functions get the same seeded inputs in both packages and must
give the same bytes: SeaHash (the crate's vectors, random buffers fed
whole and in random pieces, the subscription hash), QUIC varints, packet
number decoding, transport parameters, ack ranges and frames, stream
reassembly out of order and overlapping, GSO grouping, and the client's
first Initial datagram from a fixed connection id; the TCP transport's
lane bytes and frames as a raw socket reads them. Then port and JAX
agents gossip with each other over real loopback sockets: a pair
replicates a row both ways and a late joiner catches up by delta sync,
over plaintext QUIC, plaintext TCP and TCP with TLS. `setup` refuses
QUIC without plaintext and TLS without certificates as the JAX package
does, and `tls.py` imports without `cryptography`.

Every socket test runs under its own `asyncio.wait_for` of at most 60 s,
and every agent is shut down in a `finally`.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from corrosion_tpu.net import quic as jquic
from corrosion_tpu.net import seahash as jseahash
from corrosion_tpu.net import tcp as jtcp
from corrosion_tpu.pubsub.matcher import sql_hash as jsql_hash
from corrosion_tpu_torch import agent_checks as ac
from corrosion_tpu_torch import crdt_bench as cb
from corrosion_tpu_torch.net import quic as tquic
from corrosion_tpu_torch.net import seahash as tseahash
from corrosion_tpu_torch.net import tcp as ttcp
from corrosion_tpu_torch.pubsub.matcher import sql_hash as tsql_hash

from tests.test_torch_agent import jax_api

SOCKET_TIMEOUT_S = 60.0


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _blob(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, SOCKET_TIMEOUT_S))


# -- seahash -----------------------------------------------------------------


def test_seahash_crate_vectors_and_random_buffers_equal_jax():
    for mod in (jseahash, tseahash):
        assert mod.hash_bytes(b"to be or not to be") == 1988685042348123509
        assert (mod.hash_bytes(b"love is a wonderful terrible thing")
                == 4784284276849692846)
    rng = _rng(0)
    for n in list(range(0, 70)) + [255, 256, 1000, 4097]:
        data = _blob(rng, n)
        want = jseahash.hash_bytes(data)
        assert tseahash.hash_bytes(data) == want
        # streaming, in random pieces, equals buffered
        h = tseahash.SeaHasher()
        pos = 0
        while pos < n:
            cut = int(rng.integers(1, 40))
            h.write(data[pos:pos + cut])
            pos += cut
        assert h.finish() == want
        hdr = _blob(rng, int(rng.integers(1, 40)))
        assert tseahash.tag(hdr, data) == jseahash.tag(hdr, data)


def test_sql_hash_equals_jax():
    rng = _rng(1)
    sqls = ["SELECT id, name FROM users", "SELECT * FROM tests",
            ac.NET_QUERY, "SELECT 'é' FROM t WHERE x = ?"]
    sqls += [f"SELECT c{int(rng.integers(1 << 30))} FROM t{i}"
             for i in range(50)]
    for sql in sqls:
        assert tsql_hash(sql) == jsql_hash(sql)
        assert len(tsql_hash(sql)) == 16


# -- QUIC wire functions -----------------------------------------------------


def test_quic_varints_and_packet_numbers_equal_jax():
    rng = _rng(2)
    bounds = (1 << 6, 1 << 14, 1 << 30, 1 << 62)
    values = [0, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30,
              (1 << 62) - 1, 151288809941952652, 494878333, 15293, 37]
    values += [int(rng.integers(0, b)) for b in bounds for _ in range(50)]
    for v in values:
        enc = tquic.vint(v)
        assert enc == jquic.vint(v)
        buf = _blob(rng, 3) + enc + _blob(rng, 2)
        assert tquic.read_vint(buf, 3) == jquic.read_vint(buf, 3) == (
            v, 3 + len(enc))
    for _ in range(400):
        pn_len = int(rng.integers(1, 5))
        expected = int(rng.integers(0, 1 << 40))
        truncated = int(rng.integers(0, 1 << (8 * pn_len)))
        assert (tquic.decode_pn(truncated, pn_len, expected)
                == jquic.decode_pn(truncated, pn_len, expected))
    assert tquic.decode_pn(0x9B32, 2, 0xA82F30EA + 1) == 0xA82F9B32


def test_quic_transport_params_equal_jax():
    rng = _rng(3)
    for _ in range(50):
        params = {tquic.TP_ISCID: _blob(rng, tquic.CID_LEN)}
        for key in rng.choice(np.arange(1, 0x10), 5, replace=False):
            params[int(key)] = int(rng.integers(0, 1 << 40))
        enc = tquic.encode_transport_params(params)
        assert enc == jquic.encode_transport_params(params)
        assert (tquic.decode_transport_params(enc)
                == jquic.decode_transport_params(enc))


def test_quic_ack_ranges_and_frames_equal_jax():
    rng = _rng(4)
    for _ in range(40):
        t, j = tquic.PnRanges(), jquic.PnRanges()
        for pn in rng.integers(0, 300, int(rng.integers(1, 120))):
            assert t.add(int(pn)) == j.add(int(pn))
        assert t.ranges == j.ranges
        frame = t.ack_frame()
        assert frame == j.ack_frame()
        ftype, pos = tquic.read_vint(frame, 0)
        assert ftype == tquic.F_ACK
        got = tquic.parse_ack_frame(frame, pos, ecn=False)
        assert got == jquic.parse_ack_frame(frame, pos, ecn=False)
        assert sorted(got[0]) == [tuple(r) for r in t.ranges]


def test_quic_reassembler_out_of_order_and_overlap_equals_jax():
    rng = _rng(5)
    for _ in range(40):
        data = _blob(rng, int(rng.integers(1, 600)))
        pieces = []
        for _k in range(int(rng.integers(1, 40))):
            off = int(rng.integers(0, len(data)))
            ln = int(rng.integers(1, 80))
            pieces.append((off, data[off:off + ln]))
        # cover the whole stream, then shuffle with the overlaps
        pieces += [(k, data[k:k + 64]) for k in range(0, len(data), 64)]
        order = rng.permutation(len(pieces))
        t, j = tquic.Reassembler(), jquic.Reassembler()
        out = []
        for i in order:
            off, chunk = pieces[i]
            fin = off + len(chunk) == len(data)
            got = t.feed(off, chunk, fin=fin)
            assert got == j.feed(off, chunk, fin=fin)
            out.append(got)
        assert b"".join(out) == data
        assert t.finished == j.finished


def test_quic_ack_processing_equals_jax(monkeypatch):
    """`QuicConnection._on_ack` over the same sent packets (stream,
    crypto and control frames) and the same random ack ranges: the same
    packets stay in flight, the same streams count unacked and are
    collected, the same RTT estimate and RTT observations. The port
    looks acked packets up by range; the JAX module scans the map."""

    class Endpoint:
        mtu = tquic.MAX_UDP

        def __init__(self):
            self.rtts = []

        def _observe_rtt(self, addr, rtt):
            self.rtts.append((addr, rtt))

    def run(mod, seed):
        rng = _rng(seed)
        clock = [100.0]
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
        conn = mod.QuicConnection(Endpoint(), ("127.0.0.1", 9), True)
        sp = conn.spaces[2]
        for sid in range(8):
            conn.send_streams[sid] = mod.SendStream(sid, conn)
            conn.send_streams[sid].fin_sent = bool(rng.random() < 0.5)
        log = []
        for step in range(30):
            for _ in range(int(rng.integers(1, 60))):
                pn = sp.next_pn
                sp.next_pn += 1
                kind = int(rng.integers(0, 3))
                if kind == 0:
                    sid = int(rng.integers(0, 8))
                    fr = [("stream", sid, 0, b"x", False)]
                    conn._stream_unacked[sid] = (
                        conn._stream_unacked.get(sid, 0) + 1)
                elif kind == 1:
                    fr = [("crypto", 2, pn, b"c")]
                else:
                    fr = [("other", b"o")]
                sp.sent[pn] = mod._SentPacket(fr, clock[0], True, 100)
            clock[0] += 0.01
            ranges, hi = [], sp.next_pn - 1
            while hi >= 0 and len(ranges) < 8:
                lo = max(0, hi - int(rng.integers(0, 40)))
                ranges.append((lo, hi))
                hi = lo - 1 - int(rng.integers(1, 30))
            conn._on_ack(2, ranges)
            log.append((sorted(sp.sent), dict(conn._stream_unacked),
                        sorted(conn.send_streams), conn.srtt,
                        sp.largest_acked, conn.pto_count))
        return log, conn.endpoint.rtts

    for seed in range(3):
        assert run(tquic, seed) == run(jquic, seed)


def test_gso_groups_equal_jax():
    rng = _rng(6)
    for _ in range(200):
        n = int(rng.integers(0, 150))
        seg = int(rng.integers(200, 1400))
        lens = np.where(rng.random(n) < 0.8, seg,
                        rng.integers(1, 1500, n))
        grams = [bytes([k % 256]) * int(ln) for k, ln in enumerate(lens)]
        assert tquic.gso_groups(grams) == jquic.gso_groups(grams)


def test_client_initial_datagram_equals_jax(monkeypatch):
    """The client's first datagram to a silent address, with the
    connection ids drawn from one seeded stream in both packages."""

    async def first_datagram(mod):
        ep = await mod.QuicEndpoint.bind("127.0.0.1", 0)
        sent = []
        ep._sendto = lambda data, peer: sent.append(bytes(data))
        try:
            await asyncio.wait_for(ep.connect("127.0.0.1:1"), 0.3)
        except Exception:
            pass  # no server: the connect times out
        await ep.close()
        return sent[0]

    pkts = []
    for mod in (jquic, tquic):
        rng = _rng(7)
        monkeypatch.setattr(os, "urandom",
                            lambda n, rng=rng: _blob(rng, n))
        pkts.append(_run(first_datagram(mod)))
    assert pkts[0] == pkts[1]
    assert len(pkts[1]) >= tquic.MIN_INITIAL


# -- TCP frames --------------------------------------------------------------


async def _tcp_wire(mod) -> bytes:
    """What a raw TCP server reads from `mod`'s transport: two uni frames
    on one cached connection and a bi session's frames."""
    got = []
    done = asyncio.Event()

    async def on_conn(reader, writer):
        got.append(await reader.read())
        writer.close()
        if len(got) == 2:
            done.set()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    addr = "127.0.0.1:%d" % server.sockets[0].getsockname()[1]
    listener = await mod.TcpListener.bind()
    t = mod.TcpTransport(listener)
    try:
        await t.send_uni(addr, b"frame-1")
        await t.send_uni(addr, b"frame-2" * 100)
        bi = await t.open_bi(addr)
        await bi.send(b"sync-start")
        await bi.send(b"")
        await bi.finish()
        await t.close()  # ends the cached uni connection
        await asyncio.wait_for(done.wait(), 10)
    finally:
        await listener.close()
        server.close()
    return b"|".join(sorted(got))


def test_tcp_frames_equal_jax():
    j = _run(_tcp_wire(jtcp))
    t = _run(_tcp_wire(ttcp))
    assert t == j
    assert b"U\x00\x00\x00\x07frame-1" in t and b"B\x00\x00\x00\x0async" in t
    assert ttcp.split_addr("[::1]:8080") == jtcp.split_addr("[::1]:8080")


# -- agents of both packages over sockets ------------------------------------


async def _mixed(apis, db_dir: str, transport: str, tune=None) -> dict:
    """A (apis[0]) and B (apis[1]) replicate a row each way; then a late
    joiner C (apis[1]) catches up on both rows by delta sync."""
    addrs = [ac.loopback_addr(transport) for _ in range(3)]
    agents = []

    async def start(i, api, bootstrap):
        agents.append(await ac.boot(api, None, addrs[i], db_dir, bootstrap,
                                    tune=tune, transport=transport))
        return agents[-1]

    try:
        a = await start(0, apis[0], [])
        b = await start(1, apis[1], [addrs[0]])
        await ac._sizes([a, b], 2, 20.0)
        await ac.insert(apis[0], a, 1, "from-a")
        ab = await ac.wait_until(lambda: ac.count_rows(b) == 1)
        await ac.insert(apis[1], b, 2, "from-b")
        ba = await ac.wait_until(lambda: ac.count_rows(a) == 2)
        c = await start(2, apis[1], addrs[:2])
        late = await ac.wait_until(lambda: ac.count_rows(c) == 2,
                                   timeout=20.0)
        return {"a_to_b": ab, "b_to_a": ba, "late_joiner": late,
                "rows": [ac.rows(ag) for ag in agents],
                "addrs": [ag.actor.addr for ag in agents] == addrs}
    finally:
        await asyncio.gather(*(api.shutdown(ag) for api, ag in
                               zip((apis[0], apis[1], apis[1]), agents)))


def _pair(first: str):
    port, jax = ac.port_api("cpu"), jax_api()
    return (jax, port) if first == "jax" else (port, jax)


@pytest.mark.parametrize("transport", ["quic", "tcp"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_mixed_agents_replicate_and_late_join(tmp_path, transport, first):
    with cb.engine_env("array"):
        rec = _run(_mixed(_pair(first), str(tmp_path), transport))
    assert rec["a_to_b"] and rec["b_to_a"] and rec["late_joiner"]
    assert rec["addrs"]
    assert rec["rows"] == [[(1, "from-a"), (2, "from-b")]] * 3


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    pytest.importorskip("cryptography")
    from corrosion_tpu_torch import tls

    d = tmp_path_factory.mktemp("certs")
    tls.generate_ca(str(d / "ca.pem"), str(d / "ca.key"))
    tls.generate_server_cert(str(d / "ca.pem"), str(d / "ca.key"),
                             "127.0.0.1", str(d / "server.pem"),
                             str(d / "server.key"))
    tls.generate_client_cert(str(d / "ca.pem"), str(d / "ca.key"),
                             str(d / "client.pem"), str(d / "client.key"))
    return d


def _tls_tune(certs, mtls: bool):
    def tune(cfg):
        cfg.gossip.plaintext = False
        cfg.gossip.tls.cert_file = str(certs / "server.pem")
        cfg.gossip.tls.key_file = str(certs / "server.key")
        cfg.gossip.tls.ca_file = str(certs / "ca.pem")
        cfg.gossip.tls.mtls = mtls
        cfg.gossip.tls.client_cert_file = str(certs / "client.pem")
        cfg.gossip.tls.client_key_file = str(certs / "client.key")
    return tune


@pytest.mark.parametrize("first,mtls", [("jax", True), ("port", False)])
def test_mixed_agents_replicate_over_tls(tmp_path, certs, first, mtls):
    """The port's certificates, loaded by both packages' TLS contexts."""
    with cb.engine_env("array"):
        rec = _run(_mixed(_pair(first), str(tmp_path), "tcp",
                          tune=_tls_tune(certs, mtls)))
    assert rec["a_to_b"] and rec["b_to_a"] and rec["late_joiner"]
    assert rec["rows"] == [[(1, "from-a"), (2, "from-b")]] * 3


def _refusal(api, db_dir: Path, tune):
    db_dir.mkdir()
    cfg = ac.fast_config(api, ac.loopback_addr("tcp"), str(db_dir),
                         transport="tcp")
    tune(cfg)

    async def main():
        try:
            agent = await api.setup(cfg, network=None)
        except Exception as e:  # noqa: BLE001 - the refusal under test
            return type(e).__name__, str(e)
        await api.shutdown(agent)
        return None

    return _run(main())


def _quic_without_plaintext(cfg):
    cfg.gossip.transport = "quic"
    cfg.gossip.plaintext = False


def _tls_without_certs(cfg):
    cfg.gossip.plaintext = False


@pytest.mark.parametrize("tune", [_quic_without_plaintext,
                                  _tls_without_certs])
def test_setup_refuses_as_jax_does(tmp_path, tune):
    got = [_refusal(api, tmp_path / api.name, tune)
           for api in (jax_api(), ac.port_api("cpu"))]
    assert got[0] is not None and got[0][0] == "ValueError"
    assert got[1] == got[0]


def test_tls_module_imports_without_cryptography(tmp_path):
    """`tls.py` and `build_ssl_contexts` work on a host without the
    `cryptography` package; generating a certificate raises there."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "sys.modules['cryptography'] = None\n"
        "from corrosion_tpu_torch import tls\n"
        "from corrosion_tpu_torch.agent import run\n"
        "from corrosion_tpu_torch.runtime.config import GossipTlsConfig\n"
        "try:\n"
        "    tls.build_ssl_contexts(GossipTlsConfig())\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "try:\n"
        f"    tls.generate_ca({str(tmp_path / 'ca.pem')!r}, 'k')\n"
        "except ImportError:\n"
        "    print('no cryptography')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "refused: gossip TLS requires cert_file and key_file",
        "no cryptography"]


async def _bound(api, db_dir: Path, tune) -> tuple:
    """What `setup` bound for the config `tune` makes: the transport's
    kind, its dial sockets (count, inbound, pinned address), the
    listener's MTU and the idle timeout, and the actor's address."""
    db_dir.mkdir(exist_ok=True)
    cfg = ac.fast_config(api, "127.0.0.1:0", str(db_dir), transport="quic")
    tune(cfg)
    agent = await api.setup(cfg, network=None)
    try:
        t = agent.transport
        eps = getattr(t, "_client_eps", [])
        return (type(t).__name__, len(eps),
                sorted({ep.accept_inbound for ep in eps}),
                [ep.addr for ep in eps] if len(eps) == 1 else None,
                getattr(agent.listener, "mtu", None),
                getattr(t, "idle_timeout", getattr(t, "_idle_timeout", None)),
                agent.actor.addr == agent.listener.addr)
    finally:
        await api.shutdown(agent)


def test_setup_binds_the_gossip_knobs_as_jax_does(tmp_path):
    """8 dial-only QUIC sockets by default, one at a pinned client port,
    `gossip.max_mtu`, `idle_timeout_secs` and `external_addr`; a pinned
    client port already in use fails the setup and releases the gossip
    port, which a second setup then binds."""
    pinned = ac.free_port(dgram=True)

    def spread(cfg):
        cfg.db.path = cfg.db.path.replace(".db", "-spread.db")

    def pin(cfg):
        cfg.db.path = cfg.db.path.replace(".db", "-pin.db")
        cfg.gossip.client_addr = f"127.0.0.1:{pinned}"
        cfg.gossip.max_mtu = 1300
        cfg.gossip.idle_timeout_secs = 7

    def tcp(cfg):
        cfg.db.path = cfg.db.path.replace(".db", "-tcp.db")
        cfg.gossip.transport = "tcp"
        cfg.gossip.idle_timeout_secs = 9
        cfg.gossip.external_addr = "10.0.0.1:1"

    async def busy_pin(api, db_dir: Path):
        db_dir.mkdir(exist_ok=True)
        gossip = ac.loopback_addr("quic")
        import socket

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind(("127.0.0.1", 0))
            cfg = ac.fast_config(api, gossip, str(db_dir), transport="quic")
            cfg.db.path = cfg.db.path.replace(".db", "-busy.db")
            cfg.gossip.client_addr = "127.0.0.1:%d" % s.getsockname()[1]
            try:
                await api.setup(cfg, network=None)
                refused = None
            except OSError as e:
                refused = type(e).__name__
        cfg.gossip.client_addr = None
        agent = await api.setup(cfg, network=None)
        rebound = agent.listener.addr == gossip
        await api.shutdown(agent)
        return refused, rebound

    got = {}
    for api in (jax_api(), ac.port_api("cpu")):
        d = tmp_path / api.name
        got[api.name] = [_run(_bound(api, d, tune))
                         for tune in (spread, pin, tcp)]
        got[api.name].append(_run(busy_pin(api, d)))
    assert got["port"] == got["jax"]
    spread_rec, pin_rec, tcp_rec, busy = got["port"]
    assert spread_rec[:3] == ("QuicTransport", 8, [False])
    assert pin_rec[1:6] == (1, [False], [f"127.0.0.1:{pinned}"], 1300, 7.0)
    assert tcp_rec[0] == "TcpTransport" and tcp_rec[5:] == (9.0, False)
    assert busy == ("OSError", True)


def test_quic_send_window_bounds_packets_in_flight(monkeypatch):
    """A 1 MiB bi-stream transfer between port endpoints: the sender
    fills its window of `SEND_WINDOW` ack-eliciting 1-RTT packets and
    never passes it (its only eliciting packets carry stream data), and
    the bytes arrive whole."""
    peak = [0]
    build = tquic.QuicConnection._build_packet

    def spy(self, space, frames, **kw):
        pkt = build(self, space, frames, **kw)
        if space == 2 and self.is_client:
            peak[0] = max(peak[0], self._app_in_flight)
        return pkt

    monkeypatch.setattr(tquic.QuicConnection, "_build_packet", spy)

    async def main():
        blob = _blob(_rng(8), 1 << 20)
        got = []

        async def on_bi(stream):
            while (frame := await stream.recv()) is not None:
                got.append(frame)
            await stream.send(b"ok")
            await stream.finish()

        async def nope(*_args):
            pass

        server = await tquic.QuicEndpoint.bind("127.0.0.1", 0)
        server.serve(nope, nope, on_bi)
        client = await tquic.QuicEndpoint.bind("127.0.0.1", 0)
        t = tquic.QuicTransport(client)
        try:
            bi = await t.open_bi(server.addr)
            await bi.send(blob)
            await bi.finish()
            ack = await asyncio.wait_for(bi.recv(), 30)
        finally:
            await t.close()
            await client.close()
            await server.close()
        return ack, b"".join(got) == blob

    assert _run(main()) == (b"ok", True)
    assert peak[0] == tquic.SEND_WINDOW
