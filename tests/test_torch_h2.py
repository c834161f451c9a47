"""The port's HTTP/2 transport (`net/hpack.py`, `net/h2.py`) against the
JAX package's on the CPU.

HPACK: both codecs of each package encode the same seeded header lists
to the same bytes and decode them back (the nghttp2 binding with its
Huffman literals and dynamic table, the pure-Python codec with
hand-built incremental-indexing blocks, table-size updates and
eviction). h2: frames are byte-equal, a client's request and a server's
response are the same bytes on the wire, flow control, RST_STREAM and
GOAWAY behave as in `tests/test_h2.py`, and each package's client talks
to the other's server. Every socket await is bounded.
"""

import asyncio
import json
import struct

import numpy as np
import pytest

from corrosion_tpu.net import h2 as jh2
from corrosion_tpu.net import hpack as jhp
from corrosion_tpu_torch.net import h2 as th2
from corrosion_tpu_torch.net import hpack as thp

IO_S = 10.0
PKGS = {"jax": (jh2, jhp), "port": (th2, thp)}


def _headers(rng, n: int, pool: list) -> list:
    """`n` header fields: static-table hits, repeats from `pool` (dynamic
    table hits) and new random literals (which nghttp2 Huffman-codes)."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.2:
            out.append((b":method", b"POST" if rng.random() < 0.5 else b"GET"))
        elif r < 0.5 and pool:
            out.append(pool[int(rng.integers(len(pool)))])
        else:
            name = b"x-" + bytes(rng.integers(97, 123, int(rng.integers(1, 12)))
                                 .astype(np.uint8))
            value = bytes(rng.integers(32, 127, int(rng.integers(0, 300)))
                          .astype(np.uint8))
            out.append((name, value))
            pool.append((name, value))
    return out


@pytest.mark.parametrize("table_size", [4096, 256])
def test_nghttp2_codec_bytes_equal_jax(table_size):
    assert thp.nghttp2_available() and jhp.nghttp2_available()
    rng = np.random.default_rng(table_size)
    jd, td = jhp.NgDeflater(table_size), thp.NgDeflater(table_size)
    ji, ti = jhp.NgInflater(), thp.NgInflater()
    pool, huffman = [], 0
    for _ in range(40):
        hs = _headers(rng, int(rng.integers(1, 12)), pool)
        block = td.encode(hs)
        assert block == jd.encode(hs)
        assert ti.decode(block) == hs
        assert ji.decode(block) == hs
        # a Huffman-coded literal: the pure-Python inflaters refuse it,
        # with the same error in both packages
        try:
            jhp.PyInflater().decode(block)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                thp.PyInflater().decode(block)
            huffman += "huffman" in str(e)
    assert huffman > 0


def test_python_deflater_bytes_equal_jax():
    rng = np.random.default_rng(7)
    jd, td = jhp.PyDeflater(), thp.PyDeflater()
    pool = []
    for _ in range(30):
        hs = _headers(rng, int(rng.integers(1, 10)), pool)
        block = td.encode(hs)
        assert block == jd.encode(hs)
        for inflater in (thp.PyInflater(), jhp.PyInflater(),
                         thp.NgInflater(), jhp.NgInflater()):
            assert inflater.decode(block) == hs


def _lit(prefix: int, bits: int, name, value: bytes) -> bytes:
    """A literal field without Huffman: `name` an index or new bytes."""
    if isinstance(name, int):
        out = thp._int_encode(name, bits, prefix)
    else:
        out = bytes([prefix]) + thp._int_encode(len(name), 7, 0) + name
    return out + thp._int_encode(len(value), 7, 0) + value


def test_python_inflater_dynamic_table_and_eviction_equal_jax():
    """Incremental-indexing literals fill the dynamic table, references
    into it decode, a table-size update evicts, and a 128-byte table
    evicts on insert; both packages' tables stay equal entry by entry,
    and libnghttp2 decodes the same blocks alike."""
    rng = np.random.default_rng(11)
    blocks = []
    for k in range(12):
        value = bytes(rng.integers(97, 123, 20 + 7 * k).astype(np.uint8))
        block = _lit(0x40, 6, b"x-k%d" % k, value)
        block += _lit(0x40, 6, 4, b"/p/%d" % k)  # indexed name (:path)
        block += thp._int_encode(62, 7, 0x80)  # newest dynamic entry
        block += _lit(0x00, 4, 2, b"PUT")  # without indexing
        block += _lit(0x10, 4, b"x-never", b"secret")  # never indexed
        if k == 8:
            block = thp._int_encode(128, 5, 0x20) + block
        blocks.append(block)
    jin, tin = jhp.PyInflater(), thp.PyInflater()
    jng, tng = jhp.NgInflater(), thp.NgInflater()
    evicted = False
    for block in blocks:
        got = tin.decode(block)
        assert got == jin.decode(block) == tng.decode(block) == jng.decode(
            block)
        assert tin._dynamic == jin._dynamic
        assert (tin._size, tin._max_size) == (jin._size, jin._max_size)
        evicted |= len(tin._dynamic) < 2 * (blocks.index(block) + 1)
    assert evicted and tin._max_size == 128
    with pytest.raises(ValueError, match="out of range"):
        tin.decode(thp._int_encode(62 + len(tin._dynamic), 7, 0x80))


def test_codec_choice_and_integers_equal_jax():
    assert type(thp.make_deflater()).__name__ == type(
        jhp.make_deflater()).__name__ == "NgDeflater"
    assert type(thp.make_inflater()).__name__ == type(
        jhp.make_inflater()).__name__ == "NgInflater"
    assert thp._STATIC == jhp._STATIC
    for value in (0, 1, 30, 31, 32, 126, 127, 128, 255, 16383, 2**20):
        for bits in (4, 5, 6, 7):
            enc = thp._int_encode(value, bits, 0)
            assert enc == jhp._int_encode(value, bits, 0)
            assert thp._int_decode(enc, 0, bits) == (value, len(enc))


# -- h2 frames and wire bytes -------------------------------------------------


def test_frames_byte_equal_jax():
    rng = np.random.default_rng(3)
    names = ("DATA", "HEADERS", "PRIORITY", "RST_STREAM", "SETTINGS", "PING",
             "GOAWAY", "WINDOW_UPDATE", "CONTINUATION")
    for name in names:
        assert getattr(th2, name) == getattr(jh2, name)
        for _ in range(5):
            payload = bytes(rng.integers(0, 256, int(rng.integers(0, 600)))
                            .astype(np.uint8))
            flags = int(rng.integers(0, 256))
            sid = int(rng.integers(0, 2**31))
            frame = th2._frame(getattr(th2, name), flags, sid, payload)
            assert frame == jh2._frame(getattr(jh2, name), flags, sid,
                                       payload)
    for const in ("PREFACE", "DEFAULT_WINDOW", "MAX_FRAME_SIZE_DEFAULT",
                  "NO_ERROR", "PROTOCOL_ERROR", "CANCEL"):
        assert getattr(th2, const) == getattr(jh2, const)


async def _record_server(n_bytes: int, port: int):
    """A raw TCP listener on `port` that records what one connection
    sends."""
    got = bytearray()
    done = asyncio.Event()

    async def on_conn(reader, writer):
        while len(got) < n_bytes:
            chunk = await reader.read(65536)
            if not chunk:
                break
            got.extend(chunk)
        done.set()
        writer.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", port)
    return server, got, done


def _client_bytes(pkg: str, body: bytes, n_bytes: int, port: int) -> bytes:
    """What a client of `pkg` sends for one request to 127.0.0.1:`port`
    (one port for every run: `:authority` carries it)."""
    h2 = PKGS[pkg][0]

    async def main():
        server, got, done = await _record_server(n_bytes, port)
        client = h2.H2Client("127.0.0.1", port,
                             conn_recv_window=1 << 20)
        req = asyncio.ensure_future(client.request(
            "POST", "/v1/transactions",
            headers={"content-type": "application/json",
                     "authorization": "Bearer t"}, body=body))
        await asyncio.wait_for(done.wait(), IO_S)
        req.cancel()
        await client.close()
        server.close()
        await server.wait_closed()
        return bytes(got)

    return asyncio.run(asyncio.wait_for(main(), 2 * IO_S))


def test_client_request_bytes_equal_jax():
    """Preface, SETTINGS, the connection WINDOW_UPDATE, HEADERS (HPACK)
    and a DATA frame: the same bytes from both clients."""
    from corrosion_tpu_torch.agent_checks import free_port

    port = free_port()
    body = json.dumps([["INSERT INTO t VALUES (?)", [1]]]).encode()
    size = len(jh2.PREFACE) + 9 + 12 + 9 + 4  # up to the WINDOW_UPDATE
    first = _client_bytes("jax", body, size + 1, port)
    # the rest: headers + data frames, whatever their HPACK length
    hdr_len = int.from_bytes(first[size:size + 3], "big") if len(
        first) > size + 3 else 0
    total = size + 9 + hdr_len + 9 + len(body)
    want = _client_bytes("jax", body, total, port)
    got = _client_bytes("port", body, total, port)
    assert len(want) == total
    assert got == want


def _server_bytes(pkg: str) -> bytes:
    """What a server of `pkg` sends for one scripted h2 request."""
    h2, hp = PKGS[pkg]

    async def handler(req):
        body = await req.read_body()
        await req.respond(200, b"echo:" + body, {"x-len": str(len(body))})

    async def main():
        srv = h2.H2Server(handler)
        await srv.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        block = jhp.PyDeflater().encode([
            (b":method", b"POST"), (b":scheme", b"http"),
            (b":authority", b"h"), (b":path", b"/echo")])
        writer.write(jh2.PREFACE
                     + jh2._frame(jh2.SETTINGS, 0, 0, b"")
                     + jh2._frame(jh2.HEADERS, jh2.FLAG_END_HEADERS, 1, block)
                     + jh2._frame(jh2.DATA, jh2.FLAG_END_STREAM, 1,
                                  b"x" * 300))
        await writer.drain()
        got = bytearray()
        # read until the response's END_STREAM DATA frame has arrived
        while b"echo:" + b"x" * 300 not in got:
            chunk = await asyncio.wait_for(reader.read(65536), IO_S)
            if not chunk:
                break
            got.extend(chunk)
        writer.close()
        await srv.stop()
        return bytes(got)

    return asyncio.run(asyncio.wait_for(main(), 2 * IO_S))


def _frames(raw: bytes) -> list:
    out, pos = [], 0
    while pos + 9 <= len(raw):
        n = int.from_bytes(raw[pos:pos + 3], "big")
        out.append((raw[pos + 3], raw[pos + 4],
                    struct.unpack(">I", raw[pos + 5:pos + 9])[0],
                    raw[pos + 9:pos + 9 + n]))
        pos += 9 + n
    return out


def test_server_response_bytes_equal_jax():
    """SETTINGS, the SETTINGS ACK, the WINDOW_UPDATE credits, HEADERS and
    the DATA frame of a response: the same frames from both servers."""
    want = _frames(_server_bytes("jax"))
    got = _frames(_server_bytes("port"))
    assert [f[0] for f in want].count(jh2.HEADERS) == 1
    assert sorted(got) == sorted(want)
    # a response's frames keep their order: HEADERS before its DATA
    assert [f for f in got if f[2] == 1] == [f for f in want if f[2] == 1]


# -- behaviour over sockets, and each package against the other -----------------

BIG = bytes(range(256)) * 1024  # 256 KiB: past both 64 KiB windows


def _handler(h2):
    async def handler(req):
        if req.path.startswith("/echo"):
            body = await req.read_body()
            await req.respond(200, b"echo:" + body, {"x-method": req.method})
        elif req.path == "/big":
            await req.send_headers(200)
            await req.send_data(b"z" * (h2.DEFAULT_WINDOW * 2 + 123),
                                end_stream=True)
        elif req.path == "/stream":
            await req.send_headers(200)
            for i in range(10):
                await req.send_data(json.dumps({"n": i}).encode() + b"\n")
            await req.send_data(b"", end_stream=True)
        elif req.path == "/forever":
            await req.send_headers(200)
            while True:
                await req.send_data(b"tick\n")
                await asyncio.sleep(0.01)
        else:
            await req.respond(404, b"nope")
    return handler


async def _exchange(server_pkg: str, client_pkg: str) -> dict:
    sh2, ch2 = PKGS[server_pkg][0], PKGS[client_pkg][0]
    srv = sh2.H2Server(_handler(sh2))
    await srv.start()
    client = ch2.H2Client("127.0.0.1", srv.port)
    out = {}
    try:
        resp = await asyncio.wait_for(
            client.request("POST", "/echo", body=BIG), IO_S)
        out["echo"] = (resp.status, resp.headers.get("x-method"),
                       await asyncio.wait_for(resp.read(), IO_S) == (
                           b"echo:" + BIG))
        resp = await asyncio.wait_for(client.request("GET", "/big"), IO_S)
        body = await asyncio.wait_for(resp.read(), IO_S)
        out["big"] = (len(body), set(body))
        resp = await asyncio.wait_for(client.request("GET", "/stream"), IO_S)
        out["stream"] = (await asyncio.wait_for(resp.read(), IO_S)).count(
            b"\n")
        resp = await asyncio.wait_for(client.request("GET", "/none"), IO_S)
        out["404"] = resp.status
        # RST_STREAM: abandoning an endless stream ends it on both sides
        resp = await asyncio.wait_for(client.request("GET", "/forever"), IO_S)
        it = resp.body()
        first = await asyncio.wait_for(it.__anext__(), IO_S)
        await resp.aclose()
        rest = [c async for c in it]
        for _ in range(100):
            if not any(s for c in [*srv._conns] for s in c.streams):
                break
            await asyncio.sleep(0.02)
        out["rst"] = (first.startswith(b"tick"), rest == [],
                      any(s for c in [*srv._conns] for s in c.streams))
        conn = await client._ensure()
        out["ping"] = await conn.ping(2.0)
    finally:
        await asyncio.wait_for(client.close(), IO_S)
        await asyncio.wait_for(srv.stop(), IO_S)
    return out


EXPECTED = {"echo": (200, "POST", True),
            "big": (jh2.DEFAULT_WINDOW * 2 + 123, {ord("z")}),
            "stream": 10, "404": 404, "rst": (True, True, False),
            "ping": True}


@pytest.mark.parametrize("server,client", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_flow_control_rst_and_ping_across_packages(server, client):
    got = asyncio.run(asyncio.wait_for(_exchange(server, client), 4 * IO_S))
    assert got == EXPECTED


def test_goaway_on_stop_with_a_live_stream():
    """A port server stopped while a client holds an endless stream open
    sends GOAWAY and returns within its grace (the JAX module's stop
    waits for the connection first: Python 3.12.1's `wait_closed`); the
    client's stream then ends with the typed `StreamReset`, and a new
    request fails."""

    async def main():
        srv = th2.H2Server(_handler(th2))
        await srv.start()
        client = th2.H2Client("127.0.0.1", srv.port)
        resp = await asyncio.wait_for(client.request("GET", "/forever"), IO_S)
        it = resp.body()
        await asyncio.wait_for(it.__anext__(), IO_S)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await asyncio.wait_for(srv.stop(), 3 * th2.STOP_GRACE)
        stop_s = loop.time() - t0
        with pytest.raises(th2.StreamReset):
            async for _chunk in it:
                pass
        with pytest.raises((th2.StreamReset, ConnectionError, OSError)):
            await asyncio.wait_for(client.request("GET", "/echo"), IO_S)
        await asyncio.wait_for(client.close(), IO_S)
        return stop_s

    assert asyncio.run(asyncio.wait_for(main(), 4 * IO_S)) < th2.STOP_GRACE
