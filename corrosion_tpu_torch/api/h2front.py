"""Dual-protocol API front-end: HTTP/2 + HTTP/1.1 on one port.

The port's copy of `corrosion_tpu/api/h2front.py`, with two differences:

- shutdown: `ApiFrontend.stop` closes its connections (h2 GOAWAY, h1
  pumps cancelled) before it waits, bounded, for its listener. The JAX
  module waits first, and since Python 3.12.1 `Server.wait_closed` waits
  for every accepted connection, so its stop never returned while a
  client held a stream open;
- h2 is always served natively against the aiohttp app (`app` is
  required). The JAX module's other mode, each h2 stream forwarded as an
  h1 request to the internal listener, has no caller and is not ported.

The reference API port speaks both protocols — hyper's auto-mode server
sniffs the 24-byte h2c client preface and its client is HTTP/2-only
(`klukai-client/src/lib.rs:33-47`).  This front-end reproduces that on
asyncio:

- each accepted connection is sniffed byte-by-byte against the preface:
  the instant the buffer diverges it is an HTTP/1.1 connection and the
  bytes are replayed into a raw TCP proxy to the internal aiohttp
  listener; a full preface match terminates HTTP/2 here
  (`net/h2.py`) and serves each multiplexed stream against the same
  aiohttp application (`NativeH2Dispatcher`);
- both paths keep the whole aiohttp route surface (authz, limits,
  metrics, NDJSON streaming) with no duplicated handler logic — response
  bodies stream frame-by-frame, so one h2 connection can carry live
  subscriptions next to queries, like the reference's multiplexed h2.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import List, Optional

from corrosion_tpu_torch.net.h2 import (
    CANCEL,
    PREFACE,
    STOP_GRACE,
    H2Request,
    H2Server,
    StreamReset,
)

log = logging.getLogger(__name__)

# hop-by-hop headers that must not cross the h1→h2 boundary (RFC 9113 §8.2.2)
_HOP_BY_HOP = {
    "connection", "keep-alive", "proxy-connection", "transfer-encoding",
    "upgrade", "te",
}


class _H2PayloadWriter:
    """aiohttp AbstractStreamWriter that emits h2 frames.

    aiohttp response objects (`Response`, `StreamResponse`) write their
    status line, headers and body through the request's payload writer;
    pointing that writer at an `H2Request` serves the whole aiohttp
    handler surface natively over HTTP/2 — no loopback hop, no h1
    re-parse (r4 weak #7: the hop cost h2 ~45% of h1 throughput)."""

    def __init__(self, req: H2Request) -> None:
        self._req = req
        self.transport = None
        self.output_size = 0
        self.buffer_size = 0
        self.length = None

    async def write_headers(self, status_line: str, headers) -> None:
        # "HTTP/1.1 200 OK" -> 200; header keys lowered for h2
        status = int(status_line.split(" ", 2)[1])
        out = {
            k.lower(): v for k, v in headers.items()
            if k.lower() not in _HOP_BY_HOP
        }
        await self._req.send_headers(status, out)

    async def write(self, chunk, *, drain: bool = True, LIMIT=0x10000) -> None:
        chunk = bytes(chunk)
        if chunk:
            self.output_size += len(chunk)
            await self._req.send_data(chunk)

    async def write_eof(self, chunk: bytes = b"") -> None:
        # one frame: the last body chunk carries END_STREAM itself
        # (plain json responses become a single DATA frame)
        chunk = bytes(chunk)
        self.output_size += len(chunk)
        await self._req.send_data(chunk, end_stream=True)

    async def drain(self) -> None:
        pass

    def enable_compression(self, encoding: str = "deflate") -> None:
        pass  # h2 responses go uncompressed; clients didn't negotiate

    def enable_chunking(self) -> None:
        pass  # h2 has its own framing; chunked transfer-encoding is h1

    def send_headers(self, *a, **kw) -> None:
        # aiohttp's Response.write_eof calls this SYNCHRONOUSLY as a
        # flush hook; headers were already written via write_headers
        pass


class _TransportStub:
    """Transport stand-in for `_ProtocolStub.transport`: aiohttp ≥ 3.9
    web.Request reads `protocol.transport.get_extra_info("sslcontext"/
    "peername")` AT CONSTRUCTION (older versions read `ssl_context`/
    `peername` off the protocol itself and tolerated transport=None —
    with 3.11 installed, transport=None made every native-h2 dispatch
    die on `assert transport is not None` before the handler ran: the
    HTTP-500 /v1/* cascade)."""

    def get_extra_info(self, name, default=None):
        return default

    def is_closing(self) -> bool:
        return False


class _ProtocolStub:
    """Minimal stand-in for aiohttp's RequestHandler protocol: just what
    web.Request and StreamReader touch on the serving path (a shared
    instance — per-request unittest.mock objects cost ~0.7 ms each,
    half the request budget at SELECT-1 sizes)."""

    _reading_paused = False
    transport = _TransportStub()
    writer = None
    ssl_context = None  # pre-3.9 aiohttp read these two at construction
    peername = None

    def is_connected(self) -> bool:
        return True

    # StreamReader flow-control hooks
    def pause_reading(self) -> None:
        pass

    def resume_reading(self) -> None:
        pass


_PROTOCOL_STUB = _ProtocolStub()


class NativeH2Dispatcher:
    """Serve h2 streams directly against an aiohttp Application: resolve
    the route, run the middleware chain, and stream the response out as
    h2 frames via `_H2PayloadWriter`."""

    def __init__(self, app) -> None:
        self._app = app

    def _build_request(self, req: H2Request, payload, writer):
        """A real web.Request over the h2 stream — the hand-rolled core
        of aiohttp.test_utils.make_mocked_request without its per-call
        Mock graph."""
        import asyncio as _asyncio

        from aiohttp import web
        from aiohttp.http_parser import RawRequestMessage
        from aiohttp.http_writer import HttpVersion
        from multidict import CIMultiDict, CIMultiDictProxy
        from yarl import URL

        # H2Request.headers already excludes pseudo-headers; the client's
        # authority pseudo-header becomes Host (RFC 9113 §8.3.1)
        hdrs = CIMultiDict(req.headers)
        if "host" not in hdrs:
            hdrs["host"] = req.authority or "h2"
        raw = tuple(
            (k.encode(), v.encode()) for k, v in hdrs.items()
        )
        # positional: the C-accelerated RawRequestMessage has no kwargs
        # (method, path, version, headers, raw_headers, should_close,
        #  compression, upgrade, chunked, url)
        message = RawRequestMessage(
            req.method, req.path, HttpVersion(1, 1),
            CIMultiDictProxy(hdrs), raw,
            False, None, False, False, URL(req.path),
        )
        return web.Request(
            message, payload, _PROTOCOL_STUB, writer,
            _asyncio.current_task(), _asyncio.get_event_loop(),
            # same body-size limit as the h1 side of this API (the
            # app's default): limits must not diverge by protocol
            client_max_size=self._app._client_max_size,
        )

    async def handle(self, req: H2Request) -> None:
        from aiohttp import streams, web

        body = await req.read_body()
        payload = streams.StreamReader(_PROTOCOL_STUB, limit=2**20)
        if body:
            payload.feed_data(body)
        payload.feed_eof()
        writer = _H2PayloadWriter(req)
        request = self._build_request(req, payload, writer)
        try:
            # the app's own dispatch (resolve + match_info freeze +
            # middleware chain + on_response_prepare signals) — the app
            # is frozen by runner.setup() before any frontend starts
            try:
                resp = await self._app._handle(request)
            except web.HTTPException as e:
                resp = e
            if resp is not None:
                if not resp.prepared:
                    await resp.prepare(request)
                await resp.write_eof()
        except (ConnectionError, StreamReset, asyncio.CancelledError):
            # StreamReset = client cancel/disconnect mid-response:
            # routine teardown, silenced by H2Server._run_stream
            raise
        except Exception:  # noqa: BLE001 — handler crash = 500 or RST
            log.exception("native h2 dispatch %s %s", req.method, req.path)
            if not req._sent_headers:
                await req.respond(500, b"internal error")
            else:
                await req._conn.send_rst(req._stream.sid, CANCEL)
                req._stream.fail(CANCEL)


class ApiFrontend:
    """One public listener: HTTP/2 served natively against the aiohttp
    app, HTTP/1.1 bytes passed through to the internal listener
    (aiohttp's own parser/server)."""

    def __init__(self, upstream_host: str, upstream_port: int, app,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream_host = upstream_host
        self.upstream_port = upstream_port
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._h2 = H2Server(NativeH2Dispatcher(app).handle)
        self._proxy_tasks: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def addrs(self) -> List[str]:
        if self._server is None:
            return []
        return [
            f"{s.getsockname()[0]}:{s.getsockname()[1]}"
            for s in self._server.sockets
        ]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        await self._h2.stop()  # GOAWAY and close every h2 connection
        for t in list(self._proxy_tasks):
            t.cancel()  # the pumps close both sides of each h1 connection
        if self._server is not None:
            # bounded: a connection still sniffing its preface ends on its
            # own read timeout
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._server.wait_closed(), STOP_GRACE)

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            buf = b""
            while len(buf) < len(PREFACE) and PREFACE.startswith(buf):
                chunk = await asyncio.wait_for(
                    reader.read(len(PREFACE) - len(buf)), 30.0
                )
                if not chunk:
                    writer.close()
                    return
                buf += chunk
        except (asyncio.TimeoutError, ConnectionError, OSError):
            writer.close()
            return
        if buf == PREFACE:
            await self._h2.handle_connection(reader, writer, preface_consumed=True)
        else:
            await self._proxy_h1(buf, reader, writer)

    # -- h1 pass-through ---------------------------------------------------

    async def _proxy_h1(
        self, head: bytes,
        reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
    ) -> None:
        """Raw byte pump: the sniffed prefix is replayed, then both
        directions stream until either side closes."""
        try:
            up_r, up_w = await asyncio.open_connection(
                self.upstream_host, self.upstream_port
            )
        except (ConnectionError, OSError):
            writer.close()
            return
        up_w.write(head)

        async def pump(src: asyncio.StreamReader, dst: asyncio.StreamWriter):
            err = False
            try:
                while True:
                    data = await src.read(65536)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except (ConnectionError, OSError, asyncio.CancelledError):
                err = True
            finally:
                # clean EOF = the source half-closed its send side; pass
                # the half-close through (a client that shutdown(SHUT_WR)
                # after the request must still receive the streaming
                # response). Full close only on error.
                try:
                    if err or not dst.can_write_eof():
                        dst.close()
                    else:
                        dst.write_eof()
                except (ConnectionError, OSError):
                    pass

        t1 = asyncio.ensure_future(pump(reader, up_w))
        t2 = asyncio.ensure_future(pump(up_r, writer))
        self._proxy_tasks.update((t1, t2))
        try:
            await asyncio.gather(t1, t2, return_exceptions=True)
        finally:
            self._proxy_tasks.difference_update((t1, t2))
            for w in (up_w, writer):
                try:
                    w.close()
                except (ConnectionError, OSError):
                    pass
