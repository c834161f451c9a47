"""HTTP/2 (RFC 9113) transport: cleartext prior-knowledge server + client.

The port's copy of `corrosion_tpu/net/h2.py`. One difference, in
shutdown: `H2Server.stop` closes its connections before it waits for its
listener, each step bounded (`STOP_GRACE`).

The reference speaks HTTP/2 end-to-end: its client is h2-only (hyper with
`http2_only(true)`, 10 s keep-alive PINGs — `klukai-client/src/lib.rs:33-47`)
and its axum/hyper API server negotiates h2c.  This image ships no Python
h2 stack, so this module implements the protocol directly on asyncio:

- full frame layer: DATA / HEADERS / PRIORITY / RST_STREAM / SETTINGS /
  PING / GOAWAY / WINDOW_UPDATE / CONTINUATION, padding, header-block
  reassembly;
- both flow-control directions: outbound sends respect the peer's
  connection + stream windows and MAX_FRAME_SIZE (blocking until
  WINDOW_UPDATE), inbound DATA is credited back eagerly so peers never
  stall (bodies land in per-stream queues);
- HPACK via `net/hpack.py` (libnghttp2 when present — interop-grade with
  Huffman — else the pure-Python codec);
- server: multiplexed streams dispatched concurrently to an async handler
  with streaming request and response bodies (NDJSON subscriptions ride
  one stream each, multiplexed over one connection);
- client: request multiplexing over a shared connection with keep-alive
  PINGs every 10 s like the reference's.

Interop is tested against curl's nghttp2 (`--http2-prior-knowledge`) in
tests/test_h2.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import struct
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple

from corrosion_tpu_torch.net import hpack

log = logging.getLogger(__name__)

# frame types (RFC 9113 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1  # DATA, HEADERS
FLAG_ACK = 0x1  # SETTINGS, PING
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# settings ids
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

# error codes
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
FLOW_CONTROL_ERROR = 0x3
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8
COMPRESSION_ERROR = 0x9

# an assembled header block (HEADERS + CONTINUATIONs) larger than this is
# a hostile peer, not a real request (nghttp2's default header-list cap
# is 64 KiB; 1 MiB leaves generous headroom)
MAX_HEADER_BLOCK = 1 << 20

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
DEFAULT_WINDOW = 65535
MAX_FRAME_SIZE_DEFAULT = 16384
# seconds a server stop waits on each step for one connection (GOAWAY
# sent, transport closed) and for its listener, before it moves on
STOP_GRACE = 2.0

Headers = List[Tuple[bytes, bytes]]


class H2Error(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class StreamReset(Exception):
    """Peer reset the stream (RST_STREAM) or the connection died."""


def _frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))[1:]
        + bytes([ftype, flags])
        + struct.pack(">I", stream_id & 0x7FFFFFFF)
        + payload
    )


class _Stream:
    """Per-stream receive state + send window."""

    def __init__(self, sid: int, send_window: int):
        self.sid = sid
        self.headers: Optional[Headers] = None
        self.trailers: Optional[Headers] = None
        self.body: asyncio.Queue = asyncio.Queue()  # bytes | None(eof)
        self.headers_evt = asyncio.Event()
        self.send_window = send_window
        self.window_evt = asyncio.Event()
        self.reset_code: Optional[int] = None
        self.recv_closed = False

    def fail(self, code: int) -> None:
        self.reset_code = code
        self.headers_evt.set()
        self.window_evt.set()
        self.body.put_nowait(None)


class H2Connection:
    """Shared connection machinery: frame IO, settings, flow control."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        is_server: bool,
    ):
        self.reader = reader
        self.writer = writer
        self.is_server = is_server
        self.deflater = hpack.make_deflater()
        self.inflater = hpack.make_inflater()
        self.streams: Dict[int, _Stream] = {}
        self.send_window = DEFAULT_WINDOW  # connection-level, peer's credit
        self.window_evt = asyncio.Event()
        self.peer_max_frame = MAX_FRAME_SIZE_DEFAULT
        self.peer_initial_window = DEFAULT_WINDOW
        # what WE advertise as the per-stream initial window (a serving
        # bench draining 100k streams raises it so the server's fan-out
        # writer isn't throttled to 64 KiB per round trip)
        self.recv_window = DEFAULT_WINDOW
        self.recv_credit = 0  # connection-level bytes to acknowledge
        self._write_lock = asyncio.Lock()
        self._hpack_lock = asyncio.Lock()
        self.closed = False
        self.goaway_sent = False
        self._ping_waiters: Dict[bytes, asyncio.Event] = {}

    # -- writing -----------------------------------------------------------

    async def _send(self, raw: bytes) -> None:
        async with self._write_lock:
            if self.closed:
                raise StreamReset("connection closed")
            self.writer.write(raw)
            await self.writer.drain()

    async def send_settings(self, ack: bool = False, initial: bool = False) -> None:
        if ack:
            await self._send(_frame(SETTINGS, FLAG_ACK, 0, b""))
            return
        payload = b""
        if initial:
            payload = struct.pack(
                ">HIHI",
                SETTINGS_MAX_CONCURRENT_STREAMS, 256,
                SETTINGS_INITIAL_WINDOW_SIZE, self.recv_window,
            )
        await self._send(_frame(SETTINGS, 0, 0, payload))

    async def send_headers(
        self, sid: int, headers: Headers, end_stream: bool
    ) -> None:
        # hpack encoder state is connection-ordered: serialize encode+send
        async with self._hpack_lock:
            block = self.deflater.encode(headers)
            limit = self.peer_max_frame
            # a block over the peer's MAX_FRAME_SIZE must be split into
            # CONTINUATIONs (RFC 9113 §4.2: oversized = connection error)
            first, rest = block[:limit], block[limit:]
            flags = FLAG_END_STREAM if end_stream else 0
            if not rest:
                flags |= FLAG_END_HEADERS
            raw = _frame(HEADERS, flags, sid, first)
            while rest:
                chunk, rest = rest[:limit], rest[limit:]
                raw += _frame(
                    CONTINUATION,
                    FLAG_END_HEADERS if not rest else 0,
                    sid, chunk,
                )
            await self._send(raw)

    async def send_data(self, sid: int, data: bytes, end_stream: bool) -> None:
        """Send respecting both windows and the peer's max frame size."""
        stream = self.streams.get(sid)
        view = memoryview(data)
        while True:
            if stream is not None and stream.reset_code is not None:
                raise StreamReset(f"stream {sid} reset: {stream.reset_code}")
            if self.closed:
                raise StreamReset("connection closed")
            if len(view) == 0:
                if end_stream:
                    await self._send(_frame(DATA, FLAG_END_STREAM, sid, b""))
                return
            avail = min(len(view), self.send_window, self.peer_max_frame)
            if stream is not None:
                avail = min(avail, stream.send_window)
            if avail <= 0:
                # wait for WINDOW_UPDATE on whichever window is empty
                if self.send_window <= 0:
                    self.window_evt.clear()
                    await self.window_evt.wait()
                elif stream is not None:
                    stream.window_evt.clear()
                    await stream.window_evt.wait()
                continue
            chunk = bytes(view[:avail])
            view = view[avail:]
            self.send_window -= len(chunk)
            if stream is not None:
                stream.send_window -= len(chunk)
            last = len(view) == 0 and end_stream
            await self._send(
                _frame(DATA, FLAG_END_STREAM if last else 0, sid, chunk)
            )
            if last:
                return

    def send_data_nowait(self, sid: int, data: bytes) -> int:
        """Best-effort SYNCHRONOUS data write for the subscription
        fan-out plane (r16): consume whatever the connection + stream
        send windows currently allow, frame it, and append it to the
        transport WITHOUT awaiting drain or WINDOW_UPDATEs.  Returns
        the number of payload bytes accepted (0 when a window is
        closed) — the caller keeps the remainder and retries when
        credit returns.  Never sends END_STREAM.  Frame-atomic
        interleaving with `_send` is safe: every writer call appends
        whole frames."""
        stream = self.streams.get(sid)
        if self.closed:
            raise StreamReset("connection closed")
        if stream is not None and stream.reset_code is not None:
            raise StreamReset(f"stream {sid} reset: {stream.reset_code}")
        view = memoryview(data)
        sent = 0
        while sent < len(data):
            avail = min(len(data) - sent, self.send_window, self.peer_max_frame)
            if stream is not None:
                avail = min(avail, stream.send_window)
            if avail <= 0:
                break
            chunk = bytes(view[sent : sent + avail])
            self.send_window -= avail
            if stream is not None:
                stream.send_window -= avail
            self.writer.write(_frame(DATA, 0, sid, chunk))
            sent += avail
        return sent

    async def send_rst(self, sid: int, code: int) -> None:
        try:
            await self._send(_frame(RST_STREAM, 0, sid, struct.pack(">I", code)))
        except (StreamReset, ConnectionError, OSError):
            pass

    async def send_goaway(self, code: int = NO_ERROR) -> None:
        if self.goaway_sent:
            return
        self.goaway_sent = True
        last = max(self.streams, default=0)
        try:
            await self._send(
                _frame(GOAWAY, 0, 0, struct.pack(">II", last, code))
            )
        except (StreamReset, ConnectionError, OSError):
            pass

    async def ping(self, timeout: float = 5.0) -> bool:
        """RTT probe / keep-alive; True iff the ACK came back in time."""
        import os as _os

        data = _os.urandom(8)
        evt = asyncio.Event()
        self._ping_waiters[data] = evt
        try:
            await self._send(_frame(PING, 0, 0, data))
            await asyncio.wait_for(evt.wait(), timeout)
            return True
        except (asyncio.TimeoutError, StreamReset, ConnectionError, OSError):
            return False
        finally:
            self._ping_waiters.pop(data, None)

    async def _credit_recv(self, sid: int, n: int) -> None:
        """Replenish inbound windows eagerly: receivers buffer per-stream,
        so the transport window never back-pressures the peer."""
        if n <= 0:
            return
        self.recv_credit += n
        updates = b""
        if self.recv_credit >= DEFAULT_WINDOW // 2:
            updates += _frame(
                WINDOW_UPDATE, 0, 0, struct.pack(">I", self.recv_credit)
            )
            self.recv_credit = 0
        updates += _frame(WINDOW_UPDATE, 0, sid, struct.pack(">I", n))
        await self._send(updates)

    # -- reading -----------------------------------------------------------

    async def read_frame(self) -> Tuple[int, int, int, bytes]:
        header = await self.reader.readexactly(9)
        length = int.from_bytes(header[:3], "big")
        ftype, flags = header[3], header[4]
        sid = int.from_bytes(header[5:9], "big") & 0x7FFFFFFF
        # we never raise SETTINGS_MAX_FRAME_SIZE, so the peer must stay
        # within the default; enforcing it here (RFC 9113 §4.2) is also
        # what stops a single 16 MiB HEADERS/DATA frame from being
        # buffered wholesale — the frame-level DoS bound
        if length > MAX_FRAME_SIZE_DEFAULT:
            raise H2Error(FRAME_SIZE_ERROR, "oversized frame")
        payload = await self.reader.readexactly(length) if length else b""
        return ftype, flags, sid, payload

    async def read_header_block(
        self, flags: int, payload: bytes, sid: int
    ) -> Tuple[bytes, int]:
        """Strip padding/priority; append CONTINUATIONs until END_HEADERS.

        Returns the block plus the effective flags: END_STREAM can only
        appear on the initial HEADERS frame, so it is preserved across
        CONTINUATIONs (whose own flag bits carry only END_HEADERS).
        CONTINUATIONs must stay on the same stream, and the assembled
        block is size-capped — an endless-CONTINUATION peer is a DoS."""
        end_stream = flags & FLAG_END_STREAM
        if flags & FLAG_PADDED:
            if not payload:
                raise H2Error(PROTOCOL_ERROR, "bad padding")
            pad = payload[0]
            payload = payload[1:]
            if pad > len(payload):
                raise H2Error(PROTOCOL_ERROR, "bad padding")
            payload = payload[: len(payload) - pad]
        if flags & FLAG_PRIORITY:
            payload = payload[5:]
        block = payload
        while not flags & FLAG_END_HEADERS:
            ftype, flags, csid, cont = await self.read_frame()
            if ftype != CONTINUATION or csid != sid:
                raise H2Error(PROTOCOL_ERROR, "expected CONTINUATION")
            block += cont
            if len(block) > MAX_HEADER_BLOCK:
                raise H2Error(FRAME_SIZE_ERROR, "header block too large")
        return block, flags | end_stream

    def _strip_data_padding(self, flags: int, payload: bytes) -> bytes:
        if flags & FLAG_PADDED:
            if not payload:
                raise H2Error(PROTOCOL_ERROR, "bad padding")
            pad = payload[0]
            payload = payload[1:]
            if pad > len(payload):
                raise H2Error(PROTOCOL_ERROR, "bad padding")
            payload = payload[: len(payload) - pad]
        return payload

    def apply_settings(self, payload: bytes) -> None:
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "bad SETTINGS length")
        for off in range(0, len(payload), 6):
            ident, value = struct.unpack_from(">HI", payload, off)
            if ident == SETTINGS_MAX_FRAME_SIZE:
                if not 16384 <= value <= 2 ** 24 - 1:
                    raise H2Error(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
                self.peer_max_frame = value
            elif ident == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > 2 ** 31 - 1:
                    raise H2Error(FLOW_CONTROL_ERROR, "bad INITIAL_WINDOW")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for s in self.streams.values():
                    s.send_window += delta
                    if s.send_window > 0:
                        s.window_evt.set()

    def handle_rst_stream(self, sid: int, payload: bytes) -> None:
        """Validate + apply a peer RST_STREAM (RFC 9113 §6.4)."""
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "bad RST_STREAM")
        if sid == 0:
            raise H2Error(PROTOCOL_ERROR, "RST_STREAM on stream 0")
        stream = self.streams.get(sid)
        if stream is not None:
            stream.fail(struct.unpack(">I", payload)[0])

    def handle_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
        if sid == 0:
            self.send_window += inc
            if self.send_window > 0:
                self.window_evt.set()
        else:
            s = self.streams.get(sid)
            if s is not None:
                s.send_window += inc
                if s.send_window > 0:
                    s.window_evt.set()

    def fail_all(self) -> None:
        self.closed = True
        self.window_evt.set()
        for s in self.streams.values():
            s.fail(CANCEL)
        for evt in self._ping_waiters.values():
            evt.set()

    async def close(self) -> None:
        self.fail_all()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _body_iter(stream: _Stream) -> AsyncIterator[bytes]:
    while True:
        chunk = await stream.body.get()
        if chunk is None:
            if stream.reset_code not in (None, NO_ERROR):
                raise StreamReset(f"stream reset: {stream.reset_code}")
            return
        yield chunk


# -- server -----------------------------------------------------------------


class H2Request:
    """One server-side stream: request view + response emitters."""

    def __init__(self, conn: "H2Connection", stream: _Stream):
        self._conn = conn
        self._stream = stream
        hdrs = stream.headers or []
        pseudo = {k: v for k, v in hdrs if k.startswith(b":")}
        self.method = pseudo.get(b":method", b"").decode()
        self.path = pseudo.get(b":path", b"/").decode()
        self.authority = pseudo.get(b":authority", b"").decode()
        self.headers: Dict[str, str] = {
            k.decode(): v.decode() for k, v in hdrs if not k.startswith(b":")
        }
        self._sent_headers = False

    def body(self) -> AsyncIterator[bytes]:
        return _body_iter(self._stream)

    async def read_body(self) -> bytes:
        return b"".join([chunk async for chunk in self.body()])

    async def send_headers(
        self,
        status: int,
        headers: Optional[Dict[str, str]] = None,
        end_stream: bool = False,
    ) -> None:
        hs: Headers = [(b":status", str(status).encode())]
        for k, v in (headers or {}).items():
            hs.append((k.lower().encode(), v.encode()))
        await self._conn.send_headers(self._stream.sid, hs, end_stream)
        self._sent_headers = True

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self._conn.send_data(self._stream.sid, data, end_stream)

    async def respond(
        self, status: int, body: bytes = b"",
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        hs = dict(headers or {})
        hs.setdefault("content-length", str(len(body)))
        await self.send_headers(status, hs, end_stream=not body)
        if body:
            await self.send_data(body, end_stream=True)


Handler = Callable[[H2Request], "asyncio.Future"]


async def _goaway_and_close(conn: H2Connection) -> None:
    """GOAWAY and close one server connection within bounded waits: a
    peer that stopped reading never drains the GOAWAY, and its
    transport never finishes closing, so it is aborted."""
    with contextlib.suppress(asyncio.TimeoutError):
        await asyncio.wait_for(conn.send_goaway(NO_ERROR), STOP_GRACE)
    try:
        await asyncio.wait_for(conn.close(), STOP_GRACE)
    except asyncio.TimeoutError:
        conn.writer.transport.abort()


class H2Server:
    """h2c prior-knowledge server: one asyncio task per connection, one per
    stream; graceful close sends GOAWAY (util.rs's axum graceful layer)."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop listening, then GOAWAY and close every connection, then
        wait for the listener. Since Python 3.12.1 `wait_closed` also
        waits for every accepted connection to drop, so waiting first
        (as the JAX module does) hangs while a client holds one open."""
        if self._server is not None:
            self._server.close()
        await asyncio.gather(*(_goaway_and_close(c) for c in list(self._conns)))
        if self._server is not None:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._server.wait_closed(), STOP_GRACE)

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        await self.handle_connection(reader, writer)

    async def handle_connection(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        preface_consumed: bool = False,
    ) -> None:
        """Serve one h2c connection; a protocol-sniffing front listener
        passes preface_consumed=True after eating the 24-byte preface."""
        conn = H2Connection(reader, writer, is_server=True)
        self._conns.add(conn)
        tasks: Dict[int, asyncio.Task] = {}
        last_sid = 0  # client stream ids are strictly increasing (§5.1.1)
        seen_sids: set = set()  # sids that actually carried a request:
        # distinguishes late trailers (valid) from HEADERS/DATA on a
        # never-opened closed stream (PROTOCOL_ERROR, §5.1.1)
        try:
            if not preface_consumed:
                preface = await asyncio.wait_for(
                    reader.readexactly(len(PREFACE)), 10.0
                )
                if preface != PREFACE:
                    return
            await conn.send_settings(initial=True)
            while True:
                ftype, flags, sid, payload = await conn.read_frame()
                if ftype == HEADERS:
                    if sid == 0 or sid % 2 == 0:
                        # §5.1.1: clients use odd ids; stream 0 carries
                        # no HEADERS — connection error, not leniency
                        raise H2Error(
                            PROTOCOL_ERROR, "HEADERS on stream 0/even"
                        )
                    block, flags = await conn.read_header_block(flags, payload, sid)
                    existing = conn.streams.get(sid)
                    if existing is not None or sid in seen_sids:
                        # trailers — on an open stream, or late ones for a
                        # stream whose handler already finished. Decode
                        # either way: HPACK state is connection-ordered.
                        async with conn._hpack_lock:
                            trailers = conn.inflater.decode(block)
                        if existing is not None:
                            existing.trailers = trailers
                            if (
                                flags & FLAG_END_STREAM
                                and not existing.recv_closed
                            ):
                                existing.recv_closed = True
                                existing.body.put_nowait(None)
                        continue
                    if sid <= last_sid:
                        # a lower-numbered id that never carried a
                        # request is "closed" (§5.1.1): HEADERS on it is
                        # a connection error
                        raise H2Error(
                            PROTOCOL_ERROR, "HEADERS on never-opened stream"
                        )
                    last_sid = sid
                    seen_sids.add(sid)
                    stream = _Stream(sid, conn.peer_initial_window)
                    async with conn._hpack_lock:
                        stream.headers = conn.inflater.decode(block)
                    conn.streams[sid] = stream
                    if flags & FLAG_END_STREAM:
                        stream.recv_closed = True
                        stream.body.put_nowait(None)
                    req = H2Request(conn, stream)
                    task = asyncio.ensure_future(
                        self._run_stream(conn, req, stream)
                    )
                    tasks[sid] = task
                    # prune on completion: one long-lived multiplexed
                    # connection must not accumulate finished tasks
                    task.add_done_callback(
                        lambda _t, s=sid: tasks.pop(s, None)
                    )
                elif ftype == DATA:
                    if sid == 0 or sid % 2 == 0 or sid not in seen_sids:
                        # DATA on stream 0, a server-id stream, or a
                        # stream that never carried a request: §6.1 /
                        # §5.1.1 connection error (silently dropping it
                        # would also corrupt flow-control accounting on
                        # a misbehaving peer). DATA for a *finished*
                        # request stream stays lenient below.
                        raise H2Error(PROTOCOL_ERROR, "DATA on idle stream")
                    stream = conn.streams.get(sid)
                    data = conn._strip_data_padding(flags, payload)
                    if stream is not None and not stream.recv_closed:
                        stream.body.put_nowait(data)
                        if flags & FLAG_END_STREAM:
                            stream.recv_closed = True
                            stream.body.put_nowait(None)
                    await conn._credit_recv(sid, len(payload))
                elif ftype == SETTINGS:
                    if not flags & FLAG_ACK:
                        conn.apply_settings(payload)
                        await conn.send_settings(ack=True)
                elif ftype == WINDOW_UPDATE:
                    conn.handle_window_update(sid, payload)
                elif ftype == RST_STREAM:
                    conn.handle_rst_stream(sid, payload)
                    t = tasks.pop(sid, None)
                    if t is not None:
                        t.cancel()
                elif ftype == PING:
                    if not flags & FLAG_ACK:
                        await conn._send(_frame(PING, FLAG_ACK, 0, payload))
                elif ftype == GOAWAY:
                    return
                elif ftype in (PRIORITY, PUSH_PROMISE, CONTINUATION):
                    pass  # PRIORITY ignored; others invalid here
        except (
            asyncio.IncompleteReadError, asyncio.TimeoutError,
            ConnectionError, OSError,
        ):
            pass
        except ValueError as e:
            # undecodable HPACK block: RFC 9113 §4.3 — GOAWAY, not an
            # abrupt close with an unretrieved task exception
            log.debug("h2 compression error: %s", e)
            await conn.send_goaway(COMPRESSION_ERROR)
        except H2Error as e:
            log.debug("h2 connection error: %s", e)
            await conn.send_goaway(e.code)
        finally:
            conn.fail_all()
            for t in tasks.values():
                t.cancel()
            self._conns.discard(conn)
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass

    async def _run_stream(
        self, conn: H2Connection, req: H2Request, stream: _Stream
    ) -> None:
        try:
            await self.handler(req)
        except (StreamReset, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — handler crash = 500 or RST
            log.exception("h2 handler error %s %s", req.method, req.path)
            if not req._sent_headers:
                try:
                    await req.respond(500, b"internal error")
                except (StreamReset, ConnectionError, OSError):
                    pass
            else:
                await conn.send_rst(stream.sid, CANCEL)
        finally:
            conn.streams.pop(stream.sid, None)
            if (
                not stream.recv_closed
                and stream.reset_code is None
                and not conn.closed
            ):
                # response finished before the request did: RST with
                # NO_ERROR so the peer stops sending (RFC 9113 §8.1)
                asyncio.ensure_future(conn.send_rst(stream.sid, NO_ERROR))


# -- client -----------------------------------------------------------------


class H2Response:
    def __init__(self, conn: H2Connection, stream: _Stream):
        self._conn = conn
        self._stream = stream
        hdrs = stream.headers or []
        self.status = int(
            {k: v for k, v in hdrs}.get(b":status", b"0").decode() or 0
        )
        self.headers: Dict[str, str] = {
            k.decode(): v.decode() for k, v in hdrs if not k.startswith(b":")
        }

    def body(self) -> AsyncIterator[bytes]:
        return _body_iter(self._stream)

    async def read(self) -> bytes:
        return b"".join([chunk async for chunk in self.body()])

    async def aclose(self) -> None:
        """Abandon the response early: RST the stream so the server stops
        sending (an unconsumed NDJSON stream would otherwise flow forever)."""
        s = self._stream
        if not s.recv_closed and s.reset_code is None:
            await self._conn.send_rst(s.sid, CANCEL)
            s.reset_code = NO_ERROR  # local cancel: clean end for readers
            s.recv_closed = True
            s.body.put_nowait(None)
        self._conn.streams.pop(s.sid, None)


class H2Client:
    """Multiplexing h2c client; the reference's hyper client config
    (`lib.rs:38-47`): prior knowledge, keep-alive PING every 10 s."""

    def __init__(
        self, host: str, port: int, keepalive_s: float = 10.0,
        connect_timeout: float = 3.0,
        recv_window: int = DEFAULT_WINDOW,
        conn_recv_window: int = DEFAULT_WINDOW,
    ):
        self.host = host
        self.port = port
        self.keepalive_s = keepalive_s
        self.connect_timeout = connect_timeout
        # receive-window sizing (r16): `recv_window` is advertised as
        # the per-stream initial window, `conn_recv_window` grows the
        # connection window past the RFC-fixed 65535 start via an
        # immediate WINDOW_UPDATE — a client multiplexing thousands of
        # live subscription streams over one connection needs both or
        # the server stalls on 64 KiB of unacked data per round trip
        self.recv_window = max(DEFAULT_WINDOW, recv_window)
        self.conn_recv_window = max(DEFAULT_WINDOW, conn_recv_window)
        self._conn: Optional[H2Connection] = None
        self._next_sid = 1
        self._reader_task: Optional[asyncio.Task] = None
        self._ping_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()

    async def _ensure(self) -> H2Connection:
        async with self._lock:
            if self._conn is not None and not self._conn.closed:
                return self._conn
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.connect_timeout,
            )
            conn = H2Connection(reader, writer, is_server=False)
            conn.recv_window = self.recv_window
            writer.write(PREFACE)
            await conn.send_settings(initial=True)
            extra = self.conn_recv_window - DEFAULT_WINDOW
            if extra > 0:
                await conn._send(
                    _frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", extra))
                )
            self._conn = conn
            self._next_sid = 1
            self._reader_task = asyncio.ensure_future(self._read_loop(conn))
            self._ping_task = asyncio.ensure_future(self._keepalive(conn))
            return conn

    async def _read_loop(self, conn: H2Connection) -> None:
        try:
            while True:
                ftype, flags, sid, payload = await conn.read_frame()
                if ftype == HEADERS:
                    block, flags = await conn.read_header_block(flags, payload, sid)
                    stream = conn.streams.get(sid)
                    async with conn._hpack_lock:
                        decoded = conn.inflater.decode(block)
                    if stream is None:
                        continue
                    if stream.headers is None:
                        stream.headers = decoded
                        stream.headers_evt.set()
                    else:
                        stream.trailers = decoded
                    if flags & FLAG_END_STREAM:
                        stream.recv_closed = True
                        stream.body.put_nowait(None)
                elif ftype == DATA:
                    stream = conn.streams.get(sid)
                    data = conn._strip_data_padding(flags, payload)
                    if stream is not None and not stream.recv_closed:
                        stream.body.put_nowait(data)
                        if flags & FLAG_END_STREAM:
                            stream.recv_closed = True
                            stream.body.put_nowait(None)
                    await conn._credit_recv(sid, len(payload))
                elif ftype == SETTINGS:
                    if not flags & FLAG_ACK:
                        conn.apply_settings(payload)
                        await conn.send_settings(ack=True)
                elif ftype == WINDOW_UPDATE:
                    conn.handle_window_update(sid, payload)
                elif ftype == RST_STREAM:
                    conn.handle_rst_stream(sid, payload)
                elif ftype == PING:
                    if flags & FLAG_ACK:
                        evt = conn._ping_waiters.get(payload)
                        if evt is not None:
                            evt.set()
                    else:
                        await conn._send(_frame(PING, FLAG_ACK, 0, payload))
                elif ftype == GOAWAY:
                    return
        except (
            asyncio.IncompleteReadError, ConnectionError, OSError, H2Error,
            ValueError, asyncio.CancelledError,
        ):
            pass
        finally:
            conn.fail_all()

    async def _keepalive(self, conn: H2Connection) -> None:
        try:
            while not conn.closed:
                await asyncio.sleep(self.keepalive_s)
                if not await conn.ping(self.keepalive_s / 2):
                    conn.fail_all()
                    return
        except asyncio.CancelledError:
            pass

    async def request(
        self,
        method: str,
        path: str,
        headers: Optional[Dict[str, str]] = None,
        body: bytes = b"",
    ) -> H2Response:
        conn = await self._ensure()
        async with self._lock:
            sid = self._next_sid
            self._next_sid += 2
        stream = _Stream(sid, conn.peer_initial_window)
        conn.streams[sid] = stream
        hs: Headers = [
            (b":method", method.encode()),
            (b":scheme", b"http"),
            (b":authority", f"{self.host}:{self.port}".encode()),
            (b":path", path.encode()),
        ]
        for k, v in (headers or {}).items():
            hs.append((k.lower().encode(), v.encode()))
        try:
            await conn.send_headers(sid, hs, end_stream=not body)
            if body:
                await conn.send_data(sid, body, end_stream=True)
            await stream.headers_evt.wait()
        except (StreamReset, ConnectionError, OSError) as e:
            conn.streams.pop(sid, None)
            raise StreamReset(str(e)) from e
        except asyncio.CancelledError:
            # caller timed out / was cancelled: deregister and RST so the
            # server stops and late frames aren't queued into an orphan
            conn.streams.pop(sid, None)
            if not conn.closed:
                asyncio.ensure_future(conn.send_rst(sid, CANCEL))
            raise
        if stream.reset_code is not None:
            conn.streams.pop(sid, None)
            raise StreamReset(f"stream reset: {stream.reset_code}")
        return H2Response(conn, stream)

    async def close(self) -> None:
        for t in (self._ping_task, self._reader_task):
            if t is not None:
                t.cancel()
        if self._conn is not None:
            await self._conn.send_goaway(NO_ERROR)
            await self._conn.close()
            self._conn = None
