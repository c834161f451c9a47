"""Real-socket transport: UDP datagrams + lane-tagged TCP streams.

The port's copy of `corrosion_tpu/net/tcp.py`.

The reference's three QUIC lanes (`transport.rs`: datagrams = SWIM,
uni-streams = broadcast, bi-streams = sync) map onto plain sockets here:

  - datagrams  → one UDP socket per node (SWIM packets are ≤1178 B, well
    under any MTU — `broadcast/mod.rs:957`)
  - uni / bi   → TCP connections opened with a single lane byte
    (`U`/`B`), then u32-BE length-delimited frames (the reference's
    LengthDelimitedCodec layout, ≤100 MiB/frame)

Like the reference's client side, uni-lane connections are cached per
destination and re-established once on failure (`transport.rs:108-140`),
and RTT observations from connection reuse feed the members rings
(`transport.rs:220`). QUIC itself isn't reproduced — no aioquic in the
image and the kernel TCP path is the idiomatic substitute; the seam means
a QUIC implementation can slot in without touching the runtime.

TLS (`api/peer/mod.rs:152-373`): pass ssl contexts (built by
`corrosion_tpu_torch.tls.build_ssl_contexts`) to `TcpListener.bind` and
`TcpTransport`. With TLS on, NO plaintext UDP socket is bound — SWIM
datagrams ride a third lane byte (`D`) on a cached TLS connection as
length-delimited frames, so the whole gossip plane (datagrams, uni,
bi) is encrypted and, with mtls, client-authenticated. Plaintext is the
explicit opt-in (`gossip.plaintext = true`), matching the reference's
quinn_plaintext session (`quinn_plaintext.rs:23-35`).
"""

from __future__ import annotations

import asyncio
import struct
import time
from typing import Dict, Optional, Tuple

from corrosion_tpu_torch.net.transport import (
    BiStream,
    Listener,
    Transport,
    TransportError,
)
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.types.codec import MAX_FRAME

LANE_UNI = b"U"
LANE_BI = b"B"
LANE_DGRAM = b"D"  # TLS mode only: datagrams as frames on a TLS conn
CONNECT_TIMEOUT = 5.0  # transport.rs: 5s connect timeout


def split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]  # [::1]:8080 — sockets want the bare literal
    return host, int(port)


async def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    if len(payload) > MAX_FRAME:
        raise TransportError(f"frame too large: {len(payload)}")
    writer.write(struct.pack(">I", len(payload)) + payload)
    await writer.drain()


async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME:
        raise TransportError(f"frame too large: {n}")
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None


class TcpBiStream(BiStream):
    def __init__(self, reader, writer, peer: str):
        self._reader = reader
        self._writer = writer
        self._peer = peer

    async def send(self, payload: bytes) -> None:
        try:
            await _write_frame(self._writer, payload)
        except (ConnectionError, RuntimeError) as e:
            raise TransportError(str(e)) from e

    async def recv(self) -> Optional[bytes]:
        return await _read_frame(self._reader)

    async def finish(self) -> None:
        try:
            self._writer.write_eof()
            await self._writer.drain()
        except (ConnectionError, RuntimeError, OSError):
            pass

    def close(self) -> None:
        self._writer.close()

    @property
    def peer(self) -> str:
        return self._peer


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, owner: "TcpListener"):
        self._owner = owner

    def datagram_received(self, data: bytes, addr) -> None:
        METRICS.counter("corro.transport.udp_rx.datagrams").inc()
        METRICS.counter("corro.transport.udp_rx.bytes").inc(len(data))
        handler = self._owner._on_datagram
        if handler is not None:
            asyncio.ensure_future(handler(f"{addr[0]}:{addr[1]}", data))


class TcpListener(Listener):
    """Bound UDP socket + TCP server sharing one port number."""

    def __init__(self):
        self._on_datagram = None
        self._on_uni = None
        self._on_bi = None
        self._udp_transport = None
        self._tcp_server: Optional[asyncio.AbstractServer] = None
        self._addr = ""
        self._ssl = None

    @classmethod
    async def bind(
        cls, host: str = "127.0.0.1", port: int = 0, ssl_context=None
    ) -> "TcpListener":
        self = cls()
        self._ssl = ssl_context
        loop = asyncio.get_running_loop()
        if ssl_context is None:
            self._udp_transport, _ = await loop.create_datagram_endpoint(
                lambda: _UdpProtocol(self), local_addr=(host, port)
            )
            bound = self._udp_transport.get_extra_info("sockname")
            # share the port number between UDP (datagrams) and TCP (streams)
            self._tcp_server = await asyncio.start_server(
                self._on_tcp_conn, host, bound[1]
            )
            self._addr = f"{bound[0]}:{bound[1]}"
        else:
            # TLS: the gossip plane accepts NOTHING in plaintext — no UDP
            # socket at all; datagrams arrive as D-lane frames
            self._tcp_server = await asyncio.start_server(
                self._on_tcp_conn, host, port, ssl=ssl_context
            )
            bound = self._tcp_server.sockets[0].getsockname()
            self._addr = f"{bound[0]}:{bound[1]}"
        return self

    def serve(self, on_datagram, on_uni, on_bi) -> None:
        self._on_datagram = on_datagram
        self._on_uni = on_uni
        self._on_bi = on_bi

    async def _on_tcp_conn(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        peer_addr = f"{peer[0]}:{peer[1]}" if peer else "?"
        METRICS.counter("corro.transport.accepted").inc()
        try:
            lane = await reader.readexactly(1)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        if lane == LANE_UNI:
            # long-lived: read frames until EOF, handing each to the handler
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    break
                METRICS.counter(
                    "corro.transport.frames.received", lane="U"
                ).inc()
                METRICS.counter(
                    "corro.transport.bytes.received", lane="U"
                ).inc(len(frame) + 4)
                if self._on_uni is not None:
                    await self._on_uni(peer_addr, frame)
            writer.close()
        elif lane == LANE_DGRAM:
            # TLS-mode datagram lane: each frame is one SWIM packet.
            # Handlers run isolated (like the UDP path's ensure_future):
            # a handler exception or slow reply-send must neither kill
            # this read loop nor head-of-line-block the peer's packets
            while True:
                frame = await _read_frame(reader)
                if frame is None:
                    break
                METRICS.counter(
                    "corro.transport.datagram.recv.total"
                ).inc()
                METRICS.counter(
                    "corro.transport.datagram.bytes.recv.total"
                ).inc(len(frame) + 4)
                if self._on_datagram is not None:
                    asyncio.ensure_future(self._on_datagram(peer_addr, frame))
            writer.close()
        elif lane == LANE_BI:
            if self._on_bi is not None:
                await self._on_bi(TcpBiStream(reader, writer, peer_addr))
        else:
            writer.close()

    @property
    def addr(self) -> str:
        return self._addr

    async def close(self) -> None:
        if self._udp_transport is not None:
            self._udp_transport.close()
        if self._tcp_server is not None:
            self._tcp_server.close()
            # 3.12's wait_closed also waits for in-flight connection
            # handlers (which live as long as cached uni conns) — bound it
            try:
                await asyncio.wait_for(self._tcp_server.wait_closed(), 1.0)
            except asyncio.TimeoutError:
                pass


class TcpTransport(Transport):
    """Client side: shares the listener's UDP socket so replies carry the
    right source address; caches one uni-lane TCP connection per peer.

    Deliberate deviation from the reference: quinn's client side spreads
    connections over 8 UDP sockets hashed by peer to dilute per-socket
    kernel buffer pressure (transport.rs:57-71). Here the gossip plane is
    one asyncio datagram endpoint per node — SWIM packets are ≤1178 B at
    ~1/s/peer, the asyncio loop drains the socket on every wakeup, and
    the single bound port doubles as the node's reply identity; sharding
    sends across extra sockets would buy nothing at this layer while
    complicating addr-based peer bookkeeping."""

    def __init__(self, listener: TcpListener, ssl_context=None,
                 idle_timeout: float = 30.0):
        self._listener = listener
        self._ssl = ssl_context
        # gossip.idle_timeout_secs (peer/mod.rs:125-127 max_idle_timeout):
        # cached lane connections unused this long are reaped, so dead
        # peers don't pin sockets the way an expired QUIC path wouldn't
        self.idle_timeout = idle_timeout
        self._conns: Dict[Tuple[str, bytes], asyncio.StreamWriter] = {}
        self._locks: Dict[Tuple[str, bytes], asyncio.Lock] = {}
        self._last_use: Dict[Tuple[str, bytes], float] = {}

    def reap_idle(self, now: Optional[float] = None) -> int:
        """Close cached lane connections idle longer than idle_timeout.
        Runs opportunistically on every cached send; callable directly.
        Keys whose lane lock is held are in active use and skipped."""
        now = time.monotonic() if now is None else now
        reaped = 0
        for key in list(self._conns):
            lock = self._locks.get(key)
            if lock is not None and lock.locked():
                continue
            if now - self._last_use.get(key, now) > self.idle_timeout:
                writer = self._conns.pop(key)
                self._last_use.pop(key, None)
                self._locks.pop(key, None)  # unheld (checked above): a
                # dead peer must not pin a Lock per (addr, lane) forever
                writer.close()
                reaped += 1
        if reaped:
            METRICS.counter("corro.transport.conns.idle_closed").inc(reaped)
            METRICS.gauge("corro.transport.conns.cached").set(len(self._conns))
        return reaped

    async def send_datagram(self, addr: str, data: bytes) -> None:
        if self._ssl is not None:
            # TLS mode: datagrams ride an encrypted D-lane connection, but
            # keep UDP's fire-and-forget contract — the SWIM probe loop
            # must never stall 5 s on a dead peer's TLS connect. Sends run
            # as background tasks; if the lane is already busy (previous
            # send still connecting), the packet is DROPPED — datagrams
            # are unreliable by contract and SWIM resends
            conn_key = (addr, LANE_DGRAM)
            lock = self._locks.setdefault(conn_key, asyncio.Lock())
            if lock.locked():
                METRICS.counter("corro.transport.datagram.dropped").inc()
                return

            async def _bg():
                try:
                    await self._send_cached(addr, LANE_DGRAM, data)
                    METRICS.counter("corro.transport.datagram.sent").inc()
                except (TransportError, ConnectionError, OSError):
                    METRICS.counter("corro.transport.datagram.failed").inc()

            asyncio.ensure_future(_bg())
            return
        udp = self._listener._udp_transport
        if udp is None:
            raise TransportError("transport closed")
        host, port = split_addr(addr)
        udp.sendto(data, (host, port))
        METRICS.counter("corro.transport.datagram.sent").inc()
        METRICS.counter("corro.transport.udp_tx.datagrams").inc()
        METRICS.counter("corro.transport.udp_tx.bytes").inc(len(data))

    async def _connect(self, addr: str, lane: bytes):
        host, port = split_addr(addr)
        start = time.monotonic()
        try:
            if self._ssl is not None:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(
                        host, port, ssl=self._ssl, server_hostname=host
                    ),
                    CONNECT_TIMEOUT,
                )
            else:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), CONNECT_TIMEOUT
                )
        except (OSError, asyncio.TimeoutError) as e:
            METRICS.counter("corro.transport.connect.failed").inc()
            raise TransportError(f"connect {addr}: {e}") from e
        elapsed = time.monotonic() - start
        METRICS.counter("corro.transport.connect.total").inc()
        METRICS.histogram("corro.transport.connect.seconds").observe(elapsed)
        self.observe_rtt(addr, elapsed)
        writer.write(lane)
        await writer.drain()
        return reader, writer

    async def _send_cached(self, addr: str, lane: bytes, payload: bytes) -> None:
        """Send one frame on the cached per-(peer, lane) connection with
        one reconnect retry, like transport.rs:108-139."""
        conn_key = (addr, lane)
        self.reap_idle()
        # acquire-and-revalidate: asyncio.Lock reports unlocked in the
        # window between release and a queued waiter resuming, so
        # reap_idle can pop a Lock that still has waiters; a waiter that
        # acquired the orphaned Lock must detect the swap and queue on
        # the current one, else two tasks interleave _write_frame on one
        # socket
        while True:
            lock = self._locks.setdefault(conn_key, asyncio.Lock())
            await lock.acquire()
            if self._locks.get(conn_key) is lock:
                break
            lock.release()
        try:
            for attempt in (0, 1):
                writer = self._conns.get(conn_key)
                if writer is None or writer.is_closing():
                    _, writer = await self._connect(addr, lane)
                    self._conns[conn_key] = writer
                self._last_use[conn_key] = time.monotonic()
                try:
                    await _write_frame(writer, payload)
                    METRICS.counter(
                        "corro.transport.frames.sent", lane=lane.decode()
                    ).inc()
                    METRICS.counter(
                        "corro.transport.bytes.sent", lane=lane.decode()
                    ).inc(len(payload) + 4)
                    METRICS.gauge("corro.transport.conns.cached").set(
                        len(self._conns)
                    )
                    return
                except (TransportError, ConnectionError, RuntimeError):
                    self._conns.pop(conn_key, None)
                    self._last_use.pop(conn_key, None)
                    writer.close()
                    METRICS.counter(
                        "corro.transport.send.retried", lane=lane.decode()
                    ).inc()
                    if attempt:
                        raise
        finally:
            lock.release()

    async def send_uni(self, addr: str, payload: bytes) -> None:
        await self._send_cached(addr, LANE_UNI, payload)

    async def open_bi(self, addr: str) -> BiStream:
        reader, writer = await self._connect(addr, LANE_BI)
        METRICS.counter("corro.transport.bi.opened").inc()
        return TcpBiStream(reader, writer, addr)

    async def close(self) -> None:
        for writer in self._conns.values():
            writer.close()
        self._conns.clear()
        self._last_use.clear()
        self._locks.clear()
