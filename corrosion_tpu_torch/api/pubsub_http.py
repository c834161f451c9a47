"""HTTP plumbing for live queries and table updates.

The port's copy of `corrosion_tpu/api/pubsub_http.py`. One difference,
in shutdown: a subscription whose matcher closed before its snapshot was
read ends with a typed error line, as a replay from a closed matcher
does in both packages.

Counterpart of `klukai-agent/src/api/public/pubsub.rs` (api_v1_subs
:699, api_v1_sub_by_id :38, catch_up_sub :387-651, NDJSON streaming
:818-980) and `api/public/update.rs:31-290`:

- `POST /v1/subscriptions` — params interpolated into the SQL
  (pubsub.rs:258-363), `SubsManager::get_or_insert`, response headers
  `corro-query-id` / `corro-query-hash`, NDJSON body: columns → rows
  (unless `skip_rows`) → eoq(change_id) → live change events;
- `GET /v1/subscriptions/{id}` — re-attach; `?from=<change_id>`
  replays the changes log (a pruned-away `from` is a 404: resubscribe
  anew), otherwise streams a fresh snapshot;
- `POST /v1/updates/{table}` — NotifyEvent NDJSON stream.

Event ordering: the subscriber queue is attached *before* the snapshot
or log replay is read, then live events with ids ≤ the replayed max are
dropped — every ChangeId is delivered exactly once, in order
(pubsub.rs:818-980 buffers for the same purpose).
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, Optional

from aiohttp import web

from corrosion_tpu_torch.api.types import (
    ev_columns,
    ev_eoq,
    ev_error,
    ev_lagging,
    ev_notify,
    ev_row,
    parse_statement,
)
from corrosion_tpu_torch.pubsub.fanout import SinkClosed, StreamSink, SubLagging
from corrosion_tpu_torch.pubsub.matcher import MatcherError, SubDead
from corrosion_tpu_torch.pubsub.parse import ParseError


def expand_sql(stmt) -> str:
    """Interpolate params into the SQL text so identical subscriptions
    dedupe on the final query (pubsub.rs:258-363 uses sqlite's
    expanded_sql). Token-level substitution: placeholders inside string
    literals or prefix-colliding names are never touched."""
    from corrosion_tpu_torch.pubsub.parse import tokenize, _join_tokens

    if not stmt.params and not stmt.named_params:
        return stmt.query
    tokens = tokenize(stmt.query)
    # a bare key binds any placeholder style (sqlite accepts :k, @k, $k)
    named = {}
    for k, v in (stmt.named_params or {}).items():
        if k[0] in ":@$":
            named[k] = v
        else:
            for prefix in ":@$":
                named[prefix + k] = v
    out = []
    params = stmt.params or []
    # sqlite ?N semantics: ?N binds params[N-1]; bare ? binds one past the
    # largest index assigned so far
    max_idx = 0
    for tok in tokens:
        if tok.kind == "param":
            if tok.text.startswith("?"):
                idx = int(tok.text[1:]) if len(tok.text) > 1 else max_idx + 1
                if not 1 <= idx <= len(params):
                    raise ParseError(
                        f"parameter {tok.text} out of range"
                        f" (got {len(params)} params)"
                    )
                max_idx = max(max_idx, idx)
                out.append(type(tok)("num", _literal(params[idx - 1])))
                continue
            if tok.text in named:
                out.append(type(tok)("num", _literal(named[tok.text])))
                continue
            raise ParseError(f"unbound parameter {tok.text}")
        out.append(tok)
    if params and max_idx != len(params):
        raise ParseError(
            f"statement uses {max_idx} positional params,"
            f" got {len(params)}"
        )
    return _join_tokens(out)


def _literal(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "X'" + bytes(v).hex() + "'"
    return "'" + str(v).replace("'", "''") + "'"


def _admission_reject(api) -> Optional[web.Response]:
    """[subs] max_streams admission control (r16): a node at its stream
    ceiling refuses NEW streams with a typed 503 rather than admitting
    one it would only serve degraded — the client sees a retryable,
    machine-readable rejection, never a half-dead stream."""
    reason = api.subs.admission_reject()
    if reason is None:
        return None
    return web.json_response(
        {"error": reason, "code": "subs_admission"}, status=503
    )


async def handle_subscribe(api, request: web.Request) -> web.StreamResponse:
    try:
        stmt = parse_statement(await request.json())
        sql = expand_sql(stmt)
    except (ValueError, TypeError, ParseError) as e:
        return web.json_response({"error": str(e)}, status=400)

    try:
        skip_rows, from_id = _stream_params(request)
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=400)

    rejected = _admission_reject(api)
    if rejected is not None:
        return rejected

    try:
        # the lease pins the (possibly deduped) matcher against the
        # linger reaper until our sink attaches
        handle, _created = await api.subs.get_or_insert(sql, lease=True)
    except ParseError as e:
        return web.json_response({"error": str(e)}, status=400)

    return await _stream_sub(request, handle, skip_rows, from_id, api.subs)


async def handle_subscription_by_id(
    api, request: web.Request
) -> web.StreamResponse:
    sub_id = request.match_info["id"]
    handle = api.subs.get(sub_id)
    if handle is None:
        return web.json_response({"error": "unknown subscription"}, status=404)
    if handle.error is not None:
        # dead matcher pending removal: re-attaching would hang forever
        return web.json_response({"error": handle.error}, status=404)
    rejected = _admission_reject(api)
    if rejected is not None:
        return rejected
    handle.lease()  # pin against the linger reaper until the sink attaches
    try:
        skip_rows, from_id = _stream_params(request)
    except ValueError as e:
        handle.release_lease()
        return web.json_response({"error": str(e)}, status=400)
    return await _stream_sub(request, handle, skip_rows, from_id, api.subs)


def _stream_params(request: web.Request):
    skip_rows = request.query.get("skip_rows", "") in ("true", "1")
    from_raw = request.query.get("from")
    try:
        from_id = int(from_raw) if from_raw is not None else None
    except ValueError:
        raise ValueError(f"malformed 'from' change id: {from_raw!r}")
    return skip_rows, from_id


async def _stream_sub_queue(
    request: web.Request,
    handle,
    skip_rows: bool,
    from_id: Optional[int],
) -> web.StreamResponse:
    """The r10 reference path: one drain task + one queue per stream.
    Kept verbatim behind `[subs] fanout="queue"` as the A/B baseline
    the SUBS_SCALE bench measures the shared writer against, and as the
    operational rollback lever."""
    import time

    resp = web.StreamResponse(
        headers={
            "content-type": "application/x-ndjson",
            "corro-query-id": handle.id,
            "corro-query-hash": handle.hash,
        }
    )
    q = None
    try:
        await resp.prepare(request)
        # attach FIRST so no event can fall between snapshot and live
        q = handle.attach()
    finally:
        handle.release_lease()

    async def line(s: str) -> None:
        await resp.write((s + "\n").encode())

    try:
        replayed_max = 0
        if from_id is not None:
            try:
                evs = await asyncio.to_thread(handle.changes_since, from_id)
            except MatcherError as e:
                await line(ev_error(str(e)))
                await resp.write_eof()
                return resp
            if evs is None:
                await line(
                    ev_error(
                        f"change id {from_id} is no longer in the log;"
                        " resubscribe anew"
                    )
                )
                await resp.write_eof()
                return resp
            for ev in evs:
                await line(ev.line())
                replayed_max = ev.change_id
        else:
            await line(ev_columns(handle.columns))
            try:
                rows, snap_id = await asyncio.to_thread(
                    handle.matcher.snapshot
                )
            except MatcherError as e:
                # the subscription closed (a manager stop) before its
                # snapshot was read: a typed terminal, as for a replay
                await line(ev_error(str(e)))
                await resp.write_eof()
                return resp
            if not skip_rows:
                for rowid, values in rows:
                    await line(ev_row(rowid, values))
            await line(ev_eoq(0.0, snap_id if snap_id else None))
            replayed_max = snap_id

        while True:
            item = await q.get()
            # greedy drain: several batches coalesce into one socket
            # write under fan-out pressure (pubsub.rs:818-980)
            pending = [item]
            while True:
                try:
                    pending.append(q.get_nowait())
                except asyncio.QueueEmpty:
                    break
            chunks = []
            shipped = []
            terminal = None
            for item in pending:
                if item is None or isinstance(item, SubDead):
                    terminal = item
                    break
                if item and item[0].change_id > replayed_max:
                    chunks.append(item.payload())
                    shipped.append(item)
                else:
                    lines = [
                        ev.line()
                        for ev in item
                        if ev.change_id > replayed_max
                    ]
                    if lines:
                        chunks.append(("\n".join(lines) + "\n").encode())
                        shipped.append(item)
            if chunks:
                await resp.write(b"".join(chunks))
                from corrosion_tpu_torch.runtime.latency import e2e_observe

                now = time.time()
                for item in shipped:
                    ew = getattr(item, "event_wall", None)
                    if ew is not None:
                        e2e_observe("deliver", now - ew)
                    og = getattr(item, "origin", None)
                    if og is not None:
                        e2e_observe("total", now - og)
            if terminal is None:
                continue
            if isinstance(terminal, SubDead):  # matcher died
                await line(ev_error(f"subscription failed: {terminal.error}"))
            else:  # clean manager stop
                await line(ev_error("subscription closed"))
            break
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        if q is not None:
            handle.detach(q)
    with _suppress_conn_err():
        await resp.write_eof()
    return resp


class _AioStreamSink(StreamSink):
    """h1 flavor: the aiohttp StreamResponse over a real TCP transport
    (the internal listener behind the front-end's byte-pump).  Writes
    go straight to the transport with the response's chunked framing
    applied — synchronous, never awaiting aiohttp's drain helper, so a
    paused (stalled-reader) transport can only clog THIS sink, never
    the shared writer task.  Lag lives in the transport buffer:
    `writable()` gates on its size against the sink's lag bound."""

    def __init__(self, resp, max_lag_bytes: int, max_lag_batches: int):
        super().__init__(max_lag_bytes, max_lag_batches)
        self._writer = resp._payload_writer
        self._chunked = bool(getattr(self._writer, "chunked", False))

    def _transport(self):
        tr = getattr(self._writer, "transport", None)
        if tr is None or tr.is_closing():
            raise SinkClosed("client transport closed")
        return tr

    def writable(self) -> bool:
        return (
            self._transport().get_write_buffer_size() <= self.max_lag_bytes
        )

    def write_some(self, data: bytes) -> int:
        tr = self._transport()
        if self._chunked:
            tr.write(b"%x\r\n%s\r\n" % (len(data), data))
        else:
            tr.write(data)
        self._writer.output_size += len(data)
        return len(data)


class _H2StreamSink(StreamSink):
    """Native-h2 flavor: DATA frames written synchronously up to the
    open flow-control windows (`H2Connection.send_data_nowait`).  A
    stalled client stops crediting its windows, so its lag surfaces
    within one window's worth of bytes — clog, then shed."""

    def __init__(self, req, max_lag_bytes: int, max_lag_batches: int):
        super().__init__(max_lag_bytes, max_lag_batches)
        self._conn = req._conn
        self._stream = req._stream

    def writable(self) -> bool:
        conn, stream = self._conn, self._stream
        if conn.closed or stream.reset_code is not None:
            raise SinkClosed("h2 stream closed")
        tr = conn.writer.transport
        if tr is None or tr.is_closing():
            raise SinkClosed("h2 transport closed")
        if tr.get_write_buffer_size() > self.max_lag_bytes:
            return False
        return conn.send_window > 0 and stream.send_window > 0

    def write_some(self, data: bytes) -> int:
        from corrosion_tpu_torch.net.h2 import StreamReset

        try:
            return self._conn.send_data_nowait(self._stream.sid, data)
        except StreamReset as e:
            raise SinkClosed(str(e)) from e


def _make_sink(resp: web.StreamResponse, cfg) -> StreamSink:
    w = resp._payload_writer
    if hasattr(w, "_req"):  # api/h2front._H2PayloadWriter (native h2)
        return _H2StreamSink(w._req, cfg.max_lag_bytes, cfg.max_lag_batches)
    return _AioStreamSink(resp, cfg.max_lag_bytes, cfg.max_lag_batches)


async def _stream_sub(
    request: web.Request,
    handle,
    skip_rows: bool,
    from_id: Optional[int],
    subs,
) -> web.StreamResponse:
    """Serve one subscription stream.  r16: the stream's live tail is
    delivered by the manager's shared FanoutWriter through a per-stream
    sink — this handler streams the snapshot/replay phase, releases the
    sink into live mode, then PARKS on `sink.done` (no per-batch task
    wakeups) until a terminal: clean stop, matcher death, laggard shed,
    or peer disconnect.  `[subs] fanout="queue"` keeps the r10
    per-stream drain loop as the reference path (bench A/B + rollback
    lever; no shedding there — a stalled consumer stalls only itself)."""
    if subs.cfg.fanout == "queue":
        return await _stream_sub_queue(request, handle, skip_rows, from_id)
    resp = web.StreamResponse(
        headers={
            "content-type": "application/x-ndjson",
            "corro-query-id": handle.id,
            "corro-query-hash": handle.hash,
        }
    )
    sink = None
    try:
        await resp.prepare(request)
        # attach FIRST (in HOLD mode) so no event can fall between
        # snapshot and live tail; the lease taken at lookup is released
        # now that the sink holds a ref
        sink = _make_sink(resp, subs.cfg)
        handle.attach_sink(sink)
    finally:
        handle.release_lease()

    async def line(s: str) -> None:
        await resp.write((s + "\n").encode())

    try:
        replayed_max = 0
        if from_id is not None:
            try:
                evs = await asyncio.to_thread(handle.changes_since, from_id)
            except MatcherError as e:
                # dead matcher: typed terminal error, not a replay hang
                await line(ev_error(str(e)))
                await resp.write_eof()
                return resp
            if evs is None:
                await line(
                    ev_error(
                        f"change id {from_id} is no longer in the log;"
                        " resubscribe anew"
                    )
                )
                await resp.write_eof()
                return resp
            for ev in evs:
                await line(ev.line())
                replayed_max = ev.change_id
        else:
            await line(ev_columns(handle.columns))
            # rows + change id read atomically: no diff can land between
            try:
                rows, snap_id = await asyncio.to_thread(
                    handle.matcher.snapshot
                )
            except MatcherError as e:
                # the subscription closed (a manager stop) before its
                # snapshot was read: a typed terminal, as for a replay
                await line(ev_error(str(e)))
                await resp.write_eof()
                return resp
            if not skip_rows:
                for rowid, values in rows:
                    await line(ev_row(rowid, values))
            await line(ev_eoq(0.0, snap_id if snap_id else None))
            replayed_max = snap_id

        sink.release(replayed_max)
        outcome = await sink.done
        if isinstance(outcome, SubLagging):
            # typed shed frame; the write itself is bounded — a shed
            # sink's transport may be the thing that stopped draining
            with contextlib.suppress(
                asyncio.TimeoutError, ConnectionError
            ):
                await asyncio.wait_for(
                    line(ev_lagging(outcome.lag_bytes, outcome.lag_batches)),
                    2.0,
                )
        elif isinstance(outcome, SubDead):  # matcher died
            await line(ev_error(f"subscription failed: {outcome.error}"))
        elif outcome is None:  # clean manager stop
            await line(ev_error("subscription closed"))
        # SinkClosed outcome: the peer is gone — nothing left to tell it
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        if sink is not None:
            handle.detach_sink(sink)
    with _suppress_conn_err():
        with contextlib.suppress(asyncio.TimeoutError):
            # bounded: a shed laggard's flow-control window may never
            # reopen for the END_STREAM/terminal chunk
            await asyncio.wait_for(resp.write_eof(), 5.0)
    return resp


async def handle_updates(api, request: web.Request) -> web.StreamResponse:
    table = request.match_info["table"]
    try:
        handle, _created = await api.updates.get_or_insert(table)
    except KeyError as e:
        return web.json_response({"error": str(e)}, status=404)

    resp = web.StreamResponse(
        headers={"content-type": "application/x-ndjson"}
    )
    await resp.prepare(request)
    q = handle.attach()
    try:
        while True:
            ev = await q.get()
            if ev is None:  # handle stopped
                break
            kind, pk_values = ev
            await resp.write((ev_notify(kind, pk_values) + "\n").encode())
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        handle.detach(q)
    with _suppress_conn_err():
        await resp.write_eof()
    return resp


def _suppress_conn_err():
    return contextlib.suppress(ConnectionResetError, RuntimeError)
