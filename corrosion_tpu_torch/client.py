"""Python client library for the HTTP API.

The port's copy of `corrosion_tpu/client.py`.

Counterpart of `klukai-client` (`crates/klukai-client/src/lib.rs:33-420`,
`src/sub.rs`): execute/query/schema plus line-framed NDJSON streams for
queries, subscriptions and table updates. `SubscriptionStream` tracks the
last observed ChangeId and transparently reconnects + resubscribes from
it on gap or disconnect (`sub.rs:328-388`).

Protocol note: the reference client is HTTP/2-only (`lib.rs:33-47`,
hyper with `http2_only(true)`, keep-alive PINGs every 10 s). This client
matches it: by default requests ride one multiplexed h2c connection
(`net/h2.py` — the in-repo HTTP/2 implementation; the server front-end
`api/h2front.py` speaks both protocols on the API port). `http2=False`
falls back to aiohttp HTTP/1.1 with per-stream keep-alive connections —
identical paths, headers, and NDJSON framing either way.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import sqlite3
import threading
import urllib.parse
from typing import Any, AsyncIterator, Dict, List, Optional

import aiohttp

from corrosion_tpu_torch.net.h2 import H2Client, StreamReset
from corrosion_tpu_torch.runtime.backoff import Backoff


def _reconnect_backoff():
    """Full-jitter reconnect pacing (the r9 announcer discipline,
    runtime/backoff.py): when an agent restart drops thousands of
    subscription streams at once, deterministic doubling would re-dial
    them all in the same beat at exactly the moment the server is
    busiest re-admitting.  Uniform-in-[0, base] spreads the stampede;
    the cap keeps a capped-retry stream's total stall bounded."""
    return iter(Backoff(
        min_interval=0.2, max_interval=2.0, factor=2.0,
        mode="full", retries=None,
    ))


class _H2Resp:
    """Duck-typed slice of aiohttp.ClientResponse the client uses:
    .status, .headers.get, .text(), .content.iter_any()."""

    def __init__(self, resp):
        self._resp = resp
        self.status = resp.status
        self.headers = resp.headers

    async def text(self) -> str:
        return (await self._resp.read()).decode()

    async def json(self) -> Any:
        return json.loads(await self._resp.read())

    @property
    def content(self) -> "_H2Resp":
        return self

    def iter_any(self) -> AsyncIterator[bytes]:
        return self._resp.body()


class _H2Ctx:
    def __init__(self, session: "_H2Session", method: str, url: str,
                 json_body: Any, params: Optional[Dict[str, str]]):
        self._session = session
        self._method = method
        self._url = url
        self._json = json_body
        self._params = params
        self._resp = None

    async def __aenter__(self) -> _H2Resp:
        split = urllib.parse.urlsplit(self._url)
        path = split.path or "/"
        qs = split.query
        if self._params:
            extra = urllib.parse.urlencode(self._params)
            qs = f"{qs}&{extra}" if qs else extra
        if qs:
            path = f"{path}?{qs}"
        body = b""
        if self._json is not None:
            body = json.dumps(self._json).encode()
        try:
            # bound connect+send+response-headers like the h1 session's
            # total timeout did — a wedged server must not hang callers
            # forever just because its TCP + PINGs stay healthy. (Body
            # streaming is deliberately unbounded: subscriptions are
            # infinite by design and reconnect on transport errors.)
            self._resp = await asyncio.wait_for(
                self._session.h2.request(
                    self._method, path,
                    headers=self._session.headers, body=body,
                ),
                self._session.request_timeout,
            )
        except (StreamReset, ConnectionError, OSError, asyncio.TimeoutError) as e:
            # surface transport failures as the retry-able client error
            # type the reconnect loops already handle
            raise aiohttp.ClientConnectionError(str(e)) from e
        return _H2Resp(self._resp)

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            await self._resp.aclose()


class _H2Session:
    """aiohttp.ClientSession-shaped facade over one multiplexed H2Client."""

    def __init__(self, host: str, port: int, headers: Dict[str, str],
                 request_timeout: float = 300.0):
        self.h2 = H2Client(host, port)
        self.headers = headers
        self.request_timeout = request_timeout
        self.closed = False

    def post(self, url: str, json: Any = None,
             params: Optional[Dict[str, str]] = None) -> _H2Ctx:
        return _H2Ctx(self, "POST", url, json, params)

    def get(self, url: str,
            params: Optional[Dict[str, str]] = None) -> _H2Ctx:
        return _H2Ctx(self, "GET", url, None, params)

    async def close(self) -> None:
        self.closed = True
        await self.h2.close()


class CorrosionApiClient:
    def __init__(self, addr: str, token: Optional[str] = None,
                 http2: bool = True):
        self.base = f"http://{addr}"
        self.http2 = http2
        host, sep, port = addr.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]  # [::1]:8080 — open_connection wants ::1
        if sep and port.isdigit():
            self._host, self._port = host or "127.0.0.1", int(port)
        else:  # bare hostname: default http port, as the h1 path resolves it
            self._host, self._port = addr, 80
        self._headers = {"content-type": "application/json"}
        if token:
            self._headers["authorization"] = f"Bearer {token}"
        self._session = None

    async def _ensure(self):
        if self._session is None or self._session.closed:
            if self.http2:
                self._session = _H2Session(
                    self._host, self._port, self._headers
                )
            else:
                self._session = aiohttp.ClientSession(headers=self._headers)
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def __aenter__(self) -> "CorrosionApiClient":
        await self._ensure()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- one-shot calls ----------------------------------------------------

    @staticmethod
    def _timeout_params(timeout: Optional[float]) -> Optional[Dict[str, str]]:
        # the reference client threads ?timeout= through query_typed /
        # execute (lib.rs:53-58); the server interrupts overruns
        return {"timeout": str(timeout)} if timeout else None

    async def execute(
        self, statements: List[Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        s = await self._ensure()
        async with s.post(
            f"{self.base}/v1/transactions", json=statements,
            params=self._timeout_params(timeout),
        ) as resp:
            body = await _body_json(resp)
            if resp.status >= 400:
                raise ClientError(resp.status, body)
            return body

    async def schema(self, statements: List[str]) -> Dict[str, Any]:
        s = await self._ensure()
        async with s.post(
            f"{self.base}/v1/migrations", json=statements
        ) as resp:
            body = await _body_json(resp)
            if resp.status >= 400:
                raise ClientError(resp.status, body)
            return body

    async def schema_from_paths(self, paths: List[str]) -> Dict[str, Any]:
        stmts = []
        for p in paths:
            with open(p) as f:
                stmts.append(f.read())
        return await self.schema(stmts)

    async def table_stats(
        self, tables: Optional[List[str]] = None
    ) -> Dict[str, Any]:
        s = await self._ensure()
        async with s.post(
            f"{self.base}/v1/table_stats", json={"tables": tables or []}
        ) as resp:
            return await resp.json()

    async def query(
        self, statement: Any, timeout: Optional[float] = None
    ) -> AsyncIterator[Dict[str, Any]]:
        """Stream QueryEvents for one statement."""
        s = await self._ensure()
        async with s.post(
            f"{self.base}/v1/queries", json=statement,
            params=self._timeout_params(timeout),
        ) as resp:
            if resp.status >= 400:
                raise ClientError(resp.status, await _body_json(resp))
            async for line in _lines(resp):
                yield json.loads(line)

    async def query_rows(self, statement: Any) -> List[List[Any]]:
        """Convenience: collect just the row values."""
        rows = []
        async for ev in self.query(statement):
            if "row" in ev:
                rows.append(ev["row"][1])
            elif "error" in ev:
                raise ClientError(200, ev)
        return rows

    async def profile(
        self, window: Optional[float] = None, format: str = "json"
    ) -> Any:
        """Continuous-profiling plane (r23): the node's folded-stack
        profile.  `format="json"` (default) returns the summary dict,
        `"speedscope"` the speedscope.app document (dict),
        `"folded"` collapsed-stack text (str)."""
        s = await self._ensure()
        params: Dict[str, str] = {"format": format}
        if window is not None:
            params["window"] = str(float(window))
        async with s.get(
            f"{self.base}/v1/profile", params=params
        ) as resp:
            if resp.status >= 400:
                raise ClientError(resp.status, await resp.text())
            if format == "folded":
                return await resp.text()
            return await resp.json()

    # -- streams -----------------------------------------------------------

    def subscribe(
        self,
        statement: Any,
        skip_rows: bool = False,
        from_change: Optional[int] = None,
        raw: bool = False,
    ) -> "SubscriptionStream":
        """`raw=True` yields undecoded NDJSON lines (str) instead of
        parsed dicts — the high-throughput observer mode: no json.loads
        per event, change ids still tracked for reconnect via a cheap
        tail parse."""
        return SubscriptionStream(
            self, statement, skip_rows, from_change, raw
        )

    async def updates(self, table: str) -> AsyncIterator[Dict[str, Any]]:
        s = await self._ensure()
        async with s.post(f"{self.base}/v1/updates/{table}") as resp:
            if resp.status >= 400:
                raise ClientError(resp.status, await resp.text())
            async for line in _lines(resp):
                yield json.loads(line)


class ClientError(Exception):
    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


class SubShedError(Exception):
    """The server SHED this stream as a laggard (`{"lagging": ...}`
    terminal frame, r16 admission control): the subscription is healthy
    but our socket fell behind the live fan-out.  `SubscriptionStream`
    treats it as a retryable disconnect and resumes from the last
    observed change id — the matcher's changes log replays what the
    shed dropped."""

    def __init__(self, lag: Any):
        super().__init__(f"stream shed as laggard: {lag}")
        self.lag = lag


class SubscriptionStream:
    """Auto-resubscribing NDJSON event stream (client/src/sub.rs:328-388).

    Iterate to receive QueryEvents; on disconnect or ChangeId gap the
    stream reconnects by query-id from `last_change_id`.
    """

    def __init__(self, client, statement, skip_rows, from_change, raw=False):
        self.client = client
        self.statement = statement
        self.skip_rows = skip_rows
        self.raw = raw
        self.last_change_id: Optional[int] = from_change
        self.query_id: Optional[str] = None
        self._max_retries = 5

    def __aiter__(self) -> AsyncIterator[Dict[str, Any]]:
        return self._run()

    async def _run(self):
        retries = 0
        boff = _reconnect_backoff()
        while True:
            try:
                async for ev in self._connect_once():
                    if retries:
                        # progress: the retry budget AND the backoff
                        # ramp both restart from the bottom
                        retries = 0
                        boff = _reconnect_backoff()
                    yield ev
                return  # server ended the stream cleanly
            except SubShedError:
                # shed as a laggard: resume from last_change_id — the
                # server replays the gap from the matcher's changes log
                # (a pruned-away id surfaces as the documented
                # resubscribe-anew error).  Retry-capped like any other
                # disconnect so a chronically slow consumer surfaces
                # the error instead of thrashing subscribe/shed cycles.
                retries += 1
                if self.query_id is None or retries > self._max_retries:
                    raise
                await asyncio.sleep(next(boff))
            except (aiohttp.ClientError, asyncio.TimeoutError, ClientError,
                    StreamReset, ConnectionError):
                # a mid-request agent restart lands here as a TYPED
                # retryable error (the h2 session's wait_for + the
                # transport error set — never a hang); past the retry
                # cap it surfaces to the caller (pinned in
                # tests/test_chaos.py)
                retries += 1
                if self.query_id is None or retries > self._max_retries:
                    raise
                await asyncio.sleep(next(boff))

    async def _connect_once(self):
        s = await self.client._ensure()
        if self.query_id is not None:
            url = f"{self.client.base}/v1/subscriptions/{self.query_id}"
            params = {}
            if self.last_change_id is not None:
                params["from"] = str(self.last_change_id)
            if self.skip_rows:
                params["skip_rows"] = "true"
            ctx = s.get(url, params=params)
        else:
            params = {}
            if self.skip_rows:
                params["skip_rows"] = "true"
            if self.last_change_id is not None:
                params["from"] = str(self.last_change_id)
            ctx = s.post(
                f"{self.client.base}/v1/subscriptions",
                json=self.statement,
                params=params,
            )
        async with ctx as resp:
            if resp.status >= 400:
                raise ClientError(resp.status, await resp.text())
            qid = resp.headers.get("corro-query-id")
            if qid:
                self.query_id = qid
            # a server ending the stream ALWAYS writes a terminal frame
            # first ({"error": ...} or {"lagging": ...}); a bare EOF
            # means the transport died mid-stream (or a shed laggard's
            # terminal frame could not be delivered through its clogged
            # socket) — treated as a retryable disconnect below, the
            # reference client's hangup-reconnect behavior (sub.rs)
            terminal = False
            async for line in _lines(resp):
                if self.raw:
                    # change lines end `...,<change_id>]}`: track the id
                    # without decoding the event (reconnect still works)
                    if line.startswith('{"change":['):
                        try:
                            self.last_change_id = int(
                                line[:-2].rsplit(",", 1)[1]
                            )
                        except (ValueError, IndexError):
                            pass
                    elif line.startswith('{"lagging":'):
                        raise SubShedError(line)
                    elif line.startswith('{"error":'):
                        terminal = True
                    yield line
                    continue
                ev = json.loads(line)
                if "change" in ev:
                    self.last_change_id = ev["change"][3]
                elif "eoq" in ev and ev["eoq"].get("change_id") is not None:
                    self.last_change_id = ev["eoq"]["change_id"]
                elif "lagging" in ev:
                    raise SubShedError(ev["lagging"])
                elif "error" in ev:
                    terminal = True
                yield ev
            if not terminal and self.query_id is not None:
                raise ConnectionResetError(
                    "subscription stream ended without a terminal frame"
                )


async def _lines(resp) -> AsyncIterator[str]:
    buf = b""
    async for chunk in resp.content.iter_any():
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line.decode()
    if buf.strip():
        yield buf.decode()


async def _body_json(resp) -> Any:
    raw = await resp.text()
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


class CorrosionClient(CorrosionApiClient):
    """API client + a direct read-only sqlite pool over the agent's local
    database file — the reference's `CorrosionClient`
    (`klukai-client/src/lib.rs:365-403`): writes go through the HTTP API
    (the only correct write path), while local reads skip HTTP entirely.
    The consul-sync sidecar is the canonical user.

    The pool holds up to `pool_size` lazily-opened read-only connections
    (reference default 5); `read()` checks one out as a context manager.
    """

    def __init__(
        self,
        addr: str,
        db_path: str,
        token: Optional[str] = None,
        pool_size: int = 5,
    ):
        super().__init__(addr, token=token)
        self.db_path = db_path
        self._pool_size = pool_size
        self._pool: List["sqlite3.Connection"] = []
        self._pool_lock = threading.Lock()

    def _open_read_conn(self):
        import sqlite3

        conn = sqlite3.connect(
            f"file:{self.db_path}?mode=ro",
            uri=True,
            check_same_thread=False,
        )
        conn.row_factory = sqlite3.Row
        return conn

    @contextlib.contextmanager
    def read(self):
        """Check a read-only connection out of the local pool."""
        with self._pool_lock:
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = self._open_read_conn()
        try:
            yield conn
        finally:
            with self._pool_lock:
                if len(self._pool) < self._pool_size:
                    self._pool.append(conn)
                    conn = None
            if conn is not None:
                conn.close()

    def local_query(self, sql: str, params=()) -> List[tuple]:
        """Convenience: run a read-only query against the local db."""
        with self.read() as conn:
            return [tuple(r) for r in conn.execute(sql, params).fetchall()]

    async def close(self) -> None:
        await super().close()
        with self._pool_lock:
            for conn in self._pool:
                conn.close()
            self._pool.clear()
