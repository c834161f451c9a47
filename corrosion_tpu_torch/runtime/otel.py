"""OTLP/HTTP span export — closes the reference's OpenTelemetry gap.

The reference wires an OTLP exporter + batch span processor behind
`config.telemetry.open-telemetry` (`klukai/src/main.rs:68-118`: tonic
exporter, resource attrs service.name/service.version/host.name, batch
export).  This image ships no OTel SDK, but OTLP/HTTP has a stable JSON
protobuf mapping (opentelemetry-proto, `trace_service.proto` — trace and
span ids are HEX strings in the JSON encoding, nanosecond timestamps are
decimal strings), so the exporter here speaks it directly over
`urllib.request` with zero dependencies:

    POST {endpoint}/v1/traces   Content-Type: application/json
    {"resourceSpans": [{"resource": {...}, "scopeSpans":
        [{"scope": {"name": "corrosion-tpu"}, "spans": [...]}]}]}

Design (mirrors the reference's BatchSpanProcessor semantics):
- finished spans are enqueued onto a bounded deque (drop-oldest, the drop
  counted in `corro_otel_spans_dropped_total`) — tracing must never block
  or grow without bound when the collector is away;
- a daemon thread flushes every `flush_interval_s` or as soon as
  `batch_max` spans are queued, whichever first;
- export failures are counted (`corro_otel_export_failures_total`) and
  the batch is dropped, not retried forever — matching the SDK's
  fire-and-forget batch processor;
- `configure()` is opt-in via config/env; when unconfigured, the hot-path
  hook (`record_span`) is a single global None-check.

The port's copy of `corrosion_tpu/runtime/otel.py`. Nothing in the
port configures it from the environment: the caller (a test, a chip
phase) calls `configure(endpoint)` itself.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import urllib.request
from collections import deque
from typing import Dict, List, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS

log = logging.getLogger(__name__)

_VERSION = "0.4.0"


def _attr(key: str, value) -> dict:
    """One OTLP KeyValue in JSON encoding (anyValue by python type)."""
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


class OtlpExporter:
    """Batched OTLP/HTTP JSON span exporter (BatchSpanProcessor analog)."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "corrosion-tpu",
        resource_attrs: Optional[Dict[str, str]] = None,
        queue_max: int = 4096,
        batch_max: int = 512,
        flush_interval_s: float = 5.0,
        timeout_s: float = 10.0,
    ):
        ep = endpoint.rstrip("/")
        # OTEL_EXPORTER_OTLP_ENDPOINT is a base URL; the traces signal
        # path is appended unless the caller already gave the full path
        self.url = ep if ep.endswith("/v1/traces") else ep + "/v1/traces"
        self.timeout_s = timeout_s
        self.batch_max = batch_max
        self.flush_interval_s = flush_interval_s
        attrs = {
            "service.name": service_name,
            "service.version": _VERSION,
            "host.name": socket.gethostname(),
        }
        attrs.update(resource_attrs or {})
        self._resource = {"attributes": [_attr(k, v) for k, v in attrs.items()]}
        self._queue: deque = deque(maxlen=queue_max)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="otlp-export", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def record(self, span: dict) -> None:
        """Enqueue one finished span (already in OTLP JSON span form)."""
        with self._lock:
            if len(self._queue) == self._queue.maxlen:
                METRICS.counter("corro_otel_spans_dropped_total").inc()
            self._queue.append(span)
            full = len(self._queue) >= self.batch_max
        if full:
            self._wake.set()

    # -- consumer side -----------------------------------------------------

    def _drain(self) -> List[dict]:
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
        return batch

    def _export(self, spans: List[dict]) -> bool:
        body = json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": self._resource,
                        "scopeSpans": [
                            {
                                "scope": {
                                    "name": "corrosion-tpu",
                                    "version": _VERSION,
                                },
                                "spans": spans,
                            }
                        ],
                    }
                ]
            }
        ).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                ok = 200 <= resp.status < 300
        except Exception as e:  # noqa: BLE001 — any transport error counts
            log.debug("otlp export failed: %s", e)
            ok = False
        if ok:
            METRICS.counter("corro_otel_spans_exported_total").inc(len(spans))
        else:
            METRICS.counter("corro_otel_export_failures_total").inc()
        return ok

    def _export_chunked(self, batch: List[dict]) -> None:
        # batch_max bounds the REQUEST size, not just the wake trigger: a
        # backlog drained after a collector outage must not become one
        # oversized POST a size-limited collector rejects wholesale
        for i in range(0, len(batch), self.batch_max):
            self._export(batch[i : i + self.batch_max])

    def _run(self) -> None:
        while True:
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            batch = self._drain()
            if batch:
                self._export_chunked(batch)
            if self._closed:
                return

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        """Synchronously export everything queued (tests / shutdown)."""
        batch = self._drain()
        if batch:
            self._export_chunked(batch)

    def shutdown(self) -> None:
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=self.timeout_s + 1.0)
        self.flush()


_EXPORTER: Optional[OtlpExporter] = None


def configure(
    endpoint: Optional[str],
    service_name: str = "corrosion-tpu",
    resource_attrs: Optional[Dict[str, str]] = None,
    **kw,
) -> Optional[OtlpExporter]:
    """Install (or, with endpoint=None, uninstall) the global exporter.

    Call sites pass `config.telemetry.open_telemetry_endpoint`; the CLI
    agent entrypoint (`cli.py:_cmd_agent`) additionally falls back to the
    standard OTEL_EXPORTER_OTLP_ENDPOINT env var so deployments can turn
    tracing on without editing TOML (the reference gates identically on
    `config.telemetry.open-telemetry`, `main.rs:68-76`).
    """
    global _EXPORTER
    if _EXPORTER is not None:
        _EXPORTER.shutdown()
        _EXPORTER = None
    if endpoint:
        _EXPORTER = OtlpExporter(
            endpoint, service_name=service_name, resource_attrs=resource_attrs,
            **kw,
        )
    return _EXPORTER


def exporter() -> Optional[OtlpExporter]:
    return _EXPORTER


def record_span(
    name: str,
    trace_id: str,
    span_id: str,
    parent_span_id: Optional[str],
    start_ns: int,
    end_ns: int,
    attrs: Dict[str, str],
    error: bool = False,
) -> None:
    """Hot-path hook called by trace.Span.__exit__; no-op when unconfigured."""
    exp = _EXPORTER
    if exp is None:
        return
    span: dict = {
        "traceId": trace_id,
        "spanId": span_id,
        "name": name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": [_attr(k, v) for k, v in attrs.items()],
        "status": {"code": 2} if error else {},  # STATUS_CODE_ERROR
    }
    if parent_span_id:
        span["parentSpanId"] = parent_span_id
    exp.record(span)
