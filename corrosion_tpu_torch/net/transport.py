"""Transport seam: datagram / uni-stream / bi-stream — the port's copy of
`corrosion_tpu/net/transport.py`.

The runtime only ever calls `send_datagram` (SWIM), `send_uni`
(broadcast) and `open_bi` (sync); server-side, a `Listener` receives the
three lanes as callbacks. Addresses are plain strings (opaque labels on
the in-memory network).
"""

from __future__ import annotations

import abc
from typing import Awaitable, Callable, Optional

from corrosion_tpu_torch.runtime.metrics import METRICS


class TransportError(Exception):
    pass


class BiStream(abc.ABC):
    """One bidirectional framed stream (sync session lane)."""

    @abc.abstractmethod
    async def send(self, payload: bytes) -> None: ...

    @abc.abstractmethod
    async def recv(self) -> Optional[bytes]:
        """Next frame, or None once the peer finished its side."""

    @abc.abstractmethod
    async def finish(self) -> None:
        """Half-close our send side."""

    @abc.abstractmethod
    def close(self) -> None:
        """Tear down both directions."""

    @property
    @abc.abstractmethod
    def peer(self) -> str: ...


# server-side lane handlers
DatagramHandler = Callable[[str, bytes], Awaitable[None]]
UniHandler = Callable[[str, bytes], Awaitable[None]]  # one frame at a time
BiHandler = Callable[[BiStream], Awaitable[None]]


class Listener(abc.ABC):
    """Server half: owns the bound address and dispatches the three lanes."""

    @abc.abstractmethod
    def serve(
        self,
        on_datagram: DatagramHandler,
        on_uni: UniHandler,
        on_bi: BiHandler,
    ) -> None: ...

    @property
    @abc.abstractmethod
    def addr(self) -> str: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class Transport(abc.ABC):
    """Client half: the only networking surface the runtime consumes."""

    @abc.abstractmethod
    async def send_datagram(self, addr: str, data: bytes) -> None: ...

    @abc.abstractmethod
    async def send_uni(self, addr: str, payload: bytes) -> None: ...

    @abc.abstractmethod
    async def open_bi(self, addr: str) -> BiStream: ...

    async def close(self) -> None:  # pragma: no cover - trivial default
        pass

    def observe_rtt(self, addr: str, rtt: float) -> None:
        """One round-trip observation: the RTT histogram, and the sink
        (the agent's member RTT rings) when one is set."""
        METRICS.histogram("corro.transport.rtt.seconds", addr=addr).observe(rtt)
        if self._rtt_sink is not None:
            self._rtt_sink(addr, rtt)

    _rtt_sink: Optional[Callable[[str, float], None]] = None

    def set_rtt_sink(self, sink: Callable[[str, float], None]) -> None:
        self._rtt_sink = sink
