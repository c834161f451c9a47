"""In-memory network: delivery between in-process nodes — the port's copy
of `corrosion_tpu/net/mem.py`.

A `MemNetwork` routes datagrams and streams between registered nodes
with optional per-link latency, loss and partitions, per-node
degradation and zombie endpoints, all drawn from one seeded
`random.Random`, so the same seed and the same sends deliver the same
datagrams. It is the seam the kernel-peer bridge (`models/bridge.py`)
registers simulated members on as virtual peers.

`random` here is the standard library's: the package's own
`corrosion_tpu_torch/random.py` is reached only as
`corrosion_tpu_torch.random`, so the package must be run as modules
(`python -m ...`), never with its directory on `sys.path`.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from corrosion_tpu_torch.net.transport import (
    BiHandler,
    BiStream,
    DatagramHandler,
    Listener,
    Transport,
    TransportError,
    UniHandler,
)

log = logging.getLogger(__name__)

MAX_DATAGRAM = 1452  # quinn datagram ceiling on typical MTU


def _spawn_logged(coro, what: str, src: str, dst: str) -> None:
    """Detached handler delivery that is LOUD on failure: a silent 'Task
    exception was never retrieved' once hid a broken FEED path as a 4x
    convergence slowdown. Shared by all three lanes."""

    async def run():
        try:
            await coro
        except Exception:  # noqa: BLE001
            log.exception("%s handler failed (%s -> %s)", what, src, dst)

    asyncio.ensure_future(run())


@dataclass
class LinkFaults:
    """Per-network fault knobs (applied to every link unless partitioned),
    plus r9 per-NODE asymmetric knobs keyed by addr — the degraded-node
    scenario (one slow/lossy peer among healthy ones) that network-global
    loss/latency cannot express.  Per-node knobs apply to the node's
    OUTBOUND traffic: a degraded node's sends are slow/lossy/duplicated
    while traffic TO it flows normally — the asymmetry Lifeguard
    (arXiv:1707.00788) exploits.  Loss/duplication hit datagrams only
    (streams stay reliable, like real UDP vs TCP); node_latency also
    slows the node's uni/bi stream sends."""

    latency: float = 0.0  # one-way delay seconds
    jitter: float = 0.0
    datagram_loss: float = 0.0  # [0,1) — datagrams only; streams are reliable
    node_latency: Dict[str, float] = field(default_factory=dict)
    # addr -> extra one-way delay (s) on everything the node sends
    node_datagram_loss: Dict[str, float] = field(default_factory=dict)
    # addr -> outbound datagram loss [0,1]; combines with the global
    # loss as max(global, node) — one effective per-datagram probability
    node_duplicate: Dict[str, float] = field(default_factory=dict)
    # addr -> probability an outbound datagram is delivered TWICE
    # (dup-prone NIC/retry pathology; exercises SWIM idempotency)
    link_latency: Dict[Tuple[str, str], float] = field(default_factory=dict)
    # (src, dst) -> extra one-way delay (s) on that DIRECTED link — the
    # geo-latency matrix (r18 chaos): per-region RTTs that neither the
    # global nor the per-node knob can express (a node is "far" from
    # some peers and "near" others).  Composes additively with both.


class _MemBiStream(BiStream):
    def __init__(self, peer_addr: str, net: "MemNetwork"):
        self._peer = peer_addr
        self._net = net
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._closed = False
        self.other: Optional["_MemBiStream"] = None

    async def send(self, payload: bytes) -> None:
        if self._closed or self.other is None:
            raise TransportError("stream closed")
        # the sending side's own addr is the remote end's peer label
        await self._net._delay(self.other._peer, self._peer)
        if self._net._stalled(self.other._peer, self._peer):
            # zombie endpoint: the payload sits in a kernel buffer no
            # stalled event loop will ever read — send() "succeeds",
            # nothing is delivered, the peer's recv() hangs
            return
        self.other._inbox.put_nowait(payload)

    async def recv(self) -> Optional[bytes]:
        item = await self._inbox.get()
        if item is _EOF:
            return None
        return item

    async def finish(self) -> None:
        if self.other is not None and not self.other._closed:
            self.other._inbox.put_nowait(_EOF)

    def close(self) -> None:
        self._closed = True
        self._inbox.put_nowait(_EOF)
        if self.other is not None and not self.other._closed:
            self.other._closed = True
            self.other._inbox.put_nowait(_EOF)

    @property
    def peer(self) -> str:
        return self._peer


_EOF = object()


@dataclass
class _Node:
    on_datagram: DatagramHandler
    on_uni: UniHandler
    on_bi: BiHandler


class MemNetwork:
    """Registry + router. One per simulated cluster."""

    def __init__(self, seed: int = 0, faults: Optional[LinkFaults] = None):
        self._nodes: Dict[str, _Node] = {}
        self._rng = random.Random(seed)
        self.faults = faults or LinkFaults()
        self._partitions: Set[Tuple[str, str]] = set()
        self._down: Set[str] = set()
        self._zombies: Set[str] = set()

    # -- topology faults --------------------------------------------------

    def partition(self, a: str, b: str) -> None:
        self._partitions.add((a, b))
        self._partitions.add((b, a))

    def partition_oneway(self, a: str, b: str) -> None:
        """Asymmetric partition (r18 chaos): a's traffic to b is dropped
        while b still reaches a — the half-open link that makes b keep
        believing a is fine (b's probes go unanswered only one way)."""
        self._partitions.add((a, b))

    def heal(self, a: str, b: str) -> None:
        self._partitions.discard((a, b))
        self._partitions.discard((b, a))

    def take_down(self, addr: str) -> None:
        """Simulate a crashed node: all delivery to it fails."""
        self._down.add(addr)

    def bring_up(self, addr: str) -> None:
        self._down.discard(addr)

    def degrade(
        self,
        addr: str,
        latency: float = 0.0,
        datagram_loss: float = 0.0,
        duplicate: float = 0.0,
    ) -> None:
        """Mark one node flaky WITHOUT taking it down: its outbound
        traffic gets `latency` extra delay, datagrams drop with
        `datagram_loss` and duplicate with `duplicate` (see LinkFaults
        per-node knobs)."""
        self.faults.node_latency[addr] = latency
        self.faults.node_datagram_loss[addr] = datagram_loss
        self.faults.node_duplicate[addr] = duplicate

    def restore(self, addr: str) -> None:
        """Clear a node's degradation (including zombie state)."""
        self.faults.node_latency.pop(addr, None)
        self.faults.node_datagram_loss.pop(addr, None)
        self.faults.node_duplicate.pop(addr, None)
        self._zombies.discard(addr)

    def zombie(self, addr: str) -> None:
        """Mark a node a ZOMBIE (r18 chaos): its process looks alive at
        the transport layer — connections are accepted, streams open,
        sends land in its kernel buffers — but its event loop is stalled,
        so no handler ever runs and no byte ever comes back.  Distinct
        from `take_down` (connection refused) and `degrade` (slow but
        answering): the zombie is the peer that makes unbounded
        `await stream.recv()` hang forever — the bug class the
        timeout-discipline rule exists for.  Cleared by `restore`."""
        self._zombies.add(addr)

    def is_zombie(self, addr: str) -> bool:
        return addr in self._zombies

    def set_link_latency(
        self, a: str, b: str, secs: float, symmetric: bool = True
    ) -> None:
        """Set the geo-matrix delay of the a→b link (and b→a when
        symmetric).  0 clears the entry."""
        for pair in ((a, b), (b, a)) if symmetric else ((a, b),):
            if secs > 0:
                self.faults.link_latency[pair] = secs
            else:
                self.faults.link_latency.pop(pair, None)

    def clear_link_latency(self) -> None:
        self.faults.link_latency.clear()

    def _reachable(self, src: str, dst: str) -> bool:
        if dst in self._down or src in self._down:
            return False
        if (src, dst) in self._partitions:
            return False
        return dst in self._nodes

    def _stalled(self, src: str, dst: str) -> bool:
        """True when delivery src→dst must be silently withheld because
        one endpoint is a zombie: a stalled receiver never drains its
        socket, a stalled sender never writes to its own."""
        return src in self._zombies or dst in self._zombies

    async def _delay(
        self, src: Optional[str] = None, dst: Optional[str] = None
    ) -> None:
        f = self.faults
        extra = f.node_latency.get(src, 0.0) if src else 0.0
        if src and dst:
            extra += f.link_latency.get((src, dst), 0.0)
        if f.latency or f.jitter or extra:
            await asyncio.sleep(
                f.latency + extra + self._rng.random() * f.jitter
            )
        else:
            await asyncio.sleep(0)

    # -- node registration -------------------------------------------------

    def listener(self, addr: str) -> "MemListener":
        return MemListener(addr, self)

    def transport(self, addr: str) -> "MemTransport":
        return MemTransport(addr, self)


class MemListener(Listener):
    def __init__(self, addr: str, net: MemNetwork):
        self._addr = addr
        self._net = net

    def serve(self, on_datagram, on_uni, on_bi) -> None:
        self._net._nodes[self._addr] = _Node(on_datagram, on_uni, on_bi)

    @property
    def addr(self) -> str:
        return self._addr

    async def close(self) -> None:
        self._net._nodes.pop(self._addr, None)


class MemTransport(Transport):
    def __init__(self, src: str, net: MemNetwork):
        self._src = src
        self._net = net

    async def send_datagram(self, addr: str, data: bytes) -> None:
        if len(data) > MAX_DATAGRAM:
            raise TransportError(f"datagram too large: {len(data)}")
        net = self._net
        if not net._reachable(self._src, addr):
            return  # datagrams are fire-and-forget: silent loss
        # one effective loss probability: global iid floor raised by the
        # sender's per-node outbound loss (degraded-node asymmetry)
        loss = max(
            net.faults.datagram_loss,
            net.faults.node_datagram_loss.get(self._src, 0.0),
        )
        if loss and net._rng.random() < loss:
            return
        if net._stalled(self._src, addr):
            return  # zombie endpoint: datagrams die in a stalled socket
        node = net._nodes[addr]
        src = self._src

        async def deliver():
            await net._delay(src, addr)
            await node.on_datagram(src, data)

        # detached delivery like real UDP: the sender never blocks on the
        # receiver's handler (RTT is observed by the SWIM ack path instead)
        _spawn_logged(deliver(), "datagram", self._src, addr)
        dup = net.faults.node_duplicate.get(self._src, 0.0)
        if dup and net._rng.random() < dup:

            async def deliver_again():
                await net._delay(src, addr)
                await node.on_datagram(src, data)

            _spawn_logged(deliver_again(), "datagram-dup", self._src, addr)

    async def send_uni(self, addr: str, payload: bytes) -> None:
        net = self._net
        if not net._reachable(self._src, addr):
            raise TransportError(f"unreachable: {addr}")
        node = net._nodes[addr]
        start = time.monotonic()
        await net._delay(self._src, addr)
        if net._stalled(self._src, addr):
            # zombie endpoint: the stream opens (no error — the kernel
            # accepts), the payload is never read
            return
        # deliver as an independent task, like a uni-stream read loop
        _spawn_logged(node.on_uni(self._src, payload), "uni", self._src, addr)
        self.observe_rtt(addr, 2 * (time.monotonic() - start))

    async def open_bi(self, addr: str) -> BiStream:
        net = self._net
        if not net._reachable(self._src, addr):
            raise TransportError(f"unreachable: {addr}")
        node = net._nodes[addr]
        local = _MemBiStream(addr, net)
        remote = _MemBiStream(self._src, net)
        local.other, remote.other = remote, local
        await net._delay(self._src, addr)
        if net._stalled(self._src, addr):
            # zombie endpoint: the TCP/QUIC handshake is answered by the
            # kernel of the stalled process, so open_bi SUCCEEDS — but
            # the application handler never runs.  The caller gets a
            # stream that accepts sends and never answers: exactly the
            # peer shape that must trip recv deadlines + the PeerCircuit
            # breaker, never stall a sync round.
            return local
        _spawn_logged(node.on_bi(remote), "bi", self._src, addr)
        return local
