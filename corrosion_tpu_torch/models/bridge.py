"""Kernel-peer bridge: the members of a simulated cluster as virtual SWIM
peers — the port's copy of `corrosion_tpu/models/bridge.py`, over the
port's `ClusterSim` on the card.

A `KernelPeerBridge` registers every member j of a `models/cluster.py`
`ClusterSim` as the address `sim:<j>` on a `MemNetwork`, and answers a
real node's SWIM datagrams (`net/gossip_codec.py`) from the kernel's
ground truth:

- PING → ACK iff `alive[j]`: a crashed simulated member goes silent like
  a crashed process, so the real node's own probe and suspicion find it;
- ANNOUNCE → FEED with a packet-budgeted sample of virtual members;
- every reply piggybacks virtual-member updates (changed members first,
  then a rotating sweep), so a real node's member table absorbs a
  10^3–10^5-member population through the normal SWIM channel;
- PING_REQ / INDIRECT_PING / INDIRECT_ACK are answered through the same
  lookup, or relayed when the target is not virtual.

Replies are served from a host snapshot of the two [N] ground-truth
tensors: `refresh()` copies `alive` and `inc` off the device (two
device-to-host copies) after `sim.step()` / crashes, and every datagram
indexes those numpy arrays, so serving does no device work and no device
sync.

Membership is one-directional: real nodes track the simulated
population; the fixed-shape kernel grows no rows for them.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from corrosion_tpu_torch.net.gossip_codec import (
    MemberState,
    MemberUpdate,
    MsgKind,
    SwimMessage,
    decode_swim,
    encode_swim,
    fill_updates,
)
from corrosion_tpu_torch.types.actor import Actor, ActorId, ClusterId
from corrosion_tpu_torch.types.base import Timestamp


def sim_actor_id(j: int) -> ActorId:
    """Deterministic 16-byte id for virtual member j."""
    return ActorId(b"SIM" + j.to_bytes(13, "big"))


class KernelPeerBridge:
    """Registers kernel members as `sim:<j>` peers on a network.

    `net` is any object with the `MemNetwork` surface (`listener(addr)`,
    `transport(addr)`): the port's `net/mem.py`, or another in-memory
    network a caller's nodes already live on."""

    piggyback = 24  # updates offered per reply (fill_updates caps them)
    prefix = "sim"
    cluster_id = ClusterId(0)

    def __init__(self, net, sim, gossip_down: bool = True):
        # gossip_down=False keeps the bridge silent about dead members
        # (like peers that haven't detected yet): the real agent must
        # then find them with its OWN probe/suspicion pipeline
        self.net = net
        self.sim = sim
        self.gossip_down = gossip_down
        self.n = sim.params.n
        self._alive: Optional[np.ndarray] = None
        self._inc: Optional[np.ndarray] = None
        # hot-update queue: member -> send count (max_transmissions
        # decay); fed by refresh() diffs, drained into every piggyback
        self._hot: Dict[int, int] = {}
        self.max_transmissions = 10
        self._fill_pos = 0  # rotating cursor for the completeness fill
        self._listeners: List = []
        self._actors: Dict[int, Actor] = {}
        self.refresh()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Register every virtual member's address on the network."""
        for j in range(self.n):
            listener = self.net.listener(self.addr(j))

            async def on_datagram(src: str, data: bytes, j=j) -> None:
                await self._handle(j, src, data)

            async def on_uni(src: str, data: bytes) -> None:
                pass  # virtual members don't ingest broadcasts

            async def on_bi(stream) -> None:
                stream.close()

            listener.serve(on_datagram, on_uni, on_bi)
            self._listeners.append(listener)

    async def stop(self) -> None:
        for listener in self._listeners:
            await listener.close()
        self._listeners.clear()

    def refresh(self) -> None:
        """Re-snapshot ground truth from the kernel tensors (call after
        sim.step() / crash / restart): two device-to-host copies, `alive`
        and `inc`. Members whose (alive, inc) changed since the last
        snapshot enter the hot-update queue: piggyback carries fresh
        updates first with a send-count decay, without which a dead
        member's DOWN only reaches a peer by uniform-random luck
        (~n/piggyback replies at scale)."""
        state = self.sim.state
        alive = state.alive.cpu().numpy().astype(bool)
        inc = state.inc.cpu().numpy().astype(np.int32)
        if self._alive is not None:
            changed = np.nonzero(
                (alive != self._alive) | (inc != self._inc)
            )[0]
            for j in changed:
                self._hot[int(j)] = 0  # reset send count
        self._alive = alive
        self._inc = inc

    def crash(self, j: int) -> None:
        self.sim.crash(j)
        self.refresh()

    def restart(self, j: int) -> None:
        self.sim.restart(j)
        self.refresh()

    # -- identity ----------------------------------------------------------

    def addr(self, j: int) -> str:
        return f"{self.prefix}:{j}"

    def actor(self, j: int) -> Actor:
        a = self._actors.get(j)
        if a is None:
            a = Actor(
                id=sim_actor_id(j),
                addr=self.addr(j),
                ts=Timestamp(0),
                cluster_id=self.cluster_id,
                bump=0,
            )
            self._actors[j] = a
        return a

    # -- wire handling -------------------------------------------------------

    def _update_for(self, j: int) -> MemberUpdate:
        return MemberUpdate(
            self.actor(j),
            int(self._inc[j]),
            MemberState.ALIVE if self._alive[j] else MemberState.DOWN,
        )

    def _sample_updates(self, exclude: int) -> List[MemberUpdate]:
        """Piggyback: hot (recently changed) updates first with a
        send-count decay, then a random fill (size-capped by
        fill_updates at send time)."""
        out: List[MemberUpdate] = []
        if self._hot:
            spent = []
            for j, sent in self._hot.items():
                if j == exclude:
                    continue
                if not self._alive[j] and not self.gossip_down:
                    continue
                out.append(self._update_for(j))
                self._hot[j] = sent + 1
                if sent + 1 >= self.max_transmissions:
                    spent.append(j)
                if len(out) >= self.piggyback:
                    break
            for j in spent:
                self._hot.pop(j, None)
        # completeness fill: a rotating cursor sweep (foca's feed sends
        # consecutive member-list snapshots, not uniform samples) — a
        # uniform-random fill left mass absorption with a coupon-collector
        # tail (~n·H(n)/k replies; measured: the last 1% of 100k members
        # took as long as the first 80%)
        budget = self.piggyback - len(out)
        for _ in range(min(self.piggyback * 2, self.n)):
            j = self._fill_pos
            self._fill_pos = (self._fill_pos + 1) % self.n
            if j == exclude:
                continue
            if not self._alive[j] and not self.gossip_down:
                continue
            out.append(self._update_for(j))
            budget -= 1
            if budget <= 0:
                break
        return out

    async def _reply(self, j: int, dst: str, msg: SwimMessage) -> None:
        # exact packet budgeting (incl. target/origin actors) is shared
        # with the agent's announce path: gossip_codec.fill_updates
        fill_updates(msg, self._sample_updates(j))
        transport = self.net.transport(self.addr(j))
        await transport.send_datagram(dst, encode_swim(msg))

    async def _handle(self, j: int, src: str, data: bytes) -> None:
        if not self._alive[j]:
            return  # crashed members are silent
        try:
            msg = decode_swim(data)
        except (ValueError, struct.error):
            return
        me = self.actor(j)
        k = msg.kind
        if k == MsgKind.PING:
            await self._reply(
                j, msg.sender.addr,
                SwimMessage(MsgKind.ACK, msg.probe_no, me),
            )
        elif k == MsgKind.ANNOUNCE:
            await self._reply(
                j, msg.sender.addr,
                SwimMessage(MsgKind.FEED, 0, me),
            )
        elif k == MsgKind.PING_REQ and msg.target is not None:
            # asked to indirect-probe `target` for `sender`: if the target
            # is one of ours, answer from the arrays; else forward a real
            # INDIRECT_PING so mixed topologies keep working
            tj = self._index_of(msg.target.addr)
            if tj is not None:
                if self._alive[tj]:
                    await self._reply(
                        j, msg.sender.addr,
                        SwimMessage(
                            MsgKind.FORWARDED_ACK, msg.probe_no,
                            self.actor(tj), origin=msg.sender,
                        ),
                    )
            else:
                await self._reply(
                    j, msg.target.addr,
                    SwimMessage(
                        MsgKind.INDIRECT_PING, msg.probe_no, me,
                        target=msg.target, origin=msg.sender,
                    ),
                )
        elif k == MsgKind.INDIRECT_PING and msg.origin is not None:
            await self._reply(
                j, msg.sender.addr,
                SwimMessage(
                    MsgKind.INDIRECT_ACK, msg.probe_no, me,
                    origin=msg.origin,
                ),
            )
        elif k == MsgKind.INDIRECT_ACK and msg.origin is not None:
            # the relay leg back: a REAL target we indirect-probed on a
            # real agent's behalf answered — forward it as
            # agent/membership.py's helper path does, else the origin
            # falsely suspects a live peer
            await self._reply(
                j, msg.origin.addr,
                SwimMessage(
                    MsgKind.FORWARDED_ACK, msg.probe_no, me,
                    target=msg.sender,
                ),
            )
        # ACK / FEED / LEAVE / FORWARDED_ACK aimed at a virtual member
        # need no reaction: the kernel's own protocol state advances in
        # sim.step(), not per packet

    def _index_of(self, addr: str) -> Optional[int]:
        if not addr.startswith(self.prefix + ":"):
            return None
        try:
            j = int(addr.rsplit(":", 1)[1])
        except ValueError:
            return None
        return j if 0 <= j < self.n else None
