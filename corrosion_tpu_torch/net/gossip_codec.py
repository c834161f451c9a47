"""SWIM datagram wire format: the port's copy of
`corrosion_tpu/net/gossip_codec.py`, byte for byte.

A header (message kind, probe number, sender Actor), optional target and
origin Actors (indirect probes), a piggybacked list of membership
updates, and an opaque trailing telemetry digest behind a version byte
(written only when a digest rides along, so digest-free packets keep
the layout without it). Packets stay under the SWIM packet budget of
1178 B.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

from corrosion_tpu_torch.types.actor import Actor, ActorId, ClusterId
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.codec import Reader, Writer

MAX_PACKET = 1178


class MsgKind(IntEnum):
    PING = 0
    ACK = 1
    PING_REQ = 2  # ask a third party to probe target for us
    INDIRECT_PING = 3  # the third party's probe, carries origin
    INDIRECT_ACK = 4  # target's reply routed back via the third party
    FORWARDED_ACK = 5  # third party forwarding the ack to the origin
    ANNOUNCE = 6  # join request
    FEED = 7  # membership snapshot reply to an announce
    LEAVE = 8  # graceful departure


class MemberState(IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DOWN = 2


@dataclass(frozen=True)
class MemberUpdate:
    """One piggybacked membership assertion."""

    actor: Actor
    incarnation: int
    state: MemberState


@dataclass
class SwimMessage:
    kind: MsgKind
    probe_no: int
    sender: Actor
    target: Optional[Actor] = None  # PING_REQ/INDIRECT_*: who to probe
    origin: Optional[Actor] = None  # INDIRECT_*: who asked
    updates: List[MemberUpdate] = field(default_factory=list)
    digest: Optional[bytes] = None  # opaque trailing ext


# trailing-ext version byte (only written when a digest rides along)
_SWIM_EXT_V1 = 1


def write_actor(w: Writer, a: Actor) -> None:
    w.raw(a.id.bytes16)
    w.string(a.addr)
    w.u64(a.ts.ntp64)
    w.u16(a.cluster_id.value)
    w.u16(a.bump)


def read_actor(r: Reader) -> Actor:
    id_ = ActorId(bytes(r.raw(16)))
    addr = r.string()
    ts = Timestamp(r.u64())
    cluster_id = ClusterId(r.u16())
    bump = r.u16()
    return Actor(id=id_, addr=addr, ts=ts, cluster_id=cluster_id, bump=bump)


def actor_wire_size(a: Actor) -> int:
    return 16 + 4 + len(a.addr.encode()) + 8 + 2 + 2


def update_wire_size(u: MemberUpdate) -> int:
    return actor_wire_size(u.actor) + 4 + 1


def fill_updates(msg: SwimMessage, sample) -> None:
    """Append updates from `sample`, in order, while the encoded packet
    stays under MAX_PACKET (budgeted off the actual encoded size, so
    target/origin actors are counted exactly)."""
    budget = MAX_PACKET - len(encode_swim(msg)) - 8
    for u in sample:
        size = update_wire_size(u)
        if budget - size < 0:
            break
        msg.updates.append(u)
        budget -= size


def encode_swim(msg: SwimMessage) -> bytes:
    w = Writer()
    w.u8(int(msg.kind))
    w.u32(msg.probe_no)
    write_actor(w, msg.sender)
    w.opt(msg.target, lambda a: write_actor(w, a))
    w.opt(msg.origin, lambda a: write_actor(w, a))
    w.u16(len(msg.updates))
    for u in msg.updates:
        write_actor(w, u.actor)
        w.u32(u.incarnation)
        w.u8(int(u.state))
    if msg.digest is not None:
        w.u8(_SWIM_EXT_V1)
        w.vec_u8(msg.digest)
    return w.bytes()


def decode_swim(data: bytes) -> SwimMessage:
    """Raises ValueError on bytes that are not a SWIM datagram."""
    r = Reader(data)
    kind = MsgKind(r.u8())
    probe_no = r.u32()
    sender = read_actor(r)
    target = read_actor(r) if r.u8() else None
    origin = read_actor(r) if r.u8() else None
    n = r.u16()
    updates = [
        MemberUpdate(read_actor(r), r.u32(), MemberState(r.u8()))
        for _ in range(n)
    ]
    digest = None
    if not r.eof() and r.u8() >= _SWIM_EXT_V1 and not r.eof():
        digest = r.vec_u8()
    return SwimMessage(
        kind=kind,
        probe_no=probe_no,
        sender=sender,
        target=target,
        origin=origin,
        updates=updates,
        digest=digest,
    )
