"""Node identity: ActorId (UUID = site id), ClusterId, Actor — the port's
copy of `corrosion_tpu/types/actor.py`.

Counterpart of `klukai-types/src/actor.rs:26,134,219`. An actor's id doubles
as its CRDT site id; the Actor carries a gossip address, an HLC timestamp
(newest timestamp wins address conflicts, `actor.rs:191`), a cluster id, and
a bump counter used by `renew()` for auto-rejoin after being declared down
(`actor.rs:199-206`).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field, replace

from corrosion_tpu_torch.types.base import Timestamp


@dataclass(frozen=True, order=True)
class ActorId:
    bytes16: bytes = b"\x00" * 16

    def __post_init__(self):
        if len(self.bytes16) != 16:
            raise ValueError("ActorId must be 16 bytes")

    @classmethod
    def new_random(cls) -> "ActorId":
        return cls(uuid.uuid4().bytes)

    @classmethod
    def from_uuid_str(cls, s: str) -> "ActorId":
        return cls(uuid.UUID(s).bytes)

    @classmethod
    def zero(cls) -> "ActorId":
        return cls(b"\x00" * 16)

    def as_uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=self.bytes16)

    def __str__(self) -> str:
        return str(self.as_uuid())


@dataclass(frozen=True, order=True)
class ClusterId:
    value: int = 0  # u16

    def __post_init__(self):
        if not (0 <= self.value <= 0xFFFF):
            raise ValueError("ClusterId must fit u16")


@dataclass(frozen=True)
class Actor:
    id: ActorId
    addr: str  # "host:port" gossip address
    ts: Timestamp = field(default_factory=Timestamp.zero)
    cluster_id: ClusterId = field(default_factory=ClusterId)
    bump: int = 0  # u16 renewal counter

    def renew(self) -> "Actor":
        """New identity for rejoin after being declared down (actor.rs:199)."""
        return replace(self, ts=Timestamp.now(), bump=(self.bump + 1) & 0xFFFF)
