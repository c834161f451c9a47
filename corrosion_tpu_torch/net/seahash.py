"""SeaHash (64-bit, portable) — the packet-integrity tag of the
reference's plaintext QUIC session.

The port's copy of `corrosion_tpu/net/seahash.py`.

The reference seals every plaintext-crypto QUIC packet with an 8-byte
big-endian SeaHash of the Rust ``Hash`` stream of (header, payload)
(`quinn_plaintext.rs:289-329`: ``header.hash(h); payload.hash(h)`` with a
``SeaHasher``, checked on decrypt).  To interoperate we need the same
function, so this is SeaHash implemented from its published algorithm
(the ``seahash`` crate documents it in full; the design is ticki's):

- state: four u64 lanes seeded with fixed constants
- input is consumed as little-endian u64 words, round-robin across
  lanes: ``lane ^= word; lane = diffuse(lane)``
- a trailing partial word (< 8 bytes) is zero-padded and folded into the
  next lane in sequence
- ``finish = diffuse(a ^ b ^ c ^ d ^ total_bytes_written)``
- ``diffuse(x)``: multiply by 0x6eed0e9da4d94a4f, ``x ^= (x >> 32) >>
  (x >> 60)``, multiply again (all wrapping u64)

Rust's ``Hash for [u8]`` feeds the hasher ``usize`` length prefix then
the raw bytes; the crate implements the integer ``write_*`` methods as
little-endian byte writes into the same stream.  ``tag()`` below
reproduces that exact stream: ``LE8(len(header)) ‖ header ‖
LE8(len(payload)) ‖ payload``.

Fidelity note: validated against the seahash crate's published test
vectors (see tests/test_quic.py); the streaming-vs-buffered equivalence
is by construction (32-byte blocks are exactly one lane rotation).
"""

from __future__ import annotations

import struct

_M = 0xFFFFFFFFFFFFFFFF
_P = 0x6EED0E9DA4D94A4F
_K = (
    0x16F11FE89B0D677C,
    0xB480A793D8E6C86C,
    0x6FE2E5AAF078EBC9,
    0x14F994A4C5259381,
)


def _diffuse(x: int) -> int:
    x = (x * _P) & _M
    x ^= (x >> 32) >> (x >> 60)
    return (x * _P) & _M


class SeaHasher:
    """Streaming SeaHash over one logical byte stream."""

    __slots__ = ("_lanes", "_i", "_tail", "_written")

    def __init__(self) -> None:
        self._lanes = list(_K)
        self._i = 0
        self._tail = b""
        self._written = 0

    def write(self, data: bytes) -> None:
        self._written += len(data)
        buf = self._tail + data
        n_full = len(buf) // 8
        lanes, i = self._lanes, self._i
        for (word,) in struct.iter_unpack("<Q", buf[: n_full * 8]):
            lanes[i] = _diffuse(lanes[i] ^ word)
            i = (i + 1) & 3
        self._i = i
        self._tail = buf[n_full * 8 :]

    def write_u64le(self, n: int) -> None:
        self.write(struct.pack("<Q", n))

    def finish(self) -> int:
        a, b, c, d = self._lanes
        if self._tail:
            word = int.from_bytes(self._tail, "little")
            lanes = [a, b, c, d]
            lanes[self._i] = _diffuse(lanes[self._i] ^ word)
            a, b, c, d = lanes
        return _diffuse(a ^ b ^ c ^ d ^ self._written)


def hash_bytes(data: bytes) -> int:
    """The crate's ``seahash::hash``: one unprefixed buffer."""
    h = SeaHasher()
    h.write(data)
    return h.finish()


def tag(header: bytes, payload: bytes) -> bytes:
    """8-byte big-endian packet tag, matching the reference's
    ``header.hash(&mut SeaHasher); payload.hash(...)`` stream
    (`quinn_plaintext.rs:294-300`)."""
    h = SeaHasher()
    h.write_u64le(len(header))
    h.write(header)
    h.write_u64le(len(payload))
    h.write(payload)
    return struct.pack(">Q", h.finish())
