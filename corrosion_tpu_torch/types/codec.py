"""Little-endian byte writer and reader of the wire codecs: the port's
copy of `Writer` and `Reader` from `corrosion_tpu/types/codec.py`, with
the methods the SWIM wire uses (`net/gossip_codec.py`). The change and
changeset codecs are not ported.

Layouts: u16/u32/u64 little-endian fixed width; strings and byte vectors
carry a u32 LE length prefix; an Option is a u8 presence byte.
"""

from __future__ import annotations

import struct


class Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v)

    def raw(self, b: bytes):
        self.buf += b

    def string(self, s: str):
        raw = s.encode("utf-8")
        self.u32(len(raw))
        self.buf += raw

    def vec_u8(self, b: bytes):
        self.u32(len(b))
        self.buf += b

    def opt(self, v, write_fn):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            write_fn(v)

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated buffer")
        mv = self.data[self.pos : self.pos + n]
        self.pos += n
        return mv

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def string(self) -> str:
        return self.raw(self.u32()).decode("utf-8")

    def vec_u8(self) -> bytes:
        return self.raw(self.u32())

    def eof(self) -> bool:
        return self.pos >= len(self.data)
