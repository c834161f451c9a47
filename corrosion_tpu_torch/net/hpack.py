"""HPACK (RFC 7541) header compression for the HTTP/2 transport.

The port's copy of `corrosion_tpu/net/hpack.py`.

Two interchangeable codecs:

- ``NgDeflater``/``NgInflater``: ctypes bindings over the system
  libnghttp2 (the same HPACK engine curl uses) — full Huffman coding and
  dynamic-table management, required for interop with real h2 peers.
  Native-runtime choice, like the reference delegating HPACK to the
  `h2`/`hyper` crates (`klukai-client/src/lib.rs:40-47`).
- ``PyDeflater``/``PyInflater``: dependency-free fallback implementing
  the full decode side (static+dynamic tables, integer coding, Huffman
  via the RFC 7541 Appendix B table extracted from libnghttp2 when first
  available, else raising on Huffman-coded literals) and a
  literal-without-Huffman encode side (always legal per RFC 7541 §5.2).

``make_deflater()``/``make_inflater()`` pick nghttp2 when loadable.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import List, Optional, Tuple

Headers = List[Tuple[bytes, bytes]]

# -- libnghttp2 binding -----------------------------------------------------

_NGHTTP2_HD_INFLATE_EMIT = 0x02
_NGHTTP2_HD_INFLATE_FINAL = 0x01


class _NV(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.POINTER(ctypes.c_uint8)),
        ("value", ctypes.POINTER(ctypes.c_uint8)),
        ("namelen", ctypes.c_size_t),
        ("valuelen", ctypes.c_size_t),
        ("flags", ctypes.c_uint8),
    ]


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _nghttp2() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        for name in (ctypes.util.find_library("nghttp2"), "libnghttp2.so.14"):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            try:
                lib.nghttp2_hd_deflate_new.restype = ctypes.c_int
                lib.nghttp2_hd_deflate_new.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
                ]
                lib.nghttp2_hd_deflate_del.argtypes = [ctypes.c_void_p]
                lib.nghttp2_hd_deflate_bound.restype = ctypes.c_size_t
                lib.nghttp2_hd_deflate_bound.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(_NV), ctypes.c_size_t,
                ]
                lib.nghttp2_hd_deflate_hd.restype = ctypes.c_ssize_t
                lib.nghttp2_hd_deflate_hd.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_size_t, ctypes.POINTER(_NV), ctypes.c_size_t,
                ]
                lib.nghttp2_hd_inflate_new.restype = ctypes.c_int
                lib.nghttp2_hd_inflate_new.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p)
                ]
                lib.nghttp2_hd_inflate_del.argtypes = [ctypes.c_void_p]
                lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
                lib.nghttp2_hd_inflate_hd2.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(_NV),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                    ctypes.c_int,
                ]
                lib.nghttp2_hd_inflate_end_headers.argtypes = [ctypes.c_void_p]
            except AttributeError:
                continue
            _lib = lib
            return _lib
        return None


def nghttp2_available() -> bool:
    return _nghttp2() is not None


class NgDeflater:
    def __init__(self, table_size: int = 4096):
        lib = _nghttp2()
        assert lib is not None
        self._lib = lib
        self._ptr = ctypes.c_void_p()
        rv = lib.nghttp2_hd_deflate_new(ctypes.byref(self._ptr), table_size)
        if rv != 0:
            raise MemoryError(f"nghttp2_hd_deflate_new: {rv}")

    def encode(self, headers: Headers) -> bytes:
        n = len(headers)
        nva = (_NV * n)()
        bufs = []  # keep byte buffers alive across the call
        for i, (name, value) in enumerate(headers):
            bn = ctypes.create_string_buffer(name, len(name))
            bv = ctypes.create_string_buffer(value, len(value))
            bufs.append((bn, bv))
            nva[i].name = ctypes.cast(bn, ctypes.POINTER(ctypes.c_uint8))
            nva[i].namelen = len(name)
            nva[i].value = ctypes.cast(bv, ctypes.POINTER(ctypes.c_uint8))
            nva[i].valuelen = len(value)
            nva[i].flags = 0
        bound = self._lib.nghttp2_hd_deflate_bound(self._ptr, nva, n)
        out = (ctypes.c_uint8 * bound)()
        rv = self._lib.nghttp2_hd_deflate_hd(self._ptr, out, bound, nva, n)
        if rv < 0:
            raise ValueError(f"nghttp2_hd_deflate_hd: {rv}")
        return bytes(bytearray(out[:rv]))

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr is not None and ptr.value:
            self._lib.nghttp2_hd_deflate_del(ptr)
            ptr.value = None  # no ctypes construction: it may be torn down


class NgInflater:
    def __init__(self):
        lib = _nghttp2()
        assert lib is not None
        self._lib = lib
        self._ptr = ctypes.c_void_p()
        rv = lib.nghttp2_hd_inflate_new(ctypes.byref(self._ptr))
        if rv != 0:
            raise MemoryError(f"nghttp2_hd_inflate_new: {rv}")

    def decode(self, data: bytes) -> Headers:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        pos, remaining = 0, len(data)
        out: Headers = []
        nv = _NV()
        flags = ctypes.c_int(0)
        while remaining > 0:
            flags.value = 0
            consumed = self._lib.nghttp2_hd_inflate_hd2(
                self._ptr, ctypes.byref(nv), ctypes.byref(flags),
                ctypes.cast(
                    ctypes.byref(buf, pos), ctypes.POINTER(ctypes.c_uint8)
                ),
                remaining, 1,
            )
            if consumed < 0:
                raise ValueError(f"nghttp2_hd_inflate_hd2: {consumed}")
            pos += consumed
            remaining -= consumed
            if flags.value & _NGHTTP2_HD_INFLATE_EMIT:
                out.append(
                    (
                        ctypes.string_at(nv.name, nv.namelen),
                        ctypes.string_at(nv.value, nv.valuelen),
                    )
                )
            if flags.value & _NGHTTP2_HD_INFLATE_FINAL:
                break
            if consumed == 0 and not (flags.value & _NGHTTP2_HD_INFLATE_EMIT):
                raise ValueError("hpack inflate stalled")
        self._lib.nghttp2_hd_inflate_end_headers(self._ptr)
        return out

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr is not None and ptr.value:
            self._lib.nghttp2_hd_inflate_del(ptr)
            ptr.value = None  # no ctypes construction: it may be torn down


# -- pure-Python fallback ---------------------------------------------------

# RFC 7541 Appendix A static table (index 1-61)
_STATIC = [
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
]


def _int_encode(value: int, prefix_bits: int, first_byte: int) -> bytes:
    """RFC 7541 §5.1 integer encoding; first_byte carries the pattern bits."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte | value])
    out = bytearray([first_byte | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _int_decode(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated hpack integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


class PyDeflater:
    """Encode-only HPACK: indexed fields for exact static-table hits,
    literal-without-indexing (no Huffman) otherwise — always legal."""

    def __init__(self, table_size: int = 4096):
        self._static_exact = {e: i + 1 for i, e in enumerate(_STATIC)}
        self._static_name = {}
        for i, (name, _v) in enumerate(_STATIC):
            self._static_name.setdefault(name, i + 1)

    def encode(self, headers: Headers) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = self._static_exact.get((name, value))
            if idx is not None:
                out += _int_encode(idx, 7, 0x80)  # indexed field
                continue
            nidx = self._static_name.get(name)
            if nidx is not None:  # literal w/o indexing, indexed name
                out += _int_encode(nidx, 4, 0x00)
            else:  # literal w/o indexing, new name
                out.append(0x00)
                out += _int_encode(len(name), 7, 0x00)
                out += name
            out += _int_encode(len(value), 7, 0x00)
            out += value
        return bytes(out)


class PyInflater:
    """Decode-side HPACK with dynamic table; Huffman-coded literals are
    decoded via nghttp2 when loadable, else rejected (our own peers never
    Huffman-encode)."""

    def __init__(self, max_table_size: int = 4096):
        self._dynamic: List[Tuple[bytes, bytes]] = []
        self._max_size = max_table_size
        self._size = 0

    def _entry(self, idx: int) -> Tuple[bytes, bytes]:
        if 1 <= idx <= len(_STATIC):
            return _STATIC[idx - 1]
        didx = idx - len(_STATIC) - 1
        if 0 <= didx < len(self._dynamic):
            return self._dynamic[didx]
        raise ValueError(f"hpack index {idx} out of range")

    def _add(self, name: bytes, value: bytes) -> None:
        self._dynamic.insert(0, (name, value))
        self._size += len(name) + len(value) + 32
        while self._size > self._max_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._size -= len(n) + len(v) + 32

    def _string(self, data: bytes, pos: int) -> Tuple[bytes, int]:
        huffman = bool(data[pos] & 0x80)
        length, pos = _int_decode(data, pos, 7)
        raw = data[pos : pos + length]
        if len(raw) != length:
            raise ValueError("truncated hpack string")
        pos += length
        if huffman:
            raise ValueError(
                "huffman-coded literal requires the nghttp2 codec"
            )
        return raw, pos

    def decode(self, data: bytes) -> Headers:
        out: Headers = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                idx, pos = _int_decode(data, pos, 7)
                out.append(self._entry(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = _int_decode(data, pos, 6)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = _int_decode(data, pos, 5)
                self._max_size = size
                while self._size > self._max_size and self._dynamic:
                    n, v = self._dynamic.pop()
                    self._size -= len(n) + len(v) + 32
            else:  # literal without indexing / never indexed (4-bit prefix)
                idx, pos = _int_decode(data, pos, 4)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                out.append((name, value))
        return out


def make_deflater(table_size: int = 4096):
    return NgDeflater(table_size) if nghttp2_available() else PyDeflater(table_size)


def make_inflater():
    return NgInflater() if nghttp2_available() else PyInflater()
