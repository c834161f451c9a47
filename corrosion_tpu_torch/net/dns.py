"""Bootstrap address resolution, including the `host:port@dns_server`
custom-resolver syntax.

The port's copy of `corrosion_tpu/net/dns.py`.

Counterpart of `klukai-agent/src/agent/bootstrap.rs:60-156`: each
bootstrap entry may be
  - `ip:port`                      — used as-is,
  - `host:port`                    — resolved via the system resolver
                                     (A + AAAA),
  - `host:port@dns_ip[:dns_port]`  — resolved by querying that DNS server
                                     directly (the reference builds a
                                     hickory resolver pointed at it).

The custom-server path speaks minimal DNS over UDP (one A and one AAAA
query, RD bit set) — no external resolver library in the image.
"""

from __future__ import annotations

import asyncio
import contextlib
import ipaddress
import logging
import secrets
import socket
import struct
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)

DNS_TIMEOUT_S = 3.0

QTYPE_A = 1
QTYPE_AAAA = 28


def split_bootstrap(entry: str) -> Tuple[str, Optional[str]]:
    """`host:port[@dns]` → (host:port, dns or None)."""
    if "@" in entry:
        hostport, dns = entry.split("@", 1)
        return hostport, dns
    return entry, None


def _split_hostport(hostport: str) -> Tuple[str, int]:
    if hostport.startswith("["):  # [v6]:port
        host, _, port = hostport[1:].partition("]:")
        return host, int(port)
    host, _, port = hostport.rpartition(":")
    if not host:
        raise ValueError(f"bootstrap entry {hostport!r} missing port")
    return host, int(port)


def _is_ip(host: str) -> bool:
    try:
        ipaddress.ip_address(host)
        return True
    except ValueError:
        return False


def encode_query(qid: int, name: str, qtype: int) -> bytes:
    """One-question DNS query with RD set."""
    out = struct.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0)
    for label in name.rstrip(".").split("."):
        raw = label.encode("idna") if not label.isascii() else label.encode()
        if not 0 < len(raw) < 64:
            raise ValueError(f"bad DNS label {label!r}")
        out += bytes([len(raw)]) + raw
    out += b"\x00" + struct.pack(">HH", qtype, 1)  # IN
    return out


def _skip_name(buf: bytes, off: int) -> int:
    while True:
        if off >= len(buf):
            raise ValueError("truncated DNS name")
        n = buf[off]
        if n == 0:
            return off + 1
        if n & 0xC0 == 0xC0:  # compression pointer
            return off + 2
        off += 1 + n


def decode_answers(buf: bytes, qid: int, qtype: int) -> List[str]:
    """IP strings from a DNS response's answer section."""
    if len(buf) < 12:
        raise ValueError("short DNS response")
    rid, flags, qd, an, _, _ = struct.unpack(">HHHHHH", buf[:12])
    if rid != qid:
        raise ValueError("DNS response id mismatch")
    if flags & 0x000F != 0:  # RCODE
        return []
    off = 12
    for _ in range(qd):
        off = _skip_name(buf, off) + 4
    out: List[str] = []
    for _ in range(an):
        off = _skip_name(buf, off)
        rtype, _, _, rdlen = struct.unpack(">HHIH", buf[off : off + 10])
        off += 10
        rdata = buf[off : off + rdlen]
        off += rdlen
        if rtype == qtype == QTYPE_A and rdlen == 4:
            out.append(socket.inet_ntop(socket.AF_INET, rdata))
        elif rtype == qtype == QTYPE_AAAA and rdlen == 16:
            out.append(socket.inet_ntop(socket.AF_INET6, rdata))
    return out


class _UdpQuery(asyncio.DatagramProtocol):
    def __init__(self):
        self.reply: asyncio.Future = asyncio.get_event_loop().create_future()

    def datagram_received(self, data, addr):
        if not self.reply.done():
            self.reply.set_result(data)

    def error_received(self, exc):
        if not self.reply.done():
            self.reply.set_exception(exc)


async def query_server(
    dns_host: str, dns_port: int, name: str, qtype: int
) -> List[str]:
    qid = secrets.randbits(16)
    loop = asyncio.get_event_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _UdpQuery, remote_addr=(dns_host, dns_port)
    )
    try:
        transport.sendto(encode_query(qid, name, qtype))
        buf = await asyncio.wait_for(proto.reply, DNS_TIMEOUT_S)
        return decode_answers(buf, qid, qtype)
    finally:
        transport.close()


async def resolve_entry(entry: str) -> List[str]:
    """One bootstrap entry → list of `ip:port` strings (dedup, order
    preserved). Failures resolve to [] and are logged — a dead bootstrap
    entry must not break the announce loop."""
    try:
        hostport, dns = split_bootstrap(entry)
        try:
            host, port = _split_hostport(hostport)
        except ValueError:
            # not host:port shaped — an opaque transport label (e.g. the
            # in-memory test network's "nodeN"); pass through untouched
            return [entry]
        if _is_ip(host):
            return [hostport]
        ips: List[str] = []
        if dns is not None:
            try:
                dns_host, dns_port = _split_hostport(dns)
            except ValueError:
                dns_host, dns_port = dns, 53
            results = await asyncio.gather(
                query_server(dns_host, dns_port, host, QTYPE_A),
                query_server(dns_host, dns_port, host, QTYPE_AAAA),
                return_exceptions=True,
            )
            for qtype, res in zip((QTYPE_A, QTYPE_AAAA), results):
                if isinstance(res, BaseException):
                    log.warning(
                        "DNS query %s (qtype %d) via %s failed: %s",
                        host, qtype, dns, res,
                    )
                else:
                    ips.extend(res)
        else:
            with contextlib.suppress(socket.gaierror):
                infos = await asyncio.get_event_loop().getaddrinfo(
                    host, port, type=socket.SOCK_DGRAM
                )
                ips.extend(info[4][0] for info in infos)
        seen = set()
        out = []
        for ip in ips:
            if ip in seen:
                continue
            seen.add(ip)
            out.append(f"[{ip}]:{port}" if ":" in ip else f"{ip}:{port}")
        return out
    except (ValueError, OSError) as e:
        log.warning("could not resolve bootstrap entry %r: %s", entry, e)
        return []


async def resolve_bootstrap(entries: List[str]) -> List[str]:
    """All entries resolved concurrently so one unreachable DNS server
    can't stall the announce loop beyond a single query timeout."""
    results = await asyncio.gather(
        *(resolve_entry(e) for e in entries)
    )
    out: List[str] = []
    for addrs in results:
        out.extend(addrs)
    return out
