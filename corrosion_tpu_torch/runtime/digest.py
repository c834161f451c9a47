"""Telemetry digest: the compact per-node snapshot the cluster
observatory gossips (r12).

Each node periodically summarizes its own observability planes into one
`NodeDigest` — membership census + a canonical membership-VIEW hash,
the five cumulative `corro.e2e.*` stage histograms (sparse wire form of
`runtime/latency.py::LatencyHistogram`), kernel event-counter totals,
per-peer sync backlog, and a small health roll-up (LHM, loop lag) — and
disseminates it on the planes the cluster already runs: a version-gated
trailing ext on SWIM datagrams (`net/gossip_codec.py`) and on broadcast
envelopes (`types/codec.py` ext v2).  `agent/observatory.py` is the
anti-entropy layer on top (freshest-per-node wins, bounded staleness,
relay); this module is the pure data + wire codec half.

The port's copy of `corrosion_tpu/runtime/digest.py`: the bytes are the
JAX package's, so port and JAX nodes read each other's digests.

Wire discipline:
  - one leading version byte (`DIGEST_V1`); decoders reject newer
    majors instead of misparsing,
  - LEB128 uvarints everywhere a small integer travels,
  - histograms ride SPARSE and DELTA-ENCODED: occupied log-bucket
    indices as gaps (first index absolute, then index deltas ≥ 1), each
    with its uvarint count — a 5-stage digest of a quiet node is tens
    of bytes, and decode(encode(h)) reproduces the histogram
    bucket-for-bucket, so cross-node aggregation by
    `LatencyHistogram.merge` is EXACT (merge-of-decoded ≡
    decode-of-merged).

The digest is cumulative (not an inter-digest delta): with
freshest-per-node-wins aggregation a lost packet costs staleness, never
correctness — the property the /v1/cluster percentile pins rely on.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from corrosion_tpu_torch.runtime.latency import E2E_STAGES, LatencyHistogram
from corrosion_tpu_torch.types.codec import Reader, Writer

DIGEST_V1 = 1

# r20 alert-summary enum codes (wire form of the trailing alert block)
_SEV_CODE = {"info": 0, "warn": 1, "page": 2}
_SEV_NAME = {v: k for k, v in _SEV_CODE.items()}
_STATE_CODE = {"pending": 1, "firing": 2}
_STATE_NAME = {v: k for k, v in _STATE_CODE.items()}


def view_hash(ids: Iterable[bytes]) -> int:
    """Canonical u64 hash of a membership view: the sorted 16-byte actor
    ids of every ACTIVE member (self included).  Two nodes report the
    same hash iff they agree on who is in the cluster — the divergence
    (split-brain) detector's whole signal, so the canonicalization
    (sort, raw id bytes only, no states) must never drift."""
    h = hashlib.blake2b(digest_size=8)
    for b in sorted(ids):
        if len(b) != 16:
            raise ValueError(f"actor id must be 16 bytes, got {len(b)}")
        h.update(b)
    return int.from_bytes(h.digest(), "big")


@dataclass
class NodeDigest:
    """One node's gossiped telemetry snapshot.  `wall` is the ORIGIN
    node's clock at build time — freshness comparisons are always
    per-node (same clock), so cross-node skew cannot reorder them."""

    actor_id: bytes  # 16 raw bytes
    seq: int  # per-boot monotone build counter
    wall: float  # origin wall clock at snapshot
    view_hash: int  # canonical membership-view hash (u64)
    view_size: int  # active members incl. self
    alive: int = 0
    suspect: int = 0
    downed: int = 0  # remembered DOWN ids (Membership.downed)
    lhm: int = 0  # Lifeguard local-health score
    loop_lag: float = 0.0  # max event-loop lag seconds
    # per-peer sync backlog: origin actor id -> versions still needed
    sync_backlog: Dict[bytes, int] = field(default_factory=dict)
    # r17: total versions this node HOLDS across all origin actors
    # (heads minus gaps minus incomplete partials) — the catch-up
    # plane's freshness signal: peer choice biases toward the highest
    # advertiser and the snapshot-bootstrap gap heuristic compares
    # against it.  Rides as a TRAILING field (old decoders stop before
    # it, new decoders default 0 on eof — the envelope-ext tolerance).
    heads_total: int = 0
    # r20: this node's ACTIVE alerts (runtime/alerts.py
    # `active_summaries`: rule, severity, state pending|firing, since
    # wall, drill flag, trigger value) — how `GET /v1/alerts?scope=
    # cluster` answers from ANY node.  Rides as a second TRAILING
    # block after `heads_total` with the same eof tolerance: old
    # decoders stop before it, new decoders default to [] on eof.
    alerts: List[dict] = field(default_factory=list)
    # r23: this node's top self-time profile frames
    # (runtime/profiler.py `hotspots`: frame display name + sample
    # count) — how `GET /v1/profile?scope=cluster` serves a
    # cluster-scope hotspot table from ANY node.  Third TRAILING block
    # after `alerts`, same eof tolerance; under the wire-budget ladder
    # it is the FIRST tier shed (agent/observatory.py) — profile color
    # yields to view/census core.
    hotspots: List[dict] = field(default_factory=list)
    # device kernel event totals (corro.kernel.events.total), summed
    # across kernels — empty on agents that host no kernel sim
    events: Dict[str, int] = field(default_factory=dict)
    # cumulative corro.e2e.* stage histograms (merged across label sets)
    stages: Dict[str, LatencyHistogram] = field(default_factory=dict)

    def fresher_than(self, other: Optional["NodeDigest"]) -> bool:
        if other is None:
            return True
        return (self.wall, self.seq) > (other.wall, other.seq)


def write_hist(w: Writer, h: LatencyHistogram) -> None:
    pairs, total = h.to_sparse()
    w.uvarint(len(pairs))
    prev = 0
    for i, (idx, count) in enumerate(pairs):
        w.uvarint(idx if i == 0 else idx - prev)  # gap ≥ 1 after first
        w.uvarint(count)
        prev = idx
    w.f64(total)


def read_hist(r: Reader) -> LatencyHistogram:
    n = r.uvarint()
    pairs: List[Tuple[int, int]] = []
    idx = 0
    for i in range(n):
        gap = r.uvarint()
        idx = gap if i == 0 else idx + gap
        pairs.append((idx, r.uvarint()))
    return LatencyHistogram.from_sparse(pairs, r.f64())


def encode_digest(d: NodeDigest) -> bytes:
    w = Writer()
    w.u8(DIGEST_V1)
    w.raw(d.actor_id)
    w.uvarint(d.seq)
    w.f64(d.wall)
    w.u64(d.view_hash)
    w.uvarint(d.view_size)
    w.uvarint(d.alive)
    w.uvarint(d.suspect)
    w.uvarint(d.downed)
    w.uvarint(d.lhm)
    w.f64(d.loop_lag)
    w.uvarint(len(d.sync_backlog))
    for aid, n in sorted(d.sync_backlog.items()):
        w.raw(aid)
        w.uvarint(n)
    w.uvarint(len(d.events))
    for name, v in sorted(d.events.items()):
        w.string(name)
        w.uvarint(v)
    # stages: only non-empty histograms travel, keyed by name so the
    # stage list can grow without a wire break
    present = [
        (s, h) for s, h in sorted(d.stages.items()) if h.count > 0
    ]
    w.uvarint(len(present))
    for stage, h in present:
        w.string(stage)
        write_hist(w, h)
    w.uvarint(d.heads_total)  # r17 trailing field (default_on_eof)
    # r20 trailing alert block (default_on_eof like heads_total): the
    # severity/state string<->code maps live beside the codec so the
    # wire never carries free-form strings for enum fields
    w.uvarint(len(d.alerts))
    for a in d.alerts:
        w.string(a["rule"])
        w.u8(_SEV_CODE.get(a.get("severity", "warn"), 1))
        w.u8(
            _STATE_CODE.get(a.get("state", "firing"), 2)
            | (0x80 if a.get("drill") else 0)
        )
        w.f64(float(a.get("since") or 0.0))
        w.f64(float(a.get("value") or 0.0))
    # r23 trailing hotspot block (default_on_eof like the two above)
    w.uvarint(len(d.hotspots))
    for h in d.hotspots:
        w.string(h["frame"])
        w.uvarint(int(h.get("samples") or 0))
    return w.bytes()


def decode_digest(data: bytes) -> NodeDigest:
    r = Reader(data)
    ver = r.u8()
    if ver != DIGEST_V1:
        raise ValueError(f"unknown digest version {ver}")
    d = NodeDigest(
        actor_id=r.raw(16),
        seq=r.uvarint(),
        wall=r.f64(),
        view_hash=r.u64(),
        view_size=r.uvarint(),
        alive=r.uvarint(),
        suspect=r.uvarint(),
        downed=r.uvarint(),
        lhm=r.uvarint(),
        loop_lag=r.f64(),
    )
    for _ in range(r.uvarint()):
        aid = r.raw(16)
        d.sync_backlog[aid] = r.uvarint()
    for _ in range(r.uvarint()):
        name = r.string()
        d.events[name] = r.uvarint()
    for _ in range(r.uvarint()):
        stage = r.string()
        d.stages[stage] = read_hist(r)
    d.heads_total = r.uvarint() if not r.eof() else 0
    if not r.eof():
        for _ in range(r.uvarint()):
            rule = r.string()
            sev = r.u8()
            state = r.u8()
            d.alerts.append({
                "rule": rule,
                "severity": _SEV_NAME.get(sev, "warn"),
                "state": _STATE_NAME.get(state & 0x7F, "firing"),
                "drill": bool(state & 0x80),
                "since": r.f64(),
                "value": r.f64(),
            })
    if not r.eof():
        for _ in range(r.uvarint()):
            d.hotspots.append({
                "frame": r.string(),
                "samples": r.uvarint(),
            })
    return d


def merge_stage_hists(
    digests: Iterable[NodeDigest],
) -> Dict[str, LatencyHistogram]:
    """Exact cluster-wide per-stage histograms: aligned-bucket merge of
    each node's cumulative stage histograms (the mergeability that makes
    any-node aggregation exact, runtime/latency.py)."""
    out: Dict[str, LatencyHistogram] = {s: LatencyHistogram() for s in E2E_STAGES}
    for d in digests:
        for stage, h in d.stages.items():
            out.setdefault(stage, LatencyHistogram()).merge(h)
    return out
