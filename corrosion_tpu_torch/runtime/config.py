"""Configuration: TOML file + environment overrides.

The port's copy of `corrosion_tpu/runtime/config.py`.

Counterpart of `klukai-types/src/config.rs:62-458`. Same sections (db, api,
gossip, perf, admin, telemetry, log, consul) and the same env-override
convention: `CORRO_DB__PATH=/x` overrides `db.path` (double underscore as
the section separator, config.rs:304-310). PerfConfig carries the channel
sizes and protocol knobs with the reference's defaults (config.rs:11-59,
179-235).
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # stdlib only on 3.11+; tomli is API-identical
    import tomli as tomllib
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import List, Optional


@dataclass
class DbConfig:
    path: str = "./corrosion.db"
    schema_paths: List[str] = field(default_factory=list)
    subscriptions_path: Optional[str] = None


@dataclass
class ApiConfig:
    bind_addr: List[str] = field(default_factory=lambda: ["127.0.0.1:8080"])
    authz_bearer: Optional[str] = None


@dataclass
class GossipTlsConfig:
    """[gossip.tls] — mirrors the reference's rustls config
    (`api/peer/mod.rs:152-373`): server cert/key, CA pinning for peer
    verification, optional mTLS client-cert requirement, and an insecure
    mode that skips server verification (SkipServerVerification)."""

    cert_file: Optional[str] = None
    key_file: Optional[str] = None
    ca_file: Optional[str] = None  # verify peers against this CA
    insecure: bool = False  # client side: skip server verification
    # mTLS: server requires + verifies client certs against ca_file
    mtls: bool = False
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None


@dataclass
class GossipConfig:
    bind_addr: str = "0.0.0.0:8787"
    external_addr: Optional[str] = None
    bootstrap: List[str] = field(default_factory=list)
    cluster_id: int = 0
    # explicit plaintext mode, like the reference's quinn_plaintext crypto
    # session for trusted networks; set false + a [gossip.tls] section for
    # a TLS-secured gossip plane
    plaintext: bool = True
    # "tcp" = UDP datagrams + lane-tagged TCP/TLS streams (default);
    # "quic" = plaintext QUIC (RFC 9000 subset, net/quic.py), the
    # reference's native wire (quinn + quinn_plaintext.rs)
    transport: str = "tcp"
    tls: GossipTlsConfig = field(default_factory=GossipTlsConfig)
    max_mtu: Optional[int] = None
    idle_timeout_secs: int = 30
    # quic only: where outbound dials originate (config.rs:162-163,
    # default [::]:0). Port 0 -> 8 hashed dial-only sockets
    # (transport.rs:57-71 kernel-buffer dilution); a fixed port -> 1
    # socket bound there.
    client_addr: Optional[str] = None

    @property
    def tls_enabled(self) -> bool:
        return not self.plaintext and self.tls.cert_file is not None


@dataclass
class PerfConfig:
    # channel sizes (config.rs:179-235)
    changes_channel_len: int = 2048
    bcast_channel_len: int = 10_000
    apply_channel_len: int = 512
    foca_channel_len: int = 1024
    # ingestion (config.rs:15-47)
    processing_queue_len: int = 20_000
    apply_queue_len: int = 50
    apply_queue_timeout_ms: int = 10
    max_concurrent_applies: int = 5
    # sync (config.rs:11-13, 53-59)
    sync_interval_min_secs: float = 1.0
    sync_interval_max_secs: float = 15.0
    sync_peers_min: int = 3
    sync_peers_max: int = 10
    max_concurrent_inbound_syncs: int = 3
    # local-commit group coalescing (r14): concurrent local writers
    # batch into one BEGIN IMMEDIATE..COMMIT (one fsync, one store-lock
    # hold, consecutive db_versions; per-writer SAVEPOINT isolation).
    # The first writer commits immediately when nobody else is queued,
    # so solo p50 latency is unchanged; `group_commit_wait` > 0 adds an
    # opt-in extra coalescing window for bursty single writers, and the
    # writer/byte budgets bound one shared transaction's blast radius.
    group_commit: bool = True
    group_commit_wait: float = 0.0
    group_commit_max_writers: int = 64
    group_commit_max_bytes: int = 1 << 20
    # per-group fanout (r21): the group leader runs ONE post-commit
    # loop re-entry for the whole batch — one origin stamp, one hooks
    # flush, one chunk pass over the stamped wire cells, one channel
    # round — instead of each follower paying its own hooks+chunk+send
    # block after its future resolves — plus the leader's pre-gather
    # loop yield that lets just-settled writers join the next batch
    # (full occupancy instead of alternating full/size-1 batches).
    # false (or env CORRO_GROUP_FANOUT=0) restores the r15 per-tx
    # post-commit path and gathering behavior.
    group_fanout: bool = True
    # direct change capture (r15): WriteTx parses recognized INSERT/
    # UPDATE/DELETE statement shapes and records the written cells in
    # memory, bypassing the AFTER-trigger → __crdt_pending round-trip
    # (~60% of a 10-row commit in the r14 profile).  Triggers stay
    # installed and capture raw/unrecognized SQL; false (or env
    # CORRO_CAPTURE=trigger) restores the pure trigger path.
    direct_capture: bool = True
    # dedicated committer thread (r24): one long-lived thread per store
    # runs every group commit, fed by a lock-free handoff deque + a
    # single event-loop wakeup — the leader parks on a future instead of
    # paying an executor submit/teardown (`asyncio.to_thread`) per
    # batch.  Backpressure is unchanged: the leader still holds the
    # priority write gate across the commit, so a stuck committer
    # surfaces as the existing typed gate refusals, never a new hang.
    # false (or env CORRO_COMMITTER=to_thread) restores the r15–r23
    # per-batch to_thread hop (the ingest bench's r24 pre mode).
    committer_thread: bool = True
    # broadcast
    broadcast_interval_ms: int = 500
    broadcast_cutoff_bytes: int = 64 * 1024
    broadcast_rate_limit_bytes: int = 10 * 1024 * 1024
    max_inflight_broadcasts: int = 500
    # maintenance (handlers.rs:379-547)
    wal_threshold_gb: float = 5.0
    wal_check_interval_secs: float = 60.0
    vacuum_interval_secs: float = 300.0
    vacuum_min_freelist_pages: int = 10_000


@dataclass
class SloConfig:
    """[slo] — the write→event latency objectives served by GET /v1/slo
    (r11).  `targets` maps e2e stage → latency target in seconds at the
    `objective` quantile (a stage absent from the map is reported but
    never judged); burn rate is the violating fraction over the error
    budget `1 - objective`, and a burn > 1 sustained for
    `breach_checks` consecutive checks trips a flight-recorder incident
    dump.  The canary probe is opt-in: a background loop writing tiny
    synthetic rows to `canary_table` under a self-subscription,
    continuously measuring TRUE end-to-end write→event latency on a
    live cluster (remote rows measure cross-node latency from their
    embedded origin wall stamp)."""

    window_secs: float = 60.0
    objective: float = 0.99
    targets: dict = field(
        default_factory=lambda: {
            "broadcast": 0.75,
            "apply": 1.5,
            "match": 1.5,
            "deliver": 0.25,
            "total": 3.0,
        }
    )
    breach_checks: int = 3
    canary: bool = False
    canary_interval_secs: float = 1.0
    canary_table: str = "corro_canary"


@dataclass
class TraceConfig:
    """[trace] — the r19 end-to-end write-tracing plane (runtime/
    trace.py stage spans + runtime/tracestore.py tail sampler).

    When `enabled`, every traced write's stage spans
    (write→broadcast→apply→match→deliver, stitched cross-node by the
    W3C traceparent on the broadcast/sync envelope ext) buffer in a
    bounded per-trace ring and are KEPT only when the trace errors,
    breaches an [slo] per-stage target, was head-lottery-selected at
    the origin (1 in `lottery_n`, deterministic on the trace id so
    every node keeps the same traces), or wins the local lottery —
    everything else drops at close with O(1) cost.  Kept traces serve
    `GET /v1/traces` (slowest-N, per-stage breakdown), feed exemplar
    ids into /v1/slo stage rows, and export through the OTLP plane
    when a collector is configured.  `lottery_n=0` disables the
    lottery (keep only errors/breaches/forced)."""

    enabled: bool = True
    lottery_n: int = 64
    max_traces: int = 512
    max_spans_per_trace: int = 64
    keep_max: int = 256
    idle_close_secs: float = 1.0


@dataclass
class TsdbConfig:
    """[tsdb] — the local metrics time-series store (runtime/tsdb.py,
    r20).  A daemon thread samples the process registry every
    `sample_interval_secs` (counters→rates, gauges→levels, latency
    p50/p99), keeping `slots` points per series in a bounded ring —
    the substrate the `[alerts]` rules evaluate against.  Memory is
    capped by `slots × max_series` and accounted in `corro.tsdb.*`."""

    enabled: bool = True
    # Prometheus-scrape-like cadence: cheap enough to forget about
    # (one registry snapshot per tick), fine enough for for-durations
    # in the seconds; harnesses that need sub-second alerting
    # (scripts/traffic_sim.py) tune it per run
    sample_interval_secs: float = 5.0
    slots: int = 240  # ring depth per series (240 × 5 s = 20 min)
    max_series: int = 4096


@dataclass
class ProfileConfig:
    """[profile] — the continuous profiling plane (runtime/profiler.py
    + runtime/profstore.py, r23).  An always-on daemon-thread stack
    sampler walks every thread at `hz` (wall-clock sampling), folding
    classified stacks into a bounded ring of `slots` windows of
    `window_secs` each; when the sampler's own measured duty cycle
    exceeds `max_overhead_pct` it auto-sheds to `shed_hz`
    (`corro.profile.shed.total`) and recovers with hysteresis — Prime
    CCL discipline: the plane degrades itself, never the serving path.
    The statement-shape profiler (`corro.store.stmt.seconds{shape=}`)
    rides the same install.  Served as `GET /v1/profile?window=…&
    format=folded|speedscope`; alert firings pin the hot window to
    their flight-recorder incident.  Process-global: the first agent's
    knobs win (the tsdb/tracestore contract)."""

    enabled: bool = True
    hz: float = 67.0
    shed_hz: float = 11.0
    max_overhead_pct: float = 1.0
    window_secs: float = 5.0
    slots: int = 24  # ring depth (24 × 5 s = 2 min of hot windows)
    max_stacks: int = 512  # distinct folded stacks per window


@dataclass
class AlertsConfig:
    """[alerts] — declarative anomaly rules over the TSDB
    (runtime/alerts.py, r20).  `rules` is a list of
    `[[alerts.rules]]` tables ({name, kind=threshold|rate|absent,
    series, op, value, for_secs, window_secs, severity, agg, labels,
    summary}); `default_pack` prepends the built-in pack (SLO burn,
    loop lag, shed/refusal rates, open sync circuits, view
    divergence, store faults) — an operator rule with the same name
    overrides the pack's.  `for_scale` multiplies every rule's
    for/window durations (the chaos harness shrinks them to fit tiny
    scenario windows).  The health knobs feed the Lifeguard-style
    local-health score that WIDENS for-durations (up to
    `health_widen_max`×) when this node itself is sick — a lagging
    node distrusts its own timers instead of flooding false pages."""

    enabled: bool = True
    eval_interval_secs: float = 5.0
    history_max: int = 256
    default_pack: bool = True
    for_scale: float = 1.0
    rules: List[dict] = field(default_factory=list)
    health_lag_secs: float = 0.25
    health_fault_rate: float = 5.0
    health_widen_max: float = 4.0


@dataclass
class RemediationConfig:
    """[remediation] — the supervised remediation plane
    (agent/remediation.py, r22) that closes the observe→act loop: a
    supervisor tick consumes `[alerts]` firings and drives typed,
    cooldown-gated actuators (view-divergence → targeted anti-entropy
    sync, store-faults → matcher-home drain + refuse-bulk, sustained
    slo-burn → laggard-tier shed).

    `enabled=false` is the GLOBAL KILL-SWITCH and the default: the
    supervisor still runs, evaluates every gate, and records typed
    "would_act" events (flight-recorded, served by GET
    /v1/remediation) — observe-only mode, so operators audit exactly
    what the plane WOULD have done before arming it.  `defer_health`
    is the Lifeguard self-distrust bar (arXiv:1707.00788): when the
    local `AlertEngine.health_score()` is at/above it, local impulses
    defer to the digest-merged cluster-scope alert rollup — the node
    acts only when another node's digest confirms the same rule is
    firing.  `slo_sustain_secs` keeps the shed actuator off transient
    slo-burn blips (Prime CCL: shrink capacity, never convert requests
    into stalls); per-actuator cooldowns stop act storms; and
    `refuse_bulk_secs` bounds how long a store-faulting node refuses
    bulk snapshot serves + new stream admissions before the flag
    self-expires (revert clears it sooner on alert resolve)."""

    enabled: bool = False
    tick_secs: float = 2.0
    act_timeout_secs: float = 30.0
    history_max: int = 256
    defer_health: float = 0.5
    sync_cooldown_secs: float = 30.0
    drain_cooldown_secs: float = 60.0
    shed_cooldown_secs: float = 30.0
    slo_sustain_secs: float = 5.0
    refuse_bulk_secs: float = 60.0


@dataclass
class PubsubConfig:
    """[pubsub] — live-query matcher knobs.  `candidate_batch_wait` is
    the matcher's candidate-batching window in seconds: the SLO
    plane attributed the old ~600 ms p50 write→event total to exactly
    this wait (the pubsub.rs:1069 parity value 0.6, kept as the
    matcher-module constant), and since the r10 matcher is ~6 ms/batch
    FLAT the wide window bought nothing — the default is now 0.1 s
    (write→event p50 ~0.6 s → ~0.15 s, SLO_BASELINE.json, with no
    events/s regression in PUBSUB_BENCH.json).  Operators can raise it
    back to trade match latency for fewer, larger diff batches under
    extreme write fan-in (surfaced in /v1/status)."""

    candidate_batch_wait: float = 0.1


@dataclass
class SubsConfig:
    """[subs] — serving-plane admission control + stream backpressure
    (r16).  One node is expected to host 10k–100k concurrent
    subscription streams: `max_streams` bounds how many the HTTP plane
    admits (excess subscribes get a typed 503, never a half-served
    stream), and the per-stream lag bounds govern the coalesced fan-out
    writer — a stream whose socket stops draining accumulates pending
    batch payloads until `max_lag_bytes`/`max_lag_batches`, then is
    SHED with a terminal `{"lagging": ...}` frame (Prime CCL
    discipline: a slow consumer degrades, it never stalls the
    DiffExecutor or its sibling streams).  `matcher_linger_secs` is the
    teardown grace after a deduped matcher's LAST stream detaches: a
    reconnect inside the window re-uses the warm matcher + changes log
    (the client resumes by change id), after it the sub db is reaped.
    `writer_tick_secs` paces retry flushes of clogged sinks;
    `diff_workers` sizes the shared DiffExecutor pool."""

    max_streams: int = 100_000
    max_lag_bytes: int = 4 * 1024 * 1024
    max_lag_batches: int = 1024
    matcher_linger_secs: float = 30.0
    writer_tick_secs: float = 0.05
    diff_workers: int = 4
    # "writer" = the r16 shared coalescing fan-out writer (sinks, lag
    # shedding); "queue" = the r10 per-stream drain-loop reference path
    # (one task + one queue per stream, no shedding) — the bench's A/B
    # axis and the rollback lever (env: CORRO_SUBS__FANOUT=queue)
    fanout: str = "writer"


@dataclass
class SyncConfig:
    """[sync] — the r17 cold-node catch-up plane (agent/catchup.py,
    store/snapshot.py).

    Snapshot bootstrap: a node whose estimated version gap against the
    freshest peer exceeds `snapshot_min_gap_versions` fetches the
    peer's cached compressed snapshot (staleness-bounded by
    `snapshot_max_age_secs` on the SERVING side), installs it through
    the locked-swap path, and tops up with delta sync from the embedded
    watermark — instead of replaying the whole gap change-by-change.
    `snapshot=false` disables both serving and bootstrapping (the pure-
    delta A/B lever `scripts/bench_sync.py` measures against).

    Resumable delta sync: a peer dropping mid-stream releases its
    unserved version ranges back to the shared claim ledger and the
    SAME sync round re-claims them from surviving peers, up to
    `max_waves` waves paced by `resume_backoff_{min,max}_secs` (Prime
    CCL discipline: a dead peer degrades the transfer, never restarts
    or deadlocks it).  A peer failing `circuit_failures` consecutive
    sessions opens its circuit for `circuit_reset_secs` (per-peer
    state on the Agent handle): peer choice DEPRIORITIZES it (never
    excludes — small clusters must keep probing through a flap) and
    the snapshot bootstrap refuses it as a bulk-transfer source.  The
    default 0 auto-scales the reset to 4 × `perf.sync_interval_max_
    secs` — a breaker horizon must track the retry cadence it guards,
    or fast-cadence deployments blank their sync plane for hundreds of
    rounds after one flap."""

    snapshot: bool = True
    snapshot_min_gap_versions: int = 10_000
    snapshot_max_age_secs: float = 60.0
    snapshot_chunk_bytes: int = 256 * 1024
    snapshot_timeout_secs: float = 300.0
    # after a successful install the bootstrap stands down and the
    # delta plane owns the residual gap: under sustained write fire
    # every small transaction is a fresh version, so the version-gap
    # heuristic alone would re-trigger bootstrap each round and reset
    # the node to the (stale) watermark forever
    snapshot_cooldown_secs: float = 300.0
    max_concurrent_snapshot_serves: int = 2
    max_waves: int = 3
    resume_backoff_min_secs: float = 0.1
    resume_backoff_max_secs: float = 2.0
    circuit_failures: int = 3
    circuit_reset_secs: float = 0.0  # 0 → 4 × perf.sync_interval_max_secs


@dataclass
class ClusterObsConfig:
    """[cluster] — the r12 cluster observatory (agent/observatory.py).
    Each node builds a telemetry digest every `digest_interval_secs`
    and piggybacks it on the gossip/broadcast planes; aggregation is
    freshest-per-node with digests older than `stale_after_secs`
    excluded from /v1/cluster merges.  The view-divergence detector
    opens an episode (one flight-recorder incident dump) after
    `divergence_checks` consecutive divergent checks; an ACTIVE member
    whose digests stop arriving for `silent_after_secs` (default:
    `silent_after_mult × digest_interval_secs`) counts as divergent,
    and remembered view hashes are compared for
    `divergence_memory_secs` after the last digest."""

    digests: bool = True
    digest_interval_secs: float = 2.0
    # r22: hard ceiling on the ENCODED digest.  The digest is cumulative
    # (histograms only grow), and the gossip plane offers pick_ext only
    # the bytes a SWIM frame has left (~1135 quiet, less with piggyback)
    # — so a digest that outgrows the quiet frame is skipped by EVERY
    # datagram and the view/census core (the split-brain signal) starves
    # cluster-wide.  Worse, an open divergence episode ADDS an alert
    # block to every digest, so the starvation is self-sustaining.
    # build_and_store degrades an over-ceiling digest (drop non-total
    # stage histograms, then stages/events/alert tail) instead: shed
    # telemetry richness, never liveness.
    max_wire_bytes: int = 896
    stale_after_secs: float = 20.0
    silent_after_secs: float = 0.0  # 0 → silent_after_mult × interval
    # the silence threshold must undercut the SWIM suspicion window
    # (~9 s at n=3 defaults) or the membership downs a partitioned peer
    # before the observatory can flag the divergence: 2.5 × 2 s = 5 s
    # silence + 2 divergent checks ≈ 9 s worst-case detection
    silent_after_mult: float = 2.5
    divergence_checks: int = 2
    divergence_memory_secs: float = 120.0


@dataclass
class AdminConfig:
    uds_path: str = "./admin.sock"


@dataclass
class ConsulConfig:
    enabled: bool = False
    address: str = "127.0.0.1:8500"  # consul agent HTTP address
    # Reverse TTL sync: each entry is a `[[consul.ttl_checks]]` TOML table
    # {"id": <consul check id>, "query": <SQL run against the store>}.
    # The sync loop evaluates the query each tick and PUTs the derived
    # pass/warn/fail status to /v1/agent/check/update/<id>, hash-gated on
    # (status, output) with a forced refresh every ttl_refresh_seconds so
    # the Consul-side TTL never lapses while we're healthy.
    ttl_checks: List[dict] = field(default_factory=list)
    ttl_refresh_seconds: float = 30.0


@dataclass
class TelemetryConfig:
    prometheus_bind_addr: Optional[str] = None
    # OTLP/HTTP collector base URL (e.g. "http://127.0.0.1:4318") — the
    # reference's `telemetry.open-telemetry` exporter config
    # (`klukai/src/main.rs:68-76`).  Env fallback: the standard
    # OTEL_EXPORTER_OTLP_ENDPOINT, honored at agent startup (cli.py).
    open_telemetry_endpoint: Optional[str] = None


@dataclass
class LogConfig:
    format: str = "plaintext"  # or "json"
    colors: bool = True
    level: str = "info"


@dataclass
class Config:
    db: DbConfig = field(default_factory=DbConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    admin: AdminConfig = field(default_factory=AdminConfig)
    consul: ConsulConfig = field(default_factory=ConsulConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    log: LogConfig = field(default_factory=LogConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    pubsub: PubsubConfig = field(default_factory=PubsubConfig)
    subs: SubsConfig = field(default_factory=SubsConfig)
    cluster: ClusterObsConfig = field(default_factory=ClusterObsConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    tsdb: TsdbConfig = field(default_factory=TsdbConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    alerts: AlertsConfig = field(default_factory=AlertsConfig)
    remediation: RemediationConfig = field(default_factory=RemediationConfig)


_ENV_PREFIX = "CORRO_"


def _coerce(value: str, target_type):
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type in (List[str], list):
        return [v.strip() for v in value.split(",") if v.strip()]
    return value


def _apply_dict(cfg, data: dict):
    for f in fields(cfg):
        if f.name in data:
            v = data[f.name]
            cur = getattr(cfg, f.name)
            if is_dataclass(cur) and isinstance(v, dict):
                _apply_dict(cur, v)
            else:
                setattr(cfg, f.name, v)


def load_config(path: Optional[str] = None, env: Optional[dict] = None) -> Config:
    """TOML file (optional) overlaid with CORRO_SECTION__FIELD env vars."""
    cfg = Config()
    if path:
        with open(path, "rb") as f:
            _apply_dict(cfg, tomllib.load(f))
    env = env if env is not None else os.environ
    for key, value in env.items():
        if not key.startswith(_ENV_PREFIX):
            continue
        parts = key[len(_ENV_PREFIX):].lower().split("__")
        if len(parts) != 2:
            continue
        section, name = parts
        sec = getattr(cfg, section, None)
        if sec is None or not hasattr(sec, name):
            continue
        ftype = str({f.name: f.type for f in fields(sec)}.get(name))
        # with `from __future__ import annotations` field types are strings
        # like 'Optional[int]'; match on the contained scalar type
        target = str
        if "List" in ftype or "list" in ftype:
            target = list
        elif "bool" in ftype:
            target = bool
        elif "int" in ftype:
            target = int
        elif "float" in ftype:
            target = float
        setattr(sec, name, _coerce(value, target))
    return cfg
