"""`corrosion` CLI: the full operator command surface.

Counterpart of `klukai/src/main.rs:569-826`'s command tree:

  agent [--from-snapshot P]  run the agent (optionally cold-bootstrap
                             the database from a snapshot file first)
  backup PATH                VACUUM INTO + scrub per-node state
  restore PATH               swap the db file under full SQLite locks
  snapshot dump|install PATH r17 catch-up plane: serve-side compressed
                             snapshot dump / cold-side install (schema-
                             sha-gated, keeps the local site id)
  cluster rejoin|members|membership-states|set-id
  consul sync                bidirectional Consul <-> store replication
  query SQL                  one-shot query through the HTTP API
  exec SQL...                transaction through the HTTP API
  reload                     re-apply schema files via /v1/migrations
  sync generate|reconcile-gaps
  locks [--top N]
  actor version ACTOR_ID VERSION
  template FILE...           render templates (optionally watch)
  tls ca|server|client generate
  db lock CMD                run CMD while holding every SQLite lock
  subs list|info
  log set|reset

Global flags: -c/--config, --api-addr, --db-path, --admin-path,
--device.

The port's copy of `corrosion_tpu/cli.py`, with one addition: the global
`--device` names the torch device the agent's store decides on (`agent`,
`devcluster`; `snapshot dump` opens its store there too). With none
named the agent takes the card and raises without CUDA
(`runtime/device.py::resolve_device`); the CPU is used only when named
(`--device cpu`). The client subcommands (query, exec, the admin
commands, ...) import no torch, so they start fast.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from typing import List, Optional

from corrosion_tpu_torch.runtime import otel
from corrosion_tpu_torch.runtime.config import Config, load_config


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="corrosion",
        description="gossip-based multi-writer distributed store"
                    " (PyTorch and CUDA port)",
    )
    p.add_argument("-c", "--config", default="corrosion.toml")
    p.add_argument("--api-addr", default=None)
    p.add_argument("--db-path", default=None)
    p.add_argument("--admin-path", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the agent's store (default: the"
                        " card, cuda:0; the CPU only when named: cpu)")
    sub = p.add_subparsers(dest="command", required=True)

    ag = sub.add_parser("agent", help="run the agent")
    # cold-side bootstrap flag (r17): install a snapshot file over the
    # configured db (schema-sha-gated) before the agent boots from it
    ag.add_argument("--from-snapshot", default=None, metavar="PATH")

    b = sub.add_parser("backup", help="back up the database")
    b.add_argument("path")

    r = sub.add_parser("restore", help="restore a backup over the live db")
    r.add_argument("path")
    r.add_argument("--self-actor-id", default=None)

    sn = sub.add_parser(
        "snapshot", help="compressed catch-up snapshots (r17)"
    ).add_subparsers(dest="sub", required=True)
    snd = sn.add_parser("dump", help="build a snapshot file from the db")
    snd.add_argument("path")
    sni = sn.add_parser("install", help="install a snapshot over the db")
    sni.add_argument("path")
    sni.add_argument("--self-actor-id", default=None)

    cluster = sub.add_parser("cluster").add_subparsers(
        dest="sub", required=True
    )
    cluster.add_parser("rejoin")
    cluster.add_parser("members")
    cluster.add_parser("membership-states")
    sid = cluster.add_parser("set-id")
    sid.add_argument("cluster_id", type=int)

    consul = sub.add_parser("consul").add_subparsers(dest="sub", required=True)
    consul.add_parser("sync")

    q = sub.add_parser("query")
    q.add_argument("sql")
    q.add_argument("--columns", action="store_true")
    q.add_argument("--timer", action="store_true")
    q.add_argument("--param", action="append", default=[])
    # server-side statement interrupt in seconds (main.rs:672 Query.timeout)
    q.add_argument("--timeout", type=float, default=None)

    e = sub.add_parser("exec")
    e.add_argument("sql", nargs="+")
    e.add_argument("--timeout", type=float, default=None)

    sub.add_parser("reload", help="re-apply schema files")

    sy = sub.add_parser("sync").add_subparsers(dest="sub", required=True)
    sy.add_parser("generate")
    sy.add_parser("reconcile-gaps")

    lk = sub.add_parser("locks")
    lk.add_argument("--top", type=int, default=None)

    trc = sub.add_parser(
        "traces", help="fetch the node's kept slow traces (GET /v1/traces)"
    )
    trc.add_argument("--n", type=int, default=10, help="slowest-N traces")
    trc.add_argument("--stage", default=None,
                     help="only traces with this stage (write/broadcast/"
                          "apply/match/deliver)")
    trc.add_argument("--actor", default=None)
    trc.add_argument("--table", default=None)
    trc.add_argument("--json", action="store_true",
                     help="raw JSON instead of the table render")

    al = sub.add_parser(
        "alerts", help="fetch the node's alert states (GET /v1/alerts)"
    )
    al.add_argument("--cluster", action="store_true",
                    help="cluster scope: every node's digest-carried "
                         "active alerts + per-rule rollup")
    al.add_argument("--history", action="store_true",
                    help="include the fired/resolved transition history")
    al.add_argument("--json", action="store_true",
                    help="raw JSON instead of the table render")

    pr = sub.add_parser(
        "profile",
        help="fetch the node's continuous profile (GET /v1/profile)",
    )
    pr.add_argument("--window", type=float, default=60.0,
                    help="lookback seconds (default 60)")
    pr.add_argument("--cluster", action="store_true",
                    help="cluster scope: every node's digest-carried "
                         "hotspot frames + merged rollup")
    pr.add_argument("--speedscope", metavar="PATH", default=None,
                    help="write a speedscope.app document to PATH")
    pr.add_argument("--folded", action="store_true",
                    help="print collapsed-stack text (flamegraph input)")
    pr.add_argument("--json", action="store_true",
                    help="raw JSON instead of the table render")

    actor = sub.add_parser("actor").add_subparsers(dest="sub", required=True)
    av = actor.add_parser("version")
    av.add_argument("actor_id")
    av.add_argument("version", type=int)

    t = sub.add_parser("template")
    t.add_argument("files", nargs="+", help="TEMPLATE[:OUTPUT] specs")
    t.add_argument("--watch", action="store_true")

    tls = sub.add_parser("tls").add_subparsers(dest="sub", required=True)
    ca = tls.add_parser("ca").add_subparsers(dest="subsub", required=True)
    cag = ca.add_parser("generate")
    cag.add_argument("--cert-file", default="./ca-cert.pem")
    cag.add_argument("--key-file", default="./ca-key.pem")
    srv = tls.add_parser("server").add_subparsers(dest="subsub", required=True)
    srvg = srv.add_parser("generate")
    srvg.add_argument("ip")
    srvg.add_argument("--ca-cert", default="./ca-cert.pem")
    srvg.add_argument("--ca-key", default="./ca-key.pem")
    srvg.add_argument("--cert-file", default="./server-cert.pem")
    srvg.add_argument("--key-file", default="./server-key.pem")
    cli_ = tls.add_parser("client").add_subparsers(dest="subsub", required=True)
    clig = cli_.add_parser("generate")
    clig.add_argument("--ca-cert", default="./ca-cert.pem")
    clig.add_argument("--ca-key", default="./ca-key.pem")
    clig.add_argument("--cert-file", default="./client-cert.pem")
    clig.add_argument("--key-file", default="./client-key.pem")

    db = sub.add_parser("db").add_subparsers(dest="sub", required=True)
    dblock = db.add_parser("lock")
    dblock.add_argument("cmd")

    subs = sub.add_parser("subs").add_subparsers(dest="sub", required=True)
    subs.add_parser("list")
    si = subs.add_parser("info")
    si.add_argument("--id", default=None)
    si.add_argument("--hash", default=None)

    lg = sub.add_parser("log").add_subparsers(dest="sub", required=True)
    ls = lg.add_parser("set")
    ls.add_argument("filter")
    lg.add_parser("reset")

    dc = sub.add_parser("devcluster", help="spawn a local topology")
    dc.add_argument("topology", help="file of 'A -> B' edges")
    dc.add_argument("--schema", default=None, help="schema .sql file")

    return p


def _load_cfg(args) -> Config:
    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        cfg = Config()
    if args.api_addr:
        cfg.api.bind_addr = [args.api_addr]
    if args.db_path:
        cfg.db.path = args.db_path
    if args.admin_path:
        cfg.admin.uds_path = args.admin_path
    return cfg


def _api_addr(cfg: Config) -> str:
    return cfg.api.bind_addr[0]


async def _admin_call(cfg: Config, cmd: dict) -> int:
    from corrosion_tpu_torch.admin import AdminClient

    try:
        async with AdminClient(cfg.admin.uds_path) as c:
            r = await c.call(cmd)
    except (ConnectionError, FileNotFoundError, OSError) as e:
        print(f"could not reach admin socket {cfg.admin.uds_path}: {e}",
              file=sys.stderr)
        return 1
    for line in r["logs"]:
        print(line)
    for value in r["json"]:
        print(json.dumps(value, indent=2))
    if not r["ok"]:
        print(f"error: {r['error']}", file=sys.stderr)
        return 1
    return 0


async def _cmd_agent(cfg: Config, from_snapshot: Optional[str] = None,
                     device: Optional[str] = None) -> int:
    import logging

    from corrosion_tpu_torch.admin import AdminServer
    from corrosion_tpu_torch.agent.run import run, setup, shutdown
    from corrosion_tpu_torch.api.http import ApiServer
    from corrosion_tpu_torch.runtime.metrics import serve_prometheus
    from corrosion_tpu_torch.runtime.tripwire import Tripwire

    logging.basicConfig(
        level=cfg.log.level.upper(),
        format=(
            '{"ts":"%(asctime)s","level":"%(levelname)s",'
            '"logger":"%(name)s","msg":"%(message)s"}'
            if cfg.log.format == "json"
            else "%(asctime)s %(levelname)s %(name)s %(message)s"
        ),
    )

    if from_snapshot:
        # cold-side bootstrap (r17): install before the store opens, so
        # the agent boots straight onto the snapshot's bookkeeping and
        # its first sync rounds are the watermark top-up
        rc = _snapshot_install(cfg, from_snapshot)
        if rc != 0:
            return rc

    tripwire = Tripwire.from_signals()
    agent = await setup(cfg, tripwire=tripwire, device=device)
    await run(agent)

    # Admin socket binds before the API listener: external supervisors
    # (devcluster.wait_up) treat "api port accepts" as ready, so everything
    # ready implies must already be bound by then.
    admin = AdminServer(agent, cfg.admin.uds_path)
    await admin.start()

    api = ApiServer(agent)
    await api.start()
    print(f"api listening on {', '.join(api.addrs)}")

    prom_runner = None
    if cfg.telemetry.prometheus_bind_addr:
        prom_runner = await serve_prometheus(cfg.telemetry.prometheus_bind_addr)

    # OTLP span export (main.rs:68-118): config endpoint, or the standard
    # env var so deployments can enable tracing without editing TOML
    otlp_endpoint = cfg.telemetry.open_telemetry_endpoint or os.environ.get(
        "OTEL_EXPORTER_OTLP_ENDPOINT"
    )
    if otlp_endpoint:
        otel.configure(
            otlp_endpoint,
            resource_attrs={"corrosion.actor_id": str(agent.actor_id)},
        )

    consul_task = None
    if cfg.consul.enabled:
        from corrosion_tpu_torch.consul import consul_sync_loop

        consul_task = asyncio.ensure_future(
            consul_sync_loop(agent, cfg.consul, tripwire)
        )

    try:
        print(f"agent {agent.actor_id} up; gossip {agent.actor.addr}")
        await tripwire.wait()
        print("shutting down…")
        if consul_task is not None:
            consul_task.cancel()
        if prom_runner is not None:
            await prom_runner.cleanup()
        await admin.stop()
        await api.stop()
        await shutdown(agent)
        await agent.tracker.wait_all(60.0)
    finally:
        # even a failing shutdown path must flush queued spans — those are
        # exactly the spans that explain the failure
        if otlp_endpoint:
            otel.configure(None)  # shutdown + final flush
    return 0


def _client_error_text(body) -> str:
    """Dig the sqlite/API error line out of a ClientError body (the 400
    shape is {"results": [{"error": ...}], ...})."""
    if isinstance(body, dict):
        for r in body.get("results") or []:
            if isinstance(r, dict) and "error" in r:
                return str(r["error"])
        if "error" in body:
            return str(body["error"])
    return str(body)


async def _cmd_query(cfg: Config, args) -> int:
    import time as _time

    from corrosion_tpu_torch.client import ClientError, CorrosionApiClient

    stmt: object = (
        [args.sql, list(args.param)] if args.param else args.sql
    )
    t0 = _time.monotonic()
    async with CorrosionApiClient(
        _api_addr(cfg), token=cfg.api.authz_bearer
    ) as c:
        try:
            async for ev in c.query(stmt, timeout=args.timeout):
                if "columns" in ev and args.columns:
                    print("|".join(ev["columns"]))
                elif "row" in ev:
                    _rowid, vals = ev["row"]
                    print("|".join(_render(v) for v in vals))
                elif "error" in ev:
                    print(f"error: {ev['error']}", file=sys.stderr)
                    return 1
        except ClientError as e:
            # HTTP-level failure before the stream starts (401, parse
            # 400, …): same clean error line as the exec path
            print(f"error: {_client_error_text(e.body)}", file=sys.stderr)
            return 1
    if args.timer:
        print(f"time: {_time.monotonic() - t0:.6f}s", file=sys.stderr)
    return 0


def _render(v) -> str:
    if v is None:
        return ""
    return str(v)


async def _cmd_exec(cfg: Config, args) -> int:
    from corrosion_tpu_torch.client import ClientError, CorrosionApiClient

    async with CorrosionApiClient(
        _api_addr(cfg), token=cfg.api.authz_bearer
    ) as c:
        try:
            resp = await c.execute(list(args.sql), timeout=args.timeout)
        except ClientError as e:
            # e.g. a --timeout interrupt comes back as HTTP 400 with the
            # sqlite error in the body — print it, don't traceback
            print(f"error: {_client_error_text(e.body)}", file=sys.stderr)
            return 1
    print(json.dumps(resp, indent=2))
    return 0 if "results" in resp else 1


async def _cmd_reload(cfg: Config) -> int:
    from corrosion_tpu_torch.client import CorrosionApiClient

    if not cfg.db.schema_paths:
        print("no schema_paths configured", file=sys.stderr)
        return 1
    async with CorrosionApiClient(
        _api_addr(cfg), token=cfg.api.authz_bearer
    ) as c:
        resp = await c.schema_from_paths(cfg.db.schema_paths)
    print(json.dumps(resp, indent=2))
    return 0


async def _agent_is_live(cfg: Config) -> bool:
    from corrosion_tpu_torch.admin import AdminClient

    try:
        async with AdminClient(cfg.admin.uds_path) as c:
            r = await c.call({"cmd": "ping"})
            return bool(r["ok"])
    except (ConnectionError, FileNotFoundError, OSError):
        return False


def _expected_schema_sha(cfg: Config):
    """Schema sha from the configured declarative schema files (None
    when none are configured — the install then trusts the snapshot)."""
    if not cfg.db.schema_paths:
        return None
    from pathlib import Path

    from corrosion_tpu_torch.store.schema import parse_sql
    from corrosion_tpu_torch.store.snapshot import schema_sha

    sql = "\n".join(Path(p).read_text() for p in cfg.db.schema_paths)
    return schema_sha(parse_sql(sql), exclude=(cfg.slo.canary_table,))


def _existing_site_id(db_path: str):
    import sqlite3 as _sqlite3

    if not os.path.exists(db_path):
        return None
    try:
        conn = _sqlite3.connect(db_path)
        try:
            row = conn.execute(
                "SELECT site_id FROM __crdt_site WHERE id = 1"
            ).fetchone()
        finally:
            conn.close()
    except _sqlite3.Error:
        return None
    return bytes(row[0]) if row else None


def _snapshot_install(cfg: Config, path: str, self_actor_id=None) -> int:
    """Shared by `snapshot install` and `agent --from-snapshot`: the
    cold node keeps its own identity — an existing db's site id (or
    --self-actor-id) is re-pinned into the installed copy."""
    import uuid

    from corrosion_tpu_torch.store.snapshot import (
        SnapshotError,
        install_snapshot_file,
    )

    self_site = None
    if self_actor_id:
        self_site = uuid.UUID(self_actor_id).bytes
    else:
        self_site = _existing_site_id(cfg.db.path)
    try:
        res = install_snapshot_file(
            path,
            cfg.db.path,
            expect_schema_sha=_expected_schema_sha(cfg),
            self_site_id=self_site,
        )
    except SnapshotError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(
        f"installed snapshot over {cfg.db.path}: {res.raw_bytes} bytes,"
        f" {res.watermark_versions} watermark versions"
        f" (delta sync tops up from there)"
    )
    return 0


async def _cmd_snapshot(cfg: Config, args) -> int:
    # both directions need exclusive db access, same rule as restore
    if await _agent_is_live(cfg):
        print(
            "an agent is running on this database; stop it first"
            " (live peers serve snapshots over the sync plane instead)",
            file=sys.stderr,
        )
        return 1
    if args.sub == "dump":
        from corrosion_tpu_torch.store import snapshot as snap
        from corrosion_tpu_torch.store.bookkeeping import Bookie
        from corrosion_tpu_torch.store.crdt import CrdtStore

        store = CrdtStore(cfg.db.path, device=args.device)
        try:
            bookie = Bookie()
            for aid in store.booked_actor_ids():
                bookie.insert(aid, store.load_booked_versions(aid))
            header = snap.build_snapshot_file(
                cfg.db.path,
                args.path,
                store.schema,
                store.site_id.bytes16,
                snap.bookie_watermark(bookie),
                cfg.sync.snapshot_chunk_bytes,
            )
        finally:
            store.close()
        print(
            f"wrote snapshot {args.path}: {header.raw_bytes} bytes raw,"
            f" {header.watermark_total()} watermark versions,"
            f" schema sha {header.schema_sha.hex()[:12]}"
        )
        return 0
    return _snapshot_install(cfg, args.path, args.self_actor_id)


def _cmd_db_lock(cfg: Config, cmd: str) -> int:
    import shlex
    import subprocess
    import time as _time

    from corrosion_tpu_torch.store.restore import lock_all

    print(f"Opening DB file at {cfg.db.path}")
    start = _time.monotonic()
    locks = lock_all(cfg.db.path, timeout=30.0)
    print(f"Lock acquired after {_time.monotonic() - start:.3f}s")
    try:
        argv = shlex.split(cmd)
        print(f"Launching command {cmd}")
        code = subprocess.run(argv).returncode
        print(f"Exited with code: {code}")
        return code
    finally:
        locks.release()


async def _cmd_traces(cfg: Config, args) -> int:
    """Admin fetch of GET /v1/traces: the slowest kept traces with their
    per-stage breakdown, rendered as one fixed-width table per trace
    (or raw JSON with --json)."""
    import aiohttp

    params = {"n": str(args.n)}
    for k in ("stage", "actor", "table"):
        v = getattr(args, k)
        if v:
            params[k] = v
    url = f"http://{_api_addr(cfg)}/v1/traces"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(
                url, params=params, timeout=aiohttp.ClientTimeout(total=10)
            ) as resp:
                body = await resp.json()
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
        print(f"could not reach {url}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    census = body.get("census", {})
    if not census.get("enabled"):
        print("trace plane disabled ([trace] enabled=false)")
        return 0
    print(
        f"kept {census['kept_total']} dropped {census['dropped_total']} "
        f"buffered {census['buffered']} (1/{census['lottery_n']} lottery)"
    )
    for t in body["traces"]:
        chaos = f" chaos={t['chaos']}" if t.get("chaos") else ""
        print(
            f"\ntrace {t['trace_id']}  {t['duration_secs'] * 1e3:.3f} ms  "
            f"reason={t['reason']}  spans={t['n_spans']} "
            f"hops={t['hops']}{chaos}"
        )
        print(f"  {'stage':<10} {'count':>5} {'sum_ms':>10} {'max_ms':>10}")
        for stage, row in t["stages"].items():
            print(
                f"  {stage:<10} {row['count']:>5} "
                f"{row['seconds'] * 1e3:>10.3f} "
                f"{row['max_secs'] * 1e3:>10.3f}"
            )
    return 0


async def _cmd_alerts(cfg: Config, args) -> int:
    """Operator fetch of GET /v1/alerts: rule states, active alerts
    (drill marks, exemplar trace ids), optional history — or the
    cluster rollup with --cluster."""
    import aiohttp

    params = {}
    if args.cluster:
        params["scope"] = "cluster"
    elif not args.history:
        params["history"] = "0"
    url = f"http://{_api_addr(cfg)}/v1/alerts"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(
                url, params=params, timeout=aiohttp.ClientTimeout(total=10)
            ) as resp:
                body = await resp.json()
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
        print(f"could not reach {url}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    if args.cluster:
        cov = body.get("coverage", {})
        print(
            f"cluster alerts from {body.get('actor_id')}: "
            f"{cov.get('known', 0)} node(s) known, "
            f"{cov.get('fresh', 0)} fresh"
        )
        rollup = body.get("rollup", {})
        if not rollup:
            print("no active alerts cluster-wide")
            return 0
        print(f"{'rule':<20} {'sev':<5} {'firing':<24} {'pending':<24} drill")
        for rule, row in sorted(rollup.items()):
            print(
                f"{rule:<20} {row['severity']:<5} "
                f"{','.join(row['firing']) or '-':<24} "
                f"{','.join(row['pending']) or '-':<24} "
                f"{'yes' if row['drill'] else '-'}"
            )
        return 0
    if not body.get("enabled"):
        print("alerting plane disabled ([alerts] enabled=false)")
        return 0
    print(
        f"health score {body.get('health_score')}  "
        f"({len(body.get('active', []))} active)"
    )
    print(f"{'rule':<20} {'sev':<5} {'state':<8} {'value':>12}  notes")
    for r in body.get("rules", []):
        notes = []
        if r.get("drill"):
            notes.append(f"drill={r['drill']}")
        if r.get("trace_ids"):
            notes.append(f"traces={','.join(r['trace_ids'][:2])}")
        if r.get("incident"):
            notes.append("incident")
        v = r.get("value")
        print(
            f"{r['rule']:<20} {r['severity']:<5} {r['state']:<8} "
            f"{v if v is not None else '-':>12}  {' '.join(notes)}"
        )
    for h in body.get("history", []):
        dur = (
            f" after {h['duration_secs']}s"
            if h.get("duration_secs") is not None else ""
        )
        print(
            f"  {h['wall']:.3f} {h['rule']} {h['event']}{dur}"
            + (f" [drill: {h['drill']}]" if h.get("drill") else "")
        )
    return 0


async def _cmd_profile(cfg: Config, args) -> int:
    """Operator fetch of GET /v1/profile: the continuous profiler's
    top self-time frames + statement-shape table (default render),
    collapsed-stack text with --folded, a speedscope.app file with
    --speedscope PATH, or the cluster hotspot rollup with --cluster."""
    import aiohttp

    params = {"window": str(args.window)}
    if args.cluster:
        params["scope"] = "cluster"
    elif args.speedscope:
        params["format"] = "speedscope"
    elif args.folded:
        params["format"] = "folded"
    url = f"http://{_api_addr(cfg)}/v1/profile"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(
                url, params=params, timeout=aiohttp.ClientTimeout(total=10)
            ) as resp:
                if params.get("format") == "folded":
                    body = await resp.text()
                else:
                    body = await resp.json()
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
        print(f"could not reach {url}: {e}", file=sys.stderr)
        return 1
    if args.cluster:
        if args.json:
            print(json.dumps(body, indent=2))
            return 0
        cov = body.get("coverage", {})
        print(
            f"cluster hotspots from {body.get('actor_id')}: "
            f"{cov.get('known', 0)} node(s) known, "
            f"{cov.get('fresh', 0)} fresh"
        )
        rollup = body.get("rollup", [])
        if not rollup:
            print("no hotspot frames cluster-wide")
            return 0
        print(f"{'samples':>8}  frame")
        for row in rollup:
            print(f"{row['samples']:>8}  {row['frame']}")
        return 0
    if args.speedscope:
        with open(args.speedscope, "w") as f:
            json.dump(body, f)
        n = len(body.get("shared", {}).get("frames", []))
        print(f"wrote speedscope profile ({n} frames) to {args.speedscope}")
        return 0
    if args.folded:
        sys.stdout.write(body)
        return 0
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    if not body.get("enabled"):
        print("profiling plane disabled ([profile] enabled=false)")
        return 0
    shed = " SHED" if body.get("shed") else ""
    print(
        f"{body.get('samples', 0)} samples over {args.window:g}s at "
        f"{body.get('hz', 0):g} Hz{shed}, overhead "
        f"{body.get('overhead_pct', 0.0):.3f}%"
    )
    print(f"{'self':>8}  frame")
    for row in body.get("top_self", []):
        print(f"{row['samples']:>8}  {row['frame']}")
    stmt = body.get("stmt", [])
    if stmt:
        print(f"\n{'count':>8} {'total_ms':>10}  statement shape")
        for row in stmt:
            print(
                f"{row['count']:>8} {row['total_secs'] * 1e3:>10.3f}  "
                f"{row['shape']}"
            )
    return 0


async def _cmd_template(cfg: Config, args) -> int:
    from corrosion_tpu_torch.tpl import render_specs, watch_specs

    if args.watch:
        await watch_specs(cfg, args.files)
        return 0
    return await render_specs(cfg, args.files)


async def _amain(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    cfg = _load_cfg(args)
    cmd = args.command

    if cmd == "agent":
        return await _cmd_agent(cfg, from_snapshot=args.from_snapshot,
                                device=args.device)
    if cmd == "snapshot":
        return await _cmd_snapshot(cfg, args)
    if cmd == "backup":
        from corrosion_tpu_torch.store.restore import backup

        backup(cfg.db.path, args.path)
        print(f"backed up database to {args.path}")
        return 0
    if cmd == "restore":
        from corrosion_tpu_torch.admin import AdminClient
        from corrosion_tpu_torch.store.restore import restore, set_self_site_id

        # refuse when an agent is live on the admin socket (main.rs:224-330)
        try:
            async with AdminClient(cfg.admin.uds_path) as c:
                r = await c.call({"cmd": "ping"})
                if r["ok"]:
                    print(
                        "an agent is running on this database; stop it first",
                        file=sys.stderr,
                    )
                    return 1
        except (ConnectionError, FileNotFoundError, OSError):
            pass
        if args.self_actor_id:
            set_self_site_id(args.path, args.self_actor_id)
        res = restore(args.path, cfg.db.path)
        print(
            f"restored {res.new_len} bytes over {res.old_len}"
            f" (wal={res.is_wal})"
        )
        return 0
    if cmd == "cluster":
        if args.sub == "set-id":
            return await _admin_call(
                cfg,
                {"cmd": "cluster", "sub": "set-id",
                 "cluster_id": args.cluster_id},
            )
        return await _admin_call(cfg, {"cmd": "cluster", "sub": args.sub})
    if cmd == "consul":
        from corrosion_tpu_torch.consul import run_consul_sync_cli

        return await run_consul_sync_cli(cfg)
    if cmd == "query":
        return await _cmd_query(cfg, args)
    if cmd == "exec":
        return await _cmd_exec(cfg, args)
    if cmd == "reload":
        return await _cmd_reload(cfg)
    if cmd == "sync":
        return await _admin_call(cfg, {"cmd": "sync", "sub": args.sub})
    if cmd == "locks":
        return await _admin_call(cfg, {"cmd": "locks", "top": args.top})
    if cmd == "traces":
        return await _cmd_traces(cfg, args)
    if cmd == "alerts":
        return await _cmd_alerts(cfg, args)
    if cmd == "profile":
        return await _cmd_profile(cfg, args)
    if cmd == "actor":
        return await _admin_call(
            cfg,
            {"cmd": "actor", "sub": "version",
             "actor_id": args.actor_id, "version": args.version},
        )
    if cmd == "template":
        return await _cmd_template(cfg, args)
    if cmd == "tls":
        from corrosion_tpu_torch import tls as _tls

        if args.sub == "ca":
            _tls.generate_ca(args.cert_file, args.key_file)
            print(f"wrote {args.cert_file}, {args.key_file}")
        elif args.sub == "server":
            _tls.generate_server_cert(
                args.ca_cert, args.ca_key, args.ip,
                args.cert_file, args.key_file,
            )
            print(f"wrote {args.cert_file}, {args.key_file}")
        elif args.sub == "client":
            _tls.generate_client_cert(
                args.ca_cert, args.ca_key,
                args.cert_file, args.key_file,
            )
            print(f"wrote {args.cert_file}, {args.key_file}")
        return 0
    if cmd == "db":
        return _cmd_db_lock(cfg, args.cmd)
    if cmd == "subs":
        if args.sub == "list":
            return await _admin_call(cfg, {"cmd": "subs", "sub": "list"})
        payload = {"cmd": "subs", "sub": "info"}
        if args.id:
            payload["id"] = args.id
        if args.hash:
            payload["hash"] = args.hash
        return await _admin_call(cfg, payload)
    if cmd == "devcluster":
        from pathlib import Path as _P

        from corrosion_tpu_torch.devcluster import run_devcluster_cli

        schema_sql = _P(args.schema).read_text() if args.schema else ""
        return await run_devcluster_cli(cfg, args.topology, schema_sql,
                                        device=args.device)
    if cmd == "log":
        if args.sub == "set":
            return await _admin_call(
                cfg, {"cmd": "log", "sub": "set", "filter": args.filter}
            )
        return await _admin_call(cfg, {"cmd": "log", "sub": "reset"})
    print(f"unknown command {cmd}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> None:
    sys.exit(asyncio.run(_amain(argv)))


if __name__ == "__main__":
    main()
