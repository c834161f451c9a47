"""Pubsub serving throughput on the port: sustained write → subscription
event rate, scaled along table rows × live subscriptions.

The port's program of `scripts/bench_pubsub.py`. One port agent on the
in-memory network serves its HTTP/2 API (`api/http.py`); a writer posts
`INSERT ... ON CONFLICT` upserts in batches to `/v1/transactions` while
NDJSON subscription streams count the change events they receive: the
change router, the matchers' diffs, the shared diff executor, the
per-sub SQLite databases, the fan-out writer and the h2 front all sit
in the path.

Every write is a local commit, which runs no merge engine (as in
`chip_smoke.py`'s `agent_local_writes`): on the card's machine this
measures the host's serving plane, not the card. The agent's store
still opens on the card (`device=None`: `cuda:0`, or a RuntimeError
without CUDA).

    python -m corrosion_tpu_torch.pubsub_bench [n_rows] [batch]
    python -m corrosion_tpu_torch.pubsub_bench --subs N [--distinct] [n_rows] [batch]
    python -m corrosion_tpu_torch.pubsub_bench --all [--tag T]
        the grid: rows {5k, 20k, 80k} × 1 sub, 5k × {1, 16, 128} subs
        (shared SQL), and 5k × 16 distinct matchers
    python -m corrosion_tpu_torch.pubsub_bench --streams N [--queries K] [--rows R]
        one SUBS_SCALE rung: N streams over K distinct queries
    python -m corrosion_tpu_torch.pubsub_bench --scale [--ab] [--tag T]
        the SUBS_SCALE ladder (1k × 10 shared, 1k distinct, 10k × 10
        shared, 100k × 10 shared; `--ab` runs each rung up to 10k with
        the per-stream queue fan-out, then the shared writer)

Run it from the repo root with `-m` (the package's `random.py` must not
shadow the stdlib's). Rungs merge by name into `PUBSUB_BENCH_H100.json`
and `SUBS_SCALE_H100.json` in the working directory; the JAX package's
banked `PUBSUB_BENCH.json` and `SUBS_SCALE.json` are never written.
`code_sha` covers the port's measured files.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import math
import os
import sys
import tempfile
import time

from corrosion_tpu_torch import agent_checks as ac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBSUB_OUT = "PUBSUB_BENCH_H100.json"
SCALE_OUT = "SUBS_SCALE_H100.json"

_MEASURED_FILES = (
    "corrosion_tpu_torch/pubsub/matcher.py",
    "corrosion_tpu_torch/pubsub/manager.py",
    "corrosion_tpu_torch/pubsub/executor.py",
    "corrosion_tpu_torch/pubsub/fanout.py",
    "corrosion_tpu_torch/api/pubsub_http.py",
    "corrosion_tpu_torch/api/http.py",
    "corrosion_tpu_torch/api/h2front.py",
    "corrosion_tpu_torch/net/h2.py",
    "corrosion_tpu_torch/pubsub_bench.py",
)

_UPSERT = ("INSERT INTO tests (id, text) VALUES (?, ?) "
           "ON CONFLICT (id) DO UPDATE SET text = excluded.text")


def _code_fingerprint() -> dict:
    out = {}
    for rel in _MEASURED_FILES:
        try:
            with open(os.path.join(REPO, rel), "rb") as f:
                out[rel] = hashlib.sha256(f.read()).hexdigest()[:12]
        except OSError:
            out[rel] = "missing"
    return out


def _upserts(start: int, stop: int) -> list:
    return [[_UPSERT, [i, f"v{i}"]] for i in range(start, stop)]


async def _boot(device, addr: str, db_dir: str):
    api = ac.port_api(device)
    agent, server, client = await ac.boot_with_api(
        api, api.MemNetwork(seed=9), addr, db_dir)
    return api, agent, server, client


async def _close(api, agent, server, clients) -> None:
    for c in clients:
        await c.close()
    await server.stop()
    await api.shutdown(agent)


async def main(
    n_rows: int,
    batch: int,
    n_subs: int = 1,
    tag: str = "",
    distinct: bool = False,
    device=None,
) -> dict:
    """One rung: `n_subs` streams (identical SQL, deduped onto one
    matcher; or `distinct` predicates, one matcher each) count change
    lines until each has `n_rows`, while the writer upserts `n_rows`
    rows in batches of `batch`."""
    with tempfile.TemporaryDirectory() as db_dir:
        api, agent, server, client = await _boot(
            device, "agent-pubsub", db_dir)
        sub_clients = [api.CorrosionApiClient(server.addrs[0])
                       for _ in range(n_subs)]
        done_counts = [0] * n_subs

        async def subscriber(k: int) -> None:
            sql = (f"SELECT id, text FROM tests WHERE id >= -{k + 1}"
                   if distinct else "SELECT id, text FROM tests")
            # raw lines: the bench measures the serving plane, not the
            # harness's JSON decoder
            async for line in sub_clients[k].subscribe(
                    sql, skip_rows=True, raw=True):
                if line.startswith('{"change":'):
                    done_counts[k] += 1
                    if done_counts[k] >= n_rows:
                        return
                elif line.startswith('{"error":'):
                    raise RuntimeError(
                        f"subscriber {k} got error frame: {line}")

        sub_tasks = [asyncio.ensure_future(subscriber(k))
                     for k in range(n_subs)]
        try:
            await asyncio.sleep(0.5 + 0.01 * n_subs)  # streams established
            t0 = time.monotonic()
            for start in range(0, n_rows, batch):
                await client.execute(
                    _upserts(start, min(start + batch, n_rows)))
            write_wall = time.monotonic() - t0
            # the tasks, not an event: a subscriber's crash surfaces
            await asyncio.wait_for(asyncio.gather(*sub_tasks), 600)
            total_wall = time.monotonic() - t0
            got = sum(done_counts)
            rung = f"pubsub-{n_rows}" + (
                f"x{n_subs}{'d' if distinct else ''}" if n_subs != 1
                else "")
            return {
                "rung": rung + (f"-{tag}" if tag else ""),
                "n_rows": n_rows,
                "n_subs": n_subs,
                "distinct_matchers": bool(distinct and n_subs != 1),
                "batch": batch,
                "write_wall_s": write_wall,
                "events_delivered": got,
                "event_rate_per_s": got / total_wall,
                "event_rate_per_sub_per_s": got / n_subs / total_wall,
                "write_rate_per_s": n_rows / write_wall,
                "total_wall_s": total_wall,
                "code_sha": _code_fingerprint(),
                "measured_at": time.strftime("%Y-%m-%d %H:%M:%S",
                                             time.gmtime()),
            }
        finally:
            for t in sub_tasks:
                t.cancel()
            await _close(api, agent, server, [client, *sub_clients])


# -- the stream-count ladder ----------------------------------------------------


def _reg_peek(snap, name, labels=None):
    total = 0.0
    for _k, sname, slabels, value in snap:
        if sname == name and (labels is None or slabels == labels):
            total += value
    return total


async def streams_rung(
    n_streams: int,
    n_queries: int,
    n_rows: int,
    tag: str = "",
    distinct: bool = False,
    fanout: str = "writer",
    device=None,
) -> dict:
    """One SUBS_SCALE rung: N live NDJSON streams over K distinct
    queries on one node, every event delivered to every stream, on raw
    h2 clients with widened receive windows (flow control measures the
    server's fan-out, not the harness's 64 KiB default)."""
    from corrosion_tpu_torch.net.h2 import H2Client
    from corrosion_tpu_torch.runtime.latency import snapshot_stages
    from corrosion_tpu_torch.runtime.metrics import METRICS

    if distinct:
        n_queries = n_streams
    with tempfile.TemporaryDirectory() as db_dir:
        api, agent, server, client = await _boot(
            device, "agent-subs-scale", db_dir)
        agent.config.subs.fanout = fanout
        agent.config.subs.max_streams = max(n_streams, 1)
        host, port = server.addrs[0].rsplit(":", 1)
        # ~250 streams per connection (the server advertises
        # MAX_CONCURRENT_STREAMS=256)
        n_conns = max(1, math.ceil(n_streams / 250))
        h2s = [H2Client(host, int(port), recv_window=1 << 20,
                        conn_recv_window=64 << 20)
               for _ in range(n_conns)]
        queries = [f"SELECT id, text FROM tests WHERE id >= -{q + 1}"
                   for q in range(n_queries)]
        want = n_rows + 2  # columns + eoq + n_rows change lines
        counts = [0] * n_streams
        done_evt = asyncio.Event()
        remaining = [n_streams]
        tasks = []

        async def consume(resp, k: int) -> None:
            async for chunk in resp.body():
                counts[k] += chunk.count(b"\n")
                if counts[k] >= want:
                    break
            remaining[0] -= 1
            if remaining[0] == 0:
                done_evt.set()

        async def subscribe_one(k: int):
            body = json.dumps(queries[k % n_queries]).encode()
            resp = await h2s[k % n_conns].request(
                "POST", "/v1/subscriptions?skip_rows=true",
                headers={"content-type": "application/json"}, body=body)
            if resp.status != 200:
                raise RuntimeError(
                    f"stream {k}: {resp.status} {await resp.read()!r}")
            return asyncio.ensure_future(consume(resp, k))

        try:
            t_setup = time.monotonic()
            for base in range(0, n_streams, 256):
                tasks.extend(await asyncio.gather(*(
                    subscribe_one(k)
                    for k in range(base, min(base + 256, n_streams)))))
                if base % 10240 == 0 and base:
                    print(f"  ... {base} streams attached", flush=True)
            setup_wall = time.monotonic() - t_setup
            matchers = len(server.subs.handles())

            # one stream past the ceiling must get the typed 503
            probe = await h2s[0].request(
                "POST", "/v1/subscriptions?skip_rows=true",
                headers={"content-type": "application/json"},
                body=json.dumps(queries[0]).encode())
            probe_body = await probe.read()
            admission_rejected = (probe.status == 503
                                  and b"subs_admission" in probe_body)

            pre = snapshot_stages()
            snap0 = METRICS.snapshot()
            t0 = time.monotonic()
            for start in range(0, n_rows, 50):
                await client.execute(
                    _upserts(start, min(start + 50, n_rows)))
            write_wall = time.monotonic() - t0
            try:
                await asyncio.wait_for(done_evt.wait(), 900)
            except asyncio.TimeoutError:
                pass  # recorded below through events_delivered
            total_wall = time.monotonic() - t0

            deliver = snapshot_stages()["deliver"].diff(pre["deliver"])
            snap1 = METRICS.snapshot()

            def delta(name):
                return _reg_peek(snap1, name) - _reg_peek(snap0, name)

            delivered = sum(min(max(0, c - 2), n_rows) for c in counts)
            matcher_s = delta("corro.subs.process.time.seconds_sum")
            writer_s = delta("corro.subs.writer.round.seconds_sum")
            return {
                "rung": f"subs-{n_streams}x{n_queries}"
                        f"{'d' if distinct else ''}"
                        + (f"-{tag}" if tag else ""),
                "fanout": fanout,
                "streams": n_streams,
                "queries": n_queries,
                "matchers": matchers,
                "dedupe_ratio": n_streams / max(1, matchers),
                "n_rows": n_rows,
                "events_expected": n_streams * n_rows,
                "events_delivered": delivered,
                "streams_complete": sum(1 for c in counts if c >= want),
                "admission": {
                    "max_streams": agent.config.subs.max_streams,
                    "over_limit_probe_rejected": admission_rejected,
                },
                "shed": delta("corro.subs.shed.total"),
                "deliver_p50_s": deliver.quantile(0.50),
                "deliver_p99_s": deliver.quantile(0.99),
                "deliver_observed": deliver.count,
                "matcher_seconds": matcher_s,
                "writer_walk_seconds": writer_s,
                "per_event_server_us":
                    (matcher_s + writer_s) / max(1, delivered) * 1e6,
                "writer_writes": delta("corro.subs.writer.writes.total"),
                "writer_coalesced_batches": delta(
                    "corro.subs.writer.coalesced.batches.total"),
                "setup_wall_s": setup_wall,
                "write_wall_s": write_wall,
                "total_wall_s": total_wall,
                "event_rate_per_s": delivered / max(1e-9, total_wall),
                "code_sha": _code_fingerprint(),
                "measured_at": time.strftime("%Y-%m-%d %H:%M:%S",
                                             time.gmtime()),
            }
        finally:
            for t in tasks:
                t.cancel()
            for h in h2s:
                try:
                    await h.close()
                except Exception:
                    pass
            await _close(api, agent, server, [client])


# (streams, queries, n_rows, distinct); the 100k rung keeps event volume
# small: 100k streams × 20 events is 2M deliveries
SCALE_RUNGS = (
    (1_000, 10, 200, False),
    (1_000, 0, 50, True),  # distinct: queries = streams
    (10_000, 10, 100, False),
    (100_000, 10, 20, False),
)

# (n_rows, batch, n_subs, distinct): rows axis at 1 sub, subs axis at 5k
# rows (one matcher by dedupe), and one distinct-matcher rung
ALL_RUNGS = (
    (5_000, 50, 1, False),
    (20_000, 50, 1, False),
    (80_000, 50, 1, False),
    (5_000, 50, 16, False),
    (5_000, 50, 128, False),
    (5_000, 50, 16, True),
)


def _merge(path: str, recs) -> None:
    from corrosion_tpu_torch.runtime.records import merge_records

    merge_records(path, recs)
    try:
        os.remove(path + ".lock")
    except OSError:
        pass


def _run_scale(tag: str, ab: bool) -> None:
    recs = []
    for n_streams, n_queries, n_rows, distinct in SCALE_RUNGS:
        if ab and n_streams <= 10_000:
            modes = (("queue", "pre"), ("writer", "post"))
        else:
            modes = (("writer", "post" if ab else ""),)
        for mode, mtag in modes:
            t = "-".join(x for x in (mtag, tag) if x)
            rec = asyncio.run(streams_rung(
                n_streams, n_queries, n_rows, t, distinct, mode))
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    _merge(SCALE_OUT, recs)


def _run_and_merge(rungs, tag: str) -> None:
    recs = []
    for n_rows, batch, n_subs, distinct in rungs:
        rec = asyncio.run(main(n_rows, batch, n_subs, tag, distinct))
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    _merge(PUBSUB_OUT, recs)


def _take(args: list, flag: str, default=None, cast=int):
    if flag not in args:
        return default
    i = args.index(flag)
    val = cast(args[i + 1])
    del args[i:i + 2]
    return val


def _cli(argv) -> None:
    args = list(argv)
    tag = _take(args, "--tag", "", str)
    flags = {f: f in args for f in ("--ab", "--distinct", "--scale", "--all")}
    for f, on in flags.items():
        if on:
            args.remove(f)
    if flags["--scale"]:
        _run_scale(tag, flags["--ab"])
        return
    n_streams = _take(args, "--streams")
    if n_streams is not None:
        n_queries = _take(args, "--queries", 10)
        n_rows = _take(args, "--rows", 100)
        rec = asyncio.run(streams_rung(n_streams, n_queries, n_rows, tag,
                                       flags["--distinct"]))
        print(json.dumps(rec), flush=True)
        _merge(SCALE_OUT, [rec])
        return
    if flags["--all"]:
        _run_and_merge(ALL_RUNGS, tag)
        return
    n_subs = _take(args, "--subs", 1)
    n_rows = int(args[0]) if args else 20_000
    batch = int(args[1]) if len(args) > 1 else 50
    _run_and_merge([(n_rows, batch, n_subs, flags["--distinct"])], tag)


if __name__ == "__main__":
    _cli(sys.argv[1:])
