"""Admin socket: JSON-framed command protocol over a unix domain socket.

The port's copy of `corrosion_tpu/admin.py`.

Counterpart of the reference's admin UDS server (`klukai/src/admin.rs:217-780`):
a LengthDelimited+JSON protocol whose Command enum covers cluster
introspection and repair. Frames here are 4-byte big-endian length + JSON.

Commands (JSON objects):
  {"cmd": "ping"}
  {"cmd": "sync", "sub": "generate"}            — debug dump of generate_sync
  {"cmd": "sync", "sub": "reconcile-gaps"}      — rebuild gap bookkeeping
  {"cmd": "locks", "top": N}                    — longest-held live locks
  {"cmd": "cluster", "sub": "members"}
  {"cmd": "cluster", "sub": "membership-states"}
  {"cmd": "cluster", "sub": "rejoin"}
  {"cmd": "cluster", "sub": "set-id", "cluster_id": N}
  {"cmd": "actor", "sub": "version", "actor_id": hex, "version": N}
  {"cmd": "subs", "sub": "list"}
  {"cmd": "subs", "sub": "info", "id"|"hash": ...}
  {"cmd": "log", "sub": "set", "filter": "name=LEVEL,..."}
  {"cmd": "log", "sub": "reset"}

Responses stream until a terminal one:
  {"kind": "log", "msg": ...}    (zero or more)
  {"kind": "json", "value": ...} (zero or more)
  {"kind": "success"} | {"kind": "error", "msg": ...}
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import struct
from typing import Any, AsyncIterator, Dict, List, Optional

from corrosion_tpu_torch.sync import generate_sync
from corrosion_tpu_torch.types.actor import ActorId, ClusterId

log = logging.getLogger(__name__)

_MAX_FRAME = 16 * 1024 * 1024


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > _MAX_FRAME:
        raise ValueError(f"admin frame too large: {n}")
    body = await reader.readexactly(n)
    return json.loads(body)


def write_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode()
    writer.write(struct.pack(">I", len(body)) + body)


class AdminServer:
    """Serves admin commands for a running Agent on a unix socket."""

    def __init__(self, agent, path: str):
        self.agent = agent
        self.path = path
        self._server: Optional[asyncio.AbstractServer] = None
        # remembered root level for `log reset`
        self._log_baseline = logging.getLogger().level

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(
            self._handle_conn, path=self.path
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                cmd = await read_frame(reader)
                if cmd is None:
                    break
                try:
                    for resp in await self._dispatch(cmd):
                        write_frame(writer, resp)
                except Exception as e:  # any handler error → Error response
                    log.exception("admin command failed: %r", cmd)
                    write_frame(writer, {"kind": "error", "msg": str(e)})
                await writer.drain()
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _dispatch(self, cmd: dict) -> List[dict]:
        name = cmd.get("cmd")
        sub = cmd.get("sub")
        if name == "ping":
            return [{"kind": "json", "value": "pong"}, {"kind": "success"}]
        if name == "sync" and sub == "generate":
            # Store scans take the store lock and can be slow on a large
            # db; keep them off the agent's event loop so gossip timers
            # and HTTP streams don't stall for the duration.
            return await asyncio.to_thread(self._sync_generate)
        if name == "sync" and sub == "reconcile-gaps":
            return await asyncio.to_thread(self._reconcile_gaps)
        if name == "locks":
            return self._locks(cmd.get("top"))
        if name == "cluster" and sub == "members":
            return self._cluster_members()
        if name == "cluster" and sub == "membership-states":
            return self._membership_states()
        if name == "cluster" and sub == "rejoin":
            actor = await self.agent.membership.rejoin()
            return [
                {"kind": "log", "msg": f"rejoined as {actor.id}"},
                {"kind": "success"},
            ]
        if name == "cluster" and sub == "set-id":
            cid = ClusterId(int(cmd["cluster_id"]))
            actor = await self.agent.membership.change_cluster_id(cid)
            self.agent.actor = actor
            return [
                {"kind": "log", "msg": f"cluster id set to {cid.value}"},
                {"kind": "success"},
            ]
        if name == "actor" and sub == "version":
            return self._actor_version(
                cmd["actor_id"], int(cmd["version"])
            )
        if name == "subs" and sub == "list":
            return self._subs_list()
        if name == "subs" and sub == "info":
            return self._subs_info(cmd.get("id"), cmd.get("hash"))
        if name == "log" and sub == "set":
            return self._log_set(cmd["filter"])
        if name == "log" and sub == "reset":
            return self._log_reset()
        return [{"kind": "error", "msg": f"unknown command: {cmd}"}]

    # -- handlers ----------------------------------------------------------

    def _sync_generate(self) -> List[dict]:
        state = generate_sync(self.agent.bookie, self.agent.actor_id)
        value = {
            "actor_id": str(state.actor_id),
            "heads": {str(a): h for a, h in state.heads.items()},
            "need": {
                str(a): [list(r) for r in rs] for a, rs in state.need.items()
            },
            "partial_need": {
                str(a): {
                    str(v): [list(r) for r in rs] for v, rs in vs.items()
                }
                for a, vs in state.partial_need.items()
            },
        }
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _reconcile_gaps(self) -> List[dict]:
        """Drop gap claims disproved by the clock tables — versions the gap
        bookkeeping says are missing but whose changes are actually present
        (admin.rs Command::ReconcileGaps — the repair tool). Conservative:
        never *adds* gaps, since overwritten ("cleared") versions
        legitimately leave no clock rows."""
        out: List[dict] = []
        fixed = 0
        for aid in self.agent.store.booked_actor_ids():
            present = self.agent.store.present_versions(aid)
            booked = self.agent.bookie.ensure(aid)
            with booked.write("reconcile") as bv:
                before = list(bv.needed)
                for s, e in present:
                    bv.needed.remove(s, e)
                after = list(bv.needed)
                if before != after:
                    fixed += 1
                    self.agent.store.rewrite_gaps(aid, bv.needed)
                    out.append(
                        {
                            "kind": "log",
                            "msg": f"actor {aid}: gaps {before} -> {after}",
                        }
                    )
        out.append({"kind": "json", "value": {"actors_fixed": fixed}})
        out.append({"kind": "success"})
        return out

    def _locks(self, top: Optional[int]) -> List[dict]:
        registry = getattr(self.agent, "lock_registry", None)
        snap = registry.snapshot(top) if registry is not None else []
        value = [
            {
                "id": m.id,
                "label": m.label,
                "kind": m.kind,
                "state": m.state,
                "held_s": round(m.held_for(), 3),
            }
            for m in snap
        ]
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _cluster_members(self) -> List[dict]:
        value = []
        for actor in self.agent.members.all_actors():
            info = self.agent.members.get(actor.id)
            rtts = self.agent.members.rtts.get(actor.addr)
            value.append(
                {
                    "id": str(actor.id),
                    "addr": actor.addr,
                    "cluster_id": actor.cluster_id.value,
                    "ring": getattr(info, "ring", None),
                    "rtt_min_ms": round(min(rtts) * 1000, 3) if rtts else None,
                }
            )
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _membership_states(self) -> List[dict]:
        ms = self.agent.membership
        value = [
            {
                "id": str(m.actor.id),
                "addr": m.actor.addr,
                "state": m.state.name,
                "incarnation": m.incarnation,
            }
            for m in ms.members.values()
        ]
        value.append(
            {
                "id": str(ms.identity.id),
                "addr": ms.identity.addr,
                "state": "ALIVE",
                "incarnation": ms._incarnation,
                "self": True,
            }
        )
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _actor_version(self, actor_hex: str, version: int) -> List[dict]:
        aid = ActorId.from_uuid_str(actor_hex)
        booked = self.agent.bookie.get(aid)
        if booked is None:
            return [{"kind": "error", "msg": f"unknown actor {actor_hex}"}]
        with booked.read() as bv:
            if bv.contains_version(version):
                partial = bv.get_partial(version)
                if partial is not None and not partial.is_complete():
                    value: Any = {
                        "state": "partial",
                        "seqs": [list(r) for r in partial.gaps()],
                    }
                else:
                    value = {"state": "current"}
            else:
                value = {"state": "unknown"}
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _subs_list(self) -> List[dict]:
        subs = self.agent.subs
        value = []
        if subs is not None:
            for handle in subs.handles():
                value.append(
                    {
                        "id": handle.id,
                        "hash": handle.hash,
                        "sql": handle.sql,
                        "subscribers": handle.subscriber_count,
                        "last_change_id": handle.last_change_id,
                    }
                )
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _subs_info(
        self, sub_id: Optional[str], sql_hash: Optional[str]
    ) -> List[dict]:
        subs = self.agent.subs
        handle = None
        if subs is not None:
            if sub_id is not None:
                handle = subs.get(sub_id)
            elif sql_hash is not None:
                for h in subs.handles():
                    if h.hash == sql_hash:
                        handle = h
                        break
        if handle is None:
            return [{"kind": "error", "msg": "unknown subscription"}]
        value = {
            "id": handle.id,
            "hash": handle.hash,
            "sql": handle.sql,
            "columns": handle.columns,
            "subscribers": handle.subscriber_count,
            "last_change_id": handle.last_change_id,
            "processed": handle.processed,
            "created_at": handle.created_at,
            "error": handle.error,
        }
        return [{"kind": "json", "value": value}, {"kind": "success"}]

    def _log_set(self, filter_spec: str) -> List[dict]:
        """Dynamic log-filter reload (admin.rs:215 TracingHandle). Spec:
        "LEVEL" for root or "logger=LEVEL,logger2=LEVEL2"."""
        for part in filter_spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                name, _, level = part.partition("=")
                logging.getLogger(name.strip()).setLevel(
                    level.strip().upper()
                )
            else:
                logging.getLogger().setLevel(part.upper())
        return [
            {"kind": "log", "msg": f"log filter set: {filter_spec}"},
            {"kind": "success"},
        ]

    def _log_reset(self) -> List[dict]:
        root = logging.getLogger()
        root.setLevel(self._log_baseline)
        # drop per-module overrides
        for name in list(logging.Logger.manager.loggerDict):
            if name.startswith("corrosion_tpu_torch"):
                logging.getLogger(name).setLevel(logging.NOTSET)
        return [{"kind": "log", "msg": "log filter reset"}, {"kind": "success"}]


class AdminClient:
    """Client side of the admin protocol (used by the CLI)."""

    def __init__(self, path: str):
        self.path = path
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def __aenter__(self) -> "AdminClient":
        self._reader, self._writer = await asyncio.open_unix_connection(
            self.path
        )
        return self

    async def __aexit__(self, *exc) -> None:
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()

    async def send(self, cmd: dict) -> AsyncIterator[dict]:
        assert self._reader is not None and self._writer is not None
        write_frame(self._writer, cmd)
        await self._writer.drain()
        while True:
            resp = await read_frame(self._reader)
            if resp is None:
                raise ConnectionError("admin connection closed mid-response")
            yield resp
            if resp.get("kind") in ("success", "error"):
                break

    async def call(self, cmd: dict) -> Dict[str, Any]:
        """Collect a full response: {'ok': bool, 'json': [...], 'logs': [...]}"""
        logs: List[str] = []
        values: List[Any] = []
        ok = False
        err: Optional[str] = None
        async for resp in self.send(cmd):
            kind = resp.get("kind")
            if kind == "log":
                logs.append(resp["msg"])
            elif kind == "json":
                values.append(resp["value"])
            elif kind == "success":
                ok = True
            elif kind == "error":
                err = resp.get("msg")
        return {"ok": ok, "error": err, "json": values, "logs": logs}
