"""Bridge scale rung on the card: ONE real SWIM prober tracking a
kernel-simulated population through normal SWIM channels — the port's
copy of `scripts/bridge_scale.py`.

    python -m corrosion_tpu_torch.bridge_scale [n_sim] [n_crash] [mode]
        [--out PATH]          (default 10000 20 silent)

The population is a dense `ClusterSim(n_sim, seed=3)` on the card,
fronted by a `KernelPeerBridge`; the prober is the port's standalone
`agent/membership.py::Membership` with the agent's fast test timings
(`FAST_SWIM`), wired as the agent wires its SWIM layer: a listener whose
datagram handler calls `handle_datagram`, and a `Tripwire` for its
loops. The prober announces through `sim:0` and must absorb every member
(FEED and piggyback alone); then the bridge crashes every
(n_sim // n_crash)-th member on the device and `refresh()`es, and the
prober must down exactly the crashed set. One JSON line is printed; it
is merged into `--out` only when that is given.

Detection modes:
  silent — crashed virtual members just go quiet; the prober's own
           probe/suspicion pipeline must find them. Detection is bound
           by the probe sweep (~n * probe_period).
  gossip — the bridge gossips the kernel's ground-truth DOWNs, so
           detection reaches the prober epidemically, as a real cluster
           collectively detects. A lone prober sweeping 100,000 members
           would need ~84 min per cycle, so the 100,000 rung uses this.

Run it as a module from the repo root (`-m`): the package's own
`random.py` must not shadow the standard library's.

The module also holds the two other bridge scenarios `chip_smoke.py`
and the tests drive: `silent_pipeline` (n=192, three silent crashes, the
prober's own detection) and the scripted datagram exchange
`wire_replies` (the bridge's replies, compared byte for byte).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import hashlib
import json
import random
import statistics
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from corrosion_tpu_torch.agent.membership import Membership, SwimConfig
from corrosion_tpu_torch.models.bridge import KernelPeerBridge, sim_actor_id
from corrosion_tpu_torch.models.cluster import ClusterSim
from corrosion_tpu_torch.net.gossip_codec import (
    MemberState,
    MsgKind,
    SwimMessage,
    encode_swim,
)
from corrosion_tpu_torch.net.mem import MemNetwork
from corrosion_tpu_torch.runtime.device import resolve_device
from corrosion_tpu_torch.runtime.records import merge_records
from corrosion_tpu_torch.runtime.tripwire import Tripwire
from corrosion_tpu_torch.types.actor import Actor, ActorId
from corrosion_tpu_torch.types.base import Timestamp

# the agent tests' fast SWIM timings (tests/test_agent.py FAST_SWIM)
FAST_SWIM = SwimConfig(probe_period=0.05, probe_rtt=0.02, suspicion_mult=1.0)


async def wait_until(pred, timeout=10.0, step=0.02) -> bool:
    """Poll `pred()` every `step` s until it holds or `timeout` passes."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(step)
    return pred()


async def wait_progress(pred, progress, stall=30.0, cap=900.0,
                        step=0.05) -> bool:
    """Wait for ``pred()``; fail only on a stall, not on wall clock.

    ``progress()`` returns any comparable snapshot; while it keeps
    changing, the wait continues. ``stall`` bounds how long progress may
    freeze, ``cap`` the whole wait. The stall clock is
    starvation-compensated: a wakeup far past its ``step`` sleep means
    the process (and the nodes sharing this event loop) was
    descheduled, so such a gap charges one step, not its wall duration."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    last = progress()
    silence = 0.0
    prev = t0
    while True:
        if pred():
            return True
        now = loop.time()
        dt, prev = now - prev, now
        silence += dt if dt <= 5 * step else step
        cur = progress()
        if cur != last:
            last, silence = cur, 0.0
        if silence > stall:
            return pred()  # stalled: one final check
        if now - t0 > cap:
            return pred()
        await asyncio.sleep(step)


class Prober:
    """A standalone `Membership` on `net` at `addr`, serving datagrams.

    Use `await Prober.start(net, addr)`; `membership` is the SWIM
    instance, `close()` trips its loops and unregisters it."""

    def __init__(self, net, addr: str):
        identity = Actor(
            id=ActorId(hashlib.blake2b(addr.encode(), digest_size=16)
                       .digest()),
            addr=addr,
            ts=Timestamp.now(),
        )
        self.membership = Membership(
            identity, net.transport(addr), FAST_SWIM,
            rng=random.Random(identity.id.bytes16[:8].hex()),
        )
        self.tripwire = Tripwire()
        self.listener = net.listener(addr)

    @classmethod
    async def start(cls, net, addr: str = "agent-real") -> "Prober":
        p = cls(net, addr)
        ms = p.membership

        async def on_datagram(src: str, data: bytes) -> None:
            await ms.handle_datagram(src, data)

        async def on_uni(src: str, data: bytes) -> None:
            pass  # the prober takes no broadcasts

        async def on_bi(stream) -> None:
            stream.close()

        p.listener.serve(on_datagram, on_uni, on_bi)
        ms.start(p.tripwire)
        return p

    async def close(self) -> None:
        self.tripwire.trip()
        await self.membership.stop()
        await self.listener.close()


def crash_set(n_sim: int, n_crash: int) -> List[int]:
    """Every (n_sim // n_crash)-th member, n_crash of them."""
    if n_crash <= 0:
        return []  # pure-absorption rung
    return list(range(0, n_sim, max(1, n_sim // n_crash)))[:n_crash]


async def rung(n_sim: int, n_crash: int, mode: str = "silent",
               device=None) -> dict:
    """One rung of the reference script: absorb, crash, detect. Returns
    its record, plus the device the view lives on, the median ms of five
    `refresh()` calls and, on the card, the run's peak device memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's stats exist only after it
        torch.cuda.reset_peak_memory_stats(dev)
    net = MemNetwork(seed=11)
    sim = ClusterSim(n_sim, seed=3, device=dev)
    bridge = KernelPeerBridge(net, sim, gossip_down=(mode == "gossip"))
    bridge.start()
    prober = await Prober.start(net, "agent-real")
    ms = prober.membership
    try:
        t0 = time.monotonic()
        await ms.announce(bridge.addr(0))
        # progress-based: absorption may take minutes at 100k, so only a
        # genuine stall fails the rung
        absorbed = await wait_progress(
            lambda: ms.cluster_size >= n_sim + 1,
            lambda: ms.cluster_size,
            stall=60.0, cap=3600.0, step=0.25,
        )
        absorb_s = time.monotonic() - t0
        print(f"absorbed={absorbed} size={ms.cluster_size} "
              f"in {absorb_s:.1f}s", flush=True)

        dead = crash_set(n_sim, n_crash)
        dead_ids = {sim_actor_id(j) for j in dead}
        for j in dead:
            bridge.crash(j)
        # one real prober sweeps the ring at ~probe_period per member:
        # worst-case detection of the last crash is about a full cycle
        # plus the suspicion window; give it two cycles of headroom
        detect_budget = max(600.0, n_sim * 0.05 * 2 + 120.0)
        t0 = time.monotonic()
        detected = await wait_until(
            lambda: dead_ids <= set(ms.downed), timeout=detect_budget,
            step=0.25,
        )
        detect_s = time.monotonic() - t0
        fp = len(set(ms.downed) - dead_ids)
        print(f"detected={detected} in {detect_s:.1f}s fp={fp}", flush=True)
        refresh_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            bridge.refresh()  # ends in its device-to-host copies
            refresh_ms.append(1e3 * (time.perf_counter() - t1))
        rec = {
            "rung": f"bridge-{n_sim}" + ("" if mode == "silent"
                                         else f"-{mode}"),
            "n_sim": n_sim,
            "n_crash": len(dead),
            "mode": mode,
            "absorbed": absorbed,
            "absorb_s": absorb_s,
            "detected": detected,
            "detect_all_s": detect_s,
            "false_positives": fp,
            "cluster_size": ms.cluster_size,
            "device": str(sim.state.view.device),
            "refresh_ms": statistics.median(refresh_ms),
        }
        if dev.type == "cuda":
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        return rec
    finally:
        await prober.close()
        await bridge.stop()


async def silent_pipeline(device=None, n_sim: int = 192,
                          dead: Sequence[int] = (7, 63, 150), net=None,
                          start: Callable = Prober.start) -> dict:
    """The silent-detection scenario of `tests/test_bridge.py`: absorb
    the population, `sim.step(5)` + `refresh()`, crash `dead` silently,
    and require the prober's own probe and suspicion to down exactly
    `dead`. Raises AssertionError on any miss or false positive; returns
    absorb and detect seconds. `net` and `start` let a caller put
    another prober (on its own network) in front of the same bridge."""
    net = MemNetwork(seed=11) if net is None else net
    sim = ClusterSim(n_sim, seed=3, device=device)
    bridge = KernelPeerBridge(net, sim, gossip_down=False)
    bridge.start()
    prober = await start(net, "agent-real")
    ms = prober.membership
    try:
        t0 = time.monotonic()
        await ms.announce(bridge.addr(0))
        if not await wait_until(lambda: ms.cluster_size >= n_sim + 1,
                                timeout=60.0):
            raise AssertionError(f"only {ms.cluster_size} of {n_sim + 1} "
                                 f"members learned")
        absorb_s = time.monotonic() - t0
        sim.step(5)  # the kernel keeps running underneath
        bridge.refresh()
        for j in dead:
            bridge.crash(j)
        # ids compared as bytes: the prober may be another package's
        dead_ids = {sim_actor_id(j).bytes16 for j in dead}

        def downed() -> set:
            return {i.bytes16 for i in ms.downed}

        def all_detected() -> bool:
            # suspected or already evicted by the prober's own pipeline
            suspect = {i.bytes16 for i, m in ms.members.items()
                       if m.state == MemberState.SUSPECT}
            return dead_ids <= downed() | suspect

        t0 = time.monotonic()
        if not (await wait_until(all_detected, timeout=60.0)
                and await wait_until(lambda: dead_ids <= downed(),
                                     timeout=60.0)):
            raise AssertionError(f"downed {len(dead_ids & downed())} of "
                                 f"{len(dead_ids)} crashed members")
        detect_s = time.monotonic() - t0
        if downed() != dead_ids:
            raise AssertionError(f"false positives: "
                                 f"{len(downed() - dead_ids)}")
        return {"n_sim": n_sim, "dead": list(dead), "absorb_s": absorb_s,
                "detect_s": detect_s, "cluster_size": ms.cluster_size,
                "device": str(sim.state.view.device)}
    finally:
        await prober.close()
        await bridge.stop()


# ---------------------------------------------------------------------------
# the scripted datagram exchange (chip_smoke.py's bridge_wire phase)

PROBER_ADDR, RELAY_ADDR = "agent:0", "agent:1"
_PROBER = Actor(ActorId(b"PROBER".ljust(16, b"\0")), PROBER_ADDR,
                Timestamp(1 << 32))
_RELAY = Actor(ActorId(b"RELAY".ljust(16, b"\0")), RELAY_ADDR,
               Timestamp(2 << 32))

Datagram = Tuple[str, str, bytes]  # (src, dst, bytes)


def _virtual(j: int) -> Actor:
    return Actor(sim_actor_id(j), f"sim:{j}")


def wire_datagrams(n: int) -> List[Datagram]:
    """One round of the script for a bridge of `n` members, member n // 3
    crashed: PING, ANNOUNCE, PING_REQ for a live virtual target, for the
    crashed one and for the non-virtual relay, INDIRECT_PING and
    INDIRECT_ACK from the relay, a PING to the crashed member,
    undecodable bytes, an ACK (no reaction), and a PING to the last
    member."""
    c = n // 3

    def msg(kind, probe_no, sender=_PROBER, **kw) -> bytes:
        return encode_swim(SwimMessage(kind, probe_no, sender, **kw))

    return [
        (PROBER_ADDR, "sim:1", msg(MsgKind.PING, 1)),
        (PROBER_ADDR, "sim:2", msg(MsgKind.ANNOUNCE, 0)),
        (PROBER_ADDR, "sim:3", msg(MsgKind.PING_REQ, 2, target=_virtual(4))),
        (PROBER_ADDR, "sim:3", msg(MsgKind.PING_REQ, 3, target=_virtual(c))),
        (PROBER_ADDR, "sim:3", msg(MsgKind.PING_REQ, 4, target=_RELAY)),
        (RELAY_ADDR, "sim:6", msg(MsgKind.INDIRECT_PING, 4, _RELAY,
                                  target=_virtual(6), origin=_PROBER)),
        (RELAY_ADDR, "sim:7", msg(MsgKind.INDIRECT_ACK, 4, _RELAY,
                                  origin=_PROBER)),
        (PROBER_ADDR, f"sim:{c}", msg(MsgKind.PING, 5)),
        (PROBER_ADDR, "sim:8", b"\xff\x00not a datagram"),
        (PROBER_ADDR, "sim:9", msg(MsgKind.ACK, 6)),
        (PROBER_ADDR, f"sim:{n - 1}", msg(MsgKind.PING, 7)),
    ]


async def _quiesce() -> None:
    """Yield until every other task of the loop has finished."""
    me = asyncio.current_task()
    while any(t is not me and not t.done() for t in asyncio.all_tasks()):
        await asyncio.sleep(0)


async def wire_replies(bridge, net,
                       serving: Callable = contextlib.nullcontext
                       ) -> List[Datagram]:
    """Run the script against `bridge` (on `net`, both of either
    package: only their common surface is used) and return every reply
    the prober and the relay received, in order. Three rounds of
    `wire_datagrams`: with member n // 3 crashed, after `sim.step(5)` +
    `refresh()`, and after member 2n // 3 crashes and n // 3 restarts
    (both enter the hot queue). Each round's sends and deliveries run
    inside `serving()`, so a caller can watch them (under a profiler)."""
    n = bridge.n
    captured: List[Datagram] = []
    listeners = []
    for addr in (PROBER_ADDR, RELAY_ADDR):
        async def on_datagram(src: str, data: bytes, dst=addr) -> None:
            captured.append((src, dst, data))

        async def on_uni(src: str, data: bytes) -> None:
            pass

        async def on_bi(stream) -> None:
            stream.close()

        lst = net.listener(addr)
        lst.serve(on_datagram, on_uni, on_bi)
        listeners.append(lst)
    bridge.start()
    try:
        bridge.crash(n // 3)
        for rnd in range(3):
            if rnd == 1:
                bridge.sim.step(5)
                bridge.refresh()
            elif rnd == 2:
                bridge.crash(2 * n // 3)
                bridge.restart(n // 3)
            with serving():
                for src, dst, data in wire_datagrams(n):
                    await net.transport(src).send_datagram(dst, data)
                    await _quiesce()
        return captured
    finally:
        await bridge.stop()
        for lst in listeners:
            await lst.close()


def wire_digest(replies: Sequence[Datagram]) -> str:
    """sha256 over the replies: src, dst and the bytes, each
    length-prefixed."""
    h = hashlib.sha256()
    for src, dst, data in replies:
        for part in (src.encode(), dst.encode(), data):
            h.update(len(part).to_bytes(4, "little"))
            h.update(part)
    return h.hexdigest()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_sim", nargs="?", type=int, default=10_000)
    ap.add_argument("n_crash", nargs="?", type=int, default=20)
    ap.add_argument("mode", nargs="?", default="silent",
                    choices=("silent", "gossip"))
    ap.add_argument("--out", help="merge the record into this JSON list "
                                  "file (by its 'rung')")
    args = ap.parse_args(argv)
    rec = asyncio.run(rung(args.n_sim, args.n_crash, args.mode))
    if args.out:
        merge_records(args.out, [rec])
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
