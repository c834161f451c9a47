"""timeout-discipline: network awaits in agent//api/ must carry deadlines.

The bug class (r18 chaos matrix, zombie-node scenario): a peer whose
kernel keeps accepting bytes while its event loop is stalled turns any
unbounded `await stream.recv()` / `await stream.send(...)` /
`await transport.open_bi(...)` into a hang — the sync round stalls, the
serve permit pins, the broadcast loop wedges behind one uni stream.
The repo's discipline is that EVERY await on a cross-node wait is
directly wrapped in `asyncio.wait_for(...)` with a module deadline
constant (RECV_TIMEOUT / SEND_TIMEOUT / OPEN_TIMEOUT) or routed through
a helper that applies one (`AdaptiveChunkSize.timed_send`).

What is flagged: a direct `await X.<m>(...)` in `agent/` or `api/`
where `m` is one of the network-wait methods (`recv`, `send`,
`finish`, `open_bi`, `send_uni`) — unless

- the receiver is an in-process channel: its trailing name segment
  starts with ``tx_``/``rx_`` (`runtime/channels.py` senders/receivers
  — local backpressure by design, closed on shutdown, never a peer),
- or the await's value is an `asyncio.wait_for(...)` call (the fix).

Deliberately NOT flagged: datagram sends (`send_datagram` — UDP
fire-and-forget, no peer round-trip to wait on) and anything already
behind a helper whose receiver is not stream/transport-shaped (the
method-name set keeps the rule precise instead of guessing types).
"""

from __future__ import annotations

import ast
from typing import List

from corrosion_tpu_torch.analysis.core import (
    AnalysisContext,
    Checker,
    Finding,
    enclosing_symbols,
)

SCOPE = (
    "corrosion_tpu_torch/agent",
    "corrosion_tpu_torch/api",
)

# the cross-node wait surface: BiStream + Transport methods whose
# completion depends on a REMOTE peer making progress
NETWORK_METHODS = {"recv", "send", "finish", "open_bi", "send_uni"}

_CHANNEL_PREFIXES = ("tx_", "rx_")


def _receiver_tail(func: ast.Attribute) -> str:
    """Last name segment of the receiver expression: `agent.tx_bcast`
    -> 'tx_bcast', `stream` -> 'stream', `self.transport` ->
    'transport'."""
    v = func.value
    if isinstance(v, ast.Attribute):
        return v.attr
    if isinstance(v, ast.Name):
        return v.id
    return ""


class TimeoutDisciplineChecker(Checker):
    rule = "timeout-discipline"
    description = (
        "awaits on network/stream reads and cross-node waits in agent/ "
        "and api/ must be bounded by asyncio.wait_for (zombie-node "
        "hang class)"
    )

    def __init__(self, scope=SCOPE):
        self.scope = scope

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        for sf in ctx.walk(*self.scope):
            symbols = enclosing_symbols(sf.tree)
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Await):
                    continue
                call = node.value
                if not isinstance(call, ast.Call):
                    continue
                func = call.func
                if not isinstance(func, ast.Attribute):
                    continue
                if func.attr not in NETWORK_METHODS:
                    continue
                tail = _receiver_tail(func)
                if tail.startswith(_CHANNEL_PREFIXES):
                    continue  # in-process channel, not a peer wait
                findings.append(
                    Finding(
                        rule=self.rule,
                        path=sf.path,
                        line=node.lineno,
                        symbol=symbols.get(node, "<module>"),
                        message=(
                            f"unbounded await on network wait "
                            f".{func.attr}() — a zombie peer (sockets "
                            "open, loop stalled) hangs this forever; "
                            "wrap in asyncio.wait_for with a module "
                            "deadline constant"
                        ),
                        snippet=self.snippet_of(node),
                    )
                )
        return findings
