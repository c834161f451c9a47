"""The supervised remediation plane (r22): close the observe→act loop.

r19–r20 made every anomaly a typed, lifecycle-tracked object (traces,
TSDB, alert rules) — and stopped at "page a human".  This module is the
acting half: a supervisor tick consumes the local `AlertEngine`'s
FIRING rules (`runtime/alerts.py::DEFAULT_ACTIONS` binds rule →
actuator) and drives a registry of typed actuators built from levers
the repo already has:

- `view-divergence` → **targeted-sync**: one immediate anti-entropy
  round (`agent/syncer.py::targeted_sync`) outside the sync_loop's
  backoff — the loop backs off exactly when nothing arrives, i.e.
  exactly when divergence opens.
- `store-faults` → **drain-refuse-bulk**: drain this node's matcher
  homes (`SubsManager.drain` — every stream ends with the clean typed
  terminal the r16 resume path handles) and mark the node refuse-bulk:
  new stream admission 503s (`SubsManager.refuse_until`) and bulk
  snapshot serves/bootstraps reject BUSY (`Agent.bulk_refuse_until`,
  checked in `agent/catchup.py`) until the revert clears the flags.
- sustained `slo-burn` → **shed-laggards**: shed the clogged sink tier
  (`FanoutWriter.shed_clogged`) with the typed `SubLagging` frame
  before clients time out.

Every decision is a typed, drill-aware, flight-recorded event: acts
emit `FLIGHT.record_host_frame("remediation", ...)` frames (so they
ride every incident dump) and append cooldown-stamped history rows
served by `GET /v1/remediation` (api/http.py).

Gates, in order, per firing rule:

1. **sustain** — the rule must have been firing `sustain_secs`
   (slo-burn only by default: a transient burn blip must not shed).
2. **cooldown** — per-actuator; an act stamps it, a would-act does not.
3. **precondition** — a typed refusal ("no laggard sinks to shed")
   instead of a no-op act that burns the cooldown.
4. **Lifeguard self-distrust** (arXiv:1707.00788) — when the local
   `health_score()` is at/above `[remediation] defer_health`, this
   node's impulse DEFERS to the digest-merged cluster rollup
   (`observatory.cluster_alerts()`): it acts only when another node's
   digest confirms the same rule firing.  A sick node acting on its
   own sick telemetry is how remediation storms start.
5. **kill-switch** — `[remediation] enabled=false` (the default) is
   observe-only: every gate above still runs and a typed `would_act`
   event is recorded, so operators audit the plane before arming it.

Prime CCL bar (arXiv:2505.14065): every actuator SHRINKS capacity
(sheds, drains, refuses) with a typed signal — none may convert a
request into a stall.  The chaos matrix is the proof harness
(`scripts/traffic_sim.py --remediation`): remediation ON must strictly
improve recovery walls with timeouts==0 and the availability floors
intact.

Thread contract: the supervisor runs entirely on the event loop
(`remediation_loop` tick → async acts → HTTP reads) — no cross-thread
mutation, no lock.

The port's copy of `corrosion_tpu/agent/remediation.py`. On an agent
whose store runs the array engine, the remote batches a targeted sync
brings in are decided by the store's decision program on its device.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, List, Optional, Set, Tuple

from corrosion_tpu_torch.chaos.faults import CENSUS
from corrosion_tpu_torch.runtime.metrics import METRICS
from corrosion_tpu_torch.runtime.records import FLIGHT

log = logging.getLogger(__name__)

MODES = ("acted", "would_act", "deferred", "refused", "failed", "reverted")


@dataclass(frozen=True)
class Actuator:
    """One typed remediation action.  `act` does the work and returns a
    JSON-ready detail dict; `revert` (optional) undoes the standing
    side effects when the bound rule resolves; `precondition` returns
    None to allow or a typed refusal reason.  Discipline (pinned by the
    `actuator-discipline` static rule, analysis/actuators.py): every
    actuator carries a positive cooldown, and every `act` body checks
    the chaos CENSUS drill marker and emits a flight-recorder frame."""

    name: str
    rule: str  # the alert rule that drives it (alerts.DEFAULT_ACTIONS)
    summary: str
    cooldown_secs: float
    act: Callable[..., Awaitable[dict]]
    revert: Optional[Callable[..., Awaitable[dict]]] = None
    precondition: Optional[Callable[..., Optional[str]]] = None
    sustain_secs: float = 0.0  # min firing age before acting


# -- the default actuators (the levers the repo already has) ---------------


def _pre_targeted_sync(agent) -> Optional[str]:
    if not any(
        aid != agent.actor_id for aid in agent.members.states
    ):
        return "no peers known to sync against"
    return None


async def _act_targeted_sync(agent) -> dict:
    from corrosion_tpu_torch.agent.syncer import targeted_sync

    drill = CENSUS.snapshot()
    received = await targeted_sync(
        agent, timeout=agent.config.remediation.act_timeout_secs
    )
    FLIGHT.record_host_frame(
        "remediation",
        {"targeted_sync": 1, "changes_received": received},
    )
    return {
        "changes_received": received,
        "drill": drill.get("scenario"),
    }


async def _act_drain_refuse_bulk(agent) -> dict:
    drill = CENSUS.snapshot()
    refuse = agent.config.remediation.refuse_bulk_secs
    deadline = time.monotonic() + refuse
    drained = 0
    if agent.subs is not None:
        drained = await agent.subs.drain()
        agent.subs.refuse_until = deadline
    agent.bulk_refuse_until = deadline
    FLIGHT.record_host_frame(
        "remediation", {"drain": 1, "homes_drained": drained}
    )
    return {
        "homes_drained": drained,
        "refuse_bulk_secs": refuse,
        "drill": drill.get("scenario"),
    }


async def _revert_drain_refuse_bulk(agent) -> dict:
    """Store healthy again: stop refusing early (the deadline would
    expire on its own — the revert just gets there sooner).  Drained
    matcher homes are NOT rebuilt here; re-subscribing clients rebuild
    them on demand through the normal dedupe path."""
    agent.bulk_refuse_until = 0.0
    if agent.subs is not None:
        agent.subs.refuse_until = 0.0
    return {"refuse_bulk": "cleared"}


def _pre_shed_laggards(agent) -> Optional[str]:
    if agent.subs is None:
        return "no subscription manager on this node"
    if agent.subs.fanout.clogged_count() == 0:
        return "no laggard sinks to shed"
    return None


async def _act_shed_laggards(agent) -> dict:
    drill = CENSUS.snapshot()
    shed = agent.subs.fanout.shed_clogged()
    FLIGHT.record_host_frame(
        "remediation", {"shed": 1, "laggards_shed": shed}
    )
    return {"laggards_shed": shed, "drill": drill.get("scenario")}


def default_actuators(cfg) -> Dict[str, Actuator]:
    """The built-in registry, cooldowns from the `[remediation]`
    config.  Adding one: write the act (CENSUS drill check + FLIGHT
    frame, see the discipline note on `Actuator`), bind its rule in
    `alerts.DEFAULT_ACTIONS`, and document it in COMPONENTS.md."""
    return {
        a.name: a
        for a in (
            Actuator(
                name="targeted-sync",
                rule="view-divergence",
                summary="immediate anti-entropy round, bypassing the "
                        "sync_loop backoff",
                cooldown_secs=cfg.sync_cooldown_secs,
                act=_act_targeted_sync,
                precondition=_pre_targeted_sync,
            ),
            Actuator(
                name="drain-refuse-bulk",
                rule="store-faults",
                summary="drain matcher homes; refuse new streams and "
                        "bulk snapshot transfers while the store is "
                        "sick",
                cooldown_secs=cfg.drain_cooldown_secs,
                act=_act_drain_refuse_bulk,
                revert=_revert_drain_refuse_bulk,
            ),
            Actuator(
                name="shed-laggards",
                rule="slo-burn",
                summary="shed the clogged sink tier with the typed "
                        "lagging terminal before clients time out",
                cooldown_secs=cfg.shed_cooldown_secs,
                act=_act_shed_laggards,
                precondition=_pre_shed_laggards,
                sustain_secs=cfg.slo_sustain_secs,
            ),
        )
    }


# -- the supervisor ---------------------------------------------------------


class RemediationSupervisor:
    """One node's observe→act loop.  `tick()` is the whole protocol:
    revert actuators whose rule resolved, then gate + drive actuators
    for the rules firing now.  All state lives on the event loop."""

    def __init__(
        self,
        agent,
        cfg=None,
        actuators: Optional[Dict[str, Actuator]] = None,
        bindings: Optional[Dict[str, str]] = None,
        clock=time.monotonic,
        wall=time.time,
    ):
        from corrosion_tpu_torch.runtime.alerts import DEFAULT_ACTIONS
        from corrosion_tpu_torch.runtime.config import RemediationConfig

        self.agent = agent
        self.cfg = cfg if cfg is not None else RemediationConfig()
        self.actuators = (
            actuators if actuators is not None
            else default_actuators(self.cfg)
        )
        self.bindings = dict(
            bindings if bindings is not None else DEFAULT_ACTIONS
        )
        self._clock = clock
        self._wall = wall
        self._last_act: Dict[str, float] = {}  # actuator -> mono stamp
        self._acted_rules: Dict[str, str] = {}  # rule -> actuator name
        # (rule, mode) pairs already recorded this episode: deferred/
        # refused/would_act states persist across ticks — one history
        # row per episode, not one per tick
        self._noted: Set[Tuple[str, str]] = set()
        self._history: deque = deque(maxlen=int(self.cfg.history_max))
        self._counts: Dict[str, int] = {m: 0 for m in MODES}

    # -- consensus (Lifeguard deferral) ------------------------------------

    def _cluster_confirms(self, rule: str) -> bool:
        """Does the digest-merged cluster rollup show `rule` firing on
        some OTHER node?  That is the consensus a self-distrusting node
        requires before acting on its own telemetry."""
        obs = self.agent.observatory
        if obs is None:
            return False
        try:
            rollup = obs.cluster_alerts().get("rollup", {})
        except Exception:
            return False
        row = rollup.get(rule)
        if not row:
            return False
        me = str(self.agent.actor_id)
        return any(n != me for n in row.get("firing", []))

    # -- event plumbing ----------------------------------------------------

    def _record(
        self,
        actuator: Actuator,
        rule: str,
        mode: str,
        detail: dict,
        drill: Optional[str],
    ) -> None:
        self._history.append(
            {
                "action": actuator.name,
                "rule": rule,
                "mode": mode,
                "wall": self._wall(),
                "drill": drill,
                "cooldown_secs": actuator.cooldown_secs,
                "detail": detail,
            }
        )
        self._counts[mode] = self._counts.get(mode, 0) + 1
        METRICS.counter(
            "corro.remediation.actions.total",
            actuator=actuator.name, mode=mode,
        ).inc()
        if mode != "acted":
            # acts emit their own richer frame from inside the
            # actuator body (the lintable discipline); every other
            # outcome is stamped here so incident dumps carry the
            # full decision trail
            FLIGHT.record_host_frame(
                "remediation", {mode: 1}
            )

    def _note_once(
        self,
        actuator: Actuator,
        rule: str,
        mode: str,
        detail: dict,
        drill: Optional[str],
    ) -> None:
        key = (rule, mode)
        if key in self._noted:
            return
        self._noted.add(key)
        self._record(actuator, rule, mode, detail, drill)

    def _drill(self) -> Optional[str]:
        chaos = CENSUS.snapshot()
        return (
            (chaos.get("scenario") or "injection")
            if chaos.get("active") else None
        )

    # -- the tick ----------------------------------------------------------

    async def tick(self) -> None:
        eng = self.agent.alerts
        if eng is None:
            return
        firing = {f["rule"]: f for f in eng.firing_snapshot()}
        await self._handle_resolved(firing)
        for rule, f in firing.items():
            name = self.bindings.get(rule)
            act = self.actuators.get(name) if name else None
            if act is None:
                continue
            await self._consider(act, rule, f)

    async def _handle_resolved(self, firing: Dict[str, dict]) -> None:
        for rule in [r for r in self._acted_rules if r not in firing]:
            name = self._acted_rules.pop(rule)
            act = self.actuators.get(name)
            if act is None or act.revert is None:
                continue
            try:
                detail = await asyncio.wait_for(
                    act.revert(self.agent), self.cfg.act_timeout_secs
                )
            except Exception as e:
                detail = {"error": str(e)}
                log.exception("remediation revert %s failed", name)
            METRICS.counter(
                "corro.remediation.reverts.total", actuator=name
            ).inc()
            self._record(act, rule, "reverted", detail, self._drill())
            log.info("remediation reverted: %s (%s resolved)", name, rule)
        # episode bookkeeping: a rule leaving the firing set re-arms
        # its once-per-episode notes
        self._noted = {
            (r, m) for r, m in self._noted if r in firing
        }

    async def _consider(
        self, act: Actuator, rule: str, f: dict
    ) -> None:
        now = self._clock()
        drill = self._drill()
        if f.get("firing_secs", 0.0) < act.sustain_secs:
            METRICS.counter(
                "corro.remediation.skips.total", reason="sustain"
            ).inc()
            return
        last = self._last_act.get(act.name)
        if last is not None and now - last < act.cooldown_secs:
            METRICS.counter(
                "corro.remediation.skips.total", reason="cooldown"
            ).inc()
            return
        if act.precondition is not None:
            reason = act.precondition(self.agent)
            if reason is not None:
                self._note_once(
                    act, rule, "refused", {"reason": reason}, drill
                )
                return
        health = self.agent.alerts.health_score()
        if health >= self.cfg.defer_health and not self._cluster_confirms(
            rule
        ):
            # Lifeguard: this node's own telemetry is suspect — hold
            # until another node's digest confirms the same rule
            self._note_once(
                act, rule, "deferred",
                {"health_score": round(health, 4),
                 "defer_health": self.cfg.defer_health},
                drill,
            )
            return
        if not self.cfg.enabled:
            self._note_once(
                act, rule, "would_act",
                {"kill_switch": "[remediation] enabled=false"},
                drill,
            )
            return
        self._last_act[act.name] = now
        try:
            detail = await asyncio.wait_for(
                act.act(self.agent), self.cfg.act_timeout_secs
            )
        except Exception as e:
            self._record(act, rule, "failed", {"error": str(e)}, drill)
            log.exception("remediation act %s failed", act.name)
            return
        self._acted_rules[rule] = act.name
        self._record(act, rule, "acted", detail, drill)
        log.warning(
            "REMEDIATION acted: %s (rule %s)%s %s", act.name, rule,
            f" [drill: {drill}]" if drill else "", detail,
        )

    # -- read side (event loop; copies only) -------------------------------

    def census(self) -> dict:
        """The /v1/status block."""
        return {
            "enabled": True,
            "armed": bool(self.cfg.enabled),
            "actuators": len(self.actuators),
            "counts": {
                m: n for m, n in self._counts.items() if n
            },
        }

    def report(self, history: bool = True) -> dict:
        """GET /v1/remediation: the actuator census + action history."""
        now = self._clock()
        rows = []
        for name, act in sorted(self.actuators.items()):
            last = self._last_act.get(name)
            rows.append(
                {
                    "name": name,
                    "rule": act.rule,
                    "summary": act.summary,
                    "cooldown_secs": act.cooldown_secs,
                    "sustain_secs": act.sustain_secs,
                    "has_revert": act.revert is not None,
                    "cooldown_remaining_secs": (
                        round(max(0.0, act.cooldown_secs - (now - last)), 3)
                        if last is not None else 0.0
                    ),
                }
            )
        out = {
            "enabled": True,
            "armed": bool(self.cfg.enabled),
            "defer_health": self.cfg.defer_health,
            "actuators": rows,
            "counts": dict(self._counts),
        }
        if history:
            out["history"] = list(self._history)
        return out


async def remediation_loop(agent) -> None:
    """Tick the supervisor every `[remediation] tick_secs` until
    tripwire — the acting sibling of `alerts_loop`.  Ticks run ON the
    event loop: every gate is a cheap in-memory read and every act is
    itself async (network sync, matcher drain) with its own bound."""
    sup = agent.remediation
    if sup is None:
        return
    interval = agent.config.remediation.tick_secs
    METRICS.gauge("corro.remediation.armed").set(
        1 if agent.config.remediation.enabled else 0
    )
    while not agent.tripwire.tripped:
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(agent.tripwire.wait(), interval)
        if agent.tripwire.tripped:
            return
        try:
            await sup.tick()
        except Exception:
            log.exception("remediation tick failed")
