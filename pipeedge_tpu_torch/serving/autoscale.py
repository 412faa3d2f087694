"""Closed-loop capacity control over the replica fleet.

The port's copy of `pipeedge_tpu/serving/autoscale.py`, word for word
but for this docstring and one comment (pure Python: no arrays, no card).
`CapacityController` is a governor-ticked decision engine that consumes
the signals the fleet already publishes (admission queue depth,
brownout rung, `pipeedge_slo_burn_rate{class,window}`) and drives
capacity through existing actuators:

- **replica level** (`serve.py --role router --autoscale`): spawn a new
  supervised decode replica (next epoch, warm-up gated: it joins the
  registry SUSPECT and earns traffic through the readmit confirmation)
  or gracefully drain one through the drain + KV-prefix-migration path,
  then retire the process.
- **pipeline level** (`runtime.py -c dcn --autoscale-ranks`): expand a
  contracted partition onto benched spares at a round boundary, or
  contract it by one stage; the runtime's `_consider_autoscale` drives
  this class through its `classify_fn`/`plan_fn`/`apply_fn` seams.

Every decision survives the same discipline before it moves anything:

    observe -> confirm -> plan -> apply | held

- **confirm**: N consecutive same-direction pressure windows (a single
  hot scrape moves nothing);
- **dwell**: time-based hysteresis in BOTH directions: the streak must
  also have *lasted* `dwell_up_s`/`dwell_down_s`;
- **cooldown + flap damper**: a decision arms a cooldown; each decision
  that REVERSES the previous direction doubles the effective cooldown
  (capped), and a confirmed decision suppressed by the damped portion
  renders as a visible `flap_damped` transition instead of silence;
- **brownout ordering**: scale-down is strictly ordered BEHIND brownout:
  capacity is never shed while the ladder sits above rung 0;
- **dry-run plan**: an un-runnable decision (min-fleet floor, no
  migration survivor) renders as a visible `held` transition, never an
  outage.

Modes: `off` (no controller), `advise` (decisions logged + counted but
never applied: the A/B control arm), `auto` (decisions applied).

Observability: `pipeedge_autoscale_decisions_total{direction,outcome}`
with the full matrix pre-declared at import,
`pipeedge_fleet_target_size` / `pipeedge_fleet_actual_size` gauges, and
paired `autoscale` spans (`plan:<dir>` / `apply:<dir>` / `held:<dir>` /
`flap_damped:<dir>`) that `telemetry/report.py` and `trace_report` fold
into an `autoscale` section.

Pure logic under an injectable clock: every hysteresis path unit-tests
without a fleet.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import telemetry
from ..telemetry import metrics as prom

logger = logging.getLogger(__name__)

MODES = ("off", "advise", "auto")
DIRECTIONS = ("up", "down")
# decision outcomes (the counter's label domain):
#   applied     auto mode moved capacity
#   advised     advise mode would have moved capacity (the control arm)
#   held        the dry-run plan refused (floor/no-spare/no-survivor) —
#               visible, like the health plane's floor-held quarantine
#   flap_damped a confirmed decision suppressed by the flap-doubled
#               cooldown (a reversal arrived too soon after the last)
OUTCOMES = ("applied", "advised", "held", "flap_damped")

# PL501: the full direction x outcome matrix exists before any decision
_M_DECISIONS = prom.REGISTRY.counter(
    "pipeedge_autoscale_decisions_total",
    "autoscale decisions by direction (up/down) and outcome "
    "(applied / advised / held / flap_damped)")
for _d in DIRECTIONS:
    for _o in OUTCOMES:
        _M_DECISIONS.declare(direction=_d, outcome=_o)
_M_TARGET = prom.REGISTRY.gauge(
    "pipeedge_fleet_target_size",
    "capacity units the autoscaler currently wants (replicas at the "
    "router, pipeline stages under --autoscale-ranks)")
_M_ACTUAL = prom.REGISTRY.gauge(
    "pipeedge_fleet_actual_size",
    "capacity units currently serving")
_M_FLAP = prom.REGISTRY.gauge(
    "pipeedge_autoscale_cooldown_factor",
    "flap-damper multiplier on the decision cooldown (1 = calm; "
    "doubles on each direction reversal)")


class CapacityPolicy:
    """The autoscaler's knobs. The hysteresis contract mirrors
    health/scorer.py's HealthPolicy: thresholds must leave a dead band
    (`queue_low < queue_high`, `burn_low < burn_high`) so a signal
    oscillating between them changes nothing."""

    def __init__(self,
                 min_size: int = 1,
                 max_size: int = 2,
                 confirm: int = 3,
                 cooldown_s: float = 10.0,
                 dwell_up_s: float = 0.0,
                 dwell_down_s: float = 0.0,
                 queue_high: float = 4.0,
                 queue_low: float = 0.5,
                 burn_high: float = 1.0,
                 burn_low: float = 0.25,
                 flap_cap: float = 8.0):
        if not 1 <= min_size <= max_size:
            raise ValueError(f"need 1 <= min_size <= max_size, got "
                             f"{min_size}/{max_size}")
        if confirm < 1:
            raise ValueError("confirm must be >= 1")
        if cooldown_s < 0 or dwell_up_s < 0 or dwell_down_s < 0:
            raise ValueError("cooldown/dwell must be >= 0")
        if not 0.0 <= queue_low < queue_high:
            raise ValueError(f"need 0 <= queue_low < queue_high, got "
                             f"{queue_low}/{queue_high}")
        if not 0.0 <= burn_low < burn_high:
            raise ValueError(f"need 0 <= burn_low < burn_high, got "
                             f"{burn_low}/{burn_high}")
        if flap_cap < 1:
            raise ValueError("flap_cap must be >= 1")
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.confirm = int(confirm)
        self.cooldown_s = float(cooldown_s)
        self.dwell_up_s = float(dwell_up_s)
        self.dwell_down_s = float(dwell_down_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.flap_cap = float(flap_cap)


class Decision:
    """One autoscale decision (any outcome). `line()` is the
    machine-parseable stdout form tools/chaos_dcn.py and CI grep."""

    __slots__ = ("direction", "frm", "to", "outcome", "reason", "at",
                 "plan")

    def __init__(self, direction: str, frm: int, to: int, outcome: str,
                 reason: str, at: float, plan: Optional[dict] = None):
        self.direction = direction
        self.frm = int(frm)
        self.to = int(to)
        self.outcome = outcome
        self.reason = reason
        self.at = float(at)
        self.plan = plan

    def line(self) -> str:
        return (f"autoscale_decision direction={self.direction} "
                f"from={self.frm} to={self.to} outcome={self.outcome} "
                f"reason={self.reason}")

    def to_dict(self) -> dict:
        return {"direction": self.direction, "from": self.frm,
                "to": self.to, "outcome": self.outcome,
                "reason": self.reason, "at": round(self.at, 3)}


def default_classify(policy: CapacityPolicy, signals: dict) -> int:
    """Pressure sign from the fleet's published signals: +1 (want more
    capacity), -1 (want less), 0 (neutral — streaks reset).

    Up pressure: the brownout ladder left rung 0 anywhere, per-unit
    admission queue depth crossed `queue_high`, or the short-window SLO
    burn rate crossed `burn_high` (the budget is burning faster than
    capacity can absorb). Down pressure only when EVERY signal is calm
    below the low watermarks — and never while brownout is active
    (scale-down is ordered strictly behind brownout)."""
    size = max(1, int(signals.get("size", 1)))
    queue = float(signals.get("queue_depth", 0.0)) / size
    rung = int(signals.get("brownout_level", 0))
    burn = float(signals.get("burn_rate", 0.0))
    if rung > 0 or queue >= policy.queue_high or burn >= policy.burn_high:
        return 1
    if rung == 0 and queue <= policy.queue_low and burn <= policy.burn_low:
        return -1
    return 0


class CapacityController:
    """The decision engine: `tick(signals)` folds one observation
    window and returns a Decision when one fires (None otherwise).

    `size_fn()` reports current capacity; `plan_fn(direction, frm, to)`
    dry-runs the move and returns `{"ok": bool, "reason": str, ...}`
    (extra keys ride into `apply_fn`); `apply_fn(plan)` executes it
    (auto mode only). `classify_fn(policy, signals)` maps a signals
    dict to a pressure sign — the default reads the serving plane's
    queue/brownout/burn signals; runtime.py substitutes its
    bubble-attribution classifier. `now` is injectable everywhere
    (brownout.py discipline) so hysteresis unit-tests run clockless."""

    def __init__(self, policy: Optional[CapacityPolicy] = None,
                 mode: str = "advise",
                 size_fn: Optional[Callable[[], int]] = None,
                 plan_fn: Optional[Callable[[str, int, int], dict]] = None,
                 apply_fn: Optional[Callable[[dict], None]] = None,
                 classify_fn: Optional[Callable] = None,
                 label: str = "replicas"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.policy = policy or CapacityPolicy()
        self.mode = mode
        self.label = label
        self._size_fn = size_fn or (lambda: self.policy.min_size)
        self._plan_fn = plan_fn
        self._apply_fn = apply_fn
        self._classify = classify_fn or default_classify
        # conviction state
        self._streak_dir = 0            # +1 / -1 / 0
        self._streak_n = 0
        self._streak_since: Optional[float] = None
        self._last_decision_t: Optional[float] = None
        self._last_direction: Optional[str] = None
        self._flap_factor = 1.0
        self._damped_streak = False     # one flap_damped per episode
        self.decisions: List[Decision] = []
        self.ticks = 0
        size = max(self.policy.min_size, int(self._size_fn()))
        # gauge zeroing IS the declaration (PL501 idiom for gauges)
        _M_TARGET.set(float(size))
        _M_ACTUAL.set(float(size))
        _M_FLAP.set(1.0)

    # -- the decision pipeline -------------------------------------------

    def tick(self, signals: dict,
             now: Optional[float] = None) -> Optional[Decision]:
        """observe -> confirm -> plan -> apply | held. One call per
        governor tick / round boundary."""
        now = time.monotonic() if now is None else float(now)
        pol = self.policy
        self.ticks += 1
        cur = int(self._size_fn())
        _M_ACTUAL.set(float(cur))
        sig = dict(signals)
        sig.setdefault("size", cur)
        sign = self._classify(pol, sig)
        rung = int(sig.get("brownout_level", 0))
        if sign < 0 and rung > 0:
            # scale-down ordered strictly behind brownout: a classifier
            # override cannot shed capacity while the ladder sheds work
            sign = 0
        if sign != self._streak_dir or sign == 0:
            self._streak_dir = sign
            self._streak_n = 1 if sign else 0
            self._streak_since = now if sign else None
            self._damped_streak = False
            if sign == 0:
                return None
        else:
            self._streak_n += 1
        direction = "up" if sign > 0 else "down"
        # confirm: N consecutive same-direction windows
        if self._streak_n < pol.confirm:
            return None
        # dwell: the streak must also have LASTED (hysteresis in time,
        # independent of tick rate)
        dwell = pol.dwell_up_s if sign > 0 else pol.dwell_down_s
        if self._streak_since is not None \
                and now - self._streak_since < dwell:
            return None
        # cooldown (+ flap damper): the damped portion renders visibly
        if self._last_decision_t is not None:
            since = now - self._last_decision_t
            if since < pol.cooldown_s:
                return None
            if since < pol.cooldown_s * self._flap_factor:
                if not self._damped_streak:
                    self._damped_streak = True
                    with telemetry.span("autoscale",
                                        f"flap_damped:{direction}"):
                        pass
                    _M_DECISIONS.inc(direction=direction,
                                     outcome="flap_damped")
                    d = Decision(direction, cur, cur, "flap_damped",
                                 f"cooldown x{self._flap_factor:g} "
                                 "(recent reversal)", now)
                    self.decisions.append(d)
                    logger.info("autoscale: %s", d.line())
                    return d
                return None
        target = min(pol.max_size, max(pol.min_size, cur + sign))
        if target == cur:
            # at a bound: steady state, not a decision — a clean fleet
            # parked at the floor must record ZERO decisions
            return None
        return self._decide(direction, cur, target, sig, now)

    def _decide(self, direction: str, cur: int, target: int,
                signals: dict, now: float) -> Decision:
        plan = None
        if self._plan_fn is not None:
            with telemetry.span("autoscale", f"plan:{direction}"):
                try:
                    plan = self._plan_fn(direction, cur, target)
                except Exception as exc:  # noqa: BLE001 — a crashed
                    plan = {"ok": False,   # planner must read as held
                            "reason": f"plan failed: {exc}"}
        if plan is not None and not plan.get("ok", False):
            with telemetry.span("autoscale", f"held:{direction}"):
                pass
            _M_DECISIONS.inc(direction=direction, outcome="held")
            d = Decision(direction, cur, cur, "held",
                         str(plan.get("reason", "plan refused")), now,
                         plan=plan)
            self._arm(d, now)
            logger.warning("autoscale: %s", d.line())
            return d
        if self.mode == "auto" and self._apply_fn is not None:
            with telemetry.span("autoscale", f"apply:{direction}"):
                try:
                    self._apply_fn(plan or {"direction": direction,
                                            "from": cur, "to": target})
                except Exception as exc:  # noqa: BLE001 — a failed
                    # actuator is a held decision, not an outage
                    with telemetry.span("autoscale", f"held:{direction}"):
                        pass
                    _M_DECISIONS.inc(direction=direction, outcome="held")
                    d = Decision(direction, cur, cur, "held",
                                 f"apply failed: {exc}", now, plan=plan)
                    self._arm(d, now)
                    logger.error("autoscale: %s", d.line())
                    return d
            outcome = "applied"
        else:
            outcome = "advised"
        _M_DECISIONS.inc(direction=direction, outcome=outcome)
        _M_TARGET.set(float(target))
        reason = (f"queue={signals.get('queue_depth', 0):g} "
                  f"rung={signals.get('brownout_level', 0)} "
                  f"burn={signals.get('burn_rate', 0):g} "
                  f"confirm={self._streak_n}")
        d = Decision(direction, cur, target, outcome,
                     reason.replace(" ", ","), now, plan=plan)
        self._arm(d, now)
        logger.warning("autoscale: %s", d.line())
        return d

    def _arm(self, d: Decision, now: float) -> None:
        """Every rendered decision arms the cooldown and resets the
        streak; applied/advised moves also update the flap damper (a
        reversal doubles the effective cooldown, a same-direction move
        calms it back to 1)."""
        self.decisions.append(d)
        self._last_decision_t = now
        self._streak_dir = 0
        self._streak_n = 0
        self._streak_since = None
        self._damped_streak = False
        if d.outcome in ("applied", "advised"):
            if self._last_direction is not None \
                    and d.direction != self._last_direction:
                self._flap_factor = min(self.policy.flap_cap,
                                        self._flap_factor * 2)
            else:
                self._flap_factor = 1.0
            self._last_direction = d.direction
            _M_FLAP.set(self._flap_factor)

    # -- introspection ----------------------------------------------------

    @property
    def flap_factor(self) -> float:
        return self._flap_factor

    def snapshot(self) -> dict:
        """The /healthz + /fleet autoscale block."""
        by_outcome: Dict[str, int] = {o: 0 for o in OUTCOMES}
        for d in self.decisions:
            by_outcome[d.outcome] = by_outcome.get(d.outcome, 0) + 1
        return {
            "mode": self.mode,
            "label": self.label,
            "min": self.policy.min_size,
            "max": self.policy.max_size,
            "size": int(self._size_fn()),
            "ticks": self.ticks,
            "streak": {"direction": self._streak_dir,
                       "n": self._streak_n},
            "cooldown_factor": self._flap_factor,
            "decisions": by_outcome,
            "last": (self.decisions[-1].to_dict()
                     if self.decisions else None),
        }


def signals_from_fleet(fleet: dict, size: int) -> dict:
    """Mine a FleetCollector.fleet_snapshot() into the controller's
    signals dict: summed admission queue depth, the max per-replica
    brownout rung (telemetry/collector.py scrapes
    `pipeedge_brownout_level` per target), and the worst short-window
    burn rate across classes."""
    burn = 0.0
    slo = fleet.get("slo") or {}
    for windows in (slo.get("burn_rate") or {}).values():
        burn = max(burn, float(windows.get("short", 0.0)))
    return {
        "queue_depth": float(fleet.get("queue_depth", 0.0)),
        "brownout_level": int(fleet.get("brownout_level", 0)),
        "burn_rate": burn,
        "size": int(size),
    }


class AutoscaleRunner:
    """The router-side governor thread: every `interval_s`, mine the
    fleet collector's snapshot into signals and tick the controller.
    Decisions print as machine-parseable `autoscale_decision` lines
    (tools/chaos_dcn.py and the CI autoscale-chaos job grep them)."""

    def __init__(self, controller: CapacityController,
                 signals_fn: Callable[[], dict],
                 interval_s: float = 1.0,
                 emit: Optional[Callable[[str], None]] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.controller = controller
        self._signals_fn = signals_fn
        self.interval_s = float(interval_s)
        self._emit = emit or (lambda line: print(line, flush=True))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscale-governor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def tick_once(self) -> Optional[Decision]:
        try:
            signals = self._signals_fn()
        except Exception as exc:  # noqa: BLE001 — an unscrapeable fleet
            logger.info("autoscale: signals unavailable (%s)", exc)
            return None            # is a skipped window, not a crash
        d = self.controller.tick(signals)
        if d is not None:
            self._emit(d.line())
        return d

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick_once()
