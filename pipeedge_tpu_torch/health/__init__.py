"""Peer-health plane: gray-failure detection for the DCN fleet.

Port copy of `pipeedge_tpu/health/__init__.py`. The snapshot stays `{}`
until a runtime installs a scorer, as in the JAX package.

Fail-stop faults trip the liveness plane (missed heartbeats, dropped
connections — docs/FAULT_TOLERANCE.md); a *gray* failure does not: a
throttled TPU, a degrading NIC, or a noisy neighbor keeps a rank alive
and beating while every microbatch drags through the pipeline's new
bottleneck stage. This package closes the telemetry loop the repo
already has — per-round span digests measure per-stage cost
(telemetry/feedback.py), heartbeats prove liveness (comm/dcn.py), the
membership plane can bench and re-expand ranks (sched/failover.py) —
into a detector:

- `scorer.PeerHealthScorer` folds per-window signals (relative stage
  service time, heartbeat RTT, transport send retries) into an EWMA
  health score per rank and walks the gray rank lifecycle
  `healthy -> suspect -> quarantined -> probation -> healthy` with
  brownout-style hysteresis (suspect and readmit thresholds differ,
  N-consecutive-windows confirmation both directions).
- `guard.check_finite` is the opt-in NaN/Inf activation guard at stage
  boundaries (`PIPEEDGE_NAN_GUARD=1`): a poisoned microbatch raises
  `guard.PoisonedActivationError` and writes a flight-recorder
  postmortem instead of propagating garbage downstream.

The scorer registers itself as a process singleton so observability
surfaces (`tools/serve.py` /healthz, tests) can read the fleet's
per-peer scores without plumbing: `snapshot()` returns `{}` until a
runtime installs a scorer.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..utils.threads import make_lock
from .guard import PoisonedActivationError, check_finite, nan_guard_enabled
from .scorer import (HealthPolicy, HealthSample, PeerHealthScorer,
                     Transition, STATE_HEALTHY, STATE_PROBATION,
                     STATE_QUARANTINED, STATE_SUSPECT)

__all__ = [
    "HealthPolicy", "HealthSample", "PeerHealthScorer", "Transition",
    "STATE_HEALTHY", "STATE_SUSPECT", "STATE_QUARANTINED",
    "STATE_PROBATION", "PoisonedActivationError", "check_finite",
    "nan_guard_enabled", "set_scorer", "scorer", "snapshot",
]

_scorer: Optional[PeerHealthScorer] = None
_scorer_lock = make_lock("health.singleton")


def set_scorer(scorer_obj: Optional[PeerHealthScorer]) -> None:
    """Install (or clear, with None) the process's peer-health scorer —
    what the DCN data rank does at fleet bring-up so /healthz and tests
    can read the same state the quarantine decisions run on."""
    global _scorer  # pylint: disable=global-statement
    with _scorer_lock:
        _scorer = scorer_obj


def scorer() -> Optional[PeerHealthScorer]:
    with _scorer_lock:
        return _scorer


def snapshot() -> Dict[str, dict]:
    """Per-peer health state for observability surfaces (the /healthz
    `peer_health` block): `{rank: {state, score, windows}}`; empty when
    no scorer is installed in this process."""
    with _scorer_lock:
        sc = _scorer
    return sc.snapshot() if sc is not None else {}
