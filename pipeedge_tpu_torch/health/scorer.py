"""EWMA peer-health scoring with brownout-style hysteresis.

Port copy of `pipeedge_tpu/health/scorer.py`, copied whole.

The detector behind `--on-peer-degraded` (runtime.py): one `observe()`
per rank per measured round window folds the window's signals into a
smoothed degradation score and advances the gray rank lifecycle

    healthy --score >= suspect_threshold--> suspect
    suspect --confirmed `confirm` consecutive windows AND the min-fleet
             floor holds (caller's `can_quarantine`)--> quarantined
    quarantined --score <= readmit_threshold for `readmit` consecutive
             windows--> probation (the caller restores the rank's stage
             at the next round boundary, the existing heal machinery)
    probation --`probation` clean windows--> healthy
    probation --score >= suspect_threshold (single window: a relapse
             needs no re-confirmation)--> quarantined

Signals are RELATIVE, not absolute — a fleet where everything is slow is
balanced, not gray — so the caller normalizes against the fleet median
before calling: `service_ratio` (stage service time / fleet median,
telemetry/feedback.py `stage_estimates`), `rtt_ratio` (heartbeat RTT p99
/ fleet median, comm/dcn.py `heartbeat_rtt_stats`), and the raw
`send_retries` the transport observed toward the rank this window. The
instant degradation is the MAX over the per-signal degradations (a gray
failure usually shows in one signal; averaging would dilute it), and the
score is its EWMA — so a single noisy window moves the score by at most
`alpha`, and confirmation windows filter the rest (the same
hysteresis-plus-confirmation discipline as `sched/rebalance.py`'s
RebalancePolicy and `serving/brownout.py`'s ladder).

A window with NO signal (an empty `HealthSample` — e.g. a quarantined
rank whose heartbeats are disabled) holds the score: absence of evidence
never readmits a rank, and never convicts one either.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, List, Optional

from ..telemetry import metrics as prom

logger = logging.getLogger(__name__)

STATE_HEALTHY = "healthy"
STATE_SUSPECT = "suspect"
STATE_QUARANTINED = "quarantined"
STATE_PROBATION = "probation"

# /metrics plane: the live per-rank score (0 = healthy, 1 = fully
# degraded) and quarantine transitions. Label matrices are pre-declared
# at scorer construction, when the fleet membership is known (PL501).
_HEALTH_SCORE = prom.REGISTRY.gauge(
    "pipeedge_peer_health_score",
    "EWMA gray-failure degradation score per rank "
    "(0 = healthy, 1 = fully degraded)")
_QUARANTINES = prom.REGISTRY.counter(
    "pipeedge_quarantines_total",
    "gray-failure quarantine transitions (suspect -> quarantined and "
    "probation relapses), by rank")


@dataclasses.dataclass(frozen=True)
class HealthSample:
    """One rank's signals for one measured window. All optional — the
    scorer uses whatever the window could measure."""
    service_ratio: Optional[float] = None  # stage service_s / fleet median
    rtt_ratio: Optional[float] = None      # heartbeat RTT p99 / fleet median
    send_retries: int = 0                  # transport redials toward the rank

    def empty(self) -> bool:
        return (self.service_ratio is None and self.rtt_ratio is None
                and self.send_retries <= 0)


@dataclasses.dataclass(frozen=True)
class Transition:
    """One state change, with the evidence that drove it."""
    rank: int
    frm: str
    to: str
    score: float
    window: int      # the observe() call index that fired it
    reason: str


class HealthPolicy:
    """The scorer's knobs (defaults sized for round windows of seconds).

    `suspect_threshold` > `readmit_threshold` is the hysteresis band: a
    score oscillating between them changes nothing. `ratio_bad` /
    `rtt_bad` / `retries_bad` are the per-signal "fully degraded"
    anchors: a service ratio of `ratio_bad` (stage costs 1.5x the fleet
    median) contributes degradation 1.0, ratio 1.0 contributes 0."""

    def __init__(self, alpha: float = 0.5,
                 suspect_threshold: float = 0.4,
                 readmit_threshold: float = 0.2,
                 confirm: int = 2,
                 readmit: int = 2,
                 probation: int = 2,
                 ratio_bad: float = 1.5,
                 rtt_bad: float = 3.0,
                 retries_bad: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 < readmit_threshold < suspect_threshold <= 1.0:
            raise ValueError(
                "need 0 < readmit_threshold < suspect_threshold <= 1, got "
                f"{readmit_threshold} / {suspect_threshold}")
        if min(confirm, readmit, probation) < 1:
            raise ValueError("confirm/readmit/probation windows must be "
                             ">= 1")
        if ratio_bad <= 1.0 or rtt_bad <= 1.0 or retries_bad < 1:
            raise ValueError("ratio_bad/rtt_bad must exceed 1.0 and "
                             "retries_bad must be >= 1")
        self.alpha = float(alpha)
        self.suspect_threshold = float(suspect_threshold)
        self.readmit_threshold = float(readmit_threshold)
        self.confirm = int(confirm)
        self.readmit = int(readmit)
        self.probation = int(probation)
        self.ratio_bad = float(ratio_bad)
        self.rtt_bad = float(rtt_bad)
        self.retries_bad = int(retries_bad)

    def degradation(self, sample: HealthSample) -> Optional[float]:
        """Instant degradation in [0, 1] for one window's signals; None
        when the sample carries no signal at all (hold the score)."""
        if sample.empty():
            return None
        parts: List[float] = []
        if sample.service_ratio is not None:
            parts.append(_unit(sample.service_ratio, 1.0, self.ratio_bad))
        if sample.rtt_ratio is not None:
            parts.append(_unit(sample.rtt_ratio, 1.0, self.rtt_bad))
        if sample.send_retries > 0:
            parts.append(_unit(float(sample.send_retries), 0.0,
                               float(self.retries_bad)))
        return max(parts) if parts else 0.0


def _unit(value: float, lo: float, hi: float) -> float:
    """Clamp `value` onto [0, 1] linearly between `lo` (nominal) and
    `hi` (fully degraded)."""
    if hi <= lo:
        return 1.0 if value >= hi else 0.0
    return min(1.0, max(0.0, (value - lo) / (hi - lo)))


class _RankHealth:
    """Per-rank scorer state (internal)."""

    __slots__ = ("state", "score", "streak", "windows")

    def __init__(self):
        self.state = STATE_HEALTHY
        self.score = 0.0
        self.streak = 0     # consecutive windows toward the next transition
        self.windows = 0    # observe() calls that carried a signal


class PeerHealthScorer:
    """Fleet-wide gray-failure detector: one `_RankHealth` per peer.

    Single-threaded by design — the data rank's round loop is the only
    caller (`observe` per rank per boundary), and `snapshot()` reads are
    GIL-atomic dict copies, so no lock is needed (the same discipline as
    `RebalancePolicy`)."""

    def __init__(self, ranks: Iterable[int],
                 policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self._ranks: Dict[int, _RankHealth] = {
            int(r): _RankHealth() for r in ranks}
        self.transitions: List[Transition] = []
        # PL501: the fleet membership fixes the label matrices here
        for r in self._ranks:
            _HEALTH_SCORE.set(0.0, rank=str(r))
            _QUARANTINES.declare(rank=str(r))

    # -- queries --------------------------------------------------------

    def state_of(self, rank: int) -> str:
        return self._ranks[int(rank)].state

    def score_of(self, rank: int) -> float:
        return self._ranks[int(rank)].score

    def quarantined(self) -> List[int]:
        return sorted(r for r, h in self._ranks.items()
                      if h.state == STATE_QUARANTINED)

    def snapshot(self) -> Dict[str, dict]:
        """Per-rank state for /healthz (`{rank: {state, score, windows}}`;
        string keys — the block is JSON)."""
        return {str(r): {"state": h.state,
                         "score": round(h.score, 4),
                         "windows": h.windows}
                for r, h in sorted(self._ranks.items())}

    # -- the decision loop ---------------------------------------------

    def observe(self, rank: int, sample: HealthSample,
                can_quarantine: bool = True) -> Optional[Transition]:
        """Fold one window's signals for `rank`; returns the transition
        this window fired, if any. `can_quarantine=False` is the caller's
        min-fleet floor (and the `--on-peer-degraded ignore` policy): a
        confirmed suspect is HELD at suspect rather than benched below a
        runnable partition — and fires a (suspect -> suspect) transition
        with reason `held` exactly once per hold streak, so the refusal
        is observable without flooding."""
        h = self._ranks[int(rank)]
        pol = self.policy
        d = pol.degradation(sample)
        if d is None:
            return None     # no signal: hold everything
        h.windows += 1
        h.score = (1.0 - pol.alpha) * h.score + pol.alpha * d
        _HEALTH_SCORE.set(h.score, rank=str(rank))
        bad = h.score >= pol.suspect_threshold
        good = h.score <= pol.readmit_threshold

        if h.state == STATE_HEALTHY:
            if bad:
                return self._move(rank, h, STATE_SUSPECT,
                                  f"score {h.score:.3f} >= "
                                  f"{pol.suspect_threshold}")
            return None
        if h.state == STATE_SUSPECT:
            if good:
                # exit through the READMIT threshold, not the suspect
                # one: a score oscillating inside the hysteresis band
                # (readmit < score < suspect) holds the state AND the
                # confirmation streak — a threshold-straddling straggler
                # must not flip-flop its way out of ever confirming
                return self._move(rank, h, STATE_HEALTHY,
                                  f"score recovered to {h.score:.3f}")
            if not bad:
                return None     # in the band: hold
            h.streak += 1
            # `confirm` consecutive bad windows AFTER the suspect entry
            # (so the minimum path to quarantine is confirm + 1 bad
            # windows total — the entry window can never convict alone)
            if h.streak < pol.confirm:
                return None
            if not can_quarantine:
                if h.streak == pol.confirm:     # fire the hold once
                    return self._note(rank, h, "held",
                                      "min-fleet floor (or policy) "
                                      "refuses the bench")
                return None
            return self._move(rank, h, STATE_QUARANTINED,
                              f"confirmed over {h.streak + 1} windows")
        if h.state == STATE_QUARANTINED:
            if not good:
                h.streak = 0
                return None
            h.streak += 1
            if h.streak < pol.readmit:
                return None
            return self._move(rank, h, STATE_PROBATION,
                              f"score {h.score:.3f} <= "
                              f"{pol.readmit_threshold} for "
                              f"{h.streak} windows")
        # probation: one bad window relapses (no re-confirmation — the
        # rank already proved it can degrade), `probation` clean windows
        # graduate back to healthy. The relapse is still a QUARANTINE
        # decision, so the caller's floor applies: with no runnable plan
        # left (the spare died meanwhile) the rank is HELD on probation —
        # running degraded beats aborting the fleet.
        if bad:
            if not can_quarantine:
                h.streak = 0    # a bad window breaks the clean streak
                return self._note(rank, h, "held",
                                  "min-fleet floor (or policy) refuses "
                                  "the relapse bench")
            return self._move(rank, h, STATE_QUARANTINED,
                              f"probation relapse (score {h.score:.3f})")
        h.streak += 1
        if h.streak < pol.probation:
            return None
        return self._move(rank, h, STATE_HEALTHY,
                          f"{h.streak} clean probation windows")

    def _move(self, rank: int, h: _RankHealth, to: str, reason: str) \
            -> Transition:
        t = Transition(rank=int(rank), frm=h.state, to=to,
                       score=h.score, window=h.windows, reason=reason)
        h.state = to
        h.streak = 0
        if to == STATE_QUARANTINED:
            _QUARANTINES.inc(rank=str(rank))
        self.transitions.append(t)
        logger.warning("peer health: rank %d %s -> %s (%s)", rank, t.frm,
                       to, reason)
        return t

    def _note(self, rank: int, h: _RankHealth, kind: str, reason: str) \
            -> Transition:
        """A no-move event (the floor hold): recorded and returned like a
        transition so callers can surface it, state untouched."""
        t = Transition(rank=int(rank), frm=h.state, to=h.state,
                       score=h.score, window=h.windows,
                       reason=f"{kind}: {reason}")
        self.transitions.append(t)
        logger.warning("peer health: rank %d stays %s (%s)", rank,
                       h.state, t.reason)
        return t
