"""Brownout ladder: watermark-driven graceful degradation with hysteresis.

Port copy of `pipeedge_tpu/serving/brownout.py`, word for word but for
this paragraph and the package imports.

When the serving plane runs hot (queue depth, windowed p95 latency), it
degrades DELIBERATELY, one rung at a time, shedding the cheapest quality
first — instead of letting the overload degrade everyone uniformly:

| level | name              | effect                                     |
|-------|-------------------|--------------------------------------------|
| 0     | normal            | —                                          |
| 1     | no_speculative    | speculative requests run plain greedy      |
|       |                   | (token-identical; frees the draft model's  |
|       |                   | serialized dispatch + cache memory)        |
| 2     | clamp_tokens      | new_tokens clamped to `clamp_new_tokens`;  |
|       |                   | chunked-prefill chunk size clamped to      |
|       |                   | `clamp_chunk_tokens` when that lever is    |
|       |                   | armed (shorter pipeline holds per chunk)   |
| 3     | evict_cold_pages  | reclaim cached-but-idle prefix KV pages    |
|       |                   | (the paged-KV trie's cold pages — capacity |
|       |                   | only future requests would miss, spent     |
|       |                   | BEFORE any live request is shed)           |
| 4     | colocate_prefill  | disaggregated serving degrades to          |
|       |                   | COLOCATED prefill: prompt passes stop      |
|       |                   | shipping to the remote prefill fleet and   |
|       |                   | run in the decode executor instead         |
|       |                   | (token-identical; sheds the ship edge's    |
|       |                   | latency/fault surface when the plane is    |
|       |                   | already hot — docs/FAULT_TOLERANCE.md)     |
| 5     | shed_best_effort  | best_effort class shed at admission        |
| 6     | shed_batch        | batch class shed too (interactive only)    |

Stepping is governed by watermarks + dwell times (hysteresis): the hot
condition must persist `dwell_up_s` before each step up, and the calm
condition `dwell_down_s` before each step down — a ladder, not a
flip-flop. A FLOOR composes the degraded->healing->healed lifecycle in:
while a failover window is open (docs/FAULT_TOLERANCE.md), the effective
level is at least 1 (healing capacity must not be spent on speculative
drafts), whatever the watermarks say.

The governor thread in tools/serve.py calls `update()` periodically with
the admission queue depth and the p95 of the request-latency histogram's
last window; everything here is plain state + arithmetic (injectable
`now` for deterministic tests).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..telemetry import metrics as prom

LEVEL_NAMES = ("normal", "no_speculative", "clamp_tokens",
               "evict_cold_pages", "colocate_prefill",
               "shed_best_effort", "shed_batch")
MAX_LEVEL = len(LEVEL_NAMES) - 1
EVICT_LEVEL = LEVEL_NAMES.index("evict_cold_pages")
COLOCATE_LEVEL = LEVEL_NAMES.index("colocate_prefill")


@dataclass
class Watermarks:
    """Step-up/step-down thresholds. Hot when EITHER signal is above its
    high mark; calm only when BOTH are below their low marks (missing
    p95 — an idle window — counts as calm)."""
    queue_high: int = 8
    queue_low: int = 1
    p95_high_s: float = 2.0
    p95_low_s: float = 0.5
    dwell_up_s: float = 0.5
    dwell_down_s: float = 2.0

    def __post_init__(self):
        if self.queue_low > self.queue_high:
            raise ValueError("queue_low must be <= queue_high")
        if self.p95_low_s > self.p95_high_s:
            raise ValueError("p95_low_s must be <= p95_high_s")


class BrownoutLadder:
    """The ladder's state machine. Not internally locked: the governor
    thread is the only writer; readers (`level`, `shed_classes`, ...)
    see GIL-atomic ints."""

    def __init__(self, marks: Optional[Watermarks] = None,
                 max_level: int = MAX_LEVEL,
                 clamp_new_tokens: int = 16,
                 clamp_chunk_tokens: int = 0,
                 registry: Optional[prom.Registry] = None):
        if not 0 <= max_level <= MAX_LEVEL:
            raise ValueError(f"max_level must be in [0, {MAX_LEVEL}]")
        if clamp_new_tokens < 1:
            raise ValueError("clamp_new_tokens must be >= 1")
        if clamp_chunk_tokens < 0:
            raise ValueError("clamp_chunk_tokens must be >= 0")
        self.marks = marks if marks is not None else Watermarks()
        self.max_level = int(max_level)
        self.clamp_new_tokens = int(clamp_new_tokens)
        # the clamp_tokens rung's SECOND lever (0 = not armed): shrink
        # the chunked-prefill chunk size while hot, so prompt ingress
        # yields more step boundaries to waiting decode steps
        # (tools/serve.py's governor applies it via set_chunk_tokens)
        self.clamp_chunk_tokens = int(clamp_chunk_tokens)
        self._stepped = 0       # watermark-driven rung
        self._floor = 0         # lifecycle-driven minimum (healing >= 1)
        self._hot_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        # the evict_cold_pages rung's lever: `hook() -> pages freed`
        # (the paged-KV backend's cold-prefix sweep, tools/serve.py);
        # called on every governor tick while the level holds >= 3, so
        # pages that re-chill during a long hot spell keep reclaiming
        self.evict_hook: Optional[object] = None
        reg = prom.REGISTRY if registry is None else registry
        self.m_level = reg.gauge(
            "pipeedge_brownout_level",
            f"current brownout rung (0={LEVEL_NAMES[0]} .. "
            f"{MAX_LEVEL}={LEVEL_NAMES[-1]}; docs/SERVING.md ladder)")
        self.m_level.set(0)
        self.m_steps = reg.counter(
            "pipeedge_brownout_transitions_total",
            "brownout rung changes, by direction")
        self.m_steps.declare(direction="up")
        self.m_steps.declare(direction="down")

    # -- state ------------------------------------------------------------

    @property
    def level(self) -> int:
        """Effective level: the stepped rung, floored by the lifecycle."""
        return max(self._stepped, self._floor)

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    def set_floor(self, floor: int) -> int:
        """Lifecycle floor (0 or 1+): healing implies at least level 1."""
        before = self.level
        self._floor = max(0, min(int(floor), self.max_level))
        after = self.level
        if after != before:
            self.m_level.set(after)
            self.m_steps.inc(direction="up" if after > before else "down")
        return after

    # -- the ladder -------------------------------------------------------

    def update(self, queue_depth: int, p95_s: Optional[float],
               now: Optional[float] = None) -> int:
        """One governor tick: classify the signals, dwell, maybe step.
        Returns the effective level."""
        import time
        now = time.monotonic() if now is None else now
        m = self.marks
        hot = (queue_depth >= m.queue_high
               or (p95_s is not None and p95_s >= m.p95_high_s))
        calm = (queue_depth <= m.queue_low
                and (p95_s is None or p95_s <= m.p95_low_s))
        before = self.level
        if hot:
            self._calm_since = None
            if self._hot_since is None:
                self._hot_since = now
            elif (now - self._hot_since >= m.dwell_up_s
                  and self._stepped < self.max_level):
                self._stepped += 1
                self._hot_since = now      # re-arm: one rung per dwell
        elif calm:
            self._hot_since = None
            if self._calm_since is None:
                self._calm_since = now
            elif (now - self._calm_since >= m.dwell_down_s
                  and self._stepped > 0):
                self._stepped -= 1
                self._calm_since = now     # re-arm: one rung per dwell
        else:
            # between the marks: hold the rung, reset both dwells
            self._hot_since = None
            self._calm_since = None
        after = self.level
        if after != before:
            self.m_steps.inc(direction="up" if after > before else "down")
        self.m_level.set(after)
        if after >= EVICT_LEVEL and self.evict_hook is not None:
            self.evict_hook()
        return after

    # -- effects ----------------------------------------------------------

    def allow_speculative(self) -> bool:
        return self.level < 1

    def clamp(self, new_tokens: int) -> int:
        """Level >= 2: long generations are clamped so each admitted
        request's service time (and cache residency) is bounded."""
        if self.level >= 2:
            return min(int(new_tokens), self.clamp_new_tokens)
        return int(new_tokens)

    def clamp_chunk(self, chunk_tokens: int) -> int:
        """Level >= 2 with the lever armed: the chunked-prefill chunk
        size shrinks to `clamp_chunk_tokens` so each prompt chunk holds
        the pipeline for less time — more step boundaries per second
        for the decode steps already in flight. Identity when chunking
        is off (chunk_tokens == 0 stays 0: clamping would ENABLE
        chunking, a semantic change, not a degradation)."""
        if (self.level >= 2 and self.clamp_chunk_tokens
                and chunk_tokens > 0):
            return min(int(chunk_tokens), self.clamp_chunk_tokens)
        return int(chunk_tokens)

    def allow_disaggregate(self) -> bool:
        """Level >= 4 (`colocate_prefill`): stop shipping prompt passes
        to the remote prefill fleet — run them colocated in the decode
        executor (token-identical; drops the ship edge's latency and
        fault surface while the plane is hot)."""
        return self.level < COLOCATE_LEVEL

    def shed_classes(self) -> frozenset:
        if self.level >= 6:
            return frozenset(("best_effort", "batch"))
        if self.level >= 5:
            return frozenset(("best_effort",))
        return frozenset()

    def snapshot(self) -> dict:
        return {"level": self.level, "name": self.level_name,
                "stepped": self._stepped, "floor": self._floor,
                "evicting": self.level >= EVICT_LEVEL
                and self.evict_hook is not None,
                "clamp_new_tokens": (self.clamp_new_tokens
                                     if self.level >= 2 else None),
                "clamp_chunk_tokens": (self.clamp_chunk_tokens
                                       if self.level >= 2
                                       and self.clamp_chunk_tokens
                                       else None)}
