"""Closed-loop pipeline rebalancing: re-solve the layer partition from
MEASURED per-stage timings.

The port's copy of `pipeedge_tpu/sched/rebalance.py`. The offline DP
scheduler (`sched/scheduler.py`, the native `sched-pipeline` binary) maps
layer ranges from profiles recorded before the run; a mispredicted or
drifting stage then bubbles the whole pipeline. This module holds the
pure logic that closes the loop:

- `solve_partition` is the same objective as the native solver's DP —
  minimize the bottleneck stage time over contiguous layer ranges — run
  in-process over live costs: a per-layer cost vector (measured stage
  times spread over their ranges) plus a per-STAGE fixed cost (the
  emit/wire time a stage pays per microbatch no matter how few layers it
  carries — a slow link must not be "solved" by moving layers that cannot
  remove it).
- `RebalancePolicy` wraps the solver with the guards that keep a balanced
  fleet from churning: a proposal must differ from the running partition,
  predict at least `threshold` relative bottleneck gain (hysteresis /
  minimum-gain), and respect a cooldown of full rounds after the previous
  rebalance (no oscillation on noisy windows).

`sched/profiles.py results_from_measured` spreads measured stage times
with `spread_layer_costs`. The multi-process driver that re-plans between
rounds is not in the port yet.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

Partition = List[Tuple[int, int]]


def spread_layer_costs(partition: Sequence[Tuple[int, int]],
                       stage_layer_s: Sequence[float]) -> List[float]:
    """Per-layer cost vector from per-stage measured times: stage i's
    layer-proportional seconds (`StageEstimate.layer_s`) spread uniformly
    over its `[l, r]` range — the per-layer resolution a per-stage
    measurement supports. Layers are 1-based inclusive, ranges contiguous
    from 1 (the repo's partition convention)."""
    if len(partition) != len(stage_layer_s):
        raise ValueError(f"{len(partition)} stages != "
                         f"{len(stage_layer_s)} stage costs")
    costs: List[float] = []
    expect = 1
    for (l, r), total_s in zip(partition, stage_layer_s):
        if l != expect or r < l:
            raise ValueError(f"partition {list(partition)} is not "
                             "contiguous from layer 1")
        costs.extend([float(total_s) / (r - l + 1)] * (r - l + 1))
        expect = r + 1
    return costs


def solve_partition(layer_costs: Sequence[float], n_stages: int,
                    fixed_costs: Optional[Sequence[float]] = None,
                    align: int = 1) -> Tuple[Partition, float]:
    """Minimize the bottleneck stage time: partition layers 1..L into
    `n_stages` contiguous non-empty ranges minimizing
    `max_i(fixed_costs[i] + sum(layer_costs in range_i))` — the native DP
    solver's objective, over live costs. `align` constrains every cut to a
    multiple of `align` layers (the `--stage-tp` block-alignment rule).
    Returns `(partition, bottleneck)` — the optimum AND its objective
    value, so callers never re-derive the cost model the DP optimized.
    Deterministic: ties resolve to the earliest cut."""
    n_layers = len(layer_costs)
    if n_stages < 1 or n_layers < n_stages:
        raise ValueError(f"cannot split {n_layers} layers into "
                         f"{n_stages} non-empty stages")
    if fixed_costs is None:
        fixed_costs = [0.0] * n_stages
    if len(fixed_costs) != n_stages:
        raise ValueError(f"{len(fixed_costs)} fixed costs != "
                         f"{n_stages} stages")
    if align > 1:
        if n_layers % align:
            raise ValueError(f"{n_layers} layers not a multiple of "
                             f"align={align}")
        groups = [sum(layer_costs[g * align:(g + 1) * align])
                  for g in range(n_layers // align)]
        grouped, bottleneck = solve_partition(groups, n_stages,
                                              fixed_costs, align=1)
        return ([((l - 1) * align + 1, r * align) for l, r in grouped],
                bottleneck)

    prefix = [0.0]
    for c in layer_costs:
        prefix.append(prefix[-1] + float(c))

    inf = float("inf")
    # best[i][j]: minimal bottleneck splitting the first j layers over the
    # first i stages (each non-empty); cut[i][j]: the j' that achieves it
    best = [[inf] * (n_layers + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n_layers + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for i in range(1, n_stages + 1):
        fixed = float(fixed_costs[i - 1])
        # stages after this one each need >= 1 layer
        for j in range(i, n_layers - (n_stages - i) + 1):
            for k in range(i - 1, j):
                if best[i - 1][k] == inf:
                    continue
                cand = max(best[i - 1][k], fixed + prefix[j] - prefix[k])
                if cand < best[i][j]:
                    best[i][j] = cand
                    cut[i][j] = k
    partition: Partition = []
    j = n_layers
    for i in range(n_stages, 0, -1):
        k = cut[i][j]
        partition.append((k + 1, j))
        j = k
    partition.reverse()
    return partition, best[n_stages][n_layers]


@dataclasses.dataclass(frozen=True)
class Proposal:
    """An accepted rebalance: the new partition plus the prediction that
    justified it (recorded in logs/bench JSON for post-hoc audit)."""
    partition: Partition
    bottleneck_before_s: float
    bottleneck_after_s: float

    @property
    def gain(self) -> float:
        """Predicted relative bottleneck reduction (0..1)."""
        if self.bottleneck_before_s <= 0:
            return 0.0
        return (self.bottleneck_before_s - self.bottleneck_after_s) \
            / self.bottleneck_before_s


class RebalancePolicy:
    """The decision loop's guardrails around `solve_partition`.

    `consider(partition, estimates, rnd)` returns a `Proposal` only when
    ALL of: the re-solved partition differs from the running one, the
    predicted relative bottleneck gain is at least `threshold`
    (hysteresis: a balanced fleet's near-zero gains never churn), the
    SAME stage has been the measured bottleneck for `confirm`+1
    consecutive windows (a real straggler persists; round-to-round drift
    — compile caches warming, host contention — flips direction and is
    filtered out), and at least `cooldown` full rounds have completed
    since the last accepted proposal (no oscillation while a previous
    re-plan's effect is still being measured). `events` counts accepted
    proposals.
    """

    def __init__(self, threshold: float = 0.10, cooldown: int = 1,
                 align: int = 1, confirm: int = 1):
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {cooldown}")
        if confirm < 0:
            raise ValueError(f"confirm must be >= 0, got {confirm}")
        self.threshold = float(threshold)
        self.cooldown = int(cooldown)
        self.align = int(align)
        self.confirm = int(confirm)
        self.events = 0
        self._last_round: Optional[int] = None
        # consecutive actionable windows blaming the same bottleneck stage
        self._streak_stage: Optional[int] = None
        self._streak = 0

    def consider(self, partition: Sequence[Tuple[int, int]],
                 estimates: Dict[int, "object"],
                 rnd: int) -> Optional[Proposal]:
        """One decision over a measured round window. `estimates` maps
        every stage index to its estimate for the partition as it ran: an
        object with `layer_s` (layer-proportional seconds), `fixed_s` (the
        stage's per-microbatch fixed cost) and `service_s` (their sum)."""
        n_stages = len(partition)
        ordered = [estimates[i] for i in range(n_stages)]
        layer_costs = spread_layer_costs(partition,
                                         [e.layer_s for e in ordered])
        fixed = [e.fixed_s for e in ordered]
        before = max(e.service_s for e in ordered)
        try:
            proposed, after = solve_partition(layer_costs, n_stages, fixed,
                                              align=self.align)
        except ValueError as exc:
            logger.warning("rebalance: solver rejected the measured "
                           "profile (%s); keeping partition", exc)
            return None
        proposal = Proposal(partition=proposed,
                            bottleneck_before_s=before,
                            bottleneck_after_s=after)
        if proposed == [tuple(p) for p in partition]:
            self._streak_stage = None
            self._streak = 0
            return None
        if proposal.gain < self.threshold:
            logger.info("rebalance: predicted gain %.1f%% below the "
                        "%.1f%% threshold; keeping partition",
                        100 * proposal.gain, 100 * self.threshold)
            self._streak_stage = None
            self._streak = 0
            return None
        bottleneck = max(range(n_stages), key=lambda i: ordered[i].service_s)
        if bottleneck == self._streak_stage:
            self._streak += 1
        else:
            self._streak_stage = bottleneck
            self._streak = 1
        if self._streak < self.confirm + 1:
            logger.info("rebalance: stage %d measured as bottleneck "
                        "(window %d of %d needed); awaiting confirmation",
                        bottleneck, self._streak, self.confirm + 1)
            return None
        if self._last_round is not None \
                and rnd - self._last_round <= self.cooldown:
            logger.info("rebalance: in cooldown (last rebalance at round "
                        "%d, cooldown %d); keeping partition",
                        self._last_round, self.cooldown)
            return None
        self._last_round = rnd
        self._streak_stage = None
        self._streak = 0
        self.events += 1
        return proposal
