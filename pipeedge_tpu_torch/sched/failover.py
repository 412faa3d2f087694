"""Failover re-scheduling: rebuild a pipeline schedule over the survivors
of a mid-run stage death.

The port's copy of `pipeedge_tpu/sched/failover.py` (pure Python). The
DCN driver's failover path (`runtime.py --on-peer-death failover`) calls
`plan_failover` when a rank carrying a stage dies. The planner cascades
through three strategies, most-informed first:

1. **Native scheduler** (`sched/scheduler.py` `sched_pipeline`), when the
   caller passes profile files: re-solve the partition over the surviving
   ranks' device profiles. Produces the best schedule but may CHANGE the
   cut points, so the recovered run is numerically equivalent, not
   necessarily bit-identical, to the original partition.
2. **Reverse-auction bids** (`sched/revauct.py`), when the caller passes a
   `bid_fn` that can collect fresh bids from the survivors. Same caveat
   as (1).
3. **Spare substitution**: keep the stage_layers/stage_quant exactly as
   scheduled and move each dead rank's stage onto an idle survivor (a rank
   in the fleet but not in the schedule). Because the partition is
   unchanged and every stage runs the same kernels on the same cut,
   replayed microbatches are bit-identical to a no-fault run.

Returns None when no strategy yields a schedule the survivors can run —
the caller then aborts, naming the dead rank (the pre-failover semantics).
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Set, Tuple

logger = logging.getLogger(__name__)

Schedule = Tuple[List[Tuple[int, int]], List[int], List[int]]


def plan_failover(stage_layers: Sequence[Tuple[int, int]],
                  stage_quant: Sequence[int],
                  stage_ranks: Sequence[int],
                  world_size: int,
                  dead_ranks: Set[int],
                  scheduler_fn: Optional[Callable[[int], Schedule]] = None,
                  bid_fn: Optional[Callable[[List[int]], Schedule]] = None,
                  benched: Optional[Set[int]] = None) \
        -> Optional[Schedule]:
    """Plan a schedule for the surviving ranks after `dead_ranks` died.

    `scheduler_fn(n_survivors)` re-runs the native scheduler for a fleet of
    that size and returns (stage_layers, stage_quant, stage_ranks) with
    ranks as indices 0..n-1 INTO the survivor list (remapped here);
    `bid_fn(survivors)` does the same from fresh reverse-auction bids.
    Either may raise or return None to fall through to spare substitution.

    `benched` ranks are ALIVE but must not keep a stage the schedule
    assigns them (a rejoined rank under `--on-peer-rejoin spare`: live
    idle capacity, but its old stage stays where the failover moved it).
    They remain eligible as last-resort spares — running on a benched
    rank beats running degraded.
    """
    dead_ranks = set(dead_ranks)
    benched = set(benched or ()) - dead_ranks
    survivors = [r for r in range(world_size) if r not in dead_ranks]
    lost = [i for i, r in enumerate(stage_ranks)
            if r in dead_ranks or r in benched]
    if not lost:
        # the dead rank carried no stage (an idle spare died): the running
        # schedule is untouched
        return list(stage_layers), list(stage_quant), list(stage_ranks)
    if not survivors:
        return None

    for name, attempt in (("scheduler", scheduler_fn), ("revauct", bid_fn)):
        if attempt is None:
            continue
        try:
            arg = len(survivors) if name == "scheduler" else survivors
            planned = attempt(arg)
        except Exception as exc:  # noqa: BLE001 — every strategy may fail;
            logger.warning("failover: %s re-schedule failed (%s); falling "
                           "through", name, exc)   # the cascade continues
            continue
        if planned is None:
            continue
        layers, quant, ranks = planned
        if len(layers) > len(survivors):
            logger.warning("failover: %s produced %d stages for %d "
                           "survivors; falling through", name, len(layers),
                           len(survivors))
            continue
        # scheduler ranks are indices into the survivor list; remap them
        # onto the fleet's real rank ids
        remapped = [survivors[r] for r in ranks]
        logger.info("failover: %s re-schedule: layers=%s ranks=%s",
                    name, layers, remapped)
        return list(layers), list(quant), remapped

    return substitute_spares(stage_layers, stage_quant, stage_ranks,
                             survivors, benched=benched)


def plan_rejoin(current: Schedule,
                pre_failure: Optional[Schedule],
                world_size: int,
                dead_ranks: Set[int],
                layer_costs: Optional[Sequence[float]] = None,
                align: int = 1) -> Optional[Schedule]:
    """Plan the capacity-restoring heal after a dead rank rejoined
    (`--on-peer-rejoin heal`): the inverse of `plan_failover`.

    Strategy cascade, most-faithful first:

    1. **Restore**: when every rank the `pre_failure` schedule names is
       alive again (the common one-transient-crash case), bring that
       schedule back verbatim — partition, quant, and placement exactly as
       before the death, so the healed run's numerics are bit-identical
       to a fault-free run.
    2. **Re-expand**: when the failover contracted the partition onto
       fewer stages (a scheduler re-solve over fewer survivors) and idle
       capacity is back, re-cut the span over more stages with the
       rebalance DP (`sched/rebalance.py expand_partition`), assigning
       the added stages to the idle survivors in rank order. Interior
       quant resets to 0 — the old per-stage settings do not map onto the
       new cut points.

    Returns None when neither applies (the rejoiner simply stays an idle
    spare for the NEXT failover) — including when the current schedule
    already has full capacity."""
    alive = {r for r in range(world_size) if r not in set(dead_ranks)}
    if pre_failure is not None:
        layers, quant, ranks = pre_failure
        if all(r in alive for r in ranks):
            return list(layers), list(quant), list(ranks)
    cur_layers, _cur_quant, cur_ranks = current
    spares = sorted(alive - set(cur_ranks))
    target = len(pre_failure[0]) if pre_failure else len(cur_layers) + 1
    target = min(target, len(cur_layers) + len(spares))
    if target <= len(cur_layers) or not spares:
        return None
    from . import rebalance
    try:
        expanded = rebalance.expand_partition(list(cur_layers), target,
                                              layer_costs=layer_costs,
                                              align=align)
    except ValueError as exc:
        logger.warning("rejoin: expansion to %d stages rejected (%s); "
                       "the rejoined rank stays a spare", target, exc)
        return None
    new_ranks = list(cur_ranks) + spares[:target - len(cur_layers)]
    logger.info("rejoin: re-expanding %s -> %s over ranks %s",
                list(cur_layers), expanded, new_ranks)
    return list(expanded), [0] * target, new_ranks


def substitute_spares(stage_layers: Sequence[Tuple[int, int]],
                      stage_quant: Sequence[int],
                      stage_ranks: Sequence[int],
                      survivors: Sequence[int],
                      benched: Optional[Set[int]] = None) \
        -> Optional[Schedule]:
    """Move each lost stage onto an idle survivor, keeping the partition
    (and therefore the numerics) exactly as scheduled. Returns None when
    there are fewer spares than lost stages — no capacity to fail over.

    `benched` ranks lose any stage the schedule assigns them but stay in
    the spare pool at LOWEST priority (fresh spares are preferred; a
    benched rank is picked only when nothing else is idle)."""
    alive = set(survivors)
    benched = set(benched or ()) & alive
    lost = [i for i, r in enumerate(stage_ranks)
            if r not in alive or r in benched]
    assigned = {r for i, r in enumerate(stage_ranks)
                if r in alive and i not in set(lost)}
    pool = alive - assigned
    spares = sorted(pool - benched) + sorted(pool & benched)
    if len(spares) < len(lost):
        logger.warning("failover: %d stage(s) lost but only %d spare "
                       "rank(s) idle; no capacity", len(lost), len(spares))
        return None
    new_ranks = list(stage_ranks)
    for i, spare in zip(lost, spares):
        logger.info("failover: stage %d (layers %s) moves rank %d -> %d",
                    i, tuple(stage_layers[i]), stage_ranks[i], spare)
        new_ranks[i] = spare
    return list(stage_layers), list(stage_quant), new_ranks
