"""Measured-profile extraction: span digests -> scheduler-consumable costs.

The port's copy of `pipeedge_tpu/telemetry/feedback.py`, word for word
but for this docstring. It turns the recorded per-stage and per-edge
spans into the per-stage service-time estimates a scheduler re-solves
the partition with:

- a **digest** is the cumulative `(cat, name, stage) -> (count,
  total_ns)` rollup each rank's `SpanRecorder` maintains
  (`telemetry.Digest`), differenced against the previous round's digest
  for a clean per-round window.
- a **StageEstimate** decomposes one stage's measured per-microbatch
  time into the parts a solver treats differently: `dispatch`/`readback`
  scale with the layer range, while `emit` (the socket send, including
  any slow-link stall) is a per-microbatch cost the stage keeps no
  matter how few layers it carries.
- `check_estimates` is the self-test gate: a window whose estimates are
  incomplete (a stage that never dispatched) is refused rather than
  acted on.

`digest_from_spans` runs the same extraction over a merged trace file:
`python -m pipeedge_tpu_torch.trace_report --emit-profiles`; the DCN
runtime's `--rebalance auto` and `--autoscale-ranks` read it at every
round boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from . import DIGEST_CATEGORIES, Digest

# stage-cat span names that scale with the stage's layer range vs. the
# per-microbatch fixed part (see module docstring)
_LAYER_NAMES = frozenset(("dispatch", "readback"))
_FIXED_NAMES = frozenset(("emit",))


@dataclasses.dataclass(frozen=True)
class StageEstimate:
    """Measured per-microbatch timing of one pipeline stage (seconds)."""
    stage: int
    n: int                 # microbatches observed in the window
    dispatch_s: float      # work-thread time: decode + shard-step dispatch
    readback_s: float      # send-thread time: device completion + D2H
    emit_s: float          # send-thread time: socket send (slow links land
    # here — and stay per-microbatch no matter the layer range)
    compute_s: float = 0.0  # host dispatch of the jitted step (informational)

    @property
    def layer_s(self) -> float:
        """The part of the service time that moves with the layer range."""
        return self.dispatch_s + self.readback_s

    @property
    def fixed_s(self) -> float:
        """The part the stage keeps regardless of its layer range."""
        return self.emit_s

    @property
    def service_s(self) -> float:
        """Modeled per-microbatch service time (the solver's currency)."""
        return self.layer_s + self.fixed_s


def diff_digests(current: Digest, previous: Digest) -> Digest:
    """Per-round window: `current - previous` (both cumulative). Keys that
    regressed (a restarted rank with a fresh recorder) fall back to their
    current value rather than going negative."""
    out: Digest = {}
    for key, (n, ns) in current.items():
        pn, pns = previous.get(key, (0, 0))
        if n < pn or ns < pns:
            pn = pns = 0
        if n - pn > 0:
            out[key] = (n - pn, ns - pns)
    return out


def merge_digests(digests: Sequence[Digest]) -> Digest:
    """Sum per-rank digest windows into one fleet digest (keys are
    stage-qualified, so ranks never collide on real stage entries)."""
    out: Dict = {}
    for d in digests:
        for key, (n, ns) in d.items():
            cur = out.get(key)
            out[key] = (n + cur[0], ns + cur[1]) if cur else (n, ns)
    return out


def digest_from_spans(spans: Sequence[dict]) -> Digest:
    """The recorder's rollup, computed from a span list instead — the
    offline path (`trace_report.py --emit-profiles` over a merged trace)."""
    out: Dict = {}
    for s in spans:
        if s.get("cat") not in DIGEST_CATEGORIES or s.get("t1") is None:
            continue
        key = (str(s["cat"]), str(s["name"]), s.get("stage"))
        dur = int(s["t1"]) - int(s["t0"])
        cur = out.get(key)
        out[key] = (cur[0] + 1, cur[1] + dur) if cur else (1, dur)
    return out


def stage_estimates(digest: Digest) -> Dict[int, StageEstimate]:
    """Per-stage timing decomposition from a (fleet-merged, per-round)
    digest window. Only stage-tagged entries contribute — the DCN stage
    threads tag their dispatch/readback/emit spans with the stage id."""
    acc: Dict[int, Dict[str, List[int]]] = {}
    for (cat, name, stage), (n, ns) in digest.items():
        if stage is None:
            continue
        if cat == "stage" and (name in _LAYER_NAMES or name in _FIXED_NAMES):
            part = name
        elif cat == "compute":
            part = "compute"
        else:
            continue
        cell = acc.setdefault(int(stage), {}).setdefault(part, [0, 0])
        cell[0] += n
        cell[1] += ns

    def avg(parts, name):
        n, ns = parts.get(name, (0, 0))
        return (ns / n / 1e9) if n else 0.0

    out = {}
    for stage, parts in acc.items():
        counts = [v[0] for k, v in parts.items() if k in _LAYER_NAMES]
        out[stage] = StageEstimate(
            stage=stage,
            n=max(counts) if counts else 0,
            dispatch_s=avg(parts, "dispatch"),
            readback_s=avg(parts, "readback"),
            emit_s=avg(parts, "emit"),
            compute_s=avg(parts, "compute"))
    return out


def edge_estimates(digest: Digest) -> Dict[str, float]:
    """Mean wire transfer seconds per frame, keyed by the wire span name
    (`send->rN` / `recv<-rN`). Informational alongside the stage
    estimates: the socket time already rides in each stage's `emit`."""
    out = {}
    for (cat, name, _stage), (n, ns) in digest.items():
        if cat == "wire" and n:
            out[name] = ns / n / 1e9
    return out


def check_estimates(estimates: Dict[int, StageEstimate], n_stages: int,
                    min_samples: int = 1) -> List[str]:
    """Self-test of a measurement window before anyone acts on it: every
    stage present, enough microbatches observed, no degenerate timings.
    Returns human-readable problems (empty = trustworthy)."""
    problems = []
    for stage in range(n_stages):
        est = estimates.get(stage)
        if est is None:
            problems.append(f"stage {stage}: no measurements in the window")
            continue
        if est.n < min_samples:
            problems.append(f"stage {stage}: only {est.n} microbatch(es) "
                            f"observed (need >= {min_samples})")
        if est.service_s <= 0.0:
            problems.append(f"stage {stage}: non-positive service time "
                            f"({est.service_s:.9f}s)")
    for stage in sorted(estimates):
        if not 0 <= stage < n_stages:
            problems.append(f"stage {stage}: outside the {n_stages}-stage "
                            "schedule (stale digest window?)")
    return problems
