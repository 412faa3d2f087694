"""Bubble attribution and latency analysis over a merged span timeline.

The port's copy of `pipeedge_tpu/telemetry/report.py`, word for word but
for this docstring and `request_timeline`'s. From the span stream the
port's runtime, server, router and DCN ranks emit (host-clock spans;
they claim no device time):

- pipeline bubble %: per stage, idle time inside the active window (union
  of that stage's compute/dispatch intervals vs the fleet-wide window);
  the headline number is the mean across stages.
- per-edge wire-time share: each wire track's busy time over the window.
- per-microbatch end-to-end latency: for every mb id, last span end minus
  first span start across ALL ranks (the timeline is already aligned).
- failover breakdown: the detection and recovery spans around a mid-run
  death.
- rejoin breakdown: JOIN admissions and heal spans of the membership
  plane (each heal span's duration is that episode's
  time-to-full-capacity).
- gray-failure breakdown: peer-health lifecycle transitions (suspect /
  quarantine / readmit / recovered / floor-held) per affected rank.
- autoscale breakdown: capacity-controller decision spans
  (`serving/autoscale.py`): plan / apply / held / flap_damped per
  direction, with apply durations.
- serving and requests: admission waits, sheds and brownout transitions
  of `serve.py`'s `serve` spans; traced request ids and the worst few.
- span_overhead_pct: the recorder's own cost (per-record cost measured
  live on this host times the span count, over the window).

`request_timeline` renders one request's causal timeline across the
fleet (the rid and its `.tN`/`.hedge`/`.foN`/`.replay` derivations).
Consumed by `python -m pipeedge_tpu_torch.trace_report` (one JSON line).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import SpanRecorder, round_segments, segment_index

# categories that represent a stage doing useful work (bubble accounting)
BUSY_CATEGORIES = frozenset(("stage", "compute"))
WIRE_CATEGORY = "wire"
FAILOVER_CATEGORY = "failover"


def _union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Total length of the union of [t0, t1) intervals."""
    total = 0
    end = None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += max(0, t1 - t0)
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def measure_span_cost_ns(n: int = 2000) -> float:
    """Per-record cost of the span recorder on THIS host (ns), measured on
    a throwaway ring — the basis of `span_overhead_pct`."""
    rec = SpanRecorder(rank=0, capacity=min(n, 4096))
    t0 = time.monotonic_ns()
    for i in range(n):
        with rec.span("bench", "record", mb=i):
            pass
    return (time.monotonic_ns() - t0) / n


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy needed for a report tool)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def percentile(vals: Sequence[float], q: float) -> float:
    """Public nearest-rank percentile over (not necessarily sorted)
    samples — the one percentile definition every report surface shares
    (trace reports, benchkit records, loadgen summaries)."""
    return _percentile(sorted(vals), q)


# span categories whose per-name duration distributions are worth a
# segment breakdown (the dispatch/transfer/emit gap-hunting view)
SEGMENT_CATEGORIES = frozenset(("stage", "wire", "quant", "feed",
                                "results"))


def segment_medians(spans: Sequence[dict],
                    cats: Optional[frozenset] = None) -> Dict[str, dict]:
    """Per-(category, name) duration percentiles over a span list:
    `{"cat/name": {"n", "p50_ms", "p95_ms"}}`. The per-segment view of
    where a microbatch's end-to-end time goes — dispatch vs transfer vs
    emit — consumed by `tools/trace_report.py` and bench.py's latency
    breakdown. Feed/results names embed microbatch ids; they are folded
    to their prefix so the table stays bounded."""
    cats = SEGMENT_CATEGORIES if cats is None else cats
    series: Dict[str, List[float]] = {}
    for s in spans:
        if s.get("cat") not in cats or s.get("t1") is None:
            continue
        name = str(s.get("name", ""))
        # fold per-mb names ("mb17") and per-peer names ("send->r2") so
        # one segment key aggregates the whole series
        for sep in ("->", "<-"):
            if sep in name:
                name = name.split(sep)[0] + sep
        if name.startswith("mb") and name[2:].isdigit():
            name = "mb"
        series.setdefault(f"{s['cat']}/{name}", []).append(
            (int(s["t1"]) - int(s["t0"])) / 1e6)
    out = {}
    for key in sorted(series):
        vals = sorted(series[key])
        out[key] = {"n": len(vals),
                    "p50_ms": round(_percentile(vals, 50), 3),
                    "p95_ms": round(_percentile(vals, 95), 3)}
    return out


def analyze_spans(spans: Sequence[dict],
                  span_cost_ns: Optional[float] = None) -> dict:
    """One merged-timeline span list -> the report record (plain dict,
    json-serializable)."""
    spans = [s for s in spans if s.get("t1") is not None]
    if not spans:
        return {"spans": 0}
    t_min = min(int(s["t0"]) for s in spans)
    t_max = max(int(s["t1"]) for s in spans)
    window_ns = max(1, t_max - t_min)

    # -- per-stage busy/idle + bubble % --------------------------------
    # Two lenses: `stage_busy` counts every stage/compute span (the
    # historical bubble number), `stage_busy_core` excludes the `emit`
    # span — the downstream hand-off, which BACKPRESSURE and slow links
    # inflate (REBALANCE.md "backpressure-inflated emit"): a straggling
    # edge makes every stage LOOK busy and deflates the all-span bubble.
    # The core lens counts only genuine work (dispatch/readback/compute),
    # so a slow-link straggler honestly reads as idle — the number the
    # gray-failure A/B compares (docs/FAULT_TOLERANCE.md).
    stage_busy: Dict[str, List[Tuple[int, int]]] = {}
    stage_busy_core: Dict[str, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.get("cat") in BUSY_CATEGORIES:
            stage = s.get("stage")
            key = (f"stage{stage}" if stage is not None
                   else f"rank{s.get('rank', 0)}")
            iv = (int(s["t0"]), int(s["t1"]))
            stage_busy.setdefault(key, []).append(iv)
            if not (s.get("cat") == "stage" and s.get("name") == "emit"):
                stage_busy_core.setdefault(key, []).append(iv)
    stages = {}
    bubble_by_key = {}
    for key in sorted(stage_busy):
        busy_ns = _union_ns(stage_busy[key])
        idle_ns = max(0, window_ns - busy_ns)
        pct = 100.0 * idle_ns / window_ns
        core_ns = _union_ns(stage_busy_core.get(key, ()))
        stages[key] = {"busy_s": round(busy_ns / 1e9, 6),
                       "idle_s": round(idle_ns / 1e9, 6),
                       "bubble_pct": round(pct, 3),
                       "bubble_compute_pct": round(
                           100.0 * max(0, window_ns - core_ns)
                           / window_ns, 3)}
        bubble_by_key[key] = pct
    # headline bubble: mean over stage-indexed tracks when any span carried
    # a stage id (the rankN fallback tracks shadow the same work on DCN
    # ranks and would double-count), else over the rank tracks
    staged = [v for k, v in bubble_by_key.items() if k.startswith("stage")]
    pool = staged if staged else list(bubble_by_key.values())
    bubble_pct = round(sum(pool) / len(pool), 3) if pool else None

    # -- per-edge wire share -------------------------------------------
    edge_busy: Dict[str, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.get("cat") == WIRE_CATEGORY:
            key = f"r{s.get('rank', 0)}:{s.get('name', '')}"
            edge_busy.setdefault(key, []).append(
                (int(s["t0"]), int(s["t1"])))
    edges = {}
    for key in sorted(edge_busy):
        busy_ns = _union_ns(edge_busy[key])
        edges[key] = {"busy_s": round(busy_ns / 1e9, 6),
                      "share_pct": round(100.0 * busy_ns / window_ns, 3)}

    # -- per-microbatch end-to-end latency -----------------------------
    # mb ids restart every schedule round (replays, --measure-rounds):
    # bound each (round, mb) pair separately or a two-round trace would
    # report whole-run "latencies"
    segments = round_segments(spans)
    mb_bounds: Dict[tuple, Tuple[int, int]] = {}
    for s in spans:
        mb = s.get("mb")
        if mb is None or s.get("cat") == "serve":
            continue
        t0, t1 = int(s["t0"]), int(s["t1"])
        key = (segment_index(segments, t0), int(mb))
        cur = mb_bounds.get(key)
        mb_bounds[key] = ((t0, t1) if cur is None
                          else (min(cur[0], t0), max(cur[1], t1)))
    lat_ms = sorted((t1 - t0) / 1e6 for t0, t1 in mb_bounds.values())
    mb_latency = {
        "n": len(lat_ms),
        "p50_ms": round(_percentile(lat_ms, 50), 3),
        "p95_ms": round(_percentile(lat_ms, 95), 3),
        "p99_ms": round(_percentile(lat_ms, 99), 3),
    }

    # -- failover detection -> recovery breakdown ----------------------
    failover = {}
    fo = [s for s in spans if s.get("cat") == FAILOVER_CATEGORY]
    if fo:
        by_name: Dict[str, int] = {}
        for s in fo:
            by_name[str(s["name"])] = (by_name.get(str(s["name"]), 0)
                                       + int(s["t1"]) - int(s["t0"]))
        failover = {name: round(ns / 1e9, 6)
                    for name, ns in sorted(by_name.items())}
        # each recover span already runs detection -> replay completion,
        # so per-event recovery is its own duration (summing or pairing
        # across events would count healthy time between two failovers)
        recov = sorted((int(s["t1"]) - int(s["t0"])) / 1e9
                       for s in fo if s["name"] == "recover")
        if recov:
            failover["recoveries_s"] = [round(v, 6) for v in recov]
            failover["detect_to_recover_s"] = round(max(recov), 6)

    # -- per-round bubble ----------------------------------------------
    # the same busy/idle math per schedule round: round 0 carries compile
    # and connection setup, later rounds are warm — and on a --rebalance
    # auto run, the LAST round shows the settled partition. Comparing
    # final rounds is how the rebalance A/B avoids chasing startup noise.
    rounds = []
    for t0_seg, t1_seg in segments:
        seg_window = max(1, t1_seg - t0_seg)

        def seg_mean(busy_map):
            seg_bubbles = {}
            for key, intervals in busy_map.items():
                clipped = [(max(t0, t0_seg), min(t1, t1_seg))
                           for t0, t1 in intervals
                           if t1 > t0_seg and t0 < t1_seg]
                if not clipped:
                    # the stage recorded nothing this round (e.g. failed
                    # over away): absent, not 100% idle — it must not
                    # inflate the round's mean
                    continue
                busy_ns = _union_ns(clipped)
                seg_bubbles[key] = 100.0 * max(0, seg_window - busy_ns) \
                    / seg_window
            staged_seg = [v for k, v in seg_bubbles.items()
                          if k.startswith("stage")]
            seg_pool = (staged_seg if staged_seg
                        else list(seg_bubbles.values()))
            return (round(sum(seg_pool) / len(seg_pool), 3)
                    if seg_pool else None)

        rounds.append({
            "window_s": round(seg_window / 1e9, 6),
            "bubble_pct": seg_mean(stage_busy),
            # emit excluded (see the two-lens comment above): the
            # steady-state number the gray-failure A/B compares
            "bubble_compute_pct": seg_mean(stage_busy_core),
        })

    # -- transport tiers (docs/DCN_WIRE.md selection matrix) -----------
    # negotiation instants (cat "transport", name "tier:src->dst") count
    # edges per tier; wire-span names split busy time into the colocated
    # hand-off ("local->...") vs the socket paths — the view that proves
    # where an edge's host-hop time went after a tier switch
    # edge -> (t0, tier): the runtime renegotiates every round build, so
    # an edge's tier is its LATEST negotiation, and counts are unique
    # edges — not negotiation events
    edge_tier: Dict[str, Tuple[int, str]] = {}
    for s in spans:
        if s.get("cat") == "transport":
            tier, _, edge = str(s.get("name", "")).partition(":")
            t0 = int(s.get("t0", 0))
            if edge not in edge_tier or t0 >= edge_tier[edge][0]:
                edge_tier[edge] = (t0, tier)
    tier_edges: Dict[str, int] = {}
    for _, tier in edge_tier.values():
        tier_edges[tier] = tier_edges.get(tier, 0) + 1
    local_busy = _union_ns([(int(s["t0"]), int(s["t1"])) for s in spans
                            if s.get("cat") == WIRE_CATEGORY
                            and str(s.get("name", "")).startswith("local")])
    wire_busy = _union_ns([(int(s["t0"]), int(s["t1"])) for s in spans
                           if s.get("cat") == WIRE_CATEGORY])
    transport = {
        "edges_by_tier": dict(sorted(tier_edges.items())),
        "local_edges": tier_edges.get("local", 0),
        "local_busy_s": round(local_busy / 1e9, 6),
        "local_share_pct": round(100.0 * local_busy / wire_busy, 3)
        if wire_busy else 0.0,
    }

    # -- quantized ICI collectives: per-stage bits moved ---------------
    # instant "collective" spans (ops/qcollectives.record_collectives)
    # carry their run-total wire bytes in the name ("psum8:253440"): the
    # per-stage view that separates ICI-collective traffic from the
    # DCN-edge traffic the `edges` section times — bubble attribution
    # can then say whether a stage's wire time is inter-stage (DCN) or
    # intra-stage (quantized psum/all_gather over ICI)
    collectives = {}
    col = [s for s in spans if s.get("cat") == "collective"]
    if col:
        col_per_stage: Dict[str, dict] = {}
        col_by_kind: Dict[str, int] = {}
        col_bytes = 0
        for s in col:
            kindbit, _, nbytes_str = str(s.get("name", "")).partition(":")
            try:
                nbytes = int(nbytes_str)
            except ValueError:
                nbytes = 0
            stage = s.get("stage")
            key = (f"stage{stage}" if stage is not None
                   else f"rank{s.get('rank', 0)}")
            st = col_per_stage.setdefault(key, {"sites": 0, "wire_bytes": 0})
            st["sites"] += 1
            st["wire_bytes"] += nbytes
            col_by_kind[kindbit] = col_by_kind.get(kindbit, 0) + nbytes
            col_bytes += nbytes
        dcn_busy_s = round(wire_busy / 1e9, 6)
        collectives = {
            "sites": len(col),
            "wire_bytes": col_bytes,
            "by_kind": dict(sorted(col_by_kind.items())),
            "per_stage": {k: col_per_stage[k] for k in sorted(col_per_stage)},
            # the ICI-vs-DCN split: bytes the collectives moved beside the
            # time the DCN edges spent (the edges section holds per-edge
            # detail; this is the one-glance comparison)
            "dcn_edge_busy_s": dcn_busy_s,
        }

    # -- closed-loop rebalancing --------------------------------------
    # "plan" spans time every consideration; an instant "apply" span marks
    # each ACCEPTED re-partition (the zero-churn assertion counts these)
    rebalance_events = sum(1 for s in spans
                           if s.get("cat") == "rebalance"
                           and s.get("name") == "apply")

    # -- elastic membership: rejoin -> heal breakdown ------------------
    # an instant "admit" span per JOIN admission; each "heal" span runs
    # the episode's first death detection -> partition healed, i.e. its
    # duration IS the time-to-full-capacity (docs/FAULT_TOLERANCE.md)
    rejoin = {}
    rj = [s for s in spans if s.get("cat") == "rejoin"]
    if rj:
        heals = sorted((int(s["t1"]) - int(s["t0"])) / 1e9
                       for s in rj if s["name"] == "heal")
        rejoin = {
            "admissions": sum(1 for s in rj if s["name"] == "admit"),
            "heals": len(heals),
        }
        if heals:
            rejoin["heals_s"] = [round(v, 6) for v in heals]
            rejoin["time_to_full_capacity_s"] = round(max(heals), 6)

    # -- gray failures: peer-health transitions ------------------------
    # instant "health" spans, one per lifecycle transition, with the
    # affected rank in the name ("quarantine:r2"): suspect / quarantine /
    # readmit (quarantined -> probation) / recovered (probation ->
    # healthy) / held (min-fleet floor refused the bench) — the section
    # the gray-failure CI smoke gates on (exactly one quarantine on the
    # chaos run, ZERO on the clean run). docs/FAULT_TOLERANCE.md.
    gray = {}
    hl = [s for s in spans if s.get("cat") == "health"]
    if hl:
        by_kind: Dict[str, int] = {}
        by_rank: Dict[str, List[str]] = {}
        for s in hl:
            kind, _, target = str(s.get("name", "")).partition(":")
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if target:
                by_rank.setdefault(target, []).append(kind)
        gray = {
            "suspects": by_kind.get("suspect", 0),
            "quarantines": by_kind.get("quarantine", 0),
            "readmits": by_kind.get("readmit", 0),
            "recovered": by_kind.get("recovered", 0),
            "held": by_kind.get("held", 0),
            "by_rank": {k: by_rank[k] for k in sorted(by_rank)},
        }

    # -- autoscale: capacity-controller decisions ----------------------
    # cat "autoscale" spans from the CapacityController: "plan:{dir}"
    # (dry-run duration), "apply:{dir}" (actuation duration), instant
    # "held:{dir}" (un-runnable plan / failed actuator) and
    # "flap_damped:{dir}" (damper swallowed a reversal). The chaos CI
    # gates on this section: scale-up AND scale-down observed under the
    # ramp, ZERO decisions on the steady control run.
    autoscale = {}
    al = [s for s in spans if s.get("cat") == "autoscale"]
    if al:
        as_kinds: Dict[str, int] = {}
        as_dirs: Dict[str, Dict[str, int]] = {}
        apply_ms: List[float] = []
        for s in al:
            kind, _, direction = str(s.get("name", "")).partition(":")
            as_kinds[kind] = as_kinds.get(kind, 0) + 1
            if direction:
                d = as_dirs.setdefault(direction, {})
                d[kind] = d.get(kind, 0) + 1
            if kind == "apply":
                apply_ms.append((int(s["t1"]) - int(s["t0"])) / 1e6)
        autoscale = {
            "plans": as_kinds.get("plan", 0),
            "applies": as_kinds.get("apply", 0),
            "held": as_kinds.get("held", 0),
            "flap_damped": as_kinds.get("flap_damped", 0),
            "by_direction": {k: dict(sorted(v.items()))
                             for k, v in sorted(as_dirs.items())},
        }
        if apply_ms:
            apply_ms.sort()
            autoscale["apply_ms"] = {
                "n": len(apply_ms),
                "p50": round(_percentile(apply_ms, 50), 3),
                "max": round(apply_ms[-1], 3)}

    # -- serving plane: admission waits / sheds / brownout -------------
    # tools/serve.py records cat "serve" spans: "admit:{class}" (duration
    # = EDF-queue wait of an ADMITTED request — shed waits record under
    # "shed:{class}:{reason}" so they can't skew this stat), instant
    # "brownout:{level}" per ladder transition, and "generate"/
    # "speculative" around each admitted request (docs/SERVING.md)
    serving = {}
    sv = [s for s in spans if s.get("cat") == "serve"]
    if sv:
        admit_waits: Dict[str, List[float]] = {}
        sheds_by_class: Dict[str, int] = {}
        sheds_by_reason: Dict[str, int] = {}
        levels: List[int] = []
        for s in sv:
            name = str(s["name"])
            if name.startswith("admit:"):
                admit_waits.setdefault(name[len("admit:"):], []).append(
                    (int(s["t1"]) - int(s["t0"])) / 1e6)
            elif name.startswith("shed:"):
                _, cls, reason = name.split(":", 2)
                sheds_by_class[cls] = sheds_by_class.get(cls, 0) + 1
                sheds_by_reason[reason] = sheds_by_reason.get(reason, 0) + 1
            elif name.startswith("brownout:"):
                levels.append(int(name[len("brownout:"):]))
        serving = {
            "requests": sum(1 for s in sv
                            if s["name"] in ("generate", "speculative")),
            "admit_wait_ms": {
                cls: {"n": len(vals),
                      "p50": round(_percentile(sorted(vals), 50), 3),
                      "p95": round(_percentile(sorted(vals), 95), 3)}
                for cls, vals in sorted(admit_waits.items())},
            "sheds": sum(sheds_by_class.values()),
            "sheds_by_class": dict(sorted(sheds_by_class.items())),
            "sheds_by_reason": dict(sorted(sheds_by_reason.items())),
            "brownout": {"transitions": len(levels),
                         "max_level": max(levels) if levels else 0},
        }

    # -- request dimension (request-scoped tracing) --------------------
    # every rid-tagged span belongs to one request's causal timeline;
    # the worst list is the "which request do I trace_report --request"
    # entry point when no loadgen/504 artifact named one
    rid_bounds: Dict[str, Tuple[int, int]] = {}
    for s in spans:
        rid = s.get("rid")
        if rid is None:
            continue
        t0, t1 = int(s["t0"]), int(s["t1"])
        cur = rid_bounds.get(rid)
        rid_bounds[rid] = ((t0, t1) if cur is None
                           else (min(cur[0], t0), max(cur[1], t1)))
    worst = sorted(((t1 - t0) / 1e6, rid)
                   for rid, (t0, t1) in rid_bounds.items())[-3:]
    requests = {}
    if rid_bounds:
        requests = {"n": len(rid_bounds),
                    "worst": [{"rid": rid, "ms": round(ms, 3)}
                              for ms, rid in reversed(worst)]}

    if span_cost_ns is None:
        span_cost_ns = measure_span_cost_ns()
    overhead_pct = 100.0 * len(spans) * span_cost_ns / window_ns

    return {
        "spans": len(spans),
        "ranks": sorted({int(s.get("rank", 0)) for s in spans}),
        "window_s": round(window_ns / 1e9, 6),
        "bubble_pct": bubble_pct,
        "rounds": rounds,
        "stages": stages,
        "edges": edges,
        "segments": segment_medians(spans),
        "transport": transport,
        "collectives": collectives,
        "mb_latency": mb_latency,
        "serving": serving,
        "requests": requests,
        "failover": failover,
        "rejoin": rejoin,
        "gray": gray,
        "autoscale": autoscale,
        "rebalance_events": rebalance_events,
        "span_cost_ns": round(span_cost_ns, 1),
        "span_overhead_pct": round(overhead_pct, 4),
    }


# -- request-scoped causal timeline (trace_report --request) -------------

def _segment_key(s: dict) -> Optional[str]:
    """Attribution bucket of one request-tagged span: the named slice of
    the request's end-to-end time this span explains. None = an envelope
    span (the whole-request wrapper) that must not compete with its own
    parts for the dominant-stall title."""
    cat = str(s.get("cat", ""))
    name = str(s.get("name", ""))
    stage = s.get("stage")
    if cat == "serve":
        if name.startswith("admit:"):
            return "queue_wait"
        if name.startswith("shed:"):
            return "shed_wait"
        return None                     # generate/speculative: envelope
    if cat == "router":
        if name.startswith(("dispatch:", "stream:")):
            # route hop to a named replica — the fleet timeline's
            # router-side view of each attempt/failover leg
            return f"route/{name.split(':', 1)[1]}"
        return None                     # admit/health_poll: envelope
    if cat == "compute":
        return f"stage{stage}/compute" if stage is not None else "compute"
    if cat == "stage":
        if name in ("dispatch", "readback", "emit"):
            return (f"stage{stage}/{name}" if stage is not None
                    else name)
        # executor exec{i} / host-pipeline stage{i}: per-stage compute
        return (f"stage{stage}/compute" if stage is not None
                else f"{name}/compute")
    if cat == "wire":
        return f"wire/{name}"
    if cat == "quant":
        return f"stage{stage}/quant" if stage is not None else "quant"
    if cat == "feed":
        return "feed"
    if cat == "results":
        return "retire"
    return None


def _rid_tree_member(span_rid, rid: str) -> bool:
    """`span_rid` is `rid` itself or a dot-suffixed descendant — the
    derivation grammar `rid[.tN|.hedge|.foN|.replay]*` the router and
    executors mint (docs/OBSERVABILITY.md fleet observatory)."""
    if not isinstance(span_rid, str):
        return False
    return span_rid == rid or span_rid.startswith(rid + ".")


def request_timeline(spans: Sequence[dict], rid: str,
                     max_events: int = 400, tree: bool = True) -> dict:
    """One request's causal timeline from a merged span list: every span
    in `rid`'s derivation tree (the rid plus its retry/hedge/failover-
    replay children — `tree=False` pins exact-match), ordered,
    attributed to named segments (queue wait, route hops, per-stage
    compute/dispatch/readback/emit, per-edge transfer, feed, retire),
    with the DOMINANT STALL — the segment whose union-busy time
    explains the largest share of the request's end-to-end window —
    called out. The artifact that answers "why was THIS request slow",
    across the routed fleet."""
    if tree:
        mine = [s for s in spans
                if _rid_tree_member(s.get("rid"), rid)
                and s.get("t1") is not None]
    else:
        mine = [s for s in spans
                if s.get("rid") == rid and s.get("t1") is not None]
    if not mine:
        return {"rid": rid, "found": False}
    mine.sort(key=lambda s: (int(s["t0"]), int(s["t1"])))
    t_lo = min(int(s["t0"]) for s in mine)
    t_hi = max(int(s["t1"]) for s in mine)
    total_ns = max(1, t_hi - t_lo)

    seg_intervals: Dict[str, List[Tuple[int, int]]] = {}
    all_intervals: List[Tuple[int, int]] = []
    for s in mine:
        key = _segment_key(s)
        iv = (int(s["t0"]), int(s["t1"]))
        if key is not None:
            seg_intervals.setdefault(key, []).append(iv)
            all_intervals.append(iv)
    segments = {}
    busy_by_key = {}
    for key in sorted(seg_intervals):
        busy_ns = _union_ns(seg_intervals[key])
        busy_by_key[key] = busy_ns
        segments[key] = {"n": len(seg_intervals[key]),
                         "busy_ms": round(busy_ns / 1e6, 3),
                         "share_pct": round(100.0 * busy_ns / total_ns, 3)}
    dominant = None
    if segments:
        # rank on raw ns (rounded ms would tie sub-ms segments)
        name = max(busy_by_key, key=busy_by_key.get)
        dominant = {"segment": name, **segments[name]}
    unattributed_ns = max(0, total_ns - _union_ns(all_intervals))

    timeline = [{"t_ms": round((int(s["t0"]) - t_lo) / 1e6, 3),
                 "dur_ms": round((int(s["t1"]) - int(s["t0"])) / 1e6, 3),
                 "cat": s.get("cat"), "name": s.get("name"),
                 "rank": s.get("rank"), "stage": s.get("stage"),
                 "mb": s.get("mb")}
                for s in mine[:max_events]]
    return {
        "rid": rid,
        "found": True,
        "spans": len(mine),
        "rids": sorted({str(s.get("rid")) for s in mine}),
        "ranks": sorted({int(s.get("rank", 0)) for s in mine}),
        "stages": sorted({int(s["stage"]) for s in mine
                          if s.get("stage") is not None}),
        "mbs": sorted({int(s["mb"]) for s in mine
                       if s.get("mb") is not None}),
        "total_ms": round(total_ns / 1e6, 3),
        "segments": segments,
        "dominant_stall": dominant,
        "unattributed_ms": round(unattributed_ns / 1e6, 3),
        "timeline": timeline,
    }
