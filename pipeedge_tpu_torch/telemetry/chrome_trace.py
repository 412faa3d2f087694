"""Merged fleet timeline as Chrome trace-event JSON (Perfetto-loadable).

Port copy of `pipeedge_tpu/telemetry/chrome_trace.py` (the serve
entry's `--trace-spans` writes its trace through it).

One "process" per rank, one "thread" (track) per span category, microbatch
ids as flow events so a microbatch can be followed hop-to-hop across ranks
— feed on the data rank, dispatch/compute/readback on each stage rank,
wire send/recv on every edge, results back at the data rank.

The input is the per-rank span buffers ALREADY aligned onto one timeline
(telemetry.align_spans with the NTP-style offsets `collect_spans`
estimates); this module only lays them out. Output is deterministic for a
fixed span set: events are emitted in sorted order and no wall-clock or
randomness enters the encoding — byte-identical JSON for byte-identical
inputs (the CI artifact diff relies on this).

View: load the JSON in https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from . import round_segments, segment_index

# stable track order within each rank's process (unknown categories sort
# after these, alphabetically)
_CATEGORY_ORDER = ("runtime", "feed", "stage", "compute", "quant", "wire",
                   "results", "failover", "rebalance", "serve", "monitor")

# categories whose mb-tagged spans carry the microbatch flow arrows; wire
# spans are untagged (the transport does not parse frame payloads), so the
# flow follows the host-side lifecycle spans
_FLOW_CATEGORIES = frozenset(("feed", "stage", "compute", "results"))


def _tid_for(cat: str) -> int:
    try:
        return _CATEGORY_ORDER.index(cat)
    except ValueError:
        return len(_CATEGORY_ORDER) + sum(map(ord, cat)) % 64


def build_trace(spans: Sequence[dict],
                rank_names: Optional[Dict[int, str]] = None) -> dict:
    """Aligned span dicts (any ranks mixed) -> Chrome trace-event document.

    Timestamps are re-based to the earliest span (Perfetto renders from 0)
    and expressed in microseconds with ns precision kept as fractions.
    """
    spans = sorted(spans, key=lambda s: (int(s["t0"]), int(s["t1"]),
                                         int(s["rank"]), str(s["cat"]),
                                         str(s["name"])))
    events: List[dict] = []
    base = int(spans[0]["t0"]) if spans else 0
    seen_tracks = set()
    # mb ids restart each schedule round: flow groups key on (round, mb)
    # so a replayed/re-run microbatch never chains to the previous round's
    segments = round_segments(spans)
    flows: Dict[tuple, List[dict]] = {}
    for s in spans:
        rank, cat = int(s["rank"]), str(s["cat"])
        if (rank, cat) not in seen_tracks:
            seen_tracks.add((rank, cat))
        ts = (int(s["t0"]) - base) / 1e3
        dur = max(int(s["t1"]) - int(s["t0"]), 0) / 1e3
        args = {"rank": rank}
        if s.get("stage") is not None:
            args["stage"] = int(s["stage"])
        if s.get("mb") is not None:
            args["mb"] = int(s["mb"])
        if s.get("rid") is not None:
            # request id (trace context): the key trace_report --request
            # correlates on, and a Perfetto-searchable arg
            args["rid"] = str(s["rid"])
        ev = {"ph": "X", "pid": rank, "tid": _tid_for(cat), "cat": cat,
              "name": str(s["name"]), "ts": ts, "dur": dur, "args": args}
        events.append(ev)
        if s.get("mb") is not None and cat in _FLOW_CATEGORIES:
            seg = segment_index(segments, int(s["t0"]))
            flows.setdefault((seg, int(s["mb"])), []).append(ev)

    # microbatch flow arrows: start at the first hop, step through every
    # later hop ("t" = enclosing-slice binding), so Perfetto draws the
    # hop-to-hop path of each microbatch across rank processes
    for seg, mb in sorted(flows):
        hops = flows[(seg, mb)]
        if len(hops) < 2:
            continue
        # distinct flow id per (round, mb) group; readable mb in the name
        fid = (seg + 1) * 1_000_000 + mb
        for i, ev in enumerate(hops):
            ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
            flow = {"ph": ph, "pid": ev["pid"], "tid": ev["tid"],
                    "cat": "mb", "name": f"mb{mb}", "id": fid,
                    "ts": ev["ts"] + (0.0 if i == 0 else ev["dur"] / 2)}
            if ph == "f":
                flow["bp"] = "e"
            events.append(flow)

    meta: List[dict] = []
    for rank in sorted({r for r, _ in seen_tracks}):
        name = (rank_names or {}).get(rank, f"rank {rank}")
        meta.append({"ph": "M", "pid": rank, "name": "process_name",
                     "args": {"name": name}})
        meta.append({"ph": "M", "pid": rank, "name": "process_sort_index",
                     "args": {"sort_index": rank}})
    for rank, cat in sorted(seen_tracks):
        meta.append({"ph": "M", "pid": rank, "tid": _tid_for(cat),
                     "name": "thread_name", "args": {"name": cat}})
        meta.append({"ph": "M", "pid": rank, "tid": _tid_for(cat),
                     "name": "thread_sort_index",
                     "args": {"sort_index": _tid_for(cat)}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def dump_trace(spans: Sequence[dict], path: str,
               rank_names: Optional[Dict[int, str]] = None) -> dict:
    """Write the merged trace JSON to `path`; returns the document."""
    doc = build_trace(spans, rank_names=rank_names)
    with open(path, "w", encoding="utf8") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True)
    return doc


def trace_to_spans(doc: dict) -> List[dict]:
    """Inverse-ish of `build_trace`: recover span dicts from a trace
    document's complete ("X") events — what `tools/trace_report.py` reads,
    so the report runs off the same artifact Perfetto loads."""
    spans = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        t0 = int(round(float(ev["ts"]) * 1e3))
        spans.append({"cat": ev.get("cat", ""), "name": ev.get("name", ""),
                      "rank": int(ev.get("pid", 0)),
                      "stage": ev.get("args", {}).get("stage"),
                      "mb": ev.get("args", {}).get("mb"),
                      "rid": ev.get("args", {}).get("rid"),
                      "t0": t0,
                      "t1": t0 + int(round(float(ev.get("dur", 0)) * 1e3))})
    return spans
