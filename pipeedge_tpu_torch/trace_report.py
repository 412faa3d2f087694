"""Bubble attribution + latency report over the port's span traces.

The port's `tools/trace_report.py`: it reads the Perfetto-loadable trace
JSON a `--trace-spans OUT` run wrote (the port's runtime, server, or a
DCN rank), a flight-recorder postmortem bundle, or a `pipeedge-bench`
record naming its trace, and prints ONE JSON line with:

- `bubble_pct`: mean per-stage idle share of the active window, plus the
  per-stage busy/idle split under `stages`
- `edges`: per-edge wire-time busy seconds + share of the window
- `segments`: per-(category, name) duration p50/p95: the dispatch vs
  transfer vs emit breakdown of a microbatch's end-to-end path
- `transport`: edges per negotiated tier (local / zerocopy / socket_v2)
  + the colocated hand-off's share of wire-busy time
- `collectives`: bytes moved by quantized collectives beside the DCN-edge
  busy time (empty until the port has them, ROADMAP A7)
- `mb_latency`: per-microbatch end-to-end p50/p95/p99 (ms) across ranks
- `serving`: from a `serve.py --trace-spans` run: admitted request
  count, per-class admission-wait p50/p95, sheds by class and reason,
  brownout transitions + max rung
- `requests`: distinct traced request ids + the worst few by end-to-end
  duration: the entry point into `--request`
- `gray`: peer-health lifecycle transitions per affected rank
- `autoscale`: capacity-controller decision spans: plan / apply / held /
  flap_damped per direction with apply durations
- `failover`: detection -> recovery breakdown when a failover happened
- `span_overhead_pct`: the recorder's own measured hot-path tax
  (per-span cost measured live on this host x span count / window)

With `--request RID` it instead renders ONE request's causal timeline
(admit -> queue -> route hops -> per-stage per-edge -> retire) with its
dominant stall named. With `--fleet URL` it reads no file: it federates
the live span rings of a routed fleet (the router at URL and every
process `GET /fleet` names, else `/healthz`), clock-aligned onto one
timeline. Spans time the host clock; they claim no device time.

    python -m pipeedge_tpu_torch.runtime 0 2 -c dcn ... \
        --trace-spans /tmp/trace.json
    python -m pipeedge_tpu_torch.trace_report /tmp/trace.json
    python -m pipeedge_tpu_torch.trace_report /tmp/trace.json --request q17
    python -m pipeedge_tpu_torch.trace_report --fleet http://127.0.0.1:8321 \
        --request R3
    python -m pipeedge_tpu_torch.trace_report /tmp/trace.json \
        --emit-profiles live.yaml --partition 1,24,25,48 \
        --model google/vit-base-patch16-224 --profile-batch-size 8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from . import telemetry
from .telemetry import chrome_trace, feedback, report


def _emit_profiles(args, spans) -> None:
    """Measured per-stage service times -> profiler_results.yml
    (sched/profiles.py ingestion)."""
    from .sched import profiles

    nums = [int(x) for x in args.partition.split(",")]
    if len(nums) % 2:
        raise SystemExit("--partition needs comma-separated layer PAIRS")
    partition = list(zip(nums[::2], nums[1::2]))
    est = feedback.stage_estimates(feedback.digest_from_spans(spans))
    problems = feedback.check_estimates(est, len(partition))
    if problems:
        raise SystemExit("--emit-profiles: trace measurements incomplete: "
                         + "; ".join(problems))
    record = profiles.results_from_measured(
        args.model, args.dtype, args.profile_batch_size,
        total_layers=partition[-1][1], partition=partition,
        # layer_s, NOT service_s: the per-microbatch emit/wire fixed cost
        # must not be baked into per-layer compute times — the offline
        # scheduler models comm separately (bw_Mbps x boundary elements)
        stage_times_s=[est[i].layer_s for i in range(len(partition))])
    profiles.save_measured_profiles(args.emit_profiles, record)
    print(f"emitted measured per-layer profiles for {len(partition)} "
          f"stage(s) -> {args.emit_profiles}", file=sys.stderr)


def _load_spans(path: str):
    """Span dicts from any input shape: a merged Chrome-trace JSON
    (`--trace-spans` output), a flight-recorder postmortem bundle
    (telemetry/flight.py — its `spans` slice is already span dicts), or
    a benchkit trajectory record/artifact whose serve block names the
    trace it produced (`serve.trace`) — so `trace_report BENCH_r06.json
    --request q17` resolves a record's p99 exemplar without the caller
    digging the trace path out by hand."""
    with open(path, encoding="utf8") as f:
        doc = json.load(f)
    if isinstance(doc, dict) and doc.get("bundle") == "pipeedge-postmortem":
        return list(doc.get("spans", ())), doc
    if isinstance(doc, dict) and str(doc.get("schema",
                                             "")).startswith("pipeedge-bench"):
        records = ([doc] if "scenario" in doc
                   else list(doc.get("records", ())))
        for rec in records:
            trace = (rec.get("serve") or {}).get("trace")
            if trace:
                if not os.path.isabs(trace):
                    trace = os.path.join(os.path.dirname(
                        os.path.abspath(path)), trace)
                with open(trace, encoding="utf8") as fh:
                    return chrome_trace.trace_to_spans(json.load(fh)), None
        raise SystemExit(f"{path} is a bench record but no scenario in "
                         "it carries a serve.trace path")
    return chrome_trace.trace_to_spans(doc), None


def _fetch_json(url: str, timeout: float) -> dict:
    """GET url -> parsed JSON; an HTTP error status with a JSON body
    (the router's 503 /healthz while unroutable) still parses."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf8"))
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read().decode("utf8"))


def _fleet_targets(fleet_url: str, timeout: float) -> dict:
    """{name: base_url} of every process in the routed fleet: the router
    itself, plus whatever GET /fleet (the collector's target set —
    includes prefill workers) or, failing that, GET /healthz's fleet
    block reports."""
    targets = {"router": fleet_url}
    try:
        body = _fetch_json(f"{fleet_url}/fleet", timeout)
        for name, url in (body.get("targets") or {}).items():
            targets.setdefault(name, url)
    except (OSError, ValueError):
        pass
    if len(targets) == 1:
        body = _fetch_json(f"{fleet_url}/healthz", timeout)
        for name, rec in (body.get("fleet") or {}).items():
            url = (rec or {}).get("url")
            if url:
                targets.setdefault(name, url)
    return targets


def _collect_fleet(fleet_url: str, timeout: float = 5.0):
    """Federate span rings across the routed fleet: GET /debug/spans
    from every process, estimate each peer's monotonic-clock offset
    from the fetch's own (t0, t1, t2, t3) quadruple (telemetry.
    estimate_clock_offset), align onto the caller's timeline, and remap
    each process's span `rank` to a distinct per-process index (every
    serving process records rank 0 locally — without the remap two
    replicas would collapse into one lane). Returns (spans, processes).
    """
    fleet_url = fleet_url.rstrip("/")
    spans = []
    processes = {}
    for idx, (name, url) in enumerate(
            sorted(_fleet_targets(fleet_url, timeout).items())):
        proc = {"target": name, "url": url}
        try:
            t0 = time.monotonic_ns()
            body = _fetch_json(f"{url.rstrip('/')}/debug/spans", timeout)
            t3 = time.monotonic_ns()
            theta = telemetry.estimate_clock_offset(
                [(t0, int(body["t_recv_ns"]), int(body["t_send_ns"]), t3)])
            aligned = telemetry.align_spans(body.get("spans") or (), theta)
            for s in aligned:
                s["rank"] = idx
            spans.extend(aligned)
            proc.update({"ok": True, "pid": body.get("pid"),
                         "spans": len(aligned),
                         "dropped": body.get("dropped", 0),
                         "offset_ns": theta, "rtt_ns": t3 - t0})
        except (OSError, ValueError, KeyError, TypeError) as exc:
            proc.update({"ok": False, "error": str(exc)})
        processes[str(idx)] = proc
    return spans, processes


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="?", default=None,
                   help="merged trace JSON from --trace-spans "
                        "(Chrome trace-event format), or a "
                        "flight-recorder postmortem bundle "
                        "(omit with --fleet)")
    p.add_argument("--fleet", metavar="URL", default=None,
                   help="federate LIVE span rings instead of reading a "
                        "trace file: GET /debug/spans from the router at "
                        "URL and every replica/prefill worker it knows, "
                        "clock-aligned onto one timeline (each drain "
                        "consumes the rings — a second run sees only "
                        "newer spans)")
    p.add_argument("--request", metavar="RID", default=None,
                   help="render ONE request's causal timeline (admit -> "
                        "queue -> per-mb per-stage per-edge -> retire) "
                        "with the dominant stall named, instead of the "
                        "fleet report; RID comes from a /generate "
                        "response, a loadgen worst-N entry, a 504 body, "
                        "or the report's requests.worst list. Exit 3 "
                        "when the trace holds no spans for RID.")
    p.add_argument("--require-spans", action="store_true",
                   help="exit nonzero when the trace holds no spans or "
                        "no bubble/latency fields (the CI smoke gate)")
    p.add_argument("--require-local-edges", action="store_true",
                   help="exit nonzero unless at least one edge negotiated "
                        "the colocated (on-device hand-off) transport tier "
                        "(the CI colocated-world gate)")
    p.add_argument("--indent", action="store_true",
                   help="pretty-print instead of the one-line record")
    p.add_argument("--emit-profiles", metavar="OUT.yaml", default=None,
                   help="also write the trace's measured per-stage service "
                        "times as a profiler_results.yml the scheduler "
                        "tooling ingests (requires --partition + --model)")
    p.add_argument("--partition", default=None,
                   help="the layer partition the traced run used, e.g. "
                        "'1,24,25,48' (--emit-profiles needs it to spread "
                        "stage times over layers)")
    p.add_argument("--model", default=None,
                   help="model name recorded in the emitted profiles")
    p.add_argument("--dtype", default="float32",
                   help="dtype key recorded in the emitted profiles")
    p.add_argument("--profile-batch-size", type=int, default=8,
                   help="batch-size key recorded in the emitted profiles "
                        "(the traced run's microbatch size)")
    args = p.parse_args(argv)
    if args.emit_profiles and not (args.partition and args.model):
        p.error("--emit-profiles requires --partition and --model")
    if (args.trace is None) == (args.fleet is None):
        p.error("give a trace file OR --fleet URL (exactly one)")

    processes = None
    bundle = None
    if args.fleet is not None:
        spans, processes = _collect_fleet(args.fleet)
    else:
        spans, bundle = _load_spans(args.trace)
    source = args.fleet if args.fleet is not None else args.trace
    if args.request is not None:
        record = report.request_timeline(spans, args.request)
        record["trace"] = source
        if processes is not None:
            record["processes"] = processes
        if bundle is not None:
            record["bundle_trigger"] = bundle.get("trigger")
        print(json.dumps(record, indent=2 if args.indent else None,
                         sort_keys=True))
        return 0 if record.get("found") else 3
    record = report.analyze_spans(spans)
    record["trace"] = source
    if processes is not None:
        record["processes"] = processes
    print(json.dumps(record, indent=2 if args.indent else None,
                     sort_keys=True))
    if args.emit_profiles:
        _emit_profiles(args, spans)
    if args.require_local_edges:
        transport = record.get("transport", {})
        if not transport.get("local_edges", 0):
            print("trace_report: no edge negotiated the colocated "
                  "transport tier", file=sys.stderr)
            return 1
    if args.require_spans:
        ok = (record.get("spans", 0) > 0
              and record.get("bubble_pct") is not None
              and record.get("mb_latency", {}).get("n", 0) > 0)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
