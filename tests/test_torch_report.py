"""The port's span report, its profile feedback and `trace_report`, held
to the JAX package's.

- `telemetry/report.py`: `analyze_spans` and `request_timeline` of both
  packages on the span inputs of the JAX package's own report tests
  (`test_observability.py`: bubbles, failover, rejoin, rounds;
  `test_request_tracing.py`: request timelines and the requests section;
  `test_admission.py`: the serving section; `test_transport_tiers.py`:
  transport and segments; `test_gray_failures.py`: the gray section;
  `test_autoscale.py`: the autoscale section; `test_fleet_observatory.py`:
  the rid tree across ranks), plus `segment_medians` and `percentile`.
- The same on the `--trace-spans` files the port's own entries write: a
  2-rank `runtime -c dcn` fleet of the tiny ViT at an 8-bit edge, and
  the serve entry answering a few requests (both run here, as
  subprocesses, on the CPU).
- `telemetry/feedback.py` on those traces and on hand-made digests.
- The two CLIs, `tools/trace_report.py` and `python -m
  pipeedge_tpu_torch.trace_report`, on the same files: the report, the
  `--request` timeline, the `--require-spans` exit codes and the
  `--emit-profiles` YAML (read back) are equal.

`span_overhead_pct` rests on a per-span cost measured live, so every
in-process call passes `span_cost_ns` (as the JAX tests do), and the CLIs'
JSON lines are compared without `span_cost_ns` and `span_overhead_pct`.
Everything else compares exactly: the same integers go through the same
arithmetic.
"""
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import yaml

from pipeedge_tpu.telemetry import chrome_trace as jax_chrome
from pipeedge_tpu.telemetry import feedback as jax_feedback
from pipeedge_tpu.telemetry import report as jax_report
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.telemetry import chrome_trace as port_chrome
from pipeedge_tpu_torch.telemetry import feedback as port_feedback
from pipeedge_tpu_torch.telemetry import report as port_report
from test_observability import _two_stage_spans
from test_torch_dcn_runtime import _run_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000
LIVE_KEYS = ("span_cost_ns", "span_overhead_pct")


def _s(cat, name, t0, t1, rank=0, stage=None, mb=None, rid=None):
    return {"cat": cat, "name": name, "rank": rank, "stage": stage,
            "mb": mb, "t0": t0, "t1": t1, "rid": rid}


def _round_mbs():
    """test_observability's mb ids restarting every schedule round."""
    spans = []
    for rnd, base in ((0, 0), (1, 100 * MS)):
        spans.append(_s("runtime", f"round{rnd}", base, base + 20 * MS))
        for mb in (0, 1):
            spans.append(_s("stage", "stage0", base + mb * 10 * MS,
                            base + mb * 10 * MS + 10 * MS, stage=0, mb=mb))
    return spans


def _absent_stage():
    """test_observability's stage 2 that failed over away in round 1."""
    spans = []
    for rnd, base in ((0, 0), (1, 100 * MS)):
        spans.append(_s("runtime", f"round{rnd}", base, base + 20 * MS))
        for st in ((0, 1, 2) if rnd == 0 else (0, 1)):
            spans.append(_s("stage", "dispatch", base, base + 10 * MS,
                            rank=st, stage=st, mb=0))
    return spans


# the JAX package's report inputs, by the test they come from
INPUTS = {
    "observability_two_stage": _two_stage_spans(),
    "observability_failover": _two_stage_spans() + [
        _s("failover", "detect", 12 * MS, 12 * MS),
        _s("failover", "reschedule", 13 * MS, 15 * MS),
        _s("failover", "recover", 12 * MS, 33 * MS)],
    "observability_rejoin": _two_stage_spans() + [
        _s("rejoin", "admit", 20 * MS, 20 * MS),
        _s("rejoin", "heal", 12 * MS, 37 * MS)],
    "observability_multi_failover": [
        _s("runtime", "round0", 0, 200 * 10**9),
        _s("failover", "recover", 10 * 10**9, 11 * 10**9),
        _s("failover", "recover", 110 * 10**9, 112 * 10**9)],
    "observability_rounds": _round_mbs(),
    "observability_absent_stage": _absent_stage(),
    "request_tracing_timeline": [
        _s("serve", "admit:interactive", 0, 2 * MS, rid="q1"),
        _s("feed", "mb0", 2 * MS, 3 * MS, mb=0, rid="q1"),
        _s("compute", "stage0", 3 * MS, 6 * MS, stage=0, mb=0, rid="q1"),
        _s("wire", "send->r1", 6 * MS, 7 * MS, mb=0, rid="q1"),
        _s("stage", "dispatch", 7 * MS, 27 * MS, rank=1, stage=1, mb=0,
           rid="q1"),
        _s("results", "deliver", 27 * MS, 28 * MS, mb=0, rid="q1"),
        _s("compute", "stage0", 0, 50 * MS, stage=0, mb=5, rid="q2")],
    "request_tracing_requests": [
        _s("serve", "generate", 0, 30 * MS, rid="q1"),
        _s("serve", "generate", 0, 5 * MS, rid="q2"),
        _s("compute", "stage0", 0, MS, stage=0)],
    "admission_serving": [
        _s("serve", "admit:interactive", 0, 2 * MS),
        _s("serve", "admit:interactive", 0, 6 * MS),
        _s("serve", "generate", 2 * MS, 50 * MS),
        _s("serve", "shed:batch:queue_full", 10 * MS, 10 * MS),
        _s("serve", "shed:best_effort:brownout", 11 * MS, 11 * MS),
        _s("serve", "shed:batch:rate", 12 * MS, 12 * MS),
        _s("serve", "brownout:1", 13 * MS, 13 * MS),
        _s("serve", "brownout:2", 14 * MS, 14 * MS)],
    "transport_tiers": [
        _s("transport", "local:0->0", 0, 0),
        _s("transport", "local:1->0", 0, 0),
        _s("transport", "zerocopy:1->2", 0, 0),
        _s("wire", "local->r0", 0, MS),
        _s("wire", "send->r2", MS, 4 * MS),
        _s("stage", "dispatch", 0, 2 * MS, stage=0, mb=0)],
    "transport_renegotiated": [
        _s("transport", "socket_v2:0->1", 0, 0),
        _s("transport", "local:0->1", 5, 5),
        _s("transport", "local:0->1", 9, 9)],
    "transport_segments": [
        _s("feed", "mb0", 0, MS), _s("feed", "mb1", 0, 3 * MS),
        _s("wire", "send->r1", 0, 2 * MS), _s("wire", "send->r2", 0, 2 * MS)],
    "gray": [
        _s("health", "suspect:r2", MS, MS),
        _s("health", "quarantine:r2", MS + 1, MS + 1),
        _s("health", "readmit:r2", MS + 2, MS + 2),
        _s("compute", "stage0", MS, MS + 10, stage=0, mb=0)],
    "autoscale": [
        _s("autoscale", "plan:up", MS, 3 * MS),
        _s("autoscale", "apply:up", 3 * MS, 10 * MS),
        _s("autoscale", "plan:down", MS + 20, MS + 25),
        _s("autoscale", "held:down", MS + 25, MS + 25),
        _s("autoscale", "flap_damped:down", MS + 30, MS + 30),
        _s("compute", "stage0", MS, 11 * MS, stage=0, mb=0)],
    "fleet_rid_tree": [
        _s("router", "stream:r0", 0, 4 * MS, rid="R7"),
        _s("serve", "request", 500_000, 2 * MS, rank=1, rid="R7"),
        _s("router", "stream:r1", 4 * MS, 9 * MS, rid="R7.fo1"),
        _s("serve", "request", 4_500_000, 8_500_000, rank=2, rid="R7.fo1"),
        _s("router", "dispatch:r0", 0, MS, rid="R8")],
    "collectives": [
        _s("collective", "psum8:253440", 0, 0, stage=0),
        _s("collective", "psum8:1000", 0, 0, stage=0),
        _s("collective", "gather4:oops", 0, 0, rank=2),
        _s("wire", "send->r1", 0, 2 * MS, stage=0, mb=0),
        _s("rebalance", "apply", MS, MS),
        _s("stage", "emit", 0, MS, stage=0, mb=0)],
    "empty": [],
    "open_spans_only": [dict(_s("stage", "x", 0, 1), t1=None)],
}


def _rids(spans):
    """Every rid of the spans, a base rid and one that matches nothing."""
    return sorted({s["rid"] for s in spans if s.get("rid")}) + ["R7", "nope"]


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_analyze_spans_matches_jax(name):
    spans = INPUTS[name]
    for cost in (1000.0, 100.0):
        want = jax_report.analyze_spans([dict(s) for s in spans],
                                        span_cost_ns=cost)
        got = port_report.analyze_spans([dict(s) for s in spans],
                                        span_cost_ns=cost)
        assert got == want
    assert port_report.segment_medians(spans) == \
        jax_report.segment_medians(spans)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_request_timeline_matches_jax(name):
    spans = INPUTS[name]
    for rid in _rids(spans):
        for tree in (True, False):
            assert port_report.request_timeline(spans, rid, tree=tree) == \
                jax_report.request_timeline(spans, rid, tree=tree), rid
    assert port_report.request_timeline(spans, "q1", max_events=2) == \
        jax_report.request_timeline(spans, "q1", max_events=2)


def test_percentile_and_tree_grammar_match_jax():
    vals = [5.0, 1.0, 3.0, 9.5, 2.0, 2.0]
    for q in (0, 25, 50, 90, 95, 99, 100):
        assert port_report.percentile(vals, q) == \
            jax_report.percentile(vals, q)
    assert port_report.percentile([], 50) == jax_report.percentile([], 50)
    for span_rid in ("R4", "R4.t2", "R4.hedge.t1", "R40", "R5", None, 4):
        assert port_report._rid_tree_member(span_rid, "R4") == \
            jax_report._rid_tree_member(span_rid, "R4")
    assert port_report.measure_span_cost_ns(200) > 0


DIGESTS = [
    {("stage", "dispatch", 0): (4, 40 * MS), ("stage", "readback", 0):
     (4, 8 * MS), ("stage", "emit", 0): (4, 4 * MS),
     ("compute", "stage0", 0): (4, 20 * MS), ("wire", "send->r1", None):
     (4, 6 * MS)},
    {("stage", "dispatch", 1): (3, 90 * MS), ("stage", "readback", 1):
     (4, 9 * MS), ("wire", "recv<-r0", None): (4, 2 * MS),
     ("stage", "dispatch", 5): (1, MS)},
]


def test_feedback_matches_jax():
    j, p = jax_feedback, port_feedback
    assert p.merge_digests(DIGESTS) == j.merge_digests(DIGESTS)
    assert p.diff_digests(DIGESTS[0], DIGESTS[1]) == \
        j.diff_digests(DIGESTS[0], DIGESTS[1])
    merged = j.merge_digests(DIGESTS)
    want = j.stage_estimates(merged)
    got = p.stage_estimates(merged)
    assert {k: (v.n, v.dispatch_s, v.readback_s, v.emit_s, v.compute_s,
                v.layer_s, v.fixed_s, v.service_s)
            for k, v in got.items()} == {
        k: (v.n, v.dispatch_s, v.readback_s, v.emit_s, v.compute_s,
            v.layer_s, v.fixed_s, v.service_s) for k, v in want.items()}
    assert p.edge_estimates(merged) == j.edge_estimates(merged)
    for n_stages in (2, 3):
        assert p.check_estimates(got, n_stages) == \
            j.check_estimates(want, n_stages)
    spans = INPUTS["request_tracing_timeline"] + _two_stage_spans()
    assert p.digest_from_spans(spans) == j.digest_from_spans(spans)


# -- traces written by the port's own entries ------------------------------

VIT = "pipeedge/test-tiny-vit"
GPT2 = "pipeedge/test-tiny-gpt2"
PARTITION = "1,4,5,8"


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """A 2-rank DCN fleet's merged trace and the serve entry's shutdown
    trace, both written by the port on the CPU, with the rids served."""
    root = tmp_path_factory.mktemp("traces")
    npz = root / "w.npz"
    np.savez(npz, **tvit.random_npz_weights(registry.get_model_config(VIT),
                                            seed=5))
    dcn = root / "dcn.json"
    _run_fleet(root, ["-c", "dcn", "-m", VIT, "-M", str(npz), "-b", "16",
                      "-u", "4", "-pt", PARTITION, "-q", "8,0",
                      "--trace-spans", str(dcn)], world=2)
    served = root / "serve.json"
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pipeedge_tpu_torch.serve", "-m", GPT2,
         "-pt", PARTITION, "--max-len", "48", "-t", "float32", "--device",
         "cpu", "--port", str(port), "--kv-pages", "32", "--kv-page-size",
         "4", "--postmortem-dir", str(root), "--trace-spans", str(served)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    rids = []
    try:
        for line in proc.stdout:
            if line.startswith("serving "):
                break
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        for i, ids in enumerate(([3, 4, 5, 6], [3, 4, 5, 6, 7, 8],
                                 [9, 1, 2])):
            body = {"ids": [ids], "new_tokens": 4 + i,
                    "class": ("interactive", "batch", "best_effort")[i]}
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                rids.append(json.loads(resp.read())["rid"])
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    return {"dcn": dcn, "serve": served, "rids": rids, "root": root}


def _free_port():
    import socket
    with socket.create_server(("127.0.0.1", 0)) as s:
        return s.getsockname()[1]


def _load(path):
    doc = json.loads(path.read_text())
    spans = {"jax": jax_chrome.trace_to_spans(doc),
             "port": port_chrome.trace_to_spans(doc)}
    assert spans["port"] == spans["jax"]
    return spans["port"]


@pytest.mark.fleet
@pytest.mark.parametrize("which", ["dcn", "serve"])
def test_port_traces_report_as_jax(traces, which):
    spans = _load(traces[which])
    assert spans
    want = jax_report.analyze_spans(spans, span_cost_ns=500.0)
    got = port_report.analyze_spans(spans, span_cost_ns=500.0)
    assert got == want
    if which == "dcn":
        assert got["ranks"] == [0, 1] and got["mb_latency"]["n"] == 4
        assert set(got["stages"]) >= {"stage0", "stage1"}
    else:
        assert got["serving"]["requests"] == 3
        assert sorted(got["serving"]["admit_wait_ms"]) == [
            "batch", "best_effort", "interactive"]
        assert got["requests"]["n"] == 3
    rids = traces["rids"] if which == "serve" else _rids(spans)
    for rid in rids:
        tl = port_report.request_timeline(spans, rid)
        assert tl == jax_report.request_timeline(spans, rid)
        if which == "serve":
            assert tl["found"] and tl["stages"] == [0, 1]
    digest = jax_feedback.digest_from_spans(spans)
    assert port_feedback.digest_from_spans(spans) == digest
    assert {k: v.service_s for k, v in
            port_feedback.stage_estimates(digest).items()} == {
        k: v.service_s for k, v in
        jax_feedback.stage_estimates(digest).items()}


def _cli(which, argv, cwd):
    cmd = ([sys.executable, "tools/trace_report.py"] if which == "jax" else
           [sys.executable, "-m", "pipeedge_tpu_torch.trace_report"])
    return subprocess.run(cmd + argv, cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=dict(
                              os.environ, JAX_PLATFORMS="cpu",
                              PYTHONPATH=REPO))


def _both(argv):
    runs = {k: _cli(k, argv, REPO) for k in ("jax", "port")}
    assert runs["port"].returncode == runs["jax"].returncode, (
        runs["port"].stderr, runs["jax"].stderr)
    return runs


def _record(run):
    rec = json.loads(run.stdout)
    return {k: v for k, v in rec.items() if k not in LIVE_KEYS}


@pytest.mark.fleet
def test_the_two_clis_print_the_same_lines(traces):
    dcn, served = str(traces["dcn"]), str(traces["serve"])
    for path in (dcn, served):
        runs = _both([path])
        assert runs["port"].returncode == 0
        assert _record(runs["port"]) == _record(runs["jax"])
        assert set(json.loads(runs["port"].stdout)) >= set(LIVE_KEYS)
    for rid in traces["rids"] + ["nope"]:
        runs = _both([served, "--request", rid])
        assert runs["port"].returncode == (3 if rid == "nope" else 0)
        assert json.loads(runs["port"].stdout) == \
            json.loads(runs["jax"].stdout)
    # the gate: the DCN trace has microbatches, the serve trace none
    assert _both([dcn, "--require-spans"])["port"].returncode == 0
    assert _both([served, "--require-spans"])["port"].returncode == 1
    out = {k: traces["root"] / f"{k}.yml" for k in ("jax", "port")}
    runs = {k: _cli(k, [dcn, "--emit-profiles", str(out[k]),
                        "--partition", PARTITION, "--model", VIT,
                        "--profile-batch-size", "4"], REPO)
            for k in ("jax", "port")}
    assert runs["port"].returncode == runs["jax"].returncode == 0
    assert runs["port"].stderr.splitlines()[-1] == \
        runs["jax"].stderr.splitlines()[-1].replace(str(out["jax"]),
                                                    str(out["port"]))
    assert yaml.safe_load(out["port"].read_text()) == \
        yaml.safe_load(out["jax"].read_text())
    # and the parse errors
    for argv in ([], [dcn, "--fleet", "http://127.0.0.1:9"],
                 [dcn, "--emit-profiles", "x.yml"]):
        runs = _both(argv)
        assert runs["port"].returncode == 2
        assert runs["port"].stderr.splitlines()[-1].split("error: ")[1] == \
            runs["jax"].stderr.splitlines()[-1].split("error: ")[1]
