"""The port's telemetry copies against the JAX package's.

`pipeedge_tpu_torch/telemetry/{metrics,__init__,flight,collector,
chrome_trace}.py` are copies (the port imports nothing of
`pipeedge_tpu`); these tests hold them to the originals on the same
inputs:

- the same counter, gauge and histogram operations render the same
  Prometheus text, byte for byte (exemplars and windows on a pinned
  `now=` clock);
- spans, trace contexts, the wire codecs and the Chrome trace are equal;
- the flight ring and a postmortem bundle carry the same keys and events;
- `BurnRateEngine` takes the same breach decisions and gives the same
  burn rates on the same cumulative counts;
- `parse_prom_text` and `debug_spans_payload` agree.
"""
import json

import numpy as np
import pytest

from pipeedge_tpu import telemetry as jtel
from pipeedge_tpu.telemetry import chrome_trace as jchrome
from pipeedge_tpu.telemetry import collector as jcol
from pipeedge_tpu.telemetry import flight as jflight
from pipeedge_tpu.telemetry import metrics as jprom
from pipeedge_tpu_torch import telemetry as ttel
from pipeedge_tpu_torch.telemetry import chrome_trace as tchrome
from pipeedge_tpu_torch.telemetry import collector as tcol
from pipeedge_tpu_torch.telemetry import flight as tflight
from pipeedge_tpu_torch.telemetry import metrics as tprom


def _drive_registry(prom, seed: int) -> str:
    """A seeded sequence of instrument operations on a fresh registry;
    returns its rendering."""
    rng = np.random.default_rng(seed)
    reg = prom.Registry()
    req = reg.counter("pipeedge_serve_requests_total",
                      "generate requests by endpoint and outcome status")
    for endpoint in ("/generate", "/generate-speculative"):
        for status in ("200", "503", "504", "error"):
            req.declare(endpoint=endpoint, status=status)
    tokens = reg.counter("pipeedge_serve_tokens_total", "tokens generated")
    depth = reg.gauge("pipeedge_admission_queue_depth", "queue depth")
    lat = reg.histogram("pipeedge_serve_request_latency_seconds",
                        "end-to-end generate latency")
    custom = reg.histogram("pipeedge_custom_seconds", "custom buckets",
                           buckets=(0.001, 0.01, 0.1, 1.0))
    for i in range(int(rng.integers(20, 60))):
        op = int(rng.integers(0, 5))
        if op == 0:
            req.inc(endpoint=str(rng.choice(["/generate",
                                             "/generate-speculative"])),
                    status=str(rng.choice(["200", "503", "504"])))
        elif op == 1:
            tokens.inc(float(rng.integers(1, 500)))
        elif op == 2:
            depth.set(float(rng.integers(0, 64)))
        elif op == 3:
            # exemplars stamped in the future render whatever the clock
            lat.observe(float(rng.exponential(0.5)), exemplar=f"q{i}",
                        now=1e12 + i)
        else:
            custom.observe(float(rng.exponential(0.05)), exemplar=f"r{i}",
                           now=1e12, stage=str(rng.integers(0, 3)))
    return reg.render(extra=["# extra line"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_registry_text_identical(seed):
    got = _drive_registry(tprom, seed)
    assert got == _drive_registry(jprom, seed)
    assert "pipeedge_serve_requests_total{endpoint=" in got


def test_percentiles_exemplars_and_monitoring_gauges_identical():
    counts = [3, 0, 7, 1, 0, 0, 2]
    buckets = (0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
    for q in (50.0, 95.0, 99.0, 100.0):
        assert tprom.percentile_from_counts(buckets, counts, 13, q) == \
            jprom.percentile_from_counts(buckets, counts, 13, q)
    text = _drive_registry(tprom, 5)
    fam = "pipeedge_serve_request_latency_seconds"
    assert tprom.parse_exemplars(text, fam) == jprom.parse_exemplars(
        text, fam)
    snap = {"send0": {"instant": {"perf": 1.5, "energy": 0.25},
                      "window": {"perf": 2.0}},
            "output": {"global": {"rate": 7}}}
    assert tprom.render_monitoring_snapshot(snap) == \
        jprom.render_monitoring_snapshot(snap)


def _drive_spans(tel):
    rec = tel.SpanRecorder(rank=3, capacity=8)
    for i in range(12):                   # overflows the ring: drop-oldest
        rec.record("stage", f"exec{i % 2}", 100 * i, 100 * i + 50,
                   stage=i % 2, mb=i, rid=f"q{i}" if i % 3 else None)
    ctx = tel.TraceContext("q7", "batch", deadline_ms=250.0,
                           parent="serve.generate")
    wire = tel.spans_to_wire(rec.snapshot())
    return dict(snapshot=rec.snapshot(), dropped=rec.dropped,
                wire=wire.tolist(), back=tel.spans_from_wire(wire),
                ctx=ctx.to_dict(),
                ctx_back=tel.TraceContext.from_wire(ctx.to_wire()).to_dict(),
                digest=tel.digest_from_wire(tel.digest_to_wire(
                    rec.digest())),
                drained=rec.drain(), after=rec.snapshot(),
                offset=tel.estimate_clock_offset(
                    [(0, 105, 110, 20), (100, 160, 170, 130)]))


def test_span_recorder_and_wire_codecs_identical():
    assert _drive_spans(ttel) == _drive_spans(jtel)


def test_module_span_surface_and_chrome_trace_identical(tmp_path):
    out = {}
    for name, tel, chrome in (("jax", jtel, jchrome),
                              ("torch", ttel, tchrome)):
        tel.configure(rank=1)
        try:
            assert tel.enabled()
            with tel.trace_scope(tel.TraceContext("q1")):
                tel.record("serve", "admit:interactive", 10, 20)
                tel.record("stage", "exec0", 30, 80, stage=0, mb=0,
                           rid="q1")
            spans = tel.recorder().snapshot()
        finally:
            tel.disable()
        assert not tel.enabled()
        path = tmp_path / f"{name}.json"
        chrome.dump_trace(spans, str(path))
        out[name] = (spans, json.loads(path.read_text()))
    assert out["torch"] == out["jax"]


def _drive_flight(flight_mod, out_dir):
    rec = flight_mod.FlightRecorder(rank=0, capacity=4, out_dir=out_dir,
                                    cooldown_s=1e9)
    for i in range(6):                    # overflows: events_dropped 2
        rec.note("admit", rid=f"q{i}", cls="interactive", wait_ms=i)
    rec.note("shed", rid="q9", cls="batch", reason="queue_full",
             retry_after=1.5)
    paths = [rec.maybe_dump("shed", rid="q9", context={"k": 1}),
             rec.maybe_dump("shed", rid="q9"),           # cooldown
             rec.maybe_dump("manual", context={"serving": {"a": 1}})]
    bundles = [None if p is None else json.load(open(p)) for p in paths]
    for b in bundles:
        if b is not None:
            b.pop("t_mono_ns")
            for e in b["events"]:
                e.pop("t_ns")
    return dict(bundles=bundles, events=[
        {k: v for k, v in e.items() if k != "t_ns"}
        for e in rec.events(rid="q9")], written=rec.written_total(),
        dropped=rec.dropped, names=[None if p is None else
                                    p.rsplit("/", 1)[1] for p in paths])


def test_flight_ring_and_postmortem_bundle_identical(tmp_path):
    got = _drive_flight(tflight, str(tmp_path / "torch"))
    want = _drive_flight(jflight, str(tmp_path / "jax"))
    # written_total reads each package's own process-wide counter
    got.pop("written")
    want.pop("written")
    assert got == want
    assert got["bundles"][1] is None
    assert set(got["bundles"][0]) == {
        "bundle", "trigger", "rid", "rank", "seq", "events",
        "events_dropped", "suppressed_dumps", "spans", "context"}
    assert tflight.TRIGGERS == jflight.TRIGGERS


def _burn_decisions(col, prom):
    fired = []
    eng = col.BurnRateEngine(objective=0.99, fast_window_s=30.0,
                             slow_window_s=300.0, threshold=10.0,
                             registry=prom.Registry(),
                             on_breach=lambda c, b: fired.append((c, b)))
    rng = np.random.default_rng(4)
    good = {c: 0.0 for c in col.REQUEST_CLASSES}
    total = dict(good)
    burns = []
    for step in range(60):
        for c in col.REQUEST_CLASSES:
            n = float(rng.integers(0, 20))
            bad_share = 0.5 if 20 <= step < 30 and c == "batch" else 0.0
            total[c] += n
            good[c] += n - round(n * bad_share)
        burns.append(eng.update({c: (good[c], total[c]) for c in good},
                                now=10.0 * step))
    return fired, burns


def test_burn_rate_engine_same_decisions():
    fired, burns = _burn_decisions(tcol, tprom)
    assert (fired, burns) == _burn_decisions(jcol, jprom)
    assert [c for c, _ in fired] == ["batch"]


def test_parse_prom_text_and_counts_identical():
    text = _drive_registry(tprom, 7) + (
        'pipeedge_requests_by_class_total{class="batch",outcome="ok"} 5\n'
        'pipeedge_requests_by_class_total{class="batch",outcome="shed"} 2\n'
        "odd line that does not parse\n")
    got = tcol.parse_prom_text(text)
    assert got == jcol.parse_prom_text(text)
    assert tcol.BurnRateEngine.counts_from_families(got) == \
        jcol.BurnRateEngine.counts_from_families(got)
    fams = ["pipeedge_serve_tokens_total"]
    assert tcol.parse_prom_text(text, fams) == jcol.parse_prom_text(text,
                                                                     fams)


def test_debug_spans_payload_keys_identical():
    ttel.disable()
    jtel.disable()
    want = jcol.debug_spans_payload()
    got = tcol.debug_spans_payload()
    assert set(got) == set(want)
    assert got["spans"] == want["spans"] == [] and not got["enabled"]
