"""Span tracing on the port's host pipeline, against the JAX `HostPipeline`.

- The same tiny ViT, the same cut and the same microbatches through both
  packages' host drivers with span recording on: span categories, names,
  stages and microbatch ids are equal (`stage` x 2 and `results` x 1 per
  microbatch, `wire` 0 on one device), and request ids pass through.
- The runtime entry's `--trace-spans` dump loads through
  `chrome_trace.trace_to_spans`, and `--trace` writes a profiler trace
  whose host regions name the stages.
- `utils/tracing.trace(None)` is a no-op, and a trace that cannot start
  (another profiler session is open) warns and carries on.
"""
import collections
import contextlib
import json
import logging

import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu import telemetry as jtel
from pipeedge_tpu.parallel import pipeline as jpipe
from pipeedge_tpu_torch import runtime, telemetry
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.parallel import pipeline as tpipe
from pipeedge_tpu_torch.telemetry import chrome_trace
from pipeedge_tpu_torch.utils import tracing

MODEL = "pipeedge/test-tiny-vit"
CFG = treg.get_model_config(MODEL)
N_MB = 4


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(CFG, seed=3))
    return str(path)


def _ubatches():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
            for _ in range(N_MB)]


def _key(span):
    return (span["cat"], span["name"], span["stage"], span["mb"],
            span["rid"])


def _jax_spans(weights_file, partition, bits, traces):
    rec = jtel.configure(rank=0)
    try:
        pipe = jpipe.build_pipeline(MODEL, partition, model_file=weights_file,
                                    devices=jax.devices()[:1],
                                    quant_bits=bits)
        dev = pipe.stages[0].device
        ub = [jax.device_put(u, dev) for u in _ubatches()]
        pipe.run(ub, traces=traces)
        return rec.snapshot()
    finally:
        jtel.disable()


def _port_spans(weights_file, partition, bits, traces):
    rec = telemetry.configure(rank=0)
    try:
        pipe = tpipe.build_pipeline(MODEL, partition, model_file=weights_file,
                                    device="cpu", quant_bits=bits)
        pipe.run([torch.from_numpy(u) for u in _ubatches()], traces=traces)
        return rec.snapshot()
    finally:
        telemetry.disable()


@pytest.mark.parametrize("partition,bits", [
    ([(1, 5), (6, 8)], [8, 0]),
    ([(1, 2), (3, 5), (6, 8)], [0, 4, 0]),
], ids=["2stages_8bit", "3stages"])
@pytest.mark.parametrize("tagged", [False, True], ids=["plain", "rids"])
def test_spans_equal_jax_host_pipeline(weights_file, partition, bits,
                                       tagged):
    traces = ([telemetry.TraceContext(f"r{i}") for i in range(N_MB)]
              if tagged else None)
    jtraces = ([jtel.TraceContext(f"r{i}") for i in range(N_MB)]
               if tagged else None)
    got = collections.Counter(_key(s) for s in _port_spans(
        weights_file, partition, bits, traces))
    want = collections.Counter(_key(s) for s in _jax_spans(
        weights_file, partition, bits, jtraces))
    assert got == want
    per_cat = collections.Counter(k[0] for k in got.elements())
    assert per_cat == {"stage": len(partition) * N_MB, "results": N_MB}
    assert per_cat["wire"] == 0
    for mb in range(N_MB):
        assert sorted(k[2] for k in got if k[0] == "stage" and k[3] == mb) \
            == list(range(len(partition)))


def test_wire_span_on_a_cross_device_payload(weights_file):
    """A payload not on the stage's device is copied under a `wire` span
    (the JAX stage's rule); on the stage's own device it never fires."""
    fn, params, _ = treg.module_shard_factory(MODEL, weights_file, 1, 8,
                                              device="cpu")
    stage = tpipe.PipelineStage(shard_fn=fn, params=params, device="cpu",
                                name="s")
    x = torch.from_numpy(_ubatches()[0])
    # a stage on another device (shape-only "meta" tensors stand in for a
    # second card here)
    other = tpipe.PipelineStage(shard_fn=lambda p, t: t * 2, params={},
                                device="cpu", name="far")
    other.device = torch.device("meta")
    rec = telemetry.configure(rank=0)
    try:
        stage(x)
        assert not [s for s in rec.snapshot() if s["cat"] == "wire"]
        out = other(x)
        assert out.device.type == "meta"
        wire = [s for s in rec.snapshot() if s["cat"] == "wire"]
        assert [s["name"] for s in wire] == ["edge->far"]
    finally:
        telemetry.disable()


def test_runtime_trace_spans_dump_loads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the monitoring CSVs land in the cwd
    out = tmp_path / "spans.json"
    prof_dir = tmp_path / "prof"
    runtime.main(["0", "2", "-m", MODEL, "-pt", "1,5,6,8", "-q", "8,0",
                  "-b", "8", "-u", "2", "--device", "cpu",
                  "--trace", str(prof_dir), "--trace-spans", str(out)])
    with open(out) as f:
        doc = json.load(f)
    spans = chrome_trace.trace_to_spans(doc)
    counts = collections.Counter((s["cat"], s["name"]) for s in spans)
    assert counts == {("stage", "stage0"): 4, ("stage", "stage1"): 4,
                      ("results", "retire"): 4}
    assert sorted(s["mb"] for s in spans if s["cat"] == "results") \
        == [0, 1, 2, 3]
    with open(prof_dir / tracing.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    assert names["stage0"] == 4 and names["stage1"] == 4
    telemetry.disable()


def test_trace_none_is_a_noop(tmp_path):
    with tracing.trace(None):
        torch.ones(2).sum()
    with tracing.trace(""):
        pass
    assert list(tmp_path.iterdir()) == []
    with tracing.annotate("region"):
        torch.ones(2).sum()


def test_annotate_records_only_inside_a_session():
    assert isinstance(tracing.annotate("region"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.annotate("region"):
            torch.ones(2).sum()
    assert "region" in {e.name for e in prof.events()}


def test_trace_warns_and_continues_when_the_profiler_is_busy(tmp_path,
                                                             caplog):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with caplog.at_level(logging.WARNING):
            with tracing.trace(str(tmp_path / "busy")):
                torch.ones(2).sum()
    assert "trace capture unavailable" in caplog.text
    assert not (tmp_path / "busy" / tracing.TRACE_FILE).exists()
