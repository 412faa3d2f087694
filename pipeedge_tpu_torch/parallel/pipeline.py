"""Host-driven pipeline driver: stages on CUDA streams, QuantPipe edges.

Port of `pipeedge_tpu/parallel/pipeline.py`. One stage per layer range,
microbatches streamed through the stages, results retired in FIFO order.

- On one H100 every stage lives on `cuda:0`, each on its own CUDA stream.
  A stage's stream waits on a CUDA event recorded after the previous
  stage's work for the same microbatch, so stage s of microbatch i+1 can
  overlap stage s+1 of microbatch i while each edge stays in order. A
  payload consumed on another stream than the one that made it is marked
  with `record_stream`, so the caching allocator cannot hand its memory
  out again before the consumer is done.
- Dispatch is asynchronous: the host enqueues all stages of a microbatch
  and moves on. Backpressure is a bounded in-flight window: the host
  blocks on the oldest microbatch's event once `max_inflight` are
  unfinished.
- Quantized edges: a stage encodes its output in its epilogue and the
  next stage decodes its input in its prologue (QuantPipe), through the
  codec kernels for bits 4 and 8 (`ops/fused_quant.py`). `quant_bit` is a
  plain attribute and may change between microbatches.
- Int8 tunnel: under a `QuantizeCompute` config with `tunnel` set, a stage
  whose first sublayer leads with a dense and whose incoming edge runs at
  8 bits leaves that payload's leading tensor encoded; the dense consumes
  the wire bytes in the int8 matmul (ops/int8_matmul.wire_dense).

Spans, as in the JAX `HostPipeline` (recorded when `telemetry.configure`
armed a recorder; the runtime's `--trace-spans`): `stage` around each
stage's dispatch (host time: the device work is asynchronous), tagged
with `stage=`, `mb=` and `rid=`; `results`/`retire` around each
microbatch's retirement, where device time surfaces; `wire` around a
payload's copy to a stage's device, which never happens on one card.
Each stage dispatch is also a named `torch.profiler` region
(`utils/tracing.py annotate`), so a `--trace` session shows it.

On the CPU (`device="cpu"`, the tests) there are no streams: stages run
in order on the host, with the plain versions of the kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import DeviceLike, resolve_device
from .. import telemetry
from ..models.shard import params_to
from ..ops import clamp as clamp_ops
from ..ops import fused_quant
from ..ops import quant as quant_ops
from ..utils import tracing


def _encode_payload(payload, bit: int, clamp: bool):
    """Quantize every tensor in a stage-output payload (1- or 2-tuple)."""
    if bit == 0:
        return payload
    single = not isinstance(payload, tuple)
    tensors = (payload,) if single else payload
    out = []
    for t in tensors:
        if clamp:
            t = clamp_ops.clamp_banner2019_laplace(t, bit)
        out.append(fused_quant.encode_outerdim(t, bit))
    return out[0] if single else tuple(out)


def _decode_payload(payload):
    """Dequantize a payload produced by `_encode_payload` (no-op otherwise)."""
    if isinstance(payload, quant_ops.QuantizedTensor):
        return fused_quant.decode_outerdim(payload)
    if isinstance(payload, tuple) and any(
            isinstance(t, quant_ops.QuantizedTensor) for t in payload):
        return tuple(fused_quant.decode_outerdim(t) for t in payload)
    return payload


def _tunnel_decode_payload(payload):
    """Tunnel variant of `_decode_payload`: the payload's LEADING tensor
    stays an 8-bit `QuantizedTensor`, because the stage's first sublayer
    leads with a dense that consumes the wire bytes directly
    (ops/int8_matmul.wire_dense). Trailing tensors (the residual skip)
    decode as usual; payloads of other bitwidths decode whole."""
    if isinstance(payload, quant_ops.QuantizedTensor):
        return payload if payload.bit == 8 else _decode_payload(payload)
    if isinstance(payload, tuple) and payload and isinstance(
            payload[0], quant_ops.QuantizedTensor) and payload[0].bit == 8:
        return (payload[0],) + tuple(
            _decode_payload(t) for t in payload[1:])
    return _decode_payload(payload)


def _tensors(payload) -> Iterator[torch.Tensor]:
    """Every tensor a payload holds (QuantizedTensor fields included)."""
    for t in payload if isinstance(payload, tuple) else (payload,):
        if isinstance(t, quant_ops.QuantizedTensor):
            yield from (t.data, t.scale, t.shift)
        else:
            yield t


def _on_device(payload, device: torch.device) -> bool:
    """Whether every tensor of a payload already lies on `device`."""
    return all(t.device == device for t in _tensors(payload))


def _to_device(payload, device: torch.device):
    """Copy a payload to `device` (no-op for tensors already there)."""
    def move(t):
        if isinstance(t, quant_ops.QuantizedTensor):
            return dataclasses.replace(t, data=t.data.to(device),
                                       scale=t.scale.to(device),
                                       shift=t.shift.to(device))
        return t.to(device)
    if isinstance(payload, tuple):
        return tuple(move(t) for t in payload)
    return move(payload)


@dataclasses.dataclass
class PipelineStage:
    """One pipeline stage: a shard function bound to a device (and, on
    CUDA, a stream of its own).

    `quant_bit` applies to this stage's *output* edge and may be changed
    between microbatches. `tunnel` leaves the input payload's leading
    8-bit wire tensor encoded for the stage's first matmul (set only when
    that sublayer is in `FamilySpec.wire_subs` and the incoming edge runs
    at 8 bits)."""
    shard_fn: Callable[[Dict, Any], Any]
    params: Dict
    device: torch.device
    quant_bit: int = 0
    clamp: bool = True
    name: str = ""
    tunnel: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, payload):
        """Run the stage on the current stream: decode, shard, encode."""
        decode = _tunnel_decode_payload if self.tunnel else _decode_payload
        if not _on_device(payload, self.device):
            with telemetry.span("wire", f"edge->{self.name or 'stage'}"):
                payload = _to_device(payload, self.device)
        data = decode(payload)
        return _encode_payload(self.shard_fn(self.params, data),
                               self.quant_bit, self.clamp)


class HostPipeline:
    """Drive microbatches through a chain of `PipelineStage`s; results come
    back in FIFO order (single dispatch thread, in-order edges)."""

    def __init__(self, stages: Sequence[PipelineStage], max_inflight: int = 0,
                 ubatch_callback: Optional[Callable[[int, Any], None]] = None,
                 edge_bytes_callback: Optional[
                     Callable[[int, List[int]], None]] = None):
        if not stages:
            raise ValueError("pipeline needs at least one stage")
        self.stages = list(stages)
        # default window: 2 microbatches per stage (double buffering)
        self.max_inflight = max_inflight or 2 * len(self.stages)
        self.ubatch_callback = ubatch_callback
        # called at each retirement with that microbatch's per-edge wire
        # byte counts [stage0->1, stage1->2, ...]
        self.edge_bytes_callback = edge_bytes_callback

    def enqueue(self, ubatch, edge_bytes: Optional[List[int]] = None,
                mb: Optional[int] = None,
                trace: Optional[telemetry.TraceContext] = None):
        """Dispatch one microbatch through all stages without waiting.

        Returns (final payload, event): the event (None on the CPU) is
        recorded after the last stage's work and fences the result. When
        `edge_bytes` is a list, it receives each inter-stage edge's wire
        byte count. `mb` tags the stage spans with the microbatch id,
        `trace` with the request id it serves."""
        data = ubatch
        ready = None
        first = self.stages[0]
        if first.stream is not None:
            ready = torch.cuda.current_stream(first.device).record_event()
        last = len(self.stages) - 1
        rid = trace.rid if trace is not None else None
        for i, stage in enumerate(self.stages):
            name = stage.name or f"stage{i}"
            with tracing.annotate(name), \
                    telemetry.span("stage", name, stage=i, mb=mb, rid=rid):
                if stage.stream is None:
                    data = stage(data)
                    if i == last:
                        data = _undequantized_guard(data)
                else:
                    with torch.cuda.stream(stage.stream):
                        if ready is not None:
                            stage.stream.wait_event(ready)
                        for t in _tensors(data):
                            if t.device == stage.device:
                                t.record_stream(stage.stream)
                        data = stage(data)
                        if i == last:
                            data = _undequantized_guard(data)
                        ready = stage.stream.record_event()
            if edge_bytes is not None and i < last:
                edge_bytes.append(payload_wire_bytes(data))
        return data, ready

    def run(self, ubatches: Sequence[Any],
            traces: Optional[Sequence[telemetry.TraceContext]] = None
            ) -> Tuple[List[Any], Dict[str, float]]:
        """Stream all microbatches; returns (results, stats). `traces`
        (optional, one per microbatch) tags each microbatch's spans with
        the request id it serves.

        latency = t(last result) - t(first enqueue); throughput = total
        items / latency. `steady_state_throughput_items_sec` excludes the
        first microbatch (its latency carries one-time costs such as the
        kernel build and cuBLAS warm-up). Retirement is opportunistic:
        after each dispatch, finished microbatches at the head of the
        window retire without blocking."""
        ubatches = list(ubatches)
        results: List[Any] = []
        inflight: List[Any] = []
        retired: List[Tuple[int, float]] = []
        mb_latency_s: List[float] = []
        track_edges = self.edge_bytes_callback is not None
        dispatch_s: List[float] = []
        tik = time.monotonic()
        for i, ubatch in enumerate(ubatches):
            edge_bytes: Optional[List[int]] = [] if track_edges else None
            trace = traces[i] if traces is not None and i < len(traces) \
                else None
            t_d0 = time.monotonic()
            out, ready = self.enqueue(ubatch, edge_bytes, mb=i, trace=trace)
            dispatch_s.append(time.monotonic() - t_d0)
            inflight.append((i, out, ready, edge_bytes, t_d0, trace))
            while inflight and _is_done(inflight[0][2]):
                self._retire(inflight.pop(0), results, retired, mb_latency_s)
            while len(inflight) >= self.max_inflight:
                self._retire(inflight.pop(0), results, retired, mb_latency_s)
        while inflight:
            self._retire(inflight.pop(0), results, retired, mb_latency_s)
        tok = time.monotonic()
        items = sum(_leading_dim(u) for u in ubatches)
        latency = tok - tik
        stats = {"latency_sec": latency,
                 "throughput_items_sec": items / latency if latency > 0 else 0.0,
                 "microbatches": len(ubatches),
                 "host_dispatch_s_per_ubatch":
                     (sum(dispatch_s[1:]) / (len(dispatch_s) - 1))
                     if len(dispatch_s) > 1
                     else (dispatch_s[0] if dispatch_s else 0.0)}
        if len(retired) >= 2:
            steady_s = retired[-1][1] - retired[0][1]
            steady_items = sum(n for n, _ in retired[1:])
            if steady_s > 0:
                stats["steady_state_throughput_items_sec"] = \
                    steady_items / steady_s
                stats["steady_mb_interval_s"] = steady_s / (len(retired) - 1)
        if mb_latency_s:
            steady = sorted(mb_latency_s[1:]) or [mb_latency_s[0]]
            stats["latency_breakdown"] = {
                "fill_ms": round(mb_latency_s[0] * 1e3, 3),
                "steady_p50_ms": round(_percentile(steady, 50) * 1e3, 3),
                "steady_p99_ms": round(_percentile(steady, 99) * 1e3, 3),
            }
        return results, stats

    def _retire(self, item, results, retired: list, mb_latency_s: list):
        i, out, ready, edge_bytes, t_enq, trace = item
        with telemetry.span("results", "retire", mb=i,
                            rid=trace.rid if trace is not None else None):
            if ready is not None:
                ready.synchronize()
                # the result was made on the last stage's stream; the
                # caller uses it on its own, which the allocator must
                # know before it reuses the memory once the caller drops
                # the result
                for t in _tensors(out):
                    t.record_stream(torch.cuda.current_stream(t.device))
        now = time.monotonic()
        retired.append((_leading_dim(out), now))
        mb_latency_s.append(now - t_enq)
        if self.edge_bytes_callback is not None:
            self.edge_bytes_callback(i, edge_bytes)
        if self.ubatch_callback is not None:
            self.ubatch_callback(i, out)
        results.append(out)


def _is_done(ready) -> bool:
    return ready is None or ready.query()


def _leading_dim(ubatch) -> int:
    t = ubatch[0] if isinstance(ubatch, tuple) else ubatch
    return int(t.shape[0])


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over sorted samples."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def plan_microbatches(n_items: int, n_stages: int, t_item_s: float,
                      t_fixed_s: float,
                      max_ubatch: Optional[int] = None) -> Tuple[int, int, float]:
    """Pick the microbatch size from measured timings: minimize the
    modeled round latency

        T(M) = (M + S - 1) * (t_fixed + t_item * ceil(B/M))

    (fill/drain bubble against per-microbatch fixed cost). Returns
    `(ubatch_size, n_microbatches, predicted_latency_s)`; exhaustive over
    the distinct sizes, deterministic."""
    if n_items < 1 or n_stages < 1:
        raise ValueError(f"need n_items >= 1 and n_stages >= 1, got "
                         f"{n_items}, {n_stages}")
    t_item = max(0.0, float(t_item_s))
    t_fixed = max(0.0, float(t_fixed_s))
    best = None
    seen = set()
    for m in range(1, n_items + 1):
        u = -(-n_items // m)
        if u in seen or (max_ubatch is not None and u > max_ubatch):
            continue
        seen.add(u)
        m_eff = -(-n_items // u)
        t = (m_eff + n_stages - 1) * (t_fixed + t_item * u)
        if best is None or t < best[2]:
            best = (u, m_eff, t)
    if best is None:
        raise ValueError(f"max_ubatch={max_ubatch} admits no microbatch "
                         f"size for {n_items} items")
    return best


def payload_wire_bytes(payload) -> int:
    """Bytes a stage-output payload puts on the inter-stage edge: packed
    words plus per-item scale/shift for quantized tensors, the array
    bytes for raw ones. Reads shapes only; never waits on the device."""
    total = 0
    for t in payload if isinstance(payload, tuple) else (payload,):
        if isinstance(t, quant_ops.QuantizedTensor):
            total += (t.nbytes_wire + t.scale.numel() * 4
                      + t.shift.numel() * 4)
        else:
            total += t.numel() * t.element_size()
    return total


def _undequantized_guard(data):
    """Final stage output must not leave the pipeline quantized."""
    if isinstance(data, quant_ops.QuantizedTensor) or (
            isinstance(data, tuple) and any(
                isinstance(t, quant_ops.QuantizedTensor) for t in data)):
        return _decode_payload(data)
    return data


def build_pipeline(model_name: str, partition: Sequence[Tuple[int, int]],
                   model_file: Optional[str] = None,
                   device: DeviceLike = None,
                   quant_bits: Optional[Sequence[int]] = None,
                   dtype=None, max_inflight: int = 0,
                   stage_params: Optional[Sequence[Dict]] = None
                   ) -> HostPipeline:
    """Build a host-driven pipeline from a model partition.

    `partition` is the stage-layers list [[l0, r0], [l1, r1], ...];
    `quant_bits[i]` quantizes the edge leaving stage i (`-q`). Every stage
    runs on `device` (default `cuda`, which raises on a host without a
    GPU), each on its own stream.

    Int8 tunnel: when the active `QuantizeCompute` config has `tunnel`
    set, a stage whose first sublayer leads with a dense
    (`FamilySpec.wire_subs`) and whose incoming edge runs at 8 bits keeps
    that payload encoded for its first matmul.

    `stage_params[i]` supplies stage i's ready parameters (on `device`,
    in `dtype`, so nothing is copied) in place of loading them: stages
    and other pipelines may share one model's tensors."""
    from ..models import registry
    from ..models.layers import quantize_compute

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    if quant_bits is None:
        quant_bits = [0] * len(partition)
    wire_subs = registry.get_model_entry(model_name).family.FAMILY.wire_subs
    qc = quantize_compute()
    stages = []
    for i, (layer_start, layer_end) in enumerate(partition):
        fn, params, _ = registry.module_shard_factory(
            model_name, model_file, layer_start, layer_end, stage=i,
            dtype=dtype, device=dev,
            params=None if stage_params is None else stage_params[i])
        bit = quant_bits[i] if i < len(quant_bits) else 0
        # the final stage's output edge is the result path: never quantized
        if i == len(partition) - 1:
            bit = 0
        in_bit = quant_bits[i - 1] if 0 < i <= len(quant_bits) else 0
        tunnel = (qc.tunnel and i > 0 and in_bit == 8
                  and (layer_start - 1) % 4 in wire_subs)
        stages.append(PipelineStage(shard_fn=fn, params=params, device=dev,
                                    quant_bit=bit, name=f"stage{i}",
                                    tunnel=tunnel))
    return HostPipeline(stages, max_inflight=max_inflight)
