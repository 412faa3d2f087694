"""Offline per-layer profiler of the port: CUDA-event timing and the
allocator's peak.

The counterpart of `pipeedge_tpu/profiler.py` and the root `profiler.py`
CLI, on PyTorch:

    python -m pipeedge_tpu_torch.profiler -m google/vit-large-patch16-224 \\
        -M vitl.npz -b 8 -o profiler_results_vitl.yml

profiles each sublayer of the model on the card (`--device cpu`: on the
CPU, with the plain versions of the kernels) and writes the results
schema of the JAX package: `{model_name, dtype, batch_size, layers,
profile_data: [{layer, time, memory, shape_in, shape_out}]}`, which the
converters (`profiler_results_to_models`, `..._to_device_types`) and
the native `sched-pipeline` read. Layer l's output chains into layer
l+1's input. `time` is seconds per forward, `memory` MiB.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .models import registry
from .sched import miniyaml

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensors(payload) -> Tuple[torch.Tensor, ...]:
    return payload if isinstance(payload, tuple) else (payload,)


def _payload_shapes(payload) -> List[List[int]]:
    """Per-item shapes (batch dim stripped), as PipeEdge records them."""
    return [list(t.shape[1:]) for t in _tensors(payload)]


def _perturb(payload, i: int):
    """Iteration i's input: floating tensors scaled by 1 + i * 1e-6, as
    the JAX profiler perturbs each iteration of its scan; integer inputs
    (token ids) stay as they are."""
    scale = 1.0 + i * 1e-6

    def one(t):
        return t * scale if t.is_floating_point() else t
    if isinstance(payload, tuple):
        return tuple(one(t) for t in payload)
    return one(payload)


def _sync(payload) -> None:
    dev = _tensors(payload)[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_shard_fn(fn, params, payload, iterations: int,
                  warmup: bool = True) -> float:
    """Seconds per execution of `fn(params, payload)`: the best of 3 runs
    of `iterations` back-to-back forwards, each on its own perturbed copy
    of the input (made before the clock starts), divided by `iterations`.

    On the card the clock is a pair of CUDA events around the run. They
    also span any gap in which the host dispatches slower than the card
    computes: that is deliberate, since a stage of the host pipeline pays
    the same. On the CPU the clock is `time.perf_counter`. The warm-up
    (one untimed run) absorbs the kernels' build and load at first use
    and the libraries' own first-call costs."""
    inputs = [_perturb(payload, i) for i in range(iterations)]
    on_card = _tensors(payload)[0].device.type == "cuda"

    def run():
        for x in inputs:
            fn(params, x)

    if warmup:
        run()
        _sync(payload)
    best = float("inf")
    for _ in range(3):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            tik = time.perf_counter()
            run()
            seconds = time.perf_counter() - tik
        best = min(best, seconds)
    return best / iterations


def params_bytes(params) -> int:
    """Total bytes of the tensors of a nested params structure."""
    if isinstance(params, dict):
        return sum(params_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_bytes(v) for v in params)
    return params.numel() * params.element_size()


def _forward_with_peak(fn, params, payload) -> Tuple[Any, int]:
    """(output, bytes the forward added to the allocator's peak); the
    second is 0 on the CPU, which has no allocator statistics."""
    dev = _tensors(payload)[0].device
    if dev.type != "cuda":
        return fn(params, payload), 0
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(params, payload)
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - before


def shard_memory_bytes(fn, params, payload) -> int:
    """Memory footprint of a shard: its exact parameter bytes plus what
    one forward adds to the allocator's peak on the card
    (`reset_peak_memory_stats`, then `max_memory_allocated` less the
    `memory_allocated` before it). On the CPU the second term is 0: the
    footprint is the parameters alone."""
    return params_bytes(params) + _forward_with_peak(fn, params, payload)[1]


def default_inputs(model_name: str, batch_size: int,
                   dtype=torch.float32, device: DeviceLike = None
                   ) -> torch.Tensor:
    """The JAX profiler's inputs (numpy seed 0): images, or
    `min(512, max_pos)` token ids (int32) for the text models."""
    cfg = registry.get_model_config(model_name)
    rng = np.random.default_rng(0)
    dev = resolve_device(device)
    if cfg.vocab_size:   # token models: BERT and GPT-2
        seq = min(512, cfg.max_position_embeddings or 512)
        ids = rng.integers(0, cfg.vocab_size, size=(batch_size, seq))
        return torch.from_numpy(ids.astype(np.int32)).to(dev)
    images = rng.normal(size=(batch_size, cfg.num_channels, cfg.image_size,
                              cfg.image_size))
    return torch.from_numpy(images).to(device=dev, dtype=dtype)


def _struct_sig(payload) -> Tuple:
    """Hashable signature of a payload: arity, shapes and dtypes."""
    return (isinstance(payload, tuple),
            tuple((tuple(t.shape), str(t.dtype)) for t in _tensors(payload)))


def _layer_cfg_sig(cfg, layer: int) -> Tuple:
    """Hashable per-layer signature of the model config: scalar fields
    as they are, sequence-valued fields at this layer's block (a family
    with per-block differences must not reuse another block's numbers)."""
    block = (layer - 1) // 4
    sig = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, (list, tuple)):
            sig.append((f.name, v[block] if block < len(v) else None))
        else:
            sig.append((f.name, v))
    return tuple(sig)


def _measure_layer(fn, params, payload, iterations: int, warmup: bool
                   ) -> Tuple[float, int, Any]:
    """(seconds per forward, memory bytes, output payload) of one shard;
    the output comes from the forward that measures the memory."""
    t = time_shard_fn(fn, params, payload, iterations, warmup=warmup)
    out, peak = _forward_with_peak(fn, params, payload)
    return t, params_bytes(params) + peak, out


def profile_layers_individually(model_name: str, model_file: Optional[str],
                                inputs, layer_start: int, layer_end: int,
                                warmup: bool, iterations: int,
                                dtype=torch.float32,
                                reuse_identical: bool = True,
                                device: DeviceLike = None,
                                ) -> List[Dict[str, Any]]:
    """Profile each layer on its own, chaining outputs into the next
    layer's inputs.

    With `reuse_identical` (default), a layer whose computation is the
    same as one measured already reuses that measurement and its output,
    as the JAX profiler does: same sublayer kind ((layer-1) % 4), same
    first/last role, same input shapes and dtypes and the same block
    config. Every registered family has homogeneous blocks, so ViT-Large's
    96 layers need 6 measurements; a hit builds no shard and loads no
    weights. `reuse_identical=False` (`--exhaustive`) measures every layer.
    """
    dev = resolve_device(device)
    results = []
    payload = inputs
    model_layers = registry.get_model_layers(model_name)
    cfg = registry.get_model_config(model_name)
    cache: Dict[Tuple, Tuple[float, int, Any]] = {}
    block_sigs: Dict[int, Tuple] = {}
    for layer in range(layer_start, layer_end + 1):
        shape_in = _payload_shapes(payload)
        block = (layer - 1) // 4
        if block not in block_sigs:
            block_sigs[block] = _layer_cfg_sig(cfg, layer)
        key = ((layer - 1) % 4, layer == 1, layer == model_layers,
               _struct_sig(payload), block_sigs[block])
        hit = cache.get(key) if reuse_identical else None
        if hit is not None:
            t, mem, out = hit
            note = " (reused: identical structure)"
        else:
            fn, params, _ = registry.module_shard_factory(
                model_name, model_file, layer, layer, dtype=dtype,
                device=dev)
            t, mem, out = _measure_layer(fn, params, payload, iterations,
                                         warmup)
            del fn, params
            cache[key] = (t, mem, out)
            note = ""
        results.append({
            "layer": layer,
            "time": float(t),
            "memory": float(mem) / 1024 / 1024,   # MiB, as PipeEdge writes
            "shape_in": shape_in,
            "shape_out": _payload_shapes(out),
        })
        logger.info("layer %d: %.6f s, %.2f MB%s", layer, t,
                    results[-1]["memory"], note)
        payload = out
    return results


def validate_profile_results(profile_results: dict, model_name: str,
                             dtype_name: str, batch_size: int,
                             model_layers: int, layer_start: int,
                             layer_end: int) -> None:
    """Consistency checks against existing results (PipeEdge
    profiler.py:163-173)."""
    assert profile_results["model_name"] == model_name, \
        "model name mismatch with existing results"
    assert profile_results["dtype"] == dtype_name, \
        "dtype mismatch with existing results"
    assert profile_results["batch_size"] == batch_size, \
        "batch size mismatch with existing results"
    assert profile_results["layers"] == model_layers, \
        "layer count mismatch with existing results"
    for layer in range(layer_start, layer_end + 1):
        for pd in profile_results["profile_data"]:
            assert layer != pd["layer"], \
                "layer to be profiled already in existing results"


@contextlib.contextmanager
def _trace(trace_dir: Optional[str], device: torch.device):
    """A torch.profiler chrome trace of the block into `trace_dir`."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "profiler_trace.json")
    prof.export_chrome_trace(path)
    logger.info("trace: %s", path)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Module Shard Profiler (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-o", "--results-yml", default="profiler_results.yml",
                        type=str, help="output YAML file")
    parser.add_argument("-m", "--model-name", type=str,
                        default="google/vit-base-patch16-224",
                        choices=registry.get_model_names(),
                        help="the neural network model for loading")
    parser.add_argument("-M", "--model-file", type=str,
                        help="the model weights file, if not in working "
                             "directory")
    parser.add_argument("-l", "--layer-start", default=1, type=int,
                        help="start layer")
    parser.add_argument("-L", "--layer-end", type=int,
                        help="end layer; default: last layer in the model")
    parser.add_argument("-s", "--shape-input", type=str, action="append",
                        help="comma-delimited shape input, e.g. '3,224,224' "
                             "(required for start_layer != 1)")
    parser.add_argument("-b", "--batch-size", default=8, type=int,
                        help="batch size")
    parser.add_argument("-t", "--dtype", default="float32",
                        choices=sorted(DTYPES), help="compute dtype")
    parser.add_argument("--no-warmup", action="store_false", dest="warmup",
                        help="time without the untimed warm-up run")
    parser.add_argument("-i", "--iterations", default=16, type=int,
                        help="iterations to average runtime over")
    parser.add_argument("--exhaustive", action="store_true",
                        help="measure every layer even when structurally "
                             "identical to an already-measured one (the "
                             "default reuses such measurements)")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler chrome trace of the "
                             "measured forwards into DIR")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; returns the results it wrote."""
    args = parse_args(argv)
    dtype = DTYPES[args.dtype]
    dev = resolve_device(args.device)
    if args.shape_input is not None:
        rng = np.random.default_rng(0)
        tensors = tuple(
            torch.from_numpy(rng.normal(size=(args.batch_size,) + tuple(
                int(d) for d in shp.split(",")))).to(device=dev, dtype=dtype)
            for shp in args.shape_input)
        inputs = tensors if len(tensors) > 1 else tensors[0]
    else:
        inputs = default_inputs(args.model_name, args.batch_size, dtype,
                                device=dev)

    model_layers = registry.get_model_layers(args.model_name)
    layer_end = args.layer_end if args.layer_end is not None else model_layers
    if os.path.exists(args.results_yml):
        print("Using existing results file")
        profile_results = miniyaml.load(args.results_yml)
        validate_profile_results(profile_results, args.model_name,
                                 args.dtype, args.batch_size, model_layers,
                                 args.layer_start, layer_end)
    else:
        profile_results = {
            "model_name": args.model_name,
            "dtype": args.dtype,
            "batch_size": args.batch_size,
            "layers": model_layers,
            "profile_data": [],
        }

    with _trace(args.trace, dev):
        results = profile_layers_individually(
            args.model_name, args.model_file, inputs, args.layer_start,
            layer_end, args.warmup, args.iterations, dtype=dtype,
            reuse_identical=not args.exhaustive, device=dev)

    profile_results["profile_data"].extend(results)
    profile_results["profile_data"].sort(key=lambda pd: pd["layer"])
    miniyaml.dump(profile_results, args.results_yml)
    return profile_results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
