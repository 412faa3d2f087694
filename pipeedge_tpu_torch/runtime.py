"""Pipeline-parallel inference runtime of the port: the `-c host` driver.

The `-c host` subset of the repository's `runtime.py`, on PyTorch:

    python -m pipeedge_tpu_torch.runtime 0 2 -m google/vit-base-patch16-224 \\
        -pt 1,21,22,48 -q 8,0 -b 64 -u 8 -t float32 --measure-rounds 2

runs a two-stage ViT-Base pipeline on the GPU with an 8-bit edge and
prints `latency_sec=... throughput_items_sec=...` (the form of
`runtime.py`'s report), the steady-state throughput line, and one line
with each kernel's launch count. `--device cpu` runs the plain versions
of the kernels on the CPU. Without `--model-file` (or with a missing
file) each stage draws seeded random weights.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .models import registry
from .ops import _build
from .parallel import pipeline as host_pipeline
from .utils import data as data_utils

logger = logging.getLogger(__name__)


def _pairs(text: str) -> List[Tuple[int, int]]:
    vals = [int(v) for v in text.split(",")]
    if len(vals) % 2:
        raise ValueError(f"-pt needs layer pairs, got {text!r}")
    return list(zip(vals[0::2], vals[1::2]))


def validate_partition(partition: Sequence[Tuple[int, int]],
                       total: int) -> None:
    """Require `partition` to contiguously cover [1, total] in order."""
    expect = 1
    for l, r in partition:
        if l != expect or r < l:
            raise ValueError(f"partition {list(partition)} does not "
                             f"contiguously cover [1, {total}]")
        expect = r + 1
    if expect != total + 1:
        raise ValueError(f"partition {list(partition)} does not "
                         f"contiguously cover [1, {total}]")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Pipeline-parallel inference runtime (PyTorch port, "
                    "host driver)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("rank", type=int, help="must be 0 (single controller)")
    parser.add_argument("worldsize", type=int,
                        help="number of pipeline stages")
    parser.add_argument("-m", "--model-name",
                        default="google/vit-base-patch16-224",
                        choices=registry.get_model_names())
    parser.add_argument("-M", "--model-file", type=str,
                        help="model weights file (.npz, Google ViT keys)")
    parser.add_argument("-b", "--batch-size", default=64, type=int)
    parser.add_argument("-u", "--ubatch-size", default=8, type=int)
    parser.add_argument("-t", "--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("-pt", "--partition", type=str,
                        help="comma-delimited layer pairs, e.g. '1,24,25,48'")
    parser.add_argument("-q", "--quant", type=str,
                        help="comma-delimited per-stage output quant bitwidths")
    parser.add_argument("--measure-rounds", type=int, default=1,
                        help="run the batch this many times; round 0 pays "
                             "the kernel build and warm-up")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    args = parser.parse_args(argv)
    if args.rank != 0:
        parser.error("the host driver is a single controller: rank must be 0")
    return args


def _schedule(args) -> Tuple[List[Tuple[int, int]], List[int]]:
    total = registry.get_model_layers(args.model_name)
    if args.partition:
        stage_layers = _pairs(args.partition)
        validate_partition(stage_layers, total)
    elif args.quant:
        raise RuntimeError("Must specify partition with quantization")
    elif args.worldsize > 1:
        raise RuntimeError("the port has no scheduler yet: give the stage "
                           "layers with -pt")
    else:
        stage_layers = [(1, total)]
    quant = [int(q) for q in args.quant.split(",")] if args.quant else []
    stage_quant = quant or [0] * len(stage_layers)
    return stage_layers, stage_quant


def run_pipeline_host(args) -> dict:
    """Build the pipeline, stream the batch `--measure-rounds` times and
    print the report lines; returns the last round's stats."""
    stage_layers, stage_quant = _schedule(args)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = host_pipeline.build_pipeline(
        args.model_name, stage_layers, model_file=args.model_file,
        device=args.device, quant_bits=stage_quant, dtype=dtype)
    cfg = registry.get_model_config(args.model_name)
    dataset = data_utils.synthetic_image_dataset(
        args.batch_size,
        shape=(cfg.num_channels, cfg.image_size, cfg.image_size),
        n_labels=max(cfg.num_labels, 2))
    device = pipe.stages[0].device
    inputs = [torch.from_numpy(x).to(device=device, dtype=dtype)
              for x, _ in data_utils.batch_dataset(dataset, args.ubatch_size)]
    rounds = max(1, args.measure_rounds)
    stats: dict = {}
    for rnd in range(rounds):
        tik = time.monotonic()
        _, stats = pipe.run(inputs)
        tok = time.monotonic()
        if rounds > 1:
            batch_total = sum(len(u) for u in inputs)
            print(f"round={rnd} latency_sec={tok - tik:.6f} "
                  f"throughput_items_sec={batch_total / (tok - tik):.3f}")
    _report(tik, tok, inputs)
    steady = stats.get("steady_state_throughput_items_sec")
    if steady:
        print(f"steady_state_throughput_items_sec={steady:.3f}")
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    return stats


def _report(tik, tok, ubatches):
    batch_size = sum(len(u) for u in ubatches)
    latency = tok - tik
    throughput = batch_size / latency if latency > 0 else 0
    logger.info("Latency: %f seconds", latency)
    logger.info("Throughput: %f items/sec", throughput)
    print(f"latency_sec={latency:.6f} throughput_items_sec={throughput:.3f}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    run_pipeline_host(parse_args(argv))


if __name__ == "__main__":
    main()
