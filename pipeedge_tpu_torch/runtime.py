"""Pipeline-parallel inference runtime of the port: the `-c host` driver.

The host loop of the repository's `runtime.py`, on PyTorch:

    python -m pipeedge_tpu_torch.runtime 0 2 -m google/vit-base-patch16-224 \\
        -pt 1,21,22,48 -q 8,0 -b 64 -u 8 -t float32 --measure-rounds 2

runs a two-stage ViT-Base pipeline on the GPU with an 8-bit edge and
prints `latency_sec=... throughput_items_sec=...` (the form of
`runtime.py`'s report), the steady-state throughput line, one line with
each kernel's launch count and one with each edge's bitwidth at the end
of the run (`edge_bits=[...]`). `--device cpu` runs the plain versions
of the kernels on the CPU. Without `--model-file` (or with a missing
file) each stage draws seeded random weights.

Without `-pt`, more than one stage is scheduled as `runtime.py`
schedules it: the native `sched-pipeline` (built from `native/` into
`_build/` at first use) partitions the model from the profiler's files,

    python -m pipeedge_tpu_torch.runtime 0 4 -m google/vit-large-patch16-224 \
        -sm models.yml -sdt device_types.yml -sd devices.yml \
        -H h100-0,h100-1,h100-2,h100-3

(`pipeedge_tpu_torch/profiles/h100/` holds the card's own files), and the
run logs the stage-to-layer and stage-to-host mapping it chose. The host
pipeline has one device: every stage runs on it, whatever host the
schedule names, and `-r` takes only the identity order. `--save-results NPZ` writes every delivered microbatch,
in delivery order, and `--rebalance auto` re-splits the batch between
measure rounds to the microbatch size the measured cadence favours.

Inputs are synthetic (`--dataset-name synthetic`, the only dataset
without a download): seeded random images for the vision models, seeded
token ids (int32, 64 per item) for the text models; integer inputs keep
their dtype on the way to the first stage, floats take `-t`.

Monitoring and adaptive bitwidth, as in `runtime.py`: every run writes
heartbeat CSVs into the working directory (`output.csv`, one row per
retired microbatch; `send.csv`, the wire bytes of all edges; one
`send<i>.csv` per inter-stage edge, fed with the wire bytes that edge
carried for each microbatch), and the environment chooses the edge
policy:

    ADAPTIVE_QUANT   HEURISTIC | HEURISTIC2 | CONTROLLER (unset: fixed bits)
    SEND_CONSTRAINT  the send rate to meet, items/s (0: none)
    WINDOW_SIZE      microbatches per adaptation window (default 10)

Each policy runs once per window on the results of the microbatches
retired so far and sets each edge's `quant_bit` for the microbatches
dispatched after it.

Tracing, as in `runtime.py`: `--trace DIR` records the run in one
`torch.profiler` session (host and device activity) and writes it as
`DIR/trace.json`; `--trace-spans OUT` records the host pipeline's spans
(`stage` per stage dispatch, `results` per retired microbatch, `wire`
per cross-device copy) and writes them as Chrome trace JSON to OUT
(`telemetry/chrome_trace.py`).

The flags of `runtime.py` that this entry does not run are refused at
parse time, each naming the ROADMAP item that ports it (`REFUSED`): the
DCN driver's (A6), the multi-device axes' (A7), the rank autoscaler's,
`--platform` (the port's switch is `--device`) and the dataset flags
(the real datasets need a download).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import get_microbatch_size, registry
from .monitoring import facade as monitoring
from .ops import _build
from .parallel import pipeline as host_pipeline
from . import telemetry
from .sched.scheduler import sched_pipeline
from .telemetry import chrome_trace
from .utils import data as data_utils
from .utils import quant as quantutil
from .utils import tracing

logger = logging.getLogger(__name__)

# Env knobs (reference runtime.py:40-52)
ENV_WINDOW_SIZE = "WINDOW_SIZE"
ENV_SEND_CONSTRAINT = "SEND_CONSTRAINT"
ENV_ADAPTIVE_QUANT = "ADAPTIVE_QUANT"
ADAPTIVE_QUANT_HEURISTIC = "HEURISTIC"
ADAPTIVE_QUANT_HEURISTIC2 = "HEURISTIC2"
ADAPTIVE_QUANT_CONTROLLER = "CONTROLLER"

# the keys the host loop feeds (runtime.py:58-72 also opens 'shard',
# 'recv', 'quant_encode' and 'quant_decode', which its DCN stages feed)
MONITORING_KEY_OUTPUT = 'output'
MONITORING_KEY_SEND = 'send'

label_queue: "queue.Queue" = queue.Queue()

# `runtime.py` flags this entry refuses, each with the ROADMAP item that
# ports it (so no flag is silently ignored): flag -> (argparse keywords,
# item)
_DCN = "A6, the DCN driver's device seam"
_REBALANCE = _DCN + " (the rebalancer between rounds)"
_AXES = "A7, the multi-GPU axes"
_AUTOSCALE = "A5.2c / A6, the rank autoscaler"
_DATASET = ("A7 small pieces: the real datasets need a download, so the "
            "port runs the synthetic inputs only")
_INT, _FLOAT, _STR, _SWITCH = ({"type": int}, {"type": float}, {},
                               {"action": "store_true"})
REFUSED = {
    "--stage-ckpt": (_STR, _DCN),
    "-D": ({"type": int, "dest": "data_rank"}, _DCN),
    "--dcn-addrs": (_STR, _DCN),
    "-P": ({"type": int, "dest": "port"}, _DCN),
    "--sched-timeout": (_FLOAT, _DCN),
    "--rounds": (_INT, _DCN),
    "--wire-crc": (_SWITCH, _DCN),
    "--heartbeat-interval": (_FLOAT, _DCN),
    "--heartbeat-miss": (_INT, _DCN),
    "--on-peer-death": (_STR, _DCN),
    "--on-peer-rejoin": (_STR, _DCN),
    "--on-peer-degraded": (_STR, _DCN),
    "--degraded-threshold": (_FLOAT, _DCN),
    "--degraded-confirm": (_INT, _DCN),
    "--degraded-readmit": (_INT, _DCN),
    "--rebalance-threshold": (_FLOAT, _REBALANCE),
    "--rebalance-cooldown": (_INT, _REBALANCE),
    "--rebalance-confirm": (_INT, _REBALANCE),
    "--spmd-dp": (_INT, _AXES),
    "--spmd-tp": (_INT, _AXES),
    "--spmd-sp": (_INT, _AXES),
    "--spmd-sp-kind": (_STR, _AXES),
    "--stage-tp": (_INT, _AXES),
    "--tp-quant-bits": (_INT, _AXES),
    "--stage-depth": (_INT, _AXES),
    "--autoscale-ranks": (_STR, _AUTOSCALE),
    "--autoscale-min": (_INT, _AUTOSCALE),
    "--autoscale-max": (_INT, _AUTOSCALE),
    "--autoscale-confirm": (_INT, _AUTOSCALE),
    "--autoscale-cooldown": (_FLOAT, _AUTOSCALE),
    "--autoscale-rank-high": (_FLOAT, _AUTOSCALE),
    "--autoscale-rank-low": (_FLOAT, _AUTOSCALE),
    "--dataset-root": (_STR, _DATASET),
    "--dataset-split": (_STR, _DATASET),
    "--dataset-indices-tsv": (_STR, _DATASET),
    "--dataset-shuffle": (_SWITCH, _DATASET),
}


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
                        help="model weights file (.npz in the family's "
                             "checkpoint keys)")
    parser.add_argument("-b", "--batch-size", default=64, type=int)
    parser.add_argument("-u", "--ubatch-size", default=8, type=int)
    parser.add_argument("-t", "--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    # scheduling (runtime.py: -pt, -q, -r, -sm, -sdt, -sd, -H)
    parser.add_argument("-pt", "--partition", type=str,
                        help="comma-delimited layer pairs, e.g. '1,24,25,48'")
    parser.add_argument("-q", "--quant", type=str,
                        help="comma-delimited per-stage output quant bitwidths")
    parser.add_argument("-r", "--rank-order", type=str, default=None,
                        help="comma-delimited stage-to-rank mapping; the "
                             "host pipeline has one device, so only the "
                             "identity order 0,1,...,N-1 is accepted")
    parser.add_argument("-sm", "--sched-models-file", default=None, type=str)
    parser.add_argument("-sdt", "--sched-dev-types-file", default=None,
                        type=str)
    parser.add_argument("-sd", "--sched-dev-file", default=None, type=str)
    parser.add_argument("-H", "--hosts", type=str,
                        help="comma-delimited hosts for schedule mapping")
    parser.add_argument("--rebalance", default="off", choices=["off", "auto"],
                        help="auto: between measure rounds, adapt the "
                             "microbatch size to the measured steady-state "
                             "stage time vs fill/drain overhead")
    parser.add_argument("--save-results", type=str, default=None,
                        metavar="NPZ",
                        help="save every delivered result microbatch (in "
                             "delivery order, all rounds) to this .npz")
    parser.add_argument("--dataset-name", type=str, default="synthetic",
                        choices=["synthetic", "ImageNet", "CoLA"])
    parser.add_argument("--measure-rounds", type=int, default=1,
                        help="run the batch this many times; round 0 pays "
                             "the kernel build and warm-up")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    parser.add_argument("-c", "--comm", default="host",
                        choices=["host", "spmd", "dcn", "p2p", "rpc"],
                        help="pipeline driver: host (p2p and rpc are its "
                             "aliases); spmd and dcn are not ported yet")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="record the run in one torch.profiler session "
                             "and write it to DIR/trace.json")
    parser.add_argument("--trace-spans", type=str, default=None,
                        metavar="OUT",
                        help="record the pipeline's spans (stage, results, "
                             "wire) and write them as Chrome trace JSON to "
                             "OUT")
    parser.add_argument("--platform", default=argparse.SUPPRESS,
                        help="the JAX package's backend switch; the port "
                             "takes --device")
    for flag, (kw, item) in REFUSED.items():
        parser.add_argument(flag, default=argparse.SUPPRESS,
                            help=f"not ported yet (ROADMAP {item})", **kw)
    args = parser.parse_args(argv)
    for flag, (kw, item) in REFUSED.items():
        if hasattr(args, kw.get("dest", flag.lstrip("-").replace("-", "_"))):
            parser.error(f"{flag} is not ported to pipeedge_tpu_torch yet "
                         f"(ROADMAP {item})")
    if hasattr(args, "platform"):
        parser.error("--platform is the JAX package's backend switch; "
                     "the port runs on --device cuda (default) or --device "
                     "cpu")
    if args.comm in ("spmd", "dcn"):
        parser.error(f"-c {args.comm} is not ported to pipeedge_tpu_torch "
                     "yet (ROADMAP "
                     + (_AXES if args.comm == "spmd" else _DCN)
                     + "); the port runs the host driver")
    if args.rank != 0:
        parser.error("the host driver is a single controller: rank must be 0")
    if args.rank_order:
        order = [int(r) for r in args.rank_order.split(",")]
        if order != list(range(len(order))):
            parser.error(f"-r {args.rank_order}: the host pipeline runs "
                         "every stage on its one device, so a rank order "
                         "other than 0,1,...,N-1 would place nothing")
    if args.dataset_name != "synthetic":
        parser.error(f"--dataset-name {args.dataset_name} needs a download "
                     "(the dataset, and its tokenizer or image processor); "
                     "the port runs the synthetic inputs only")
    if args.rebalance == "auto" and args.measure_rounds <= 1:
        parser.error("--rebalance auto on the host driver adapts the "
                     "microbatch size BETWEEN measure rounds: pass "
                     "--measure-rounds N > 1")
    return args


def parse_yaml_sched(sched: List[dict], hosts: Optional[List[str]]) -> \
        Tuple[List[Tuple[int, int]], List[int]]:
    """Parse the scheduler's YAML into stage_layers + stage_ranks (as
    `runtime.py` does; PipeEdge runtime.py:260-288). A rank is the host's
    index in `hosts`, or the host name read as an index without them."""
    assert isinstance(sched, list)
    if len(sched) == 0:
        raise RuntimeError("No viable schedule found")
    stage_layers = []
    stage_ranks = []
    # numeric host names come back from YAML as ints
    hosts_s = [str(h) for h in hosts] if hosts else None
    for stage in sched:
        assert len(stage) == 1
        for host, layers in stage.items():
            assert len(layers) == 2
            stage_layers.append((int(layers[0]), int(layers[1])))
            if hosts_s:
                try:
                    stage_ranks.append(hosts_s.index(str(host)))
                except ValueError:
                    logger.error("Scheduling: host not in hosts list: %s", host)
                    raise
            else:
                try:
                    stage_ranks.append(int(host))
                except ValueError:
                    logger.error("Scheduling: 'hosts' not specified, failed "
                                 "to parse as device index: %s", host)
                    raise
    return stage_layers, stage_ranks


def get_pipeline_sched(world_size: int, hosts: Optional[List[str]],
                       partition: Optional[List[Tuple[int, int]]],
                       quant: Optional[List[int]],
                       rank_order: Optional[List[int]], model_name: str,
                       microbatch_size: int, s_models_file: Optional[str],
                       s_dev_types_file: Optional[str],
                       s_dev_file: Optional[str],
                       dtype: str = 'float32') -> \
        Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Schedule resolution, in `runtime.py`'s order: manual partition >
    single-stage degenerate > native scheduler. Returns (stage layers,
    stage output bits, stage ranks)."""
    total = registry.get_model_layers(model_name)
    if partition:
        logger.info("Scheduling: using user-defined partitioning")
        try:
            validate_partition(partition, total)
        except ValueError as exc:
            raise ValueError(
                f"-pt: {exc} ({model_name} has {total} sublayers)") from exc
        stage_layers = list(partition)
        stage_quant = quant if quant else [0] * len(stage_layers)
        stage_ranks = (rank_order if rank_order
                       else list(range(len(stage_layers))))
    elif quant:
        raise RuntimeError("Must specify partition with quantization")
    elif rank_order:
        raise RuntimeError("Must specify partition with rank stage ordering")
    elif world_size <= 1:
        logger.info("Scheduling: single-node execution (degenerate case)")
        stage_layers = [(1, total)]
        stage_quant = [0]
        stage_ranks = [0]
    else:
        logger.info("Scheduling: using scheduler algorithm")
        if hosts and len(hosts) != world_size:
            raise RuntimeError("Specified hosts count != world size")
        # dtype must match the profile's dtype key (the scheduler selects
        # the model profile by exact (dtype, batch_size) match)
        sched = sched_pipeline(model_name, 2, 2, microbatch_size,
                               dtype=dtype, models_file=s_models_file,
                               dev_types_file=s_dev_types_file,
                               dev_file=s_dev_file)
        stage_layers, stage_ranks = parse_yaml_sched(sched, hosts)
        stage_quant = [0] * len(stage_layers)
        if hosts:
            # the scheduler's choice; the caller places the stages
            logger.info("Scheduling: stage-to-host mapping: %s",
                        [hosts[r] for r in stage_ranks])
    logger.info("Scheduling: stage-to-layer mapping: %s", stage_layers)
    logger.info("Scheduling: stage output quantization: %s", stage_quant)
    logger.info("Scheduling: stage-to-rank mapping: %s", stage_ranks)
    return stage_layers, stage_quant, stage_ranks


def _schedule(args) -> Tuple[List[Tuple[int, int]], List[int]]:
    """The run's stage layers and stage output bits, from the CLI."""
    stage_layers, stage_quant, _ = get_pipeline_sched(
        args.worldsize, args.hosts.split(",") if args.hosts else None,
        _pairs(args.partition) if args.partition else None,
        [int(q) for q in args.quant.split(",")] if args.quant else None,
        [int(r) for r in args.rank_order.split(",")]
        if args.rank_order else None,
        args.model_name, args.ubatch_size, args.sched_models_file,
        args.sched_dev_types_file, args.sched_dev_file, dtype=args.dtype)
    # one device: the ranks (and hosts) name the schedule, not a placement
    logger.info("Scheduling: all %d stage(s) run on the one %s device",
                len(stage_layers), args.device)
    return stage_layers, stage_quant


def get_window_size() -> int:
    """Window period for monitoring/adaptation (reference runtime.py:40-44)."""
    return int(os.getenv(ENV_WINDOW_SIZE, "10"))


def handle_results(tensors) -> None:
    """Process one microbatch's result: accuracy against its labels (FIFO
    order) for [B, n_classes] outputs, else softmax confidence."""
    outputs = tensors.detach().float().cpu().numpy()
    n_items = get_microbatch_size(outputs, verify=True)
    # pop the label queue either way, so it stays in step with the stream
    ubatch_labels = None if label_queue.empty() else label_queue.get()
    if ubatch_labels is not None and outputs.ndim == 2:
        assert len(outputs) == len(ubatch_labels)
        pred = outputs.argmax(axis=-1)
        acc = int((pred == np.asarray(ubatch_labels)).sum())
    else:
        exp = np.exp(outputs - outputs.max(axis=-1, keepdims=True))
        probs = exp / exp.sum(axis=-1, keepdims=True)
        conf = probs.max(axis=-1)   # [B] or [B, S]
        acc = float(conf.reshape(conf.shape[0], -1).mean(axis=1).sum())
    monitoring.iteration(MONITORING_KEY_OUTPUT, work=n_items, accuracy=acc,
                         safe=False)
    logger.debug("outputs is %s", outputs)


def load_dataset(model_name: str, batch_size: int):
    """Synthetic inputs for the model: token ids for the text models (64
    per item, or the model's positions if fewer), images otherwise."""
    cfg = registry.get_model_config(model_name)
    if cfg.vocab_size:  # token models: BERT and GPT-2
        return data_utils.synthetic_token_dataset(
            batch_size, seq_len=min(64, cfg.max_position_embeddings or 64),
            vocab_size=cfg.vocab_size, n_labels=max(cfg.num_labels, 2))
    return data_utils.synthetic_image_dataset(
        batch_size, shape=(cfg.num_channels, cfg.image_size, cfg.image_size),
        n_labels=max(cfg.num_labels, 2))


def to_input(x: np.ndarray, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """A microbatch on `device`: floats take `dtype`, integer ids keep
    theirs (an embedding gathers with them)."""
    t = torch.from_numpy(x)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


def load_batches(model_name: str, batch_size: int, ubatch_size: int,
                 device: torch.device, dtype: torch.dtype):
    """The model's synthetic batch as microbatches on `device`
    (`load_dataset`, `to_input`), and each microbatch's labels."""
    inputs, labels = [], []
    for x, lb in data_utils.batch_dataset(load_dataset(model_name, batch_size),
                                          ubatch_size):
        inputs.append(to_input(x, device, dtype))
        labels.append(lb)
    return inputs, labels


def _make_adaptive_callback(edge_stages, window_size: int, edge_keys):
    """Window-period bitwidth adaptation (reference runtime.py:121-216).

    `edge_stages` are the stages whose *output* edge is adaptive (all but
    the final stage); each exposes a mutable `quant_bit`. `edge_keys[i]`
    names the monitoring key carrying stage i's edge telemetry (wire Mbits
    per microbatch), so each stage adapts on its own edge's traffic."""
    policy = os.getenv(ENV_ADAPTIVE_QUANT)
    if not policy:
        return None
    rate_constraint = float(os.getenv(ENV_SEND_CONSTRAINT, "0"))
    controllers = {}
    ctl_state = {}

    def callback(i: int, out) -> None:
        tag = i + 1
        if tag % window_size != 0:
            # controller policy counts down its bitwidth1 window split
            if policy == ADAPTIVE_QUANT_CONTROLLER:
                for stage in edge_stages:
                    st = ctl_state.get(id(stage))
                    if st:
                        bw1, bw2, it1 = st
                        stage.quant_bit = (bw1 if it1 > 0 else bw2) % max(
                            quantutil.BITWIDTHS)
                        ctl_state[id(stage)] = (bw1, bw2, max(0, it1 - 1))
            return
        ubatch_size = get_microbatch_size(out)
        for stage_idx, stage in enumerate(edge_stages):
            key = edge_keys[stage_idx]
            with monitoring.get_locked_context(key) as mctx:
                if mctx is None:
                    return
                window_perf = mctx.get_window_perf(key=key)
                window_work = mctx.get_window_work(key=key)
                heartrate = mctx.get_window_heartrate(key=key)
            if policy == ADAPTIVE_QUANT_HEURISTIC:
                # discrete compress-ratio ladder (runtime.py:121-154)
                if rate_constraint > 0:
                    target_time = ubatch_size * window_size / rate_constraint
                else:
                    target_time = float('inf')
                target_datasize = target_time * max(window_perf, 1e-12)
                qbit = stage.quant_bit
                eff = window_work * (32 / qbit if qbit > 0 else 1)
                ratio = int(eff / target_datasize) + 1 if target_datasize > 0 else 1
                for bound, bit in ((1, 0), (2, 16), (4, 8), (5, 6), (8, 4)):
                    if ratio <= bound:
                        stage.quant_bit = bit
                        break
                else:
                    stage.quant_bit = 2
            elif policy == ADAPTIVE_QUANT_HEURISTIC2:
                # analytic largest-feasible bitwidth (runtime.py:156-174)
                if rate_constraint <= 0:
                    continue
                ubatch_time = ubatch_size / rate_constraint
                src_bit = 32
                qbit = quantutil.constrain_max_bitwidth(
                    ubatch_time, max(window_work, 1e-12) / window_size,
                    max(window_perf, 1e-12), src_bit)
                stage.quant_bit = max(2, qbit) % src_bit
            elif policy == ADAPTIVE_QUANT_CONTROLLER:
                # Kalman/integral controller window split (runtime.py:177-216)
                if id(stage) not in controllers:
                    bw_start = stage.quant_bit or max(quantutil.BITWIDTHS)
                    controllers[id(stage)] = \
                        quantutil.AdaptiveBitwidthPerformanceController(
                            rate_constraint, quantutil.BITWIDTHS, bw_start)
                ctl = controllers[id(stage)]
                ctl.reference = rate_constraint
                send_rate = heartrate * ubatch_size
                bw1, bw2, it1 = ctl(send_rate, window_size)
                ctl_state[id(stage)] = (bw1, bw2, it1)
                stage.quant_bit = (bw1 if it1 > 0 else bw2) % max(
                    quantutil.BITWIDTHS)
            logger.info("Adaptive quantization (%s): bitwidth=%d", policy,
                        stage.quant_bit)

    return callback


def init_monitoring(window_size: int) -> None:
    """Open the monitoring session with the keys the host loop feeds:
    `output` (`handle_results`) and `send` (all edges' wire Mbits per
    microbatch); `attach_callbacks` adds one key per edge."""
    monitoring.init(MONITORING_KEY_OUTPUT, window_size,
                    work_type='classifications', acc_type='correct')
    monitoring.add_key(MONITORING_KEY_SEND, work_type='Mbits')


def attach_callbacks(pipe: host_pipeline.HostPipeline,
                     window_size: int) -> List[str]:
    """Wire a pipeline to the open monitoring session, as `runtime.py`'s
    host loop does: one `send<i>` key per inter-stage edge, fed with
    that edge's wire bytes for each microbatch (the plain `send` key gets
    their sum), the results handler, and the `ADAPTIVE_QUANT` policy over
    the edges. Returns the per-edge keys."""
    edge_keys = [f"{MONITORING_KEY_SEND}{i}"
                 for i in range(len(pipe.stages) - 1)]
    for key in edge_keys:
        monitoring.add_key(key, work_type='Mbits')
    adaptive = _make_adaptive_callback(pipe.stages[:-1], window_size,
                                       edge_keys=edge_keys)

    def on_edge_bytes(i, edge_bytes):
        total_mbits = 0.0
        for key, nbytes in zip(edge_keys, edge_bytes):
            mbits = nbytes * 8 / 1e6
            total_mbits += mbits
            monitoring.iteration(key, work=mbits, safe=False)
        monitoring.iteration(MONITORING_KEY_SEND, work=total_mbits, safe=False)

    def on_result(i, out):
        handle_results(out)
        if adaptive is not None:
            adaptive(i, out)

    pipe.edge_bytes_callback = on_edge_bytes
    pipe.ubatch_callback = on_result
    return edge_keys


def edge_bits(pipe: host_pipeline.HostPipeline) -> List[int]:
    """Each inter-stage edge's bitwidth as it stands."""
    return [stage.quant_bit for stage in pipe.stages[:-1]]


def run_pipeline_host(args, stage_layers: Sequence[Tuple[int, int]],
                      stage_quant: Sequence[int]) -> dict:
    """Build the pipeline, stream the batch `--measure-rounds` times under
    the open monitoring session and print the report lines; returns the
    last round's stats. With `--rebalance auto` the batch is re-split
    between rounds (`adapt_microbatches`); with `--save-results` every
    delivered microbatch of every round is saved, in delivery order."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = host_pipeline.build_pipeline(
        args.model_name, stage_layers, model_file=args.model_file,
        device=args.device, quant_bits=stage_quant, dtype=dtype)
    inputs, labels = load_batches(args.model_name, args.batch_size,
                                  args.ubatch_size, pipe.stages[0].device,
                                  dtype)
    attach_callbacks(pipe, get_window_size())
    rounds = max(1, args.measure_rounds)
    stats: dict = {}
    delivered: list = []
    for rnd in range(rounds):
        for lb in labels:
            label_queue.put(lb)
        tik = time.monotonic()
        results, stats = pipe.run(inputs)
        tok = time.monotonic()
        if args.save_results:
            delivered.extend(r.detach().float().cpu().numpy() for r in results)
        if rounds > 1:
            batch_total = sum(len(u) for u in inputs)
            print(f"round={rnd} latency_sec={tok - tik:.6f} "
                  f"throughput_items_sec={batch_total / (tok - tik):.3f}")
        if args.rebalance == "auto" and rnd + 1 < rounds:
            # the planner may merge up to 4x the CLI microbatch (memory
            # grows with it) but never the whole batch into one
            inputs, labels = adapt_microbatches(
                pipe, stats, inputs, labels, max_ubatch=4 * args.ubatch_size)
    if args.save_results:
        np.savez(args.save_results, *delivered)
        logger.info("saved %d result microbatch(es) to %s", len(delivered),
                    args.save_results)
    _report(tik, tok, inputs)
    steady = stats.get("steady_state_throughput_items_sec")
    if steady:
        print(f"steady_state_throughput_items_sec={steady:.3f}")
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    print("edge_bits=" + json.dumps(edge_bits(pipe)))
    return stats


def adapt_microbatches(pipe: host_pipeline.HostPipeline, stats: dict,
                       inputs: list, labels: list,
                       max_ubatch: Optional[int] = None):
    """One adaptive-microbatching step between measure rounds (as
    `runtime.py _adapt_microbatches`): split this round's measured steady
    interval per microbatch into per-item time and per-microbatch host
    overhead, ask `plan_microbatches` for the latency-minimizing split,
    and re-slice the batch, inputs and labels at the same boundaries so
    results and labels stay paired. Returns (inputs, labels)."""
    interval = stats.get("steady_mb_interval_s")
    if not interval or not inputs:
        return inputs, labels
    u_cur = max(len(u) for u in inputs)
    t_fixed = stats.get("host_dispatch_s_per_ubatch") or 0.0
    t_item = max(0.0, interval - t_fixed) / u_cur
    batch_total = sum(len(u) for u in inputs)
    u_new, m_new, t_pred = host_pipeline.plan_microbatches(
        batch_total, len(pipe.stages), t_item, t_fixed,
        max_ubatch=max(max_ubatch or 0, u_cur) or None)
    if u_new == u_cur:
        return inputs, labels
    logger.info("adaptive ubatch: %d -> %d items/microbatch (%d -> %d "
                "microbatches; modeled round latency %.4fs)", u_cur, u_new,
                len(inputs), m_new, t_pred)
    print(f"adaptive_ubatch={u_new} microbatches={m_new} "
          f"predicted_latency_sec={t_pred:.6f}")
    flat = torch.cat(list(inputs), dim=0)
    new_inputs = [flat[i:i + u_new] for i in range(0, batch_total, u_new)]
    new_labels = labels
    if labels and all(lb is not None for lb in labels):
        lflat = np.concatenate([np.asarray(lb) for lb in labels], axis=0)
        new_labels = [lflat[i:i + u_new]
                      for i in range(0, batch_total, u_new)]
    # enough microbatches in flight to cover the pipeline's depth, never
    # more than double buffering gives
    pipe.max_inflight = max(len(pipe.stages) + 1,
                            min(2 * len(pipe.stages), m_new))
    return new_inputs, new_labels


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
    args = parse_args(argv)
    stage_layers, stage_quant = _schedule(args)
    if args.trace_spans:
        telemetry.configure(rank=0)
    init_monitoring(get_window_size())
    try:
        with tracing.trace(args.trace):
            run_pipeline_host(args, stage_layers, stage_quant)
    finally:
        monitoring.finish()
    if args.trace_spans and telemetry.recorder() is not None:
        spans = telemetry.recorder().snapshot()
        chrome_trace.dump_trace(spans, args.trace_spans)
        logger.info("trace-spans: %d span(s) -> %s", len(spans),
                    args.trace_spans)


if __name__ == "__main__":
    main()
