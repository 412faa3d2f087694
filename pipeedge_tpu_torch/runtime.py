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

PipeEdge's own deployment, `-c dcn`: one process per rank, the stages'
activations between them over framed TCP (`comm/dcn.py`), as
`runtime.py -c dcn` runs it:

    python -m pipeedge_tpu_torch.runtime 1 2 -c dcn -pt 1,21,22,48 \
        -q 8,0 --dcn-addrs 127.0.0.1:29600,127.0.0.1:29601 &
    python -m pipeedge_tpu_torch.runtime 0 2 -c dcn -pt 1,21,22,48 \
        -q 8,0 --dcn-addrs 127.0.0.1:29600,127.0.0.1:29601 --save-results r.npz

The data rank (`-D`, default 0) resolves the schedule and broadcasts it
(CMD_SCHED), feeds the microbatches to the first stage and collects the
results; every rank builds the stage the schedule gives it and idles
when it has none. A stage decodes its input on its device (the codec's
decode kernel at bits 4 and 8 on the card), runs its layers on a stream
of its own and encodes its output there (the encode kernel), and a send
thread waits only on that microbatch's event before the frame goes out.
`-pt "a;b" -q "x;y"` (or `--rounds N`) runs several schedule rounds on one
fleet; an empty CMD_SCHED ends it. A peer's death (a dropped connection,
or `--heartbeat-interval` beats missed `--heartbeat-miss` times) stops the
fleet, each survivor naming the dead rank (`--on-peer-death abort`).
Every rank prints its `kernel_launches=`, per round and in total.

The flags of `runtime.py` that this entry does not run are refused at
parse time, each naming the ROADMAP item that ports it (`REFUSED`): the
DCN driver's fault recovery, rebalancer and autoscaler (A6b), the
multi-device axes' (A7), `--platform` (the port's switch is `--device`)
and the dataset flags (the real datasets need a download).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .comm import CMD_ADMIT, CMD_DEAD, CMD_SCHED, CMD_STOP
from .health import guard as nan_guard
from .models import get_microbatch_size, registry
from .monitoring import facade as monitoring
from .ops import _build
from .parallel import pipeline as host_pipeline
from . import telemetry
from .sched.scheduler import sched_pipeline
from .telemetry import chrome_trace
from .telemetry import metrics as prom
from .utils import data as data_utils
from .utils import quant as quantutil
from .utils import tracing
from .utils.threads import ThreadSafeCounter

logger = logging.getLogger(__name__)

# Env knobs (reference runtime.py:40-52)
ENV_WINDOW_SIZE = "WINDOW_SIZE"
ENV_SEND_CONSTRAINT = "SEND_CONSTRAINT"
ENV_ADAPTIVE_QUANT = "ADAPTIVE_QUANT"
ADAPTIVE_QUANT_HEURISTIC = "HEURISTIC"
ADAPTIVE_QUANT_HEURISTIC2 = "HEURISTIC2"
ADAPTIVE_QUANT_CONTROLLER = "CONTROLLER"

# monitoring keys (runtime.py:58-72): the host loop feeds 'output' and
# 'send'; the DCN ranks feed 'shard' (beat per retired microbatch),
# 'send'/'recv' (the transport hooks), 'liveness' (one row per heartbeat
# received, accuracy column = sender rank) and 'hb_rtt' (one row per
# heartbeat round trip, work = ms)
MONITORING_KEY_MODEL = 'shard'
MONITORING_KEY_OUTPUT = 'output'
MONITORING_KEY_QUANT_ENCODE = 'quant_encode'
MONITORING_KEY_QUANT_DECODE = 'quant_decode'
MONITORING_KEY_SEND = 'send'
MONITORING_KEY_RECV = 'recv'
MONITORING_KEY_LIVENESS = 'liveness'
MONITORING_KEY_HB_RTT = 'hb_rtt'

label_queue: "queue.Queue" = queue.Queue()
results_counter = ThreadSafeCounter(name="runtime.results")
# multi-process (dcn) command state (reference runtime.py:400-415)
stop_event = threading.Event()
sched_q: "queue.Queue" = queue.Queue()
# why the fleet stopped: a CMD_STOP carrying a rank id means that rank died
# mid-run; None = clean stop
stop_info: List[Optional[int]] = [None]
# cumulative CMD_STOP count: round r of a multi-schedule run ends at the
# (r+1)-th stop, so a stop that lands while a worker is still tearing down
# the previous round is counted, not lost
stop_counter = ThreadSafeCounter(name="runtime.stops")
# set once the fleet is tearing down cleanly (empty CMD_SCHED sent or
# received): from then on, dropped connections are expected, not deaths
fleet_shutdown = threading.Event()
# --save-results at the dcn data rank: every delivered result, in order
_results_sink: Optional[list] = None

# /metrics plane: the DCN transport hooks feed these
_WIRE_BYTES = prom.REGISTRY.counter(
    "pipeedge_edge_wire_bytes_total",
    "bytes moved over DCN pipeline edges, by direction and peer rank")
_EDGE_BITS = prom.REGISTRY.gauge(
    "pipeedge_edge_bits",
    "negotiated wire bitwidth per DCN edge (0 = uncompressed)")
_EDGE_PATH = prom.REGISTRY.gauge(
    "pipeedge_edge_path",
    "negotiated transport tier per DCN edge "
    "(0 = socket_v2, 1 = zerocopy, 2 = local hand-off)")
_HEARTBEATS_RX = prom.REGISTRY.counter(
    "pipeedge_heartbeats_received_total",
    "liveness-plane heartbeat frames received, by sender rank")
_PEER_DEATHS = prom.REGISTRY.counter(
    "pipeedge_peer_deaths_total", "peer deaths observed (any mode)")
_REJOINS = prom.REGISTRY.counter(
    "pipeedge_rejoins_total",
    "peers re-admitted through the JOIN handshake after a confirmed death")

# `runtime.py` flags this entry refuses, each with the ROADMAP item that
# ports it (so no flag is silently ignored): flag -> (argparse keywords,
# item)
_DCN_B = "A6b, the DCN driver's fault recovery"
_REBALANCE = "A6b, the DCN rebalancer between rounds"
_AXES = "A7, the multi-GPU axes"
_AUTOSCALE = "A6b, the DCN rank autoscaler"
_DATASET = ("A7 small pieces: the real datasets need a download, so the "
            "port runs the synthetic inputs only")
_INT, _FLOAT, _STR, _SWITCH = ({"type": int}, {"type": float}, {},
                               {"action": "store_true"})
REFUSED = {
    "--on-peer-rejoin": (_STR, _DCN_B),
    "--on-peer-degraded": (_STR, _DCN_B),
    "--degraded-threshold": (_FLOAT, _DCN_B),
    "--degraded-confirm": (_INT, _DCN_B),
    "--degraded-readmit": (_INT, _DCN_B),
    "--rebalance-threshold": (_FLOAT, _REBALANCE),
    "--rebalance-cooldown": (_INT, _REBALANCE),
    "--rebalance-confirm": (_INT, _REBALANCE),
    "--spmd-dp": (_INT, _AXES),
    "--spmd-tp": (_INT, _AXES),
    "--spmd-sp": (_INT, _AXES),
    "--spmd-sp-kind": (_STR, _AXES),
    "--stage-tp": (_INT, _AXES),
    "--tp-quant-bits": (_INT, _AXES),
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
        description="Pipeline-parallel inference runtime (PyTorch port: "
                    "the host driver, and the DCN driver of one process "
                    "per rank)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("rank", type=int,
                        help="this process's rank (-c dcn); the host "
                             "driver is a single controller: 0")
    parser.add_argument("worldsize", type=int,
                        help="number of ranks (-c dcn) or pipeline stages")
    parser.add_argument("-m", "--model-name",
                        default="google/vit-base-patch16-224",
                        choices=registry.get_model_names())
    parser.add_argument("-M", "--model-file", type=str,
                        help="model weights file (.npz in the family's "
                             "checkpoint keys)")
    parser.add_argument("--stage-ckpt", type=str, default=None, metavar="DIR",
                        help="per-stage checkpoint root (utils/checkpoint.py "
                             "save_stage_checkpoints); each dcn rank reads "
                             "only its own stage")
    parser.add_argument("-b", "--batch-size", default=64, type=int)
    parser.add_argument("-u", "--ubatch-size", default=8, type=int)
    parser.add_argument("-t", "--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    # scheduling (runtime.py: -pt, -q, -r, -sm, -sdt, -sd, -H)
    parser.add_argument("-pt", "--partition", type=str,
                        help="comma-delimited layer pairs, e.g. '1,24,25,48';"
                             " ';'-separated values define live re-schedule "
                             "rounds (dcn only)")
    parser.add_argument("-q", "--quant", type=str,
                        help="comma-delimited per-stage output quant "
                             "bitwidths (';'-separated per round)")
    parser.add_argument("-r", "--rank-order", type=str, default=None,
                        help="comma-delimited stage-to-rank mapping (';' per "
                             "round, dcn); the host pipeline has one "
                             "device, so it takes only the identity order")
    parser.add_argument("-D", "--data-rank", type=int, default=0,
                        help="rank that drives data and results (dcn)")
    parser.add_argument("--dcn-addrs", type=str, default=None,
                        help="comma-delimited host:port listener address per "
                             "rank (dcn); default 127.0.0.1:PORT+rank")
    parser.add_argument("-P", "--port", type=int, default=29600,
                        help="base listener port for the dcn defaults")
    parser.add_argument("--stage-depth", type=int, default=0,
                        help="dcn stage pipelining depth: microbatches "
                             "buffered per hand-off queue (0 = env "
                             "DCN_STAGE_DEPTH or 2; 1 serializes compute "
                             "with readback and send)")
    parser.add_argument("--sched-timeout", type=float, default=300,
                        help="seconds a dcn rank waits for the schedule, "
                             "the results or the stop")
    parser.add_argument("--rounds", type=int, default=1,
                        help="dcn: run the schedule this many rounds (same "
                             "batch each round)")
    parser.add_argument("--on-peer-death", default="abort",
                        choices=["abort", "failover"],
                        help="dcn reaction to a rank dying mid-run: abort "
                             "the fleet (failover is not ported yet)")
    parser.add_argument("--wire-crc", action="store_true",
                        help="checksum every wire-v2 frame, verify it on "
                             "receive and ask for one resend of a corrupt "
                             "frame (env PIPEEDGE_WIRE_CRC=1); pass it to "
                             "every rank")
    parser.add_argument("--heartbeat-interval", type=float, default=0.0,
                        help="dcn liveness plane: seconds between heartbeat "
                             "frames to every peer (0 = env "
                             "DCN_HEARTBEAT_INTERVAL or off)")
    parser.add_argument("--heartbeat-miss", type=int, default=0,
                        help="missed beats before a silent peer is declared "
                             "dead (0 = env DCN_HEARTBEAT_MISS or 3)")
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
                             "aliases) or dcn (one process per rank); spmd "
                             "is not ported yet")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="record the run in one torch.profiler session "
                             "and write it to DIR/trace.json (dcn: "
                             "DIR/rank<r>/trace.json)")
    parser.add_argument("--trace-spans", type=str, default=None,
                        metavar="OUT",
                        help="record the pipeline's spans and write them as "
                             "Chrome trace JSON to OUT (dcn: the data rank "
                             "gathers every rank's spans, clock-aligned; "
                             "pass the flag to every rank)")
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
    if args.comm == "spmd":
        parser.error(f"-c spmd is not ported to pipeedge_tpu_torch yet "
                     f"(ROADMAP {_AXES}); the port runs the host and dcn "
                     "drivers")
    if args.on_peer_death != "abort":
        parser.error(f"--on-peer-death {args.on_peer_death} is not ported "
                     f"to pipeedge_tpu_torch yet (ROADMAP {_DCN_B}); the "
                     "port's dcn driver aborts the fleet")
    dcn = args.comm == "dcn"
    n_rounds = max(len(v.split(";")) for v in
                   (args.partition or "", args.quant or "",
                    args.rank_order or ""))
    if not dcn:
        for flag, given in (("--stage-ckpt", args.stage_ckpt),
                            ("--rounds", args.rounds != 1)):
            if given:
                parser.error(f"{flag} is a -c dcn option")
        if n_rounds > 1:
            parser.error("';'-separated re-schedule rounds require -c dcn")
        if args.rank != 0:
            parser.error("the host driver is a single controller: rank "
                         "must be 0")
        if args.rank_order:
            order = [int(r) for r in args.rank_order.split(",")]
            if order != list(range(len(order))):
                parser.error(f"-r {args.rank_order}: the host pipeline runs "
                             "every stage on its one device, so a rank "
                             "order other than 0,1,...,N-1 would place "
                             "nothing")
    else:
        if not 0 <= args.rank < args.worldsize:
            parser.error(f"rank {args.rank} is outside the world of "
                         f"{args.worldsize}")
        if not 0 <= args.data_rank < args.worldsize:
            parser.error(f"-D {args.data_rank} is outside the world of "
                         f"{args.worldsize}")
        if args.rounds < 1:
            parser.error("--rounds must be >= 1")
        if args.rounds > 1 and n_rounds > 1:
            parser.error("--rounds cannot combine with ';'-separated "
                         "re-schedule rounds (pick one)")
        for opt, spec in (("-pt", args.partition), ("-q", args.quant),
                          ("-r", args.rank_order)):
            k = len(spec.split(";")) if spec else 1
            if 1 < k != n_rounds:
                parser.error(f"{opt}: {k} ';'-rounds given but {n_rounds} "
                             f"rounds defined; give 1 or {n_rounds}")
        if args.rebalance == "auto":
            parser.error(f"--rebalance auto on the dcn driver is not ported "
                         f"to pipeedge_tpu_torch yet (ROADMAP {_REBALANCE})")
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
    """Process one microbatch's result (a tensor or an array): accuracy
    against its labels (FIFO order) for [B, n_classes] outputs, else
    softmax confidence. At a dcn data rank with `--save-results` the
    result is kept, and `results_counter` counts its items."""
    if isinstance(tensors, torch.Tensor):
        outputs = np.array(tensors.detach().float().cpu().numpy())
    else:
        outputs = np.array(tensors, dtype=np.float32)
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
    if _results_sink is not None:
        _results_sink.append(outputs)
    results_counter.add(n_items)


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


# -- the DCN driver: one process per rank -------------------------------

def _declare_fleet_metric_labels(world_size: int, rank: int) -> None:
    """Pre-declare the per-peer label matrices: the fleet's membership
    fixes every (direction, peer) series up front, so scrapers see the
    full matrix at 0 instead of series appearing at first increment."""
    for r in range(world_size):
        if r == rank:
            continue
        _HEARTBEATS_RX.declare(src=str(r))
        _PEER_DEATHS.declare(peer=str(r))
        _REJOINS.declare(peer=str(r))
        for key in (MONITORING_KEY_SEND, MONITORING_KEY_RECV):
            _WIRE_BYTES.declare(direction=key, peer=str(r))


def handle_cmd(cmd: int, tensors) -> None:
    """Process a command (reference runtime.py:404-415)."""
    if cmd == CMD_STOP:
        logger.info("handle_cmd: stop")
        if tensors:
            stop_info[0] = int(np.asarray(tensors[0]))
            monitoring.flush()   # post-mortem CSVs must survive the abort
        stop_counter.add(1)
        stop_event.set()
    elif cmd == CMD_SCHED:
        logger.info("handle_cmd: sched")
        # pair the schedule with the stop count at its arrival (commands
        # from the data rank ride one connection, so this round's stop is
        # not yet counted): the worker's round ends at base + 1
        sched_q.put((stop_counter.value, tensors))
    elif cmd == CMD_ADMIT:
        rnd_now = int(np.asarray(tensors[0])) if tensors else -1
        logger.warning("handle_cmd: re-admitted into the fleet "
                       "(current round %d)", rnd_now)
    elif cmd == CMD_DEAD:
        # a failover announcement (from a JAX rank running --on-peer-death
        # failover); the port's driver aborts on a death it sees itself
        logger.warning("handle_cmd: rank %d announced dead",
                       int(np.asarray(tensors[0])))
        monitoring.flush()
    else:
        logger.warning("handle_cmd: Unknown command: %s", cmd)


class _EdgeQuantState:
    """Mutable output-edge bitwidth of a DCN rank (the reference's
    `quant_bit` buffer that the adaptive hooks mutate)."""

    def __init__(self, quant_bit: int):
        self.quant_bit = quant_bit


def _register_dcn_monitor_hooks(ctx) -> None:
    """Wire the transport's send/recv hooks to the monitoring keys: the
    bytes and transfer time of every pipeline-edge frame on this rank
    (reference p2p:132-152). Feed frames (raw inputs to the head stage)
    are left out, as the reference injects inputs locally."""
    from .comm import dcn

    def make_hooks(key):
        def pre(peer, channel):
            if dcn.base_channel(channel) != dcn.CHANNEL_FEED:
                monitoring.iteration_start(key)

        def post(peer, channel, tensors):
            if dcn.base_channel(channel) == dcn.CHANNEL_FEED:
                return
            if tensors is None:  # transfer aborted mid-frame
                monitoring.iteration_abort(key)
                return
            nbytes = sum(int(t.nbytes) for t in tensors)
            _WIRE_BYTES.inc(nbytes, direction=key, peer=str(peer))
            monitoring.iteration(key, work=nbytes * 8 / 1e6)

        return pre, post

    ctx.register_send_hooks(*make_hooks(MONITORING_KEY_SEND))
    ctx.register_recv_hooks(*make_hooks(MONITORING_KEY_RECV))


def _stream_scope(stream):
    import contextlib
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def build_dcn_stage(args, ctx, rnd: int, i: int,
                    stage_layers: Sequence[Tuple[int, int]],
                    stage_quant: Sequence[int], stage_ranks: Sequence[int],
                    dtype: torch.dtype):
    """Stage `i` of a schedule on this rank: a `DcnPipelineStage` whose
    dispatch decodes the inbound frame on the stage's device, runs the
    stage on a stream of its own and encodes the output edge there (wire
    v2, `wire_encode_device`), and whose readback (on the send thread)
    waits on that microbatch's event only. The output edge's bitwidth is
    negotiated with the consumer, adapts under `ADAPTIVE_QUANT` on this
    rank's own `send` window, and its transport tier is negotiated
    (`local` hands the device tensors to a consumer in this process)."""
    from .comm import dcn
    from .comm import wire

    rank, data_rank = ctx.rank, args.data_rank
    parity = dcn.CHANNEL_ROUND_PARITY * (rnd % 2)
    wire_crc = args.wire_crc or wire.crc_enabled()
    guard_on = nan_guard.nan_guard_enabled()
    device = resolve_device(args.device)
    l, r = stage_layers[i]
    restored = None
    if args.stage_ckpt:
        # this rank reads exactly its own stage, validated against the
        # schedule by the checkpoint's manifest
        from .utils import checkpoint as ckpt_utils
        ckpt_utils.check_stage_compatible(args.stage_ckpt, args.model_name,
                                          i, (l, r))
        restored = ckpt_utils.load_stage_checkpoint(args.stage_ckpt, i,
                                                    dtype=dtype)
    fn, params, _ = registry.module_shard_factory(
        args.model_name, args.model_file, l, r, stage=i, dtype=dtype,
        device=device, params=restored)
    last = len(stage_layers) - 1
    is_first, is_last = i == 0, i == last
    out_bit = stage_quant[i] if i < last else 0
    # colocated hand-offs into this rank land on its device
    ctx.set_local_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    edge = None if is_last else _EdgeQuantState(out_bit)
    adaptive = None if edge is None else _make_adaptive_callback(
        [edge], get_window_size(), edge_keys=[MONITORING_KEY_SEND])
    # the head stage is fed by the data rank on the FEED channel, the last
    # stage's results ride the RESULTS channel
    rank_src = stage_ranks[i - 1] if not is_first else data_rank
    rank_dst = stage_ranks[i + 1] if not is_last else data_rank
    agreed_bits = {0: 0}

    def negotiate(proposed: int, timeout: float = 5.0) -> int:
        # what the consumer accepts; an adaptive move is re-capped to it
        agreed = agreed_bits.get(proposed)
        if agreed is None:
            try:
                agreed = ctx.negotiate_edge_bits(rank_dst, proposed,
                                                 timeout=timeout)
                if agreed != proposed:
                    logger.info("edge rank %d->%d: bitwidth negotiated "
                                "%d -> %d", rank, rank_dst, proposed, agreed)
            except queue.Empty:
                logger.warning("edge rank %d->%d: bitwidth handshake timed "
                               "out; keeping bit=%d", rank, rank_dst,
                               proposed)
                agreed = proposed
            agreed_bits[proposed] = agreed
        _EDGE_BITS.set(agreed, edge=f"{rank}->{rank_dst}")
        return agreed

    if edge is not None and edge.quant_bit:
        edge.quant_bit = negotiate(edge.quant_bit,
                                   timeout=min(30.0, args.sched_timeout))
    edge_tier = [None]
    try:
        edge_tier[0] = ctx.negotiate_edge_path(
            rank_dst, timeout=min(10.0, args.sched_timeout))
        _EDGE_PATH.set(dcn.PATH_CODES[edge_tier[0]],
                       edge=f"{rank}->{rank_dst}")
    except (queue.Empty, OSError) as exc:
        logger.warning("edge rank %d->%d: transport-path handshake failed "
                       "(%s); keeping the socket path", rank, rank_dst, exc)
    mb_seq = [0]
    ubatch_idx = [0]

    def dispatch_cb(tensors):
        with _stream_scope(stream):
            if is_first:
                payload = to_input(np.asarray(tensors[0]), device, dtype)
            else:
                try:
                    payload = wire.wire_decode(tensors, dtype, device=device)
                except wire.WireCorruptError as exc:
                    # the reader verifies CRC-flagged frames when this
                    # rank's PIPEEDGE_WIRE_CRC is on; this catches the
                    # frames it did not (a producer armed alone)
                    dcn.FRAMES_CORRUPT.inc(peer=str(rank_src))
                    logger.error("stage %d: corrupt frame from rank %d "
                                 "(%s); requesting resend", i, rank_src, exc)
                    try:
                        ctx.request_resend(rank_src,
                                           dcn.CHANNEL_DATA + parity)
                    except OSError as rexc:
                        logger.error("resend request to rank %d failed: "
                                     "%s", rank_src, rexc)
                    return dcn.DcnPipelineStage.SKIP
            mb = mb_seq[0]
            mb_seq[0] += 1
            if guard_on:
                payload = nan_guard.check_finite(payload,
                                                 where=f"stage{i}/input",
                                                 mb=mb)
            with telemetry.span("compute", f"stage{i}", stage=i, mb=mb):
                out = fn(params, payload)
                pending = wire.wire_encode_device(
                    out, edge.quant_bit if edge is not None else 0,
                    crc=wire_crc)
        first = out[0] if isinstance(out, tuple) else out
        # the raw output rides the hand-off queue only when the adaptive
        # policy reads it (it would pin `depth` microbatches otherwise)
        return (pending, out if adaptive is not None else None,
                int(first.shape[0]))

    def readback_cb(item):
        pending, out, n_items = item
        if edge_tier[0] == dcn.PATH_LOCAL:
            # a consumer in this process takes the device tensors, its
            # stream waiting on this microbatch's event
            frame = pending.device_frame()
        else:
            frame = pending.finalize()   # waits on this microbatch's event
        # beat-to-beat: in steady state the interval between retiring
        # microbatches is the per-microbatch time
        monitoring.iteration(MONITORING_KEY_MODEL, work=n_items,
                             accuracy=r - l + 1, safe=False)
        if adaptive is not None:
            adaptive(ubatch_idx[0], out)
            ubatch_idx[0] += 1
            if edge.quant_bit:
                edge.quant_bit = negotiate(edge.quant_bit)
        return frame

    return dcn.DcnPipelineStage(
        ctx, rank_src, rank_dst, dispatch_cb=dispatch_cb,
        readback_cb=readback_cb, stage=i,
        depth=args.stage_depth or None,
        recv_channel=(dcn.CHANNEL_FEED if is_first
                      else dcn.CHANNEL_DATA) + parity,
        send_channel=(dcn.CHANNEL_RESULTS if is_last
                      else dcn.CHANNEL_DATA) + parity)


def _launch_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()}


def run_pipeline_dcn(args, schedules, ubatches, labels) -> None:
    """One rank of a DCN fleet (reference `runtime.py RANK WORLDSIZE`,
    run_pipeline_p2p 418-511). The data rank broadcasts each round's
    schedule (`schedules`: a list of (stage layers, stage bits, stage
    ranks)), streams the microbatches to the first stage and collects
    the results from the last; workers build the stage each CMD_SCHED
    gives them until an empty one ends the run. A peer's death stops the
    fleet (`--on-peer-death abort`)."""
    from .comm import dcn

    rank, world_size = args.rank, args.worldsize
    data_rank = args.data_rank
    resolve_device(args.device)   # a run asked for the card needs one
    _declare_fleet_metric_labels(world_size, rank)
    addrs = dcn.parse_rank_addrs(args.dcn_addrs, world_size, args.port)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    launches0 = dict(_build.launch_counts)

    # deaths are terminal: the abort driver has no rejoin (A6b)
    with dcn.DistDcnContext(world_size, rank, addrs, cmd_handler=handle_cmd,
                            accept_joins=False) as ctx:
        _register_dcn_monitor_hooks(ctx)

        def on_peer_death(dead: int) -> None:
            if stop_info[0] is not None:
                return  # the fleet is already aborting for a known death
            # connections also drop during the clean teardown (empty
            # CMD_SCHED), which may still be in flight on another socket
            if fleet_shutdown.wait(timeout=2.0):
                return
            monitoring.flush()
            now = time.monotonic_ns()
            telemetry.record("failover", "detect", now, now)
            _PEER_DEATHS.inc(peer=str(dead))
            logger.error("rank %d: peer rank %d died; stopping the pipeline",
                         rank, dead)
            stop_info[0] = dead
            # broadcast before waking local waiters: the data rank's round
            # broadcasts a plain CMD_STOP once stop_event fires
            try:
                ctx.cmd_broadcast(CMD_STOP, [np.asarray(dead, np.int32)],
                                  best_effort=True)
            except OSError:  # pragma: no cover - best_effort guards
                pass
            stop_event.set()

        ctx.register_peer_death_handler(on_peer_death)

        def liveness_beat(src: int) -> None:
            _HEARTBEATS_RX.inc(src=str(src))
            with monitoring.get_locked_context(MONITORING_KEY_LIVENESS) \
                    as mctx:
                if mctx is not None:
                    mctx.iteration(key=MONITORING_KEY_LIVENESS, work=1,
                                   accuracy=src)

        def rtt_sample(src: int, rtt_ms: float) -> None:
            with monitoring.get_locked_context(MONITORING_KEY_HB_RTT) \
                    as mctx:
                if mctx is not None:
                    mctx.iteration(key=MONITORING_KEY_HB_RTT, work=rtt_ms,
                                   accuracy=src)

        ctx.register_heartbeat_hook(liveness_beat)
        ctx.register_heartbeat_rtt_hook(rtt_sample)
        ctx.start_heartbeat(
            interval=args.heartbeat_interval
            if args.heartbeat_interval > 0 else None,
            miss_threshold=args.heartbeat_miss
            if args.heartbeat_miss > 0 else None)
        results_target = [0]
        if rank == data_rank:
            try:
                for rnd, sched in enumerate(schedules):
                    if rnd:
                        logger.info("re-schedule: broadcasting round %d "
                                    "(partition %s)", rnd, sched[0])
                    _dcn_round(args, ctx, rnd, *sched, ubatches, labels,
                               dtype, results_target)
            finally:
                if args.trace_spans:
                    _collect_write_spans(ctx, args)
            # no more rounds: an empty schedule releases the workers
            # (fleet_shutdown first, so peers closing are not deaths)
            fleet_shutdown.set()
            ctx.cmd_broadcast(CMD_SCHED, [], exclude=ctx.dead_ranks())
        else:
            rnd = 0
            while True:
                deadline = time.monotonic() + args.sched_timeout
                while True:
                    try:
                        stop_base, tensors = sched_q.get(timeout=0.5)
                        break
                    except queue.Empty:
                        if stop_info[0] is not None:
                            raise RuntimeError(
                                f"rank {rank}: pipeline aborted: rank "
                                f"{stop_info[0]} died") from None
                        if time.monotonic() >= deadline:
                            raise RuntimeError(
                                f"rank {rank}: no CMD_SCHED within "
                                f"{args.sched_timeout}s; is the data rank "
                                "up and are --dcn-addrs consistent across "
                                "ranks?") from None
                if len(tensors) == 0:
                    logger.info("rank %d: empty CMD_SCHED; shutting down",
                                rank)
                    fleet_shutdown.set()
                    break
                stage_layers = [tuple(map(int, lr)) for lr in tensors[0]]
                stage_quant = [int(q) for q in tensors[1]]
                stage_ranks = [int(r) for r in tensors[2]]
                # the schedule carries the data rank's global round index
                # (channel parity must match the fleet's)
                if len(tensors) > 3:
                    rnd = int(np.asarray(tensors[3]).reshape(-1)[0])
                _dcn_round(args, ctx, rnd, stage_layers, stage_quant,
                           stage_ranks, [], [], dtype, results_target,
                           stop_base=stop_base)
                rnd += 1
    print(f"rank={rank} kernel_launches="
          + json.dumps(_launch_delta(launches0), sort_keys=True), flush=True)


def _dcn_round(args, ctx, rnd, stage_layers, stage_quant, stage_ranks,
               ubatches, labels, dtype, results_target,
               stop_base: Optional[int] = None) -> None:
    """One schedule round on a live fleet: (data rank) broadcast the
    schedule, build this rank's stage if it has one, stream the batch,
    stop; (worker) build, run until this round's CMD_STOP. Prints this
    round's kernel launches on this rank."""
    from .comm import dcn
    from .comm import wire

    rank, data_rank = args.rank, args.data_rank
    parity = dcn.CHANNEL_ROUND_PARITY * (rnd % 2)
    if stop_info[0] is not None:
        raise RuntimeError(f"rank {rank}: pipeline aborted: rank "
                           f"{stop_info[0]} died")
    t_round0 = time.monotonic_ns()
    launches0 = dict(_build.launch_counts)
    stop_event.clear()
    if rank == data_rank:
        ctx.cmd_broadcast(CMD_SCHED, [
            np.asarray(stage_layers, np.int32),
            np.asarray(stage_quant, np.int32),
            np.asarray(stage_ranks, np.int32),
            np.asarray(rnd, np.int32)], exclude=ctx.dead_ranks())
    stage = None
    try:
        my_stages = [i for i, r in enumerate(stage_ranks) if r == rank]
        if my_stages:
            assert len(my_stages) == 1, \
                "one stage per rank (reference p2p semantics)"
            stage = build_dcn_stage(args, ctx, rnd, my_stages[0],
                                    stage_layers, stage_quant, stage_ranks,
                                    dtype)
            # fresh beat baseline per round: the inter-round gap is not
            # a microbatch
            monitoring.iteration_reset(MONITORING_KEY_MODEL)
            stage.start()
        else:
            logger.info("rank %d not in schedule; idling", rank)

        if rank == data_rank:
            for lb in labels:
                label_queue.put(lb)
            first_rank, last_rank = stage_ranks[0], stage_ranks[-1]
            try:
                feed_tier = ctx.negotiate_edge_path(
                    first_rank, timeout=min(10.0, args.sched_timeout))
                _EDGE_PATH.set(dcn.PATH_CODES[feed_tier],
                               edge=f"{rank}->{first_rank}:feed")
            except (queue.Empty, OSError) as exc:
                logger.warning("feed edge rank %d->%d: transport-path "
                               "handshake failed (%s); keeping the socket "
                               "path", rank, first_rank, exc)

            def results_loop():
                deadline = time.monotonic() + args.sched_timeout
                for mbid in range(len(ubatches)):
                    # short polls, so an abort is seen within one
                    while not stop_event.is_set():
                        try:
                            tensors, _, tctx = ctx.recv_tensors_traced(
                                last_rank, timeout=0.5,
                                channel=dcn.CHANNEL_RESULTS + parity)
                            break
                        except queue.Empty:
                            if time.monotonic() >= deadline:
                                return
                        except ConnectionError:
                            # the last stage died: the peer-death handler
                            # aborts the run
                            return
                    else:
                        return
                    try:
                        with telemetry.span("results", "deliver", mb=mbid,
                                            rid=tctx.rid if tctx else None):
                            handle_results(wire.wire_decode(
                                tensors, dtype, device="cpu"))
                    except wire.WireCorruptError as exc:
                        dcn.FRAMES_CORRUPT.inc(peer=str(last_rank))
                        logger.error("results: corrupt frame from rank %d "
                                     "(%s); requesting resend", last_rank,
                                     exc)
                        try:
                            ctx.request_resend(
                                last_rank, dcn.CHANNEL_RESULTS + parity)
                        except OSError as rexc:
                            logger.error("resend request to rank %d "
                                         "failed: %s", last_rank, rexc)

            def feed_loop():
                # its own thread: a send backpressured by a stalled
                # pipeline may block, and the main thread must stay free
                # to abort
                try:
                    for mbid, u in enumerate(ubatches):
                        if stop_event.is_set():
                            return
                        tctx = None
                        if telemetry.enabled():
                            tctx = telemetry.TraceContext(
                                f"r{rnd}.mb{mbid}", "batch",
                                parent=f"feed.rank{rank}")
                        with telemetry.span("feed", f"mb{mbid}", mb=mbid,
                                            rid=tctx.rid if tctx else None):
                            ctx.send_tensors(first_rank, [np.asarray(u)],
                                             channel=dcn.CHANNEL_FEED
                                             + parity, trace=tctx)
                except OSError as exc:
                    logger.error("feeding stage rank %d failed (%s)",
                                 first_rank, exc)

            results_thread = threading.Thread(target=results_loop,
                                              daemon=True)
            results_thread.start()
            feed_thread = threading.Thread(target=feed_loop, daemon=True)
            try:
                tik = time.monotonic()
                batch_total = sum(len(u) for u in ubatches)
                results_target[0] += batch_total
                target = results_target[0]
                feed_thread.start()
                deadline = time.monotonic() + args.sched_timeout
                complete = False
                while not complete and time.monotonic() < deadline \
                        and not stop_event.is_set() \
                        and stop_info[0] is None:
                    complete = results_counter.wait_gte(target, timeout=0.5)
                # the last results can land concurrently with an abort
                complete = complete or results_counter.wait_gte(target,
                                                                timeout=0)
                tok = time.monotonic()
            finally:
                # CMD_STOP goes out even on failure, or the workers hang
                # until their own timeouts
                ctx.cmd_broadcast(CMD_STOP)
                stop_event.set()
            # an aborted round's feed may be stuck on a full queue of a
            # stage that stopped pulling: it ends with the context
            results_thread.join(timeout=10 if complete else 1)
            feed_thread.join(timeout=10 if complete else 1)
            if not complete:
                delivered = results_counter.value - (target - batch_total)
                if stop_info[0] is not None:
                    raise RuntimeError(
                        f"pipeline aborted: rank {stop_info[0]} died "
                        f"mid-run ({delivered}/{batch_total} results "
                        "delivered)")
                raise RuntimeError(
                    f"pipeline delivered {delivered}/{batch_total} results "
                    f"within {args.sched_timeout}s")
            print(f"round={rnd} latency_sec={tok - tik:.6f} "
                  f"throughput_items_sec={batch_total / (tok - tik):.3f}")
            _report(tik, tok, ubatches)
        else:
            # this round ends at the first CMD_STOP after its schedule
            # arrived; poll so a locally seen death aborts promptly
            target = (stop_base + 1) if stop_base is not None else rnd + 1
            deadline = time.monotonic() + args.sched_timeout
            stopped = False
            while not stopped and stop_info[0] is None \
                    and time.monotonic() < deadline:
                stopped = stop_counter.wait_gte(target, timeout=0.5)
            if stop_info[0] is not None:
                raise RuntimeError(
                    f"rank {rank}: pipeline aborted: rank "
                    f"{stop_info[0]} died mid-run")
            if not stopped:
                raise RuntimeError(
                    f"rank {rank}: no CMD_STOP within "
                    f"{args.sched_timeout}s; aborting")
    finally:
        telemetry.record("runtime", f"round{rnd}", t_round0,
                         time.monotonic_ns())
        if stage is not None:
            stage.stop()
    print(f"rank={rank} round={rnd} kernel_launches="
          + json.dumps(_launch_delta(launches0), sort_keys=True), flush=True)


def _collect_write_spans(ctx, args) -> None:
    """Gather every live peer's span ring over the command channel
    (clock-aligned, `DistDcnContext.collect_spans`), merge it with this
    rank's and write the Chrome trace to `--trace-spans`. Best-effort: an
    unreachable peer is skipped."""
    rec = telemetry.recorder()
    if rec is None:
        return
    merged = rec.snapshot()
    ranks_seen = 1
    dead = ctx.dead_ranks()
    for dst in range(args.worldsize):
        if dst == args.rank or dst in dead:
            continue
        try:
            spans, offset = ctx.collect_spans(dst, timeout=5.0)
        except Exception as exc:  # noqa: BLE001 - skip unreachable peers
            logger.warning("trace-spans: collection from rank %d failed "
                           "(%s); the trace will omit it", dst, exc)
            continue
        merged.extend(telemetry.align_spans(spans, offset))
        ranks_seen += 1
    chrome_trace.dump_trace(merged, args.trace_spans)
    logger.info("trace-spans: %d span(s) from %d rank(s) -> %s", len(merged),
                ranks_seen, args.trace_spans)


def dcn_schedules(args) -> List[Tuple[List[Tuple[int, int]], List[int],
                                      List[int]]]:
    """The data rank's schedule rounds: ';'-separated -pt/-q/-r values
    (a single value applies to every round), times `--rounds`."""
    rounds = [v.split(";") if v else [None] for v in
              (args.partition, args.quant, args.rank_order)]
    n = max(len(v) for v in rounds)
    hosts = args.hosts.split(",") if args.hosts else None
    out = []
    for i in range(n):
        pt, q, r = (v[i] if len(v) > 1 else v[0] for v in rounds)
        out.append(get_pipeline_sched(
            args.worldsize, hosts, _pairs(pt) if pt else None,
            [int(x) for x in q.split(",")] if q else None,
            [int(x) for x in r.split(",")] if r else None,
            args.model_name, args.ubatch_size, args.sched_models_file,
            args.sched_dev_types_file, args.sched_dev_file,
            dtype=args.dtype))
    return out * max(1, args.rounds)


def main_dcn(args) -> None:
    """`-c dcn`: this process is one rank of the fleet."""
    global _results_sink
    if args.wire_crc:
        # one process-wide switch, read by the transport and the codec
        from .comm.wire import ENV_WIRE_CRC
        os.environ[ENV_WIRE_CRC] = "1"
    is_data = args.rank == args.data_rank
    schedules, ubatches, labels = [], [], []
    if is_data:
        schedules = dcn_schedules(args)
        for x, lb in data_utils.batch_dataset(
                load_dataset(args.model_name, args.batch_size),
                args.ubatch_size):
            ubatches.append(x)
            labels.append(lb)
        if args.save_results:
            _results_sink = []
    window_size = get_window_size()
    monitoring.init(MONITORING_KEY_MODEL, window_size, work_type='items',
                    acc_type='layers')
    monitoring.add_key(MONITORING_KEY_OUTPUT, work_type='classifications',
                       acc_type='correct')
    monitoring.add_key(MONITORING_KEY_SEND, work_type='Mbits')
    monitoring.add_key(MONITORING_KEY_RECV, work_type='Mbits')
    monitoring.add_key(MONITORING_KEY_QUANT_ENCODE, acc_type='bits')
    monitoring.add_key(MONITORING_KEY_QUANT_DECODE, acc_type='bits')
    monitoring.add_key(MONITORING_KEY_LIVENESS, work_type='beats',
                       acc_type='rank')
    monitoring.add_key(MONITORING_KEY_HB_RTT, work_type='ms',
                       acc_type='rank')
    if args.trace_spans:
        telemetry.configure(rank=args.rank)
    trace_dir = (os.path.join(args.trace, f"rank{args.rank}")
                 if args.trace else None)
    try:
        with tracing.trace(trace_dir):
            run_pipeline_dcn(args, schedules, ubatches, labels)
        if _results_sink is not None:
            np.savez(args.save_results, *_results_sink)
            logger.info("saved %d result microbatch(es) to %s",
                        len(_results_sink), args.save_results)
    finally:
        monitoring.finish()


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    args = parse_args(argv)
    if args.comm == "dcn":
        main_dcn(args)
        return
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
