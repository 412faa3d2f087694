"""Pipeline-parallel inference runtime of the port: the host, SPMD and DCN
drivers.

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
run logs the stage-to-layer and stage-to-host mapping it chose. The
single-controller drivers see `worldsize` logical devices (the JAX
runtime's `jax.devices()`), logical device k on `cuda:k % device_count()`
(`parallel/mesh.py devices_for`), so on one card every one is `cuda:0`;
the host driver places stage i on logical device `r_i % worldsize` of
`-r` (default the identity order), round-robin as `runtime.py` does.
`--save-results NPZ` writes every delivered microbatch,
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

The SPMD driver, `-c spmd` (`parallel/spmd.py`), runs a block-aligned
partition as one program over a `(dp, stage[, tp|sp])` mesh of those
logical devices, as `runtime.py -c spmd` does:

    python -m pipeedge_tpu_torch.runtime 0 4 -c spmd \
        -pt 1,12,13,24,25,36,37,48 -q 8,8,8,0
    python -m pipeedge_tpu_torch.runtime 0 8 -c spmd -pt 1,24,25,48 \
        --spmd-dp 2 --spmd-tp 2 [--tp-quant-bits 8]
    python -m pipeedge_tpu_torch.runtime 0 8 -c spmd -m bert-large-uncased \
        -pt 1,48,49,96 --spmd-dp 2 --spmd-sp 2 [--spmd-sp-kind ulysses]

It runs the batch once to warm up and once timed, prints the report
lines, `kernel_launches=` and `edge_bits=`, and under `--tp-quant-bits`
folds the run's quantized-collective tally once (a `quantized
collectives` log line, `collective` spans, the bits counter). The mesh
needs stages x dp x (tp or sp) logical devices; `-r` places stage i at
logical device `r_i % worldsize` (distinct, and only without the dp, tp
and sp axes). A mid-block cut falls back to the host driver with
`runtime.py`'s warning.

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
fleet, each survivor naming the dead rank (`--on-peer-death abort`, the
default). Every rank prints its `kernel_launches=`, per round and in
total.

The DCN driver's fault plane, as in `runtime.py`:

- `--on-peer-death failover`: every frame leads with its global
  microbatch id, and the data rank keeps a ledger of the round
  (`_MicrobatchLedger`: acks by id, delivery in order, exactly once,
  snapshots every `DCN_LEDGER_SNAPSHOT` acks). A stage rank's death ends
  the round; the survivors re-plan (`sched/failover.py`: spare
  substitution keeps the partition, so the replay is bit-identical) and
  the unacknowledged microbatches replay on the new schedule. With no
  spare left the fleet aborts, naming the dead rank.
- `--on-peer-rejoin ignore|spare|heal` (default spare): a restarted rank
  (`DCN_EPOCH` > 0) announces itself with a JOIN; it comes back as an
  idle spare, and under `heal` the pre-failure schedule is restored at
  the next round boundary (the `heal_round=` line).
- `--on-peer-degraded quarantine` (with `--degraded-threshold/-confirm/
  -readmit`): the data rank scores every stage rank at each round
  boundary from the fleet's span digests, heartbeat round trips and send
  retries (`health/scorer.py`) and benches a confirmed straggler
  (`quarantine_rank=`), readmitting it on probation (`readmit_rank=`).

`python -m pipeedge_tpu_torch.chaos_dcn` launches such a fleet with one
fault armed in one rank (`comm/chaos.py`) and times its recovery.

The DCN driver's control loop, as in `runtime.py`: at each round
boundary the data rank pulls every stage rank's span digest once
(`_collect_fleet_digests`) and each consumer reads the window since its
own last look:

- `--rebalance auto` (with `--rebalance-threshold/-cooldown/-confirm`)
  re-solves the partition from the stages' measured service times
  (`sched/rebalance.py`) and re-cuts the remaining rounds (the
  `rebalance_round=` line);
- `--autoscale-ranks auto|advise` (with `--autoscale-min/-max/-confirm/
  -cooldown/-rank-high/-rank-low`) runs `serving/autoscale.py`'s
  controller over pipeline stages: up pressure expands onto idle ranks,
  down pressure contracts the span by one stage and benches a rank (the
  `autoscale_decision` and `autoscale_rank` lines).

Both, and the peer-health scorer, force span recording on every rank.

`--stage-tp N [--tp-quant-bits 4|8]` on every `-c dcn` rank runs each
stage's blocks Megatron tensor-parallel over N shards (`_make_tp_stage`,
`parallel/tensor.py` over a `parallel/mesh.py ShardGroup`): the
pipeline runs over DCN between ranks, tensor parallelism within each
rank, on cards 0..N-1 round-robin (so shards share a one-card host's
card; `--device cpu` puts them on the CPU). Stages must be block-aligned
(the schedulers re-cut at multiples of 4), and `--tp-quant-bits` makes
the two all-reduces of every block the quantized ring of
`ops/qcollectives.py`, whose wire footprint each rank folds into
stage-tagged `collective` spans and `pipeedge_collective_bits_total` at
the end of each round.

The flags of `runtime.py` that this entry does not run are refused at
parse time, each naming the ROADMAP item that ports it (`REFUSED`): the
dataset flags (the real datasets need a download); `--platform` is
refused too (the port's switch is `--device`).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import sys
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
from .telemetry import flight
from .telemetry import metrics as prom
from .utils import data as data_utils
from .utils import quant as quantutil
from .utils import tracing
from .utils.threads import ThreadSafeCounter, make_lock

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
# failover mode state (--on-peer-death failover): ranks announced dead via
# CMD_DEAD or observed locally; deaths accumulate for the whole run
dead_ranks: set = set()
dead_lock = make_lock("runtime.dead")
# rejoined-but-not-healed ranks (guarded by dead_lock): alive spare
# capacity that must NOT silently reclaim its old stage at the next
# round's failover re-plan. --on-peer-rejoin spare keeps ranks here;
# heal clears the bench at the round boundary that restores capacity.
benched_ranks: set = set()
# gray-quarantined ranks (guarded by dead_lock): alive but benched by
# the peer-health plane (--on-peer-degraded quarantine). Kept SEPARATE
# from benched_ranks so a rejoin heal clearing the bench can never
# silently readmit a quarantined straggler; only probation readmission
# (health/scorer.py) removes entries here.
quarantined_ranks: set = set()
# capacity-benched ranks (guarded by dead_lock): alive ranks the capacity
# controller (--autoscale-ranks) parked as spares because the pipeline is
# over-provisioned. Kept apart from benched_ranks and quarantined_ranks so
# a heal or a readmission never re-seats a capacity decision; only the
# controller's own scale-up removes entries here.
autoscaled_ranks: set = set()
# a death landed mid-round: the data rank ends the round, re-schedules over
# the survivors, and replays the unacknowledged microbatches
failover_event = threading.Event()
# elastic membership (--on-peer-rejoin): a confirmed-dead rank passed the
# JOIN admission handshake and is live again. The handler removes it from
# dead_ranks; `_heal_state` carries what the data rank's round loop needs
# to close the capacity loop at the next boundary.
_heal_state: dict = {
    "detect_ns": None,    # first death detection of the open episode
    "rejoin_ns": None,    # admission stamp of the most recent rejoin
    "pre_failure": None,  # schedule running when the episode's death hit
    "pending": False,     # a heal should be attempted at the boundary
}
# --save-results at the dcn data rank: every delivered result, in order
_results_sink: Optional[list] = None
# failover telemetry: monotonic_ns stamps of each death detection, consumed
# by the data rank's recovery span (detection -> replay-round completion)
_failover_detect_ns: List[int] = []

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
_FAILOVER_EVENTS = prom.REGISTRY.counter(
    "pipeedge_failover_events_total",
    "mid-run peer deaths entering the failover path")
_PEER_DEATHS = prom.REGISTRY.counter(
    "pipeedge_peer_deaths_total", "peer deaths observed (any mode)")
_REBALANCE_EVENTS = prom.REGISTRY.counter(
    "pipeedge_rebalance_events_total",
    "accepted telemetry-driven partition rebalances (--rebalance auto)")
_REJOINS = prom.REGISTRY.counter(
    "pipeedge_rejoins_total",
    "peers re-admitted through the JOIN handshake after a confirmed death")
_TTFC = prom.REGISTRY.gauge(
    "pipeedge_time_to_full_capacity_seconds",
    "latest heal episode: first death detection -> partition healed back "
    "to full capacity at a round boundary")
_LEDGER_SNAPSHOTS = prom.REGISTRY.counter(
    "pipeedge_ledger_snapshots_total",
    "microbatch-ledger snapshots taken (bounds failover replay state)")
# the heartbeat RTT percentiles the peer-health scorer reads (q = p50 |
# p99); the frame-integrity counter lives with its verification site in
# comm/dcn.py (`dcn.FRAMES_CORRUPT`)
_HB_RTT = prom.REGISTRY.gauge(
    "pipeedge_heartbeat_rtt_ms",
    "heartbeat round-trip percentiles per peer over the bounded sample "
    "window (q = p50 | p99)")

# `runtime.py` flags this entry refuses, each with the ROADMAP item that
# ports it (so no flag is silently ignored): flag -> (argparse keywords,
# item). Only the dataset flags are left: they need a download
_DATASET = ("A7 small pieces: the real datasets need a download, so the "
            "port runs the synthetic inputs only")
_STR, _SWITCH = {}, {"action": "store_true"}
REFUSED = {
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
                             "round, dcn); the host and spmd drivers place "
                             "stage i on logical device r_i % worldsize")
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
                        help="dcn reaction to a stage rank dying mid-run: "
                             "abort the fleet, or re-schedule over the "
                             "survivors and replay the unacknowledged "
                             "microbatches (pass it to every rank; results "
                             "are exactly-once by microbatch id)")
    parser.add_argument("--on-peer-rejoin", default="spare",
                        choices=["ignore", "spare", "heal"],
                        help="dcn reaction to a confirmed-dead rank passing "
                             "the JOIN handshake (a restarted incarnation "
                             "with a higher DCN_EPOCH): ignore refuses it, "
                             "spare re-admits it as idle capacity for later "
                             "failovers, heal also restores the pre-failure "
                             "schedule at the next round boundary")
    parser.add_argument("--on-peer-degraded", default="ignore",
                        choices=["ignore", "quarantine"],
                        help="dcn reaction to a gray-failing peer (alive, "
                             "but its health score confirmed a straggler): "
                             "ignore scores only; quarantine benches it at "
                             "the next round boundary (its stage moves to a "
                             "spare, no replay) and readmits it on "
                             "probation. Forces span recording on; pass it "
                             "to every rank")
    parser.add_argument("--degraded-threshold", type=float, default=0.4,
                        help="health score at which a rank turns suspect "
                             "(the readmit threshold is half of it)")
    parser.add_argument("--degraded-confirm", type=int, default=2,
                        help="consecutive bad windows after the suspect "
                             "entry before quarantine")
    parser.add_argument("--degraded-readmit", type=int, default=2,
                        help="consecutive recovered windows before a "
                             "quarantined rank readmits on probation")
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
                        help="auto, dcn: the data rank re-solves the layer "
                             "partition at each round boundary from the "
                             "stages' measured service times (span "
                             "digests) and applies it with the next "
                             "CMD_SCHED; pass it to every rank. auto, "
                             "host: between measure rounds, adapt the "
                             "microbatch size to the measured steady-state "
                             "stage time vs fill/drain overhead")
    parser.add_argument("--rebalance-threshold", type=float, default=0.10,
                        help="least predicted relative bottleneck gain "
                             "before a re-partition is applied")
    parser.add_argument("--rebalance-cooldown", type=int, default=1,
                        help="full rounds to wait after a rebalance before "
                             "considering another")
    parser.add_argument("--rebalance-confirm", type=int, default=1,
                        help="extra consecutive windows that must blame the "
                             "same bottleneck stage before a re-partition "
                             "(0 = act on the first actionable window)")
    parser.add_argument("--autoscale-ranks", default="off",
                        choices=["off", "advise", "auto"],
                        help="dcn: closed-loop capacity control over the "
                             "partition at round boundaries "
                             "(serving/autoscale.py's controller): up "
                             "pressure expands onto idle ranks "
                             "(sched/failover.py plan_rejoin), down "
                             "pressure contracts the span by one stage and "
                             "benches the rank with the fewest layers. "
                             "advise logs decisions without acting; auto "
                             "acts (needs --on-peer-death failover). Data "
                             "rank drives; forces span recording on")
    parser.add_argument("--autoscale-min", type=int, default=2,
                        help="stage-count floor the controller never "
                             "contracts below")
    parser.add_argument("--autoscale-max", type=int, default=0,
                        help="stage-count ceiling (0 = world size)")
    parser.add_argument("--autoscale-confirm", type=int, default=2,
                        help="consecutive same-direction measured windows "
                             "before a capacity decision")
    parser.add_argument("--autoscale-cooldown", type=float, default=0.0,
                        help="seconds between capacity decisions "
                             "(reversals double it)")
    parser.add_argument("--autoscale-rank-high", type=float, default=0.75,
                        help="bottleneck stage service seconds per "
                             "microbatch that count as up pressure")
    parser.add_argument("--autoscale-rank-low", type=float, default=0.05,
                        help="bottleneck service seconds below which the "
                             "pipeline counts as over-provisioned")
    parser.add_argument("--spmd-dp", type=int, default=1,
                        help="data-parallel mesh axis for the spmd driver "
                             "(devices needed = stages x dp x (tp or sp))")
    parser.add_argument("--spmd-tp", type=int, default=1,
                        help="Megatron tensor-parallel mesh axis for the "
                             "spmd driver: blocks stage-sharded AND "
                             "tp-sharded in one program")
    parser.add_argument("--spmd-sp", type=int, default=1,
                        help="sequence-parallel mesh axis for the spmd "
                             "driver: activations sequence-sharded, exact "
                             "ring attention per block (long-context "
                             "pipelines); exclusive with --spmd-tp")
    parser.add_argument("--spmd-sp-kind", default="ring",
                        choices=["ring", "ulysses"],
                        help="sp attention core: K/V ring rotation or "
                             "Ulysses all-to-all head resharding")
    parser.add_argument("--stage-tp", type=int, default=1,
                        help="shard each dcn stage's blocks Megatron-style "
                             "over N shards (block-aligned stages): "
                             "pipeline across ranks over DCN, tensor "
                             "parallelism within each rank (the shards "
                             "share the cards round-robin)")
    parser.add_argument("--tp-quant-bits", type=int, default=0,
                        choices=[0, 8, 4],
                        help="bitwidth of the intra-stage TP collectives "
                             "(EQuARX-style quantized all-reduce, "
                             "ops/qcollectives.py): 0 = exact all-reduce; "
                             "8/4 = block-scaled int8/int4 ring collectives "
                             "with an f32 accumulator. Gates every "
                             "tensor.py psum site (--spmd-tp, --stage-tp) "
                             "and the sequence-parallel gather "
                             "(--spmd-sp)")
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
                             "aliases), spmd (one program over a dp x stage "
                             "x tp|sp mesh, block-aligned) or dcn (one "
                             "process per rank)")
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
    dcn = args.comm == "dcn"
    # runtime.py's driver-mode and composition errors, word for word and
    # in its order
    if args.stage_ckpt and not dcn:
        parser.error("--stage-ckpt is a dcn-mode option (per-rank restore); "
                     "single-controller drivers load via -M/--model-file")
    if args.rank != 0 and not dcn:
        return args             # main() warns and returns, exit 0
    n_rounds = max(len(v.split(";")) for v in
                   (args.partition or "", args.quant or "",
                    args.rank_order or ""))
    if n_rounds > 1 and not dcn:
        parser.error("';'-separated re-schedule rounds require --comm dcn")
    if args.rounds < 1:
        parser.error("--rounds must be >= 1")
    if args.rounds > 1:
        if not dcn:
            parser.error("--rounds requires --comm dcn (use "
                         "--measure-rounds for the host driver)")
        if n_rounds > 1:
            parser.error("--rounds cannot combine with ';'-separated "
                         "re-schedule rounds (pick one)")
    pt_rounds = args.partition.split(";") if args.partition else [None]
    if args.rebalance == "auto":
        if args.comm == "spmd":
            parser.error("--rebalance auto applies to the dcn driver "
                         "(partition re-solve) and the host driver "
                         "(adaptive microbatching), not spmd")
        if len(set(pt_rounds)) > 1:
            # rounds must repeat the same workload: a re-cut would
            # silently overwrite deliberately distinct partitions
            parser.error("--rebalance auto cannot combine with distinct "
                         "';'-separated partitions")
        if args.stage_ckpt:
            parser.error("--rebalance auto cannot combine with "
                         "--stage-ckpt (the checkpoint manifest pins the "
                         "partition)")
        if dcn and args.rounds == 1 and n_rounds == 1:
            parser.error("--rebalance auto needs round boundaries to "
                         "re-plan at: pass --rounds N (or ';'-separated "
                         "schedule rounds)")
    if args.on_peer_degraded == "quarantine":
        if not dcn:
            parser.error("--on-peer-degraded quarantine applies to the "
                         "dcn driver (per-process ranks)")
        if args.rounds == 1 and n_rounds == 1:
            parser.error("--on-peer-degraded quarantine acts at round "
                         "boundaries: pass --rounds N (or ';'-separated "
                         "schedule rounds)")
    if args.autoscale_ranks != "off":
        if not dcn:
            parser.error("--autoscale-ranks applies to the dcn driver "
                         "(per-process ranks)")
        if args.rounds == 1 and n_rounds == 1:
            parser.error("--autoscale-ranks acts at round boundaries: "
                         "pass --rounds N (or ';'-separated schedule "
                         "rounds)")
        if args.autoscale_ranks == "auto" \
                and args.on_peer_death != "failover":
            parser.error("--autoscale-ranks auto needs --on-peer-death "
                         "failover: a planned bench rides the failover "
                         "re-plan cascade (advise mode only observes)")
        if args.autoscale_min < 1:
            parser.error("--autoscale-min must be >= 1")
        if args.autoscale_confirm < 1:
            parser.error("--autoscale-confirm must be >= 1")
    has_tp_sites = (args.stage_tp > 1
                    or (args.comm == "spmd"
                        and (args.spmd_tp > 1 or args.spmd_sp > 1)))
    if args.tp_quant_bits and not has_tp_sites:
        parser.error("--tp-quant-bits gates intra-stage TP/SP "
                     "collectives, but no TP axis is active: pass "
                     "--spmd-tp/--spmd-sp > 1 (--comm spmd) or "
                     "--stage-tp > 1 (--comm dcn)")
    if args.stage_tp > 1 and not dcn:
        parser.error("--stage-tp requires --comm dcn (per-rank local TP; "
                     "use the spmd driver's mesh axes for single-controller "
                     "tp)")
    if args.stage_tp > 1:
        # at parse time, not mid-round after the schedule broadcast (a
        # late failure on one rank strands the rest of the fleet)
        cfg = registry.get_model_config(args.model_name)
        if cfg.num_attention_heads % args.stage_tp \
                or cfg.intermediate_size % args.stage_tp \
                or cfg.kv_heads % args.stage_tp:
            parser.error(
                f"--stage-tp {args.stage_tp} must divide attention heads "
                f"({cfg.num_attention_heads}), kv heads ({cfg.kv_heads}), "
                f"and intermediate size ({cfg.intermediate_size}) of "
                f"{args.model_name}")
        for spec in pt_rounds:
            if not spec:
                continue
            nums = [int(x) for x in spec.split(',')]
            for l, r in zip(nums[::2], nums[1::2]):
                if (l - 1) % 4 or r % 4:
                    parser.error(f"--stage-tp requires block-aligned "
                                 f"stages; [{l}, {r}] cuts mid-block")
    if dcn:
        if not 0 <= args.rank < args.worldsize:
            parser.error(f"rank {args.rank} is outside the world of "
                         f"{args.worldsize}")
        if not 0 <= args.data_rank < args.worldsize:
            parser.error(f"-D {args.data_rank} is outside the world of "
                         f"{args.worldsize}")
        for opt, spec in (("-pt", args.partition), ("-q", args.quant),
                          ("-r", args.rank_order)):
            k = len(spec.split(";")) if spec else 1
            if 1 < k != n_rounds:
                parser.error(f"{opt}: {k} ';'-rounds given but {n_rounds} "
                             f"rounds defined; give 1 or {n_rounds}")
    if args.dataset_name != "synthetic":
        parser.error(f"--dataset-name {args.dataset_name} needs a download "
                     "(the dataset, and its tokenizer or image processor); "
                     "the port runs the synthetic inputs only")
    if args.rebalance == "auto" and not dcn and args.measure_rounds <= 1:
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


def _schedule(args) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """The run's stage layers, stage output bits and stage ranks, from the
    CLI."""
    stage_layers, stage_quant, stage_ranks = get_pipeline_sched(
        args.worldsize, args.hosts.split(",") if args.hosts else None,
        _pairs(args.partition) if args.partition else None,
        [int(q) for q in args.quant.split(",")] if args.quant else None,
        [int(r) for r in args.rank_order.split(",")]
        if args.rank_order else None,
        args.model_name, args.ubatch_size, args.sched_models_file,
        args.sched_dev_types_file, args.sched_dev_file, dtype=args.dtype)
    return stage_layers, stage_quant, stage_ranks


def logical_devices(args) -> List[torch.device]:
    """The single-controller drivers' devices: `worldsize` logical ones,
    the k-th on `cuda:k % device_count()` (or the CPU), as `jax.devices()`
    lists the JAX runtime's."""
    from .parallel.mesh import devices_for
    return devices_for(args.worldsize, resolve_device(args.device))


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
                      stage_quant: Sequence[int],
                      stage_ranks: Optional[Sequence[int]] = None) -> dict:
    """Build the pipeline, stream the batch `--measure-rounds` times under
    the open monitoring session and print the report lines; returns the
    last round's stats. Stage i runs on logical device `stage_ranks[i] %
    worldsize` (`logical_devices`; default the identity order). With
    `--rebalance auto` the batch is re-split between rounds
    (`adapt_microbatches`); with `--save-results` every delivered
    microbatch of every round is saved, in delivery order."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    devices = logical_devices(args)
    ranks = stage_ranks or range(len(stage_layers))
    placed = [devices[r % len(devices)] for r in ranks]
    logger.info("Scheduling: stage-to-device placement: %s",
                [str(d) for d in placed])
    pipe = host_pipeline.build_pipeline(
        args.model_name, stage_layers, model_file=args.model_file,
        devices=placed, quant_bits=stage_quant, dtype=dtype)
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


def run_pipeline_spmd(args, stage_layers: Sequence[Tuple[int, int]],
                      stage_quant: Sequence[int],
                      stage_ranks: Sequence[int]) -> None:
    """`-c spmd`: the block-aligned partition as one `SpmdPipeline` over a
    `(dp, stage[, tp|sp])` mesh of the logical devices, with the JAX
    driver's checks and messages. Runs the batch once to warm up and once
    timed, reports, prints `kernel_launches=` and `edge_bits=`, and folds
    the quantized-collective tally once."""
    from .ops import qcollectives
    from .parallel import spmd
    from .parallel import tensor as tp

    entry = registry.get_model_entry(args.model_name)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    n_stages = len(stage_layers)
    # conflict checks on the raw arguments, before any stage weights load
    if stage_ranks and list(stage_ranks) != list(range(n_stages)) \
            and (args.spmd_dp > 1 or args.spmd_tp > 1 or args.spmd_sp > 1):
        raise RuntimeError("-r stage ranks cannot combine with "
                           "--spmd-dp/--spmd-tp/--spmd-sp mesh axes")
    if args.spmd_tp > 1 and args.spmd_sp > 1:
        raise RuntimeError("--spmd-tp and --spmd-sp are mutually exclusive "
                           "(Megatron TP assumes a full local sequence)")
    need = n_stages * args.spmd_dp * max(args.spmd_tp, args.spmd_sp)
    devices = logical_devices(args)
    have = len(devices)
    if need > have:
        raise RuntimeError(
            f"mesh needs {need} devices (stages x dp x tp|sp = "
            f"{n_stages} x {args.spmd_dp} x "
            f"{max(args.spmd_tp, args.spmd_sp)}) but only {have} available")
    ranks = None
    if stage_ranks and list(stage_ranks) != list(range(n_stages)):
        mapped = [r % len(devices) for r in stage_ranks]
        if len(set(mapped)) != n_stages:
            raise RuntimeError(
                f"-r stage ranks {list(stage_ranks)} map to non-distinct "
                f"devices {mapped} on {len(devices)} available devices; "
                "spmd mode needs one distinct device per stage (drop -r "
                "for the default identity order)")
        ranks = mapped
    mesh = spmd.make_pipeline_mesh(n_stages, dp=args.spmd_dp,
                                   tp=args.spmd_tp, sp=args.spmd_sp,
                                   devices=devices, stage_ranks=ranks)
    logger.info("SPMD mesh %s at logical devices %s", mesh.shape,
                mesh.positions)
    qcollectives.reset_trace_tally()
    stage_params = [registry.module_shard_factory(
        args.model_name, args.model_file, l, r, stage=i, dtype=dtype,
        device=mesh.cell(0, i).devices[0])[1]
        for i, (l, r) in enumerate(stage_layers)]
    pipe = spmd.build_spmd_pipeline(
        entry.family.FAMILY, entry.config, stage_layers, stage_params, mesh,
        quant_bit=list(stage_quant) if stage_quant else 0,
        sp_kind=args.spmd_sp_kind)
    inputs, labels = load_batches(args.model_name, args.batch_size,
                                  args.ubatch_size,
                                  mesh.cell(0, 0).devices[0], dtype)
    stacked = torch.stack(inputs)
    for lb in labels:
        label_queue.put(lb)
    # one process-wide switch, read by every TP block's all-reduce and
    # the sp gather: set for this run, the caller's value restored after
    prev_bits = tp.get_tp_quant_bits()
    tp.set_tp_quant_bits(args.tp_quant_bits)
    try:
        pipe.run(stacked).cpu()  # warm-up (the kernel build, cuBLAS)
        tik = time.monotonic()
        outputs = pipe.run(stacked).cpu()
        tok = time.monotonic()
    finally:
        tp.set_tp_quant_bits(prev_bits)
    for out in outputs:
        handle_results(out)
    _report(tik, tok, inputs)
    if args.tp_quant_bits:
        # every call of this run (warm-up included) was tallied as it ran
        summary = qcollectives.record_collectives()
        logger.info("quantized collectives (--tp-quant-bits %d): %s",
                    args.tp_quant_bits, summary)
    if args.save_results:
        np.savez(args.save_results,
                 *[o.detach().float().numpy() for o in outputs])
        logger.info("saved %d result microbatch(es) to %s", len(outputs),
                    args.save_results)
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    print("edge_bits=" + json.dumps(list(pipe.stage_bits[:-1])))


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
        # a failover announcement (--on-peer-death failover) from the
        # survivor that saw the death first, a port rank or a JAX rank
        dead = int(np.asarray(tensors[0]))
        logger.warning("handle_cmd: rank %d announced dead (failover)", dead)
        with dead_lock:
            known = dead in dead_ranks
            dead_ranks.add(dead)
        if not known:
            # every survivor may broadcast the same death; count the event
            # once and stamp detection once, or the failover metrics and
            # spans multiply by the fleet size
            _record_failover_detect(dead)
        failover_event.set()
        monitoring.flush()
    else:
        logger.warning("handle_cmd: Unknown command: %s", cmd)


def _record_failover_detect(dead: int, failover: bool = True) -> None:
    """First-observation bookkeeping for a peer death: one detect span,
    one detection stamp (the recovery span's start), one death count —
    callers dedupe against dead_ranks (or stop_info) before calling.
    `failover=False` (abort path) skips the failover-event counter."""
    now = time.monotonic_ns()
    telemetry.record("failover", "detect", now, now)
    flight.note("peer_death", dead_rank=dead, failover=failover)
    _failover_detect_ns.append(now)
    if _heal_state["detect_ns"] is None:
        # anchor of the time-to-full-capacity clock: the FIRST detection
        # of the episode a later heal closes
        _heal_state["detect_ns"] = now
    _PEER_DEATHS.inc(peer=str(dead))
    if failover:
        _FAILOVER_EVENTS.inc()


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


def _stage_align(args) -> int:
    """The granularity, in sublayers, of every cut the schedulers make at
    run time: whole blocks (4) under --stage-tp, else any sublayer."""
    return 4 if args.stage_tp > 1 else 1


def _make_tp_stage(args, l: int, r: int, stage: int, dtype, restored,
                   device):
    """Stage [l, r] with its blocks Megatron-TP-split over `--stage-tp`
    shards on this rank (`runtime.py _make_tp_stage`): pipeline over DCN
    across ranks, tensor parallelism within the rank. The shards sit on
    `device`'s kind, cards round-robin (`parallel/mesh.py devices_for`).

    Returns `(fn, params, group)` with the stage's `fn(params, payload)`
    convention; the split block params live in the closure, so `params`
    is empty. The payload enters on shard 0's device and the output is
    shard 0's."""
    from .models.shard import params_to
    from .parallel import tensor as tp
    from .parallel.mesh import ShardGroup, devices_for

    n_tp = args.stage_tp
    entry = registry.get_model_entry(args.model_name)
    cfg = entry.config
    if cfg.num_attention_heads % n_tp or cfg.intermediate_size % n_tp \
            or cfg.kv_heads % n_tp:
        raise RuntimeError(
            f"--stage-tp {n_tp} must divide attention heads "
            f"({cfg.num_attention_heads}), kv heads ({cfg.kv_heads}), "
            f"and intermediate size ({cfg.intermediate_size})")
    if (l - 1) % 4 or r % 4:
        raise RuntimeError(f"--stage-tp requires block-aligned stages; "
                           f"[{l}, {r}] cuts mid-block")
    group = ShardGroup(devices_for(n_tp, device))
    # the whole stage stays on the host; each block is split onto the
    # shards and dropped, so the card holds only the shards
    _, params, shard_cfg = registry.module_shard_factory(
        args.model_name, args.model_file, l, r, stage=stage, dtype=dtype,
        device="cpu", params=restored)
    block_fn = tp.make_tp_block_fn(cfg, group)
    blocks = list(params.get("blocks", ()))
    params["blocks"] = None
    sharded_blocks = []
    for b, bp in enumerate(blocks):
        sharded_blocks.append(tp.shard_block_params(cfg, bp, group))
        blocks[b] = None
    family = entry.family.FAMILY
    root = group.devices[0]
    embed_p = (params_to(params["embeddings"], device=root)
               if shard_cfg.is_first else None)
    final_p = (params_to(params["final"], device=root)
               if shard_cfg.is_last else None)
    logger.info("stage %d: %d block(s) TP-split over %d shards on %s",
                stage, len(sharded_blocks), n_tp,
                ", ".join(str(d) for d in group.devices))

    @torch.inference_mode()
    def stage_fn(_params, x):
        if shard_cfg.is_first:
            x = family.embed(embed_p, x, cfg)
        xs = group.replicate(x)
        for bp in sharded_blocks:
            xs = block_fn(bp, xs)
        x = xs[0]
        if shard_cfg.is_last:
            x = family.finalize(final_p, x, cfg)
        return x

    return stage_fn, {}, group


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
    (`local` hands the device tensors to a consumer in this process).
    Under `--on-peer-death failover` every frame leads with its global
    microbatch id: dispatch strips it, readback puts it back in front."""
    from .comm import dcn
    from .comm import wire

    rank, data_rank = ctx.rank, args.data_rank
    failover_mode = args.on_peer_death == "failover"
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
    if args.stage_tp > 1:
        fn, params, group = _make_tp_stage(args, l, r, i, dtype, restored,
                                           device)
        # the stage's input enters on shard 0's device
        device = group.devices[0]
    else:
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
    # this round's quantized TP collectives, folded after each microbatch
    # into stage-tagged spans (recorded before the microbatch's result can
    # reach the data rank, so a span collection at the end of the run
    # finds them) and summed here for the round's log line
    tp_fold = ({"calls": 0, "wire_bits_total": 0, "raw_bits_total": 0}
               if args.stage_tp > 1 and args.tp_quant_bits else None)

    def dispatch_cb(tensors):
        mbid = None
        if failover_mode:
            # the id never enters the stage: stripped here, put back in
            # front of the output frame by readback
            mbid, tensors = tensors[0], tensors[1:]
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
            mb = _mbid_of(mbid) if mbid is not None else mb_seq[0]
            mb_seq[0] += 1
            if guard_on:
                payload = nan_guard.check_finite(payload,
                                                 where=f"stage{i}/input",
                                                 mb=mb)
            with telemetry.span("compute", f"stage{i}", stage=i, mb=mb):
                out = fn(params, payload)
                if tp_fold is not None:
                    from .ops import qcollectives
                    summary = qcollectives.record_collectives(stage=i)
                    qcollectives.reset_trace_tally()
                    for key in tp_fold:
                        tp_fold[key] += summary[key]
                pending = wire.wire_encode_device(
                    out, edge.quant_bit if edge is not None else 0,
                    crc=wire_crc)
        first = out[0] if isinstance(out, tuple) else out
        # the raw output rides the hand-off queue only when the adaptive
        # policy reads it (it would pin `depth` microbatches otherwise)
        return (pending, out if adaptive is not None else None,
                int(first.shape[0]), mbid)

    def readback_cb(item):
        pending, out, n_items, mbid = item
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
        if mbid is not None:
            # a 0-d host array, as the data rank sent it
            tagged = [np.asarray(mbid)] + list(frame)
            frame = (wire.DeviceFrame(tagged, frame.event)
                     if isinstance(frame, wire.DeviceFrame) else tagged)
        return frame

    stage = dcn.DcnPipelineStage(
        ctx, rank_src, rank_dst, dispatch_cb=dispatch_cb,
        readback_cb=readback_cb, stage=i,
        # failover frames lead with the global microbatch id: the stage's
        # spans carry it, so a replay traces under the same id
        mb_of=(lambda ts: _mbid_of(ts[0])) if failover_mode else None,
        depth=args.stage_depth or None,
        recv_channel=(dcn.CHANNEL_FEED if is_first
                      else dcn.CHANNEL_DATA) + parity,
        send_channel=(dcn.CHANNEL_RESULTS if is_last
                      else dcn.CHANNEL_DATA) + parity)
    stage.tp_collectives = tp_fold
    return stage


ENV_LEDGER_SNAPSHOT = "DCN_LEDGER_SNAPSHOT"  # acks between ledger
# snapshots (0 disables). Each snapshot compacts acknowledged microbatch
# payloads out of the ledger and advances the replay frontier, so a
# failover replays from the last snapshot's frontier — O(unacknowledged)
# work and memory — instead of rescanning (and holding) the whole round.
DEFAULT_LEDGER_SNAPSHOT = 8


class _MicrobatchLedger:
    """Bounded in-flight ledger for the data rank (failover mode): every
    microbatch is registered with its id before dispatch, acknowledged when
    its result frame lands, and REPLAYED (same id) after a failover if no
    acknowledgment arrived. Duplicate results — a replay overlapping a
    frame that was already in flight when the stage died, or a transient
    resend — are dropped by id, and delivery to `handle_results` is held
    until contiguous, so the result stream at the data rank is exactly-once
    and in microbatch order regardless of arrival order (`runtime.py
    _MicrobatchLedger`).

    Snapshots (`maybe_snapshot`, every `snapshot_every` acks) keep the
    failover replay O(in-flight) instead of O(round): acknowledged
    payloads are dropped (they can never be refed — an ack is final) and
    the replay frontier advances past the acked prefix, so `pending()`
    after a mid-round death scans and ships only the microbatches that
    genuinely need replaying from the last snapshot on.

    An acknowledged result is kept as given until its turn to be
    delivered: the caller hands over a host copy the ledger owns, never a
    view of a pooled receive buffer or of recycled staging memory."""

    def __init__(self, ubatches, labels, snapshot_every: Optional[int] = None):
        self._ubatches = list(ubatches)
        self._labels = (list(labels) if labels
                        else [None] * len(self._ubatches))
        self._snapshot_every = (snapshot_every if snapshot_every is not None
                                else int(os.getenv(
                                    ENV_LEDGER_SNAPSHOT,
                                    str(DEFAULT_LEDGER_SNAPSHOT))))
        self._acks_since_snapshot = 0
        self._frontier = 0        # lowest possibly-unacked microbatch id
        self.snapshots = 0        # snapshots taken (tests/metrics)
        # mbid -> epoch of the incarnation whose result was accepted: the
        # dedupe key carries the epoch, so forensics (and tests) can tell
        # a same-incarnation resend from a stale-incarnation replay
        self._acked: dict = {}
        self._held: dict = {}       # acked but not yet contiguous
        self._next_deliver = 0
        # per-source epoch floor (fence_rank): an ack produced by an
        # incarnation below the floor is stale and refused — the transport
        # already fences these at the reader; this is the ledger's own
        # belt-and-braces (a stale frame must NEVER ack a microbatch)
        self._epoch_floor: dict = {}
        self.stale_dropped = 0
        # request <-> microbatch mapping: the feed loop records each
        # microbatch's trace/request id here, so a postmortem bundle can
        # resolve a request to its microbatches (and back) after the fact
        self._traces: dict = {}
        self._lock = make_lock("runtime.ledger")
        self.done = threading.Event()
        if not self._ubatches:
            self.done.set()

    def record_trace(self, mbid: int, rid: str) -> None:
        """Bind microbatch `mbid` to request id `rid` (feed time)."""
        with self._lock:
            self._traces[int(mbid)] = str(rid)

    def trace_of(self, mbid: int) -> Optional[str]:
        with self._lock:
            return self._traces.get(int(mbid))

    def forensics(self) -> dict:
        """The ledger slice of a failover postmortem bundle: progress,
        the replay set, and the request ids in flight when it was taken
        (ids only — payloads stay out of the bundle)."""
        with self._lock:
            pending = [i for i in range(self._frontier,
                                        len(self._ubatches))
                       if i not in self._acked]
            return {"microbatches": len(self._ubatches),
                    "acked": len(self._acked),
                    "pending_mbids": pending,
                    "frontier": self._frontier,
                    "snapshots": self.snapshots,
                    "stale_dropped": self.stale_dropped,
                    "next_deliver": self._next_deliver,
                    "traces": {str(k): v
                               for k, v in sorted(self._traces.items())}}

    @property
    def acked_count(self) -> int:
        with self._lock:
            return len(self._acked)

    def pending(self) -> List[Tuple[int, np.ndarray]]:
        """(microbatch id, ubatch) pairs not yet acknowledged — what the
        feed loop sends, and after a failover, exactly the replay set.
        The scan starts at the snapshot frontier: everything below it was
        acked (and compacted away) by the last snapshot."""
        with self._lock:
            return [(i, self._ubatches[i])
                    for i in range(self._frontier, len(self._ubatches))
                    if i not in self._acked]

    def maybe_snapshot(self) -> bool:
        """Count an ack toward the snapshot cadence; snapshot when due.
        Called by the results loop after every accepted ack (cheap: a
        counter bump between snapshots)."""
        if self._snapshot_every <= 0:
            return False
        with self._lock:
            self._acks_since_snapshot += 1
            if self._acks_since_snapshot < self._snapshot_every:
                return False
            self._snapshot_locked()
        _LEDGER_SNAPSHOTS.inc()
        return True

    def snapshot(self) -> None:
        """Compact now (see `maybe_snapshot` for the periodic form)."""
        with self._lock:
            self._snapshot_locked()
        _LEDGER_SNAPSHOTS.inc()

    def _snapshot_locked(self) -> None:
        # an acked payload is never refed (acks are final even across
        # failovers — replay covers only unacked ids), so drop it and
        # advance the frontier past the acked prefix: replay work and
        # ledger memory both become O(unacknowledged since snapshot)
        for i in range(self._frontier, len(self._ubatches)):
            if i in self._acked:
                self._ubatches[i] = None
        while self._frontier < len(self._ubatches) \
                and self._frontier in self._acked:
            self._frontier += 1
        self._acks_since_snapshot = 0
        self.snapshots += 1

    def acked_epochs(self) -> dict:
        """mbid -> producing incarnation's epoch, for every accepted ack."""
        with self._lock:
            return dict(self._acked)

    def fence_rank(self, src: int, min_epoch: int) -> None:
        """Refuse acks from `src` incarnations below `min_epoch` (mirrors
        the transport fence, `DistDcnContext.min_epoch_of`)."""
        with self._lock:
            self._epoch_floor[src] = max(self._epoch_floor.get(src, 0),
                                         int(min_epoch))

    def ack(self, mbid: int, out, epoch: int = 0,
            src: Optional[int] = None) -> bool:
        """Acknowledge microbatch `mbid`'s result; False for a duplicate
        or a stale-incarnation ack (both dropped). Results are surfaced
        through `handle_results` in id order so the label queue and
        accuracy bookkeeping stay aligned."""
        deliver = []
        with self._lock:
            if src is not None and epoch < self._epoch_floor.get(src, 0):
                self.stale_dropped += 1
                return False
            if mbid in self._acked or not 0 <= mbid < len(self._ubatches):
                return False
            self._acked[mbid] = int(epoch)
            self._held[mbid] = out
            while self._next_deliver in self._held:
                i = self._next_deliver
                deliver.append((self._labels[i], self._held.pop(i)))
                self._next_deliver += 1
            complete = len(self._acked) == len(self._ubatches)
        for label, result in deliver:
            if label is not None:
                label_queue.put(label)
            handle_results(result)
        if complete:
            self.done.set()
        return True


def _collect_fleet_digests(ctx, args, stage_ranks):
    """Pull every stage rank's CUMULATIVE span digest over the command
    channel once (kilobytes; `DistDcnContext.collect_digest`), at a round
    boundary. Returns `{rank: digest}`, or None when any rank is dead or
    unreachable (the whole window is unmeasurable — partial snapshots
    must not advance anyone's baseline)."""
    with dead_lock:
        gone = set(dead_ranks)
    out = {}
    for src in sorted(set(stage_ranks)):
        if src == args.rank:
            rec = telemetry.recorder()
            out[src] = rec.digest() if rec is not None else {}
        elif src in gone:
            logger.info("telemetry window: rank %d is dead; skipping "
                        "this round", src)
            return None
        else:
            try:
                out[src] = ctx.collect_digest(src, timeout=10.0)
            except Exception as exc:  # noqa: BLE001 - any peer hiccup
                logger.warning("telemetry window: digest collection from "
                               "rank %d failed (%s)", src, exc)
                return None
    return out


def _estimates_from_digests(cur_digests, sched, prev_digests: dict,
                            min_samples: int = 2):
    """One consumer's measured window: difference a fleet digest
    snapshot against `prev_digests` (the caller-owned baselines, which
    advance here — every rank's, atomically, so windows always cover one
    time span) and decompose into per-stage service estimates
    (telemetry/feedback.py). Returns the estimates dict, or None when
    the snapshot is absent or fails the self-test."""
    from .telemetry import feedback

    if cur_digests is None:
        return None
    stage_layers = sched[0]
    windows = [feedback.diff_digests(cur, prev_digests.get(src, {}))
               for src, cur in cur_digests.items()]
    prev_digests.update(cur_digests)
    est = feedback.stage_estimates(feedback.merge_digests(windows))
    problems = feedback.check_estimates(est, len(stage_layers),
                                        min_samples=min_samples)
    if problems:
        logger.info("telemetry window failed the self-test (%s)",
                    "; ".join(problems))
        return None
    return est


def _consider_rebalance(ctx, args, policy, sched, prev_digests: dict,
                        rnd: int, cur_digests=None):
    """One closed-loop decision at a round boundary (data rank only, as
    `runtime.py _consider_rebalance`): measure this round's window from
    the boundary's shared digest snapshot and ask the policy
    (`sched/rebalance.py`) whether re-solving the partition with the
    measured profile is worth a re-schedule. Returns the accepted
    Proposal or None; an unmeasurable round keeps the partition."""
    stage_layers = sched[0]
    t0 = time.monotonic_ns()
    # cur_digests None: the boundary's one shared sweep already failed,
    # fleet-wide, so no second sweep here
    est = _estimates_from_digests(cur_digests, sched, prev_digests)
    if est is None:
        logger.info("rebalance: no measurable window; keeping partition")
        return None
    proposal = policy.consider(list(stage_layers), est, rnd)
    now = time.monotonic_ns()
    telemetry.record("rebalance", "plan", t0, now)
    if proposal is None:
        return None
    # one instant per accepted re-partition: the span report's
    # `rebalance_events` counts these
    telemetry.record("rebalance", "apply", now, now)
    _REBALANCE_EVENTS.inc()
    logger.warning("rebalance: round %d partition %s -> %s (predicted "
                   "bottleneck %.4fs -> %.4fs, gain %.1f%%)", rnd,
                   list(stage_layers), proposal.partition,
                   proposal.bottleneck_before_s,
                   proposal.bottleneck_after_s, 100 * proposal.gain)
    # machine-parseable line
    print(f"rebalance_round={rnd} "
          f"partition={','.join(f'{l},{r}' for l, r in proposal.partition)} "
          f"predicted_gain={proposal.gain:.4f}", flush=True)
    return proposal


def _consider_autoscale(ctx, args, a_state: dict, sched, schedules,
                        sched_idx: int, world_size: int, rnd: int,
                        cur_digests=None) -> None:
    """One capacity decision at a round boundary (data rank only, as
    `runtime.py _consider_autoscale`; `--autoscale-ranks`). The engine is
    `serving/autoscale.py`'s CapacityController, its unit pipeline
    stages. The signal is the boundary's shared digest window as
    per-stage service estimates: up pressure when the bottleneck stage's
    service time per microbatch reaches `--autoscale-rank-high`, down
    pressure at or below `--autoscale-rank-low`.

    Scale-up is a planned rejoin: `plan_rejoin(sched, None, ...)` expands
    onto idle ranks, capacity-benched ones included, written over the
    remaining rounds. Scale-down contracts the span over one stage fewer
    and drops the rank carrying the fewest layers (never the data rank)
    into `autoscaled_ranks`, so later failover re-plans keep it benched;
    a contraction that cannot run renders as a `held` decision."""
    from .sched import failover as failover_sched
    from .sched import rebalance
    from .serving import autoscale as autoscale_mod

    est = _estimates_from_digests(cur_digests, sched,
                                  a_state["prev_digests"])
    with dead_lock:
        dead_now = set(dead_ranks)
    # state before the lazy controller construction: the controller
    # probes size_fn() at __init__, and the closures read a_state at call
    # time
    a_state.update(sched=sched, schedules=schedules, sched_idx=sched_idx,
                   dead=dead_now, last_apply=None)

    if a_state.get("controller") is None:
        max_size = (min(args.autoscale_max, world_size)
                    if args.autoscale_max else world_size)

        def _classify(pol, sig):
            b = sig.get("bottleneck_s")
            if b is None:
                return 0     # unmeasurable window: streaks reset
            if b >= args.autoscale_rank_high:
                return 1
            if b <= args.autoscale_rank_low:
                return -1
            return 0

        def _plan(direction, cur, target):
            sched_now = a_state["sched"]
            dead = a_state["dead"]
            if direction == "up":
                planned = failover_sched.plan_rejoin(
                    sched_now, None, world_size, dead,
                    align=_stage_align(args))
                if planned is None:
                    return {"ok": False,
                            "reason": "no idle survivor to expand onto"}
                return {"ok": True, "planned": planned}
            # scale-down: merge the span over `target` stages and drop the
            # victim from the placement (benching through the failover
            # cascade alone would hand the stage straight back to it as
            # the last-resort spare)
            stage_layers, _q, stage_ranks = sched_now
            candidates = [(hi - lo + 1, i)
                          for i, (lo, hi) in enumerate(stage_layers)
                          if stage_ranks[i] != args.rank
                          and stage_ranks[i] not in dead]
            if not candidates:
                return {"ok": False,
                        "reason": "no benchable stage (data rank holds "
                                  "the only one)"}
            _, idx = min(candidates)
            victim = stage_ranks[idx]
            try:
                contracted, _ = rebalance.solve_partition(
                    [1.0] * stage_layers[-1][1], target,
                    align=_stage_align(args))
            except ValueError as exc:
                return {"ok": False,
                        "reason": f"contraction to {target} stage(s) "
                                  f"unsolvable: {exc}"}
            new_ranks = [r for r in stage_ranks if r != victim]
            if len(new_ranks) != target:
                return {"ok": False,
                        "reason": f"placement mismatch: {len(new_ranks)} "
                                  f"survivors for {target} stage(s)"}
            return {"ok": True, "victim": victim,
                    "planned": (list(contracted), [0] * target, new_ranks)}

        def _apply(plan):
            scheds = a_state["schedules"]
            planned = plan["planned"]
            for j in range(a_state["sched_idx"] + 1, len(scheds)):
                scheds[j] = (list(planned[0]), list(planned[1]),
                             list(planned[2]))
            if "victim" not in plan:                    # scale-up
                with dead_lock:
                    for r_new in planned[2]:
                        autoscaled_ranks.discard(r_new)
                a_state["last_apply"] = ("up", planned[2])
            else:                                       # scale-down
                with dead_lock:
                    autoscaled_ranks.add(plan["victim"])
                a_state["last_apply"] = ("down", plan["victim"])

        a_state["controller"] = autoscale_mod.CapacityController(
            autoscale_mod.CapacityPolicy(
                min_size=args.autoscale_min,
                max_size=max(max_size, args.autoscale_min),
                confirm=args.autoscale_confirm,
                cooldown_s=args.autoscale_cooldown),
            mode=args.autoscale_ranks,
            size_fn=lambda: len(a_state["sched"][0]),
            plan_fn=_plan, apply_fn=_apply,
            classify_fn=_classify, label="stages")

    signals = {"size": len(sched[0]), "brownout_level": 0}
    if est:
        svc = [e.service_s for e in est.values()]
        bott = max(svc)
        signals["bottleneck_s"] = bott
        # the steady-state bubble ratio: the share of the fleet's
        # stage-seconds spent waiting on the bottleneck
        signals["bubble_frac"] = (1.0 - sum(svc) / (len(svc) * bott)
                                  if bott > 0 else 0.0)
    d = a_state["controller"].tick(signals)
    if d is None:
        return
    # machine-parseable decision line
    print(f"{d.line()} round={rnd}", flush=True)
    applied = a_state["last_apply"]
    if applied is None:
        return
    kind, detail = applied
    if kind == "up":
        print(f"autoscale_rank direction=up round={rnd} "
              f"ranks={','.join(str(r) for r in detail)}", flush=True)
    else:
        print(f"autoscale_rank direction=down round={rnd} "
              f"victim={detail}", flush=True)


def _consider_peer_health(ctx, args, hstate: dict, sched, next_sched,
                          world_size: int, rnd: int,
                          cur_digests=None) -> None:
    """One gray-failure decision at a round boundary (data rank only, as
    `runtime.py _consider_peer_health`): fold this round's measured
    signals — per-stage service time against the fleet median (the
    digest windows), heartbeat RTT p99 against the fleet median
    (`DistDcnContext.heartbeat_rtt_stats`), transport redial counts —
    into the EWMA health scorer, and act on its transitions:

    - suspect / floor-hold / recovery: recorded (health spans, flight
      ring) but nothing moves.
    - quarantine (`--on-peer-degraded quarantine`, confirmed over N
      windows, min-fleet floor verified by DRY-RUNNING the next round's
      failover plan with the victim benched): a planned bench — the rank
      is alive and this round fully drained, so adding it to
      `quarantined_ranks` makes the next boundary's re-plan move its
      stage to a spare with no ledger replay.
    - probation readmit: the score recovered; un-benching lets the next
      round's own schedule restore the stage through the same re-plan
      path.

    Never raises; an unmeasurable service window still folds RTT/retry
    signals so quarantined ranks keep moving toward (or away from)
    readmission."""
    from statistics import median

    from . import health as health_mod

    scorer = hstate["scorer"]
    _stage_layers, _q, stage_ranks = sched
    # cur_digests=None = the boundary's shared sweep failed: no service
    # signal this window, but RTT/retry signals still fold below
    est = _estimates_from_digests(cur_digests, sched,
                                  hstate["prev_digests"])

    # relative signals: a fleet where everything is slow is balanced,
    # not gray — normalize against the TRUE median (an upper median would
    # make a 2-stage fleet's straggler its own baseline). Absolute floors
    # guard the false-positive side: a stage a few ms over the median or
    # a sub-5 ms RTT at 2x the median reads as healthy (ratio 1.0)
    excess_floor_s = float(os.getenv("PIPEEDGE_HEALTH_MIN_EXCESS_S",
                                     "0.02"))
    rtt_floor_ms = float(os.getenv("PIPEEDGE_HEALTH_RTT_FLOOR_MS", "5"))
    service_ratio: dict = {}
    if est:
        svc = {stage_ranks[i]: e.service_s for i, e in est.items()
               if 0 <= i < len(stage_ranks)}
        med = median(svc.values()) if svc else 0.0
        if med > 0:
            service_ratio = {
                r: (s / med if s - med >= excess_floor_s else 1.0)
                for r, s in svc.items()}
    rtt = ctx.heartbeat_rtt_stats()
    rtt_ratio: dict = {}
    if rtt:
        med = median(v["p99_ms"] for v in rtt.values())
        for peer, v in rtt.items():
            _HB_RTT.set(v["p50_ms"], peer=str(peer), q="p50")
            _HB_RTT.set(v["p99_ms"], peer=str(peer), q="p99")
            if med > 0 and len(rtt) > 1:
                rtt_ratio[peer] = (v["p99_ms"] / med
                                   if v["p99_ms"] >= rtt_floor_ms
                                   else 1.0)
    retries_now = ctx.send_retry_counts()
    prev_r = hstate["prev_retries"]
    window_retries = {p: n - prev_r.get(p, 0)
                      for p, n in retries_now.items()}
    hstate["prev_retries"] = retries_now

    with dead_lock:
        dead_now = set(dead_ranks)
        bench_now = (set(benched_ranks) | set(quarantined_ranks)
                     | set(autoscaled_ranks))
    # score every rank carrying a stage this round PLUS every quarantined
    # rank (still beating — its RTT drives readmission)
    for peer in sorted((set(stage_ranks) | set(quarantined_ranks))
                       - dead_now - {args.rank}):
        sample = health_mod.HealthSample(
            service_ratio=service_ratio.get(peer),
            rtt_ratio=rtt_ratio.get(peer),
            send_retries=int(window_retries.get(peer, 0)))
        floor_ok = False
        if args.on_peer_degraded == "quarantine" \
                and scorer.state_of(peer) in (health_mod.STATE_SUSPECT,
                                              health_mod.STATE_PROBATION):
            # min-fleet floor: quarantine (or a probation relapse) only if
            # the NEXT round still has a runnable plan with this rank also
            # benched — the cascade the boundary re-plan will run
            planned = _plan_failover(args, next_sched, world_size,
                                     dead_now, benched=bench_now | {peer})
            floor_ok = planned is not None
        t = scorer.observe(peer, sample, can_quarantine=floor_ok)
        if t is None:
            continue
        now = time.monotonic_ns()
        if t.to == health_mod.STATE_QUARANTINED:
            with dead_lock:
                quarantined_ranks.add(peer)
            telemetry.record("health", f"quarantine:r{peer}", now, now)
            flight.note("peer_degraded", rank=peer, to=t.to,
                        score=round(t.score, 4), reason=t.reason)
            flight.maybe_dump("gray", context={
                "rank": peer, "round": rnd, "score": t.score,
                "reason": t.reason, "health": scorer.snapshot()})
            logger.warning("peer health: QUARANTINING rank %d at round "
                           "%d (%s); its stage moves to a spare at the "
                           "next boundary", peer, rnd, t.reason)
            # machine-parseable line (the chaos harness keys on it)
            print(f"quarantine_rank={peer} round={rnd} "
                  f"score={t.score:.4f}", flush=True)
        elif t.frm == health_mod.STATE_QUARANTINED \
                and t.to == health_mod.STATE_PROBATION:
            with dead_lock:
                quarantined_ranks.discard(peer)
            telemetry.record("health", f"readmit:r{peer}", now, now)
            flight.note("peer_readmitted", rank=peer,
                        score=round(t.score, 4))
            logger.warning("peer health: READMITTING rank %d on "
                           "probation at round %d (%s)", peer, rnd,
                           t.reason)
            print(f"readmit_rank={peer} round={rnd} "
                  f"score={t.score:.4f}", flush=True)
        elif t.frm == t.to:
            # floor hold (suspect stays suspect / probation relapse held):
            # checked before the suspect branch, which would otherwise
            # record a suspect-state hold as a second `suspect` span
            telemetry.record("health", f"held:r{peer}", now, now)
            flight.note("peer_quarantine_held", rank=peer,
                        score=round(t.score, 4))
        elif t.to == health_mod.STATE_SUSPECT:
            telemetry.record("health", f"suspect:r{peer}", now, now)
            flight.note("peer_suspect", rank=peer,
                        score=round(t.score, 4), reason=t.reason)
        else:                 # suspect/probation -> healthy
            telemetry.record("health", f"recovered:r{peer}", now, now)
            flight.note("peer_recovered", rank=peer,
                        score=round(t.score, 4))


def _plan_failover(args, sched, world_size: int, dead_now: set,
                   benched: Optional[set] = None):
    """Re-schedule over the survivors (sched/failover.py cascade). The
    native scheduler re-solve is attempted only when profile files were
    given; spare substitution — which preserves the partition and thus
    bit-identical replay — is the fallback. None = no capacity: abort.
    `benched` ranks (rejoined, not healed, or quarantined) keep no stage
    but stay in the spare pool at lowest priority."""
    from .sched import failover as failover_sched

    scheduler_fn = None
    if args.sched_models_file or args.sched_dev_types_file \
            or args.sched_dev_file:
        def scheduler_fn(n_survivors):
            return get_pipeline_sched(
                n_survivors, None, None, None, None, args.model_name,
                args.ubatch_size, args.sched_models_file,
                args.sched_dev_types_file, args.sched_dev_file,
                dtype=args.dtype)
    return failover_sched.plan_failover(*sched, world_size, dead_now,
                                        scheduler_fn=scheduler_fn,
                                        benched=benched)


def _maybe_heal(args, sched, world_size: int, rnd: int,
                schedules, sched_idx: int) -> None:
    """One heal decision at a round boundary (`--on-peer-rejoin heal`,
    data rank only): if the capacity the episode lost is restorable —
    every rank the pre-failure schedule names is alive again, or idle
    ranks allow a re-expansion (sched/failover.py `plan_rejoin`) — clear
    the bench so the next round runs the fleet at full capacity, and
    close the episode's time-to-full-capacity clock. A restore needs no
    schedule rewrite (each remaining round's own schedule replans clean
    once the bench is empty); a genuine re-expansion is written over the
    remaining rounds. The heal line reports the schedule the next round
    will run. A rejoiner that cannot restore capacity yet stays a spare
    and the heal stays pending for a later boundary."""
    from .sched import failover as failover_sched

    with dead_lock:
        dead_now = set(dead_ranks)
    pre = _heal_state["pre_failure"]
    healed = failover_sched.plan_rejoin(sched, pre, world_size, dead_now,
                                        align=_stage_align(args))
    if healed is None:
        logger.info("heal: capacity not restorable yet (dead=%s); the "
                    "rejoined rank stays a spare", sorted(dead_now))
        return
    restored = pre is not None and healed == (list(pre[0]), list(pre[1]),
                                              list(pre[2]))
    if restored:
        # the next round's own schedule runs clean once the bench is
        # empty: report THAT, not the plan
        layers, _quant, ranks = schedules[sched_idx + 1]
    else:
        for j in range(sched_idx + 1, len(schedules)):
            schedules[j] = (list(healed[0]), list(healed[1]),
                            list(healed[2]))
        layers, _quant, ranks = healed
    now = time.monotonic_ns()
    t0 = _heal_state["detect_ns"] or _heal_state["rejoin_ns"] or now
    telemetry.record("rejoin", "heal", t0, now)
    ttfc = (now - t0) / 1e9
    _TTFC.set(ttfc)
    with dead_lock:
        benched_ranks.clear()
    _heal_state["pending"] = False
    _heal_state["pre_failure"] = None
    _heal_state["detect_ns"] = None
    logger.warning("heal: partition %s to full capacity for round "
                   "%d: layers=%s ranks=%s (%.3fs after detection)",
                   "restored" if restored else "re-expanded",
                   rnd, list(layers), list(ranks), ttfc)
    # machine-parseable heal line (the chaos harness keys its healed
    # timestamp and final partition on it)
    print(f"heal_round={rnd} "
          f"partition={','.join(f'{l},{r}' for l, r in layers)} "
          f"ranks={','.join(str(r) for r in ranks)} "
          f"time_to_full_capacity_s={ttfc:.3f}", flush=True)


def _abort_no_capacity(ctx, dead_now: set) -> None:
    """Failover found no schedule the survivors can run: fall back to the
    abort semantics, naming the dead rank fleet-wide (death-carrying
    CMD_STOP) so every worker raises instead of waiting for a schedule."""
    dead = sorted(dead_now)[0]
    stop_info[0] = dead
    monitoring.flush()
    try:
        ctx.cmd_broadcast(CMD_STOP, [np.asarray(dead, np.int32)],
                          best_effort=True)
    except OSError:  # pragma: no cover - best_effort already guards
        pass
    stop_event.set()
    raise RuntimeError(
        f"pipeline aborted: rank {dead} died and no spare capacity "
        "remains to fail over (set --on-peer-death abort to skip the "
        "re-schedule attempt)")


def _handle_corrupt_results(ctx, src: int, channel: int, exc) -> None:
    """A result frame failed its checksum where the transport reader did
    not verify it (the producer armed `--wire-crc`, this rank did not):
    count it, note it, and request a latest-frame resend. In failover mode
    the ledger dedupes and orders the resent frame by microbatch id;
    without a ledger the FIFO label pairing may shift by one — the same
    caveat DCN_SEND_RETRIES carries outside failover mode."""
    from .comm import dcn
    dcn.FRAMES_CORRUPT.inc(peer=str(src))
    flight.note("frame_corrupt", peer=src, error=str(exc))
    logger.error("results: corrupt frame from rank %d (%s); requesting "
                 "resend", src, exc)
    try:
        ctx.request_resend(src, channel)
    except OSError as rexc:
        logger.error("resend request to rank %d failed: %s", src, rexc)


def _mbid_of(t) -> int:
    """The microbatch id a failover frame leads with (a 0-d int64)."""
    return int(np.asarray(t).reshape(-1)[0])


def emit_line(line: str) -> None:
    """Print one machine-read line in a single write: `print` writes the
    text and its newline apart, and with stdout unbuffered another
    thread's log record (stderr into the same file) can land between
    them, after the line's JSON."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _launch_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()}


def run_pipeline_dcn(args, schedules, ubatches, labels) -> None:
    """One rank of a DCN fleet (reference `runtime.py RANK WORLDSIZE`,
    run_pipeline_p2p 418-511). The data rank broadcasts each round's
    schedule (`schedules`: a list of (stage layers, stage bits, stage
    ranks)), streams the microbatches to the first stage and collects
    the results from the last; workers build the stage each CMD_SCHED
    gives them until an empty one ends the run.

    A peer's death stops the fleet (`--on-peer-death abort`), or, under
    `failover`, ends the round: the data rank re-plans over the survivors
    and replays what its ledger has not acknowledged, in a new round.
    A restarted rank (`DCN_EPOCH` > 0) announces its JOIN; the data rank
    admits it as a spare and, under `--on-peer-rejoin heal`, restores
    the pre-failure schedule at the next round boundary. Under
    `--on-peer-degraded quarantine` each boundary scores the stage ranks
    and benches a confirmed straggler (`_consider_peer_health`)."""
    from .comm import chaos, dcn

    rank, world_size = args.rank, args.worldsize
    data_rank = args.data_rank
    failover_mode = args.on_peer_death == "failover"
    resolve_device(args.device)   # a run asked for the card needs one
    _declare_fleet_metric_labels(world_size, rank)
    # per-rank flight recorder: always-on event ring; postmortem bundles
    # fire on failover (data rank), one per cooldown window
    flight.configure(rank=rank)
    addrs = dcn.parse_rank_addrs(args.dcn_addrs, world_size, args.port)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    launches0 = dict(_build.launch_counts)

    with dcn.DistDcnContext(world_size, rank, addrs, cmd_handler=handle_cmd,
                            accept_joins=args.on_peer_rejoin != "ignore"
                            ) as ctx:
        _register_dcn_monitor_hooks(ctx)
        chaos.maybe_install(ctx)   # deterministic fault injection, env-gated
        if ctx.send_retries > 0 and not failover_mode:
            # a resent frame can DUPLICATE or reorder a microbatch; only
            # the failover ledger dedupes by id. Without it, the FIFO
            # label/result pairing can silently misalign.
            logger.warning(
                "DCN_SEND_RETRIES=%d without --on-peer-death failover: "
                "resends are not deduplicated; result/label alignment is "
                "not guaranteed after a transient fault", ctx.send_retries)

        def on_peer_death(dead: int) -> None:
            if stop_info[0] is not None:
                return  # the fleet is already aborting for a known death
            # connections also drop during the clean teardown (empty
            # CMD_SCHED), which may still be in flight on another socket
            if fleet_shutdown.wait(timeout=2.0):
                return
            monitoring.flush()
            if failover_mode and dead != data_rank:
                with dead_lock:
                    announced = dead in dead_ranks
                    dead_ranks.add(dead)
                if announced:
                    return
                _record_failover_detect(dead)
                logger.error("rank %d: peer rank %d died; entering failover",
                             rank, dead)
                failover_event.set()
                # every rank may detect independently; the announcement is
                # idempotent at the receivers (dead_ranks is a set) and the
                # data rank alone orchestrates the recovery
                try:
                    ctx.cmd_broadcast(CMD_DEAD, [np.asarray(dead, np.int32)],
                                      best_effort=True)
                except OSError:  # pragma: no cover - best_effort guards
                    pass
                return
            # the data rank's death is never survivable — it alone holds
            # the ledger, the inputs and the orchestration — so even in
            # failover mode it takes the abort path
            _record_failover_detect(dead, failover=False)
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

        # heal state shared between the rejoin handler (reader-thread
        # dispatch) and the data rank's round loop
        round_state = {"rnd": 0}
        ledger_ref: List[Optional[_MicrobatchLedger]] = [None]

        def on_peer_rejoin(src: int, epoch: int) -> None:
            """A peer passed the JOIN handshake: pull it out of the dead
            set (it is live idle capacity again), and — on the data rank —
            fence the ledger, ack the admission (CMD_ADMIT) and arm the
            heal for the next round boundary."""
            with dead_lock:
                was_dead = src in dead_ranks
                dead_ranks.discard(src)
                # its old stage stays where the failover moved it until a
                # heal says otherwise (spare mode never does)
                if was_dead:
                    benched_ranks.add(src)
            now = time.monotonic_ns()
            telemetry.record("rejoin", "admit", now, now)
            _REJOINS.inc(peer=str(src))
            _heal_state["rejoin_ns"] = now
            if was_dead:
                _heal_state["pending"] = True
            logger.warning("rank %d: peer rank %d rejoined with epoch %d%s",
                           rank, src, epoch,
                           " (was confirmed dead)" if was_dead else "")
            if rank != data_rank:
                return
            # machine-parseable admission line (the chaos harness keys its
            # rejoin timestamp on it)
            print(f"rejoin_rank={src} epoch={epoch} "
                  f"was_dead={int(was_dead)}", flush=True)
            # epoch floor for the ledger: results signed by the fenced
            # incarnation must never ack a microbatch
            ledger = ledger_ref[0]
            if ledger is not None:
                ledger.fence_rank(src, ctx.min_epoch_of(src))
            # a rank admitted once the fleet is tearing down may have
            # missed the empty CMD_SCHED: it gets its own, or it would
            # wait out --sched-timeout holding its device
            done = fleet_shutdown.is_set()
            try:
                if done:
                    ctx.cmd_send(src, CMD_SCHED, [], timeout=10.0)
                else:
                    ctx.cmd_send(src, CMD_ADMIT,
                                 [np.asarray(round_state["rnd"], np.int32)],
                                 timeout=10.0)
            except OSError as exc:
                logger.warning("%s to rank %d failed (%s)",
                               "the empty CMD_SCHED" if done else "CMD_ADMIT",
                               src, exc)

        ctx.register_peer_rejoin_handler(on_peer_rejoin)

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
        if ctx.epoch > 0:
            # this process IS a restarted incarnation (env DCN_EPOCH, e.g.
            # chaos restart@K:MS or an orchestrator relaunch): ask the
            # fleet to re-admit it before waiting for a schedule
            # the data rank first: if it is gone, so is the fleet this
            # incarnation would rejoin, and waiting for a schedule would
            # only hold the device until --sched-timeout
            reached = ctx.announce_join(peers=[data_rank])
            if rank != data_rank and not reached:
                raise RuntimeError(
                    f"rank {rank}: restarted as epoch {ctx.epoch}, but the "
                    f"data rank {data_rank} did not take its JOIN; the "
                    "fleet has ended")
            reached += ctx.announce_join(
                peers=[r for r in range(world_size) if r != data_rank])
            logger.warning("rank %d: restarted as epoch %d; JOIN announced "
                           "to rank(s) %s", rank, ctx.epoch, reached)
        results_target = [0]
        if rank == data_rank:
            _drive_rounds(args, ctx, schedules, ubatches, labels, dtype,
                          results_target, round_state, ledger_ref)
            # no more rounds: an empty schedule releases the workers
            # (fleet_shutdown first, so peers closing are not deaths)
            fleet_shutdown.set()
            with dead_lock:
                gone = set(dead_ranks)
            ctx.cmd_broadcast(CMD_SCHED, [], exclude=gone)
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
                # (channel parity must match the fleet's; a rejoined
                # worker starts counting mid-sequence)
                if len(tensors) > 3:
                    rnd = int(np.asarray(tensors[3]).reshape(-1)[0])
                _dcn_round(args, ctx, rnd, stage_layers, stage_quant,
                           stage_ranks, [], [], dtype, results_target,
                           stop_base=stop_base)
                rnd += 1
    emit_line(f"rank={rank} kernel_launches="
              + json.dumps(_launch_delta(launches0), sort_keys=True))


def _drive_rounds(args, ctx, schedules, ubatches, labels, dtype,
                  results_target, round_state: dict, ledger_ref: list) -> None:
    """The data rank's round loop (`runtime.py run_pipeline_dcn`): each
    schedule round runs once, or, when a stage rank dies under failover,
    until a round over the re-planned survivors completes it from the
    ledger. At each completed boundary before the last, from one shared
    sweep of the fleet's span digests: the rebalance (`--rebalance
    auto`, re-cutting the remaining rounds), the peer-health decision,
    the heal, then the capacity decision (`--autoscale-ranks`). The
    merged span trace is written whatever happens (`--trace-spans`)."""
    world_size = args.worldsize
    failover_mode = args.on_peer_death == "failover"
    # closed-loop rebalancer: re-partition the remaining rounds from this
    # round's measured per-stage timings, applied through the CMD_SCHED
    # broadcast that failover uses
    rebalancer = None
    prev_digests: dict = {}
    if args.rebalance == "auto":
        from .sched import rebalance as rebalance_sched
        rebalancer = rebalance_sched.RebalancePolicy(
            threshold=args.rebalance_threshold,
            cooldown=args.rebalance_cooldown,
            confirm=args.rebalance_confirm, align=_stage_align(args))
    # peer-health plane (gray failures): active whenever the fleet
    # records spans — `--on-peer-degraded quarantine` forces them on
    # (main_dcn); with `ignore` and --trace-spans the scorer still runs
    # for observability (scores, suspect spans, flight events) but never
    # benches
    health_state = None
    if telemetry.enabled() and world_size > 1:
        from . import health as health_mod
        h_scorer = health_mod.PeerHealthScorer(
            [r for r in range(world_size) if r != args.rank],
            policy=health_mod.HealthPolicy(
                suspect_threshold=args.degraded_threshold,
                readmit_threshold=args.degraded_threshold / 2,
                confirm=args.degraded_confirm,
                readmit=args.degraded_readmit))
        health_mod.set_scorer(h_scorer)
        health_state = {"scorer": h_scorer, "prev_digests": {},
                        "prev_retries": {}}
    # the capacity loop's pipeline half (--autoscale-ranks): its
    # controller is built at the first boundary, from the same windows
    a_state = None
    if args.autoscale_ranks != "off" and world_size > 1:
        a_state = {"prev_digests": {}, "controller": None}
    schedules = [tuple(s) for s in schedules]
    try:
        rnd = 0
        fo_t0 = None   # recovery span: detection stamp, if any
        for sched_idx in range(len(schedules)):
            sched = schedules[sched_idx]
            ledger = None
            if failover_mode:
                # clear BEFORE snapshotting: a death landing in between is
                # caught by the snapshot (its rank joins dead_ranks before
                # the event is set), and a death landing after re-sets the
                # event and fails the round over normally
                failover_event.clear()
                with dead_lock:
                    dead_now = set(dead_ranks)
                    bench_now = (set(benched_ranks)
                                 | set(quarantined_ranks)
                                 | set(autoscaled_ranks))
                if dead_now or bench_now:
                    # a later round may still name a rank that died earlier
                    # (or rejoined un-healed, or was quarantined): remap
                    # before broadcasting
                    if _heal_state["pre_failure"] is None:
                        _heal_state["pre_failure"] = sched
                    sched = _plan_failover(args, sched, world_size, dead_now,
                                           benched=bench_now)
                    if sched is None:
                        _abort_no_capacity(ctx, dead_now)
                ledger = _MicrobatchLedger(ubatches, labels)
                ledger_ref[0] = ledger
            while True:
                round_state["rnd"] = rnd
                if rnd:
                    logger.info("re-schedule: broadcasting round %d "
                                "(partition %s)", rnd, sched[0])
                status = _dcn_round(args, ctx, rnd, *sched, ubatches,
                                    labels, dtype, results_target,
                                    ledger=ledger)
                rnd += 1
                if status != "failover":
                    if fo_t0 is not None:
                        # detection -> replay-round completion (the span
                        # report's failover breakdown); consume this
                        # episode's stamps
                        telemetry.record("failover", "recover", fo_t0,
                                         time.monotonic_ns())
                        fo_t0 = None
                        del _failover_detect_ns[:]
                    if sched_idx + 1 < len(schedules):
                        # one digest sweep per boundary, shared: each
                        # consumer differences it against its own
                        # baseline (the digests are cumulative)
                        digests = None
                        if rebalancer is not None \
                                or health_state is not None \
                                or a_state is not None:
                            digests = _collect_fleet_digests(ctx, args,
                                                             sched[2])
                        if rebalancer is not None:
                            proposal = _consider_rebalance(
                                ctx, args, rebalancer, sched, prev_digests,
                                rnd - 1, cur_digests=digests)
                            if proposal is not None:
                                # re-cut the remaining rounds; their quant
                                # and rank specs stand, and a death before
                                # they run still goes through the
                                # per-round failover re-plan
                                for j in range(sched_idx + 1,
                                               len(schedules)):
                                    _, q_j, r_j = schedules[j]
                                    schedules[j] = (
                                        [tuple(p) for p in
                                         proposal.partition], q_j, r_j)
                        if health_state is not None:
                            # gray-failure decision at the boundary: the
                            # round is fully drained, so a quarantine is a
                            # planned bench with no replay
                            _consider_peer_health(
                                ctx, args, health_state, sched,
                                schedules[sched_idx + 1], world_size,
                                rnd - 1, cur_digests=digests)
                        if args.on_peer_rejoin == "heal" \
                                and _heal_state["pending"]:
                            # capacity came back mid-run: restore (or
                            # re-expand) before the next round's broadcast
                            _maybe_heal(args, sched, world_size, rnd,
                                        schedules, sched_idx)
                        if a_state is not None:
                            # the capacity decision last: its scale-up
                            # rewrite lands after any heal, so the
                            # remaining rounds reflect both
                            _consider_autoscale(
                                ctx, args, a_state, sched, schedules,
                                sched_idx, world_size, rnd - 1,
                                cur_digests=digests)
                    break
                if fo_t0 is None:
                    # FIRST detection of this episode
                    fo_t0 = (_failover_detect_ns[0] if _failover_detect_ns
                             else time.monotonic_ns())
                # failover postmortem bundle: the ledger's replay set and
                # request map and the membership at the moment the round
                # failed over — written before the re-plan mutates them
                with dead_lock:
                    fo_dead = sorted(dead_ranks)
                    fo_bench = sorted(benched_ranks)
                flight.note("failover", dead_ranks=fo_dead, round=rnd)
                flight.maybe_dump("failover", context={
                    "round": rnd, "dead_ranks": fo_dead,
                    "benched_ranks": fo_bench,
                    "ledger": ledger.forensics()})
                # clear-then-snapshot, same ordering as above
                failover_event.clear()
                with dead_lock:
                    dead_now = set(dead_ranks)
                    bench_now = (set(benched_ranks)
                                 | set(quarantined_ranks)
                                 | set(autoscaled_ranks))
                if _heal_state["pre_failure"] is None:
                    # the schedule running when the episode's death hit:
                    # what --on-peer-rejoin heal restores
                    _heal_state["pre_failure"] = sched
                replay = ledger.pending()
                with telemetry.span("failover", "reschedule"):
                    planned = _plan_failover(args, sched, world_size,
                                             dead_now, benched=bench_now)
                if planned is None:
                    _abort_no_capacity(ctx, dead_now)
                logger.warning(
                    "failover: rank(s) %s dead (benched: %s); re-scheduling "
                    "over survivors and replaying %d unacknowledged "
                    "microbatch(es)", sorted(dead_now), sorted(bench_now),
                    len(replay))
                sched = planned
    finally:
        if args.trace_spans:
            _collect_write_spans(ctx, args)


def _dcn_round(args, ctx, rnd, stage_layers, stage_quant, stage_ranks,
               ubatches, labels, dtype, results_target,
               ledger: Optional[_MicrobatchLedger] = None,
               stop_base: Optional[int] = None) -> Optional[str]:
    """One schedule round on a live fleet: (data rank) broadcast the
    schedule, build this rank's stage if it has one, stream the batch,
    stop; (worker) build, run until this round's CMD_STOP. Prints this
    round's kernel launches on this rank.

    With a `ledger` (failover mode at the data rank) every frame leads
    with its microbatch id, only unacknowledged microbatches are fed, and
    a stage rank's death ends the round with status "failover" (the
    survivors' results drained) instead of raising: the caller re-plans
    and replays. Returns "ok" on completion, "failover" on a survivable
    death, None on worker ranks."""
    from .comm import dcn
    from .comm import wire

    rank, data_rank = args.rank, args.data_rank
    parity = dcn.CHANNEL_ROUND_PARITY * (rnd % 2)
    # an aborting death is terminal for the whole run (failover-mode
    # deaths live in dead_ranks instead)
    if stop_info[0] is not None:
        raise RuntimeError(f"rank {rank}: pipeline aborted: rank "
                           f"{stop_info[0]} died")
    t_round0 = time.monotonic_ns()
    launches0 = dict(_build.launch_counts)
    stop_event.clear()
    status = None
    feed_threads: List[threading.Thread] = []
    if rank == data_rank:
        if ledger is not None:
            # results of earlier rounds (a stage's work on what a cut-off
            # round left queued) are stale; none of this round's exists yet
            _drop_stale(ctx, dcn.CHANNEL_RESULTS, "result")
        # skip confirmed-dead ranks, so a failover schedule reaches every
        # survivor without stalling
        with dead_lock:
            gone = set(dead_ranks)
        ctx.cmd_broadcast(CMD_SCHED, [
            np.asarray(stage_layers, np.int32),
            np.asarray(stage_quant, np.int32),
            np.asarray(stage_ranks, np.int32),
            np.asarray(rnd, np.int32)], exclude=gone)
    stage = None
    try:
        my_stages = [i for i, r in enumerate(stage_ranks) if r == rank]
        if my_stages:
            assert len(my_stages) == 1, \
                "one stage per rank (reference p2p semantics)"
            if args.stage_tp > 1 and args.tp_quant_bits:
                # this round's folds count this round's collectives only
                from .ops import qcollectives
                qcollectives.reset_trace_tally()
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
            if ledger is None:
                for lb in labels:
                    label_queue.put(lb)
                feed_items = list(enumerate(ubatches))
            else:
                # only unacknowledged microbatches are (re)fed; labels are
                # delivered by the ledger in microbatch order
                feed_items = ledger.pending()
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

            def death_hits_schedule() -> bool:
                # a dead IDLE spare is recorded but must not tear down a
                # healthy round; only a death among this round's stage
                # ranks fails it over. A scheduled rank sitting in
                # benched_ranks is lost too: restart@K:MS can re-exec the
                # victim fast enough that its JOIN is admitted (dead ->
                # benched) before this loop's next poll sees the death,
                # and the fresh incarnation holds no stage state. Every
                # call site pairs this with failover_event, so a benched
                # rank fails a round only while a death episode is open.
                with dead_lock:
                    lost = set(dead_ranks) | set(benched_ranks)
                    return bool(lost & set(stage_ranks))

            def round_lost() -> bool:
                return failover_event.is_set() and death_hits_schedule()

            def results_loop():
                if ledger is not None:
                    # failover mode: keep acking until the ledger is full
                    # or the round is torn down — including the drain
                    # window after a death, when survivors' in-flight
                    # results are still arriving
                    while not stop_event.is_set() \
                            and not ledger.done.is_set():
                        try:
                            # the producing incarnation's epoch keys the
                            # ledger's epoch-aware dedupe
                            tensors, epoch, tctx = ctx.recv_tensors_traced(
                                last_rank, timeout=0.5,
                                channel=dcn.CHANNEL_RESULTS + parity)
                        except queue.Empty:
                            # a late result of the last round must not
                            # park its reader in front of this round's
                            ctx.drop_queued(dcn.CHANNEL_RESULTS
                                            + dcn.CHANNEL_ROUND_PARITY
                                            - parity)
                            continue
                        except ConnectionError:
                            return
                        mbid = _mbid_of(tensors[0])
                        rid = (tctx.rid if tctx is not None
                               else ledger.trace_of(mbid))
                        try:
                            with telemetry.span("results", "deliver",
                                                mb=mbid, rid=rid):
                                out = wire.wire_decode(tensors[1:], dtype,
                                                       device="cpu")
                                if nan_guard.nan_guard_enabled():
                                    out = nan_guard.check_finite(
                                        out, where="results", mb=mbid,
                                        rid=rid)
                                # the ledger keeps a host copy it owns,
                                # never a view of the receive buffer
                                if not ledger.ack(mbid, out.clone(),
                                                  epoch=epoch,
                                                  src=last_rank):
                                    logger.info("failover: duplicate "
                                                "result for microbatch "
                                                "%d dropped", mbid)
                                else:
                                    # keeps the replay a mid-round death
                                    # would trigger bounded to the unacked
                                    # window
                                    ledger.maybe_snapshot()
                        except wire.WireCorruptError as exc:
                            # the resent frame re-enters this loop and
                            # acks by id: exactly-once holds
                            _handle_corrupt_results(
                                ctx, last_rank,
                                dcn.CHANNEL_RESULTS + parity, exc)
                    return
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
                        # the resent frame is consumed by a later
                        # iteration of this loop (the count stays whole)
                        _handle_corrupt_results(
                            ctx, last_rank, dcn.CHANNEL_RESULTS + parity,
                            exc)

            def feed_loop():
                # its own thread: a send backpressured by a stalled
                # pipeline may block, and the main thread must stay free
                # to abort
                try:
                    for mbid, u in feed_items:
                        if stop_event.is_set() or (ledger is not None
                                                   and round_lost()):
                            return
                        tctx = None
                        if telemetry.enabled():
                            tctx = telemetry.TraceContext(
                                f"r{rnd}.mb{mbid}", "batch",
                                parent=f"feed.rank{rank}")
                            if ledger is not None:
                                ledger.record_trace(mbid, tctx.rid)
                        frame = [np.asarray(u)]
                        if ledger is not None:
                            frame.insert(0, np.asarray(mbid, np.int64))
                        with telemetry.span("feed", f"mb{mbid}", mb=mbid,
                                            rid=tctx.rid if tctx else None):
                            ctx.send_tensors(first_rank, frame,
                                             channel=dcn.CHANNEL_FEED
                                             + parity, trace=tctx)
                except OSError as exc:
                    logger.error("feeding stage rank %d failed (%s)",
                                 first_rank, exc)

            results_thread = threading.Thread(target=results_loop,
                                              daemon=True)
            results_thread.start()
            feed_thread = threading.Thread(target=feed_loop, daemon=True)
            feed_threads.append(feed_thread)
            failed_over = False
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
                    if ledger is not None:
                        if round_lost():
                            break
                        complete = ledger.done.wait(timeout=0.5)
                    else:
                        complete = results_counter.wait_gte(target,
                                                            timeout=0.5)
                if ledger is not None:
                    if not complete and round_lost():
                        # drain the survivors: in-flight results keep
                        # landing for a moment after the death; wait until
                        # the ack stream goes quiet before tearing down
                        quiet_at = ledger.acked_count
                        drain_deadline = time.monotonic() + 5.0
                        while time.monotonic() < drain_deadline:
                            time.sleep(0.4)
                            now_acked = ledger.acked_count
                            if now_acked == quiet_at:
                                break
                            quiet_at = now_acked
                        failed_over = not ledger.done.is_set()
                    complete = ledger.done.is_set()
                else:
                    # the last results can land concurrently with an abort
                    complete = complete or results_counter.wait_gte(
                        target, timeout=0)
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
            if failed_over or (not complete and ledger is not None
                               and round_lost()):
                monitoring.flush()
                status = "failover"
            elif not complete:
                delivered = (ledger.acked_count if ledger is not None else
                             results_counter.value - (target - batch_total))
                if stop_info[0] is not None:
                    raise RuntimeError(
                        f"pipeline aborted: rank {stop_info[0]} died "
                        f"mid-run ({delivered}/{batch_total} results "
                        "delivered)")
                raise RuntimeError(
                    f"pipeline delivered {delivered}/{batch_total} results "
                    f"within {args.sched_timeout}s")
            else:
                print(f"round={rnd} latency_sec={tok - tik:.6f} "
                      f"throughput_items_sec={batch_total / (tok - tik):.3f}")
                _report(tik, tok, ubatches)
                status = "ok"
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
            totals = stage.tp_collectives
            if totals is not None:
                # the round's quantized-collective wire footprint (each
                # microbatch's was folded into stage-tagged spans already)
                wire_bits = totals["wire_bits_total"]
                logger.info("rank %d stage %d quantized collectives "
                            "(--tp-quant-bits %d): %s", rank, my_stages[0],
                            args.tp_quant_bits, dict(totals, wire_reduction=(
                                round(totals["raw_bits_total"] / wire_bits,
                                      3) if wire_bits else None)))
        if feed_threads and ledger is not None:
            # a round cut off by a death leaves microbatches of its feed
            # in the first stage's queue (and a feeder parked on it); the
            # next round of the same parity would run them again
            _drop_stale(ctx, dcn.CHANNEL_FEED + parity, "feed",
                        feeder=feed_threads[0])
    emit_line(f"rank={rank} round={rnd} kernel_launches="
              + json.dumps(_launch_delta(launches0), sort_keys=True))
    return status


def _drop_stale(ctx, channel: int, what: str, feeder=None) -> None:
    """Discard the frames waiting on `channel` (both round parities when
    it is a base channel), first letting `feeder` (a thread parked on a
    full local queue) put its last one and end (bounded: 2 s)."""
    from .comm import dcn

    channels = ([channel] if feeder is not None else
                [channel, channel + dcn.CHANNEL_ROUND_PARITY])
    dropped = 0
    deadline = time.monotonic() + 2.0
    while True:
        dropped += sum(ctx.drop_queued(ch) for ch in channels)
        if feeder is None or not feeder.is_alive() \
                or time.monotonic() >= deadline:
            break
        feeder.join(timeout=0.1)
    if dropped:
        logger.info("dropped %d stale %s frame(s)", dropped, what)


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
    if args.tp_quant_bits:
        # one process-wide switch, read by every TP block's all-reduce
        from .parallel import tensor as tp
        tp.set_tp_quant_bits(args.tp_quant_bits)
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
    if args.trace_spans or args.rebalance == "auto" \
            or args.on_peer_degraded == "quarantine" \
            or args.autoscale_ranks != "off":
        # every rank records: the data rank merges the fleet's spans, and
        # the rebalancer, the peer-health scorer and the capacity
        # controller read the span digests every rank serves
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
    if args.rank != 0 and args.comm != "dcn":
        logger.warning("Single-controller runtime: only rank 0 runs; "
                       "rank %d exits immediately (all devices are driven "
                       "from rank 0). Use --comm dcn for one-process-per-"
                       "rank operation.", args.rank)
        return
    if args.comm == "dcn":
        main_dcn(args)
        return
    stage_layers, stage_quant, stage_ranks = _schedule(args)
    comm = args.comm
    if comm == "spmd":
        from .parallel import spmd
        try:
            spmd.partition_to_blocks(stage_layers)
        except ValueError as exc:
            logger.warning("%s; falling back to host driver", exc)
            comm = "host"
    if args.trace_spans:
        telemetry.configure(rank=0)
    init_monitoring(get_window_size())
    try:
        with tracing.trace(args.trace):
            if comm == "spmd":
                run_pipeline_spmd(args, stage_layers, stage_quant,
                                  stage_ranks)
            else:
                run_pipeline_host(args, stage_layers, stage_quant,
                                  stage_ranks)
    finally:
        monitoring.finish()
    if args.trace_spans and telemetry.recorder() is not None:
        spans = telemetry.recorder().snapshot()
        chrome_trace.dump_trace(spans, args.trace_spans)
        logger.info("trace-spans: %d span(s) -> %s", len(spans),
                    args.trace_spans)


if __name__ == "__main__":
    main()
