"""Pipelined KV-cache text generation (GPT-2, MoE GPT-2, Llama, Mistral).

The local path of the repository's `tools/generate.py`, on PyTorch:

    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 -b 16 \\
        --prompt-len 192 --new-tokens 128 --max-len 1024 --kv-bits 8
    python -m pipeedge_tpu_torch.generate -m meta-llama/Meta-Llama-3-8B \\
        -t bfloat16 -b 4 --prompt-len 512 --new-tokens 128

decodes seeded synthetic prompts through a block-aligned pipeline on the
GPU and prints `generated BxN tokens in Xs = Y tok/s (...)`, the first
row's continuation ids, and one line with each kernel's launch count over
the run (warm-up included). `--device cpu` runs the plain versions of the
kernels on the CPU. Without `--model-file` (or with a missing file) each
stage draws seeded random weights. `PIPEEDGE_INT8_DECODE_ATTEND=1` routes
the int8 cache's decode steps through the decode-attention kernel.

`--draft-model NAME [--gamma G]` decodes greedily by speculative rounds
(`parallel/speculative.py`): the draft model, one stage, proposes G
tokens per round and the target verifies them in one span; the tokens
are the target's own greedy ones, and the report line adds the
acceptance rate and the host readbacks per round:

    python -m pipeedge_tpu_torch.generate -m gpt2-medium \\
        --draft-model gpt2 --gamma 4 -b 4 --prompt-len 128 --new-tokens 64

`--concurrent N` decodes N requests of `-b` rows each through the
continuous batcher (`parallel/batcher.py ContinuousBatcher`), every
request's tokens equal to its solo run; `--monitor` writes one heartbeat
per decoded token to `decode.csv` in the working directory (each beat
waits on a CUDA event recorded after its token, so it times the token's
emission, not its dispatch); `-sm/-sdt/-sd` cut the model with the
native scheduler over the profiler's files and round the cut to whole
blocks, as decoding needs:

    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 \\
        --kv-bits 8 --concurrent 4 -b 4 --prompt-len 192 --new-tokens 128 \\
        --max-len 1024
    python -m pipeedge_tpu_torch.generate -m gpt2 -b 4 \\
        -sm models.yml -sdt device_types.yml -sd devices.yml

`--dcn-addrs h:p,h:p,... --rank R [--edge-bits B]` decodes across OS
processes over TCP (`comm/dcn.py`), one stage per rank: every rank runs
the same command with its own `--rank`, so the step count is known
fleet-wide. Per step the hidden state hops rank to rank on CHANNEL_DATA
(encoded on the card by the codec's encode kernel at 4 and 8 bits,
decoded by its decode kernel) and the last rank returns the next-token
logits to rank 0 on CHANNEL_RESULTS. With `ADAPTIVE_QUANT` set, each
rank but the last adapts its own output edge's bits, `--edge-bits` being
the start. Rank 0 prints the report lines; every rank prints `rank=R
kernel_launches=`:

    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 \\
        --dcn-addrs 127.0.0.1:29600,127.0.0.1:29601 --rank 1 --edge-bits 8 &
    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 \\
        --dcn-addrs 127.0.0.1:29600,127.0.0.1:29601 --rank 0 --edge-bits 8

A JAX rank (`tools/generate.py` with the same flags) takes either place.

`--tp N` runs each stage Megatron tensor-parallel over N shards
(`parallel/mesh.py ShardGroup`, `DecodePipeline(mesh=)`): heads and the
KV cache split across the shards, the LM head vocab-split when N divides
the vocabulary. The shards sit on cards `0..N-1` round-robin, so on a
one-card host they share it; `--device cpu` puts them on the CPU:

    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 --tp 2 \\
        -b 16 --prompt-len 192 --new-tokens 64 --kv-bits 8

`--ep N` splits an MoE model's experts over N shards
(`DecodePipeline(ep_mesh=)`, attention and the cache replicated);
`--tp N --ep M` runs the tp x ep grid of N * M shards (`tp_ep_mesh=`,
`parallel/mesh.py ShardGrid`): attention tensor-parallel, experts
expert-parallel. `--sp N` runs the prompt pass sequence-parallel over N
shards (the ring core, `sp_mesh=`; the prompt length must divide by N)
and the decode steps on the first. Their shards share the cards
round-robin as `--tp`'s do:

    python -m pipeedge_tpu_torch.generate -m pipeedge/gpt2-moe-8e \\
        -pt 1,24,25,48 --tp 2 --ep 2 -b 16 --prompt-len 192 --new-tokens 64
    python -m pipeedge_tpu_torch.generate -m meta-llama/Meta-Llama-3-8B \\
        --sp 2 -b 1 --prompt-len 4096 --new-tokens 32

`--spmd-wave` decodes K request slots (K = the stage count) as one wave
over the stages (`parallel/spmd_decode.py SpmdDecodePipeline`): every
slot the same prompts, slot r sampling with seed `--seed` + r, each
slot's tokens equal to its solo run. Stage i sits on card `i %
device_count()`, as `runtime -c spmd` places stages, so on a one-card
host the stages share it; `--edge-bits 4|8` sends the prompt hops through
the codec kernels. With `--draft-model` the plain wave runs and the draft
is not used, as in the JAX entry:

    python -m pipeedge_tpu_torch.generate -m gpt2 \\
        -pt 1,12,13,24,25,36,37,48 --spmd-wave -b 4 --prompt-len 64 \\
        --new-tokens 32 --edge-bits 8

`REFUSED` lists the JAX entry's flags the port does not run; it is empty.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .models import registry
from .monitoring import facade as monitoring
from .ops import _build
from .parallel import decode
from .sched.scheduler import sched_pipeline

# `tools/generate.py` flags this entry refuses, each with the ROADMAP
# item that ports it: flag -> (argparse keywords, item)
REFUSED: dict = {}
MONITOR_KEY = "decode"


def prompt_ids(args, cfg) -> np.ndarray:
    """Synthetic prompt token ids [B, prompt_len] (seeded, as the JAX
    package's CLI draws them)."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(args.batch_size, args.prompt_len))


def print_summary(args, dt: float, result: np.ndarray, label: str) -> None:
    print(f"generated {args.batch_size}x{args.new_tokens} tokens in "
          f"{dt:.3f}s = {args.batch_size * args.new_tokens / dt:.1f} tok/s "
          f"({label})")
    print("sample continuation ids:", result[0, args.prompt_len:].tolist())


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Pipelined KV-cache generation (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-m", "--model-name", default="gpt2",
                        choices=[n for n in registry.get_model_names()
                                 if registry.get_model_config(n).model_type
                                 in registry.DECODER_TYPES])
    parser.add_argument("-M", "--model-file", default=None,
                        help="weights (.npz, HF state-dict keys of the family)")
    parser.add_argument("-pt", "--partition", default=None,
                        help="comma-separated layer ranges, e.g. 1,24,25,48 "
                             "(default: single stage)")
    parser.add_argument("-b", "--batch-size", default=4, type=int)
    parser.add_argument("--prompt-len", default=16, type=int)
    parser.add_argument("--new-tokens", default=32, type=int)
    parser.add_argument("--max-len", default=None, type=int,
                        help="cache capacity (default: prompt+new tokens)")
    parser.add_argument("-t", "--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--kv-bits", default=0, type=int, choices=[0, 8],
                        help="int8-quantize the KV cache (0 = full "
                             "precision)")
    parser.add_argument("--attend-floor", default=64, type=int,
                        help="smallest bucketed attend window: decode steps "
                             "attend over the least power-of-2 window >= "
                             "the live cache length")
    parser.add_argument("--temperature", default=0.0, type=float,
                        help="sampling temperature (0 = greedy)")
    parser.add_argument("--top-k", default=0, type=int,
                        help="sample only from the k most likely tokens "
                             "(0 = full distribution)")
    parser.add_argument("--seed", default=0, type=int,
                        help="sampling generator seed")
    parser.add_argument("--beams", default=0, type=int,
                        help="beam-search width (0 = greedy/sampling)")
    parser.add_argument("--prefill-ubatch", default=None, type=int,
                        help="run the prompt pass in batch chunks of this "
                             "size")
    parser.add_argument("--shared-prefix", default=0, type=int,
                        help="treat the first N prompt tokens as a prefix "
                             "shared by every batch row, prefilled once "
                             "and reused; the suffixes run as one span")
    parser.add_argument("--draft-model", default=None,
                        choices=[n for n in registry.get_model_names()
                                 if registry.get_model_config(n).model_type
                                 in registry.DECODER_TYPES],
                        help="speculative decoding: this (smaller, same-"
                             "vocabulary) model proposes --gamma tokens "
                             "per round and the target verifies them in "
                             "one span; tokens equal plain greedy")
    parser.add_argument("--gamma", default=4, type=int,
                        help="draft lookahead per speculative round")
    parser.add_argument("--concurrent", default=0, type=int,
                        help="continuous batching: decode this many "
                             "concurrent requests (each of -b sequences) "
                             "through the wave executor; tokens match "
                             "solo runs per request")
    parser.add_argument("--spmd-wave", action="store_true",
                        help="decode n_stages request slots as one wave "
                             "over the stages (stage i on card i mod the "
                             "card count), the tokens staying on the "
                             "device; greedy or --temperature sampling")
    parser.add_argument("--monitor", action="store_true",
                        help="record per-step heartbeats to decode.csv "
                             "(overwrites an existing decode.csv in cwd)")
    parser.add_argument("--rank", default=0, type=int,
                        help="this process's rank in a DCN fleet")
    parser.add_argument("--edge-bits", default=0, type=int,
                        choices=[0, 2, 4, 6, 8, 16],
                        help="quantize stage edges (QuantPipe activation "
                             "compression): DCN wire frames with "
                             "--dcn-addrs, or the [B, S, D] prompt hops "
                             "with --spmd-wave")
    parser.add_argument("--dcn-addrs", default=None, type=str,
                        help="comma-separated host:port per rank: run the "
                             "pipeline across OS processes over TCP (stage "
                             "i on rank i; launch the same command on every "
                             "rank with its own --rank)")
    parser.add_argument("--save-ids", default=None, metavar="NPZ",
                        help="also write every generated row's ids (key "
                             "`ids`, [B, prompt + new]; [N, B, ...] with "
                             "--concurrent, [K, B, ...] with --spmd-wave) "
                             "to NPZ; in a DCN fleet rank 0 "
                             "writes them")
    parser.add_argument("-sm", "--sched-models-file", default=None)
    parser.add_argument("-sdt", "--sched-dev-types-file", default=None)
    parser.add_argument("-sd", "--sched-dev-file", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    parser.add_argument("--tp", default=1, type=int,
                        help="Megatron tensor-parallel degree per stage "
                             "(head-sharded KV cache; the shards share the "
                             "cards round-robin)")
    parser.add_argument("--sp", default=1, type=int,
                        help="sequence-parallel PREFILL degree (causal ring "
                             "attention over the prompt; decode steps stay "
                             "single-device)")
    parser.add_argument("--ep", default=1, type=int,
                        help="expert-parallel degree for MoE models "
                             "(experts split over the shards per stage); "
                             "with --tp the tp x ep grid (attention "
                             "tp-split, experts ep-split)")
    for flag, (kw, item) in REFUSED.items():
        parser.add_argument(flag, default=argparse.SUPPRESS,
                            help=f"not ported yet (ROADMAP {item})", **kw)
    args = parser.parse_args(argv)
    # the refused flags at the JAX entry's defaults, for the composition
    # errors below (a refused flag that was given is refused after them)
    given = [flag for flag in REFUSED
             if hasattr(args, flag.lstrip("-").replace("-", "_"))]
    sp, ep = args.sp, args.ep
    spmd_wave = args.spmd_wave
    # the JAX entry's composition errors, word for word
    if args.new_tokens < 1:
        parser.error("--new-tokens must be >= 1")
    if args.beams and args.temperature > 0:
        parser.error("--beams and --temperature are mutually exclusive")
    if args.beams and args.monitor:
        parser.error("--monitor records per-step heartbeats only for "
                     "greedy/sampled generation, not --beams")
    if args.beams and args.prefill_ubatch:
        parser.error("--prefill-ubatch applies to greedy/sampled "
                     "generation, not --beams")
    if args.edge_bits and args.dcn_addrs is None and not spmd_wave:
        parser.error("--edge-bits applies to DCN stage edges or the SPMD "
                     "wave prefill hops; pass --dcn-addrs or --spmd-wave")
    if args.shared_prefix and (args.beams or spmd_wave
                               or args.prefill_ubatch
                               or args.dcn_addrs is not None):
        parser.error("--shared-prefix composes with plain, speculative, "
                     "or --concurrent greedy/sampled generation only "
                     "(not --beams/--spmd-wave/--prefill-ubatch/"
                     "--dcn-addrs)")
    if args.shared_prefix and not 0 < args.shared_prefix < args.prompt_len:
        parser.error(f"--shared-prefix must be in (0, {args.prompt_len})")
    if args.shared_prefix and sp > 1 and args.shared_prefix % sp:
        parser.error(f"--shared-prefix {args.shared_prefix} must divide "
                     f"by --sp {sp} (the prefix is what the sp "
                     "prefill runs on)")
    if spmd_wave and (args.concurrent or args.beams or args.monitor
                      or args.prefill_ubatch or args.tp > 1 or sp > 1
                      or ep > 1 or args.kv_bits
                      or args.dcn_addrs is not None):
        parser.error("--spmd-wave does not compose with --concurrent/"
                     "--beams/--monitor/--prefill-ubatch/--tp/--sp/--ep/"
                     "--kv-bits/--dcn-addrs")
    if args.dcn_addrs is not None and (
            args.tp > 1 or sp > 1 or ep > 1 or args.kv_bits
            or args.monitor or args.beams or args.prefill_ubatch):
        parser.error("--dcn-addrs does not compose with --tp/--sp/--ep/"
                     "--kv-bits/--monitor/--beams/--prefill-ubatch in "
                     "this demo")
    if args.tp > 1 or sp > 1 or ep > 1:
        need = args.tp * ep if args.tp > 1 and ep > 1 else max(args.tp, sp,
                                                               ep)
        # the shards share the cards round-robin (parallel/mesh.py), so
        # only a host without one is short of devices
        if args.device == "cuda" and torch.cuda.device_count() < 1:
            parser.error(f"--tp/--sp/--ep {need} needs {need} devices, "
                         f"only {torch.cuda.device_count()} visible")
        if sp > 1 and (args.tp > 1 or ep > 1):
            parser.error("--sp is mutually exclusive with --tp/--ep in "
                         "this demo")
        if sp > 1 and args.prompt_len % sp:
            parser.error(f"--prompt-len {args.prompt_len} must divide by "
                         f"--sp {sp}")
    for flag in given:
        parser.error(f"{flag} is not ported to pipeedge_tpu_torch yet "
                     f"(ROADMAP {REFUSED[flag][1]})")
    if args.draft_model and (args.temperature > 0 or args.top_k
                             or args.beams or args.concurrent
                             or args.monitor or args.prefill_ubatch
                             or args.dcn_addrs is not None
                             or args.kv_bits):
        parser.error("--draft-model is greedy-exact speculative "
                     "decoding; it does not compose with sampling/"
                     "--beams/--concurrent/--monitor/--spmd-wave/"
                     "--prefill-ubatch/--dcn-addrs, nor --kv-bits "
                     "(int8 span verification is not bit-identical "
                     "to serial int8 steps)")
    if args.concurrent and (args.beams or args.monitor
                            or args.prefill_ubatch):
        parser.error("--concurrent composes with greedy/sampled "
                     "generation only (not --beams/--monitor/"
                     "--prefill-ubatch)")
    if args.partition:
        nums = [int(x) for x in args.partition.split(",")]
        if len(nums) % 2:
            parser.error(f"-pt needs an even count of layer bounds: {nums}")
        args.partition = list(zip(nums[::2], nums[1::2]))
    return args


def scheduled_partition(args):
    """The native scheduler's cut over the profiler's files (`-sm`,
    `-sdt`, `-sd`), rounded to whole blocks (decoding steps block by
    block); prints the rounding when it moved a cut."""
    total = registry.get_model_layers(args.model_name)
    # the profile records are keyed by (dtype, batch size)
    sched = sched_pipeline(args.model_name, 2, 2, args.batch_size,
                           dtype=args.dtype,
                           models_file=args.sched_models_file,
                           dev_types_file=args.sched_dev_types_file,
                           dev_file=args.sched_dev_file)
    if not sched:
        raise SystemExit("No viable schedule found")
    raw = [tuple(int(v) for v in layers)
           for stage in sched for layers in stage.values()]
    partition = decode.round_partition_to_blocks(raw, total)
    if partition != raw:
        print(f"scheduler partition {raw} rounded to block-aligned "
              f"{partition}")
    return partition


def _heartbeat(step, tokens) -> None:
    """`--monitor`'s per-token beat: wait for the token itself (a CUDA
    event recorded after it on its stream), then beat. The first beat
    sets the time base, so decode.csv holds new_tokens - 1 intervals."""
    del step
    if tokens.device.type == "cuda":
        torch.cuda.current_stream(tokens.device).record_event().synchronize()
    monitoring.iteration(MONITOR_KEY, work=int(tokens.shape[0]), safe=False)


def run_concurrent(args, pipe, ids: np.ndarray, p_len: int,
                   label: str) -> np.ndarray:
    """`--concurrent`: N requests of the same prompt batch (sampling seed
    `--seed` + request index) through one `ContinuousBatcher`, once to
    warm up and once timed; returns every request's ids, [N, B, S + new]
    (the shared prefix included)."""
    from .parallel.batcher import ContinuousBatcher
    handle = pipe.precompute_prefix(ids[:1, :p_len]) if p_len else None
    req_ids = ids[:, p_len:] if p_len else ids

    def run_batch():
        batcher = ContinuousBatcher(pipe)
        for req in range(args.concurrent):
            batcher.submit(req, req_ids, args.new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed + req, prefix=handle)
        return batcher, batcher.run()

    run_batch()                     # warm-up (kernel build)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    tik = time.monotonic()
    batcher, results = run_batch()      # host arrays: the tokens are in
    dt = time.monotonic() - tik
    outs = [results[r] for r in range(args.concurrent)]
    if p_len:
        outs = [np.concatenate([ids[:, :p_len], o], axis=1) for o in outs]
    n_tok = args.concurrent * args.batch_size * args.new_tokens
    shared = f", shared prefix {p_len}" if p_len else ""
    print(f"generated {args.concurrent}x{args.batch_size}x"
          f"{args.new_tokens} tokens in {dt:.3f}s = {n_tok / dt:.1f} "
          f"tok/s ({label}, continuous batching{shared}; "
          f"{batcher.stats['ticks']} ticks, "
          f"{batcher.stats['stage_steps']} stage-steps)")
    print("sample continuation ids:", outs[0][0, args.prompt_len:].tolist())
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    return np.stack(outs)


def run_dcn(args, cfg, partition, max_len: int, dtype) -> Optional[np.ndarray]:
    """Pipelined decoding across OS processes over TCP (`tools/generate.py
    run_dcn`): stage i runs on rank i, and every rank runs the same step
    count, so no control plane is needed. A stage's output edge is
    encoded on its device (`wire_encode_device`: kernel 1 at 4 and 8
    bits) and decoded on the next rank's (kernel 2). Each rank but the
    last owns one output edge; with `ADAPTIVE_QUANT` set it adapts that
    edge's bits on its own `send` telemetry window (`--edge-bits` is the
    start), and the consumer needs no coordination: the bits ride the
    wire header. Returns rank 0's ids [B, prompt + new], None elsewhere."""
    from . import resolve_device
    from . import runtime as runtime_mod
    from .comm import dcn, wire

    world = len(partition)
    rank = args.rank
    if not 0 <= rank < world:
        raise SystemExit(f"--rank {rank} outside the {world}-stage partition")
    total = registry.get_model_layers(args.model_name)
    decode.validate_partition(partition, total)
    decode.validate_capacity(cfg, max_len, args.prompt_len, args.new_tokens)
    device = resolve_device(args.device)
    addrs = dcn.parse_rank_addrs(args.dcn_addrs, world, 29600)
    l, r = partition[rank]
    _, params, sc = registry.module_shard_factory(
        args.model_name, args.model_file, l, r, stage=rank, dtype=dtype,
        device=device)
    family = registry.get_model_entry(args.model_name).family.FAMILY
    prefill_fn, decode_fn = decode.make_stage_fns(family, cfg, sc)
    pick = decode.make_token_picker(args.temperature, args.top_k)
    prompt = args.prompt_len
    ids = prompt_ids(args, cfg)
    launches0 = dict(_build.launch_counts)

    # this rank's output-edge bits and adaptive policy (the runtime's DCN
    # ranks use the same state and callback)
    edge = adaptive = None
    if world > 1 and not sc.is_last:
        edge = runtime_mod._EdgeQuantState(args.edge_bits)
        if os.getenv(runtime_mod.ENV_ADAPTIVE_QUANT):
            window = runtime_mod.get_window_size()
            monitoring.init(runtime_mod.MONITORING_KEY_SEND, window,
                            work_type="Mbits")
            monitoring.add_key(runtime_mod.MONITORING_KEY_RECV,
                               work_type="Mbits")
            adaptive = runtime_mod._make_adaptive_callback(
                [edge], window, [runtime_mod.MONITORING_KEY_SEND])
    step_beat = [0]
    result = None
    try:
        with dcn.DistDcnContext(world, rank, addrs) as ctx:
            if adaptive is not None:
                runtime_mod._register_dcn_monitor_hooks(ctx)

            def stage_step(data, pos, cache):
                if not sc.is_first:
                    data = wire.wire_decode(ctx.recv_tensors(rank - 1),
                                            dtype, device=device)
                # bucketed attend window: pos is fleet-lockstep, so every
                # rank picks the same bucket on its own
                if pos is None:
                    out, cache = prefill_fn(params, data, cache)
                else:
                    out, cache = decode_fn(
                        params, data, cache, pos,
                        read_len=decode.attend_bucket(pos + 1, max_len,
                                                      args.attend_floor))
                if not sc.is_last:
                    ctx.send_tensors(rank + 1, wire.wire_encode_device(
                        out, edge.quant_bit).finalize())
                    if adaptive is not None:
                        adaptive(step_beat[0], out)
                        step_beat[0] += 1
                elif world > 1:
                    # the last position's logits back to rank 0
                    last = out[:, -1] if pos is None else out[:, 0]
                    ctx.send_tensors(0, [last.float().cpu().numpy()],
                                     channel=dcn.CHANNEL_RESULTS)
                return out

            def run_once(new_tokens):
                """One fleet-lockstep generation (prefill and steps);
                returns rank 0's tokens."""
                cache = decode.init_cache(cfg, (r - l + 1) // 4,
                                          args.batch_size, max_len, dtype,
                                          device=device)
                gen = None
                if args.temperature > 0.0 and rank == 0:
                    gen = torch.Generator(device=device)
                    gen.manual_seed(args.seed)
                tokens = []

                def next_token(out, pos):
                    if world > 1:
                        logits = torch.as_tensor(
                            ctx.recv_tensors(world - 1,
                                             channel=dcn.CHANNEL_RESULTS)[0],
                            device=device)
                    else:
                        logits = out[:, prompt - 1] if pos is None \
                            else out[:, 0]
                    return pick(logits.float(), gen)

                first = (torch.as_tensor(ids, dtype=torch.long,
                                         device=device)
                         if sc.is_first else None)
                out = stage_step(first, None, cache)
                if rank == 0:
                    tokens.append(next_token(out, None))
                for step in range(1, new_tokens):
                    pos = prompt + step - 1
                    data = tokens[-1][:, None] if sc.is_first else None
                    out = stage_step(data, pos, cache)
                    if rank == 0:
                        tokens.append(next_token(out, pos))
                return tokens

            # warm up with the full token budget, so every attend bucket
            # the timed run crosses has run once
            run_once(args.new_tokens)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tik = time.monotonic()
            tokens = run_once(args.new_tokens)
            if rank == 0:
                result = np.concatenate(
                    [ids, torch.stack(tokens, dim=1).cpu().numpy()], axis=1)
                print_summary(args, time.monotonic() - tik, result,
                              f"{world} DCN ranks")
    finally:
        if adaptive is not None:
            monitoring.finish()
    runtime_mod.emit_line(
        f"rank={rank} kernel_launches="
        + json.dumps({k: v - launches0.get(k, 0)
                      for k, v in _build.launch_counts.items()},
                     sort_keys=True))
    return result


def run_spmd_wave(args, cfg, partition, max_len: int, dtype) -> np.ndarray:
    """`--spmd-wave` (`tools/generate.py run_spmd_wave`): n_stages request
    slots of `prompt_ids` through `SpmdDecodePipeline`, slot r sampling
    with seed `--seed` + r; one warm-up with the same token budget, then
    the timed call. Returns the ids [K, B, prompt_len + new_tokens]."""
    from .parallel import spmd
    from .parallel.spmd_decode import SpmdDecodePipeline

    n_stages = len(partition)
    mesh = spmd.make_pipeline_mesh(n_stages, device=args.device)
    stage_params = [registry.module_shard_factory(
        args.model_name, args.model_file, l, r, stage=i, dtype=dtype,
        device=mesh.cell(0, i).devices[0])[1]
        for i, (l, r) in enumerate(partition)]
    wave = SpmdDecodePipeline(
        registry.get_model_entry(args.model_name).family.FAMILY, cfg,
        partition, stage_params, mesh, max_len=max_len, dtype=dtype,
        edge_bits=args.edge_bits, attend_floor=args.attend_floor)
    # the solo and --concurrent runs' prompts, one copy per request slot
    wave_ids = np.stack([prompt_ids(args, cfg)] * n_stages)
    kw = dict(temperature=args.temperature, top_k=args.top_k,
              seeds=[args.seed + r for r in range(n_stages)])
    wave.generate(wave_ids, args.new_tokens, **kw).cpu()    # warm-up
    tik = time.monotonic()
    out = wave.generate(wave_ids, args.new_tokens, **kw).cpu().numpy()
    dt = time.monotonic() - tik
    n_tok = n_stages * args.batch_size * args.new_tokens
    print(f"generated {n_stages}x{args.batch_size}x{args.new_tokens} "
          f"tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s "
          f"({n_stages} stages, SPMD wave decode)")
    print("sample continuation ids:",
          out[0, 0, args.prompt_len:].tolist())
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    return out


def mesh_args(args):
    """The pipeline's mesh for `--tp/--sp/--ep` (`tools/generate.py`'s
    choice: the tp x ep grid when both are above 1, else the one axis
    given) over `devices_for`, and its report label."""
    from .parallel.mesh import ShardGrid, ShardGroup, devices_for
    if args.tp > 1 and args.ep > 1:
        grid = ShardGrid(devices_for(args.tp * args.ep, args.device),
                         args.tp, args.ep)
        return {"tp_ep_mesh": grid}, f", tp {args.tp} x ep {args.ep}"
    if args.tp > 1:
        return ({"mesh": ShardGroup(devices_for(args.tp, args.device))},
                f", tp {args.tp}")
    if args.sp > 1:
        return ({"sp_mesh": ShardGroup(devices_for(args.sp, args.device),
                                       "sp")}, f", sp {args.sp}")
    if args.ep > 1:
        return ({"ep_mesh": ShardGroup(devices_for(args.ep, args.device),
                                       "ep")}, f", ep {args.ep}")
    return {}, ""


def run(args) -> np.ndarray:
    """Build the pipeline, warm it up, time one generation and print the
    report lines; returns the generated ids [B, prompt_len + new_tokens]
    ([N, B, ...] with `--concurrent N`, [K, B, ...] with `--spmd-wave`
    over K stages)."""
    cfg = registry.get_model_config(args.model_name)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.partition:
        partition = args.partition
    elif args.sched_models_file:
        partition = scheduled_partition(args)
    else:
        partition = [(1, registry.get_model_layers(args.model_name))]
    max_len = args.max_len or args.prompt_len + args.new_tokens
    if args.draft_model and args.max_len is None:
        max_len += args.gamma   # verify spans write past the last token
    if args.dcn_addrs is not None:
        return run_dcn(args, cfg, partition, max_len, dtype)
    if args.spmd_wave:
        return run_spmd_wave(args, cfg, partition, max_len, dtype)
    meshes, label = mesh_args(args)
    pipe = decode.build_decode_pipeline(
        args.model_name, partition, max_len=max_len,
        dtype=dtype, cache_bits=args.kv_bits,
        attend_floor=args.attend_floor, model_file=args.model_file,
        device=args.device, **meshes)
    ids = prompt_ids(args, cfg)
    p_len = args.shared_prefix
    label = f"{len(partition)} stages" + label
    spec = None
    if p_len:
        ids[:, :p_len] = ids[0, :p_len]
        prefix = torch.as_tensor(ids[:, :p_len], device=pipe.device)
    if args.concurrent:
        return run_concurrent(args, pipe, ids, p_len, label)
    if args.draft_model:
        from .parallel.speculative import SpeculativeDecoder
        d_pipe = decode.build_decode_pipeline(
            args.draft_model, None, max_len=max_len, dtype=dtype,
            attend_floor=args.attend_floor, device=args.device)
        spec = SpeculativeDecoder(pipe, d_pipe, gamma=args.gamma)
        label += (f", speculative gamma={args.gamma} "
                  f"draft={args.draft_model} sync={spec.sync}")
        if p_len:
            handle = spec.precompute_prefix(ids[:1, :p_len])

            def gen(n):
                return torch.cat([prefix, spec.generate(
                    ids[:, p_len:], n, prefix=handle)], dim=1)
            label += f", shared prefix {p_len}"
        else:
            def gen(n):
                return spec.generate(ids, n)
    elif args.beams:
        def gen(n):
            return pipe.generate_beam(ids, n, beams=args.beams)
        label += f", beam {args.beams}"
    elif p_len:
        handle = pipe.precompute_prefix(ids[:1, :p_len])

        def gen(n, cb=None):
            out = pipe.generate(ids[:, p_len:], n, prefix=handle,
                                temperature=args.temperature,
                                top_k=args.top_k, seed=args.seed,
                                step_callback=cb)
            return torch.cat([prefix, out], dim=1)
        label += f", shared prefix {p_len} (prefilled once)"
    else:
        def gen(n, cb=None):
            return pipe.generate(ids, n, temperature=args.temperature,
                                 top_k=args.top_k, seed=args.seed,
                                 prefill_ubatch=args.prefill_ubatch,
                                 step_callback=cb)
    gen(min(2, args.new_tokens))            # warm-up (kernel build)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    if args.monitor:      # greedy/sampled only (parse_args): gen takes cb
        monitoring.init(MONITOR_KEY, window_size=16, work_type="tokens")
    tik = time.monotonic()
    try:
        out = (gen(args.new_tokens, _heartbeat) if args.monitor
               else gen(args.new_tokens))
        out = out.cpu().numpy()       # the copy waits for the card
    finally:
        if args.monitor:
            monitoring.finish()
    dt = time.monotonic() - tik
    if spec is not None:
        rate = spec.last_acceptance_rate
        rounds = (spec.last_sync_count - 1) // (
            2 if spec.sync == "device" else args.gamma + 1)
        label += (" acceptance=" + (f"{rate:.2f}" if rate is not None
                                    else "n/a")
                  + f" syncs={spec.last_sync_count} rounds={rounds}")
    print_summary(args, dt, out, label)
    print("kernel_launches=" + json.dumps(_build.launch_counts,
                                          sort_keys=True))
    return out


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    args = parse_args(argv)
    result = run(args)
    if args.save_ids and result is not None:
        np.savez(args.save_ids, ids=result)
    return result


if __name__ == "__main__":
    main()
