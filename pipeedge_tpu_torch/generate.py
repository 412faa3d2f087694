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

The JAX entry's flags for other device layouts are refused at parse time
with the ROADMAP item that ports them (`REFUSED`): `--edge-bits`,
`--dcn-addrs` and `--rank` (the DCN fleet, A6b), `--tp`, `--sp`, `--ep`
and `--spmd-wave` (the multi-GPU axes, A7).
"""
from __future__ import annotations

import argparse
import json
import logging
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
_DCN = "A6b, generate over the DCN transport"
_AXES = "A7, the multi-GPU axes"
REFUSED = {
    "--edge-bits": ({"type": int}, _DCN),
    "--dcn-addrs": ({}, _DCN),
    "--rank": ({"type": int}, _DCN),
    "--tp": ({"type": int}, _AXES),
    "--sp": ({"type": int}, _AXES),
    "--ep": ({"type": int}, _AXES),
    "--spmd-wave": ({"action": "store_true"}, _AXES),
}
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
    parser.add_argument("--monitor", action="store_true",
                        help="record per-step heartbeats to decode.csv "
                             "(overwrites an existing decode.csv in cwd)")
    parser.add_argument("-sm", "--sched-models-file", default=None)
    parser.add_argument("-sdt", "--sched-dev-types-file", default=None)
    parser.add_argument("-sd", "--sched-dev-file", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    for flag, (kw, item) in REFUSED.items():
        parser.add_argument(flag, default=argparse.SUPPRESS,
                            help=f"not ported yet (ROADMAP {item})", **kw)
    args = parser.parse_args(argv)
    for flag, (_, item) in REFUSED.items():
        if hasattr(args, flag.lstrip("-").replace("-", "_")):
            parser.error(f"{flag} is not ported to pipeedge_tpu_torch yet "
                         f"(ROADMAP {item})")
    # the JAX entry's composition errors, word for word (some name its
    # flags that are refused above)
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
    if args.shared_prefix and (args.beams or args.prefill_ubatch):
        parser.error("--shared-prefix composes with plain, speculative, "
                     "or --concurrent greedy/sampled generation only "
                     "(not --beams/--spmd-wave/--prefill-ubatch/"
                     "--dcn-addrs)")
    if args.shared_prefix and not 0 < args.shared_prefix < args.prompt_len:
        parser.error(f"--shared-prefix must be in (0, {args.prompt_len})")
    if args.draft_model and (args.temperature > 0 or args.top_k
                             or args.beams or args.concurrent
                             or args.monitor or args.prefill_ubatch
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


def run(args) -> np.ndarray:
    """Build the pipeline, warm it up, time one generation and print the
    report lines; returns the generated ids [B, prompt_len + new_tokens]
    ([N, B, ...] with `--concurrent N`)."""
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
    pipe = decode.build_decode_pipeline(
        args.model_name, partition, max_len=max_len,
        dtype=dtype, cache_bits=args.kv_bits,
        attend_floor=args.attend_floor, model_file=args.model_file,
        device=args.device)
    ids = prompt_ids(args, cfg)
    p_len = args.shared_prefix
    label = f"{len(partition)} stages"
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
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
