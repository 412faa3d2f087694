"""Pipelined KV-cache text generation (GPT-2 family), the port's entry.

The local path of the repository's `tools/generate.py`, on PyTorch:

    python -m pipeedge_tpu_torch.generate -m gpt2 -pt 1,24,25,48 -b 16 \\
        --prompt-len 192 --new-tokens 128 --max-len 1024 --kv-bits 8

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
from .ops import _build
from .parallel import decode


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
                                 == "gpt2"])
    parser.add_argument("-M", "--model-file", default=None,
                        help="weights (.npz, HF GPT-2 state-dict keys)")
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
                                 == "gpt2"],
                        help="speculative decoding: this (smaller, same-"
                             "vocabulary) model proposes --gamma tokens "
                             "per round and the target verifies them in "
                             "one span; tokens equal plain greedy")
    parser.add_argument("--gamma", default=4, type=int,
                        help="draft lookahead per speculative round")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu their "
                             "plain versions")
    args = parser.parse_args(argv)
    if args.new_tokens < 1:
        parser.error("--new-tokens must be >= 1")
    if args.beams and args.temperature > 0:
        parser.error("--beams and --temperature are mutually exclusive")
    if args.beams and args.prefill_ubatch:
        parser.error("--prefill-ubatch applies to greedy/sampled "
                     "generation, not --beams")
    if args.shared_prefix and (args.beams or args.prefill_ubatch):
        parser.error("--shared-prefix composes with plain greedy/sampled "
                     "generation only (not --beams/--prefill-ubatch)")
    if args.shared_prefix and not 0 < args.shared_prefix < args.prompt_len:
        parser.error(f"--shared-prefix must be in (0, {args.prompt_len})")
    if args.draft_model and (args.temperature > 0 or args.top_k
                             or args.beams or args.prefill_ubatch
                             or args.kv_bits):
        # the JAX entry's text, which also names its flags the port's
        # entry does not have (--concurrent, --monitor, --spmd-wave,
        # --dcn-addrs)
        parser.error("--draft-model is greedy-exact speculative "
                     "decoding; it does not compose with sampling/"
                     "--beams/--concurrent/--monitor/--spmd-wave/"
                     "--prefill-ubatch/--dcn-addrs, nor --kv-bits "
                     "(int8 span verification is not bit-identical "
                     "to serial int8 steps)")
    if args.partition:
        nums = [int(x) for x in args.partition.split(",")]
        if len(nums) % 2:
            parser.error(f"-pt needs an even count of layer bounds: {nums}")
        args.partition = list(zip(nums[::2], nums[1::2]))
    return args


def run(args) -> np.ndarray:
    """Build the pipeline, warm it up, time one generation and print the
    report lines; returns the generated ids [B, prompt_len + new_tokens]."""
    cfg = registry.get_model_config(args.model_name)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    partition = args.partition or [
        (1, registry.get_model_layers(args.model_name))]
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

        def gen(n):
            out = pipe.generate(ids[:, p_len:], n, prefix=handle,
                                temperature=args.temperature,
                                top_k=args.top_k, seed=args.seed)
            return torch.cat([prefix, out], dim=1)
        label += f", shared prefix {p_len} (prefilled once)"
    else:
        def gen(n):
            return pipe.generate(ids, n, temperature=args.temperature,
                                 top_k=args.top_k, seed=args.seed,
                                 prefill_ubatch=args.prefill_ubatch)
    gen(min(2, args.new_tokens))            # warm-up (kernel build)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    tik = time.monotonic()
    out = gen(args.new_tokens).cpu().numpy()   # the copy waits for the card
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
