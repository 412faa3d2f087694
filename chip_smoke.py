#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`pipeedge_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--ab-parent DIR] [--ab-entry-parent ROOT]
                          [--profiles-out DIR]

Phases, each of which raises on failure (nothing is caught):
  1. card and toolchain: `nvidia-smi` name and power limit, torch and CUDA;
  2. build: compile the kernels of `pipeedge_tpu_torch/csrc/` for sm_90a;
  3. kernels against their plain PyTorch versions on the card, and their
     times beside the plain version's, a library call's and the bound:
     - edge codec encode/decode, bits 4 and 8, at ViT-Base's edge
       [8, 197, 768], an odd tail [3, 37], items whose slices outgrow
       shared memory ([2, 605184], [2, 605189]), items scaled from 1e-30
       to 1e30 ([64, 151296]), a zero-range item, items holding NaN,
       +inf, -inf, both infinities and a range past the f32 maximum
       ([6, 151296], [6, 37]) and more items than a grid axis takes
       ([65537, 37]): words bit-identical, scale, shift and decoded
       values too (NaN counted equal to NaN); one device kernel per
       encode and per decode call; the encode also timed at the other
       cluster size (16 blocks per item);
     - attention at [96, 197, 64] f32, [128, 257, 80] f32 (ViT-H), causal
       [8, 1024, 64] f32, [96, 197, 64] bf16, S = 1, S = 65 (one row past
       a tile), causal [96, 197, 64] f32, the main path's strided
       [8, 197, 12, 64] in bf16 and f32, and the strided shapes of phases
       8 and 9: DeiT-B [8, 198, 12, 64], DeiT-S [8, 198, 6, 64], BERT-B
       [8, 64, 12, 64] f32 and the tiny BERT's head dim 8 [8, 64, 4, 8]
       in f32 and bf16, and phase 10's ViT-L [8, 197, 16, 64] f32,
       within the tolerances stated below, each timed beside SDPA;
     - the plain codec on the card at every bitwidth an adaptive policy
       can pick (32, 16, 10, 8, 6, 5, 4, 3, 2) at the edges of phases 8
       and 9, DeiT-B's [8, 198, 768] and BERT-Base's [8, 64, 768]: words,
       scale, shift and decoded values identical to the CPU's; at bits 4
       and 8 the kernels launch once per call and equal the plain codec
       on the same input bit for bit; each timed;
     - the block-scaled int8 matmul, bit-identical to its plain version,
       at the main path's three dense shapes, ragged M and N, K = 100 (a
       block of all of K), K = 80 (half a k-step of padding), K = 192
       (blocks of 96), K = 320 (blocks of 80), M = 1, all-zero blocks and
       channels, a saturating outlier, and the tunnel's input (the wire
       words' bytes read in place at [8 * 197, 768] into N = 768 and
       3072), each case naming the kernel it ran (the main path's shapes
       and the tunnel must run the wgmma kernel); beside its time, the
       plain activation quantizer's, an f32 `addmm` of the same dense
       (what the route replaces) and `torch._int_mm` on the same codes
       (the whole-K int32 product: not the same function);
     - with `--ab-parent DIR` (a `csrc/` of another version, e.g. the
       parent commit's unpacked under the gitignored `_build/`), that
       version's attention, int8, decode-attention (main_w256/512/1024,
       warm and L2-cold), encode and decode (bits 8 and 4) kernels are
       built beside these and timed on the same inputs in the order
       parent, this, this, parent (the `paired` ratios of the kernels
       line);
  4. the main path: ViT-Base at full width (seeded random weights in the
     Google npz format) through `parallel.pipeline.build_pipeline`, two
     stages cut at `-pt 1,21,22,48` (a (ctx, residual) 2-tuple edge),
     batch 64 in microbatches of 8, f32, at edge bits 0, 8 and 4:
     - bit 0: the logits equal the single-shard forward on the card;
     - bits 8 and 4: the logits lie within the stated bound;
     - launch counts: 12 attention launches per microbatch, and 2 encode
       plus 2 decode launches per quantized microbatch;
     then one more pass with an 8-bit edge under torch.profiler: device
     time by kernel and the device's busy share;
  5. the int8 compute path (`QuantizeCompute`) on the same pipeline:
     (a) int8 denses with exact edges, (b) with an 8-bit edge and clamp
     alphas calibrated on the first microbatch (utils/calibrate.py), (c)
     as (b) with the stage-seam tunnel, where stage 1's first dense eats
     the 8-bit `ctx` payload without a decode:
     - exactly 72 int8 matmul launches per microbatch (6 tagged denses x
       12 blocks), 2 encode and 2 decode (b) or 1 decode (c) launches;
     - the logits within the stated bound of the exact ones, top-1
       agreement and items/s printed beside the exact runs;
     then one profiled pass of (c);
  6. the decode main path: GPT-2 at full width and depth (seeded random
     weights in the HF `GPT2LMHeadModel` npz layout, read by
     `load_params`), two stages `-pt 1,24,25,48`, batch 16, a 192-token
     prompt, 128 new tokens, max_len 1024, attend floor 64, f32, through
     `DecodePipeline.generate`: (i) fp cache, (ii) int8 cache on the
     decode-attention kernel route, (iii) int8 cache on the dequantize-
     then-attend route:
     - (i)'s step logits within the stated bound of the full-sequence
       forward (`shard_apply`, the causal fused attention) on its tokens;
     - (ii) and (iii) in lockstep on (ii)'s greedy tokens: every step's
       logits within the stated bound, and each step's time per attend
       bucket (256, 512) on both routes;
     - launch counts: 12 decode-attention launches per decode step in
       (ii), 127 x 12 = 1524 per generation, none in (i) and (iii);
     then one profiled decode step of (ii) and of (iii), and the entry
     `python -m pipeedge_tpu_torch.generate ... --kv-bits 8` once with
     PIPEEDGE_INT8_DECODE_ATTEND=1;
  7. the tiny GPT-2 (`pipeedge/test-tiny-gpt2`, head dim 8, seeded random
     weights made in-process), two stages, batch 4, a 16-token prompt, 32
     new tokens, int8 cache, on the kernel route (ii) and the dequantize
     route (iii): greedy tokens identical, 2 decode-attention launches
     per step on (ii) and none on (iii), and the two in lockstep within
     the (ii)/(iii) bound;
  8. DeiT-Base (`facebook/deit-base-distilled-patch16-224`, BASELINE
     config 5) at full width and depth (seeded `init_params` weights in
     the torch-hub npz keys, qkv fused), 8 stages of 6 sublayers, batch
     64 in microbatches of 8, f32:
     - edge bits 0, 8 and 4 on all 7 edges: bit 0 equal to the
       single-shard forward, 8 and 4 within the stated bounds; 12
       attention launches per microbatch, 7 encode and 7 decode launches
       per quantized microbatch;
     - one profiled pass at 8 bits;
     - an unconstrained pass through the runtime's own monitoring and
       callbacks (`runtime.init_monitoring`, `attach_callbacks`) measures
       edge 0's rate; then ADAPTIVE_QUANT = HEURISTIC, HEURISTIC2 and
       CONTROLLER with WINDOW_SIZE 2 against a SEND_CONSTRAINT of
       ADAPTIVE_SHARE times that rate. Each microbatch's bits per edge
       are read from the wire bytes `edge_bytes_callback` reports (each
       bitwidth gives other bytes at a fixed shape) and printed; at least
       one policy must move an edge off 8 bits; the codec launches must
       equal the edge-microbatches that travelled at 4 or 8 bits; each
       microbatch's logits must equal, bit for bit, its replay through
       the same pipeline at the bits it travelled with (a second
       replay only for a microbatch whose first replay differs);
     - `python -m pipeedge_tpu_torch.runtime` once, 8 stages, HEURISTIC;
  9. BERT-Base CoLA (`textattack/bert-base-uncased-CoLA`, BASELINE config
     4) at full width (vocab 30522, 2 labels, 64 int32 token ids per
     item): `python -m pipeedge_tpu_torch.runtime 0 2 -m ... -pt
     1,24,25,48 -q 8,0 -b 64 -u 8` as a subprocess (12 attention
     launches per microbatch, one encode and one decode per microbatch);
     then in process, seeded weights in the HF npz keys, the 2-stage
     pipeline at bit 0 equal to the single-shard forward and at 8 bits
     within the stated bound, one profiled pass at 8 bits; then the tiny
     BERT (head dim 8, stages 1-4 and 5-8, exact edges) on the card
     against its run on the CPU within the f32 attention tolerance;
 10. PipeEdge's own loop, BASELINE config 3: `pipeedge_tpu_torch.profiler`
     profiles every sublayer of ViT-Base and ViT-Large at full width and
     depth (f32, microbatch 8, seeded random npz weights) into a
     temporary directory: the layer count (48, 96), contiguous layers,
     each layer's output shapes equal to the next one's inputs, finite
     positive times, memory at least the layer's parameters. The
     converters make models.yml and device_types.yml (type `h100`: the
     card's memory in MiB, 450 GB/s of NVLink 4 in Mbit/s), devices.yml
     names four hosts, and the native `sched-pipeline` (built from
     `native/` by the port) must give 4 stages covering 1..96, one per
     host. `python -m pipeedge_tpu_torch.runtime 0 4 -m
     google/vit-large-patch16-224 -M ... -sm -sdt -sd -H ... -b 64 -u 8
     --measure-rounds 2 --save-results ...` must exit 0, log the
     scheduler's partition and hosts, launch kernel 3 24 times per
     microbatch and save logits equal, bit for bit, to the single-shard
     forward of the same weights on the same inputs. The scheduler's
     predicted items/s (microbatch over the slowest stage's profile
     time), the one-card prediction (over the sum of the stages' times)
     and the measured steady items/s are printed side by side. Then
     BASELINE configs 1 (`0 1`) and 2 (`-pt 1,24,25,48`) of ViT-Base
     through the entry, rc 0 each. With `--profiles-out DIR` the
     profiles and scheduler files are also written to DIR, each opening
     with a comment line naming the card and its power limit.
 11. GPT-2 serving at full width (`pipeedge_tpu_torch/serve.py`, in
     process: `make_handler` behind its `ThreadingHTTPServer` on
     127.0.0.1), phase 6's weights, `-pt 1,24,25,48 --max-len 1024 -t
     float32 --kv-bits 8 --int8-decode-attend auto --max-active 16`:
     16 concurrent clients (seeded prompts [1, 64..256], 16..48 new
     tokens, greedy; 4 streamed, 4 on a 128-token prefix registered
     through /prefix, 2 with an eos token their solo run emits partway,
     one batched [4, 128] with 64 new tokens), once on the wave executor
     and once on the stage executor, then 4 requests on an fp cache
     (wave). Every served result equals, bit for bit, the request's solo
     `DecodePipeline.generate` on an oracle pipeline loaded from the same
     npz (eos masking applied to the solo run); each streamed request's
     step lines equal its final line; decode-attention launches equal 12
     x the single-token decode waves the executor reports and
     Sum(new tokens - 1) over the traffic (none on the fp cache, and no
     other kernel); /metrics' `pipeedge_serve_tokens_total` and
     `pipeedge_serve_requests_total{endpoint="/generate",status="200"}`
     move by the traffic's rows x new tokens and request count; /healthz
     names the executor (and the stage workers' stats). Printed per run:
     aggregate tokens/s, first-token ms and latency p50/p95, launches;
     one profiled pass of 4 wave ticks; the host's cost per launch of
     one-element adds from one thread against two at once; then `python -m
     pipeedge_tpu_torch.serve` once as a subprocess: its readiness line,
     one /generate equal to the oracle, /healthz, and exit code 0 after
     SIGTERM.
 12. The paged KV plane (`pipeedge_tpu_torch/kv/`) under phase 11's int8
     server and weights, with `--kv-pages 1024 --kv-page-size 16
     --chunked-prefill 64 --step-join` (PAGED_* below), on the wave and
     then the stage executor: 19 concurrent clients (phase 11's int8
     traffic but its 4 prefix clients; a publisher whose prompt is
     exactly the 128-token prefix, served alone first; 4 sharers whose
     prompts start with it; one 512-token prompt in 8 chunks; one request
     of 16 tokens in all, one page). Every result equals, bit for bit,
     its solo run through a dense wave executor that chunks as the
     server does; decode-attention launches equal 12 x (the decode waves
     + the one-token prompt chunks); the trie reports at least 4 hits in
     each run; after the traffic and an eviction of the cold prefix
     pages the pool has every page free, nothing leaked, and /metrics'
     `pipeedge_kv_pages{state="free"}` equals the total. Printed: the
     runs' tokens/s, latency and first-token ms, the stage/wave ratio,
     and the launches and device time per profiled wave tick of 4
     requests, dense and paged.
 13. Speculative decoding: gpt2-medium at full width and depth (seeded
     npz, 1.4 GB f32) verifying, gamma 4, f32, [4, 128] prompts, 64 new
     tokens, the drafts of (a) gpt2 (phase 6's npz) and (b) gpt2-medium
     itself with seeded noise on its last block's weight matrices (a
     draft that agrees on some proposals and not on others, so rounds
     accept 0 < a < gamma tokens and roll the draft back), each in host
     and in device sync, timed in pairs (host, device, device, host,
     twice); then (c) gpt2-medium as its own draft. Every generation is
     held to the target's greedy `generate` by the rule of `spec_rule`
     (CHANGES.md); its verify rounds are counted at the target's
     `extend` and held to its readbacks (1 + (gamma + 1) per round in
     host sync, 1 + 2 per round in device sync) and to its acceptance;
     host and device sync with the same acceptance and rounds; (b)'s
     acceptance strictly between 0 and 1, (c)'s 1.0; the measured
     span-vs-serial logit difference printed. Then 4 `"speculative":
     true` requests through the in-process server with `--draft-model
     gpt2 --kv-pages 1024`, each equal to plain greedy, both pools whole
     afterwards; then `python -m pipeedge_tpu_torch.generate -m
     gpt2-medium --draft-model gpt2 --gamma 4`, exit code 0. Printed:
     acceptance, readbacks per round, tokens/s against plain greedy.
Phase 3 also holds kernel 5 (decode attention) against its plain version
at the main path's shapes (windows of a [16, 1024, 12, 64] stage cache at
buckets 256 and 512, and pos 1000 of the whole cache), pos 0 and W-1,
W = 100, B = 1, H = 16, Dh = 32, Dh = 8 (f32 and bf16; B 16, H 4, W 64),
B = 65537 (W 16, H 1, Dh 16), a zero-range K row and bf16, timed beside
the dequantize-then-attend route and SDPA over the dequantized window; the
main cases warm and with a cold L2 (the calls rotate over copies of the
cache that together stream more than the L2), and the host's split rule
held to the library's.
Each phase prints its wall time. With `--ab-entry-parent ROOT` (another
checkout's root, e.g. the parent commit's unpacked under the gitignored
`pipeedge_tpu_torch/_build/`), the ViT entry of the runtime (`-pt
1,21,22,48 -q 8,0 -b 64 -u 8`, 5 rounds) then runs from that checkout and
from this one in the order parent, this, this, parent, twice, and each
run's items/s is printed.
Then one `{"kernels": [...]}` JSON line and, last, the device line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.

Exits nonzero, and prints no result, without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = "google/vit-base-patch16-224"
PARTITION = [(1, 21), (22, 48)]
BATCH, UBATCH = 64, 8

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
# f32 attention at f32 accuracy on the tensor cores: 3xTF32 takes three
# TF32 products (495 TFLOP/s dense) per f32 product, so 165 TFLOP/s; the
# attention kernel runs it that way, so its bound uses this rate, not the
# CUDA-core rate (67), which a kernel on the tensor cores can beat
ATTN_F32_FLOPS = 495e12 / 3
ATTN_PEAK_FLOPS = {torch.float32: ATTN_F32_FLOPS,
                   torch.bfloat16: PEAK_FLOPS[torch.bfloat16]}

# Kernel vs plain version on the card. Codec: bit-identical (same IEEE
# ops, no contraction, round half to even). Attention: online vs dense
# softmax sum in different orders; the plain version's f32 matmuls run in
# full f32 (TF32 off, set below). bf16: both round the same f32 result to
# bf16, which may land one bf16 ulp (2^-8 relative) apart.
ATTN_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}

# Quantized-edge logits against the exact single-shard logits, as a share
# of max |exact logit|. The JAX package's own pipeline test bounds 8-bit
# edge logits at 0.5 of that scale (tests/test_pipeline.py); here 8 bits
# must stay within 0.1 and 4 bits (16x coarser steps) within 0.5, and the
# 4-bit error must exceed the 8-bit one, which must exceed zero.
LOGIT_BOUND = {8: 0.1, 4: 0.5}

# Int8-compute logits against the exact single-shard logits, as a share of
# max |exact logit|. The JAX package gates one int8 dense at 0.05 relative
# error (tests/test_int8_matmul.py); through the 72 int8 denses of ViT-Base
# the error grows with depth, roughly as its square root (LayerNorm
# renormalizes each block's input), not as their sum. Bounds: 0.15 with
# exact edges (a), 0.2 with an 8-bit edge on top (b, c; the edge alone
# stays within 0.1, above). Random
# weights leave the 1000 logits close together, so top-1 agreement with
# exact is printed, not gated.
INT8_LOGIT_BOUND = {"a": 0.15, "b": 0.2, "c": 0.2}

REPLACES = {
    "fused_encode": "pipeedge_tpu/ops/fused_quant.py:115",
    "fused_decode": "pipeedge_tpu/ops/fused_quant.py:153",
    "fused_attention": "pipeedge_tpu/ops/attention.py:92",
    "int8_matmul": "pipeedge_tpu/ops/int8_matmul.py:129",
    "decode_attention": "pipeedge_tpu/ops/decode_attention.py:198",
}
SOURCES = {
    "fused_encode": "pipeedge_tpu_torch/csrc/fused_quant.cu",
    "fused_decode": "pipeedge_tpu_torch/csrc/fused_quant.cu",
    "fused_attention": "pipeedge_tpu_torch/csrc/attention.cu",
    "int8_matmul": "pipeedge_tpu_torch/csrc/int8_matmul.cu",
    "decode_attention": "pipeedge_tpu_torch/csrc/decode_attention.cu",
}
INT8_PEAK_OPS = 1979e12                 # dense int8 tensor cores, 700 W

# Phase 6, the decode main path: GPT-2 at full width and depth, two
# stages, batch 16, a 192-token prompt and 128 new tokens in a 1024-row
# cache, so the decode steps attend buckets 256 and 512.
DECODE_MODEL = "gpt2"
DECODE_PARTITION = [(1, 24), (25, 48)]
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 16, 192, 128
DECODE_MAX_LEN, DECODE_FLOOR = 1024, 64

# Kernel 5 against its plain version. f32: the JAX package's bound for its
# TPU kernel (rtol = atol = 2e-5, tests/test_decode_attention.py); the
# kernel takes the affine dequantization out of its products (s (q . u) +
# z sum q) and sums the softmax in another order, each a few ulp of f32.
# bf16: K, V and the softmax
# numerators round to bf16 (2^-8 relative) against different running
# maxima, so outputs may sit a bf16 ulp or two apart.
DECODE_ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
                   torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}

# Decode logits, as a share of max |logit|. (i) fp cache against the
# full-sequence forward over the same tokens: f32 on both sides, but the
# attends (an einsum over the cache vs the causal fused kernel) and the
# matmuls (M = 16 rows per step vs 16 x 319) sum in other orders; a few
# ulp per op through 12 blocks stays far below 1e-4. (ii) kernel route
# against (iii) dequantize-then-attend route in lockstep: the same int8
# cache rows (bit-identical dequantization), softmax sums in another
# order, and a last-bit difference may flip an int8 code of a later row;
# held to 1e-3.
DECODE_FP_BOUND = 1e-4
DECODE_ROUTE_BOUND = 1e-3

# Phase 7, the tiny GPT-2 (hidden 32, 4 heads: head dim 8, the one decoder
# of the registry whose head dim is not 64) through both int8 routes: two
# stages of one block each, batch 4, a 16-token prompt, 32 new tokens.
TINY_DECODE_MODEL = "pipeedge/test-tiny-gpt2"
TINY_DECODE_PARTITION = [(1, 4), (5, 8)]
TINY_DECODE_BATCH, TINY_DECODE_PROMPT, TINY_DECODE_NEW = 4, 16, 32

# Phase 8, BASELINE config 5: DeiT-Base distilled at full width and depth
# in 8 stages of 6 sublayers (7 single-tensor edges), batch 64 in
# microbatches of 8, f32, every edge starting at 8 bits. The adaptive runs
# adapt every ADAPTIVE_WINDOW microbatches against a send constraint of
# ADAPTIVE_SHARE times the items/s the unconstrained run's edge 0 carried
# (SEND_CONSTRAINT is in items/s), a rate the pipeline does not reach, so
# each policy must compress further. Each adaptive microbatch's logits
# must equal its replay at the bits it travelled with; REPLAY_BOUND (of
# max |logit|) applies only if the fixed-bit replay is not itself
# repeatable on the card.
DEIT_MODEL = "facebook/deit-base-distilled-patch16-224"
DEIT_PARTITION = [(6 * i + 1, 6 * i + 6) for i in range(8)]
ADAPTIVE_WINDOW = 2
ADAPTIVE_SHARE = 8.0
REPLAY_BOUND = 1e-5

# `--ab-entry-parent`: rounds of the ViT entry per run (the first pays the
# cuBLAS and allocator warm-up)
AB_ENTRY_ROUNDS = 5

# Phase 9, BASELINE config 4: BERT-Base CoLA (2 labels) at full width, two
# stages (one single-tensor edge), 64 tokens per item; then the tiny BERT
# (head dim 8) on the card against the CPU at the f32 attention tolerance.
BERT_MODEL = "textattack/bert-base-uncased-CoLA"
BERT_PARTITION = [(1, 24), (25, 48)]
TINY_BERT_MODEL = "pipeedge/test-tiny-bert"
TINY_BERT_PARTITION = [(1, 4), (5, 8)]

# Phase 10, BASELINE config 3: PipeEdge's own loop. The port's profiler
# measures every sublayer of ViT-Base and ViT-Large at full width and
# depth (f32, microbatch 8, seeded random weights), the converters make
# models.yml and device_types.yml of one device type with four hosts, the
# native sched-pipeline partitions ViT-Large over them, and the runtime
# entry runs that schedule (all four stages on this one card) for
# SCHED_ROUNDS rounds of the batch. Then BASELINE configs 1 (one stage)
# and 2 (`-pt 1,24,25,48`) of ViT-Base through the entry.
SCHED_MODEL = "google/vit-large-patch16-224"
PROFILE_MODELS = {"vitb": MODEL, "vitl": SCHED_MODEL}
SCHED_DEV_TYPE = "h100"
SCHED_HOSTS = [f"h100-{i}" for i in range(4)]
SCHED_ROUNDS = 2
# the device type's link rate, a planning number for placing stages on
# several cards: 450 GB/s per direction of NVLink 4, in the converters'
# Mbit/s (Mb = 2^20 bits)
NVLINK_MBPS = int(450e9 * 8 / 2**20)
BASELINE_PARTITION = "1,24,25,48"

# Phase 11, GPT-2 serving at full width through the port's HTTP server
# (module docstring). `--max-active 16` admits every client at once (16
# requests, 19 rows, 32 live per-stage caches); the brownout ladder runs
# with watermarks above this traffic, whose requests each take seconds by
# design, so no request is clamped and each must equal its solo run.
SERVE_FLAGS = ["-m", DECODE_MODEL, "-pt", "1,24,25,48", "--max-len", "1024",
               "-t", "float32", "--int8-decode-attend", "auto",
               "--max-active", "16", "--brownout-p95-high", "600",
               "--brownout-p95-low", "300"]
SERVE_KINDS = (["stream"] * 4 + ["prefix"] * 4 + ["eos"] * 2 + ["batched"]
               + ["plain"] * 5)
SERVE_FP_KINDS = ["stream", "prefix", "eos", "plain"]
SERVE_PROMPT = (64, 256)          # prompt lengths drawn from [64, 256]
SERVE_NEW = (16, 48)              # new tokens drawn from [16, 48]
SERVE_PREFIX_LEN = 128
SERVE_BATCHED = (4, 128, 64)      # rows, prompt length, new tokens
SERVE_PROFILE_TICKS = 4           # profiled wave ticks of 4 requests
SERVE_PROFILE_NEW = 64            # ... with 64 new tokens each
SERVE_DISPATCH_OPS = 20000        # one-element adds per dispatching thread

# Phase 12, the paged KV plane: phase 11's server and weights with 1024
# pages of 16 tokens per stage (12 blocks x (2 x 768 B of int8 K/V + 4 x
# 12 x 4 B of scales) x 16384 tokens, 340 MB), prompts past 64 tokens in
# 64-token chunks between decode steps, admission re-driven at every step.
# Traffic: phase 11's int8 clients but the 4 on a registered prefix; one
# publisher whose prompt is exactly phase 11's 128-token prefix (8 whole
# pages), served alone first, then 4 sharers whose prompts start with it
# (suffixes of at most one chunk, so a sharer's suffix runs as one span),
# one 512-token prompt (8 chunks) and one request of 16 tokens in all
# (one page: a window narrower than the attend floor of 64).
PAGED_FLAGS = ["--kv-pages", "1024", "--kv-page-size", "16",
               "--chunked-prefill", "64", "--step-join"]
PAGED_CHUNK = 64
PAGED_SHARERS = 4
PAGED_SUFFIX = (16, 64)           # sharer suffix lengths drawn from [16, 64]
PAGED_LONG = (512, 32)            # prompt length, new tokens
PAGED_SHORT = (8, 8)              # prompt length, new tokens: one page

# Phase 13, speculative decoding: gpt2-medium (24 blocks, 1024 wide, 16
# heads; seeded npz, 1.4 GB in f32) verifies what gpt2 (phase 6's npz)
# drafts, gamma 4, f32, fp caches (the server refuses --draft-model with
# --kv-bits), batch 4 x 128-token prompts, 64 new tokens, in host and in
# device sync; then gpt2-medium as its own draft; then 4 speculative
# requests through the server with --kv-pages; then the generate entry.
SPEC_TARGET = "gpt2-medium"
SPEC_DRAFT = DECODE_MODEL
SPEC_GAMMA = 4
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW = 4, 128, 64
# the noisy self-draft: seeded N(0, 1) noise times SPEC_NOISE times each
# matrix's own standard deviation, added to every weight matrix of the
# last block
SPEC_NOISE = 0.1
SPEC_PAIRS = 2                    # (host, device, device, host) x 2
SPEC_SERVE = 4                    # speculative requests through the server
SPEC_SERVE_NEW = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Device time of one `fn()` call: a CUDA graph of `iters` calls,
    replayed `reps` times between CUDA events; the median per call.
    Inputs stay in L2 between calls, as they are on the main path, where
    the producer has just written them.

    Cold L2: `fn` may be a list of callables, each over its own copy of
    the inputs (`cold_copies`); the captured calls then rotate over them
    (at least one round), so a copy comes back only after the others have
    streamed more than the L2 through it, as a decode step finds a layer's
    cache window one full step after it last read it."""
    fns = fn if isinstance(fn, list) else [fn]
    iters = max(iters, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns * (3 if len(fns) == 1 else 1):
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


L2_BYTES = 50 * 2**20                   # the H100's L2


def cold_copies(touched_bytes: int) -> int:
    """Input copies a cold-L2 timing rotates over: enough that the calls
    between two uses of one copy read twice the L2."""
    return min(64, max(2, -(-2 * L2_BYTES // touched_bytes) + 1))


def cold_windows(cache: dict, w: int, touched_bytes: int) -> list:
    """The windows [:, :w] of a quantized stage cache (a dict of its
    tensors) and of clones of it, `cold_copies` in all: the inputs of an
    L2-cold timing of kernel 5; the first is the cache itself."""
    fulls = [cache] + [{key: val.clone() for key, val in cache.items()}
                       for _ in range(cold_copies(touched_bytes) - 1)]
    return [{key: val[:, :w] for key, val in c.items()} for c in fulls]


# --- phase 3: kernels against their plain versions ------------------------

def codec_bytes(shape, bit: int) -> int:
    """Bytes the encode (or decode) must move: the f32 activation once,
    the packed words once, the per-item scale and shift once."""
    from pipeedge_tpu_torch.ops.quant import packed_words
    b, n = shape[0], int(np.prod(shape[1:]))
    return b * n * 4 + b * packed_words(n, bit) * 4 + b * 8


def same_values(got, want) -> bool:
    """torch.equal, with NaN counted equal to NaN (scale, shift and decoded
    values of an item holding NaN or an infinity)."""
    nan = want.isnan()
    return (got.shape == want.shape and torch.equal(got.isnan(), nan)
            and torch.equal(got.masked_fill(nan, 0.0),
                            want.masked_fill(nan, 0.0)))


def codec_input(shape, kind, gen, dev):
    """A codec case's input. 'zero_item': item 1 constant (scale 0);
    'scaled': items scaled from 1e-30 to 1e30; 'nonfinite': item 0 holds a
    NaN, 1 a +inf, 2 a -inf, 3 alternates +-3e38 (its range overflows
    f32), 4 both infinities, and item 5 is finite."""
    x = torch.randn(shape, generator=gen, device=dev) * 3.0
    if kind == "zero_item":
        x[1] = 0.75
    elif kind == "scaled":
        x *= torch.logspace(-30, 30, shape[0], device=dev)[:, None]
    elif kind == "nonfinite":
        flat = x.view(shape[0], -1)
        n = flat.shape[1]
        flat[0, n // 3] = float("nan")
        flat[1, n // 2] = float("inf")
        flat[2, 0] = float("-inf")
        flat[3, 0::2] = 3e38
        flat[3, 1::2] = -3e38
        flat[4, n - 1] = float("inf")
        flat[4, n // 4] = float("-inf")
    return x


def check_codec(dev, gen):
    from pipeedge_tpu_torch.ops import fused_quant, quant
    rows = {}
    # [2, 605184] / [2, 605189]: an item whose slice outgrows shared
    # memory (the tiled re-read), 16-byte and scalar copies
    # [64, 151296]: item scales from 1e-30 to 1e30, through the encode's
    # reciprocal division and its __fdiv_rn fallback (csrc div_rn)
    # [6, 151296] / [6, 37]: NaN, +-inf and an overflowing range
    # [65537, 37]: more items than one grid axis takes
    for shape, kind in (((8, 197, 768), "zero_item"), ((3, 37), "zero_item"),
                        ((2, 151296 * 4), "zero_item"),
                        ((2, 151296 * 4 + 5), "zero_item"),
                        ((64, 197 * 768), "scaled"),
                        ((6, 151296), "nonfinite"), ((6, 37), "nonfinite"),
                        ((65537, 37), "plain"),
                        ((8, 197, 768), "plain")):
        for bit in (8, 4):
            x = codec_input(shape, kind, gen, dev)
            enc = fused_quant.fused_encode_outerdim(x, bit)
            ref = quant.tensor_encode_outerdim(x, bit)
            torch.cuda.synchronize()
            for name in ("data", "scale", "shift"):
                got, want = getattr(enc, name), getattr(ref, name)
                if not same_values(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"encode {shape} bit {bit} {kind}: {name} differs "
                        f"in {bad} of {want.numel()} entries")
            dec = fused_quant.fused_decode_outerdim(enc)
            dref = quant.tensor_decode_outerdim(ref)
            torch.cuda.synchronize()
            finite = dref.isfinite() & dec.isfinite()
            dec_err = (float((dec - dref)[finite].abs().max())
                       if bool(finite.any()) else 0.0)
            if not same_values(dec, dref):
                raise AssertionError(f"decode {shape} bit {bit} {kind}: "
                                     f"max |diff| {dec_err}")
            enc_err = max(float((enc.scale - ref.scale).abs().max()),
                          float((enc.shift - ref.shift).abs().max()))
            log(f"codec {shape} bit {bit} {kind}: bit-identical")
            if shape == (8, 197, 768) and kind == "plain":
                nbytes = codec_bytes(shape, bit)
                kernels = {name: device_launches(fn) for name, fn in (
                    ("fused_encode",
                     lambda: fused_quant.fused_encode_outerdim(x, bit)),
                    ("fused_decode",
                     lambda: fused_quant.fused_decode_outerdim(enc)))}
                if kernels != {"fused_encode": 1, "fused_decode": 1}:
                    raise AssertionError(f"codec bit {bit}: device kernels "
                                         f"per call {kernels}, not 1")
                # the other cluster size the design allows (16 blocks per
                # item, a non-portable cluster), timed beside the chosen one
                chosen = fused_quant.ENCODE_CLUSTER
                fused_quant.ENCODE_CLUSTER = 16
                try:
                    cluster16_ms = time_ms(
                        lambda: fused_quant.fused_encode_outerdim(x, bit))
                finally:
                    fused_quant.ENCODE_CLUSTER = chosen
                rows[("fused_encode", bit)] = dict(
                    shape=list(shape), bit=bit, max_abs_err=enc_err,
                    device_kernels=kernels["fused_encode"], cluster=chosen,
                    cluster16_ms=cluster16_ms,
                    ms=time_ms(lambda: fused_quant.fused_encode_outerdim(x, bit)),
                    plain_ms=time_ms(lambda: quant.tensor_encode_outerdim(x, bit)),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None)
                rows[("fused_decode", bit)] = dict(
                    shape=list(shape), bit=bit, max_abs_err=dec_err,
                    device_kernels=kernels["fused_decode"],
                    ms=time_ms(lambda: fused_quant.fused_decode_outerdim(enc)),
                    plain_ms=time_ms(lambda: quant.tensor_decode_outerdim(ref)),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None)
    return rows


def attention_bound_ms(b, h, s, d, dtype, causal):
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * s * d * elem          # q, k, v read; o written
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d              # q k^T and p v
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / ATTN_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_attention(dev, gen):
    import torch.nn.functional as F
    from pipeedge_tpu_torch.ops import attention
    rows = []
    cases = [("bhsd", (96, 197, 64), torch.float32, False),
             ("bhsd", (128, 257, 80), torch.float32, False),
             ("bhsd", (8, 1024, 64), torch.float32, True),
             ("bhsd", (96, 197, 64), torch.bfloat16, False),
             ("bhsd", (96, 1, 64), torch.float32, False),
             ("bhsd", (96, 65, 64), torch.float32, False),
             ("bhsd", (96, 197, 64), torch.float32, True),
             ("bshd", (8, 197, 12, 64), torch.bfloat16, False),
             ("bshd", (8, 197, 12, 64), torch.float32, False),
             # phases 8 and 9: DeiT-B and DeiT-S (198 tokens), BERT-Base
             # (64 tokens), the tiny BERT (head dim 8, padded to 32)
             ("bshd", (8, 198, 12, 64), torch.float32, False),
             ("bshd", (8, 198, 6, 64), torch.float32, False),
             ("bshd", (8, 64, 12, 64), torch.float32, False),
             ("bshd", (8, 64, 4, 8), torch.float32, False),
             ("bshd", (8, 64, 4, 8), torch.bfloat16, False),
             # phase 10: ViT-Large (16 heads)
             ("bshd", (8, 197, 16, 64), torch.float32, False)]
    for layout, shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        if layout == "bhsd":
            def kern():
                return attention.fused_attention_bhsd(q, k, v, causal=causal)

            def plain():
                return attention.attention_reference(q, k, v, causal)

            def library():
                return F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], is_causal=causal)
            b, h, s, d = shape[0], 1, shape[1], shape[2]
        else:
            flip = (0, 2, 1, 3)

            def kern():
                return attention.fused_attention(q, k, v, causal=causal)

            def plain():
                return attention.attention_reference(
                    q.permute(flip), k.permute(flip), v.permute(flip),
                    causal).permute(flip)

            def library():
                return F.scaled_dot_product_attention(
                    q.permute(flip), k.permute(flip), v.permute(flip),
                    is_causal=causal)
            b, s, h, d = shape
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        bound, bound_by = attention_bound_ms(b, h, s, d, dtype, causal)
        row = dict(layout=layout, shape=list(shape),
                   dtype=str(dtype).replace("torch.", ""), causal=causal,
                   max_abs_err=err, ms=time_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), bound_ms=bound,
                   bound_by=bound_by)
        log("attention " + json.dumps(row))
        rows.append(row)
    return rows


def check_policy_bits(dev, gen):
    """The plain codec at every bitwidth an adaptive policy can pick
    (`utils/quant.py BITWIDTHS`) on CUDA tensors of the edges of phases 8
    and 9 (DeiT-B's [8, 198, 768], BERT-Base's [8, 64, 768]): the same
    words, scale and shift as on the CPU, whose words the CPU tests hold to
    the JAX package's (tests/test_torch_adaptive.py), and the same decoded
    values. At bits 4 and 8 the routed codec (`encode_outerdim`) launches
    the kernels, and their words, scale, shift and decoded values equal the
    plain codec's on the same CUDA input. Timed, since a policy may leave
    an edge at any of these bits."""
    from pipeedge_tpu_torch.ops import _build, fused_quant, quant
    from pipeedge_tpu_torch.utils.quant import BITWIDTHS
    rows = []
    for shape in ((8, 198, 768), (8, 64, 768)):
        x = torch.randn(shape, generator=gen, device=dev)
        x_cpu = x.cpu()
        for bit in BITWIDTHS:
            kernel = bit in fused_quant.FUSED_BITS
            before = dict(_build.launch_counts)
            enc = quant.tensor_encode_outerdim(x, bit)
            want = quant.tensor_encode_outerdim(x_cpu, bit)
            routed = fused_quant.encode_outerdim(x, bit)
            dec = quant.tensor_decode_outerdim(enc)
            routed_dec = fused_quant.decode_outerdim(routed)
            torch.cuda.synchronize()
            launched = {k: _build.launch_counts[k] - before.get(k, 0)
                        for k in ("fused_encode", "fused_decode")}
            if launched != {"fused_encode": int(kernel),
                            "fused_decode": int(kernel)}:
                raise AssertionError(f"codec {shape} at {bit} bits: kernel "
                                     f"launches {launched}")
            for name in ("data", "scale", "shift"):
                if not torch.equal(getattr(enc, name).cpu(),
                                   getattr(want, name)):
                    raise AssertionError(f"plain encode {shape} at {bit} "
                                         f"bits on the card: {name} differs "
                                         f"from the CPU")
                if not torch.equal(getattr(routed, name), getattr(enc, name)):
                    raise AssertionError(f"routed encode {shape} at {bit} "
                                         f"bits: {name} differs from the "
                                         f"plain encode on the same input")
            if not torch.equal(dec.cpu(), quant.tensor_decode_outerdim(want)):
                raise AssertionError(f"plain decode {shape} at {bit} bits on "
                                     f"the card differs from the CPU's")
            if not torch.equal(routed_dec, dec):
                raise AssertionError(f"routed decode {shape} at {bit} bits "
                                     f"differs from the plain decode")
            row = dict(bit=bit, shape=list(shape), kernel=kernel,
                       encode_ms=time_ms(
                           lambda: fused_quant.encode_outerdim(x, bit)),
                       decode_ms=time_ms(
                           lambda: fused_quant.decode_outerdim(routed)))
            log("policy bit " + json.dumps(row))
            rows.append(row)
    return rows


def int8_bound_ms(m, k, n, block_k):
    """Bytes: codes, scales and the f32 output once; operations: 2MNK at
    the int8 tensor-core peak."""
    nbytes = m * k + k * n + m * (k // block_k) * 4 + n * 4 + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / INT8_PEAK_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_launches(fn) -> int:
    """Kernels one `fn()` call puts on the device (torch.profiler). The
    first profiling session of a process can miss a kernel while the
    tracer starts (a first session has counted no kernel for the encode
    on the H100), so each count comes from the second of two sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def check_int8_matmul(dev, gen):
    """The int8 matmul kernel against `matmul_reference`: bit-identical
    at every case; timed at the main path's dense shapes and the tunnel."""
    from pipeedge_tpu_torch.ops import fused_quant
    from pipeedge_tpu_torch.ops import int8_matmul as im
    m_path = UBATCH * 197
    cases = [  # name, M, K, N, timed
        ("attn.q/k/v/out", m_path, 768, 768, True),
        ("mlp.up", m_path, 768, 3072, True),
        ("mlp.down", m_path, 3072, 768, True),
        ("ragged", 37, 256, 40, False),
        ("odd_n", 33, 128, 17, False),
        ("k100", 64, 100, 48, False),
        ("k80", 70, 80, 40, False),
        ("k192", 64, 192, 96, False),
        ("k320", 70, 320, 40, False),
        ("m1", 1, 768, 768, False),
        ("zeros", 256, 384, 96, False),
        ("outlier", 200, 768, 256, False),
        ("tunnel", m_path, 768, 768, True),
        ("tunnel_up", m_path, 768, 3072, True),
    ]
    rows = []
    for name, m, k, n, timed in cases:
        bk = im.pick_block(k)
        x = torch.randn((m, k), generator=gen, device=dev) * 3.0
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        if name == "zeros":
            x[: m // 2, :bk] = 0.0
            w[:, : n // 3] = 0.0
        if name == "outlier":
            x[5, 7] = 1e4
        folded = im.fold_weight(w)
        if name.startswith("tunnel"):
            enc = fused_quant.fused_encode_outerdim(
                x.reshape(UBATCH, 197, k), 8)
            s_row = (enc.scale / torch.full((), 255.0, device=dev)
                     ).repeat_interleave(197)
            xs = s_row[:, None].expand(m, k // bk)
            xq = im.wire_codes(enc)
            x_bytes = enc.data

            def kern():
                return im.wire_matmul(enc, xs, folded.w_q, folded.w_scale,
                                      bk)
        else:
            xq, xs = im.quantize_act_blocks(x, bk)
            x_bytes = xq

            def kern():
                return im.matmul_q(xq, xs, folded.w_q, folded.w_scale, bk)

        def plain():
            return im.matmul_reference(xq, xs, folded.w_q, folded.w_scale,
                                       bk)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"int8 matmul {name} [{m},{k}]x[{k},{n}]: {bad} of "
                f"{want.numel()} outputs differ from the plain version, "
                f"max |diff| {float((got - want).abs().max())}")
        kernel = im.kernel_choice(
            k, bk, (x_bytes.data_ptr() | folded.w_q.data_ptr()) % 16 == 0)
        if timed and kernel != "wgmma":
            raise AssertionError(f"int8 matmul {name}: the main path's "
                                 f"shape ran the {kernel} kernel")
        row = dict(case=name, shape=[m, k, n], block_k=bk, kernel=kernel,
                   max_abs_err=float((got - want).abs().max()))
        if name == "zeros" and not bool((got[:, : n // 3] == 0).all()):
            raise AssertionError("int8 matmul: all-zero channels not zero")
        if timed:
            bias = torch.zeros(n, device=dev)
            bound, bound_by = int8_bound_ms(m, k, n, bk)
            row.update(
                ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound,
                bound_by=bound_by, library_ms=None,
                addmm_f32_ms=time_ms(lambda: torch.addmm(bias, x, w)),
                int_mm_whole_k_ms=time_ms(
                    lambda: torch._int_mm(xq, folded.w_q)))
            if not name.startswith("tunnel"):
                row["act_quantizer_ms"] = time_ms(
                    lambda: im.quantize_act_blocks(x, bk))
                row["act_quantizer_launches"] = device_launches(
                    lambda: im.quantize_act_blocks(x, bk))
        log("int8_matmul " + json.dumps(row))
        rows.append(row)
    return rows


def ab_parent(parent_csrc: Path, dev, gen):
    """Time another version's attention, int8, decode-attention, encode
    and decode kernels (built from `parent_csrc`) against this one's on
    the same inputs, in the order parent, this, this, parent. The parent
    runs through the same wrappers with its library swapped in (before the
    wgmma kernel existed, its int8 entry for both kernel choices). The
    one exception is the encode of a version whose `pe_fused_encode`
    still takes the two-pass arguments (a partial-min/max scratch and a
    chunk; before `pe_decode_attention_splits` existed): it is called
    with those. Kernel 5 is timed warm and with a cold L2, and each
    kernel 1, 2 and 5 case first checks that both versions agree.
    Returns the rows, one per case."""
    import ctypes
    from pipeedge_tpu_torch.ops import _build, fused_quant, quant
    from pipeedge_tpu_torch.ops import attention
    from pipeedge_tpu_torch.ops import decode_attention as da
    from pipeedge_tpu_torch.ops import int8_matmul as im
    from pipeedge_tpu_torch.parallel import decode
    t0 = time.monotonic()
    parent = _build.load(_build.build(parent_csrc))
    log(f"ab: parent kernels built in {time.monotonic() - t0:.1f} s")
    ours = _build.library()
    entries = dict(im._ENTRIES)
    two_pass_encode = not hasattr(parent, "pe_decode_attention_splits")
    if two_pass_encode:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # x, data, scale, shift, partial, B, n, bit, chunk, vec, stream
        parent.pe_fused_encode.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                           i32, i64, i32, ptr]

    def parent_encode(x, bit):
        b, n = x.shape[0], x[0].numel()
        flat = x.reshape(b, n)
        data = torch.empty((b, quant.packed_words(n, bit)),
                           dtype=torch.int32, device=dev)
        scale = torch.empty((b,), dtype=torch.float32, device=dev)
        shift = torch.empty((b,), dtype=torch.float32, device=dev)
        chunk = 8192
        partial = torch.empty((b, 2 * -(-n // chunk)), dtype=torch.float32,
                              device=dev)
        _build.check(parent.pe_fused_encode(
            flat.data_ptr(), data.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), partial.data_ptr(), b, n, bit, chunk,
            int(n % 4 == 0), _build.stream_handle(dev)), "parent encode")
        return data, scale, shift

    # a parent from before the wgmma kernel runs its mma.sync entry for
    # both kernel choices; a later one keeps its own entries
    parent_entries = (entries if hasattr(parent, "pe_int8_matmul_wgmma")
                      else {name: "pe_int8_matmul" for name in entries})

    def timed(fn, lib):
        _build._lib = lib
        im._ENTRIES.update(entries if lib is ours else parent_entries)
        try:
            return time_ms(fn)
        finally:
            _build._lib = ours
            im._ENTRIES.update(entries)

    cases = []
    for shape, dtype in (((8, 197, 12, 64), torch.float32),
                         ((96, 197, 64), torch.bfloat16)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        fn = (attention.fused_attention if len(shape) == 4
              else attention.fused_attention_bhsd)
        cases.append((f"attention {list(shape)} "
                      f"{str(dtype).replace('torch.', '')}",
                      lambda fn=fn, q=q, k=k, v=v: fn(q, k, v)))
    m = UBATCH * 197
    for name, k, n in (("qkv", 768, 768), ("mlp.up", 768, 3072),
                       ("mlp.down", 3072, 768), ("tunnel", 768, 768),
                       ("tunnel_up", 768, 3072)):
        x = torch.randn((m, k), generator=gen, device=dev) * 3.0
        folded = im.fold_weight(torch.randn((k, n), generator=gen,
                                            device=dev) * 0.02)
        if name.startswith("tunnel"):
            enc = fused_quant.fused_encode_outerdim(x.reshape(UBATCH, 197, k),
                                                    8)
            xs = (enc.scale / torch.full((), 255.0, device=dev)
                  ).repeat_interleave(197)[:, None].expand(m, k // 128)
            fn = (lambda enc=enc, xs=xs, f=folded:
                  im.wire_matmul(enc, xs, f.w_q, f.w_scale, 128))
        else:
            xq, xs = im.quantize_act_blocks(x, 128)
            fn = (lambda xq=xq, xs=xs, f=folded:
                  im.matmul_q(xq, xs, f.w_q, f.w_scale, 128))
        cases.append((f"int8_matmul {name} [{m},{k}]x[{k},{n}]", fn))
    # kernel 5 at the main path's windows, warm and cold
    for name, w, pos in (("main_w256", 256, 200), ("main_w512", 512, 300),
                         ("main_w1024", 1024, 1000)):
        b, h, d = DECODE_BATCH, 12, 64
        cache = {}
        for tag in ("k", "v"):
            cache[tag], cache[tag + "_scale"], cache[tag + "_shift"] = \
                decode._quantize_rows(torch.randn(
                    (b, DECODE_MAX_LEN, h, d), generator=gen, device=dev))
        q, k_new, v_new = (torch.randn((b, 1, h, d), generator=gen,
                                       device=dev) for _ in range(3))
        arg_sets = [(q, wn["k"], wn["k_scale"], wn["k_shift"], wn["v"],
                     wn["v_scale"], wn["v_shift"], k_new, v_new, pos)
                    for wn in cold_windows(cache, w, decode_bytes(
                        b, h, d, pos, torch.float32))]
        _build._lib = parent
        try:
            got = da.int8_decode_attention(*arg_sets[0])
        finally:
            _build._lib = ours
        torch.testing.assert_close(got, da.int8_decode_attention(
            *arg_sets[0]), **DECODE_ATTN_TOL[torch.float32])
        fns = [lambda a=a: da.int8_decode_attention(*a) for a in arg_sets]
        cases.append((f"decode_attention {name}", fns[0]))
        cases.append((f"decode_attention {name} l2_cold", fns))
    # kernel 1 at ViT-Base's edge
    for bit in (8, 4):
        x = torch.randn((UBATCH, 197, 768), generator=gen, device=dev) * 3.0
        enc = fused_quant.fused_encode_outerdim(x, bit)
        if two_pass_encode:
            got = parent_encode(x, bit)
        else:
            _build._lib = parent
            try:
                p_enc = fused_quant.fused_encode_outerdim(x, bit)
            finally:
                _build._lib = ours
            got = (p_enc.data, p_enc.scale, p_enc.shift)
        if not all(torch.equal(a, b) for a, b in
                   zip(got, (enc.data, enc.scale, enc.shift))):
            raise AssertionError(f"ab: the parent's encode at bit {bit} "
                                 f"differs from this one's")
        fn = (lambda x=x, bit=bit: fused_quant.fused_encode_outerdim(x, bit))
        cases.append((f"fused_encode [{UBATCH},197,768] bit {bit}", fn,
                      (lambda x=x, bit=bit: parent_encode(x, bit))
                      if two_pass_encode else fn))
    # kernel 2 at ViT-Base's edge: the same words through both versions
    for bit in (8, 4):
        x = torch.randn((UBATCH, 197, 768), generator=gen, device=dev) * 3.0
        enc = fused_quant.fused_encode_outerdim(x, bit)
        fn = (lambda enc=enc: fused_quant.fused_decode_outerdim(enc))
        _build._lib = parent
        try:
            got = fn()
        finally:
            _build._lib = ours
        if not torch.equal(got, fn()):
            raise AssertionError(f"ab: the parent's decode at bit {bit} "
                                 f"differs from this one's")
        cases.append((f"fused_decode [{UBATCH},197,768] bit {bit}", fn))
    rows = []
    for name, fn, *parent_fn in cases:
        p_fn = parent_fn[0] if parent_fn else fn
        p1, c1, c2, p2 = (timed(p_fn if lib is parent else fn, lib)
                          for lib in (parent, ours, ours, parent))
        row = dict(case=name, parent_ms=[p1, p2], this_ms=[c1, c2],
                   speedup=(p1 + p2) / (c1 + c2))
        log("ab " + json.dumps(row))
        rows.append(row)
    return rows


def decode_bytes(b, h, d, pos, dtype) -> int:
    """Bytes the decode step's attend must move: the int8 K and V of the
    cached live rows [0, pos) and their four f32 scale/shift rows, q,
    k_new, v_new and the output once."""
    elem = torch.tensor([], dtype=dtype).element_size()
    return 2 * b * pos * h * d + 4 * b * pos * h * 4 + 4 * b * h * d * elem


def decode_bound_ms(b, h, d, pos, dtype):
    """`decode_bytes` against the two products' flops."""
    nbytes = decode_bytes(b, h, d, pos, dtype)
    flops = 4 * b * h * (pos + 1) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_decode_attention(dev, gen):
    """Kernel 5 against `decode_attention_reference` at the main path's
    shapes (windows of a [16, 1024, 12, 64] stage cache at buckets 256 and
    512, and pos 1000 of the whole cache) and the edge cases; timed beside
    the plain version, the dequantize-then-attend route it replaces, and
    SDPA over the already dequantized window (a yardstick: not the same
    function). The main cases are timed with the window warm in L2 and
    cold (`time_ms` over `cold_copies` of the cache), the kernel and the
    dequantize route alike. The host's split rule (`split_count`) is held
    to the library's for every pos of a 1024-row cache."""
    import torch.nn.functional as F
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.ops import decode_attention as da
    from pipeedge_tpu_torch.parallel import decode
    lib = _build.library()
    bad = [p for p in range(DECODE_MAX_LEN)
           if lib.pe_decode_attention_splits(p) != da.split_count(p)]
    if bad:
        raise AssertionError(f"decode attention: the library's split count "
                             f"differs from split_count at pos {bad[:8]}")
    cases = [  # name, B, W, H, D, pos, dtype, window of a T=1024 cache
        ("main_w256", 16, 256, 12, 64, 200, torch.float32, True),
        ("main_w512", 16, 512, 12, 64, 300, torch.float32, True),
        ("main_w1024", 16, 1024, 12, 64, 1000, torch.float32, False),
        ("pos0", 16, 256, 12, 64, 0, torch.float32, False),
        ("pos_w_minus_1", 16, 256, 12, 64, 255, torch.float32, False),
        ("w100", 16, 100, 12, 64, 97, torch.float32, False),
        ("b1", 1, 256, 12, 64, 200, torch.float32, False),
        ("h16", 16, 256, 16, 64, 200, torch.float32, True),
        ("dh32", 16, 256, 12, 32, 200, torch.float32, False),
        ("zero_range_row", 16, 256, 12, 64, 200, torch.float32, False),
        ("bf16", 16, 256, 12, 64, 200, torch.bfloat16, True),
        # the tiny GPT-2's head dim (8-byte rows), and more batch cells
        # than one grid axis takes
        ("dh8", 16, 64, 4, 8, 50, torch.float32, False),
        ("dh8_bf16", 16, 64, 4, 8, 50, torch.bfloat16, False),
        ("b65537", 65537, 16, 1, 16, 13, torch.float32, False),
    ]
    rows = []
    for name, b, w, h, d, pos, dtype, strided in cases:
        t = DECODE_MAX_LEN if strided else w
        k_rows = torch.randn((b, t, h, d), generator=gen, device=dev)
        v_rows = torch.randn((b, t, h, d), generator=gen, device=dev)
        if name == "zero_range_row":
            k_rows[:, 7] = 0.5             # scale clamps to 1e-8/255
        cache = {}
        for tag, r in (("k", k_rows), ("v", v_rows)):
            cache[tag], cache[tag + "_scale"], cache[tag + "_shift"] = \
                decode._quantize_rows(r)
        del k_rows, v_rows
        win = {key: val[:, :w] for key, val in cache.items()}
        if name == "zero_range_row":
            assert float(win["k_scale"][:, 7].max()) < 1e-9
        q, k_new, v_new = (torch.randn((b, 1, h, d), generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(3))
        def args_of(wn):
            return (q, wn["k"], wn["k_scale"], wn["k_shift"], wn["v"],
                    wn["v_scale"], wn["v_shift"], k_new, v_new, pos)
        args = args_of(win)
        assert win["k"].is_contiguous() != strided

        def kern(a=args):
            return da.int8_decode_attention(*a)

        def plain():
            return da.decode_attention_reference(*args)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(),
                                   **DECODE_ATTN_TOL[dtype])
        row = dict(case=name, shape=[b, w, h, d], pos=pos,
                   dtype=str(dtype).replace("torch.", ""),
                   strided_window=strided, max_abs_err=err)
        if name.startswith("main") or name in ("bf16", "dh8"):
            k_deq = decode._dequantize_rows(win["k"], win["k_scale"],
                                            win["k_shift"], dtype)
            v_deq = decode._dequantize_rows(win["v"], win["v_scale"],
                                            win["v_shift"], dtype)
            keep = torch.arange(w, device=dev)[None] <= pos

            def dequant_route(wn=win):
                k = decode._dequantize_rows(wn["k"], wn["k_scale"],
                                            wn["k_shift"], dtype)
                v = decode._dequantize_rows(wn["v"], wn["v_scale"],
                                            wn["v_shift"], dtype)
                k[:, pos:pos + 1] = k_new
                v[:, pos:pos + 1] = v_new
                return decode._attend(q, k, v, keep)

            flip = (0, 2, 1, 3)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q.permute(flip), k_deq.permute(flip),
                    v_deq.permute(flip), attn_mask=keep)

            route_err = float((dequant_route().float()
                               - want.float()).abs().max())
            bound, bound_by = decode_bound_ms(b, h, d, pos, dtype)
            row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                       bound_ms=bound, bound_by=bound_by, library_ms=None,
                       dequant_route_ms=time_ms(dequant_route),
                       dequant_route_max_abs_err=route_err,
                       sdpa_dequantized_ms=time_ms(sdpa))
            if name.startswith("main"):
                wins = cold_windows(cache, w,
                                    decode_bytes(b, h, d, pos, dtype))
                row.update(
                    l2_cold_copies=len(wins),
                    ms_l2_cold=time_ms([lambda wn=wn: kern(args_of(wn))
                                        for wn in wins]),
                    dequant_route_ms_l2_cold=time_ms(
                        [lambda wn=wn: dequant_route(wn) for wn in wins]))
                del wins
        log("decode_attention " + json.dumps(row))
        rows.append(row)
    return rows


# --- phase 4: the main path ------------------------------------------------

def main_path(device: str, model: str = MODEL, partition=PARTITION,
              batch: int = BATCH, ubatch: int = UBATCH,
              weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build",
              profile: bool = False):
    """Drive the port's pipeline at bits 0, 8 and 4, then with int8
    compute in runs (a), (b) and (c) (module docstring); returns a dict of
    per-run results keyed by bit (0, 8, 4) or run ("a", "b", "c"), with
    the kernel launch counts of each run set to 0 just before it. With
    `profile`, one more pass with an 8-bit edge and one of (c) run under
    torch.profiler and their device-time breakdowns are printed (the CPU
    rehearsal of this function leaves it off: the profile reads CUDA
    kernels)."""
    from pipeedge_tpu_torch.models import edge_arity, layers, registry, vit
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline
    from pipeedge_tpu_torch.utils import calibrate
    from pipeedge_tpu_torch.utils import data as data_utils

    cfg = registry.get_model_config(model)
    weights_dir.mkdir(parents=True, exist_ok=True)
    weights_file = weights_dir / f"{model.replace('/', '_')}-random-seed0.npz"
    t0 = time.monotonic()
    np.savez(weights_file, **vit.random_npz_weights(cfg, seed=0))
    log(f"weights: {weights_file.name} "
        f"({weights_file.stat().st_size / 2**20:.1f} MiB) in "
        f"{time.monotonic() - t0:.1f} s")
    dataset = data_utils.synthetic_image_dataset(
        batch, shape=(cfg.num_channels, cfg.image_size, cfg.image_size))
    inputs = [torch.from_numpy(x).to(device)
              for x, _ in data_utils.batch_dataset(dataset, ubatch)]
    n_mb = len(inputs)

    layers.set_quantize_compute(False)    # exact, whatever the env says
    fn, params, _ = registry.module_shard_factory(
        model, str(weights_file), 1, registry.get_model_layers(model),
        device=device)
    exact = [fn(params, x) for x in inputs]
    # clamp alphas for runs (b) and (c), from the first microbatch
    alphas = calibrate.compute_alphas(calibrate.collect_activation_stats(
        fn, params, inputs[:1]), bit=8)
    log("calibrated alphas: " + json.dumps(alphas, sort_keys=True))
    del params

    pipe = build_pipeline(model, partition, model_file=str(weights_file),
                          device=device, quant_bits=[0] * len(partition))
    blocks = cfg.num_hidden_layers
    # one codec launch per tensor of each quantized edge: the cut after
    # sublayer 21 leaves a (ctx, residual) 2-tuple
    edge_tensors = sum(edge_arity(r) for _, r in partition[:-1])
    results = {}
    for bit in (0, 8, 4):
        set_edge_bits(pipe, bit)
        results[bit] = measure(pipe, inputs, exact, expected={
            "fused_attention": blocks * n_mb,
            "fused_encode": edge_tensors * n_mb if bit else 0,
            "fused_decode": edge_tensors * n_mb if bit else 0,
            "int8_matmul": 0, "decode_attention": 0},
            expected_shape=[ubatch, cfg.num_labels])
    if profile:
        set_edge_bits(pipe, 8)
        profile_pass(lambda: pipe.run(inputs), "exact, 8-bit edge")

    # int8 compute: 6 tagged denses per block (q, k, v, attn.out, mlp.up,
    # mlp.down); the untagged patch embedding and head stay exact
    runs = {"a": (layers.QuantizeCompute(enabled=True), 0),
            "b": (layers.QuantizeCompute(enabled=True, clamp_alphas=alphas),
                  8),
            "c": (layers.QuantizeCompute(enabled=True, clamp_alphas=alphas,
                                         tunnel=True), 8)}
    for run, (qc, bit) in runs.items():
        layers.set_quantize_compute(qc)
        if qc.tunnel:   # the tunnel is chosen when the stages are built
            pipe = build_pipeline(model, partition,
                                  model_file=str(weights_file),
                                  device=device, quant_bits=[bit])
            assert [s.tunnel for s in pipe.stages] == [False, True]
        set_edge_bits(pipe, bit)
        # (c): stage 1's first dense consumes the leading `ctx` tensor
        # encoded, so only the residual is decoded
        decoded = edge_tensors - 1 if qc.tunnel else edge_tensors
        results[run] = measure(pipe, inputs, exact, expected={
            "fused_attention": blocks * n_mb,
            "fused_encode": edge_tensors * n_mb if bit else 0,
            "fused_decode": decoded * n_mb if bit else 0,
            "int8_matmul": 6 * blocks * n_mb, "decode_attention": 0},
            expected_shape=[ubatch, cfg.num_labels])
    if profile:
        profile_pass(lambda: pipe.run(inputs),
                     "int8 compute, 8-bit edge, tunnel")
    layers.set_quantize_compute(None)
    return results


def set_edge_bits(pipe, bit: int) -> None:
    for stage in pipe.stages[:-1]:
        stage.quant_bit = bit


def measure(pipe, inputs, exact, expected, expected_shape) -> dict:
    """One warm-up pass, then one counted pass (launch counts set to 0
    just before it), held against the exact single-shard logits."""
    from pipeedge_tpu_torch.ops import _build
    pipe.run(inputs)                      # warm-up (not counted)
    _build.reset_launch_counts()
    outs, stats = pipe.run(inputs)
    counts = dict(_build.launch_counts)
    scale = max(float(e.abs().max()) for e in exact)
    err = max(float((o - e).abs().max()) for o, e in zip(outs, exact))
    top1 = float(np.mean([float((o.argmax(-1) == e.argmax(-1)).float().mean())
                          for o, e in zip(outs, exact)]))
    return dict(
        counts=counts, rel_err=err / scale, max_abs_err=err,
        equal=all(torch.equal(o, e) for o, e in zip(outs, exact)),
        top1_agreement=top1, items_per_s=stats["throughput_items_sec"],
        steady_items_per_s=stats.get("steady_state_throughput_items_sec"),
        p50_ms=stats["latency_breakdown"]["steady_p50_ms"],
        host_dispatch_ms=stats["host_dispatch_s_per_ubatch"] * 1e3,
        finite=all(bool(torch.isfinite(o).all()) for o in outs),
        shape=list(outs[0].shape), expected_counts=expected,
        expected_shape=expected_shape)


def profile_pass(run_once, label: str) -> dict:
    """Device time by kernel over one warm `run_once()` (a pass of the
    pipeline as it is set, one decode step, or a few executor ticks), and
    the device's busy share of its wall time (kernel time summed over all
    streams, so overlap between the stages can lift it above what one
    stream shows). Logs the numbers and returns them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_once()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # device-side events only: CPU ops (aten::addmm...) carry the device
    # time of the kernels they launch as well
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    total = sum(ms for _, ms, _ in kernels)
    numbers = {
        "pass": label, "wall_ms": wall_ms, "device_ms": total,
        "device_busy_share": total / wall_ms,
        "kernel_launches": sum(calls for _, _, calls in kernels),
        "top": [dict(kernel=name[:90], ms=ms, calls=calls,
                     share=ms / total) for name, ms, calls in kernels[:15]],
        # every kernel of csrc/ (their names start pe_), in the top or not
        "port": [dict(kernel=name[:90], ms=ms, calls=calls,
                      ms_per_call=ms / calls, share=ms / total)
                 for name, ms, calls in kernels if "::pe_" in name],
    }
    log("profile " + json.dumps(numbers))
    return numbers


def check_main_path(results, device_name: str):
    for run, r in results.items():
        name = f"bit {run}" if isinstance(run, int) else f"int8 run ({run})"
        log(f"main path {name}: " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        if r["shape"] != r["expected_shape"] or not r["finite"]:
            raise AssertionError(f"{name}: logits of shape {r['shape']}, "
                                 f"finite={r['finite']}")
        if r["counts"] != r["expected_counts"]:
            raise AssertionError(f"{name}: launch counts {r['counts']} "
                                 f"!= {r['expected_counts']}")
        if run == 0 and not r["equal"]:
            raise AssertionError(f"bit 0: pipeline logits differ from the "
                                 f"single-shard forward by "
                                 f"{r['max_abs_err']}")
        bound = INT8_LOGIT_BOUND[run] if isinstance(run, str) \
            else LOGIT_BOUND.get(run)
        if bound is not None and r["rel_err"] > bound:
            raise AssertionError(f"{name}: logit error {r['rel_err']} of "
                                 f"the logit scale > {bound}")
    if not results[4]["rel_err"] > results[8]["rel_err"] > 0:
        raise AssertionError("quantized logit errors not ordered 4 > 8 > 0 "
                             "bits")
    if not all(results[run]["rel_err"] > 0 for run in INT8_LOGIT_BOUND):
        raise AssertionError("an int8 run gave the exact logits: the int8 "
                             "path did not run")


# --- phase 6: the decode main path -----------------------------------------

def decode_main_path(device: str, model: str = DECODE_MODEL,
                     partition=DECODE_PARTITION, batch: int = DECODE_BATCH,
                     prompt_len: int = DECODE_PROMPT,
                     new_tokens: int = DECODE_NEW,
                     max_len: int = DECODE_MAX_LEN,
                     floor: int = DECODE_FLOOR,
                     weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build",
                     profile: bool = False) -> dict:
    """Drive `DecodePipeline.generate` with (i) an fp cache, (ii) an int8
    cache on the kernel route, (iii) an int8 cache on the dequantize-then-
    attend route (module docstring), the launch counts set to 0 just
    before each timed generation; then hold (i)'s step logits against the
    full-sequence forward, run (ii) and (iii) in lockstep on (ii)'s greedy
    tokens, and run the generate entry once. Returns the numbers;
    `check_decode_path` gates them. `profile` (the card only) adds one
    profiled decode step of (ii) and of (iii)."""
    from pipeedge_tpu_torch.models import gpt2, registry
    from pipeedge_tpu_torch.models.shard import shard_apply
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = registry.get_model_config(model)
    weights_dir.mkdir(parents=True, exist_ok=True)
    weights_file = weights_dir / f"{model.replace('/', '_')}-random-seed0.npz"
    t0 = time.monotonic()
    np.savez(weights_file, **gpt2.random_npz_weights(cfg, seed=0))
    log(f"weights: {weights_file.name} "
        f"({weights_file.stat().st_size / 2**20:.1f} MiB) in "
        f"{time.monotonic() - t0:.1f} s")
    stage_params = [registry.module_shard_factory(
        model, str(weights_file), l, r, stage=i, device=device)[1]
        for i, (l, r) in enumerate(partition)]
    # the generate entry's prompts
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(device)
    steps = new_tokens - 1
    blocks = cfg.num_hidden_layers
    pipes = {run: decode.build_decode_pipeline(
        model, partition, max_len=max_len, cache_bits=bits,
        attend_floor=floor, stage_params=stage_params, device=device,
        int8_decode_attend=optin)
        for run, bits, optin in (("i", 0, 0), ("ii", 8, 1), ("iii", 8, 0))}
    res = {"expected": dict(
        decode_attention={"i": 0, "ii": blocks * steps, "iii": 0},
        launches_per_step={"ii": [blocks], "iii": [0]},
        shape=[batch, prompt_len + new_tokens])}
    tokens = {}
    for run, pipe in pipes.items():
        pipe.generate(ids, 2)                  # warm-up (not counted)
        sync()
        _build.reset_launch_counts()
        t0 = time.monotonic()
        tokens[run] = pipe.generate(ids, new_tokens)
        sync()
        dt = time.monotonic() - t0
        res[run] = dict(counts=dict(_build.launch_counts),
                        tok_per_s=batch * new_tokens / dt, generate_s=dt,
                        shape=list(tokens[run].shape),
                        in_vocab=bool((tokens[run] >= 0).all()
                                      and (tokens[run] < cfg.vocab_size)
                                      .all()))

    # (i) against the full-sequence forward over its own tokens
    seq = tokens["i"][:, :prompt_len + steps]
    full = seq
    for (l, r), params in zip(partition, stage_params):
        full = shard_apply(gpt2.FAMILY, cfg,
                           registry.make_shard_config(model, l, r), params,
                           full)
    scale = float(full.abs().max())
    pipe = pipes["i"]
    logits, caches = pipe._prefill(ids)
    err = float((logits - full[:, :prompt_len]).abs().max())
    replay_equal = True
    for s in range(1, new_tokens):
        pos = prompt_len + s - 1
        out = decode_step(pipe, caches, seq[:, pos], pos)
        err = max(err, float((out - full[:, pos]).abs().max()))
        replay_equal &= bool(torch.equal(out.argmax(-1),
                                         tokens["i"][:, pos + 1]))
    res["i"].update(rel_err_vs_full=err / scale, max_abs_err=err,
                    logit_scale=scale, replay_equal=replay_equal,
                    finite=bool(torch.isfinite(full).all()))
    del full

    # (ii) and (iii) in lockstep on (ii)'s greedy tokens
    pk = pipes["ii"]
    res["lockstep"], cache, tok = lockstep_routes(pipes, ids, new_tokens,
                                                  sync)
    if profile:
        pos = prompt_len + steps
        for run in ("ii", "iii"):
            profile_pass(lambda run=run: decode_step(pipes[run], cache[run],
                                                     tok, pos),
                         f"decode step ({run}), bucket "
                         f"{pk._read_len(pos)}, pos {pos}")

    # the generate entry, once, with the kernel route chosen by the env
    pt = ",".join(f"{l},{r}" for l, r in partition)
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.generate", "-m", model,
           "-pt", pt, "-b", str(batch), "--prompt-len", str(prompt_len),
           "--new-tokens", str(new_tokens), "--max-len", str(max_len),
           "--attend-floor", str(floor), "--kv-bits", "8",
           "--device", torch.device(device).type]
    env = dict(os.environ, PIPEEDGE_INT8_DECODE_ATTEND="1")
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        log("generate entry: " + line)
    launches = [json.loads(ln.split("=", 1)[1]) for ln in lines
                if ln.startswith("kernel_launches=")]
    res["entry"] = dict(
        command=" ".join(cmd[1:]), seconds=time.monotonic() - t0,
        report=[ln for ln in lines if ln.startswith("generated ")],
        decode_attention=launches[0]["decode_attention"] if launches
        else None,
        # warm-up of 2 tokens (1 decode step) + the timed generation
        expected_decode_attention=blocks * (1 + steps) if on_card else 0)
    return res


def decode_step(pipe, caches, tok, pos):
    """One decode step of every stage of `pipe` at `pos`: tokens [B] ->
    the last stage's logits [B, V]."""
    data = tok[:, None]
    for i, st in enumerate(pipe.stages):
        data, caches[i] = pipe._decode_step(st, data, caches[i], pos)
    return data[:, 0]


def lockstep_routes(pipes, ids, new_tokens: int, sync):
    """Prefill `ids` on the kernel route pipes["ii"] and the dequantize
    route pipes["iii"] (both int8 caches), then step both on (ii)'s greedy
    tokens, in alternating order, the launch counts set to 0 before each
    step. Returns (the numbers, the caches, the last token)."""
    from pipeedge_tpu_torch.ops import _build
    prompt_len = ids.shape[1]
    pk = pipes["ii"]
    prefill_ms, cache, last = {}, {}, {}
    for run in ("ii", "iii"):
        sync()
        t0 = time.monotonic()
        logits, cache[run] = pipes[run]._prefill(ids)
        sync()
        prefill_ms[run] = (time.monotonic() - t0) * 1e3
        last[run] = logits[:, -1]
    tok = last["ii"].argmax(-1)
    step_ms = {"ii": {}, "iii": {}}
    per_step = {"ii": set(), "iii": set()}
    route_err = float((last["ii"] - last["iii"]).abs().max()
                      / last["iii"].abs().max())
    for s in range(1, new_tokens):
        pos = prompt_len + s - 1
        bucket = pk._read_len(pos)
        order = ("ii", "iii") if s % 2 else ("iii", "ii")
        out = {}
        for run in order:
            _build.reset_launch_counts()
            sync()
            t0 = time.monotonic()
            out[run] = decode_step(pipes[run], cache[run], tok, pos)
            sync()
            step_ms[run].setdefault(bucket, []).append(
                (time.monotonic() - t0) * 1e3)
            per_step[run].add(_build.launch_counts["decode_attention"])
        route_err = max(route_err, float(
            (out["ii"] - out["iii"]).abs().max() / out["iii"].abs().max()))
        tok = out["ii"].argmax(-1)
    numbers = dict(
        rel_err=route_err, prefill_ms=prefill_ms,
        launches_per_step={r: sorted(v) for r, v in per_step.items()},
        step_p50_ms={r: {str(b): statistics.median(v)
                         for b, v in sorted(by.items())}
                     for r, by in step_ms.items()},
        steps_per_bucket={str(b): len(v)
                          for b, v in sorted(step_ms["ii"].items())})
    return numbers, cache, tok


def tiny_decode_path(device: str, model: str = TINY_DECODE_MODEL,
                     partition=TINY_DECODE_PARTITION,
                     batch: int = TINY_DECODE_BATCH,
                     prompt_len: int = TINY_DECODE_PROMPT,
                     new_tokens: int = TINY_DECODE_NEW) -> dict:
    """The tiny GPT-2 (head dim 8; seeded random weights made in-process)
    with an int8 cache through `DecodePipeline.generate` on the kernel
    route (ii) and the dequantize route (iii), the launch counts set to 0
    just before each timed generation; then the two in lockstep
    (`lockstep_routes`). `check_tiny_decode` gates the result."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = registry.get_model_config(model)
    pipes = {run: decode.build_decode_pipeline(
        model, partition, max_len=cfg.max_position_embeddings,
        cache_bits=8, attend_floor=16, device=device,
        int8_decode_attend=optin) for run, optin in (("ii", 1), ("iii", 0))}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(device)
    blocks = cfg.num_hidden_layers
    res = {"head_dim": cfg.head_dim, "expected_decode_attention": {
        "ii": blocks * (new_tokens - 1) if on_card else 0, "iii": 0},
        "expected_launches_per_step": {"ii": [blocks if on_card else 0],
                                       "iii": [0]}}
    tokens = {}
    for run, pipe in pipes.items():
        pipe.generate(ids, 2)                  # warm-up (not counted)
        sync()
        _build.reset_launch_counts()
        tokens[run] = pipe.generate(ids, new_tokens)
        sync()
        res[run] = dict(counts=dict(_build.launch_counts),
                        shape=list(tokens[run].shape))
    res["tokens_equal"] = bool(torch.equal(tokens["ii"], tokens["iii"]))
    res["lockstep"], _, _ = lockstep_routes(pipes, ids, new_tokens, sync)
    return res


def check_tiny_decode(res, device_name: str) -> None:
    log("tiny decode (ii)/(iii): " + json.dumps(
        {**res, "card": device_name}, sort_keys=True))
    for run in ("ii", "iii"):
        got = res[run]["counts"]["decode_attention"]
        if got != res["expected_decode_attention"][run]:
            raise AssertionError(f"tiny decode ({run}): {got} decode "
                                 f"attention launches != "
                                 f"{res['expected_decode_attention'][run]}")
    if not res["tokens_equal"]:
        raise AssertionError("tiny decode: greedy tokens of the kernel "
                             "route differ from the dequantize route's")
    lock = res["lockstep"]
    if lock["rel_err"] > DECODE_ROUTE_BOUND:
        raise AssertionError(f"tiny decode (ii) vs (iii): logits differ by "
                             f"{lock['rel_err']} of max |logit| > "
                             f"{DECODE_ROUTE_BOUND}")
    if lock["launches_per_step"] != res["expected_launches_per_step"]:
        raise AssertionError(f"tiny decode lockstep: kernel launches per "
                             f"step {lock['launches_per_step']}")


def check_decode_path(res, device_name: str) -> None:
    expected = res["expected"]
    for run in ("i", "ii", "iii"):
        r = res[run]
        log(f"decode main path ({run}): " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        want = {name: 0 for name in r["counts"]}
        want["decode_attention"] = expected["decode_attention"][run]
        if r["counts"] != want:
            raise AssertionError(f"decode ({run}): launch counts "
                                 f"{r['counts']} != {want}")
        if r["shape"] != expected["shape"] or not r["in_vocab"]:
            raise AssertionError(f"decode ({run}): tokens of shape "
                                 f"{r['shape']}, in vocab {r['in_vocab']}")
    i = res["i"]
    if not i["finite"] or i["rel_err_vs_full"] > DECODE_FP_BOUND:
        raise AssertionError(f"decode (i): step logits off the full-"
                             f"sequence forward by {i['rel_err_vs_full']} "
                             f"of max |logit| > {DECODE_FP_BOUND}")
    lock = res["lockstep"]
    log("decode lockstep (ii)/(iii): " + json.dumps(
        {**lock, "card": device_name}, sort_keys=True))
    if lock["rel_err"] > DECODE_ROUTE_BOUND:
        raise AssertionError(f"decode (ii) vs (iii): logits differ by "
                             f"{lock['rel_err']} of max |logit| > "
                             f"{DECODE_ROUTE_BOUND}")
    if lock["launches_per_step"] != expected["launches_per_step"]:
        raise AssertionError(f"decode lockstep: kernel launches per step "
                             f"{lock['launches_per_step']}")
    entry = res["entry"]
    log("generate entry: " + json.dumps(entry, sort_keys=True))
    if len(entry["report"]) != 1 or \
            entry["decode_attention"] != entry["expected_decode_attention"]:
        raise AssertionError(f"generate entry: report {entry['report']}, "
                             f"{entry['decode_attention']} decode_attention "
                             f"launches != "
                             f"{entry['expected_decode_attention']}")


# --- phase 8: DeiT-Base in 8 stages with adaptive edges ---------------------

def write_random_checkpoint(module, model: str, weights_dir: Path) -> Path:
    """The whole model's `init_params(seed 0)` weights in the family's
    checkpoint keys, as an npz under the gitignored build directory."""
    from pipeedge_tpu_torch.models import registry
    weights_dir.mkdir(parents=True, exist_ok=True)
    path = weights_dir / f"{model.replace('/', '_')}-init-seed0.npz"
    t0 = time.monotonic()
    np.savez(path, **module.random_npz_weights(
        registry.get_model_config(model), seed=0))
    log(f"weights: {path.name} ({path.stat().st_size / 2**20:.1f} MiB) in "
        f"{time.monotonic() - t0:.1f} s")
    return path


def single_shard_logits(model: str, weights_file: Path, inputs, device: str):
    from pipeedge_tpu_torch.models import registry
    fn, params, _ = registry.module_shard_factory(
        model, str(weights_file), 1, registry.get_model_layers(model),
        device=device)
    return [fn(params, x) for x in inputs]


def wire_bits(raw_bytes: int, widths, ubatch: int) -> dict:
    """Wire bytes of one edge at each bitwidth a policy can pick (and 0),
    from its raw f32 bytes: for each of its tensors (`widths`: their last
    dims), packed words plus a scale and a shift per item. Each bitwidth
    packs another count of values per word, so the bytes name the bit."""
    from pipeedge_tpu_torch.ops.quant import packed_words
    from pipeedge_tpu_torch.utils.quant import BITWIDTHS
    seq = raw_bytes // (4 * ubatch * sum(widths))
    table = {raw_bytes: 0}
    for bit in BITWIDTHS:
        nbytes = sum(ubatch * (packed_words(seq * w, bit) * 4 + 8)
                     for w in widths)
        if nbytes in table:
            raise AssertionError(f"{bit} and {table[nbytes]} bits give the "
                                 f"same wire bytes {nbytes}")
        table[nbytes] = bit
    return table


def edge_widths(cfg, layer_end: int):
    """Last dims of the tensors on the edge after sublayer `layer_end`:
    (ctx, residual) after an attention, (mlp_h, residual) after an MLP-up,
    the hidden state otherwise."""
    sub = (layer_end - 1) % 4
    d = cfg.hidden_size
    return {0: (d, d), 2: (cfg.intermediate_size, d)}.get(sub, (d,))


def adaptive_run(pipe, inputs, labels, policy, constraint: float,
                 window: int, monitor_dir: Path) -> dict:
    """One pass of the batch through the runtime's own loop: the monitoring
    session and keys of `runtime.init_monitoring`, the per-edge callbacks
    and the `ADAPTIVE_QUANT` policy of `runtime.attach_callbacks`, every
    edge starting at 8 bits. Records each microbatch's wire bytes per edge
    as `edge_bytes_callback` reports them; the launch counts are set to 0
    just before the pass."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.monitoring import facade as monitoring
    from pipeedge_tpu_torch.ops import _build
    env = {runtime.ENV_WINDOW_SIZE: str(window),
           runtime.ENV_SEND_CONSTRAINT: repr(constraint)}
    if policy:
        env[runtime.ENV_ADAPTIVE_QUANT] = policy
    saved = {k: os.environ.pop(k, None) for k in (
        runtime.ENV_WINDOW_SIZE, runtime.ENV_SEND_CONSTRAINT,
        runtime.ENV_ADAPTIVE_QUANT)}
    os.environ.update(env)
    monitor_dir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(monitor_dir)          # the session's CSVs land in the cwd
    set_edge_bits(pipe, 8)
    wire = []
    try:
        runtime.init_monitoring(window)
        runtime.attach_callbacks(pipe, window)
        record, on_result = pipe.edge_bytes_callback, pipe.ubatch_callback
        callback_s = [0.0, 0.0]     # edge-bytes callback, result callback

        def spy(i, edge_bytes):
            wire.append(list(edge_bytes))
            t0 = time.perf_counter()
            record(i, edge_bytes)
            callback_s[0] += time.perf_counter() - t0

        def timed_result(i, out):
            t0 = time.perf_counter()
            on_result(i, out)
            callback_s[1] += time.perf_counter() - t0

        pipe.edge_bytes_callback = spy
        pipe.ubatch_callback = timed_result
        for lb in labels:
            runtime.label_queue.put(lb)
        _build.reset_launch_counts()
        outs, stats = pipe.run(inputs)
        counts = dict(_build.launch_counts)
        snap = monitoring.snapshot()
    finally:
        monitoring.finish()
        pipe.edge_bytes_callback = pipe.ubatch_callback = None
        os.chdir(cwd)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return dict(outs=outs, wire=wire, counts=counts, stats=stats, snap=snap,
                final_bits=runtime.edge_bits(pipe),
                # the host's time in the runtime's callbacks per microbatch
                edge_callback_ms=callback_s[0] * 1e3 / len(inputs),
                result_callback_ms=callback_s[1] * 1e3 / len(inputs))


def replay(pipe, x, bits):
    """One microbatch through the same pipeline at fixed edge bits; returns
    its logits and wire bytes per edge."""
    for stage, bit in zip(pipe.stages[:-1], bits):
        stage.quant_bit = bit
    wire = []
    pipe.edge_bytes_callback = lambda i, edge_bytes: wire.append(edge_bytes)
    try:
        outs, _ = pipe.run([x])
    finally:
        pipe.edge_bytes_callback = None
    return outs[0], wire[0]


def deit_path(device: str, model: str = DEIT_MODEL,
              partition=DEIT_PARTITION, profile: bool = False,
              weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build") -> dict:
    """Phase 8 (module docstring): DeiT-Base in 8 stages at bits 0, 8 and
    4, then each adaptive policy through the runtime's callback against a
    send constraint set from the unconstrained run, each microbatch
    replayed at the bits it travelled with; then the runtime entry once
    with HEURISTIC. `check_deit_path` gates the result."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import deit, edge_arity, registry
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline

    on_card = torch.device(device).type == "cuda"
    cfg = registry.get_model_config(model)
    weights_file = write_random_checkpoint(deit, model, weights_dir)
    inputs, labels = runtime.load_batches(model, BATCH, UBATCH,
                                          torch.device(device), torch.float32)
    n_mb = len(inputs)
    exact = single_shard_logits(model, weights_file, inputs, device)
    pipe = build_pipeline(model, partition, model_file=str(weights_file),
                          device=device, quant_bits=[8] * len(partition))
    edges = len(partition) - 1
    edge_tensors = sum(edge_arity(r) for _, r in partition[:-1])
    blocks = cfg.num_hidden_layers
    res = {"fixed": {}}
    for bit in (0, 8, 4):
        set_edge_bits(pipe, bit)
        res["fixed"][bit] = measure(pipe, inputs, exact, expected={
            "fused_attention": blocks * n_mb if on_card else 0,
            "fused_encode": edge_tensors * n_mb if bit and on_card else 0,
            "fused_decode": edge_tensors * n_mb if bit and on_card else 0,
            "int8_matmul": 0, "decode_attention": 0},
            expected_shape=[UBATCH, cfg.num_labels])
    if profile:
        set_edge_bits(pipe, 8)
        profile_pass(lambda: pipe.run(inputs),
                     f"deit-base, {len(partition)} stages, 8-bit edges")

    # the raw bytes of each edge, from a bit-0 pass: the key to the bits
    set_edge_bits(pipe, 0)
    raw = []
    pipe.edge_bytes_callback = lambda i, edge_bytes: raw.append(edge_bytes)
    pipe.run(inputs[:1])
    pipe.edge_bytes_callback = None
    tables = [wire_bits(nbytes, edge_widths(cfg, r), UBATCH)
              for nbytes, (_, r) in zip(raw[0], partition[:-1])]

    monitor_dir = weights_dir / "monitor"
    window = ADAPTIVE_WINDOW
    free = adaptive_run(pipe, inputs, labels, None, 0.0, window, monitor_dir)
    send0 = free["snap"]["send0"]["global"]
    items_s = send0["heartrate"] * UBATCH
    constraint = ADAPTIVE_SHARE * items_s
    res["unconstrained"] = dict(
        edge0_mbit_s=send0["perf"], edge0_items_s=items_s,
        share=ADAPTIVE_SHARE, send_constraint_items_s=constraint,
        # the 8-bit pipeline with the runtime's callbacks on, to set beside
        # the same pipeline without them (res["fixed"][8])
        steady_items_per_s=free["stats"].get(
            "steady_state_throughput_items_sec"),
        host_dispatch_ms=free["stats"]["host_dispatch_s_per_ubatch"] * 1e3,
        edge_callback_ms=free["edge_callback_ms"],
        result_callback_ms=free["result_callback_ms"],
        send_constraint_edge0_mbit_s=ADAPTIVE_SHARE * send0["perf"],
        bits=[[tables[e][b] for e, b in enumerate(mb)] for mb in free["wire"]])
    log("deit adaptive: unconstrained run " + json.dumps(res["unconstrained"]))
    res["policies"] = {}
    for policy in ("HEURISTIC", "HEURISTIC2", "CONTROLLER"):
        run = adaptive_run(pipe, inputs, labels, policy, constraint, window,
                           monitor_dir)
        bits = [[tables[e][b] for e, b in enumerate(mb)] for mb in run["wire"]]
        gaps, equal, repeat_equal = [], [], []
        scale = max(float(e.abs().max()) for e in exact)
        for i, x in enumerate(inputs):
            first, wire = replay(pipe, x, bits[i])
            if wire != run["wire"][i]:
                raise AssertionError(f"{policy} microbatch {i}: replay wire "
                                     f"bytes {wire} != {run['wire'][i]}")
            equal.append(bool(torch.equal(first, run["outs"][i])))
            if not equal[-1]:
                # is the fixed-bit pass itself repeatable on the card?
                again, _ = replay(pipe, x, bits[i])
                repeat_equal.append(bool(torch.equal(first, again)))
            gaps.append(float((first - run["outs"][i]).abs().max()) / scale)
        coded = sum(b in (4, 8) for mb in bits for b in mb)
        res["policies"][policy] = dict(
            bits=bits, final_bits=run["final_bits"], counts=run["counts"],
            expected_counts={
                "fused_attention": blocks * n_mb if on_card else 0,
                "fused_encode": coded if on_card else 0,
                "fused_decode": coded if on_card else 0,
                "int8_matmul": 0, "decode_attention": 0},
            replay_equal=equal, replay_repeat_equal=repeat_equal,
            replay_rel_gap=max(gaps),
            rel_err=max(float((o - e).abs().max()) for o, e in
                        zip(run["outs"], exact)) / scale,
            finite=all(bool(torch.isfinite(o).all()) for o in run["outs"]),
            steady_items_per_s=run["stats"].get(
                "steady_state_throughput_items_sec"),
            edge_callback_ms=run["edge_callback_ms"],
            result_callback_ms=run["result_callback_ms"],
            edge0_mbit_s=run["snap"]["send0"]["global"]["perf"])
        log(f"deit adaptive {policy}: bits per microbatch (edges 0..{edges - 1}) "
            + json.dumps(bits))
    del pipe

    # the runtime entry itself, 8 stages, HEURISTIC against that constraint
    pt = ",".join(f"{l},{r}" for l, r in partition)
    res["entry"] = run_entry(
        ["0", str(len(partition)), "-m", model, "-pt", pt,
         "-q", ",".join(["8"] * edges + ["0"]), "-b", str(BATCH),
         "-u", str(UBATCH), "--device", torch.device(device).type],
        {"ADAPTIVE_QUANT": "HEURISTIC", "WINDOW_SIZE": str(window),
         "SEND_CONSTRAINT": repr(constraint)}, monitor_dir)
    res["entry"]["expected"] = {"fused_attention": blocks * n_mb
                                if on_card else 0}
    return res


def run_entry(argv, env_extra: dict, cwd: Path) -> dict:
    """`python -m pipeedge_tpu_torch.runtime ARGV` as a subprocess (its
    monitoring CSVs in `cwd`); returns its report lines, launch counts and
    final edge bits."""
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.runtime"] + argv
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_extra)
    cwd.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        log("runtime entry: " + line)

    def value(prefix):
        found = [json.loads(ln.split("=", 1)[1]) for ln in lines
                 if ln.startswith(prefix + "=")]
        return found[0] if len(found) == 1 else None

    steady = [float(ln.split("=", 1)[1]) for ln in lines
              if ln.startswith("steady_state_throughput_items_sec=")]
    return dict(command=" ".join(
        [f"{k}={v}" for k, v in env_extra.items()] + cmd[1:]),
        seconds=time.monotonic() - t0, kernel_launches=value("kernel_launches"),
        edge_bits=value("edge_bits"),
        report=[ln for ln in lines if ln.startswith("latency_sec=")],
        steady_items_per_s=steady[-1] if steady else None,
        # the schedule the runtime logged (on stderr), message text only
        sched_log=[ln.split("Scheduling: ", 1)[1]
                   for ln in proc.stderr.splitlines()
                   if "Scheduling: stage-to-" in ln])


def ab_entry(parent_root: Path) -> list:
    """The ViT entry of the port's runtime (`python -m
    pipeedge_tpu_torch.runtime 0 2 -m google/vit-base-patch16-224 -pt
    1,21,22,48 -q 8,0 -b 64 -u 8 --measure-rounds AB_ENTRY_ROUNDS`) from
    another checkout (`parent_root`) and from this one, in the order
    parent, this, this, parent, twice, each in a fresh working directory.
    Returns one row per run: the rounds' items/s and the last round's
    steady items/s and latency."""
    argv = ["0", "2", "-m", MODEL, "-pt", "1,21,22,48", "-q", "8,0",
            "-b", str(BATCH), "-u", str(UBATCH),
            "--measure-rounds", str(AB_ENTRY_ROUNDS)]
    rows = []
    order = [("parent", parent_root), ("this", ROOT), ("this", ROOT),
             ("parent", parent_root)] * 2
    for n, (name, root) in enumerate(order):
        cwd = ROOT / "pipeedge_tpu_torch" / "_build" / f"ab_entry{n}"
        cwd.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "pipeedge_tpu_torch.runtime"] + argv,
            cwd=cwd, env=dict(os.environ, PYTHONPATH=str(root.resolve())),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"ab entry ({name}) exited {proc.returncode}:"
                               f"\n{proc.stderr[-4000:]}")
        fields = [dict(kv.split("=", 1) for kv in ln.split())
                  for ln in proc.stdout.splitlines()
                  if ln.startswith(("round=", "steady_state_"))]
        rounds = [float(f["throughput_items_sec"]) for f in fields
                  if "round" in f]
        steady = [float(f["steady_state_throughput_items_sec"])
                  for f in fields if "steady_state_throughput_items_sec" in f]
        row = dict(version=name, root=str(root), items_per_s_rounds=rounds,
                   last_round_latency_s=float(fields[len(rounds) - 1][
                       "latency_sec"]) if rounds else None,
                   steady_items_per_s=steady[-1] if steady else None,
                   csv_files=sorted(f.name for f in cwd.glob("*.csv")),
                   seconds=time.monotonic() - t0)
        log("ab entry " + json.dumps(row))
        rows.append(row)
    return rows


def check_entry(name: str, entry: dict) -> None:
    log(f"{name} entry: " + json.dumps(entry, sort_keys=True))
    launches = entry["kernel_launches"] or {}
    if len(entry["report"]) != 1 or entry["edge_bits"] is None or any(
            launches.get(k) != v for k, v in entry["expected"].items()):
        raise AssertionError(f"{name} entry: report {entry['report']}, "
                             f"launches {launches} (expected "
                             f"{entry['expected']}), edge bits "
                             f"{entry['edge_bits']}")


def check_fixed_bits(name: str, fixed: dict, device_name: str) -> None:
    """Gate the fixed-bit runs of phases 8 and 9 (`measure` results keyed
    by edge bit): shape, finite logits and launch counts; bit 0 equal to
    the single-shard forward; other bits within LOGIT_BOUND."""
    for bit, r in fixed.items():
        log(f"{name} fixed bit {bit}: " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        if r["shape"] != r["expected_shape"] or not r["finite"] or \
                r["counts"] != r["expected_counts"]:
            raise AssertionError(f"{name} bit {bit}: shape {r['shape']}, "
                                 f"finite={r['finite']}, launch counts "
                                 f"{r['counts']} != {r['expected_counts']}")
        if bit == 0 and not r["equal"]:
            raise AssertionError(f"{name} bit 0: pipeline logits differ "
                                 f"from the single-shard forward by "
                                 f"{r['max_abs_err']}")
        if bit and not 0 < r["rel_err"] <= LOGIT_BOUND[bit]:
            raise AssertionError(f"{name} bit {bit}: logit error "
                                 f"{r['rel_err']} not in (0, "
                                 f"{LOGIT_BOUND[bit]}]")


def check_deit_path(res, device_name: str) -> None:
    check_fixed_bits("deit", res["fixed"], device_name)
    moved = False
    for policy, r in res["policies"].items():
        log(f"deit adaptive {policy}: " + json.dumps(
            {k: v for k, v in r.items() if k != "bits"}, sort_keys=True))
        if r["counts"] != r["expected_counts"] or not r["finite"]:
            raise AssertionError(f"deit {policy}: launch counts {r['counts']}"
                                 f" != {r['expected_counts']} or non-finite")
        if not all(r["replay_equal"]):
            # bit for bit, unless the same fixed-bit pass is itself not
            # repeatable on the card (`replay_repeat_equal`: a second
            # replay of each microbatch that differed); then within
            # REPLAY_BOUND
            if all(r["replay_repeat_equal"]) or \
                    r["replay_rel_gap"] > REPLAY_BOUND:
                raise AssertionError(f"deit {policy}: a microbatch differs "
                                     f"from its fixed-bit replay by "
                                     f"{r['replay_rel_gap']} of max |logit|")
        moved = moved or any(b != 8 for mb in r["bits"] for b in mb)
    if not moved:
        raise AssertionError("deit: no adaptive policy moved an edge off 8 "
                             "bits")
    check_entry("deit", res["entry"])


# --- phase 9: BERT-Base CoLA and the tiny BERT --------------------------------

def bert_path(device: str, model: str = BERT_MODEL, partition=BERT_PARTITION,
              profile: bool = False,
              weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build") -> dict:
    """Phase 9 (module docstring): the runtime entry on BERT-Base CoLA,
    then an in-process 2-stage run at bits 0 and 8 against the single-shard
    forward, and the tiny BERT on `device` against its run on the CPU.
    `check_bert_path` gates the result."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import bert, edge_arity, registry
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline

    on_card = torch.device(device).type == "cuda"
    cfg = registry.get_model_config(model)
    blocks = cfg.num_hidden_layers
    n_mb = BATCH // UBATCH
    edge_tensors = sum(edge_arity(r) for _, r in partition[:-1])
    pt = ",".join(f"{l},{r}" for l, r in partition)
    res = {"entry": run_entry(
        ["0", str(len(partition)), "-m", model, "-pt", pt, "-q", "8,0",
         "-b", str(BATCH), "-u", str(UBATCH),
         "--device", torch.device(device).type], {},
        weights_dir / "monitor")}
    res["entry"]["expected"] = {
        "fused_attention": blocks * n_mb if on_card else 0,
        "fused_encode": edge_tensors * n_mb if on_card else 0,
        "fused_decode": edge_tensors * n_mb if on_card else 0}

    weights_file = write_random_checkpoint(bert, model, weights_dir)
    inputs, _ = runtime.load_batches(model, BATCH, UBATCH,
                                     torch.device(device), torch.float32)
    exact = single_shard_logits(model, weights_file, inputs, device)
    pipe = build_pipeline(model, partition, model_file=str(weights_file),
                          device=device, quant_bits=[0] * len(partition))
    res["fixed"] = {}
    for bit in (0, 8):
        set_edge_bits(pipe, bit)
        res["fixed"][bit] = measure(pipe, inputs, exact, expected={
            "fused_attention": blocks * n_mb if on_card else 0,
            "fused_encode": edge_tensors * n_mb if bit and on_card else 0,
            "fused_decode": edge_tensors * n_mb if bit and on_card else 0,
            "int8_matmul": 0, "decode_attention": 0},
            expected_shape=[UBATCH, cfg.num_labels])
    if profile:
        set_edge_bits(pipe, 8)
        profile_pass(lambda: pipe.run(inputs),
                     f"bert-base CoLA, {len(partition)} stages, 8-bit edge")
    del pipe, exact

    # the tiny BERT (head dim 8): on `device` and on the CPU, exact edges
    tiny_inputs, _ = runtime.load_batches(TINY_BERT_MODEL, BATCH, UBATCH,
                                          torch.device("cpu"), torch.float32)
    outs = {}
    for dev in (device, "cpu"):
        tiny = build_pipeline(TINY_BERT_MODEL, TINY_BERT_PARTITION,
                              device=dev, quant_bits=[0, 0])
        outs[dev], _ = tiny.run([x.to(dev) for x in tiny_inputs])
    gap = max(float((o.cpu() - c).abs().max())
              for o, c in zip(outs[device], outs["cpu"]))
    res["tiny"] = dict(max_abs_err=gap, head_dim=registry.get_model_config(
        TINY_BERT_MODEL).head_dim, shape=list(outs["cpu"][0].shape))
    for o, c in zip(outs[device], outs["cpu"]):
        torch.testing.assert_close(o.cpu(), c, **ATTN_TOL[torch.float32])
    return res


def check_bert_path(res, device_name: str) -> None:
    check_entry("bert", res["entry"])
    check_fixed_bits("bert", res["fixed"], device_name)
    log("tiny bert on the card vs the CPU: " + json.dumps(
        {**res["tiny"], "card": device_name}))


# --- phase 10: the profiler -> scheduler -> runtime loop -------------------

def layer_param_mib(model: str, weights_file: Path) -> list:
    """Each sublayer's parameter MiB, from shards loaded on the CPU (one
    per sublayer kind, first and last layer: the blocks are alike)."""
    from pipeedge_tpu_torch import profiler
    from pipeedge_tpu_torch.models import registry
    total = registry.get_model_layers(model)
    cache = {}
    out = []
    for layer in range(1, total + 1):
        key = ((layer - 1) % 4, layer == 1, layer == total)
        if key not in cache:
            _, params, _ = registry.module_shard_factory(
                model, str(weights_file), layer, layer, device="cpu")
            cache[key] = profiler.params_bytes(params) / 1024 / 1024
        out.append(cache[key])
    return out


def check_profile(results: dict, model: str, param_mib: list) -> dict:
    """Hold one profiler run to its model: the layer count, contiguous
    layers, each layer's output shapes equal to the next one's inputs,
    finite positive times, memory at least the parameters'. Returns the
    per-sublayer-kind times (s): mean over the inner blocks, first and
    last layer, and the sum."""
    from pipeedge_tpu_torch.models import registry
    data = results["profile_data"]
    total = registry.get_model_layers(model)
    problems = []
    if results["layers"] != total or \
            [d["layer"] for d in data] != list(range(1, total + 1)):
        problems.append(f"layers {[d['layer'] for d in data]} of {total}")
    problems += [f"layer {a['layer']} shape_out {a['shape_out']} != layer "
                 f"{b['layer']} shape_in {b['shape_in']}"
                 for a, b in zip(data, data[1:])
                 if a["shape_out"] != b["shape_in"]]
    problems += [f"layer {d['layer']} time {d['time']}" for d in data
                 if not (np.isfinite(d["time"]) and d["time"] > 0)]
    problems += [f"layer {d['layer']} memory {d['memory']} MiB < "
                 f"parameters {mib} MiB" for d, mib in zip(data, param_mib)
                 if not d["memory"] >= mib]
    if problems:
        raise AssertionError(f"profile of {model}: " + "; ".join(problems))
    inner = data[1:-1]     # without the embedding and the head
    return dict(
        kinds={kind: statistics.mean(d["time"] for d in inner
                                     if (d["layer"] - 1) % 4 == i)
               for i, kind in enumerate(("attention", "attention_out",
                                         "mlp_up", "mlp_down"))},
        first=data[0]["time"], last=data[-1]["time"],
        total=sum(d["time"] for d in data),
        memory_mib=sum(d["memory"] for d in data))


def sublayer_times(model: str, weights_file: Path, device: str,
                   iterations: int = 16) -> dict:
    """Where a profiled sublayer's time goes: for the four sublayers of
    the second block (layers 5-8), the profiler's time per forward (CUDA
    events around `iterations` back-to-back forwards, host gaps
    included), the kernels' own time per forward (torch.profiler over
    the same loop) and the host's time to enqueue one forward (the loop
    on the host clock, before the device is waited for)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pipeedge_tpu_torch import profiler
    from pipeedge_tpu_torch.models import registry
    payload = profiler.default_inputs(model, UBATCH, device=device)
    out = {}
    for layer in range(1, 9):
        fn, params, _ = registry.module_shard_factory(
            model, str(weights_file), layer, layer, device=device)
        if layer >= 5:
            events_s = profiler.time_shard_fn(fn, params, payload, iterations)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iterations):
                fn(params, payload)
            host_s = (time.perf_counter() - t0) / iterations
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iterations):
                    fn(params, payload)
                torch.cuda.synchronize()
            kernel_us = sum(e.self_device_time_total
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA)
            out[layer] = dict(events_ms=events_s * 1e3,
                              kernels_ms=kernel_us / 1e3 / iterations,
                              host_enqueue_ms=host_s * 1e3)
        payload = fn(params, payload)
        del fn, params
    return out


def sched_path(card: str, profiles_out=None) -> dict:
    """Phase 10 (module docstring): profile, convert, schedule and run
    ViT-Large through the runtime entry on cuda:0; then BASELINE configs
    1 and 2. `check_sched_path` gates the result. With `profiles_out`,
    the profiles and the scheduler's files are also written there, each
    opening with a comment line that names the card (`card`)."""
    import ast
    import tempfile
    from pipeedge_tpu_torch import profiler, runtime
    from pipeedge_tpu_torch import profiler_results_to_device_types as to_types
    from pipeedge_tpu_torch import profiler_results_to_models as to_models
    from pipeedge_tpu_torch.models import registry, vit
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline
    from pipeedge_tpu_torch.sched import miniyaml, scheduler, yaml_files

    device = "cuda"
    weights_dir = ROOT / "pipeedge_tpu_torch" / "_build"
    mem_mib = torch.cuda.get_device_properties(0).total_memory // 2**20
    n_mb = BATCH // UBATCH
    weights = {model: write_random_checkpoint(vit, model, weights_dir)
               for model in dict.fromkeys([*PROFILE_MODELS.values(), MODEL])}
    res = {"profiles": {}, "mem_mib": mem_mib, "bw_mbps": NVLINK_MBPS}
    with tempfile.TemporaryDirectory(prefix="sched_") as tmp_name:
        tmp = Path(tmp_name)
        files = {"models": tmp / "models.yml",
                 "device_types": tmp / "device_types.yml",
                 "devices": tmp / "devices.yml"}
        for key, model in PROFILE_MODELS.items():
            out = tmp / f"profiler_results_{key}.yml"
            files[key] = out
            _build.reset_launch_counts()
            t0 = time.monotonic()
            results = profiler.main(
                ["-m", model, "-M", str(weights[model]), "-b", str(UBATCH),
                 "-t", "float32", "-o", str(out), "--device", device])
            seconds = time.monotonic() - t0
            launches = _build.launch_counts["fused_attention"]
            res["profiles"][key] = dict(
                model=model, seconds=seconds, attention_launches=launches,
                **check_profile(results, model,
                                layer_param_mib(model, weights[model])))
            to_models.main(["-i", str(out), "-o", str(files["models"])])
            to_types.main([SCHED_DEV_TYPE, "-i", str(out),
                           "-o", str(files["device_types"]),
                           "-dtm", str(mem_mib), "-dtb", str(NVLINK_MBPS)])
        yaml_files.yaml_save({SCHED_DEV_TYPE: SCHED_HOSTS},
                             str(files["devices"]))

        sched = scheduler.sched_pipeline(
            SCHED_MODEL, 2, 2, UBATCH, dtype="float32",
            models_file=str(files["models"]),
            dev_types_file=str(files["device_types"]),
            dev_file=str(files["devices"]))
        stages = [(host, tuple(lr)) for st in sched for host, lr in st.items()]
        res["schedule"] = stages
        time_s = miniyaml.load(files["device_types"])[SCHED_DEV_TYPE][
            "model_profiles"][SCHED_MODEL][0]["time_s"]
        stage_s = [sum(time_s[l - 1:r]) for _, (l, r) in stages]
        res["stage_s"] = stage_s
        # the scheduler's model: stages on separate cards, the slowest sets
        # the rate; on one card the stages share it, so their sum does
        res["predicted_items_per_s"] = UBATCH / max(stage_s)
        res["one_card_items_per_s"] = UBATCH / sum(stage_s)

        saved = tmp / "results.npz"
        entry = run_entry(
            ["0", str(len(SCHED_HOSTS)), "-m", SCHED_MODEL,
             "-M", str(weights[SCHED_MODEL]), "-sm", str(files["models"]),
             "-sdt", str(files["device_types"]),
             "-sd", str(files["devices"]), "-H", ",".join(SCHED_HOSTS),
             "-b", str(BATCH), "-u", str(UBATCH),
             "--measure-rounds", str(SCHED_ROUNDS),
             "--save-results", str(saved), "--device", device], {},
            weights_dir / "monitor")
        blocks = registry.get_model_config(SCHED_MODEL).num_hidden_layers
        entry["expected"] = {
            "fused_attention": blocks * n_mb * SCHED_ROUNDS,
            "fused_encode": 0, "fused_decode": 0}
        logged = {line.split(":", 1)[0]: ast.literal_eval(
            line.split(": ", 1)[1]) for line in entry["sched_log"]}
        entry["logged_layers"] = [tuple(lr) for lr in logged.get(
            "stage-to-layer mapping", [])]
        entry["logged_hosts"] = logged.get("stage-to-host mapping")
        res["entry"] = entry

        inputs, _ = runtime.load_batches(SCHED_MODEL, BATCH, UBATCH,
                                         torch.device(device), torch.float32)
        exact = single_shard_logits(SCHED_MODEL, weights[SCHED_MODEL], inputs,
                                    device)
        with np.load(saved) as z:
            got = [z[f"arr_{i}"] for i in range(len(z.files))]
        want = [e.cpu().numpy() for e in exact]
        res["saved"] = dict(
            microbatches=len(got), shape=list(got[0].shape) if got else None,
            finite=all(bool(np.isfinite(g).all()) for g in got),
            equal=len(got) == SCHED_ROUNDS * n_mb and all(
                np.array_equal(g, want[i % n_mb]) for i, g in enumerate(got)),
            max_abs_err=max((float(np.abs(g - want[i % n_mb]).max())
                             for i, g in enumerate(got)
                             if g.shape == want[i % n_mb].shape),
                            default=None))
        del exact
        # the profile's sublayer times against the kernels' own, and one
        # profiled pass of the scheduled stages in this process
        res["sublayers"] = sublayer_times(SCHED_MODEL, weights[SCHED_MODEL],
                                          device)
        pipe = build_pipeline(SCHED_MODEL, [lr for _, lr in stages],
                              model_file=str(weights[SCHED_MODEL]),
                              device=device)
        profile_pass(lambda: pipe.run(inputs),
                     f"{SCHED_MODEL}, {len(stages)} scheduled stages")
        del pipe

        if profiles_out is not None:
            profiles_out.mkdir(parents=True, exist_ok=True)
            header = (f"# {card} (nvidia-smi name, power.limit); "
                      f"chip_smoke.py phase 10\n")
            for path in files.values():
                (profiles_out / path.name).write_text(header +
                                                      path.read_text())
            log(f"profiles written to {profiles_out}")

    res["baseline"] = {}
    for name, argv in (("config 1", ["0", "1"]),
                       ("config 2", ["0", "2", "-pt", BASELINE_PARTITION])):
        e = run_entry(argv + ["-m", MODEL, "-M", str(weights[MODEL]),
                              "-b", str(BATCH), "-u", str(UBATCH),
                              "--device", device], {},
                      weights_dir / "monitor")
        blocks = registry.get_model_config(MODEL).num_hidden_layers
        e["expected"] = {"fused_attention": blocks * n_mb,
                         "fused_encode": 0, "fused_decode": 0}
        res["baseline"][name] = e
    return res


def check_sched_path(res, device_name: str) -> None:
    for key, prof in res["profiles"].items():
        log(f"profile {key}: " + json.dumps({**prof, "card": device_name}))
    entry = res["entry"]
    check_entry("vit-large scheduled", entry)
    if entry["logged_layers"] != [lr for _, lr in res["schedule"]] or \
            entry["logged_hosts"] != [h for h, _ in res["schedule"]]:
        raise AssertionError(f"the runtime ran {entry['logged_layers']} on "
                             f"{entry['logged_hosts']}, the scheduler chose "
                             f"{res['schedule']}")
    saved = res["saved"]
    log("vit-large scheduled results: " + json.dumps(saved))
    if not (saved["equal"] and saved["finite"]):
        raise AssertionError("vit-large scheduled: the saved logits differ "
                             "from the single-shard forward: "
                             + json.dumps(saved))
    log("vit-large schedule: " + json.dumps({
        "schedule": res["schedule"], "stage_ms": [t * 1e3 for t in
                                                  res["stage_s"]],
        "mem_mib": res["mem_mib"], "bw_mbps": res["bw_mbps"],
        "card": device_name}))
    # the three rates side by side (PERF.md says which the run follows)
    log("vit-large sublayers 5-8, ms per forward: " + json.dumps(
        {**res["sublayers"], "card": device_name}))
    log("vit-large items/s: " + json.dumps({
        "scheduler_predicted": res["predicted_items_per_s"],
        "one_card_predicted": res["one_card_items_per_s"],
        "measured_steady": entry["steady_items_per_s"],
        "card": device_name}))
    for name, e in res["baseline"].items():
        check_entry(f"baseline {name}", e)


# --- phase 11: GPT-2 serving through the port's HTTP server ----------------

def serve_requests(rng, vocab: int, kinds) -> list:
    """One request per kind, drawn from `rng`: "plain", "stream",
    "prefix" (the prompt is the suffix after the registered prefix),
    "eos" (its eos token is chosen from its solo run, `serve_oracle`) and
    "batched" (SERVE_BATCHED)."""
    reqs = []
    for kind in kinds:
        if kind == "batched":
            rows, length, new = SERVE_BATCHED
        else:
            rows = 1
            length = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
            new = int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))
        ids = rng.integers(0, vocab, size=(rows, length)).tolist()
        reqs.append({"kind": kind, "ids": ids, "new": new, "eos": None})
    return reqs


def mask_after_eos(ids: np.ndarray, prompt_len: int, eos: int) -> np.ndarray:
    """A solo run [B, S + T] as the executors return an eos request: cut
    after the step where every row has emitted `eos` (at most T), and
    every token after a row's first eos set to `eos` (the pad)."""
    toks = ids[:, prompt_len:]
    hit = toks == eos
    first = np.where(hit.any(1), hit.argmax(1), toks.shape[1])
    stop = int(first.max()) + 1 if hit.any(1).all() else toks.shape[1]
    toks = toks[:, :stop].copy()
    for r, f in enumerate(first):
        toks[r, f + 1:] = eos
    return np.concatenate([ids[:, :prompt_len], toks], axis=1)


def serve_oracle(pipe, reqs, prefix_ids) -> dict:
    """Each request solo through `pipe.generate` (the prefix handle from
    `pipe.precompute_prefix` where the request uses one); an "eos"
    request gets as its eos token the token its solo run emits halfway,
    and the solo run masked as the executors return it. rid -> [B, S+T]."""
    handle = pipe.precompute_prefix(np.asarray([prefix_ids]))
    want = {}
    for i, r in enumerate(reqs):
        ids = torch.as_tensor(r["ids"], device=pipe.device)
        solo = pipe.generate(ids, r["new"], prefix=(
            handle if r["kind"] == "prefix" else None)).cpu().numpy()
        if r["kind"] == "eos":
            s = ids.shape[1]
            r["eos"] = int(solo[0, s + r["new"] // 2])
            solo = mask_after_eos(solo, s, r["eos"])
        want[i] = solo
    torch.cuda.synchronize()
    return want


def http_json(port: int, path: str, obj=None, timeout: float = 600):
    import urllib.request
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
    return body if path == "/metrics" else json.loads(body)


def serve_metric(text: str, family: str, **labels) -> float:
    """One series of a /metrics body (0 when absent)."""
    from pipeedge_tpu_torch.telemetry.collector import parse_prom_text
    return sum(v for lab, v in parse_prom_text(text, [family]).get(
        family, []) if all(lab.get(k) == w for k, w in labels.items()))


def serve_client(port: int, rid: int, r: dict, pid: str, start, out: dict):
    """One client: waits on `start`, sends its /generate, records the
    result, the client-side latency and (streamed) the step lines."""
    import urllib.request
    body = {"ids": r["ids"], "new_tokens": r["new"]}
    if r["kind"] == "prefix":
        body["prefix_id"] = pid
    if r["eos"] is not None:
        body["eos_token"] = r["eos"]
    if r["kind"] == "stream":
        body["stream"] = True
    start.wait()
    t0 = time.monotonic()
    try:
        if r["kind"] == "stream":
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=900) as resp:
                lines = [json.loads(ln) for ln in resp.read().decode()
                         .splitlines() if ln.strip()]
            final = lines[-1]
            out[rid] = dict(ids=final["ids"], steps=[ln["tokens"] for ln in
                                                     lines[:-1]],
                            first_token_ms=final["first_token_ms"])
        else:
            out[rid] = dict(ids=http_json(port, "/generate", body,
                                          timeout=900)["ids"])
    except Exception as exc:   # noqa: BLE001 — the check reports it
        out[rid] = dict(error=repr(exc))
    out[rid].update(t0=t0, t1=time.monotonic())


def serve_run(pipe, args, reqs, want, prefix_ids, label: str,
              first=None, draft=None, prompt_singles: int = 0) -> dict:
    """Serve `reqs` concurrently through the port's HTTP front end over
    `pipe` (flags `args`; `draft`, the draft pipeline with
    `--draft-model`), the launch counts set to 0 just before the clients
    start and read just after the last one returns. Request `first`, when
    given, is served alone to completion before the others start (a
    prefix publisher). On a paged server the trie's and the pool's
    numbers are read after the traffic, then every cold prefix page is
    evicted and the pool read again. `prompt_singles` counts the prompt
    chunks and spans of one token in the traffic: an int8 step of one
    token attends through kernel 5 whatever its kind."""
    import threading
    from pipeedge_tpu_torch import serve, telemetry
    from pipeedge_tpu_torch.ops import _build

    telemetry.configure(rank=0)
    service = serve.make_service(args, pipe, draft=draft)
    httpd = serve.Server(("127.0.0.1", 0),
                         serve.make_handler(service, args.model_name))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        pid = http_json(port, "/prefix", {"ids": prefix_ids})["prefix_id"]
        before = http_json(port, "/metrics")
        # the trie's counters live in the process's registry, which an
        # earlier server in this process moved too: read them as deltas
        kv_before = http_json(port, "/healthz")["serving"].get("kv")
        out: dict = {}
        start = threading.Event()
        clients = [threading.Thread(target=serve_client,
                                    args=(port, i, r, pid, start, out))
                   for i, r in enumerate(reqs) if i != first]
        for c in clients:
            c.start()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        if first is not None:
            alone = threading.Event()
            alone.set()
            serve_client(port, first, reqs[first], pid, alone, out)
        start.set()
        for c in clients:
            c.join()
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        after = http_json(port, "/metrics")
        health = http_json(port, "/healthz")
        ex = service.exec if service.exec is not None else service.batcher
        kind_steps = [dict(k) for k in ex.kind_steps]
        kv = None
        if service.kv_backend is not None:
            kv = dict(after_traffic=health["serving"]["kv"],
                      trie_hits=health["serving"]["kv"]["prefix"]["hits"]
                      - kv_before["prefix"]["hits"],
                      evicted=service.kv_backend.evict_cold_all())
            kv["pool"] = service.kv_backend.pool.stats()
            kv["metrics_pages"] = {
                state: serve_metric(http_json(port, "/metrics"),
                                    "pipeedge_kv_pages", state=state)
                for state in ("total", "free")}
            if service.spec is not None:
                kv["draft_pool"] = service.spec.draft_pool.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
    wall = max(o["t1"] for o in out.values()) - min(
        o["t0"] for o in out.values())
    served = {i: np.asarray(o["ids"]) for i, o in out.items()
              if "ids" in o}
    tokens = sum(served[i].shape[0] * (served[i].shape[1]
                                       - len(r["ids"][0]))
                 for i, r in enumerate(reqs) if i in served)
    lat_ms = [(o["t1"] - o["t0"]) * 1e3 for o in out.values()]
    first_ms = [o["first_token_ms"] for o in out.values()
                if o.get("first_token_ms") is not None]
    blocks = [st["n_blocks"] for st in pipe.stages]
    delta = {fam: serve_metric(after, fam, **lab) - serve_metric(
        before, fam, **lab) for fam, lab in (
        ("pipeedge_serve_tokens_total", {}),
        ("pipeedge_serve_requests_total",
         {"endpoint": "/generate", "status": "200"}))}
    res = dict(
        label=label, executor=args.executor, kv_bits=args.kv_bits,
        requests=len(reqs), errors={i: o["error"] for i, o in out.items()
                                    if "error" in o},
        mismatched=sorted(i for i in range(len(reqs))
                          if i not in served
                          or not np.array_equal(served[i], want[i])),
        stream_steps_equal=all(
            np.array_equal(np.asarray(out[i]["steps"]).T,
                           np.asarray(out[i]["ids"])[:, len(r["ids"][0]):])
            for i, r in enumerate(reqs)
            if r["kind"] == "stream" and "ids" in out[i]),
        counts=counts, kind_steps=kind_steps,
        expected_decode_attention=(
            sum(b * k["step"] for b, k in zip(blocks, kind_steps))
            + sum(blocks) * prompt_singles if args.kv_bits else 0),
        prompt_singles=prompt_singles,
        decode_waves=kind_steps[-1]["step"],
        traffic_decode_waves=sum(
            served[i].shape[1] - len(r["ids"][0]) - 1
            for i, r in enumerate(reqs) if i in served),
        blocks=sum(blocks),
        metrics_delta=delta,
        expected_tokens_total=sum(len(r["ids"]) * r["new"] for r in reqs),
        healthz=dict(ok=health["ok"], executor=health["executor"],
                     stats_keys=sorted(health["stats"])),
        kv=kv, ticks=ex.stats.get("ticks"),
        wall_s=wall, tokens=tokens, tok_per_s=tokens / wall,
        latency_ms_p50=float(np.percentile(lat_ms, 50)),
        latency_ms_p95=float(np.percentile(lat_ms, 95)),
        first_token_ms_p50=(float(np.percentile(first_ms, 50))
                            if first_ms else None),
        first_token_ms_p95=(float(np.percentile(first_ms, 95))
                            if first_ms else None))
    if args.executor == "stage":
        res["healthz"]["workers"] = {k: health["stats"][k] for k in (
            "stage_steps", "busy", "queued")}
    return res


def dispatch_threads() -> dict:
    """Host cost of launching ops from one thread against two at once:
    2 x SERVE_DISPATCH_OPS one-element in-place adds on the card from one
    thread, and SERVE_DISPATCH_OPS from each of two threads started
    together (each on its own tensor, under inference mode as the
    executors run), in the order one, two, two, one; synchronized before
    each clock read. Two threads that dispatch no faster than one show
    that PyTorch's dispatch, not the card, bounds the stage workers."""
    import threading
    xs = [torch.zeros(1, device="cuda") for _ in range(2)]

    def launch(x, n):
        with torch.inference_mode():
            for _ in range(n):
                x.add_(1.0)

    n_ops = SERVE_DISPATCH_OPS

    def one():
        launch(xs[0], 2 * n_ops)

    def two():
        threads = [threading.Thread(target=launch, args=(x, n_ops))
                   for x in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    launch(xs[0], 1000)                        # warm-up
    times = {"one": [], "two": []}
    for name, fn in (("one", one), ("two", two), ("two", two),
                     ("one", one)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times[name].append((time.monotonic() - t0) * 1e6 / (2 * n_ops))
    res = {f"{k}_thread_us_per_op": v for k, v in times.items()}
    res["two_over_one"] = sum(times["two"]) / sum(times["one"])
    return res


def serve_entry(flags, req: dict, want: np.ndarray) -> dict:
    """`python -m pipeedge_tpu_torch.serve` as a subprocess: its
    readiness line, one /generate (held to `want`), /healthz, then
    SIGTERM and its exit code. The process is killed if anything fails."""
    import queue
    import signal
    import socket
    import threading
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.serve", *flags,
           "--port", str(port)]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in
                                              proc.stdout], daemon=True)
    reader.start()
    log_lines = []
    try:
        deadline = time.monotonic() + 300
        while True:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            log_lines.append(line.rstrip())
            if line.startswith("serving "):
                break
        ready_s = time.monotonic() - t0
        got = np.asarray(http_json(port, "/generate", {
            "ids": req["ids"], "new_tokens": req["new"]})["ids"])
        health = http_json(port, "/healthz")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        log_lines.append(lines.get().rstrip())
    return dict(command=" ".join(cmd[1:]), ready_s=ready_s, rc=rc,
                equal=bool(np.array_equal(got, want)),
                healthz_ok=health["ok"], executor=health["executor"],
                output=log_lines[-5:], seconds=time.monotonic() - t0)


def serve_path(card: str,
               weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build"
               ) -> dict:
    """Phase 11 (module docstring): the served runs, their oracle, one
    profiled pass of wave ticks and the entry. `check_serve_path` gates
    the result."""
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import gpt2, registry
    from pipeedge_tpu_torch.parallel import batcher

    cfg = registry.get_model_config(DECODE_MODEL)
    weights_file = (weights_dir
                    / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz")
    if not weights_file.exists():          # phase 6 writes it
        weights_dir.mkdir(parents=True, exist_ok=True)
        np.savez(weights_file, **gpt2.random_npz_weights(cfg, seed=0))
    pm_dir = weights_dir / "postmortems"
    flags = {bits: SERVE_FLAGS + ["-M", str(weights_file), "--kv-bits",
                                  str(bits), "--postmortem-dir", str(pm_dir)]
             for bits in (8, 0)}
    rng = np.random.default_rng(11)
    prefix_ids = rng.integers(0, cfg.vocab_size,
                              size=SERVE_PREFIX_LEN).tolist()
    traffic = {8: serve_requests(rng, cfg.vocab_size, SERVE_KINDS),
               0: serve_requests(rng, cfg.vocab_size, SERVE_FP_KINDS)}
    # the served pipelines and the oracle each hold their own copy of the
    # weights, read from the npz as `-M` reads it
    params = {who: [registry.module_shard_factory(
        DECODE_MODEL, str(weights_file), l, r, stage=i, device="cuda")[1]
        for i, (l, r) in enumerate(DECODE_PARTITION)]
        for who in ("server", "oracle")}
    res = {"card": card, "runs": []}
    for bits in (8, 0):
        args = serve.parse_args(flags[bits] + ["--executor", "wave"])
        t0 = time.monotonic()
        want = serve_oracle(serve.build_pipeline(args, params["oracle"]),
                            traffic[bits], prefix_ids)
        res[f"oracle_s_{bits}"] = time.monotonic() - t0
        pipe = serve.build_pipeline(args, params["server"])
        for executor in (("wave", "stage") if bits else ("wave",)):
            args = serve.parse_args(flags[bits] + ["--executor", executor])
            res["runs"].append(serve_run(
                pipe, args, traffic[bits], want, prefix_ids,
                f"{executor}, {'int8' if bits else 'fp'} cache"))
            log("serve run " + json.dumps(res["runs"][-1], sort_keys=True))
        if bits:
            # a few wave ticks of 4 in-flight requests under the profiler
            b = batcher.ContinuousBatcher(pipe, max_active=4)
            for i in range(4):
                b.submit(i, traffic[bits][i + 4]["ids"], SERVE_PROFILE_NEW)
            for _ in range(16):                # prompts in, steps flowing
                b.tick()
            prof = profile_pass(
                lambda: [b.tick() for _ in range(SERVE_PROFILE_TICKS)],
                f"{SERVE_PROFILE_TICKS} wave ticks, 4 requests, int8")
            res["profile"] = dict(
                wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                busy_share=prof["device_busy_share"],
                launches_per_tick=prof["kernel_launches"]
                / SERVE_PROFILE_TICKS)
            entry_req = next(r for r in traffic[bits]
                             if r["kind"] == "plain")
            res["entry"] = serve_entry(
                flags[bits] + ["--executor", "wave"], entry_req,
                want[traffic[bits].index(entry_req)])
            log("serve entry " + json.dumps(res["entry"], sort_keys=True))
            del b
            res["dispatch"] = dispatch_threads()
        del pipe
        torch.cuda.empty_cache()
    return res


def check_serve_path(res, device_name: str, entry: bool = True) -> None:
    for run in res["runs"]:
        name = f"serve ({run['label']})"
        log(f"{name}: " + json.dumps({
            k: run[k] for k in ("tok_per_s", "wall_s", "tokens",
                                "first_token_ms_p50", "first_token_ms_p95",
                                "latency_ms_p50", "latency_ms_p95",
                                "counts")} | {"card": res["card"],
                                              "device": device_name}))
        if run["errors"] or run["mismatched"]:
            raise AssertionError(f"{name}: errors {run['errors']}, results "
                                 f"unequal to their solo runs: "
                                 f"{run['mismatched']}")
        if not run["stream_steps_equal"]:
            raise AssertionError(f"{name}: streamed step lines differ from "
                                 "the final line")
        want = {k: 0 for k in run["counts"]}
        want["decode_attention"] = run["expected_decode_attention"]
        if run["counts"] != want:
            raise AssertionError(f"{name}: launch counts {run['counts']} "
                                 f"!= {want}")
        waves = run["decode_waves"]
        if waves != run["traffic_decode_waves"] or (
                run["kv_bits"] and run["counts"]["decode_attention"]
                != run["blocks"] * (waves + run["prompt_singles"])):
            raise AssertionError(
                f"{name}: {run['counts']['decode_attention']} decode "
                f"attention launches, {waves} decode waves reported, "
                f"{run['traffic_decode_waves']} in the traffic, "
                f"{run['prompt_singles']} one-token prompt chunks, "
                f"{run['blocks']} blocks")
        delta = run["metrics_delta"]
        if delta["pipeedge_serve_tokens_total"] != \
                run["expected_tokens_total"] or \
                delta["pipeedge_serve_requests_total"] != run["requests"]:
            raise AssertionError(f"{name}: /metrics moved by {delta}, "
                                 f"traffic {run['expected_tokens_total']} "
                                 f"tokens, {run['requests']} requests")
        health = run["healthz"]
        if not health["ok"] or health["executor"] != run["executor"] or (
                run["executor"] == "stage"
                and len(health["workers"]["stage_steps"]) != 2):
            raise AssertionError(f"{name}: /healthz {health}")
    if not entry:
        return
    entry = res["entry"]
    if entry["rc"] != 0 or not entry["equal"] or not entry["healthz_ok"]:
        raise AssertionError(f"serve entry: {entry}")
    log("serve profile: " + json.dumps(res["profile"]))
    log("serve dispatch threads: " + json.dumps(res["dispatch"]))


# --- phase 12: the paged KV plane under the serving traffic -----------------

def paged_requests(rng, vocab: int, prefix_ids) -> tuple:
    """Phase 12's traffic (PAGED_* above): phase 11's int8 requests drawn
    from `rng` as phase 11 draws them, less the prefix ones, then the
    publisher, the sharers, the long and the short request. Returns
    (requests, index of the publisher)."""
    reqs = [r for r in serve_requests(rng, vocab, SERVE_KINDS)
            if r["kind"] != "prefix"]
    first = len(reqs)
    reqs.append({"kind": "publish", "ids": [list(prefix_ids)],
                 "new": int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1)),
                 "eos": None})
    for _ in range(PAGED_SHARERS):
        n = int(rng.integers(PAGED_SUFFIX[0], PAGED_SUFFIX[1] + 1))
        reqs.append({"kind": "share", "ids": [list(prefix_ids) + rng.integers(
            0, vocab, size=n).tolist()],
            "new": int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1)),
            "eos": None})
    for kind, (length, new) in (("long", PAGED_LONG),
                                ("short", PAGED_SHORT)):
        reqs.append({"kind": kind, "ids": rng.integers(
            0, vocab, size=(1, length)).tolist(), "new": new, "eos": None})
    return reqs, first


def prompt_singles(reqs, chunk: int, shared: int) -> int:
    """The one-token prompt steps of the traffic: a chunked prompt pass
    whose last chunk is one token, or a one-token pass (sharers run only
    the tokens past the `shared` prefix)."""
    n_single = 0
    for r in reqs:
        n = len(r["ids"][0]) - (shared if r["kind"] == "share" else 0)
        n_single += n == 1 or (n > chunk and n % chunk == 1)
    return n_single


def chunked_oracle(pipe, reqs, chunk: int) -> dict:
    """Each request alone through a dense wave executor that chunks
    prompts as the server does (an int8 cache's chunked prompt pass is
    its own computation: a chunk attends earlier chunks' rows
    dequantized). A sharer's rows [0, 128) are then the publisher's
    chunks and its suffix the last chunk, run as the span at offset 128
    the server runs over the shared pages. An "eos" request takes the
    token its solo run emits halfway, as in `serve_oracle`."""
    from pipeedge_tpu_torch.parallel import batcher
    want = {}
    for i, r in enumerate(reqs):
        b = batcher.ContinuousBatcher(pipe, max_active=1,
                                      chunk_tokens=chunk)
        b.submit(i, np.asarray(r["ids"]), r["new"])
        solo = b.run()[i]
        if r["kind"] == "eos":
            s = len(r["ids"][0])
            r["eos"] = int(solo[0, s + r["new"] // 2])
            solo = mask_after_eos(solo, s, r["eos"])
        want[i] = solo
    torch.cuda.synchronize()
    return want


def tick_profile(pipe, reqs, kv=None) -> dict:
    """`SERVE_PROFILE_TICKS` wave ticks of 4 in-flight int8 requests
    under the profiler, dense or (`kv`) paged, after 16 ticks that bring
    their prompts in: the launches and device time per tick."""
    from pipeedge_tpu_torch.parallel import batcher
    b = batcher.ContinuousBatcher(pipe, max_active=4, kv=kv)
    for i, r in enumerate(reqs):
        b.submit(i, r["ids"], SERVE_PROFILE_NEW)
    for _ in range(16):
        b.tick()
    prof = profile_pass(
        lambda: [b.tick() for _ in range(SERVE_PROFILE_TICKS)],
        f"{SERVE_PROFILE_TICKS} wave ticks, 4 requests, int8"
        + (", paged" if kv is not None else ""))
    return dict(wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                busy_share=prof["device_busy_share"],
                launches_per_tick=prof["kernel_launches"]
                / SERVE_PROFILE_TICKS,
                device_ms_per_tick=prof["device_ms"] / SERVE_PROFILE_TICKS)


def paged_path(card: str,
               weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build"
               ) -> dict:
    """Phase 12 (module docstring): phase 11's int8 server over the paged
    KV plane on the wave and the stage executor, held to solo runs; the
    launches per profiled wave tick, dense and paged."""
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.kv import PagedKvBackend
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.telemetry import metrics as prom

    cfg = registry.get_model_config(DECODE_MODEL)
    weights_file = (weights_dir
                    / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz")
    flags = SERVE_FLAGS + ["-M", str(weights_file), "--kv-bits", "8",
                           "--postmortem-dir",
                           str(weights_dir / "postmortems")]
    rng = np.random.default_rng(11)          # phase 11's draws
    prefix_ids = rng.integers(0, cfg.vocab_size,
                              size=SERVE_PREFIX_LEN).tolist()
    reqs, first = paged_requests(rng, cfg.vocab_size, prefix_ids)
    params = {who: [registry.module_shard_factory(
        DECODE_MODEL, str(weights_file), l, r, stage=i, device="cuda")[1]
        for i, (l, r) in enumerate(DECODE_PARTITION)]
        for who in ("server", "oracle")}
    args = serve.parse_args(flags + ["--executor", "wave"])
    t0 = time.monotonic()
    want = chunked_oracle(serve.build_pipeline(args, params["oracle"]),
                          reqs, PAGED_CHUNK)
    res = {"card": card, "oracle_s": time.monotonic() - t0, "runs": [],
           "kinds": [r["kind"] for r in reqs],
           "prompt_lens": [len(r["ids"][0]) for r in reqs]}
    pipe = serve.build_pipeline(args, params["server"])
    for executor in ("wave", "stage"):
        args = serve.parse_args(flags + PAGED_FLAGS
                                + ["--executor", executor])
        res["runs"].append(serve_run(
            pipe, args, reqs, want, prefix_ids,
            f"{executor}, int8 cache, paged", first=first,
            prompt_singles=prompt_singles(reqs, PAGED_CHUNK,
                                          SERVE_PREFIX_LEN)))
        log("paged run " + json.dumps(res["runs"][-1], sort_keys=True))
    profiled = [r for r in reqs if r["kind"] == "plain"][:4]
    kv = PagedKvBackend(pipe, 1024, 16, registry=prom.Registry())
    res["arena_mb"] = kv.pool.arena_bytes / 1e6
    res["profile"] = {"dense": tick_profile(pipe, profiled),
                      "paged": tick_profile(pipe, profiled, kv=kv)}
    del pipe, kv
    torch.cuda.empty_cache()
    return res


def check_paged_path(res, serve_res, device_name: str) -> None:
    """Phase 12's gates: phase 11's per-run checks, then the trie's hits,
    the pool back to all pages free with nothing leaked, and /metrics'
    free-page gauge at the total."""
    check_serve_path({"runs": res["runs"], "card": res["card"]},
                     device_name, entry=False)
    for run in res["runs"]:
        name = f"paged serve ({run['label']})"
        kv = run["kv"]
        hits = kv["trie_hits"]
        pool = kv["pool"]
        if hits < PAGED_SHARERS:
            raise AssertionError(f"{name}: {hits} trie hits, want >= "
                                 f"{PAGED_SHARERS}: {kv}")
        if pool["pages_free"] != pool["pages_total"] or pool["leaked"] \
                or kv["after_traffic"]["leaked"]:
            raise AssertionError(f"{name}: pool not whole after the "
                                 f"traffic and eviction: {kv}")
        if kv["metrics_pages"]["free"] != kv["metrics_pages"]["total"] \
                or kv["metrics_pages"]["total"] != pool["pages_total"]:
            raise AssertionError(f"{name}: /metrics pipeedge_kv_pages "
                                 f"{kv['metrics_pages']}, pool {pool}")
        log(f"{name}: kv " + json.dumps(kv))
    wave, stage = res["runs"]
    dense_wave = next(r for r in serve_res["runs"]
                      if r["executor"] == "wave" and r["kv_bits"])
    log("paged: " + json.dumps({
        "arena_mb": res["arena_mb"], "oracle_s": res["oracle_s"],
        "stage_over_wave_tok_per_s": stage["tok_per_s"] / wave["tok_per_s"],
        "wave_tok_per_s_paged_over_dense": wave["tok_per_s"]
        / dense_wave["tok_per_s"],
        "launches_per_tick": {k: v["launches_per_tick"]
                              for k, v in res["profile"].items()}
        | {"phase 11": serve_res["profile"]["launches_per_tick"]},
        "profile": res["profile"], "card": res["card"],
        "device": device_name}))


# --- phase 13: speculative decoding -----------------------------------------

def serial_logits(pipe, ids, tokens) -> torch.Tensor:
    """The target's logits [B, T, V] along a given continuation `tokens`
    [B, T]: the prompt's prefill, then one serial decode step per token
    (the computation `generate` runs), logits of step t predicting t."""
    with torch.inference_mode():
        data, caches = pipe._prefill(pipe._ids(ids))
        out = [data[:, -1].float()]
        pos = ids.shape[1]
        for t in range(tokens.shape[1] - 1):
            data = pipe._ids(tokens[:, t:t + 1])
            for i, st in enumerate(pipe.stages):
                data, caches[i] = pipe._decode_step(st, data, caches[i],
                                                    pos + t)
            out.append(data[:, 0].float())
    return torch.stack(out, dim=1)


def span_vs_serial(pipe, ids, tokens, k: int) -> float:
    """max |span logits - serial step logits| over one k-token verify
    span [S, S + k) after the prompt against k serial decode steps over
    the same tokens (the port's counterpart of the JAX package's
    `test_extend_matches_serial_steps`)."""
    pos = ids.shape[1]
    with torch.inference_mode():
        ids_t = pipe._ids(ids)
        _, caches = pipe._prefill(ids_t)
        span, _ = pipe.extend(tokens[:, :k], caches, pos)
        _, caches = pipe._prefill(ids_t)
        serial = []
        for j in range(k):
            data = pipe._ids(tokens[:, j:j + 1])
            for i, st in enumerate(pipe.stages):
                data, caches[i] = pipe._decode_step(st, data, caches[i],
                                                    pos + j)
            serial.append(data[:, 0])
        serial = torch.stack(serial, dim=1)
    return float((span.float() - serial.float()).abs().max())


def spec_rule(got, want, prompt_len: int, serial, span_diff: float) -> dict:
    """The phase-13 check (CHANGES.md): speculative tokens equal the
    target's greedy tokens; a row may differ only where, at its first
    differing step, the speculative token is the serial run's second
    choice and the serial top-2 logit gap is within the measured
    span-vs-serial logit difference (a near-tie the verify GEMM's
    rounding can flip). Later steps of such a row follow another prefix
    and are not compared."""
    rows = []
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b, prompt_len:] != want[b, prompt_len:])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        top2 = torch.topk(serial[b, t], 2)
        gap = float(top2.values[0] - top2.values[1])
        rows.append(dict(row=b, step=t, spec_token=int(got[b, prompt_len + t]),
                         greedy_token=int(want[b, prompt_len + t]),
                         second=int(top2.indices[1]), top2_gap=gap,
                         span_vs_serial=span_diff,
                         near_tie=bool(int(top2.indices[1])
                                       == int(got[b, prompt_len + t])
                                       and gap <= span_diff)))
    return dict(equal=not rows, differing=rows,
                ok=all(r["near_tie"] for r in rows))


class CountedVerify:
    """A target pipeline whose `extend` calls are counted: on a dense
    generation the prompt goes through `_prefill`, so each call is one
    verify round. Everything else is the wrapped pipeline's."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def extend(self, tokens, caches, pos):
        self.calls += 1
        return self.pipe.extend(tokens, caches, pos)


def noisy_draft(target, max_len: int, eps: float, seed: int = 0):
    """`target` (one stage) as its own draft, with seeded noise of
    relative size `eps` on every weight matrix of its last block; every
    other parameter is the target's own tensor."""
    from pipeedge_tpu_torch.parallel.decode import build_decode_pipeline
    gen = torch.Generator(device=target.device)
    gen.manual_seed(seed)
    params = dict(target.stages[0]["params"])
    blocks = list(params["blocks"])
    last = {name: dict(leaf) for name, leaf in blocks[-1].items()}
    for leaf in last.values():
        if "w" in leaf:
            w = leaf["w"]
            leaf["w"] = w + eps * w.std() * torch.randn(
                w.shape, generator=gen, device=w.device, dtype=w.dtype)
    blocks[-1] = last
    params["blocks"] = blocks
    return build_decode_pipeline(SPEC_TARGET, None, max_len=max_len,
                                 stage_params=[params],
                                 device=target.device)


def spec_call(target, d_pipe, sync: str, ids, want, serial,
              span_diff: float) -> dict:
    """One timed speculative generation (after a short warm-up), its
    verify rounds counted at the target's `extend`."""
    from pipeedge_tpu_torch.parallel.speculative import SpeculativeDecoder
    counted = CountedVerify(target)
    spec = SpeculativeDecoder(counted, d_pipe, gamma=SPEC_GAMMA, sync=sync)
    spec.generate(ids[:, :8], 2)                    # warm-up
    counted.calls = 0
    got, secs = timed(lambda: spec.generate(ids, SPEC_NEW))
    return dict(sync=sync, seconds=secs, acceptance=spec.last_acceptance_rate,
                syncs=spec.last_sync_count, rounds=counted.calls,
                rule=spec_rule(got, want, SPEC_PROMPT, serial, span_diff))


def timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    return out, time.monotonic() - t0


def spec_path(card: str,
              weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build"
              ) -> dict:
    """Phase 13 (module docstring): gpt2-medium verifying the drafts of
    gpt2 and of its noisy self, host and device sync timed in pairs,
    then as its own draft, then speculative requests through the paged
    server, then the generate entry."""
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import gpt2, registry
    from pipeedge_tpu_torch.parallel.decode import build_decode_pipeline

    res = {"card": card}
    files = {}
    t0 = time.monotonic()
    for model in (SPEC_TARGET, SPEC_DRAFT):
        files[model] = weights_dir / f"{model}-random-seed0.npz"
        if not files[model].exists():
            weights_dir.mkdir(parents=True, exist_ok=True)
            np.savez(files[model], **gpt2.random_npz_weights(
                registry.get_model_config(model), seed=0))
    res["weights_s"] = time.monotonic() - t0
    max_len = 1024
    target = build_decode_pipeline(SPEC_TARGET, None, max_len=max_len,
                                   model_file=str(files[SPEC_TARGET]),
                                   device="cuda")
    draft = build_decode_pipeline(SPEC_DRAFT, None, max_len=max_len,
                                  model_file=str(files[SPEC_DRAFT]),
                                  device="cuda")
    vocab = target.cfg.vocab_size
    rng = np.random.default_rng(13)
    ids = rng.integers(0, vocab, size=(SPEC_BATCH, SPEC_PROMPT))
    target.generate(ids[:, :8], 2)                  # warm-up
    want, plain_s = timed(lambda: target.generate(ids, SPEC_NEW))
    serial = serial_logits(target, ids, want[:, SPEC_PROMPT:])
    span_diff = span_vs_serial(target, ids, want[:, SPEC_PROMPT:],
                               SPEC_GAMMA + 1)
    tokens = SPEC_BATCH * SPEC_NEW
    res["plain"] = dict(seconds=plain_s, tok_per_s=tokens / plain_s)
    res["span_vs_serial"] = span_diff
    res["runs"] = []
    noisy = noisy_draft(target, max_len, SPEC_NOISE)
    for name, d_pipe in (("gpt2 draft", draft), ("noisy self-draft", noisy)):
        # host and device rounds in pairs, so a drift of the host's
        # speed between calls weighs on both alike
        calls = [spec_call(target, d_pipe, sync, ids, want, serial,
                           span_diff)
                 for _ in range(SPEC_PAIRS)
                 for sync in ("host", "device", "device", "host")]
        for sync in ("host", "device"):
            mine = [c for c in calls if c["sync"] == sync]
            secs = [c["seconds"] for c in mine]
            res["runs"].append(dict(
                draft=name, sync=sync, seconds=secs,
                tok_per_s=tokens / float(np.median(secs)),
                speedup=plain_s / float(np.median(secs)),
                calls=[{k: c[k] for k in ("acceptance", "syncs", "rounds",
                                          "rule")} for c in mine]))
            log("spec run " + json.dumps(res["runs"][-1]))
        host, device = res["runs"][-2:]
        # > 1: device rounds take less time than host rounds
        device["device_over_host"] = float(
            np.median(host["seconds"]) / np.median(device["seconds"]))
    del noisy
    self_draft = spec_call(target, target, "device", ids, want, serial,
                           span_diff)
    res["runs"].append(dict(
        draft="self-draft", sync="device", seconds=[self_draft["seconds"]],
        tok_per_s=tokens / self_draft["seconds"],
        speedup=plain_s / self_draft["seconds"],
        calls=[{k: self_draft[k] for k in ("acceptance", "syncs", "rounds",
                                           "rule")}]))
    log("spec run " + json.dumps(res["runs"][-1]))
    del serial
    # the speculative requests through the paged server (fp cache)
    flags = ["-m", SPEC_TARGET, "-M", str(files[SPEC_TARGET]),
             "--max-len", str(max_len), "-t", "float32",
             "--draft-model", SPEC_DRAFT, "--gamma", str(SPEC_GAMMA),
             "--kv-pages", "1024", "--kv-page-size", "16",
             "--brownout-p95-high", "600", "--brownout-p95-low", "300",
             "--postmortem-dir", str(weights_dir / "postmortems")]
    args = serve.parse_args(flags)
    reqs = [{"ids": rng.integers(0, vocab, size=(1, SPEC_PROMPT)).tolist(),
             "new": SPEC_SERVE_NEW} for _ in range(SPEC_SERVE)]
    served = spec_serve(args, target, draft, reqs)
    served["equal"] = [bool(np.array_equal(
        got, target.generate(np.asarray(r["ids"]),
                             r["new"]).cpu().numpy()))
        for got, r in zip(served.pop("results"), reqs)]
    res["serve"] = served
    log("spec serve " + json.dumps(served))
    del target, draft
    torch.cuda.empty_cache()
    res["entry"] = generate_entry(
        ["-m", SPEC_TARGET, "-M", str(files[SPEC_TARGET]), "--draft-model",
         SPEC_DRAFT, "--gamma", str(SPEC_GAMMA)])
    log("spec entry " + json.dumps(res["entry"]))
    return res


def spec_serve(args, target, draft, reqs) -> dict:
    """`reqs` as concurrent `"speculative": true` requests through the
    in-process server over `target` and `draft`; the results, /metrics'
    speculative counter, and both pools after the traffic."""
    import threading
    from pipeedge_tpu_torch import serve, telemetry
    telemetry.configure(rank=0)
    service = serve.make_service(args, target, draft=draft)
    httpd = serve.Server(("127.0.0.1", 0),
                         serve.make_handler(service, args.model_name))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    out = {}

    def client(i, r):
        out[i] = http_json(port, "/generate", {
            "ids": r["ids"], "new_tokens": r["new"], "speculative": True},
            timeout=900)["ids"]

    try:
        t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(i, r))
                   for i, r in enumerate(reqs)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.monotonic() - t0
        health = http_json(port, "/healthz")
        ok = serve_metric(http_json(port, "/metrics"),
                          "pipeedge_serve_requests_total",
                          endpoint="/generate-speculative", status="200")
        pools = {"target": service.kv_backend.pool.stats(),
                 "draft": service.spec.draft_pool.stats()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
    return dict(results=[np.asarray(out.get(i)) for i in range(len(reqs))],
                wall_s=wall, tok_per_s=sum(r["new"] for r in reqs) / wall,
                healthz_speculative=health["speculative"],
                requests_200=ok, pools=pools)


def generate_entry(argv) -> dict:
    """`python -m pipeedge_tpu_torch.generate ARGV` as a subprocess: its
    exit code and report lines."""
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.generate"] + argv
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    return dict(command=" ".join(cmd[1:]), rc=proc.returncode,
                seconds=time.monotonic() - t0,
                report=[ln for ln in proc.stdout.splitlines()
                        if ln.startswith(("generated", "kernel_launches"))],
                stderr=proc.stderr[-2000:] if proc.returncode else "")


def check_spec_path(res, device_name: str) -> None:
    """Phase 13's gates: every speculative generation by the rule of
    `spec_rule`, the self-draft's acceptance 1.0 and its tokens equal,
    the served requests equal to plain greedy with both pools whole, and
    the entry's exit code 0."""
    for run in res["runs"]:
        name = f"spec ({run['draft']}, {run['sync']} sync)"
        per_round = 2 if run["sync"] == "device" else SPEC_GAMMA + 1
        for call in run["calls"]:
            if not call["rule"]["ok"]:
                raise AssertionError(f"{name}: tokens differ from greedy "
                                     f"beyond a near-tie: {call['rule']}")
            rounds, acc = call["rounds"], call["acceptance"]
            if call["syncs"] != 1 + per_round * rounds:
                raise AssertionError(f"{name}: {call['syncs']} readbacks "
                                     f"in {rounds} verify rounds")
            # each round emits its accepted drafts and one target token
            # after the first token: SPEC_NEW - 1 more, the last round
            # overshooting by at most gamma
            emitted = rounds + round(acc * SPEC_GAMMA * rounds)
            if not SPEC_NEW - 1 <= emitted < SPEC_NEW + SPEC_GAMMA:
                raise AssertionError(f"{name}: {rounds} rounds at "
                                     f"acceptance {acc} emit {emitted}")
        if any(c != run["calls"][0] for c in run["calls"]):
            raise AssertionError(f"{name}: repeats differ: {run['calls']}")
    gpt2_host, gpt2_device, noisy_host, noisy_device, self_draft = \
        res["runs"]
    for host, device in ((gpt2_host, gpt2_device),
                         (noisy_host, noisy_device)):
        if host["calls"][0] != device["calls"][0] | {
                "syncs": host["calls"][0]["syncs"]}:
            raise AssertionError(f"host and device sync differ: {host}, "
                                 f"{device}")
    if not 0.0 < noisy_host["calls"][0]["acceptance"] < 1.0:
        raise AssertionError(f"noisy self-draft: acceptance not partial: "
                             f"{noisy_host}")
    call = self_draft["calls"][0]
    if call["acceptance"] != 1.0 or not call["rule"]["equal"]:
        raise AssertionError(f"self-draft: {self_draft}")
    served = res["serve"]
    pools = served["pools"]
    if not all(served["equal"]) or served["requests_200"] != SPEC_SERVE \
            or not served["healthz_speculative"] or any(
                p["pages_free"] != p["pages_total"] or p["leaked"]
                for p in pools.values()):
        raise AssertionError(f"speculative serving: {served}")
    if res["entry"]["rc"] != 0:
        raise AssertionError(f"generate entry: {res['entry']}")
    log("spec: " + json.dumps({k: res[k] for k in (
        "plain", "span_vs_serial", "weights_s")} | {
        "runs": [{k: r[k] for k in ("draft", "sync", "tok_per_s",
                                    "speedup", "seconds")}
                 | {"acceptance": r["calls"][0]["acceptance"],
                    "syncs_per_round": (r["calls"][0]["syncs"] - 1)
                    / r["calls"][0]["rounds"]}
                 | ({"device_over_host": r["device_over_host"]}
                    if "device_over_host" in r else {})
                 for r in res["runs"]],
        "serve_tok_per_s": served["tok_per_s"],
        "card": res["card"], "device": device_name}))


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ab-parent", type=Path, default=None,
                        help="a csrc/ directory of another version to time "
                             "against this one (phase 3)")
    parser.add_argument("--ab-entry-parent", type=Path, default=None,
                        help="the root of another checkout whose ViT "
                             "runtime entry to time against this one's "
                             "(after phase 10)")
    parser.add_argument("--profiles-out", type=Path, default=None,
                        help="also write phase 10's profiles and scheduler "
                             "files into this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from pipeedge_tpu_torch.ops import _build

    started = time.monotonic()
    mark = [started]

    def phase_done(name: str) -> None:
        now = time.monotonic()
        log(f"{name}: {now - mark[0]:.1f} s (total {now - started:.1f} s)")
        mark[0] = now

    # phase 1: card and toolchain
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 2: build
    t0 = time.monotonic()
    _build.library()
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc "
        f"{_build.build_seconds:.1f} s)")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("ptxas " + line.strip())

    phase_done("phases 1-2")

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    codec_rows = check_codec(dev, gen)
    for (name, bit), row in codec_rows.items():
        log(f"{name} " + json.dumps(row))
    attn_rows = check_attention(dev, gen)
    policy_rows = check_policy_bits(dev, gen)
    int8_rows = check_int8_matmul(dev, gen)
    dec_rows = check_decode_attention(dev, gen)
    ab_rows = (ab_parent(args.ab_parent, dev, gen)
               if args.ab_parent is not None else [])

    phase_done("phase 3")

    # phases 4 and 5: the main path, exact and with int8 compute
    results = main_path("cuda", profile=True)
    check_main_path(results, device_name)

    phase_done("phases 4-5")

    # phase 6: the decode main path (GPT-2, int8 KV cache)
    dec = decode_main_path("cuda", profile=True)
    check_decode_path(dec, device_name)

    phase_done("phase 6")

    # phase 7: the tiny GPT-2 (head dim 8) through both int8 routes
    tiny = tiny_decode_path("cuda")
    check_tiny_decode(tiny, device_name)

    phase_done("phase 7")

    # phase 8: DeiT-Base in 8 stages, fixed and adaptive edges
    deit_res = deit_path("cuda", profile=True)
    check_deit_path(deit_res, device_name)

    phase_done("phase 8")

    # phase 9: BERT-Base CoLA through the runtime entry, and the tiny BERT
    bert_res = bert_path("cuda", profile=True)
    check_bert_path(bert_res, device_name)

    phase_done("phase 9")

    # phase 10: the profiler -> scheduler -> runtime loop on ViT-Large
    _build.reset_launch_counts()
    sched_res = sched_path(card, profiles_out=args.profiles_out)
    check_sched_path(sched_res, device_name)

    phase_done("phase 10")

    # phase 11: GPT-2 serving through the port's HTTP server
    serve_res = serve_path(card)
    check_serve_path(serve_res, device_name)

    phase_done("phase 11")

    # phase 12: the paged KV plane under phase 11's server
    paged_res = paged_path(card)
    check_paged_path(paged_res, serve_res, device_name)

    phase_done("phase 12")

    # phase 13: speculative decoding, in process, served and the entry
    spec_res = spec_path(card)
    check_spec_path(spec_res, device_name)

    phase_done("phase 13")

    if args.ab_entry_parent is not None:
        ab_entry(args.ab_entry_parent)
        phase_done("ab entry")

    def paired(prefix):
        """The A/B rows of one kernel: case -> parent mean over this one's."""
        return {r["case"]: r["speedup"] for r in ab_rows
                if r["case"].startswith(prefix)} or None

    main_attn = next(r for r in attn_rows if r["layout"] == "bshd"
                     and r["dtype"] == "float32")
    kernels = []
    # one row per codec kernel and bit width, each with the launches of
    # the main path's run at that edge width
    for name in ("fused_encode", "fused_decode"):
        for bit in (8, 4):
            row = codec_rows[(name, bit)]
            kernels.append(dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name],
                launches=results[bit]["counts"][name],
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None,
                shape=row["shape"], bit=bit,
                device_kernels=row["device_kernels"],
                paired=paired(f"{name} [{UBATCH},197,768] bit {bit}"),
                **({"cluster": row["cluster"],
                    "cluster16_ms": row["cluster16_ms"]}
                   if name == "fused_encode" else {}),
                **({"bit4_ms": codec_rows[(name, 4)]["ms"]}
                   if bit == 8 else {}),
                # launches per pass of 8 microbatches on phase 8 (7 edges)
                deit_launches=deit_res["fixed"][bit]["counts"][name],
                # every policy bitwidth on phase 8's edge
                policy_bits_ms={r["bit"]: r[f"{name[6:]}_ms"]
                                for r in policy_rows
                                if r["shape"] == [UBATCH, 198, 768]}))
    kernels.append(dict(
        name="fused_attention", route="cuda",
        source=SOURCES["fused_attention"],
        replaces=REPLACES["fused_attention"],
        launches=results[8]["counts"]["fused_attention"],
        max_abs_err=main_attn["max_abs_err"], ms=main_attn["ms"],
        plain_ms=main_attn["plain_ms"], bound_ms=main_attn["bound_ms"],
        bound_by=main_attn["bound_by"], library_ms=main_attn["library_ms"],
        shape=main_attn["shape"], dtype=main_attn["dtype"],
        paired=paired("attention"),
        # launches per pass of 8 microbatches on phases 8 and 9
        deit_launches=deit_res["fixed"][8]["counts"]["fused_attention"],
        bert_launches=bert_res["fixed"][8]["counts"]["fused_attention"],
        # phase 10: the scheduled ViT-Large entry (all rounds), and the
        # profiler's runs of ViT-Base and ViT-Large
        vitl_scheduled_launches=sched_res["entry"]["kernel_launches"][
            "fused_attention"],
        profiler_launches={key: p["attention_launches"]
                           for key, p in sched_res["profiles"].items()},
        cases={f"{r['layout']} {r['shape']} {r['dtype']}"
               f"{' causal' if r['causal'] else ''}": {
                   key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "max_abs_err")}
               for r in attn_rows}))
    # the int8 path's own main path is run (c): every int8 launch of it
    timed = [r for r in int8_rows if "ms" in r]
    qkv = timed[0]
    kernels.append(dict(
        name="int8_matmul", route="cuda", source=SOURCES["int8_matmul"],
        replaces=REPLACES["int8_matmul"],
        launches=results["c"]["counts"]["int8_matmul"],
        max_abs_err=max(r["max_abs_err"] for r in int8_rows),
        ms=qkv["ms"], plain_ms=qkv["plain_ms"], bound_ms=qkv["bound_ms"],
        bound_by=qkv["bound_by"], library_ms=None, shape=qkv["shape"],
        kernel=qkv["kernel"], paired=paired("int8_matmul"),
        cases={r["case"]: dict(ms=r["ms"], plain_ms=r["plain_ms"],
                               bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"], kernel=r["kernel"])
               for r in timed}))
    # a bucket-256 decode step of the main path; its launches are run (ii)'s
    timed = {r["case"]: r for r in dec_rows if "ms" in r}
    step = timed["main_w256"]
    kernels.append(dict(
        name="decode_attention", route="cuda",
        source=SOURCES["decode_attention"],
        replaces=REPLACES["decode_attention"],
        launches=dec["ii"]["counts"]["decode_attention"],
        max_abs_err=max(r["max_abs_err"] for r in dec_rows
                        if r["dtype"] == "float32"),
        ms=step["ms"], plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
        bound_by=step["bound_by"], library_ms=None, shape=step["shape"],
        pos=step["pos"], ms_l2_cold=step["ms_l2_cold"],
        dequant_route_ms=step["dequant_route_ms"],
        dequant_route_ms_l2_cold=step["dequant_route_ms_l2_cold"],
        sdpa_dequantized_ms=step["sdpa_dequantized_ms"],
        paired=paired("decode_attention"),
        tiny_decoder_launches=tiny["ii"]["counts"]["decode_attention"],
        # phase 11: the served traffic of each int8 run
        serve_launches={run["executor"]: run["counts"]["decode_attention"]
                        for run in serve_res["runs"] if run["kv_bits"]},
        # phase 12: the same server over the paged KV plane
        paged_serve_launches={run["executor"]: run["counts"][
            "decode_attention"] for run in paged_res["runs"]},
        paged_decode_waves={run["executor"]: run["decode_waves"]
                            for run in paged_res["runs"]},
        cases={name: {k: r[k] for k in (
            "shape", "pos", "dtype", "ms", "ms_l2_cold", "plain_ms",
            "bound_ms", "bound_by", "dequant_route_ms",
            "dequant_route_ms_l2_cold", "sdpa_dequantized_ms",
            "max_abs_err") if k in r} for name, r in timed.items()}))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
