#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`pipeedge_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--ab-parent DIR] [--ab-entry-parent ROOT]
                          [--profiles-out DIR]
    python3 chip_smoke.py --spmd-memory [ROOT]
    python3 chip_smoke.py --mh-rates [ROOT]

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
       ([6, 151296], [6, 37]), more items than a grid axis takes
       ([65537, 37]) and phase 14's Llama edge [8, 128, 4096]: words
       bit-identical, scale, shift and decoded
       values too (NaN counted equal to NaN); one device kernel per
       encode and per decode call; the encode also timed at the other
       cluster size (16 blocks per item);
     - attention at [96, 197, 64] f32, [128, 257, 80] f32 (ViT-H), causal
       [8, 1024, 64] f32, [96, 197, 64] bf16, S = 1, S = 65 (one row past
       a tile), causal [96, 197, 64] f32, the main path's strided
       [8, 197, 12, 64] in bf16 and f32, and the strided shapes of phases
       8 and 9: DeiT-B [8, 198, 12, 64], DeiT-S [8, 198, 6, 64], BERT-B
       [8, 64, 12, 64] f32 and the tiny BERT's head dim 8 [8, 64, 4, 8]
       in f32 and bf16, phase 10's ViT-L [8, 197, 16, 64] f32, and phase
       14's causal head dim 128 (Llama-3-8B [8, 128, 32, 128] f32 and
       bf16, the decode checks' forwards [4, 640, 32, 128] f32 and bf16,
       [4, 512, 32, 128] f32, Mistral-7B [1, 4096, 32, 128] f32 and
       bf16) and the MoE GPT-2's causal [8, 128, 12, 64] f32, and phase
       23's [4, 197, 6, 64], [8, 64, 16, 64] and [4, 64, 8, 64] f32, within
       the tolerances stated below, each timed beside SDPA;
     - kernel 3's backward (`csrc/attention_bwd.cu`) against
       `attention_backward_reference` on the same q, k, v, dO and the
       forward kernel's o and LSE (the LSE itself against
       `attention_lse_reference`), within ATTN_BWD_TOL of max |grad|, at
       ViT-Base [8, 197, 12, 64] f32, GPT-2 causal [2, 1024, 12, 64] f32
       and bf16, a Llama head group causal [1, 512, 32, 128] bf16 and the
       tiny head dim 8 [8, 64, 4, 8] f32, each timed beside the plain
       backward and SDPA's backward (its autograd call's kernels in a
       CUDA graph, on the stream of its forward, as the kernel is timed);
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
     `pipeedge_tpu_torch.generate.main([... --kv-bits 8])` once in this
     process with PIPEEDGE_INT8_DECODE_ATTEND=1;
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
     - the runtime entry once through its `main` in this process, 8
       stages, HEURISTIC;
  9. BERT-Base CoLA (`textattack/bert-base-uncased-CoLA`, BASELINE config
     4) at full width (vocab 30522, 2 labels, 64 int32 token ids per
     item): the runtime entry `0 2 -m ... -pt 1,24,25,48 -q 8,0 -b 64 -u
     8` through its `main` in this process (12 attention launches per
     microbatch, one encode and one decode per microbatch);
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
     host. The runtime entry `0 4 -m google/vit-large-patch16-224 -M
     ... -sm -sdt -sd -H ... -b 64 -u 8 --measure-rounds 2
     --save-results ...`, through its `main` in this process, must
     return, log the
     scheduler's partition and hosts, launch kernel 3 24 times per
     microbatch and save logits equal, bit for bit, to the single-shard
     forward of the same weights on the same inputs. The scheduler's
     predicted items/s (microbatch over the slowest stage's profile
     time), the one-card prediction (over the sum of the stages' times)
     and the measured steady items/s are printed side by side. Then
     BASELINE configs 1 (`0 1`) and 2 (`-pt 1,24,25,48`) of ViT-Base
     through the entry's `main` in this process, each one report line
     and its launches. With `--profiles-out DIR` the
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
     npz, 1.4 GB f32) verifying, gamma 4, f32, [4, 128] prompts, 16 new
     tokens, the drafts of (a) gpt2 (phase 6's npz) and (b) gpt2-medium
     itself with seeded noise on its last block's weight matrices (a
     draft that agrees on some proposals and not on others, so rounds
     accept 0 < a < gamma tokens and roll the draft back), each in host
     and in device sync, timed in pairs (host, device, device, host);
     then (c) gpt2-medium as its own draft. Every generation is
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
 14. The decoder families at full width and depth. Each model's weights
     are drawn on the card from a seeded CUDA generator in the structure
     of its `load_params` (`card_params`; not the JAX package's numpy
     stream, which the CPU tests hold), shared by every pipeline, oracle
     and server of the model, and freed before the next model:
     The Llama-family models run at LLAMA_BLOCKS (4) of their 32 blocks,
     at full width (the script's time):
     (a) Llama-3-8B, f32, `build_pipeline` `-pt 1,8,9,16`,
     16 sequences of 128 tokens in microbatches of 8, edge bits 0, 8 and
     4: bit 0 equal to the single-shard forward, 8 and 4 within the
     stated bounds, 4 kernel-3 launches and one encode and one decode
     per microbatch; one profiled 8-bit microbatch;
     (b) the same weights and cut through `DecodePipeline.generate`,
     batch 4, a 512-token prompt, 64 new tokens, fp and int8 caches (the
     kernel-5 opt-in set: no launch, a Llama step never asks the gate),
     timed; the fp cache's prefill and each step replayed, timed, its
     logits within FAMILY_FP_BOUND of the forward over the same 576
     tokens (4 kernel-3 launches); one profiled decode step; then phase
     24(e), the wave decoder on these weights;
     (c) the in-process server, `--kv-bits 8 --kv-pages 512
     --kv-page-size 16 --chunked-prefill 64`, wave and stage executors:
     8 concurrent clients (2 streamed, 4 plain, 2 sharers of a 128-token
     prefix that a publisher served alone first put in the trie), prompts
     of 64-512 tokens, 8-32 new tokens; each equal to its solo run
     through a dense executor chunking alike, no kernel launched, the
     pool whole afterwards;
     (d) Mistral-7B, f32: one 4090-token prompt and 16 new
     tokens (the steps cross the 4096-token window) on an fp cache, each
     step within FAMILY_FP_BOUND of the forward over the 4106 tokens,
     which takes the masked route (no kernel-3 launch); the forward over
     the first 4096 tokens launches kernel 3 4 times and agrees with it;
     (e) Llama-2-7B (MHA), bf16: generate [4, 512] + 64 on fp
     and int8 caches, timed, no kernel-5 launch;
     (f) `pipeedge/gpt2-moe-8e`, f32: the pipeline `-pt 1,24,25,48` at
     edge bits 0 and 8 (12 kernel-3 launches per microbatch; bit 8 equal
     to the stages' forward with the plain codec at the cut, and the
     tokens before their sequence's first rerouted token within
     LOGIT_BOUND of the exact forward), the expert load of each block,
     generate [16, 192] + 64 on an int8 cache of 1024 rows (phase 6's
     cache) with the kernel-5 opt-in 'auto' (12 launches per decode
     step), then the kernel route and the dequantize route in lockstep
     under one routing (`RoutingPin`), within DECODE_ROUTE_BOUND, and 4
     requests through the in-process server (1024 rows), each equal to
     its solo run;
     (g) `python -m pipeedge_tpu_torch.generate` on the tiny Llama,
     Mistral and MoE (int8 cache), and `python -m
     pipeedge_tpu_torch.runtime` on the tiny Llama at `-pt 1,4,5,8 -q
     8,0`, the four at once (since PR 15, for the script's time), exit
     code 0 each.
     Printed: items/s and tokens/s, step p50 per attend bucket, prefill
     ms, peak memory, the profiles, and a `phase 14 summary` line.
 15. the rest of PipeEdge's loop and the replica router:
     (a) `python -m pipeedge_tpu_torch.revauct` over the committed
     `pipeedge_tpu_torch/profiles/h100/` (ViT-Large, `-u 8`, latency- and
     throughput-ordered, seed 0, side by side; beside phase 14(g),
     neither reading a rate): each schedule covers [1, 96] and
     runs through the runtime entry with raw edges, its saved logits
     equal to the single-shard forward bit for bit (kernel 3 at 24
     launches per microbatch);
     (b) the ViT-Base runtime entry (`-pt 1,21,22,48 -q 8,0 -b 64 -u 8`,
     2 rounds) without `--trace` in this process and with `--trace DIR
     --trace-spans OUT` as a process of its own (no profiler session of
     this script is open there):
     items/s of both, the trace written (a busy profiler fails here) and
     its device events naming kernel 3 and the codec's encode and decode,
     and the spans dump: `stage` x 2 and `results` x 1 per microbatch, no
     `wire`;
     (c) generate on `gpt2` `-pt 1,24,25,48` in process: `--kv-bits 8
     --concurrent 4 -b 4 --prompt-len 192 --new-tokens 72 --max-len
     1024` (kernel-5 opt-in on), every request equal to its solo run and
     kernel 5 at 12 launches per decode wave; `--monitor`'s decode.csv
     with 71 rows; `-sm/-sdt/-sd` over a profile of GPT-2 (48 sublayers,
     f32, batch 4) that the port's profiler makes here, the cut
     block-aligned and printed;
     (d) two `gpt2` replicas as in-process servers (`--role replica`,
     paged fp KV: `--kv-pages 1024 --kv-page-size 16`) behind the router
     entry (`--role router --replica-addrs`): a 256-token prefix
     published alone, then 8 sharers of it registered through the
     router's `/prefix` and 4 plain requests, each equal to its solo run,
     the launches per served request; the router's `/drain` of the
     prefix's replica moves its pages to the survivor, whose next
     sharer spans its suffix on the trie's pages (no prefill), both pools
     whole after; then the survivor's prefix rows through the ship codec
     at 8 bits (kernels 1 and 2), words, scale, shift and values equal to
     the plain codec on the card, timed at that shape;
     (e) the router entry spawning two int8 `gpt2` replicas (`--replicas
     2`, kernel 5): one SIGKILLed in the middle of a burst of 16 streamed
     requests, none lost, each equal to its solo int8 run in this process
     (run while the replica respawns), the dead replica respawned with the
     next epoch and readmitted, the
     router and its replicas gone after SIGTERM; tokens/s and first-token
     and request latency p50/p95 through the router. (d) and (e) also
     fail if the router process holds a GPU device file.
 16. PipeEdge's own transport, one process per rank on the card (`python
     -m pipeedge_tpu_torch.runtime R N -c dcn`, stages' activations over
     framed TCP on loopback, seeded weights at full width):
     (a) ViT-Base, 2 ranks, three rounds on one fleet (`-pt
     "1,21,22,48;1,21,22,48;1,24,25,48" -q "0,0;8,0;4,0" -b 64 -u 8
     --save-results`): round 1 equal to the single-shard forward, rounds
     2 and 3 equal to the host pipeline at their cut and bits with the
     Banner clamp off (the DCN driver encodes without it, as
     `runtime.py`'s does), round 3 also within LOGIT_BOUND[4] of the
     exact forward, rank 1 logging its rebuilt stage [25, 48];
     each rank's launches per round (kernel 1 on rank 0, kernel 2 on rank
     1, one per edge tensor and quantized microbatch; kernel 3 12 per
     microbatch over both ranks); items/s per round beside phase 4's
     host pipeline, each edge's Mbit/s from `send.csv`/`recv.csv`;
     (b) DeiT-Base, 3 ranks (`-pt 1,16,17,32,33,48 -q 8,8,0 --wire-crc`):
     HEURISTIC (WINDOW_SIZE ADAPTIVE_WINDOW) against phase 8's constraint
     (ADAPTIVE_SHARE times edge 0's items/s in process, beyond what a
     socket edge carries): an edge moves off 8 bits, each microbatch's
     bits per edge
     read from the frame bytes the receiving rank's recv hook recorded,
     each result equal to its replay through the host pipeline (clamp
     off) at those bits (REPLAY_BOUND as in phase 8), the codec launches
     per rank equal to the edge-microbatches that travelled at 4 or 8
     bits;
     (c) the colocated tier in this process: two `DistDcnContext`s and
     the runtime's stage pair at 8 bits negotiate `local` on every edge
     and give (a)'s round 2 bit for bit;
     (d) (a)'s fleet at `-q 8,0` with `--heartbeat-interval 0.5
     --heartbeat-miss 3` on a longer batch, rank 1 SIGKILLed 1 s after
     rank 0's first edge frame: the data rank exits non-zero naming rank
     1 within 30 s, and no process of the fleet is left ((d) runs beside
     (b), for the script's time).
     Each sub-run's seconds are printed.
 17. the routed fleet's observatory and capacity loop: the router entry
     with one int8 `gpt2` replica (phase 15e's flags on the paged KV
     plane, `--max-active 4 --no-brownout`) under `--autoscale auto
     --autoscale-min 1 --autoscale-max 2 --fleet-scrape-interval 0.5`
     (AUTOSCALE_FLAGS): (a) 16 closed-loop streamed clients (phase 15e's
     prompt and token draws) queue on r0 until exactly one
     `autoscale_spawn replica=r1 rank=1 epoch=0`, the health polls
     readmit r1, fresh prompts reach it and it answers 4 times;
     `pipeedge_fleet_actual_size` reaches 2; (c) at quiescence, both
     replicas live, `GET /fleet`'s per-class `requests_total` and
     `ok_total` equal the sums over the replicas' own /metrics; (b) the
     load stops: one `autoscale_drain` of r1, its process gone and not
     respawned, the fleet back to 1, the decision counter at up/applied
     1 and down/applied 1 and nothing else, `/fleet`'s totals r0's own
     plus r1's last; the router's span ring through
     `telemetry/report.py` (both applies, no flap) and `python -m
     pipeedge_tpu_torch.trace_report --fleet URL --request RID` on the
     first request, resolved in the router's and r0's rings; every answer
     equal to its solo int8 run in this process (kernel 5), and r1's own
     kernel-5 launches read from its exit line. Printed: seconds from the
     first up-pressure window to the spawn, from the spawn to the
     readmission, the drain's, the router's tokens/s before r1's
     readmission (r0 alone) and after it, migrated prefixes, the phase's
     seconds.
 18. the DCN driver's fault plane, each case through `python -m
     pipeedge_tpu_torch.chaos_dcn` (CHAOS_CASES) on ViT-Base at full
     width (phase 16's weights) at `-pt 1,21,22,48 -q 8,0 -b 64 -u 8`,
     one process and CUDA context per rank, `--on-peer-death failover`:
     (a) 3 ranks, `kill@3` on rank 1: "moves rank 1 -> 2", at least one
     microbatch replayed, the results equal to 16a's round 2 (the
     unfaulted fleet at this cut and bits) bit for bit, the spare's
     kernel 2 and 3 launches one per replayed microbatch (and edge
     tensor, and attention block), rank 0's kernel 1 launches one per
     edge tensor of the 8 to 8 + replayed microbatches it encoded;
     (b) 2 ranks, `kill@2`: the data rank exits non-zero naming rank 1
     and "no spare capacity"; (c) 4 ranks, `restart@3:1000`, a spare
     slower than rank 1 (`--arm 2=delay@1:2000`), `--rounds 3
     --on-peer-rejoin heal`: one `rejoin_rank=1 epoch=1`, a
     `heal_round=` line with `ranks=0,1`, 24 results each equal to the
     unfaulted fleet's, `time_to_full_capacity_s`; (d) 4 ranks,
     `slow@2:400`, `--rounds 4 --on-peer-degraded quarantine`:
     `quarantine_rank=1`, 32 results as in (c). Every case fails if a
     process of its fleet (a restarted incarnation included) outlives
     it; the four run at once, each its own fleet; the launches of each
     rank are the kernels line's `fault_plane_launches`.
 19. the DCN driver's control loop, one process and CUDA context per
     rank: (a) alone, then the other four fleets at once; (a) ViT-Base
     in 2 ranks on the skewed cut `-pt 1,8,9,48 -q 8,0 --rounds 6
     --rebalance auto --rebalance-threshold 0.05 --rebalance-cooldown
     6`: a `rebalance_round=` line, the stage that began with 40
     sublayers holding fewer by the last round, every
     round's logits within LOGIT_BOUND[8] of the single-shard forward,
     each rank's kernel 1-3 launches per round equal to its stage's
     shape, items/s per round; (b) 3 ranks, `-pt 1,24,25,48 -r 0,1 -q
     0,0 --on-peer-death failover --autoscale-ranks auto --rounds 5`
     with `--autoscale-rank-high` far below any stage's service time:
     one `autoscale_rank direction=up ... ranks=0,1,2`, rank 2 building
     a stage in every later round, every result equal to the
     single-shard forward, kernel 3 launched once per block and
     microbatch over the ranks and on rank 2 only after the scale-up;
     (c) `revauct --comm dcn` over 3 ranks bidding as h100-0..2 from the
     card's profiles (ViT-Large): the schedule equals `--comm local`'s,
     every bidder released; (d) `generate --dcn-addrs` for `gpt2` in 2
     ranks, [16, 192] + 32, at `--edge-bits 0` and 8: tokens/s, kernel 1
     on rank 0 and kernel 2 on rank 1 once a step at 8 bits (none at 0;
     kernel 3 none: a decode prefill attends through `_attend`), all 16
     rows' ids (rank 0's `--save-ids`; the printed sample is row 0) at
     bit 0 equal to the one-process decode's (which equals
     `DecodePipeline.generate`), at 8 bits each row equal to a
     one-process decode with the plain codec at the cut, or differing
     first at a near-tie (`near_tie_rule`). The launches are the kernels
     line's
     `control_launches`.
 20. disaggregated serving, GPT-2 at full width and depth (phase 6's
     weights) on the paged KV plane (`--kv-pages 1024 --kv-page-size
     16`, fp cache, the wave executor): (a) in this process, 8 requests
     of [1, 192] + 64 new tokens, streamed by 4 clients at a time,
     colocated and through `--disaggregate local`, `wire --kv-ship-bits
     0` and `wire --kv-ship-bits 8`: at 0 bits every answer equal to its
     colocated solo run, at 8 bits each held by `near_tie_rule` to a
     one-process decode with the plain codec on the shipped K/V rows;
     prefills shipped equal to the requests routed, none colocated, no
     page leaked; kernels 1 and 2 launched 4 times each per shipped
     request at 8 bits and never at 0; then a `--disaggregate process`
     server (2 prefill worker processes, ship bits 8): 3 single leases
     (each rank's first, timed), the same traffic, every lease shipped
     (no re-dispatch, fallback or colocated pass), the workers' kernel 1
     and the server's kernel 2 launches read from their exit lines (4
     per lease each), nothing left running; one traced request per ship
     path (the prompt pass, the ship, the install, the first decode
     step, the card synchronized between them) and kernels 1 and 2 at
     the ship's shape [6, 1, 192, 12, 64] against the plain codec;
     (b) `python -m pipeedge_tpu_torch.chaos_dcn --target serve-disagg
     --chaos kill@2 --expect disagg --device cuda` on the same weights at
     ship bits 8 (run beside phase 18's cases, and the process-mode
     server's start-up and the references beside phase 19's fleets
     (b)-(d), for the script's time): nothing lost or errored, no page leaked, the fault
     path engaged, the victim readmitted, no process left, the workers'
     kernel 1 and the server's kernel 2 launches read from their lines.
     Printed per run: first-token p50/p95, tokens/s, ship bytes, lease
     outcomes, `recovery_s`; the launches are the kernels line's
     `disagg_launches`.
 21. the tensor-parallel axis (`parallel/{mesh,tensor}.py`,
     `ops/qcollectives.py`), the shards sharing the one card:
     (a) a ViT-Base block (seeded on the card) over 2 and 4 shards
     (`make_tp_block_fn`) within TP_BLOCK_TOL of the unsharded block,
     every shard's output equal, kernel 3 once per shard; `qpsum` at 8
     and 4 bits over 2 and 4 shards of [8, 197, 768] addends, each
     shard's result equal bit for bit to the same ring through the plain
     codec on the card and within `qpsum_error_bound` of the exact sum,
     n^2 encodes and 2n(n-1) decodes a call; kernels 1 and 2 at the
     ring's chunk shapes ([2364, 256], [1182, 256], and the Llama-3-8B
     prompt's [16384, 256]) against the plain codec (the ring's one
     block per item and the edge's 8-block cluster both), kernel 3 at a
     shard's [8, 197, 6, 64] and kernel 5 over a shard's 6 heads, each
     timed beside its plain version and bound;
     (b) beside phase 16's (b) and (d): `runtime -c dcn` ViT-Base in 2
     ranks at `-pt 1,24,25,48 --stage-tp 2`, one fleet at
     `--tp-quant-bits 0` with an exact edge (logits within
     TP_DCN_FP_BOUND of the single-shard forward, argmax equal) and one
     at `--tp-quant-bits 8` with an 8-bit edge (within LOGIT_BOUND[8]),
     every rank's launches per kernel (96 kernel-3, 384 + 8 encodes and
     decodes at 8 bits), the 8-bit fleet traced (`--trace-spans`) and
     its stage-tagged collective bytes read from `trace_report`'s
     `collectives` section;
     (c) `generate --tp 2` against `--tp 1`: GPT-2 `-pt 1,24,25,48`
     [16, 192] + 64 through the entry on fp and int8 caches (kernel 5
     per shard, 12 x 2 launches a decode step), Llama-3-8B at
     LLAMA_BLOCKS in process (GQA kv heads split, the vocab-split head)
     [4, 512] + 32, each generation held by `near_tie_rule` to the
     `--tp 1` pipeline's greedy decode; tokens/s and device kernels per
     decode step at both degrees.
 22. expert and sequence parallelism (`parallel/{expert,sequence}.py`,
     `DecodePipeline(ep_mesh/tp_ep_mesh/sp_mesh)`), the shards sharing
     the one card:
     (a) `ep_ffn_delta` at the MoE GPT-2's widths (768 / 3072, 8
     experts, [16, 192] tokens) over 2 and 4 shards against the single
     device (equal, or within EP_DELTA_BOUND; each shard's delta exactly
     0 off its kept tokens, dropped tokens 0); the ring and Ulysses cores
     at Llama-3-8B's heads (32 / 8 kv / 128) over [1, 4096] causal, sp 2,
     against kernel 3 and the plain full attention (ATTN_TOL), Ulysses
     with 2 kernel-3 launches, the ring none; Ulysses under Mistral-7B's
     window (4096) over [1, 8192] against a plain windowed attention, no
     kernel-3 launch; kernel 3 at a Ulysses head group [1, 4096, 16, 128]
     f32 causal beside its plain version, SDPA and its bound;
     (b) the MoE GPT-2 (weights drawn on the card, handed to the entry)
     through `generate -pt 1,24,25,48 -b 16 --prompt-len 192
     --new-tokens 64 --max-len 1024` at `--ep 2 --kv-bits 8` with the
     decode-attention opt-in (kernel 5, 12 blocks x 2 shards a step) and
     `--tp 2 --ep 2` (4 shards), each held by `near_tie_rule` to the ep
     1 pipeline's greedy decode over the same whole-window attends;
     tokens/s, ms and device kernels per step at ep 1 and on the mesh;
     the grid in process at `set_tp_quant_bits(8)` (a prefill and two
     steps) within LOGIT_BOUND[8] of the exact grid, with n^2 encodes and
     2n(n-1) decodes per attention all-reduce of each ep column; kernels
     1 and 2 at the grid's ring chunks and kernel 5 at an ep shard's
     whole window, timed;
     (c) Llama-3-8B at LLAMA_BLOCKS (`-pt 1,8,9,16`) [1, 4096] + 32
     through `generate --sp 2` (the ring core), held by `near_tie_rule`
     to the sp 1 pipeline's greedy decode; in process the ring and
     Ulysses prefills against sp 1's (last-position logits within
     SP_LOGIT_BOUND, the gathered cache within SP_CACHE_BOUND of its
     route), kernel 3 launched 2 per block by Ulysses only, Ulysses'
     tokens by the same rule; prefill ms at sp 1 and 2.
 23. the SPMD pipeline driver (`parallel/spmd.py`) through `python -m
     pipeedge_tpu_torch.runtime ... -c spmd`, in this process (each run
     the entry's warm-up and timed batch of 64 in microbatches of 8), the
     mesh's shards sharing the one card: (a) ViT-Base (phase 4's npz) at
     `-pt 1,12,13,24,25,36,37,48` (4 stages of 3 blocks) at `-q 0`, equal
     bit for bit to the host driver's exact run at that cut, at `-q
     8,8,8,0` within LOGIT_BOUND[8] and at `-q 8,4,0,0` within
     LOGIT_BOUND[4] of it, neither equal; (b) `--spmd-dp 2 --spmd-tp 2`
     at `-pt 1,24,25,48`, `--tp-quant-bits 0` within SPMD_TP_BOUND and 8
     within LOGIT_BOUND[8] of the exact run, then one run at 8 bits
     through the API with every `qpsum` within `qpsum_error_bound` of its
     exact sum and equal to the entry's outputs; (c) BERT-Large (weights
     drawn on the card) at `-pt 1,48,49,96` unsharded, then `--spmd-dp 2
     --spmd-sp 2` with the ring and the Ulysses core, each within
     SPMD_SP_BOUND of the unsharded run. Every run's launches equal the
     prediction (`spmd_launches`: only the valid stage-steps run): kernel
     3 96 per run in (a), 384 in (b), 192 unsharded, 0 ring and 768
     Ulysses in (c); kernels 1 and 2 8 per quantized edge in (a), n^2 =
     4 encodes and 2n(n-1) = 4 decodes per `qpsum` in (b) at 8 bits (384
     all-reduces a run). Printed: each run's items/s and seconds, and
     the device memory allocated before it and at its peak.
 24. the SPMD wave decoder (`parallel/spmd_decode.py`): GPT-2 at full
     width and depth (phase 6's npz) in 4 stages of 3 blocks on the one
     card, R = 4 slots of batch 4, 64-token prompts (all opening with
     the same 32 tokens, (d)'s prefix), 32 new tokens:
     (a) every slot of the greedy wave equal to its solo
     `DecodePipeline.generate` on the card token for token (the same [4,
     ...] shapes, so the same kernels and cuBLAS calls), and of the
     sampled wave (temperature 0.9, top-k 40, slot r seeded 24 + r) to
     its solo run with that seed; the walk R x K stage-steps a wave;
     (b) the host syncs of a greedy walk counted under
     `torch.cuda.set_sync_debug_mode("warn")`: none (the counter sees
     the one sync of a readback);
     (c) `generate --spmd-wave` in this process at `--edge-bits 0` and
     8, beside `--concurrent 4` on the same prompts (the 0-bit wave's
     ids equal its), kernels 1 and 2 launched 2 x R x (K - 1) = 24
     times each at 8 bits (warm-up and timed prefill waves), 0 at 0
     bits; in process, each slot's first-token logits at 8 bits within
     LOGIT_BOUND[8] of the exact wave's (12 launches of each);
     (d) a prefix-seeded wave (32 shared prompt tokens) against the
     monolithic wave at edge bits 0 and 8, by `slot_rule` at WAVE_TIE
     (equal, or a near tie at the first difference, as `spec_rule`
     says), the first-token
     logits within WAVE_TIE; `SpmdSpeculativeDecoder` (gamma 4) with the
     whole gpt2 as a self-draft (acceptance 1.0, tokens equal to the
     greedy wave's) and with phase 13's noisy self-draft (by `slot_rule`);
     (e) inside phase 14, on Llama-3-8B's card-drawn weights at
     LLAMA_BLOCKS in its 2 stages: the greedy wave of 2 slots [2, 64] +
     16 equal to each slot's solo run.
     Printed: tokens/s of the wave, the solo runs one after another, the
     entries and the speculative waves.
 25. training on the card (`parallel/train.py`), through
     `pipeedge_tpu_torch.train.main` in this process, seeded weights and
     data as the entry draws them:
     (a) ViT-Base in 2 stages (`-pt 1,24,25,48 -u 4 -b 8`, Adam, 5
     steps): the loss falls; the first step's loss and gradients at `-b
     2` on the card within TRAIN_GRAD_TOL of the same step on the CPU
     (the plain path); a run of 3 steps that checkpoints and a run that
     resumes from it for steps 4-5 end at the uninterrupted run's loss
     (TRAIN_RESUME_TOL);
     (b) GPT-2 in 4 stages at `--seq-len 1024` (microbatches [2, 1023]),
     `--mixed-precision --remat`, SGD, 5 steps: the loss falls.
     Kernel 3's backward launches blocks x M x dp a step in both, and its
     forward as many, twice that under remat (`train_launches`).
     Printed: steps/s, peak `torch.cuda.max_memory_allocated` and the
     seconds of each run.
 26. the multi-process contexts (`comm.MultiHostContext`,
     `global_devices()`, process-spanning meshes): two ranks of this
     script (`--multihost-rank R`), each a process, share the one card
     under `gloo` (NCCL refuses two ranks on one card), 4 positions each
     on cuda:0, process-major. They start beside phase 25, load their
     weights and wait for the phase. ViT-Base (phase 4's npz) in 4 stages
     of 3 blocks, M = 4 microbatches of 8:
     (a) dp 2 x 4 stages (one dp row a rank), 8-bit edges: each rank's
     output equals the in-process `SpmdPipeline` of the same mesh (8
     positions on cuda:0) bit for bit;
     (b) dp 1 x 4 stages, stages 0-1 on rank 0 and 2-3 on rank 1, 8-bit
     edges (kernel 1's words cross the process): equal bit for bit;
     (c) 3 SGD steps on each layout: the ranks' losses agree to the
     printed digit and lie within rtol 1e-5 of the in-process steps; the
     first step's gradients within TRAIN_GRAD_TOL of the in-process ones;
     (d) GPT-2 (phase 6's npz, 2 stages) greedy over a tp group of one
     position in each rank: the tokens of the in-process tp 2 run.
     Each rank prints its launches per leg (`rank=R leg=L
     kernel_launches=`), held to `mh_expected`; a failed rank fails the
     phase. Printed: items/s and steps/s beside the in-process runs', the
     time of one gloo hop through the host (an 8-bit edge payload and an
     f32 activation), the ranks' start-up and the phase's seconds.
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
run's items/s is printed. `--spmd-memory [ROOT]` runs only phase
23(b)'s dp 2 x tp 2 entry at `--tp-quant-bits 0`, with the port imported
from the checkout at ROOT (default this one), and prints the device
memory resident before it and at its peak: run once per checkout, in a
process each, it compares versions. `--mh-rates [ROOT]` does the same
for phase 26's in-process legs, three times each: (a) and (b) items/s,
(c) steps/s, (d) tokens/s.
Then one `{"kernels": [...]}` JSON line and, last, the device line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.

Exits nonzero, and prints no result, without a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
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
# Kernel 3's backward against its plain version, each of dq, dk, dv as a
# share of its own max |grad|: f32 (full f32 FMAs against f32 matmuls,
# summed in other orders, from an LSE of 3xTF32 scores) 1e-4; bf16 (both
# round one f32 result to bf16, 2^-8 relative) 2e-2. The kernel's LSE
# against the plain log-sum-exp: 1e-3 absolute (base-2 units).
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_LSE_TOL = 1e-3

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

# device_launches: the most profiler sessions one count may take
DEVICE_LAUNCH_SESSIONS = 5

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
# new tokens drawn from [8, 24], and the batched request's 32 ((16, 48)
# and 64 until PR 17's review round), for the script's time
SERVE_NEW = (8, 24)
SERVE_PREFIX_LEN = 128
SERVE_BATCHED = (4, 128, 32)      # rows, prompt length, new tokens
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
# --kv-bits), batch 4 x 128-token prompts, 16 new tokens, in host and in
# device sync; then gpt2-medium as its own draft; then 4 speculative
# requests through the server with --kv-pages; then the generate entry.
SPEC_TARGET = "gpt2-medium"
SPEC_DRAFT = DECODE_MODEL
SPEC_GAMMA = 4
# 16 new tokens (64 before phase 19 was added, 32 before phase 20), for
# the script's time
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW = 4, 128, 16
# the noisy self-draft: seeded N(0, 1) noise times SPEC_NOISE times each
# matrix's own standard deviation, added to every weight matrix of the
# last block
SPEC_NOISE = 0.1
# (host, device, device, host) once; 2 until the script passed 1000 s of
# its 1200 s limit on a slow host (PR 13)
SPEC_PAIRS = 1
SPEC_SERVE = 4                    # speculative requests through the server
SPEC_SERVE_NEW = 16               # 32 before phase 20, as SPEC_NEW

# Phase 14, the decoder families at full width (module docstring). The
# weights are drawn on the card (`card_params`); every pipeline, oracle
# and server of one model shares them, and each model is freed before
# the next: two f32 copies of an 8B model and its caches do not fit.
LLAMA3 = "meta-llama/Meta-Llama-3-8B"
LLAMA2 = "meta-llama/Llama-2-7b-hf"
MISTRAL = "mistralai/Mistral-7B-v0.1"
MOE = "pipeedge/gpt2-moe-8e"
# the three Llama-family models run at 8 of their 32 blocks (full width;
# `cut_llama_depth`): at 32 the whole script with phase 17 took 889.2 s
# on the H100 (NVIDIA H100 80GB HBM3, 700.00 W), too near its 1200 s
# limit on a slower host, so PR 14 cut them to 16; with phase 18 a host
# 1.4x slower reached 932 s by the end of phase 15 (PR 15), so 8; with
# phase 20 (PR 17), 4
LLAMA_BLOCKS = 4
FAMILY_PARTITION = [(1, 2 * LLAMA_BLOCKS), (2 * LLAMA_BLOCKS + 1,
                                            4 * LLAMA_BLOCKS)]
MOE_PARTITION = [(1, 24), (25, 48)]
# sequences, microbatch, tokens; 32 sequences until the script passed
# 1000 s of its limit (PR 13)
FAMILY_FWD = (16, 8, 128)
# batch, prompt, new tokens (cut from 128 new tokens to make room for
# phase 22)
FAMILY_DECODE = (4, 512, 64)
LLAMA_MAX_LEN = 640
MISTRAL_DECODE = (4090, 16)       # prompt, new tokens: steps cross 4096
MOE_DECODE = (16, 192, 64)        # batch, prompt, new tokens (cut from
                                  # 128, as FAMILY_DECODE); max_len is
                                  # DECODE_MAX_LEN, so kernel 5 sees phase
                                  # 6's cache
# fp decode logits against the forward over the same tokens, as a share
# of max |logit| (f32 on both sides). Phase 6 holds GPT-2 (12 blocks,
# inner widths 768 / 3072) at 1e-4; here 32 blocks of inner widths 4096 /
# 14336 sum longer dot products in other orders (M = B rows per step
# against B x S), the forward attends through kernel 3's 3xTF32 products
# (each within ~2^-21 of f32) where a step attends through an f32 einsum,
# and the unnormalized residual stream grows with depth. 10x phase 6's
# bound. The same bound holds Mistral's kernel-3 route at S = 4096
# against its masked route.
FAMILY_FP_BOUND = 1e-3
# The MoE GPT-2's 8-bit edge. Top-1 routing is discontinuous: an 8-bit
# edge moves a token's router logits a little, enough to flip a near-tie
# between two experts or a token's rank for a capacity slot, and a
# rerouted token then takes another expert's whole FFN delta (or none),
# and so do the later tokens of its sequence through attention. So the
# edge is held in two parts (`family_forward`, `routing_split`): the
# pipeline's logits equal, bit for bit, the stages' forward with the
# plain codec applied at the cut; and the tokens of a sequence before its
# first rerouted token (expert or capacity slot, in any block) stay
# within LOGIT_BOUND of the exact forward, as a ViT's tokens do. The
# error of the rerouted tokens is printed, not bounded: it is the
# model's, not the codec's.
# Phase 14c: the Llama-3-8B server with an int8 cache on 512 pages of 16
# tokens per stage, prompts past 64 tokens in 64-token chunks; 8
# concurrent clients (2 streamed, 4 plain, 2 sharers of the 128-token
# prefix a publisher served alone first has put in the trie), prompts of
# 64-512 tokens and 8-32 new tokens.
LLAMA_SERVE_FLAGS = ["-m", LLAMA3, "-pt", ",".join(
                         str(b) for lr in FAMILY_PARTITION for b in lr),
                     "--max-len",
                     str(LLAMA_MAX_LEN), "-t", "float32", "--kv-bits", "8",
                     "--max-active", "9", "--brownout-p95-high", "600",
                     "--brownout-p95-low", "300"]
LLAMA_PAGED_FLAGS = ["--kv-pages", "512", "--kv-page-size", "16",
                     "--chunked-prefill", "64"]
FAMILY_SERVE_PROMPT = (64, 512)
FAMILY_SERVE_NEW = (8, 32)        # (16, 64) until PR 13, as FAMILY_FWD
FAMILY_SHARERS = 2
# Phase 14f: 4 requests of phase 11's draw through the MoE GPT-2's server
MOE_SERVE = 4
MOE_SERVE_FLAGS = ["-m", MOE, "-pt", "1,24,25,48", "--max-len", "1024", "-t",
                   "float32", "--kv-bits", "8", "--int8-decode-attend",
                   "auto", "--max-active", "4"]
# Phase 14g: the entries on the tiny models
FAMILY_TINY = ["pipeedge/test-tiny-llama", "pipeedge/test-tiny-mistral",
               "pipeedge/test-tiny-moe"]
FAMILY_TINY_NEW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 7, stream=None) -> float:
    """Device time of one `fn()` call: a CUDA graph of `iters` calls,
    replayed `reps` times between CUDA events; the median per call.
    Inputs stay in L2 between calls, as they are on the main path, where
    the producer has just written them. `stream`: the side stream to warm
    up and capture on (an autograd backward launches on its forward's
    stream, so timing one takes the stream its forward ran on).

    Cold L2: `fn` may be a list of callables, each over its own copy of
    the inputs (`cold_copies`); the captured calls then rotate over them
    (at least one round), so a copy comes back only after the others have
    streamed more than the L2 through it, as a decode step finds a layer's
    cache window one full step after it last read it."""
    fns = fn if isinstance(fn, list) else [fn]
    iters = max(iters, len(fns))
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns * (3 if len(fns) == 1 else 1):
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


# phase 24: the wave decoder's hops, a slot's [B, S_p, D] prompt hop, the
# prefix wave's [1, 32, D] and the suffix span wave's [B, 32, D]
WAVE_EDGES = ((4, 64, 768), (4, 32, 768), (1, 32, 768))
# the codec shapes timed beside their plain version and bound
TIMED_EDGES = ((8, 197, 768), (8, 128, 4096)) + WAVE_EDGES


def check_codec(dev, gen):
    from pipeedge_tpu_torch.ops import fused_quant, quant
    rows = {}
    # [2, 605184] / [2, 605189]: an item whose slice outgrows shared
    # memory (the tiled re-read), 16-byte and scalar copies
    # [64, 151296]: item scales from 1e-30 to 1e30, through the encode's
    # reciprocal division and its __fdiv_rn fallback (csrc div_rn)
    # [6, 151296] / [6, 37]: NaN, +-inf and an overflowing range
    # [65537, 37]: more items than one grid axis takes
    cases = (((8, 197, 768), "zero_item"), ((3, 37), "zero_item"),
             ((2, 151296 * 4), "zero_item"),
             ((2, 151296 * 4 + 5), "zero_item"),
             ((64, 197 * 768), "scaled"),
             ((6, 151296), "nonfinite"), ((6, 37), "nonfinite"),
             ((65537, 37), "plain"),
             ((8, 197, 768), "plain"),
             # phase 14: a Llama-3-8B / Mistral-7B edge
             ((8, 128, 4096), "plain"))
    for shape, kind in cases + tuple((s, "plain") for s in WAVE_EDGES):
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
            if kind == "plain" and shape in TIMED_EDGES:
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
                cluster16_ms = None
                if shape not in WAVE_EDGES:
                    fused_quant.ENCODE_CLUSTER = 16
                    try:
                        cluster16_ms = time_ms(
                            lambda: fused_quant.fused_encode_outerdim(x, bit))
                    finally:
                        fused_quant.ENCODE_CLUSTER = chosen
                # the main path's edge keyed (name, bit), others with
                # their shape
                key = () if shape == (8, 197, 768) else (shape,)
                rows[("fused_encode", bit) + key] = dict(
                    shape=list(shape), bit=bit, max_abs_err=enc_err,
                    device_kernels=kernels["fused_encode"], cluster=chosen,
                    cluster16_ms=cluster16_ms,
                    ms=time_ms(lambda: fused_quant.fused_encode_outerdim(x, bit)),
                    plain_ms=time_ms(lambda: quant.tensor_encode_outerdim(x, bit)),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                    library_ms=None)
                rows[("fused_decode", bit) + key] = dict(
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
             ("bshd", (8, 197, 16, 64), torch.float32, False),
             # phase 14: the Llama family's causal forward at head dim
             # 128: Llama-3-8B's microbatch (f32; bf16 beside it), the
             # decode checks' forwards over 640 tokens (Llama-3-8B f32,
             # Llama-2-7B bf16), Mistral-7B at its window (f32; bf16
             # beside it); a 512-token forward; and the MoE GPT-2's
             ("bshd", (8, 128, 32, 128), torch.float32, True),
             ("bshd", (8, 128, 32, 128), torch.bfloat16, True),
             ("bshd", (4, 640, 32, 128), torch.float32, True),
             ("bshd", (4, 640, 32, 128), torch.bfloat16, True),
             ("bshd", (4, 512, 32, 128), torch.float32, True),
             ("bshd", (1, 4096, 32, 128), torch.float32, True),
             ("bshd", (1, 4096, 32, 128), torch.bfloat16, True),
             ("bshd", (8, 128, 12, 64), torch.float32, True),
             # phase 23: a dp x tp cell's ViT-Base shard (4 rows, 6
             # heads), BERT-Large (16 heads, 64 tokens) whole and as a
             # dp x sp cell's Ulysses head group (4 rows, 8 heads)
             ("bshd", (4, 197, 6, 64), torch.float32, False),
             ("bshd", (8, 64, 16, 64), torch.float32, False),
             ("bshd", (4, 64, 8, 64), torch.float32, False)]
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


# phase 3: kernel 3's backward at the training path's shapes: ViT-Base
# (phase 25(a)), GPT-2 at S = 1024 in f32 and bf16 (25(b) runs bf16 at S =
# 1023), a Llama head group at head dim 128 and the tiny head dim 8
ATTN_BWD_CASES = [((8, 197, 12, 64), torch.float32, False),
                  ((2, 1024, 12, 64), torch.float32, True),
                  ((2, 1024, 12, 64), torch.bfloat16, True),
                  ((1, 512, 32, 128), torch.bfloat16, True),
                  ((8, 64, 4, 8), torch.float32, False)]


def attention_bwd_bound_ms(b, h, s, d, dtype, causal):
    """The backward's least time: q, k, v, o, dO and the LSE read once,
    dq, dk, dv written once; five products of 2 x pairs x D flops per
    head (P, dO V^T, dV, dQ, dK), at the peak of the inputs' type."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 8 * b * h * s * d * elem + 4 * b * h * s
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 10 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / ATTN_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_attention_backward(dev, gen):
    """Kernel 3's backward against `attention_backward_reference` on the
    same inputs and the forward kernel's o and LSE (ATTN_BWD_CASES); each
    timed beside the plain backward and SDPA's (the library yardstick,
    called here only)."""
    import torch.nn.functional as F
    from pipeedge_tpu_torch.ops import attention
    flip = (0, 2, 1, 3)
    rows = []
    for shape, dtype, causal in ATTN_BWD_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = attention.fused_attention_lse(q, k, v, causal)
        lse_err = float((lse - attention.attention_lse_reference(
            q.permute(flip), k.permute(flip), causal)).abs().max())

        def kern():
            return attention.fused_attention_backward(q, k, v, o, do, lse,
                                                      causal)

        def plain():
            return attention.attention_backward_reference(
                *(t.permute(flip) for t in (q, k, v, o, do)), lse, causal)

        got = kern()
        want = [w.permute(flip) for w in plain()]
        torch.cuda.synchronize()
        diffs = {name: float((g.float() - w.float()).abs().max())
                 for name, g, w in zip(("dq", "dk", "dv"), got, want)}
        errs = {name: diffs[name] / float(w.float().abs().max())
                for name, w in zip(("dq", "dk", "dv"), want)}
        if max(errs.values()) > ATTN_BWD_TOL[dtype] or \
                lse_err > ATTN_LSE_TOL or \
                not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(
                f"attention backward {list(shape)} {dtype} causal={causal}: "
                f"errors {errs} (limit {ATTN_BWD_TOL[dtype]} of max |grad|), "
                f"lse {lse_err} (limit {ATTN_LSE_TOL})")
        # SDPA's backward alone, on the stream its forward ran on, timed
        # as the kernel is (a CUDA graph of the autograd call's kernels)
        sdpa_stream = torch.cuda.Stream()
        sdpa_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(sdpa_stream):
            leaves = [t.permute(flip).detach().requires_grad_(True)
                      for t in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                      is_causal=causal)
            sdpa_do = do.permute(flip)
            sdpa_backend = sdpa_out.grad_fn.name()

        def library():
            return torch.autograd.grad(sdpa_out, leaves, sdpa_do,
                                       retain_graph=True)

        b, s, h, d = shape
        bound, bound_by = attention_bwd_bound_ms(b, h, s, d, dtype, causal)
        row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                   causal=causal, max_abs_err=max(diffs.values()),
                   rel_errs=errs, lse_max_abs_err=lse_err,
                   ms=time_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(library, stream=sdpa_stream),
                   library_op=sdpa_backend, bound_ms=bound,
                   bound_by=bound_by)
        del sdpa_out
        log("attention backward " + json.dumps(row))
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


def device_launches(fn, host_copies: bool = False):
    """Kernels one `fn()` call puts on the device (torch.profiler). The
    tracer can miss a kernel in the first sessions of a process (on the
    H100 the encode went uncounted in a first session, and once in a
    second), and never counts one that was not launched, since every
    session starts after a synchronize. So sessions repeat until two in a
    row agree on a count above 0 (at most DEVICE_LAUNCH_SESSIONS), and
    the count is the largest seen. With `host_copies`, also the copies
    between host and device (`Memcpy HtoD` / `DtoH` events) of that
    session: (kernels, copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    while len(counts) < DEVICE_LAUNCH_SESSIONS:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        counts.append((len(events), sum(1 for e in events
                                        if "HtoD" in e.name
                                        or "DtoH" in e.name)))
        if len(counts) >= 2 and counts[-1][0] == counts[-2][0] > 0:
            break
    most = max(counts)
    return most if host_copies else most[0]


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

    # the generate entry, once, in this process, with the kernel route
    # chosen by the env (set for the call)
    import io
    import logging
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.ops import _build
    pt = ",".join(f"{l},{r}" for l, r in partition)
    argv = ["-m", model, "-pt", pt, "-b", str(batch), "--prompt-len",
            str(prompt_len), "--new-tokens", str(new_tokens), "--max-len",
            str(max_len), "--attend-floor", str(floor), "--kv-bits", "8",
            "--device", torch.device(device).type]
    saved = os.environ.get("PIPEEDGE_INT8_DECODE_ATTEND")
    os.environ["PIPEEDGE_INT8_DECODE_ATTEND"] = "1"
    # a handler on the root makes the entry's logging.basicConfig a no-op:
    # the script's later phases keep their logging as it was
    quiet, out = logging.NullHandler(), io.StringIO()
    logging.getLogger().addHandler(quiet)
    _build.reset_launch_counts()    # the entry prints the process's tally
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            generate.main(argv)
    finally:
        logging.getLogger().removeHandler(quiet)
        if saved is None:
            os.environ.pop("PIPEEDGE_INT8_DECODE_ATTEND")
        else:
            os.environ["PIPEEDGE_INT8_DECODE_ATTEND"] = saved
    lines = out.getvalue().splitlines()
    for line in lines:
        log("generate entry: " + line)
    launches = [json.loads(ln.split("=", 1)[1]) for ln in lines
                if ln.startswith("kernel_launches=")]
    res["entry"] = dict(
        command=" ".join(["in process: PIPEEDGE_INT8_DECODE_ATTEND=1", "-m",
                          "pipeedge_tpu_torch.generate"] + argv),
        seconds=time.monotonic() - t0,
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


def lockstep_routes(pipes, ids, new_tokens: int, sync, pin=None):
    """Prefill `ids` on the kernel route pipes["ii"] and the dequantize
    route pipes["iii"] (both int8 caches), then step both on (ii)'s greedy
    tokens, in alternating order, the launch counts set to 0 before each
    step. With a `RoutingPin` (an MoE model), the second run of each
    prefill and step takes the first one's routing. Returns (the numbers,
    the caches, the last token)."""
    from pipeedge_tpu_torch.ops import _build
    prompt_len = ids.shape[1]
    pk = pipes["ii"]
    prefill_ms, cache, last = {}, {}, {}
    for j, run in enumerate(("ii", "iii")):
        if pin is not None:
            pin.start(j == 0)
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
        for j, run in enumerate(order):
            if pin is not None:
                pin.start(j == 0)
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
    res["entry"] = run_entry_here(
        ["0", str(len(partition)), "-m", model, "-pt", pt,
         "-q", ",".join(["8"] * edges + ["0"]), "-b", str(BATCH),
         "-u", str(UBATCH), "--device", torch.device(device).type],
        monitor_dir, {"ADAPTIVE_QUANT": "HEURISTIC",
                      "WINDOW_SIZE": str(window),
                      "SEND_CONSTRAINT": repr(constraint)})
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


def run_entry_here(argv, cwd: Path, env_extra=None) -> dict:
    """`run_entry` without the process: `pipeedge_tpu_torch.runtime.main
    (ARGV)` in this process, in `cwd` (its monitoring CSVs), with
    `env_extra` set in the environment for the call (the entry reads its
    adaptive-policy variables when it runs), its stdout and its logged
    schedule read as `run_entry` reads them."""
    import io
    import logging
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.ops import _build
    cwd.mkdir(parents=True, exist_ok=True)
    sched, out = [], io.StringIO()

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Scheduling: stage-to-"):
                sched.append(msg.split("Scheduling: ", 1)[1])

    # the entry's records reach `keep` and no stream: a handler on the
    # root makes the entry's logging.basicConfig a no-op, as its stderr
    # was the subprocess's own
    keep, rt_log = Keep(), logging.getLogger(runtime.__name__)
    quiet = logging.NullHandler()
    level = rt_log.level
    rt_log.setLevel(logging.INFO)
    rt_log.addHandler(keep)
    logging.getLogger().addHandler(quiet)
    here = os.getcwd()
    env_extra = env_extra or {}
    saved_env = {key: os.environ.get(key) for key in env_extra}
    os.environ.update(env_extra)
    _build.reset_launch_counts()   # the entry prints the process's tally
    t0 = time.monotonic()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            runtime.main(argv)
    finally:
        os.chdir(here)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        rt_log.removeHandler(keep)
        rt_log.setLevel(level)
        logging.getLogger().removeHandler(quiet)
    lines = out.getvalue().splitlines()
    for line in lines:
        log("runtime entry: " + line)

    def value(prefix):
        found = [json.loads(ln.split("=", 1)[1]) for ln in lines
                 if ln.startswith(prefix + "=")]
        return found[0] if len(found) == 1 else None

    steady = [float(ln.split("=", 1)[1]) for ln in lines
              if ln.startswith("steady_state_throughput_items_sec=")]
    return dict(command=" ".join(
        ["in process:"] + [f"{k}={v}" for k, v in env_extra.items()]
        + ["-m", "pipeedge_tpu_torch.runtime"] + list(argv)),
                seconds=time.monotonic() - t0,
                kernel_launches=value("kernel_launches"),
                edge_bits=value("edge_bits"),
                report=[ln for ln in lines if ln.startswith("latency_sec=")],
                steady_items_per_s=steady[-1] if steady else None,
                sched_log=sched)


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
    res = {"entry": run_entry_here(
        ["0", str(len(partition)), "-m", model, "-pt", pt, "-q", "8,0",
         "-b", str(BATCH), "-u", str(UBATCH),
         "--device", torch.device(device).type], weights_dir / "monitor")}
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
        entry = run_entry_here(
            ["0", str(len(SCHED_HOSTS)), "-m", SCHED_MODEL,
             "-M", str(weights[SCHED_MODEL]), "-sm", str(files["models"]),
             "-sdt", str(files["device_types"]),
             "-sd", str(files["devices"]), "-H", ",".join(SCHED_HOSTS),
             "-b", str(BATCH), "-u", str(UBATCH),
             "--measure-rounds", str(SCHED_ROUNDS),
             "--save-results", str(saved), "--device", device],
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

    # BASELINE configs 1 and 2 through the entry in this process, each
    # with its own monitoring directory (a process each would spend most
    # of its time starting up; their items/s are logged, not gated)
    configs = {"config 1": ["0", "1"],
               "config 2": ["0", "2", "-pt", BASELINE_PARTITION]}
    res["baseline"] = {name: run_entry_here(
        argv + ["-m", MODEL, "-M", str(weights[MODEL]), "-b", str(BATCH),
                "-u", str(UBATCH), "--device", device],
        weights_dir / "monitor" / name.replace(" ", ""))
        for name, argv in configs.items()}
    blocks = registry.get_model_config(MODEL).num_hidden_layers
    for e in res["baseline"].values():
        e["expected"] = {"fused_attention": blocks * n_mb,
                         "fused_encode": 0, "fused_decode": 0}
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


def http_json_url(url: str, timeout: float = 60):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


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


def reaches_kernel5(model: str) -> bool:
    """Whether `model`'s int8 decode steps route to kernel 5: the GPT-2
    family's steps ask the gate; a family with its own cached block
    (Llama) attends through the dequantize route and never asks it."""
    from pipeedge_tpu_torch.models import registry
    return registry.get_model_entry(model).family.FAMILY \
        .cached_block_step is None


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
    token attends through kernel 5 whatever its kind, in a family whose
    steps reach it (`reaches_kernel5`)."""
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
    kernel5 = bool(args.kv_bits) and reaches_kernel5(args.model_name)
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
            + sum(blocks) * prompt_singles if kernel5 else 0),
        kernel5=kernel5,
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
                run["kernel5"] and run["counts"]["decode_attention"]
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


def noisy_draft(target, max_len: int, eps: float, seed: int = 0,
                model: str = SPEC_TARGET):
    """`target` (one stage of `model`) as its own draft, with seeded noise
    of relative size `eps` on every weight matrix of its last block;
    every other parameter is the target's own tensor."""
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
    return build_decode_pipeline(model, None, max_len=max_len,
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
    server; the generate entry runs beside them from the moment the
    weights are written, for the script's time."""
    from concurrent.futures import ThreadPoolExecutor
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
    entry_pool = ThreadPoolExecutor(1)
    entry = entry_pool.submit(generate_entry, [
        "-m", SPEC_TARGET, "-M", str(files[SPEC_TARGET]), "--draft-model",
        SPEC_DRAFT, "--gamma", str(SPEC_GAMMA)])
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
    res["entry"] = entry.result()
    entry_pool.shutdown()
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


# --- phase 14: the decoder families at full width ---------------------------

def card_params(model: str, dtype=torch.float32, seed: int = 0) -> dict:
    """A whole model's parameters drawn on the card with a seeded CUDA
    generator, in the structure the family's `load_params` builds (a list
    of per-block dicts): N(0, 0.02) matrices, norm scales N(1, 0.02),
    zero linear biases (the Llama, GPT-2 and BERT structures). This is not the JAX package's numpy stream
    (`init_params`, which the CPU tests hold to the JAX package): 8e9 f64
    normals drawn on the host would take minutes. The LM head of the
    MoE GPT-2 is tied to `wte` (a transposed view), the Llama head is its
    own matrix, as in `load_params` of their checkpoints."""
    from pipeedge_tpu_torch.models import registry
    cfg = registry.get_model_config(model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    d, it, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def mat(*shape, mean=0.0):
        return torch.empty(shape, dtype=dtype, device="cuda").normal_(
            mean, 0.02, generator=gen)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    def lin(n_in, n_out):
        return {"w": mat(n_in, n_out), "b": zeros(n_out)}

    if cfg.model_type == "bert":
        def norm():
            return {"scale": mat(d, mean=1.0), "bias": mat(d)}

        blocks = [{"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                   "attn_out": lin(d, d), "attn_ln": norm(),
                   "mlp_up": lin(d, it), "mlp_down": lin(it, d),
                   "out_ln": norm()} for _ in range(cfg.num_hidden_layers)]
        final = {"pooler": lin(d, d)}
        if cfg.num_labels:
            final["head"] = lin(d, cfg.num_labels)
        return {"embeddings": {"word": mat(vocab, d),
                               "pos": mat(cfg.max_position_embeddings, d),
                               "type": mat(cfg.type_vocab_size, d),
                               "ln": norm()},
                "blocks": blocks, "final": final}
    if cfg.model_type == "llama":
        kv = cfg.kv_heads * cfg.head_dim

        def norm():
            return {"scale": mat(d, mean=1.0)}

        blocks = [{"ln_before": norm(), "q": lin(d, d), "k": lin(d, kv),
                   "v": lin(d, kv), "attn_out": lin(d, d),
                   "ln_after": norm(), "mlp_gate": lin(d, it),
                   "mlp_up": lin(d, it), "mlp_down": lin(it, d)}
                  for _ in range(cfg.num_hidden_layers)]
        return {"embeddings": {"wte": mat(vocab, d)}, "blocks": blocks,
                "final": {"ln": norm(), "head": lin(d, vocab)}}
    e = cfg.n_experts

    def norm():
        return {"scale": mat(d, mean=1.0), "bias": mat(d)}

    wte = mat(vocab, d)
    blocks = [{"ln_before": norm(), "q": lin(d, d), "k": lin(d, d),
               "v": lin(d, d), "attn_out": lin(d, d), "ln_after": norm(),
               "moe": {"router": lin(d, e), "experts": {
                   "mlp_up": {"w": mat(e, d, it), "b": zeros(e, it)},
                   "mlp_down": {"w": mat(e, it, d), "b": zeros(e, d)}}}}
              for _ in range(cfg.num_hidden_layers)]
    return {"embeddings": {"wte": wte,
                           "wpe": mat(cfg.max_position_embeddings, d)},
            "blocks": blocks,
            "final": {"ln": norm(), "head": {"w": wte.T, "b": zeros(vocab)}}}


def shard_view(whole: dict, model: str, l: int, r: int) -> dict:
    """Shard [l, r]'s parameters as views of `whole`'s tensors (no copy):
    every pipeline, oracle and server of one model shares one set."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.models.shard import build_shard_params
    return build_shard_params(
        registry.make_shard_config(model, l, r),
        lambda: whole["embeddings"], lambda b, subs: whole["blocks"][b],
        lambda: whole["final"])


def param_gb(params: dict) -> float:
    """GB of the distinct tensors of a parameter tree (a tied view counts
    once)."""
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t.untyped_storage().data_ptr() not in seen:
            seen.add(t.untyped_storage().data_ptr())
            total += t.untyped_storage().nbytes()
    walk(params)
    return total / 1e9


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()



class RoutingPin:
    """Watches the MoE routing (`parallel/expert.py _routing`) while it is
    entered. `start(True)` begins a record: each call's decision (expert
    [T], gate [T], keep [E, C], kept [E, C]) is kept in `calls`.
    `start(False)` replays the record: each call still computes its own
    routing, adds the tokens it would route otherwise (expert or capacity
    slot) to `rerouted` (a tensor on the card, read once at the end), and
    returns the recorded decision, so two pipelines route alike."""

    def __init__(self):
        from pipeedge_tpu_torch.parallel import expert
        self.module, self.routing = expert, expert._routing
        self.calls, self.i, self.record, self.rerouted = [], 0, True, 0

    def __enter__(self):
        self.module._routing = self._route
        return self

    def __exit__(self, *exc):
        self.module._routing = self.routing

    def start(self, record: bool) -> None:
        if record:
            self.calls = []
        self.record, self.i = record, 0

    def _route(self, router, tokens, n_experts, capacity):
        out = self.routing(router, tokens, n_experts, capacity)
        if self.record:
            self.calls.append(out)
            return out
        want = self.calls[self.i]
        self.i += 1
        self.rerouted = self.rerouted + routed_apart(out, want).sum()
        return want


def routed_apart(a, b) -> torch.Tensor:
    """[T] bool: tokens that two routing decisions send to different
    experts or keep in one and drop in the other."""
    def kept(decision):
        expert, _, keep, ok = decision
        return torch.zeros_like(expert).scatter_add_(
            0, keep.reshape(-1), ok.reshape(-1).to(expert.dtype)) > 0
    return (a[0] != b[0]) | (kept(a) != kept(b))


def routing_split(exact, cut, exact_calls, cut_calls, ubatch: int,
                  seq: int, scale: float) -> dict:
    """The MoE edge's error split at each sequence's first rerouted token
    (module constants): the tokens before it in every microbatch against
    the rest. `exact_calls` / `cut_calls`: the routing of each microbatch
    (one record of a call per block) in the exact forward and the
    forward with the codec at the cut."""
    clean_err, clean, rerouted = 0.0, 0, 0
    for e, c, ec, cc in zip(exact, cut, exact_calls, cut_calls):
        apart = torch.zeros(ubatch * seq, dtype=torch.bool, device=e.device)
        for a, b in zip(ec, cc):
            apart |= routed_apart(a, b)
        rerouted += int(apart.sum())
        after = apart.view(ubatch, seq).int().cummax(dim=1).values.bool()
        err = (c - e).abs().amax(dim=-1)
        clean += int((~after).sum())
        if bool((~after).any()):
            clean_err = max(clean_err, float(err[~after].max()))
    return dict(clean_tokens=clean, clean_rel_err=clean_err / scale,
                rerouted_tokens=rerouted, tokens=len(exact) * ubatch * seq)


def family_forward(model: str, whole: dict, partition, bits, batch: int,
                   ubatch: int, seq: int, dtype, profile: bool = False
                   ) -> dict:
    """The host pipeline (`build_pipeline` over views of `whole`) at the
    edge bits `bits`, each run counted and held against the single-shard
    forward (`measure`); with `profile`, one 8-bit forward microbatch under
    torch.profiler. A routed (MoE) model's quantized runs are also held to
    the stages' forward with the plain codec at the cut (`equal_at_cut`)
    and split at each sequence's first rerouted token (`routing_split`)."""
    from pipeedge_tpu_torch.models import edge_arity, registry
    from pipeedge_tpu_torch.models.shard import shard_apply
    from pipeedge_tpu_torch.ops import clamp, quant
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline

    entry = registry.get_model_entry(model)
    cfg, total = entry.config, registry.get_model_layers(model)
    ids = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, size=(batch, seq))).to("cuda")
    inputs = list(ids.split(ubatch))
    n_mb = len(inputs)
    whole_sc = registry.make_shard_config(model, 1, total)
    views = [shard_view(whole, model, l, r) for l, r in partition]
    routed = bool(cfg.n_experts)
    exact, exact_calls = [], []
    with RoutingPin() as pin:
        for x in inputs:
            pin.start(True)
            exact.append(shard_apply(entry.family.FAMILY, cfg, whole_sc,
                                     whole, x))
            exact_calls.append(pin.calls)
    pipe = build_pipeline(model, partition, device="cuda",
                          quant_bits=[0] * len(partition), dtype=dtype,
                          stage_params=views)
    edge_tensors = sum(edge_arity(r) for _, r in partition[:-1])
    res = {}
    for bit in bits:
        set_edge_bits(pipe, bit)
        torch.cuda.reset_peak_memory_stats()
        res[bit] = measure(pipe, inputs, exact, expected={
            "fused_attention": cfg.num_hidden_layers * n_mb,
            "fused_encode": edge_tensors * n_mb if bit else 0,
            "fused_decode": edge_tensors * n_mb if bit else 0,
            "int8_matmul": 0, "decode_attention": 0},
            expected_shape=[ubatch, seq, cfg.vocab_size])
        res[bit]["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if routed and not bit:
            # each block's routing of microbatch 0: tokens assigned to
            # each expert, tokens kept, the capacity
            res["expert_load"] = [dict(
                assigned=torch.bincount(c[0], minlength=cfg.n_experts)
                .tolist(), kept=c[3].sum(dim=1).tolist(),
                capacity=c[2].shape[1]) for c in exact_calls[0]]
        if not (routed and bit):
            continue
        outs, _ = pipe.run(inputs)
        cut, cut_calls = [], []
        with RoutingPin() as pin:
            for x in inputs:
                pin.start(True)
                data = x
                for i, ((l, r), params) in enumerate(zip(partition, views)):
                    if i:
                        if pipe.stages[i - 1].clamp:
                            data = clamp.clamp_banner2019_laplace(data, bit)
                        data = quant.tensor_decode_outerdim(
                            quant.tensor_encode_outerdim(data, bit))
                    data = shard_apply(entry.family.FAMILY, cfg,
                                       registry.make_shard_config(model, l, r),
                                       params, data)
                cut.append(data)
                cut_calls.append(pin.calls)
        res[bit]["equal_at_cut"] = all(torch.equal(o, c)
                                       for o, c in zip(outs, cut))
        res[bit] |= routing_split(
            exact, cut, exact_calls, cut_calls, ubatch, seq,
            max(float(e.abs().max()) for e in exact))
        del outs, cut, cut_calls
    if profile:
        set_edge_bits(pipe, 8)
        res["profile"] = profile_pass(
            lambda: pipe.run(inputs[:1]),
            f"{model} forward microbatch [{ubatch}, {seq}], 8-bit edge")
    res["inputs"] = inputs
    return res


def check_family_forward(name: str, res: dict, device_name: str) -> None:
    bits = [b for b in res if isinstance(b, int)]
    for bit in bits:
        r = res[bit]
        log(f"{name} forward bit {bit}: " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        if r["shape"] != r["expected_shape"] or not r["finite"]:
            raise AssertionError(f"{name} bit {bit}: logits of shape "
                                 f"{r['shape']}, finite={r['finite']}")
        if r["counts"] != r["expected_counts"]:
            raise AssertionError(f"{name} bit {bit}: launch counts "
                                 f"{r['counts']} != {r['expected_counts']}")
        if bit == 0 and not r["equal"]:
            raise AssertionError(f"{name} bit 0: pipeline logits differ from "
                                 f"the single-shard forward by "
                                 f"{r['max_abs_err']}")
        if bit and "equal_at_cut" in r:     # a routed model (constants)
            if not r["equal_at_cut"] or not r["rel_err"] > 0:
                raise AssertionError(
                    f"{name} bit {bit}: pipeline logits unequal to the "
                    f"forward with the plain codec at the cut, or equal "
                    f"to the exact forward (rel_err {r['rel_err']})")
            if not (r["clean_tokens"] > 0
                    and r["clean_rel_err"] <= LOGIT_BOUND[bit]):
                raise AssertionError(
                    f"{name} bit {bit}: {r['clean_tokens']} tokens before "
                    f"their sequence's first rerouted token, logit error "
                    f"{r['clean_rel_err']} of the logit scale > "
                    f"{LOGIT_BOUND[bit]}")
        elif bit and not 0 < r["rel_err"] <= LOGIT_BOUND[bit]:
            raise AssertionError(f"{name} bit {bit}: logit error "
                                 f"{r['rel_err']} of the logit scale not in "
                                 f"(0, {LOGIT_BOUND[bit]}]")
    if 4 in bits and not res[4]["rel_err"] > res[8]["rel_err"]:
        raise AssertionError(f"{name}: 4-bit logit error not above 8-bit")


def family_decode(model: str, whole: dict, partition, dtype, batch: int,
                  prompt: int, new: int, max_len: int, modes=("fp", "int8"),
                  int8_optin=1, replay: bool = True,
                  profile: bool = False) -> dict:
    """`DecodePipeline.generate` over views of `whole` on an fp and an int8
    cache (`int8_optin`: forced on for Llama, whose steps must not ask
    the gate), timed, the launch counts set to 0 just before each
    generation. With `replay`, the fp cache's prefill and every step run
    again on the generated tokens, each timed and held against the
    forward over the whole sequence (`full_forward`, its kernel-3
    launches counted; `res["full"]`, `res["seq"]`); with `profile`, one
    fp decode step under torch.profiler."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode

    entry = registry.get_model_entry(model)
    cfg = entry.config
    views = [shard_view(whole, model, l, r) for l, r in partition]
    pipes = {mode: decode.DecodePipeline(
        entry.family.FAMILY, cfg, partition, views, max_len=max_len,
        device="cuda", dtype=dtype, cache_bits=8 if mode == "int8" else 0,
        int8_decode_attend=int8_optin if mode == "int8" else 0)
        for mode in modes}
    ids = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, size=(batch, prompt))).to("cuda")
    res, tokens = {}, {}
    for mode, pipe in pipes.items():
        pipe.generate(ids, 2)                   # warm-up (not counted)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.monotonic()
        tokens[mode] = pipe.generate(ids, new)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        res[mode] = dict(
            counts=dict(_build.launch_counts), tok_per_s=batch * new / dt,
            generate_s=dt, shape=list(tokens[mode].shape),
            max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            in_vocab=bool(((tokens[mode] >= 0)
                           & (tokens[mode] < cfg.vocab_size)).all()))
    if not replay:
        return res
    seq = tokens["fp"]
    full, launches = full_forward(model, views, partition, seq)
    pipe = pipes["fp"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, caches = pipe._prefill(ids)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    scale = float(full.abs().max())
    err = float((logits - full[:, :prompt]).abs().max())
    step_ms: dict = {}
    for s in range(1, new):
        pos = prompt + s - 1
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = decode_step(pipe, caches, seq[:, pos], pos)
        torch.cuda.synchronize()
        step_ms.setdefault(pipe._read_len(pos), []).append(
            (time.monotonic() - t0) * 1e3)
        err = max(err, float((out - full[:, pos]).abs().max()))
    res["fp"].update(
        rel_err_vs_full=err / scale, max_abs_err=err, logit_scale=scale,
        finite=bool(torch.isfinite(full).all()), prefill_ms=prefill_ms,
        step_p50_ms={str(b): statistics.median(v)
                     for b, v in sorted(step_ms.items())},
        steps_per_bucket={str(b): len(v) for b, v in sorted(step_ms.items())},
        full_forward_launches=launches, full_forward_tokens=seq.shape[1])
    if profile:
        pos = prompt + new - 1
        res["profile"] = profile_pass(
            lambda: decode_step(pipe, caches, seq[:, pos - 1], pos - 1),
            f"{model} decode step, batch {batch}, pos {pos - 1}, fp cache")
    res["full"], res["seq"] = full, seq
    return res


def full_forward(model: str, views, partition, seq):
    """The forward of `seq` through the stages' views, back to back; its
    kernel-3 launches counted."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.models.shard import shard_apply
    from pipeedge_tpu_torch.ops import _build
    entry = registry.get_model_entry(model)
    _build.reset_launch_counts()
    data = seq
    for (l, r), params in zip(partition, views):
        data = shard_apply(entry.family.FAMILY, entry.config,
                           registry.make_shard_config(model, l, r), params,
                           data)
    torch.cuda.synchronize()
    return data, _build.launch_counts["fused_attention"]


def check_family_decode(name: str, res: dict, bound, expected_launches: int,
                        device_name: str, expected_kernel5: int = 0) -> None:
    for mode in ("fp", "int8"):
        r = res.get(mode)
        if r is None:
            continue
        log(f"{name} decode ({mode}): " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        want = {k: 0 for k in r["counts"]}
        if mode == "int8":
            want["decode_attention"] = expected_kernel5
        if r["counts"] != want:
            raise AssertionError(f"{name} decode ({mode}): launch counts "
                                 f"{r['counts']} != {want}")
        if not r["in_vocab"]:
            raise AssertionError(f"{name} decode ({mode}): token out of "
                                 "the vocabulary")
    fp = res["fp"]
    if "full_forward_launches" not in fp:
        return
    if not fp["finite"]:
        raise AssertionError(f"{name}: the full forward is not finite")
    if fp["full_forward_launches"] != expected_launches:
        raise AssertionError(
            f"{name}: the forward over {fp['full_forward_tokens']} tokens "
            f"launched kernel 3 {fp['full_forward_launches']} times, not "
            f"{expected_launches}")
    if bound is not None and fp["rel_err_vs_full"] > bound:
        raise AssertionError(f"{name}: fp step logits off the full forward "
                             f"by {fp['rel_err_vs_full']} of max |logit| > "
                             f"{bound}")


def family_serve_requests(rng, vocab: int, prefix_ids) -> tuple:
    """Phase 14c's traffic: 2 streamed and 4 plain clients (prompts and
    new tokens drawn from FAMILY_SERVE_PROMPT / FAMILY_SERVE_NEW), then a
    publisher whose prompt is the 128-token prefix (served alone first)
    and 2 sharers whose prompts start with it. Returns (requests, index of
    the publisher)."""
    reqs = []
    for kind in ["stream"] * 2 + ["plain"] * 4:
        length = int(rng.integers(FAMILY_SERVE_PROMPT[0],
                                  FAMILY_SERVE_PROMPT[1] + 1))
        reqs.append({"kind": kind, "ids": rng.integers(
            0, vocab, size=(1, length)).tolist(), "new": int(rng.integers(
                FAMILY_SERVE_NEW[0], FAMILY_SERVE_NEW[1] + 1)), "eos": None})
    first = len(reqs)
    reqs.append({"kind": "publish", "ids": [list(prefix_ids)],
                 "new": FAMILY_SERVE_NEW[0], "eos": None})
    for _ in range(FAMILY_SHARERS):
        n = int(rng.integers(PAGED_SUFFIX[0], PAGED_SUFFIX[1] + 1))
        reqs.append({"kind": "share", "ids": [list(prefix_ids) + rng.integers(
            0, vocab, size=n).tolist()], "new": int(rng.integers(
                FAMILY_SERVE_NEW[0], FAMILY_SERVE_NEW[1] + 1)), "eos": None})
    return reqs, first


def family_serve(card: str, model: str, whole: dict, flags, paged=None,
                 kinds=None, executors=("wave", "stage")) -> dict:
    """The in-process server over views of `whole` (the oracle pipeline
    shares them), each result held to its solo run: with `paged` flags,
    phase 14c's traffic against a dense wave executor that chunks alike;
    without, `kinds` of phase 11's requests against solo `generate`."""
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import registry

    cfg = registry.get_model_config(model)
    flags = flags + ["--device", "cuda"]
    args = serve.parse_args(flags + ["--executor", "wave"])
    views = [shard_view(whole, model, l, r) for l, r in args.partition]
    rng = np.random.default_rng(16)
    prefix_ids = rng.integers(0, cfg.vocab_size,
                              size=SERVE_PREFIX_LEN).tolist()
    oracle = serve.build_pipeline(args, views)
    t0 = time.monotonic()
    if paged is not None:
        reqs, first = family_serve_requests(rng, cfg.vocab_size, prefix_ids)
        want = chunked_oracle(oracle, reqs, PAGED_CHUNK)
        singles = prompt_singles(reqs, PAGED_CHUNK, SERVE_PREFIX_LEN)
    else:
        reqs, first = serve_requests(rng, cfg.vocab_size, kinds), None
        want = serve_oracle(oracle, reqs, prefix_ids)
        singles = 0
    res = {"card": card, "oracle_s": time.monotonic() - t0, "runs": [],
           "prompt_lens": [len(r["ids"][0]) for r in reqs]}
    del oracle
    pipe = serve.build_pipeline(args, views)
    for executor in executors:
        run_args = serve.parse_args(flags + (paged or [])
                                    + ["--executor", executor])
        torch.cuda.reset_peak_memory_stats()
        res["runs"].append(serve_run(
            pipe, run_args, reqs, want, prefix_ids,
            f"{model}, {executor}, {'int8' if args.kv_bits else 'fp'} cache"
            + (", paged" if paged else ""), first=first,
            prompt_singles=singles))
        res["runs"][-1]["max_memory_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        log("family serve run " + json.dumps(res["runs"][-1],
                                             sort_keys=True))
    del pipe
    free_card()
    return res


def check_family_serve(name: str, res: dict, device_name: str,
                       min_hits: int = 0) -> None:
    check_serve_path(res, device_name, entry=False)
    for run in res["runs"]:
        kv = run["kv"]
        if kv is None:
            continue
        pool = kv["pool"]
        if kv["trie_hits"] < min_hits or pool["pages_free"] != \
                pool["pages_total"] or pool["leaked"] \
                or kv["after_traffic"]["leaked"]:
            raise AssertionError(f"{name} ({run['label']}): trie hits "
                                 f"{kv['trie_hits']} (want >= {min_hits}), "
                                 f"pool {pool}")
        log(f"{name} ({run['label']}): kv " + json.dumps(kv))


def family_entries(weights_dir: Path) -> list:
    """The entries on the card as subprocesses, all at once (each its own
    process and CUDA context): generate on the tiny Llama, Mistral and
    MoE (int8 cache; the kernel-5 opt-in set in the environment: launched
    by the GPT-2 family's steps only), and the runtime on the tiny Llama
    at `-q 8,0`."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(FAMILY_TINY) + 1) as pool:
        runs = [pool.submit(generate_tiny_entry, model)
                for model in FAMILY_TINY]
        rt = pool.submit(run_entry, [
            "0", "2", "-m", "pipeedge/test-tiny-llama", "-pt", "1,4,5,8",
            "-q", "8,0", "-b", "16", "-u", "4", "--device", "cuda"], {},
            weights_dir / "runtime_tiny_llama")
        return [run.result() for run in runs] + [dict(rt.result(), rc=0)]


def generate_tiny_entry(model: str) -> dict:
    """`python -m pipeedge_tpu_torch.generate` on one tiny decoder (phase
    14g): its report line, launches and exit code."""
    from pipeedge_tpu_torch.models import registry
    cfg = registry.get_model_config(model)
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.generate", "-m",
           model, "-pt", "1,4,5,8", "-b", "4", "--prompt-len", "16",
           "--new-tokens", str(FAMILY_TINY_NEW), "--kv-bits", "8",
           "--device", "cuda"]
    env = dict(os.environ, PIPEEDGE_INT8_DECODE_ATTEND="1")
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"generate entry ({model}): " + line)
    launches = [json.loads(ln.split("=", 1)[1]) for ln in lines
                if ln.startswith("kernel_launches=")]
    return dict(
        command=" ".join(cmd[1:]), rc=proc.returncode,
        stderr=proc.stderr[-2000:] if proc.returncode else "",
        seconds=time.monotonic() - t0,
        report=[ln for ln in lines if ln.startswith("generated ")],
        counts=launches[0] if launches else None,
        # the warm-up's one step and the timed run's steps
        expected_decode_attention=cfg.num_hidden_layers * FAMILY_TINY_NEW
        if reaches_kernel5(model) else 0)


def check_family_entries(runs: list) -> None:
    for run in runs:
        log("family entry: " + json.dumps(run, sort_keys=True))
        if run["rc"] != 0:
            raise AssertionError(f"{run['command']} exited {run['rc']}: "
                                 f"{run.get('stderr')}")
        if "kernel_launches" in run:          # the runtime
            k = run["kernel_launches"]
            if not (k and len(run["report"]) >= 1) or not (
                    k["fused_attention"] > 0
                    and k["fused_encode"] == k["fused_decode"] > 0):
                raise AssertionError(f"runtime entry: {run}")
        elif len(run["report"]) != 1 or run["counts"] is None or \
                run["counts"]["decode_attention"] != \
                run["expected_decode_attention"]:
            raise AssertionError(f"generate entry: {run}")


def draw_model(model: str, dtype, seed: int) -> tuple:
    """`card_params` of `model` after freeing the card; (params, GB)."""
    free_card()
    t0 = time.monotonic()
    whole = card_params(model, dtype, seed=seed)
    torch.cuda.synchronize()
    gb = param_gb(whole)
    log(f"{model}: {gb:.2f} GB of {str(dtype)[6:]} parameters drawn on "
        f"the card in {time.monotonic() - t0:.1f} s")
    return whole, gb


def llama3_path(card: str, device_name: str, pm) -> dict:
    """Phase 14 a-c: Llama-3-8B (f32) through the host pipeline, the
    decode pipeline and the paged server, each gated."""
    out = {}
    whole, out["llama3_gb"] = draw_model(LLAMA3, torch.float32, 0)
    fwd = family_forward(LLAMA3, whole, FAMILY_PARTITION, (0, 8, 4),
                         *FAMILY_FWD, torch.float32, profile=True)
    check_family_forward(LLAMA3, fwd, device_name)
    out["llama3_forward"] = {k: v for k, v in fwd.items() if k != "inputs"}
    del fwd
    free_card()
    dec = family_decode(LLAMA3, whole, FAMILY_PARTITION, torch.float32,
                        *FAMILY_DECODE, max_len=LLAMA_MAX_LEN, profile=True)
    del dec["full"], dec["seq"]
    check_family_decode(LLAMA3, dec, FAMILY_FP_BOUND, LLAMA_BLOCKS,
                        device_name)
    out["llama3_decode"] = dec
    free_card()
    # phase 24(e): the wave decoder on these weights
    out["llama3_wave"] = llama_wave(whole)
    check_llama_wave(out["llama3_wave"], device_name)
    free_card()
    out["llama3_serve"] = family_serve(card, LLAMA3, whole,
                                       LLAMA_SERVE_FLAGS + pm,
                                       paged=LLAMA_PAGED_FLAGS)
    check_family_serve(LLAMA3, out["llama3_serve"], device_name,
                       min_hits=FAMILY_SHARERS)
    return out


def mistral_path(device_name: str) -> dict:
    """Phase 14d: Mistral-7B (f32) decoding across its window, held to
    the forward over the same tokens (the masked route), and the forward
    at S = window (kernel 3) held to that."""
    from pipeedge_tpu_torch.models import llama, registry
    whole, gb = draw_model(MISTRAL, torch.float32, 1)
    prompt, new = MISTRAL_DECODE
    dec = family_decode(MISTRAL, whole, FAMILY_PARTITION, torch.float32, 1,
                        prompt, new, max_len=prompt + new, modes=("fp",))
    full, seq = dec.pop("full"), dec.pop("seq")
    cfg = registry.get_model_config(MISTRAL)
    fused = llama.fused_route(cfg, seq.shape[1])
    check_family_decode(MISTRAL, dec, FAMILY_FP_BOUND,
                        LLAMA_BLOCKS if fused else 0, device_name)
    w = cfg.sliding_window
    views = [shard_view(whole, MISTRAL, l, r) for l, r in FAMILY_PARTITION]
    at_window, launches = full_forward(MISTRAL, views, FAMILY_PARTITION,
                                       seq[:, :w])
    route_err = float((at_window - full[:, :w]).abs().max()
                      / full[:, :w].abs().max())
    dec["window"] = dict(tokens=w, launches=launches,
                         masked_tokens=seq.shape[1], route_rel_err=route_err)
    log(f"{MISTRAL} window: " + json.dumps(dec["window"]))
    if launches != LLAMA_BLOCKS or route_err > FAMILY_FP_BOUND:
        raise AssertionError(
            f"{MISTRAL}: the forward at S = {w} launched kernel 3 "
            f"{launches} times (want {LLAMA_BLOCKS}); it differs from the "
            f"masked route by {route_err} of max |logit|")
    return {"mistral_gb": gb, "mistral_decode": dec}


def llama2_path(device_name: str) -> dict:
    """Phase 14e: Llama-2-7B (MHA, bf16) generation on fp and int8
    caches."""
    whole, gb = draw_model(LLAMA2, torch.bfloat16, 2)
    dec = family_decode(LLAMA2, whole, FAMILY_PARTITION, torch.bfloat16,
                        *FAMILY_DECODE, max_len=LLAMA_MAX_LEN)
    del dec["full"], dec["seq"]
    check_family_decode(LLAMA2, dec, None, LLAMA_BLOCKS, device_name)
    return {"llama2_gb": gb, "llama2_decode": dec}


def moe_path(card: str, device_name: str, pm) -> dict:
    """Phase 14f: the switch-MoE GPT-2 (f32) through the host pipeline,
    its expert load, int8 generation on kernel 5 held in lockstep to the
    dequantize route under one routing, and the server."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.parallel import decode
    out = {}
    whole, out["moe_gb"] = draw_model(MOE, torch.float32, 3)
    fwd = family_forward(MOE, whole, MOE_PARTITION, (0, 8), *FAMILY_FWD,
                         torch.float32)
    out["moe_expert_load"] = fwd.pop("expert_load")
    check_family_forward(MOE, fwd, device_name)
    log(f"{MOE} expert load per block (microbatch 0): "
        + json.dumps(out["moe_expert_load"]))
    out["moe_forward"] = {k: v for k, v in fwd.items() if k != "inputs"}
    del fwd
    # capacity routing is not causal: a step routes its own 16 tokens, the
    # forward all of them, so the steps are not held to the forward here
    # (the CPU tests hold them to the JAX package's); the kernel route is
    # held to the dequantize route instead, as phase 6 holds GPT-2's
    batch, prompt, new = MOE_DECODE
    dec = family_decode(MOE, whole, MOE_PARTITION, torch.float32, batch,
                        prompt, new, max_len=DECODE_MAX_LEN,
                        int8_optin="auto", replay=False)
    cfg = registry.get_model_config(MOE)
    blocks = cfg.num_hidden_layers
    check_family_decode(MOE, dec, None, 0, device_name,
                        expected_kernel5=blocks * (new - 1))
    views = [shard_view(whole, MOE, l, r) for l, r in MOE_PARTITION]
    pipes = {run: decode.DecodePipeline(
        registry.get_model_entry(MOE).family.FAMILY, cfg, MOE_PARTITION,
        views, max_len=DECODE_MAX_LEN, device="cuda", cache_bits=8,
        int8_decode_attend=optin) for run, optin in (("ii", "auto"),
                                                     ("iii", 0))}
    ids = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, size=(batch, prompt))).to("cuda")
    with RoutingPin() as pin:
        lock, _, _ = lockstep_routes(pipes, ids, new,
                                     torch.cuda.synchronize, pin=pin)
        lock["rerouted_tokens"] = int(pin.rerouted)
    del pipes
    dec["lockstep"] = lock
    log(f"{MOE} lockstep (ii)/(iii): " + json.dumps(
        {**lock, "card": device_name}, sort_keys=True))
    if lock["rel_err"] > DECODE_ROUTE_BOUND or lock["launches_per_step"] \
            != {"ii": [blocks], "iii": [0]}:
        raise AssertionError(
            f"{MOE} (ii) vs (iii): logits differ by {lock['rel_err']} of "
            f"max |logit| (bound {DECODE_ROUTE_BOUND}); kernel launches per "
            f"step {lock['launches_per_step']}")
    out["moe_decode"] = dec
    out["moe_serve"] = family_serve(card, MOE, whole, MOE_SERVE_FLAGS + pm,
                                    kinds=["plain"] * MOE_SERVE,
                                    executors=("wave",))
    check_family_serve(MOE, out["moe_serve"], device_name)
    return out


@contextlib.contextmanager
def cut_llama_depth():
    """Llama-3-8B, Llama-2-7B and Mistral-7B at LLAMA_BLOCKS blocks, full
    width, in this process's registry for the time of the block: every
    pipeline, oracle and in-process server built from their names takes
    that depth. Phase 14's subprocesses run the tiny models only."""
    import dataclasses
    from pipeedge_tpu_torch.models import registry
    saved = {m: registry.get_model_entry(m) for m in (LLAMA3, LLAMA2,
                                                      MISTRAL)}
    for m, e in saved.items():
        registry._MODELS[m] = dataclasses.replace(
            e, layers=4 * LLAMA_BLOCKS, config=dataclasses.replace(
                e.config, num_hidden_layers=LLAMA_BLOCKS))
    try:
        yield
    finally:
        registry._MODELS.update(saved)


def families_path(card: str, device_name: str,
                  weights_dir: Path = ROOT / "pipeedge_tpu_torch" / "_build",
                  alongside=None) -> dict:
    """Phase 14 (module docstring), gated as it goes; each model is freed
    before the next is drawn. Returns what the kernels line and PERF.md
    read. `alongside`, a callable, runs beside (g)'s entries (phase 15a,
    whose results, like (g)'s, read no rate); its result is
    `out["alongside"]`."""
    from concurrent.futures import ThreadPoolExecutor
    pm = ["--postmortem-dir", str(weights_dir / "postmortems")]
    t0 = time.monotonic()
    out = {}

    def entries():
        with ThreadPoolExecutor(1) as pool:
            beside = None if alongside is None else pool.submit(alongside)
            res = {"entries": family_entries(weights_dir)}
            if beside is not None:
                res["alongside"] = beside.result()
        return res

    for name, run in (("a-c", lambda: llama3_path(card, device_name, pm)),
                      ("d", lambda: mistral_path(device_name)),
                      ("e", lambda: llama2_path(device_name)),
                      ("f", lambda: moe_path(card, device_name, pm)),
                      ("g", entries)):
        with cut_llama_depth():
            out |= run()
        free_card()
        log(f"phase 14{name}: {time.monotonic() - t0:.1f} s (memory "
            f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    check_family_entries(out["entries"])
    log("phase 14 summary: " + json.dumps(
        family_summary(out) | {"card": card, "device": device_name}))
    return out


def family_summary(out: dict) -> dict:
    """Phase 14's numbers in one line: GB drawn, items/s, tokens/s,
    prefill ms, step p50 per bucket, launches and device ms of the
    profiled step and microbatch, peak memory."""
    def dec(key):
        d = out[key]
        return {mode: {k: d[mode].get(k) for k in (
            "tok_per_s", "prefill_ms", "step_p50_ms", "max_memory_gb",
            "rel_err_vs_full")} for mode in ("fp", "int8") if mode in d}

    def prof(p):
        return None if p is None else {k: p[k] for k in (
            "wall_ms", "device_ms", "device_busy_share", "kernel_launches")}

    fwd = out["llama3_forward"]
    return {
        "gb": {k: out[k] for k in ("llama3_gb", "mistral_gb", "llama2_gb",
                                   "moe_gb")},
        "llama3_forward": {bit: {k: fwd[bit][k] for k in (
            "items_per_s", "p50_ms", "rel_err", "max_memory_gb")}
            for bit in (0, 8, 4)},
        "llama3_forward_profile": prof(fwd.get("profile")),
        "llama3_decode": dec("llama3_decode"),
        "llama3_step_profile": prof(out["llama3_decode"].get("profile")),
        "llama3_serve": [{k: r[k] for k in (
            "label", "tok_per_s", "latency_ms_p50", "latency_ms_p95",
            "first_token_ms_p50", "max_memory_gb")}
            for r in out["llama3_serve"]["runs"]],
        "mistral_decode": dec("mistral_decode")
        | {"window": out["mistral_decode"]["window"]},
        "llama2_decode": dec("llama2_decode"),
        "moe_forward": {bit: {k: out["moe_forward"][bit].get(k) for k in (
            "items_per_s", "rel_err", "clean_rel_err", "clean_tokens",
            "rerouted_tokens")} for bit in (0, 8)},
        "moe_decode": dec("moe_decode"),
        "moe_lockstep": {k: out["moe_decode"]["lockstep"][k] for k in (
            "rel_err", "rerouted_tokens", "step_p50_ms")},
        "moe_serve_tok_per_s": out["moe_serve"]["runs"][0]["tok_per_s"],
        "entries_s": [round(r["seconds"], 1) for r in out["entries"]]}


# --- phase 15: the rest of PipeEdge's loop and the replica router ----------

BUILD_DIR = ROOT / "pipeedge_tpu_torch" / "_build"
H100_PROFILES = ROOT / "pipeedge_tpu_torch" / "profiles" / "h100"
REVAUCT_SCHEDULERS = ("latency_ordered", "throughput_ordered")
TRACE_ROUNDS = 2
TRACE_ARGV = ["-pt", "1,21,22,48", "-q", "8,0", "-b", str(BATCH),
              "-u", str(UBATCH), "--measure-rounds", str(TRACE_ROUNDS)]
# requests, rows, prompt, new tokens: a 240-token prompt and 24 new tokens
# (192 and 72 until PR 17, 192 and 128 before phase 19 was added), for the
# script's time; the decode still crosses from the 256-row attend bucket
# into the 512-row one (at its 17th token)
CONCURRENT = (4, 4, 240, 24)
# sampled, so the concurrent requests differ: request r draws with seed r
# and is held to the solo run with `--seed r`
CONCURRENT_SAMPLING = ["--temperature", "0.8", "--top-k", "40"]
SCHED_GEN_HOSTS = 2               # the -sm generate run's devices.yml
ROUTER_PAGED = ["--kv-pages", "1024", "--kv-page-size", "16"]
ROUTER_PREFIX_LEN = 256
ROUTER_CLIENTS = (8, 4)           # prefix sharers, plain requests
ROUTER_BURST = 16
ROUTER_NEW = (16, 32)             # new tokens of the burst's requests
ROUTER_POLL = "0.25"


def revauct_cli(scheduler: str) -> dict:
    """`python -m pipeedge_tpu_torch.revauct` for ViT-Large over the card's
    profiles as a subprocess; returns its schedule (1-based, data-host
    entry dropped)."""
    from pipeedge_tpu_torch.sched import miniyaml
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.revauct", "0",
           str(len(SCHED_HOSTS)), "-m", SCHED_MODEL, "-u", str(UBATCH),
           "--seed", "0", "-sch", scheduler,
           "-sm", str(H100_PROFILES / "models.yml"),
           "-sdt", str(H100_PROFILES / "device_types.yml"),
           "-sd", str(H100_PROFILES / "devices.yml"),
           "-sdnw", str(H100_PROFILES / "device_neighbors_world.yml")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr[-2000:]}")
    sched = miniyaml.loads(proc.stdout)
    return dict(scheduler=scheduler, yaml=proc.stdout,
                seconds=time.monotonic() - t0,
                stages=[tuple(lr) for part in sched
                        for lr in part.values() if lr],
                hosts=[h for part in sched for h, lr in part.items() if lr])


def revauct_path() -> dict:
    """Phase 15a: the reverse auction over the card's profiles, each
    schedule run by the runtime entry (raw edges), its saved logits held
    to the single-shard forward. The two schedulers' CLIs, then their
    entries, run side by side (their results do not depend on timing; no
    rate is read from them)."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import registry
    model = SCHED_MODEL
    total = registry.get_model_layers(model)
    weights = BUILD_DIR / f"{model.replace('/', '_')}-init-seed0.npz"
    inputs, _ = runtime.load_batches(model, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    want = [e.cpu().numpy() for e in
            single_shard_logits(model, weights, inputs, "cuda")]
    blocks = registry.get_model_config(model).num_hidden_layers
    with ThreadPoolExecutor(len(REVAUCT_SCHEDULERS)) as pool:
        runs = list(pool.map(revauct_cli, REVAUCT_SCHEDULERS))
        for run in runs:
            runtime.validate_partition(run["stages"], total)

        def entry(run):
            saved = BUILD_DIR / f"revauct_{run['scheduler']}.npz"
            e = run_entry(
                ["0", str(len(run["stages"])), "-m", model, "-M",
                 str(weights), "-pt",
                 ",".join(f"{l},{r}" for l, r in run["stages"]),
                 "-b", str(BATCH), "-u", str(UBATCH), "--save-results",
                 str(saved)], {}, BUILD_DIR / f"monitor_{run['scheduler']}")
            e["expected"] = {"fused_attention": blocks * len(inputs),
                             "fused_encode": 0, "fused_decode": 0}
            return e, saved
        entries = list(pool.map(entry, runs))
    for run, (e, saved) in zip(runs, entries):
        with np.load(saved) as z:
            got = [z[f"arr_{i}"] for i in range(len(z.files))]
        run["entry"] = e
        run["equal"] = len(got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want))
        run["max_abs_err"] = max((float(np.abs(g - w).max())
                                  for g, w in zip(got, want)
                                  if g.shape == w.shape), default=None)
    return {"runs": runs}


def check_revauct_path(res, device_name: str) -> None:
    for run in res["runs"]:
        log(f"revauct {run['scheduler']}: " + json.dumps(
            {k: run[k] for k in ("stages", "hosts", "seconds", "equal",
                                 "max_abs_err")} | {"card": device_name}))
        check_entry(f"revauct {run['scheduler']}", run["entry"])
        if not run["equal"]:
            raise AssertionError(f"revauct {run['scheduler']}: bit 0 differs "
                                 "from the single-shard forward by "
                                 f"{run['max_abs_err']}")


def trace_kernels(trace_file: Path) -> dict:
    """Device kernel events of a `--trace` Chrome trace, counted by name."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    counts: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def tracing_path() -> dict:
    """Phase 15b: the runtime entry on ViT-Base without `--trace` in this
    process (`run_entry_here`), and with `--trace` and `--trace-spans` as
    a process of its own (no profiler session of this script is open
    there); the trace's device kernels and the spans."""
    import shutil
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.telemetry import chrome_trace
    from pipeedge_tpu_torch.utils import tracing
    weights = BUILD_DIR / f"{MODEL.replace('/', '_')}-init-seed0.npz"
    trace_dir = BUILD_DIR / "trace_vitb"
    spans_file = BUILD_DIR / "spans_vitb.json"
    shutil.rmtree(trace_dir, ignore_errors=True)
    spans_file.unlink(missing_ok=True)
    base = ["0", "2", "-m", MODEL, "-M", str(weights), *TRACE_ARGV]
    res = {"plain": run_entry_here(base, BUILD_DIR / "monitor")}
    res["traced"] = run_entry(base + ["--trace", str(trace_dir),
                                      "--trace-spans", str(spans_file)],
                              {}, BUILD_DIR / "monitor")
    trace_file = trace_dir / tracing.TRACE_FILE
    res["trace_written"] = trace_file.exists()
    res["trace_mb"] = (trace_file.stat().st_size / 2**20
                       if res["trace_written"] else None)
    res["trace_kernels"] = (trace_kernels(trace_file)
                            if res["trace_written"] else {})
    with open(spans_file) as f:
        spans = chrome_trace.trace_to_spans(json.load(f))
    res["spans"] = {}
    for s in spans:
        res["spans"][s["cat"]] = res["spans"].get(s["cat"], 0) + 1
    res["stage_names"] = sorted({s["name"] for s in spans
                                 if s["cat"] == "stage"})
    n_mb = TRACE_ROUNDS * BATCH // UBATCH
    res["microbatches"] = n_mb
    # ViT-Base cut after sublayer 21: a two-tensor 8-bit edge
    blocks = registry.get_model_config(MODEL).num_hidden_layers
    for key in ("plain", "traced"):
        res[key]["expected"] = {"fused_attention": blocks * n_mb,
                                "fused_encode": 2 * n_mb,
                                "fused_decode": 2 * n_mb}
    return res


def check_tracing_path(res, device_name: str) -> None:
    n_mb = res["microbatches"]
    for key in ("plain", "traced"):
        check_entry(f"tracing {key}", res[key])
    log("tracing: " + json.dumps({
        "items_per_s_plain": res["plain"]["steady_items_per_s"],
        "items_per_s_traced": res["traced"]["steady_items_per_s"],
        "trace_mb": res["trace_mb"], "spans": res["spans"],
        "trace_kernels": {k: v for k, v in res["trace_kernels"].items()
                          if "pe_" in k},
        "card": device_name}))
    if not res["trace_written"]:
        raise AssertionError("tracing: --trace wrote no trace.json (was a "
                             "profiler session already open?)")
    names = " ".join(res["trace_kernels"])
    missing = [k for k in ("pe_attention_mma_kernel", "pe_encode_kernel",
                           "pe_decode_kernel") if k not in names]
    if missing:
        raise AssertionError(f"tracing: the trace's device events name "
                             f"none of {missing}")
    want = {"stage": 2 * n_mb, "results": n_mb}
    if res["spans"] != want or res["stage_names"] != ["stage0", "stage1"]:
        raise AssertionError(f"tracing: spans {res['spans']} "
                             f"({res['stage_names']}), expected {want} and "
                             "no wire span")


def generate_flags_path() -> dict:
    """Phase 15c: generate's `--concurrent` (int8 cache, kernel 5, sampled
    with a seed per request) against solo runs, `--monitor`'s decode.csv,
    and `-sm/-sdt/-sd` over profiles the port's profiler makes here."""
    import contextlib
    import io
    import tempfile
    from pipeedge_tpu_torch import generate, profiler
    from pipeedge_tpu_torch import profiler_results_to_device_types as to_types
    from pipeedge_tpu_torch import profiler_results_to_models as to_models
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode
    from pipeedge_tpu_torch.sched import yaml_files
    model = DECODE_MODEL
    cfg = registry.get_model_config(model)
    weights = BUILD_DIR / f"{model.replace('/', '_')}-random-seed0.npz"
    n_req, rows, prompt, new = CONCURRENT
    common = ["-m", model, "-M", str(weights), "-b", str(rows),
              "--prompt-len", str(prompt), "--max-len", str(DECODE_MAX_LEN)]
    res: dict = {}
    env_key = "PIPEEDGE_INT8_DECODE_ATTEND"
    old = os.environ.get(env_key)
    os.environ[env_key] = "1"
    try:
        argv = common + ["-pt", "1,24,25,48", "--kv-bits", "8",
                         "--new-tokens", str(new), *CONCURRENT_SAMPLING]
        # the solo runs on one pipeline built as the entry builds it
        gen_args = generate.parse_args(argv)
        pipe = decode.build_decode_pipeline(
            model, gen_args.partition, max_len=DECODE_MAX_LEN,
            cache_bits=8, attend_floor=gen_args.attend_floor,
            model_file=str(weights), device="cuda")
        ids = generate.prompt_ids(gen_args, cfg)
        solos = [pipe.generate(ids, new, temperature=gen_args.temperature,
                               top_k=gen_args.top_k, seed=r).cpu().numpy()
                 for r in range(n_req)]
        del pipe
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.monotonic()
        many = generate.main(argv + ["--concurrent", str(n_req)])
        res["concurrent_s"] = time.monotonic() - t0
        counts = dict(_build.launch_counts)
        # the warm-up batch and the timed one: each request's first token
        # comes from its prefill, each later one from a decode wave
        waves = 2 * n_req * (new - 1)
        blocks = cfg.num_hidden_layers
        res["concurrent"] = dict(
            shape=list(many.shape), counts=counts, decode_waves=waves,
            launches_per_wave=counts["decode_attention"] / waves,
            expected=blocks * waves,
            equal=len(many) == n_req and all(
                np.array_equal(m, solo) for m, solo in zip(many, solos)),
            distinct=len({m.tobytes() for m in many}))
        with tempfile.TemporaryDirectory(prefix="monitor_",
                                         dir=BUILD_DIR) as tmp:
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                generate.main(argv + ["--monitor"])
            finally:
                os.chdir(cwd)
            with open(Path(tmp) / "decode.csv") as f:
                res["monitor_rows"] = len(f.read().splitlines()) - 1
        res["monitor_expected"] = new - 1
    finally:
        if old is None:
            os.environ.pop(env_key)
        else:
            os.environ[env_key] = old
    # -sm/-sdt/-sd over the card's own profile of the model
    prof_dir = BUILD_DIR / "gen_sched"
    prof_dir.mkdir(parents=True, exist_ok=True)
    results = prof_dir / "profiler_results.yml"
    results.unlink(missing_ok=True)     # the profiler adds to a file
    t0 = time.monotonic()
    profiler.main(["-m", model, "-M", str(weights), "-b", str(rows),
                   "-t", "float32", "-o", str(results)])
    res["profile_s"] = time.monotonic() - t0
    files = {"-sm": prof_dir / "models.yml", "-sdt": prof_dir /
             "device_types.yml", "-sd": prof_dir / "devices.yml"}
    for f in files.values():
        f.unlink(missing_ok=True)
    to_models.main(["-i", str(results), "-o", str(files["-sm"])])
    mem_mib = torch.cuda.get_device_properties(0).total_memory // 2**20
    to_types.main([SCHED_DEV_TYPE, "-i", str(results),
                   "-o", str(files["-sdt"]), "-dtm", str(mem_mib),
                   "-dtb", str(NVLINK_MBPS)])
    yaml_files.yaml_save({SCHED_DEV_TYPE: SCHED_HOSTS[:SCHED_GEN_HOSTS]},
                         str(files["-sd"]))
    argv = common + ["--new-tokens", "8"]
    for flag, path in files.items():
        argv += [flag, str(path)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res["scheduled_partition"] = generate.scheduled_partition(
            generate.parse_args(argv))
        out = generate.main(argv)
    res["scheduled_output"] = buf.getvalue().splitlines()
    res["scheduled_shape"] = list(out.shape)
    res["scheduled_expected_shape"] = [rows, prompt + 8]
    res["total"] = registry.get_model_layers(model)
    return res


def check_generate_flags_path(res, device_name: str) -> None:
    conc = res["concurrent"]
    log("generate --concurrent: " + json.dumps(conc | {
        "seconds": res["concurrent_s"], "card": device_name}))
    if not conc["equal"] or conc["distinct"] != CONCURRENT[0] or \
            conc["counts"]["decode_attention"] != conc["expected"]:
        raise AssertionError(f"--concurrent: requests equal solo runs: "
                             f"{conc['equal']}; distinct requests "
                             f"{conc['distinct']} of {CONCURRENT[0]}; "
                             f"kernel-5 launches "
                             f"{conc['counts']['decode_attention']} != "
                             f"{conc['expected']}")
    if res["monitor_rows"] != res["monitor_expected"]:
        raise AssertionError(f"--monitor: decode.csv has "
                             f"{res['monitor_rows']} rows, not "
                             f"{res['monitor_expected']}")
    part = [tuple(p) for p in res["scheduled_partition"]]
    log("generate -sm partition: " + json.dumps(
        {"partition": part, "profile_s": res["profile_s"],
         "lines": [ln for ln in res["scheduled_output"]
                   if ln.startswith(("scheduler partition", "generated"))],
         "card": device_name}))
    from pipeedge_tpu_torch import runtime
    runtime.validate_partition(part, res["total"])
    if any((l - 1) % 4 or r % 4 for l, r in part) or \
            res["scheduled_shape"] != res["scheduled_expected_shape"]:
        raise AssertionError(f"-sm: partition {part} not block-aligned, or "
                             f"output {res['scheduled_shape']}")


class RouterProc:
    """`python -m pipeedge_tpu_torch.serve --role router ...` as a
    subprocess: its output kept, its port read from its serving line;
    `close()` stops it (SIGTERM, then SIGKILL of it and of every replica
    pid it reported)."""

    def __init__(self, argv, timeout: float = 300):
        import queue
        import threading
        self.cmd = [sys.executable, "-m", "pipeedge_tpu_torch.serve",
                    "--role", "router", "--port", "0",
                    "--router-poll-interval", ROUTER_POLL, *argv]
        self.proc = subprocess.Popen(
            self.cmd, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        self.lines: list = []
        self.replica_pids: set = set()
        q: "queue.Queue" = queue.Queue()

        def pump():
            for ln in self.proc.stdout:
                self.lines.append(ln.rstrip())
                q.put(ln)
        self.reader = threading.Thread(target=pump, daemon=True)
        self.reader.start()
        t0 = time.monotonic()
        while True:
            ln = q.get(timeout=max(1.0, timeout - (time.monotonic() - t0)))
            if ln.startswith("serving router"):
                self.port = int(ln.rsplit(":", 1)[1])
                break
        self.ready_s = time.monotonic() - t0

    def health(self) -> dict:
        h = http_json(self.port, "/healthz", timeout=30)
        for rec in (h.get("workers") or {}).values():
            self.replica_pids.add(rec["pid"])
        return h

    def close(self) -> int:
        import signal
        try:
            self.proc.send_signal(signal.SIGTERM)
            rc = self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            for pid in self.replica_pids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        self.reader.join(timeout=10)
        return rc

    def touches_card(self) -> bool:
        """Whether the router process holds a GPU device file open (a
        CUDA context does): it must not, being model-free."""
        fd_dir = Path(f"/proc/{self.proc.pid}/fd")
        targets = []
        for fd in fd_dir.iterdir():
            try:
                targets.append(os.readlink(fd))
            except OSError:        # closed while listing
                pass
        return any(t.startswith("/dev/nvidia") for t in targets)

    def replicas_gone(self) -> bool:
        return all(not Path(f"/proc/{p}").exists()
                   or Path(f"/proc/{p}/stat").read_text().split()[2] == "Z"
                   for p in self.replica_pids)


def wait_until(pred, timeout: float, step: float = 0.1) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def router_adopt_path() -> dict:
    """Phase 15d: two replicas as in-process servers (paged fp KV) behind
    the router entry (`--replica-addrs`): clients held to solo runs, the
    launches per served request, the drain's prefix migration into the
    survivor's trie, both pools whole after. Then a direct check of the
    ship codec at 8 bits (kernels 1 and 2) on the survivor's prefix rows:
    no entry ships quantized KV (the drain ships exact frames), so these
    launches are the codec's at KV shapes, not a path's."""
    import threading
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.kv import ship
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.ops import quant as quant_ops
    model, prefix_len = DECODE_MODEL, ROUTER_PREFIX_LEN
    cfg = registry.get_model_config(model)
    weights = BUILD_DIR / f"{model.replace('/', '_')}-random-seed0.npz"
    base = SERVE_FLAGS + ["-M", str(weights), "--kv-bits", "0",
                          "--postmortem-dir", str(BUILD_DIR / "postmortems")]
    args = serve.parse_args(base + ROUTER_PAGED + ["--role", "replica"])
    params = [registry.module_shard_factory(
        model, str(weights), l, r, stage=i, device="cuda")[1]
        for i, (l, r) in enumerate(args.partition)]
    rng = np.random.default_rng(15)
    prefix_ids = rng.integers(0, cfg.vocab_size, size=prefix_len).tolist()
    reqs = serve_requests(rng, cfg.vocab_size, ["prefix"] * ROUTER_CLIENTS[0]
                          + ["plain"] * ROUTER_CLIENTS[1])
    # the prefix alone first (phase 12's publisher): its pages enter the
    # trie, so every sharer's prompt pass is the span over its suffix
    # that the oracle's prefix handle runs
    publisher = {"kind": "publish", "ids": [list(prefix_ids)],
                 "new": SERVE_NEW[0], "eos": None}
    oracle = serve.build_pipeline(serve.parse_args(base), params)
    want = serve_oracle(oracle, reqs + [publisher], prefix_ids)
    reps, router = [], None
    res: dict = {}
    try:
        for _ in range(2):
            service = serve.make_service(args, serve.build_pipeline(
                args, params))
            httpd = serve.Server(("127.0.0.1", 0),
                                 serve.make_handler(service, model))
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            reps.append((service, httpd))
        router = RouterProc(["--replica-addrs", ",".join(
            f"127.0.0.1:{h.server_address[1]}" for _, h in reps)])
        res["router_ready_s"] = router.ready_s
        port = router.port
        pid = http_json(port, "/prefix", {"ids": prefix_ids})["prefix_id"]
        out: dict = {}
        start = threading.Event()
        threads = [threading.Thread(target=serve_client,
                                    args=(port, i, r, pid, start, out))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        alone = threading.Event()
        alone.set()
        serve_client(port, len(reqs), publisher, pid, alone, out)
        reqs = reqs + [publisher]
        start.set()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        res["counts"] = counts
        res["per_request"] = {k: v / len(reqs) for k, v in counts.items()}
        res["errors"] = {i: o["error"] for i, o in out.items()
                         if "error" in o}
        res["mismatched"] = sorted(
            i for i in range(len(reqs)) if "ids" not in out.get(i, {})
            or not np.array_equal(np.asarray(out[i]["ids"]), want[i]))
        wall = max(o["t1"] for o in out.values()) - min(
            o["t0"] for o in out.values())
        res["wall_s"] = wall
        kvs = [s.kv_backend for s, _ in reps]
        probe = prefix_ids + [0]
        owner = next(i for i, kv in enumerate(kvs)
                     if kv.shared_prompt_tokens(probe) >= prefix_len)
        survivor = 1 - owner
        res["survivor_before"] = kvs[survivor].shared_prompt_tokens(probe)
        res["drain"] = http_json(port, "/drain", {"replica": f"r{owner}"})
        res["survivor_after"] = kvs[survivor].shared_prompt_tokens(probe)
        ex = reps[survivor][0].batcher
        steps0 = dict(ex.kind_steps[0])
        hits0 = kvs[survivor].trie.stats()["hits"]
        last = serve_requests(rng, cfg.vocab_size, ["prefix"])[0]
        got = http_json(port, "/generate", {"ids": last["ids"],
                                            "new_tokens": last["new"],
                                            "prefix_id": pid})
        res["after_drain_equal"] = bool(np.array_equal(
            np.asarray(got["ids"]), serve_oracle(oracle, [last],
                                                 prefix_ids)[0]))
        res["survivor_span"] = ex.kind_steps[0]["span"] - steps0["span"]
        res["survivor_prefill"] = (ex.kind_steps[0]["prefill"]
                                   - steps0["prefill"])
        res["trie_hits"] = kvs[survivor].trie.stats()["hits"] - hits0
        res["states"] = {n: r["state"] for n, r in
                         router.health()["fleet"].items()}
        res["router_touches_card"] = router.touches_card()

        def whole(kv):
            pool, trie = kv.pool.stats(), kv.trie.stats()
            return (pool["pages_free"] + trie["pages_cached"]
                    == pool["pages_total"] and pool["owners"] == 0
                    and pool["leaked"] == 0)
        res["pools_whole"] = wait_until(lambda: all(whole(kv) for kv in kvs),
                                        30)
        res["pools"] = [dict(kv.pool.stats(), cached=kv.trie.stats()[
            "pages_cached"]) for kv in kvs]
        # the ship codec at 8 bits on the survivor's prefix rows, called
        # directly (the drain above shipped exact frames)
        pids = kvs[survivor].trie.lookup(probe, max_tokens=prefix_len)
        try:
            table = np.asarray([pids], np.int64)
            caches = [kvs[survivor].pool.gather(i, table)
                      for i in range(len(args.partition))]
        finally:
            kvs[survivor].pool.release(pids)
        _build.reset_launch_counts()
        frames = ship.encode_kv_ship(caches, prefix_len,
                                     np.zeros((1, 1), np.float32), bits=8)
        handle = ship.decode_kv_ship(frames, torch.float32, device="cuda")
        res["ship_counts"] = dict(_build.launch_counts)
        res["ship_expected"] = 2 * len(caches)
        res["ship_mb"] = sum(f.nbytes for f in frames) / 2**20
        equal, err = True, 0.0
        at = 2
        for i, cache in enumerate(caches):
            at += 1                          # the stage frame's header
            for name in ("k", "v"):
                rows = cache[name][:, :, :prefix_len]
                plain = quant_ops.tensor_encode_outerdim(rows, 8)
                words, scale, shift = frames[at:at + 3]
                equal &= bool(np.array_equal(words, quant_ops.words_u32(
                    plain)) and np.array_equal(scale, plain.scale.cpu()
                                               .numpy())
                    and np.array_equal(shift, plain.shift.cpu().numpy()))
                dec = handle["stage_rows"][i][name]
                equal &= bool(torch.equal(
                    dec, quant_ops.tensor_decode_outerdim(plain)))
                err = max(err, float((dec - rows).abs().max()))
                at += 4
        res["ship_equal_plain"] = equal
        res["ship_max_abs_err"] = err
        # the codec at the ship's shape: one stage's K rows
        from pipeedge_tpu_torch.ops import fused_quant
        rows = caches[0]["k"][:, :, :prefix_len].contiguous()
        enc = fused_quant.fused_encode_outerdim(rows, 8)
        shape = list(rows.shape)
        res["ship_codec"] = dict(
            shape=shape,
            encode_ms=time_ms(
                lambda: fused_quant.fused_encode_outerdim(rows, 8)),
            plain_encode_ms=time_ms(
                lambda: quant_ops.tensor_encode_outerdim(rows, 8)),
            decode_ms=time_ms(
                lambda: fused_quant.fused_decode_outerdim(enc)),
            plain_decode_ms=time_ms(
                lambda: quant_ops.tensor_decode_outerdim(enc)),
            bound_ms=codec_bytes(shape, 8) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
    finally:
        if router is not None:
            res["router_rc"] = router.close()
        for service, httpd in reps:
            httpd.shutdown()
            httpd.server_close()
            service.stop()
    del oracle, reps
    free_card()
    return res


def check_router_adopt_path(res, device_name: str) -> None:
    log("router adopt: " + json.dumps(res | {"card": device_name},
                                      sort_keys=True, default=str))
    problems = []
    if res["errors"] or res["mismatched"] or not res["after_drain_equal"]:
        problems.append(f"errors {res['errors']}, mismatched "
                        f"{res['mismatched']}, after drain "
                        f"{res['after_drain_equal']}")
    if not (res["drain"].get("drained") and res["drain"].get(
            "migrated_prefixes", 0) >= 1 and res["survivor_before"] == 0
            and res["survivor_after"] >= ROUTER_PREFIX_LEN
            and res["survivor_span"] == 1 and res["survivor_prefill"] == 0
            and res["trie_hits"] > 0):
        problems.append("drain migration: " + json.dumps(
            {k: res[k] for k in ("drain", "survivor_before",
                                 "survivor_after", "survivor_span",
                                 "survivor_prefill", "trie_hits")}))
    if not res["pools_whole"]:
        problems.append(f"pools not whole: {res['pools']}")
    ship = res["ship_counts"]
    if not res["ship_equal_plain"] or ship["fused_encode"] != \
            res["ship_expected"] or ship["fused_decode"] != \
            res["ship_expected"]:
        problems.append(f"ship codec check at 8 bits: equal to the plain "
                        f"codec {res['ship_equal_plain']}, launches {ship}")
    if res.get("router_rc") != 0 or res["router_touches_card"]:
        problems.append(f"router exited {res.get('router_rc')}, holds a "
                        f"GPU device file: {res['router_touches_card']}")
    if problems:
        raise AssertionError("router adopt: " + "; ".join(problems))


def stream_client(port: int, i: int, body: dict, start, out: dict) -> None:
    """One streamed request through the router, timestamped at its first
    step line and at its end (client side)."""
    import urllib.request
    start.wait()
    t0 = time.monotonic()
    first = None
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(dict(body, stream=True)).encode())
        lines = []
        with urllib.request.urlopen(req, timeout=600) as resp:
            for raw in resp:
                if not raw.strip():
                    continue
                if first is None:
                    first = time.monotonic()
                lines.append(json.loads(raw))
        out[i] = dict(ids=lines[-1].get("ids"), final=lines[-1],
                      steps=len(lines) - 1)
    except Exception as exc:   # noqa: BLE001 — the check reports it
        out[i] = dict(error=repr(exc))
    out[i].update(t0=t0, t_first=first, t1=time.monotonic())


def router_spawn_path() -> dict:
    """Phase 15e: the router entry spawning two int8 replicas; one is
    SIGKILLed in the middle of a burst of streamed requests: none lost,
    each equal to its solo int8 run (kernel 5, in this process, while the
    respawned replica starts), the dead replica respawned with the next
    epoch and readmitted."""
    import signal
    import threading
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import registry
    cfg = registry.get_model_config(DECODE_MODEL)
    weights = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    base = SERVE_FLAGS + ["-M", str(weights), "--kv-bits", "8",
                          "--postmortem-dir", str(BUILD_DIR / "postmortems")]
    rng = np.random.default_rng(16)
    reqs = []
    for _ in range(ROUTER_BURST):
        length = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        reqs.append({"ids": rng.integers(0, cfg.vocab_size,
                                         size=(1, length)).tolist(),
                     "new": int(rng.integers(ROUTER_NEW[0],
                                             ROUTER_NEW[1] + 1))})
    res: dict = {}
    router = RouterProc(["--replicas", "2", *base], timeout=600)
    try:
        res["ready_s"] = router.ready_s
        port = router.port
        wait_until(lambda: all(r["state"] == "healthy" for r in
                               router.health()["fleet"].values()), 60)
        before = router.health()["workers"]
        out: dict = {}
        start = threading.Event()
        threads = [threading.Thread(target=stream_client, args=(
            port, i, {"ids": r["ids"], "new_tokens": r["new"]}, start, out))
            for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        start.set()
        # mid-burst: once the first request finished (or 1 s passed)
        wait_until(lambda: any("t1" in o for o in list(out.values())), 1.0,
                   step=0.02)
        victim = before["0"]["pid"]
        os.kill(victim, signal.SIGKILL)
        t_kill = time.monotonic()
        res["killed_after_s"] = t_kill - t0
        res["finished_before_kill"] = sum("t1" in o for o in
                                          list(out.values()))
        for t in threads:
            t.join()
        res["burst_s"] = max(o["t1"] for o in out.values()) - t0

        def solo_runs():
            """The solo int8 runs, in this process on kernel 5, while the
            respawned replica starts (for the script's time)."""
            oracle = serve.build_pipeline(serve.parse_args(base))
            want = [oracle.generate(torch.as_tensor(r["ids"], device="cuda"),
                                    r["new"]).cpu().numpy() for r in reqs]
            del oracle
            return want

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(1) as pool:
            solo = pool.submit(solo_runs)
            res["readmitted"] = wait_until(
                lambda: (router.health()["workers"]["0"]["epoch"] == 1
                         and router.health()["fleet"]["r0"]["state"]
                         == "healthy"), 180, step=0.25)
            res["readmit_s"] = time.monotonic() - t_kill
            wants = solo.result()
        after = router.health()
        res["epochs"] = {k: v["epoch"] for k, v in after["workers"].items()}
        res["states"] = {k: v["state"] for k, v in after["fleet"].items()}
        res["respawned_pid_differs"] = after["workers"]["0"]["pid"] != victim
        res["router_touches_card"] = router.touches_card()
        res["errors"] = {i: o["error"] for i, o in out.items()
                         if "error" in o}
        res["mismatched"] = [i for i, want in enumerate(wants)
                             if "ids" not in out[i] or not np.array_equal(
                                 np.asarray(out[i]["ids"]), want)]
        lat = [(o["t1"] - o["t0"]) * 1e3 for o in out.values() if "t1" in o]
        first = [(o["t_first"] - o["t0"]) * 1e3 for o in out.values()
                 if o.get("t_first") is not None]
        tokens = sum(r["new"] for r in reqs)
        res.update(tokens=tokens, tok_per_s=tokens / res["burst_s"],
                   latency_ms_p50=float(np.percentile(lat, 50)),
                   latency_ms_p95=float(np.percentile(lat, 95)),
                   first_token_ms_p50=float(np.percentile(first, 50)),
                   first_token_ms_p95=float(np.percentile(first, 95)),
                   served_by={}, failovers=serve_metric(
                       http_json(port, "/metrics"),
                       "pipeedge_router_failovers_total"))
        for o in out.values():
            rep = (o.get("final") or {}).get("replica")
            res["served_by"][rep] = res["served_by"].get(rep, 0) + 1
    finally:
        res["router_rc"] = router.close()
        res["replicas_gone"] = wait_until(router.replicas_gone, 30)
        res["log_tail"] = [ln for ln in router.lines
                           if not ln.startswith("[replica")][-12:]
    free_card()
    return res


def check_router_spawn_path(res, device_name: str) -> None:
    log("router spawned: " + json.dumps(res | {"card": device_name},
                                        sort_keys=True, default=str))
    if res["errors"] or res["mismatched"]:
        raise AssertionError(f"router spawned: lost or wrong requests: "
                             f"errors {res['errors']}, mismatched "
                             f"{res['mismatched']}")
    if not (res["readmitted"] and res["epochs"] == {"0": 1, "1": 0}
            and res["respawned_pid_differs"]
            and set(res["states"].values()) == {"healthy"}):
        raise AssertionError("router spawned: the killed replica was not "
                             "respawned and readmitted: " + json.dumps(
                                 {k: res[k] for k in ("readmitted", "epochs",
                                                      "states")}))
    if res["router_rc"] != 0 or not res["replicas_gone"] or \
            res["router_touches_card"]:
        raise AssertionError(f"router spawned: rc {res['router_rc']}, "
                             f"replicas gone {res['replicas_gone']}, the "
                             f"router holds a GPU device file: "
                             f"{res['router_touches_card']}")


# --- phase 16: PipeEdge's own transport, one process per rank --------------

# (a) ViT-Base, 2 ranks, three rounds on one fleet: bit 0, 8 and 4 (the
# last cut at a block boundary); (b) DeiT-Base, 3 ranks, adaptive, with
# frame checksums; (d) (a)'s fleet with heartbeats, rank 1 killed
DCN_VIT_PT = "1,21,22,48;1,21,22,48;1,24,25,48"
DCN_VIT_Q = "0,0;8,0;4,0"
DCN_DEIT_PARTITION = [(1, 16), (17, 32), (33, 48)]
DCN_ABORT_BATCH = 2048            # long enough to be killed mid-run
DCN_ABORT_DELAY_S = 1.0           # after the first frame on the edge
DCN_ABORT_LIMIT_S = 30.0


def free_addrs(n: int) -> str:
    import socket
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ",".join(f"127.0.0.1:{p}" for p in ports)


def dcn_launch(argv, world: int, cwd: Path, env_extra=None) -> list:
    """Every rank of a fleet as a process (workers first), each in its
    own directory under `cwd` (its monitoring CSVs), stdout and stderr
    into its `out.log` there (a pipe nobody drains would stall a rank
    once its logging filled it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONFAULTHANDLER="1",
               **(env_extra or {}))
    argv = argv + ["--dcn-addrs", free_addrs(world)]
    procs = []
    for rank in list(range(1, world)) + [0]:
        d = cwd / f"rank{rank}"
        d.mkdir(parents=True, exist_ok=True)
        for old in d.glob("*.csv"):
            old.unlink()
        with open(d / "out.log", "w") as log_file:
            procs.append((rank, d, subprocess.Popen(
                [sys.executable, "-m", "pipeedge_tpu_torch.runtime",
                 str(rank), str(world), "-c", "dcn"] + argv, cwd=d, env=env,
                stdout=log_file, stderr=subprocess.STDOUT)))
    return sorted(procs)


def rank_output(d: Path) -> str:
    return (d / "out.log").read_text(errors="replace")


def reap(procs) -> list:
    """Kill whatever of `procs` still runs; returns the ranks that did."""
    left = [rank for rank, _, p in procs if p.poll() is None]
    for _, _, p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    return left


def dcn_fleet(argv, world: int, cwd: Path, env_extra=None,
              timeout: float = 300) -> dict:
    """One fleet run to its end: each rank's output and exit code, its
    launches per round and in total (`rank=R [round=K] kernel_launches=`),
    the data rank's per-round report, and the wall time."""
    import signal
    t0 = time.monotonic()
    procs = dcn_launch(argv, world, cwd, env_extra)
    try:
        for rank, d, p in sorted(procs, key=lambda x: x[0] != 0):
            p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        # every thread's stack (PYTHONFAULTHANDLER), then the outputs
        for _, _, p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)
        for _, _, p in procs:
            p.wait(timeout=30)
        tails = {rank: rank_output(d)[-6000:] for rank, d, _ in procs}
        raise RuntimeError(f"dcn fleet {argv} did not end within "
                           f"{timeout} s:\n" + "\n".join(
                               f"--- rank {r}\n{t}" for r, t in
                               tails.items()))
    finally:
        left = reap(procs)
    seconds = time.monotonic() - t0
    res = {"seconds": seconds, "ranks": {}, "dirs": {r: d for r, d, _ in
                                                     procs}}
    outs = {rank: rank_output(d) for rank, d, _ in procs}
    for rank, _, p in procs:
        out = outs[rank]
        if p.returncode != 0 or left:
            raise RuntimeError(f"dcn rank {rank} exited {p.returncode} "
                               f"(left running: {left}):\n{out[-6000:]}")
        rounds, total = {}, None
        for ln in out.splitlines():
            if ln.startswith(f"rank={rank} round="):
                head, counts = ln.split(" kernel_launches=", 1)
                rounds[int(head.split("round=")[1])] = json.loads(counts)
            elif ln.startswith(f"rank={rank} kernel_launches="):
                total = json.loads(ln.split("=", 2)[2])
        res["ranks"][rank] = dict(out=out, rounds=rounds, total=total)
    res["report"] = {int(ln.split()[0].split("=")[1]): {
        kv.split("=")[0]: float(kv.split("=")[1]) for kv in ln.split()[1:]}
        for ln in outs[0].splitlines() if ln.startswith("round=")
        and "latency_sec=" in ln}
    return res


def read_csv(path: Path) -> list:
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def csv_mbit_s(rows) -> float:
    """Mbit/s of the transfers a monitoring CSV records: their Mbits over
    their summed transfer time."""
    mbits = sum(float(r["Work"]) for r in rows)
    ns = sum(float(r["Time (ns)"]) for r in rows)
    return mbits / (ns / 1e9) if ns else 0.0


def stage_attention(l: int, r: int) -> int:
    """Attention launches of a stage per microbatch: the blocks whose
    first sublayer it runs."""
    return sum(1 for s in range(l, r + 1) if (s - 1) % 4 == 0)


def dcn_vit_path(weights_file: Path, host: dict) -> dict:
    """Phase 16a: ViT-Base in 2 ranks through `python -m
    pipeedge_tpu_torch.runtime -c dcn`, three rounds on one fleet
    (DCN_VIT_PT, DCN_VIT_Q), results saved by the data rank. Round 1 is
    held to the single-shard forward, rounds 2 and 3 to the host pipeline
    at their cut and bits with the Banner clamp off (the DCN driver
    encodes without it, as `runtime.py`'s does), round 3 also to
    LOGIT_BOUND[4] of the exact forward; every rank's launches per round
    to the stages' shapes."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import edge_arity, registry
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline

    cfg = registry.get_model_config(MODEL)
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    n_mb = len(inputs)
    exact = single_shard_logits(MODEL, weights_file, inputs, "cuda")
    specs = []
    for round_pt, round_q in zip(DCN_VIT_PT.split(";"),
                                 DCN_VIT_Q.split(";")):
        nums = [int(v) for v in round_pt.split(",")]
        specs.append((list(zip(nums[0::2], nums[1::2])),
                      int(round_q.split(",")[0])))
    host_ref = {}                         # round -> host pipeline logits
    for k in (1, 2):
        pipe = build_pipeline(MODEL, specs[k][0],
                              model_file=str(weights_file), device="cuda",
                              quant_bits=[specs[k][1], 0])
        for stage in pipe.stages:
            stage.clamp = False
        if k == 1:
            pipe.run(inputs)              # warm-up
        outs, stats = pipe.run(inputs)
        host_ref[k] = [h.float().cpu().numpy() for h in outs]
        if k == 1:
            host_stats = stats
        del pipe
    cwd = BUILD_DIR / "dcn_vit"
    fleet = dcn_fleet(["-m", MODEL, "-M", str(weights_file), "-pt",
                       DCN_VIT_PT, "-q", DCN_VIT_Q, "-r", "0,1", "-b",
                       str(BATCH), "-u", str(UBATCH), "--save-results",
                       "results.npz", "--sched-timeout", "300"], 2, cwd)
    with np.load(fleet["dirs"][0] / "results.npz") as f:
        got = [f[f"arr_{i}"] for i in range(len(f.files))]
    rounds = []
    for k, (layers, bit) in enumerate(specs):
        arity = edge_arity(layers[0][1])
        outs = got[k * n_mb:(k + 1) * n_mb]
        want = [e.float().cpu().numpy() for e in exact]
        scale = max(float(np.abs(w).max()) for w in want)
        ref = host_ref.get(k, want)
        expected = {r: {"fused_attention": stage_attention(*layers[r]) * n_mb,
                        "fused_encode": arity * n_mb if bit and r == 0
                        else 0,
                        "fused_decode": arity * n_mb if bit and r == 1
                        else 0,
                        "int8_matmul": 0, "decode_attention": 0}
                    for r in (0, 1)}
        send0 = read_csv(fleet["dirs"][0] / "send.csv")[k * n_mb:
                                                        (k + 1) * n_mb]
        recv1 = read_csv(fleet["dirs"][1] / "recv.csv")[k * n_mb:
                                                        (k + 1) * n_mb]
        send1 = read_csv(fleet["dirs"][1] / "send.csv")[k * n_mb:
                                                        (k + 1) * n_mb]
        rounds.append(dict(
            partition=layers, bit=bit, n=len(outs),
            equal=len(outs) == n_mb and all(
                np.array_equal(o, r) for o, r in zip(outs, ref)),
            rel_err=max(float(np.abs(o - w).max()) for o, w in
                        zip(outs, want)) / scale,
            finite=all(bool(np.isfinite(o).all()) for o in outs),
            shape=list(outs[0].shape),
            counts={r: fleet["ranks"][r]["rounds"].get(k) for r in (0, 1)},
            expected_counts=expected,
            items_per_s=fleet["report"].get(k, {}).get(
                "throughput_items_sec"),
            edge_send_mbit_s=csv_mbit_s(send0),
            edge_recv_mbit_s=csv_mbit_s(recv1),
            results_send_mbit_s=csv_mbit_s(send1),
            edge_frame_mbits=float(send0[0]["Work"]) if send0 else None))
    l, r = specs[-1][0][1]
    rebuilt = f"stage 1: layers [{l}, {r}]" in fleet["ranks"][1]["out"]
    return dict(rounds=rounds, seconds=fleet["seconds"], rebuilt=rebuilt,
                host=host, expected_shape=[UBATCH, cfg.num_labels],
                # the host pipeline at round 2's cut and bits, clamp off,
                # warm, in this process
                host_items_per_s=host_stats["throughput_items_sec"],
                totals={r: fleet["ranks"][r]["total"] for r in (0, 1)},
                results=got)


def frame_bits_table(shapes, bits, crc: bool) -> dict:
    """Bytes of one v2 frame at each bitwidth for a payload of `shapes`
    (a policy's pick, or 0): each bitwidth packs another count of values
    per word, so the bytes name the bit."""
    from pipeedge_tpu_torch.comm import wire
    table = {}
    for bit in bits:
        x = tuple(torch.zeros(s) for s in shapes)
        frame = wire.wire_encode_device(x if len(x) > 1 else x[0], bit,
                                        crc=crc).finalize()
        nbytes = wire.frame_wire_bytes(frame)
        if nbytes in table:
            raise AssertionError(f"{bit} and {table[nbytes]} bits give the "
                                 f"same frame bytes {nbytes}")
        table[nbytes] = bit
    return table


def dcn_deit_path(weights_file: Path, constraint: float) -> dict:
    """Phase 16b: DeiT-Base in 3 ranks with `--wire-crc`, every edge
    starting at 8 bits, under ADAPTIVE_QUANT=HEURISTIC, WINDOW_SIZE=
    ADAPTIVE_WINDOW and a SEND_CONSTRAINT of `constraint` items/s: phase
    8's, ADAPTIVE_SHARE times the items/s edge 0 of the same model carried
    in process, more than a socket edge carries, so the policy must
    compress (a fleet of its own measuring edge 0's socket rate would
    cost a fleet's start-up for a number only this constraint reads). Each
    microbatch's bits per edge
    come from the frame bytes the receiving rank's recv hook recorded;
    each result is replayed through the host pipeline (clamp off) at those
    bits."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import edge_arity, registry
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline
    from pipeedge_tpu_torch.utils.quant import BITWIDTHS

    partition, ubatch = DCN_DEIT_PARTITION, UBATCH
    cfg = registry.get_model_config(DEIT_MODEL)
    world = len(partition)
    inputs, _ = runtime.load_batches(DEIT_MODEL, BATCH, ubatch,
                                     torch.device("cuda"), torch.float32)
    n_mb = len(inputs)
    pt = ",".join(f"{l},{r}" for l, r in partition)
    argv = ["-m", DEIT_MODEL, "-M", str(weights_file), "-pt", pt,
            "-q", ",".join(["8"] * (world - 1) + ["0"]),
            "-r", ",".join(str(r) for r in range(world)), "-b", str(BATCH),
            "-u", str(ubatch), "--wire-crc", "--save-results",
            "results.npz", "--sched-timeout", "300"]
    run = dcn_fleet(argv, world, BUILD_DIR / "dcn_deit",
                    env_extra={"ADAPTIVE_QUANT": "HEURISTIC",
                               "WINDOW_SIZE": str(ADAPTIVE_WINDOW),
                               "SEND_CONSTRAINT": repr(constraint)})
    with np.load(run["dirs"][0] / "results.npz") as f:
        outs = [f[f"arr_{i}"] for i in range(len(f.files))]
    pipe = build_pipeline(DEIT_MODEL, partition,
                          model_file=str(weights_file), device="cuda",
                          quant_bits=[8] * world)
    for stage in pipe.stages:
        stage.clamp = False
    # the raw bytes of each edge (a bit-0 replay) give its shape
    _, raw = replay(pipe, inputs[0], [0] * (world - 1))
    bits = [[None] * (world - 1) for _ in range(n_mb)]
    for e in range(world - 1):
        widths = edge_widths(cfg, partition[e][1])
        seq = raw[e] // (4 * ubatch * sum(widths))
        table = frame_bits_table([(ubatch, seq, w) for w in widths],
                                 [0] + list(BITWIDTHS), crc=True)
        rows = read_csv(run["dirs"][e + 1] / "recv.csv")
        if len(rows) != n_mb:
            raise AssertionError(f"edge {e}: {len(rows)} frames recorded")
        for i, row in enumerate(rows):
            bits[i][e] = table[round(float(row["Work"]) * 1e6 / 8)]
    equal, repeat_equal, gaps = [], [], []
    scale = max(float(np.abs(o).max()) for o in outs)
    for i, x in enumerate(inputs):
        first, _ = replay(pipe, x, bits[i])
        first = first.float().cpu().numpy()
        equal.append(bool(np.array_equal(first, outs[i])))
        if not equal[-1]:
            again, _ = replay(pipe, x, bits[i])
            repeat_equal.append(bool(np.array_equal(
                first, again.float().cpu().numpy())))
        gaps.append(float(np.abs(first - outs[i]).max()) / scale)
    del pipe
    coded = [sum(mb[e] in (4, 8) for mb in bits) for e in range(world - 1)]
    expected = {}
    for r, (l, rr) in enumerate(partition):
        enc = coded[r] * edge_arity(rr) if r < world - 1 else 0
        dec = coded[r - 1] * edge_arity(partition[r - 1][1]) if r else 0
        expected[r] = {"fused_attention": stage_attention(l, rr) * n_mb,
                       "fused_encode": enc, "fused_decode": dec,
                       "int8_matmul": 0, "decode_attention": 0}
    return dict(
        bits=bits, counts={r: run["ranks"][r]["total"] for r in range(world)},
        expected_counts=expected, replay_equal=equal,
        replay_repeat_equal=repeat_equal, replay_rel_gap=max(gaps),
        finite=all(bool(np.isfinite(o).all()) for o in outs),
        n=len(outs), send_constraint_items_s=constraint,
        edge0_mbit_s=csv_mbit_s(read_csv(run["dirs"][0] / "send.csv")),
        items_per_s={"adaptive": run["report"][0]["throughput_items_sec"]},
        seconds={"adaptive": run["seconds"]},
        crc_checked="--wire-crc" in argv)


def dcn_local_path(weights_file: Path, want) -> dict:
    """Phase 16c: the colocated tier in this process: two
    `DistDcnContext`s and the runtime's own stage pair
    (`runtime.build_dcn_stage`) at 8 bits on round 2's partition; the
    edges negotiate `local`, the tensors pass between the stages' streams
    under the producer's event, and the results equal `want` (fleet (a)'s
    round 2) bit for bit. Launch counts set to 0 just before the feed."""
    import argparse

    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.comm import dcn, wire
    from pipeedge_tpu_torch.ops import _build

    addrs = [tuple((h, int(p))) for h, p in
             (a.split(":") for a in free_addrs(2).split(","))]
    ctxs = [dcn.DistDcnContext(2, r, addrs) for r in (0, 1)]
    for c in ctxs:
        c.init()
    args = argparse.Namespace(model_name=MODEL, model_file=str(weights_file),
                              device="cuda", data_rank=0, sched_timeout=60,
                              stage_depth=0, stage_ckpt=None, wire_crc=False,
                              on_peer_death="abort", stage_tp=1,
                              tp_quant_bits=0)
    layers, quant, ranks = PARTITION, [8, 0], [0, 1]
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cpu"), torch.float32)
    stages = []
    try:
        for i in (0, 1):
            stage = runtime.build_dcn_stage(args, ctxs[i], 0, i, layers,
                                            quant, ranks, torch.float32)
            stages.append(stage)
        feed_tier = ctxs[0].negotiate_edge_path(0, timeout=10)
        tiers = [ctxs[0].edge_path(1), ctxs[1].edge_path(0), feed_tier]
        for s in stages:
            s.start()
        _build.reset_launch_counts()
        t0 = time.monotonic()
        for x in inputs:
            ctxs[0].send_tensors(0, [x.numpy()], channel=dcn.CHANNEL_FEED)
        outs = [wire.wire_decode(ctxs[0].recv_tensors(
            1, timeout=120, channel=dcn.CHANNEL_RESULTS), torch.float32,
            device="cpu").numpy() for _ in inputs]
        seconds = time.monotonic() - t0
        counts = dict(_build.launch_counts)
    finally:
        for s in stages:
            s.stop()
        for c in ctxs:
            c.shutdown()
    n_mb = len(inputs)
    from pipeedge_tpu_torch.models import edge_arity
    arity = edge_arity(layers[0][1])
    return dict(tiers=tiers, counts=counts, expected_counts={
        "fused_attention": sum(stage_attention(*lr) for lr in layers) * n_mb,
        "fused_encode": arity * n_mb, "fused_decode": arity * n_mb,
        "int8_matmul": 0, "decode_attention": 0},
        equal=len(outs) == len(want) and all(
            np.array_equal(o, w) for o, w in zip(outs, want)),
        items_per_s=sum(len(x) for x in inputs) / seconds)


def dcn_abort_path(weights_file: Path) -> dict:
    """Phase 16d: (a)'s fleet (-pt 1,21,22,48 -q 8,0) with heartbeats
    (0.5 s, 3 misses) on a batch long enough to be mid-run, rank 1 killed
    (SIGKILL) DCN_ABORT_DELAY_S after rank 0 logs its first frame on the
    edge: the data rank must exit non-zero naming rank 1 within
    DCN_ABORT_LIMIT_S, and no process of the fleet may be left."""
    import signal

    argv = ["-m", MODEL, "-M", str(weights_file), "-pt", "1,21,22,48",
            "-q", "8,0", "-r", "0,1", "-b", str(DCN_ABORT_BATCH), "-u",
            str(UBATCH), "--sched-timeout", "120", "--heartbeat-interval",
            "0.5", "--heartbeat-miss", "3"]
    procs = dcn_launch(argv, 2, BUILD_DIR / "dcn_abort")
    data = [p for r, _, p in procs if r == 0][0]
    victim = [p for r, _, p in procs if r == 1][0]
    data_dir = [d for r, d, _ in procs if r == 0][0]
    try:
        if not wait_until(lambda: "send: Instant" in rank_output(data_dir)
                          or data.poll() is not None, 240, step=0.05):
            raise AssertionError("dcn abort: no frame on the edge:\n"
                                 + rank_output(data_dir)[-4000:])
        time.sleep(DCN_ABORT_DELAY_S)
        still_running = data.poll() is None
        victim.send_signal(signal.SIGKILL)
        killed_at = time.monotonic()
        try:
            data.wait(timeout=DCN_ABORT_LIMIT_S + 30)
        except subprocess.TimeoutExpired:
            pass
        exit_s = (time.monotonic() - killed_at
                  if data.poll() is not None else None)
        victim.wait(timeout=30)
    finally:
        left = reap(procs)
    out = rank_output(data_dir)
    return dict(running_at_kill=still_running, exit_s=exit_s,
                returncode=data.returncode, left=left,
                names_rank1="rank 1 died" in out,
                tail=out[-1500:])


def dcn_path(card: str, host: dict, deit_constraint: float,
             alongside=None) -> dict:
    """Phase 16 (a)-(d) on the card, (d) beside (b) for the script's
    time; each sub-run's seconds printed. `deit_constraint`: (b)'s
    SEND_CONSTRAINT (phase 8's).
    `alongside`, a callable, runs beside (b) and (d) (phase 21b's fleets);
    its result is `res["alongside"]`."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch.models import deit, vit
    from pipeedge_tpu_torch.models import registry
    res = {"seconds": {}}
    t0 = time.monotonic()
    vit_w = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    if not vit_w.exists():
        np.savez(vit_w, **vit.random_npz_weights(
            registry.get_model_config(MODEL), seed=0))
    res["vit"] = dcn_vit_path(vit_w, host=host)
    res["seconds"]["a"] = time.monotonic() - t0
    log(f"phase 16a: {res['seconds']['a']:.1f} s")
    def timed_run(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        res["seconds"][name] = time.monotonic() - t0
        log(f"phase 16{name}: {res['seconds'][name]:.1f} s")
        return out

    deit_w = write_random_checkpoint(deit, DEIT_MODEL, BUILD_DIR)
    with ThreadPoolExecutor(2) as pool:
        abort = pool.submit(timed_run, "d", dcn_abort_path, vit_w)
        beside = None if alongside is None else pool.submit(alongside)
        res["deit"] = timed_run("b", dcn_deit_path, deit_w, deit_constraint)
        res["abort"] = abort.result()
        if beside is not None:
            res["alongside"] = beside.result()
    want = res["vit"]["results"][BATCH // UBATCH:2 * (BATCH // UBATCH)]
    res["local"] = timed_run("c", dcn_local_path, vit_w, want)
    res["card"] = card
    return res


def check_dcn_path(res, device_name: str) -> None:
    v = res["vit"]
    for k, r in enumerate(v["rounds"]):
        log(f"dcn vit round {k + 1}: " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        if r["n"] != BATCH // UBATCH or not r["finite"] or \
                r["shape"] != v["expected_shape"]:
            raise AssertionError(f"dcn vit round {k + 1}: {r['n']} results "
                                 f"of shape {r['shape']}, finite="
                                 f"{r['finite']}")
        if r["counts"] != r["expected_counts"]:
            raise AssertionError(f"dcn vit round {k + 1}: launches "
                                 f"{r['counts']} != {r['expected_counts']}")
    r1, r2, r3 = v["rounds"]
    if not r1["equal"]:
        raise AssertionError(f"dcn vit round 1 (bit 0) differs from the "
                             f"single-shard forward by {r1['rel_err']}")
    if not r2["equal"]:
        raise AssertionError("dcn vit round 2 (8 bits) differs from the "
                             "host pipeline at 8 bits (clamp off)")
    if not r3["equal"]:
        raise AssertionError("dcn vit round 3 (4 bits, the new cut) differs "
                             "from the host pipeline at its cut and bits "
                             "(clamp off)")
    if not 0 < r3["rel_err"] <= LOGIT_BOUND[4]:
        raise AssertionError(f"dcn vit round 3 (4 bits): logit error "
                             f"{r3['rel_err']} not in (0, {LOGIT_BOUND[4]}]")
    if not v["rebuilt"]:
        raise AssertionError("dcn vit: rank 1 did not log its rebuilt "
                             "stage [25, 48]")
    log("dcn vit items/s per round " + json.dumps(
        [r["items_per_s"] for r in v["rounds"]]) + " beside the host "
        f"pipeline's {v['host_items_per_s']} at round 2's cut and bits "
        "(phase 4's by bit: " + json.dumps(v["host"]) + f"; {device_name})")
    d = res["deit"]
    log("dcn deit: " + json.dumps({k: val for k, val in d.items()
                                   if k != "bits"}, sort_keys=True))
    log("dcn deit bits per microbatch (edges 0..1) " + json.dumps(d["bits"]))
    if d["n"] != BATCH // UBATCH or not d["finite"]:
        raise AssertionError(f"dcn deit: {d['n']} results, finite="
                             f"{d['finite']}")
    if not any(b != 8 for mb in d["bits"] for b in mb):
        raise AssertionError("dcn deit: no edge moved off 8 bits")
    if d["counts"] != d["expected_counts"]:
        raise AssertionError(f"dcn deit: launches {d['counts']} != "
                             f"{d['expected_counts']}")
    if not all(d["replay_equal"]):
        if all(d["replay_repeat_equal"]) or \
                d["replay_rel_gap"] > REPLAY_BOUND:
            raise AssertionError(f"dcn deit: a microbatch differs from its "
                                 f"replay by {d['replay_rel_gap']} of max "
                                 f"|logit|")
    c = res["local"]
    log("dcn local: " + json.dumps({**c, "card": device_name}))
    if c["tiers"] != ["local"] * 3:
        raise AssertionError(f"dcn local: tiers {c['tiers']}")
    if c["counts"] != c["expected_counts"] or not c["equal"]:
        raise AssertionError(f"dcn local: launches {c['counts']} != "
                             f"{c['expected_counts']} or results differ "
                             f"from fleet (a)'s round 2")
    a = res["abort"]
    log("dcn abort: " + json.dumps(a))
    if not a["running_at_kill"]:
        raise AssertionError("dcn abort: the fleet finished before rank 1 "
                             "was killed")
    if a["returncode"] in (0, None) or a["exit_s"] is None or \
            a["exit_s"] > DCN_ABORT_LIMIT_S or not a["names_rank1"]:
        raise AssertionError(f"dcn abort: data rank exit {a['returncode']} "
                             f"after {a['exit_s']} s, naming rank 1: "
                             f"{a['names_rank1']}")
    if a["left"]:
        raise AssertionError(f"dcn abort: rank(s) {a['left']} left running")
    log("phase 16 seconds " + json.dumps(res["seconds"]))


# --- phase 17: the routed fleet's observatory and capacity loop ------------

# One int8 `gpt2` replica behind the router under `--autoscale auto`,
# phase 15e's weights and serving flags on the paged KV plane, at most 4
# requests active per replica so the rest queue, and no brownout ladder
# (its clamp would cut the new tokens of queued requests, and each
# request is held to its solo run). The loop scrapes and ticks every 0.5
# s, confirms a direction over 2 windows, waits 2 s between decisions and
# wants 6 s of calm before it drains: long enough for the observatory's
# checks while both replicas are live.
AUTOSCALE_FLAGS = ["--replicas", "1", "--max-active", "4", "--no-brownout",
                   "--fleet-scrape-interval", "0.5", "--autoscale", "auto",
                   "--autoscale-min", "1", "--autoscale-max", "2",
                   "--autoscale-interval", "0.5", "--autoscale-confirm", "2",
                   "--autoscale-cooldown", "2", "--autoscale-dwell-down",
                   "6"]
AUTOSCALE_CLIENTS = 16     # closed-loop clients: 4 active, 12 queued on r0
# answers from r1 before the load stops: 4 (one round of its 4 active
# slots; 8 until PR 21 made room for phase 24)
AUTOSCALE_R1_ANSWERS = 4
AUTOSCALE_LOAD_S = 120.0   # the most the ramp up may take
AUTOSCALE_DOWN_S = 60.0    # the most the ramp down may take after it


class ClosedLoad:
    """One streaming client thread per request of `sets[0]`, each sending
    its request again and again until `stop()`; after `switch()`, request
    i of `sets[1]` (fresh prompts: the router's affinity pinned the first
    set to r0). Keeps (set, index, final line, t0, t1) per answer."""

    def __init__(self, port: int, sets):
        import threading
        self.answers: list = []
        self.errors: list = []
        self._halt, self._switch = threading.Event(), threading.Event()

        def client(i):
            while not self._halt.is_set():
                k = int(self._switch.is_set())
                r = sets[k][i]
                out: dict = {}
                start = threading.Event()
                start.set()
                stream_client(port, 0, {"ids": r["ids"],
                                        "new_tokens": r["new"]}, start, out)
                if "error" in out[0]:
                    self.errors.append((k, i, out[0]["error"]))
                else:
                    self.answers.append((k, i, out[0]["final"],
                                         out[0]["t0"], out[0]["t1"]))
        self.threads = [threading.Thread(target=client, args=(i,))
                        for i in range(len(sets[0]))]
        for t in self.threads:
            t.start()

    def served_by(self, name: str) -> int:
        return sum(1 for a in list(self.answers) if a[2].get("replica") == name)

    def switch(self) -> None:
        self._switch.set()

    def stop(self) -> None:
        self._halt.set()
        for t in self.threads:
            t.join()


def fleet_class_totals(text: str) -> dict:
    """{class: {ok_total, requests_total}} of one /metrics body."""
    from pipeedge_tpu_torch.telemetry import collector as fleet_obs
    counts = fleet_obs.BurnRateEngine.counts_from_families(
        fleet_obs.parse_prom_text(text))
    return {cls: {"ok_total": g, "requests_total": t}
            for cls, (g, t) in counts.items()}


def autoscale_path() -> dict:
    """Phase 17: the router entry with one int8 replica under `--autoscale
    auto`. (a) closed-loop clients queue on r0 until the controller spawns
    r1, the health polls readmit it and it serves; (c) at quiescence
    `/fleet`'s per-class totals against the two replicas' own /metrics;
    (b) the load stops, r1 is drained and retired; then the router's span
    ring through `telemetry/report.py` and `python -m
    pipeedge_tpu_torch.trace_report --fleet URL --request RID`; every
    answer against its solo int8 run in this process (kernel 5)."""
    import threading
    import urllib.request
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.telemetry import report
    cfg = registry.get_model_config(DECODE_MODEL)
    weights = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    base = SERVE_FLAGS + ["-M", str(weights), "--kv-bits", "8",
                          "--postmortem-dir", str(BUILD_DIR / "postmortems"),
                          *ROUTER_PAGED]
    rng = np.random.default_rng(17)

    def draw():
        length = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        return {"ids": rng.integers(0, cfg.vocab_size,
                                    size=(1, length)).tolist(),
                "new": int(rng.integers(ROUTER_NEW[0], ROUTER_NEW[1] + 1))}
    sets = [[draw() for _ in range(AUTOSCALE_CLIENTS)] for _ in range(2)]
    res: dict = {}
    t_phase = time.monotonic()
    r0_pid = None

    def solo_runs():
        """Every request's solo int8 run in this process on kernel 5, while
        the router and r0 start, for the script's time; the load starts
        once they are done."""
        t_solo = time.monotonic()
        oracle = serve.build_pipeline(serve.parse_args(base))
        _build.reset_launch_counts()
        want = {(k, i): oracle.generate(
            torch.as_tensor(r["ids"], device="cuda"), r["new"]).cpu().numpy()
            for k in range(2) for i, r in enumerate(sets[k])}
        torch.cuda.synchronize()
        res["solo_s"] = time.monotonic() - t_solo
        return want, _build.launch_counts["decode_attention"]

    from concurrent.futures import ThreadPoolExecutor
    solo_pool = ThreadPoolExecutor(1)
    solo = solo_pool.submit(solo_runs)
    # the loop's flags last: they override the serving flags' --max-active
    router = RouterProc([*base, *AUTOSCALE_FLAGS], timeout=600)
    try:
        port = router.port
        url = f"http://127.0.0.1:{port}"
        res["ready_s"] = router.ready_s
        res["mode_line"] = next((ln for ln in router.lines
                                 if ln.startswith("autoscale mode=")), None)
        wait_until(lambda: router.health()["fleet"]["r0"]["state"]
                   == "healthy", 60)
        r0_pid = router.health()["workers"]["0"]["pid"]
        # the first request alone, on r0: the one the trace report
        # resolves at the end
        first_out: dict = {}
        go = threading.Event()
        go.set()
        stream_client(port, 0, {"ids": sets[0][0]["ids"],
                                "new_tokens": sets[0][0]["new"]}, go,
                      first_out)
        first = first_out[0]
        res["first"] = {"replica": first["final"].get("replica"),
                        "rid": first["final"].get("rid")}
        t_wait = time.monotonic()
        want, res["solo_launches"] = solo.result()
        res["solo_wait_s"] = time.monotonic() - t_wait
        # (a) the ramp up
        seen = {"t_pressure": None, "t_spawn": None, "t_readmit": None,
                "size": 0, "r1_pid": None}
        load = ClosedLoad(port, sets)
        t_load = time.monotonic()
        deadline = t_load + AUTOSCALE_LOAD_S
        while time.monotonic() < deadline:
            h = router.health()
            now = time.monotonic()
            if seen["t_pressure"] is None and \
                    h["autoscale"]["streak"]["direction"] == 1:
                seen["t_pressure"] = now
            seen["size"] = max(seen["size"], h["autoscale"]["size"])
            if "1" in h["workers"] and seen["t_spawn"] is None:
                seen["t_spawn"] = now
                seen["r1_pid"] = h["workers"]["1"]["pid"]
            r1 = h["fleet"].get("r1")
            if seen["t_readmit"] is None and r1 and \
                    r1["state"] == "healthy":
                seen["t_readmit"] = now
                load.switch()
            if seen["t_readmit"] is not None and \
                    load.served_by("r1") >= AUTOSCALE_R1_ANSWERS:
                break
            time.sleep(0.1)
        load.stop()
        t_stop = time.monotonic()
        # (c) at quiescence, both replicas live: /fleet against the
        # replicas' own /metrics, once two scrapes have passed
        time.sleep(1.2)
        fleet = http_json(port, "/fleet")
        live = {name: urllib.request.urlopen(f"{u}/metrics", timeout=30)
                .read().decode() for name, u in fleet["targets"].items()}
        router_metrics = http_json(port, "/metrics")
        res["actual_size_live"] = serve_metric(router_metrics,
                                               "pipeedge_fleet_actual_size")
        res["fleet_targets"] = sorted(fleet["targets"])
        sums = {}
        for text in live.values():
            for cls, rec in fleet_class_totals(text).items():
                for k, v in rec.items():
                    sums.setdefault(cls, {}).setdefault(k, 0.0)
                    sums[cls][k] += v
        res["fleet_totals"] = {cls: {k: rec[k] for k in sums[cls]}
                               for cls, rec in fleet["classes"].items()}
        res["replica_sums"] = sums
        r1_final = fleet_class_totals(live.get("r1", ""))
        # (b) the ramp down
        wait_until(lambda: any(ln.startswith("autoscale_drain")
                               for ln in router.lines), AUTOSCALE_DOWN_S)
        res["r1_gone"] = seen["r1_pid"] is not None and wait_until(
            lambda: not Path(f"/proc/{seen['r1_pid']}").exists()
            or Path(f"/proc/{seen['r1_pid']}/stat").read_text().split()[2]
            == "Z", 30)
        wait_until(lambda: any(ln.startswith("[replica r1] kernel_launches=")
                               for ln in router.lines), 30)
        time.sleep(2.0)              # a respawn would show by now
        h = router.health()
        res["after"] = {"fleet": sorted(h["fleet"]),
                        "workers": sorted(h["workers"]),
                        "size": h["autoscale"]["size"],
                        "decisions": h["autoscale"]["decisions"]}
        router_metrics = http_json(port, "/metrics")
        res["decisions"] = {f"{d}/{o}": serve_metric(
            router_metrics, "pipeedge_autoscale_decisions_total",
            direction=d, outcome=o) for d in ("up", "down")
            for o in ("applied", "advised", "held", "flap_damped")}
        res["actual_size_after"] = serve_metric(
            router_metrics, "pipeedge_fleet_actual_size")
        time.sleep(1.2)
        fleet = http_json(port, "/fleet")
        r0_now = fleet_class_totals(urllib.request.urlopen(
            f"{fleet['targets']['r0']}/metrics", timeout=30).read().decode())
        res["totals_after"] = {
            "fleet": {cls: {k: rec[k] for k in r0_now[cls]}
                      for cls, rec in fleet["classes"].items()},
            "r0_plus_r1_final": {cls: {k: r0_now[cls][k]
                                       + r1_final.get(cls, {}).get(k, 0.0)
                                       for k in r0_now[cls]}
                                 for cls in r0_now}}
        # the router's span ring (peeked) through the report, then the
        # trace report across the router and r0 (drains the rings)
        with urllib.request.urlopen(f"{url}/debug/spans?drain=0",
                                    timeout=30) as resp:
            ring = json.loads(resp.read())["spans"]
        res["autoscale_section"] = report.analyze_spans(
            ring, span_cost_ns=report.measure_span_cost_ns())["autoscale"]
        applies = {s["name"]: (s["t1"] - s["t0"]) / 1e9 for s in ring
                   if s["cat"] == "autoscale"
                   and s["name"].startswith("apply:")}
        res["spawn_apply_s"] = applies.get("apply:up")
        res["drain_s"] = applies.get("apply:down")
        tr = subprocess.run(
            [sys.executable, "-m", "pipeedge_tpu_torch.trace_report",
             "--fleet", url, "--request", res["first"]["rid"]], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
            text=True, timeout=120)
        res["trace_report_rc"] = tr.returncode
        timeline = json.loads(tr.stdout) if tr.stdout.strip() else {}
        procs = timeline.get("processes", {})
        by_target = {p["target"]: int(k) for k, p in procs.items()}
        res["timeline"] = {
            "found": timeline.get("found"), "spans": timeline.get("spans"),
            "ranks": timeline.get("ranks"), "by_target": by_target,
            "r0_ok": procs.get(str(by_target.get("r0")), {}).get("ok"),
            "segments": sorted(timeline.get("segments", {})),
            "dominant": (timeline.get("dominant_stall") or {}).get(
                "segment"), "total_ms": timeline.get("total_ms")}
        # the times (the spawn's: the first health poll that lists rank 1)
        t_spawn = seen["t_spawn"]
        res["spawn_lines"] = [ln for ln in router.lines
                              if ln.startswith("autoscale_spawn")]
        res["drain_lines"] = [ln for ln in router.lines
                              if ln.startswith("autoscale_drain")]
        res["rank1_spawned"] = sum("decode replica rank 1 spawned" in ln
                                   for ln in router.lines)
        res["rank1_retired"] = any("decode replica rank 1 retired" in ln
                                   for ln in router.lines)
        res["pressure_to_spawn_s"] = (
            None if None in (t_spawn, seen["t_pressure"])
            else t_spawn - seen["t_pressure"])
        res["spawn_to_readmit_s"] = (
            None if None in (t_spawn, seen["t_readmit"])
            else seen["t_readmit"] - t_spawn)
        res["size_max"] = seen["size"]
        answers = load.answers
        res["answers"] = len(answers) + 1
        res["errors"] = load.errors
        res["served_by"] = {}
        for a in answers:
            rep = a[2].get("replica")
            res["served_by"][rep] = res["served_by"].get(rep, 0) + 1

        def tok_s(lo, hi):
            if lo is None or hi is None or hi <= lo:
                return None
            done = [a for a in answers if lo <= a[4] <= hi]
            return sum(sets[k][i]["new"] for k, i, *_ in done) / (hi - lo)
        # r0 serves alone until r1's readmission, the two after it
        res["tok_per_s_before_readmit"] = tok_s(t_load, seen["t_readmit"])
        res["tok_per_s_after_readmit"] = tok_s(seen["t_readmit"], t_stop)
        res["load_s"] = t_stop - t_load
        launches = next((ln for ln in router.lines if ln.startswith(
            "[replica r1] kernel_launches=")), None)
        res["r1_launches"] = (json.loads(launches.split("=", 1)[1])
                              if launches else None)
        # r1's last lines as the router printed them, for a failed check
        res["r1_tail"] = [ln for ln in router.lines
                          if "r1" in ln or "rank 1" in ln][-6:]
        # every answer against its request's solo int8 run (`solo_runs`)
        res["mismatched"] = [
            (k, i) for k, i, final in [(0, 0, first["final"])] + [
                (a[0], a[1], a[2]) for a in answers]
            if not np.array_equal(np.asarray(final.get("ids")), want[(k, i)])]
        res["solo_runs"] = len(want)
    finally:
        solo_pool.shutdown()
        res["router_rc"] = router.close()
        res["replicas_gone"] = wait_until(router.replicas_gone, 30)
        res["r0_gone"] = r0_pid is not None and wait_until(
            lambda: not Path(f"/proc/{r0_pid}").exists()
            or Path(f"/proc/{r0_pid}/stat").read_text().split()[2] == "Z",
            30)
        res["log_tail"] = [ln for ln in router.lines
                           if not ln.startswith("[replica")][-12:]
        if sys.exc_info()[0] is not None:
            log("autoscale failed; the router's output: "
                + json.dumps(router.lines[-40:]))
    free_card()
    res["seconds"] = time.monotonic() - t_phase
    return res


def check_autoscale_path(res, device_name: str) -> None:
    log("autoscale: " + json.dumps(res | {"card": device_name},
                                   sort_keys=True, default=str))
    if res["errors"] or res["mismatched"]:
        raise AssertionError(f"autoscale: lost or wrong requests: errors "
                             f"{res['errors'][:4]}, mismatched "
                             f"{res['mismatched'][:8]}")
    if res["mode_line"] != ("autoscale mode=auto min=1 max=2 confirm=2 "
                            "cooldown=2"):
        raise AssertionError(f"autoscale: mode line {res['mode_line']!r}")
    if not (len(res["spawn_lines"]) == 1 and res["spawn_lines"][0].startswith(
            "autoscale_spawn replica=r1 rank=1 epoch=0 url=")
            and res["rank1_spawned"] == 1):
        raise AssertionError("autoscale: not exactly one spawn of r1 at "
                             f"epoch 0: {res['spawn_lines']}")
    if not (res["spawn_to_readmit_s"] is not None
            and res["served_by"].get("r1", 0) >= AUTOSCALE_R1_ANSWERS
            and res["size_max"] == 2 and res["actual_size_live"] == 2):
        raise AssertionError(
            "autoscale: r1 was not readmitted and serving, or the fleet "
            "never reached 2: " + json.dumps(
                {k: res[k] for k in ("spawn_to_readmit_s", "served_by",
                                     "size_max", "actual_size_live")}))
    if res["fleet_targets"] != ["r0", "r1"] or \
            res["fleet_totals"] != res["replica_sums"] or \
            sum(t["ok_total"] for t in res["replica_sums"].values()) \
            != res["answers"]:
        raise AssertionError(
            f"autoscale: /fleet {res['fleet_totals']} against the replicas' "
            f"/metrics {res['replica_sums']} ({res['answers']} answers)")
    if not (len(res["drain_lines"]) == 1 and res["drain_lines"][0]
            .startswith("autoscale_drain replica=r1 rank=1 migrated=")
            and res["r1_gone"] and res["rank1_retired"]
            and res["after"]["fleet"] == ["r0"]
            and res["after"]["workers"] == ["0"]
            and res["after"]["size"] == 1
            and res["actual_size_after"] == 1):
        raise AssertionError("autoscale: r1 was not drained and retired: "
                             + json.dumps({k: res[k] for k in (
                                 "drain_lines", "r1_gone", "after")}))
    want = {f"{d}/{o}": float(o == "applied") for d in ("up", "down")
            for o in ("applied", "advised", "held", "flap_damped")}
    if res["decisions"] != want:
        raise AssertionError(f"autoscale: decisions {res['decisions']}")
    if res["totals_after"]["fleet"] != res["totals_after"]["r0_plus_r1_final"]:
        raise AssertionError(f"autoscale: /fleet after the drain "
                             f"{res['totals_after']}")
    sec = res["autoscale_section"]
    if not (sec.get("applies") == 2 and sec.get("flap_damped") == 0
            and sec.get("by_direction") == {"down": {"apply": 1, "plan": 1},
                                            "up": {"apply": 1, "plan": 1}}):
        raise AssertionError(f"autoscale: report section {sec}")
    tl = res["timeline"]
    if not (res["trace_report_rc"] == 0 and tl["found"] and tl["r0_ok"]
            and res["first"]["replica"] == "r0"
            and set(tl["ranks"] or ()) == {tl["by_target"].get("router"),
                                           tl["by_target"].get("r0")}
            and any(s.startswith("route/r0") for s in tl["segments"])):
        raise AssertionError(f"autoscale: trace_report --fleet --request: "
                             f"rc {res['trace_report_rc']}, {tl}")
    if not (res["r1_launches"] and res["r1_launches"]["decode_attention"] > 0
            and res["solo_launches"] > 0):
        raise AssertionError(f"autoscale: kernel 5 launches: r1 "
                             f"{res['r1_launches']}, solo runs "
                             f"{res['solo_launches']}; r1's last lines "
                             f"{res['r1_tail']}")
    if res["router_rc"] != 0 or not res["replicas_gone"] or not res["r0_gone"]:
        raise AssertionError(f"autoscale: router rc {res['router_rc']}, "
                             f"replicas gone {res['replicas_gone']}")
    log("phase 17 times " + json.dumps({k: res[k] for k in (
        "pressure_to_spawn_s", "spawn_to_readmit_s", "spawn_apply_s",
        "tok_per_s_before_readmit", "tok_per_s_after_readmit", "drain_s",
        "load_s", "seconds")} | {"migrated": int(
            res["drain_lines"][0].rsplit("=", 1)[1]), "card": device_name}))


# --- phase 18: the DCN driver's fault plane -----------------------------

# (a)-(d) through the chaos harness, ViT-Base at full width (phase 16's
# weights) at -pt 1,21,22,48 -q 8,0 -b 64 -u 8, one process and CUDA
# context per rank. The beat budget (1 s x 10) covers a rank's CUDA
# start and the spare's build of the stage it takes over.
CHAOS_RANK_ARGS = ["-m", MODEL, "-pt",
                   ",".join(f"{l},{r}" for l, r in PARTITION), "-q", "8,0",
                   "-r", "0,1", "-b", str(BATCH), "-u", str(UBATCH),
                   "--heartbeat-interval", "1", "--heartbeat-miss", "10",
                   "--sched-timeout", "300", "--device", "cuda"]
# (c): the restarted rank needs its restart delay plus an interpreter's
# and a CUDA context's start to JOIN, longer than three ViT-Base rounds
# on the card take; the substitute spare is made slower than the rank it
# replaces (2 s per send: 12-16 s a round), so the rounds it carries
# outlast that and the JOIN lands before the last boundary
CHAOS_RESTART_MS = 1000
CHAOS_SPARE_DELAY_MS = 2000
# (d): a straggler slower than the other stage's first round on the card
# (its first CUDA uses), so round 0's window already counts against it
CHAOS_SLOW_MS = 400
CHAOS_CASES = {
    "a_kill": ["--world", "3", "--chaos", "kill@3"],
    "b_no_spare": ["--world", "2", "--chaos", "kill@2", "--expect",
                   "abort"],
    "c_restart_heal": ["--world", "4", "--chaos",
                       f"restart@3:{CHAOS_RESTART_MS}", "--arm",
                       f"2=delay@1:{CHAOS_SPARE_DELAY_MS}", "--rounds", "3",
                       "--on-peer-rejoin", "heal", "--expect", "heal"],
    "d_quarantine": ["--world", "4", "--chaos", f"slow@2:{CHAOS_SLOW_MS}",
                     "--rounds", "4", "--on-peer-degraded", "quarantine",
                     "--expect", "quarantine"],
}


def chaos_case(name: str, weights_file: Path) -> dict:
    """One case through `python -m pipeedge_tpu_torch.chaos_dcn`: its JSON
    record, exit code, each rank's output (`out.log` in its directory)
    and the data rank's saved results."""
    d = BUILD_DIR / f"chaos_{name}"
    if d.exists():
        import shutil
        shutil.rmtree(d)
    d.mkdir(parents=True)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pipeedge_tpu_torch.chaos_dcn",
         *CHAOS_RANK_ARGS, "-M", str(weights_file), "--workdir", str(d),
         "--save-results", str(d / "results.npz"), "--timeout", "400",
         *CHAOS_CASES[name]],
        capture_output=True, text=True, cwd=d, timeout=480,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    seconds = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    if not lines:
        raise AssertionError(f"chaos {name}: no record (rc "
                             f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    record = json.loads(lines[-1])
    outs = {int(r.name[4:]): (r / "out.log").read_text(errors="replace")
            for r in sorted(d.glob("rank*")) if (r / "out.log").exists()}
    results = []
    if (d / "results.npz").exists():
        with np.load(d / "results.npz") as f:
            results = [f[f"arr_{i}"] for i in range(len(f.files))]
    return dict(rc=proc.returncode, record=record, outs=outs,
                results=results, seconds=seconds)


def chaos_path(want, alongside=None) -> dict:
    """Phase 18: the cases of CHAOS_CASES, all at once (each its own fleet
    on its own ports; they share the card and the host's cores, which
    their times carry); `want` is phase 16a's round 2 (the unfaulted fleet
    at this cut and bits). `alongside`, a callable, runs with them (phase
    20(b), the chaos harness's serve-disagg case: the script's time); its
    result is `res["alongside"]`."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch.models import edge_arity
    weights_file = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    res = {"want": want, "arity": edge_arity(PARTITION[0][1])}
    with ThreadPoolExecutor(len(CHAOS_CASES) + 1) as pool:
        futures = {name: pool.submit(chaos_case, name, weights_file)
                   for name in CHAOS_CASES}
        extra = pool.submit(alongside) if alongside is not None else None
        res["cases"] = {name: f.result() for name, f in futures.items()}
        if extra is not None:
            res["alongside"] = extra.result()
    for name, case in res["cases"].items():
        log(f"phase 18 {name}: {case['seconds']:.1f} s")
    return res


def chaos_launch_problem(launches: dict, arity: int, replayed: int):
    """Case (a)'s launches: the spare decodes (kernel 2) and attends
    (kernel 3) every replayed microbatch, and rank 0 encoded (kernel 1)
    each of the 8 to 8 + `replayed` microbatches it dispatched over the
    two rounds. Returns what is wrong, or None."""
    n_mb = BATCH // UBATCH
    spare, head = launches["2"], launches["0"]
    want = {"fused_decode": arity * replayed,
            "fused_attention": stage_attention(*PARTITION[1]) * replayed}
    if spare is None or any(spare[k] != v for k, v in want.items()):
        return (f"the spare's launches {spare} are not {want} for "
                f"{replayed} replayed microbatches")
    enc = (head or {}).get("fused_encode", 0)
    if enc % arity or not arity * n_mb <= enc <= arity * (n_mb + replayed):
        return (f"rank 0's {enc} encode launches are not one per edge "
                f"tensor of {n_mb}..{n_mb + replayed} microbatches")
    return None


def check_chaos_path(res, device_name: str) -> dict:
    """Every check of phase 18; returns each case's launches per rank (the
    kernels line's `chaos_launches`)."""
    cases, want, arity = res["cases"], res["want"], res["arity"]
    n_mb = BATCH // UBATCH
    summary, launches = {}, {}

    def fail(name, what):
        c = cases[name]
        raise AssertionError(
            f"chaos {name}: {what}\nrecord {json.dumps(c['record'])}\n"
            + "\n".join(f"--- rank {r}\n{o[-3000:]}"
                        for r, o in c["outs"].items()))

    def same_rounds(name, rounds):
        got = cases[name]["results"]
        if len(got) != rounds * n_mb:
            fail(name, f"{len(got)} results, not {rounds * n_mb}")
        for k, (g, w) in enumerate(zip(got, want * rounds)):
            if g.shape != w.shape or not np.array_equal(g, w):
                fail(name, f"result {k} differs from the unfaulted fleet's")

    for name, c in cases.items():
        rec = c["record"]
        if rec["survivors"]:
            fail(name, f"fleet processes outlived the case: "
                       f"{rec['survivors']}")
        if c["rc"] != 0:
            fail(name, f"the harness exited {c['rc']}")
        launches[name] = rec["kernel_launches"]
        summary[name] = {k: rec[k] for k in (
            "detect_s", "recover_s", "replayed", "rejoin_s", "heal_s",
            "time_to_full_capacity_s", "quarantine_s", "total_s")}
        summary[name]["seconds"] = c["seconds"]
    # (a) the spare takes stage 1 over and replays
    a = cases["a_kill"]
    replayed = a["record"]["replayed"] or 0
    if "moves rank 1 -> 2" not in a["outs"][0] or replayed < 1:
        fail("a_kill", f"no failover to rank 2 with a replay ({replayed})")
    same_rounds("a_kill", 1)
    problem = chaos_launch_problem(launches["a_kill"], arity, replayed)
    if problem:
        fail("a_kill", problem)
    # (b) no spare: a non-zero exit naming rank 1
    b = cases["b_no_spare"]
    if not b["record"]["aborted"] or "no spare capacity" not in \
            b["outs"][0] or "rank 1 died" not in b["outs"][0]:
        fail("b_no_spare", "the fleet did not abort naming rank 1")
    # (c) one rejoin at epoch 1, a heal back to ranks 0,1, every result once
    c = cases["c_restart_heal"]
    data = c["outs"][0]
    heal = [ln for ln in data.splitlines() if "heal_round=" in ln]
    if data.count("rejoin_rank=1") != 1 or "rejoin_rank=1 epoch=1" \
            not in data:
        fail("c_restart_heal", "rank 1 did not rejoin once at epoch 1")
    if len(heal) != 1 or "ranks=0,1" not in heal[0] or \
            c["record"]["time_to_full_capacity_s"] is None:
        fail("c_restart_heal", f"no heal to ranks 0,1: {heal}")
    same_rounds("c_restart_heal", 3)
    # (d) the straggler quarantined, every round delivered
    d = cases["d_quarantine"]
    if "quarantine_rank=1" not in d["outs"][0]:
        fail("d_quarantine", "rank 1 was not quarantined")
    same_rounds("d_quarantine", 4)
    log("chaos " + json.dumps({"cases": summary, "launches": launches,
                               "card": device_name}, sort_keys=True))
    return launches


# --- phase 19: the DCN driver's control loop --------------------------------

# (a) ViT-Base in 2 ranks on a deliberately skewed cut (stage 1 carries 40
# of the 48 sublayers) under `--rebalance auto`: the re-cut needs two
# consecutive windows blaming the same stage at a predicted gain over the
# threshold (the default `--rebalance-confirm 1`). Round 0's window (first
# CUDA uses) has blamed either stage, and the solver charges rank 0 a
# large fixed cost, so a window's predicted gain on the card has ranged
# 0.02-0.27: at the default 0.10 threshold, or in 4 rounds (2 windows
# after round 0's), the re-cut was left to chance; 0.05 and 6 rounds
CONTROL_SKEWED_PT = "1,8,9,48"
CONTROL_REBALANCE_ROUNDS = 6
CONTROL_REBALANCE_THRESHOLD = "0.05"
# The first re-cut holds for the rest of the run (cooldown 0 until PR 17's
# review round). Both ranks share one card, so once the skew is gone a
# window blames whichever rank the card's time slicing delayed, and with
# no cooldown the partition followed that noise: 8 -> 17 -> 13, 8 -> 17
# -> 11, and once on to the cut after sublayer 1, where the 8-bit edge
# alone puts the logits 0.108 of max |logit| from the exact forward
# (`--edge-cut-sweep`: cuts 1 and 2 above LOGIT_BOUND[8], every other cut
# within 0.028) and the 40-sublayer stage had grown to 47.
CONTROL_REBALANCE_COOLDOWN = str(CONTROL_REBALANCE_ROUNDS)
# (b) 3 ranks, the 2-stage cut on ranks 0 and 1, rank 2 idle; up pressure
# from a threshold (seconds of the bottleneck stage per microbatch) far
# below any ViT-Base stage's, confirmed over 2 windows, expands onto rank
# 2 at the second boundary: rounds 2-4 run 3 stages
CONTROL_AUTOSCALE_PT = "1,24,25,48"
CONTROL_AUTOSCALE_ROUNDS = 5
CONTROL_RANK_HIGH = "0.0005"
# (c) the reverse auction over 3 ranks of the card's profiles
CONTROL_AUCTION_RANKS = 3
# (d) GPT-2 in 2 ranks: batch, prompt, new tokens
DCN_GEN = (16, 192, 32)
DCN_GEN_BITS = (0, 8)


def rank_stages(out: str) -> list:
    """The (l, r) of each stage a rank built, in order (one per round it
    carried a stage), from the registry's `stage i: layers [l, r]` lines."""
    import re
    return [(int(a), int(b)) for a, b in
            re.findall(r"stage \d+: layers \[(\d+), (\d+)\]", out)]


def control_rebalance(weights_file: Path, exact) -> dict:
    """Phase 19a: the skewed fleet under `--rebalance auto`; the partition,
    items/s and each rank's kernel 1-3 launches per round, each round's
    logits against the single-shard forward."""
    from pipeedge_tpu_torch.models import edge_arity
    n_mb = BATCH // UBATCH
    fleet = dcn_fleet(["-m", MODEL, "-M", str(weights_file), "-pt",
                       CONTROL_SKEWED_PT, "-q", "8,0", "-r", "0,1", "-b",
                       str(BATCH), "-u", str(UBATCH), "--rounds",
                       str(CONTROL_REBALANCE_ROUNDS), "--rebalance", "auto",
                       "--rebalance-threshold",
                       CONTROL_REBALANCE_THRESHOLD,
                       "--rebalance-cooldown",
                       CONTROL_REBALANCE_COOLDOWN, "--save-results",
                       "results.npz", "--sched-timeout", "300"], 2,
                      BUILD_DIR / "control_rebalance")
    with np.load(fleet["dirs"][0] / "results.npz") as f:
        got = [f[f"arr_{i}"] for i in range(len(f.files))]
    heads, tails = (rank_stages(fleet["ranks"][r]["out"]) for r in (0, 1))
    want = [e.float().cpu().numpy() for e in exact]
    scale = max(float(np.abs(w).max()) for w in want)
    rounds = []
    for k in range(CONTROL_REBALANCE_ROUNDS):
        (l0, r0), (l1, r1) = heads[k], tails[k]
        arity = edge_arity(r0)
        outs = got[k * n_mb:(k + 1) * n_mb]
        rounds.append(dict(
            partition=[[l0, r0], [l1, r1]], n=len(outs),
            rel_err=max(float(np.abs(o - w).max())
                        for o, w in zip(outs, want)) / scale,
            finite=all(bool(np.isfinite(o).all()) for o in outs),
            items_per_s=fleet["report"].get(k, {}).get(
                "throughput_items_sec"),
            counts={r: {name: (fleet["ranks"][r]["rounds"].get(k) or {})
                        .get(name) for name in ("fused_encode",
                                                "fused_decode",
                                                "fused_attention")}
                    for r in (0, 1)},
            expected_counts={
                0: {"fused_encode": arity * n_mb, "fused_decode": 0,
                    "fused_attention": stage_attention(l0, r0) * n_mb},
                1: {"fused_encode": 0, "fused_decode": arity * n_mb,
                    "fused_attention": stage_attention(l1, r1) * n_mb}}))
    out0 = fleet["ranks"][0]["out"].splitlines()
    lines = [ln for ln in out0 if ln.startswith("rebalance_round=")]
    # the policy's reasons at each boundary (gain, streak, cooldown)
    reasons = [ln.split(": ", 1)[-1] for ln in out0 if "rebalance: " in ln]
    return dict(rounds=rounds, lines=lines, reasons=reasons,
                seconds=fleet["seconds"])


def edge_cut_sweep() -> list:
    """`--edge-cut-sweep`: ViT-Base in 2 stages with an 8-bit edge at every
    cut, in this process; each cut's logit error against the single-shard
    forward as phase 19(a) measures it (max |error| over max |exact|, on
    phase 19's seeded weights and batch)."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import edge_arity, registry, vit
    from pipeedge_tpu_torch.parallel.pipeline import build_pipeline
    weights = write_random_checkpoint(vit, MODEL, BUILD_DIR)
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    exact = single_shard_logits(MODEL, weights, inputs, "cuda")
    scale = max(float(e.abs().max()) for e in exact)
    rows, total = [], registry.get_model_layers(MODEL)
    for cut in range(1, total):
        pipe = build_pipeline(MODEL, [(1, cut), (cut + 1, total)],
                              model_file=str(weights), device="cuda",
                              quant_bits=[8, 0])
        outs, _ = pipe.run(inputs)
        err = max(float((o - e).abs().max()) for o, e in zip(outs, exact))
        rows.append(dict(cut=cut, arity=edge_arity(cut),
                         rel_err=err / scale,
                         within_bound=err / scale <= LOGIT_BOUND[8]))
        del pipe
    return rows


def control_autoscale(weights_file: Path, exact) -> dict:
    """Phase 19b: 3 ranks, the 2-stage cut, `--autoscale-ranks auto` under
    up pressure; the decisions, the stages per round, every round's
    logits against the single-shard forward (raw edges), and each rank's
    kernel-3 launches per round."""
    n_mb = BATCH // UBATCH
    fleet = dcn_fleet(["-m", MODEL, "-M", str(weights_file), "-pt",
                       CONTROL_AUTOSCALE_PT, "-q", "0,0", "-r", "0,1", "-b",
                       str(BATCH), "-u", str(UBATCH), "--rounds",
                       str(CONTROL_AUTOSCALE_ROUNDS), "--on-peer-death",
                       "failover", "--autoscale-ranks", "auto",
                       "--autoscale-rank-high", CONTROL_RANK_HIGH,
                       "--autoscale-rank-low", "0", "--save-results",
                       "results.npz", "--sched-timeout", "300"], 3,
                      BUILD_DIR / "control_autoscale")
    with np.load(fleet["dirs"][0] / "results.npz") as f:
        got = [f[f"arr_{i}"] for i in range(len(f.files))]
    want = [e.float().cpu().numpy() for e in exact]
    out0 = fleet["ranks"][0]["out"]
    stages = {r: rank_stages(fleet["ranks"][r]["out"]) for r in (0, 1, 2)}
    rounds = []
    for k in range(CONTROL_AUTOSCALE_ROUNDS):
        outs = got[k * n_mb:(k + 1) * n_mb]
        rounds.append(dict(
            n=len(outs),
            equal=len(outs) == n_mb and all(
                np.array_equal(o, w) for o, w in zip(outs, want)),
            items_per_s=fleet["report"].get(k, {}).get(
                "throughput_items_sec"),
            attention={r: (fleet["ranks"][r]["rounds"].get(k) or {})
                       .get("fused_attention") for r in (0, 1, 2)}))
    return dict(
        rounds=rounds, stages=stages,
        decisions=[ln for ln in out0.splitlines()
                   if ln.startswith(("autoscale_decision",
                                     "autoscale_rank"))],
        seconds=fleet["seconds"])


def auction_rank(rank: int, addrs: str, cwd: Path) -> subprocess.Popen:
    d = cwd / f"rank{rank}"
    d.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "pipeedge_tpu_torch.revauct", str(rank),
         str(CONTROL_AUCTION_RANKS), "-c", "dcn", "--dcn-addrs", addrs,
         "--host", f"h100-{rank}", "--dev-type", SCHED_DEV_TYPE,
         "-m", SCHED_MODEL, "-u", str(UBATCH), "--seed", "0",
         "-sch", "throughput_ordered",
         "-sm", str(H100_PROFILES / "models.yml"),
         "-sdt", str(H100_PROFILES / "device_types.yml"),
         "-sdnw", str(H100_PROFILES / "device_neighbors_world.yml")],
        cwd=d, env=dict(os.environ, PYTHONPATH=str(ROOT)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def control_auction() -> dict:
    """Phase 19c: `revauct --comm dcn` over 3 ranks (each bidding as one
    host of the card's profiles) against `--comm local` over the same
    hosts."""
    from pipeedge_tpu_torch.sched import miniyaml
    t0 = time.monotonic()
    local = subprocess.run(
        [sys.executable, "-m", "pipeedge_tpu_torch.revauct", "0",
         str(CONTROL_AUCTION_RANKS), "-m", SCHED_MODEL, "-u", str(UBATCH),
         "--seed", "0", "-sch", "throughput_ordered",
         "-sm", str(H100_PROFILES / "models.yml"),
         "-sdt", str(H100_PROFILES / "device_types.yml"),
         "-sd", str(H100_PROFILES / "devices.yml"),
         "-sdnw", str(H100_PROFILES / "device_neighbors_world.yml")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    addrs = free_addrs(CONTROL_AUCTION_RANKS)
    cwd = BUILD_DIR / "control_auction"
    procs = [auction_rank(r, addrs, cwd)
             for r in range(1, CONTROL_AUCTION_RANKS)]
    procs.insert(0, auction_rank(0, addrs, cwd))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    sched = miniyaml.loads(outs[0][0]) if procs[0].returncode == 0 else None
    return dict(
        local_rc=local.returncode, rcs=[p.returncode for p in procs],
        local=miniyaml.loads(local.stdout) if local.returncode == 0
        else local.stderr[-2000:],
        dcn=sched if sched is not None else outs[0][1][-2000:],
        released=["released by auctioneer" in err for _, err in outs[1:]],
        seconds=time.monotonic() - t0)


def dcn_generate_reference(weights_file: Path, bits: int) -> dict:
    """The DCN fleet's computation in this process: both stages in
    lockstep on the card, the edge through the plain codec at `bits`
    (none at 0). Returns each row's tokens and, per step and row, the
    top-2 logits, their tokens and the max |logit| (`near_tie_rule`); at
    bit 0 also whether the tokens equal `DecodePipeline.generate`'s (the
    one-process `generate`)."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import quant
    from pipeedge_tpu_torch.parallel import decode
    batch, prompt, new = DCN_GEN
    cfg = registry.get_model_config(DECODE_MODEL)
    family = registry.get_model_entry(DECODE_MODEL).family.FAMILY
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            size=(batch, prompt))
    max_len = prompt + new
    stages = []
    for i, (l, r) in enumerate(DECODE_PARTITION):
        _, params, sc = registry.module_shard_factory(
            DECODE_MODEL, str(weights_file), l, r, stage=i, device="cuda")
        pre, dec = decode.make_stage_fns(family, cfg, sc)
        stages.append((params, pre, dec, decode.init_cache(
            cfg, (r - l + 1) // 4, batch, max_len, device="cuda")))
    tokens, top2, amax = [], [], []
    data = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    for step in range(new):
        pos = None if step == 0 else prompt + step - 1
        for i, (params, pre, dec, cache) in enumerate(stages):
            if i and bits:
                data = quant.tensor_decode_outerdim(
                    quant.tensor_encode_outerdim(data, bits))
            data, _ = (pre(params, data, cache) if pos is None else
                       dec(params, data, cache, pos,
                           read_len=decode.attend_bucket(pos + 1, max_len)))
        last = (data[:, -1] if pos is None else data[:, 0]).float()
        top2.append(torch.topk(last, 2, dim=-1))
        amax.append(last.abs().amax(dim=-1))
        tokens.append(last.argmax(dim=-1))
        data = tokens[-1][:, None]
    out = np.concatenate([ids, torch.stack(tokens, 1).cpu().numpy()], 1)
    res = dict(ids=out,
               top2_values=torch.stack([t.values for t in top2], 1).cpu(),
               top2_tokens=torch.stack([t.indices for t in top2], 1).cpu(),
               max_abs=torch.stack(amax, 1).cpu())
    if not bits:
        pipe = decode.build_decode_pipeline(
            DECODE_MODEL, DECODE_PARTITION, max_len=max_len,
            model_file=str(weights_file), device="cuda")
        res["equal_one_process"] = bool(np.array_equal(
            pipe.generate(ids, new).cpu().numpy(), out))
        del pipe
    del stages
    return res


def dcn_generate_fleet(weights_file: Path, bits: int) -> dict:
    """Phase 19d: `python -m pipeedge_tpu_torch.generate --dcn-addrs` in
    2 ranks at edge bits `bits`: rank 0's report lines, every row it
    generated (`--save-ids`) and each rank's launches."""
    import re
    batch, prompt, new = DCN_GEN
    addrs = free_addrs(2)
    cwd = BUILD_DIR / f"control_generate{bits}"
    argv = ["-m", DECODE_MODEL, "-M", str(weights_file), "-pt",
            ",".join(f"{l},{r}" for l, r in DECODE_PARTITION), "-b",
            str(batch), "--prompt-len", str(prompt), "--new-tokens",
            str(new), "--dcn-addrs", addrs, "--edge-bits", str(bits),
            "--save-ids", "ids.npz"]
    procs = []
    for rank in (1, 0):
        d = cwd / f"rank{rank}"
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "out.log", "w") as log_file:
            procs.append((rank, d, subprocess.Popen(
                [sys.executable, "-m", "pipeedge_tpu_torch.generate", *argv,
                 "--rank", str(rank)], cwd=d, stdout=log_file,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(ROOT)))))
    t0 = time.monotonic()
    try:
        for _, _, p in procs:
            p.wait(timeout=400)
    finally:
        reap(procs)
    outs = {rank: rank_output(d) for rank, d, _ in procs}
    res = dict(bits=bits, seconds=time.monotonic() - t0,
               rcs={rank: p.returncode for rank, _, p in procs},
               tail={rank: o[-3000:] for rank, o in outs.items()})
    hit = re.search(r"sample continuation ids: (\[[\d, ]*\])", outs[0])
    res["ids"] = json.loads(hit.group(1)) if hit else None
    saved = cwd / "rank0" / "ids.npz"
    res["rows"] = np.load(saved)["ids"] if saved.exists() else None
    rate = re.search(r"= ([\d.]+) tok/s \(2 DCN ranks\)", outs[0])
    res["tokens_per_s"] = float(rate.group(1)) if rate else None
    res["launches"] = {}
    for rank, out in outs.items():
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"rank={rank} kernel_launches=")]
        res["launches"][rank] = (json.loads(line[-1].split("=", 2)[2])
                                 if line else None)
    return res


def control_path(alongside=None) -> dict:
    """Phase 19: (a) alone (its windows must measure the skew, not the
    other fleets' start-up on the host's cores), then (b)-(d) at once,
    each its own fleet (they share the card and the host's cores, which
    their times carry), with the references of (d) in this process (in
    turn until PR 17). `alongside`, a callable, runs with (b)-(d) (phase
    20's prelude, the script's time); its result is `res["alongside"]`."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch import runtime
    vit_w = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    gpt2_w = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    exact = single_shard_logits(MODEL, vit_w, inputs, "cuda")
    t0 = time.monotonic()
    res = {"a": control_rebalance(vit_w, exact)}

    def references():
        t_ref = time.monotonic()
        out = {bits: dcn_generate_reference(gpt2_w, bits)
               for bits in DCN_GEN_BITS}
        res["reference_seconds"] = time.monotonic() - t_ref
        return out

    with ThreadPoolExecutor(4 + len(DCN_GEN_BITS)) as pool:
        futs = {"b": pool.submit(control_autoscale, vit_w, exact),
                "c": pool.submit(control_auction),
                "reference": pool.submit(references)}
        for bits in DCN_GEN_BITS:
            futs[f"d{bits}"] = pool.submit(dcn_generate_fleet, gpt2_w, bits)
        if alongside is not None:
            futs["alongside"] = pool.submit(alongside)
        res.update({name: f.result() for name, f in futs.items()})
    res["fleets_seconds"] = time.monotonic() - t0
    for name in ("a", "b", "c", "d0", "d8"):
        log(f"phase 19{name}: {res[name]['seconds']:.1f} s")
    return res


def near_tie_rule(rows, ref: dict, prompt: int) -> dict:
    """Every row of a DCN generation ([B, prompt + new]) against the
    one-process decode with the plain codec at the cut: each row equal,
    or, at its first differing step, the fleet's token is that decode's
    second choice there and its top-2 logit gap is within 1e-4 of its
    max |logit| (a near-tie that a one-ulp difference of the stage
    outputs can flip; the row's later steps then follow another prefix
    and are not compared). `differing` has each such row's step."""
    want = ref["ids"]
    if rows is None or rows.shape != want.shape \
            or not np.array_equal(rows[:, :prompt], want[:, :prompt]):
        return dict(equal=False, ok=False, rows=None if rows is None
                    else list(rows.shape), differing=[])
    differing = []
    for b in range(want.shape[0]):
        diff = np.flatnonzero(rows[b, prompt:] != want[b, prompt:])
        if not diff.size:
            continue
        t = int(diff[0])
        got = int(rows[b, prompt + t])
        gap = float(ref["top2_values"][b, t, 0] - ref["top2_values"][b, t, 1])
        bound = 1e-4 * float(ref["max_abs"][b, t])
        second = int(ref["top2_tokens"][b, t, 1])
        differing.append(dict(row=b, step=t, got=got,
                              want=int(want[b, prompt + t]), second=second,
                              top2_gap=gap, bound=bound,
                              ok=second == got and gap <= bound))
    return dict(equal=not differing, rows=list(rows.shape),
                differing=differing, ok=all(d["ok"] for d in differing))


def check_control_path(res, device_name: str) -> dict:
    """Every check of phase 19; returns each kernel's launches per rank
    and round (the kernels line's `control_launches`)."""
    from pipeedge_tpu_torch.models import registry
    n_mb = BATCH // UBATCH
    a, b, c = res["a"], res["b"], res["c"]
    for k, r in enumerate(a["rounds"]):
        log(f"control rebalance round {k}: " + json.dumps(
            {**r, "card": device_name}, sort_keys=True))
        if r["n"] != n_mb or not r["finite"]:
            raise AssertionError(f"control rebalance round {k}: {r['n']} "
                                 f"results, finite={r['finite']}")
        if not 0 < r["rel_err"] <= LOGIT_BOUND[8]:
            raise AssertionError(f"control rebalance round {k}: logit "
                                 f"error {r['rel_err']} not in (0, "
                                 f"{LOGIT_BOUND[8]}]")
        if r["counts"] != r["expected_counts"]:
            raise AssertionError(f"control rebalance round {k}: launches "
                                 f"{r['counts']} != {r['expected_counts']}")
    log("control rebalance: " + json.dumps(
        {"lines": a["lines"], "reasons": a["reasons"]}))
    first, last = a["rounds"][0]["partition"], a["rounds"][-1]["partition"]
    held = first[1][1] - first[1][0] + 1
    if not a["lines"] or last[1][1] - last[1][0] + 1 >= held:
        raise AssertionError(f"control rebalance: the stage of {held} "
                             f"sublayers was not re-cut ({first} -> "
                             f"{last}; {a['lines']}; the policy: "
                             f"{a['reasons']})")
    log("control autoscale: " + json.dumps(
        {"decisions": b["decisions"], "stages": b["stages"],
         "rounds": b["rounds"], "card": device_name}, sort_keys=True))
    ups = [ln for ln in b["decisions"] if ln.startswith(
        "autoscale_rank direction=up")]
    if len(ups) != 1 or "ranks=0,1,2" not in ups[0]:
        raise AssertionError(f"control autoscale: no scale-up onto rank 2: "
                             f"{b['decisions']}")
    up_round = int(ups[0].split("round=")[1].split()[0])
    if not b["stages"][2] or \
            len(b["stages"][2]) != CONTROL_AUTOSCALE_ROUNDS - up_round - 1:
        raise AssertionError(f"control autoscale: rank 2 built "
                             f"{b['stages'][2]} after the scale-up at "
                             f"round {up_round}")
    blocks = registry.get_model_config(MODEL).num_hidden_layers
    for k, r in enumerate(b["rounds"]):
        if r["n"] != n_mb or not r["equal"]:
            raise AssertionError(f"control autoscale round {k}: not equal "
                                 "to the single-shard forward")
        if bool(r["attention"][2]) != (k > up_round):
            raise AssertionError(f"control autoscale round {k}: rank 2's "
                                 f"kernel-3 launches {r['attention'][2]}")
        if sum(v or 0 for v in r["attention"].values()) != blocks * n_mb:
            raise AssertionError(f"control autoscale round {k}: kernel-3 "
                                 f"launches {r['attention']} are not one "
                                 "per block and microbatch")
    log("control auction: " + json.dumps({k: c[k] for k in (
        "local_rc", "rcs", "dcn", "released", "seconds")}))
    if c["local_rc"] != 0 or c["rcs"] != [0] * CONTROL_AUCTION_RANKS or \
            c["dcn"] != c["local"] or not all(c["released"]):
        raise AssertionError(f"control auction: dcn {c['dcn']} != local "
                             f"{c['local']} (rcs {c['rcs']}, released "
                             f"{c['released']})")
    batch, prompt, new = DCN_GEN
    gen = {}
    for bits in DCN_GEN_BITS:
        d, ref = res[f"d{bits}"], res["reference"][bits]
        expected = {r: {"fused_encode": new * 2 if bits and r == 0 else 0,
                        "fused_decode": new * 2 if bits and r == 1 else 0,
                        "fused_attention": 0} for r in (0, 1)}
        launches = {r: {k: (d["launches"][r] or {}).get(k) for k in
                        expected[r]} for r in (0, 1)}
        rule = near_tie_rule(d["rows"], ref, prompt)
        gen[bits] = dict(tokens_per_s=d["tokens_per_s"], launches=launches,
                         rule=rule, seconds=d["seconds"])
        log(f"control generate {bits}-bit: " + json.dumps(
            {**gen[bits], "card": device_name}, sort_keys=True))
        if d["rcs"] != {0: 0, 1: 0} or d["ids"] is None \
                or d["rows"] is None:
            raise AssertionError(f"control generate {bits}-bit: ranks "
                                 f"exited {d['rcs']}:\n{d['tail']}")
        if d["ids"] != d["rows"][0, prompt:].tolist():
            raise AssertionError(f"control generate {bits}-bit: the printed "
                                 f"sample {d['ids']} is not row 0 of the "
                                 "saved ids")
        if launches != expected:
            raise AssertionError(f"control generate {bits}-bit: launches "
                                 f"{launches} != {expected}")
        if bits == 0 and not (rule["equal"] and rule["ok"]
                              and ref["equal_one_process"]):
            raise AssertionError(f"control generate 0-bit: the fleet's ids "
                                 f"differ from the one-process run: {rule}")
        if not rule["ok"]:
            raise AssertionError(f"control generate {bits}-bit: the ids "
                                 f"differ beyond a near-tie: {rule}")
    return {"rebalance": {f"round{k}": r["counts"]
                          for k, r in enumerate(a["rounds"])},
            "autoscale_attention": {f"round{k}": r["attention"]
                                    for k, r in enumerate(b["rounds"])},
            "generate": {bits: g["launches"] for bits, g in gen.items()}}


# --- phase 20: disaggregated serving -----------------------------------------

# GPT-2 at full width and depth (phase 6's npz), fp cache on 1024 pages of
# 16 tokens, the wave executor and phase 11's brownout watermarks (far above
# this traffic, so no rung turns shipping off): 8 requests of [1, 192] + 64
# new tokens, streamed by 4 clients at a time, colocated and then through
# `--disaggregate local`, `wire` at ship bits 0 and 8 in this process, then
# `process` (2 prefill workers, ship bits 8) as its own server; then the
# chaos harness's serve-disagg target on the same weights at ship bits 8
DISAGG_FLAGS = ["-m", DECODE_MODEL, "-pt", "1,24,25,48", "--max-len", "1024",
                "-t", "float32", "--kv-pages", "1024", "--kv-page-size",
                "16", "--brownout-p95-high", "600", "--brownout-p95-low",
                "300"]
DISAGG_TRAFFIC = (8, 192, 64)      # requests, prompt length, new tokens
DISAGG_CLIENTS = 4
DISAGG_RUNS = (("colocated", "off", 0), ("local", "local", 0),
               ("wire0", "wire", 0), ("wire8", "wire", 8))
DISAGG_PREFILL_RANKS = 2
# process mode: single requests of one new token before the traffic, each
# a lease alone (round robin: rank 2's first, rank 1's first, rank 2's
# second), so each rank's first lease is timed apart from a warm one
DISAGG_FIRST_LEASES = 3
DISAGG_TRACE_REPS = 5              # traced requests per ship path (medians)


def disagg_prompts(vocab: int, n: int, seed: int = 20) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=DISAGG_TRAFFIC[1]).tolist()
            for _ in range(n)]


def disagg_references(pipe, prompts, new: int) -> dict:
    """Each prompt solo through `pipe.generate` (the colocated answer),
    and the 8-bit ship's one-process decode: the prompt pass, its K/V
    rows through the plain codec at 8 bits, the first token from the
    exact logits, then greedy steps; per step and row the top-2 logits,
    their tokens and the max |logit| (`near_tie_rule`)."""
    from pipeedge_tpu_torch.ops import quant
    solo, ids8, top2, amax = [], [], [], []
    with torch.inference_mode():
        for p in prompts:
            ids = torch.as_tensor([p], dtype=torch.long, device=pipe.device)
            solo.append(pipe.generate(ids, new).cpu().numpy())
            out, caches = pipe._prefill(ids)
            s = ids.shape[1]
            for cache in caches:
                for name in ("k", "v"):
                    rows = cache[name][:, :, :s].contiguous()
                    cache[name][:, :, :s] = quant.tensor_decode_outerdim(
                        quant.tensor_encode_outerdim(rows, 8))
            last, toks, t2, am = out[:, -1].float(), [], [], []
            for step in range(new):
                if step:
                    data = toks[-1][:, None]
                    for i, st in enumerate(pipe.stages):
                        data, caches[i] = pipe._decode_step(
                            st, data, caches[i], s + step - 1)
                    last = data[:, -1].float()
                t2.append(torch.topk(last, 2, dim=-1))
                am.append(last.abs().amax(dim=-1))
                toks.append(last.argmax(dim=-1))
            ids8.append(np.concatenate(
                [np.asarray([p]), torch.stack(toks, 1).cpu().numpy()], 1))
            top2.append(t2)
            amax.append(torch.stack(am, 1).cpu())
    ref8 = dict(
        ids=np.concatenate(ids8),
        top2_values=torch.cat([torch.stack([t.values for t in t2], 1).cpu()
                               for t2 in top2]),
        top2_tokens=torch.cat([torch.stack([t.indices for t in t2], 1).cpu()
                               for t2 in top2]),
        max_abs=torch.cat(amax))
    return dict(solo=np.concatenate(solo), ref8=ref8)


def disagg_clients(port: int, prompts, new: int) -> list:
    """The traffic: every prompt streamed, DISAGG_CLIENTS at a time; per
    request its ids, the server's first-token ms and the client's clock."""
    import queue
    import threading
    import urllib.request
    todo: "queue.Queue" = queue.Queue()
    for i, p in enumerate(prompts):
        todo.put((i, p))
    out: list = [None] * len(prompts)

    def client():
        while True:
            try:
                i, p = todo.get_nowait()
            except queue.Empty:
                return
            t0 = time.monotonic()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate",
                    data=json.dumps({"ids": [p], "new_tokens": new,
                                     "stream": True}).encode())
                with urllib.request.urlopen(req, timeout=600) as resp:
                    last = [ln for ln in resp.read().decode().splitlines()
                            if ln.strip()][-1]
                final = json.loads(last)
                out[i] = dict(ids=final["ids"][0],
                              first_token_ms=final["first_token_ms"])
            except Exception as exc:   # noqa: BLE001 — the check reports it
                out[i] = dict(error=repr(exc))
            out[i].update(t0=t0, t1=time.monotonic())

    threads = [threading.Thread(target=client)
               for _ in range(DISAGG_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def disagg_summary(out: list, prompt: int) -> dict:
    """Answers [n, prompt + new] (None for a failed request), errors,
    first-token p50/p95, tokens/s over the traffic's wall."""
    done = [o for o in out if "ids" in o]
    first = [o["first_token_ms"] for o in done]
    wall = max(o["t1"] for o in out) - min(o["t0"] for o in out)
    tokens = sum(len(o["ids"]) - prompt for o in done)
    return dict(
        answers=(np.asarray([o["ids"] for o in out])
                 if len(done) == len(out) else None),
        errors=[o["error"] for o in out if "error" in o],
        first_token_ms_p50=float(np.percentile(first, 50)) if first else None,
        first_token_ms_p95=float(np.percentile(first, 95)) if first else None,
        wall_s=wall, tokens=tokens, tok_per_s=tokens / wall)


DISAGG_COUNTERS = (("prefills", "pipeedge_kv_prefills_total", {}),
                   ("ship_bytes_local", "pipeedge_kv_ship_bytes_total",
                    {"path": "local"}),
                   ("ship_bytes_wire", "pipeedge_kv_ship_bytes_total",
                    {"path": "wire"}),
                   ("colocated", "pipeedge_kv_prefill_colocated_total", {}))


def disagg_serve(pipe, args, prompts, warm, new: int, label: str) -> dict:
    """The traffic through the port's HTTP front end over `pipe` with the
    flags `args` (its prefill fleet built by the entry's
    `build_prefill_fleet`), after one request of prompt `warm` (a new
    executor thread's first stage-steps pay for its first library
    calls); the launch counts set to 0 just before the clients start and
    read just after the last one returns; the fleet's counters as deltas
    of /metrics (the registry outlives a server)."""
    import threading
    from pipeedge_tpu_torch import serve, telemetry
    from pipeedge_tpu_torch.ops import _build

    telemetry.configure(rank=0)
    fleet, _, _ = serve.build_prefill_fleet(args, pipe)
    service = serve.make_service(args, pipe, prefill_fleet=fleet)
    httpd = serve.Server(("127.0.0.1", 0),
                         serve.make_handler(service, args.model_name))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        http_json(port, "/generate", {"ids": [warm], "new_tokens": 2})
        before = http_json(port, "/metrics")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = disagg_clients(port, prompts, new)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        after = http_json(port, "/metrics")
        kv = http_json(port, "/healthz")["serving"]["kv"]
        pool = service.kv_backend.pool.stats()
        cached = service.kv_backend.trie.stats()["pages_cached"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
    res = dict(label=label, disaggregate=args.disaggregate,
               ship_bits=args.kv_ship_bits, requests=len(prompts),
               counts=counts, leaked=kv["leaked"],
               disaggregated=kv["disaggregated"],
               pool_whole=(pool["pages_free"] + cached == pool["pages_total"]
                           and pool["owners"] == 0),
               **disagg_summary(out, len(prompts[0])))
    for key, family, labels in DISAGG_COUNTERS:
        res[key] = serve_metric(after, family, **labels) - serve_metric(
            before, family, **labels)
    return res


def disagg_trace(pipe, bits: int, prompt, local: bool = False) -> dict:
    """Where one disaggregated request's time goes, on the host's clock
    with the card synchronized at each boundary: the prompt pass on the
    prefill pipeline, the ship (`wire`: encode and read back, the
    loopback socket, the decode onto the card; `local`: none), the
    install (`admit`: pages, rows, the first token) and the first decode
    step through the page tables. Medians over DISAGG_TRACE_REPS."""
    from pipeedge_tpu_torch.kv import PagedKvBackend, ship
    from pipeedge_tpu_torch.parallel import batcher
    from pipeedge_tpu_torch.parallel.decode import build_decode_pipeline
    from pipeedge_tpu_torch.telemetry import metrics as prom
    prefill = build_decode_pipeline(
        DECODE_MODEL, DECODE_PARTITION, max_len=DECODE_MAX_LEN,
        stage_params=[st["params"] for st in pipe.stages],
        device=pipe.device)
    kv = PagedKvBackend(pipe, 64, 16, registry=prom.Registry())

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    segs: dict = {}
    sizes = []
    with ship.device_stream(pipe.device):
        for rep in range(DISAGG_TRACE_REPS + 1):
            t = [clock()]
            ids = torch.as_tensor([prompt], dtype=torch.long,
                                  device=pipe.device)
            out, caches = prefill._prefill(ids)
            logits = out[:, -1]
            t.append(clock())
            s = ids.shape[1]
            if local:
                handle = {"stage_rows": [{n: c[n][:, :, :s] for n in "kv"}
                                         for c in caches],
                          "logits": logits, "prompt_len": s}
                t += [t[-1]] * 3
            else:
                blob = ship.frames_to_bytes(ship.encode_kv_ship(
                    caches, s, logits, bits=bits))
                t.append(clock())
                back = ship.frames_from_bytes(ship.ship_over_socket(blob))
                t.append(clock())
                handle = ship.decode_kv_ship(back, pipe.dtype,
                                             device=pipe.device)
                t.append(clock())
                sizes.append(len(blob))
            req = batcher._build_request(pipe, f"trace{rep}", [prompt], 2,
                                         0.0, 0, 0, None, None, None,
                                         shipped=handle)
            kind, data = kv.admit(req)
            t.append(clock())
            for i in range(len(pipe.stages)):
                data = kv.run_stage(i, req, data, kind)
            req.tokens.append(batcher._pick(req, data))
            t.append(clock())
            kv.release(req)
            if rep:              # the first is a warm-up
                for name, a, b in (("prefill", 0, 1), ("encode", 1, 2),
                                   ("socket", 2, 3), ("decode", 3, 4),
                                   ("install", 4, 5),
                                   ("first_step", 5, 6)):
                    segs.setdefault(name, []).append((t[b] - t[a]) * 1e3)
    res = {f"{name}_ms": float(np.median(v)) for name, v in segs.items()}
    res["ship_ms"] = res["encode_ms"] + res["socket_ms"] + res["decode_ms"]
    res["ship_mb"] = (float(np.median(sizes)) / 1e6) if sizes else 0.0
    del prefill, kv
    return res


def disagg_codec(pipe, prompt) -> dict:
    """Kernels 1 and 2 at the ship's shape (one stage's K rows of one
    prompt, [6, 1, 192, 12, 64] f32) against the plain codec: words,
    scale, shift and decoded values equal, each timed beside the plain
    version with its bound."""
    from pipeedge_tpu_torch.ops import fused_quant
    from pipeedge_tpu_torch.ops import quant as quant_ops
    with torch.inference_mode():
        ids = torch.as_tensor([prompt], dtype=torch.long,
                              device=pipe.device)
        _, caches = pipe._prefill(ids)
        rows = caches[0]["k"][:, :, :ids.shape[1]].contiguous()
        del caches
        enc = fused_quant.fused_encode_outerdim(rows, 8)
        plain = quant_ops.tensor_encode_outerdim(rows, 8)
        dec = fused_quant.fused_decode_outerdim(enc)
        equal = bool(torch.equal(enc.data, plain.data)
                     and torch.equal(enc.scale, plain.scale)
                     and torch.equal(enc.shift, plain.shift)
                     and torch.equal(dec,
                                     quant_ops.tensor_decode_outerdim(plain)))
        shape = list(rows.shape)
        return dict(
            shape=shape, equal_plain=equal,
            max_abs_err=float((dec - quant_ops.tensor_decode_outerdim(
                plain)).abs().max()),
            encode_ms=time_ms(lambda: fused_quant.fused_encode_outerdim(
                rows, 8)),
            plain_encode_ms=time_ms(
                lambda: quant_ops.tensor_encode_outerdim(rows, 8)),
            decode_ms=time_ms(lambda: fused_quant.fused_decode_outerdim(enc)),
            plain_decode_ms=time_ms(
                lambda: quant_ops.tensor_decode_outerdim(enc)),
            bound_ms=codec_bytes(shape, 8) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")


class DisaggProcess:
    """`python -m pipeedge_tpu_torch.serve --disaggregate process` with
    DISAGG_PREFILL_RANKS workers at ship bits 8 on phase 6's weights, its
    output lines stamped as they come; the server, its workers and their
    respawns carry the chaos harness's fleet tag, so `stop` reaps
    whatever is left."""

    def __init__(self, weights: Path):
        import atexit
        import uuid
        from pipeedge_tpu_torch import chaos_dcn
        self.tag = uuid.uuid4().hex
        self.stopped = None
        # a phase that fails between the start-up and the run (phase 19's
        # checks, say) still leaves no process of this fleet behind
        atexit.register(self.stop)
        self.port = int(free_addrs(1).rsplit(":", 1)[1])
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pipeedge_tpu_torch.serve",
             *DISAGG_FLAGS, "-M", str(weights), "--disaggregate", "process",
             "--prefill-ranks", str(DISAGG_PREFILL_RANKS),
             "--kv-ship-bits", "8", "--port", str(self.port)],
            env=chaos_dcn.fleet_env(self.tag), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
        self.reader = chaos_dcn.TimedReader(self.proc)

    def wait_ready(self, timeout: float = 600.0) -> float:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            hit = self.reader.first("serving ")
            if hit is not None:
                return hit[0] - self.t0
            if self.proc.poll() is not None:
                raise AssertionError("disaggregated server exited: " + "\n"
                                     .join(ln for _, ln in self.reader.lines))
            time.sleep(0.2)
        raise AssertionError("disaggregated server never came up")

    def run(self, prompts, first_prompts, new: int) -> dict:
        res = dict(startup_s=self.wait_ready())
        first = []
        for p in first_prompts:
            t0 = time.monotonic()
            http_json(self.port, "/generate", {"ids": [p], "new_tokens": 1})
            first.append((time.monotonic() - t0) * 1e3)
        res["first_lease_ms"] = first
        res.update(disagg_summary(disagg_clients(self.port, prompts, new),
                                  len(prompts[0])))
        res["healthz_kv"] = http_json(self.port, "/healthz")["serving"]["kv"]
        prefill = res["healthz_kv"]["prefill"]
        res.update(leases=prefill["leases"], leaked=res["healthz_kv"]["leaked"],
                   colocated=sum(prefill["colocated"].values()))
        # card memory: each worker's allocator (its /healthz), and the
        # card's use less this process's reservation (`disagg_path` takes
        # out what is left once the fleet is gone)
        res["memory_mib"] = {
            f"prefill r{r}": {k.replace("_bytes", "_mib"): v / 2**20
                              for k, v in (http_json_url(
                                  w["http_url"] + "/healthz")[
                                  "device_memory"] or {}).items()}
            for r, w in prefill["workers"].items()}
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            res["memory_mib"]["card_in_use_mib"] = (
                total - free - torch.cuda.memory_reserved()) / 2**20
        return res

    def stop(self) -> dict:
        from pipeedge_tpu_torch import chaos_dcn
        if self.stopped is not None:
            return self.stopped
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        survivors = chaos_dcn.reap_fleet(self.tag, 30.0)
        self.reader.join()
        self.stopped = dict(rc=rc, survivors=survivors,
                            launches=chaos_dcn.server_launches(self.reader))
        return self.stopped


def disagg_chaos(weights: Path, device: str = "cuda") -> dict:
    """Phase 20(b): the chaos harness's serve-disagg target on the card,
    `kill@2` on prefill worker rank 1 at ship bits 8; its record."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pipeedge_tpu_torch.chaos_dcn", "--target",
         "serve-disagg", "--chaos", "kill@2", "--expect", "disagg",
         "--device", device, "-m", DECODE_MODEL, "-pt",
         ",".join(f"{l},{r}" for l, r in DECODE_PARTITION),
         "-M", str(weights), "--kv-ship-bits", "8", "--timeout", "600"],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return dict(rc=proc.returncode, seconds=time.monotonic() - t0,
                record=json.loads(lines[-1]) if lines else None,
                stderr_tail=proc.stderr[-3000:])


def disagg_prelude(device: str = "cuda", chaos=None) -> dict:
    """Phase 20's untimed start: (b), the chaos case, in a thread (unless
    its result `chaos` is given: `main` runs it beside phase 18's cases);
    the process-mode server's start-up; this process's decode pipeline
    and the references. `main` runs it beside phase 19's fleets (b)-(d),
    the script's time: its work shares the host and the card with them,
    and none of it is timed."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import registry
    t0 = time.monotonic()
    cfg = registry.get_model_config(DECODE_MODEL)
    weights = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    with ThreadPoolExecutor(1) as pool:
        pending = (pool.submit(disagg_chaos, weights, device)
                   if chaos is None else None)
        process = DisaggProcess(weights)
        try:
            pipe = serve.build_pipeline(serve.parse_args(
                DISAGG_FLAGS + ["-M", str(weights)]))
            prompts = disagg_prompts(cfg.vocab_size, DISAGG_TRAFFIC[0])
            ref = disagg_references(pipe, prompts, DISAGG_TRAFFIC[2])
            process.wait_ready()
        except BaseException:
            process.stop()
            raise
        return dict(weights=weights, process=process, pipe=pipe,
                    prompts=prompts, ref=ref,
                    chaos=chaos if pending is None else pending.result(),
                    seconds=time.monotonic() - t0)


def disagg_path(card: str, device: str = "cuda", prelude=None) -> dict:
    """Phase 20: disaggregated serving, after `disagg_prelude` (run here
    when not given): the timed in-process runs, each alone on the card
    with the process-mode server idle, then the process run, the traced
    requests and the codec at the ship's shape."""
    from pipeedge_tpu_torch import serve
    from pipeedge_tpu_torch.models import registry
    t0 = time.monotonic()
    pre = disagg_prelude(device) if prelude is None else prelude
    n, prompt_len, new = DISAGG_TRAFFIC
    cfg = registry.get_model_config(DECODE_MODEL)
    first_prompts = disagg_prompts(cfg.vocab_size, DISAGG_FIRST_LEASES,
                                   seed=21)
    warm = disagg_prompts(cfg.vocab_size, 1, seed=22)[0]
    pipe, prompts, process = pre["pipe"], pre["prompts"], pre["process"]
    res: dict = {"card": card, "runs": {}, "chaos": pre["chaos"],
                 "ref": pre["ref"], "prelude_s": pre["seconds"]}
    try:
        for label, mode, bits in DISAGG_RUNS:
            args = serve.parse_args(DISAGG_FLAGS + [
                "-M", str(pre["weights"]), "--disaggregate", mode,
                "--kv-ship-bits", str(bits)])
            res["runs"][label] = disagg_serve(pipe, args, prompts, warm,
                                              new, label)
            log("disagg run " + json.dumps(
                {k: v for k, v in res["runs"][label].items()
                 if k != "answers"}, sort_keys=True))
        res["runs"]["process"] = process.run(prompts, first_prompts, new)
    finally:
        res["process_stop"] = process.stop()
    if device == "cuda":
        # the card's use by the server and its workers together (CUDA
        # contexts included): what it was with them up, less what it is
        # now they are gone, this process's reservation taken out of both
        free, total = torch.cuda.mem_get_info()
        mem = res["runs"]["process"]["memory_mib"]
        mem["server and workers"] = mem.pop("card_in_use_mib") - (
            total - free - torch.cuda.memory_reserved()) / 2**20
    res["trace"] = {label: disagg_trace(pipe, bits, prompts[0],
                                        local=label == "local")
                    for label, bits in (("local", 0), ("wire0", 0),
                                        ("wire8", 8))}
    res["codec"] = disagg_codec(pipe, prompts[0])
    del pipe, pre
    free_card()
    res["seconds"] = time.monotonic() - t0
    return res


def check_disagg_path(res, device_name: str) -> dict:
    """Every check of phase 20; returns each kernel's launches on the
    driven paths (the kernels line's `disagg_launches`)."""
    n, prompt_len, new = DISAGG_TRAFFIC
    ship_expected = 2 * len(DECODE_PARTITION)    # K and V per stage
    solo, ref8 = res["ref"]["solo"], res["ref"]["ref8"]
    log(f"phase 20 timeline: the prelude {res['prelude_s']:.1f} s, (b) "
        f"{res['chaos']['seconds']:.1f} s, the rest {res['seconds']:.1f} s")
    problems = []
    for label, run in res["runs"].items():
        summary = {k: run.get(k) for k in (
            "first_token_ms_p50", "first_token_ms_p95", "tok_per_s",
            "wall_s", "tokens", "prefills", "ship_bytes_wire",
            "ship_bytes_local", "colocated", "counts", "leaked",
            "leases", "first_lease_ms", "memory_mib", "startup_s")}
        log(f"disagg {label}: " + json.dumps(summary | {
            "card": device_name}, sort_keys=True))
        if run["errors"] or run["answers"] is None:
            problems.append(f"{label}: errors {run['errors']}")
            continue
        if label in ("wire8", "process"):
            rule = near_tie_rule(run["answers"], ref8, prompt_len)
            run["near_tie"] = rule
            if not rule["ok"]:
                problems.append(f"{label}: answers against the 8-bit "
                                f"ship's decode: {rule}")
        elif not np.array_equal(run["answers"], solo):
            bad = [i for i in range(n)
                   if not np.array_equal(run["answers"][i], solo[i])]
            problems.append(f"{label}: requests {bad} differ from their "
                            "colocated solo runs")
    for label, mode, bits in DISAGG_RUNS:
        run = res["runs"][label]
        codec = {k: run["counts"][k] for k in ("fused_encode",
                                                "fused_decode")}
        routed = n if mode != "off" else 0
        want_codec = ship_expected * n if bits else 0
        if run["prefills"] != routed or run["colocated"] != 0 \
                or set(codec.values()) != {want_codec} \
                or run["leaked"] or not run["pool_whole"] \
                or run["disaggregated"] != (mode != "off"):
            problems.append(
                f"{label}: prefills shipped {run['prefills']} of {routed} "
                f"routed, colocated {run['colocated']}, kernel 1/2 "
                f"launches {codec} (want {want_codec} each), leaked "
                f"{run['leaked']}, pool whole {run['pool_whole']}")
    proc, stop = res["runs"]["process"], res["process_stop"]
    prefill = proc["healthz_kv"]["prefill"]
    routed = n + DISAGG_FIRST_LEASES
    workers = {k: v for k, v in stop["launches"].items()
               if k.startswith("prefill")}
    encodes = {k: v["fused_encode"] for k, v in workers.items()}
    server = stop["launches"].get("server", {})
    if prefill["leases"] != {"shipped": routed, "redispatched": 0,
                             "corrupt_retry": 0, "fallback": 0} \
            or sum(prefill["colocated"].values()) \
            or len(workers) != DISAGG_PREFILL_RANKS \
            or sum(encodes.values()) != ship_expected * routed \
            or not all(encodes.values()) \
            or server.get("fused_decode") != ship_expected * routed \
            or server.get("fused_encode") \
            or proc["healthz_kv"]["leaked"] or stop["rc"] != 0 \
            or stop["survivors"]:
        problems.append(
            f"process: leases {prefill['leases']} of {routed} routed, "
            f"colocated {prefill['colocated']}, workers' kernel 1 "
            f"{encodes}, server's launches {server}, leaked "
            f"{proc['healthz_kv']['leaked']}, rc {stop['rc']}, survivors "
            f"{stop['survivors']}")
    codec = res["codec"]
    log("disagg ship codec: " + json.dumps(codec | {"card": device_name}))
    if not codec["equal_plain"]:
        problems.append(f"ship codec at 8 bits not equal to the plain "
                        f"codec: {codec}")
    log("disagg trace: " + json.dumps(res["trace"] | {"card": device_name},
                                      sort_keys=True))
    chaos = res["chaos"]
    rec = chaos["record"] or {}
    log("disagg chaos: " + json.dumps(
        {"rc": chaos["rc"], "seconds": chaos["seconds"], **rec,
         "card": device_name}, sort_keys=True))
    launches = rec.get("kernel_launches") or {}
    chaos_encodes = {k: v["fused_encode"] for k, v in launches.items()
                     if k.startswith("prefill")}
    engaged = (rec.get("leases", {}).get("redispatched", 0)
               + rec.get("leases", {}).get("fallback", 0)
               + sum((rec.get("colocated") or {}).values())) > 0
    if chaos["rc"] != 0 or rec.get("errors") != 0 or rec.get("lost") != 0 \
            or rec.get("pages_leaked") != 0 or not engaged \
            or not rec.get("readmitted") or rec.get("survivors") \
            or not any(chaos_encodes.values()) \
            or not launches.get("server", {}).get("fused_decode"):
        problems.append(f"chaos serve-disagg: rc {chaos['rc']}, record "
                        f"{rec}, stderr {chaos['stderr_tail']}")
    if problems:
        raise AssertionError("phase 20: " + "; ".join(problems))
    return {"wire8_in_process": {k: res["runs"]["wire8"]["counts"][k]
                                 for k in ("fused_encode", "fused_decode")},
            "process_workers": encodes,
            "process_server": server.get("fused_decode"),
            "chaos_workers": chaos_encodes,
            "chaos_server": launches["server"]["fused_decode"],
            "ship_codec": {k: codec[k] for k in (
                "shape", "encode_ms", "plain_encode_ms", "decode_ms",
                "plain_decode_ms", "bound_ms", "bound_by", "max_abs_err")}}


# --- phase 21: the tensor-parallel axis ---------------------------------------

# (a) ViT-Base blocks over 2 and 4 shards on the one card; the quantized
# all-reduce at 8 and 4 bits; kernels 1 and 2 at the ring's chunk shapes
# (a [8, 197, 768] addend split n ways in rows of DEFAULT_BLOCK = 256)
# and the Llama-3-8B prompt's [4, 512, 4096] at n = 2, kernel 3 at a
# shard's [8, 197, 6, 64] and kernel 5 over a shard's 6 heads
TP_DEGREES = (2, 4)
TP_BITS = (8, 4)
# a TP block against the unsharded one: the JAX package's tolerance for
# the same comparison (tests/test_tensor_parallel.py); the row-parallel
# products are summed across shards, in another order than one matmul
TP_BLOCK_TOL = dict(rtol=2e-4, atol=2e-5)
# (b) runtime -c dcn: ViT-Base in 2 ranks cut at a block boundary, 2
# shards a rank on the one card, at --tp-quant-bits 0 (exact edge) and 8
# (8-bit edge). At bits 0 the logits against the single-shard forward:
# 12 blocks each summing their row-parallel products in another order,
# a few f32 ulps an op, held to phase 6's fp decode bound (1e-4 of max
# |logit|) and the same argmax; at 8 bits LOGIT_BOUND[8]
TP_DCN_PT = "1,24,25,48"
TP_DCN_FP_BOUND = 1e-4
# (c) generate --tp 2 against --tp 1: GPT-2 through the entry, fp and
# int8 caches (kernel 5 per shard), and Llama-3-8B at LLAMA_BLOCKS in
# process (GQA kv heads split, the vocab-split head)
TP_GEN = (16, 192, 64)            # batch, prompt, new tokens
TP_LLAMA_GEN = (4, 512, 32)


@contextlib.contextmanager
def plain_codec():
    """The quantized collectives' encode and decode through the plain
    codec (`ops/quant.py`) instead of kernels 1 and 2, for the time of the
    block: the same ring on the card, to hold the kernels' ring to."""
    from pipeedge_tpu_torch.ops import fused_quant, quant
    saved = fused_quant.encode_outerdim, fused_quant.decode_outerdim
    fused_quant.encode_outerdim = (
        lambda x, bit, mode="original", cluster=None:
        quant.tensor_encode_outerdim(x, bit, mode))
    fused_quant.decode_outerdim = quant.tensor_decode_outerdim
    try:
        yield
    finally:
        fused_quant.encode_outerdim, fused_quant.decode_outerdim = saved


def plain_ring_ms(group, addends, bit: int) -> float:
    """Device time of the quantized all-reduce through the plain codec."""
    from pipeedge_tpu_torch.ops import qcollectives
    with plain_codec():
        return time_ms(lambda: qcollectives.qpsum(group, addends, bit),
                       iters=5, reps=5)


def launch_delta(before: dict) -> dict:
    from pipeedge_tpu_torch.ops import _build
    return {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()}


def ring_codec_row(case: str, m: int, n: int, bit: int, dev, gen) -> dict:
    """Kernels 1 and 2 at the quantized all-reduce's chunk of an m-value
    addend over n shards ([m / (n * 256), 256] rounded up) against the
    plain codec, the ring's one block per item and the edge's cluster
    both, each timed beside the plain codec and the bound."""
    from pipeedge_tpu_torch.ops import fused_quant, qcollectives, quant
    block_len = qcollectives.DEFAULT_BLOCK
    rows = -(-m // (n * block_len))
    chunk = torch.randn((rows, block_len), generator=gen, device=dev)
    ring = qcollectives.RING_CLUSTER
    enc = fused_quant.fused_encode_outerdim(chunk, bit, cluster=ring)
    ref = quant.tensor_encode_outerdim(chunk, bit)
    dec = fused_quant.fused_decode_outerdim(enc)
    dref = quant.tensor_decode_outerdim(ref)
    edge = fused_quant.fused_encode_outerdim(
        chunk, bit, cluster=fused_quant.ENCODE_CLUSTER)
    torch.cuda.synchronize()
    fields = ("data", "scale", "shift")
    return dict(
        case=case, shape=[rows, block_len], bit=bit,
        equal_plain=all(torch.equal(getattr(enc, f), getattr(ref, f))
                        for f in fields) and torch.equal(dec, dref),
        edge_cluster_equal_plain=all(torch.equal(getattr(edge, f),
                                                 getattr(ref, f))
                                     for f in fields),
        encode_ms=time_ms(lambda: fused_quant.fused_encode_outerdim(
            chunk, bit, cluster=ring)),
        cluster=ring, edge_cluster=fused_quant.ENCODE_CLUSTER,
        edge_cluster_encode_ms=time_ms(
            lambda: fused_quant.fused_encode_outerdim(
                chunk, bit, cluster=fused_quant.ENCODE_CLUSTER)),
        plain_encode_ms=time_ms(
            lambda: quant.tensor_encode_outerdim(chunk, bit)),
        decode_ms=time_ms(lambda: fused_quant.fused_decode_outerdim(enc)),
        plain_decode_ms=time_ms(lambda: quant.tensor_decode_outerdim(ref)),
        bound_ms=codec_bytes((rows, block_len), bit) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", max_abs_err=float((dec - dref).abs().max()))


def decode_kernel_row(b: int, w: int, h: int, hd: int, pos: int, dev,
                      gen) -> dict:
    """Kernel 5 (variant 2) over a w-row window of a [b, DECODE_MAX_LEN,
    h, hd] int8 cache at `pos` against its plain version, timed beside it
    and the bound."""
    from pipeedge_tpu_torch.ops import decode_attention as da
    from pipeedge_tpu_torch.parallel import decode
    cache = {}
    for tag in ("k", "v"):
        rows_ = torch.randn((b, DECODE_MAX_LEN, h, hd), generator=gen,
                            device=dev)
        cache[tag], cache[tag + "_scale"], cache[tag + "_shift"] = \
            decode._quantize_rows(rows_)
    win = {key: val[:, :w] for key, val in cache.items()}
    qd, k_new, v_new = (torch.randn((b, 1, h, hd), generator=gen,
                                    device=dev) for _ in range(3))
    args = (qd, win["k"], win["k_scale"], win["k_shift"], win["v"],
            win["v_scale"], win["v_shift"], k_new, v_new, pos)
    got = da.int8_decode_attention(*args, variant=2)
    want = da.decode_attention_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **DECODE_ATTN_TOL[torch.float32])
    bound, bound_by = decode_bound_ms(b, h, hd, pos, torch.float32)
    return dict(
        shape=[b, w, h, hd], pos=pos, dtype="float32",
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: da.int8_decode_attention(*args, variant=2)),
        plain_ms=time_ms(lambda: da.decode_attention_reference(*args)),
        bound_ms=bound, bound_by=bound_by, library_ms=None)


def tp_kernels_path(dev, gen) -> dict:
    """Phase 21a: a ViT-Base block over 2 and 4 shards against the
    unsharded block; `qpsum` at 8 and 4 bits against the same ring through
    the plain codec on the card (bit for bit, per shard) and the exact
    sum (`qpsum_error_bound`); kernels 1 and 2 at the ring's chunk shapes,
    kernel 3 at a shard's heads and kernel 5 over a shard's heads, each
    timed beside its plain version and its bound."""
    import torch.nn.functional as F
    from pipeedge_tpu_torch.models import registry, vit
    from pipeedge_tpu_torch.ops import _build, attention, qcollectives
    from pipeedge_tpu_torch.parallel import tensor as tp
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for

    cfg = registry.get_model_config(MODEL)
    d, it = cfg.hidden_size, cfg.intermediate_size

    def mat(*shape, mean=0.0):
        return torch.empty(shape, device=dev).normal_(mean, 0.02,
                                                      generator=gen)

    def lin(n_in, n_out):
        return {"w": mat(n_in, n_out), "b": mat(n_out)}

    block = {"ln_before": {"scale": mat(d, mean=1.0), "bias": mat(d)},
             "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
             "attn_out": lin(d, d),
             "ln_after": {"scale": mat(d, mean=1.0), "bias": mat(d)},
             "mlp_up": lin(d, it), "mlp_down": lin(it, d)}
    x = torch.randn((UBATCH, 197, d), generator=gen, device=dev)
    with torch.inference_mode():
        exact = x
        for sub in range(4):
            exact = vit.sublayer(block, sub, exact, cfg)
    res = {"blocks": [], "qpsum": [], "ring": [], "attention": None,
           "decode_attention": None}
    for n in TP_DEGREES:
        group = ShardGroup(devices_for(n, "cuda"))
        fn = tp.make_tp_block_fn(cfg, group)
        sharded = tp.shard_block_params(cfg, block, group)
        xs = group.replicate(x)
        before = dict(_build.launch_counts)
        got = fn(sharded, xs)
        torch.cuda.synchronize()
        counts = launch_delta(before)
        err = float((got[0] - exact).abs().max())
        ok = bool(torch.allclose(got[0], exact, **TP_BLOCK_TOL))
        res["blocks"].append(dict(
            n=n, shape=list(x.shape), max_abs_err=err,
            rel_err=err / float(exact.abs().max()), close=ok,
            shards_equal=all(torch.equal(g, got[0]) for g in got[1:]),
            counts=counts, ms=time_ms(lambda: fn(sharded, xs), iters=5,
                                      reps=5)))
        log("tp block " + json.dumps(res["blocks"][-1]))
        addends = [torch.randn((UBATCH, 197, d), generator=gen,
                               device=dev) for _ in range(n)]
        summed = group.psum(addends)[0]
        absrange = max(float(a.max() - a.min()) for a in addends)
        for bit in TP_BITS:
            qcollectives.reset_trace_tally()
            before = dict(_build.launch_counts)
            out = qcollectives.qpsum(group, addends, bit)
            torch.cuda.synchronize()
            counts = launch_delta(before)
            with plain_codec():
                ref = qcollectives.qpsum(group, addends, bit)
            torch.cuda.synchronize()
            bound = qcollectives.qpsum_error_bound(absrange, bit, n)
            err = max(float((o - summed).abs().max()) for o in out)
            res["qpsum"].append(dict(
                n=n, bit=bit, shape=list(summed.shape),
                equal_plain_ring=all(torch.equal(o, r)
                                     for o, r in zip(out, ref)),
                max_abs_err=err, error_bound=bound, counts=counts,
                # a shard encodes each reduce-scatter hop's payload and its
                # reduced chunk once, and decodes every hop of both rings
                expected_counts={"fused_encode": n * n,
                                 "fused_decode": 2 * (n - 1) * n},
                tally=qcollectives.trace_tally(),
                ms=time_ms(lambda: qcollectives.qpsum(group, addends, bit),
                           iters=5, reps=5),
                plain_ms=plain_ring_ms(group, addends, bit),
                exact_psum_ms=time_ms(lambda: group.psum(addends), iters=5,
                                      reps=5)))
            qcollectives.reset_trace_tally()
            log("tp qpsum " + json.dumps(res["qpsum"][-1]))
    # kernels 1 and 2 at the ring's [m / 256, 256] chunks: ViT-Base's
    # [8, 197, 768] addend at n = 2 and 4, the Llama-3-8B prompt's
    # [4, 512, 4096] at n = 2
    for name, m, n in (("vitb", UBATCH * 197 * d, 2),
                       ("vitb", UBATCH * 197 * d, 4),
                       ("llama3_prompt", 4 * 512 * 4096, 2)):
        for bit in TP_BITS:
            res["ring"].append(ring_codec_row(f"{name} n={n}", m, n, bit,
                                              dev, gen))
            log("tp ring codec " + json.dumps(res["ring"][-1]))
    # kernel 3 at a shard's heads: ViT-Base's 12 heads over 2 shards
    flip = (0, 2, 1, 3)
    q, k, v = (torch.randn((UBATCH, 197, 6, 64), generator=gen, device=dev)
               for _ in range(3))
    got = attention.fused_attention(q, k, v)
    want = attention.attention_reference(
        q.permute(flip), k.permute(flip), v.permute(flip)).permute(flip)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL[torch.float32])
    bound, bound_by = attention_bound_ms(UBATCH, 6, 197, 64, torch.float32,
                                         False)
    res["attention"] = dict(
        shape=[UBATCH, 197, 6, 64], dtype="float32",
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: attention.fused_attention(q, k, v)),
        plain_ms=time_ms(lambda: attention.attention_reference(
            q.permute(flip), k.permute(flip), v.permute(flip))),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q.permute(flip), k.permute(flip), v.permute(flip))),
        bound_ms=bound, bound_by=bound_by)
    log("tp attention " + json.dumps(res["attention"]))
    # kernel 5 over a shard's 6 heads: a bucket-256 window of GPT-2's
    # [16, 1024, 6, 64] shard cache at pos 200
    res["decode_attention"] = decode_kernel_row(DECODE_BATCH, 256, 6, 64,
                                                200, dev, gen)
    log("tp decode_attention " + json.dumps(res["decode_attention"]))
    return res


def check_tp_kernels(res, device_name: str) -> None:
    problems = []
    for r in res["blocks"]:
        want = {"fused_attention": r["n"], "fused_encode": 0,
                "fused_decode": 0, "int8_matmul": 0, "decode_attention": 0}
        if not (r["close"] and r["shards_equal"]) or r["counts"] != want:
            problems.append(f"tp block n={r['n']}: {r}")
    for r in res["qpsum"]:
        want = r["expected_counts"]
        if not r["equal_plain_ring"] or r["max_abs_err"] > r["error_bound"] \
                or r["max_abs_err"] == 0 \
                or any(r["counts"][k] != v for k, v in want.items()):
            problems.append(f"tp qpsum n={r['n']} bit {r['bit']}: "
                            f"{ {k: v for k, v in r.items() if k != 'tally'} }")
    for r in res["ring"]:
        if not r["equal_plain"] or not r["edge_cluster_equal_plain"]:
            problems.append(f"tp ring codec {r['case']} bit {r['bit']}: "
                            "not equal to the plain codec")
    if problems:
        raise AssertionError("phase 21a: " + "; ".join(problems))
    log(f"phase 21a checks held ({device_name})")


def tp_dcn_fleet(weights_file: Path, tp_bits: int, edge_bits: int,
                 exact) -> dict:
    """One phase-21b fleet: ViT-Base in 2 ranks, `--stage-tp 2
    --tp-quant-bits tp_bits`, edge at `edge_bits`; the 8-bit one also
    traced (`--trace-spans` on every rank) and read by `trace_report`."""
    traced = tp_bits > 0
    argv = ["-m", MODEL, "-M", str(weights_file), "-pt", TP_DCN_PT, "-q",
            f"{edge_bits},0", "-r", "0,1", "-b", str(BATCH), "-u",
            str(UBATCH), "--stage-tp", "2", "--tp-quant-bits", str(tp_bits),
            "--save-results", "results.npz", "--sched-timeout", "300"]
    if traced:
        argv += ["--trace-spans", "spans.json"]
    fleet = dcn_fleet(argv, 2, BUILD_DIR / f"tp_dcn{tp_bits}")
    with np.load(fleet["dirs"][0] / "results.npz") as f:
        outs = [f[f"arr_{i}"] for i in range(len(f.files))]
    want = [e.float().cpu().numpy() for e in exact]
    scale = max(float(np.abs(w).max()) for w in want)
    n_mb = BATCH // UBATCH
    blocks = 6                       # each rank's stage: 24 sublayers
    calls = 2 * blocks               # all-reduces per microbatch
    codec = 2 * (2 - 1) * 2 * calls if tp_bits else 0
    edge = n_mb if edge_bits else 0
    expected = {r: {"fused_attention": 2 * blocks * n_mb,
                    "fused_encode": codec * n_mb + (edge if r == 0 else 0),
                    "fused_decode": codec * n_mb + (edge if r == 1 else 0),
                    "int8_matmul": 0, "decode_attention": 0}
                for r in (0, 1)}
    res = dict(tp_bits=tp_bits, edge_bits=edge_bits, n=len(outs),
               shape=list(outs[0].shape) if outs else None,
               finite=all(bool(np.isfinite(o).all()) for o in outs),
               rel_err=max(float(np.abs(o - w).max())
                           for o, w in zip(outs, want)) / scale,
               argmax_equal=all(np.array_equal(o.argmax(-1), w.argmax(-1))
                                for o, w in zip(outs, want)),
               counts={r: fleet["ranks"][r]["total"] for r in (0, 1)},
               expected_counts=expected, seconds=fleet["seconds"],
               items_per_s=fleet["report"].get(0, {}).get(
                   "throughput_items_sec"),
               split_logged=all(
                   "block(s) TP-split over 2 shards on cuda:0, cuda:0"
                   in fleet["ranks"][r]["out"] for r in (0, 1)))
    if traced:
        rep = subprocess.run(
            [sys.executable, "-m", "pipeedge_tpu_torch.trace_report",
             str(fleet["dirs"][0] / "spans.json")], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
            text=True, timeout=120)
        lines = rep.stdout.strip().splitlines()
        res["collectives"] = (json.loads(lines[-1]).get("collectives")
                              if rep.returncode == 0 and lines else None)
        res["trace_report_rc"] = rep.returncode
        # per stage: `calls` all-reduces of one [8, 197, 768] footprint a
        # microbatch, each 2 ring hops of one encoded chunk
        from pipeedge_tpu_torch.ops import qcollectives
        m = UBATCH * 197 * 768
        chunk = qcollectives.DEFAULT_BLOCK * -(-m // (
            2 * qcollectives.DEFAULT_BLOCK))
        res["expected_stage_bytes"] = n_mb * calls * 2 * \
            qcollectives._enc_bytes_per_chunk(chunk, qcollectives
                                              .DEFAULT_BLOCK, tp_bits)
    return res


def tp_dcn_path(weights_file: Path) -> dict:
    """Phase 21b: the two fleets at once (beside phase 16's (b) and (d))."""
    from concurrent.futures import ThreadPoolExecutor
    from pipeedge_tpu_torch import runtime
    t0 = time.monotonic()
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    exact = single_shard_logits(MODEL, weights_file, inputs, "cuda")
    with ThreadPoolExecutor(2) as pool:
        futs = {bits: pool.submit(tp_dcn_fleet, weights_file, bits, bits,
                                  exact) for bits in (0, 8)}
        res = {f"bits{bits}": f.result() for bits, f in futs.items()}
    res["seconds"] = time.monotonic() - t0
    return res


def check_tp_dcn(res, device_name: str) -> dict:
    """Phase 21b's gates; returns each rank's launches per fleet."""
    problems = []
    for key in ("bits0", "bits8"):
        r = res[key]
        log(f"tp dcn {key}: " + json.dumps(
            {k: v for k, v in r.items() if k != "collectives"}
            | {"card": device_name}, sort_keys=True, default=str))
        if r["n"] != BATCH // UBATCH or not r["finite"] \
                or r["shape"] != [UBATCH, 1000] or not r["split_logged"]:
            problems.append(f"{key}: {r['n']} results of shape {r['shape']}"
                            f", finite={r['finite']}, split logged="
                            f"{r['split_logged']}")
        if r["counts"] != r["expected_counts"]:
            problems.append(f"{key}: launches {r['counts']} != "
                            f"{r['expected_counts']}")
    r0, r8 = res["bits0"], res["bits8"]
    if not (r0["rel_err"] <= TP_DCN_FP_BOUND and r0["argmax_equal"]):
        problems.append(f"bits 0: logit error {r0['rel_err']} over "
                        f"{TP_DCN_FP_BOUND} or argmax differs "
                        f"({r0['argmax_equal']})")
    if not 0 < r8["rel_err"] <= LOGIT_BOUND[8]:
        problems.append(f"bits 8: logit error {r8['rel_err']} not in "
                        f"(0, {LOGIT_BOUND[8]}]")
    col = r8.get("collectives") or {}
    log("tp dcn collectives " + json.dumps(col, sort_keys=True))
    per = col.get("per_stage", {})
    if set(per) != {"stage0", "stage1"} or any(
            s["wire_bytes"] != r8["expected_stage_bytes"]
            for s in per.values()) or set(col.get("by_kind", {})) \
            != {"psum8"}:
        problems.append(f"bits 8: trace_report's collectives section "
                        f"{col} (rc {r8.get('trace_report_rc')}), each "
                        f"stage expected {r8['expected_stage_bytes']} "
                        "bytes of psum8")
    if problems:
        raise AssertionError("phase 21b: " + "; ".join(problems))
    return {key: res[key]["counts"] for key in ("bits0", "bits8")}


def greedy_reference(pipe, ids, new: int) -> dict:
    """`pipe`'s greedy decode of `ids` step by step, with each step's top-2
    logits, their tokens and max |logit| per row (`near_tie_rule`)."""
    data, caches = pipe._prefill(torch.as_tensor(ids, device="cuda"))
    last = data[:, -1].float()
    tokens, top2, amax = [], [], []
    for step in range(new):
        top2.append(torch.topk(last, 2, dim=-1))
        amax.append(last.abs().amax(dim=-1))
        tokens.append(last.argmax(dim=-1))
        if step + 1 < new:
            last = decode_step(pipe, caches, tokens[-1],
                               ids.shape[1] + step).float()
    return dict(ids=np.concatenate(
        [np.asarray(ids), torch.stack(tokens, 1).cpu().numpy()], 1),
        top2_values=torch.stack([t.values for t in top2], 1).cpu(),
        top2_tokens=torch.stack([t.indices for t in top2], 1).cpu(),
        max_abs=torch.stack(amax, 1).cpu())


def tp_generate_entry(argv, int8: bool) -> dict:
    """`pipeedge_tpu_torch.generate.main(ARGV)` in this process (the
    decode-attention opt-in set for an int8 cache): its ids, tokens/s
    and the kernels it launched (warm-up included)."""
    import io
    import re
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.ops import _build
    saved = os.environ.get("PIPEEDGE_INT8_DECODE_ATTEND")
    os.environ["PIPEEDGE_INT8_DECODE_ATTEND"] = "1" if int8 else "0"
    out = io.StringIO()
    before = dict(_build.launch_counts)
    try:
        with contextlib.redirect_stdout(out):
            ids = generate.main(argv)
    finally:
        if saved is None:
            os.environ.pop("PIPEEDGE_INT8_DECODE_ATTEND")
        else:
            os.environ["PIPEEDGE_INT8_DECODE_ATTEND"] = saved
    rate = re.search(r"= ([\d.]+) tok/s \(([^)]*)\)", out.getvalue())
    return dict(ids=ids, tok_per_s=float(rate.group(1)) if rate else None,
                label=rate.group(2) if rate else None,
                counts=launch_delta(before))


def tp_generate_path(card: str) -> dict:
    """Phase 21c: `generate --tp 2` against `--tp 1` for GPT-2 (the entry,
    fp and int8 caches) and Llama-3-8B at LLAMA_BLOCKS (in process, the
    weights drawn on the card); each held by `near_tie_rule` to the `--tp
    1` pipeline's greedy decode, tokens/s and device kernels per decode
    step at both degrees."""
    from types import SimpleNamespace
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.parallel import decode
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for
    t0 = time.monotonic()
    res = {"card": card, "gpt2": {}}
    batch, prompt, new = TP_GEN
    weights = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    pt = ",".join(f"{l},{r}" for l, r in DECODE_PARTITION)
    cfg = registry.get_model_config(DECODE_MODEL)
    ids = generate.prompt_ids(SimpleNamespace(batch_size=batch,
                                              prompt_len=prompt), cfg)
    # the references' weights, loaded once: every pipeline below shares
    # them (the tp 2 pipelines split copies of their blocks)
    stage_params = [registry.module_shard_factory(
        DECODE_MODEL, str(weights), l, r, stage=i, device="cuda")[1]
        for i, (l, r) in enumerate(DECODE_PARTITION)]
    for kv in (0, 8):
        runs = {tp: tp_generate_entry(
            ["-m", DECODE_MODEL, "-M", str(weights), "-pt", pt, "-b",
             str(batch), "--prompt-len", str(prompt), "--new-tokens",
             str(new), "--kv-bits", str(kv), "--tp", str(tp)], bool(kv))
            for tp in (1, 2)}
        pipes = {tp: decode.build_decode_pipeline(
            DECODE_MODEL, DECODE_PARTITION, max_len=prompt + new,
            stage_params=stage_params, device="cuda", cache_bits=kv,
            int8_decode_attend=1 if kv else 0,
            mesh=ShardGroup(devices_for(2, "cuda")) if tp == 2 else None)
            for tp in (1, 2)}
        ref = greedy_reference(pipes[1], ids, new)
        step_kernels = {}
        for tp, pipe in pipes.items():
            _, caches = pipe._prefill(torch.as_tensor(ids, device="cuda"))
            tok = torch.zeros(batch, dtype=torch.long, device="cuda")
            step_kernels[tp] = device_launches(
                lambda: decode_step(pipe, caches, tok, prompt))
        res["gpt2"][f"kv{kv}"] = dict(
            tok_per_s={tp: r["tok_per_s"] for tp, r in runs.items()},
            labels={tp: r["label"] for tp, r in runs.items()},
            counts={tp: r["counts"] for tp, r in runs.items()},
            tp1_equal_reference=bool(np.array_equal(runs[1]["ids"],
                                                    ref["ids"])),
            rule=near_tie_rule(runs[2]["ids"], ref, prompt),
            kernels_per_step=step_kernels,
            # the warm-up's one decode step and the timed run's new - 1
            steps=new)
        log(f"tp generate gpt2 kv{kv}: " + json.dumps(
            res["gpt2"][f"kv{kv}"], default=str))
        del pipes
    del stage_params
    free_card()
    batch, prompt, new = TP_LLAMA_GEN
    with cut_llama_depth():
        entry = registry.get_model_entry(LLAMA3)
        whole, gb = draw_model(LLAMA3, torch.float32, 0)
        views = [shard_view(whole, LLAMA3, l, r) for l, r in
                 FAMILY_PARTITION]
        max_len = prompt + new
        pipes = {tp: decode.DecodePipeline(
            entry.family.FAMILY, entry.config, FAMILY_PARTITION, views,
            max_len=max_len, device="cuda",
            mesh=ShardGroup(devices_for(2, "cuda")) if tp == 2 else None)
            for tp in (1, 2)}
        llama_ids = torch.from_numpy(np.random.default_rng(21).integers(
            0, entry.config.vocab_size, size=(batch, prompt))).to("cuda")
        out = {"gb": gb, "tok_per_s": {}, "kernels_per_step": {}}
        got = {}
        for tp, pipe in pipes.items():
            pipe.generate(llama_ids[:, :8], 2)          # warm-up
            torch.cuda.synchronize()
            t1 = time.monotonic()
            got[tp] = pipe.generate(llama_ids, new).cpu().numpy()
            out["tok_per_s"][tp] = batch * new / (time.monotonic() - t1)
            _, caches = pipe._prefill(llama_ids)
            tok = torch.zeros(batch, dtype=torch.long, device="cuda")
            out["kernels_per_step"][tp] = device_launches(
                lambda: decode_step(pipe, caches, tok, prompt))
            del caches
        ref = greedy_reference(pipes[1], llama_ids.cpu().numpy(), new)
        out["tp1_equal_reference"] = bool(np.array_equal(got[1],
                                                         ref["ids"]))
        out["rule"] = near_tie_rule(got[2], ref, prompt)
        out["vocab_split"] = bool(decode._tp_shards_head(entry.config, 2))
        out["kv_heads_per_shard"] = entry.config.kv_heads // 2
        res["llama3"] = out
        log("tp generate llama3: " + json.dumps(out, default=str))
        del pipes, views, whole
    free_card()
    res["seconds"] = time.monotonic() - t0
    return res


def check_tp_generate(res, device_name: str) -> dict:
    """Phase 21c's gates; returns kernel 5's launches per entry run."""
    problems = []
    n_blocks = 12
    for key, r in res["gpt2"].items():
        int8 = key == "kv8"
        for tp in (1, 2):
            want = {"fused_attention": 0, "fused_encode": 0,
                    "fused_decode": 0, "int8_matmul": 0,
                    "decode_attention": n_blocks * tp * r["steps"]
                    if int8 else 0}
            if r["counts"][tp] != want:
                problems.append(f"gpt2 {key} tp {tp}: launches "
                                f"{r['counts'][tp]} != {want}")
        if not r["tp1_equal_reference"] or not r["rule"]["ok"]:
            problems.append(f"gpt2 {key}: tp 1 equal to its reference "
                            f"{r['tp1_equal_reference']}, tp 2 "
                            f"{r['rule']}")
        if ", tp 2" not in (r["labels"][2] or ""):
            problems.append(f"gpt2 {key}: report label {r['labels']}")
    llama = res["llama3"]
    if not llama["tp1_equal_reference"] or not llama["rule"]["ok"] \
            or not llama["vocab_split"]:
        problems.append(f"llama3: {llama}")
    if problems:
        raise AssertionError("phase 21c: " + "; ".join(problems))
    log(f"tp generate tokens/s (tp 1 -> tp 2): gpt2 fp "
        f"{res['gpt2']['kv0']['tok_per_s']}, int8 "
        f"{res['gpt2']['kv8']['tok_per_s']}, llama3 "
        f"{llama['tok_per_s']}; device kernels per decode step: gpt2 fp "
        f"{res['gpt2']['kv0']['kernels_per_step']}, int8 "
        f"{res['gpt2']['kv8']['kernels_per_step']}, llama3 "
        f"{llama['kernels_per_step']} ({device_name})")
    return {key: {f"tp{tp}": r["counts"][tp]["decode_attention"]
                  for tp in (1, 2)} for key, r in res["gpt2"].items()}


# Phase 22: expert and sequence parallelism, the shards sharing the one
# card. (a) in process at full width: `ep_ffn_delta` at the MoE GPT-2's
# widths over EP_TOKENS tokens, the ring and Ulysses cores at Llama-3-8B's
# heads over SP_ATTN tokens, Ulysses under Mistral-7B's window over
# SP_WINDOW_ATTN tokens; (b) the MoE GPT-2 through `generate --ep 2
# --kv-bits 8` and `--tp 2 --ep 2` (EP_GEN), then the tp x ep grid at 8
# quantized bits in process; (c) Llama-3-8B at LLAMA_BLOCKS through
# `generate --sp 2` (SP_GEN, the ring core) and in process with both
# cores.
EP_DEGREES = (2, 4)
EP_TOKENS = (16, 192)             # the MoE GPT-2 decode path's prompt
SP_ATTN = (1, 4096)               # batch, tokens over sp 2
SP_WINDOW_ATTN = (1, 8192)        # twice Mistral-7B's window of 4096
# ep_ffn_delta against the single-device delta, as a share of max
# |delta|. The routing is the same function of the same tokens, so the
# kept table is too, and each token's delta comes from one shard (the
# others add exact zeros: checked). The shards run the experts' GEMMs
# batched over E/n experts where one device batches all E; cuBLAS may
# pick another kernel for another batch count, summing the 768- and
# 3072-long products in another order: a few f32 ulps.
EP_DELTA_BOUND = 1e-6
EP_GEN = (16, 192, 64)            # batch, prompt, new tokens
EP_MAX_LEN = 1024
SP_GEN = (1, 4096, 32)
# sp 2's prefill against sp 1's, as a share of the max |value|: the
# last position's logits, and the gathered K/V rows by route. The ring
# attends through f32 einsums over 2048-row blocks, sp 1 over all 4096
# rows (another order: 8.5e-6 of max |K/V| measured on an NVIDIA H100
# 80GB HBM3 at 700 W). Ulysses attends through kernel 3, whose f32
# products are 3xTF32 (each within ~2^-21 of f32, as FAMILY_FP_BOUND
# says), and the 4 blocks' residual stream carries that into the next
# blocks' K/V: 3.05e-5 measured there, so its cache is held at the
# logits' bound
SP_LOGIT_BOUND = 1e-4
SP_CACHE_BOUND = {"ring": 1e-5, "ulysses": 1e-4}


@contextlib.contextmanager
def card_weights(model: str, whole: dict):
    """The entry's weights for `model` drawn on the card: for the time of
    the block, the registry's shard factory takes each stage's params as
    views of `whole` (no host draw, no checkpoint file), as
    `cut_llama_depth` hands the entry its depth."""
    from pipeedge_tpu_torch.models import registry
    real = registry.module_shard_factory

    def factory(name, model_file, l, r, **kw):
        if name == model:
            kw["params"] = shard_view(whole, model, l, r)
        return real(name, model_file, l, r, **kw)

    registry.module_shard_factory = factory
    try:
        yield
    finally:
        registry.module_shard_factory = real


def wall_ms(fn, n: int = 3) -> float:
    """Host milliseconds of one `fn()` (warmed, synchronized): for the
    host-dispatched collectives, whose device work is a small share."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def windowed_reference(q, k, v, window: int, rows: int = 1024):
    """Plain causal attention of q [B, S, H, D] over k/v [B, S, KV, D]
    with query q attending keys in (q - window, q], in blocks of `rows`
    queries (the whole [S, S] score matrix would not fit twice)."""
    import math
    b, s, h, d = q.shape
    k = k.repeat_interleave(h // k.shape[2], dim=2).float()
    v = v.repeat_interleave(h // v.shape[2], dim=2).float()
    out = torch.empty_like(q)
    pos = torch.arange(s, device=q.device)
    for r0 in range(0, s, rows):
        qb = q[:, r0:r0 + rows].float()
        qp = pos[r0:r0 + rows, None]
        keep = (pos[None, :] <= qp) & (pos[None, :] > qp - window)
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, k) / math.sqrt(d)
        probs = torch.softmax(scores.masked_fill(~keep, -math.inf), -1)
        out[:, r0:r0 + rows] = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out


def ep_sp_kernels_path(dev, gen) -> dict:
    """Phase 22a (see EP_DEGREES): each case's error against its
    references, kernel 3's launches in it and its time; kernel 3 at the
    Ulysses head group [1, 4096, 16, 128] f32 causal beside its plain
    version, SDPA and its bound."""
    import torch.nn.functional as F
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.models.layers import gelu_new
    from pipeedge_tpu_torch.ops import _build, attention
    from pipeedge_tpu_torch.parallel import expert, sequence
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for

    cfg = registry.get_model_config(MOE)
    d, it, e = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts

    def mat(*shape):
        return torch.empty(shape, device=dev).normal_(0, 0.02, generator=gen)

    params = {"router": {"w": mat(d, e), "b": mat(e)},
              "experts": {"mlp_up": {"w": mat(e, d, it), "b": mat(e, it)},
                          "mlp_down": {"w": mat(e, it, d), "b": mat(e, d)}}}
    b, s = EP_TOKENS
    x = torch.randn((b, s, d), generator=gen, device=dev)
    tokens = x.reshape(-1, d)
    res = {"ep": [], "sp": [], "window": None, "ulysses_kernel": None}
    with torch.inference_mode():
        want = expert.moe_ffn_delta(params, x, e, cfg.capacity_factor,
                                    act=gelu_new)
        capacity = expert.moe_capacity(b * s, e, cfg.capacity_factor)
        expert_of, gate, keep, kept = expert._routing(
            params["router"], tokens, e, capacity)
        routed = torch.zeros(b * s, dtype=torch.bool, device=dev)
        routed[keep[kept]] = True
        scale = float(want.abs().max())
        for n in EP_DEGREES:
            group = ShardGroup(devices_for(n, "cuda"), "ep")
            shards = expert.shard_moe_params(params, group)
            xs = group.replicate(x)
            got = expert.ep_ffn_delta(group, shards, xs, e,
                                      cfg.capacity_factor, act=gelu_new)
            # each shard's own delta is exactly 0 off the tokens its
            # experts kept: the capacity slots that point at arbitrary
            # rows (index_add_'s atomics on the card) add only zeros
            e_local = e // n
            zeros_off_shard = True
            for i, sh in enumerate(shards):
                rows = slice(i * e_local, (i + 1) * e_local)
                local = expert._scatter_expert_deltas(
                    sh["experts"], tokens, gate, keep[rows], kept[rows],
                    gelu_new)
                mine = routed & (expert_of // e_local == i)
                zeros_off_shard &= bool((local[~mine] == 0).all())
            torch.cuda.synchronize()
            err = max(float((g - want).abs().max()) for g in got)
            res["ep"].append(dict(
                n=n, tokens=b * s, width=[d, it], experts=e,
                capacity=capacity, dropped=int((~routed).sum()),
                equal=all(torch.equal(g, want) for g in got),
                max_abs_err=err, rel_err=err / scale,
                zeros_off_shard=zeros_off_shard,
                dropped_rows_zero=all(bool((g[~routed.reshape(b, s)] == 0)
                                           .all()) for g in got),
                ms=wall_ms(lambda: expert.ep_ffn_delta(
                    group, shards, xs, e, cfg.capacity_factor,
                    act=gelu_new)),
                single_device_ms=wall_ms(lambda: expert.moe_ffn_delta(
                    params, x, e, cfg.capacity_factor, act=gelu_new))))
            log("ep ffn " + json.dumps(res["ep"][-1]))
            del shards, xs, got
    del params, want
    flip = (0, 2, 1, 3)
    lcfg = registry.get_model_config(LLAMA3)
    h, kv, hd = lcfg.num_attention_heads, lcfg.kv_heads, lcfg.head_dim
    group = ShardGroup(devices_for(2, "cuda"), "sp")
    sb, ss = SP_ATTN
    q = torch.randn((sb, ss, h, hd), generator=gen, device=dev)
    k, v = (torch.randn((sb, ss, kv, hd), generator=gen, device=dev)
            for _ in range(2))
    kr, vr = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    with torch.inference_mode():
        plain = attention.attention_reference(
            q.permute(flip), kr.permute(flip), vr.permute(flip),
            True).permute(flip)
        whole_k3 = attention.fused_attention(q, kr, vr, causal=True)
        for kind in ("ring", "ulysses"):
            fn = sequence.make_sequence_parallel_attention(group, kind,
                                                           causal=True)
            before = dict(_build.launch_counts)
            out = fn(q, k, v)
            torch.cuda.synchronize()
            counts = launch_delta(before)
            res["sp"].append(dict(
                kind=kind, shape=[sb, ss, h, kv, hd], sp=2,
                max_abs_err_plain=float((out - plain).abs().max()),
                max_abs_err_kernel3=float((out - whole_k3).abs().max()),
                close=bool(torch.allclose(out, plain,
                                          **ATTN_TOL[torch.float32])
                           and torch.allclose(out, whole_k3,
                                              **ATTN_TOL[torch.float32])),
                kernel3_launches=counts["fused_attention"],
                ms=wall_ms(lambda: fn(q, k, v))))
            log("sp attention " + json.dumps(res["sp"][-1]))
            del out
        del plain, whole_k3
        # kernel 3 at a Ulysses shard's head group, K/V repeated
        qh, kh, vh = (t[:, :, :h // 2].contiguous() for t in (q, kr, vr))
        got = attention.fused_attention(qh, kh, vh, causal=True)
        ref = attention.attention_reference(
            qh.permute(flip), kh.permute(flip), vh.permute(flip),
            True).permute(flip)
        torch.cuda.synchronize()
        bound, bound_by = attention_bound_ms(sb, h // 2, ss, hd,
                                             torch.float32, True)
        res["ulysses_kernel"] = dict(
            shape=[sb, ss, h // 2, hd], dtype="float32", causal=True,
            max_abs_err=float((got - ref).abs().max()),
            close=bool(torch.allclose(got, ref, **ATTN_TOL[torch.float32])),
            ms=time_ms(lambda: attention.fused_attention(qh, kh, vh,
                                                         causal=True),
                       iters=5, reps=5),
            plain_ms=time_ms(lambda: attention.attention_reference(
                qh.permute(flip), kh.permute(flip), vh.permute(flip), True),
                iters=3, reps=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qh.permute(flip), kh.permute(flip), vh.permute(flip),
                is_causal=True), iters=5, reps=5),
            bound_ms=bound, bound_by=bound_by)
        log("ulysses kernel 3 " + json.dumps(res["ulysses_kernel"]))
        del q, k, v, kr, vr, qh, kh, vh, got, ref
        free_card()
        # Ulysses under Mistral-7B's window: the blockwise route, no kernel
        window = registry.get_model_config(MISTRAL).sliding_window
        wb, ws = SP_WINDOW_ATTN
        q = torch.randn((wb, ws, h, hd), generator=gen, device=dev)
        k, v = (torch.randn((wb, ws, kv, hd), generator=gen, device=dev)
                for _ in range(2))
        fn = sequence.make_sequence_parallel_attention(
            group, "ulysses", causal=True, window=window)
        before = dict(_build.launch_counts)
        out = fn(q, k, v)
        torch.cuda.synchronize()
        counts = launch_delta(before)
        ref = windowed_reference(q, k, v, window)
        res["window"] = dict(
            shape=[wb, ws, h, kv, hd], window=window, sp=2,
            max_abs_err=float((out - ref).abs().max()),
            close=bool(torch.allclose(out, ref, **ATTN_TOL[torch.float32])),
            kernel3_launches=counts["fused_attention"],
            ms=wall_ms(lambda: fn(q, k, v), n=1))
        log("ulysses window " + json.dumps(res["window"]))
        del q, k, v, out, ref
    free_card()
    return res


def check_ep_sp_kernels(res, device_name: str) -> None:
    problems = []
    for r in res["ep"]:
        if not (r["equal"] or r["rel_err"] <= EP_DELTA_BOUND) \
                or not r["zeros_off_shard"] or not r["dropped_rows_zero"]:
            problems.append(f"ep n={r['n']}: {r}")
    for r in res["sp"]:
        want = 2 if r["kind"] == "ulysses" else 0
        if not r["close"] or r["kernel3_launches"] != want:
            problems.append(f"sp {r['kind']}: {r} (kernel 3 launches "
                            f"expected {want})")
    if not res["ulysses_kernel"]["close"]:
        problems.append(f"kernel 3 at the Ulysses head group: "
                        f"{res['ulysses_kernel']}")
    w = res["window"]
    if not w["close"] or w["kernel3_launches"] != 0:
        problems.append(f"ulysses under a window: {w}")
    if problems:
        raise AssertionError("phase 22a: " + "; ".join(problems))
    log(f"phase 22a checks held ({device_name})")


def step_profile(pipe, ids, pos: int, steps: int = 3) -> dict:
    """Host ms per decode step (median of `steps`, synchronized), the
    device kernels of one step and its copies between host and device,
    after a prefill of `ids`."""
    _, caches = pipe._prefill(torch.as_tensor(ids, device="cuda"))
    tok = torch.zeros(ids.shape[0], dtype=torch.long, device="cuda")
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(pipe, caches, tok, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernels, copies = device_launches(
        lambda: decode_step(pipe, caches, tok, pos), host_copies=True)
    return dict(step_ms=statistics.median(times), kernels=kernels,
                host_copies=copies)


def timed_tok_per_s(pipe, ids, new: int) -> float:
    """Tokens/s of `pipe.generate` after a two-token warm-up, as the
    entry times its run."""
    pipe.generate(ids, 2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pipe.generate(ids, new)
    torch.cuda.synchronize()
    return ids.shape[0] * new / (time.monotonic() - t0)


def ep_generate_path(card: str, dev, gen) -> dict:
    """Phase 22b: the MoE GPT-2 (weights drawn on the card, handed to the
    entry) through `generate --ep 2 --kv-bits 8` (the decode-attention
    opt-in set) and `--tp 2 --ep 2`, each held by `near_tie_rule` to the
    `--ep 1` pipeline's greedy decode over the same whole-window attends;
    tokens/s, ms and device kernels per decode step at ep 1 and on each
    mesh; then the grid in process at 8 quantized bits against the exact
    grid, its codec launches against the prediction; kernels 1 and 2 at
    the grid's ring chunks and kernel 5 at an ep shard's whole window,
    each timed beside its plain version and bound."""
    from types import SimpleNamespace
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build, qcollectives
    from pipeedge_tpu_torch.parallel import decode
    from pipeedge_tpu_torch.parallel import tensor as tp
    from pipeedge_tpu_torch.parallel.mesh import ShardGrid, ShardGroup, devices_for

    t0 = time.monotonic()
    batch, prompt, new = EP_GEN
    entry = registry.get_model_entry(MOE)
    cfg = entry.config
    whole, gb = draw_model(MOE, torch.float32, 3)
    views = [shard_view(whole, MOE, l, r) for l, r in MOE_PARTITION]
    ids = generate.prompt_ids(SimpleNamespace(batch_size=batch,
                                              prompt_len=prompt), cfg)
    pt = ",".join(f"{l},{r}" for l, r in MOE_PARTITION)
    argv = ["-m", MOE, "-pt", pt, "-b", str(batch), "--prompt-len",
            str(prompt), "--new-tokens", str(new), "--max-len",
            str(EP_MAX_LEN)]
    cases = {"ep2_kv8": (8, ["--kv-bits", "8", "--ep", "2"],
                         lambda: {"ep_mesh": ShardGroup(
                             devices_for(2, "cuda"), "ep")}),
             "tp2_ep2": (0, ["--tp", "2", "--ep", "2"],
                         lambda: {"tp_ep_mesh": ShardGrid(
                             devices_for(4, "cuda"), 2, 2)})}

    def pipe(kv, **mesh):
        # ep 1 at the ep steps' whole window (attend_floor = max_len)
        return decode.DecodePipeline(
            entry.family.FAMILY, cfg, MOE_PARTITION, views,
            max_len=EP_MAX_LEN, device="cuda", cache_bits=kv,
            int8_decode_attend=1 if kv else 0, attend_floor=EP_MAX_LEN,
            **mesh)

    # placement: the grid's cells all sit on the one card, and a ring hop
    # or a replication to a device a tensor is on is the tensor itself
    grid_devs = ShardGrid(devices_for(4, "cuda"), 2, 2)
    probe = torch.ones(4, device="cuda")
    res = {"card": card, "gb": gb, "placement": dict(
        devices=[str(d) for d in grid_devs.devices],
        hops_are_the_tensor=all(
            t is probe for t in grid_devs.tp_group(0).ring_forward(
                [probe, probe]) + grid_devs.replicate(probe)))}
    for key, (kv, flags, mesh) in cases.items():
        with card_weights(MOE, whole):
            run = tp_generate_entry(argv + flags, bool(kv))
        ref_pipe = pipe(kv)
        ref = greedy_reference(ref_pipe, ids, new)
        mesh_pipe = pipe(kv, **mesh())
        res[key] = dict(
            label=run["label"], counts=run["counts"],
            tok_per_s=run["tok_per_s"],
            ep1_tok_per_s=timed_tok_per_s(ref_pipe, ids, new),
            rule=near_tie_rule(run["ids"], ref, prompt),
            step={"ep1": step_profile(ref_pipe, ids, prompt),
                  "mesh": step_profile(mesh_pipe, ids, prompt)},
            # the warm-up's one decode step and the timed run's new - 1
            steps=new)
        log(f"ep generate {key}: " + json.dumps(res[key], default=str))
        del ref_pipe, mesh_pipe, ref
        free_card()
    # the grid at 8 quantized bits against the exact grid: a prefill and
    # two decode steps, kernels 1 and 2 counted
    grid = pipe(0, tp_ep_mesh=ShardGrid(devices_for(4, "cuda"), 2, 2))
    toks = torch.zeros(batch, dtype=torch.long, device="cuda")

    def passes():
        data, caches = grid._prefill(torch.as_tensor(ids, device="cuda"))
        out = [data[:, -1]]
        for s in range(2):
            out.append(decode_step(grid, caches, toks, prompt + s))
        return out

    # top-1 routing is discontinuous: the 8-bit ring's error can flip a
    # near-tie between two experts, and a rerouted token takes another
    # expert's whole delta, an error of the model, not of the codec (as
    # phase 14's 8-bit MoE edge). So the quantized passes replay the
    # exact passes' routing (`RoutingPin`); the tokens they would route
    # otherwise are counted and printed
    with RoutingPin() as pin:
        pin.start(True)
        exact = passes()
        pin.start(False)
        tp.set_tp_quant_bits(8)
        try:
            qcollectives.reset_trace_tally()
            before = dict(_build.launch_counts)
            quant = passes()
            torch.cuda.synchronize()
            counts = launch_delta(before)
        finally:
            tp.set_tp_quant_bits(0)
            qcollectives.reset_trace_tally()
        rerouted = int(pin.rerouted)
    n_tp = 2
    # per pass: each block's attention all-reduce in each of the 2 ep
    # columns (the FFN's is the exact ep all-reduce): n^2 encodes and
    # 2n(n-1) decodes a qpsum
    calls = 3 * cfg.num_hidden_layers * 2
    scale = max(float(e.abs().max()) for e in exact)
    res["quant8"] = dict(
        rel_err=max(float((q - e).abs().max()) for q, e in zip(quant, exact))
        / scale, counts=counts, rerouted_tokens=rerouted,
        expected_counts={"fused_encode": calls * n_tp * n_tp,
                         "fused_decode": calls * 2 * (n_tp - 1) * n_tp},
        qpsum_calls=calls)
    log("ep generate tp x ep 8 bits: " + json.dumps(res["quant8"]))
    del grid, views, whole, exact, quant
    free_card()
    # the tp all-reduce's chunks of a decode step's and the prompt's
    # addends over the grid's 2 tp shards
    d = cfg.hidden_size
    res["codec"] = [ring_codec_row(f"tp x ep {what}", m, n_tp, 8, dev, gen)
                    for what, m in (("step", batch * d),
                                    ("prefill", batch * prompt * d))]
    for row in res["codec"]:
        log("ep generate ring codec " + json.dumps(row))
    # an ep shard's step attends the whole cache (the ep steps take no
    # bucket): pos 200 of a 1024-row window, every head
    res["decode_attention"] = decode_kernel_row(
        batch, EP_MAX_LEN, cfg.num_attention_heads, cfg.head_dim, 200, dev,
        gen)
    log("ep generate decode_attention " + json.dumps(
        res["decode_attention"]))
    res["seconds"] = time.monotonic() - t0
    return res


def check_ep_generate(res, device_name: str) -> dict:
    """Phase 22b's gates; returns each run's launches."""
    problems = []
    blocks = 12
    kinds = ("fused_attention", "fused_encode", "fused_decode",
             "int8_matmul")
    r = res["ep2_kv8"]
    want = {k: 0 for k in kinds} | {
        "decode_attention": blocks * 2 * r["steps"]}
    if r["counts"] != want or not r["rule"]["ok"] \
            or ", ep 2" not in (r["label"] or ""):
        problems.append(f"ep 2 int8: launches {r['counts']} (want {want}), "
                        f"{r['rule']}, label {r['label']}")
    r = res["tp2_ep2"]
    want = {k: 0 for k in kinds} | {"decode_attention": 0}
    if r["counts"] != want or not r["rule"]["ok"] \
            or ", tp 2 x ep 2" not in (r["label"] or ""):
        problems.append(f"tp 2 x ep 2: launches {r['counts']} (want {want})"
                        f", {r['rule']}, label {r['label']}")
    for key in ("ep2_kv8", "tp2_ep2"):
        if res[key]["step"]["mesh"]["host_copies"]:
            problems.append(f"{key}: a decode step copies through the host "
                            f"{res[key]['step']['mesh']['host_copies']} "
                            "times")
    if not res["placement"]["hops_are_the_tensor"]:
        problems.append(f"placement: {res['placement']}")
    q = res["quant8"]
    if not 0 < q["rel_err"] <= LOGIT_BOUND[8] or any(
            q["counts"][k] != v for k, v in q["expected_counts"].items()):
        problems.append(f"tp x ep at 8 bits: {q}")
    for row in res["codec"]:
        if not row["equal_plain"] or not row["edge_cluster_equal_plain"]:
            problems.append(f"ring codec {row['case']}: not equal to the "
                            "plain codec")
    if problems:
        raise AssertionError("phase 22b: " + "; ".join(problems))
    log(f"ep generate tokens/s (ep 1 -> mesh): ep 2 int8 "
        f"{res['ep2_kv8']['ep1_tok_per_s']:.1f} -> "
        f"{res['ep2_kv8']['tok_per_s']}, tp 2 x ep 2 "
        f"{res['tp2_ep2']['ep1_tok_per_s']:.1f} -> "
        f"{res['tp2_ep2']['tok_per_s']}; per step "
        f"{ {k: res[k]['step'] for k in ('ep2_kv8', 'tp2_ep2')} } "
        f"({device_name})")
    return {k: res[k]["counts"] for k in ("ep2_kv8", "tp2_ep2")} | {
        "quant8": res["quant8"]["counts"]}


def sp_prefill_path(card: str) -> dict:
    """Phase 22c: Llama-3-8B at LLAMA_BLOCKS (weights drawn on the card,
    handed to the entry) through `generate --sp 2` (the ring core), held
    by `near_tie_rule` to the sp 1 pipeline's greedy decode; in process
    the ring and Ulysses prefills against sp 1's (last-position logits,
    the gathered cache), kernel 3's launches in each, the Ulysses
    pipeline's tokens by the same rule; prefill ms at sp 1 and 2."""
    from types import SimpleNamespace
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for

    t0 = time.monotonic()
    batch, prompt, new = SP_GEN
    res = {"card": card, "kinds": {}}
    with cut_llama_depth():
        entry = registry.get_model_entry(LLAMA3)
        cfg = entry.config
        whole, res["gb"] = draw_model(LLAMA3, torch.float32, 0)
        views = [shard_view(whole, LLAMA3, l, r) for l, r in
                 FAMILY_PARTITION]
        ids = generate.prompt_ids(SimpleNamespace(batch_size=batch,
                                                  prompt_len=prompt), cfg)
        ids_t = torch.as_tensor(ids, device="cuda")
        pt = ",".join(f"{l},{r}" for l, r in FAMILY_PARTITION)
        with card_weights(LLAMA3, whole):
            run = tp_generate_entry(
                ["-m", LLAMA3, "-pt", pt, "-b", str(batch), "--prompt-len",
                 str(prompt), "--new-tokens", str(new), "--sp", "2"], False)

        def pipe(**mesh):
            return decode.DecodePipeline(
                entry.family.FAMILY, cfg, FAMILY_PARTITION, views,
                max_len=prompt + new, device="cuda", **mesh)

        def prefill(p):
            """The last position's logits, the caches, the prefill's ms
            and its kernel launches (after a short warm-up)."""
            p._prefill(ids_t[:, :64])
            torch.cuda.synchronize()
            before = dict(_build.launch_counts)
            t1 = time.perf_counter()
            logits, caches = p._prefill(ids_t)
            torch.cuda.synchronize()
            return (logits[:, -1], caches,
                    (time.perf_counter() - t1) * 1e3, launch_delta(before))

        ref_pipe = pipe()
        ref = greedy_reference(ref_pipe, ids, new)
        base, base_caches, res["sp1_prefill_ms"], _ = prefill(ref_pipe)
        del ref_pipe
        scale = float(base.abs().max())
        res["entry"] = dict(label=run["label"], counts=run["counts"],
                            tok_per_s=run["tok_per_s"],
                            rule=near_tie_rule(run["ids"], ref, prompt))
        log("sp generate entry: " + json.dumps(res["entry"]))
        for kind in ("ring", "ulysses"):
            p = pipe(sp_mesh=ShardGroup(devices_for(2, "cuda"), "sp"),
                     sp_kind=kind)
            logits, caches, ms, counts = prefill(p)
            cache_err = max(
                float((c[t] - bc[t]).abs().max() / bc[t].abs().max())
                for c, bc in zip(caches, base_caches) for t in ("k", "v"))
            out = dict(prefill_ms=ms, counts=counts,
                       logit_rel_err=float((logits - base).abs().max())
                       / scale, cache_rel_err=cache_err)
            del logits, caches
            if kind == "ulysses":
                got = p.generate(ids_t, new).cpu().numpy()
                out["rule"] = near_tie_rule(got, ref, prompt)
            res["kinds"][kind] = out
            log(f"sp prefill {kind}: " + json.dumps(out, default=str))
            del p
            free_card()
        del whole, views, base, base_caches
    free_card()
    res["seconds"] = time.monotonic() - t0
    return res


def check_sp_prefill(res, device_name: str) -> dict:
    """Phase 22c's gates; returns kernel 3's launches per prefill."""
    problems = []
    e = res["entry"]
    if any(e["counts"].values()) or not e["rule"]["ok"] \
            or ", sp 2" not in (e["label"] or ""):
        problems.append(f"entry --sp 2: {e}")
    for kind, r in res["kinds"].items():
        want = 2 * LLAMA_BLOCKS if kind == "ulysses" else 0
        if r["counts"]["fused_attention"] != want \
                or r["logit_rel_err"] > SP_LOGIT_BOUND \
                or r["cache_rel_err"] > SP_CACHE_BOUND[kind] \
                or not r.get("rule", {"ok": True})["ok"]:
            problems.append(f"{kind}: {r} (kernel 3 launches expected "
                            f"{want})")
    if problems:
        raise AssertionError("phase 22c: " + "; ".join(problems))
    log(f"sp prefill ms: sp 1 {res['sp1_prefill_ms']:.1f}, ring "
        f"{res['kinds']['ring']['prefill_ms']:.1f}, ulysses "
        f"{res['kinds']['ulysses']['prefill_ms']:.1f}; entry --sp 2 "
        f"{e['tok_per_s']} tok/s ({device_name})")
    return {kind: r["counts"]["fused_attention"]
            for kind, r in res["kinds"].items()}


# phase 23: the SPMD pipeline driver through the runtime entry, in this
# process, at the README's meshes: ViT-Base in 4 stages of 3 blocks at
# edge bits 0 / 8 / mixed; dp 2 x tp 2 at 2 stages; BERT-Large dp 2 x sp 2
SPMD_PT = "1,12,13,24,25,36,37,48"
SPMD_BITS = ("0,0,0,0", "8,8,8,0", "8,4,0,0")
SPMD_TP_PT = "1,24,25,48"
SPMD_TP_BITS = (0, 8)
BERT_LARGE = "bert-large-uncased"
SPMD_SP_PT = "1,48,49,96"
SPMD_SP_KINDS = ("ring", "ulysses")
# a whole model's logits under a tp mesh: row-parallel partial sums in
# another order than one matmul's, through 12 blocks (phase 21b's bound)
SPMD_TP_BOUND = TP_DCN_FP_BOUND
# sp cores against the unsharded attention over 24 blocks: phase 22's
# sp prefill bound (the ring streams in f32 einsums, Ulysses through
# kernel 3's 3xTF32, the unsharded run through kernel 3 over all tokens)
SPMD_SP_BOUND = SP_LOGIT_BOUND


def spmd_entry(argv, name: str) -> dict:
    """`python -m pipeedge_tpu_torch.runtime` with `argv`, in this
    process (its output captured and logged), in `_build/spmd/`: its
    report line, launches (counts set to 0 just before: the entry's
    warm-up and timed runs), saved results, seconds, and the device
    memory allocated before it (`resident_mib`) and at its peak
    (`peak_mib`, weights included)."""
    import io
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.ops import _build

    work = BUILD_DIR / "spmd"
    work.mkdir(parents=True, exist_ok=True)
    saved = work / f"{name}.npz"
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.chdir(work), contextlib.redirect_stdout(out):
        runtime.main(argv + ["--save-results", str(saved)])
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[{name}] {line}")
    report = next(ln for ln in lines if ln.startswith("latency_sec="))
    with np.load(saved) as z:
        results = [z[f"arr_{i}"] for i in range(len(z.files))]
    return dict(name=name, seconds=seconds,
                latency_s=float(report.split()[0].split("=")[1]),
                items_per_s=float(report.split("throughput_items_sec=")[1]),
                counts=dict(_build.launch_counts), results=results,
                resident_mib=resident / 2**20, peak_mib=peak / 2**20)


def spmd_memory(root: Path) -> dict:
    """Phase 23(b)'s dp 2 x tp 2 pipeline with the port imported from the
    checkout at `root` (this one or another version, to compare them),
    device memory in MiB above what was allocated before: built through
    the API as in phase 23(b), the stage parameters loaded (`loaded`),
    the pipeline alone once the caller has dropped them (`held`), the
    peak of two runs (`run_peak`); then the entry's run at
    `--tp-quant-bits 0` (`spmd_entry`: the runtime keeps its stage
    parameters through its run). The caller puts `root` first on
    `sys.path` before the port's first import."""
    import gc
    import pipeedge_tpu_torch
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import registry, vit
    from pipeedge_tpu_torch.parallel import spmd
    from pipeedge_tpu_torch.parallel.mesh import devices_for
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    weights = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    np.savez(weights, **vit.random_npz_weights(
        registry.get_model_config(MODEL), seed=0))

    def mib():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated() - base) / 2**20

    base = torch.cuda.memory_allocated()
    entry = registry.get_model_entry(MODEL)
    layers = [(1, 24), (25, 48)]
    mesh = spmd.make_pipeline_mesh(2, dp=2, tp=2,
                                   devices=devices_for(8, "cuda"))
    stages = [registry.module_shard_factory(
        MODEL, str(weights), l, r, stage=i,
        device=mesh.cell(0, i).devices[0])[1]
        for i, (l, r) in enumerate(layers)]
    res = dict(package=str(Path(pipeedge_tpu_torch.__file__).parent),
               loaded_mib=mib())
    pipe = spmd.build_spmd_pipeline(entry.family.FAMILY, entry.config,
                                    layers, stages, mesh)
    del stages
    gc.collect()
    res["held_mib"] = mib()
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    stacked = torch.stack(inputs)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        pipe.run(stacked).cpu()
    res["run_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    del pipe, stacked, inputs
    gc.collect()
    run = spmd_entry(["0", "8", "-c", "spmd", "-pt", SPMD_TP_PT,
                      "--spmd-dp", "2", "--spmd-tp", "2", "--tp-quant-bits",
                      "0", "-m", MODEL, "-M", str(weights), "-b", str(BATCH),
                      "-u", str(UBATCH)], "memory_b_tp0")
    return res | dict(entry_resident_mib=run["resident_mib"],
                      entry_peak_mib=run["peak_mib"],
                      entry_items_per_s=run["items_per_s"])


def rel_err(got: list, want: list) -> float:
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale


@contextlib.contextmanager
def qpsum_bounds(stats: dict):
    """Every `qpsum` call in the block: its result on each shard against
    the exact sum of the same addends, over `qpsum_error_bound` of the
    addends' widest 256-value block range (`stats["worst"]`, one sync at
    the end; above 1 breaks the bound)."""
    from pipeedge_tpu_torch.ops import qcollectives
    real = qcollectives.qpsum
    ratios = []

    def checked(group, xs, bit, **kw):
        out = real(group, xs, bit, **kw)
        block = kw.get("block", qcollectives.DEFAULT_BLOCK)
        exact = group.psum(xs)[0].float()
        blocks = [torch.nn.functional.pad(
            x.reshape(-1).float(), (0, -x.numel() % block))
            .reshape(-1, block) for x in xs]
        width = torch.stack([(r.amax(dim=1) - r.amin(dim=1)).max()
                             .to(exact.device) for r in blocks]).max()
        # the bound is linear in the range: evaluated on the card, no sync
        at0 = qcollectives.qpsum_error_bound(0.0, bit, group.size, block)
        at1 = qcollectives.qpsum_error_bound(1.0, bit, group.size, block)
        bound = at0 + (at1 - at0) * width
        err = torch.stack([(o.float().to(exact.device) - exact).abs().max()
                           for o in out]).max()
        ratios.append(err / bound)
        return out

    qcollectives.qpsum = checked
    try:
        yield
    finally:
        qcollectives.qpsum = real
        stats["calls"] = len(ratios)
        stats["worst"] = float(torch.stack(ratios).max()) if ratios else None


def spmd_launches(blocks: int, inner: int, dp: int, quant_edges: int,
                  qpsum_calls: int, n: int = 2) -> dict:
    """Phase 23's predicted launches of one run of UBATCH-item
    microbatches (valid stage-steps only, `parallel/spmd.py`): kernel 3
    once per block, microbatch, dp cell and inner shard (tp shards and
    Ulysses' head groups; pass inner 0 for the ring, which launches
    none); kernels 1 and 2 once per quantized edge and microbatch; a
    `qpsum` over n shards n^2 encodes and 2n(n - 1) decodes."""
    m = BATCH // UBATCH
    return {"fused_attention": blocks * m * dp * inner,
            "fused_encode": quant_edges * m + qpsum_calls * n * n,
            "fused_decode": quant_edges * m + qpsum_calls * 2 * n * (n - 1),
            "int8_matmul": 0, "decode_attention": 0}


def spmd_path(card: str) -> dict:
    """Phase 23: `runtime -c spmd` through the entry in this process.
    (a) ViT-Base (phase 4's npz) in 4 stages of 3 blocks at edge bits 0,
    8 and [8, 4], beside the host driver's exact run at the same cut (its
    warm second round); (b)
    dp 2 x tp 2 at 2 stages, `--tp-quant-bits` 0 and 8, and one more run
    at 8 bits through the API with every `qpsum` held to its bound; (c)
    BERT-Large (weights drawn on the card) at 2 stages unsharded, then dp
    2 x sp 2 with the ring and the Ulysses core."""
    from pipeedge_tpu_torch import runtime
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.parallel import spmd
    from pipeedge_tpu_torch.parallel import tensor as tp
    from pipeedge_tpu_torch.parallel.mesh import devices_for

    t0 = time.monotonic()
    vit_w = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    vit = ["-m", MODEL, "-M", str(vit_w), "-b", str(BATCH), "-u",
           str(UBATCH)]
    res = {"card": card, "a": {}, "b": {}, "c": {}}
    # the host driver's second round is its warm one, as the SPMD entry
    # times its run after a warm-up
    res["host"] = spmd_entry(["0", "4", "-pt", SPMD_PT, "--measure-rounds",
                              "2"] + vit, "host")
    res["host"]["results"] = res["host"]["results"][-(BATCH // UBATCH):]
    for q in SPMD_BITS:
        res["a"][q] = spmd_entry(["0", "4", "-c", "spmd", "-pt", SPMD_PT,
                                  "-q", q] + vit, f"a_q{q.replace(',', '')}")
    for bits in SPMD_TP_BITS:
        res["b"][bits] = spmd_entry(
            ["0", "8", "-c", "spmd", "-pt", SPMD_TP_PT, "--spmd-dp", "2",
             "--spmd-tp", "2", "--tp-quant-bits", str(bits)] + vit,
            f"b_tp{bits}")
    # the 8-bit all-reduces of one run, each against its bound
    entry = registry.get_model_entry(MODEL)
    layers = [(1, 24), (25, 48)]
    mesh = spmd.make_pipeline_mesh(2, dp=2, tp=2,
                                   devices=devices_for(8, "cuda"))
    stages = [registry.module_shard_factory(
        MODEL, str(vit_w), l, r, stage=i,
        device=mesh.cell(0, i).devices[0])[1]
        for i, (l, r) in enumerate(layers)]
    pipe = spmd.build_spmd_pipeline(entry.family.FAMILY, entry.config,
                                    layers, stages, mesh)
    inputs, _ = runtime.load_batches(MODEL, BATCH, UBATCH,
                                     torch.device("cuda"), torch.float32)
    bound = {}
    tp.set_tp_quant_bits(8)
    try:
        with qpsum_bounds(bound):
            out = pipe.run(torch.stack(inputs)).cpu().numpy()
    finally:
        tp.set_tp_quant_bits(0)
    bound["equal_to_entry"] = all(
        np.array_equal(o, e) for o, e in zip(out, res["b"][8]["results"]))
    res["qpsum_bound"] = bound
    log("qpsum bounds: " + json.dumps(bound))
    del pipe, stages
    free_card()
    # (c) BERT-Large, the entry's stages viewing weights drawn on the card
    whole = card_params(BERT_LARGE)
    bert = ["-m", BERT_LARGE, "-pt", SPMD_SP_PT, "-b", str(BATCH), "-u",
            str(UBATCH), "-c", "spmd"]
    with card_weights(BERT_LARGE, whole):
        res["c"]["unsharded"] = spmd_entry(["0", "2"] + bert, "c_sp1")
        for kind in SPMD_SP_KINDS:
            res["c"][kind] = spmd_entry(
                ["0", "8"] + bert + ["--spmd-dp", "2", "--spmd-sp", "2",
                                     "--spmd-sp-kind", kind], f"c_{kind}")
    del whole
    free_card()
    res["seconds"] = time.monotonic() - t0
    return res


def check_spmd_path(res, device_name: str) -> dict:
    """Phase 23's gates; returns each run's launches per run (the entry
    runs twice: warm-up and timed)."""
    problems = []
    exact = res["host"]["results"]
    launches = {}

    def gate(case: str, run: dict, want: dict, ok: bool, **numbers):
        per_run = {k: v / 2 for k, v in run["counts"].items()}
        launches[case] = per_run
        good = ok and per_run == {k: float(v) for k, v in want.items()} \
            and all(np.all(np.isfinite(r)) for r in run["results"])
        row = dict(case=case, items_per_s=run["items_per_s"],
                   seconds=run["seconds"], launches_per_run=per_run,
                   expected=want, ok=good, resident_mib=run["resident_mib"],
                   peak_mib=run["peak_mib"], **numbers)
        log("spmd " + json.dumps(row))
        if not good:
            problems.append(f"{case}: {row}")

    for q, run in res["a"].items():
        bits = [int(b) for b in q.split(",")[:-1]]
        err = rel_err(run["results"], exact)
        equal = all(np.array_equal(r, e) for r, e in
                    zip(run["results"], exact))
        if not any(bits):
            ok = equal            # the same functions as the host's stages
        else:
            ok = not equal and err <= LOGIT_BOUND[min(b for b in bits if b)]
        gate(f"a -q {q}", run, spmd_launches(12, 1, 1, sum(
            b in (4, 8) for b in bits), 0), ok, rel_err=err, equal=equal,
            shape=list(run["results"][0].shape))
    for bits, run in res["b"].items():
        err = rel_err(run["results"], exact)
        calls = 12 * 2 * 2 * (BATCH // UBATCH) if bits else 0
        if bits:
            qb = res["qpsum_bound"]
            ok = (err <= LOGIT_BOUND[8] and qb["calls"] == calls
                  and qb["worst"] <= 1.0 and qb["equal_to_entry"])
        else:
            ok = err <= SPMD_TP_BOUND
        gate(f"b dp2 tp2 --tp-quant-bits {bits}", run,
             spmd_launches(12, 2, 2, 0, calls), ok, rel_err=err,
             **({"qpsum_bound": res["qpsum_bound"]} if bits else {}))
    base = res["c"]["unsharded"]
    gate("c bert-large unsharded", base, spmd_launches(24, 1, 1, 0, 0),
         list(base["results"][0].shape) == [UBATCH, 1024])
    for kind in SPMD_SP_KINDS:
        run = res["c"][kind]
        err = rel_err(run["results"], base["results"])
        gate(f"c dp2 sp2 {kind}", run,
             spmd_launches(24, 2 if kind == "ulysses" else 0, 2, 0, 0),
             err <= SPMD_SP_BOUND, rel_err=err)
    if problems:
        raise AssertionError("phase 23: " + "; ".join(problems))
    log(f"spmd: host {res['host']['items_per_s']:.1f} items/s at {SPMD_PT}; "
        + ", ".join(f"{case} {res[k1][k2]['items_per_s']:.1f}"
                    for case, k1, k2 in (
                        ("a q0", "a", SPMD_BITS[0]), ("a q8", "a", SPMD_BITS[1]),
                        ("a q84", "a", SPMD_BITS[2]), ("b tp0", "b", 0),
                        ("b tp8", "b", 8), ("c sp1", "c", "unsharded"),
                        ("c ring", "c", "ring"), ("c ulysses", "c", "ulysses")))
        + f" items/s; phase 23 {res['seconds']:.1f} s ({device_name})")
    return launches


# --- phase 24: the SPMD wave decoder ----------------------------------------

# Phase 24, the wave decoder (`parallel/spmd_decode.py`, `generate
# --spmd-wave`): GPT-2 at full width and depth (phase 6's npz) in 4 stages
# of 3 blocks on the one card, R = 4 request slots of batch 4, 64-token
# prompts, 32 new tokens, f32 and fp caches (the wave takes no
# --kv-bits, as in JAX); the caches hold a verify span past the last token
WAVE_PT = "1,12,13,24,25,36,37,48"
WAVE_PARTITION = [(1, 12), (13, 24), (25, 36), (37, 48)]
WAVE_SLOTS, WAVE_BATCH, WAVE_PROMPT, WAVE_NEW = 4, 4, 64, 32
WAVE_GAMMA = 4
WAVE_MAX_LEN = WAVE_PROMPT + WAVE_NEW + WAVE_GAMMA
WAVE_SAMPLING = dict(temperature=0.9, top_k=40)
WAVE_SEED = 24                    # slot r samples with seed WAVE_SEED + r
WAVE_PREFIX = 32                  # (d): the prompts' shared first tokens
# (d): a row whose tokens differ from its reference must first differ at
# a near tie (`spec_rule` over the exact serial logits along the
# reference): its token the reference's second choice, their top-2 gap
# within this share of max |logit|. 0 bits: a prefix and a monolithic
# prompt pass (a verify span and serial steps) multiply matrices of other
# shapes, a few ulp apart: the DCN near-tie bound (`near_tie_rule`). 8
# bits: the prefix path quantizes the prefix's rows and the suffix's
# apart, the monolithic path the whole prompt's rows together, so their
# hops round differently: the 8-bit edge's bound.
WAVE_TIE = {0: 1e-4, 8: LOGIT_BOUND[8]}
# (e) Llama-3-8B at LLAMA_BLOCKS blocks in phase 14's 2 stages: 2 slots,
# batch, prompt, new tokens
LLAMA_WAVE = (2, 64, 16)
# what each synchronizing call warns under set_sync_debug_mode("warn")
# (the mode's own notice says "synchronizing operations" too)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn) -> tuple:
    """fn()'s result, and the warnings of the synchronizing calls it made
    (`torch.cuda.set_sync_debug_mode("warn")` for its time)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message) for w in caught
                 if SYNC_WARNING in str(w.message)]


def first_token_logits(wave, ids, prefix=None) -> torch.Tensor:
    """Each slot's first-token logits [R, B, V] through the prompt pass
    `generate` runs (the prefill wave, or the span wave at a prefix
    handle's offset), with no token picked."""
    slots, batch, _ = ids.shape
    out = torch.empty((slots, batch, wave.cfg.vocab_size), device=wave.last)

    def finish(r, logits):
        out[r] = logits[:, -1].float()

    with torch.inference_mode():
        caches = (wave._fresh_caches(slots * batch) if prefix is None
                  else wave._tile_prefix(prefix, slots * batch))
        wave._fill_wave(list(ids.to(wave.first)), caches, batch, finish,
                        pos=None if prefix is None else prefix["len"])
    return out


def logit_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def slot_rule(got, want, prompt: int, reference, bound: float) -> dict:
    """`spec_rule` for each slot of ids [R, B, prompt + N] that differs
    from `want`: `reference(r)` gives its serial logits along want[r]'s
    continuation (asked only then), and a near tie is a top-2 gap within
    `bound` x their max |logit|."""
    rows = []
    for r in range(want.shape[0]):
        if np.array_equal(got[r], want[r]):
            continue
        serial = reference(r)
        rule = spec_rule(got[r], want[r], prompt, serial,
                         bound * float(serial.abs().max()))
        rows += [dict(row, slot=r) for row in rule["differing"]]
    return dict(equal=not rows, differing=rows,
                ok=all(row["near_tie"] for row in rows))


def wave_entry(argv, name: str) -> dict:
    """`python -m pipeedge_tpu_torch.generate` with `argv` in this process
    (its output captured and logged): its ids, tokens/s, seconds and
    launches (counts set to 0 just before: warm-up and timed run)."""
    import io
    from pipeedge_tpu_torch import generate
    from pipeedge_tpu_torch.ops import _build

    out = io.StringIO()
    _build.reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        ids = generate.main(argv)
    seconds = time.monotonic() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[{name}] {line}")
    report = next(ln for ln in lines if ln.startswith("generated"))
    return dict(name=name, seconds=seconds, ids=ids, report=report,
                tok_per_s=float(report.split(" = ")[1].split()[0]),
                counts=dict(_build.launch_counts))


def wave_path(card: str) -> dict:
    """Phase 24 (a)-(d) (module docstring); (e) runs inside phase 14."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import decode, spmd
    from pipeedge_tpu_torch.parallel.spmd_decode import (
        SpmdDecodePipeline, SpmdSpeculativeDecoder)

    t0 = time.monotonic()
    weights = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    entry = registry.get_model_entry(DECODE_MODEL)
    cfg, family = entry.config, entry.family.FAMILY
    slots, batch, prompt, new = (WAVE_SLOTS, WAVE_BATCH, WAVE_PROMPT,
                                 WAVE_NEW)
    # phase 6's weights read once: every pipeline, draft and entry below
    # takes views of them (`card_weights`), so no stage reads the file
    # again
    total = 4 * cfg.num_hidden_layers
    whole = registry.module_shard_factory(DECODE_MODEL, str(weights), 1,
                                          total, device="cuda")[1]
    mesh = spmd.make_pipeline_mesh(len(WAVE_PARTITION))
    stages = [shard_view(whole, DECODE_MODEL, l, r)
              for l, r in WAVE_PARTITION]
    wave = SpmdDecodePipeline(family, cfg, WAVE_PARTITION, stages, mesh,
                              max_len=WAVE_MAX_LEN)
    wave8 = SpmdDecodePipeline(family, cfg, WAVE_PARTITION, stages, mesh,
                               max_len=WAVE_MAX_LEN, edge_bits=8)
    host = decode.DecodePipeline(family, cfg, WAVE_PARTITION, stages,
                                 max_len=WAVE_MAX_LEN, device="cuda")
    # every prompt opens with the same WAVE_PREFIX tokens, (d)'s prefix
    ids = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, size=(slots, batch, prompt))).to("cuda")
    ids[:, :, :WAVE_PREFIX] = ids[0, 0, :WAVE_PREFIX]
    seeds = [WAVE_SEED + r for r in range(slots)]
    res = {"card": card}
    wave.generate(ids, 2).cpu()                     # warm-ups
    host.generate(ids[0], 2).cpu()

    # (a) every slot against its solo run, greedy and sampled
    greedy, wave_s = timed(lambda: wave.generate(ids, new))
    stats = dict(wave.stats)
    solo, solo_s = [], 0.0
    for r in range(slots):
        out, secs = timed(lambda: host.generate(ids[r], new))
        solo.append(out)
        solo_s += secs
    sampled = wave.generate(ids, new, seeds=seeds,
                            **WAVE_SAMPLING).cpu().numpy()
    tokens = slots * batch * new
    res["a"] = dict(
        greedy_equal=[bool(np.array_equal(greedy[r], solo[r]))
                      for r in range(slots)],
        sampled_equal=[bool(np.array_equal(sampled[r], host.generate(
            ids[r], new, seed=seeds[r], **WAVE_SAMPLING).cpu().numpy()))
            for r in range(slots)],
        sampled_differs_from_greedy=not np.array_equal(sampled, greedy),
        stats=stats, wave_s=wave_s, solo_s=solo_s,
        wave_tok_per_s=tokens / wave_s, solo_tok_per_s=tokens / solo_s,
        shape=list(greedy.shape))
    log("wave (a) " + json.dumps(res["a"]))

    # (b) host syncs inside a greedy walk, ids already on the card; the
    # counter must see the one sync of a readback
    walked, syncs = count_syncs(lambda: wave.generate(ids, new))
    _, probe = count_syncs(lambda: torch.ones(1, device="cuda").item())
    res["b"] = dict(syncs=len(syncs), kinds=sorted(set(syncs))[:4],
                    readback_probe=len(probe),
                    equal=bool(np.array_equal(walked.cpu().numpy(), greedy)))
    log("wave (b) " + json.dumps(res["b"]))

    # (c) the entry at edge bits 0 and 8 beside --concurrent, and the
    # 8-bit first-token logits in process
    argv = ["-m", DECODE_MODEL, "-M", str(weights), "-pt", WAVE_PT, "-b",
            str(batch), "--prompt-len", str(prompt), "--new-tokens",
            str(new)]
    with card_weights(DECODE_MODEL, whole):
        res["c"] = {f"wave{bits}": wave_entry(
            argv + ["--spmd-wave", "--edge-bits", str(bits)], f"wave{bits}")
            for bits in (0, 8)}
        res["c"]["concurrent"] = wave_entry(
            argv + ["--concurrent", str(slots)], "concurrent")
    exact = first_token_logits(wave, ids)
    _build.reset_launch_counts()
    q8 = first_token_logits(wave8, ids)
    torch.cuda.synchronize()
    res["c"]["first_token"] = dict(
        counts=dict(_build.launch_counts),
        rel_err=[logit_rel(q8[r], exact[r]) for r in range(slots)])
    log("wave (c) " + json.dumps(
        {k: ({kk: v[kk] for kk in ("tok_per_s", "seconds", "counts")}
             if "ids" in v else v) for k, v in res["c"].items()}))

    # (d) a prefix-seeded wave against the monolithic one at 0 and 8 bits;
    # the speculative wave with a self-draft and a perturbed draft
    def serial(want):
        return lambda r: serial_logits(host, ids[r], want[r][:, prompt:])

    suffix = ids[:, :, WAVE_PREFIX:]
    res["d"] = {}
    for bits, w in ((0, wave), (8, wave8)):
        handle = w.precompute_prefix(ids[0, 0, :WAVE_PREFIX])
        # the monolithic wave: (a)'s greedy at 0 bits
        mono = greedy if not bits else w.generate(ids, new).cpu().numpy()
        got = np.concatenate([ids[:, :, :WAVE_PREFIX].cpu().numpy(),
                              w.generate(suffix, new, prefix=handle)
                              .cpu().numpy()], axis=2)
        res["d"][f"prefix{bits}"] = dict(
            rule=slot_rule(got, mono, prompt, serial(mono), WAVE_TIE[bits]),
            first_token_rel_err=logit_rel(
                first_token_logits(w, suffix, prefix=handle),
                exact if not bits else q8))
    draft = decode.DecodePipeline(family, cfg, [(1, total)], [whole],
                                  max_len=WAVE_MAX_LEN, device="cuda")
    for name, d_pipe in (("self", draft), ("noisy", noisy_draft(
            draft, WAVE_MAX_LEN, SPEC_NOISE, model=DECODE_MODEL))):
        spec = SpmdSpeculativeDecoder(wave, d_pipe, gamma=WAVE_GAMMA)
        spec.generate(ids, 2).cpu()                 # warm-up
        got, secs = timed(lambda: spec.generate(ids, new))
        res["d"][f"spec_{name}"] = dict(
            acceptance=spec.last_acceptance_rate, seconds=secs,
            tok_per_s=tokens / secs,
            rule=slot_rule(got, greedy, prompt, serial(greedy),
                          WAVE_TIE[0]))
    log("wave (d) " + json.dumps(res["d"]))
    del wave, wave8, host, draft, stages, whole
    free_card()
    res["seconds"] = time.monotonic() - t0
    return res


def check_wave_path(res, llama: dict, device_name: str) -> dict:
    """Phase 24's gates ((e) is gated in phase 14); returns the codec
    kernels' launches of (c)."""
    problems = []
    a, b, c, d = res["a"], res["b"], res["c"], res["d"]
    slots, k = WAVE_SLOTS, len(WAVE_PARTITION)
    steps = slots * k * WAVE_NEW
    ticks = (slots + k - 1) + (WAVE_NEW - 1) * slots + k - 1
    if not (all(a["greedy_equal"]) and all(a["sampled_equal"])
            and a["sampled_differs_from_greedy"]
            and a["stats"] == {"ticks": ticks, "stage_steps": steps}
            and a["shape"] == [slots, WAVE_BATCH, WAVE_PROMPT + WAVE_NEW]):
        problems.append(f"(a) {a}")
    if b["syncs"] or b["readback_probe"] != 1 or not b["equal"]:
        problems.append(f"(b) {b}")
    quant = 2 * slots * (k - 1)       # warm-up and timed prefill waves
    for bits in (0, 8):
        counts = c[f"wave{bits}"]["counts"]
        want = quant if bits else 0
        if counts["fused_encode"] != want or counts["fused_decode"] != want \
                or counts["fused_attention"] or counts["decode_attention"]:
            problems.append(f"(c) wave{bits} launches {counts}")
    conc = c["concurrent"]["ids"]
    if not all(np.array_equal(c["wave0"]["ids"][r], conc[r])
               for r in range(slots)):
        problems.append("(c) the 0-bit wave entry differs from "
                        "--concurrent")
    first = c["first_token"]
    if not all(0.0 < e <= LOGIT_BOUND[8] for e in first["rel_err"]) \
            or first["counts"]["fused_encode"] != slots * (k - 1) \
            or first["counts"]["fused_decode"] != slots * (k - 1):
        problems.append(f"(c) 8-bit first token {first}")
    for bits in (0, 8):
        case = d[f"prefix{bits}"]
        if not case["rule"]["ok"] \
                or case["first_token_rel_err"] > WAVE_TIE[bits]:
            problems.append(f"(d) prefix{bits} {case}")
    spec = d["spec_self"]
    if spec["acceptance"] != 1.0 or not spec["rule"]["equal"]:
        problems.append(f"(d) self-draft {spec}")
    if not d["spec_noisy"]["rule"]["ok"]:
        problems.append(f"(d) noisy draft {d['spec_noisy']}")
    if problems:
        raise AssertionError("phase 24: " + "; ".join(problems))
    log("wave: " + json.dumps({
        "wave_tok_per_s": a["wave_tok_per_s"],
        "solo_tok_per_s": a["solo_tok_per_s"],
        "entry_tok_per_s": {key: c[key]["tok_per_s"] for key in (
            "wave0", "wave8", "concurrent")},
        "spec_tok_per_s": {key: d[key]["tok_per_s"] for key in (
            "spec_self", "spec_noisy")},
        "spec_noisy_acceptance": d["spec_noisy"]["acceptance"],
        "first_token_rel_err_8bit": max(first["rel_err"]),
        "prefix_equal": {bits: d[f"prefix{bits}"]["rule"]["equal"]
                         for bits in (0, 8)},
        "syncs": b["syncs"], "llama3_wave": {
            key: llama[key] for key in ("equal", "wave_tok_per_s",
                                        "solo_tok_per_s")},
        "seconds": res["seconds"], "card": device_name}))
    return {name: {f"entry_bits{bits}": c[f"wave{bits}"]["counts"][name]
                   for bits in (0, 8)}
            | {"first_token_bits8": first["counts"][name]}
            for name in ("fused_encode", "fused_decode")}


def llama_wave(whole: dict) -> dict:
    """Phase 24(e), inside phase 14's Llama-3-8B block: the wave over
    `whole`'s views in phase 14's 2 stages, greedy, against each slot's
    solo `DecodePipeline` run on the same views."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.parallel import decode
    from pipeedge_tpu_torch.parallel.spmd_decode import SpmdDecodePipeline

    entry = registry.get_model_entry(LLAMA3)
    cfg, family = entry.config, entry.family.FAMILY
    batch, prompt, new = LLAMA_WAVE
    slots = len(FAMILY_PARTITION)
    views = [shard_view(whole, LLAMA3, l, r) for l, r in FAMILY_PARTITION]
    wave = SpmdDecodePipeline(family, cfg, FAMILY_PARTITION, views,
                              max_len=prompt + new)
    host = decode.DecodePipeline(family, cfg, FAMILY_PARTITION, views,
                                 max_len=prompt + new, device="cuda")
    ids = torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab_size, size=(slots, batch, prompt))).to("cuda")
    wave.generate(ids, 2).cpu()                     # warm-ups
    host.generate(ids[0], 2).cpu()
    got, wave_s = timed(lambda: wave.generate(ids, new))
    solo, solo_s = [], 0.0
    for r in range(slots):
        out, secs = timed(lambda: host.generate(ids[r], new))
        solo.append(out)
        solo_s += secs
    tokens = slots * batch * new
    return dict(equal=[bool(np.array_equal(got[r], solo[r]))
                       for r in range(slots)],
                stats=dict(wave.stats), shape=list(got.shape),
                wave_tok_per_s=tokens / wave_s,
                solo_tok_per_s=tokens / solo_s)


def check_llama_wave(res: dict, device_name: str) -> None:
    batch, prompt, new = LLAMA_WAVE
    slots = len(FAMILY_PARTITION)
    log("llama3 wave " + json.dumps(res | {"card": device_name}))
    if not all(res["equal"]) \
            or res["shape"] != [slots, batch, prompt + new] \
            or res["stats"]["stage_steps"] != slots * slots * new:
        raise AssertionError(f"phase 24(e): {res}")


# --- phase 25: training on the card ---------------------------------------

# Phase 25 (module docstring). (a) ViT-Base with Adam; the learning rate is
# 1e-4, where Adam's first steps move every weight by about that much (the
# entry's default 1e-3 is 5% of the init's 0.02 scale a step on 86M
# weights). (b) GPT-2 with SGD at 0.1, where the head's first step lowers
# the loss by about lr x |grad|^2 ~ 0.01 (at 1e-3 the descent would sit in
# the printed loss's fourth decimal).
TRAIN_VIT = ["-m", MODEL, "-pt", "1,24,25,48", "-u", "4", "-b", "8",
             "--optimizer", "adam", "--lr", "1e-4"]
TRAIN_GPT2 = ["-m", "gpt2", "-pt", "1,12,13,24,25,36,37,48", "-u", "4",
              "-b", "2", "--seq-len", "1024", "--mixed-precision",
              "--remat", "--optimizer", "sgd", "--lr", "0.1", "--steps",
              "5"]
TRAIN_STEPS = 5
# The first step's gradients on the card against the CPU's, per leaf: max
# |diff| <= 1e-3 of the leaf's max |grad| + 1e-5 of the largest gradient
# of all (k's bias gets none, so its own scale is round-off); f32 both,
# the card's products in f32 (TF32 off; kernel 3 in 3xTF32 and f32
# FMAs), summed in other orders through 12 blocks. The loss: 1e-5
# relative.
TRAIN_GRAD_TOL = (1e-3, 1e-5)
TRAIN_LOSS_RTOL = 1e-5
# The resumed run's losses against the uninterrupted run's, in the
# entry's printed 4 decimals: one unit of the last (the same steps on the
# same state, so equal is expected; the allowance is the rounding's)
TRAIN_RESUME_TOL = 1e-4


def train_launches(blocks: int, ubatches: int, dp: int, steps: int,
                   remat: bool) -> dict:
    """Kernel 3's launches in `steps` training steps: the backward once
    per block and stage-step (M x dp a block a step), the forward as many,
    twice under remat (the backward re-runs each block's forward)."""
    bwd = blocks * ubatches * dp * steps
    return {"fused_attention": bwd * (2 if remat else 1),
            "fused_attention_bwd": bwd}


def train_entry(argv) -> dict:
    """`pipeedge_tpu_torch.train.main(argv)` in this process: its summary,
    the `step=` losses, kernel 3's launches, peak memory and seconds."""
    import io
    from pipeedge_tpu_torch import train as train_cli
    from pipeedge_tpu_torch.ops import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        summary = train_cli.main(argv)
    seconds = time.monotonic() - t0
    text = out.getvalue()
    log("train entry " + " ".join(argv) + "\n" + text.rstrip())
    return dict(summary=summary, seconds=seconds,
                losses=[float(x) for x in re.findall(r"loss=([0-9.]+)", text)],
                resumed="resumed from" in text,
                launches={**_build.launch_counts,
                          **_build.grad_launch_counts},
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def first_step_grads(device: str):
    """Phase 25(a)'s first step at `-b 2` on `device`: the loss and each
    canonical leaf's gradient (on the CPU)."""
    from pipeedge_tpu_torch import train as train_cli
    from pipeedge_tpu_torch.parallel import train
    _, pipe, inputs, labels = train_cli.setup(
        TRAIN_VIT[:6] + ["-b", "2", "--device", device])
    loss, grads = train.value_and_grad(pipe, pipe.canonical, inputs, labels)
    return float(loss), [g.detach().cpu() for g in grads]


@contextlib.contextmanager
def drawn_once(model: str):
    """Within the block, `model`'s family draws each stage's seeded
    weights once and hands every later run a copy: the same numbers (the
    entry draws them with numpy per stage, seconds for ViT-Base) without
    drawing them again."""
    from pipeedge_tpu_torch.models import registry
    from pipeedge_tpu_torch.parallel.train import tree_map
    family = registry.get_model_entry(model).family
    draw, drawn = family.init_params, {}

    def init_params(cfg, shard_config, seed=0, dtype=torch.float32):
        key = (shard_config, seed, dtype)
        if key not in drawn:
            drawn[key] = draw(cfg, shard_config, seed=seed, dtype=dtype)
        return tree_map(torch.clone, drawn[key])

    family.init_params = init_params
    try:
        yield
    finally:
        family.init_params = draw


def train_path() -> dict:
    """Phase 25 (a) and (b) (module docstring)."""
    from pipeedge_tpu_torch.models import registry
    with drawn_once(MODEL):
        res = train_vit()
    t0 = time.monotonic()
    res["gpt2"] = train_entry(TRAIN_GPT2)
    res["seconds"]["b"] = time.monotonic() - t0
    log(f"phase 25b: {res['seconds']['b']:.1f} s")
    vit_blocks = registry.get_model_config(MODEL).num_hidden_layers
    gpt2_blocks = registry.get_model_config("gpt2").num_hidden_layers
    res["expected"] = {
        "vit": train_launches(vit_blocks, 4, 1, TRAIN_STEPS, False),
        "gpt2": train_launches(gpt2_blocks, 4, 1, TRAIN_STEPS, True)}
    return res


def train_vit() -> dict:
    """Phase 25(a): the 5-step run, the checkpointed 3 steps and the
    resumed 2, and the first step at `-b 2` on the card and the CPU."""
    import shutil
    res = {"seconds": {}}
    t0 = time.monotonic()
    res["vit"] = train_entry(TRAIN_VIT + ["--steps", str(TRAIN_STEPS)])
    ckpt = BUILD_DIR / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    res["vit_first3"] = train_entry(TRAIN_VIT + ["--steps", "3",
                                                 "--ckpt-dir", str(ckpt)])
    res["vit_resumed"] = train_entry(TRAIN_VIT + [
        "--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ckpt)])
    shutil.rmtree(ckpt, ignore_errors=True)
    card_loss, card_grads = first_step_grads("cuda")
    cpu_loss, cpu_grads = first_step_grads("cpu")
    scale = max(float(g.abs().max()) for g in cpu_grads)
    worst = 0.0
    for g, w in zip(card_grads, cpu_grads):
        limit = TRAIN_GRAD_TOL[0] * float(w.abs().max()) \
            + TRAIN_GRAD_TOL[1] * scale
        worst = max(worst, float((g - w).abs().max()) / limit)
    res["first_step"] = dict(card_loss=card_loss, cpu_loss=cpu_loss,
                             leaves=len(cpu_grads), worst_share=worst,
                             max_grad=scale)
    res["seconds"]["a"] = time.monotonic() - t0
    log(f"phase 25a: {res['seconds']['a']:.1f} s")
    return res


def check_train_path(res, device_name: str) -> dict:
    """Phase 25's gates; returns kernel 3's launches per run."""
    problems = []
    for key in ("vit", "gpt2"):
        run = res[key]
        losses = run["losses"]
        s = run["summary"]
        log(f"train {key}: " + json.dumps(dict(
            losses=losses, steps_per_sec=s["steps_per_sec"],
            wall_s=s["wall_s"], seconds=run["seconds"],
            peak_mib=run["peak_mib"], launches=run["launches"],
            expected=res["expected"][key], mesh=s["mesh"],
            remat=s["remat"], mixed_precision=s["mixed_precision"],
            card=device_name)))
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0]:
            problems.append(f"{key}: losses {losses} do not fall")
        want = res["expected"][key]
        if any(run["launches"][k] != n for k, n in want.items()):
            problems.append(f"{key}: kernel 3 launches {run['launches']} != "
                            f"{want}")
        if any(run["launches"][k] for k in ("fused_encode", "fused_decode",
                                            "int8_matmul",
                                            "decode_attention")):
            problems.append(f"{key}: a kernel off the training path ran: "
                            f"{run['launches']}")
    first = res["first_step"]
    log("train vit first step (-b 2, card against cpu): " + json.dumps(
        {**first, "card": device_name}))
    if first["worst_share"] > 1.0 or abs(first["card_loss"] - first[
            "cpu_loss"]) > TRAIN_LOSS_RTOL * abs(first["cpu_loss"]):
        problems.append(f"vit first step: gradients at {first['worst_share']}"
                        f" of TRAIN_GRAD_TOL, loss {first['card_loss']} "
                        f"against {first['cpu_loss']}")
    resumed = res["vit_resumed"]
    log("train vit resume: " + json.dumps(dict(
        first3=res["vit_first3"]["losses"], resumed=resumed["losses"],
        uninterrupted=res["vit"]["losses"])))
    if not resumed["resumed"] or resumed["summary"]["steps"] != 2 or \
            abs(resumed["losses"][-1] - res["vit"]["losses"][-1]) \
            > TRAIN_RESUME_TOL or not np.allclose(
                res["vit_first3"]["losses"], res["vit"]["losses"][:3],
                rtol=0, atol=TRAIN_RESUME_TOL):
        problems.append("vit resume: the resumed run's losses "
                        f"{resumed['losses']} (resumed={resumed['resumed']})"
                        f" are not the uninterrupted run's "
                        f"{res['vit']['losses'][3:]}")
    log("phase 25 seconds " + json.dumps(res["seconds"]))
    if problems:
        raise AssertionError("phase 25: " + "; ".join(problems))
    return {key: res[key]["launches"] for key in ("vit", "gpt2")}


# --- phase 26: the multi-process contexts -----------------------------------

# Two ranks of this script, each a process, join one `torch.distributed`
# world (`comm.MultiHostContext`, gloo: NCCL refuses two ranks on the one
# card) with 4 positions each on cuda:0, process-major. ViT-Base (phase
# 4's npz) in 4 stages of 3 blocks, M = 4 microbatches of 8: (a) dp 2 x 4
# stages, one dp row a rank, 8-bit edges; (b) dp 1 x 4 stages, stages 0-1
# on rank 0 and 2-3 on rank 1, 8-bit edges (kernel 1's words cross the
# process); (c) 3 SGD steps on each layout; (d) GPT-2 (phase 6's npz) in
# 2 stages, greedy, over a tp group of one position in each rank.
MH_WORLD = 2
MH_LOCAL = 4
MH_PARTITION = [(1, 12), (13, 24), (25, 36), (37, 48)]
MH_M, MH_B = 4, 8
MH_STEPS = 3
MH_LR = 0.1
MH_GPT2 = dict(partition=[(1, 24), (25, 48)], batch=4, prompt=32, new=16,
               max_len=64)
MH_HOP_ROUNDS = 20
MH_TIMEOUT_S = 180    # the ranks' legs took 16.5 s (H100 80GB HBM3, 700 W)


def mh_inputs():
    """Phase 26's images [M, B, 3, 224, 224] and labels [M, B] (numpy
    streams, so every process draws the same)."""
    from pipeedge_tpu_torch.models import registry
    cfg = registry.get_model_config(MODEL)
    rng = np.random.default_rng(26)
    x = rng.normal(size=(MH_M, MH_B, cfg.num_channels, cfg.image_size,
                         cfg.image_size)).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, size=(MH_M, MH_B))
    ids = np.random.default_rng(27).integers(
        0, registry.get_model_config(DECODE_MODEL).vocab_size,
        size=(MH_GPT2["batch"], MH_GPT2["prompt"]))
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(ids)


def mh_stage_params():
    """ViT-Base's 4 stages on the CPU (phase 4's npz), and GPT-2's 2."""
    from pipeedge_tpu_torch.models import ShardConfig, gpt2, registry, vit
    out = {}
    for model, module, partition, weights in (
            (MODEL, vit, MH_PARTITION,
             BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"),
            (DECODE_MODEL, gpt2, MH_GPT2["partition"],
             BUILD_DIR / f"{DECODE_MODEL}-random-seed0.npz")):
        cfg = registry.get_model_config(model)
        total = registry.get_model_layers(model)
        with np.load(weights) as npz:
            w = {k: npz[k] for k in npz.files}
        out[model] = [module.load_params(cfg, ShardConfig(
            l, r, is_first=l == 1, is_last=r == total), w)
            for l, r in partition]
    return out


def mh_cuda(stages):
    """A fresh copy of stage parameters on the card (training updates the
    positions' tensors in place)."""
    from pipeedge_tpu_torch.parallel.train import tree_map
    return [tree_map(lambda t: t.to("cuda", copy=True), p)
            for p in stages]


def mh_vit_pipe(stages, mesh, bits):
    from pipeedge_tpu_torch.models import registry, vit
    from pipeedge_tpu_torch.parallel import spmd
    return spmd.build_spmd_pipeline(
        vit.FAMILY, registry.get_model_config(MODEL), MH_PARTITION,
        mh_cuda(stages), mesh,
        quant_bit=[bits] * (len(MH_PARTITION) - 1) + [0])


def mh_layouts(positions=None) -> dict:
    """(a)'s dp 2 x 4 mesh and (b)'s stage split over `positions`
    (`global_devices()`), or both over one process's 8 positions."""
    from pipeedge_tpu_torch.parallel import spmd
    n = len(MH_PARTITION)
    if positions is None:
        return {"a": spmd.make_pipeline_mesh(n, dp=2, device="cuda"),
                "b": spmd.make_pipeline_mesh(n, device="cuda")}
    return {"a": spmd.make_pipeline_mesh(n, dp=2, devices=positions),
            "b": spmd.make_pipeline_mesh(n, devices=[
                positions[0], positions[1], positions[MH_LOCAL],
                positions[MH_LOCAL + 1]])}


def mh_timed_run(pipe, x) -> tuple:
    """A warm-up run, then the timed run with every count at 0 just
    before it: (output on the CPU, items/s, launches)."""
    from pipeedge_tpu_torch.ops import _build
    pipe.run(x)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.run(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (out.cpu(), MH_M * MH_B / dt, dict(_build.launch_counts))


def mh_train(pipe, x, y) -> dict:
    """The first step's loss and gradients (`value_and_grad`), then
    MH_STEPS SGD steps with every count at 0 just before them."""
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel import train
    loss0, grads = train.value_and_grad(pipe, pipe.canonical, x, y)
    parts = {part: [g.detach().cpu() for g in grads[i:j]]
             for part, i, j in train._parts(pipe.canonical)}
    step, state = train.make_train_step(
        pipe, lambda leaves: torch.optim.SGD(leaves, lr=MH_LR), x)
    params, losses = pipe.canonical, []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(MH_STEPS):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(first_loss=float(loss0), first_grads=parts, losses=losses,
                steps_per_s=MH_STEPS / dt,
                launches={**_build.launch_counts,
                          **_build.grad_launch_counts})


def mh_decode(stages, mesh) -> dict:
    """GPT-2 greedy over a tp `mesh`: tokens, tokens/s and launches."""
    from pipeedge_tpu_torch.models import gpt2, registry
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel.decode import DecodePipeline
    pipe = DecodePipeline(gpt2.FAMILY, registry.get_model_config(
        DECODE_MODEL), MH_GPT2["partition"], mh_cuda(stages),
        max_len=MH_GPT2["max_len"], mesh=mesh)
    ids = mh_inputs()[2].to("cuda")
    pipe.generate(ids, 2)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = pipe.generate(ids, MH_GPT2["new"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(tokens=tokens.cpu(),
                tok_per_s=MH_GPT2["batch"] * MH_GPT2["new"] / dt,
                launches=dict(_build.launch_counts))


def mh_hop_ms(rank: int) -> dict:
    """One hop between the ranks through the host (gloo, pinned staging),
    ms: (b)'s 8-bit edge payload of a microbatch and its f32 activation
    (the training edge), each a ping-pong of MH_HOP_ROUNDS round trips."""
    from pipeedge_tpu_torch.comm.exchange import exchange
    from pipeedge_tpu_torch.ops import fused_quant
    from pipeedge_tpu_torch.models import registry
    cfg = registry.get_model_config(MODEL)
    act = torch.randn(MH_B, cfg.num_patches + 1, cfg.hidden_size,
                      device="cuda")
    out = {}
    for name, payload in (("edge8", fused_quant.encode_outerdim(act, 8)),
                          ("f32", act)):
        peer = 1 - rank
        exchange({1: [payload]} if rank == 0 else {}, [] if rank == 0
                 else [0], "cuda", [0, 1])          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MH_HOP_ROUNDS):
            if rank == 0:
                exchange({peer: [payload]}, [], "cuda", [0, 1])
                exchange({}, [peer], "cuda", [0, 1])
            else:
                got = exchange({}, [peer], "cuda", [0, 1])[peer]
                exchange({peer: got}, [], "cuda", [0, 1])
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / (2 * MH_HOP_ROUNDS)
    return out


def mh_rank(rank: int, coord: str, work: Path) -> int:
    """One rank of phase 26 (`chip_smoke.py --multihost-rank R ...`): load
    the weights, wait for the parent's go, then the legs; every result to
    `work/rank<R>.pt`, each leg's launches on a `rank=R leg=L
    kernel_launches=` line."""
    from pipeedge_tpu_torch.comm import MultiHostContext, global_devices
    from pipeedge_tpu_torch.ops import _build
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    _build.library()
    stages = mh_stage_params()
    x, y, _ = mh_inputs()
    x, y = x.to("cuda"), y.to("cuda")
    ready_s = time.monotonic() - t0
    go = work / "go"
    while not go.exists():
        time.sleep(0.05)
    res = {"ready_s": ready_s}
    with MultiHostContext(coord, MH_WORLD, rank, backend="gloo",
                          device="cuda") as ctx:
        log(f"multihost rank {rank}: torch.distributed backend "
            f"{ctx.backend}, {MH_LOCAL} positions on {ctx.devices[0]}")
        res["backend"] = ctx.backend
        positions = global_devices([ctx.devices[0]] * MH_LOCAL)
        layouts = mh_layouts(positions)
        for leg in ("a", "b"):
            out, ips, counts = mh_timed_run(
                mh_vit_pipe(stages[MODEL], layouts[leg], 8), x)
            res[leg] = dict(out=out, items_per_s=ips, launches=counts)
        for leg in ("a", "b"):
            res[f"c_{leg}"] = mh_train(
                mh_vit_pipe(stages[MODEL], layouts[leg], 0), x, y)
        res["d"] = mh_decode(stages[DECODE_MODEL], ShardGroup(
            [positions[0], positions[MH_LOCAL]], "tp"))
        res["hop_ms"] = mh_hop_ms(rank)
        for leg in ("a", "b", "c_a", "c_b", "d"):
            print(f"rank={rank} leg={leg} kernel_launches="
                  + json.dumps(res[leg]["launches"]), flush=True)
        torch.save(res, work / f"rank{rank}.pt")
        torch.distributed.barrier()
    log(f"multihost rank {rank}: done")
    return 0


def multihost_start() -> dict:
    """Start phase 26's two ranks: they load their weights (beside phase
    25, for the script's time) and wait for `multihost_path`'s go."""
    import shutil
    work = BUILD_DIR / "multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    import socket
    with socket.create_server(("127.0.0.1", 0)) as s:
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    for r in range(MH_WORLD):
        log_file = open(work / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-rank",
             str(r), "--multihost-coord", coord, "--multihost-dir",
             str(work)], cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT))))
        log_file.close()
    return {"work": work, "procs": procs, "t0": time.monotonic()}


def multihost_stop(started: dict) -> None:
    """Kill the ranks that still run (a failed phase must not leave them)."""
    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()


def mh_references() -> dict:
    """Phase 26's legs in this process on one process's 8 positions: the
    references the ranks are held to."""
    from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for
    stages = mh_stage_params()
    x, y, _ = mh_inputs()
    x, y = x.to("cuda"), y.to("cuda")
    layouts = mh_layouts()
    ref = {}
    for leg in ("a", "b"):
        out, ips, counts = mh_timed_run(
            mh_vit_pipe(stages[MODEL], layouts[leg], 8), x)
        ref[leg] = dict(out=out, items_per_s=ips, launches=counts)
    for leg in ("a", "b"):
        ref[f"c_{leg}"] = mh_train(
            mh_vit_pipe(stages[MODEL], layouts[leg], 0), x, y)
    ref["d"] = mh_decode(stages[DECODE_MODEL],
                         ShardGroup(devices_for(2, "cuda"), "tp"))
    return ref


def mh_rates(root: Path, repeats: int = 3) -> dict:
    """`mh_references`' rates with the port imported from the checkout at
    `root` (this one or another version, to compare them), each leg
    `repeats` times: (a) and (b) items/s, (c) steps/s, (d) tokens/s. The
    caller puts `root` first on `sys.path` before the port's first
    import."""
    import pipeedge_tpu_torch
    from pipeedge_tpu_torch.models import gpt2, registry, vit
    from pipeedge_tpu_torch.ops import _build
    _build.library()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for model, module in ((MODEL, vit), (DECODE_MODEL, gpt2)):
        path = BUILD_DIR / f"{model.replace('/', '_')}-random-seed0.npz"
        if not path.exists():
            np.savez(path, **module.random_npz_weights(
                registry.get_model_config(model), seed=0))
    rates = {}
    for _ in range(repeats):
        ref = mh_references()
        for leg, key in (("a", "items_per_s"), ("b", "items_per_s"),
                         ("c_a", "steps_per_s"), ("c_b", "steps_per_s"),
                         ("d", "tok_per_s")):
            rates.setdefault(leg, []).append(ref[leg][key])
    return dict(package=str(Path(pipeedge_tpu_torch.__file__).parent),
                **rates)


def multihost_path(started: dict) -> dict:
    """Phase 26: the in-process references on one process's 8 positions,
    then the ranks' legs (module docstring); fails if a rank fails."""
    work, procs = started["work"], started["procs"]
    res = {"seconds": {}}
    try:
        t0 = time.monotonic()
        res["ref"] = mh_references()
        res["seconds"]["references"] = time.monotonic() - t0
        res["ranks_up_s"] = time.monotonic() - started["t0"]
        (work / "go").touch()
        t1 = time.monotonic()
        # a rank that fails leaves the other waiting in a collective: stop
        # waiting at the first failure (or the limit) and kill both
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs) \
                and time.monotonic() < t1 + MH_TIMEOUT_S:
            time.sleep(0.1)
        res["seconds"]["ranks"] = time.monotonic() - t1
    finally:
        multihost_stop(started)
    outs = [(work / f"rank{r}.log").read_text() for r in range(MH_WORLD)]
    if any(p.returncode for p in procs):   # -9: killed after the other
        raise AssertionError("multihost: " + "\n".join(
            f"rank {r} exited {p.returncode}:\n{outs[r][-3000:]}"
            for r, p in enumerate(procs)))
    res["logs"] = outs
    res["ranks"] = [torch.load(work / f"rank{r}.pt", weights_only=False)
                    for r in range(MH_WORLD)]
    res["launch_lines"] = [[ln for ln in text.splitlines()
                            if ln.startswith(f"rank={r} leg=")]
                           for r, text in enumerate(outs)]
    res["seconds"]["phase"] = time.monotonic() - t0
    return res


def mh_expected() -> dict:
    """Each rank's launches per leg (module docstring of
    `parallel/spmd.py`): (a) its dp row's 12 blocks x M, 3 8-bit edges x
    M; (b) rank 0 stages 0-1 (6 blocks, 2 edges leaving, 1 arriving) and
    rank 1 stages 2-3; (c) MH_STEPS steps of the same forward plus its
    backward; (d) none (a float cache: no kernel 5; the prompt attends
    through the cache step, off kernel 3)."""
    per = 3   # blocks a stage
    a = {"fused_attention": 4 * per * MH_M, "fused_encode": 3 * MH_M,
         "fused_decode": 3 * MH_M}
    b = [{"fused_attention": 2 * per * MH_M, "fused_encode": 2 * MH_M,
          "fused_decode": MH_M},
         {"fused_attention": 2 * per * MH_M, "fused_encode": MH_M,
          "fused_decode": 2 * MH_M}]

    def train(blocks):
        n = blocks * MH_M * MH_STEPS
        return {"fused_attention": n, "fused_attention_bwd": n}
    return {r: {"a": a, "b": b[r], "c_a": train(4 * per),
                "c_b": train(2 * per), "d": {}} for r in range(MH_WORLD)}


def check_multihost_path(res, device_name: str) -> dict:
    """Phase 26's gates; returns each rank's launches per leg."""
    ranks, ref = res["ranks"], res["ref"]
    problems = []
    expected = mh_expected()
    # each rank's launches as it reported them on its `kernel_launches=`
    # lines
    launches = {r: {line.split(" ", 2)[1][4:]: json.loads(
        line.split("kernel_launches=", 1)[1]) for line in lines}
        for r, lines in enumerate(res["launch_lines"])}
    for r, got in enumerate(ranks):
        if got["backend"] != "gloo":
            problems.append(f"rank {r}: backend {got['backend']}")
        for leg, want in expected[r].items():
            if leg not in launches[r]:
                problems.append(f"rank {r}: no kernel_launches line for "
                                f"leg {leg}")
                continue
            counts = launches[r][leg]
            # over both key sets: a kernel the leg needs that the rank did
            # not report fails, as does one it launched that it needs not
            wrong = {k: counts.get(k) for k in set(counts) | set(want)
                     if k not in counts or counts[k] != want.get(k, 0)}
            if wrong:
                problems.append(f"rank {r} leg {leg}: launches {counts}, "
                                f"expected {want}")
        for leg in ("a", "b"):
            if not torch.equal(got[leg]["out"], ref[leg]["out"]):
                diff = float((got[leg]["out"] - ref[leg]["out"]).abs().max())
                problems.append(f"rank {r} leg {leg}: output differs from "
                                f"the in-process run by {diff}")
        if not torch.equal(got["d"]["tokens"], ref["d"]["tokens"]):
            problems.append(f"rank {r} leg d: tokens differ from the "
                            "in-process --tp 2 run")
    train_rows = {}
    for leg in ("c_a", "c_b"):
        printed = [[f"{v:.6f}" for v in got[leg]["losses"]] for got in ranks]
        want = ref[leg]["losses"]
        worst = 0.0
        scale = max(float(g.abs().max()) for gs in
                    ref[leg]["first_grads"].values() for g in gs)
        for got in ranks:
            for part, grads in got[leg]["first_grads"].items():
                for g, w in zip(grads, ref[leg]["first_grads"][part]):
                    limit = TRAIN_GRAD_TOL[0] * float(w.abs().max()) \
                        + TRAIN_GRAD_TOL[1] * scale
                    worst = max(worst, float((g - w).abs().max()) / limit)
        train_rows[leg] = dict(
            losses=printed[0], in_process=want,
            steps_per_s=[got[leg]["steps_per_s"] for got in ranks],
            in_process_steps_per_s=ref[leg]["steps_per_s"],
            first_grad_worst_share=worst)
        if printed[0] != printed[1]:
            problems.append(f"{leg}: the ranks' losses differ: {printed}")
        if not np.allclose(ranks[0][leg]["losses"], want, rtol=1e-5, atol=0):
            problems.append(f"{leg}: losses {ranks[0][leg]['losses']} not "
                            f"within rtol 1e-5 of the in-process {want}")
        if worst > 1.0:
            problems.append(f"{leg}: first-step gradients at {worst} of "
                            "TRAIN_GRAD_TOL")
    log("multihost " + json.dumps(dict(
        items_per_s={leg: [got[leg]["items_per_s"] for got in ranks]
                     for leg in ("a", "b")},
        in_process_items_per_s={leg: ref[leg]["items_per_s"]
                                for leg in ("a", "b")},
        train=train_rows,
        decode_tok_per_s=[got["d"]["tok_per_s"] for got in ranks],
        in_process_decode_tok_per_s=ref["d"]["tok_per_s"],
        hop_ms=[got["hop_ms"] for got in ranks],
        ready_s=[got["ready_s"] for got in ranks],
        ranks_up_s=res["ranks_up_s"], seconds=res["seconds"],
        card=device_name)))
    for lines in res["launch_lines"]:
        for line in lines:
            log("multihost " + line)
    if problems:
        raise AssertionError("phase 26: " + "; ".join(problems))
    return launches


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
    parser.add_argument("--edge-cut-sweep", action="store_true",
                        help="only print phase 19(a)'s 8-bit edge error at "
                             "every 2-stage cut of ViT-Base, and exit")
    parser.add_argument("--spmd-memory", type=Path, nargs="?", const=ROOT,
                        default=None, metavar="ROOT",
                        help="only run phase 23(b)'s dp 2 x tp 2 run with "
                             "the port of the checkout at ROOT (default "
                             "this one), print its device memory, and exit")
    parser.add_argument("--mh-rates", type=Path, nargs="?", const=ROOT,
                        default=None, metavar="ROOT",
                        help="only run phase 26's in-process legs three "
                             "times with the port of the checkout at ROOT "
                             "(default this one), print their rates, and "
                             "exit")
    parser.add_argument("--multihost-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--multihost-coord", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--multihost-dir", type=Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.multihost_rank is not None:     # one of phase 26's ranks
        return mh_rank(args.multihost_rank, args.multihost_coord,
                       args.multihost_dir)
    if args.edge_cut_sweep:
        log(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for row in edge_cut_sweep():
            log("edge cut " + json.dumps(row))
        return 0
    if args.spmd_memory is not None:
        log(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        sys.path.insert(0, str(args.spmd_memory.resolve()))
        log("spmd memory " + json.dumps(spmd_memory(args.spmd_memory)))
        return 0
    if args.mh_rates is not None:
        log(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sys.path.insert(0, str(args.mh_rates.resolve()))
        log("mh rates " + json.dumps(mh_rates(args.mh_rates)))
        return 0
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
    for key, row in codec_rows.items():
        log(f"{key[0]} " + json.dumps(row))
    attn_rows = check_attention(dev, gen)
    attn_bwd_rows = check_attention_backward(dev, gen)
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

    # phase 14: the decoder families at full width; phase 15a, the reverse
    # auction, beside its (g)
    fam = families_path(card, device_name, alongside=revauct_path)
    revauct_res = fam.pop("alongside")

    phase_done("phase 14")

    # phase 15: the rest of PipeEdge's loop and the replica router
    check_revauct_path(revauct_res, device_name)
    phase_done("phase 15a (beside 14g)")
    trace_res = tracing_path()
    check_tracing_path(trace_res, device_name)
    phase_done("phase 15b")
    gen_res = generate_flags_path()
    check_generate_flags_path(gen_res, device_name)
    phase_done("phase 15c")
    adopt_res = router_adopt_path()
    check_router_adopt_path(adopt_res, device_name)
    phase_done("phase 15d")
    spawn_res = router_spawn_path()
    check_router_spawn_path(spawn_res, device_name)
    phase_done("phase 15e")

    # phase 16: PipeEdge's own transport, one process per rank; phase
    # 21(b), the tensor-parallel fleets, beside its (b) and (d)
    vit_w = BUILD_DIR / f"{MODEL.replace('/', '_')}-random-seed0.npz"
    dcn_res = dcn_path(card, host={bit: results[bit]["items_per_s"]
                                   for bit in (0, 8, 4)},
                       deit_constraint=deit_res["unconstrained"][
                           "send_constraint_items_s"],
                       alongside=lambda: tp_dcn_path(vit_w))
    check_dcn_path(dcn_res, device_name)
    tp_dcn_res = dcn_res.pop("alongside")
    tp_dcn_launches = check_tp_dcn(tp_dcn_res, device_name)
    log(f"phase 21b (beside phase 16): {tp_dcn_res['seconds']:.1f} s")
    phase_done("phase 16")

    # phase 17: the routed fleet's observatory and capacity loop
    auto_res = autoscale_path()
    check_autoscale_path(auto_res, device_name)
    phase_done("phase 17")

    # phase 18: the DCN driver's fault plane, through the chaos harness;
    # phase 20(b), the harness's serve-disagg case, runs beside its cases
    gpt2_w = BUILD_DIR / f"{DECODE_MODEL.replace('/', '_')}-random-seed0.npz"
    chaos_res = chaos_path(dcn_res["vit"]["results"][BATCH // UBATCH:
                                                     2 * (BATCH // UBATCH)],
                           alongside=lambda: disagg_chaos(gpt2_w))
    chaos_launches = check_chaos_path(chaos_res, device_name)
    phase_done("phase 18")

    # phase 19: the DCN driver's control loop; phase 20's untimed prelude
    # (the process-mode server's start-up, the references) runs beside
    # its fleets (b)-(d)
    disagg_chaos_res = chaos_res.pop("alongside")
    control_res = control_path(
        alongside=lambda: disagg_prelude(chaos=disagg_chaos_res))
    control_launches = check_control_path(control_res, device_name)
    phase_done("phase 19")

    # phase 20: disaggregated serving
    disagg_res = disagg_path(card, prelude=control_res.pop("alongside"))
    disagg_launches = check_disagg_path(disagg_res, device_name)
    phase_done("phase 20")

    # phase 21: the tensor-parallel axis ((b) ran beside phase 16)
    tp_res = tp_kernels_path(dev, gen)
    check_tp_kernels(tp_res, device_name)
    phase_done("phase 21a")
    tp_gen_res = tp_generate_path(card)
    tp_gen_launches = check_tp_generate(tp_gen_res, device_name)
    phase_done("phase 21c")

    # phase 22: expert and sequence parallelism
    ep_sp_res = ep_sp_kernels_path(dev, gen)
    check_ep_sp_kernels(ep_sp_res, device_name)
    phase_done("phase 22a")
    ep_gen_res = ep_generate_path(card, dev, gen)
    ep_gen_launches = check_ep_generate(ep_gen_res, device_name)
    phase_done("phase 22b")
    sp_res = sp_prefill_path(card)
    sp_launches = check_sp_prefill(sp_res, device_name)
    phase_done("phase 22c")

    # phase 23: the SPMD pipeline driver through the runtime entry
    spmd_res = spmd_path(card)
    spmd_runs = check_spmd_path(spmd_res, device_name)
    phase_done("phase 23")

    # phase 24: the SPMD wave decoder ((e) ran inside phase 14)
    wave_res = wave_path(card)
    wave_launches = check_wave_path(wave_res, fam["llama3_wave"],
                                    device_name)
    phase_done("phase 24")

    # phase 25: training on the card; phase 26's ranks start beside it
    mh_started = multihost_start()
    try:
        train_res = train_path()
        train_counts = check_train_path(train_res, device_name)
        phase_done("phase 25")

        # phase 26: the multi-process contexts, two ranks of this script
        mh_res = multihost_path(mh_started)
    finally:
        multihost_stop(mh_started)
    mh_launches = check_multihost_path(mh_res, device_name)
    phase_done("phase 26")

    def multihost_launches_of(name):
        """Phase 26's launches of one kernel in each rank's process, per
        leg: (a) and (b) a timed run each, (c) MH_STEPS steps on each
        layout, (d) the timed tp decode."""
        return {leg: {f"rank{r}": per_leg[leg].get(name, 0)
                      for r, per_leg in mh_launches.items()}
                for leg in ("a", "b", "c_a", "c_b", "d")}

    def spmd_launches_of(name):
        """Phase 23's launches of one kernel per run of 8 microbatches."""
        return {case: counts[name] for case, counts in spmd_runs.items()}

    if args.ab_entry_parent is not None:
        ab_entry(args.ab_entry_parent)
        phase_done("ab entry")

    def paired(prefix):
        """The A/B rows of one kernel: case -> parent mean over this one's."""
        return {r["case"]: r["speedup"] for r in ab_rows
                if r["case"].startswith(prefix)} or None

    main_attn = next(r for r in attn_rows if r["layout"] == "bshd"
                     and r["dtype"] == "float32")

    def dcn_launches(name):
        """Phase 16's launches of one kernel in each rank's process: (a)
        per round, (b) the adaptive fleet's."""
        return {
            "vit_2_ranks": {f"round{k + 1}": {
                f"rank{r}": c[name] for r, c in rnd["counts"].items()}
                for k, rnd in enumerate(dcn_res["vit"]["rounds"])},
            "deit_3_ranks_adaptive": {
                f"rank{r}": c[name]
                for r, c in dcn_res["deit"]["counts"].items()},
            "local_tier": dcn_res["local"]["counts"][name]}

    def control_launches_of(name):
        """Phase 19's launches of one kernel in each rank's process: (a)
        per round, (b) kernel 3 per round, (d) over each generation's
        warm-up and timed runs, by edge bits."""
        out = {"rebalance": {rnd: {f"rank{r}": c[name] for r, c in
                                   per_rank.items()}
                             for rnd, per_rank in
                             control_launches["rebalance"].items()}}
        if name == "fused_attention":
            out["autoscale"] = {rnd: {f"rank{r}": v for r, v in
                                      per_rank.items()}
                                for rnd, per_rank in control_launches[
                                    "autoscale_attention"].items()}
        out["dcn_generate"] = {f"bits{bits}": {f"rank{r}": c[name] for r, c
                                                in per_rank.items()}
                               for bits, per_rank in
                               control_launches["generate"].items()}
        return out

    def fault_launches(name):
        """Phase 18's launches of one kernel in each rank's process (its
        exit line; the killed rank has none), replays included."""
        return {case: {f"rank{r}": (c or {}).get(name)
                       for r, c in per_rank.items()}
                for case, per_rank in chaos_launches.items()}

    def disagg_launches_of(name):
        """Phase 20's launches of one codec kernel: the in-process `wire`
        server at 8 bits, the process mode's workers (kernel 1) or server
        (kernel 2) from their exit lines, the same in the chaos case, and
        the kernel at the ship's shape."""
        side = "workers" if name == "fused_encode" else "server"
        codec = disagg_launches["ship_codec"]
        op = name[6:]
        return {"wire8_in_process": disagg_launches["wire8_in_process"][name],
                "process": disagg_launches[f"process_{side}"],
                "chaos": disagg_launches[f"chaos_{side}"],
                "ship_shape": codec["shape"],
                "ship_ms": codec[f"{op}_ms"],
                "ship_plain_ms": codec[f"plain_{op}_ms"],
                "ship_bound_ms": codec["bound_ms"]}

    def tp_codec(name, bit):
        """Phase 21: the codec kernel at the quantized all-reduce's chunk
        shapes, and its launches there (a's in-process qpsum per shard
        count, b's fleet at --tp-quant-bits 8 per rank)."""
        op = name[6:]
        keys = ("shape", f"{op}_ms", f"plain_{op}_ms", "bound_ms",
                "bound_by") + (("cluster", "edge_cluster_encode_ms")
                               if op == "encode" else ())
        return dict(
            tp_ring={r["case"]: {k: r[k] for k in keys}
                     for r in tp_res["ring"] if r["bit"] == bit},
            tp_launches={
                "qpsum": {f"n{r['n']}": r["counts"][name]
                          for r in tp_res["qpsum"] if r["bit"] == bit},
                **({"stage_tp_fleet": {
                    f"rank{r}": c[name]
                    for r, c in tp_dcn_launches["bits8"].items()}}
                   if bit == 8 else {})})

    def tp_ep_codec(name):
        """Phase 22b: the codec kernel at the tp x ep grid's ring chunks,
        and its launches in the grid's 3 passes at 8 quantized bits."""
        op = name[6:]
        keys = ("shape", f"{op}_ms", f"plain_{op}_ms", "bound_ms",
                "bound_by")
        return dict(
            ring={r["case"]: {k: r[k] for k in keys}
                  for r in ep_gen_res["codec"]},
            launches=ep_gen_launches["quant8"][name],
            expected_launches=ep_gen_res["quant8"]["expected_counts"][name])

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
                dcn_launches=dcn_launches(name),
                **({"fault_plane_launches": fault_launches(name),
                    "control_launches": control_launches_of(name),
                    # phase 20: the driven KV ship at 8 bits (kernel 1 on
                    # the prefill side, kernel 2 on the decode side)
                    "disagg_launches": disagg_launches_of(name)}
                   if bit == 8 else {}),
                **tp_codec(name, bit),
                **({"tp_ep": tp_ep_codec(name),
                    "spmd_launches": spmd_launches_of(name),
                    "multihost_launches": multihost_launches_of(name),
                    # phase 24(c): the wave entry's warm-up and timed
                    # prefill waves, and one in-process prefill wave
                    "wave_launches": wave_launches[name]}
                   if bit == 8 else {}),
                # every policy bitwidth on phase 8's edge
                policy_bits_ms={r["bit"]: r[f"{name[6:]}_ms"]
                                for r in policy_rows
                                if r["shape"] == [UBATCH, 198, 768]},
                # phase 14: the Llama-3-8B edge and its pass of 4
                # microbatches; the MoE GPT-2's edge at 8 bits
                llama_edge={k: codec_rows[(name, bit, (8, 128, 4096))][k]
                            for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "max_abs_err")},
                llama3_launches=fam["llama3_forward"][bit]["counts"][name],
                # phase 24: the wave decoder's prompt, prefix and span hops
                wave_edges={"x".join(map(str, shape)): {
                    k: codec_rows[(name, bit, shape)][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "max_abs_err")} for shape in WAVE_EDGES},
                **({"moe_launches": fam["moe_forward"][8]["counts"][name],
                    # phase 15: a direct check of the codec on KV shapes,
                    # 8-bit ship frames of the router's survivor (one per
                    # leaf and stage; no entry ships quantized KV, so these
                    # are not a path's launches), and the traced ViT-Base
                    # entry (2 rounds of 8 microbatches)
                    "kv_ship_codec_check": {
                        "launches": adopt_res["ship_counts"][name]} | {
                        k: adopt_res["ship_codec"][k] for k in (
                            "shape", f"{name[6:]}_ms", f"plain_{name[6:]}_ms",
                            "bound_ms", "bound_by")},
                    "traced_entry_launches": trace_res["traced"][
                        "kernel_launches"][name]}
                   if bit == 8 else {})))
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
        dcn_launches=dcn_launches("fused_attention"),
        fault_plane_launches=fault_launches("fused_attention"),
        control_launches=control_launches_of("fused_attention"),
        bert_launches=bert_res["fixed"][8]["counts"]["fused_attention"],
        # phase 10: the scheduled ViT-Large entry (all rounds), and the
        # profiler's runs of ViT-Base and ViT-Large
        vitl_scheduled_launches=sched_res["entry"]["kernel_launches"][
            "fused_attention"],
        profiler_launches={key: p["attention_launches"]
                           for key, p in sched_res["profiles"].items()},
        # phase 14: per pass of 4 microbatches (Llama-3-8B, the MoE
        # GPT-2), and per forward of the decode checks
        llama3_forward_launches=fam["llama3_forward"][8]["counts"][
            "fused_attention"],
        moe_forward_launches=fam["moe_forward"][8]["counts"][
            "fused_attention"],
        decode_check_forward_launches={
            name: fam[key]["fp"]["full_forward_launches"] for name, key in (
                (LLAMA3, "llama3_decode"), (LLAMA2, "llama2_decode"),
                (MISTRAL, "mistral_decode"))},
        mistral_window_launches=fam["mistral_decode"]["window"]["launches"],
        # phase 15: the reverse auction's ViT-Large runs (one round of 8
        # microbatches per schedule) and the traced ViT-Base entry
        revauct_launches={run["scheduler"]: run["entry"]["kernel_launches"][
            "fused_attention"] for run in revauct_res["runs"]},
        traced_entry_launches=trace_res["traced"]["kernel_launches"][
            "fused_attention"],
        # phase 21: a shard's heads, the TP blocks' launches (2 and 4
        # shards) and each rank's of the --stage-tp fleets
        tp_shard=tp_res["attention"],
        tp_launches={"blocks": {f"n{r['n']}": r["counts"]["fused_attention"]
                                for r in tp_res["blocks"]},
                     "stage_tp_fleets": {
                         key: {f"rank{r}": c["fused_attention"]
                               for r, c in per_rank.items()}
                         for key, per_rank in tp_dcn_launches.items()}},
        # phase 22: a Ulysses shard's head group (kernel 3's function on
        # the card), its launches in 22a's core (2 shards) and per 22c
        # prefill (4 blocks x 2 shards), none under a window
        ulysses_head_group=ep_sp_res["ulysses_kernel"],
        ulysses_launches={
            "core_sp2": next(r["kernel3_launches"] for r in ep_sp_res["sp"]
                             if r["kind"] == "ulysses"),
            "llama3_prefill_sp2": sp_launches["ulysses"],
            "windowed_core": ep_sp_res["window"]["kernel3_launches"]},
        # phase 23: each SPMD run (tp shards and Ulysses head groups per
        # dp cell; none from the ring core)
        spmd_launches=spmd_launches_of("fused_attention"),
        # phase 25: 5 training steps of each run (twice under remat)
        train_launches={key: c["fused_attention"]
                        for key, c in train_counts.items()},
        # phase 26: each rank's, per leg
        multihost_launches=multihost_launches_of("fused_attention"),
        cases={f"{r['layout']} {r['shape']} {r['dtype']}"
               f"{' causal' if r['causal'] else ''}": {
                   key: r[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "max_abs_err")}
               for r in attn_rows}))
    # kernel 3's backward: the main path is phase 25(b)'s GPT-2 run
    # (bf16, causal, microbatches [2, 1023, 12, 64]); its row is the
    # phase-3 case at [2, 1024, 12, 64] bf16
    bwd = next(r for r in attn_bwd_rows if r["shape"] == [2, 1024, 12, 64]
               and r["dtype"] == "bfloat16")
    kernels.append(dict(
        name="fused_attention_bwd", route="cuda",
        source="pipeedge_tpu_torch/csrc/attention_bwd.cu",
        replaces=REPLACES["fused_attention"], gradient_of="fused_attention",
        launches=train_counts["gpt2"]["fused_attention_bwd"],
        max_abs_err=bwd["max_abs_err"], ms=bwd["ms"],
        plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
        bound_by=bwd["bound_by"], library_ms=bwd["library_ms"],
        shape=bwd["shape"], dtype=bwd["dtype"], causal=True,
        train_launches={key: c["fused_attention_bwd"]
                        for key, c in train_counts.items()},
        multihost_launches=multihost_launches_of("fused_attention_bwd"),
        cases={f"{r['shape']} {r['dtype']}"
               f"{' causal' if r['causal'] else ''}": {
                   key: r[key] for key in (
                       "ms", "plain_ms", "library_ms", "bound_ms",
                       "bound_by", "max_abs_err", "rel_errs",
                       "lse_max_abs_err")}
               for r in attn_bwd_rows}))
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
        # phase 14: the MoE GPT-2's int8 generation and served run; none
        # on the Llama family's int8 steps
        moe_generate_launches=fam["moe_decode"]["int8"]["counts"][
            "decode_attention"],
        moe_serve_launches=fam["moe_serve"]["runs"][0]["counts"][
            "decode_attention"],
        llama_int8_launches={name: fam[key]["int8"]["counts"][
            "decode_attention"] for name, key in (
                (LLAMA3, "llama3_decode"), (LLAMA2, "llama2_decode"))},
        # phase 15: generate --concurrent (warm-up and timed batches), the
        # launches per request of the router's adopted fp fleet
        concurrent_launches=gen_res["concurrent"]["counts"][
            "decode_attention"],
        concurrent_launches_per_wave=gen_res["concurrent"][
            "launches_per_wave"],
        routed_fp_launches_per_request=adopt_res["per_request"][
            "decode_attention"],
        # phase 17: the replica the autoscaler spawned and retired (its
        # own process, read from its exit line), and the solo runs its
        # answers were held to in this process
        autoscaled_replica_launches=auto_res["r1_launches"][
            "decode_attention"],
        autoscale_solo_launches=auto_res["solo_launches"],
        # phase 21c: a shard's 6 heads, and the generate entry's int8
        # runs at --tp 1 and 2 (warm-up included)
        tp_shard=tp_res["decode_attention"],
        tp_generate_launches=tp_gen_launches["kv8"],
        # phase 22b: an ep shard's whole-window step, and `generate --ep 2
        # --kv-bits 8` (warm-up included: 12 blocks x 2 shards a step)
        ep_shard=ep_gen_res["decode_attention"],
        ep_generate_launches=ep_gen_launches["ep2_kv8"]["decode_attention"],
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
