"""Autoregressive KV-cache decoding through the pipeline (the decoders).

Port of `pipeedge_tpu/parallel/decode.py`: the single-device path and
its tensor-, expert- and sequence-parallel variants. The block step, the
single-token and the span
embeddings come from the family (`FamilySpec` hooks: the Llama family
supplies its own), with the GPT-2-shaped ones of this module as the
defaults; the switch-MoE GPT-2's block tail routes through
`parallel/expert.py`.

- **Static caches, written in place**: each stage holds one [n_blocks, B,
  max_len, H, Dh] K and V buffer (plus per-(position, head) scale/shift
  rows for an int8 cache). JAX threads new caches out of every step; here
  a block's step writes its rows into views of those buffers, so nothing
  is copied and the returned cache is the one passed in. `_repeat_batch`
  and `_gather_batch` therefore make new tensors, so a prefix handle or a
  parent beam is never written through an alias.
- **Block-aligned stages**: each stage consumes the previous stage's
  hidden state for the current token and returns its own; the last stage
  returns vocab logits. Autoregression serializes the steps, so the batch
  is the throughput axis.
- **Bucketed attend windows**: a decode step attends cache rows
  [0, read_len), read_len the least power of two >= the live length
  (>= the attend floor), which JAX needed as a static shape; eager
  PyTorch keeps it, so both packages attend the same windows. A prefill
  attends its own S prompt rows (the JAX package attends the whole cache
  with the rows past S masked, the same function): so a prefill on a
  paged view (`kv/`) is the same computation as on a dense cache.
- **The int8 decode-attend route** (`_use_int8_decode_kernel`): with an
  int8 cache, a single-token MHA step of the default (GPT-2-shaped)
  block step may attend through kernel 5 (`ops/decode_attention.py`),
  which dequantizes in registers, in place of the dequantize-then-attend
  route. The choice is resolved once, when the pipeline is built
  (`_resolve_int8_optin`), and is off by default. A family's own block
  step (Llama) never asks the gate, as in the JAX package.

- **Tensor parallelism** (`DecodePipeline(mesh=ShardGroup)`,
  `make_tp_stage_fns`): each stage's blocks run the Megatron body of
  `parallel/tensor.py` over the group with the attention core swapped for
  a cache-attend over a head-sharded cache: shard i holds heads
  [i*H/n, (i+1)*H/n) of every K/V buffer and, for an int8 cache, of the
  per-head scale/shift rows, so each shard quantizes and attends its own
  heads (kernel 5 per shard on the route chosen at construction). A
  stage's cache is then the list of its shards' caches. The embedding
  runs on shard 0, and the LM head is vocab-split when the group size
  divides the vocabulary (`_tp_shards_head`), else it runs on shard 0.

Eager functions replace the jitted stage programs; `read_len` stays an
explicit argument. Greedy decoding and beam search match the JAX
`DecodePipeline` token for token on the same weights; sampling draws
from a `torch.Generator` and cannot match `jax.random` (ROADMAP §C).
"""
from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..models import ShardConfig, plan_shard
from ..models.layers import TransformerConfig, dense, gelu_new, layer_norm
from ..models.shard import params_to
from ..ops import decode_attention
from .expert import ep_ffn_delta, moe_ffn_delta

Cache = Dict[str, torch.Tensor]   # {'k': [L, B, T, H, Dh], 'v': ...}
# int8 variant adds per-(block, batch, position, head) scale/shift rows:
#   {'k': int8, 'v': int8, 'k_scale'/'k_shift'/'v_scale'/'v_shift': [L, B, T, H]}

def init_cache(cfg: TransformerConfig, n_blocks: int, batch: int,
               max_len: int, dtype=torch.float32, cache_bits: int = 0,
               *, device: DeviceLike, kv_heads: Optional[int] = None
               ) -> Cache:
    """Zeroed stacked KV cache for `n_blocks` blocks on `device` (a
    required keyword: a cache the caller did not place would land on the
    host unnoticed).

    `cache_bits=8` stores K/V as int8 with per-(position, head) affine
    scales: cache reads dominate a decode step's memory traffic, so int8
    halves it against bfloat16. The head axis is `cfg.kv_heads`, or
    `kv_heads` (a tensor-parallel shard's slice of them)."""
    shape = (n_blocks, batch, max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    if cache_bits == 0:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cache_bits != 8:
        raise ValueError(f"cache_bits must be 0 (off) or 8, got {cache_bits}")
    rows = shape[:4]                       # [..., T, H] per-head scales
    cache = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device)}
    for t in ("k", "v"):
        cache[f"{t}_scale"] = torch.zeros(rows, dtype=torch.float32,
                                          device=device)
        cache[f"{t}_shift"] = torch.zeros(rows, dtype=torch.float32,
                                          device=device)
    return cache


def _quantize_rows(x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Affine-quantize [B, S, H, Dh] to int8 per (batch, position, head),
    rounding half to even. The range is divided by a device tensor 255:
    PyTorch on CUDA turns `tensor / python_float` into a multiply by the
    reciprocal, which would move codes against the CPU's."""
    lo = x.amin(dim=3).float()                               # [B, S, H]
    hi = x.amax(dim=3).float()
    scale = torch.clamp_min(hi - lo, 1e-8) / torch.full(
        (), 255.0, dtype=torch.float32, device=x.device)
    q = torch.round((x.float() - lo[..., None]) / scale[..., None]) - 128.0
    return q.to(torch.int8), scale, lo


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, dtype) -> torch.Tensor:
    """Invert `_quantize_rows`: [B, T, H, Dh] int8 + [B, T, H] -> dtype."""
    return ((q.float() + 128.0) * scale[..., None]
            + shift[..., None]).to(dtype)


def _qkv(p: Dict, normed: torch.Tensor, cfg: TransformerConfig):
    b, s, _ = normed.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim
    return (dense(p["q"], normed).reshape(b, s, h, hd),
            dense(p["k"], normed).reshape(b, s, h, hd),
            dense(p["v"], normed).reshape(b, s, h, hd))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """Masked attention of q [B,S,H,Dh] over k/v [B,T,H,Dh]; `keep`
    [S, T] marks key positions each query may attend to. Scores and the
    softmax in f32; probabilities rounded to q's dtype before the V
    product, as the JAX package does."""
    b, s, h, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                       v.float()).to(q.dtype)
    return ctx.reshape(b, s, h * hd)


def _attend_width(bcache: Cache, read_len: Optional[int]) -> int:
    """The attend window's width: the full cache, cut to `read_len` when
    one is bound. Shared by both routes, so they attend one window."""
    t_max = bcache["k"].shape[1]
    return t_max if read_len is None else min(read_len, t_max)


def _cache_write_quantized(bcache: Cache, k_new: torch.Tensor,
                           v_new: torch.Tensor, start: int) -> None:
    """Quantize the new K/V rows and write them, with their per-(position,
    head) scale/shift rows, at `start`, in place: the one int8 write path
    of both attend routes."""
    s = k_new.shape[1]
    for t, new in (("k", k_new), ("v", v_new)):
        qv, scale, shift = _quantize_rows(new)
        bcache[t][:, start:start + s] = qv
        bcache[f"{t}_scale"][:, start:start + s] = scale
        bcache[f"{t}_shift"][:, start:start + s] = shift


def _int8_kernel_env() -> int:
    """Resolve PIPEEDGE_INT8_DECODE_ATTEND: empty/0/false/no/off are off
    (0), 'auto' is 3, '2' is 2, any other value 1. As in the JAX package;
    what 1, 2 and 3 route is `_use_int8_decode_kernel`'s."""
    env = (os.getenv("PIPEEDGE_INT8_DECODE_ATTEND") or "").strip().lower()
    if not env or env in ("0", "false", "no", "off"):
        return 0
    if env == "auto":
        return 3
    return 2 if env == "2" else 1


def _resolve_int8_optin(override=None) -> int:
    """The int8 decode-attend opt-in, resolved once when a pipeline is
    built: an explicit `override` (constructor arg `int8_decode_attend`)
    wins, then PIPEEDGE_INT8_DECODE_ATTEND (an explicit '0' included),
    then the int8 compute config: `quantize_compute().enabled` promotes
    the route to 'auto' (3). Idempotent on resolved ints."""
    if override is not None:
        if isinstance(override, str):
            s = override.strip().lower()
            if s == "auto":
                return 3
            if not s or s in ("0", "false", "no", "off"):
                return 0
            return 2 if s == "2" else 1
        return int(override)
    if os.getenv("PIPEEDGE_INT8_DECODE_ATTEND") is not None:
        return _int8_kernel_env()
    from ..models.layers import quantize_compute
    if quantize_compute().enabled:
        return 3
    return 0


def _use_int8_decode_kernel(bcache: Cache, s: int, cfg: TransformerConfig,
                            optin: int) -> Optional[int]:
    """The kernel variant (1 or 2) for an int8 single-token MHA decode
    step when the opt-in is set, else None (dequantize-then-attend).

    The semantic refusals: span steps (s != 1), fp caches, GQA and
    sliding windows stay on the dequantize route. The JAX gate's width and
    VMEM caps were TPU limits; the kernel stages no window, so any width
    routes. Off the CPU (where the plain version takes every window), a
    cache the kernel would refuse (`decode_attention.window_refusal`: head
    dim, alignment, head count) stays on the dequantize route too; the gate
    runs before the step writes its row, so a routed step never raises
    halfway. 'auto' (3) routes every eligible step to the kernel (variant
    2, as the JAX package's 'auto' does) until the card's own crossover
    against the dequantize route is set from measurements."""
    if not optin:
        return None
    if s != 1 or "k_scale" not in bcache:
        return None
    if cfg.kv_heads != cfg.num_attention_heads or cfg.sliding_window:
        return None
    if bcache["k"].device.type != "cpu" and decode_attention.window_refusal(
            bcache["k"], bcache["v"]) is not None:
        return None
    return 1 if int(optin) == 1 else 2


def _cache_update_and_read(bcache: Cache, k_new: torch.Tensor,
                           v_new: torch.Tensor, pos: int, prefill: bool,
                           dtype, read_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Write the new K/V rows at [pos, pos+S) and return (k, v, keep) for
    attention over the window [0, width).

    The caller guarantees pos + S <= read_len; rows past the live ones are
    masked either way, so cutting the window to `read_len` changes no
    result. For an int8 cache the window is dequantized and the fresh rows
    attended unquantized."""
    width = _attend_width(bcache, read_len)
    start, s = (0 if prefill else pos), k_new.shape[1]
    if "k_scale" in bcache:
        _cache_write_quantized(bcache, k_new, v_new, start)
        k = _dequantize_rows(bcache["k"][:, :width],
                             bcache["k_scale"][:, :width],
                             bcache["k_shift"][:, :width], dtype)
        v = _dequantize_rows(bcache["v"][:, :width],
                             bcache["v_scale"][:, :width],
                             bcache["v_shift"][:, :width], dtype)
        k[:, start:start + s] = k_new.to(dtype)
        v[:, start:start + s] = v_new.to(dtype)
    else:
        for t, new in (("k", k_new), ("v", v_new)):
            bcache[t][:, start:start + s] = new.to(bcache[t].dtype)
        k = bcache["k"][:, :width].to(dtype)
        v = bcache["v"][:, :width].to(dtype)
    # query i sits at start + i (prefill: start = 0) and attends [0, start+i]
    q_pos = start + torch.arange(s, device=k_new.device)[:, None]
    k_pos = torch.arange(width, device=k_new.device)[None, :]
    return k, v, k_pos <= q_pos


def _attn_out(p: Dict, x: torch.Tensor, ctx: torch.Tensor,
              cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output projection + residual, and the FFN's LayerNorm of it."""
    x = dense(p["attn_out"], ctx) + x
    return x, layer_norm(p["ln_after"], x, cfg.layer_norm_eps)


def _block_tail(p: Dict, x: torch.Tensor, ctx: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Post-attention half of a GPT-2 block: output projection + residual,
    FFN + residual (the routed switch-FFN for an MoE config)."""
    x, normed = _attn_out(p, x, ctx, cfg)
    if cfg.n_experts:
        # capacity routing is not causal: a step routes only its own
        # tokens, so a capacity-bounded model's cached step is not the
        # full forward's computation (capacity_factor >= n_experts is)
        return x + moe_ffn_delta(p["moe"], normed, cfg.n_experts,
                                 cfg.capacity_factor, act=gelu_new)
    return dense(p["mlp_down"], gelu_new(dense(p["mlp_up"], normed))) + x


def _attention_core(p: Dict, x: torch.Tensor, bcache: Cache, pos: int,
                    cfg: TransformerConfig, prefill: bool,
                    read_len: Optional[int] = None,
                    int8_optin: int = 0) -> torch.Tensor:
    """ln + qkv + cache update + masked attend. `int8_optin` is the
    construction-time resolution (`_resolve_int8_optin`)."""
    normed = layer_norm(p["ln_before"], x, cfg.layer_norm_eps)
    q, k_new, v_new = _qkv(p, normed, cfg)
    return _cache_attend(bcache, q, k_new, v_new, pos, cfg, prefill,
                         read_len=read_len, int8_optin=int8_optin)


def _cache_attend(bcache: Cache, q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, pos: int, cfg: TransformerConfig,
                  prefill: bool, read_len: Optional[int] = None,
                  int8_optin: int = 0) -> torch.Tensor:
    """Write the new K/V rows into `bcache` and attend the window: through
    kernel 5 on an int8 single-token step the opt-in routes, else the
    dequantize-then-attend route. -> [B, S, H * Dh] over q's heads (all of
    them, or a tensor-parallel shard's)."""
    variant = (None if prefill
               else _use_int8_decode_kernel(bcache, q.shape[1], cfg,
                                            int8_optin))
    if variant is not None:
        w = _attend_width(bcache, read_len)
        _cache_write_quantized(bcache, k_new, v_new, pos)
        return decode_attention.int8_decode_attention(
            q, bcache["k"][:, :w], bcache["k_scale"][:, :w],
            bcache["k_shift"][:, :w], bcache["v"][:, :w],
            bcache["v_scale"][:, :w], bcache["v_shift"][:, :w],
            k_new, v_new, pos, variant=variant)
    k, v, keep = _cache_update_and_read(bcache, k_new, v_new, pos, prefill,
                                        q.dtype, read_len=read_len)
    return _attend(q, k, v, keep)


def _block_step(p: Dict, x: torch.Tensor, bcache: Cache, pos: int,
                cfg: TransformerConfig, prefill: bool,
                read_len: Optional[int] = None,
                int8_optin: int = 0) -> torch.Tensor:
    """One GPT-2 block over the current token(s), reading and updating
    its cache slice `bcache` in place. Prefill: x is the prompt [B, S, D]
    written at [0, S); decode: x is [B, S, D] written at [pos, pos+S)
    (S = 1 for a plain step, K for a span)."""
    ctx = _attention_core(p, x, bcache, pos, cfg, prefill,
                          read_len=read_len, int8_optin=int8_optin)
    return _block_tail(p, x, ctx, cfg)


def single_token_embed(pe: Dict, tok: torch.Tensor, pos: int
                       ) -> torch.Tensor:
    """Embed one decode-step token [B] (or [B, 1]) at position `pos` ->
    [B, 1, D]: its wte row + the wpe row of `pos`."""
    return pe["wte"][tok.reshape(-1).long()][:, None] \
        + pe["wpe"][pos:pos + 1][None]


def span_embed(pe: Dict, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """Embed a K-token span [B, K] at positions [pos, pos+K) -> [B, K, D]."""
    return pe["wte"][tok.long()] + pe["wpe"][pos:pos + tok.shape[1]][None]


def stage_blocks(params: Dict) -> List[Dict]:
    """The per-block parameter dicts of a decode stage (block-aligned)."""
    blocks = params.get("blocks")
    if blocks is None:
        raise ValueError("decode stages must contain full blocks "
                         "(block-aligned partition)")
    return list(blocks)


def attend_bucket(pos_next: int, max_len: int, floor: int = 64) -> int:
    """Attend-window size for a decode step with `pos_next` valid cache
    rows: the least power of two >= pos_next (>= floor), capped at
    max_len."""
    if pos_next > max_len:
        raise ValueError(f"pos_next {pos_next} exceeds max_len {max_len}")
    b = max(1, floor)
    while b < pos_next:
        b *= 2
    return min(b, max_len)


def make_stage_fns(family, cfg: TransformerConfig, shard_config: ShardConfig,
                   int8_optin=None):
    """(prefill_fn, decode_fn) for one block-aligned pipeline stage.

    prefill_fn(params, data, cache)                  -> (out, cache)
    decode_fn(params, data, cache, pos, read_len=None) -> (out, cache)

    data: token ids on the first stage, the previous stage's hidden state
    otherwise. The first stage embeds (decode positions offset by `pos`);
    the last applies the final LN + LM head and returns per-token logits.
    The cache is updated in place and returned. `int8_optin` is the
    resolved int8 decode-attend routing (None re-resolves)."""
    run = _make_stage_run(family, cfg, shard_config, int8_optin=int8_optin)
    prefill_fn = functools.partial(run, pos=0, prefill=True)
    decode_fn = functools.partial(run, prefill=False)
    return prefill_fn, decode_fn


def _make_stage_run(family, cfg: TransformerConfig,
                    shard_config: ShardConfig, int8_optin=None):
    _check_block_aligned(shard_config)
    # the family's cached block (llama: RoPE/GQA/SwiGLU), else the
    # GPT-2-shaped step with the int8-kernel opt-in resolved here, once
    block_fn = family.cached_block_step or functools.partial(
        _block_step, int8_optin=_resolve_int8_optin(int8_optin))
    tok_embed = family.decode_embed or single_token_embed
    tok_span_embed = family.span_embed or span_embed

    @torch.inference_mode()
    def run(params, data, cache, pos, prefill, read_len=None):
        if prefill and read_len is None:
            # the prompt's own rows: any width past them is masked
            read_len = data.shape[1]
        if shard_config.is_first:
            if prefill:
                data = family.embed(params["embeddings"], data, cfg)
            elif data.dim() == 2 and data.shape[1] > 1:
                data = tok_span_embed(params["embeddings"], data, pos)
            else:
                data = tok_embed(params["embeddings"], data, pos)
        for i, bp in enumerate(stage_blocks(params)):
            data = block_fn(bp, data, {k: c[i] for k, c in cache.items()},
                            pos, cfg, prefill, read_len=read_len)
        if shard_config.is_last:
            data = family.finalize(params["final"], data, cfg)
        return data, cache

    return run


def _cache_attender(bcaches: Sequence[Cache], pos: int,
                    cfg: TransformerConfig, prefill: bool,
                    read_len: Optional[int], int8_optin: int):
    """`qkv_to_ctx(i, q, k, v)` of the tp bodies: shard i's cache-attend
    over its head slice `bcaches[i]` (kernel 5 where the int8 route is
    opted in)."""
    def cache_attend(i, q, k_new, v_new):
        return _cache_attend(bcaches[i], q, k_new, v_new, pos, cfg, prefill,
                             read_len=read_len, int8_optin=int8_optin)
    return cache_attend


def _block_step_tp(group, ps: Sequence[Dict], xs: Sequence[torch.Tensor],
                   bcaches: Sequence[Cache], pos: int,
                   cfg: TransformerConfig, prefill: bool, act=gelu_new,
                   read_len: Optional[int] = None,
                   int8_optin: int = 0) -> List[torch.Tensor]:
    """The Megatron tensor-parallel block step: the projection/all-reduce/
    MLP body of `parallel/tensor.py` with each shard's attention core
    swapped for a cache-attend over its head slice `bcaches[i]`."""
    from .tensor import _tp_block_local
    return _tp_block_local(group, ps, xs, cfg, act=act, causal=True,
                           qkv_to_ctx=_cache_attender(
                               bcaches, pos, cfg, prefill, read_len,
                               int8_optin))


def _tp_shards_head(cfg: TransformerConfig, n: int) -> bool:
    """Vocab-split the LM head when the tp degree divides the vocabulary:
    at decode the head matmul is a third of GPT-2's per-token FLOPs. A
    non-divisible combination (gpt2's 50257 at tp 2/4/8) keeps the head
    whole, on shard 0."""
    return cfg.vocab_size > 0 and n > 1 and cfg.vocab_size % n == 0


def tp_param_specs(params: Dict, cfg: TransformerConfig, n: int) -> Dict:
    """The split rules of one decode stage's params under Megatron TP of
    degree `n` (`parallel/tensor.py`: the axis that splits, None for a
    whole leaf): blocks per the family table, the embeddings whole, the
    LM head vocab-split when `_tp_shards_head`."""
    from .tensor import family_tp_plan

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else None
                for k, v in tree.items()}

    table, _ = family_tp_plan(cfg)
    specs = {k: whole(v) for k, v in params.items() if k != "blocks"}
    specs["blocks"] = table
    if "final" in params and "head" in params["final"] \
            and _tp_shards_head(cfg, n):
        specs["final"]["head"] = {"w": 1, "b": 0}
    return specs


def shard_stage_params(params: Dict, cfg: TransformerConfig,
                       group) -> Dict:
    """One decode stage's params over `group` by `tp_param_specs`: the
    embeddings on shard 0 (the embedding runs there), each block as a
    per-shard list, the final params as a per-shard list when the head is
    vocab-split, else on shard 0."""
    from .tensor import split_leaf

    n = group.size
    specs = tp_param_specs(params, cfg, n)

    def take(p, s, i):
        if isinstance(p, dict):
            return {k: take(v, s[k], i) for k, v in p.items()}
        return split_leaf(p, s, n, i, group.devices[i])

    out = {}
    if "embeddings" in params:
        out["embeddings"] = params_to(params["embeddings"],
                                      device=group.devices[0])
    out["blocks"] = [[take(bp, specs["blocks"], i) for i in range(n)]
                     for bp in stage_blocks(params)]
    if "final" in params:
        out["final"] = ([take(params["final"], specs["final"], i)
                         for i in range(n)] if _tp_shards_head(cfg, n)
                        else params_to(params["final"],
                                       device=group.devices[0]))
    return out


def tp_vocab_head_finalize(group, pfs: Sequence[Dict],
                           xs: Sequence[torch.Tensor],
                           cfg: TransformerConfig, norm_fn) -> torch.Tensor:
    """The vocab-split LM head, shared by the tp decode stages: `norm_fn`
    (layer_norm for GPT-2, rms_norm for Llama) on each shard, the head
    matmul giving each shard's logit slice, and one gather in shard order
    restoring the full [B, S, V] on shard 0."""
    def local(i, pf, x):
        return dense(pf["head"], norm_fn(pf["ln"], x, cfg.layer_norm_eps))

    return group.gather(group.map(local, pfs, xs), dim=-1)


def init_tp_cache(cfg: TransformerConfig, n_blocks: int, batch: int,
                  max_len: int, group, dtype=torch.float32,
                  cache_bits: int = 0, tp: Optional[int] = None
                  ) -> List[Cache]:
    """A stage cache split over `group` (JAX `tp_cache_specs`): shard i's
    leaves on its device hold heads [i*kv/n, (i+1)*kv/n) of the K/V
    buffers [L, B, T, H, Dh] and of the per-head scale/shift rows
    [L, B, T, H], so each shard quantizes and dequantizes its own heads.
    On a `ShardGrid` pass `tp`: cell (i, j) holds tp slice i (the cache
    is split over tp and replicated over ep)."""
    n = tp or group.size
    local = cfg.kv_heads // n
    return [init_cache(cfg, n_blocks, batch, max_len, dtype, cache_bits,
                       device=d, kv_heads=local) for d in group.devices]


def _check_block_aligned(shard_config: ShardConfig) -> None:
    plan = plan_shard(shard_config)
    if plan.head is not None or plan.tail is not None:
        raise ValueError("decode requires a block-aligned partition "
                         f"(layers [{shard_config.layer_start}, "
                         f"{shard_config.layer_end}] cut mid-block)")


def _make_sharded_run(family, cfg: TransformerConfig,
                      shard_config: ShardConfig, cells, block_fn, fin=None):
    """(prefill_fn, decode_fn) of a stage whose blocks run over `cells` (a
    shard group or grid): the embedding runs on the first cell, its output
    is replicated to every cell, each block is `block_fn(cells, ps, xs,
    caches, pos, cfg, prefill, read_len=)` over the per-cell params and
    caches, and the head runs on the first cell (`fin` over every cell
    when the head is split). `data` and the output live on the first
    cell's device."""
    _check_block_aligned(shard_config)
    tok_embed = family.decode_embed or single_token_embed
    tok_span_embed = family.span_embed or span_embed

    @torch.inference_mode()
    def run(params, data, cache, pos, prefill, read_len=None):
        if prefill and read_len is None:
            read_len = data.shape[1]
        if shard_config.is_first:
            if prefill:
                data = family.embed(params["embeddings"], data, cfg)
            elif data.dim() == 2 and data.shape[1] > 1:
                data = tok_span_embed(params["embeddings"], data, pos)
            else:
                data = tok_embed(params["embeddings"], data, pos)
        xs = cells.replicate(data)
        for b, bps in enumerate(params["blocks"]):
            bcaches = [{k: c[b] for k, c in shard.items()} for shard in cache]
            xs = block_fn(cells, bps, xs, bcaches, pos, cfg, prefill,
                          read_len=read_len)
        if not shard_config.is_last:
            return xs[0], cache
        if fin is not None:
            return fin(cells, params["final"], xs, cfg), cache
        return family.finalize(params["final"], xs[0], cfg), cache

    prefill_fn = functools.partial(run, pos=0, prefill=True)
    decode_fn = functools.partial(run, prefill=False)
    return prefill_fn, decode_fn


def make_tp_stage_fns(family, cfg: TransformerConfig,
                      shard_config: ShardConfig, group, int8_optin=None):
    """The tensor-parallel `make_stage_fns`: the stage's blocks run over
    `group` with the head-sharded cache and the two-all-reduce Megatron
    body. `params` come from `shard_stage_params`, the cache from
    `init_tp_cache` (a per-shard list); `data` and the output live on
    shard 0's device."""
    n = group.size
    if cfg.num_attention_heads % n or cfg.kv_heads % n:
        raise ValueError(f"tp={n} requires head count "
                         f"({cfg.num_attention_heads}) and kv head count "
                         f"({cfg.kv_heads}) divisible by tp")
    if cfg.n_experts:
        raise NotImplementedError(
            "tensor-parallel decode does not cover MoE blocks (experts "
            "shard over 'ep', not 'tp') — use make_tp_ep_stage_fns / "
            "DecodePipeline(tp_ep_mesh=...) for the tp x ep composition")
    if family.tp_cached_block_step is None \
            and family.cached_block_step is not None:
        raise NotImplementedError(
            f"tensor-parallel decode pairs the default (GPT-2-shaped) "
            f"cached step with the Megatron body; the {family.name} "
            "family supplies a custom cached block step but no tp variant "
            "(forward TP — make_tp_block_fn / --spmd-tp — does cover it)")
    block_fn = family.tp_cached_block_step or functools.partial(
        _block_step_tp, int8_optin=_resolve_int8_optin(int8_optin))
    fin = None
    if _tp_shards_head(cfg, n):
        fin = family.tp_finalize or functools.partial(
            tp_vocab_head_finalize, norm_fn=layer_norm)
    return _make_sharded_run(family, cfg, shard_config, group, block_fn,
                             fin=fin)


def _block_step_ep(group, ps: Sequence[Dict], xs: Sequence[torch.Tensor],
                   bcaches: Sequence[Cache], pos: int,
                   cfg: TransformerConfig, prefill: bool,
                   read_len: Optional[int] = None,
                   int8_optin: int = 0) -> List[torch.Tensor]:
    """The expert-parallel MoE block step: each shard's cached attention
    over its own replica of the cache (`_attention_core`, kernel 5 on the
    opted-in int8 route) and output projection, then the routed FFN with
    the experts split over `group` (`ep_ffn_delta`)."""
    def attention(i, p, x, bc):
        ctx = _attention_core(p, x, bc, pos, cfg, prefill,
                              read_len=read_len, int8_optin=int8_optin)
        return _attn_out(p, x, ctx, cfg)

    hs, normed = zip(*group.map(attention, ps, xs, bcaches))
    deltas = ep_ffn_delta(group, [p["moe"] for p in ps], normed,
                          cfg.n_experts, cfg.capacity_factor, act=gelu_new)
    return group.map(lambda i, h, dl: h + dl, hs, deltas)


def _block_step_tp_ep(grid, ps: Sequence[Dict], xs: Sequence[torch.Tensor],
                      bcaches: Sequence[Cache], pos: int,
                      cfg: TransformerConfig, prefill: bool, act,
                      read_len: Optional[int] = None) -> List[torch.Tensor]:
    """The tp x ep MoE block step over a `ShardGrid` (per-cell lists in
    grid order): each ep column's Megatron attention half over its tp
    group and head slice of the cache, then each tp row's routed FFN with
    the experts split over its ep group. Routing sees the whole token set
    on every cell, so the capacity semantics are the single device's."""
    from .tensor import _tp_attention

    hs = [None] * grid.size
    for j in range(grid.ep):
        cells = [grid.cell(i, j) for i in range(grid.tp)]
        out = _tp_attention(
            grid.tp_group(j), [ps[c] for c in cells], [xs[c] for c in cells],
            cfg, causal=True, qkv_to_ctx=_cache_attender(
                [bcaches[c] for c in cells], pos, cfg, prefill, read_len,
                int8_optin=0))
        for c, h in zip(cells, out):
            hs[c] = h
    ys = [None] * grid.size
    for i in range(grid.tp):
        cells = [grid.cell(i, j) for j in range(grid.ep)]
        group = grid.ep_group(i)
        rps, rhs = [ps[c] for c in cells], [hs[c] for c in cells]
        normed = group.map(lambda k, p, h: layer_norm(
            p["ln_after"], h, cfg.layer_norm_eps), rps, rhs)
        deltas = ep_ffn_delta(group, [p["moe"] for p in rps], normed,
                              cfg.n_experts, cfg.capacity_factor, act=act)
        for c, h, dl in zip(cells, rhs, deltas):
            ys[c] = h + dl
    return ys


def make_ep_stage_fns(family, cfg: TransformerConfig,
                      shard_config: ShardConfig, group, axis: str = "ep",
                      int8_optin=None):
    """The expert-parallel `make_stage_fns` of an MoE stage: the routed
    FFN's experts split over `group` (its axis `axis`), attention and the
    cache replicated (experts hold an MoE decoder's parameter mass).
    `params` from `shard_moe_stage_params`, the cache one replica per
    shard; the int8 decode-attend route is the pipeline's resolved
    opt-in."""
    if not cfg.n_experts:
        raise ValueError("make_ep_stage_fns requires an MoE config "
                         "(cfg.n_experts > 0)")
    n = group.axis_size(axis)
    if cfg.n_experts % n:
        raise ValueError(f"ep={n} must divide n_experts ({cfg.n_experts})")
    return _make_sharded_run(
        family, cfg, shard_config, group, functools.partial(
            _block_step_ep, int8_optin=_resolve_int8_optin(int8_optin)))


def make_tp_ep_stage_fns(family, cfg: TransformerConfig,
                         shard_config: ShardConfig, grid,
                         tp_axis: str = "tp", ep_axis: str = "ep"):
    """The MoE serving composition over a `ShardGrid`: attention tensor-
    parallel over `tp_axis` and experts expert-parallel over `ep_axis`.
    Exact against the single device up to the tp all-reduce's summation
    order: routing sees the whole (replicated) token set and the expert
    all-reduce adds one nonzero term per token. The cache is head-split
    over tp and replicated over ep (`init_tp_cache(..., tp=)`); the
    embeddings, router and LM head are whole. An int8 cache is refused by
    the pipeline, as in the JAX package."""
    from .tensor import family_tp_ep_plan

    if not cfg.n_experts:
        raise ValueError("make_tp_ep_stage_fns requires an MoE config "
                         "(cfg.n_experts > 0); use make_tp_stage_fns for "
                         "dense models")
    ntp, nep = grid.axis_size(tp_axis), grid.axis_size(ep_axis)
    if cfg.num_attention_heads % ntp:
        raise ValueError(f"tp={ntp} requires head count "
                         f"({cfg.num_attention_heads}) divisible by tp")
    if cfg.n_experts % nep:
        raise ValueError(f"ep={nep} must divide n_experts "
                         f"({cfg.n_experts})")
    _, act = family_tp_ep_plan(cfg)
    return _make_sharded_run(family, cfg, shard_config, grid,
                             functools.partial(_block_step_tp_ep, act=act))


def shard_moe_stage_params(params: Dict, cfg: TransformerConfig,
                           cells) -> Dict:
    """One MoE decode stage's params over `cells` (an ep `ShardGroup`, or
    a `ShardGrid`): each block a per-cell list whose cell (i, j) holds tp
    slice i of the attention leaves (the family's table of
    `family_tp_ep_plan`; whole on an ep group) and expert slab j
    (`shard_moe_params`), the router whole; the embeddings and final
    params on the first cell. Slices are cut once, on the grid's first
    column and row, and moved to each cell's device, so cells that share
    a device share them."""
    from .expert import shard_moe_params
    from .mesh import ShardGrid
    from .tensor import _shard_by_specs, family_tp_ep_plan

    grid = isinstance(cells, ShardGrid)
    ep = cells.ep if grid else cells.size
    specs = family_tp_ep_plan(cfg)[0] if grid else None
    blocks = []
    for bp in stage_blocks(params):
        att = {k: v for k, v in bp.items() if k != "moe"}
        att_shards = _shard_by_specs(att, {k: specs[k] for k in att},
                                     cells.tp_group(0)) if grid else [att]
        moe_shards = shard_moe_params(bp["moe"], cells.ep_group(0)
                                      if grid else cells)
        blocks.append([
            dict(params_to(att_shards[c // ep], device=dev),
                 moe=params_to(moe_shards[c % ep], device=dev))
            for c, dev in enumerate(cells.devices)])
    out = {k: params_to(v, device=cells.devices[0])
           for k, v in params.items() if k in ("embeddings", "final")}
    out["blocks"] = blocks
    return out


def make_sp_prefill_fn(family, cfg: TransformerConfig,
                       shard_config: ShardConfig, group, axis: str = "sp",
                       sp_kind: str = "ring"):
    """The sequence-parallel prompt pass of a decode stage:
    `prefill(shard_params, data, cache) -> (out, cache)`, `shard_params`
    the stage's params on each shard's device. The prompt's activations
    split over `group` (its axis `axis`) and each block attends through
    the causal core `sp_kind` picks (`parallel/sequence.py
    resolve_sp_core`; a sliding-window family binds its window into it);
    each block's K/V rows are gathered in shard order into the stage
    cache on shard 0's device, so the per-token decode steps run there
    unchanged. Stage edges carry the per-shard chunks; the last stage
    gathers the hidden state and runs the head on shard 0.

    Needs a block-aligned stage and a prompt the sp degree divides. An
    MoE stage is covered when routing is dropless (capacity_factor >=
    n_experts: a per-token gate, exact chunk by chunk)."""
    from .sequence import resolve_sp_core

    if cfg.n_experts and cfg.capacity_factor < cfg.n_experts:
        raise NotImplementedError(
            "sequence-parallel prefill covers dropless MoE only "
            "(capacity_factor >= n_experts); capacity-bounded routing "
            "is sequence-global and would change drop semantics per chunk")
    fam_sp_block = family.sp_prefill_block_step
    if family.position_dependent_attention and fam_sp_block is None:
        raise NotImplementedError(
            f"sequence-parallel prefill does not cover the {family.name} "
            "family (its attention is position-dependent — RoPE — and it "
            "supplies no sp_prefill_block_step hook to pre-rotate at "
            "global chunk positions)")
    _check_block_aligned(shard_config)
    n = group.axis_size(axis)
    core = resolve_sp_core(sp_kind, cfg.num_attention_heads, n,
                           window=cfg.sliding_window or None)

    def cache_gather(bcache: Cache, k_new, v_new) -> None:
        """Write the shards' K/V chunks, gathered in shard order, into the
        stage cache's rows [0, S)."""
        for t, news in (("k", k_new), ("v", v_new)):
            full = group.gather(news, dim=1)
            bcache[t][:, :full.shape[1]] = full.to(bcache[t].dtype)

    def default_block(ps, xs, bcache, cfg_, group_, core_, gather):
        """One GPT-2-shaped block over the local chunks [B, S/n, D]."""
        def project(i, p, x):
            return _qkv(p, layer_norm(p["ln_before"], x,
                                      cfg_.layer_norm_eps), cfg_)

        q, k, v = (list(t) for t in zip(*group_.map(project, ps, xs)))
        ctx = core_(group_, q, k, v, causal=True)
        gather(bcache, k, v)
        return group_.map(lambda i, p, x, c: _block_tail(
            p, x, c.reshape(*x.shape[:2], -1), cfg_), ps, xs, ctx)

    block = fam_sp_block or default_block

    def sp_embed(ps, ids):
        """Each shard's chunk of the prompt at its global positions (the
        learned position table only where the family has one)."""
        chunk = ids.shape[1] // n

        def local(i, p):
            pe = p["embeddings"]
            rows = slice(i * chunk, (i + 1) * chunk)
            out = pe["wte"][ids[:, rows].to(pe["wte"].device).long()]
            if "wpe" in pe:
                out = out + pe["wpe"][rows][None]
            return out
        return group.map(local, ps)

    @torch.inference_mode()
    def prefill(ps, data, cache):
        xs = sp_embed(ps, data) if shard_config.is_first else data
        for b in range(len(ps[0]["blocks"])):
            bcache = {k: c[b] for k, c in cache.items()}
            xs = block([p["blocks"][b] for p in ps], xs, bcache, cfg, group,
                       core, cache_gather)
        if shard_config.is_last:
            return family.finalize(ps[0]["final"], group.gather(xs, dim=1),
                                   cfg), cache
        return xs, cache

    return prefill


def validate_partition(partition: Sequence[Tuple[int, int]],
                       total: int) -> None:
    """Require `partition` to contiguously cover [1, total] in order."""
    expect = 1
    for l, r in partition:
        if l != expect:
            raise ValueError(f"partition {list(partition)} does not "
                             f"contiguously cover [1, {total}]")
        expect = r + 1
    if expect != total + 1:
        raise ValueError(f"partition {list(partition)} does not "
                         f"contiguously cover [1, {total}]")


def round_partition_to_blocks(partition: Sequence[Tuple[int, int]],
                              total: int) -> List[Tuple[int, int]]:
    """Round a sublayer-granular partition to the block-aligned cuts
    decoding requires: each interior cut moves to the nearest multiple of
    4 (a cut halfway rounds up), empty stages are dropped, and [1, total]
    stays covered."""
    if total % 4:
        raise ValueError(f"total sublayers {total} not a multiple of 4")
    cuts = [r for (_, r) in partition[:-1]]
    rounded = sorted({min(total - 4, max(4, int(c / 4 + 0.5) * 4))
                      for c in cuts})
    bounds = [0] + [c for c in rounded if c < total] + [total]
    return [(bounds[i] + 1, bounds[i + 1]) for i in range(len(bounds) - 1)
            if bounds[i + 1] > bounds[i]]


def validate_capacity(cfg: TransformerConfig, max_len: int,
                      prompt_len: int = 0, new_tokens: int = 0) -> None:
    """Reject cache and position overflows up front."""
    if cfg.max_position_embeddings and max_len > cfg.max_position_embeddings:
        raise ValueError(f"max_len {max_len} exceeds the model's "
                         f"{cfg.max_position_embeddings} positions")
    if prompt_len + new_tokens > max_len:
        raise ValueError(f"prompt {prompt_len} + {new_tokens} new tokens "
                         f"exceeds max_len {max_len}")


def _repeat_batch(cache, k: int):
    """Tile the batch axis (axis 1 of [L, B, ...] leaves) k times into new
    tensors: beam b of batch i occupies row i*k + b. A copy even at k = 1,
    since the steps that follow write in place. A tensor-parallel stage's
    cache (a list of shard caches) is tiled shard by shard."""
    if isinstance(cache, list):
        return [_repeat_batch(c, k) for c in cache]
    return {name: x.repeat_interleave(k, dim=1) for name, x in cache.items()}


def _gather_batch(cache, rows: torch.Tensor):
    """Reorder the batch axis of cache leaves by `rows` [B*k], into new
    tensors (two beams may share a parent row); shard by shard for a
    tensor-parallel stage."""
    if isinstance(cache, list):
        return [_gather_batch(c, rows) for c in cache]
    return {name: x.index_select(1, rows.to(x.device))
            for name, x in cache.items()}


def _cat_batch(caches: Sequence):
    """Concatenate caches of batch chunks on the batch axis (shard by shard
    for a tensor-parallel stage)."""
    if isinstance(caches[0], list):
        return [_cat_batch([c[i] for c in caches])
                for i in range(len(caches[0]))]
    return {name: torch.cat([c[name] for c in caches], dim=1)
            for name in caches[0]}


def _pick_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float, top_k: int) -> torch.Tensor:
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits / temperature
    if top_k > 0:
        # keep EXACTLY top_k candidates: scatter the top_k values back by
        # index (a threshold compare would admit every logit tied with the
        # k-th value)
        vals, idx = torch.topk(scaled, top_k, dim=-1)
        scaled = torch.full_like(scaled, -math.inf).scatter(-1, idx, vals)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_token_picker(temperature: float = 0.0, top_k: int = 0):
    """`pick(logits [B, V], generator) -> tokens [B]`: greedy argmax at
    temperature 0, else a draw from softmax(logits/temperature), optionally
    over exactly the `top_k` most likely tokens."""
    return functools.partial(_pick_token, temperature=float(temperature),
                             top_k=int(top_k))


def build_decode_pipeline(model_name: str,
                          partition: Optional[Sequence] = None,
                          max_len: int = 1024, dtype=torch.float32,
                          cache_bits: int = 0, attend_floor: int = 64,
                          model_file: Optional[str] = None,
                          stage_params: Optional[Sequence] = None,
                          device: DeviceLike = None,
                          **pipe_kw) -> "DecodePipeline":
    """Registry-driven `DecodePipeline`: model lookup, per-stage weight
    loading (`module_shard_factory`) and the position-capacity clamp in
    one place. `stage_params` supplies already-loaded per-stage params;
    extra kwargs (`int8_decode_attend=`, the meshes `mesh=`, `sp_mesh=`,
    `ep_mesh=`, `tp_ep_mesh=`, `sp_kind=` and the axes) pass through."""
    from ..models import registry
    cfg = registry.get_model_config(model_name)
    total = registry.get_model_layers(model_name)
    partition = list(partition) if partition else [(1, total)]
    if cfg.max_position_embeddings:
        max_len = min(max_len, cfg.max_position_embeddings)
    if stage_params is None:
        stage_params = [registry.module_shard_factory(
            model_name, model_file, l, r, stage=i, dtype=dtype,
            device=device)[1] for i, (l, r) in enumerate(partition)]
    family = registry.get_model_entry(model_name).family.FAMILY
    return DecodePipeline(family, cfg, partition, stage_params,
                          max_len=max_len, dtype=dtype,
                          cache_bits=cache_bits, attend_floor=attend_floor,
                          device=device, **pipe_kw)


class DecodePipeline:
    """Host-driven pipelined decoding over block-aligned stages, on one
    device (`cuda` unless told otherwise; every stage's params and cache
    live there), or with one mesh over several shards, the pipeline's
    device being its first shard's:

    - `mesh` (a `parallel/mesh.py ShardGroup`): each stage tensor-parallel
      over the group (`make_tp_stage_fns`);
    - `ep_mesh` (a `ShardGroup` whose axis is `ep_axis`): each MoE stage's
      experts split over the group (`make_ep_stage_fns`);
    - `tp_ep_mesh` (a `ShardGrid`): attention over its tp axis and experts
      over its `ep_axis` (`make_tp_ep_stage_fns`);
    - `sp_mesh` (a `ShardGroup` whose axis is `sp_axis`): the prompt pass
      sequence-parallel with the `sp_kind` core (`make_sp_prefill_fn`),
      the decode steps on the first shard's device.

    `stage_params[i]` are forward-pipeline shard params (what
    `module_shard_factory` builds); caches are per stage (per shard on a
    tp, ep or tp x ep mesh)."""

    def __init__(self, family, cfg: TransformerConfig,
                 partition: Sequence[Tuple[int, int]],
                 stage_params: Sequence[Dict], max_len: int,
                 device: DeviceLike = None, dtype=torch.float32,
                 cache_bits: int = 0, attend_floor: int = 64,
                 int8_decode_attend=None, mesh=None, sp_mesh=None,
                 sp_axis: str = "sp", sp_kind: str = "ring", ep_mesh=None,
                 ep_axis: str = "ep", tp_ep_mesh=None):
        from .mesh import ShardGrid, ShardGroup
        total = 4 * cfg.num_hidden_layers
        validate_partition(partition, total)
        validate_capacity(cfg, max_len)
        # the JAX constructor's composition errors, word for word
        if sp_mesh is not None and (mesh is not None or cache_bits):
            raise ValueError("sp_mesh (sequence-parallel prefill) does not "
                             "compose with tp mesh/int8 cache/devices")
        if ep_mesh is not None and (mesh is not None or sp_mesh is not None):
            raise ValueError("ep_mesh (expert-parallel MoE decode) does not "
                             "compose with tp/sp meshes or devices")
        if tp_ep_mesh is not None and (mesh is not None or ep_mesh is not None
                                       or sp_mesh is not None or cache_bits):
            raise ValueError("tp_ep_mesh (tp x ep MoE decode) replaces the "
                             "single-axis meshes; it does not compose with "
                             "mesh/ep_mesh/sp_mesh, int8 cache, or devices")
        if attend_floor < 1:
            raise ValueError(f"attend_floor must be >= 1, got {attend_floor}")
        for name, value, kind in (("mesh", mesh, ShardGroup),
                                  ("sp_mesh", sp_mesh, ShardGroup),
                                  ("ep_mesh", ep_mesh, ShardGroup),
                                  ("tp_ep_mesh", tp_ep_mesh, ShardGrid)):
            if value is not None and not isinstance(value, kind):
                raise TypeError(f"{name} must be a parallel.mesh."
                                f"{kind.__name__}, not "
                                f"{type(value).__name__}")
        self.cfg = cfg
        self.max_len = max_len
        self.mesh, self.sp_mesh = mesh, sp_mesh
        self.ep_mesh, self.tp_ep_mesh = ep_mesh, tp_ep_mesh
        lead = next((m for m in (mesh, sp_mesh, ep_mesh, tp_ep_mesh)
                     if m is not None), None)
        if lead is not None:
            self.device = lead.devices[0]
            if device is not None and resolve_device(device).type \
                    != self.device.type:
                raise ValueError(f"device {device} is not the kind of the "
                                 f"mesh's devices {lead}")
        else:
            self.device = resolve_device(device)
        self.dtype = dtype
        self.cache_bits = cache_bits
        self.attend_floor = attend_floor
        self.sp_degree = sp_mesh.axis_size(sp_axis) if sp_mesh else 1
        # the shard layout of each stage's cache (the prefix stamp's field)
        self._shard_layout = (
            ("tp", mesh.size) if mesh is not None else
            ("ep", ep_mesh.axis_size(ep_axis)) if ep_mesh is not None else
            ("tp", tp_ep_mesh.tp, "ep", tp_ep_mesh.ep)
            if tp_ep_mesh is not None else ())
        # bucketed attend windows ride the plain and tp steps; the ep and
        # tp x ep steps attend the whole window, as in the JAX package
        self._bucketed = ep_mesh is None and tp_ep_mesh is None
        # resolved ONCE here (arg > env > QuantizeCompute) and bound into
        # the stage functions: later env/config changes don't reach them
        self.int8_decode_optin = _resolve_int8_optin(int8_decode_attend)
        optin = self.int8_decode_optin
        self.stages = []
        for i, (l, r) in enumerate(partition):
            sc = ShardConfig(l, r, is_first=l == 1, is_last=r == total)
            stage = {"n_blocks": (r - l + 1) // 4}
            if mesh is not None:
                pre, dec = make_tp_stage_fns(family, cfg, sc, mesh,
                                             int8_optin=optin)
                params = shard_stage_params(stage_params[i], cfg, mesh)
            elif ep_mesh is not None:
                pre, dec = make_ep_stage_fns(family, cfg, sc, ep_mesh,
                                             axis=ep_axis, int8_optin=optin)
                params = shard_moe_stage_params(stage_params[i], cfg,
                                                ep_mesh)
            elif tp_ep_mesh is not None:
                pre, dec = make_tp_ep_stage_fns(family, cfg, sc, tp_ep_mesh,
                                                ep_axis=ep_axis)
                params = shard_moe_stage_params(stage_params[i], cfg,
                                                tp_ep_mesh)
            else:
                pre, dec = make_stage_fns(family, cfg, sc, int8_optin=optin)
                params = params_to(stage_params[i], device=self.device)
                if sp_mesh is not None:
                    pre = make_sp_prefill_fn(family, cfg, sc, sp_mesh,
                                             axis=sp_axis, sp_kind=sp_kind)
                    # the prompt pass's params on each shard's device
                    # (the same tensors where a shard shares the device)
                    stage["prefill_params"] = [
                        params_to(params, device=d) for d in sp_mesh.devices]
            stage.update(prefill=pre, decode=dec, params=params)
            self.stages.append(stage)

    def _read_len(self, pos: int, span: int = 1) -> Optional[int]:
        """Attend window of a decode/span step whose last query row sits
        at pos + span - 1 (None: the whole window, on an ep or tp x ep
        pipeline)."""
        if not self._bucketed:
            return None
        return attend_bucket(pos + span, self.max_len, self.attend_floor)

    def _fresh_caches(self, batch: int) -> List:
        def stage_cache(st):
            args = (self.cfg, st["n_blocks"], batch, self.max_len)
            if self.mesh is not None:
                return init_tp_cache(*args, self.mesh, self.dtype,
                                     cache_bits=self.cache_bits)
            if self.tp_ep_mesh is not None:
                return init_tp_cache(*args, self.tp_ep_mesh, self.dtype,
                                     tp=self.tp_ep_mesh.tp)
            if self.ep_mesh is not None:
                # one replica per shard, each attended on its device
                return [init_cache(*args, self.dtype,
                                   cache_bits=self.cache_bits, device=d)
                        for d in self.ep_mesh.devices]
            return init_cache(*args, self.dtype, cache_bits=self.cache_bits,
                              device=self.device)
        return [stage_cache(st) for st in self.stages]

    def _decode_step(self, st, data, cache: Cache, pos: int, span: int = 1):
        """Run one stage's decode function at host-known `pos` with its
        attend bucket. `span` > 1 runs a K-token span [pos, pos+K)."""
        return st["decode"](st["params"], data, cache, pos,
                            read_len=self._read_len(pos, span))

    def _check_sp_divides(self, length: int, what: str) -> None:
        if length % self.sp_degree:
            raise ValueError(f"{what} length {length} not divisible by "
                             f"the sp prefill degree {self.sp_degree}")

    def _prefill(self, ids: torch.Tensor,
                 prefill_ubatch: Optional[int] = None):
        """Run the prompt through all stages; returns (last-stage output,
        per-stage caches). `prefill_ubatch` runs the batch in chunks and
        concatenates the chunks' caches on the batch axis."""
        batch = ids.shape[0]

        def run_stages(data):
            caches = self._fresh_caches(data.shape[0])
            for i, st in enumerate(self.stages):
                data, caches[i] = st["prefill"](
                    st.get("prefill_params", st["params"]), data, caches[i])
            return data, caches

        if prefill_ubatch is None or prefill_ubatch >= batch:
            return run_stages(ids)
        if prefill_ubatch <= 0:
            raise ValueError(f"prefill_ubatch must be positive, got "
                             f"{prefill_ubatch}")
        if batch % prefill_ubatch:
            raise ValueError(f"batch {batch} not divisible by "
                             f"prefill_ubatch {prefill_ubatch}")
        outs, chunk_caches = [], []
        for c0 in range(0, batch, prefill_ubatch):
            data, caches = run_stages(ids[c0:c0 + prefill_ubatch])
            outs.append(data)
            chunk_caches.append(caches)
        merged = [_cat_batch([cc[i] for cc in chunk_caches])
                  for i in range(len(self.stages))]
        return torch.cat(outs, dim=0), merged

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def extend(self, tokens, caches: List[Cache], pos: int):
        """Run a K-token span [B, K] through every stage at cache offset
        `pos`: rows [pos, pos+K) are written and span row i attends
        [0, pos+i]. Returns (last-stage output [B, K, ...], caches). With
        an int8 cache the in-span rows are attended unquantized, so a span
        is not bit-identical to K serial int8 steps; fp caches are exact."""
        data = self._ids(tokens)
        k = data.shape[1]
        if pos + k > self.max_len:
            raise ValueError(f"span [{pos}, {pos + k}) exceeds max_len "
                             f"{self.max_len}")
        for i, st in enumerate(self.stages):
            data, caches[i] = self._decode_step(st, data, caches[i], pos,
                                                span=k)
        return data, caches

    def precompute_prefix(self, prefix_ids) -> Dict:
        """Prefill a shared prompt prefix once, for reuse across requests:
        returns a handle for `generate(..., prefix=)`. `prefix_ids` is [P]
        or [1, P]. Exact for fp caches; with an int8 cache the reused rows
        carry their quantization error, where a whole prefill attends its
        own prompt rows unquantized."""
        ids = self._ids(prefix_ids)
        if ids.dim() == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError("a shared prefix is one sequence; got batch "
                             f"{ids.shape[0]}")
        self._check_sp_divides(ids.shape[1], "prefix")
        _, caches = self._prefill(ids)
        return {"caches": caches, "len": ids.shape[1],
                "sig": self._prefix_sig()}

    def _prefix_sig(self) -> Tuple:
        """Cache-compatibility stamp of prefix handles: per-stage block
        split, max_len, quantization, dtype and KV geometry."""
        return ("decode-prefix-v1",
                tuple(st["n_blocks"] for st in self.stages),
                self.max_len, self.cache_bits,
                str(self.dtype).replace("torch.", ""),
                self.cfg.kv_heads, self.cfg.head_dim, self._shard_layout)

    def check_prefix(self, prefix: Dict) -> None:
        """Validate a `precompute_prefix` handle against this pipeline's
        cache layout; raises ValueError on a mismatch."""
        sig = prefix.get("sig") if isinstance(prefix, dict) else None
        if sig is None:
            raise ValueError(
                "prefix is not a precompute_prefix handle (no 'sig' "
                "stamp); build it with this pipeline's precompute_prefix")
        if sig != self._prefix_sig():
            raise ValueError(
                "prefix handle was built by an incompatible pipeline: "
                f"handle sig {sig} vs this pipeline {self._prefix_sig()} "
                "(fields: version, per-stage block counts, max_len, "
                "cache_bits, dtype, kv_heads, head_dim, shard layout)")

    @torch.inference_mode()
    def generate(self, ids, new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, step_callback=None,
                 prefill_ubatch: Optional[int] = None,
                 prefix: Optional[Dict] = None) -> torch.Tensor:
        """Decode `new_tokens` continuations of prompt `ids` [B, S].

        `temperature=0` is greedy argmax; otherwise tokens are drawn from
        softmax(logits/temperature), optionally over the `top_k` most
        likely, by a `torch.Generator` on the device seeded with `seed`.
        `step_callback(step, tokens)` fires after each token.
        `prefill_ubatch` runs the prompt pass in batch chunks. `prefix`
        (from `precompute_prefix`) seeds the caches with a shared prefix;
        `ids` is then each row's suffix, run as one span. Returns
        [B, S + new_tokens] token ids on the device (without the prefix)."""
        ids = self._ids(ids)
        batch, suffix_len = ids.shape
        prompt_len = suffix_len + (prefix["len"] if prefix else 0)
        if new_tokens <= 0:
            return ids
        validate_capacity(self.cfg, self.max_len, prompt_len, new_tokens)
        if prefix is None:
            self._check_sp_divides(prompt_len, "prompt")
        pick = make_token_picker(temperature, top_k)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)

        if prefix is not None:
            self.check_prefix(prefix)
            if prefill_ubatch is not None:
                raise ValueError("prefix reuse runs the suffix as one "
                                 "span; --prefill-ubatch does not apply")
            if suffix_len == 0:
                raise ValueError(
                    "prefix reuse needs a non-empty suffix (the span "
                    "produces the first token's logits); keep at least "
                    "the last prompt token out of the prefix")
            caches = [_repeat_batch(c, batch) for c in prefix["caches"]]
            data, caches = self.extend(ids, caches, prefix["len"])
        else:
            data, caches = self._prefill(ids, prefill_ubatch)
        tokens = [pick(data[:, -1].float(), gen)]
        if step_callback is not None:
            step_callback(0, tokens[-1])
        for step in range(1, new_tokens):
            pos = prompt_len + step - 1
            data = tokens[-1][:, None]
            for i, st in enumerate(self.stages):
                data, caches[i] = self._decode_step(st, data, caches[i], pos)
            tokens.append(pick(data[:, 0].float(), gen))
            if step_callback is not None:
                step_callback(step, tokens[-1])
        return torch.cat([ids, torch.stack(tokens, dim=1)], dim=1)

    @torch.inference_mode()
    def generate_beam(self, ids, new_tokens: int, beams: int
                      ) -> torch.Tensor:
        """Beam search: keep the `beams` highest log-probability
        continuations per prompt and return the best [B, S + new_tokens].

        Beams fold into the batch axis (row i*beams + b); after each step
        the caches are gathered to follow their surviving parent beams.
        Fixed horizon, no EOS or length normalization."""
        ids = self._ids(ids)
        batch, prompt_len = ids.shape
        if new_tokens <= 0:
            return ids
        if beams < 1:
            raise ValueError(f"beams must be >= 1, got {beams}")
        if beams == 1:
            return self.generate(ids, new_tokens)
        validate_capacity(self.cfg, self.max_len, prompt_len, new_tokens)
        self._check_sp_divides(prompt_len, "prompt")

        data, caches = self._prefill(ids)
        caches = [_repeat_batch(c, beams) for c in caches]
        logp = torch.log_softmax(data[:, prompt_len - 1].float(), dim=-1)
        scores, first = torch.topk(logp, beams, dim=-1)    # [B, beams]
        history = first[..., None]                         # [B, beams, 1]
        base = torch.arange(batch, device=self.device)[:, None] * beams

        for step in range(1, new_tokens):
            pos = prompt_len + step - 1
            data = history[:, :, -1].reshape(batch * beams, 1)
            for i, st in enumerate(self.stages):
                data, caches[i] = self._decode_step(st, data, caches[i], pos)
            logp = torch.log_softmax(data[:, 0].float(), dim=-1)
            vocab = logp.shape[-1]
            total = scores[..., None] + logp.reshape(batch, beams, vocab)
            scores, flat = torch.topk(total.reshape(batch, -1), beams,
                                      dim=-1)
            parent = flat // vocab                          # [B, beams]
            token = flat % vocab
            rows = (base + parent).reshape(-1)
            caches = [_gather_batch(c, rows) for c in caches]
            history = torch.cat(
                [torch.gather(history, 1, parent[..., None].expand(
                    -1, -1, history.shape[2])), token[..., None]], dim=2)

        best = scores.argmax(dim=1)
        best_hist = history[torch.arange(batch, device=self.device), best]
        return torch.cat([ids, best_hist], dim=1)
