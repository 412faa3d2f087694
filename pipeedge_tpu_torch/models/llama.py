"""Llama model family: RoPE / RMSNorm / SwiGLU / grouped-query attention.

Port of `pipeedge_tpu/models/llama.py` with its tensor-parallel hooks
(`tp_cached_block_step`, `tp_finalize`) and its sequence-parallel
block (`sp_block_step`, the SPMD pipeline's; `sp_prefill_block_step`,
the decode prefill's, gathers the K/V rows into the cache). It carries
Llama-2, Llama-3 and Mistral (the Llama block with a sliding window over
the last `cfg.sliding_window` positions) in the 4-sublayer cut of every
other family:
  sub 0: rms_norm -> RoPE'd GQA self-attention   payload becomes (ctx, residual)
  sub 1: attention output proj + residual        payload becomes hidden
  sub 2: rms_norm -> silu(gate) * up             payload becomes (mlp_h, residual)
  sub 3: MLP-down + residual                     payload becomes hidden
First shard: token embedding (positions live in the rotation). Last
shard: final RMSNorm + LM head.

Attention routes, a predicate on the config and the sequence length
(`fused_route`), not a fallback:
- the full forward (sublayer 0) repeats K/V to the query heads and takes
  kernel 3 (`ops/attention.py fused_attention`, causal) when there is no
  window or S <= window, where the window masks nothing; otherwise the
  masked `_attend` of `parallel/decode.py`, the function the JAX package
  computes there;
- the cached step (`cached_block_step`, prefill and span steps included)
  attends through `_cache_update_and_read` + `_attend`, as the JAX step
  does, so a chunked prompt pass and a whole one attend through one
  function. It never asks the int8 decode-attention gate: Llama steps
  on an int8 cache take the dequantize route, MHA Llama-2 included.

The cache holds post-RoPE K at `cfg.kv_heads` heads; a step rotates only
its new rows, at their absolute positions.

Weights: HF `LlamaForCausalLM` state dicts (`model.`-prefixed
`nn.Linear` kernels stored [out, in], transposed to [in, out] at load;
no biases: zero vectors keep the {w, b} layout of the other families;
the LM head falls back to the tied `embed_tokens`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import ShardConfig
from .layers import TransformerConfig, dense, rms_norm, rope_rotate
from .shard import FamilySpec, build_shard_params
from ..ops.attention import fused_attention

SUBLAYER_PARAMS = {
    0: ("ln_before", "q", "k", "v"),
    1: ("attn_out",),
    2: ("ln_after", "mlp_gate", "mlp_up"),
    3: ("mlp_down",),
}


def _split_heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = y.shape
    return y.reshape(b, s, n_heads, -1)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, kv_heads, Dh] -> [B, S, kv_heads * n_rep, Dh]: each KV head
    repeated in place (`jnp.repeat` on the head axis), so query head h
    reads KV head h // n_rep."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def _window_keep(keep: torch.Tensor, q_pos: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Intersect a keep mask [S_q, S_k] with the sliding window: the query
    at absolute position q (`q_pos` [S_q, 1]) attends keys in
    (q - window, q]; unchanged when the window is off."""
    if not cfg.sliding_window:
        return keep
    k_pos = torch.arange(keep.shape[1], device=keep.device)[None, :]
    return keep & (k_pos > q_pos - cfg.sliding_window)


def fused_route(cfg: TransformerConfig, seq_len: int) -> bool:
    """Whether the full forward over `seq_len` tokens attends through
    kernel 3 (causal): with no window, or one that masks nothing."""
    return not cfg.sliding_window or seq_len <= cfg.sliding_window


def _gqa_attend(q, k, v, cfg: TransformerConfig, keep=None,
                q_pos=None) -> torch.Tensor:
    """softmax(q kᵀ/√Dh) v with GQA head repetition -> [B, S_q, H * Dh].

    `keep` [S_q, S_k] masks key positions (the cached step: pass `q_pos`
    [S_q, 1] so the window anchors at absolute positions); without it,
    the full forward's causal (and windowed) attention over [S, S], routed
    by `fused_route`."""
    from ..parallel.decode import _attend

    b, s, h, hd = q.shape
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    if keep is None:
        if fused_route(cfg, s):
            return fused_attention(q, k, v, causal=True).reshape(b, s, h * hd)
        q_pos = torch.arange(s, device=q.device)[:, None]
        keep = torch.arange(s, device=q.device)[None, :] <= q_pos
    if q_pos is not None:
        keep = _window_keep(keep, q_pos, cfg)
    return _attend(q, k, v, keep)


def _qkv_rope(p: Dict, normed: torch.Tensor, cfg: TransformerConfig,
              pos: torch.Tensor):
    """Project, then RoPE-rotate q and k (v unrotated) at positions `pos`."""
    q = _split_heads(dense(p["q"], normed), cfg.num_attention_heads)
    k = _split_heads(dense(p["k"], normed), cfg.kv_heads)
    v = _split_heads(dense(p["v"], normed), cfg.kv_heads)
    return (rope_rotate(q, pos, cfg.rope_theta),
            rope_rotate(k, pos, cfg.rope_theta), v)


def embed(p: Dict, input_ids: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Token embedding only: positions live in the rotation."""
    return p["wte"][input_ids.long()]


def _swiglu(p: Dict, normed: torch.Tensor) -> torch.Tensor:
    gated = F.silu(dense(p["mlp_gate"], normed).float()).to(normed.dtype)
    return gated * dense(p["mlp_up"], normed)


def sublayer(p: Dict, sub: int, data, cfg: TransformerConfig,
             attention_fn=None):
    """One of the 4 schedulable sublayers (pre-RMSNorm block, RoPE GQA)."""
    if attention_fn is not None:
        raise NotImplementedError(
            "llama attention cores are position-dependent (RoPE); the "
            "sequence-parallel attention override is not supported")
    if sub == 0:
        normed = rms_norm(p["ln_before"], data, cfg.layer_norm_eps)
        pos = torch.arange(normed.shape[1], device=normed.device)
        q, k, v = _qkv_rope(p, normed, cfg, pos)
        return (_gqa_attend(q, k, v, cfg), data)
    if sub == 1:
        ctx, skip = data
        return dense(p["attn_out"], ctx) + skip
    if sub == 2:
        normed = rms_norm(p["ln_after"], data, cfg.layer_norm_eps)
        return (_swiglu(p, normed), data)
    if sub == 3:
        mlp_h, skip = data
        return dense(p["mlp_down"], mlp_h) + skip
    raise ValueError(f"sublayer must be 0..3, got {sub}")


def finalize(p: Dict, hidden: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """Final RMSNorm + LM head -> [B, S, vocab] logits."""
    return dense(p["head"], rms_norm(p["ln"], hidden, cfg.layer_norm_eps))


def _abs_q_pos(pos: int, s: int, device) -> torch.Tensor:
    """Absolute query positions [S_q, 1] of a cached step: row i sits at
    pos + i (a prefill runs at pos 0, a decode step is one row at `pos`,
    a span covers [pos, pos + s)). They anchor the sliding window."""
    return pos + torch.arange(s, device=device)[:, None]


def decode_embed(pe: Dict, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step's token embedding [B, 1, D]: the wte row only."""
    return pe["wte"][tok.reshape(-1).long()][:, None]


def span_embed(pe: Dict, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """A K-token span's embedding [B, K] -> [B, K, D]: wte rows only."""
    return pe["wte"][tok.long()]


def _block_tail(p: Dict, x: torch.Tensor, ctx: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Post-attention half of a block: output projection + residual,
    RMSNorm, SwiGLU + residual."""
    h = dense(p["attn_out"], ctx) + x
    normed = rms_norm(p["ln_after"], h, cfg.layer_norm_eps)
    return dense(p["mlp_down"], _swiglu(p, normed)) + h


def cached_block_step(p: Dict, x: torch.Tensor, bcache, pos: int,
                      cfg: TransformerConfig, prefill: bool,
                      read_len=None) -> torch.Tensor:
    """A KV-cached Llama block (`parallel/decode.py` `_block_step`'s
    contract): rotate the new rows at [pos, pos + S) (a prefill runs at
    pos 0), write their post-RoPE K and V into the cache slice `bcache`
    in place, and attend the masked window [0, read_len)."""
    from ..parallel.decode import _cache_update_and_read

    normed = rms_norm(p["ln_before"], x, cfg.layer_norm_eps)
    s = normed.shape[1]
    pos_ids = pos + torch.arange(s, device=x.device)
    q, k_new, v_new = _qkv_rope(p, normed, cfg, pos_ids)
    k, v, keep = _cache_update_and_read(bcache, k_new, v_new, pos, prefill,
                                        q.dtype, read_len=read_len)
    ctx = _gqa_attend(q, k, v, cfg, keep=keep,
                      q_pos=_abs_q_pos(pos, s, x.device))
    return _block_tail(p, x, ctx, cfg)


def tp_cached_block_step(group, ps, xs, bcaches, pos: int,
                         cfg: TransformerConfig, prefill: bool,
                         read_len=None):
    """The tensor-parallel KV-cached Llama block over a shard group: the
    forward Megatron body (`parallel/tensor.py _tp_llama_block_local`, one
    copy of the projection/all-reduce/SwiGLU numerics) with each shard's
    attention core swapped for a cache-attend over its head slice of the
    GQA cache, `bcaches[i]`. Heads and kv heads divide by the group size."""
    from ..parallel.decode import _cache_update_and_read
    from ..parallel.tensor import _tp_llama_block_local

    s = xs[0].shape[1]

    def cache_attend(i, q, k_new, v_new):
        k, v, keep = _cache_update_and_read(bcaches[i], k_new, v_new, pos,
                                            prefill, q.dtype,
                                            read_len=read_len)
        return _gqa_attend(q, k, v, cfg, keep=keep,
                           q_pos=_abs_q_pos(pos, s, q.device))

    return _tp_llama_block_local(group, ps, xs, cfg, qkv_to_ctx=cache_attend,
                                 pos_ids=pos + torch.arange(s))


def tp_finalize(group, pfs, xs, cfg: TransformerConfig) -> torch.Tensor:
    """The vocab-split LM head under tp (the shared helper, RMSNorm)."""
    from ..parallel.decode import tp_vocab_head_finalize
    return tp_vocab_head_finalize(group, pfs, xs, cfg, norm_fn=rms_norm)


def sp_block_step(ps, xs, cfg: TransformerConfig, group, core,
                  on_kv=None):
    """The sequence-parallel Llama block over the shards' chunks [B, S/n,
    D]: q and k are rotated at their global positions (shard i's chunk
    starts at i * S/n) before the sp core, so the chunk-local core needs
    no positions. The cores are GQA-aware: unrepeated K/V ride the ring or
    the all-to-all. A window needs nothing here: the core has it bound.
    `on_kv(ks, vs)` receives the shards' unrepeated post-RoPE K/V rows
    (the prefill's cache gather); an SPMD pipeline's block passes none."""
    def project(i, p, x):
        s_local = x.shape[1]
        pos = i * s_local + torch.arange(s_local, device=x.device)
        return _qkv_rope(p, rms_norm(p["ln_before"], x, cfg.layer_norm_eps),
                         cfg, pos)

    q, k, v = (list(t) for t in zip(*group.map(project, ps, xs)))
    ctx = core(group, q, k, v, causal=True)
    if on_kv is not None:
        on_kv(k, v)
    return group.map(lambda i, p, x, c: _block_tail(
        p, x, c.reshape(*x.shape[:2], -1), cfg), ps, xs, ctx)


def sp_prefill_block_step(ps, xs, bcache, cfg: TransformerConfig, group,
                          core, cache_gather):
    """The sequence-parallel Llama prefill block (`sp_block_step`), its
    K/V rows gathered into the stage cache `bcache`: the unrepeated
    post-RoPE rows the decode steps read, which mask their own window
    (`_window_keep`)."""
    return sp_block_step(ps, xs, cfg, group, core,
                         on_kv=lambda k, v: cache_gather(bcache, k, v))


FAMILY = FamilySpec(name="llama", embed=embed, sublayer=sublayer,
                    finalize=finalize, cached_block_step=cached_block_step,
                    decode_embed=decode_embed, span_embed=span_embed,
                    position_dependent_attention=True,
                    tp_cached_block_step=tp_cached_block_step,
                    tp_finalize=tp_finalize,
                    sp_prefill_block_step=sp_prefill_block_step,
                    sp_block_step=sp_block_step)


# --- weight loading -------------------------------------------------------

def _a(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _lin(sd, key: str, dtype) -> Dict:
    """HF nn.Linear kernel [out, in] -> {w [in, out], b zeros}."""
    w = np.asarray(sd[key])
    return {"w": _a(w.T, dtype), "b": torch.zeros((w.shape[0],), dtype=dtype)}


def load_params(cfg: TransformerConfig, shard_config: ShardConfig,
                weights: Mapping, dtype=torch.float32) -> Dict:
    """Build shard params (on the CPU) from an HF `LlamaForCausalLM`
    state dict (npz or dict of arrays)."""
    keys = set(weights.keys())
    sd = {k.removeprefix("model."): weights[k] for k in keys
          if k.startswith("model.")}
    if "lm_head.weight" in keys:
        sd["lm_head.weight"] = weights["lm_head.weight"]

    def get_embed() -> Dict:
        return {"wte": _a(sd["embed_tokens.weight"], dtype)}

    def get_block(block_id: int, subs: tuple) -> Dict:
        root = f"layers.{block_id}."
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = {
                "scale": _a(sd[root + "input_layernorm.weight"], dtype)}
            for name in ("q", "k", "v"):
                p[name] = _lin(sd, root + f"self_attn.{name}_proj.weight",
                               dtype)
        if 1 in subs:
            p["attn_out"] = _lin(sd, root + "self_attn.o_proj.weight", dtype)
        if 2 in subs:
            p["ln_after"] = {
                "scale": _a(sd[root + "post_attention_layernorm.weight"],
                            dtype)}
            p["mlp_gate"] = _lin(sd, root + "mlp.gate_proj.weight", dtype)
            p["mlp_up"] = _lin(sd, root + "mlp.up_proj.weight", dtype)
        if 3 in subs:
            p["mlp_down"] = _lin(sd, root + "mlp.down_proj.weight", dtype)
        return p

    def get_final() -> Dict:
        head = sd.get("lm_head.weight", sd["embed_tokens.weight"])  # tied
        return {"ln": {"scale": _a(sd["norm.weight"], dtype)},
                "head": _lin({"head": head}, "head", dtype)}

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def init_params(cfg: TransformerConfig, shard_config: ShardConfig,
                seed: int = 0, dtype=torch.float32) -> Dict:
    """Random shard params with the structure of `load_params`, drawn from
    the numpy stream of the JAX package's `llama.init_params` (one seed,
    equal weights in both packages)."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size
    kv_d = cfg.kv_heads * cfg.head_dim

    def mat(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, size=shape)).to(dtype)

    def lin(n_in, n_out):
        return {"w": mat(n_in, n_out),
                "b": torch.zeros((n_out,), dtype=dtype)}

    def rms():
        return {"scale": torch.ones((d,), dtype=dtype)}

    def get_embed() -> Dict:
        return {"wte": mat(cfg.vocab_size, d)}

    def get_block(block_id: int, subs: tuple) -> Dict:
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = rms()
            p["q"] = lin(d, d)
            p["k"] = lin(d, kv_d)
            p["v"] = lin(d, kv_d)
        if 1 in subs:
            p["attn_out"] = lin(d, d)
        if 2 in subs:
            p["ln_after"] = rms()
            p["mlp_gate"] = lin(d, it)
            p["mlp_up"] = lin(d, it)
        if 3 in subs:
            p["mlp_down"] = lin(it, d)
        return p

    def get_final() -> Dict:
        return {"ln": rms(), "head": lin(d, cfg.vocab_size)}

    return build_shard_params(shard_config, get_embed, get_block, get_final)
