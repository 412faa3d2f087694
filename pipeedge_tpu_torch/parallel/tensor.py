"""Tensor parallelism: Megatron-style sharding of a block over a shard group.

Port of `pipeedge_tpu/parallel/tensor.py`. A transformer block's
attention heads and MLP hidden dimension split over the shard group
(`parallel/mesh.py ShardGroup`): q/k/v and MLP-up kernels column-split
(no communication), the attention-output and MLP-down kernels row-split,
each followed by one all-reduce (`tp_psum`): two per block.

JAX runs the per-device body under `shard_map`; here the body is written
over the group in lock step: each phase maps over the shards (each on its
own device), and the all-reduce between phases takes the per-shard
partial products and returns each shard's sum. Every value a body passes
on is a per-shard list; a replicated activation is one entry per shard.
At `--tp-quant-bits` 0 the shards agree bit for bit; with a quantized
all-reduce each shard keeps its own result, as each JAX device does, and
the output of a block is read from shard 0, as JAX reads a replicated
output.

The attention core of an unmasked shard is kernel 3 (`ops/attention.py
fused_attention`) on the card and its plain version on the CPU, as every
unmasked self-attention of the port is; the JAX TP body computes the same
function with einsums. Row-parallel partial products are summed across
shards, so a TP block is not bit-identical to the unsharded one.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..models.layers import (TransformerConfig, dense, gelu, gelu_new,
                             layer_norm, rms_norm, rope_rotate)
from ..ops.attention import fused_attention
from .mesh import ShardGroup

# -- quantized TP collectives: 0 = exact all-reduce; 4/8 = the EQuARX-style
#    quantized all-reduce (ops/qcollectives.py). Eager PyTorch reads it on
#    every call, so a change applies from the next block.
_TP_QUANT_BITS = 0


def set_tp_quant_bits(bit: int) -> None:
    """Select the bitwidth of intra-stage TP collectives (the runtime's
    --tp-quant-bits knob)."""
    global _TP_QUANT_BITS  # pylint: disable=global-statement
    if bit not in (0, 4, 8):
        raise ValueError(f"tp quant bits must be 0, 4 or 8, got {bit}")
    _TP_QUANT_BITS = int(bit)


def get_tp_quant_bits() -> int:
    return _TP_QUANT_BITS


def tp_psum(group: ShardGroup, xs: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """THE all-reduce of every Megatron block body here: exact at bits 0,
    the quantized collective otherwise; the single gate the
    --tp-quant-bits knob flips for all six psum sites."""
    bit = _TP_QUANT_BITS
    if bit:
        from ..ops import qcollectives
        return qcollectives.qpsum(group, xs, bit)
    return group.psum(xs)


# -- split rules: the axis of each leaf that splits over the group (the
#    position of 'tp' in the JAX PartitionSpec), None = replicated.
#    Kernels are stored [in, out]: a column split cuts axis 1 (and the
#    bias), a row split axis 0 (the bias stays whole)
_COL = {"w": 1, "b": 0}
_ROW = {"w": 0, "b": None}
_LN = {"scale": None, "bias": None}

_LLAMA_PARAM_SPECS = {
    "q": _COL, "k": _COL, "v": _COL, "attn_out": _ROW,
    "mlp_gate": _COL, "mlp_up": _COL, "mlp_down": _ROW,
    "ln_before": {"scale": None}, "ln_after": {"scale": None},
}

_VIT_PARAM_SPECS = {
    "q": _COL, "k": _COL, "v": _COL, "attn_out": _ROW,
    "mlp_up": _COL, "mlp_down": _ROW,
    "ln_before": _LN, "ln_after": _LN,
}

_BERT_PARAM_SPECS = {
    "q": _COL, "k": _COL, "v": _COL, "attn_out": _ROW,
    "mlp_up": _COL, "mlp_down": _ROW,
    "attn_ln": _LN, "out_ln": _LN,
}


def split_leaf(x: torch.Tensor, ax, n: int, i: int, device) -> torch.Tensor:
    """Shard i of n of leaf `x` along axis `ax` (None: the whole leaf) on
    `device`. A split is its own copy, so the unsharded leaf can be
    freed; a replicated leaf moved to a device it is on stays itself."""
    if ax is None:
        return x.to(device)
    if x.shape[ax] % n:
        raise ValueError(f"axis {ax} of a {tuple(x.shape)} leaf does not "
                         f"split {n} ways")
    size = x.shape[ax] // n
    return x.narrow(ax, i * size, size).to(device, copy=True)


def _shard_by_specs(params: Dict, specs: Dict, group: ShardGroup
                    ) -> List[Dict]:
    """One block's params as per-shard dicts on the group's devices, per
    the spec table the block bodies read (one source of truth)."""
    def take(p, s, i):
        if isinstance(p, dict):
            return {k: take(v, s[k], i) for k, v in p.items()}
        return split_leaf(p, s, group.size, i, group.devices[i])

    return [take(params, specs, i) for i in range(group.size)]


def shard_vit_block_params(params: Dict, group: ShardGroup) -> List[Dict]:
    """One ViT/DeiT block's params with Megatron TP sharding: column
    q/k/v and mlp_up, row attn_out and mlp_down, LayerNorms replicated."""
    return _shard_by_specs(params, _VIT_PARAM_SPECS, group)


def shard_bert_block_params(params: Dict, group: ShardGroup) -> List[Dict]:
    """One BERT (post-LN) block's params: ViT's column/row layout, the
    LayerNorms (attn_ln/out_ln) replicated."""
    return _shard_by_specs(params, _BERT_PARAM_SPECS, group)


def _partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel partial product in f32 (JAX's
    `preferred_element_type=float32`): products of bf16 values are exact
    in f32, so a bf16 shard multiplies in f32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, w.to(torch.float32))
    return torch.matmul(a.float(), w.float())


def _heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = y.shape
    return y.reshape(b, s, n_heads, -1)


def _tp_attention(group: ShardGroup, ps: Sequence[Dict],
                  xs: Sequence[torch.Tensor], cfg: TransformerConfig,
                  causal: bool = False, qkv_to_ctx=None
                  ) -> List[torch.Tensor]:
    """The attention half of the pre-LN block over the group: local heads,
    the row-parallel output projection, one all-reduce and the residual.

    `qkv_to_ctx(i, q, k, v) -> ctx` ([b, s, h_local * hd]) replaces shard
    i's attention core over its local heads: how KV-cache decoding plugs
    its cache-attend into this same projection/all-reduce body
    (parallel/decode.py)."""
    heads_local = cfg.num_attention_heads // group.size

    def attention(i, p, x):
        normed = layer_norm(p["ln_before"], x, cfg.layer_norm_eps)
        q, k, v = (_heads(dense(p[name], normed), heads_local)
                   for name in ("q", "k", "v"))
        if qkv_to_ctx is not None:
            ctx = qkv_to_ctx(i, q, k, v)
        else:
            b, s = x.shape[:2]
            ctx = fused_attention(q, k, v, causal=causal).reshape(b, s, -1)
        # row-parallel output projection: partial products summed across
        # the shards
        return _partial(ctx, p["attn_out"]["w"])

    attn = tp_psum(group, group.map(attention, ps, xs))
    return group.map(lambda i, p, x, a: (a + p["attn_out"]["b"]).to(x.dtype)
                     + x, ps, xs, attn)


def _tp_block_local(group: ShardGroup, ps: Sequence[Dict],
                    xs: Sequence[torch.Tensor], cfg: TransformerConfig,
                    act=gelu, causal: bool = False, qkv_to_ctx=None
                    ) -> List[torch.Tensor]:
    """The pre-LN block body over the group: local head/hidden slices +
    two all-reduces. Serves ViT/DeiT as-is and GPT-2 via act=gelu_new +
    causal=True; `qkv_to_ctx` as in `_tp_attention`. The tp x ep MoE
    block (parallel/decode.py `_block_step_tp_ep`) runs `_tp_attention`
    and then the expert-parallel FFN: its all-reduce spans the grid's ep
    columns, so it cannot run inside one column's body."""
    xs = _tp_attention(group, ps, xs, cfg, causal=causal,
                       qkv_to_ctx=qkv_to_ctx)

    def mlp(i, p, x):
        normed = layer_norm(p["ln_after"], x, cfg.layer_norm_eps)
        return _partial(act(dense(p["mlp_up"], normed)), p["mlp_down"]["w"])

    down = tp_psum(group, group.map(mlp, ps, xs))
    return group.map(lambda i, p, x, d: (d + p["mlp_down"]["b"]).to(x.dtype)
                     + x, ps, xs, down)


def _tp_bert_block_local(group: ShardGroup, ps: Sequence[Dict],
                         xs: Sequence[torch.Tensor],
                         cfg: TransformerConfig) -> List[torch.Tensor]:
    """The BERT block body (post-LN residuals, bert.py sublayers 0-3):
    attention on the raw x, LayerNorm after each residual."""
    heads_local = cfg.num_attention_heads // group.size

    def attention(i, p, x):
        q, k, v = (_heads(dense(p[name], x), heads_local)
                   for name in ("q", "k", "v"))
        b, s = x.shape[:2]
        ctx = fused_attention(q, k, v).reshape(b, s, -1)
        return _partial(ctx, p["attn_out"]["w"])

    attn = tp_psum(group, group.map(attention, ps, xs))
    xs = group.map(lambda i, p, x, a: layer_norm(
        p["attn_ln"], (a + p["attn_out"]["b"]).to(x.dtype) + x,
        cfg.layer_norm_eps), ps, xs, attn)

    def mlp(i, p, x):
        return _partial(gelu(dense(p["mlp_up"], x)), p["mlp_down"]["w"])

    down = tp_psum(group, group.map(mlp, ps, xs))
    return group.map(lambda i, p, x, d: layer_norm(
        p["out_ln"], (d + p["mlp_down"]["b"]).to(x.dtype) + x,
        cfg.layer_norm_eps), ps, xs, down)


def _tp_llama_block_local(group: ShardGroup, ps: Sequence[Dict],
                          xs: Sequence[torch.Tensor],
                          cfg: TransformerConfig, qkv_to_ctx=None,
                          pos_ids=None) -> List[torch.Tensor]:
    """The Llama block body (pre-RMSNorm, RoPE, GQA, SwiGLU).

    Column-split q/k/v keep GQA grouping local: shard i holds query heads
    [i*h/n, (i+1)*h/n) and kv heads [i*kv/n, (i+1)*kv/n), and query head
    g's kv head g // (h/kv) lands on the same shard, so the local repeat
    and attend need no collective. Heads, kv heads and the intermediate
    size must divide by the group size. `qkv_to_ctx(i, q, k, v)` replaces
    the attention core over the local RoPE'd heads and `pos_ids` the
    rotation positions (the KV-cached step, models/llama.py
    `tp_cached_block_step`)."""
    from ..models.llama import _gqa_attend

    n = group.size
    heads_local, kv_local = cfg.num_attention_heads // n, cfg.kv_heads // n

    def attention(i, p, x):
        normed = rms_norm(p["ln_before"], x, cfg.layer_norm_eps)
        pos = (torch.arange(x.shape[1], device=x.device) if pos_ids is None
               else pos_ids.to(x.device))
        q = rope_rotate(_heads(dense(p["q"], normed), heads_local), pos,
                        cfg.rope_theta)
        k = rope_rotate(_heads(dense(p["k"], normed), kv_local), pos,
                        cfg.rope_theta)
        v = _heads(dense(p["v"], normed), kv_local)
        ctx = (qkv_to_ctx(i, q, k, v) if qkv_to_ctx is not None
               else _gqa_attend(q, k, v, cfg))    # local heads, causal
        return _partial(ctx, p["attn_out"]["w"])

    attn = tp_psum(group, group.map(attention, ps, xs))
    xs = group.map(lambda i, p, x, a: (a + p["attn_out"]["b"]).to(x.dtype)
                   + x, ps, xs, attn)

    def mlp(i, p, x):
        normed = rms_norm(p["ln_after"], x, cfg.layer_norm_eps)
        gated = F.silu(dense(p["mlp_gate"], normed).float()).to(x.dtype)
        return _partial(gated * dense(p["mlp_up"], normed),
                        p["mlp_down"]["w"])

    down = tp_psum(group, group.map(mlp, ps, xs))
    return group.map(lambda i, p, x, d: (d + p["mlp_down"]["b"]).to(x.dtype)
                     + x, ps, xs, down)


def family_tp_plan(cfg: TransformerConfig):
    """THE family dispatch point for tensor parallelism: returns (split
    rule table, block body over the group). MoE configs refuse here (the
    dense column/row table does not describe a routed FFN); their
    composition is `family_tp_ep_plan`."""
    if cfg.n_experts:
        raise NotImplementedError(
            "Megatron TP does not cover MoE blocks (experts shard over "
            "'ep', not the column/row kernel table) — see family_tp_ep_plan "
            "/ decode.make_tp_ep_stage_fns for the tp x ep composition")
    if cfg.model_type == "bert":
        return _BERT_PARAM_SPECS, _tp_bert_block_local
    if cfg.model_type == "gpt2":
        return _VIT_PARAM_SPECS, partial(_tp_block_local, act=gelu_new,
                                         causal=True)
    if cfg.model_type == "llama":
        return _LLAMA_PARAM_SPECS, _tp_llama_block_local
    return _VIT_PARAM_SPECS, _tp_block_local


def family_tp_ep_plan(cfg: TransformerConfig):
    """Family dispatch for the tp x ep MoE composition: returns (the
    attention split table over tp, the FFN activation). The attention half
    of an MoE block splits exactly like its dense family's; the routed
    FFN splits over 'ep' (parallel/decode.py make_tp_ep_stage_fns)."""
    if not cfg.n_experts:
        raise ValueError("family_tp_ep_plan requires an MoE config "
                         "(cfg.n_experts > 0); use family_tp_plan")
    if cfg.model_type == "gpt2":
        return _VIT_PARAM_SPECS, gelu_new
    raise NotImplementedError(
        f"no tp x ep plan for MoE family {cfg.model_type!r}")


def shard_block_params(cfg: TransformerConfig, params: Dict,
                       group: ShardGroup) -> List[Dict]:
    """Megatron split of one block's params (family-dispatched)."""
    specs, _ = family_tp_plan(cfg)
    return _shard_by_specs(params, specs, group)


def make_tp_block_fn(cfg: TransformerConfig, group: ShardGroup):
    """`fn(sharded_params, xs) -> xs` running one full transformer block
    with tensor parallelism over `group`: `sharded_params` from
    `shard_block_params`, `xs` the per-shard (replicated) activations.
    Dispatches on the family."""
    _, local = family_tp_plan(cfg)

    @torch.inference_mode()
    def fn(sharded_params: Sequence[Dict], xs: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
        return local(group, sharded_params, xs, cfg)

    return fn
