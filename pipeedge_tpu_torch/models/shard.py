"""Generic shard execution shared by the model families.

Port of `pipeedge_tpu/models/shard.py`. A shard executes as

    embeddings? -> partial head block -> full blocks -> partial tail block
                -> final norm/classifier?

The full blocks are a list of per-block parameter dicts run in a Python
loop (PyTorch runs eagerly; `lax.scan` has no counterpart here). Partial
blocks at the shard edges exist because PipeEdge partitions at sublayer
granularity.

A model family plugs in three functions via `FamilySpec`:
  embed(embed_params, raw_input, cfg)        -> hidden [B, S, D]
  sublayer(block_params, sub, payload, cfg)  -> payload (tensor or 2-tuple)
  finalize(final_params, hidden, cfg)        -> model output
and, for KV-cache decoding (`parallel/decode.py`), optional hooks that
replace the GPT-2-shaped defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from . import BlockSlice, ShardConfig, plan_shard
from .layers import TransformerConfig

ShardData = Any  # torch.Tensor | tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """The functions that define a model family. The optional decode
    hooks plug a decoder into `parallel/decode.py`: `cached_block_step`
    replaces the GPT-2-shaped block step, `decode_embed` and `span_embed`
    the wte + wpe embeddings of one token and of a K-token span. The
    tensor- and sequence-parallel hooks of the JAX spec wait for ROADMAP
    A7."""
    name: str
    embed: Callable[[Dict, Any, TransformerConfig], torch.Tensor]
    sublayer: Callable[[Dict, int, ShardData, TransformerConfig], ShardData]
    finalize: Callable[[Dict, torch.Tensor, TransformerConfig], torch.Tensor]
    # (p, x, bcache, pos, cfg, prefill, read_len=None) -> x, the cache
    # slice written in place
    cached_block_step: Any = None
    decode_embed: Any = None         # (embed_params, tok, pos) -> [B, 1, D]
    span_embed: Any = None           # (embed_params, tok [B,K], pos) ->
    #                                  [B, K, D] (speculative verify span)
    # attention reads absolute positions (RoPE): chunk-local attention
    # overrides (sequence-parallel cores) would rotate at wrong offsets
    position_dependent_attention: bool = False
    # sublayers that LEAD with a dense and accept an 8-bit wire
    # `QuantizedTensor` as the payload's first tensor (the int8
    # stage-seam tunnel, parallel/pipeline.py + ops/int8_matmul.py)
    wire_subs: tuple = ()


def _apply_slice(family: FamilySpec, block_params: Dict, data: ShardData,
                 blk: BlockSlice, cfg: TransformerConfig) -> ShardData:
    for sub in blk.sublayers():
        data = family.sublayer(block_params, sub, data, cfg)
    return data


@torch.inference_mode()
def shard_apply(family: FamilySpec, cfg: TransformerConfig,
                shard_config: ShardConfig, params: Dict,
                data: ShardData) -> ShardData:
    """Apply one layer-range shard to a payload."""
    plan = plan_shard(shard_config)
    if shard_config.is_first:
        data = family.embed(params["embeddings"], data, cfg)
    if plan.head is not None:
        data = _apply_slice(family, params["head"], data, plan.head, cfg)
    full = BlockSlice(0, 0, 3)
    for block_params in params.get("blocks", ()):
        data = _apply_slice(family, block_params, data, full, cfg)
    if plan.tail is not None:
        data = _apply_slice(family, params["tail"], data, plan.tail, cfg)
    if shard_config.is_last:
        data = family.finalize(params["final"], data, cfg)
    return data


def build_shard_params(shard_config: ShardConfig,
                       get_embed: Callable[[], Dict],
                       get_block: Callable[[int, tuple], Dict],
                       get_final: Callable[[], Dict]) -> Dict:
    """Assemble a shard's parameter dict from per-component getters.

    `get_block(block_id, sublayers)` returns only the parameters the listed
    sublayers need, so a shard never materializes weights outside its
    layer range. The getters are called in the JAX package's order (embed,
    head, full blocks, tail, final), which keeps a seeded random init's
    numpy stream identical across the two packages.
    """
    plan = plan_shard(shard_config)
    params: Dict = {}
    if shard_config.is_first:
        params["embeddings"] = get_embed()
    if plan.head is not None:
        params["head"] = get_block(plan.head.block_id,
                                   tuple(plan.head.sublayers()))
    if plan.full_ids:
        params["blocks"] = [get_block(b, (0, 1, 2, 3)) for b in plan.full_ids]
    if plan.tail is not None:
        params["tail"] = get_block(plan.tail.block_id,
                                   tuple(plan.tail.sublayers()))
    if shard_config.is_last:
        params["final"] = get_final()
    return params


def params_to(params, device=None, dtype=None):
    """Move (and cast floating) tensors of a nested params structure."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device, dtype) for v in params]
    cast = dtype if dtype is not None and params.is_floating_point() else None
    return params.to(device=device, dtype=cast)
