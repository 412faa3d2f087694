"""Model registry and shard factories.

Port of `pipeedge_tpu/models/registry.py`: every entry of the JAX
registry (ViT, BERT, DeiT, GPT-2 dense and switch-MoE, Llama-2/-3 and
Mistral), in its order, with its hyperparameters. Layer counts are in
sublayers, 4 per transformer block; configs are local constants, so
nothing is fetched.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from . import ShardConfig
from . import bert as bert_mod
from . import deit as deit_mod
from . import gpt2 as gpt2_mod
from . import llama as llama_mod
from . import vit as vit_mod
from .layers import TransformerConfig
from .shard import params_to, shard_apply

logger = logging.getLogger(__name__)

# the model types with KV-cache decoding (`parallel/decode.py`): what the
# generate and serve entries take, as `tools/generate.py` does
DECODER_TYPES = ("gpt2", "llama")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    layers: int                  # sublayer count = 4 * blocks
    weights_file: str            # default npz filename (reference format)
    family: object               # module: vit/bert/deit/gpt2/llama_mod
    config: TransformerConfig


def _vit(name, layers, weights, hidden, blocks, heads, inter, labels,
         patch=16, img=224):
    return ModelEntry(name, layers, weights, vit_mod, TransformerConfig(
        model_type="vit", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, intermediate_size=inter, num_labels=labels,
        image_size=img, patch_size=patch))


def _bert(name, layers, weights, hidden, blocks, heads, inter, labels):
    return ModelEntry(name, layers, weights, bert_mod, TransformerConfig(
        model_type="bert", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, intermediate_size=inter, num_labels=labels,
        vocab_size=30522, max_position_embeddings=512))


def _deit(name, layers, weights, hidden, blocks, heads, inter):
    return ModelEntry(name, layers, weights, deit_mod, TransformerConfig(
        model_type="deit", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, intermediate_size=inter, num_labels=1000))


def _gpt2(name, layers, weights, hidden, blocks, heads, inter,
          vocab=50257, max_pos=1024, n_experts=0, capacity_factor=1.25):
    return ModelEntry(name, layers, weights, gpt2_mod, TransformerConfig(
        model_type="gpt2", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, intermediate_size=inter,
        layer_norm_eps=1e-5, vocab_size=vocab,
        max_position_embeddings=max_pos, n_experts=n_experts,
        capacity_factor=capacity_factor))


def _llama(name, layers, weights, hidden, blocks, heads, kv_heads, inter,
           vocab, max_pos, theta=10000.0, window=0):
    return ModelEntry(name, layers, weights, llama_mod, TransformerConfig(
        model_type="llama", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, num_kv_heads=kv_heads,
        intermediate_size=inter, layer_norm_eps=1e-5, vocab_size=vocab,
        max_position_embeddings=max_pos, rope_theta=theta,
        sliding_window=window))


_MODELS: Dict[str, ModelEntry] = {e.name: e for e in [
    _vit("google/vit-base-patch16-224", 48, "ViT-B_16-224.npz", 768, 12, 12, 3072, 1000),
    _vit("google/vit-large-patch16-224", 96, "ViT-L_16-224.npz", 1024, 24, 16, 4096, 1000),
    _vit("google/vit-huge-patch14-224-in21k", 128, "ViT-H_14.npz", 1280, 32, 16, 5120,
         21843, patch=14),
    _bert("bert-base-uncased", 48, "BERT-B.npz", 768, 12, 12, 3072, 0),
    _bert("bert-large-uncased", 96, "BERT-L.npz", 1024, 24, 16, 4096, 0),
    _bert("textattack/bert-base-uncased-CoLA", 48, "BERT-B-CoLA.npz", 768, 12, 12, 3072, 2),
    _deit("facebook/deit-base-distilled-patch16-224", 48, "DeiT_B_distilled.npz",
          768, 12, 12, 3072),
    _deit("facebook/deit-small-distilled-patch16-224", 48, "DeiT_S_distilled.npz",
          384, 12, 6, 1536),
    _deit("facebook/deit-tiny-distilled-patch16-224", 48, "DeiT_T_distilled.npz",
          192, 12, 3, 768),
    # causal decoders
    _gpt2("gpt2", 48, "GPT2.npz", 768, 12, 12, 3072),
    _gpt2("gpt2-medium", 96, "GPT2-M.npz", 1024, 24, 16, 4096),
    # synthetic switch-MoE decoder (top-1 routed FFN, 8 experts per block)
    _gpt2("pipeedge/gpt2-moe-8e", 48, "GPT2-MoE-8E.npz", 768, 12, 12, 3072,
          n_experts=8),
    # the llama family: RoPE / RMSNorm / SwiGLU / grouped-query attention
    _llama("meta-llama/Llama-2-7b-hf", 128, "Llama-2-7B.npz", 4096, 32, 32,
           32, 11008, vocab=32000, max_pos=4096),
    _llama("meta-llama/Meta-Llama-3-8B", 128, "Llama-3-8B.npz", 4096, 32,
           32, 8, 14336, vocab=128256, max_pos=8192, theta=500000.0),
    # Mistral: the llama block with a sliding window (the same HF
    # state-dict layout; the window is a mask, not a weight)
    _llama("mistralai/Mistral-7B-v0.1", 128, "Mistral-7B.npz", 4096, 32,
           32, 8, 14336, vocab=32000, max_pos=32768, window=4096),
    # tiny synthetic models for fast tests
    _vit("pipeedge/test-tiny-vit", 8, "test-tiny-vit.npz", 32, 2, 4, 64, 5,
         patch=4, img=16),
    _bert("pipeedge/test-tiny-bert", 8, "test-tiny-bert.npz", 32, 2, 4, 64, 2),
    _gpt2("pipeedge/test-tiny-gpt2", 8, "test-tiny-gpt2.npz", 32, 2, 4, 64,
          vocab=100, max_pos=64),
    _llama("pipeedge/test-tiny-llama", 8, "test-tiny-llama.npz", 32, 2, 4,
           2, 64, vocab=100, max_pos=64),
    _llama("pipeedge/test-tiny-mistral", 8, "test-tiny-mistral.npz", 32, 2,
           4, 2, 64, vocab=100, max_pos=64, window=4),
    # capacity_factor = n_experts: no capacity drops, so routing is a
    # per-token gate and cached decode equals the full forward
    _gpt2("pipeedge/test-tiny-moe", 8, "test-tiny-moe.npz", 32, 2, 4, 64,
          vocab=100, max_pos=64, n_experts=4, capacity_factor=4.0),
]}


def get_model_names() -> List[str]:
    return list(_MODELS.keys())


def get_model_entry(model_name: str) -> ModelEntry:
    return _MODELS[model_name]


def get_model_layers(model_name: str) -> int:
    """Total sublayer count."""
    return _MODELS[model_name].layers


def get_model_config(model_name: str) -> TransformerConfig:
    return _MODELS[model_name].config


def make_shard_config(model_name: str, layer_start: int, layer_end: int) -> ShardConfig:
    """is_first/is_last derived from the global layer range."""
    return ShardConfig(layer_start=layer_start, layer_end=layer_end,
                       is_first=layer_start == 1,
                       is_last=layer_end == get_model_layers(model_name))


def module_shard_factory(model_name: str, model_file: Optional[str],
                         layer_start: int, layer_end: int, stage: int = 0,
                         dtype=torch.float32, device: DeviceLike = None,
                         params: Optional[Dict] = None) \
        -> Tuple[Callable, Dict, ShardConfig]:
    """Build one pipeline stage: (shard fn, params on `device`, config).

    `params` supplies a ready parameter dict and skips weight loading.
    Otherwise a missing weights file falls back to deterministic random
    initialization (the JAX package's seed-0 stream, drawn per shard), with
    a warning, since the outputs are then not pretrained."""
    dev = resolve_device(device)
    entry = _MODELS[model_name]
    if model_file is None:
        model_file = entry.weights_file
    shard_config = make_shard_config(model_name, layer_start, layer_end)
    if params is None:
        if model_file and os.path.exists(model_file):
            with np.load(model_file) as weights:
                params = entry.family.load_params(entry.config, shard_config,
                                                  weights, dtype=dtype)
        else:
            logger.warning("weights file %r not found for %s; using random "
                           "init", model_file, model_name)
            params = entry.family.init_params(entry.config, shard_config,
                                              dtype=dtype)
    params = params_to(params, device=dev, dtype=dtype)
    fn = functools.partial(shard_apply, entry.family.FAMILY, entry.config,
                           shard_config)
    logger.info("======= %s stage %d: layers [%d, %d] on %s =======",
                model_name, stage, layer_start, layer_end, dev)
    return fn, params, shard_config
