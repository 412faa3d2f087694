"""Model registry and shard factories.

Port of `pipeedge_tpu/models/registry.py`: the ViT, BERT, DeiT and
dense GPT-2 entries (the families the port carries so far), in the JAX
registry's order. Layer counts are in
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
from . import vit as vit_mod
from .layers import TransformerConfig
from .shard import params_to, shard_apply

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    layers: int                  # sublayer count = 4 * blocks
    weights_file: str            # default npz filename (reference format)
    family: object               # module: vit_mod | bert_mod | deit_mod | gpt2_mod
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
          vocab=50257, max_pos=1024):
    return ModelEntry(name, layers, weights, gpt2_mod, TransformerConfig(
        model_type="gpt2", hidden_size=hidden, num_hidden_layers=blocks,
        num_attention_heads=heads, intermediate_size=inter,
        layer_norm_eps=1e-5, vocab_size=vocab,
        max_position_embeddings=max_pos))


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
    # causal decoders (dense FFN; the switch-MoE entries wait for
    # parallel/expert.py)
    _gpt2("gpt2", 48, "GPT2.npz", 768, 12, 12, 3072),
    _gpt2("gpt2-medium", 96, "GPT2-M.npz", 1024, 24, 16, 4096),
    # tiny synthetic models for fast tests
    _vit("pipeedge/test-tiny-vit", 8, "test-tiny-vit.npz", 32, 2, 4, 64, 5,
         patch=4, img=16),
    _bert("pipeedge/test-tiny-bert", 8, "test-tiny-bert.npz", 32, 2, 4, 64, 2),
    _gpt2("pipeedge/test-tiny-gpt2", 8, "test-tiny-gpt2.npz", 32, 2, 4, 64,
          vocab=100, max_pos=64),
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
