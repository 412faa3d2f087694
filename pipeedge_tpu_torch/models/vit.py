"""ViT model family: shards with the 4-way sublayer split.

Port of `pipeedge_tpu/models/vit.py`. Sublayer semantics (reference
`ViTLayerShard.forward`):
  sub 0: ln_before -> self-attention         payload becomes (ctx, residual)
  sub 1: output dense + residual add         payload becomes hidden
  sub 2: ln_after -> MLP-up + GeLU           payload becomes (mlp_h, residual)
  sub 3: MLP-down + residual add             payload becomes hidden
The first shard prepends patch + CLS + position embeddings; the last
applies the final layernorm and the classifier head on the CLS token.

Stage-seam tunnel: subs 1 and 3 lead with a dense, so when a stage
boundary lands there the payload's leading tensor may arrive as an 8-bit
wire `QuantizedTensor` (parallel/pipeline.py leaves it encoded under the
`QuantizeCompute` tunnel); it feeds the int8 matmul directly through
`wire_dense`, with no decode.

Weights: Google's ViT `.npz` key scheme (what `save_model_weights.py`
writes), kernels stored [in, out].
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.int8_matmul import wire_dense
from ..ops.quant import QuantizedTensor
from . import ShardConfig
from .layers import TransformerConfig, dense, gelu, layer_norm, patchify, self_attention
from .shard import FamilySpec, build_shard_params

def embed(p: Dict, pixel_values: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Patch embedding (as one matmul) + CLS token + position embeddings.

    `pixel_values` is NCHW [B, C, H, W], as in the JAX package."""
    x = pixel_values.permute(0, 2, 3, 1)
    patches = patchify(x, cfg.patch_size)
    hidden = dense(p["patch"], patches.to(p["patch"]["w"].dtype))
    cls = p["cls"].to(hidden.dtype).expand(hidden.shape[0], 1,
                                           cfg.hidden_size)
    hidden = torch.cat([cls, hidden], dim=1)
    return hidden + p["pos"].to(hidden.dtype)


def sublayer(p: Dict, sub: int, data, cfg: TransformerConfig):
    """One of the 4 schedulable sublayers."""
    if sub == 0:
        normed = layer_norm(p["ln_before"], data, cfg.layer_norm_eps)
        ctx = self_attention({"q": p["q"], "k": p["k"], "v": p["v"]},
                             normed, cfg.num_attention_heads,
                             tag_prefix="attn")
        return (ctx, data)
    if sub == 1:
        ctx, skip = data
        if isinstance(ctx, QuantizedTensor):
            return wire_dense(p["attn_out"], ctx, out_dtype=skip.dtype) + skip
        return dense(p["attn_out"], ctx, tag="attn.out") + skip
    if sub == 2:
        normed = layer_norm(p["ln_after"], data, cfg.layer_norm_eps)
        return (gelu(dense(p["mlp_up"], normed, tag="mlp.up")), data)
    if sub == 3:
        mlp_h, skip = data
        if isinstance(mlp_h, QuantizedTensor):
            return wire_dense(p["mlp_down"], mlp_h, out_dtype=skip.dtype) + skip
        return dense(p["mlp_down"], mlp_h, tag="mlp.down") + skip
    raise ValueError(f"sublayer must be 0..3, got {sub}")


def finalize(p: Dict, hidden: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """Final layernorm; classifier head on the CLS token when present."""
    hidden = layer_norm(p["ln"], hidden, cfg.layer_norm_eps)
    if "head" in p:
        return dense(p["head"], hidden[:, 0, :])
    return hidden


FAMILY = FamilySpec(name="vit", embed=embed, sublayer=sublayer,
                    finalize=finalize, wire_subs=(1, 3))


# --- weight loading -------------------------------------------------------

def _a(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _google_block_getter(weights: Mapping, cfg: TransformerConfig, dtype):
    """Per-block params from Google ViT npz keys."""
    d = cfg.hidden_size

    def get_block(block_id: int, subs: tuple) -> Dict:
        root = f"Transformer/encoderblock_{block_id}/"
        attn = root + "MultiHeadDotProductAttention_1/"
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = {"scale": _a(weights[root + "LayerNorm_0/scale"], dtype),
                              "bias": _a(weights[root + "LayerNorm_0/bias"], dtype)}
            for name, key in (("q", "query"), ("k", "key"), ("v", "value")):
                p[name] = {"w": _a(weights[attn + key + "/kernel"], dtype).reshape(d, d),
                           "b": _a(weights[attn + key + "/bias"], dtype).reshape(-1)}
        if 1 in subs:
            p["attn_out"] = {"w": _a(weights[attn + "out/kernel"], dtype).reshape(d, d),
                             "b": _a(weights[attn + "out/bias"], dtype).reshape(-1)}
        if 2 in subs:
            p["ln_after"] = {"scale": _a(weights[root + "LayerNorm_2/scale"], dtype),
                             "bias": _a(weights[root + "LayerNorm_2/bias"], dtype)}
            p["mlp_up"] = {"w": _a(weights[root + "MlpBlock_3/Dense_0/kernel"], dtype),
                           "b": _a(weights[root + "MlpBlock_3/Dense_0/bias"], dtype)}
        if 3 in subs:
            p["mlp_down"] = {"w": _a(weights[root + "MlpBlock_3/Dense_1/kernel"], dtype),
                             "b": _a(weights[root + "MlpBlock_3/Dense_1/bias"], dtype)}
        return p

    return get_block


def load_params(cfg: TransformerConfig, shard_config: ShardConfig,
                weights: Mapping, dtype=torch.float32) -> Dict:
    """Build shard params (on the CPU) from a Google-format npz mapping."""

    def get_embed() -> Dict:
        kernel = np.asarray(weights["embedding/kernel"])  # [ph, pw, C, D]
        return {
            "cls": _a(weights["cls"], dtype),
            "pos": _a(weights["Transformer/posembed_input/pos_embedding"], dtype),
            "patch": {"w": _a(kernel.reshape(-1, kernel.shape[-1]), dtype),
                      "b": _a(weights["embedding/bias"], dtype)},
        }

    def get_final() -> Dict:
        p = {"ln": {"scale": _a(weights["Transformer/encoder_norm/scale"], dtype),
                    "bias": _a(weights["Transformer/encoder_norm/bias"], dtype)}}
        if cfg.num_labels > 0 and "head/kernel" in weights:
            p["head"] = {"w": _a(weights["head/kernel"], dtype),
                         "b": _a(weights["head/bias"], dtype)}
        return p

    return build_shard_params(shard_config, get_embed,
                              _google_block_getter(weights, cfg, dtype), get_final)


# --- random weights (benchmarks / tests without checkpoints) --------------

def init_params(cfg: TransformerConfig, shard_config: ShardConfig,
                seed: int = 0, dtype=torch.float32) -> Dict:
    """Random shard params with the structure of `load_params`.

    Draws exactly the numpy stream of the JAX package's `vit.init_params`,
    so one seed gives identical weights in both packages."""
    rng = np.random.default_rng(seed)

    def mat(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, size=shape)).to(dtype)

    def vec(n):
        return torch.zeros((n,), dtype=dtype)

    def ln():
        return {"scale": torch.ones((cfg.hidden_size,), dtype=dtype),
                "bias": vec(cfg.hidden_size)}

    d, it = cfg.hidden_size, cfg.intermediate_size

    def get_block(block_id: int, subs: tuple) -> Dict:
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = ln()
            for name in ("q", "k", "v"):
                p[name] = {"w": mat(d, d), "b": vec(d)}
        if 1 in subs:
            p["attn_out"] = {"w": mat(d, d), "b": vec(d)}
        if 2 in subs:
            p["ln_after"] = ln()
            p["mlp_up"] = {"w": mat(d, it), "b": vec(it)}
        if 3 in subs:
            p["mlp_down"] = {"w": mat(it, d), "b": vec(d)}
        return p

    def get_embed() -> Dict:
        n_patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels
        return {"cls": mat(1, 1, d), "pos": mat(1, cfg.num_patches + 1, d),
                "patch": {"w": mat(n_patch_in, d), "b": vec(d)}}

    def get_final() -> Dict:
        p = {"ln": ln()}
        if cfg.num_labels > 0:
            p["head"] = {"w": mat(d, cfg.num_labels), "b": vec(cfg.num_labels)}
        return p

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def random_npz_weights(cfg: TransformerConfig,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """A whole model's seeded random weights under the Google npz keys.

    Unlike `init_params`, which draws each shard's weights from a fresh
    stream, this gives every shard of every partition the same weights
    (through `load_params` or `np.savez` + `--model-file`), so a pipeline
    can be held against the single-shard forward. Biases and norm
    parameters are random too, so their code paths are exercised."""
    rng = np.random.default_rng(seed)
    d, it, nh = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    hd = d // nh

    def r(*shape, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(shape, dtype=np.float32)
                ).astype(np.float32)

    p, c = cfg.patch_size, cfg.num_channels
    out = {"cls": r(1, 1, d),
           "Transformer/posembed_input/pos_embedding": r(1, cfg.num_patches + 1, d),
           "embedding/kernel": r(p, p, c, d), "embedding/bias": r(d),
           "Transformer/encoder_norm/scale": r(d, mean=1.0),
           "Transformer/encoder_norm/bias": r(d)}
    if cfg.num_labels > 0:
        out["head/kernel"] = r(d, cfg.num_labels)
        out["head/bias"] = r(cfg.num_labels)
    for i in range(cfg.num_hidden_layers):
        root = f"Transformer/encoderblock_{i}/"
        mha = root + "MultiHeadDotProductAttention_1/"
        out[root + "LayerNorm_0/scale"] = r(d, mean=1.0)
        out[root + "LayerNorm_0/bias"] = r(d)
        for name in ("query", "key", "value"):
            out[mha + name + "/kernel"] = r(d, nh, hd)
            out[mha + name + "/bias"] = r(nh, hd)
        out[mha + "out/kernel"] = r(nh, hd, d)
        out[mha + "out/bias"] = r(d)
        out[root + "LayerNorm_2/scale"] = r(d, mean=1.0)
        out[root + "LayerNorm_2/bias"] = r(d)
        out[root + "MlpBlock_3/Dense_0/kernel"] = r(d, it)
        out[root + "MlpBlock_3/Dense_0/bias"] = r(it)
        out[root + "MlpBlock_3/Dense_1/kernel"] = r(it, d)
        out[root + "MlpBlock_3/Dense_1/bias"] = r(d)
    return out
