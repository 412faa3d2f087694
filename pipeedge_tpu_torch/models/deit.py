"""DeiT model family: ViT's sublayer math with distillation-token embeddings.

Port of `pipeedge_tpu/models/deit.py`. The encoder block is ViT's, so this
module reuses `vit.sublayer` (with its `attn.*`/`mlp.*` tags, hence the
int8 compute path, and its stage-seam tunnel). The differences: the
embeddings prepend a CLS and a distillation token (198 tokens at 224 px),
the classifier reads the CLS token only, and the native checkpoint is the
torch-hub state dict, whose fused `attn.qkv` kernel [3D, D] is split and
transposed to [in, out] at load.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import ShardConfig
from .layers import TransformerConfig, dense, layer_norm, patchify
from .shard import FamilySpec, build_shard_params
from .vit import sublayer  # block math shared with ViT

__all__ = ["FAMILY", "load_params", "init_params", "hf_to_npz_weights",
           "random_npz_weights"]


def embed(p: Dict, pixel_values: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Patch embedding + [CLS, DIST] tokens + position embeddings.

    `pixel_values` is NCHW [B, C, H, W], as in the JAX package."""
    x = pixel_values.permute(0, 2, 3, 1)
    patches = patchify(x, cfg.patch_size)
    hidden = dense(p["patch"], patches.to(p["patch"]["w"].dtype))
    b = hidden.shape[0]
    cls = p["cls"].to(hidden.dtype).expand(b, 1, cfg.hidden_size)
    dist = p["dist"].to(hidden.dtype).expand(b, 1, cfg.hidden_size)
    hidden = torch.cat([cls, dist, hidden], dim=1)
    return hidden + p["pos"].to(hidden.dtype)


def finalize(p: Dict, hidden: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """Final layernorm; classifier head on the CLS token when present."""
    hidden = layer_norm(p["ln"], hidden, cfg.layer_norm_eps)
    if "head" in p:
        return dense(p["head"], hidden[:, 0, :])
    return hidden


FAMILY = FamilySpec(name="deit", embed=embed, sublayer=sublayer,
                    finalize=finalize, wire_subs=(1, 3))


def _a(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def load_params(cfg: TransformerConfig, shard_config: ShardConfig,
                weights: Mapping, dtype=torch.float32) -> Dict:
    """Build shard params (on the CPU) from a torch-hub DeiT npz mapping."""
    d = cfg.hidden_size

    def t(key) -> np.ndarray:
        return np.asarray(weights[key]).T

    def get_embed() -> Dict:
        kernel = np.asarray(weights["patch_embed.proj.weight"])  # [D, C, ph, pw]
        return {
            "cls": _a(weights["cls_token"], dtype),
            "dist": _a(weights["dist_token"], dtype),
            "pos": _a(weights["pos_embed"], dtype),
            "patch": {"w": _a(kernel.transpose(2, 3, 1, 0).reshape(-1, d), dtype),
                      "b": _a(weights["patch_embed.proj.bias"], dtype)},
        }

    def get_block(block_id: int, subs: tuple) -> Dict:
        root = f"blocks.{block_id}."
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = {"scale": _a(weights[root + "norm1.weight"], dtype),
                              "bias": _a(weights[root + "norm1.bias"], dtype)}
            # fused qkv [3D, D] in torch layout: split, then [in, out]
            qkv_w = np.asarray(weights[root + "attn.qkv.weight"])
            qkv_b = np.asarray(weights[root + "attn.qkv.bias"])
            for i, name in enumerate(("q", "k", "v")):
                p[name] = {"w": _a(qkv_w[i * d:(i + 1) * d, :].T, dtype),
                           "b": _a(qkv_b[i * d:(i + 1) * d], dtype)}
        if 1 in subs:
            p["attn_out"] = {"w": _a(t(root + "attn.proj.weight"), dtype),
                             "b": _a(weights[root + "attn.proj.bias"], dtype)}
        if 2 in subs:
            p["ln_after"] = {"scale": _a(weights[root + "norm2.weight"], dtype),
                             "bias": _a(weights[root + "norm2.bias"], dtype)}
            p["mlp_up"] = {"w": _a(t(root + "mlp.fc1.weight"), dtype),
                           "b": _a(weights[root + "mlp.fc1.bias"], dtype)}
        if 3 in subs:
            p["mlp_down"] = {"w": _a(t(root + "mlp.fc2.weight"), dtype),
                             "b": _a(weights[root + "mlp.fc2.bias"], dtype)}
        return p

    def get_final() -> Dict:
        p = {"ln": {"scale": _a(weights["norm.weight"], dtype),
                    "bias": _a(weights["norm.bias"], dtype)}}
        if cfg.num_labels > 0 and "head.weight" in weights:
            p["head"] = {"w": _a(t("head.weight"), dtype),
                         "b": _a(weights["head.bias"], dtype)}
        return p

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def hf_to_npz_weights(state_dict: Mapping,
                      cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """Convert an HF DeiT state dict to the torch-hub key scheme that
    `load_params` reads."""
    sd = {k.removeprefix("deit."): np.asarray(v) for k, v in state_dict.items()}
    out = {
        "cls_token": sd["embeddings.cls_token"],
        "dist_token": sd["embeddings.distillation_token"],
        "pos_embed": sd["embeddings.position_embeddings"],
        "patch_embed.proj.weight": sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias": sd["embeddings.patch_embeddings.projection.bias"],
        "norm.weight": sd["layernorm.weight"],
        "norm.bias": sd["layernorm.bias"],
    }
    if "cls_classifier.weight" in sd:
        out["head.weight"] = sd["cls_classifier.weight"]
        out["head.bias"] = sd["cls_classifier.bias"]
    for i in range(cfg.num_hidden_layers):
        hf_root = f"encoder.layer.{i}."
        attn_prefix = None
        for cand in ("attention.attention.", "attention.self."):
            if hf_root + cand + "query.weight" in sd:
                attn_prefix = hf_root + cand
                break
        root = f"blocks.{i}."
        out[root + "norm1.weight"] = sd[hf_root + "layernorm_before.weight"]
        out[root + "norm1.bias"] = sd[hf_root + "layernorm_before.bias"]
        out[root + "attn.qkv.weight"] = np.concatenate(
            [sd[attn_prefix + n + ".weight"] for n in ("query", "key", "value")], axis=0)
        out[root + "attn.qkv.bias"] = np.concatenate(
            [sd[attn_prefix + n + ".bias"] for n in ("query", "key", "value")], axis=0)
        out[root + "attn.proj.weight"] = sd[hf_root + "attention.output.dense.weight"]
        out[root + "attn.proj.bias"] = sd[hf_root + "attention.output.dense.bias"]
        out[root + "norm2.weight"] = sd[hf_root + "layernorm_after.weight"]
        out[root + "norm2.bias"] = sd[hf_root + "layernorm_after.bias"]
        out[root + "mlp.fc1.weight"] = sd[hf_root + "intermediate.dense.weight"]
        out[root + "mlp.fc1.bias"] = sd[hf_root + "intermediate.dense.bias"]
        out[root + "mlp.fc2.weight"] = sd[hf_root + "output.dense.weight"]
        out[root + "mlp.fc2.bias"] = sd[hf_root + "output.dense.bias"]
    return out


def init_params(cfg: TransformerConfig, shard_config: ShardConfig,
                seed: int = 0, dtype=torch.float32) -> Dict:
    """Random shard params with the structure of `load_params`: ViT's
    init with `seed`, then the distillation token and the 198-row position
    table from a second stream (`seed + 1`), as the JAX package draws
    them, so one seed gives identical weights in both packages."""
    from .vit import init_params as vit_init
    rng = np.random.default_rng(seed + 1)
    params = vit_init(cfg, shard_config, seed=seed, dtype=dtype)
    if shard_config.is_first:
        d = cfg.hidden_size
        params["embeddings"]["dist"] = torch.from_numpy(
            rng.normal(0, 0.02, size=(1, 1, d))).to(dtype)
        params["embeddings"]["pos"] = torch.from_numpy(
            rng.normal(0, 0.02, size=(1, cfg.num_patches + 2, d))).to(dtype)
    return params


def random_npz_weights(cfg: TransformerConfig,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """The whole model's `init_params(seed)` weights under the torch-hub
    keys (qkv fused, kernels [out, in]), so every shard of every partition
    loads the same weights and a pipeline can be held against the
    single-shard forward."""
    n = cfg.num_hidden_layers * 4
    p = init_params(cfg, ShardConfig(1, n, is_first=True, is_last=True),
                    seed=seed)

    def a(x):
        return x.numpy().astype(np.float32)

    emb, final = p["embeddings"], p["final"]
    d = cfg.hidden_size
    w = emb["patch"]["w"].numpy().reshape(cfg.patch_size, cfg.patch_size,
                                          cfg.num_channels, d)
    out = {"cls_token": a(emb["cls"]), "dist_token": a(emb["dist"]),
           "pos_embed": a(emb["pos"]),
           "patch_embed.proj.weight": w.transpose(3, 2, 0, 1).astype(np.float32),
           "patch_embed.proj.bias": a(emb["patch"]["b"]),
           "norm.weight": a(final["ln"]["scale"]),
           "norm.bias": a(final["ln"]["bias"])}
    if "head" in final:
        out["head.weight"] = a(final["head"]["w"].T)
        out["head.bias"] = a(final["head"]["b"])
    for i, blk in enumerate(p["blocks"]):
        root = f"blocks.{i}."
        out[root + "norm1.weight"] = a(blk["ln_before"]["scale"])
        out[root + "norm1.bias"] = a(blk["ln_before"]["bias"])
        out[root + "attn.qkv.weight"] = np.concatenate(
            [a(blk[n]["w"].T) for n in ("q", "k", "v")], axis=0)
        out[root + "attn.qkv.bias"] = np.concatenate(
            [a(blk[n]["b"]) for n in ("q", "k", "v")], axis=0)
        for key, name in (("attn.proj", "attn_out"), ("mlp.fc1", "mlp_up"),
                          ("mlp.fc2", "mlp_down")):
            out[root + key + ".weight"] = a(blk[name]["w"].T)
            out[root + key + ".bias"] = a(blk[name]["b"])
        out[root + "norm2.weight"] = a(blk["ln_after"]["scale"])
        out[root + "norm2.bias"] = a(blk["ln_after"]["bias"])
    return out
