"""BERT model family: shards with the 4-way sublayer split.

Port of `pipeedge_tpu/models/bert.py`. BERT is post-LN, so the split
differs from ViT's:
  sub 0: self-attention (no pre-norm)     payload becomes (ctx, residual)
  sub 1: output dense + residual, then LN payload becomes hidden
  sub 2: MLP-up + GeLU                    payload becomes (mlp_h, residual)
  sub 3: MLP-down + residual, then LN     payload becomes hidden
The first shard sums word, position and token-type embeddings and
normalizes them; the last applies a tanh pooler to the CLS token, then the
classifier head when the model has labels.

The self-attention is unmasked, as in the JAX package, so it goes through
`ops.attention.fused_attention` at every sequence length. The denses are
untagged there, so they stay exact under `QuantizeCompute` and no stage
seam tunnels (`wire_subs` is empty).

Weights: the HF `BertModel` state-dict npz, with or without the `bert.`
prefix that classification checkpoints carry (with `classifier.*`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import ShardConfig
from ..ops.attention import fused_attention
from .layers import TransformerConfig, dense, gelu, layer_norm, qkv_heads
from .shard import FamilySpec, build_shard_params, sp_block_apply

__all__ = ["FAMILY", "load_params", "init_params", "random_npz_weights"]


def embed(p: Dict, input_ids: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Word + position [0, S) + token type 0 embeddings, then LayerNorm.

    `input_ids` is an integer tensor [B, S] (int32 or int64)."""
    seq_len = input_ids.shape[1]
    word = F.embedding(input_ids, p["word"])
    pos = p["pos"][:seq_len][None, :, :]
    ttype = p["type"][0][None, None, :]
    return layer_norm(p["ln"], word + pos + ttype, cfg.layer_norm_eps)


def project(p: Dict, x: torch.Tensor, cfg: TransformerConfig):
    """Sublayer 0 up to its attention core: q, k, v heads of the raw x."""
    return qkv_heads(p, x, cfg.num_attention_heads)


def sublayer(p: Dict, sub: int, data, cfg: TransformerConfig):
    """One of the 4 schedulable sublayers."""
    if sub == 0:
        ctx = fused_attention(*project(p, data, cfg))
        return (ctx.reshape(data.shape), data)
    if sub == 1:
        ctx, skip = data
        return layer_norm(p["attn_ln"], dense(p["attn_out"], ctx) + skip,
                          cfg.layer_norm_eps)
    if sub == 2:
        return (gelu(dense(p["mlp_up"], data)), data)
    if sub == 3:
        mlp_h, skip = data
        return layer_norm(p["out_ln"], dense(p["mlp_down"], mlp_h) + skip,
                          cfg.layer_norm_eps)
    raise ValueError(f"sublayer must be 0..3, got {sub}")


def finalize(p: Dict, hidden: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """Tanh pooler on the CLS token; classifier head when present."""
    pooled = torch.tanh(dense(p["pooler"], hidden[:, 0, :]))
    if "head" in p:
        return dense(p["head"], pooled)
    return pooled


def sp_block_step(ps, xs, cfg: TransformerConfig, group, core):
    """One block over the sp shards' sequence chunks (`sp_block_apply`)."""
    return sp_block_apply(sublayer, ps, xs, cfg, group, core,
                          lambda i, p, x: project(p, x, cfg))


FAMILY = FamilySpec(name="bert", embed=embed, sublayer=sublayer,
                    finalize=finalize, sp_block_step=sp_block_step)


def _a(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def load_params(cfg: TransformerConfig, shard_config: ShardConfig,
                weights: Mapping, dtype=torch.float32) -> Dict:
    """Build shard params (on the CPU) from an HF state-dict npz mapping,
    bare `BertModel` keys or `bert.`-prefixed ones with `classifier.*`."""
    if any(k.startswith("bert.") for k in weights.keys()):
        sd = {k.removeprefix("bert."): weights[k] for k in weights.keys()
              if k.startswith("bert.")}
        classifier = {k: weights[k] for k in weights.keys()
                      if k.startswith("classifier.")}
    else:
        sd = classifier = weights

    def w(key) -> torch.Tensor:   # torch [out, in] -> [in, out]
        return _a(np.asarray(sd[key]).T, dtype)

    def ln(prefix) -> Dict:
        return {"scale": _a(sd[prefix + ".weight"], dtype),
                "bias": _a(sd[prefix + ".bias"], dtype)}

    def get_embed() -> Dict:
        return {
            "word": _a(sd["embeddings.word_embeddings.weight"], dtype),
            "pos": _a(sd["embeddings.position_embeddings.weight"], dtype),
            "type": _a(sd["embeddings.token_type_embeddings.weight"], dtype),
            "ln": ln("embeddings.LayerNorm"),
        }

    def get_block(block_id: int, subs: tuple) -> Dict:
        root = f"encoder.layer.{block_id}."
        p: Dict = {}
        if 0 in subs:
            for name, key in (("q", "query"), ("k", "key"), ("v", "value")):
                p[name] = {"w": w(root + f"attention.self.{key}.weight"),
                           "b": _a(sd[root + f"attention.self.{key}.bias"], dtype)}
        if 1 in subs:
            p["attn_out"] = {"w": w(root + "attention.output.dense.weight"),
                             "b": _a(sd[root + "attention.output.dense.bias"], dtype)}
            p["attn_ln"] = ln(root + "attention.output.LayerNorm")
        if 2 in subs:
            p["mlp_up"] = {"w": w(root + "intermediate.dense.weight"),
                           "b": _a(sd[root + "intermediate.dense.bias"], dtype)}
        if 3 in subs:
            p["mlp_down"] = {"w": w(root + "output.dense.weight"),
                             "b": _a(sd[root + "output.dense.bias"], dtype)}
            p["out_ln"] = ln(root + "output.LayerNorm")
        return p

    def get_final() -> Dict:
        p = {"pooler": {"w": w("pooler.dense.weight"),
                        "b": _a(sd["pooler.dense.bias"], dtype)}}
        if cfg.num_labels > 0 and "classifier.weight" in classifier:
            p["head"] = {"w": _a(np.asarray(classifier["classifier.weight"]).T, dtype),
                         "b": _a(classifier["classifier.bias"], dtype)}
        return p

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def init_params(cfg: TransformerConfig, shard_config: ShardConfig,
                seed: int = 0, dtype=torch.float32) -> Dict:
    """Random shard params with the structure of `load_params`; draws the
    JAX package's numpy stream, so one seed gives identical weights in
    both packages."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size

    def mat(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, size=shape)).to(dtype)

    def vec(n):
        return torch.zeros((n,), dtype=dtype)

    def ln():
        return {"scale": torch.ones((d,), dtype=dtype), "bias": vec(d)}

    def get_embed() -> Dict:
        return {"word": mat(cfg.vocab_size, d),
                "pos": mat(cfg.max_position_embeddings, d),
                "type": mat(cfg.type_vocab_size, d), "ln": ln()}

    def get_block(block_id: int, subs: tuple) -> Dict:
        p: Dict = {}
        if 0 in subs:
            for name in ("q", "k", "v"):
                p[name] = {"w": mat(d, d), "b": vec(d)}
        if 1 in subs:
            p["attn_out"] = {"w": mat(d, d), "b": vec(d)}
            p["attn_ln"] = ln()
        if 2 in subs:
            p["mlp_up"] = {"w": mat(d, it), "b": vec(it)}
        if 3 in subs:
            p["mlp_down"] = {"w": mat(it, d), "b": vec(d)}
            p["out_ln"] = ln()
        return p

    def get_final() -> Dict:
        p = {"pooler": {"w": mat(d, d), "b": vec(d)}}
        if cfg.num_labels > 0:
            p["head"] = {"w": mat(d, cfg.num_labels), "b": vec(cfg.num_labels)}
        return p

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def random_npz_weights(cfg: TransformerConfig,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """The whole model's `init_params(seed)` weights under the HF keys of
    a classification checkpoint (`bert.`-prefixed, `classifier.*`), so
    every shard of every partition loads the same weights and a pipeline
    can be held against the single-shard forward."""
    n = cfg.num_hidden_layers * 4
    p = init_params(cfg, ShardConfig(1, n, is_first=True, is_last=True),
                    seed=seed)

    def a(x):
        return x.numpy().astype(np.float32)

    out: Dict[str, np.ndarray] = {}

    def put(prefix, dense_p):   # [in, out] -> torch [out, in]
        out[prefix + ".weight"] = a(dense_p["w"].T)
        out[prefix + ".bias"] = a(dense_p["b"])

    def put_ln(prefix, ln_p):
        out[prefix + ".weight"] = a(ln_p["scale"])
        out[prefix + ".bias"] = a(ln_p["bias"])

    emb = p["embeddings"]
    out["bert.embeddings.word_embeddings.weight"] = a(emb["word"])
    out["bert.embeddings.position_embeddings.weight"] = a(emb["pos"])
    out["bert.embeddings.token_type_embeddings.weight"] = a(emb["type"])
    put_ln("bert.embeddings.LayerNorm", emb["ln"])
    for i, blk in enumerate(p["blocks"]):
        root = f"bert.encoder.layer.{i}."
        for name, key in (("q", "query"), ("k", "key"), ("v", "value")):
            put(root + f"attention.self.{key}", blk[name])
        put(root + "attention.output.dense", blk["attn_out"])
        put_ln(root + "attention.output.LayerNorm", blk["attn_ln"])
        put(root + "intermediate.dense", blk["mlp_up"])
        put(root + "output.dense", blk["mlp_down"])
        put_ln(root + "output.LayerNorm", blk["out_ln"])
    put("bert.pooler.dense", p["final"]["pooler"])
    if "head" in p["final"]:
        put("classifier", p["final"]["head"])
    return out
