"""GPT-2 model family: causal-decoder shards with the 4-way sublayer split.

Port of `pipeedge_tpu/models/gpt2.py`. A GPT-2 block is pre-LN like
ViT's, so the sublayer cut points carry over:
  sub 0: ln_1 -> causal self-attention       payload becomes (ctx, residual)
  sub 1: attn output proj + residual         payload becomes hidden
  sub 2: ln_2 -> MLP-up + GeLU(tanh)         payload becomes (mlp_h, residual)
  sub 3: MLP-down + residual                 payload becomes hidden
First shard: token + learned position embeddings. Last shard: final
LayerNorm + LM head -> per-token vocab logits [B, S, V].

The switch-MoE variant (`cfg.n_experts > 0`) keeps the whole routed FFN
in sublayer 2 (`parallel/expert.py moe_ffn_delta`: capacity routing
cannot span a pipeline cut), whose edge carries (delta, residual);
sublayer 3 is the parameter-free residual add.

Parameters reuse the ViT sublayer names (ln_before/q/k/v/attn_out/
ln_after/mlp_up/mlp_down). The causal attention core is
`ops.attention.fused_attention` (kernel 3) through `layers.self_attention`.

Weights: HF `GPT2LMHeadModel`/`GPT2Model` state-dict npz. HF stores these
as `Conv1D`, kernels already [in, out]; the fused `c_attn` [D, 3D] kernel
splits into q/k/v; the LM head is tied to `wte` unless `lm_head.weight`
is present; the MoE blocks' experts load from `h.{i}.moe.*` keys
(`moe_state_dict`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import ShardConfig
from .layers import TransformerConfig, dense, gelu_new, layer_norm, self_attention
from .shard import FamilySpec, build_shard_params

SUBLAYER_PARAMS = {
    0: ("ln_before", "q", "k", "v"),
    1: ("attn_out",),
    2: ("ln_after", "mlp_up"),
    3: ("mlp_down",),
}

# the routed-FFN variant: the switch-FFN in sublayer 2, sublayer 3 the
# parameter-free residual add
MOE_SUBLAYER_PARAMS = {
    0: ("ln_before", "q", "k", "v"),
    1: ("attn_out",),
    2: ("ln_after", "moe"),
    3: (),
}


def embed(p: Dict, input_ids: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Token embedding + learned position embedding (HF `GPT2Model`)."""
    seq_len = input_ids.shape[1]
    return p["wte"][input_ids.long()] + p["wpe"][:seq_len][None]


def sublayer(p: Dict, sub: int, data, cfg: TransformerConfig):
    """One of the 4 schedulable sublayers (pre-LN block, causal attention)."""
    if sub == 0:
        normed = layer_norm(p["ln_before"], data, cfg.layer_norm_eps)
        ctx = self_attention({"q": p["q"], "k": p["k"], "v": p["v"]}, normed,
                             cfg.num_attention_heads, causal=True)
        return (ctx, data)
    if sub == 1:
        ctx, skip = data
        return dense(p["attn_out"], ctx) + skip
    if sub == 2:
        normed = layer_norm(p["ln_after"], data, cfg.layer_norm_eps)
        if cfg.n_experts:
            from ..parallel.expert import moe_ffn_delta
            delta = moe_ffn_delta(p["moe"], normed, cfg.n_experts,
                                  cfg.capacity_factor, act=gelu_new)
            return (delta, data)
        return (gelu_new(dense(p["mlp_up"], normed)), data)
    if sub == 3:
        mlp_h, skip = data
        if cfg.n_experts:
            return mlp_h + skip      # sublayer 2's delta + residual
        return dense(p["mlp_down"], mlp_h) + skip
    raise ValueError(f"sublayer must be 0..3, got {sub}")


def finalize(p: Dict, hidden: torch.Tensor,
             cfg: TransformerConfig) -> torch.Tensor:
    """Final LayerNorm + LM head -> [B, S, vocab] logits."""
    hidden = layer_norm(p["ln"], hidden, cfg.layer_norm_eps)
    return dense(p["head"], hidden)


FAMILY = FamilySpec(name="gpt2", embed=embed, sublayer=sublayer,
                    finalize=finalize)


# --- weight loading -------------------------------------------------------

def _a(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def load_params(cfg: TransformerConfig, shard_config: ShardConfig,
                weights: Mapping, dtype=torch.float32) -> Dict:
    """Build shard params (on the CPU) from an HF GPT-2 state-dict npz.

    Accepts `GPT2LMHeadModel` keys (`transformer.`-prefixed + `lm_head.*`)
    and bare `GPT2Model` keys; the LM head falls back to the tied `wte`."""
    keys = set(weights.keys())
    if any(k.startswith("transformer.") for k in keys):
        sd = {k.removeprefix("transformer."): weights[k] for k in keys
              if k.startswith("transformer.")}
        if "lm_head.weight" in keys:
            sd["lm_head.weight"] = weights["lm_head.weight"]
    else:
        sd = weights if isinstance(weights, dict) else dict(weights.items())
    d = cfg.hidden_size

    def get_embed() -> Dict:
        return {"wte": _a(sd["wte.weight"], dtype),
                "wpe": _a(sd["wpe.weight"], dtype)}

    def get_block(block_id: int, subs: tuple) -> Dict:
        root = f"h.{block_id}."
        p: Dict = {}
        if 0 in subs:
            p["ln_before"] = {"scale": _a(sd[root + "ln_1.weight"], dtype),
                              "bias": _a(sd[root + "ln_1.bias"], dtype)}
            w = np.asarray(sd[root + "attn.c_attn.weight"])   # [D, 3D]
            b = np.asarray(sd[root + "attn.c_attn.bias"])     # [3D]
            for i, name in enumerate(("q", "k", "v")):
                p[name] = {"w": _a(w[:, i * d:(i + 1) * d], dtype),
                           "b": _a(b[i * d:(i + 1) * d], dtype)}
        if 1 in subs:
            p["attn_out"] = {"w": _a(sd[root + "attn.c_proj.weight"], dtype),
                             "b": _a(sd[root + "attn.c_proj.bias"], dtype)}
        if 2 in subs:
            p["ln_after"] = {"scale": _a(sd[root + "ln_2.weight"], dtype),
                             "bias": _a(sd[root + "ln_2.bias"], dtype)}
            if cfg.n_experts:
                moe = root + "moe."
                p["moe"] = {
                    "router": {"w": _a(sd[moe + "router.weight"], dtype),
                               "b": _a(sd[moe + "router.bias"], dtype)},
                    "experts": {
                        "mlp_up": {
                            "w": _a(sd[moe + "experts.c_fc.weight"], dtype),
                            "b": _a(sd[moe + "experts.c_fc.bias"], dtype)},
                        "mlp_down": {
                            "w": _a(sd[moe + "experts.c_proj.weight"],
                                    dtype),
                            "b": _a(sd[moe + "experts.c_proj.bias"],
                                    dtype)}}}
            else:
                p["mlp_up"] = {"w": _a(sd[root + "mlp.c_fc.weight"], dtype),
                               "b": _a(sd[root + "mlp.c_fc.bias"], dtype)}
        if 3 in subs and not cfg.n_experts:
            p["mlp_down"] = {"w": _a(sd[root + "mlp.c_proj.weight"], dtype),
                             "b": _a(sd[root + "mlp.c_proj.bias"], dtype)}
        return p

    def get_final() -> Dict:
        head = sd.get("lm_head.weight", sd["wte.weight"])     # [V, D] tied
        # the [in, out] kernel as a transposed view: no copy of the head
        return {"ln": {"scale": _a(sd["ln_f.weight"], dtype),
                       "bias": _a(sd["ln_f.bias"], dtype)},
                "head": {"w": _a(head, dtype).T,
                         "b": torch.zeros((np.asarray(head).shape[0],),
                                          dtype=dtype)}}

    return build_shard_params(shard_config, get_embed, get_block, get_final)


# --- random weights (benchmarks / tests without checkpoints) --------------

def init_params(cfg: TransformerConfig, shard_config: ShardConfig,
                seed: int = 0, dtype=torch.float32) -> Dict:
    """Random shard params with the structure of `load_params`.

    Draws exactly the numpy stream of the JAX package's `gpt2.init_params`,
    so one seed gives identical weights in both packages. The random LM
    head is its own [D, V] matrix, not tied to `wte`."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size

    def mat(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, size=shape)).to(dtype)

    def vec(n):
        return torch.zeros((n,), dtype=dtype)

    def ln():
        return {"scale": torch.ones((d,), dtype=dtype), "bias": vec(d)}

    def get_embed() -> Dict:
        return {"wte": mat(cfg.vocab_size, d),
                "wpe": mat(cfg.max_position_embeddings, d)}

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
            if cfg.n_experts:
                e = cfg.n_experts
                p["moe"] = {
                    "router": {"w": mat(d, e), "b": vec(e)},
                    "experts": {
                        "mlp_up": {"w": mat(e, d, it),
                                   "b": torch.zeros((e, it), dtype=dtype)},
                        "mlp_down": {"w": mat(e, it, d),
                                     "b": torch.zeros((e, d), dtype=dtype)},
                    },
                }
            else:
                p["mlp_up"] = {"w": mat(d, it), "b": vec(it)}
        if 3 in subs and not cfg.n_experts:
            p["mlp_down"] = {"w": mat(it, d), "b": vec(d)}
        return p

    def get_final() -> Dict:
        return {"ln": ln(), "head": {"w": mat(d, cfg.vocab_size),
                                     "b": vec(cfg.vocab_size)}}

    return build_shard_params(shard_config, get_embed, get_block, get_final)


def random_npz_weights(cfg: TransformerConfig,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """A whole model's seeded random weights under the HF
    `GPT2LMHeadModel` keys (`transformer.`-prefixed, `lm_head.weight` tied
    to `wte`), f32.

    Unlike `init_params`, which draws each shard's weights from a fresh
    stream, this gives every shard of every partition the same weights
    (through `load_params` or `np.savez` + `--model-file`), so a pipeline
    can be held against the single-shard forward. Biases and norm
    parameters are random too, so their code paths are exercised. The
    switch-MoE layout is `moe_state_dict`'s."""
    if cfg.n_experts:
        raise ValueError(
            f"GPT-2 with n_experts={cfg.n_experts} stores its routed FFN "
            "under h.{i}.moe.* (parallel/expert.py params): draw it with "
            "moe_state_dict")
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size

    def r(*shape, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(shape, dtype=np.float32)
                ).astype(np.float32)

    wte = r(cfg.vocab_size, d)
    out = {"transformer.wte.weight": wte,
           "transformer.wpe.weight": r(cfg.max_position_embeddings, d),
           "transformer.ln_f.weight": r(d, mean=1.0),
           "transformer.ln_f.bias": r(d),
           "lm_head.weight": wte}
    for i in range(cfg.num_hidden_layers):
        root = f"transformer.h.{i}."
        out[root + "ln_1.weight"] = r(d, mean=1.0)
        out[root + "ln_1.bias"] = r(d)
        out[root + "attn.c_attn.weight"] = r(d, 3 * d)
        out[root + "attn.c_attn.bias"] = r(3 * d)
        out[root + "attn.c_proj.weight"] = r(d, d)
        out[root + "attn.c_proj.bias"] = r(d)
        out[root + "ln_2.weight"] = r(d, mean=1.0)
        out[root + "ln_2.bias"] = r(d)
        out[root + "mlp.c_fc.weight"] = r(d, it)
        out[root + "mlp.c_fc.bias"] = r(it)
        out[root + "mlp.c_proj.weight"] = r(it, d)
        out[root + "mlp.c_proj.bias"] = r(d)
    return out


def moe_state_dict(cfg: TransformerConfig, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """A whole MoE model's seeded random state dict in the flat npz layout
    `load_params` reads (`h.{i}.moe.*` for the routed FFN), f32: the JAX
    package's `moe_state_dict` stream, so one seed gives equal weights."""
    if not cfg.n_experts:
        raise ValueError("moe_state_dict needs an MoE config (n_experts > 0)")
    rng = np.random.default_rng(seed)
    d, it, e = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts

    def mat(*shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    sd = {"wte.weight": mat(cfg.vocab_size, d),
          "wpe.weight": mat(cfg.max_position_embeddings, d),
          "ln_f.weight": np.ones(d, np.float32),
          "ln_f.bias": np.zeros(d, np.float32)}
    for i in range(cfg.num_hidden_layers):
        root = f"h.{i}."
        sd[root + "ln_1.weight"] = np.ones(d, np.float32)
        sd[root + "ln_1.bias"] = np.zeros(d, np.float32)
        sd[root + "attn.c_attn.weight"] = mat(d, 3 * d)
        sd[root + "attn.c_attn.bias"] = np.zeros(3 * d, np.float32)
        sd[root + "attn.c_proj.weight"] = mat(d, d)
        sd[root + "attn.c_proj.bias"] = np.zeros(d, np.float32)
        sd[root + "ln_2.weight"] = np.ones(d, np.float32)
        sd[root + "ln_2.bias"] = np.zeros(d, np.float32)
        sd[root + "moe.router.weight"] = mat(d, e)
        sd[root + "moe.router.bias"] = np.zeros(e, np.float32)
        sd[root + "moe.experts.c_fc.weight"] = mat(e, d, it)
        sd[root + "moe.experts.c_fc.bias"] = np.zeros((e, it), np.float32)
        sd[root + "moe.experts.c_proj.weight"] = mat(e, it, d)
        sd[root + "moe.experts.c_proj.bias"] = np.zeros((e, d), np.float32)
    return sd
