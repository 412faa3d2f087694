"""Transformer building blocks as plain functions on tensors.

Port of `pipeedge_tpu/models/layers.py`. Parameters are nested dicts of
tensors; dense kernels are stored [in, out] as in the JAX package (torch
state dicts store [out, in] and are transposed at load time).

An unmasked self-attention always goes through `ops.attention
.fused_attention`: the hand-written kernel for CUDA tensors, the plain
version for CPU tensors. (The JAX package routes its Pallas kernel only on
a TPU at S >= 1024, a TPU measurement that does not carry over.)

Tagged denses take the int8 compute path (`ops/int8_matmul.py`) while a
`QuantizeCompute` config is enabled; untagged ones are always exact.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import int8_matmul
from ..ops.attention import fused_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static model hyperparameters (local constants: no network fetch)."""
    model_type: str              # 'vit' | 'deit' | 'bert' | 'gpt2'
    hidden_size: int
    num_hidden_layers: int       # transformer blocks (sublayers = 4x this)
    num_attention_heads: int
    intermediate_size: int
    layer_norm_eps: float = 1e-12
    num_labels: int = 0
    # vision
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    # text
    vocab_size: int = 0
    max_position_embeddings: int = 0
    type_vocab_size: int = 2
    # mixture-of-experts (switch-FFN blocks; 0 = dense FFN)
    n_experts: int = 0
    capacity_factor: float = 1.25
    # grouped-query attention: 0 = same as query heads
    num_kv_heads: int = 0
    # sliding-window attention: each position attends to the last
    # `sliding_window` positions (incl. itself); 0 = full causal
    sliding_window: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        """Key/value head count (GQA: fewer than query heads; 0 = equal)."""
        return self.num_kv_heads or self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class QuantizeCompute:
    """Int8 compute-path config (ops/int8_matmul.py).

    `enabled` routes every TAGGED dense (ViT's attention projections,
    attn-out, and the FFN pair; untagged call sites always stay exact)
    through the block-scaled int8 matmul. `skip_tags` is the per-layer
    opt-out (e.g. frozenset({"mlp.down"})); `clamp_alphas` maps tags to
    calibrated Banner clip thresholds (the utils/calibrate.py sidecar);
    `tunnel` also lets a stage's first matmul consume the 8-bit wire
    payload directly (parallel/pipeline.py seam, ops/int8_matmul
    .wire_dense), and is read when `build_pipeline` builds the stages.

    PyTorch runs eagerly: the denses read the active config on every
    call."""
    enabled: bool = False
    block_k: int = 128
    skip_tags: frozenset = frozenset()
    clamp_alphas: Optional[dict] = None
    tunnel: bool = False


_QC_OFF = QuantizeCompute()
_QUANTIZE_COMPUTE = None   # None = unset (consult the env var)
_QC_OBSERVER = None        # calibration hook: fn(tag, x) per tagged dense


def set_quantize_compute(cfg) -> None:
    """Install the int8 compute-path config.

    `cfg` is a `QuantizeCompute`, True/False (defaults / off), or None to
    reset: discard the programmatic choice and defer to the env again
    (PIPEEDGE_QUANTIZE_COMPUTE=1 enables the defaults,
    PIPEEDGE_QUANTIZE_SKIP=tag,tag fills the opt-out); the setter wins
    over the env, as `set_fast_numerics` does."""
    global _QUANTIZE_COMPUTE
    if cfg is None or isinstance(cfg, QuantizeCompute):
        _QUANTIZE_COMPUTE = cfg
    else:
        _QUANTIZE_COMPUTE = QuantizeCompute(enabled=bool(cfg))


def quantize_compute() -> QuantizeCompute:
    """The active int8 compute config (programmatic choice wins; env
    PIPEEDGE_QUANTIZE_COMPUTE is the fallback; disabled otherwise)."""
    if _QUANTIZE_COMPUTE is not None:
        return _QUANTIZE_COMPUTE
    env = os.getenv("PIPEEDGE_QUANTIZE_COMPUTE")
    if env is not None and env.strip().lower() not in (
            "", "0", "false", "no", "off"):
        skip = frozenset(t for t in os.getenv(
            "PIPEEDGE_QUANTIZE_SKIP", "").split(",") if t)
        return QuantizeCompute(enabled=True, skip_tags=skip)
    return _QC_OFF


_FAST_NUMERICS = None      # None = unset (consult the env var)


def set_fast_numerics(enabled) -> None:
    """Opt-in fast-numerics mode (also env PIPEEDGE_FAST_NUMERICS=1 when
    this setter was never called or was reset; the programmatic toggle
    wins): LayerNorm statistics run in the model dtype instead of float32,
    and exact-erf GeLU becomes the tanh approximation. `None` resets to
    the env. PyTorch runs eagerly, so the flag applies from the next call."""
    global _FAST_NUMERICS
    _FAST_NUMERICS = None if enabled is None else bool(enabled)


def fast_numerics_enabled() -> bool:
    if _FAST_NUMERICS is not None:
        return _FAST_NUMERICS
    env = os.getenv("PIPEEDGE_FAST_NUMERICS")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return False


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with scale/bias, statistics in float32 (model dtype under
    fast numerics); population variance, as `jnp.var`."""
    if fast_numerics_enabled():
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        normed = (x - mean) * torch.rsqrt(var + eps)
        return normed * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["scale"] + p["bias"]).to(x.dtype)


def dense(p, x: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
    """x @ w + b with the kernel stored [in, out].

    `tag` names the call site for the int8 compute path: tagged denses
    route through the block-scaled int8 matmul while a `QuantizeCompute`
    config is enabled (and the tag is not opted out); untagged denses are
    always exact. The calibration observer hook also keys on tags."""
    if tag is not None:
        if _QC_OBSERVER is not None:
            _QC_OBSERVER(tag, x)
        qc = quantize_compute()
        if qc.enabled and tag not in qc.skip_tags:
            alpha = (qc.clamp_alphas or {}).get(tag)
            return int8_matmul.int8_dense(
                x, p["w"], p["b"], block_k=qc.block_k, clamp_alpha=alpha,
                out_dtype=x.dtype)
    w = p["w"].to(x.dtype)
    y = torch.addmm(p["b"].to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def self_attention(p, x: torch.Tensor, num_heads: int,
                   causal: bool = False,
                   tag_prefix: Optional[str] = None) -> torch.Tensor:
    """Multi-head self-attention context (pre-projection) over [B, S, D].

    Matches HF `ViTSelfAttention`: returns the concatenated per-head
    context; the output projection lives in the next sublayer. The
    softmax(QK^T)V core is `fused_attention` (module docstring).
    `tag_prefix` tags the q/k/v projections (`<prefix>.q` etc.) for the
    int8 compute path (see `dense`)."""
    b, s, d = x.shape
    hd = d // num_heads
    tags = {n: f"{tag_prefix}.{n}" if tag_prefix else None
            for n in ("q", "k", "v")}
    q = dense(p["q"], x, tag=tags["q"]).reshape(b, s, num_heads, hd)
    k = dense(p["k"], x, tag=tags["k"]).reshape(b, s, num_heads, hd)
    v = dense(p["v"], x, tag=tags["v"]).reshape(b, s, num_heads, hd)
    return fused_attention(q, k, v, causal=causal).reshape(b, s, d)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GeLU, as torch `nn.GELU()` (tanh under fast numerics)."""
    return F.gelu(x, approximate="tanh" if fast_numerics_enabled() else "none")


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GeLU, matching HF `gelu_new` (GPT-2's activation)."""
    return F.gelu(x, approximate="tanh")


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] with (ph, pw, c) flattening
    order, matching Google's ViT npz `embedding/kernel` [ph, pw, C, D]
    reshaped to [ph*pw*C, D]."""
    b, h, w, c = x.shape
    nh, nw = h // patch, w // patch
    x = x.reshape(b, nh, patch, nw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)
