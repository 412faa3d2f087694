"""Fused attention: the hand-written flash-attention kernel on the H100.

Port of `pipeedge_tpu/ops/attention.py`. `fused_attention_bhsd` ([B*H, S,
D]) and `fused_attention` ([B, S, H, D]) launch the CUDA kernel of
`csrc/attention.cu` for CUDA tensors, and run `attention_reference`, the
plain PyTorch version of the same function, for CPU tensors. The kernel
reads both layouts through strides, so neither wrapper transposes, and it
masks the ragged key tail itself (the TPU wrapper padded S to 8).

f32 or bf16 in, the same dtype out; the softmax runs in f32 either way.
The kernel's products run on the tensor cores: bf16 as bf16 products, f32
as 3xTF32 (each operand split into two TF32 parts, three products summed
in f32), which keeps the f32 tolerance that one TF32 product would miss.
"""
from __future__ import annotations

import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain softmax(q k^T / sqrt(D)) v over [..., S, D], f32 softmax."""
    s, d = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    if causal:
        future = torch.ones(s, s, dtype=torch.bool,
                            device=q.device).triu_(1)
        scores = scores.masked_fill(future, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def check_kernel_args(dtype: torch.dtype, d: int) -> None:
    """Raise for what the kernel does not take: a dtype other than f32 or
    bf16, a head dim above 128."""
    if dtype not in _DTYPES:
        raise ValueError(f"fused attention takes float32 or bfloat16, "
                         f"got {dtype}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"fused attention takes head dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")


def _launch(q, k, v, batch: int, heads: int, seq: int, d: int,
            strides, causal: bool) -> torch.Tensor:
    """Run the kernel on tensors that share one strided layout."""
    check_kernel_args(q.dtype, d)
    out = torch.empty_like(q)
    lib = _build.library()
    _build.check(lib.pe_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], batch, heads, seq, d, *strides, int(causal),
        _build.stream_handle(q.device)), "fused_attention")
    _build.count_launch("fused_attention")
    return out


def _same_device_and_dtype(q, k, v) -> None:
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cuda or cpu, not "
                         f"{q.device}")


def fused_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Fused attention over [BH, S, D] tensors (already head-flattened)."""
    _same_device_and_dtype(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, d = q.shape
    return _launch(q, k, v, bh, 1, s, d, (s * d, 0, d), causal)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention over [B, S, H, D] tensors; returns the same layout."""
    _same_device_and_dtype(q, k, v)
    if q.device.type == "cpu":
        flip = (0, 2, 1, 3)
        return attention_reference(q.permute(flip), k.permute(flip),
                                   v.permute(flip), causal).permute(flip)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, h, d = q.shape
    return _launch(q, k, v, b, h, s, d, (s * h * d, d, h * d), causal)
