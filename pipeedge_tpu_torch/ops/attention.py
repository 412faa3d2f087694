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

Gradients. On a CUDA tensor the kernel's output has no autograd graph, so
when grad mode is on and q, k or v requires grad, both wrappers go through
`FusedAttentionFunction`: its forward runs the kernel with the row
log-sum-exp output (`fused_attention_lse`), its backward the hand-written
backward of `csrc/attention_bwd.cu` (`fused_attention_backward`, counted
as `fused_attention_bwd`). Its plain version, `attention_backward_reference`,
is what the CPU tests and `chip_smoke.py` hold it to; nothing on the main
path calls it when a card is present. CPU tensors keep `attention_reference`,
which autograd differentiates.
"""
from __future__ import annotations

import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
LOG2E = 1.4426950408889634
BSHD = (0, 2, 1, 3)   # [B, S, H, D] <-> [B, H, S, D]


def _future(s: int, device) -> torch.Tensor:
    """The causal mask: True above the diagonal (keys past the row)."""
    return torch.ones(s, s, dtype=torch.bool, device=device).triu_(1)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """q k^T / sqrt(D) in f32 over [..., S, D], -inf past the diagonal."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        scores = scores.masked_fill(_future(q.shape[-2], q.device),
                                    float("-inf"))
    return scores


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain softmax(q k^T / sqrt(D)) v over [..., S, D], f32 softmax."""
    probs = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = False) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores in base 2, f32 [..., S]:
    the kernel's LSE output (`fused_attention_lse`)."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1) * LOG2E


def attention_backward_reference(q, k, v, o, do, lse, causal: bool = False):
    """Plain backward of attention over [..., S, D]: (dq, dk, dv) in q's
    dtype from the forward's output `o`, the output's gradient `do` and
    the base-2 row LSE `lse` [..., S] (the kernel's contract), sums in f32:
    P = 2^(s log2(e) - lse), dV = P^T dO, dS = P (dO V^T - rowsum(dO O)),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    probs = torch.exp2(_scores(q, k, causal) * LOG2E - lse[..., None])
    dv = torch.matmul(probs.transpose(-1, -2), dof)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = probs * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_kernel_args(dtype: torch.dtype, d: int) -> None:
    """Raise for what the kernel does not take: a dtype other than f32 or
    bf16, a head dim above 128."""
    if dtype not in _DTYPES:
        raise ValueError(f"fused attention takes float32 or bfloat16, "
                         f"got {dtype}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"fused attention takes head dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")


def _geometry(q: torch.Tensor, bshd: bool):
    """(batch, heads, seq, d, (stride_b, stride_h, stride_s)) of a
    contiguous [B, S, H, D] (`bshd`) or [BH, S, D] tensor."""
    if bshd:
        b, s, h, d = q.shape
        return b, h, s, d, (s * h * d, d, h * d)
    bh, s, d = q.shape
    return bh, 1, s, d, (s * d, 0, d)


def _launch(q, k, v, batch: int, heads: int, seq: int, d: int,
            strides, causal: bool, lse=None) -> torch.Tensor:
    """Run the kernel on tensors that share one strided layout; `lse`, f32
    [batch * heads, seq], also takes each row's base-2 log-sum-exp."""
    check_kernel_args(q.dtype, d)
    out = torch.empty_like(q)
    lib = _build.library()
    args = (_DTYPES[q.dtype], batch, heads, seq, d, *strides, int(causal),
            _build.stream_handle(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    # two entries where one with a null LSE pointer would do: `chip_smoke.py
    # --ab-parent` runs this wrapper over a parent's library, built before
    # the LSE output existed, whose `pe_fused_attention` has no such
    # argument; inference calls that entry in both libraries
    if lse is None:
        code = lib.pe_fused_attention(*ptrs, *args)
    else:
        code = lib.pe_fused_attention_lse(*ptrs, lse.data_ptr(), *args)
    _build.check(code, "fused_attention")
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
    if _build.cuts_graph(q, k, v):
        return FusedAttentionFunction.apply(q, k, v, causal, False)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _launch(q, k, v, *_geometry(q, False), causal)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention over [B, S, H, D] tensors; returns the same layout."""
    _same_device_and_dtype(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q.permute(BSHD), k.permute(BSHD),
                                   v.permute(BSHD), causal).permute(BSHD)
    if _build.cuts_graph(q, k, v):
        return FusedAttentionFunction.apply(q, k, v, causal, True)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _launch(q, k, v, *_geometry(q, True), causal)


# --------------------------------------------------------------------------
# the gradient
# --------------------------------------------------------------------------

def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, bshd: bool = True):
    """(o, lse): attention over [B, S, H, D] (`bshd`) or [BH, S, D] and
    each row's base-2 log-sum-exp, f32 [B, H, S] or [BH, S]. The kernel
    for CUDA tensors (contiguous inputs), the plain versions for CPU
    ones. No autograd graph."""
    _same_device_and_dtype(q, k, v)
    if q.device.type == "cpu":
        if bshd:
            q, k, v = (t.permute(BSHD) for t in (q, k, v))
        o = attention_reference(q, k, v, causal)
        lse = attention_lse_reference(q, k, causal)
        return (o.permute(BSHD) if bshd else o), lse
    geometry = _geometry(q, bshd)
    batch, heads, seq = geometry[:3]
    lse = torch.empty((batch, heads, seq) if bshd else (batch, seq),
                      dtype=torch.float32, device=q.device)
    o = _launch(q.contiguous(), k.contiguous(), v.contiguous(), *geometry,
                causal, lse=lse)
    return o, lse


def fused_attention_backward(q, k, v, o, do, lse, causal: bool = False,
                             bshd: bool = True):
    """(dq, dk, dv) of attention from the forward's `o` and `lse`
    (`fused_attention_lse`) and the output's gradient `do`, in the layout
    of `fused_attention_lse`: the backward kernel for CUDA tensors,
    `attention_backward_reference` for CPU ones."""
    _same_device_and_dtype(q, k, v)
    if q.device.type == "cpu":
        if bshd:
            grads = attention_backward_reference(
                *(t.permute(BSHD) for t in (q, k, v, o, do)), lse, causal)
            return tuple(g.permute(BSHD) for g in grads)
        return attention_backward_reference(q, k, v, o, do, lse, causal)
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"attention backward takes do in q's dtype "
                         f"({q.dtype}) and an f32 lse, got {do.dtype} and "
                         f"{lse.dtype}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    batch, heads, seq, d, strides = _geometry(q, bshd)
    check_kernel_args(q.dtype, d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    _build.check(_build.library().pe_fused_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], batch, heads, seq, d,
        *strides, int(causal), _build.stream_handle(q.device)),
        "fused_attention_bwd")
    _build.count_launch("fused_attention_bwd")
    return dq, dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """Kernel 3 with its backward: `apply(q, k, v, causal, bshd)`.

    The forward keeps the kernel's LSE; the backward runs the backward
    kernel on q, k, v, o, dO and that LSE. It saves only tensors (the two
    flags ride on ctx), so `torch.utils.checkpoint` may re-run the forward.
    On CPU tensors both halves run their plain versions (the tests)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bshd: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fused_attention_lse(q, k, v, causal, bshd)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bshd = causal, bshd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, o, do, lse,
                                              ctx.causal, ctx.bshd)
        return dq, dk, dv, None, None
