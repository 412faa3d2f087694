"""Block-scaled int8 matmul: the int8 compute path's kernel on the H100.

Port of `pipeedge_tpu/ops/int8_matmul.py`. Weights are quantized per
output channel (symmetric int8), activations per (row, k-block) (symmetric
int8, block `block_k` wide), and

    y[m, n] = ws[n] * sum_kb xs[m, kb] * (sum_{k in kb} xq[m, k] * wq[k, n])

with each k-block's int8 product summed exactly, in int32, and folded into
an f32 accumulator in k order. One activation outlier saturates only its
own k-block's scale.

`matmul_q` is the dispatch seam: the hand-written kernels of
`csrc/int8_matmul.cu` for CUDA tensors, `matmul_reference`, the plain
PyTorch version of the same function, for CPU tensors. Of the two kernels,
`kernel_choice` picks by shape and alignment alone: the `wgmma` kernel
(TMA ring, warp-specialised) whenever the k-block is a multiple of 32 bytes
and both operands are 16-byte aligned, which covers the whole main path,
and the `mma.sync` kernel for the rest (K = 100 taken whole, K = 320 in
blocks of 80). There is no mode switch and no probe: on the card a kernel
runs or the call raises. Both equal `matmul_reference` bit for bit
(`chip_smoke.py` holds them to that): each sums every k-block exactly and
folds it with one rounded multiply and one rounded add, in k order.

Weight fold: a weight's int8 codes and scales depend on the weight alone,
so `int8_dense` and `wire_dense` quantize each weight tensor once, at
first use, and keep the codes in the kernel's layout ([N, K], K
contiguous: the s8 `mma` reads B column by column). The cache is keyed on
the tensor and its version counter, so an in-place update re-quantizes;
the codes are those `quantize_weight` gives on every call.

The wire tunnel (`wire_dense`): an 8-bit `QuantizedTensor` off the edge
codec (ops/quant.py affine layout: x = q/255*scale + shift per item) feeds
the matmul directly. The codes are recentred to signed int8 (q - 128) and
the affine part folds into a rank-1 epilogue term:

    y = (scale/255) * (q-128) @ W  +  (128*scale/255 + shift) * colsum(W)

On the card, when the item length is a multiple of 4, the packed words'
bytes are the codes (value i is byte i % 4 of word i // 4, little-endian),
so the kernel reads them in place and flips each byte's top bit
(q - 128 == q ^ 0x80 as int8): no unpack.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _build
from . import quant as quant_ops

# default k-block width: fine enough that a single activation outlier
# saturates only 128 values, coarse enough that the scales stay 1/128th
# of the activation bytes
DEFAULT_BLOCK_K = 128


def pick_block(width: int, preferred: int = 128) -> int:
    """Largest multiple of 8 <= `preferred` that divides `width`; the full
    width when there is none (the JAX package's `ops/_blocks.py` rule,
    which picks the activation k-block)."""
    block = min(preferred, width) // 8 * 8
    while block >= 8:
        if width % block == 0:
            return block
        block -= 8
    return width


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as an IEEE division on every device (a Python divisor
    would become a reciprocal multiply on CUDA; ops/quant.py)."""
    return x / torch.full((), value, dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# quantizers
# --------------------------------------------------------------------------

def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 over [K, N]: scale[n] =
    amax(w[:, n]) / 127, codes round half to even and clip at +/-127.
    All-zero channels get scale 1."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, _div(amax, 127.0), 1.0)
    w_q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_act_blocks(x: torch.Tensor, block_k: int):
    """Per-(row, k-block) symmetric int8 over [M, K] activations.

    Returns (x_q int8 [M, K], x_scale f32 [M, K // block_k]). All-zero
    blocks get scale 1; saturating outliers clip at +/-127."""
    m, k = x.shape
    kb = k // block_k
    xf = x.to(torch.float32).reshape(m, kb, block_k)
    amax = xf.abs().amax(dim=2)
    scale = torch.where(amax > 0, _div(amax, 127.0), 1.0)
    x_q = torch.clamp(torch.round(xf / scale[:, :, None]), -127, 127)
    return x_q.to(torch.int8).reshape(m, k), scale


# --------------------------------------------------------------------------
# the plain version and the kernel
# --------------------------------------------------------------------------

def _check_shapes(x_shape, x_scale, w_q, w_scale, block_k: int):
    m, k = x_shape
    if w_q.shape[0] != k:
        raise ValueError(f"x_q {tuple(x_shape)} and w_q "
                         f"{tuple(w_q.shape)} disagree on K")
    if block_k <= 0 or k % block_k:
        raise ValueError(f"K={k} not divisible by block_k={block_k}")
    n = w_q.shape[1]
    if tuple(x_scale.shape) != (m, k // block_k):
        raise ValueError(f"x_scale {tuple(x_scale.shape)} is not "
                         f"[{m}, {k // block_k}]")
    if tuple(w_scale.shape) != (n,):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is not [{n}]")
    return m, k, n


def matmul_reference(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor,
                     block_k: int) -> torch.Tensor:
    """The block-scaled product in plain ops: [M, K] x [K, N] -> f32.

    Each k-block's product of the int8 codes is exact: in f32 while
    block_k * 128 * 127 < 2^24 (every partial sum is then an integer f32
    holds, in any summation order, TF32 included), in f64 beyond. The
    blocks fold in k order with a separate multiply and add, which nothing
    contracts to an FMA, then the channel scales multiply once."""
    m, k, n = _check_shapes(x_q.shape, x_scale, w_q, w_scale, block_k)
    kb = k // block_k
    exact = torch.float32 if block_k * 128 * 127 < 2 ** 24 \
        else torch.float64
    xb = x_q.to(exact).reshape(m, kb, block_k).permute(1, 0, 2)
    wb = w_q.to(exact).reshape(kb, block_k, n)
    prod = torch.bmm(xb, wb).to(torch.float32)                # [kb, m, n]
    scaled = prod * x_scale.to(torch.float32).t()[:, :, None]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    for b in range(kb):
        acc = acc + scaled[b]
    return acc * w_scale.to(torch.float32)[None, :]


def kernel_choice(k: int, block_k: int, aligned: bool) -> str:
    """The kernel a CUDA call of this shape runs: "wgmma" for a k-block of
    whole 32-byte wgmma steps with 16-byte aligned operands (TMA's rule;
    K is then a multiple of 32 too), else "mma_sync"."""
    if block_k > 0 and k % block_k == 0 and block_k % 32 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


_ENTRIES = {"wgmma": "pe_int8_matmul_wgmma", "mma_sync": "pe_int8_matmul"}


def _launch(x_bytes: torch.Tensor, x_scale: torch.Tensor,
            w_qt: torch.Tensor, w_scale: torch.Tensor, block_k: int,
            flip: bool) -> torch.Tensor:
    """Run the kernel: x_bytes int8/uint8 [M, K] and w_qt int8 [N, K], both
    contiguous; `flip` reads each activation byte as (byte ^ 0x80)."""
    m, k = x_bytes.shape
    n = w_qt.shape[0]
    dev = x_bytes.device
    for name, t in (("x_scale", x_scale), ("w_q", w_qt),
                    ("w_scale", w_scale)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, activations on {dev}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError("int8 matmul scales must be float32")
    w_scale = w_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    aligned = (x_bytes.data_ptr() | w_qt.data_ptr()) % 16 == 0
    entry = getattr(_build.library(),
                    _ENTRIES[kernel_choice(k, block_k, aligned)])
    _build.check(entry(
        x_bytes.data_ptr(), x_scale.data_ptr(), w_qt.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, n, k, block_k,
        x_scale.stride(0), x_scale.stride(1), int(flip),
        _build.stream_handle(dev)), "int8_matmul")
    _build.count_launch("int8_matmul")
    return out


def _kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """w_q [K, N] as the kernel reads it: [N, K], K contiguous. Free for a
    folded weight (its [K, N] codes are a transposed view already)."""
    w_qt = w_q.t()
    return w_qt if w_qt.is_contiguous() else w_qt.contiguous()


def matmul_q(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
             w_scale: torch.Tensor, block_k: int) -> torch.Tensor:
    """Dispatch seam: the CUDA kernel for CUDA tensors, `matmul_reference`
    for CPU tensors; the same block-scaled product either way."""
    _check_shapes(x_q.shape, x_scale, w_q, w_scale, block_k)
    dev = x_q.device
    if dev.type == "cpu":
        return matmul_reference(x_q, x_scale, w_q, w_scale, block_k)
    if dev.type != "cuda":
        raise ValueError(f"int8 matmul runs on cuda or cpu, not {dev}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 matmul takes int8 codes, got {x_q.dtype} "
                         f"and {w_q.dtype}")
    return _launch(x_q.contiguous(), x_scale, _kernel_layout(w_q),
                   w_scale, block_k, flip=False)


# --------------------------------------------------------------------------
# weight fold
# --------------------------------------------------------------------------

class FoldedWeight(NamedTuple):
    """A weight's int8 codes ([K, N], a view of the kernel's [N, K]
    layout), channel scales [N] and dequantized column sums [N]."""
    w_q: torch.Tensor
    w_scale: torch.Tensor
    colsum: torch.Tensor


_FOLDED: WeakIdKeyDictionary = WeakIdKeyDictionary()


def fold_weight(w: torch.Tensor) -> FoldedWeight:
    """`quantize_weight(w)` in the kernel's layout, computed once per
    weight tensor (and again after an in-place update of it)."""
    version = None if w.is_inference() else w._version
    hit = _FOLDED.get(w)
    if hit is not None and version is not None and hit[0] == version:
        return hit[1]
    w_q, w_scale = quantize_weight(w)
    colsum = w_q.to(torch.int32).sum(dim=0).to(torch.float32) * w_scale
    folded = FoldedWeight(w_q.t().contiguous().t(), w_scale, colsum)
    if version is not None:
        _FOLDED[w] = (version, folded)
    return folded


# --------------------------------------------------------------------------
# layer entry points
# --------------------------------------------------------------------------

def int8_dense(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               block_k: int = DEFAULT_BLOCK_K, clamp_alpha=None,
               out_dtype=None) -> torch.Tensor:
    """y = x @ w (+ b) with int8 compute, over [..., K] activations.

    `clamp_alpha` (from the calibration sidecar, utils/calibrate.py) clips
    activations to +/-alpha (an f32 threshold) before quantization, so a
    rare outlier does not stretch its block's scale; None skips the
    clip."""
    orig_shape = x.shape
    k = orig_shape[-1]
    x2 = x.reshape(-1, k)
    bk = pick_block(k, block_k)
    if clamp_alpha is not None:
        alpha = torch.full((), float(clamp_alpha), dtype=torch.float32,
                           device=x.device)
        x2 = torch.clamp(x2.to(torch.float32), -alpha, alpha)
    x_q, x_scale = quantize_act_blocks(x2, bk)
    folded = fold_weight(w)
    y = matmul_q(x_q, x_scale, folded.w_q, folded.w_scale, bk)
    if b is not None:
        y = y + b
    if out_dtype is None:
        out_dtype = x.dtype
    return y.reshape(*orig_shape[:-1], w.shape[1]).to(out_dtype)


def wire_codes(enc: quant_ops.QuantizedTensor) -> torch.Tensor:
    """An 8-bit payload's codes recentred to int8 (q - 128), [M, K] with
    M = items * rows per item: the plain unpack of the wire words."""
    items, k = enc.shape[0], enc.shape[-1]
    n_per_item = math.prod(enc.shape[1:])
    q = quant_ops._unpack_bits(enc.data, 8, n_per_item)
    return (q - 128).to(torch.int8).reshape(items * n_per_item // k, k)


def wire_matmul(enc: quant_ops.QuantizedTensor, x_scale: torch.Tensor,
                w_q: torch.Tensor, w_scale: torch.Tensor,
                block_k: int) -> torch.Tensor:
    """`matmul_q(wire_codes(enc), ...)`. On the card, with whole words
    per item, the kernel reads the words' bytes in place and flips their
    sign bit instead."""
    items, k = enc.shape[0], enc.shape[-1]
    n_per_item = math.prod(enc.shape[1:])
    dev = enc.data.device
    if dev.type == "cuda" and n_per_item % 4 == 0:
        m = items * n_per_item // k
        _check_shapes((m, k), x_scale, w_q, w_scale, block_k)
        x_bytes = enc.data.contiguous().view(torch.uint8).reshape(m, k)
        return _launch(x_bytes, x_scale, _kernel_layout(w_q), w_scale,
                       block_k, flip=True)
    return matmul_q(wire_codes(enc), x_scale, w_q, w_scale, block_k)


def wire_dense(p, enc: quant_ops.QuantizedTensor, *,
               block_k: int = DEFAULT_BLOCK_K,
               out_dtype=torch.float32) -> torch.Tensor:
    """Consume an 8-bit wire `QuantizedTensor` directly in an int8 matmul.

    The consumer half of the stage-seam tunnel. The activation side is
    exact (the affine identity loses nothing against decoding first), so
    the only deviation from `dense(p, decode_outerdim(enc))` is the
    per-channel weight quantization, as in `int8_dense`:

        x = q/255*scale + shift   (per item; ops/quant.py layout)
        y = (scale/255) * ((q-128) @ W_deq)
            + (128*scale/255 + shift) * colsum(W_deq) + b
    """
    if enc.bit != 8:
        raise ValueError(f"wire_dense consumes 8-bit payloads, got bit="
                         f"{enc.bit}")
    shape = enc.shape                       # [items, ..., K]
    items, k = shape[0], shape[-1]
    rows_per_item = math.prod(shape[1:]) // k
    m = items * rows_per_item
    bk = pick_block(k, block_k)
    s = _div(enc.scale.to(torch.float32), 255.0)            # [items]
    s_row = s.repeat_interleave(rows_per_item)              # [m]
    x_scale = s_row[:, None].expand(m, k // bk)
    folded = fold_weight(p["w"])
    y = wire_matmul(enc, x_scale, folded.w_q, folded.w_scale, bk)
    corr = 128.0 * s + enc.shift.to(torch.float32)          # [items]
    y = y + corr.repeat_interleave(rows_per_item)[:, None] \
        * folded.colsum[None, :]
    y = y + p["b"]
    return y.reshape(*shape[:-1], p["w"].shape[1]).to(out_dtype)
