"""Int8-KV decode-step attention: the hand-written kernel on the H100.

Port of `pipeedge_tpu/ops/decode_attention.py`. One decode step of an MHA
decoder attends its single query row over the int8 KV cache window:
K and V are dequantized per (position, head) as (q + 128)·s + z, the row
at `pos` (written this step) is replaced by its fresh, unquantized K/V,
rows [0, pos] are attended, and K, V and the softmax numerators are
rounded through the pipeline dtype. The dequantize-then-attend route
(`parallel/decode.py` `_cache_update_and_read` + `_attend`) computes the
same function through a full-precision copy of the window.

`int8_decode_attention` launches the CUDA kernel of
`csrc/decode_attention.cu` for CUDA tensors and runs
`decode_attention_reference`, the plain PyTorch version of the same
function, for CPU tensors. The window may be a strided view of the stage
cache ([B, W, H, Dh] with any batch and row strides): the kernel reads it
in place, and only its live rows [0, pos], split over the blocks of one
thread-block cluster per (head, batch cell) (`split_count`).

The TPU kernel's two `variant`s (per-cell grid, batch-as-sublane grid)
are two VMEM layouts of one function; both names are accepted and run
this one kernel.
"""
from __future__ import annotations

import math
import operator
from typing import List, Optional, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# every head dim an MHA decoder of the registry decodes (the tiny GPT-2's
# 8, GPT-2's 64), and the powers of two between
HEAD_DIMS = (8, 16, 32, 64, 128)


def window_refusal(k_q, v_q) -> Optional[str]:
    """Why the kernel would refuse the int8 window k_q/v_q [B, W, H, Dh]
    on the card, or None when it takes it: the head dim, the 16-byte
    alignment of the windows' bases and strides (the kernel's vector
    loads) and the head count, the grid's y axis (any B: `_launch` takes
    the batch cells, the z axis, in chunks). `_launch` raises with this
    reason, and the decode driver's route gate (`parallel/decode.py`)
    asks it before a step writes its cache row, so a step it routes here
    never raises. It reads only shapes, strides and addresses."""
    _, _, h, d = k_q.shape
    if d not in HEAD_DIMS:
        return f"the kernel takes head dims {HEAD_DIMS}, not {d}"
    if any(x % 16 for x in (k_q.data_ptr(), v_q.data_ptr(), k_q.stride(0),
                            k_q.stride(1))):
        return ("the int8 window's base and strides must be multiples of "
                "16 bytes")
    if h > _build.MAX_GRID_YZ:
        return f"the kernel takes at most {_build.MAX_GRID_YZ} heads, not {h}"
    return None


def split_count(pos: int) -> int:
    """Into how many row ranges (`split_ranges`) the kernel splits the live
    rows [0, pos], one block each of one thread-block cluster: 1 up to 256
    rows, 2 up to 512, else 4 (csrc/decode_attention.cu `splits_for`;
    `chip_smoke.py` holds the two to one rule)."""
    n = pos + 1
    return 1 if n <= 256 else 2 if n <= 512 else 4


def split_ranges(pos: int, splits: int) -> List[Tuple[int, int]]:
    """The row range [start, end) of each of `splits` blocks at `pos`, in
    rank order; a range past the live rows is empty."""
    n = pos + 1
    per = -(-n // splits)
    return [(min(n, r * per), min(n, (r + 1) * per)) for r in range(splits)]


def decode_attention_reference(q, k_q, k_scale, k_shift, v_q, v_scale,
                               v_shift, k_new, v_new, pos: int
                               ) -> torch.Tensor:
    """Plain version: softmax over rows [0, pos] with the fresh row
    substituted, numerators rounded through q's dtype, as the kernel does.
    Returns [B, 1, H*Dh] in q's dtype."""
    b, _, h, d = q.shape
    dtype = q.dtype
    n = pos + 1

    def rows(codes, scale, shift, new):
        x = ((codes[:, :n].float() + 128.0) * scale[:, :n, :, None]
             + shift[:, :n, :, None])
        x[:, pos] = new[:, 0].float()
        return x.to(dtype).float()                     # [B, n, H, Dh]

    k = rows(k_q, k_scale, k_shift, k_new)
    v = rows(v_q, v_scale, v_shift, v_new)
    scores = torch.einsum("bhd,bnhd->bhn", q[:, 0].float(), k) \
        * (1.0 / math.sqrt(d))
    p = torch.exp(scores - scores.amax(-1, keepdim=True)).to(dtype).float()
    ctx = torch.einsum("bhn,bnhd->bhd", p, v) / p.sum(-1, keepdim=True)
    return ctx.to(dtype).reshape(b, 1, h * d)


def _check(q, k_q, k_scale, k_shift, v_q, v_scale, v_shift, k_new, v_new,
           pos: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, Dh], got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's shape and dtype")
    b, _, h, d = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != b or tuple(k_q.shape[2:]) != (h, d):
        raise ValueError(f"k_q must be [{b}, W, {h}, {d}], got "
                         f"{tuple(k_q.shape)}")
    if v_q.shape != k_q.shape or v_q.stride() != k_q.stride():
        raise ValueError("k_q and v_q must share one shape and layout")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError("k_q and v_q must be int8")
    if k_q.stride(3) != 1 or k_q.stride(2) != d:
        raise ValueError("each cache row's [H, Dh] must be contiguous")
    rows = tuple(k_q.shape[:3])
    for t in (k_scale, k_shift, v_scale, v_shift):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise ValueError(f"scales and shifts must be float32 {rows}")
        if t.stride() != k_scale.stride() or t.stride(2) != 1:
            raise ValueError("scales and shifts must share one layout with "
                             "a contiguous head axis")
    if not 0 <= pos < k_q.shape[1]:
        raise ValueError(f"pos {pos} outside the window of "
                         f"{k_q.shape[1]} rows")
    devices = {t.device for t in (q, k_q, k_scale, k_shift, v_q, v_scale,
                                  v_shift, k_new, v_new)}
    if len(devices) != 1:
        raise ValueError("decode attention inputs must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode attention runs on cuda or cpu, not "
                         f"{q.device}")


def _launch(q, k_q, k_scale, k_shift, v_q, v_scale, v_shift, k_new, v_new,
            pos: int) -> torch.Tensor:
    b, _, h, d = q.shape
    refusal = window_refusal(k_q, v_q)
    if refusal is not None:
        raise ValueError(f"decode attention kernel: {refusal}")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty((b, 1, h * d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    stream = _build.stream_handle(q.device)
    # the batch cells are the grid's z axis: one launch per 65535 of them
    for b0, b1 in _build.launch_chunks(b):
        ptrs = [t[b0:b1].data_ptr() for t in (
            q, k_new, v_new, k_q, v_q, k_scale, k_shift, v_scale, v_shift,
            out)]
        _build.check(lib.pe_decode_attention(
            *ptrs, _DTYPES[q.dtype], b1 - b0, h, d, pos, k_q.stride(0),
            k_q.stride(1), k_scale.stride(0), k_scale.stride(1),
            1.0 / math.sqrt(d), stream), "decode_attention")
        _build.count_launch("decode_attention")
    return out


def int8_decode_attention(q, k_q, k_scale, k_shift, v_q, v_scale, v_shift,
                          k_new, v_new, pos: int, variant: int = 1
                          ) -> torch.Tensor:
    """Decode-step attention over an int8 cache window.

    q/k_new/v_new: [B, 1, H, Dh] float32 or bfloat16; k_q/v_q: [B, W, H,
    Dh] int8; scales/shifts: [B, W, H] float32; `pos`: the host-known row
    written this step, 0 <= pos < W. Returns the [B, 1, H*Dh] context in
    q's dtype, `_attend`'s output layout. `variant` is 1 or 2 (module
    docstring)."""
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    pos = operator.index(pos)
    args = (q, k_q, k_scale, k_shift, v_q, v_scale, v_shift, k_new, v_new,
            pos)
    _check(*args)
    if q.device.type == "cpu":
        return decode_attention_reference(*args)
    _build.refuse_grad("decode_attention", q, k_new, v_new, k_scale,
                       k_shift, v_scale, v_shift)
    return _launch(*args)
