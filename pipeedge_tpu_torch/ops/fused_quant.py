"""Edge-codec kernels: QuantPipe encode and decode on the H100.

Port of `pipeedge_tpu/ops/fused_quant.py`. `fused_encode_outerdim` and
`fused_decode_outerdim` launch the hand-written CUDA kernels of
`csrc/fused_quant.cu` for a CUDA tensor and run the plain PyTorch ops of
`ops/quant.py` for a CPU tensor. There is no mode switch and no probe: on
the card the kernel runs or the call raises.

Bit-identity contract: for bits 4 and 8, the kernels give the same packed
words, scale, shift and decoded values as the plain ops on the same input
on the card (`chip_smoke.py` holds them to it), and the plain encode gives
the same words as the JAX package's `tensor_encode_outerdim`
(tests/test_torch_quant.py). It holds for non-finite input too: an item
holding NaN or an infinity, or whose range overflows f32, gets the same
NaN or infinite scale and shift (NaN compared equal) and the same words,
its codes saturating as XLA's f32 -> uint32 convert does. Any leading
size is taken: the encode launches once per 65535 items, the decode once.

`encode_outerdim`/`decode_outerdim` are the one dispatch seam the pipeline
uses; bitwidths other than 4 and 8 have no kernel, in the JAX package
either (`FUSED_BITS`), and take the plain ops on every device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from . import quant as quant_ops

# bitwidths with a kernel: int8 bytes and int4 nibbles, the wire workhorses
FUSED_BITS = (4, 8)

# the encode kernel's partition of an item (csrc/fused_quant.cu): one
# thread-block cluster of up to ENCODE_CLUSTER blocks per item, each block
# a slice of whole ENCODE_GROUP-float groups (16 bytes of output words at 4
# bits, 32 at 8), so every block starts its words on a 16-byte boundary.
# 8 blocks timed faster than 16 (a non-portable cluster) on the H100;
# chip_smoke.py times both.
ENCODE_CLUSTER = 8
ENCODE_GROUP = 32


def encode_slices(n: int, cluster: int = ENCODE_CLUSTER) -> Tuple[int, int]:
    """(blocks, slice): the encode kernel's partition of an item of `n`
    floats. Block r takes [r * slice, min(n, (r + 1) * slice)); slice is a
    multiple of ENCODE_GROUP, and no block is empty."""
    groups = -(-n // ENCODE_GROUP)
    per = -(-groups // min(cluster, groups))
    return -(-groups // per), per * ENCODE_GROUP


def _check_bit(bit: int) -> None:
    if bit not in FUSED_BITS:
        raise ValueError(f"fused codec supports bits {FUSED_BITS}, got {bit}")


def fused_encode_outerdim(x: torch.Tensor, bit: int) -> quant_ops.QuantizedTensor:
    """Per-item encode, bits 4 and 8: the CUDA kernel for a CUDA tensor,
    the plain ops for a CPU tensor."""
    _check_bit(bit)
    if x.device.type == "cpu":
        return quant_ops.tensor_encode_outerdim(x, bit)
    if x.device.type != "cuda":
        raise ValueError(f"fused encode runs on cuda or cpu, not {x.device}")
    shape = tuple(x.shape)
    b = shape[0]
    n = math.prod(shape[1:])
    flat = x.reshape(b, n).to(torch.float32).contiguous()
    words = quant_ops.packed_words(n, bit)
    blocks, slice_len = encode_slices(n, ENCODE_CLUSTER)
    data = torch.empty((b, words), dtype=torch.int32, device=x.device)
    scale = torch.empty((b,), dtype=torch.float32, device=x.device)
    shift = torch.empty((b,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    stream = _build.stream_handle(x.device)
    # the items are the grid's y axis: one launch per 65535 of them (a
    # 1-D grid without the limit ran slower, csrc/fused_quant.cu)
    for b0, b1 in _build.launch_chunks(b):
        part = flat[b0:b1]
        vec = int(n % 4 == 0 and part.data_ptr() % 16 == 0)
        _build.check(lib.pe_fused_encode(
            part.data_ptr(), data[b0:b1].data_ptr(), scale[b0:b1].data_ptr(),
            shift[b0:b1].data_ptr(), b1 - b0, n, bit, blocks, slice_len, vec,
            stream), "fused_encode")
        _build.count_launch("fused_encode")
    return quant_ops.QuantizedTensor(data=data, scale=scale, shift=shift,
                                     shape=shape, bit=bit)


def fused_decode_outerdim(enc: quant_ops.QuantizedTensor) -> torch.Tensor:
    """Per-item decode, bits 4 and 8: the CUDA kernel for CUDA words, the
    plain ops for CPU words."""
    bit = enc.bit
    _check_bit(bit)
    dev = enc.data.device
    if dev.type == "cpu":
        return quant_ops.tensor_decode_outerdim(enc)
    if dev.type != "cuda":
        raise ValueError(f"fused decode runs on cuda or cpu, not {dev}")
    shape = tuple(enc.shape)
    b = shape[0]
    n = math.prod(shape[1:])
    if tuple(enc.data.shape) != (b, quant_ops.packed_words(n, bit)):
        raise ValueError(f"packed words {tuple(enc.data.shape)} do not fit "
                         f"shape {shape} at {bit} bits")
    data = enc.data.contiguous()
    scale = enc.scale.to(torch.float32).contiguous()
    shift = enc.shift.to(torch.float32).contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    vec = int(n % 4 == 0)
    lib = _build.library()
    _build.check(lib.pe_fused_decode(
        data.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        b, n, bit, vec, _build.stream_handle(dev)), "fused_decode")
    _build.count_launch("fused_decode")
    return out


def encode_outerdim(x: torch.Tensor, bit: int,
                    mode: str = "original") -> quant_ops.QuantizedTensor:
    """Per-outer-item encode: the codec kernel for bits 4 and 8 in
    'original' mode, else the plain ops; bit-identical either way."""
    if bit in FUSED_BITS and mode == "original":
        return fused_encode_outerdim(x, bit)
    return quant_ops.tensor_encode_outerdim(x, bit, mode)


def decode_outerdim(enc: quant_ops.QuantizedTensor) -> torch.Tensor:
    """Inverse of `encode_outerdim` (same dispatch rule)."""
    if enc.bit in FUSED_BITS:
        return fused_decode_outerdim(enc)
    return quant_ops.tensor_decode_outerdim(enc)
