"""QuantPipe activation encode/decode as plain PyTorch ops.

Port of `pipeedge_tpu/ops/quant.py` (itself parity with the reference
QuantPipe `basic_op.py`). Same wire format and the same f32 op order, so
an encode here gives the same packed words, scale and shift as the JAX
ops on the same input:

  shift = min(x); scale = max(x - shift); q = round((x-shift)/scale * (2^b-1))
  decode: q / (2^b-1) * scale + shift

Each item along the leading (microbatch) axis is quantized on its own
(`*_outerdim`); the batch axis is written out where JAX used `vmap`.

Words: torch has no shifts or `min` for `torch.uint32` on the CPU, so
values pack in int64 and the 32-bit words are stored with their exact
bits as `int32`. `words_u32` views them as numpy `uint32`.

Division by a tensor, never by a Python number: on CUDA PyTorch turns
`tensor / python_float` into a multiply by the reciprocal, which is not
IEEE division. Dividing by a one-element tensor on the same device keeps
the division exact on both devices, so the plain version and the CUDA
codec kernel agree bit for bit on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Discrete bitwidths the runtime's adaptive policies select among
# (reference runtime.py:142-153). 0 means "no quantization".
SUPPORTED_BITS = (0, 1, 2, 3, 4, 5, 6, 8, 16, 32)

_U32_MAX = (1 << 32) - 1


def compression_factor(bit: int) -> float:
    """Data-size improvement for a bitwidth > 0 (reference basic_op.py:109-111)."""
    return 32.0 / bit


def packed_words(n_values: int, bit: int) -> int:
    """Number of 32-bit words needed to pack `n_values` `bit`-wide ints."""
    per_word = 32 // bit
    return -(-n_values // per_word)


@dataclasses.dataclass
class QuantizedTensor:
    """Fixed-shape quantized activation payload (the inter-stage wire format).

    data:  int32 [leading..., words] packed words, exact uint32 bits
           (the raw tensor when bit=0)
    scale: float32 [leading...] per-item scale factors
    shift: float32 [leading...] per-item shifts
    shape: logical shape of the decoded tensor
    bit:   bitwidth (0 = passthrough)
    """
    data: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    shape: Tuple[int, ...]
    bit: int

    @property
    def nbytes_wire(self) -> int:
        """Bytes on the wire (packed payload only)."""
        return self.data.numel() * 4


def words_u32(enc: QuantizedTensor) -> np.ndarray:
    """The packed words as numpy `uint32` (same bits as `enc.data`)."""
    return enc.data.detach().cpu().numpy().view(np.uint32)


def _pack_bits(ints: torch.Tensor, bit: int) -> torch.Tensor:
    """Pack int64 [..., n] `bit`-wide values into int32 words [..., words].

    Value i goes to word i // per_word at bit offset (i % per_word) * bit;
    the tail pads with zero values (reference basic_op.py:38-55)."""
    per_word = 32 // bit
    n = ints.shape[-1]
    n_pad = packed_words(n, bit) * per_word - n
    if n_pad:
        ints = F.pad(ints, (0, n_pad))
    grouped = ints.reshape(*ints.shape[:-1], -1, per_word)
    # the bitwise OR of the shifted values, each cut to 32 bits, as the
    # JAX package's uint32 shift-or: a saturated code (0xFFFFFFFF, from a
    # non-finite quotient) spills over its neighbours' bits there too
    words = grouped[..., 0] & _U32_MAX
    for j in range(1, per_word):
        words = words | ((grouped[..., j] << (j * bit)) & _U32_MAX)
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


def _unpack_bits(words: torch.Tensor, bit: int, n_values: int) -> torch.Tensor:
    """Inverse of `_pack_bits`: int32 words [..., words] -> int64 [..., n]."""
    per_word = 32 // bit
    w = words.to(torch.int64) & _U32_MAX
    shifts = torch.arange(per_word, device=words.device,
                          dtype=torch.int64) * bit
    values = (w.unsqueeze(-1) >> shifts) & ((1 << bit) - 1)
    return values.reshape(*words.shape[:-1], -1)[..., :n_values]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on `like`'s device (filled there: no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _quantize_items(flat: torch.Tensor, bit: int, mode: str):
    """Quantize each row of f32 [B, n] to (words [B, W], scale [B], shift [B]).

    'original': q = round(x01 * (2^b - 1)); 'modified': q = clip(floor(
    x01 * 2^b), 0, 2^b - 1) (reference basic_op.py:17-29). A zero-range
    item (scale == 0) divides by 1 instead of producing NaN."""
    shift = flat.amin(dim=-1, keepdim=True)
    scale = (flat - shift).amax(dim=-1, keepdim=True)
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    x01 = (flat - shift) / safe_scale
    if mode == "original":
        q = torch.round(x01 * float((1 << bit) - 1))
    elif mode == "modified":
        levels = float(1 << bit)
        q = torch.clamp(torch.floor(x01 * levels), 0.0, levels - 1.0)
    else:
        raise ValueError(f"mode must be 'original' or 'modified', got {mode!r}")
    return _pack_bits(_saturate_u32(q), bit), scale[..., 0], shift[..., 0]


def _saturate_u32(q: torch.Tensor) -> torch.Tensor:
    """f32 -> uint32 codes as XLA's convert gives them, in int64: NaN -> 0,
    below 0 -> 0, 2^32 and above (+inf included) -> 0xFFFFFFFF. Finite
    input keeps q in [0, 2^b - 1], where this is the plain cast; bit 32
    reaches 2^32, and an item whose scale or shift is not finite gives
    NaN and infinite quotients (tests/test_torch_quant.py)."""
    q = torch.nan_to_num(q.double(), nan=0.0, posinf=float(_U32_MAX))
    return q.clamp_(0.0, float(_U32_MAX)).to(torch.int64)


def _dequantize_items(words: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, n: int, bit: int) -> torch.Tensor:
    """int32 words [B, W] -> f32 [B, n]: q / levels * scale + shift."""
    q = _unpack_bits(words, bit, n).to(torch.float32)
    levels = _scalar(float((1 << bit) - 1), q)
    return q / levels * scale[..., None] + shift[..., None]


def tensor_encode(x: torch.Tensor, bit: int,
                  mode: str = "original") -> QuantizedTensor:
    """Encode a whole tensor with one scale/shift (reference basic_op.py:114-143)."""
    shape = tuple(x.shape)
    if bit == 0:
        return QuantizedTensor(data=x, scale=_scalar(1.0, x),
                               shift=_scalar(0.0, x), shape=shape, bit=0)
    data, scale, shift = _quantize_items(
        x.reshape(1, -1).to(torch.float32), bit, mode)
    return QuantizedTensor(data=data[0], scale=scale[0], shift=shift[0],
                           shape=shape, bit=bit)


def tensor_decode(enc: QuantizedTensor) -> torch.Tensor:
    """Decode `tensor_encode` output (reference basic_op.py:146-163)."""
    if enc.bit == 0:
        return enc.data
    n = int(np.prod(enc.shape))
    return _dequantize_items(enc.data[None], enc.scale[None], enc.shift[None],
                             n, enc.bit).reshape(enc.shape)


def tensor_encode_outerdim(x: torch.Tensor, bit: int,
                           mode: str = "original") -> QuantizedTensor:
    """Quantize each item along the leading (microbatch) axis on its own
    (reference basic_op.py:166-170)."""
    shape = tuple(x.shape)
    b = shape[0]
    if bit == 0:
        return QuantizedTensor(
            data=x, scale=torch.ones(b, dtype=torch.float32, device=x.device),
            shift=torch.zeros(b, dtype=torch.float32, device=x.device),
            shape=shape, bit=0)
    data, scale, shift = _quantize_items(
        x.reshape(b, -1).to(torch.float32), bit, mode)
    return QuantizedTensor(data=data, scale=scale, shift=shift, shape=shape,
                           bit=bit)


def tensor_decode_outerdim(enc: QuantizedTensor) -> torch.Tensor:
    """Decode `tensor_encode_outerdim` output (reference basic_op.py:173-176)."""
    if enc.bit == 0:
        return enc.data
    n = int(np.prod(enc.shape[1:]))
    return _dequantize_items(enc.data, enc.scale, enc.shift, n,
                             enc.bit).reshape(enc.shape)

