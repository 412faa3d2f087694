"""The frames a stage output travels in: v2 (device-encoded) and v1 (host).

Port of `pipeedge_tpu/comm/wire.py`. A frame is a list of arrays. The v2
frame: the 1-D int32 header `[WIRE_V2_MAGIC, version, bit, flags,
n_payload]`, then per payload tensor either the raw array (bit 0) or the
quad `[packed words (uint32), scale, shift, shape (int64)]`, then, when
the header's FLAG_CRC bit is set, a `[algo, crc]` uint32 checksum over
every body tensor's bytes. The v1 frame: a 0-d int32 bitwidth, then the
same raw arrays or quads. The packing is the QuantPipe codec's, bit for
bit, so a frame this module writes decodes with the JAX package's
`wire_decode` and the reverse.

- `wire_encode_device(out, bit)` encodes on the payload's device (the
  codec kernel `ops/fused_quant.py` at bits 4 and 8 on the card, the
  plain ops otherwise) and starts the device-to-host copies of only the
  wire payload into pinned host buffers, fenced by one CUDA event; the
  returned `PendingWire` waits on that event in `finalize()`, so the
  caller can dispatch more work first. `device_frame()` hands the device
  tensors themselves (the colocated tier of `comm/dcn.py`), with the
  event the consumer's stream waits on.
- `wire_encode(out, bit)` is the v1 host encoder for a payload on the
  CPU: the native codec (`ops/native_quant.py`, built from
  `native/quantpack.cpp`) when it is available, else the plain ops. It
  refuses a payload on the card, which `wire_encode_device` encodes.
- `wire_decode(frame, dtype, device=...)` verifies a CRC-flagged frame
  first (`WireCorruptError` on a mismatch) and decodes on `device`: on
  the card through the codec's decode kernel at bits 4 and 8, for v1
  frames too; on the CPU a v1 frame takes the native codec when it is
  available.

bfloat16 travels as its 16-bit patterns in a `WireArray` (dtype code 14,
the JAX package's code), since numpy has no bfloat16 of its own and the
port does not use `ml_dtypes`.
"""
from __future__ import annotations

import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .. import telemetry
from ..ops import fused_quant
from ..ops import quant as quant_ops

# v2 header magic: v1's header is a 0-d int32 bitwidth (>= 0), so a 1-D
# header opening with a negative sentinel is unambiguous
WIRE_V2_MAGIC = -2
WIRE_V2_VERSION = 2
_V2_HEADER_LEN = 5
# flags bit 0: the payload was encoded on its device (informational)
FLAG_ON_DEVICE = 1
# flags bit 1: the frame ends with a [algo, crc] uint32 checksum over
# every body tensor's bytes
FLAG_CRC = 2

ENV_WIRE_CRC = "PIPEEDGE_WIRE_CRC"   # 1 = checksum every v2 frame

# DCN dtype codes (`comm/dcn.py` _DTYPES) of the three wire dtypes numpy
# lacks: bfloat16, and int4/uint4, which travel nibble-packed
CODE_BFLOAT16 = 14
CODE_INT4 = 15
CODE_UINT4 = 16


class WireArray(np.ndarray):
    """An array that names its DCN dtype code: the storage of a dtype
    numpy lacks (bfloat16 as int16 bit patterns, int4/uint4 one value per
    int8/uint8 byte). Views keep the code; `comm/dcn.py` frames the
    storage's bytes under the code, and checks that the storage dtype
    matches it."""

    def __new__(cls, data, code: int):
        obj = np.asarray(data).view(cls)
        obj.wire_code = int(code)
        return obj

    def __array_finalize__(self, obj):
        self.wire_code = getattr(obj, "wire_code", None)


class DeviceFrame(list):
    """A frame whose tensors may still be written by the device: `event`
    (a CUDA event, or None) fences them. What the colocated tier hands
    over; the consumer's stream waits on the event before it reads."""

    def __init__(self, tensors=(), event=None):
        super().__init__(tensors)
        self.event = event


# checksum algorithm ids (they travel in the checksum tensor): CRC32C
# when the `crc32c` wheel is importable, else zlib's CRC32
CRC_ALGO_CRC32C = 0
CRC_ALGO_CRC32 = 1
try:                               # pragma: no cover - env-dependent
    import crc32c as _crc32c_mod   # type: ignore
except ImportError:
    _crc32c_mod = None


def crc_enabled() -> bool:
    """Whether v2 frames carry an integrity checksum (env
    PIPEEDGE_WIRE_CRC)."""
    return os.getenv(ENV_WIRE_CRC, "0") == "1"


class WireCorruptError(ValueError):
    """A v2 frame's checksum did not match its payload bytes."""

    def __init__(self, expected: int, got: int):
        self.expected = int(expected)
        self.got = int(got)
        super().__init__(
            f"wire frame failed integrity check (checksum "
            f"{got:#010x} != expected {expected:#010x})")


def _checksum_fn(algo: int):
    if algo == CRC_ALGO_CRC32C and _crc32c_mod is not None:
        return _crc32c_mod.crc32c
    if algo == CRC_ALGO_CRC32:
        return zlib.crc32
    return None


def frame_checksum(tensors: Sequence,
                   algo: Optional[int] = None) -> Tuple[int, int]:
    """`(algo, crc)` over every tensor's raw bytes, in list order."""
    if algo is None:
        algo = (CRC_ALGO_CRC32C if _crc32c_mod is not None
                else CRC_ALGO_CRC32)
    fn = _checksum_fn(algo)
    if fn is None:
        raise ValueError(f"checksum algorithm {algo} unavailable")
    crc = 0
    for t in tensors:
        a = np.ascontiguousarray(np.asarray(t))
        crc = fn(a.reshape(-1).view(np.uint8).data, crc)
    return algo, crc & 0xFFFFFFFF


def locate_crc_header(tensors: Sequence, scan: int = 3) -> Optional[int]:
    """Index of the CRC-flagged v2 header within a frame's tensor list
    (it may follow a prepended microbatch-id tensor), or None."""
    for i, t in enumerate(tensors[:scan]):
        a = np.asarray(t)
        if _is_v2_header(a) and int(a[3]) & FLAG_CRC:
            return i
    return None


def verify_frame(body: Sequence, crc_tensor) -> Sequence:
    """Check `body` against a frame's `[algo, crc]` tensor; returns
    `body`, raises `WireCorruptError` on a mismatch. An unknown
    algorithm (a newer producer) leaves the frame unverified."""
    vals = np.asarray(crc_tensor, np.uint32).reshape(-1)
    algo, expected = int(vals[0]), int(vals[1])
    if _checksum_fn(algo) is None:  # pragma: no cover - future algos
        return body
    _, got = frame_checksum(body, algo=algo)
    if got != expected:
        raise WireCorruptError(expected, got)
    return body


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array JAX would put on the wire: packed words
    as uint32 (by the caller), bfloat16 as a `WireArray` of its bits."""
    if t.dtype == torch.bfloat16:
        return WireArray(t.view(torch.int16).numpy(), CODE_BFLOAT16)
    return t.numpy()


def _from_numpy(a, device: torch.device) -> torch.Tensor:
    """A frame tensor (array, or a tensor of a colocated hand-off) as a
    tensor on `device` (never aliasing a read-only frame buffer). The
    copy of a host array to the card returns once the bytes have left the
    host buffer, so a pooled receive buffer may be reused after it."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    bf16 = (getattr(a, "wire_code", None) == CODE_BFLOAT16
            or a.dtype.name == "bfloat16")
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(a)).to(device)


def _words(a, device: torch.device) -> torch.Tensor:
    """Packed words (uint32 on the wire, int32 in a tensor) on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return _from_numpy(np.asarray(a).view(np.int32), device)


def _floats(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return _from_numpy(np.asarray(a, np.float32), device)


class PendingWire:
    """A v2 frame whose device-to-host copies may still be in flight.

    `parts` mixes numpy arrays (header, shapes) and host tensors (pinned,
    filled by async copies on the card); `device_parts` holds the same
    frame with the device tensors in place of their host copies; `event`
    (None on the CPU) was recorded after the copies. `finalize()` waits on
    it (and on nothing else: the stream keeps running) and returns the
    frame as numpy arrays, with the CRC trailer when `crc` is set."""

    __slots__ = ("parts", "device_parts", "crc", "event", "_words")

    def __init__(self, parts: List, crc: bool = False, event=None,
                 words: Sequence[int] = (),
                 device_parts: Optional[List] = None):
        self.parts = parts
        self.device_parts = parts if device_parts is None else device_parts
        self.crc = bool(crc)
        self.event = event
        self._words = frozenset(words)   # indices of packed-word tensors

    def device_frame(self) -> DeviceFrame:
        """The frame with its device tensors, for a consumer in this
        process: no readback, no checksum (there is no wire to corrupt);
        the consumer's stream waits on `event` before reading."""
        return DeviceFrame(self.device_parts, self.event)

    def finalize(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        out = []
        for i, p in enumerate(self.parts):
            if isinstance(p, torch.Tensor):
                p = _to_numpy(p)
                if i in self._words:
                    p = p.view(np.uint32)
            out.append(p if isinstance(p, np.ndarray) else np.asarray(p))
        if self.crc:
            header = out[0].copy()
            header[3] |= FLAG_CRC
            out[0] = header
            algo, crc = frame_checksum(out[1:])
            out.append(np.asarray([algo, crc], np.uint32))
        return out


def _start_host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that holds (or, on the card, will hold once the
    stream reaches the copy) the value of `t`."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.contiguous().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def wire_encode_device(out, bit: int,
                       crc: Optional[bool] = None) -> PendingWire:
    """Stage output (tensor or tuple) -> pending v2 frame: encoded on the
    payload's device, read back asynchronously (only the packed words
    and per-item scale/shift at bit > 0; the raw arrays at bit 0). Never
    waits for the device. `crc` arms the checksum trailer (default: env
    PIPEEDGE_WIRE_CRC), computed at `finalize()`."""
    with telemetry.span("quant", f"encode_device{bit}"):
        return _wire_encode_device_timed(
            out, bit, crc_enabled() if crc is None else bool(crc))


def _wire_encode_device_timed(out, bit: int, crc: bool) -> PendingWire:
    tensors = out if isinstance(out, tuple) else (out,)
    header = np.asarray([WIRE_V2_MAGIC, WIRE_V2_VERSION, bit, FLAG_ON_DEVICE,
                         len(tensors)], np.int32)
    parts: List = [header]
    device_parts: List = [header]
    words: List[int] = []
    if bit == 0:
        for t in tensors:
            parts.append(_start_host_copy(t))
            device_parts.append(t.detach())
    else:
        for t in tensors:
            enc = fused_quant.encode_outerdim(t, bit)
            words.append(len(parts))
            shape = np.asarray(enc.shape, np.int64)
            parts += [_start_host_copy(enc.data), _start_host_copy(enc.scale),
                      _start_host_copy(enc.shift), shape]
            device_parts += [enc.data, enc.scale, enc.shift, shape]
    event = None
    dev = tensors[0].device if tensors else torch.device("cpu")
    if dev.type == "cuda":
        event = torch.cuda.current_stream(dev).record_event()
    return PendingWire(parts, crc=crc, event=event, words=words,
                       device_parts=device_parts)


def native_wire_codec(bit: int):
    """The native host-side codec when it is built and takes this
    bitwidth, else None."""
    if bit == 0 or bit > 16:
        return None
    from ..ops import native_quant
    return native_quant if native_quant.available() else None


def wire_encode(out, bit: int) -> List[np.ndarray]:
    """Stage output (tensor or tuple) on the CPU -> v1 frame, encoded on
    the host (the native codec when available, else the plain ops). A
    payload on another device is refused: `wire_encode_device` encodes it
    where it lies."""
    tensors = out if isinstance(out, tuple) else (out,)
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(
                f"wire_encode encodes on the host and was given a tensor on "
                f"{t.device}; encode it there with wire_encode_device")
    with telemetry.span("quant", f"encode{bit}"):
        return _wire_encode_timed(tensors, bit)


def _wire_encode_timed(tensors, bit: int) -> List[np.ndarray]:
    wire: List[np.ndarray] = [np.asarray(bit, np.int32)]
    if bit == 0:
        return wire + [_to_numpy(t.detach()) for t in tensors]
    native = native_wire_codec(bit)
    for t in tensors:
        t = t.detach().float()
        if native is not None:
            packed, scale, shift = native.encode_outerdim(t.numpy(), bit)
        else:
            enc = quant_ops.tensor_encode_outerdim(t, bit)
            packed = quant_ops.words_u32(enc)
            scale, shift = enc.scale.numpy(), enc.shift.numpy()
        wire += [packed, scale, shift, np.asarray(t.shape, np.int64)]
    return wire


def _is_v2_header(header: np.ndarray) -> bool:
    return (header.ndim == 1 and header.size >= _V2_HEADER_LEN
            and header.dtype.kind == 'i' and int(header[0]) == WIRE_V2_MAGIC)


def _wire_decode_v2(header, tensors, dtype, device: torch.device):
    """Decode a v2 body on `device` (the codec's decode at bits 4/8)."""
    bit = int(header[2])
    n_payload = int(header[4])
    if bit == 0:
        if len(tensors) != n_payload:
            raise ValueError(
                f"malformed v2 wire frame: {len(tensors)} tensors after the "
                f"header (expected {n_payload} raw payloads)")
        out = tuple(_from_numpy(t, device) for t in tensors)
    else:
        if len(tensors) != 4 * n_payload:
            raise ValueError(
                f"malformed v2 wire frame: {len(tensors)} tensors after the "
                f"header (expected {4 * n_payload}: packed/scale/shift/shape "
                f"per payload)")
        out = []
        for i in range(0, len(tensors), 4):
            data, scale, shift, shape = tensors[i:i + 4]
            enc = quant_ops.QuantizedTensor(
                data=_words(data, device), scale=_floats(scale, device),
                shift=_floats(shift, device),
                shape=tuple(int(s) for s in shape), bit=bit)
            out.append(fused_quant.decode_outerdim(enc).to(dtype))
        out = tuple(out)
    return out[0] if len(out) == 1 else out


def _wire_decode_v1(bit: int, tensors, dtype, device: torch.device):
    """Decode a v1 body: on the card through the codec's decode (as a v2
    body), on the CPU through the native codec when it is available."""
    if bit and len(tensors) % 4:
        raise ValueError(
            f"malformed quantized wire frame: {len(tensors)} tensors "
            "after the bitwidth header (expected a multiple of 4: "
            "packed/scale/shift/shape per payload)")
    native = native_wire_codec(bit) if device.type == "cpu" else None
    if native is None:
        n_payload = len(tensors) // 4 if bit else len(tensors)
        header = np.asarray([WIRE_V2_MAGIC, WIRE_V2_VERSION, bit, 0,
                             n_payload], np.int32)
        return _wire_decode_v2(header, tensors, dtype, device)
    out = []
    for i in range(0, len(tensors), 4):
        data, scale, shift, shape = tensors[i:i + 4]
        dec = native.decode_outerdim(data, scale, shift,
                                     tuple(int(s) for s in shape), bit)
        out.append(torch.from_numpy(dec).to(device=device, dtype=dtype))
    return out[0] if len(out) == 1 else tuple(out)


def wire_decode(tensors: List, dtype, *, device: DeviceLike):
    """Inverse of `wire_encode_device` and `wire_encode` (and of the JAX
    package's encoders): the stage payload (tensor or tuple) on `device`.
    A frame carrying the CRC trailer is verified first. A `DeviceFrame`
    from a colocated producer is read after the current stream waits on
    its event."""
    with telemetry.span("quant", "decode"):
        device = resolve_device(device)
        event = getattr(tensors, "event", None)
        if event is not None and device.type == "cpu":
            event.synchronize()     # the host reads the producer's tensors
        elif event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in tensors:
                # made on the producer's stream, read on this one: the
                # allocator must not reuse it before this stream is done
                if isinstance(t, torch.Tensor) and t.device == device:
                    t.record_stream(stream)
        header = np.asarray(tensors[0])
        body = tensors[1:]
        if not _is_v2_header(header):
            return _wire_decode_v1(int(header), body, dtype, device)
        if int(header[3]) & FLAG_CRC:
            if not body:
                raise ValueError("malformed v2 wire frame: FLAG_CRC set "
                                 "but no checksum tensor")
            body = verify_frame(body[:-1], body[-1])
        return _wire_decode_v2(header, body, dtype, device)


# -- wire byte accounting ---------------------------------------------

def frame_wire_bytes(tensors: Sequence) -> int:
    """Total bytes of a frame's tensor list (header, payload, scales,
    shapes, checksum)."""
    return sum(int(t.nbytes) for t in tensors)


def frame_payload_bytes(tensors: Sequence) -> int:
    """Activation-payload bytes of a frame: the packed words at bit > 0,
    the raw arrays at bit 0, without the metadata (header, scale/shift,
    shapes, checksum)."""
    header = np.asarray(tensors[0])
    body = list(tensors[1:])
    if _is_v2_header(header):
        bit = int(header[2])
        if int(header[3]) & FLAG_CRC and body:
            body = body[:-1]    # the integrity trailer is metadata
    else:
        bit = int(header)
    if bit == 0:
        return sum(int(t.nbytes) for t in body)
    return sum(int(body[i].nbytes) for i in range(0, len(body), 4))
