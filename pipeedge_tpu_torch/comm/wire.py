"""The wire-v2 frame: a payload encoded on its device, read back async.

Port of the v2 half of `pipeedge_tpu/comm/wire.py`. A frame is a list of
numpy arrays: the 1-D int32 header `[WIRE_V2_MAGIC, version, bit, flags,
n_payload]`, then per payload tensor either the raw array (bit 0) or the
quad `[packed words (uint32), scale, shift, shape (int64)]`, then, when
the header's FLAG_CRC bit is set, a `[algo, crc]` uint32 checksum over
every body tensor's bytes. The packing is the QuantPipe codec's, bit for
bit, so a frame this module writes decodes with the JAX package's
`wire_decode` and the reverse.

- `wire_encode_device(out, bit)` encodes on the payload's device (the
  codec kernel `ops/fused_quant.py` at bits 4 and 8 on the card, the
  plain ops otherwise) and starts the device-to-host copies of only the
  wire payload into pinned host buffers, fenced by one CUDA event; the
  returned `PendingWire` waits on that event in `finalize()`, so the
  caller can dispatch more work first.
- `wire_decode(frame, dtype, device=...)` verifies a CRC-flagged frame
  first (`WireCorruptError` on a mismatch) and decodes on `device` (the
  codec's decode kernel at bits 4 and 8 on the card).

The v1 host-encoded frame and the native host codec wait for ROADMAP A6
(the DCN driver); `wire_decode` refuses a v1 frame naming it.
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
    """A host tensor as the numpy array JAX would put on the wire: packed
    words as uint32, bfloat16 as `ml_dtypes.bfloat16`."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy has no bfloat16 of its own
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A frame array as a tensor on `device` (never aliasing a read-only
    frame buffer)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class PendingWire:
    """A v2 frame whose device-to-host copies may still be in flight.

    `parts` mixes numpy arrays (header, shapes) and host tensors (pinned,
    filled by async copies on the card); `event` (None on the CPU) was
    recorded after the copies. `finalize()` waits on it and returns the
    frame as numpy arrays, with the CRC trailer when `crc` is set."""

    __slots__ = ("parts", "crc", "event", "_words")

    def __init__(self, parts: List, crc: bool = False, event=None,
                 words: Sequence[int] = ()):
        self.parts = parts
        self.crc = bool(crc)
        self.event = event
        self._words = frozenset(words)   # indices of packed-word tensors

    def finalize(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        out = []
        for i, p in enumerate(self.parts):
            if isinstance(p, torch.Tensor):
                p = _to_numpy(p)
                if i in self._words:
                    p = p.view(np.uint32)
            out.append(np.asarray(p))
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
    words: List[int] = []
    if bit == 0:
        for t in tensors:
            parts.append(_start_host_copy(t))
    else:
        for t in tensors:
            enc = fused_quant.encode_outerdim(t, bit)
            words.append(len(parts))
            parts += [_start_host_copy(enc.data), _start_host_copy(enc.scale),
                      _start_host_copy(enc.shift),
                      np.asarray(enc.shape, np.int64)]
    event = None
    dev = tensors[0].device if tensors else torch.device("cpu")
    if dev.type == "cuda":
        event = torch.cuda.current_stream(dev).record_event()
    return PendingWire(parts, crc=crc, event=event, words=words)


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
        out = tuple(_from_numpy(np.asarray(t), device) for t in tensors)
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
                data=_from_numpy(np.asarray(data).view(np.int32), device),
                scale=_from_numpy(np.asarray(scale, np.float32), device),
                shift=_from_numpy(np.asarray(shift, np.float32), device),
                shape=tuple(int(s) for s in shape), bit=bit)
            out.append(fused_quant.decode_outerdim(enc).to(dtype))
        out = tuple(out)
    return out[0] if len(out) == 1 else out


def wire_decode(tensors: List[np.ndarray], dtype, *,
                device: DeviceLike):
    """Inverse of `wire_encode_device` (and of the JAX package's v2
    encoders): the stage payload (tensor or tuple) on `device`. A frame
    carrying the CRC trailer is verified first; a v1 frame is refused
    (its host codec waits for ROADMAP A6)."""
    with telemetry.span("quant", "decode"):
        header = np.asarray(tensors[0])
        if not _is_v2_header(header):
            raise ValueError("wire-v1 (host-encoded) frames are not ported "
                             "to pipeedge_tpu_torch yet (ROADMAP A6, the "
                             "DCN driver's device seam)")
        body = tensors[1:]
        if int(header[3]) & FLAG_CRC:
            if not body:
                raise ValueError("malformed v2 wire frame: FLAG_CRC set "
                                 "but no checksum tensor")
            body = verify_frame(body[:-1], body[-1])
        return _wire_decode_v2(header, body, dtype, resolve_device(device))


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
