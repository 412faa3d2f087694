"""KV shipping, the frame half: finished prompt KV rows as wire-v2 frames.

Port of the frame half of `pipeedge_tpu/kv/ship.py`. What travels is a
request's (or a cached prefix's) per-stage KV rows `[n_blocks, B,
prompt_len, H, Dh]` plus the last stage's final-position logits `[B,
V]`, as one flat list of numpy arrays:

    [kv_header, logits, stage 0's v2 frame..., stage 1's v2 frame..., ...]

Each stage rides one wire-v2 frame (`comm/wire.py`): the raw rows at
`bits=0` (exact), the codec's 8-bit quads at `bits=8` (the codec kernels
on the card), with the optional CRC trailer. The packing is the JAX
package's, so a bundle either package encodes decodes in the other.
`frames_to_bytes`/`frames_from_bytes` give the byte form the router's
`/kv/export` and `/kv/import` carry (base64 around it).

Logits always ship exact: quantizing the pick's input would change
tokens.

The socket half: `ship_over_socket` rounds one blob through a real
loopback socket pair (length-prefixed, a feeder thread at the far end),
the path `kv/disagg.py`'s `wire` prefill fleet ships whole requests
through. `SHIP_PATHS` names the in-process prefill fleet's transports.
"""
from __future__ import annotations

import contextlib
import io
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike
from ..comm import wire

# distinct from WIRE_V2_MAGIC (-2): a bundle opens with its own sentinel,
# so a misrouted frame fails loudly, not as a shape error
KV_SHIP_MAGIC = -7
KV_SHIP_VERSION = 1
_LEAVES = ("k", "v")     # fp cache leaves, in shipped order

SHIP_PATHS = ("local", "wire")


@contextlib.contextmanager
def device_stream(device: torch.device):
    """Where ship work runs: the device's default stream on a GPU (the
    serving executors enqueue there, so a handle made or decoded in
    another thread is ordered before its install) and inference mode
    (thread-local, so every thread that touches a handle enters it)."""
    stream = (torch.cuda.stream(torch.cuda.default_stream(device))
              if device.type == "cuda" else contextlib.nullcontext())
    with stream, torch.inference_mode():
        yield


def encode_kv_ship(caches: Sequence[Dict], prompt_len: int, logits,
                   bits: int = 0, crc: Optional[bool] = None) \
        -> List[np.ndarray]:
    """Per-stage dense caches (+ final logits) -> one flat tensor list.
    Only the first `prompt_len` cache positions ship. fp caches only:
    an int8 cache's scale rows have no codec lane (quantize on the wire
    with `bits=8` instead)."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    if bits not in (0, 8):
        raise ValueError(f"kv ship bits must be 0 (exact) or 8, "
                         f"got {bits}")
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    logits = np.asarray(logits, np.float32)
    if logits.ndim != 2:
        raise ValueError(f"logits must be [B, V], got {logits.shape}")
    pending = []
    for cache in caches:
        if set(cache) != set(_LEAVES):
            raise ValueError(
                "kv ship covers fp caches (leaves k/v); this cache has "
                f"{sorted(cache)} — int8 CACHES don't ship (use "
                "bits=8 to quantize on the wire instead)")
        rows = tuple(cache[name][:, :, :prompt_len] for name in _LEAVES)
        pending.append(wire.wire_encode_device(rows, bits, crc=crc))
    # every stage's copies are in flight before the first wait
    frames: List[np.ndarray] = []
    for p in pending:
        frames.extend(p.finalize())
    header = np.asarray([KV_SHIP_MAGIC, KV_SHIP_VERSION, bits,
                         len(caches), prompt_len, logits.shape[0]],
                        np.int64)
    return [header, logits] + frames


def _v2_span(tensors: Sequence[np.ndarray], start: int) -> int:
    """Tensor count of the v2 frame starting at `tensors[start]`."""
    header = np.asarray(tensors[start])
    if not (header.ndim == 1 and header.size >= 5
            and header.dtype.kind == "i"
            and int(header[0]) == wire.WIRE_V2_MAGIC):
        raise ValueError("malformed kv-ship bundle: expected a wire-v2 "
                         f"frame header at tensor {start}")
    bit, flags, n_payload = (int(header[2]), int(header[3]),
                             int(header[4]))
    span = 1 + (n_payload if bit == 0 else 4 * n_payload)
    if flags & wire.FLAG_CRC:
        span += 1
    return span


def decode_kv_ship(tensors: Sequence[np.ndarray], dtype, *,
                   device: DeviceLike) -> dict:
    """Inverse of `encode_kv_ship`: `{"stage_rows": [{k, v} per stage]
    (tensors on `device`), "logits", "prompt_len"}`, the install handle
    of `PagedKvBackend.install_prefix`. CRC-flagged frames are verified;
    corruption raises `wire.WireCorruptError`."""
    header = np.asarray(tensors[0])
    if not (header.ndim == 1 and header.size >= 6
            and int(header[0]) == KV_SHIP_MAGIC):
        raise ValueError("not a kv-ship bundle (bad magic header)")
    if int(header[1]) != KV_SHIP_VERSION:
        raise ValueError(f"kv-ship version {int(header[1])} "
                         f"(this decoder speaks {KV_SHIP_VERSION})")
    n_stages, prompt_len = int(header[3]), int(header[4])
    logits = np.asarray(tensors[1], np.float32)
    stage_rows: List[Dict] = []
    at = 2
    for _ in range(n_stages):
        span = _v2_span(tensors, at)
        payload = wire.wire_decode(list(tensors[at:at + span]), dtype,
                                   device=device)
        at += span
        if not isinstance(payload, tuple) or len(payload) != len(_LEAVES):
            raise ValueError("malformed kv-ship stage frame: expected "
                             f"{len(_LEAVES)} payload tensors")
        stage_rows.append(dict(zip(_LEAVES, payload)))
    if at != len(tensors):
        raise ValueError(f"kv-ship bundle has {len(tensors) - at} "
                         "trailing tensor(s)")
    return {"stage_rows": stage_rows, "logits": logits,
            "prompt_len": prompt_len}


# -- byte-stream form ---------------------------------------------------

def frames_to_bytes(tensors: Sequence[np.ndarray]) -> bytes:
    """Tensor list -> one bytes blob (npz container, order-preserving)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"t{i}": np.asarray(t)
                     for i, t in enumerate(tensors)})
    return buf.getvalue()


def frames_from_bytes(blob: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return [z[f"t{i}"] for i in range(len(z.files))]


def ship_over_socket(blob: bytes) -> bytes:
    """Round one blob through a real loopback socket pair (length-
    prefixed), a writer thread feeding the far end: the bytes leave and
    re-enter the process through the socket machinery, so framing and
    CRC faults surface here, not on a multi-host fleet."""
    a, b = socket.socketpair()
    try:
        def feed():
            with a:
                a.sendall(struct.pack("!Q", len(blob)))
                a.sendall(blob)

        t = threading.Thread(target=feed, daemon=True,
                             name="kv-ship-feeder")
        t.start()
        with b:
            need = struct.unpack("!Q", _read_exact(b, 8))[0]
            out = _read_exact(b, need)
        t.join(timeout=60)
        return out
    finally:
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    # the exact-read primitive is comm/dcn.py's (recv_into, no flattening
    # copy), imported here so that importing the ship codec never pulls
    # the DCN runtime in
    from ..comm.dcn import _recv_exact
    return bytes(_recv_exact(sock, n))
