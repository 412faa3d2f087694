"""PipeEdge's own transport: framed TCP between ranks, one process each.

Port of `pipeedge_tpu/comm/dcn.py`. Every rank runs a listener; links are
dialed lazily and identified by a HELLO frame. A frame is a fixed header
(message type, aux, channel, tensor count), then per tensor a dtype code,
its shape and its raw bytes, the same bytes as the JAX package's frame,
so a port rank and a JAX rank talk to each other.

- dtype enum: `_DTYPES`, the reference's TORCH_TYPES order (p2p:24-38)
  plus bfloat16 (code 14) and the nibble-packed int4/uint4 (codes 15 and
  16). numpy has none of the last three without `ml_dtypes`, which the
  port does not use: such a tensor travels as a `wire.WireArray`, an
  array of its storage (the 16-bit patterns of bfloat16, one byte per
  4-bit value) that names its code. A CPU `torch.bfloat16` tensor is
  taken as well.
- command channel: CMD frames carry (cmd, tensors) to every peer over
  dedicated connections (the reference's `cmd_broadcast` on tag 10).
- liveness: heartbeats on the command connections, a reconnect grace
  window, epoch fencing of a dead incarnation and the JOIN handshake.
- tiers (`negotiate_edge_path`): `local` when both ranks live in this
  process (device tensors hand off through the consumer's queue, the
  consumer's stream waiting on the producer's event), `zerocopy` (pooled
  receive buffers) or `socket_v2` otherwise.
- `DcnPipelineStage` wires recv -> dispatch -> readback -> send with
  bounded hand-off queues (reference ConditionQueue maxsize=1,
  p2p:88-93), at `depth` microbatches each.

Fault injection (`comm/chaos.py`, the `DCN_CHAOS` spec) wraps a
context's `send_tensors`; its `corrupt@K` flips one bit of a frame here,
below the integrity layer (`_send_tensors_once`, on a copy).
"""
from __future__ import annotations

import logging
import os
import queue
import socket
import struct
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import CMD_STOP, DistContext
from . import wire as wire_codec
from .wire import CODE_BFLOAT16, CODE_INT4, CODE_UINT4, WireArray
from .. import telemetry
from ..telemetry import metrics as prom
from ..utils.threads import make_lock

logger = logging.getLogger(__name__)

# dtype enum (reference TORCH_TYPES, p2p/__init__.py:24-38): the numpy
# dtype of each code, and for the three codes numpy lacks the storage
# dtype of their `WireArray`
_DTYPES: List[np.dtype] = [np.dtype(d) for d in (
    'float16', 'float32', 'float64', 'uint8', 'int8', 'int16', 'int32',
    'int64', 'bool', 'complex64', 'complex128', 'uint16', 'uint32',
    'uint64')]
_STORAGE: Dict[int, np.dtype] = {CODE_BFLOAT16: np.dtype(np.int16),
                                 CODE_INT4: np.dtype(np.int8),
                                 CODE_UINT4: np.dtype(np.uint8)}
# the same codes by the name `ml_dtypes` gives their numpy dtypes, so an
# array a caller made with it still frames (the port never imports it)
_CODE_BY_NAME = {"bfloat16": CODE_BFLOAT16, "int4": CODE_INT4,
                 "uint4": CODE_UINT4}
# 4-bit codes travel nibble-packed: ceil(n/2) wire bytes for n values
_NIBBLE_CODES = frozenset((CODE_INT4, CODE_UINT4))

_MSG_TENSORS = 1
_MSG_CMD = 2
_MSG_HELLO = 3
# per-edge bitwidth negotiation on the control channel (aux = bitwidth):
# answered directly by the receiving reader thread, no app wiring needed
_MSG_NEG = 4
_MSG_NEG_ACK = 5
# liveness plane (aux = sender rank): periodic no-payload frames on the
# dedicated command connections. A closed socket already raises on its
# reader; heartbeats additionally catch a HUNG peer — process frozen,
# sockets still open — which no amount of stream-error handling can see.
_MSG_HEARTBEAT = 6
# telemetry collection (aux = probe flag): a `_MSG_SPANS` request is
# answered inline by the receiving reader thread with a `_MSG_SPANS_ACK`
# carrying [t_rx, t_tx] receiver timestamps + the receiver's span ring as a
# uint8 JSON blob (empty when span recording is off). The same exchange
# doubles as the NTP-style clock probe `collect_spans` aligns ranks with.
_MSG_SPANS = 7
_MSG_SPANS_ACK = 8
# elastic membership plane (aux = joiner's epoch): a restarted (or late)
# peer asks to be re-admitted over the command channel. The receiver
# un-deads the rank (cancels pending death timers, resets the heartbeat
# watch) when the epoch is NEWER than every incarnation it has fenced,
# and replies _MSG_JOIN_ACK (aux = receiver's epoch; -1 = refused).
_MSG_JOIN = 9
_MSG_JOIN_ACK = 10
# tiered-transport negotiation (aux = path-tier code): a producing rank
# asks the consuming rank which transport tier its edge should ride —
# answered inline by the receiving reader thread like `_MSG_NEG`. The
# receiver grants the COLOCATED tier only when the proposer's context is
# registered in this very process (the hand-off is a direct queue put of
# device buffers, so both ends must share an address space), else the
# zero-copy socket tier when its receive pool is enabled, else legacy v2.
_MSG_PATH = 11
_MSG_PATH_ACK = 12
# request-scoped tracing (docs/OBSERVABILITY.md): a `_MSG_TENSORS` frame
# whose FIRST tensor is a uint8 JSON trace-context blob (telemetry.
# TraceContext.to_wire). The reader strips the blob and delivers the
# remaining tensors exactly like a plain data frame, with the decoded
# context as queue metadata — so stage workers' dispatch/readback/emit
# spans and per-edge transfer spans inherit the request id fleet-wide.
# Wire-v2 compatible by construction: plain `_MSG_TENSORS` frames stay
# byte-identical (absent = untraced), and an undecodable/truncated blob
# degrades to untraced (counted), never to a dead reader.
_MSG_TENSORS_TRACED = 13
# heartbeat RTT echo (aux = the echoed beat sequence number): a beat that
# carries a sequence-number payload is answered inline by the receiving
# reader with this ack, so the beat sender can measure the command-plane
# round trip per peer — the latency signal the gray-failure detector
# (pipeedge_tpu/health/) consumes; beats without the payload (older
# peers) simply go unanswered and keep their pure-liveness meaning.
_MSG_HEARTBEAT_ACK = 14
# frame-integrity recovery (aux = the corrupt frame's per-edge sequence
# number, -1 = latest; payload = [channel int32]): the receiving READER
# verifies CRC-flagged frames in flight and, on a checksum mismatch,
# drops the frame and asks the producer to re-send it BY SEQUENCE
# NUMBER — with PIPEEDGE_WIRE_CRC armed, data-frame headers carry a
# per-(dst, channel) seq in the aux field, and the producer keeps the
# last RESEND_CACHE_DEPTH clean frames per edge (pipelined sends mean
# "the last frame" may already be a LATER one; the seq address makes the
# replay exact). Each cached frame replays at most max(1, send_retries)
# times — the bounded redial+resend the integrity satellite reuses
# DCN_SEND_RETRIES for. A cache miss (producer restarted, cap hit,
# frame aged out) means the frame is lost and the round's normal
# timeout/failover semantics apply.
_MSG_RESEND = 15
_SPANS_PROBE = 1    # aux: timestamps only (clock probe)
_SPANS_REQUEST = 0  # aux: timestamps + span ring
_SPANS_DIGEST = 2   # aux: timestamps + cumulative duration digest — the
# per-round rebalance collection (kilobytes of (cat,name,stage) rollups;
# durations only, so no clock alignment and no full trace required)

# wire bitwidths a context accepts by default for its inbound quantized
# edges (ops/quant.py SUPPORTED_BITS, restatable per context so a peer
# without e.g. the sub-byte decode path can cap its producers)
DEFAULT_EDGE_BITS = (0, 1, 2, 3, 4, 5, 6, 8, 16, 32)

# Liveness / transient-fault knobs (env defaults; constructor args and the
# runtime CLI override). Interval 0 disables the heartbeat plane entirely.
ENV_HEARTBEAT_INTERVAL = "DCN_HEARTBEAT_INTERVAL"   # seconds between beats
ENV_HEARTBEAT_MISS = "DCN_HEARTBEAT_MISS"           # missed-beat threshold
ENV_RECONNECT_GRACE = "DCN_RECONNECT_GRACE"         # seconds a dropped peer
# may reconnect before its death is confirmed (0 = declare immediately)
ENV_SEND_RETRIES = "DCN_SEND_RETRIES"               # redial+resend attempts
ENV_EPOCH = "DCN_EPOCH"                             # this rank's incarnation
# number (0 = first launch). A restarted rank MUST come up with a higher
# epoch than the incarnation that died, or its JOIN is refused and its
# frames stay fenced (an orchestrator relaunches it with the epoch
# incremented).
DEFAULT_HEARTBEAT_MISS = 3

# -- tiered inter-stage transport (docs/DCN_WIRE.md selection matrix) ----
# Per edge, the producer negotiates the cheapest path the consumer can
# serve (`negotiate_edge_bits` idiom, `_MSG_PATH` on the control channel):
#
#   local      colocated ranks (same process): device buffers hand off
#              through the consumer context's bounded recv queue directly —
#              no serialize, no D2H/H2D round trip, no socket. The wire
#              protocol's framing (src, epoch, channel) rides as queue
#              metadata; epoch fencing, liveness signs, and the monitor
#              hooks behave exactly like the socket reader's.
#   zerocopy   remote edges: scatter-gather `sendmsg` writes (no flattening
#              copy — the pre-existing send path) paired with POOLED
#              receive buffers: payloads land via `recv_into` in reusable
#              buffers and surface as ndarray views, eliminating the
#              per-tensor bytes() copy. Buffers recycle only when no
#              consumer still references them (refcount ownership), so a
#              retained array — the failover ledger, a replay — can never
#              observe a recycled buffer.
#   socket_v2  the legacy copy-on-receive socket path (fallback, and the
#              A/B baseline: DCN_RECV_POOL=0).
PATH_SOCKET_V2 = "socket_v2"
PATH_ZEROCOPY = "zerocopy"
PATH_LOCAL = "local"
PATH_CODES = {PATH_SOCKET_V2: 0, PATH_ZEROCOPY: 1, PATH_LOCAL: 2}
_PATH_BY_CODE = {v: k for k, v in PATH_CODES.items()}
ENV_RECV_POOL = "DCN_RECV_POOL"          # 0 disables pooled recv buffers
ENV_LOCAL_HANDOFF = "DCN_LOCAL_HANDOFF"  # 0 disables the colocated tier

# process-local context registry, keyed by listen address: how a sender
# discovers that a destination rank's context lives in THIS process (and
# its frames can skip the socket entirely). Registered in init(),
# unregistered in shutdown().
_LOCAL_CONTEXTS: Dict[Tuple[str, int], "DistDcnContext"] = {}
_LOCAL_LOCK = make_lock("dcn.local_registry")


class _RecvBufferPool:
    """Reusable receive buffers for the zero-copy socket tier.

    `acquire(n)` hands out a bytearray of at least `n` bytes; payloads are
    `recv_into`'d and surfaced as `np.frombuffer` views, so the buffer
    stays referenced for exactly as long as any consumer holds the array.
    Recycling is refcount-driven: a buffer is reused only when the pool
    itself is its sole owner — ownership hand-off without a release
    protocol, and a retained array (the ledger holding a result, a replay
    in flight) silently promotes its buffer out of rotation instead of
    ever being overwritten. One pool per reader thread: no locking.
    """

    # 3 == pool list + loop variable + getrefcount argument: no array
    # view (or any other consumer) references the buffer
    _FREE_REFCOUNT = 3

    def __init__(self, max_buffers: int = 16):
        self._bufs: List[bytearray] = []
        self._max = max_buffers

    def acquire(self, n: int) -> bytearray:
        for buf in self._bufs:
            if len(buf) >= n \
                    and sys.getrefcount(buf) == self._FREE_REFCOUNT:
                return buf
        buf = bytearray(max(n, 4096))
        # retained buffers (refcount > free) rotate out: drop the oldest
        # still-held entry first — its consumer keeps it alive, and the
        # pool can never reuse it while held — so free (just too-small)
        # buffers survive for smaller frames; only a fully-free pool
        # evicts a reusable one
        if len(self._bufs) >= self._max:
            idx = 0
            for old in self._bufs:   # same refcount shape as the scan above
                if sys.getrefcount(old) != self._FREE_REFCOUNT:
                    break            # held: evict this one
                idx += 1
            self._bufs.pop(idx if idx < len(self._bufs) else 0)
        self._bufs.append(buf)
        return buf


def _recv_pool_enabled() -> bool:
    return os.getenv(ENV_RECV_POOL, "1") != "0" \
        and hasattr(sys, "getrefcount")


def _local_handoff_enabled() -> bool:
    return os.getenv(ENV_LOCAL_HANDOFF, "1") != "0"


def _put_on_device(tensors: List, device) -> List:
    """Move the CUDA tensors of a colocated hand-off onto the consumer's
    device (a copy on the current stream, which first waits on the
    producer's event; a tensor already there passes through). Host arrays
    pass through untouched: the consumer's decode places them."""
    import torch
    event = getattr(tensors, "event", None)
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor) and device is not None \
                and t.device != torch.device(device):
            if event is not None and t.is_cuda:
                torch.cuda.current_stream(t.device).wait_event(event)
            t = t.to(device)
        out.append(t)
    return wire_codec.DeviceFrame(out, event) if event is not None else out


# /metrics plane: exceeded-silence events the liveness watcher saw (the
# healthz/metrics "is the fleet flapping" signal; docs/OBSERVABILITY.md)
_HEARTBEAT_MISSES = prom.REGISTRY.counter(
    "pipeedge_heartbeat_miss_total",
    "peers whose heartbeat silence exceeded interval*miss (per event)")
# epoch fencing: frames a reader dropped because they were sent by an
# incarnation that has since been fenced (declared dead, or superseded by
# a newer incarnation's admission) — the "stale zombie frame" signal
_STALE_FRAMES = prom.REGISTRY.counter(
    "pipeedge_stale_frames_dropped_total",
    "frames dropped at the reader because their sender incarnation was "
    "fenced (dead or superseded), by sender rank")
# membership plane: admissions this context granted to rejoining peers
_PEER_REJOINS = prom.REGISTRY.counter(
    "pipeedge_peer_rejoins_total",
    "JOIN admissions granted to restarted/rejoining peers, by rank")
# request tracing: data frames that arrived carrying a trace context, per
# producing peer (the per-edge trace counter the request-tracing plane
# reports), and blobs that failed to decode (tolerated as untraced)
_TRACED_FRAMES = prom.REGISTRY.counter(
    "pipeedge_traced_frames_total",
    "data frames received with a trace-context field, by producing peer")
_TRACE_INVALID = prom.REGISTRY.counter(
    "pipeedge_trace_ctx_invalid_total",
    "trace-context blobs that failed to decode (frame delivered untraced)")
# gray-failure signal: bounded redial+resend attempts the transport paid
# per destination (DCN_SEND_RETRIES) — a link that needs retries is
# degrading even when every retry eventually succeeds
_SEND_RETRIES_TOTAL = prom.REGISTRY.counter(
    "pipeedge_send_retries_total",
    "data-send redial+resend attempts (DCN_SEND_RETRIES), by peer rank")
# frame integrity (PIPEEDGE_WIRE_CRC): frames whose checksum failed at
# the receiving reader — each one triggers a bounded seq-addressed
# resend request. Public: the runtime's belt-and-braces decode handlers
# count on the same family.
FRAMES_CORRUPT = prom.REGISTRY.counter(
    "pipeedge_frames_corrupt_total",
    "wire frames that failed the integrity checksum on receive, by "
    "producing peer")


def _env_number(name: str, default, cast):
    val = os.getenv(name)
    if not val:
        return default
    try:
        return cast(val)
    except ValueError:
        raise ValueError(f"{name}={val!r} is not a number") from None

# msg_type, aux (cmd / sender rank), channel, n_tensors. The channel byte
# demultiplexes logically-distinct streams on the same rank pair (e.g. a
# colocated data rank's raw-input feed vs the last stage's results) — the
# role the reference's tag offsets play (p2p:12-21).
_HEADER = struct.Struct('!BiBH')
_TENSOR_HEADER = struct.Struct('!BB')  # dtype code, ndim
_DIM = struct.Struct('!q')

CHANNEL_DATA = 0     # inter-stage activations
CHANNEL_RESULTS = 1  # last stage -> data rank
CHANNEL_BIDS = 3     # reverse-auction bid replies -> auctioneer
# Round-parity offset for multi-round (re-schedule) runs: round r uses
# channel + CHANNEL_ROUND_PARITY*(r%2), so a frame the data rank streams for
# round r+1 can never be pulled by a stage from round r that is still
# tearing down (its recv loop polls only the old-parity channel; per-channel
# queues keep the traffic apart). Parity-2 suffices because a worker fully
# stops round r's stage before it begins round r+1.
CHANNEL_ROUND_PARITY = 8


def base_channel(channel: int) -> int:
    """Strip the round-parity offset: the logical stream kind
    (DATA/RESULTS/FEED) of a possibly parity-shifted channel byte."""
    return channel % CHANNEL_ROUND_PARITY


CHANNEL_FEED = 2     # data rank -> head stage (raw inputs). A separate
# channel so feed traffic is distinguishable from pipeline-edge traffic:
# the reference injects inputs *locally* (enqueue_tensor, p2p:442-450), so
# its per-rank 'send' telemetry never contains feed bytes — keeping the
# adaptive-quant policies' sensor clean. Monitoring hooks can filter on it.


def parse_rank_addrs(dcn_addrs: Optional[str], world_size: int,
                     base_port: int) -> List[Tuple[str, int]]:
    """Parse `--dcn-addrs 'h:p,h:p,...'` (one per rank) or default to
    localhost at base_port+rank (the reference's MASTER_ADDR/PORT analogue,
    runtime.py:599). Shared by every DCN CLI."""
    if dcn_addrs:
        parts = dcn_addrs.split(',')
        if len(parts) != world_size:
            raise RuntimeError("--dcn-addrs must list one host:port per rank")
        out = []
        for p in parts:
            host, port = p.rsplit(':', 1)
            out.append((host, int(port)))
        return out
    return [("127.0.0.1", base_port + i) for i in range(world_size)]


def _dtype_code(dtype: np.dtype) -> int:
    """The wire code of a numpy dtype (codes 0-13, or the three `ml_dtypes`
    names by name)."""
    dtype = np.dtype(dtype)
    for i, d in enumerate(_DTYPES):
        if d == dtype:
            return i
    code = _CODE_BY_NAME.get(dtype.name)
    if code is not None:
        return code
    raise TypeError(f"unsupported wire dtype: {dtype}")


def _wire_tensor(t) -> Tuple[np.ndarray, int]:
    """(C-contiguous array of the bytes that travel, its dtype code) for
    one frame tensor: a numpy array, a `WireArray` (its storage and code)
    or a CPU torch tensor (bfloat16 as its 16-bit patterns)."""
    code = getattr(t, "wire_code", None)
    if code is not None and np.dtype(t.dtype) == _STORAGE.get(code):
        a = np.asarray(t)
    elif type(t).__module__.startswith("torch"):
        import torch
        t = t.detach()
        if t.dtype == torch.bfloat16:
            a, code = t.contiguous().view(torch.int16).numpy(), CODE_BFLOAT16
        else:
            a = t.numpy()
            code = _dtype_code(a.dtype)
    else:
        a = np.asarray(t)
        code = _dtype_code(a.dtype)
        if code in _STORAGE:        # an ml_dtypes array: frame its bytes
            a = a.view(_STORAGE[code])
    if not a.flags.c_contiguous:  # ascontiguousarray would promote 0-d to 1-d
        a = np.ascontiguousarray(a)
    return a, code


def _socket_buf_bytes() -> int:
    """Requested SO_SNDBUF/SO_RCVBUF size. Default 4 MiB: inter-stage
    activation frames are megabytes, and deeper kernel buffers keep the
    sender's `sendmsg` from stalling on the default (often ~200 KiB)
    window while the stage could be computing. DCN_SOCKET_BUF overrides;
    0 keeps the kernel default."""
    env = os.getenv("DCN_SOCKET_BUF")
    if env:
        try:
            return int(env)
        except ValueError:
            raise ValueError(
                f"DCN_SOCKET_BUF={env!r} is not a byte count") from None
    return 4 << 20


def _tune_socket(sock: socket.socket) -> None:
    """Apply the transport socket options: TCP_NODELAY (frames are whole
    messages; never wait on Nagle) and enlarged send/recv buffers."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    buf = _socket_buf_bytes()
    if buf > 0:
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, buf)
            except OSError:  # pragma: no cover - kernel policy caps apply
                pass


def _pack_nibbles(t: np.ndarray) -> np.ndarray:
    """4-bit values (one per byte) -> wire bytes, two values per byte
    (value i in byte i//2, low nibble first). int4 is stored as its
    two's-complement low nibble; the receiver sign-extends."""
    vals = t.reshape(-1).view(np.uint8) & np.uint8(0xF)
    if vals.size % 2:
        vals = np.concatenate([vals, np.zeros(1, np.uint8)])
    return (vals[0::2] | (vals[1::2] << np.uint8(4))).astype(np.uint8)


def _unpack_nibbles(payload, n: int, code: int) -> WireArray:
    """Inverse of `_pack_nibbles` for `n` values of 4-bit `code`."""
    b = np.frombuffer(payload, np.uint8)
    nib = np.empty(b.size * 2, np.uint8)
    nib[0::2] = b & np.uint8(0xF)
    nib[1::2] = b >> np.uint8(4)
    nib = nib[:n]
    if code == CODE_INT4:  # sign-extend the two's-complement nibble
        return WireArray((nib.astype(np.int8) ^ 8) - 8, code)
    return WireArray(nib, code)


def _recv_into_exact(sock: socket.socket, view: memoryview) -> None:
    """Fill `view` completely from the socket (raises on peer close)."""
    got, n = 0, view.nbytes
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # returns the bytearray itself (struct.unpack and np.frombuffer both
    # take any buffer): no bytes() flattening copy
    buf = bytearray(n)
    _recv_into_exact(sock, memoryview(buf))
    return buf


# Linux caps sendmsg at UIO_MAXIOV (1024) iovecs; frames with many tensors
# (2 + ndim buffers each) must be sent in chunks or sendmsg fails EMSGSIZE.
_MAX_IOVECS = 1000


def _sendmsg_all(sock: socket.socket, parts: List) -> None:
    """Scatter-gather send of every buffer in `parts` (no flattening copy)."""
    bufs = [memoryview(p) for p in parts if len(p)]
    while bufs:
        try:
            sent = sock.sendmsg(bufs[:_MAX_IOVECS])
        except InterruptedError:
            continue
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent:
            bufs[0] = bufs[0][sent:]


def _send_frame(sock: socket.socket, msg_type: int, aux: int,
                tensors: Sequence, channel: int = 0) -> None:
    parts = [_HEADER.pack(msg_type, aux, channel, len(tensors))]
    for t in tensors:
        a, code = _wire_tensor(t)
        parts.append(_TENSOR_HEADER.pack(code, a.ndim))
        for d in a.shape:
            parts.append(_DIM.pack(d))
        if code in _NIBBLE_CODES:
            parts.append(_pack_nibbles(a))
        else:
            # raw bytes view of the payload: zero-copy into sendmsg
            parts.append(a.reshape(-1).view(np.uint8))
    _sendmsg_all(sock, parts)


def _recv_header(sock: socket.socket) -> Tuple[int, int, int, int]:
    return _HEADER.unpack(_recv_exact(sock, _HEADER.size))


def _recv_body(sock: socket.socket, n: int,
               pool: Optional[_RecvBufferPool] = None) -> List[np.ndarray]:
    tensors = []
    for _ in range(n):
        code, ndim = _TENSOR_HEADER.unpack(
            _recv_exact(sock, _TENSOR_HEADER.size))
        if code < len(_DTYPES):
            dtype = _DTYPES[code]
        elif code in _STORAGE:
            dtype = _STORAGE[code]
        else:
            raise TypeError(f"peer sent unknown wire dtype code {code}")
        shape = tuple(_DIM.unpack(_recv_exact(sock, _DIM.size))[0]
                      for _ in range(ndim))
        n_values = int(np.prod(shape, dtype=np.int64))
        if code in _NIBBLE_CODES:
            payload = _recv_exact(sock, (n_values + 1) // 2)
            tensors.append(_unpack_nibbles(payload, n_values,
                                           code).reshape(shape))
            continue
        nbytes = dtype.itemsize * n_values
        if pool is not None and nbytes > 0:
            # zero-copy tier: the payload lands directly in a pooled
            # buffer and the array is a VIEW over it — no intermediate
            # allocation or copy. The view's refcount is what keeps the
            # buffer out of rotation (see _RecvBufferPool).
            buf = pool.acquire(nbytes)
            _recv_into_exact(sock, memoryview(buf)[:nbytes])
            arr = np.frombuffer(buf, dtype=dtype,
                                count=n_values).reshape(shape)
        else:
            payload = _recv_exact(sock, nbytes)
            arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
        tensors.append(WireArray(arr, code) if code in _STORAGE else arr)
    return tensors


def _flip_one_bit(tensors: Sequence) -> List:
    """Chaos corrupt@K: return `tensors` with one bit flipped in a COPY
    of the largest tensor (the activation payload — never the header,
    microbatch id, or checksum, which are all small). The caller's
    arrays are untouched."""
    tensors = list(tensors)
    sizes = [int(np.asarray(t).nbytes) for t in tensors]
    if not sizes or max(sizes) == 0:
        return tensors
    idx = sizes.index(max(sizes))
    victim = np.array(tensors[idx], copy=True)
    flat = victim.reshape(-1).view(np.uint8)
    flat[flat.size // 2] ^= np.uint8(1)
    tensors[idx] = victim
    return tensors


def _recv_frame(sock: socket.socket) -> Tuple[int, int, int, List[np.ndarray]]:
    msg_type, aux, channel, n = _recv_header(sock)
    return msg_type, aux, channel, _recv_body(sock, n)


class DistDcnContext(DistContext):
    """Point-to-point tensor transport between ranks over TCP (DCN).

    The reference's `DistP2pContext` (p2p:41-70) minus the process group:
    every rank runs a listener; links are dialed lazily on first send and
    identified by a HELLO frame. `send_tensors`/`recv_tensors` move ndarray
    lists rank-to-rank; `cmd_broadcast` fans a command frame to all peers,
    dispatched to `cmd_handler` on the receiver (reference tag-10 channel).
    """

    RECV_QUEUE_DEPTH = 1   # reference ConditionQueue maxsize=1 backpressure
    CONNECT_TIMEOUT = 60.0  # total dial deadline incl. refused-retry backoff
    # clean frames cached per (dst, channel) for integrity resends —
    # deeper than the default stage pipelining depth (2), so the frame a
    # consumer flags corrupt is still addressable by seq even after the
    # producer pipelined a few more sends on that edge
    RESEND_CACHE_DEPTH = 4

    def __init__(self, world_size: int, rank: int,
                 rank_addrs: Sequence[Tuple[str, int]],
                 cmd_handler: Optional[Callable] = None,
                 edge_bits_supported: Optional[Sequence[int]] = None,
                 reconnect_grace: Optional[float] = None,
                 send_retries: Optional[int] = None,
                 epoch: Optional[int] = None,
                 accept_joins: bool = True):
        super().__init__(world_size=world_size, rank=rank)
        assert len(rank_addrs) == world_size
        self._rank_addrs = list(rank_addrs)
        self._cmd_handler = cmd_handler
        # wire bitwidths this context accepts on its inbound quantized
        # edges; producers cap their proposals via negotiate_edge_bits
        self._edge_bits = tuple(sorted(set(
            edge_bits_supported if edge_bits_supported is not None
            else DEFAULT_EDGE_BITS)))
        # bitwidth-negotiation replies, keyed by the answering peer
        self._neg_replies: Dict[int, "queue.Queue"] = {}
        self._neg_lock = make_lock("dcn.neg")
        # span-collection replies, keyed by the answering peer (one
        # in-flight collect_spans per peer, like negotiation)
        self._span_replies: Dict[int, "queue.Queue"] = {}
        self._span_lock = make_lock("dcn.span")
        # tiered transport (docs/DCN_WIRE.md): negotiated path per
        # DESTINATION rank (producer side; only PATH_LOCAL changes this
        # context's send behavior), path-negotiation reply queues, the
        # env-resolved tier capabilities, and the device colocated
        # hand-offs should land on (set_local_device)
        self._edge_path: Dict[int, str] = {}
        self._path_replies: Dict[int, "queue.Queue"] = {}
        self._recv_pool_on = _recv_pool_enabled()
        self._local_on = _local_handoff_enabled()
        self._local_device = None
        # env override so small test fleets / fast-failing deployments don't
        # wait the full minute for a peer that will never come up
        env_timeout = os.getenv("DCN_CONNECT_TIMEOUT")
        if env_timeout:
            try:
                self.CONNECT_TIMEOUT = float(env_timeout)
            except ValueError:
                raise ValueError(
                    f"DCN_CONNECT_TIMEOUT={env_timeout!r} is not a number "
                    "(seconds)") from None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._reader_threads: List[threading.Thread] = []
        self._conns: Dict[int, socket.socket] = {}       # outgoing data, by dst
        # outgoing COMMAND connections, separate from the data sockets: a
        # data send blocked on backpressure holds its conn lock for as long
        # as the receiver stalls, and an abort command (CMD_STOP after a
        # peer death) must never queue behind it
        self._cmd_conns: Dict[int, socket.socket] = {}
        # per-destination locks (created upfront: world size is known), so a
        # slow dial to one peer never stalls traffic to the others
        self._conn_locks = [make_lock(f"dcn.conn[{i}]")
                            for i in range(world_size)]
        self._cmd_conn_locks = [make_lock(f"dcn.cmd_conn[{i}]")
                                for i in range(world_size)]
        self._conns_lock = make_lock("dcn.conns")        # dict/list mutation
        self._accepted: List[socket.socket] = []         # incoming
        self._recv_queues: Dict[Tuple[int, int], "queue.Queue"] = {}
        self._recv_lock = make_lock("dcn.recv")
        self._stop = threading.Event()
        # peer-death detection (beyond the reference, whose RPC backpressure
        # "breaks down if the previous stage fails to send data afterward",
        # rpc/__init__.py:83-86): ranks whose connection dropped outside a
        # clean shutdown, and an optional notification callback
        self._dead: set = set()
        self._dead_lock = make_lock("dcn.dead")
        self._peer_death_handler: Optional[Callable[[int], None]] = None
        # elastic membership (docs/FAULT_TOLERANCE.md rank lifecycle):
        # this rank's incarnation number — travels in every HELLO so the
        # receiver can fence frames from a dead incarnation
        self.epoch = int(epoch if epoch is not None
                         else _env_number(ENV_EPOCH, 0, int))
        # /metrics hygiene: membership is known here, so
        # the per-peer label matrices render from the first scrape — a
        # scraper watching a peer's series sees 0, not series-absent
        for r in range(world_size):
            if r != rank:
                _HEARTBEAT_MISSES.declare(peer=str(r))
                _STALE_FRAMES.declare(peer=str(r))
                _PEER_REJOINS.declare(peer=str(r))
                _TRACED_FRAMES.declare(peer=str(r))
                _SEND_RETRIES_TOTAL.declare(peer=str(r))
                FRAMES_CORRUPT.declare(peer=str(r))
        # admission policy: with accept_joins=False every _MSG_JOIN is
        # refused (the runtime's --on-peer-rejoin ignore), so a confirmed
        # death stays terminal exactly as before this plane existed
        self.accept_joins = bool(accept_joins)
        # highest epoch each peer ever HELLO'd/JOINed with (under _dead_lock)
        self._peer_epoch: Dict[int, int] = {}
        # when each peer's current (restarted) incarnation first spoke: the
        # HELLO that raised its epoch (under _dead_lock). With the dial
        # stamp of each outgoing connection (`_dialed_at`, under
        # _conns_lock; keyed (is_cmd, dst)) it tells a JOIN admission
        # which cached connections reach the OLD incarnation
        self._incarnation_at: Dict[int, float] = {}
        self._dialed_at: Dict[Tuple[bool, int], float] = {}
        # fence floor per peer: frames from incarnations with epoch below
        # this are stale and dropped at the reader. Raised to dead_epoch+1
        # when a death is confirmed, and to the admitted epoch on JOIN.
        self._min_epoch: Dict[int, int] = {}
        self._peer_rejoin_handler: Optional[
            Callable[[int, int], None]] = None
        # instance-level stale counter so tests and the runtime can assert
        # "the fenced frame never reached the ledger" without scraping
        self.stale_frames_dropped = 0
        # peers whose listener answered at least once (dialed out or dialed
        # us): a later connection-REFUSED from one of these is a death
        # signal, not a still-starting listener (_ensure_conn fast path)
        self._ever_connected: set = set()
        # transient-fault policy: a dropped connection opens a grace window
        # (seconds) before the death is confirmed — a RESTARTING rank that
        # rebinds its listener and HELLOs again within it is revived, a dead
        # one is not. 0 preserves the declare-immediately behavior.
        self._reconnect_grace = (reconnect_grace if reconnect_grace is not None
                                 else _env_number(ENV_RECONNECT_GRACE, 0.0,
                                                  float))
        # bounded redial+resend attempts for a data send that hits a broken
        # pipe (transient network fault / peer restart); 0 = fail fast
        self.send_retries = (send_retries if send_retries is not None
                             else _env_number(ENV_SEND_RETRIES, 0, int))
        # monotonic stamp of the last life sign per peer (any inbound frame,
        # or a successful outbound dial): what a grace window checks against
        self._alive_at: Dict[int, float] = {}
        # ranks inside an open grace window, mapped to their pending timer
        self._pending_death: Dict[int, threading.Timer] = {}
        # liveness plane state (start_heartbeat)
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_interval = 0.0
        self._hb_miss = DEFAULT_HEARTBEAT_MISS
        self._hb_peers: Tuple[int, ...] = ()
        self._hb_last_rx: Dict[int, float] = {}
        self._hb_lock = make_lock("dcn.hb")
        self._hb_hook: Optional[Callable[[int], None]] = None
        # per-peer redial backoff for the beat loop — instance state (not
        # loop-local) so a rejoin admission can clear it and the plane
        # starts beating the restored rank immediately
        self._hb_dial_backoff: Dict[int, float] = {}
        # heartbeat RTT measurement (all under _hb_lock): beat sequence
        # counter, in-flight probes (dst, seq) -> send stamp, and per-peer
        # bounded RTT sample windows (ms). Beats carry the seq as a
        # payload; the peer's reader echoes it back (_MSG_HEARTBEAT_ACK).
        self._hb_seq = 0
        self._hb_rtt_pending: Dict[Tuple[int, int], float] = {}
        self._hb_rtt: Dict[int, deque] = {}
        self._hb_rtt_hook: Optional[Callable[[int, float], None]] = None
        # gray-failure accounting + frame-integrity recovery (under
        # _retry_lock): per-destination redial+resend counts, and — when
        # PIPEEDGE_WIRE_CRC arms frame checksums — a per-(dst, channel)
        # frame sequence counter (travels in the data-frame aux field)
        # plus a bounded cache of the last clean frames per edge, each
        # entry [seq, msg_type, tensors, replays]. Deeper than the stage
        # pipelining depth (default 2) so a corrupt frame's seq is still
        # cached by the time the consumer's resend request arrives.
        self._retry_lock = make_lock("dcn.retry")
        self._send_retry_counts: Dict[int, int] = {}
        self._frame_seq: Dict[Tuple[int, int], int] = {}
        self._last_frames: Dict[Tuple[int, int], deque] = {}
        self._wire_crc = wire_codec.crc_enabled()
        # chaos hook (comm/chaos.py corrupt@K): one-shot bit flip applied
        # BELOW the integrity layer, on a copy, so the resend cache and
        # any checksum stay clean — simulated wire corruption
        self._corrupt_next_send = False
        # send/recv measurement hooks (reference p2p:132-152): pre fires just
        # before the payload moves, post just after, so (post - pre) is the
        # actual wire transfer time — excluding idle waits for data to exist.
        self._send_pre_hook: Optional[Callable[[int, int], None]] = None
        self._send_post_hook: Optional[
            Callable[[int, int, Sequence[np.ndarray]], None]] = None
        self._recv_pre_hook: Optional[Callable[[int, int], None]] = None
        self._recv_post_hook: Optional[
            Callable[[int, int, Sequence[np.ndarray]], None]] = None

    def register_send_hooks(self, pre: Optional[Callable] = None,
                            post: Optional[Callable] = None) -> None:
        """Measure data sends: `pre(dst, channel)` before the frame hits the
        socket, `post(dst, channel, tensors)` after the write completes
        (reference register_send_pre/post_hook, p2p:132-142). Command and
        HELLO frames are not measured."""
        self._send_pre_hook = pre
        self._send_post_hook = post

    def register_recv_hooks(self, pre: Optional[Callable] = None,
                            post: Optional[Callable] = None) -> None:
        """Measure data receipt: `pre(src, channel)` after a frame header
        arrives (payload incoming), `post(src, channel, tensors)` once the
        payload is fully read — so the interval is transfer time, not idle
        time (reference recv hooks run around the tensor payload reads,
        p2p:236-244).

        After `pre` fires, `post` is ALWAYS called — with `tensors=None` if
        the transfer aborted mid-payload (peer death) — so hooks that pair
        start/stop measurements never leak a started measurement."""
        self._recv_pre_hook = pre
        self._recv_post_hook = post

    def register_peer_death_handler(self, handler: Callable[[int], None]) \
            -> None:
        """`handler(rank)` fires (once per rank, from the observing thread)
        when a connection to/from `rank` drops while the context is live —
        i.e. not during `shutdown()`. A dropped connection during a clean
        stop is NOT a death; callers that race stop against detection should
        gate on their own stop flag inside the handler."""
        self._peer_death_handler = handler

    def _mark_dead(self, rank: int, reason: str = "connection lost",
                   last_sign: Optional[float] = None) -> None:
        """A connection to or from `rank` failed. `last_sign` is the stamp
        of the last life sign read on that connection, when a reader saw
        it drop: a grace window then counts any newer life sign of the
        rank (another connection's HELLO or frame, a successful dial, a
        JOIN admission) as a revival, however late the drop was seen."""
        if rank < 0 or self._stop.is_set():
            return
        if self._reconnect_grace > 0:
            # open a grace window instead of declaring death: a RESTARTING
            # peer (rebinds + HELLOs within the window) is revived by
            # _confirm_dead finding a newer life sign
            with self._dead_lock:
                if rank in self._dead or rank in self._pending_death:
                    return
                if last_sign is not None \
                        and self._alive_at.get(rank, 0.0) > last_sign:
                    # the reader saw its drop only after the rank's next
                    # life sign: a restarted incarnation already spoke
                    superseded = True
                else:
                    superseded = False
                    timer = threading.Timer(
                        self._reconnect_grace, self._confirm_dead,
                        args=(rank, (time.monotonic() if last_sign is None
                                     else last_sign), reason))
                    timer.daemon = True
                    self._pending_death[rank] = timer
            if superseded:
                logger.info("rank %d: peer rank %d %s after a newer life "
                            "sign; not a death", self._rank, rank, reason)
                return
            logger.warning("rank %d: peer rank %d %s; reconnect grace %.1fs",
                           self._rank, rank, reason, self._reconnect_grace)
            timer.start()
            return
        self._declare_dead(rank, reason)

    def _confirm_dead(self, rank: int, marked_at: float, reason: str) -> None:
        """Grace expiry: the peer is dead unless it showed a life sign
        (inbound frame / fresh HELLO / successful dial / JOIN admission)
        after `marked_at` (the dropped connection's last life sign, or the
        time of the mark)."""
        with self._dead_lock:
            self._pending_death.pop(rank, None)
        self._declare_dead(rank, reason + " (grace expired)",
                           not_after=marked_at)

    def _declare_dead(self, rank: int, reason: str,
                      not_after: Optional[float] = None) -> None:
        if self._stop.is_set():
            return
        with self._dead_lock:
            # revive check INSIDE the same critical section that declares:
            # a JOIN admission (which stamps _alive_at under this lock)
            # racing a grace-expiry timer must never be overridden by the
            # timer fencing the just-admitted incarnation
            if not_after is not None \
                    and self._alive_at.get(rank, 0.0) > not_after:
                revived = True
            elif rank in self._dead:
                return
            else:
                revived = False
                self._dead.add(rank)
                # fence the dead incarnation: anything it (or a zombie
                # copy of it) still manages to push onto a half-open
                # socket is stale. A restart must come back with a HIGHER
                # epoch to be heard.
                dead_epoch = self._peer_epoch.get(rank, 0)
                self._min_epoch[rank] = max(self._min_epoch.get(rank, 0),
                                            dead_epoch + 1)
        if revived:
            logger.info("rank %d: peer rank %d reconnected within grace",
                        self._rank, rank)
            return
        # a dead peer's negotiated path is void: whatever replaces it
        # (failover target, restarted incarnation) must renegotiate
        self._edge_path.pop(rank, None)
        # so are its outgoing sockets: a send blocked on a hung peer's full
        # buffers fails now instead of holding its thread until shutdown
        with self._conns_lock:
            stale = [c for c in (self._conns.pop(rank, None),
                                 self._cmd_conns.pop(rank, None))
                     if c is not None]
        for conn in stale:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        logger.warning("rank %d: peer rank %d %s (peer death?)",
                       self._rank, rank, reason)
        if self._peer_death_handler is not None:
            self._peer_death_handler(rank)

    def _alive_sign(self, rank: int) -> float:
        """Record a life sign from `rank` (called from reader threads and
        successful dials); what an open grace window is checked against.
        Returns its stamp."""
        with self._dead_lock:
            now = self._alive_at[rank] = time.monotonic()
        return now

    def dead_ranks(self) -> frozenset:
        """Ranks this context has confirmed dead (post-grace) and not
        since re-admitted via the JOIN handshake."""
        with self._dead_lock:
            return frozenset(self._dead)

    def min_epoch_of(self, rank: int) -> int:
        """The fence floor for `rank`: frames from incarnations with a
        lower epoch are stale (dropped at the reader). 0 = never fenced."""
        with self._dead_lock:
            return self._min_epoch.get(rank, 0)

    # -- elastic membership (rejoin) -----------------------------------

    def register_peer_rejoin_handler(
            self, handler: Optional[Callable[[int, int], None]]) -> None:
        """`handler(rank, epoch)` fires (off-thread) when a peer passes
        the JOIN admission handshake — the signal the runtime uses to pull
        the rank out of its terminal dead set and plan a heal."""
        self._peer_rejoin_handler = handler

    def _admit_peer(self, src: int, epoch: int) -> bool:
        """Process a _MSG_JOIN from `src` claiming incarnation `epoch`:
        admit (un-dead, reset liveness watch, drop stale conns) when the
        epoch is not below the fence floor, refuse otherwise. Returns
        whether the peer was admitted."""
        if not self.accept_joins or src < 0 or src == self._rank:
            return False
        with self._dead_lock:
            if epoch < self._min_epoch.get(src, 0):
                return False    # a zombie of a fenced incarnation
            was_dead = src in self._dead
            self._dead.discard(src)
            timer = self._pending_death.pop(src, None)
            # the new incarnation spoke first on the connection carrying
            # this JOIN (its HELLO raised the epoch), if not before
            reborn_at = self._incarnation_at.get(src, time.monotonic())
            self._alive_at[src] = time.monotonic()
            self._peer_epoch[src] = max(self._peer_epoch.get(src, 0), epoch)
            # supersede every older incarnation: even if the old one was
            # never CONFIRMED dead (fast restart inside grace), its frames
            # must not interleave with the new incarnation's
            self._min_epoch[src] = max(self._min_epoch.get(src, 0), epoch)
        if timer is not None:
            timer.cancel()
        # the old incarnation's outgoing sockets are gone; drop them so
        # the next send/beat redials the restarted listener. Only those:
        # a connection dialed after the new incarnation first spoke (the
        # echo of its first heartbeat, say) reaches the NEW listener, and
        # dropping it would close it under the new incarnation, which
        # would take the drop for this rank's death and fence it. Its
        # negotiated transport path is stale either way (a restarted rank
        # is a NEW process: a colocated grant would now dangle).
        self._edge_path.pop(src, None)
        with self._conns_lock:
            for is_cmd, conns in ((False, self._conns),
                                  (True, self._cmd_conns)):
                if self._dialed_at.get((is_cmd, src), 0.0) < reborn_at:
                    conns.pop(src, None)
        # heartbeat hygiene: restart the watch from the peer's FIRST new
        # beat (watching-starts-at-first-beat rule), and clear the dial
        # backoff so this rank resumes beating it immediately — a second
        # death of the same rank must be detected like the first
        with self._hb_lock:
            self._hb_last_rx.pop(src, None)
        self._hb_dial_backoff.pop(src, None)
        _PEER_REJOINS.inc(peer=str(src))
        logger.warning("rank %d: peer rank %d rejoined (epoch %d%s)",
                       self._rank, src, epoch,
                       ", was confirmed dead" if was_dead else "")
        if self._peer_rejoin_handler is not None:
            # off-thread like _mark_dead: the handler may broadcast
            # commands, and this reader must keep serving frames
            threading.Thread(target=self._peer_rejoin_handler,
                             args=(src, epoch), daemon=True).start()
        return True

    def _cmd_channel_send(self, dst: int, msg_type: int, aux: int,
                          tensors: Sequence[np.ndarray] = (),
                          timeout: Optional[float] = None) -> None:
        """One frame to `dst` over the dedicated command connection,
        invalidating the cached conn on failure so the next send redials
        — the shared core of every point-to-point control-channel path
        (negotiation, span replies, JOIN, CMD sends)."""
        with self._cmd_conn_locks[dst]:
            conn = self._ensure_conn(dst, timeout=timeout,
                                     conns=self._cmd_conns)
            try:
                _send_frame(conn, msg_type, aux, tensors)
            except OSError:
                with self._conns_lock:
                    if self._cmd_conns.get(dst) is conn:
                        del self._cmd_conns[dst]
                raise

    def _try_cmd_send(self, dst: int, msg_type: int, aux: int,
                      tensors: Sequence[np.ndarray] = (),
                      lock_timeout: float = 0.5,
                      dial_timeout: float = 2.0) -> bool:
        """Best-effort, BOUNDED command-channel send for reader-thread
        replies (heartbeat-RTT echoes, resend requests): a busy conn
        lock (e.g. a broadcast blocked mid-send to the same peer) or a
        failed dial just drops the reply — one lost probe/request, never
        a wedged reader. Returns whether the frame went out."""
        lock = self._cmd_conn_locks[dst]
        if not lock.acquire(timeout=lock_timeout):
            return False
        try:
            conn = self._ensure_conn(dst, timeout=dial_timeout,
                                     conns=self._cmd_conns)
            try:
                _send_frame(conn, msg_type, aux, tensors)
                return True
            except OSError:
                with self._conns_lock:
                    if self._cmd_conns.get(dst) is conn:
                        del self._cmd_conns[dst]
                return False
        except OSError:
            return False
        finally:
            lock.release()

    def cmd_send(self, dst: int, cmd: int,
                 tensors: Sequence[np.ndarray] = (),
                 timeout: Optional[float] = None) -> None:
        """Send a command frame to ONE peer over the command connection —
        the point-to-point complement of `cmd_broadcast` (an admission ACK
        must reach exactly the rejoiner, not the fleet). Raises OSError
        when `dst` is unreachable."""
        self._cmd_channel_send(dst, _MSG_CMD, cmd, tensors,
                               timeout=timeout)

    def announce_join(self, peers: Optional[Sequence[int]] = None,
                      timeout: float = 5.0) -> List[int]:
        """Ask every peer (default: the whole fleet) to re-admit this rank
        at its current epoch — what a restarted rank calls after init().
        Best-effort per peer (a peer that is itself down just misses the
        announcement); returns the list of peers the JOIN reached."""
        reached = []
        for dst in (peers if peers is not None else range(self._world_size)):
            if dst == self._rank:
                continue
            try:
                self._cmd_channel_send(dst, _MSG_JOIN, self.epoch,
                                       timeout=timeout)
                reached.append(dst)
            except OSError as exc:
                logger.warning("rank %d: JOIN announcement to rank %d "
                               "failed: %s", self._rank, dst, exc)
        return reached

    # -- liveness plane ------------------------------------------------

    def register_heartbeat_hook(self, hook: Optional[Callable[[int], None]]) \
            -> None:
        """`hook(src)` fires on the reader thread for every heartbeat frame
        received — the feed for monitoring's heartbeat windows."""
        self._hb_hook = hook

    def register_heartbeat_rtt_hook(
            self, hook: Optional[Callable[[int, float], None]]) -> None:
        """`hook(src, rtt_ms)` fires on the reader thread for every
        heartbeat probe that comes home — the per-sample feed for
        monitoring's RTT windows (the aggregate view is
        `heartbeat_rtt_stats`)."""
        self._hb_rtt_hook = hook

    def heartbeat_rtt_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-peer heartbeat round-trip statistics over the bounded
        sample window: `{peer: {"n", "p50_ms", "p99_ms"}}` (nearest-rank
        percentiles; peers with no completed probe are absent). The
        latency signal the gray-failure scorer and the
        `pipeedge_heartbeat_rtt_ms` gauges read — beats prove liveness,
        these prove the link is still FAST."""
        with self._hb_lock:
            samples = {p: sorted(dq) for p, dq in self._hb_rtt.items()
                       if dq}
        out: Dict[int, Dict[str, float]] = {}
        for peer, vals in samples.items():
            def pct(q):
                idx = max(0, min(len(vals) - 1,
                                 int(round(q / 100.0 * (len(vals) - 1)))))
                return round(vals[idx], 3)
            out[peer] = {"n": len(vals), "p50_ms": pct(50),
                         "p99_ms": pct(99)}
        return out

    def send_retry_counts(self) -> Dict[int, int]:
        """Cumulative redial+resend attempts per destination (the
        DCN_SEND_RETRIES loop) — the gray-failure scorer differences two
        snapshots for a per-window count."""
        with self._retry_lock:
            return dict(self._send_retry_counts)

    # -- frame-integrity recovery (PIPEEDGE_WIRE_CRC) -------------------

    def request_resend(self, src: int, channel: int, seq: int = -1,
                       timeout: float = 5.0) -> None:
        """Ask `src` to replay data frame `seq` (its per-edge sequence
        number, carried in the data-frame aux when PIPEEDGE_WIRE_CRC is
        armed; -1 = the latest cached frame) on `channel` — the consumer
        half of the integrity-recovery path. The reader loop calls this
        automatically on a checksum mismatch; it stays public for
        belt-and-braces consumers (runtime.py's decode handlers).
        Best-effort: the replayed frame arrives as a normal data frame
        on the same recv queue; a cache miss or replay-cap hit on the
        producer means the frame is lost and the round's
        timeout/failover semantics apply. Raises OSError when `src` is
        unreachable."""
        self._cmd_channel_send(src, _MSG_RESEND, int(seq),
                               (np.asarray(channel, np.int32),),
                               timeout=timeout)

    def _resend_last(self, dst: int, channel: int, seq: int = -1) -> bool:
        """Producer half: replay cached frame `seq` (-1 = latest) for
        (dst, channel), at most max(1, send_retries) times per frame.
        Runs on the reader thread: the data-conn lock acquire AND the
        replay send itself are bounded (a backpressured consumer that
        stopped draining its socket forfeits the replay rather than
        wedging this reader)."""
        with self._retry_lock:
            dq = self._last_frames.get((dst, channel))
            entry = None
            if dq:
                if seq < 0:
                    entry = dq[-1]
                else:
                    for e in dq:
                        if e[0] == seq:
                            entry = e
                            break
            if entry is None:
                logger.warning("rank %d: resend request from rank %d "
                               "(channel %d, seq %d) missed the cache "
                               "(PIPEEDGE_WIRE_CRC off, restarted, or "
                               "aged past RESEND_CACHE_DEPTH=%d)",
                               self._rank, dst, channel, seq,
                               self.RESEND_CACHE_DEPTH)
                return False
            cap = max(1, self.send_retries)
            if entry[3] >= cap:
                logger.warning("rank %d: resend cap (%d) hit for rank %d "
                               "channel %d seq %d; frame stays lost",
                               self._rank, cap, dst, channel, entry[0])
                return False
            entry[3] += 1
            frame_seq, msg_type, tensors = entry[0], entry[1], entry[2]
        lock = self._conn_locks[dst]
        if not lock.acquire(timeout=5.0):
            logger.warning("rank %d: resend to rank %d skipped (data "
                           "conn busy)", self._rank, dst)
            return False
        try:
            conn = self._ensure_conn(dst, timeout=5.0)
            conn.settimeout(10.0)
            try:
                # deliberate send under the per-dst conn lock: the same
                # frame-serializer discipline as _send_tensors_once; the
                # socket timeout bounds it (see docstring)
                _send_frame(conn, msg_type, frame_seq, tensors, channel)
            except OSError:
                with self._conns_lock:
                    if self._conns.get(dst) is conn:
                        del self._conns[dst]
                try:
                    conn.close()
                except OSError:
                    pass
                raise
            finally:
                try:
                    conn.settimeout(None)
                except OSError:
                    pass
        finally:
            lock.release()
        logger.warning("rank %d: replayed frame seq %d to rank %d on "
                       "channel %d (integrity recovery)", self._rank,
                       frame_seq, dst, channel)
        return True

    def start_heartbeat(self, peers: Optional[Sequence[int]] = None,
                        interval: Optional[float] = None,
                        miss_threshold: Optional[int] = None) -> None:
        """Start the liveness plane: every `interval` seconds beat each peer
        over the command connections, and declare any peer dead whose own
        beats stop for `interval * miss_threshold` seconds. A beat-silent
        peer with an OPEN socket is exactly the hung-rank case the stream
        errors cannot catch. Defaults: env DCN_HEARTBEAT_INTERVAL (0 =
        disabled, the default) and DCN_HEARTBEAT_MISS (3). Watching starts
        at a peer's FIRST received beat, so ranks coming up at different
        times are never declared dead by a launch skew."""
        interval = (interval if interval is not None
                    else _env_number(ENV_HEARTBEAT_INTERVAL, 0.0, float))
        if interval <= 0 or self._hb_thread is not None:
            return
        self._hb_interval = float(interval)
        self._hb_miss = int(miss_threshold if miss_threshold is not None
                            else _env_number(ENV_HEARTBEAT_MISS,
                                             DEFAULT_HEARTBEAT_MISS, int))
        self._hb_peers = tuple(p for p in (peers if peers is not None
                                           else range(self._world_size))
                               if p != self._rank)
        self._hb_stop = threading.Event()
        self._hb_dial_backoff = {}
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"dcn-heartbeat-{self._rank}")
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        """Stop beating and watching (the context stays usable)."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None

    def _heartbeat_loop(self) -> None:
        interval = self._hb_interval
        # a peer that failed to dial is not re-dialed every cycle: serial
        # blocking dials to (say) a SYN-blackholed host would stretch THIS
        # rank's own beat period past other ranks' silence thresholds and
        # get healthy ranks declared dead. One attempt per miss-window.
        dial_backoff = self._hb_dial_backoff
        while not self._stop.is_set() and not self._hb_stop.is_set():
            for dst in self._hb_peers:
                if dst in self._dead or self._hb_stop.is_set():
                    continue
                if self._cmd_conns.get(dst) is None \
                        and time.monotonic() < dial_backoff.get(dst, 0.0):
                    continue
                # bounded lock acquire: a broadcast stuck dialing THIS
                # peer must not stall the beats to every other peer
                lock = self._cmd_conn_locks[dst]
                if not lock.acquire(timeout=min(2.0, interval)):
                    continue
                try:
                    # short per-beat dial budget: a peer that is not up yet
                    # just misses this beat, it does not stall the plane
                    conn = self._ensure_conn(
                        dst, timeout=min(0.5, interval),
                        conns=self._cmd_conns)
                    # sequence-numbered beat: the peer's reader echoes the
                    # seq (_MSG_HEARTBEAT_ACK), turning liveness beats
                    # into RTT probes. Stamp BEFORE the send so kernel
                    # buffering counts toward the measured round trip;
                    # prune probes older than the miss window (a lost ack
                    # must not leak its stamp forever).
                    with self._hb_lock:
                        self._hb_seq += 1
                        seq = self._hb_seq
                        self._hb_rtt_pending[(dst, seq)] = time.monotonic()
                        horizon = (time.monotonic()
                                   - interval * max(1, self._hb_miss))
                        for key in [k for k, t
                                    in self._hb_rtt_pending.items()
                                    if t < horizon]:
                            del self._hb_rtt_pending[key]
                    _send_frame(conn, _MSG_HEARTBEAT, self._rank,
                                (np.asarray(seq, np.int64),))
                    dial_backoff.pop(dst, None)
                except OSError:
                    dial_backoff[dst] = (time.monotonic()
                                         + interval * self._hb_miss)
                    with self._conns_lock:
                        self._cmd_conns.pop(dst, None)
                finally:
                    lock.release()
            now = time.monotonic()
            with self._hb_lock:
                rx = dict(self._hb_last_rx)
            with self._dead_lock:
                alive = dict(self._alive_at)
                # peers in an open grace window are already being handled:
                # re-flagging them every tick would spam death threads and
                # inflate the miss counter (one event, not one per tick)
                dead = set(self._dead) | set(self._pending_death)
            # ANY inbound frame counts as life, not only beats: a rank
            # whose beat thread is starved while it streams data is busy,
            # not hung. Size interval*miss above the worst single-threaded
            # stall a rank can take (model build / kernel build) — see
            # docs/FAULT_TOLERANCE.md.
            silent = [(p, now - max(last, alive.get(p, 0.0)))
                      for p, last in rx.items()
                      if now - max(last, alive.get(p, 0.0))
                      > interval * self._hb_miss and p not in dead]
            for peer, gap in silent:
                # dispatch off-thread: the death handler may block (grace
                # waits, command broadcasts) and beats must keep flowing
                _HEARTBEAT_MISSES.inc(peer=str(peer))
                threading.Thread(
                    target=self._mark_dead,
                    args=(peer, f"missed {self._hb_miss} heartbeats "
                                f"(silent {gap:.1f}s, interval "
                                f"{interval}s)"),
                    daemon=True).start()
            self._hb_stop.wait(interval)

    # -- lifecycle -----------------------------------------------------

    def init(self) -> None:
        # fresh session state so the context is genuinely reusable
        # (base-class contract, comm/__init__.py): the previous session's
        # threads are all joined by shutdown() and hold the old event
        self._stop = threading.Event()
        self._reader_threads = []
        self._recv_queues = {}
        self._neg_replies = {}
        self._span_replies = {}
        self._path_replies = {}
        self._edge_path = {}
        self._dead = set()
        self._alive_at = {}
        self._pending_death = {}
        self._hb_last_rx = {}
        self._hb_dial_backoff = {}
        self._hb_rtt_pending = {}
        self._hb_rtt = {}
        self._send_retry_counts = {}
        self._frame_seq = {}
        self._last_frames = {}
        self._peer_epoch = {}
        self._min_epoch = {}
        self._incarnation_at = {}
        self._dialed_at = {}
        self.stale_frames_dropped = 0
        # forget which peers were ever up: a relaunched fleet's listeners
        # get the full rendezvous budget again, not the fast-refusal path
        self._ever_connected = set()
        host, port = self._rank_addrs[self._rank]
        self._listener = socket.create_server((host, port), backlog=8,
                                              reuse_port=False)
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"dcn-accept-{self._rank}")
        self._accept_thread.start()
        # colocated-tier discovery: contexts in one process find each
        # other by listen address (a rank's address is unique fleet-wide)
        with _LOCAL_LOCK:
            _LOCAL_CONTEXTS[tuple(self._rank_addrs[self._rank])] = self
        super().init()

    def shutdown(self) -> None:
        self._stop.set()
        key = tuple(self._rank_addrs[self._rank])
        with _LOCAL_LOCK:
            if _LOCAL_CONTEXTS.get(key) is self:
                del _LOCAL_CONTEXTS[key]
        self.stop_heartbeat()
        with self._dead_lock:
            timers = list(self._pending_death.values())
            self._pending_death.clear()
        for t in timers:
            t.cancel()
        if self._accept_thread is not None:
            self._accept_thread.join()
        with self._conns_lock:
            conns = (list(self._conns.values())
                     + list(self._cmd_conns.values()) + self._accepted)
            self._conns.clear()
            self._cmd_conns.clear()
            self._accepted.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)  # unblock readers immediately
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.close()
        for t in self._reader_threads:
            t.join(timeout=5)
        super().shutdown()

    # -- incoming ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            _tune_socket(conn)
            with self._conns_lock:
                self._accepted.append(conn)
            t = threading.Thread(target=self._reader_loop, args=(conn,),
                                 daemon=True,
                                 name=f"dcn-reader-{self._rank}")
            t.start()
            self._reader_threads.append(t)

    def _queue_for(self, src: int, channel: int) -> "queue.Queue":
        with self._recv_lock:
            q = self._recv_queues.get((src, channel))
            if q is None:
                q = queue.Queue(maxsize=self.RECV_QUEUE_DEPTH)
                self._recv_queues[(src, channel)] = q
            return q

    def _reader_loop(self, conn: socket.socket) -> None:
        src = -1
        conn_epoch = 0
        last_sign = None        # stamp of this connection's last life sign
        warned_stale = False
        # zero-copy tier: one receive-buffer pool per connection (reader
        # threads never share buffers, so the pool needs no lock)
        pool = _RecvBufferPool() if self._recv_pool_on else None
        try:
            msg_type, src, _, hello = _recv_frame(conn)
            if msg_type != _MSG_HELLO:
                logger.error("peer spoke before HELLO; dropping connection")
                return
            # the HELLO's payload carries the sender's incarnation number
            # (absent = 0, the pre-epoch wire layout): every frame on THIS
            # connection belongs to that incarnation
            conn_epoch = int(np.asarray(hello[0]).reshape(-1)[0]) \
                if hello else 0
            with self._dead_lock:
                if conn_epoch > self._peer_epoch.get(src, 0):
                    self._incarnation_at[src] = time.monotonic()
                self._peer_epoch[src] = max(self._peer_epoch.get(src, 0),
                                            conn_epoch)
            with self._conns_lock:
                self._ever_connected.add(src)
            last_sign = self._alive_sign(src)
            while not self._stop.is_set():
                msg_type, aux, channel, n_tensors = _recv_header(conn)
                # traced data frame: identical to _MSG_TENSORS except the
                # leading uint8 trace-context blob (stripped after the
                # body read, below) — normalize the type here so every
                # data-frame branch (hooks, spans, fences, queues) stays
                # one code path
                traced = msg_type == _MSG_TENSORS_TRACED
                if traced:
                    msg_type = _MSG_TENSORS
                # epoch fence: a frame from an incarnation that has since
                # been fenced (confirmed dead, or superseded by a newer
                # JOIN) must never reach queues, handlers, or the ledger.
                # The payload is still drained (stream framing), then
                # dropped — with no hooks, no life sign, no beat credit:
                # a zombie must not keep its own death window open.
                with self._dead_lock:
                    stale = conn_epoch < self._min_epoch.get(src, 0)
                if stale:
                    _recv_body(conn, n_tensors, pool)
                    self.stale_frames_dropped += 1
                    _STALE_FRAMES.inc(peer=str(src))
                    # one WARNING per connection, debug thereafter: a
                    # zombie that keeps streaming would otherwise flood
                    # the logs for the rest of the run (the counter
                    # carries the ongoing signal)
                    log = logger.debug if warned_stale else logger.warning
                    warned_stale = True
                    log("rank %d: dropping stale frame(s) (type %d) from "
                        "rank %d epoch %d (fence %d)", self._rank,
                        msg_type, src, conn_epoch, self.min_epoch_of(src))
                    continue
                # "any inbound frame counts as life" — EXCEPT the
                # heartbeat-RTT echo: an ack proves only that the peer's
                # reader thread can write a socket (it is generated in
                # response to OUR probe). Crediting it would keep a
                # partially-hung peer — beat loop wedged, reader alive —
                # alive forever, defeating beat-silence detection.
                if msg_type != _MSG_HEARTBEAT_ACK:
                    last_sign = self._alive_sign(src)
                hooked = (msg_type == _MSG_TENSORS
                          and self._recv_pre_hook is not None)
                if hooked:
                    self._recv_pre_hook(src, channel)
                # wire-recv span: header seen -> payload fully read, i.e.
                # actual transfer time, not idle time (zero-cost when span
                # recording is off)
                t_rx0 = (time.monotonic_ns()
                         if msg_type == _MSG_TENSORS and telemetry.enabled()
                         else 0)
                try:
                    tensors = _recv_body(conn, n_tensors, pool)
                except Exception:
                    # abort notification: a paired measurement started by the
                    # pre hook must be discarded, or this (recyclable) thread
                    # ident leaks a dangling iteration context
                    if hooked and self._recv_post_hook is not None:
                        self._recv_post_hook(src, channel, None)
                    raise
                tctx = None
                if traced:
                    # strip the leading trace-context blob; decode failure
                    # (truncated/garbage) degrades to untraced — the
                    # payload tensors are intact either way
                    tctx = telemetry.TraceContext.from_wire(tensors[0]) \
                        if tensors else None
                    tensors = tensors[1:]
                    if tctx is None:
                        _TRACE_INVALID.inc()
                    else:
                        _TRACED_FRAMES.inc(peer=str(src))
                if t_rx0:
                    telemetry.record("wire", f"recv<-r{src}", t_rx0,
                                     time.monotonic_ns(),
                                     rid=tctx.rid if tctx else None)
                if msg_type == _MSG_TENSORS and self._recv_post_hook is not None:
                    self._recv_post_hook(src, channel, tensors)
                if msg_type == _MSG_TENSORS and self._wire_crc and tensors:
                    # frame integrity: verify CRC-flagged frames HERE,
                    # where src, channel AND the producer's frame seq
                    # (aux) are all known — a corrupt frame is dropped
                    # (never enqueued, so consumers only ever see clean
                    # frames) and its EXACT seq is requested back. The
                    # request rides the bounded try-send: recovery must
                    # never wedge this reader.
                    idx = wire_codec.locate_crc_header(tensors)
                    if idx is not None:
                        try:
                            wire_codec.verify_frame(tensors[idx + 1:-1],
                                                    tensors[-1])
                        except wire_codec.WireCorruptError as exc:
                            FRAMES_CORRUPT.inc(peer=str(src))
                            logger.error(
                                "rank %d: corrupt frame from rank %d "
                                "(channel %d, seq %d): %s; requesting "
                                "resend", self._rank, src, channel, aux,
                                exc)
                            self._try_cmd_send(
                                src, _MSG_RESEND, aux,
                                (np.asarray(channel, np.int32),))
                            continue
                if msg_type == _MSG_TENSORS:
                    # blocks when the consumer is behind: TCP backpressure
                    # propagates the stall to the sender (reference
                    # p2p:252-257 semantics); re-check _stop so shutdown
                    # can't leave this thread parked on a full queue forever.
                    # Items carry the sending incarnation's epoch so
                    # `recv_tensors_meta` consumers (the failover ledger)
                    # can key their dedupe on it.
                    q = self._queue_for(src, channel)
                    while not self._stop.is_set():
                        try:
                            q.put((conn_epoch, tensors, tctx), timeout=0.2)
                            break
                        except queue.Full:
                            continue
                elif msg_type == _MSG_CMD:
                    if self._cmd_handler is not None:
                        self._cmd_handler(aux, tuple(tensors))
                elif msg_type == _MSG_NEG:
                    # answer the bitwidth proposal inline: transport-level
                    # handshake, no app handler required
                    try:
                        self._send_neg(src, _MSG_NEG_ACK,
                                       self._accept_edge_bit(aux))
                    except OSError as exc:
                        logger.warning("rank %d: bitwidth-handshake reply to "
                                       "rank %d failed: %s", self._rank, src,
                                       exc)
                elif msg_type == _MSG_NEG_ACK:
                    self._neg_queue(src).put(aux)
                elif msg_type == _MSG_PATH:
                    # transport-tier proposal: answered inline like the
                    # bitwidth handshake (no app wiring)
                    try:
                        self._send_neg(src, _MSG_PATH_ACK,
                                       self._accept_edge_path(src, aux))
                    except OSError as exc:
                        logger.warning("rank %d: path-handshake reply to "
                                       "rank %d failed: %s", self._rank,
                                       src, exc)
                elif msg_type == _MSG_PATH_ACK:
                    self._path_queue(src).put(aux)
                elif msg_type == _MSG_SPANS:
                    # answer inline (transport-level, like _MSG_NEG): the
                    # requester's clock probe needs t_rx stamped NOW
                    try:
                        self._reply_spans(src, aux, time.monotonic_ns())
                    except OSError as exc:
                        logger.warning("rank %d: span-collection reply to "
                                       "rank %d failed: %s", self._rank,
                                       src, exc)
                elif msg_type == _MSG_SPANS_ACK:
                    self._span_queue(src).put((aux, tensors))
                elif msg_type == _MSG_HEARTBEAT:
                    with self._hb_lock:
                        self._hb_last_rx[aux] = time.monotonic()
                    if self._hb_hook is not None:
                        self._hb_hook(aux)
                    if tensors:
                        # sequence-numbered beat: echo the seq so the
                        # sender measures this command plane's RTT.
                        # BOUNDED send (lock + dial budgets): a busy cmd
                        # conn or unreachable peer just loses this one
                        # probe — it must never wedge this reader (a
                        # wedged reader stops crediting the peer's DATA
                        # frames as life signs and falsely kills it).
                        seq = int(np.asarray(tensors[0]).reshape(-1)[0])
                        if not self._try_cmd_send(src, _MSG_HEARTBEAT_ACK,
                                                  seq):
                            logger.debug("rank %d: heartbeat-RTT echo to "
                                         "rank %d skipped", self._rank,
                                         src)
                elif msg_type == _MSG_HEARTBEAT_ACK:
                    # our own probe coming home (aux = echoed seq)
                    now = time.monotonic()
                    rtt_ms = None
                    with self._hb_lock:
                        t0 = self._hb_rtt_pending.pop((src, aux), None)
                        if t0 is not None:
                            rtt_ms = (now - t0) * 1e3
                            dq = self._hb_rtt.get(src)
                            if dq is None:
                                dq = self._hb_rtt[src] = deque(maxlen=512)
                            dq.append(rtt_ms)
                    if rtt_ms is not None \
                            and self._hb_rtt_hook is not None:
                        self._hb_rtt_hook(src, rtt_ms)
                elif msg_type == _MSG_RESEND:
                    # frame-integrity recovery: replay the cached clean
                    # frame for (requester, channel=payload, seq=aux) —
                    # bounded, best-effort (see _MSG_RESEND's comment)
                    ch = (int(np.asarray(tensors[0]).reshape(-1)[0])
                          if tensors else 0)
                    try:
                        self._resend_last(src, ch, aux)
                    except OSError as exc:
                        logger.warning("rank %d: resend to rank %d "
                                       "(channel %d, seq %d) failed: %s",
                                       self._rank, src, ch, aux, exc)
                elif msg_type == _MSG_JOIN:
                    # admission handshake (aux = joiner's claimed epoch):
                    # a JOIN always rides a NEW connection from the new
                    # incarnation, so its epoch should match conn_epoch —
                    # trust the HELLO (what fencing keys on) when they
                    # disagree
                    admitted = self._admit_peer(src, conn_epoch)
                    try:
                        self._send_neg(src, _MSG_JOIN_ACK,
                                       self.epoch if admitted else -1)
                    except OSError as exc:
                        logger.warning("rank %d: JOIN ack to rank %d "
                                       "failed: %s", self._rank, src, exc)
                elif msg_type == _MSG_JOIN_ACK:
                    if aux < 0:
                        logger.error("rank %d: rank %d REFUSED this "
                                     "rank's JOIN (epoch %d is fenced "
                                     "there)", self._rank, src, self.epoch)
                    else:
                        with self._dead_lock:
                            self._peer_epoch[src] = max(
                                self._peer_epoch.get(src, 0), aux)
                else:
                    logger.error("unknown frame type %d from rank %d",
                                 msg_type, src)
        except (ConnectionError, OSError) as exc:
            if not self._stop.is_set():
                # a FENCED incarnation's connection dropping is not news:
                # the zombie finally exiting must not re-kill a rank whose
                # new incarnation has since been admitted
                with self._dead_lock:
                    fenced = (src >= 0
                              and conn_epoch < self._min_epoch.get(src, 0))
                if fenced:
                    logger.info("fenced connection from rank %d (epoch %d) "
                                "dropped: %s", src, conn_epoch, exc)
                else:
                    logger.warning("connection from rank %d dropped: %s",
                                   src, exc)
                    self._mark_dead(src, last_sign=last_sign)
        finally:
            conn.close()

    # -- outgoing ------------------------------------------------------

    def _ensure_conn(self, dst: int, timeout: Optional[float] = None,
                     conns: Optional[Dict[int, socket.socket]] = None) \
            -> socket.socket:
        """Dial `dst` lazily into `conns` (default: the data-conn map);
        caller must hold the matching per-dst lock. Retries refused
        connections until the deadline (CONNECT_TIMEOUT default) so
        simultaneously-launched ranks can dial peers whose listeners aren't
        up yet (the role of the reference's process-group rendezvous,
        p2p:62).

        Fast peer-death path: once a peer has EVER been dialed
        successfully, fresh connection-REFUSED errors mean its listener is
        gone (the process died — restarts rebind within ~1 s), so the
        retry loop gives up after a short grace instead of burning the
        full startup budget. This is what bounds fleet abort latency when
        a rank dies before data flows (test_peer_death_aborts_fleet)."""
        if conns is None:
            conns = self._conns
        conn = conns.get(dst)
        if conn is not None:
            return conn
        host, port = self._rank_addrs[dst]
        deadline = time.monotonic() + (self.CONNECT_TIMEOUT
                                       if timeout is None else timeout)
        was_up = dst in self._ever_connected
        refused_since = None
        while True:
            try:
                # per-attempt timeout clamped to the remaining budget, so a
                # SYN-blackholed peer can't overrun the caller's deadline
                attempt = min(5.0, max(0.1, deadline - time.monotonic()))
                conn = socket.create_connection((host, port), timeout=attempt)
                break
            except OSError as exc:
                if self._stop.is_set() or time.monotonic() >= deadline:
                    raise
                if was_up and isinstance(exc, ConnectionRefusedError):
                    now = time.monotonic()
                    refused_since = refused_since or now
                    if now - refused_since > 2.0:
                        raise   # listener stayed gone: the peer is dead
                else:
                    refused_since = None
                time.sleep(0.2)
        conn.settimeout(None)
        _tune_socket(conn)
        # HELLO carries this incarnation's epoch so the receiver can fence
        # stale frames per connection (readers without the payload read 0)
        _send_frame(conn, _MSG_HELLO, self._rank,
                    (np.asarray(self.epoch, np.int64),))
        with self._conns_lock:
            conns[dst] = conn
            self._dialed_at[(conns is self._cmd_conns, dst)] = \
                time.monotonic()
            self._ever_connected.add(dst)
        self._alive_sign(dst)   # a successful dial revives a grace window
        return conn

    def send_tensors(self, dst: int, tensors: Sequence[np.ndarray],
                     channel: int = CHANNEL_DATA,
                     trace: Optional["telemetry.TraceContext"] = None) \
            -> None:
        """Send a tensor list to `dst` (reference _send_tensor, p2p:96-108).

        `trace` (a telemetry.TraceContext) rides the frame as an optional
        leading uint8 blob (`_MSG_TENSORS_TRACED`): the consumer's stage
        and wire spans inherit its request id. None sends the plain (and
        byte-identical to pre-tracing) `_MSG_TENSORS` frame — untraced
        runs pay zero wire bytes for the feature.

        With `send_retries` > 0 (env DCN_SEND_RETRIES), a broken connection
        is redialed and the WHOLE frame resent, with exponential backoff —
        transient network faults and in-grace peer restarts heal instead of
        killing the edge. The receiver discards a torn partial frame with
        its dropped connection, so a resend can duplicate a frame but never
        corrupt one; consumers that must be exactly-once dedupe at the
        application layer (runtime.py's microbatch-id ledger).

        When `negotiate_edge_path` agreed the COLOCATED tier for `dst`,
        the frame skips the socket entirely: tensors (host or device
        arrays) hand off through the in-process peer's recv queue with
        the framing as metadata. A peer that left the process meanwhile
        (clean shutdown) degrades back to the socket path."""
        if self._edge_path.get(dst) == PATH_LOCAL:
            peer = self._local_peer(dst)
            if peer is not None:
                try:
                    self._deliver_local(peer, dst, tensors, channel,
                                        trace=trace)
                    return
                except (ConnectionError, OSError):
                    self._mark_dead(dst)
                    raise
            # grant went stale (peer context gone): socket truth resumes
            self._edge_path.pop(dst, None)
        attempts = 1 + max(0, self.send_retries)
        for attempt in range(attempts):
            try:
                self._send_tensors_once(dst, tensors, channel, trace=trace)
                return
            except OSError as exc:
                if attempt + 1 >= attempts or self._stop.is_set():
                    # notify AFTER releasing the conn lock: the death
                    # handler may broadcast commands, which needs these
                    # locks (deadlock otherwise)
                    self._mark_dead(dst)
                    raise
                # gray-failure signal: a link that needs redials is
                # degrading even when every retry eventually succeeds
                with self._retry_lock:
                    self._send_retry_counts[dst] = \
                        self._send_retry_counts.get(dst, 0) + 1
                _SEND_RETRIES_TOTAL.inc(peer=str(dst))
                backoff = min(2.0, 0.2 * (2 ** attempt))
                logger.warning(
                    "rank %d: send to rank %d failed (%s); retry %d/%d "
                    "in %.1fs", self._rank, dst, exc, attempt + 1,
                    attempts - 1, backoff)
                time.sleep(backoff)

    def _send_tensors_once(self, dst: int, tensors: Sequence[np.ndarray],
                           channel: int,
                           trace: Optional["telemetry.TraceContext"] = None
                           ) -> None:
        # wire frame vs hook payload kept separate: the recv side strips
        # the blob BEFORE its hooks fire, so the send hooks must count
        # the same (payload-only) tensors or the per-edge send/recv byte
        # accounting would permanently diverge on traced edges
        msg_type = _MSG_TENSORS
        wire_tensors = tensors
        if trace is not None:
            wire_tensors = [trace.to_wire()] + list(tensors)
            msg_type = _MSG_TENSORS_TRACED
        # chaos corrupt@K: flip one bit in a COPY, below the integrity
        # layer — the resend cache (and any frame checksum, computed by
        # the caller's PendingWire.finalize) keeps the clean bytes, so a
        # consumer-requested resend genuinely recovers the frame
        frame_tensors = wire_tensors
        if self._corrupt_next_send:
            self._corrupt_next_send = False
            frame_tensors = _flip_one_bit(wire_tensors)
        # frame integrity: with PIPEEDGE_WIRE_CRC armed, CRC-FLAGGED
        # frames carry a per-(dst, channel) sequence number in the aux
        # field instead of the (reader-unused) sender rank, so a
        # consumer can address a corrupt frame's resend EXACTLY —
        # pipelined sends mean "the last frame" may already be a later
        # one. Unflagged frames (raw feed microbatches, v1) are neither
        # stamped nor cached: the receiver can never verify them, so
        # caching would only pin dead copies of large inputs per edge.
        aux = self._rank
        seq = None
        if self._wire_crc \
                and wire_codec.locate_crc_header(wire_tensors) is not None:
            with self._retry_lock:
                seq = self._frame_seq.get((dst, channel), 0) + 1
                self._frame_seq[(dst, channel)] = seq
            aux = seq
        with self._conn_locks[dst]:
            conn = self._ensure_conn(dst)
            if self._send_pre_hook is not None:
                self._send_pre_hook(dst, channel)
            t_tx0 = time.monotonic_ns() if telemetry.enabled() else 0
            try:
                _send_frame(conn, msg_type, aux, frame_tensors,
                            channel)
            except Exception as exc:
                if self._send_pre_hook is not None \
                        and self._send_post_hook is not None:
                    self._send_post_hook(dst, channel, None)  # abort
                if isinstance(exc, OSError):
                    # broken pipe / reset: the peer is gone; drop the
                    # conn so state stays clean
                    with self._conns_lock:
                        if self._conns.get(dst) is conn:
                            del self._conns[dst]
                raise
            if t_tx0:
                telemetry.record("wire", f"send->r{dst}", t_tx0,
                                 time.monotonic_ns(),
                                 rid=trace.rid if trace else None)
            if self._send_post_hook is not None:
                self._send_post_hook(dst, channel, tensors)
        if seq is not None:
            # frame-integrity resend cache: the last RESEND_CACHE_DEPTH
            # CLEAN CRC-flagged frames per edge-channel, seq-addressed
            # (memory is bounded at a few in-flight microbatches per
            # edge), each with its own replay count
            with self._retry_lock:
                dq = self._last_frames.get((dst, channel))
                if dq is None:
                    dq = self._last_frames[(dst, channel)] = deque(
                        maxlen=self.RESEND_CACHE_DEPTH)
                dq.append([seq, msg_type, wire_tensors, 0])

    def recv_tensors(self, src: int, timeout: Optional[float] = None,
                     channel: int = CHANNEL_DATA) -> List[np.ndarray]:
        """Receive the next tensor list from `src` (p2p:111-121). Raises
        queue.Empty on timeout, ConnectionError if `src`'s connection died
        and no frames remain (already-delivered frames drain first)."""
        return self.recv_tensors_meta(src, timeout=timeout,
                                      channel=channel)[0]

    def drop_queued(self, channel: int, src: Optional[int] = None) -> int:
        """Discard the frames waiting on `channel` (from `src`, or from
        every rank), without blocking; returns how many. What a round
        that is over leaves there is stale: a reader parked on that full
        queue would hold back every later frame of its connection."""
        with self._recv_lock:
            queues = [q for (s, ch), q in self._recv_queues.items()
                      if ch == channel and src in (None, s)]
        dropped = 0
        for q in queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
                dropped += 1
        return dropped

    def recv_tensors_meta(self, src: int, timeout: Optional[float] = None,
                          channel: int = CHANNEL_DATA) \
            -> Tuple[List[np.ndarray], int]:
        """`recv_tensors` plus the sending incarnation's epoch:
        `(tensors, epoch)`. What the failover ledger keys its epoch-aware
        dedupe on (stale incarnations are already fenced at the reader;
        the epoch here is forensic + belt-and-braces)."""
        tensors, epoch, _ = self.recv_tensors_traced(src, timeout=timeout,
                                                     channel=channel)
        return tensors, epoch

    def recv_tensors_traced(self, src: int,
                            timeout: Optional[float] = None,
                            channel: int = CHANNEL_DATA) \
            -> Tuple[List[np.ndarray], int,
                     Optional["telemetry.TraceContext"]]:
        """`recv_tensors_meta` plus the frame's trace context
        `(tensors, epoch, trace)` — None for a plain (untraced) frame or
        an undecodable blob. What the DCN stage workers pull so their
        spans inherit the producing request's id."""
        q = self._queue_for(src, channel)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                epoch, tensors, tctx = q.get(
                    timeout=0.2 if deadline is None
                    else max(0.0, min(0.2, deadline - time.monotonic())))
                return tensors, epoch, tctx
            except queue.Empty:
                with self._dead_lock:
                    dead = src in self._dead
                if dead and q.empty():
                    raise ConnectionError(
                        f"rank {src} died (connection lost)") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise

    def cmd_broadcast(self, cmd: int, tensors: Sequence[np.ndarray] = (),
                      best_effort: Optional[bool] = None,
                      exclude: Optional[Sequence[int]] = None) -> None:
        """Send a command frame to every other rank (p2p:72-85).

        Delivery policy: commands the fleet can survive missing (CMD_STOP —
        receivers also have their own timeouts) are best-effort with a short
        dial deadline, so one dead rank never stalls the broadcast. Every
        other command (CMD_SCHED especially) retries dialing each peer until
        the full CONNECT_TIMEOUT: a worker whose listener comes up seconds
        after the data rank broadcasts must still receive the schedule — the
        delivery guarantee the reference gets for free from its
        init_process_group rendezvous (p2p:62).

        Peers in `exclude` and peers this context has CONFIRMED dead are
        skipped outright (never counted as failures): a failover CMD_SCHED
        must reach every survivor without stalling on — or aborting over —
        the rank whose death triggered it."""
        if best_effort is None:
            best_effort = cmd == CMD_STOP
        skip = set(exclude or ())
        with self._dead_lock:
            skip |= self._dead
        # One deadline shared across the whole broadcast: several dead peers
        # cost at most ~CONNECT_TIMEOUT total, not CONNECT_TIMEOUT each
        # (already-connected and live peers dial in milliseconds regardless
        # of their position in the loop).
        deadline = time.monotonic() + (5.0 if best_effort
                                       else self.CONNECT_TIMEOUT)
        failures = []
        for dst in range(self._world_size):
            if dst == self._rank:
                continue
            if dst in skip:
                logger.debug("cmd_broadcast: skipping rank %d (dead/"
                             "excluded)", dst)
                continue
            try:
                # dedicated command connections: never blocked behind a
                # backpressured data send to the same peer
                with self._cmd_conn_locks[dst]:
                    remaining = max(1.0, deadline - time.monotonic())
                    conn = self._ensure_conn(dst, timeout=remaining,
                                             conns=self._cmd_conns)
                    try:
                        _send_frame(conn, _MSG_CMD, cmd, tensors)
                    except OSError:
                        # the CACHED connection went stale (the peer
                        # flapped or restarted inside its grace window):
                        # one fresh redial before declaring the peer
                        # unreachable — it is alive, only the old socket
                        # is dead
                        with self._conns_lock:
                            if self._cmd_conns.get(dst) is conn:
                                del self._cmd_conns[dst]
                        remaining = max(1.0, deadline - time.monotonic())
                        conn = self._ensure_conn(dst, timeout=remaining,
                                                 conns=self._cmd_conns)
                        _send_frame(conn, _MSG_CMD, cmd, tensors)
            except OSError as exc:
                # keep delivering to the remaining reachable peers either
                # way; drop the broken conn so a later broadcast redials
                with self._conns_lock:
                    self._cmd_conns.pop(dst, None)
                failures.append((dst, exc))
                logger.warning("cmd_broadcast: rank %d unreachable (%s); "
                               "skipping", dst, exc)
        if failures and not best_effort:
            raise ConnectionError(
                f"cmd_broadcast(cmd={cmd}): undeliverable to rank(s) "
                + ", ".join(f"{d} ({e})" for d, e in failures))

    # -- per-edge bitwidth negotiation ---------------------------------

    def _neg_queue(self, peer: int) -> "queue.Queue":
        with self._neg_lock:
            q = self._neg_replies.get(peer)
            if q is None:
                q = queue.Queue()
                self._neg_replies[peer] = q
            return q

    def _accept_edge_bit(self, proposed: int) -> int:
        """Receiver policy: the proposal when supported, else the widest
        supported bitwidth below it (0 = uncompressed, always legal)."""
        if proposed in self._edge_bits:
            return proposed
        lower = [b for b in self._edge_bits if 0 < b < proposed]
        return max(lower) if lower else 0

    def _send_neg(self, dst: int, msg_type: int, bit: int) -> None:
        # rides the dedicated command connections: a proposal must never
        # queue behind a backpressured data send to the same peer
        self._cmd_channel_send(dst, msg_type, bit)

    def negotiate_edge_bits(self, dst: int, proposed: int,
                            timeout: Optional[float] = 30.0) -> int:
        """Agree an edge bitwidth with the consuming rank over the control
        channel: propose `proposed`, get back what `dst` accepts (its
        `edge_bits_supported` policy — the proposal itself, or the widest
        supported bitwidth below it, or 0 for uncompressed). Run once per
        edge before streaming; the per-frame wire header still carries the
        actual bitwidth, so adaptive policies may later move WITHIN the
        agreed capability. Raises queue.Empty on timeout and OSError when
        `dst` is unreachable. One in-flight negotiation per peer."""
        q = self._neg_queue(dst)
        while True:  # drop stale replies from an abandoned negotiation
            try:
                q.get_nowait()
            except queue.Empty:
                break
        self._send_neg(dst, _MSG_NEG, int(proposed))
        return int(q.get(timeout=timeout))

    # -- tiered transport (colocated / zero-copy / legacy v2) ----------

    def _path_queue(self, peer: int) -> "queue.Queue":
        with self._neg_lock:
            q = self._path_replies.get(peer)
            if q is None:
                q = queue.Queue()
                self._path_replies[peer] = q
            return q

    def _local_peer(self, rank: int) -> Optional["DistDcnContext"]:
        """The live context serving `rank` IN THIS PROCESS, or None. The
        registry is keyed by listen address, so the check is also proof
        both ends share an address space — the colocated tier's only
        requirement."""
        if not 0 <= rank < self._world_size:
            return None
        with _LOCAL_LOCK:
            peer = _LOCAL_CONTEXTS.get(tuple(self._rank_addrs[rank]))
        if peer is None or peer._rank != rank or peer._stop.is_set():
            return None
        return peer

    def _accept_edge_path(self, src: int, proposed_code: int) -> int:
        """Receiver policy for a `_MSG_PATH` proposal: the colocated tier
        when the proposer's context is registered in this process (and
        both sides enable it), else zero-copy when this context pools its
        receive buffers, else legacy v2."""
        if proposed_code >= PATH_CODES[PATH_LOCAL] and self._local_on \
                and self._local_peer(src) is not None:
            return PATH_CODES[PATH_LOCAL]
        if self._recv_pool_on:
            return PATH_CODES[PATH_ZEROCOPY]
        return PATH_CODES[PATH_SOCKET_V2]

    def negotiate_edge_path(self, dst: int,
                            timeout: Optional[float] = 30.0) -> str:
        """Agree this edge's transport tier with the consuming rank over
        the control channel (the `negotiate_edge_bits` idiom): propose the
        cheapest tier this side supports, get back what `dst` serves.
        PATH_LOCAL switches `send_tensors(dst, ...)` to the in-process
        device-buffer hand-off; the socket tiers are receiver-local
        behavior and the answer is informational (telemetry records it
        either way). Run once per edge before streaming — the runtime
        renegotiates at every round build, so failover targets and
        restarted incarnations never ride a stale grant. Raises
        queue.Empty on timeout and OSError when `dst` is unreachable."""
        proposed = (PATH_CODES[PATH_LOCAL]
                    if self._local_on and self._local_peer(dst) is not None
                    else PATH_CODES[PATH_ZEROCOPY])
        q = self._path_queue(dst)
        while True:  # drop stale replies from an abandoned negotiation
            try:
                q.get_nowait()
            except queue.Empty:
                break
        self._send_neg(dst, _MSG_PATH, proposed)
        code = int(q.get(timeout=timeout))
        tier = _PATH_BY_CODE.get(code, PATH_SOCKET_V2)
        if tier == PATH_LOCAL and (not self._local_on
                                   or self._local_peer(dst) is None):
            # the grant outlived the peer's registration (or this side
            # disabled the tier): degrade to the socket truth
            tier = (PATH_ZEROCOPY if self._recv_pool_on
                    else PATH_SOCKET_V2)
        self._edge_path[dst] = tier
        # per-tier telemetry marker: trace_report's transport section
        # counts edges per tier from these instants
        now = time.monotonic_ns()
        telemetry.record("transport", f"{tier}:{self._rank}->{dst}",
                         now, now)
        logger.info("rank %d: edge ->%d rides the %s path", self._rank,
                    dst, tier)
        return tier

    def edge_path(self, dst: int) -> Optional[str]:
        """The tier `negotiate_edge_path` agreed for sends to `dst`
        (None = never negotiated: the legacy socket path)."""
        return self._edge_path.get(dst)

    def set_local_device(self, device) -> None:
        """Device colocated hand-offs INTO this context should land on:
        a producer's CUDA tensors on another device are copied there
        device-to-device (never through the host) before they reach this
        rank's recv queue. None (default) hands tensors off wherever they
        already live."""
        self._local_device = device

    def _deliver_local(self, peer: "DistDcnContext", dst: int,
                       tensors: Sequence, channel: int,
                       trace: Optional["telemetry.TraceContext"] = None
                       ) -> None:
        """Colocated-tier send: hand `tensors` (host OR device arrays)
        straight to `peer`'s bounded recv queue. Framing travels as
        metadata (src rank, sender epoch, channel, trace context); the
        send/recv monitor hooks and telemetry fire exactly like the
        socket path's."""
        if self._send_pre_hook is not None:
            self._send_pre_hook(dst, channel)
        t0 = time.monotonic_ns() if telemetry.enabled() else 0
        # a DeviceFrame keeps its event: the consumer's stream waits on it
        frame = (wire_codec.DeviceFrame(tensors, tensors.event)
                 if isinstance(tensors, wire_codec.DeviceFrame)
                 else list(tensors))
        try:
            peer._local_put(self._rank, self.epoch, frame, channel,
                            trace=trace)
        except Exception:
            if self._send_pre_hook is not None \
                    and self._send_post_hook is not None:
                self._send_post_hook(dst, channel, None)  # abort
            raise
        if t0:
            telemetry.record("wire", f"local->r{dst}", t0,
                             time.monotonic_ns(),
                             rid=trace.rid if trace else None)
        if self._send_post_hook is not None:
            self._send_post_hook(dst, channel, tensors)

    def _local_put(self, src: int, epoch: int, tensors: List,
                   channel: int,
                   trace: Optional["telemetry.TraceContext"] = None
                   ) -> None:
        """Receiver half of the colocated hand-off: the reader loop's
        contract (epoch fence, life sign, recv hooks, bounded queue
        backpressure) without a socket in between. Runs on the SENDER's
        thread; blocking on a full queue is this tier's backpressure."""
        with self._dead_lock:
            self._peer_epoch[src] = max(self._peer_epoch.get(src, 0), epoch)
            stale = epoch < self._min_epoch.get(src, 0)
        if stale:
            # same fencing as the socket reader: a zombie incarnation's
            # hand-off must never reach queues — and earns no life sign
            self.stale_frames_dropped += 1
            _STALE_FRAMES.inc(peer=str(src))
            logger.warning("rank %d: dropping stale local hand-off from "
                           "rank %d epoch %d (fence %d)", self._rank, src,
                           epoch, self.min_epoch_of(src))
            return
        self._alive_sign(src)
        if self._local_device is not None:
            tensors = _put_on_device(tensors, self._local_device)
        if self._recv_pre_hook is not None:
            self._recv_pre_hook(src, channel)
        if self._recv_post_hook is not None:
            self._recv_post_hook(src, channel, tensors)
        if trace is not None:
            _TRACED_FRAMES.inc(peer=str(src))
        q = self._queue_for(src, channel)
        while not self._stop.is_set():
            try:
                q.put((epoch, tensors, trace), timeout=0.2)
                return
            except queue.Full:
                continue
        raise ConnectionError(f"rank {self._rank} stopped; local hand-off "
                              f"from rank {src} refused")

    # -- fleet span collection (telemetry) -----------------------------

    def _span_queue(self, peer: int) -> "queue.Queue":
        with self._span_lock:
            q = self._span_replies.get(peer)
            if q is None:
                q = queue.Queue()
                self._span_replies[peer] = q
            return q

    def _reply_spans(self, dst: int, aux: int, t_rx_ns: int) -> None:
        """Answer a `_MSG_SPANS` request from `dst`: [t_rx, t_tx] receiver
        timestamps plus (full requests only) this rank's span ring as a
        uint8 JSON blob. Runs on the reader thread; the blob is built
        BEFORE t_tx is stamped so serialization time never skews the
        clock-probe math."""
        blob = np.zeros(0, np.uint8)
        if aux != _SPANS_PROBE:
            rec = telemetry.recorder()
            if rec is not None:
                blob = (telemetry.digest_to_wire(rec.digest())
                        if aux == _SPANS_DIGEST
                        else telemetry.spans_to_wire(rec.snapshot()))
        with self._cmd_conn_locks[dst]:
            conn = self._ensure_conn(dst, conns=self._cmd_conns)
            stamp = np.asarray([t_rx_ns, time.monotonic_ns()], np.int64)
            try:
                _send_frame(conn, _MSG_SPANS_ACK, aux, (stamp, blob))
            except OSError:
                with self._conns_lock:
                    if self._cmd_conns.get(dst) is conn:
                        del self._cmd_conns[dst]
                raise

    def collect_spans(self, dst: int, probes: int = 3,
                      timeout: float = 5.0):
        """Fetch `dst`'s span ring over the command channel and estimate
        its clock offset NTP-style from the same exchanges.

        Runs `probes` timestamp-only round trips plus one full request;
        the minimum-RTT sample gives the offset (telemetry.
        estimate_clock_offset). Returns `(spans, offset_ns)` with
        `offset_ns = peer_clock - local_clock` — shift the peer's spans
        onto this rank's timeline with `telemetry.align_spans`. Raises
        queue.Empty on timeout and OSError when `dst` is unreachable; one
        in-flight collection per peer (same discipline as
        `negotiate_edge_bits`)."""
        q = self._span_queue(dst)
        while True:  # drop stale replies from an abandoned collection
            try:
                q.get_nowait()
            except queue.Empty:
                break
        samples = []
        blob = None
        for i in range(max(0, probes) + 1):
            aux = _SPANS_PROBE if i < probes else _SPANS_REQUEST
            t0 = time.monotonic_ns()
            self._send_neg(dst, _MSG_SPANS, aux)
            _, tensors = q.get(timeout=timeout)
            t3 = time.monotonic_ns()
            stamp = np.asarray(tensors[0], np.int64).reshape(-1)
            samples.append((t0, int(stamp[0]), int(stamp[1]), t3))
            if aux == _SPANS_REQUEST:
                blob = tensors[1]
        offset = telemetry.estimate_clock_offset(samples)
        return telemetry.spans_from_wire(blob), offset

    def collect_digest(self, dst: int, timeout: float = 5.0):
        """Fetch `dst`'s cumulative span digest over the command channel:
        the lightweight per-round collection the peer-health scorer reads
        (telemetry.Digest, durations only — no clock probes, no full
        trace). Empty dict when the peer records no spans. Raises
        queue.Empty on timeout and OSError when `dst` is unreachable; one
        in-flight collection per peer (shared reply queue with
        `collect_spans`)."""
        q = self._span_queue(dst)
        while True:  # drop stale replies from an abandoned collection
            try:
                q.get_nowait()
            except queue.Empty:
                break
        self._send_neg(dst, _MSG_SPANS, _SPANS_DIGEST)
        deadline = time.monotonic() + timeout
        while True:
            aux, tensors = q.get(timeout=max(0.0, deadline
                                             - time.monotonic()))
            if aux == _SPANS_DIGEST:
                return telemetry.digest_from_wire(tensors[1])
            # a late reply from a previously timed-out collect_spans probe
            # (different aux): discard, keep waiting for OUR reply


class DcnPipelineStage:
    """One pipeline stage over the DCN transport: recv -> work -> send on
    background threads with bounded hand-off queues (the reference's
    `DistP2pPipelineStage` role, p2p:334-450).

    Two work contracts:

    - `work_cb(tensors) -> tensors`: the legacy single-phase form — the
      whole recv->compute->readback runs on the work thread.
    - `dispatch_cb(tensors) -> handle` + `readback_cb(handle) -> tensors`:
      the overlapped form. `dispatch_cb` runs on the work thread and must
      NOT block on device results (launch the stage's kernels, start
      the async device->host copies — wire.wire_encode_device — and
      return a handle immediately); `readback_cb` runs on the SEND thread
      and completes the handle into the wire tensor list. With `depth` >=
      2 the work thread dispatches microbatch i+1's compute while the
      send thread drains microbatch i's readback — compute, D2H copy and
      socket send overlap instead of serializing. FIFO order is preserved
      (single work thread, single send thread, FIFO queues).

    `depth` sizes both hand-off queues (default env DCN_STAGE_DEPTH or 2;
    the pre-overlap behavior was a hardcoded 1). Ranks outside the
    schedule pass rank_src=rank_dst=None with no callback and idle
    (reference model_cfg.py:154-159).
    """

    _SENTINEL = object()
    # dispatch_cb return value meaning "drop this item": nothing is
    # enqueued for readback/send and the stage-local sequence counter
    # does not advance — the recovery path for a corrupt inbound frame
    # whose resend will re-enter the recv loop as a fresh item
    SKIP = object()

    def __init__(self, ctx: DistDcnContext, rank_src: Optional[int],
                 rank_dst: Optional[int],
                 work_cb: Optional[
                     Callable[[List[np.ndarray]], List[np.ndarray]]] = None,
                 results_cb: Optional[Callable] = None,
                 recv_channel: int = CHANNEL_DATA,
                 send_channel: int = CHANNEL_DATA,
                 dispatch_cb: Optional[Callable] = None,
                 readback_cb: Optional[Callable] = None,
                 depth: Optional[int] = None,
                 mb_of: Optional[Callable] = None,
                 stage: Optional[int] = None):
        if depth is None:
            depth = int(os.getenv("DCN_STAGE_DEPTH", "2"))
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if dispatch_cb is not None and work_cb is not None:
            raise ValueError("pass work_cb OR dispatch_cb/readback_cb, "
                             "not both")
        if readback_cb is not None and dispatch_cb is None:
            raise ValueError("readback_cb requires dispatch_cb")
        if work_cb is None and dispatch_cb is None \
                and not (rank_src is None and rank_dst is None):
            # only the not-in-schedule idle stage may omit the callback;
            # a wired stage without one would die silently on its first
            # frame in a daemon thread
            raise ValueError("a stage with rank_src/rank_dst needs a "
                             "work_cb or dispatch_cb")
        self._ctx = ctx
        self._rank_src = rank_src
        self._rank_dst = rank_dst
        self._dispatch_cb = dispatch_cb if dispatch_cb is not None else work_cb
        self._readback_cb = readback_cb
        self._results_cb = results_cb
        self._recv_channel = recv_channel
        self._send_channel = send_channel
        # telemetry: extracts the GLOBAL microbatch id from an inbound
        # tensor list (failover frames carry it as the leading tensor);
        # without it spans tag the stage-local dispatch sequence, which a
        # failover replay would renumber from 0 — miscorrelating exactly
        # the traces failover forensics needs
        self._mb_of = mb_of
        # pipeline-stage index for span tagging: with it, this stage's
        # dispatch/readback/emit spans land on the report's per-stage
        # tracks AND in the digest the rebalancer differences per round
        self._stage = stage
        self._depth = depth
        self._queue_work: "queue.Queue" = queue.Queue(maxsize=depth)
        self._queue_out: "queue.Queue" = queue.Queue(maxsize=depth)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    def start(self) -> None:
        if self._rank_src is None and self._rank_dst is None \
                and self._dispatch_cb is None:
            return  # not in the schedule: idle (reference runtime.py:456-460)
        # fresh session state: a stopped stage can be restarted (stop()
        # joined all threads, which hold the old event/queues)
        self._stop = threading.Event()
        self._queue_work = queue.Queue(maxsize=self._depth)
        self._queue_out = queue.Queue(maxsize=self._depth)
        for target, name in ((self._recv_loop, "recv"),
                             (self._work_loop, "work"),
                             (self._send_loop, "send")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"dcn-stage-{name}")
            t.start()
            self._threads.append(t)

    @property
    def recv_channel(self) -> int:
        """The channel this stage's inputs arrive on."""
        return self._recv_channel

    def stop(self) -> None:
        self._stop.set()
        # drain before inserting the sentinel so a producer blocked on a full
        # single-slot queue is released (it re-checks _stop after the put)
        for q in (self._queue_work, self._queue_out):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            try:
                q.put_nowait(self._SENTINEL)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()

    def enqueue_tensors(self, tensors: List[np.ndarray],
                        trace: Optional["telemetry.TraceContext"] = None
                        ) -> None:
        """Inject data at the head of the pipeline (reference
        enqueue_tensor, p2p:442-450); blocks when the stage is busy.
        `trace` tags this microbatch's spans and rides downstream."""
        self._queue_work.put((tensors, trace))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *args):
        self.stop()

    def _recv_loop(self) -> None:
        if self._rank_src is None:
            return  # head stage: fed by enqueue_tensors
        while not self._stop.is_set():
            try:
                tensors, _, trace = self._ctx.recv_tensors_traced(
                    self._rank_src, timeout=0.2,
                    channel=self._recv_channel)
            except queue.Empty:
                continue
            except ConnectionError:
                # upstream died: the context's peer-death handler owns the
                # fleet-wide reaction (CMD_STOP broadcast); this thread just
                # stops pulling
                return
            self._queue_work.put((tensors, trace))

    def _work_loop(self) -> None:
        # span mb tag: the global id when the frame carries one (mb_of),
        # else the stage-local dispatch sequence (equal to the global id
        # on a FIFO run)
        seq = 0
        while True:
            item = self._queue_work.get()
            if item is self._SENTINEL or self._stop.is_set():
                return
            tensors, trace = item
            mb = seq
            if self._mb_of is not None:
                try:
                    mb = self._mb_of(tensors)
                except Exception:  # malformed frame: keep the sequence tag
                    pass
            rid = trace.rid if trace is not None else None
            # trace_scope: spans the callback records WITHOUT an explicit
            # rid (the compute span inside dispatch_cb) inherit this
            # microbatch's request id through the thread-local context
            with telemetry.trace_scope(trace), \
                    telemetry.span("stage", "dispatch", stage=self._stage,
                                   mb=mb, rid=rid):
                out = self._dispatch_cb(tensors)
            if out is self.SKIP:
                continue    # dropped (corrupt frame awaiting its resend)
            self._queue_out.put((mb, out, trace))
            seq += 1

    def _send_loop(self) -> None:
        while True:
            item = self._queue_out.get()
            if item is self._SENTINEL or self._stop.is_set():
                return
            mb, item, trace = item
            rid = trace.rid if trace is not None else None
            if self._readback_cb is not None:
                # drain the async readback HERE, after the work thread is
                # already free to dispatch the next microbatch
                with telemetry.trace_scope(trace), \
                        telemetry.span("stage", "readback",
                                       stage=self._stage, mb=mb, rid=rid):
                    item = self._readback_cb(item)
            if self._rank_dst is not None:
                try:
                    # emit span: the downstream hand-off — socket transfer
                    # plus any slow-link stall or backpressure. A cost the
                    # stage pays per microbatch REGARDLESS of its layer
                    # range, which is exactly how the rebalance solver
                    # treats it (feedback.StageEstimate.fixed_s). The
                    # trace context rides the outbound frame, so the next
                    # stage inherits the request id without the payload
                    # tensors ever carrying it.
                    with telemetry.span("stage", "emit", stage=self._stage,
                                        mb=mb, rid=rid):
                        self._ctx.send_tensors(self._rank_dst, item,
                                               channel=self._send_channel,
                                               trace=trace)
                except OSError:
                    return  # downstream died: peer-death handler notified
            elif self._results_cb is not None:
                self._results_cb(item)


# -- protocol-table self-check (import-time) -------------------------------

def _check_protocol_table() -> None:
    """Assert the `_MSG_*` table is coherent: every id unique, and every
    constant actually dispatched by `_reader_loop` (introspected from its
    source, so the check cannot drift from the code). A message type that
    only ever needs SENDING would go in `_MSG_SENDER_ONLY` — today every
    type is also received somewhere, so it is empty. Runs at import: a
    colliding or orphaned id fails the process before any frame moves."""
    import ast as _ast
    import inspect
    import textwrap

    msgs = {name: val for name, val in globals().items()
            if name.startswith("_MSG_") and isinstance(val, int)}
    by_id: Dict[int, List[str]] = {}
    for name, val in msgs.items():
        by_id.setdefault(val, []).append(name)
    dupes = {i: sorted(ns) for i, ns in by_id.items() if len(ns) > 1}
    assert not dupes, f"_MSG_ id collisions: {dupes}"
    try:
        reader_src = inspect.getsource(DistDcnContext._reader_loop)
        reader_tree = _ast.parse(textwrap.dedent(reader_src))
    except (OSError, TypeError, SyntaxError):  # pragma: no cover
        return                    # frozen/stripped: uniqueness still checked
    # CODE references only (ast.Name) — a comment or docstring mentioning
    # a _MSG_ constant must not satisfy the dispatch requirement
    dispatched = {n.id for n in _ast.walk(reader_tree)
                  if isinstance(n, _ast.Name) and n.id.startswith("_MSG_")}
    sender_only: frozenset = frozenset()
    missing = sorted(set(msgs) - dispatched - sender_only)
    assert not missing, (
        f"_MSG_ constants with no _reader_loop dispatch entry: {missing} "
        "(add the dispatch arm, or list the name in _MSG_SENDER_ONLY "
        "inside _check_protocol_table)")


_check_protocol_table()
