"""EQuARX-style quantized collectives over a shard group.

Port of `pipeedge_tpu/ops/qcollectives.py`. The JAX functions run inside
`shard_map` on each device over a named axis; here they take the shard
group (`parallel/mesh.py ShardGroup`) and a per-shard list of tensors
and return a per-shard list. Shard i gets what JAX gives device i:

- `qpsum`: quantized all-reduce ("EQuARX: Efficient Quantized AllReduce
  in XLA", arxiv 2506.17615). Each shard's flat addend splits into n
  chunks; a ring reduce-scatter moves block-scaled int`bit` payloads with
  an f32 accumulator (each hop decodes, adds the local chunk at full
  precision and re-encodes only what travels), then a ring all-gather
  moves each reduced chunk, encoded once. The chunk a shard reduces
  stays f32 there; each remote chunk carries one more quantization
  error (`qpsum_error_bound`).
- `qall_gather`: each shard is encoded once and rides n - 1 ring hops;
  the local shard stays exact.

Block scaling is the edge codec: a chunk reshaped to [m / block, block]
is an outer-dim batch, so every encode and decode is `fused_quant
.encode_outerdim` / `decode_outerdim`, which on a CUDA tensor launches
kernel 1 or 2 (`csrc/fused_quant.cu`) or raises, and on a CPU tensor
runs the plain codec. The encode runs on the sending shard's device, the
packed words hop (`ShardGroup.ring_forward`), the decode runs on the
receiver's. The optional Banner clamp (`ops/clamp.py`) bounds each
collective's quantization step under the Laplace activation model.

Observability: every quantized call adds its wire footprint to a tally
(`trace_tally`). JAX tallies a traced site once and its drivers multiply
by the executions they ran; PyTorch runs eagerly, so here a call is an
execution, and the tally keeps one entry per distinct footprint (kind,
bits, shards, bytes) with its count of `calls`, which bounds its size.
`record_collectives()` folds it into `collective` telemetry spans named
`{kind}{bit}:{wire_bytes}` (the run total of that footprint, which
`telemetry/report.py` parses into its `collectives` section) and the
`pipeedge_collective_bits_total{collective,bits}` counter.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from .. import telemetry
from ..telemetry.metrics import REGISTRY
from . import clamp as clamp_ops
from . import fused_quant
from . import quant as quant_ops

# bitwidths a quantized collective accepts (0 = exact passthrough)
QCOLLECTIVE_BITS = (0, 4, 8)

# values per scale/shift pair: small enough that one outlier only poisons
# its own block, large enough that the f32 scale/shift metadata stays ~3%
# of the int8 payload
DEFAULT_BLOCK = 256

# kernel 1's blocks per encoded item on the ring: one. A 256-float item
# split over the edge's 8-block cluster is mostly cluster barrier; one
# block per item gives the same words and took 0.0221 ms against 0.192 at
# the ring's [2364, 256] chunk of a ViT-Base addend, 0.137 against 1.31
# at a Llama-3-8B prompt's [16384, 256] (NVIDIA H100 80GB HBM3, 700 W;
# chip_smoke.py phase 21a)
RING_CLUSTER = 1

COLLECTIVE_BITS_TOTAL = REGISTRY.counter(
    "pipeedge_collective_bits_total",
    "wire bits moved by quantized intra-stage collectives, per collective "
    "kind and bitwidth (per-device ring traffic)")
# the full kind x bitwidth domain renders before the first increment
for _kind in ("psum", "all_gather"):
    for _bit in (4, 8):
        COLLECTIVE_BITS_TOTAL.declare(collective=_kind, bits=str(_bit))


# -- the wire-footprint tally --------------------------------------------

# (kind, bit, n_shards, wire_bytes, raw_bytes) -> calls. wire_bytes is
# what ONE shard sends per call (all ring hops, packed words + scale/shift
# metadata); raw_bytes what the exact f32 ring would send
_TALLY: Dict[tuple, int] = {}
_TALLY_LOCK = threading.Lock()


def reset_trace_tally() -> None:
    """Clear the tally (drivers call this before a run they fold)."""
    with _TALLY_LOCK:
        _TALLY.clear()


def trace_tally() -> List[Dict]:
    """One record per distinct footprint since the last reset: {kind,
    bit, n_shards, wire_bytes, raw_bytes, calls}."""
    with _TALLY_LOCK:
        items = list(_TALLY.items())
    return [{"kind": k, "bit": b, "n_shards": n, "wire_bytes": w,
             "raw_bytes": r, "calls": c} for (k, b, n, w, r), c in items]


def _enc_bytes_per_chunk(chunk: int, block: int, bit: int) -> int:
    """Wire bytes of one block-scaled encoded chunk: packed words + the
    per-block f32 scale/shift pair."""
    n_blocks = chunk // block
    return n_blocks * (quant_ops.packed_words(block, bit) * 4 + 8)


def _tally(kind: str, bit: int, n_shards: int, hops: int, chunk: int,
           block: int) -> None:
    key = (kind, bit, n_shards, hops * _enc_bytes_per_chunk(chunk, block, bit),
           hops * chunk * 4)
    with _TALLY_LOCK:
        _TALLY[key] = _TALLY.get(key, 0) + 1


def record_collectives(executions: int = 1,
                       stage: Optional[int] = None) -> Dict:
    """Fold the tally into telemetry + /metrics after a run.

    For each footprint: one instant `collective` span named
    `{kind}{bit}:{wire_bytes}`, the bytes being the footprint's per-call
    wire bytes x its calls x `executions` (1 for eagerly tallied calls; a
    caller that tallied one representative run passes how many it
    stands for), and `pipeedge_collective_bits_total` raised by the same
    bits. Returns the summary record the JAX function returns, plus the
    count of tallied `calls`."""
    now = time.monotonic_ns()
    wire_bits = 0
    raw_bits = 0
    tally = trace_tally()
    for t in tally:
        site_bytes = t["wire_bytes"] * t["calls"] * executions
        site_bits = site_bytes * 8
        wire_bits += site_bits
        raw_bits += t["raw_bytes"] * t["calls"] * 8 * executions
        telemetry.record("collective", f"{t['kind']}{t['bit']}:"
                         f"{site_bytes}", now, now, stage=stage)
        COLLECTIVE_BITS_TOTAL.inc(amount=site_bits,
                                  collective=t["kind"], bits=str(t["bit"]))
    return {"sites": len(tally), "executions": executions,
            "calls": sum(t["calls"] for t in tally),
            "wire_bits_total": wire_bits, "raw_bits_total": raw_bits,
            "wire_reduction": (round(raw_bits / wire_bits, 3)
                               if wire_bits else None)}


# -- the collectives -----------------------------------------------------

def _check_bit(bit: int) -> None:
    if bit not in QCOLLECTIVE_BITS:
        raise ValueError(f"quantized collectives support bits "
                         f"{QCOLLECTIVE_BITS}, got {bit}")


def _block_encode(chunk: torch.Tensor, bit: int,
                  block: int) -> quant_ops.QuantizedTensor:
    """Block-scaled encode of a flat [m] chunk (m % block == 0): each
    `block`-value group gets its own scale/shift (kernel 1 on the card,
    one block per group: RING_CLUSTER)."""
    return fused_quant.encode_outerdim(chunk.reshape(-1, block), bit,
                                       cluster=RING_CLUSTER)


def _block_decode(enc: quant_ops.QuantizedTensor) -> torch.Tensor:
    """Inverse of `_block_encode`, flat f32 (kernel 2 on the card)."""
    return fused_quant.decode_outerdim(enc).reshape(-1)


def _flat_addend(x: torch.Tensor, bit: int, clamp: bool, padded: int
                 ) -> torch.Tensor:
    """x flattened to f32, clamped if asked, zero-padded to `padded`."""
    flat = x.reshape(-1).to(torch.float32)
    if clamp:
        flat = clamp_ops.clamp_banner2019_laplace(flat, bit)
    if padded > flat.shape[0]:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.shape[0])])
    return flat


def qpsum(group, xs: Sequence[torch.Tensor], bit: int, *,
          block: int = DEFAULT_BLOCK, clamp: bool = False
          ) -> List[torch.Tensor]:
    """Quantized all-reduce of the per-shard addends `xs` (EQuARX-style).

    bit=0 is the exact `group.psum`. Otherwise each flat addend splits
    into n chunks (zero-padded to n x block alignment); the ring
    reduce-scatter moves block-scaled int`bit` payloads with an f32
    accumulator, and the ring all-gather moves each reduced chunk encoded
    once. Result dtype follows the input; the accumulation is f32.
    `clamp=True` applies the Banner Laplace clamp to each local addend
    first. `qpsum_error_bound` bounds |quantized - exact| unclamped."""
    _check_bit(bit)
    if bit == 0:
        return group.psum(xs)
    n = group.size
    if n == 1:
        return list(xs)
    orig_shape, orig_dtype = xs[0].shape, xs[0].dtype
    m = xs[0].numel()
    chunk = block * (-(-m // (n * block)))
    total = n * chunk
    chunks = group.map(
        lambda i, x: _flat_addend(x, bit, clamp, total).reshape(n, chunk),
        xs)

    # ring reduce-scatter, widened accumulator: at step s shard i forwards
    # the partial sum of chunk (i - s) mod n and folds chunk (i - s - 1)
    # mod n of its own addend into what arrives
    send = [chunks[i][i] for i in range(n)]
    for s in range(n - 1):
        enc = group.map(lambda i, t: _block_encode(t, bit, block), send)
        send = group.map(
            lambda i, e, s=s: _block_decode(e) + chunks[i][(i - s - 1) % n],
            group.ring_forward(enc))
    own = send                       # shard i: full sum of chunk (i + 1) % n

    # quantized all-gather of the reduced chunks: each encoded ONCE, so a
    # remote chunk carries exactly one quantization error and the locally
    # reduced chunk stays exact f32
    def start(i, piece):
        buf = piece.new_zeros((n, chunk))
        buf[(i + 1) % n] = piece
        return buf

    out = group.map(start, own)
    cur = group.map(lambda i, t: _block_encode(t, bit, block), own)
    for k in range(1, n):
        cur = group.ring_forward(cur)

        # after k hops shard i holds the chunk reduced by shard i - k
        def place(i, enc, k=k):
            out[i][(i + 1 - k) % n] = _block_decode(enc)
        group.map(place, cur)
    _tally("psum", bit, n, 2 * (n - 1), chunk, block)
    return group.map(
        lambda i, buf: buf.reshape(total)[:m].reshape(orig_shape)
        .to(orig_dtype), out)


def qall_gather(group, xs: Sequence[torch.Tensor], bit: int, *,
                axis: int = 0, tiled: bool = True,
                block: int = DEFAULT_BLOCK, clamp: bool = False
                ) -> List[torch.Tensor]:
    """Quantized all-gather of the per-shard tensors `xs` (one shape).

    bit=0 is the exact `group.all_gather`. Otherwise each shard is
    block-scale-encoded ONCE and the packed payload rides n - 1 ring hops;
    the local shard stays exact. `tiled=True` concatenates the shards
    along `axis`; `tiled=False` stacks them on a new axis `axis`."""
    _check_bit(bit)
    if bit == 0:
        return group.all_gather(xs, dim=axis, tiled=tiled)
    n = group.size
    if n == 1:
        return [xs[0] if tiled else xs[0].unsqueeze(axis)]
    shape, orig_dtype = xs[0].shape, xs[0].dtype
    m = xs[0].numel()
    padded = block * (-(-m // block))
    # the local shard enters exact (not its quantized round trip)
    pieces = group.map(lambda i, x: {i: x.to(torch.float32)}, xs)
    cur = group.map(
        lambda i, x: _block_encode(_flat_addend(x, bit, clamp, padded), bit,
                                   block), xs)
    for k in range(1, n):
        cur = group.ring_forward(cur)

        def place(i, enc, k=k):
            pieces[i][(i - k) % n] = _block_decode(enc)[:m].reshape(shape)
        group.map(place, cur)
    _tally("all_gather", bit, n, n - 1, padded, block)

    def join(i, got):
        parts = [got[j].to(orig_dtype) for j in range(n)]
        return (torch.cat(parts, dim=axis) if tiled
                else torch.stack(parts, dim=axis))
    return group.map(join, pieces)


def qpsum_error_bound(shard_absrange: float, bit: int, n_shards: int,
                      block: int = DEFAULT_BLOCK) -> float:
    """Conservative worst-case |qpsum - psum| per element (unclamped).

    Each reduce-scatter hop s quantizes a partial sum of s+1 shard chunks
    whose per-block range is at most (s+1) x `shard_absrange`; the gather
    hop quantizes the full n-shard sum. A block-scaled encode's round-off
    is half a step = range / (2^bit - 1) / 2. Summing the n-1 RS hops and
    the single AG encode, then doubling for float round-off slack:

        2 * (sum_{s=1}^{n-1} s + n) * R / (2 (2^bit - 1))

    where R = `shard_absrange` (max - min of any one shard's block)."""
    del block  # the bound holds per block; range is the caller's worst block
    levels = float((1 << bit) - 1)
    hops = sum(range(1, n_shards)) + n_shards
    return 2.0 * hops * shard_absrange / (2.0 * levels) + 1e-5
