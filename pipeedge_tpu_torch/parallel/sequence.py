"""Sequence parallelism: ring attention and Ulysses-style all-to-all.

Port of `pipeedge_tpu/parallel/sequence.py`. The sequence axis of q, k
and v splits over a `parallel/mesh.py ShardGroup`, one chunk [B, S/n, H,
D] per shard, and each core returns each shard's output chunk (per-shard
lists in and out, as the JAX cores run per device under `shard_map`):

- `ring_attention`: K/V chunks rotate round the ring
  (`ShardGroup.ring_forward`) while a streaming (log-sum-exp) softmax
  accumulates each shard's queries against each arriving block. Under a
  sliding window the ring stops early: blocks wholly behind every local
  query's window are never rotated in (`_ring_steps`).
- `ulysses_attention`: an all-to-all turns sequence shards into head
  shards [B, S, H/n, D], each shard attends its head group over the whole
  sequence, and the inverse all-to-all restores sequence shards. The
  local attend of an unwindowed core is kernel 3's function, so it goes
  through `ops/attention.py fused_attention` (the kernel on a CUDA
  tensor, its plain version on a CPU one), K/V repeated to the query
  heads first. Under a sliding window (kernel 3 has none) it is the
  blockwise streaming update over S/n-row key blocks. The route is fixed
  by the configuration, never taken on a failure.

Both are exact (full attention to float tolerance), GQA-aware (kv heads
ride the ring and the all-to-all unrepeated and repeat only in the local
attend) and take causal masks at global positions and Mistral's window
(query q attends keys in (q - window, q], `models/llama.py
_window_keep`).
"""
from __future__ import annotations

import logging
import math
from functools import partial
from typing import List, Optional, Sequence

import torch

from ..ops.attention import fused_attention

logger = logging.getLogger(__name__)

_WARNED_GQA_FALLBACK = set()


def _repeat_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, kv, D] -> [B, S, heads, D], each kv head repeated in place
    (`jnp.repeat` on the head axis)."""
    rep = heads // x.shape[2]
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def _block_attention(q, k, v, m_prev, l_prev, acc_prev, q_offset: int,
                     k_offset: int, causal: bool, scale: float,
                     window: Optional[int] = None):
    """One streaming-softmax block update of q [B, Sq, H, D] over k/v
    [B, Sk, H or KV, D] (GQA heads repeat here, locally): the running
    (max [B, H, Sq], sum [B, H, Sq], acc [B, Sq, H, D]) over the key axis,
    scores and statistics in f32. `window` bounds how far back a query
    attends: k in (q - window, q]."""
    k = _repeat_heads(k, q.shape[2])
    v = _repeat_heads(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal or window is not None:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        scores = scores.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    # a fully masked row keeps m = -inf: shift it by 0, not by -inf
    safe_m = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(scores - safe_m[..., None])
    corr = torch.exp(m_prev - safe_m)
    l_new = l_prev * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    acc_new = acc_prev * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _finish_softmax(acc, l, out_dtype):
    """Normalize the streaming accumulator; fully masked rows give 0."""
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l.transpose(1, 2)[..., None]).to(out_dtype)


def _init_state(b: int, s: int, h: int, d: int, device):
    return (torch.full((b, h, s), -math.inf, device=device),
            torch.zeros((b, h, s), device=device),
            torch.zeros((b, s, h, d), device=device))


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        if window < 1:
            raise ValueError(f"sliding window must be >= 1, got {window}")


def _ring_steps(n: int, chunk: int, window: Optional[int]) -> int:
    """How many ring steps a windowed causal attention needs.

    Step t delivers the K/V block t hops behind the local queries; its
    nearest key is (t-1)*chunk + 1 positions before the first query, so a
    step whose distance exceeds window - 1 lies outside every query's
    (q - window, q] range and is skipped: neither computed nor rotated
    in."""
    if window is None:
        return n
    return min(n, (window - 2) // chunk + 2)


def ring_attention(group, qs: Sequence[torch.Tensor],
                   ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                   causal: bool = False,
                   window: Optional[int] = None) -> List[torch.Tensor]:
    """Exact attention over a ring-split sequence: `qs[i]`, `ks[i]`,
    `vs[i]` are shard i's chunks [B, S/n, H (or KV), D]; returns each
    shard's output chunk. A `window` masks and shortens the ring: only
    the first `_ring_steps` blocks run at all."""
    _check_window(causal, window)
    n = group.size
    b, sq, h, d = qs[0].shape
    scale = 1.0 / math.sqrt(d)
    chunk = ks[0].shape[1]
    n_steps = _ring_steps(n, chunk, window)
    state = group.map(lambda i, q: _init_state(b, sq, h, d, q.device), qs)

    def attend(t, state, k_cur, v_cur):
        # block t came from ring neighbour (i - t) mod n
        return group.map(
            lambda i, q, st, kc, vc: _block_attention(
                q, kc, vc, *st, i * sq, ((i - t) % n) * chunk, causal,
                scale, window), qs, state, k_cur, v_cur)

    k_cur, v_cur = list(ks), list(vs)
    # the last update runs after the loop, so the ring makes exactly
    # n_steps - 1 rotations: one more would only bring in a block that is
    # skipped or already consumed
    for t in range(n_steps - 1):
        state = attend(t, state, k_cur, v_cur)
        k_cur, v_cur = group.ring_forward(k_cur), group.ring_forward(v_cur)
    state = attend(n_steps - 1, state, k_cur, v_cur)
    return group.map(lambda i, q, st: _finish_softmax(st[2], st[1], q.dtype),
                     qs, state)


def _blockwise_local(q, k, v, n: int, causal: bool,
                     window: Optional[int]) -> torch.Tensor:
    """Ulysses' windowed local attend: q [B, S, H/n, D] over the whole
    sequence's K/V in n key blocks of S/n rows, streaming."""
    b, s, h, d = q.shape
    s_local = s // n
    state = _init_state(b, s, h, d, q.device)
    for j in range(n):
        rows = slice(j * s_local, (j + 1) * s_local)
        state = _block_attention(q, k[:, rows], v[:, rows], *state, 0,
                                 j * s_local, causal, 1.0 / math.sqrt(d),
                                 window)
    return _finish_softmax(state[2], state[1], q.dtype)


def ulysses_attention(group, qs: Sequence[torch.Tensor],
                      ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      causal: bool = False,
                      window: Optional[int] = None) -> List[torch.Tensor]:
    """Exact attention through the all-to-all head <-> sequence reshard:
    sequence chunks [B, S/n, H, D] in, head groups [B, S, H/n, D] attended
    locally, sequence chunks out. Requires H % n == 0.

    Unwindowed, the local attend is kernel 3 (`fused_attention`, K/V
    repeated to the query heads). A `window` cannot skip key blocks here
    (every shard holds every query after the first all-to-all), so it is
    a mask, applied by the blockwise streaming update."""
    _check_window(causal, window)
    n = group.size
    h = qs[0].shape[2]
    if h % n:
        raise ValueError("ulysses requires head count divisible by axis "
                         "size")
    kv = ks[0].shape[2]
    if kv != h and kv % n:
        # the GQA group count does not split n ways: pre-repeat K/V to
        # lcm(kv, n) heads, the fewest the all-to-all can split (kv and n
        # both divide h, so their lcm does too)
        target = math.lcm(kv, n)
        if (kv, n) not in _WARNED_GQA_FALLBACK:
            _WARNED_GQA_FALLBACK.add((kv, n))
            logger.warning(
                "ulysses GQA fallback: kv_heads=%d not divisible by sp=%d; "
                "K/V pre-repeat to lcm=%d heads, so the all-to-all moves "
                "%dx the GQA-ideal K/V bytes. Use an sp degree dividing "
                "kv_heads to keep the full advantage.",
                kv, n, target, target // kv)
        ks = [_repeat_heads(k, target) for k in ks]
        vs = [_repeat_heads(v, target) for v in vs]

    def to_heads(xs):          # [B, S/n, H, D] -> [B, S, H/n, D]
        return group.all_to_all(xs, split_dim=2, concat_dim=1)

    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    if window is None:
        out = group.map(lambda i, q, k, v: fused_attention(
            q, _repeat_heads(k, q.shape[2]), _repeat_heads(v, q.shape[2]),
            causal=causal), qh, kh, vh)
    else:
        out = group.map(lambda i, q, k, v: _blockwise_local(
            q, k, v, n, causal, window), qh, kh, vh)
    return group.all_to_all(out, split_dim=1, concat_dim=2)


def resolve_sp_core(sp_kind: str, num_heads: Optional[int] = None,
                    n: Optional[int] = None, window: Optional[int] = None):
    """The one dispatch point of the sequence-parallel attention core
    (the decode prefill and the standalone wrapper): 'ring' streams K/V
    round the ring and skips steps outside a window (the long-context
    choice); 'ulysses' reshards heads <-> sequence and needs heads
    divisible by the sp degree, checked here when `num_heads` and `n` are
    given. A `window` binds the sliding-window mask into the core; callers
    keep `core(group, qs, ks, vs, causal=True)`."""
    if sp_kind == "ring":
        core = ring_attention
    elif sp_kind == "ulysses":
        if num_heads is not None and n and num_heads % n:
            raise ValueError(f"ulysses sp={n} requires head count "
                             f"({num_heads}) divisible by sp")
        core = ulysses_attention
    else:
        raise ValueError(f"unknown sp_kind {sp_kind!r} (ring | ulysses)")
    if window is not None:
        core = partial(core, window=int(window))
    return core


def make_sequence_parallel_attention(group, kind: str = "ring",
                                     causal: bool = False,
                                     window: Optional[int] = None):
    """`fn(q, k, v) -> out` over global [B, S, H, D] tensors: the sequence
    splits into `group.size` chunks, one per shard on its device, and the
    output chunks are gathered on shard 0's device."""
    inner = resolve_sp_core(kind, window=window)

    @torch.inference_mode()
    def fn(q, k, v):
        n = group.size

        def split(x):
            if x.shape[1] % n:
                raise ValueError(f"sequence length {x.shape[1]} does not "
                                 f"split {n} ways")
            return [c.to(d) for c, d in zip(x.chunk(n, dim=1),
                                            group.devices)]

        out = inner(group, split(q), split(k), split(v), causal=causal)
        return group.gather(out, dim=1)

    return fn
