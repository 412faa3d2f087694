"""Sequence-parallel attention (`parallel/sequence.py`) against the JAX
package.

The cases of `tests/test_sequence.py` on the port's ring and Ulysses
cores over `[cpu] * n` shards: full attention, causal or not, GQA, and
Mistral's sliding window at 1, 3, 8, 17 and 64 (smaller than, equal to
and larger than the chunk), each held to the numpy oracle and to JAX's
`make_sequence_parallel_attention` on the conftest's CPU devices within
rtol=2e-4, atol=2e-5 (bf16: rtol=0.1, atol=0.05), the JAX test's
tolerances. Beside them:

- the ring makes exactly `_ring_steps - 1` rotations (window-skipped
  blocks are never rotated in), and a window needs causal attention;
- Ulysses' GQA pre-repeat to lcm(kv, n) heads warns once per (kv, n), in
  JAX's words;
- the Ulysses route: without a window each shard's head group attends
  through `ops/attention.py fused_attention` (kernel 3 on the card, its
  plain version here); under a window through the blockwise update, no
  `fused_attention` call.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.parallel import sequence as jseq
from pipeedge_tpu_torch.parallel import sequence as tseq
from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for

RTOL, ATOL = 2e-4, 2e-5


def _reference_attention(q, k, v, causal=False, window=None):
    d = q.shape[-1]
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal or window is not None:
        s = q.shape[1]
        mask = np.tril(np.ones((s, s), bool))
        if window is not None:
            pos = np.arange(s)
            mask &= pos[None, :] > pos[:, None] - window
        scores = np.where(mask[None, None], scores, -np.inf)
    scores = scores - scores.max(axis=-1, keepdims=True)
    probs = np.exp(scores)
    probs = probs / probs.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", probs, v)


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32))


def _both(n, kind, q, k, v, causal=False, window=None, dtype=None):
    """(port output, JAX output) of the global-tensor wrapper over n
    shards / devices."""
    group = ShardGroup(devices_for(n, "cpu"), "sp")
    fn = tseq.make_sequence_parallel_attention(group, kind=kind,
                                               causal=causal, window=window)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = fn(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    jfn = jseq.make_sequence_parallel_attention(
        Mesh(np.asarray(jax.devices()[:n]), ("sp",)), kind=kind,
        causal=causal, window=window)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jfn(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    return got, np.asarray(want.astype(jnp.float32))


def _check(got, jax_out, expected, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got.float().numpy(), jax_out, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_full_attention(kind, causal):
    q, k, v = _qkv(0, 2, 64, 8, 8, 16)
    got, ref = _both(8, kind, q, k, v, causal=causal)
    _check(got, ref, _reference_attention(q, k, v, causal=causal))


def test_ring_long_sequence_4_devices():
    q, k, v = _qkv(1, 1, 512, 4, 4, 32)
    got, ref = _both(4, "ring", q, k, v)
    _check(got, ref, _reference_attention(q, k, v))


def test_ring_bfloat16():
    q, k, v = _qkv(2, 1, 32, 4, 4, 16)
    got, ref = _both(4, "ring", q, k, v, dtype="bf16")
    assert got.dtype == torch.bfloat16
    _check(got, ref, _reference_attention(q, k, v), rtol=0.1, atol=0.05)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_gqa_kv_heads_match_full_attention(kind):
    """K/V carry 4 heads for 8 query heads and repeat only in the local
    attend."""
    q, k, v = _qkv(7, 2, 32, 8, 4, 16)
    got, ref = _both(4, kind, q, k, v, causal=True)
    _check(got, ref, _reference_attention(q, np.repeat(k, 2, 2),
                                          np.repeat(v, 2, 2), causal=True))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("window", [1, 3, 8, 17, 64])
def test_sliding_window_matches_full_attention(kind, window):
    """Windows below, at and above the chunk (64 / 8 shards = 8): the
    mask and the ring's skipped steps."""
    q, k, v = _qkv(11, 2, 64, 8, 8, 16)
    got, ref = _both(8, kind, q, k, v, causal=True, window=window)
    _check(got, ref, _reference_attention(q, k, v, causal=True,
                                          window=window))


def test_sliding_window_gqa_ring():
    q, k, v = _qkv(13, 1, 64, 8, 4, 16)
    got, ref = _both(4, "ring", q, k, v, causal=True, window=5)
    _check(got, ref, _reference_attention(q, np.repeat(k, 2, 2),
                                          np.repeat(v, 2, 2), causal=True,
                                          window=5))


def test_ring_window_skips_out_of_window_blocks(monkeypatch):
    """`_ring_steps` as JAX's, and the ring rotates K and V exactly
    `_ring_steps - 1` times each: a skipped block is never brought in."""
    for args in ((8, 8, 1), (8, 8, 8), (8, 8, 9), (8, 8, 10), (8, 8, 17),
                 (8, 8, None), (8, 8, 10**9), (8, 16384, 4096)):
        assert tseq._ring_steps(*args) == jseq._ring_steps(*args)
    assert tseq._ring_steps(8, 16384, 4096) == 2
    group = ShardGroup(devices_for(8, "cpu"), "sp")
    hops = []
    real = group.ring_forward
    monkeypatch.setattr(group, "ring_forward",
                        lambda xs: hops.append(1) or real(xs))
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 64, 2, 2, 8))
    for window, steps in ((3, 2), (10, 3), (None, 8)):
        hops.clear()
        tseq.make_sequence_parallel_attention(group, "ring", causal=True,
                                              window=window)(q, k, v)
        assert len(hops) == 2 * (steps - 1), (window, len(hops))


def test_window_requires_causal():
    group = ShardGroup(devices_for(4, "cpu"), "sp")
    x = torch.zeros((1, 16, 4, 8))
    with pytest.raises(ValueError, match="requires causal"):
        tseq.make_sequence_parallel_attention(group, "ring", causal=False,
                                              window=4)(x, x, x)
    with pytest.raises(ValueError, match="must be >= 1"):
        tseq.make_sequence_parallel_attention(group, "ulysses", causal=True,
                                              window=0)(x, x, x)


def test_gqa_ulysses_indivisible_kv_falls_back(caplog):
    """2 kv heads over 4 shards: K/V pre-repeat to lcm(2, 4) = 4 heads,
    the output is exact, and the warning (JAX's words) fires once."""
    q, k, v = _qkv(9, 1, 32, 8, 2, 16)
    tseq._WARNED_GQA_FALLBACK.discard((2, 4))
    with caplog.at_level(logging.WARNING, logger=tseq.__name__):
        got, ref = _both(4, "ulysses", q, k, v, causal=True)
        _both(4, "ulysses", q, k, v, causal=True)
    _check(got, ref, _reference_attention(q, np.repeat(k, 4, 2),
                                          np.repeat(v, 4, 2), causal=True))
    warned = [r.getMessage() for r in caplog.records
              if r.name == tseq.__name__]
    assert warned == [
        "ulysses GQA fallback: kv_heads=2 not divisible by sp=4; K/V "
        "pre-repeat to lcm=4 heads, so the all-to-all moves 2x the "
        "GQA-ideal K/V bytes. Use an sp degree dividing kv_heads to keep "
        "the full advantage."]


@pytest.mark.parametrize("window", [None, 6])
def test_ulysses_route(window, monkeypatch):
    """Unwindowed, each shard's head group goes through `fused_attention`
    once (on [B, S, H/n, D], K/V repeated to its query heads); under a
    window the blockwise update runs and `fused_attention` never."""
    shapes = []
    real = tseq.fused_attention

    def spy(q, k, v, causal=False):
        shapes.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tseq, "fused_attention", spy)
    q, k, v = _qkv(5, 2, 32, 8, 4, 16)
    got, ref = _both(2, "ulysses", q, k, v, causal=True, window=window)
    _check(got, ref, _reference_attention(q, np.repeat(k, 2, 2),
                                          np.repeat(v, 2, 2), causal=True,
                                          window=window))
    want = [((2, 32, 4, 16), (2, 32, 4, 16), True)] * 2 if window is None \
        else []
    assert shapes == want


def test_resolve_sp_core_is_jax_s():
    """The core dispatch refuses what JAX's does, in its words."""
    for args in (("ulysses", 6, 4), ("tree", None, None)):
        with pytest.raises(ValueError) as port:
            tseq.resolve_sp_core(*args)
        with pytest.raises(ValueError) as ref:
            jseq.resolve_sp_core(*args)
        assert str(port.value) == str(ref.value)
    assert tseq.resolve_sp_core("ring") is tseq.ring_attention
    assert tseq.resolve_sp_core("ulysses", 8, 4, window=3).keywords == {
        "window": 3}
