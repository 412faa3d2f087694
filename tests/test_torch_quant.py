"""The port's QuantPipe codec and Banner clamp against the JAX package.

Encode is held BIT-IDENTICAL (words, scale, shift) to the JAX ops: both
compute the same IEEE f32 ops in the same order and round half to even.
Decode is held to atol=2e-6 on N(0,1) data: XLA's CPU decode does not
evaluate q / L * s + h in IEEE op order (it differs by 1-2 ulp, ~1.4e-6
at |x| ~ 4), while the port divides exactly; on the card the port's
kernel and plain decode are bit-identical (chip_smoke.py).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeedge_tpu.ops import clamp as jclamp
from pipeedge_tpu.ops import fused_quant as jfused
from pipeedge_tpu.ops import quant as jquant
from pipeedge_tpu_torch.ops import clamp as tclamp
from pipeedge_tpu_torch.ops import fused_quant as tfused
from pipeedge_tpu_torch.ops import quant as tquant

SHAPES = [(3, 37), (2, 5, 7), (4, 197 * 3)]
DECODE_ATOL = 2e-6


def _data(shape, seed=0, zero_item=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_item:
        x[1] = 0.75   # a zero-range item: scale 0, guarded divide
    return x


def _assert_same_encode(t_enc, j_enc):
    np.testing.assert_array_equal(tquant.words_u32(t_enc),
                                  np.asarray(j_enc.data))
    np.testing.assert_array_equal(t_enc.scale.numpy(), np.asarray(j_enc.scale))
    np.testing.assert_array_equal(t_enc.shift.numpy(), np.asarray(j_enc.shift))
    assert t_enc.shape == tuple(j_enc.shape) and t_enc.bit == j_enc.bit


@pytest.mark.parametrize("bit", [b for b in jquant.SUPPORTED_BITS if b])
@pytest.mark.parametrize("mode", ["original", "modified"])
def test_encode_outerdim_bit_identical_all_bits(bit, mode):
    for i, shape in enumerate(SHAPES):
        x = _data(shape, seed=i, zero_item=True)
        _assert_same_encode(
            tquant.tensor_encode_outerdim(torch.from_numpy(x), bit, mode),
            jquant.tensor_encode_outerdim(jnp.asarray(x), bit, mode))


@pytest.mark.parametrize("bit", [4, 8])
@pytest.mark.parametrize("shape", [(3, 37), (8, 197, 24)])
def test_fused_encode_matches_pallas_interpret(bit, shape):
    x = _data(shape, seed=bit, zero_item=True)
    t_enc = tfused.fused_encode_outerdim(torch.from_numpy(x), bit)
    _assert_same_encode(t_enc, jfused.fused_encode_outerdim(
        jnp.asarray(x), bit, interpret=True))
    _assert_same_encode(t_enc, jquant.tensor_encode_outerdim(
        jnp.asarray(x), bit))
    # the dispatch seam takes the same path on a CPU tensor
    _assert_same_encode(tfused.encode_outerdim(torch.from_numpy(x), bit),
                        jquant.tensor_encode_outerdim(jnp.asarray(x), bit))


@pytest.mark.parametrize("bit", [b for b in jquant.SUPPORTED_BITS if b])
def test_decode_outerdim_matches_jax(bit):
    for i, shape in enumerate(SHAPES):
        x = _data(shape, seed=10 + i, zero_item=True)
        j_enc = jquant.tensor_encode_outerdim(jnp.asarray(x), bit)
        t_enc = tquant.tensor_encode_outerdim(torch.from_numpy(x), bit)
        got = tfused.decode_outerdim(t_enc)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jquant.tensor_decode_outerdim(j_enc)),
            rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("bit", [4, 8])
def test_fused_decode_matches_pallas_interpret(bit):
    x = _data((4, 5, 37), seed=3)
    j_enc = jquant.tensor_encode_outerdim(jnp.asarray(x), bit)
    t_enc = tfused.fused_encode_outerdim(torch.from_numpy(x), bit)
    np.testing.assert_allclose(
        tfused.fused_decode_outerdim(t_enc).numpy(),
        np.asarray(jfused.fused_decode_outerdim(j_enc, interpret=True)),
        rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("bit", [2, 8, 16])
def test_whole_tensor_encode_decode(bit):
    x = _data((6, 11), seed=bit)
    j_enc = jquant.tensor_encode(jnp.asarray(x), bit)
    t_enc = tquant.tensor_encode(torch.from_numpy(x), bit)
    _assert_same_encode(t_enc, j_enc)
    np.testing.assert_allclose(tquant.tensor_decode(t_enc).numpy(),
                               np.asarray(jquant.tensor_decode(j_enc)),
                               rtol=0, atol=DECODE_ATOL)


def test_passthrough_and_wire_bytes():
    x = torch.from_numpy(_data((3, 8)))
    enc = tquant.tensor_encode_outerdim(x, 0)
    assert enc.data is x and tquant.tensor_decode_outerdim(enc) is x
    enc8 = tquant.tensor_encode_outerdim(x, 8)
    assert enc8.nbytes_wire == 3 * tquant.packed_words(8, 8) * 4


def test_fused_codec_rejects_other_bits():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        tfused.fused_encode_outerdim(x, 6)


# The clip threshold is W * sqrt(var / 2) over the whole tensor; torch and
# XLA sum the f32 variance in different orders, so alpha (and only the
# clipped values) may differ by a few ulp: rtol 2e-6 bounds that, while
# every unclipped value must come through exactly.
CLAMP_RTOL = 2e-6


@pytest.mark.parametrize("bit", [2, 4, 8])
def test_banner_clamps_match(bit):
    x = _data((8, 197, 24), seed=bit) * 3.0
    for t_fn, j_fn, inp in (
            (tclamp.clamp_banner2019_laplace,
             jclamp.clamp_banner2019_laplace, x),
            (tclamp.clamp_banner2019_gelu, jclamp.clamp_banner2019_gelu,
             np.abs(x))):
        want = np.asarray(j_fn(jnp.asarray(inp), bit))
        got = t_fn(torch.from_numpy(inp), bit).numpy()
        np.testing.assert_allclose(got, want, rtol=CLAMP_RTOL, atol=0)
        inside = np.abs(want) < np.abs(want).max()
        np.testing.assert_array_equal(got[inside], want[inside])
    assert tclamp.clamp_factor_laplace(bit) == jclamp.clamp_factor_laplace(bit)
    assert tclamp.clamp_factor_gelu(bit) == jclamp.clamp_factor_gelu(bit)


@pytest.mark.parametrize("bit", [4, 8])
@pytest.mark.parametrize("n", [37, 3 * 37, 151296, 151296 * 4 + 5])
def test_encode_slices_partition(n, bit):
    """The encode kernel's partition of an item (one block per slice, one
    cluster per item): whole 32-float groups, so every block's words start
    on a 16-byte boundary at both bit widths, covering [0, n) exactly once
    with no empty block, in at most ENCODE_CLUSTER blocks."""
    blocks, slice_len = tfused.encode_slices(n)
    assert 1 <= blocks <= tfused.ENCODE_CLUSTER
    assert slice_len % tfused.ENCODE_GROUP == 0
    assert (slice_len // (32 // bit)) % 4 == 0        # 16 bytes of words
    starts = [r * slice_len for r in range(blocks)]
    ends = [min(n, s + slice_len) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e > s for s, e in zip(starts, ends))
    assert all(e == s for e, s in zip(ends, starts[1:]))


# --- non-finite input (NaN, +-inf, ranges past the f32 maximum) -----------

def _nonfinite_data(shape, seed):
    """Item 0 holds a NaN, 1 a +inf, 2 a -inf (its first value), 3
    alternates +-3e38 (max - min overflows to inf), 4 holds both
    infinities, 5 is finite."""
    x = _data(shape, seed=seed) * 3.0
    flat = x.reshape(shape[0], -1)
    n = flat.shape[1]
    flat[0, n // 3] = np.nan
    flat[1, n // 2] = np.inf
    flat[2, 0] = -np.inf
    flat[3, 0::2] = 3e38
    flat[3, 1::2] = -3e38
    flat[4, n - 1] = np.inf
    flat[4, n // 4] = -np.inf
    return x


@pytest.mark.parametrize("bit", [4, 8])
@pytest.mark.parametrize("shape", [(6, 40), (6, 5, 37)])
def test_encode_nonfinite_items_match_jax(bit, shape):
    """The plain encode (the CPU path of the codec kernel's wrapper) gives
    the JAX package's words on items whose quotients are NaN, infinite or
    out of range: XLA's f32 -> uint32 convert saturates (NaN -> 0, +inf
    -> 0xFFFFFFFF) and the words are the OR of the shifted codes cut to
    32 bits. Scale and shift match with NaN equal to NaN, and the decoded
    values too (finite ones at the decode tolerance above)."""
    x = _nonfinite_data(shape, seed=bit)
    j_enc = jquant.tensor_encode_outerdim(jnp.asarray(x), bit)
    for t_enc in (tquant.tensor_encode_outerdim(torch.from_numpy(x), bit),
                  tfused.encode_outerdim(torch.from_numpy(x), bit)):
        np.testing.assert_array_equal(tquant.words_u32(t_enc),
                                      np.asarray(j_enc.data))
        for name in ("scale", "shift"):
            np.testing.assert_array_equal(getattr(t_enc, name).numpy(),
                                          np.asarray(getattr(j_enc, name)))
        np.testing.assert_allclose(
            tfused.decode_outerdim(t_enc).numpy(),
            np.asarray(jquant.tensor_decode_outerdim(j_enc)),
            rtol=0, atol=DECODE_ATOL, equal_nan=True)
    # every item but the finite one has a non-finite scale or shift
    scale = np.asarray(j_enc.scale)
    shift = np.asarray(j_enc.shift)
    assert not np.isfinite(scale[:5] + shift[:5]).any()
    assert np.isfinite(scale[5] + shift[5])


@pytest.mark.parametrize("bit", [b for b in jquant.SUPPORTED_BITS if b])
@pytest.mark.parametrize("mode", ["original", "modified"])
def test_encode_nonfinite_items_match_jax_all_bits(bit, mode):
    x = _nonfinite_data((6, 37), seed=30 + bit)
    _assert_same_encode(
        tquant.tensor_encode_outerdim(torch.from_numpy(x), bit, mode),
        jquant.tensor_encode_outerdim(jnp.asarray(x), bit, mode))


# --- the decode kernel's arithmetic, emulated exactly ----------------------

def _rn32(v: Fraction) -> Fraction:
    """v rounded to the nearest f32, ties to even (normal range)."""
    if v == 0:
        return Fraction(0)
    m = abs(v)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    while Fraction(2) ** e > m:
        e -= 1
    while Fraction(2) ** (e + 1) <= m:
        e += 1
    ulp = Fraction(2) ** (e - 23)
    return (1 if v > 0 else -1) * round(m / ulp) * ulp


def _div_rn(a: int, levels: int) -> Fraction:
    """csrc/fused_quant.cu `div_rn(a, L, __frcp_rn(L))`: q = a r, e =
    fma(-q, L, a), fma(e, r, q), each rounded once to f32."""
    r = _rn32(Fraction(1, levels))
    q = _rn32(a * r)
    e = _rn32(a - q * levels)
    return _rn32(e * r + q)


@pytest.mark.parametrize("bit", [4, 8])
def test_decode_division_is_correctly_rounded(bit):
    """The decode kernel forms q / (2^b - 1) with one reciprocal and two
    FMAs in place of a division per value. For every code q it equals the
    correctly rounded quotient that the plain decode's IEEE division
    gives, so the kernel's words decode to the same bits."""
    levels = (1 << bit) - 1
    got = [_div_rn(q, levels) for q in range(levels + 1)]
    want = [_rn32(Fraction(q, levels)) for q in range(levels + 1)]
    assert got == want
    # and the plain version's f32 division gives those values
    plain = (torch.arange(levels + 1, dtype=torch.float32)
             / torch.full((), float(levels))).tolist()
    assert [Fraction(v) for v in plain] == want


@pytest.mark.parametrize("bit", [4, 8])
def test_decode_kernel_order_matches_plain_and_pallas(bit):
    """The decode kernel's order, emulated in numpy f32: the quotient
    table of `_div_rn`, then one rounded multiply by scale and one
    rounded add of shift. Bit-identical to the port's plain decode, and
    within the decode tolerance of the JAX interpret-mode kernel."""
    levels = (1 << bit) - 1
    table = np.array([float(_div_rn(q, levels)) for q in range(levels + 1)],
                     np.float32)
    x = _data((4, 5, 37), seed=20 + bit, zero_item=True)
    t_enc = tquant.tensor_encode_outerdim(torch.from_numpy(x), bit)
    codes = tquant._unpack_bits(t_enc.data, bit, 5 * 37).numpy()
    want = (table[codes] * t_enc.scale.numpy()[:, None]
            + t_enc.shift.numpy()[:, None]).reshape(x.shape)
    np.testing.assert_array_equal(
        tfused.fused_decode_outerdim(t_enc).numpy(), want)
    j_enc = jquant.tensor_encode_outerdim(jnp.asarray(x), bit)
    np.testing.assert_allclose(
        want, np.asarray(jfused.fused_decode_outerdim(j_enc, interpret=True)),
        rtol=0, atol=DECODE_ATOL)
