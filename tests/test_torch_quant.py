"""The port's QuantPipe codec and Banner clamp against the JAX package.

Encode is held BIT-IDENTICAL (words, scale, shift) to the JAX ops: both
compute the same IEEE f32 ops in the same order and round half to even.
Decode is held to atol=2e-6 on N(0,1) data: XLA's CPU decode does not
evaluate q / L * s + h in IEEE op order (it differs by 1-2 ulp, ~1.4e-6
at |x| ~ 4), while the port divides exactly; on the card the port's
kernel and plain decode are bit-identical (chip_smoke.py).
"""
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
