"""The port's native host codec (`pipeedge_tpu_torch/ops/native_quant.py`).

The wrapper builds `native/quantpack.cpp` as it stands with the host's
C++ compiler into the port's build directory, and its words, scale and
shift equal the port's plain codec (`ops/quant.py`) and the JAX
package's codecs (its `ops/native_quant.py` over the same source, and
its XLA ops) bit for bit; decodes agree with the plain decode to f32
rounding, and a v1 frame it encodes decodes in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.comm import wire as jwire
from pipeedge_tpu.ops import native_quant as jnative
from pipeedge_tpu.ops import quant as jquant
from pipeedge_tpu_torch.comm import wire as twire
from pipeedge_tpu_torch.ops import native_quant
from pipeedge_tpu_torch.ops import quant as tquant
from pipeedge_tpu_torch.sched import scheduler

BITS = [2, 3, 4, 6, 8, 16]
SHAPES = [(4, 33), (2, 7, 5), (8, 13, 48)]


def test_builds_from_the_source_into_the_port_build_dir():
    assert native_quant.available()
    path = native_quant.library_path()
    assert path.exists() and path.parent == scheduler.BUILD_DIR
    assert native_quant.SOURCE.name == "quantpack.cpp"
    assert native_quant.build() == path          # built once


def _x(bit, shape):
    return np.random.default_rng(bit).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bit", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_equals_plain_and_jax_codecs(bit, shape):
    x = _x(bit, shape)
    packed, scale, shift = native_quant.encode_outerdim(x, bit)
    plain = tquant.tensor_encode_outerdim(torch.from_numpy(x), bit)
    np.testing.assert_array_equal(packed, tquant.words_u32(plain))
    np.testing.assert_array_equal(scale, plain.scale.numpy())
    np.testing.assert_array_equal(shift, plain.shift.numpy())
    ref = jquant.tensor_encode_outerdim(jnp.asarray(x), bit)
    np.testing.assert_array_equal(packed, np.asarray(ref.data))
    np.testing.assert_array_equal(scale, np.asarray(ref.scale))
    if jnative._load() is not None:      # the JAX package's own build
        for got, want in zip((packed, scale, shift),
                             jnative.encode_outerdim(x, bit)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bit", BITS)
def test_decode_agrees_with_plain_decode(bit):
    shape = (4, 6, 9)
    x = _x(bit, shape)
    packed, scale, shift = native_quant.encode_outerdim(x, bit)
    got = native_quant.decode_outerdim(packed, scale, shift, shape, bit)
    enc = tquant.QuantizedTensor(
        data=torch.from_numpy(packed.view(np.int32)),
        scale=torch.from_numpy(scale), shift=torch.from_numpy(shift),
        shape=shape, bit=bit)
    want = tquant.tensor_decode_outerdim(enc).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6,
                               atol=2e-6 * float(scale.max()) + 1e-12)
    assert np.abs(got - x).max() <= float(scale.max()) / (2 ** bit - 1)


def test_refuses_out_of_range_bits():
    with pytest.raises(ValueError):
        native_quant.encode_outerdim(np.zeros((1, 4), np.float32), 32)


@pytest.mark.parametrize("bit", [0, 4, 8])
def test_v1_frame_from_native_codec_decodes_in_both_packages(bit):
    x = torch.from_numpy(_x(bit, (3, 5, 7)))
    frame = twire.wire_encode(x, bit)
    assert frame[0].ndim == 0 and int(frame[0]) == bit
    want = jwire.wire_encode(jnp.asarray(x.numpy()), bit)
    for g, w in zip(frame, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    j = np.asarray(jwire.wire_decode(frame, jnp.float32))
    t = twire.wire_decode(frame, torch.float32, device="cpu").numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
