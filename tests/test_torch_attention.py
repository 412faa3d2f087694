"""The port's attention (plain version, the CPU path of its kernel wrapper)
against the JAX package's Pallas kernel in interpret mode.

Tolerance rtol=2e-4, atol=2e-5, as tests/test_fused_attention.py uses for
the Pallas kernel against its own reference: the online softmax and the
dense softmax sum in different orders.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeedge_tpu.ops import attention as jattn
from pipeedge_tpu_torch.ops import attention as tattn

RTOL, ATOL = 2e-4, 2e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 64, 80])
@pytest.mark.parametrize("s", [17, 197])
def test_bhsd_matches_pallas_interpret(s, d, causal):
    q, k, v = _qkv((2, s, d), seed=s + d)
    want = jattn.fused_attention_bhsd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      interpret=True)
    got = tattn.fused_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bshd_wrapper_matches_pallas_interpret(causal):
    q, k, v = _qkv((2, 19, 3, 8), seed=7)
    want = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 interpret=True)
    got = tattn.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == (2, 19, 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bf16_keeps_dtype_and_cpu_path_counts_no_launch():
    from pipeedge_tpu_torch.ops import _build
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((2, 9, 16), seed=3))
    before = dict(_build.launch_counts)
    out = tattn.fused_attention_bhsd(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = tattn.attention_reference(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)
    assert _build.launch_counts == before


def test_mismatched_inputs_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 9, 16), seed=4))
    with pytest.raises(ValueError):
        tattn.fused_attention_bhsd(q, k[:, :5], v)
    with pytest.raises(ValueError):
        tattn.fused_attention_bhsd(q, k.double(), v)


# --- the kernel's f32 arithmetic, emulated on the CPU -----------------------
# The CUDA kernel runs f32 attention on the tensor cores as 3xTF32: each
# operand x splits into hi = tf32(x) and lo = tf32(x - hi), and each product
# is hi*hi + hi*lo + lo*hi, summed in f32. tf32 keeps 10 mantissa bits,
# rounded to nearest with ties away from zero (cvt.rna.tf32.f32). The
# emulation below follows that order of operations with plain torch ops, so
# the CPU can show the split meets the f32 tolerance where one TF32 product
# per term does not.

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), ties away from zero: add half
    an ulp of bit 13 to the sign-magnitude bits, then clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product_3x(a, b):
    """a @ b as the kernel's 3xTF32 (the tf32 x tf32 products are exact in
    f32; small terms first, as the kernel issues them)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _product_1x(a, b):
    return _tf32(a) @ _tf32(b)


def _emulated_attention(q, k, v, product):
    """softmax(q k^T / sqrt(D)) v with the kernel's order: unnormalised
    exponentials against the row max, P V, then one division by the sum."""
    s = product(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return product(p, v) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("shape", [(2, 197, 64), (2, 65, 80)])
def test_3xtf32_split_meets_the_f32_tolerance(shape):
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=shape[1]))
    ref = tattn.attention_reference(q, k, v)
    got = _emulated_attention(q, k, v, _product_3x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 197, 64), (2, 65, 80)])
def test_1xtf32_misses_the_f32_tolerance(shape):
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=shape[1]))
    ref = tattn.attention_reference(q, k, v).numpy()
    got = _emulated_attention(q, k, v, _product_1x).numpy()
    assert not np.allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # a tf32 value
    x = torch.tensor([1.0 + 2.0 ** -11,          # tie -> away (up)
                      -(1.0 + 2.0 ** -11),       # tie -> away (down)
                      1.0 + 2.0 ** -12,          # below half -> 1
                      one], dtype=torch.float32)
    assert _tf32(x).tolist() == [one, -one, 1.0, one]
    hi, lo = _split(torch.tensor([math.pi], dtype=torch.float32))
    assert _tf32(hi).item() == hi.item() and _tf32(lo).item() == lo.item()
    assert abs((hi + lo).item() - math.pi) < 2.0 ** -20


@pytest.mark.parametrize("dtype, d", [(torch.float32, 129),
                                      (torch.bfloat16, 256),
                                      (torch.float64, 64),
                                      (torch.float16, 64),
                                      (torch.float32, 0)])
def test_kernel_refuses_other_dtypes_and_head_dims(dtype, d):
    with pytest.raises(ValueError):
        tattn.check_kernel_args(dtype, d)


@pytest.mark.parametrize("dtype, d", [(torch.float32, 128),
                                      (torch.bfloat16, 80),
                                      (torch.float32, 1)])
def test_kernel_takes_f32_and_bf16_up_to_128(dtype, d):
    tattn.check_kernel_args(dtype, d)
