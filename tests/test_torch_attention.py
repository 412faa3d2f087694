"""The port's attention (plain version, the CPU path of its kernel wrapper)
against the JAX package's Pallas kernel in interpret mode.

Tolerance rtol=2e-4, atol=2e-5, as tests/test_fused_attention.py uses for
the Pallas kernel against its own reference: the online softmax and the
dense softmax sum in different orders.
"""
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
