"""Kernel 3's gradient: the plain backward, the autograd Function around
the kernel, and the guard on the kernels that have no backward.

- `attention_backward_reference` (the contract the backward kernel of
  `csrc/attention_bwd.cu` is held to on the card) against
  `torch.autograd` of `attention_reference`, and against `jax.vjp` of the
  JAX package's `models/layers.py self_attention` (its einsum path, which
  it takes on the CPU) with its projections, for f32 and bf16, causal and
  not, head dims 8, 64 and 128 at a ragged S = 37. Tolerances are stated
  against the largest gradient (of the q/k/v triple, or of x and every
  projection leaf): f32 1e-5 (two f32 orders of summation),
  bf16 2e-2 (the JAX core rounds P to bf16 before P V, the port keeps it
  in f32; each rounds its outputs to bf16).
- `FusedAttentionFunction` on CPU tensors (its plain halves) gives the
  gradients autograd gives through the wrappers' CPU path, in both
  layouts.
- `_build.cuts_graph`, the predicate behind the guard of kernels 1, 2, 4
  and 5, and `refuse_grad`'s error, which each of those wrappers raises on
  its CUDA branch.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import layers as jlayers
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.ops import attention as tattn
from pipeedge_tpu_torch.ops import decode_attention, fused_quant, int8_matmul

S = 37
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close(got, want, dtype, what=""):
    """Each gradient within TOL[dtype] of the largest |want|."""
    for name, g, w in zip("qkv", got, want):
        g = np.asarray(g, dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape
        bound = TOL[dtype] * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bound, f"{what} d{name}: {err} > {bound}"


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_backward_reference_matches_autograd(d, causal, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays((2, 3, S, d), seed=d + causal))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tattn.attention_reference(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    o = tattn.attention_reference(q, k, v, causal)
    lse = tattn.attention_lse_reference(q, k, causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 3, S)
    got = tattn.attention_backward_reference(q, k, v, o, do, lse, causal)
    assert all(g.dtype == dtype for g in got)
    _close([g.float() for g in got], [w.float() for w in want], dtype)


def test_causal_grads_past_the_frontier_are_zero():
    """Key j's dK and dV take nothing from rows before j: the last key's
    gradients come from the last row alone."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, S, 8), seed=1))
    lse = tattn.attention_lse_reference(q, k, True)
    o = tattn.attention_reference(q, k, v, True)
    do[:, -1] = 0.0       # the only row that sees the last key
    _, dk, dv = tattn.attention_backward_reference(q, k, v, o, do, lse, True)
    assert torch.all(dk[:, -1] == 0) and torch.all(dv[:, -1] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_backward_matches_jax_self_attention_vjp(d, causal, dtype):
    """The JAX core with its q/k/v projections, differentiated by
    jax.vjp, against the port's projections and `FusedAttentionFunction`
    differentiated by autograd (the Function's backward is the plain
    backward on the CPU): dx and every projection's weight and bias."""
    heads, width = 2, 2 * d
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, S, width)).astype(np.float32)
    cot = rng.normal(size=(2, S, width)).astype(np.float32)
    proj = {n: {"w": (rng.normal(size=(width, width)) / np.sqrt(width)
                      ).astype(np.float32),
                "b": (0.1 * rng.normal(size=(width,))).astype(np.float32)}
            for n in ("q", "k", "v")}

    jdt = DTYPES[dtype]

    def jfn(x, p):
        return jlayers.self_attention(p, x, heads, causal=causal)

    jx = jnp.asarray(x, jdt)
    jp = jax.tree_util.tree_map(jnp.asarray, proj)
    _, vjp = jax.vjp(jfn, jx, jp)
    jdx, jdp = vjp(jnp.asarray(cot, jdt))

    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tp = {n: {k: torch.from_numpy(a).requires_grad_(True)
              for k, a in p.items()} for n, p in proj.items()}
    q, k, v = tlayers.qkv_heads(tp, tx, heads)
    out = tattn.FusedAttentionFunction.apply(q, k, v, causal, True)
    out.reshape(2, S, width).backward(torch.from_numpy(cot).to(dtype))
    got = [tx.grad] + [tp[n][k].grad for n in "qkv" for k in ("w", "b")]
    want = [np.asarray(jdx, dtype=np.float32)] + [
        np.asarray(jdp[n][k], dtype=np.float32)
        for n in "qkv" for k in ("w", "b")]
    # against the largest gradient of all: k's bias gets none (softmax
    # ignores a per-row constant), so its own scale is round-off
    bound = TOL[dtype] * max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bound


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_function_cpu_grads_equal_autograd(bshd, causal):
    shape = (2, S, 3, 8) if bshd else (6, S, 8)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(shape, seed=5))
    wrapper = tattn.fused_attention if bshd else tattn.fused_attention_bhsd
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_o = wrapper(*leaves, causal=causal)
    want = torch.autograd.grad(want_o, leaves, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got_o = tattn.FusedAttentionFunction.apply(*leaves, causal, bshd)
    got = torch.autograd.grad(got_o, leaves, do)
    torch.testing.assert_close(got_o, want_o)
    _close(got, want, torch.float32)
    o, lse = tattn.fused_attention_lse(q, k, v, causal, bshd)
    assert tuple(lse.shape) == ((2, 3, S) if bshd else (6, S))
    torch.testing.assert_close(o, want_o.detach())


def test_guard_predicate_and_error():
    t = torch.zeros(3, requires_grad=True)
    plain = torch.zeros(3)
    assert _build.cuts_graph(plain, t)
    assert not _build.cuts_graph(plain, None)
    with torch.no_grad():
        assert not _build.cuts_graph(t)
    with torch.inference_mode():
        assert not _build.cuts_graph(t)
    _build.refuse_grad("int8_matmul", plain)      # no gradient: no error
    with pytest.raises(RuntimeError, match="kernel fused_encode has no "
                       "backward"):
        _build.refuse_grad("fused_encode", t)


@pytest.mark.parametrize("fn,kernel", [
    (fused_quant.fused_encode_outerdim, "fused_encode"),
    (fused_quant.fused_decode_outerdim, "fused_decode"),
    (int8_matmul.matmul_q, "int8_matmul"),
    (int8_matmul.int8_dense, "int8_matmul"),
    (int8_matmul.wire_matmul, "int8_matmul"),
    (decode_attention.int8_decode_attention, "decode_attention"),
])
def test_kernels_without_backward_call_the_guard(fn, kernel):
    """Each wrapper of kernels 1, 2, 4 and 5 calls `refuse_grad` with its
    kernel's name (its CUDA branch, which this host cannot reach)."""
    assert f'refuse_grad("{kernel}"' in inspect.getsource(fn)


def test_backward_tally_is_its_own(monkeypatch):
    """`fused_attention_bwd` counts in `grad_launch_counts`, whose keys are
    fixed, as `launch_counts`' are: the inference tally keeps the five TPU
    kernels, and a reset zeroes both."""
    monkeypatch.setattr(_build, "launch_counts",
                        {name: 0 for name in _build.KERNELS})
    monkeypatch.setattr(_build, "grad_launch_counts",
                        {name: 0 for name in _build.GRAD_KERNELS})
    _build.count_launch("fused_attention_bwd")
    _build.count_launch("fused_attention_bwd")
    _build.count_launch("fused_attention")
    assert _build.grad_launch_counts == {"fused_attention_bwd": 2}
    assert _build.launch_counts == {name: int(name == "fused_attention")
                                    for name in _build.KERNELS}
    _build.reset_launch_counts()
    assert _build.launch_counts == {name: 0 for name in _build.KERNELS}
    assert _build.grad_launch_counts == {"fused_attention_bwd": 0}
