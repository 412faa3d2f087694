"""The port's int8 compute path against the JAX package's, on the CPU.

The same numpy inputs (drawn from a seed) go through both packages:

- Quantizers: `quantize_weight` and `quantize_act_blocks` give identical
  int8 codes and scales (both divide in IEEE f32 and round half to even).
- Plain matmul: `matmul_reference` matches `matmul_xla` and the Pallas
  kernel in interpret mode at rtol 1e-5, atol 1e-4, the JAX test's own
  tolerance (tests/test_int8_matmul.py): the k-block products are exact
  on all three, only the f32 fold may round in another order.
- Dense wrappers, config and routing, the tunnel's gating, and the tiny
  ViT end to end (tolerances stated at each test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import layers as jlayers
from pipeedge_tpu.ops import int8_matmul as jmm
from pipeedge_tpu.ops import quant as jquant
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.ops import int8_matmul as tmm
from pipeedge_tpu_torch.ops import quant as tquant

MODEL = "pipeedge/test-tiny-vit"
CFG = treg.get_model_config(MODEL)


@pytest.fixture(autouse=True)
def _clean_quantize_state(monkeypatch):
    """Both packages keep the config in process globals; leave none."""
    monkeypatch.delenv("PIPEEDGE_QUANTIZE_COMPUTE", raising=False)
    monkeypatch.delenv("PIPEEDGE_QUANTIZE_SKIP", raising=False)
    monkeypatch.delenv(jmm.ENV_INT8_MATMUL, raising=False)
    prev = (jlayers._QUANTIZE_COMPUTE, tlayers._QUANTIZE_COMPUTE)
    yield
    jlayers.set_quantize_compute(prev[0])
    tlayers.set_quantize_compute(prev[1])


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(m, k, n, seed, zero_blocks=False, outlier=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (0.05 * rng.normal(size=(k, n))).astype(np.float32)
    if zero_blocks:
        x[: m // 2, : min(k, 128)] = 0.0        # whole k-blocks of zeros
        w[:, : n // 3] = 0.0                    # all-zero channels
    if outlier:
        x[1, 3] = 1e4                           # saturates its k-block
    return x, w


CASES = {                       # (m, k, n, zero_blocks, outlier)
    "square": (16, 256, 64, False, False),
    "ragged": (37, 256, 40, False, False),
    "k100": (5, 100, 24, False, False),        # block_k = K = 100
    "zeros": (12, 256, 48, True, False),
    "outlier": (9, 384, 32, False, True),
}


# -- quantizers ----------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_quantizers_match_jax(case):
    m, k, n, zeros, outlier = CASES[case]
    x, w = _inputs(m, k, n, seed=1, zero_blocks=zeros, outlier=outlier)
    bk = tmm.pick_block(k)
    assert bk == jmm.pick_block(k, 128)
    jq, js = jmm.quantize_act_blocks(jnp.asarray(x), bk)
    tq, ts = tmm.quantize_act_blocks(_t(x), bk)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jwq, jws = jmm.quantize_weight(jnp.asarray(w))
    twq, tws = tmm.quantize_weight(_t(w))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    if zeros:
        assert (ts.numpy()[: m // 2, 0] == 1.0).all()
        assert (tws.numpy()[: n // 3] == 1.0).all()
    if outlier:
        assert tq.numpy().max() <= 127 and tq.numpy().min() >= -127


def test_pick_block_matches_jax():
    from pipeedge_tpu.ops._blocks import pick_block
    for width in (8, 32, 64, 100, 197, 256, 768, 1000, 3072, 4):
        for pref in (8, 64, 128):
            assert tmm.pick_block(width, pref) == pick_block(width, pref)


# -- the choice between the two CUDA kernels -------------------------------
# ViT-Base's denses (K 768 and 3072) and the tunnel take the wgmma kernel;
# a k-block that is not whole 32-byte wgmma steps, or an operand that is
# not 16-byte aligned (TMA's rule), takes the mma.sync kernel.
@pytest.mark.parametrize("k, want", [
    (768, "wgmma"),          # q/k/v/attn.out, mlp.up, the tunnel
    (3072, "wgmma"),         # mlp.down
    (192, "wgmma"),          # block 96: three k32 steps per block
    (64, "wgmma"),
    (100, "mma_sync"),       # no multiple of 8 divides it: one block of 100
    (80, "mma_sync"),        # block 80
    (320, "mma_sync"),       # block 80
])
def test_kernel_choice_by_shape(k, want):
    bk = tmm.pick_block(k)
    assert tmm.kernel_choice(k, bk, aligned=True) == want


@pytest.mark.parametrize("k", [768, 3072, 192])
def test_kernel_choice_needs_aligned_operands(k):
    assert tmm.kernel_choice(k, tmm.pick_block(k), aligned=False) \
        == "mma_sync"


def test_kernel_choice_takes_explicit_blocks():
    assert tmm.kernel_choice(768, 256, aligned=True) == "wgmma"
    assert tmm.kernel_choice(768, 96, aligned=True) == "wgmma"
    assert tmm.kernel_choice(768, 48, aligned=True) == "mma_sync"
    assert tmm.kernel_choice(768, 0, aligned=True) == "mma_sync"
    assert tmm.kernel_choice(700, 64, aligned=True) == "mma_sync"  # K % bk


def test_wire_flip_is_the_recentred_code():
    """The wgmma kernel XORs each wire byte with 0x80 in shared memory (the
    mma.sync kernel in registers): as int8, q ^ 0x80 == q - 128 for every
    8-bit code, which is what `wire_codes` computes."""
    q = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    flipped = (q ^ 0x80).view(torch.int8)
    assert torch.equal(flipped.to(torch.int32), q.to(torch.int32) - 128)


# -- the plain matmul ----------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_matmul_reference_matches_xla_and_pallas(case):
    m, k, n, zeros, outlier = CASES[case]
    x, w = _inputs(m, k, n, seed=2, zero_blocks=zeros, outlier=outlier)
    bk = tmm.pick_block(k)
    jq, js = jmm.quantize_act_blocks(jnp.asarray(x), bk)
    jwq, jws = jmm.quantize_weight(jnp.asarray(w))
    got = tmm.matmul_reference(_t(jq), _t(js), _t(jwq), _t(jws), bk).numpy()
    xla = np.asarray(jmm.matmul_xla(jq, js, jwq, jws, bk))
    pallas = np.asarray(jmm.matmul_pallas(jq, js, jwq, jws, bk,
                                          interpret=True))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
    # the dispatch seam takes the plain version for CPU tensors
    assert torch.equal(tmm.matmul_q(_t(jq), _t(js), _t(jwq), _t(jws), bk),
                       torch.from_numpy(got))
    if zeros:
        assert (got[:, : n // 3] == 0.0).all()


def test_matmul_reference_is_exact_per_block_in_f64():
    """K = 1100 is not a multiple of 8, so the block is all of K and its
    int8 sums exceed what f32 holds exactly: the reference switches to
    f64 and still equals the exact integer product, scaled once."""
    rng = np.random.default_rng(3)
    m, k, n = 4, 1100, 8
    xq = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    xs = np.ones((m, 1), np.float32)
    ws = np.ones((n,), np.float32)
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(exact).max() < 2 ** 31
    got = tmm.matmul_reference(_t(xq), _t(xs), _t(wq), _t(ws), k)
    np.testing.assert_array_equal(got.numpy(),
                                  exact.astype(np.float32))


def test_matmul_rejects_bad_shapes():
    xq = torch.zeros((4, 96), dtype=torch.int8)
    wq = torch.zeros((96, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="divisible"):
        tmm.matmul_q(xq, torch.ones(4, 2), wq, torch.ones(8), 64)
    with pytest.raises(ValueError, match="x_scale"):
        tmm.matmul_q(xq, torch.ones(4, 2), wq, torch.ones(8), 32)
    with pytest.raises(ValueError, match="disagree"):
        tmm.matmul_q(xq, torch.ones(4, 3), wq[:64], torch.ones(8), 32)


# -- dense wrappers ------------------------------------------------------

# f32: identical codes and scales on both sides, so the outputs differ only
# by the fold's summation order (rtol 1e-5). bf16: both round the same f32
# value to bf16, which may then land one bf16 ulp (2^-8) apart.
DENSE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("alpha", [None, 0.75])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(dtype, alpha):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 96)).astype(np.float32)
    w = (0.1 * rng.normal(size=(96, 32))).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(jx.astype(jnp.float32)).to(getattr(torch, dtype))
    want = jmm.int8_dense(jx, jnp.asarray(w), jnp.asarray(b),
                          clamp_alpha=alpha)
    got = tmm.int8_dense(tx, _t(w), _t(b), clamp_alpha=alpha)
    assert got.shape == (2, 5, 32) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **DENSE_TOL[dtype])
    if alpha is not None:
        unclipped = tmm.int8_dense(tx, _t(w), _t(b))
        assert not torch.equal(unclipped, got)


def test_fold_weight_caches_and_tracks_updates():
    rng = np.random.default_rng(5)
    w = _t((0.1 * rng.normal(size=(64, 16))).astype(np.float32))
    first = tmm.fold_weight(w)
    assert tmm.fold_weight(w) is first
    assert first.w_q.t().is_contiguous()            # the kernel's layout
    w_q, w_s = tmm.quantize_weight(w)
    assert torch.equal(first.w_q, w_q) and torch.equal(first.w_scale, w_s)
    w.mul_(2.0)                                     # in-place update
    second = tmm.fold_weight(w)
    assert second is not first
    assert torch.equal(second.w_scale, tmm.quantize_weight(w)[1])


def _wire_payloads(seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    w = (0.1 * rng.normal(size=(128, 24))).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jenc = jquant.tensor_encode_outerdim(jnp.asarray(x), 8)
    tenc = tquant.tensor_encode_outerdim(_t(x), 8)
    return jenc, tenc, w, b


def test_wire_dense_matches_jax():
    jenc, tenc, w, b = _wire_payloads()
    # the port's encode is the JAX encode word for word
    np.testing.assert_array_equal(tquant.words_u32(tenc),
                                  np.asarray(jenc.data))
    want = np.asarray(jmm.wire_dense({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, jenc))
    got = tmm.wire_dense({"w": _t(w), "b": _t(b)}, tenc)
    assert got.shape == (3, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wire_matmul_is_the_plain_unpack():
    _, tenc, w, _ = _wire_payloads(seed=7)
    codes = tmm.wire_codes(tenc)
    q = tquant._unpack_bits(tenc.data, 8, 5 * 128).reshape(15, 128)
    assert torch.equal(codes, (q - 128).to(torch.int8))
    folded = tmm.fold_weight(_t(w))
    xs = torch.rand(15, 1) + 0.5
    assert torch.equal(
        tmm.wire_matmul(tenc, xs, folded.w_q, folded.w_scale, 128),
        tmm.matmul_reference(codes, xs, folded.w_q, folded.w_scale, 128))


def test_wire_dense_rejects_non_8bit():
    enc = tquant.tensor_encode_outerdim(torch.ones(2, 2, 128), 4)
    with pytest.raises(ValueError, match="8-bit"):
        tmm.wire_dense({"w": torch.ones(128, 8), "b": torch.zeros(8)}, enc)


# -- QuantizeCompute config and routing -----------------------------------

def test_quantize_compute_setter_env_and_skip(monkeypatch):
    assert not tlayers.quantize_compute().enabled       # default off
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_COMPUTE", "1")
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_SKIP", "attn.out,mlp.down")
    for lay in (tlayers, jlayers):
        lay.set_quantize_compute(None)                  # defer to env
    qc, jqc = tlayers.quantize_compute(), jlayers.quantize_compute()
    assert qc.enabled and qc.skip_tags == {"attn.out", "mlp.down"}
    assert (qc.enabled, qc.block_k, qc.skip_tags, qc.tunnel) == \
        (jqc.enabled, jqc.block_k, jqc.skip_tags, jqc.tunnel)
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_COMPUTE", "off")
    assert not tlayers.quantize_compute().enabled
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_COMPUTE", "1")
    # the programmatic setter beats the env
    tlayers.set_quantize_compute(False)
    assert not tlayers.quantize_compute().enabled
    tlayers.set_quantize_compute(True)
    assert tlayers.quantize_compute() == tlayers.QuantizeCompute(enabled=True)
    cfg = tlayers.QuantizeCompute(enabled=True, block_k=64,
                                  clamp_alphas={"mlp.up": 2.5})
    tlayers.set_quantize_compute(cfg)
    assert tlayers.quantize_compute() is cfg


def test_tagged_dense_routes_and_untagged_stays_exact():
    rng = np.random.default_rng(8)
    w = (0.1 * rng.normal(size=(128, 32))).astype(np.float32)
    p = {"w": _t(w), "b": torch.zeros(32)}
    x = _t(rng.normal(size=(3, 128)).astype(np.float32))
    exact = tlayers.dense(p, x)
    tlayers.set_quantize_compute(tlayers.QuantizeCompute(enabled=True))
    tagged = tlayers.dense(p, x, tag="mlp.up")
    untagged = tlayers.dense(p, x)
    tlayers.set_quantize_compute(tlayers.QuantizeCompute(
        enabled=True, skip_tags=frozenset({"mlp.up"})))
    skipped = tlayers.dense(p, x, tag="mlp.up")
    assert torch.equal(untagged, exact)
    assert torch.equal(skipped, exact)
    assert not torch.equal(tagged, exact)
    assert torch.equal(tagged, tmm.int8_dense(x, p["w"], p["b"]))
    assert float((tagged - exact).abs().max() / exact.abs().max()) < 0.05
    # the same routing in the JAX package gives the same numbers
    jlayers.set_quantize_compute(jlayers.QuantizeCompute(enabled=True))
    want = np.asarray(jlayers.dense({"w": jnp.asarray(w),
                                     "b": jnp.zeros(32)},
                                    jnp.asarray(x.numpy()), tag="mlp.up"))
    np.testing.assert_allclose(tagged.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clamp_alpha_reaches_the_dense():
    rng = np.random.default_rng(9)
    p = {"w": _t((0.1 * rng.normal(size=(64, 8))).astype(np.float32)),
         "b": torch.zeros(8)}
    x = _t(rng.normal(size=(4, 64)).astype(np.float32))
    tlayers.set_quantize_compute(tlayers.QuantizeCompute(
        enabled=True, clamp_alphas={"attn.q": 0.5}))
    assert torch.equal(tlayers.dense(p, x, tag="attn.q"),
                       tmm.int8_dense(x, p["w"], p["b"], clamp_alpha=0.5))
    assert torch.equal(tlayers.dense(p, x, tag="attn.k"),
                       tmm.int8_dense(x, p["w"], p["b"]))


def test_observer_sees_tagged_activations():
    seen = []
    p = {"w": torch.full((16, 16), 0.01), "b": torch.zeros(16)}
    x = torch.ones(1, 3, 16)
    prev = tlayers._QC_OBSERVER
    tlayers._QC_OBSERVER = lambda tag, a: seen.append((tag, a.shape))
    try:
        tlayers.dense(p, x, tag="attn.q")
        tlayers.dense(p, x)                              # untagged: silent
        tlayers.self_attention({"q": p, "k": p, "v": p}, x, 2,
                               tag_prefix="attn")
        tlayers.self_attention({"q": p, "k": p, "v": p}, x, 2)
    finally:
        tlayers._QC_OBSERVER = prev
    assert [t for t, _ in seen] == ["attn.q", "attn.q", "attn.k", "attn.v"]


# -- the tunnel's gating ---------------------------------------------------

GATING = [([(1, 1), (2, 8)], [8]),     # cut after sub 0: sub 1 leads
          ([(1, 3), (4, 8)], [8]),     # cut after sub 2: sub 3 leads
          ([(1, 2), (3, 8)], [8]),     # sub 2 leads with a LayerNorm
          ([(1, 3), (4, 8)], [4]),     # a 4-bit edge: wire_dense refuses
          ([(1, 1), (2, 3), (4, 8)], [8, 8]),
          ([(1, 1), (2, 8)], [0])]


@pytest.mark.parametrize("tunnel", [True, False])
@pytest.mark.parametrize("case", range(len(GATING)))
def test_tunnel_gating_matches_jax(case, tunnel):
    from pipeedge_tpu.parallel import pipeline as jpipe
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    partition, bits = GATING[case]
    jlayers.set_quantize_compute(jlayers.QuantizeCompute(
        enabled=True, tunnel=tunnel))
    tlayers.set_quantize_compute(tlayers.QuantizeCompute(
        enabled=True, tunnel=tunnel))
    want = [s.tunnel for s in jpipe.build_pipeline(
        MODEL, partition, quant_bits=bits).stages]
    got = [s.tunnel for s in tpipe.build_pipeline(
        MODEL, partition, device="cpu", quant_bits=bits).stages]
    assert got == want
    assert any(got) == (tunnel and case in (0, 1, 4))


def test_tunnel_decode_keeps_only_the_leading_8bit_tensor():
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    x = torch.randn(2, 3, 8)
    e8, e4 = (tquant.tensor_encode_outerdim(x, b) for b in (8, 4))
    out = tpipe._tunnel_decode_payload((e8, e8))
    assert out[0] is e8 and torch.is_tensor(out[1])
    assert tpipe._tunnel_decode_payload(e8) is e8
    assert torch.is_tensor(tpipe._tunnel_decode_payload(e4))
    assert all(torch.is_tensor(t)
               for t in tpipe._tunnel_decode_payload((e4, e8)))


# -- the tiny ViT end to end ------------------------------------------------

@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(CFG, seed=12))
    return str(path)


def _images(batch, seed):
    return np.random.default_rng(seed).normal(
        size=(batch, CFG.num_channels, CFG.image_size,
              CFG.image_size)).astype(np.float32)


def _jax_logits(weights_file, x, qc):
    from pipeedge_tpu.models import registry as jreg
    fn, params, _ = jreg.module_shard_factory(MODEL, weights_file, 1, 8)
    jlayers.set_quantize_compute(qc)
    try:   # a fresh jit: the config is read when the function is traced
        return np.asarray(jax.jit(fn.__wrapped__)(params, jnp.asarray(x)))
    finally:
        jlayers.set_quantize_compute(None)


def _torch_logits(weights_file, x, qc):
    fn, params, _ = treg.module_shard_factory(MODEL, weights_file, 1, 8,
                                              device="cpu")
    tlayers.set_quantize_compute(qc)
    try:
        return fn(params, torch.from_numpy(x)).numpy()
    finally:
        tlayers.set_quantize_compute(None)


def test_tiny_vit_int8_logits_match_jax(weights_file):
    """Port int8 logits against JAX int8 logits. The activations entering
    each int8 dense differ between the packages by f32 ulps (tests/
    test_torch_models.py), and a value on a rounding boundary then takes
    the next int8 code: one step of its block's scale in one product. The
    bound is a tenth of the int8 path's own error against exact, plus f32
    noise; top-1 agrees with exact on >= 99% of the images, the gate of
    tests/test_int8_matmul.py."""
    x = _images(16, seed=0)
    exact = _jax_logits(weights_file, x, jlayers.QuantizeCompute())
    want = _jax_logits(weights_file, x,
                       jlayers.QuantizeCompute(enabled=True))
    got = _torch_logits(weights_file, x,
                        tlayers.QuantizeCompute(enabled=True))
    int8_err = np.abs(want - exact).max()
    assert int8_err > 0
    assert np.abs(got - want).max() <= 0.1 * int8_err + 1e-5
    agree = np.mean(np.argmax(got, -1) == np.argmax(exact, -1))
    assert agree >= 0.99, agree


def test_tiny_vit_tunnel_logits_match_jax(weights_file):
    """A two-stage pipeline cut after sub 0 (so sub 1's dense eats the
    8-bit wire payload) in both packages. The stage-0 payloads may differ
    in a code where the two stage outputs straddle a codec step (tests/
    test_torch_pipeline.py); the bound is a tenth of the tunnel's error
    against the exact logits, plus f32 noise."""
    from pipeedge_tpu.parallel import pipeline as jpipe
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    x = _images(4, seed=1)
    partition = [(1, 1), (2, 8)]
    exact = _jax_logits(weights_file, x, jlayers.QuantizeCompute())
    jlayers.set_quantize_compute(jlayers.QuantizeCompute(
        enabled=True, tunnel=True))
    jp = jpipe.build_pipeline(MODEL, partition, model_file=weights_file,
                              quant_bits=[8])
    want = np.asarray(jp.stages[1](jp.stages[0](jnp.asarray(x))))
    tlayers.set_quantize_compute(tlayers.QuantizeCompute(
        enabled=True, tunnel=True))
    tp = tpipe.build_pipeline(MODEL, partition, model_file=weights_file,
                              device="cpu", quant_bits=[8])
    assert [s.tunnel for s in tp.stages] == [False, True]
    payload = tp.stages[0](torch.from_numpy(x))
    assert isinstance(payload[0], tquant.QuantizedTensor)
    got = tp.stages[1](payload).numpy()
    tunnel_err = np.abs(want - exact).max()
    assert tunnel_err > 0
    assert np.abs(got - want).max() <= 0.1 * tunnel_err + 1e-5
    assert np.mean(np.argmax(got, -1) == np.argmax(exact, -1)) >= 0.99


def test_tiny_vit_int8_through_env_and_pipeline(weights_file, monkeypatch):
    """PIPEEDGE_QUANTIZE_COMPUTE=1 alone turns the path on in the port's
    pipeline (the runtime has no flag for it), and the pipeline's logits
    equal the int8 single-shard forward."""
    x = torch.from_numpy(_images(2, seed=2))
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_COMPUTE", "1")
    tlayers.set_quantize_compute(None)
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    single = tpipe.build_pipeline(MODEL, [(1, 8)], model_file=weights_file,
                                  device="cpu")
    split = tpipe.build_pipeline(MODEL, [(1, 5), (6, 8)],
                                 model_file=weights_file, device="cpu")
    (a,), _ = single.run([x])
    (b,), _ = split.run([x])
    assert torch.equal(a, b)
    monkeypatch.delenv("PIPEEDGE_QUANTIZE_COMPUTE")
    (c,), _ = single.run([x])
    assert not torch.equal(a, c)


def test_runtime_int8_env_on_cpu(monkeypatch, capsys, tmp_path):
    """`PIPEEDGE_QUANTIZE_COMPUTE=1 python -m pipeedge_tpu_torch.runtime`
    runs the int8 path (no flag), and its launch line names the int8
    kernel: none launched on the CPU, where the plain version runs."""
    from pipeedge_tpu_torch import runtime
    monkeypatch.chdir(tmp_path)   # the monitoring CSVs land in the cwd
    monkeypatch.setenv("PIPEEDGE_QUANTIZE_COMPUTE", "1")
    tlayers.set_quantize_compute(None)
    runtime.main(["0", "2", "-m", MODEL, "-pt", "1,5,6,8", "-q", "8,0",
                  "-b", "4", "-u", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("latency_sec=") for ln in lines)
    assert '"int8_matmul": 0' in [ln for ln in lines
                                  if ln.startswith("kernel_launches=")][0]
