"""The port's Llama family against the JAX package's, on the same weights.

`pipeedge/test-tiny-llama` (4 heads over 2 KV heads, GQA) and
`pipeedge/test-tiny-mistral` (the same with a 4-token sliding window),
weights from the JAX package's seeded `init_params` stream carried across
by `params_from_jax`:

- `rms_norm` and `rope_rotate` (positions up to 8192, Llama-3's
  `rope_theta` too), `_repeat_kv`'s head order at kv_heads < heads and
  `_window_keep`;
- every sublayer, the whole forward and 2-stage cuts (block-aligned and
  mid-block) within rtol=1e-4, atol=1e-5 (f32: XLA and torch sum the
  matmuls and the softmax in other orders, a few ulp per op);
- greedy tokens on fp and int8 caches over 1 and 2 stages, beam search,
  span steps (`extend`) and a generation crossing the tiny Mistral's
  window, equal to the JAX `DecodePipeline`'s; decode-step logits against
  the port's own full forward;
- `init_params` equal to the JAX stream (the 7B/8B entries at narrowed
  widths), `load_params` from HF `LlamaForCausalLM` keys (tied head too)
  equal to `params_from_jax` of the JAX package's load;
- the kernel-3 route predicate (`fused_route`) and the int8
  decode-attention gate never asked by a Llama step, MHA included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import layers as jlayers
from pipeedge_tpu.models import llama as jllama
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch.kv import KvPagePool
from pipeedge_tpu_torch.models import ShardConfig, edge_arity
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import llama as tllama
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.parallel import decode as tdec

LLAMA, MISTRAL = "pipeedge/test-tiny-llama", "pipeedge/test-tiny-mistral"
MODELS = [LLAMA, MISTRAL]
TOTAL = 8
RTOL, ATOL = 1e-4, 1e-5
PARTITIONS = {1: [(1, 8)], 2: [(1, 4), (5, 8)]}
MAX_LEN, FLOOR, PROMPT = 32, 8, 6
# cache mode -> (cache_bits, int8 decode-attend opt-in): the opt-in is
# set so that a step which asked the gate could route to kernel 5
MODES = {"fp": (0, 0), "int8": (8, 1)}


def _sc(l, r):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)


def _jsc(l, r):
    return JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)


@pytest.fixture(scope="module")
def jparams():
    """model -> (l, r) -> the JAX package's seeded shard params."""
    cache = {}

    def get(model, l, r, seed=3):
        key = (model, l, r, seed)
        if key not in cache:
            cache[key] = jllama.init_params(jreg.get_model_config(model),
                                            _jsc(l, r), seed=seed)
        return cache[key]
    return get


def _tparams(jp):
    return params_from_jax(jax.device_get(jp))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 100, size=shape)


def _np(payload):
    if isinstance(payload, tuple):
        return tuple(np.asarray(t) for t in payload)
    return (np.asarray(payload),)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# --- layers ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """f32 statistics and scale, then the cast: equal up to f32 rounding
    (bf16: one bf16 ulp, 2^-8 relative, where the two round apart)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=32).astype(np.float32)
    want = jlayers.rms_norm({"scale": jnp.asarray(scale)},
                            jnp.asarray(x).astype(dtype), 1e-5)
    got = tlayers.rms_norm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x).to(getattr(torch, dtype)),
                           1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("start", [0, 4096 - 64, 8192 - 64])
def test_rope_rotate_matches_jax(theta, start):
    """The angles pos * inv_freq are the same f32 products in both
    packages; at Llama-3's positions (~8192 rad) the sin/cos of XLA and
    of torch differ by an ulp or two, so the rotation is held at
    rtol = atol = 1e-5 (measured 4.8e-7 on values of |x| < 5)."""
    x = np.random.default_rng(2).normal(size=(2, 64, 4, 128)).astype(
        np.float32)
    pos = np.arange(start, start + 64)
    want = jlayers.rope_rotate(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_repeat_kv_head_order():
    """Each KV head repeated in place (`jnp.repeat`), not the heads tiled:
    query head h reads KV head h // n_rep."""
    x = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    got = tllama._repeat_kv(x, 2)
    assert got.shape == (2, 3, 4, 4)
    for h in range(4):
        assert torch.equal(got[:, :, h], x[:, :, h // 2])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jllama._repeat_kv(jnp.asarray(x.numpy()), 2)))
    assert tllama._repeat_kv(x, 1) is x


def test_window_keep_matches_jax():
    cfg = treg.get_model_config(MISTRAL)
    keep = torch.ones(5, 12, dtype=torch.bool).tril(7)
    q_pos = 7 + torch.arange(5)[:, None]
    got = tllama._window_keep(keep, q_pos, cfg)
    want = jllama._window_keep(jnp.asarray(keep.numpy()),
                               jnp.asarray(q_pos.numpy()),
                               jreg.get_model_config(MISTRAL))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum(1).tolist() == [4] * 5
    llama = treg.get_model_config(LLAMA)
    assert tllama._window_keep(keep, q_pos, llama) is keep


# --- shards ---------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("sub", range(4))
def test_each_sublayer_matches_jax(jparams, model, sub):
    """Each sublayer on the same payload (S = 9: past the tiny Mistral's
    window, so its sublayer 0 takes the masked route)."""
    jcfg, tcfg = jreg.get_model_config(model), treg.get_model_config(model)
    jp = jparams(model, 1, TOTAL)["blocks"]
    bp = jax.tree_util.tree_map(lambda a: a[0], jp)
    rng = np.random.default_rng(10 + sub)
    # sublayer 3's first tensor is the SwiGLU output (intermediate width)
    width = tcfg.intermediate_size if sub == 3 else 32
    x = rng.normal(size=(2, 9, width)).astype(np.float32)
    data = (x, rng.normal(size=(2, 9, 32)).astype(np.float32)) \
        if sub in (1, 3) else x
    jdata = tuple(jnp.asarray(t) for t in data) if sub in (1, 3) \
        else jnp.asarray(data)
    tdata = tuple(torch.from_numpy(t) for t in data) if sub in (1, 3) \
        else torch.from_numpy(data)
    want = jllama.sublayer(bp, sub, jdata, jcfg)
    got = tllama.sublayer(_tparams(bp), sub, tdata, tcfg)
    _close(got, want)


def test_sublayer_refuses_attention_override(jparams):
    bp = _tparams(jax.tree_util.tree_map(
        lambda a: a[0], jparams(LLAMA, 1, TOTAL)["blocks"]))
    with pytest.raises(NotImplementedError, match="position-dependent"):
        tllama.sublayer(bp, 0, torch.zeros(1, 3, 32),
                        treg.get_model_config(LLAMA),
                        attention_fn=lambda *a, **k: None)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("partition", [
    [(1, 8)], [(1, 4), (5, 8)],
    [(1, 3), (4, 8)],      # a (ctx, residual) edge
    [(1, 6), (7, 8)]])     # an (mlp_h, residual) edge
def test_forward_matches_jax(jparams, model, partition):
    """The forward over 1 and 2 stages (each stage's params drawn as the
    JAX package draws them for that range) against the JAX stages."""
    jcfg, tcfg = jreg.get_model_config(model), treg.get_model_config(model)
    ids = _ids(5, (2, 9))
    jdata, tdata = jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    for l, r in partition:
        jp = jparams(model, l, r)
        jdata = make_shard_fn(jllama.FAMILY, jcfg, _jsc(l, r))(jp, jdata)
        tdata = shard_apply(tllama.FAMILY, tcfg, _sc(l, r), _tparams(jp),
                            tdata)
        if r < TOTAL:
            assert len(_np(tdata)) == edge_arity(r)
        _close(tdata, jdata)
    assert tuple(tdata.shape) == (2, 9, 100)


def test_kernel3_route_predicate(jparams, monkeypatch):
    """The full forward attends through kernel 3 (its plain version on the
    CPU) exactly when `fused_route` says so: always for Llama, for Mistral
    only while S <= window; the masked route gives the same function."""
    calls = []
    real = tllama.fused_attention

    def counted(*args, **kw):
        calls.append(kw.get("causal"))
        return real(*args, **kw)

    monkeypatch.setattr(tllama, "fused_attention", counted)
    llama, mistral = (treg.get_model_config(m) for m in MODELS)
    assert all(tllama.fused_route(llama, s) for s in (1, 9, 4096, 8192))
    assert [tllama.fused_route(mistral, s) for s in (1, 4, 5, 9)] == \
        [True, True, False, False]
    for model, s, want in ((LLAMA, 9, 2), (MISTRAL, 4, 2), (MISTRAL, 9, 0)):
        calls.clear()
        tp = _tparams(jparams(model, 1, TOTAL))
        cfg = treg.get_model_config(model)
        out = shard_apply(tllama.FAMILY, cfg, _sc(1, TOTAL), tp,
                          torch.from_numpy(_ids(6, (2, s))))
        assert calls == [True] * want, (model, s, calls)
        if want:       # the masked route computes the same function
            monkeypatch.setattr(tllama, "fused_route", lambda c, n: False)
            masked = shard_apply(tllama.FAMILY, cfg, _sc(1, TOTAL), tp,
                                 torch.from_numpy(_ids(6, (2, s))))
            monkeypatch.undo()
            monkeypatch.setattr(tllama, "fused_attention", counted)
            _close(masked, out)


# --- weights --------------------------------------------------------------

def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("model,l,r", [
    (LLAMA, 1, 8), (LLAMA, 2, 7), (MISTRAL, 5, 8),
    ("meta-llama/Meta-Llama-3-8B", 1, 8),
    ("meta-llama/Llama-2-7b-hf", 121, 128),
    ("mistralai/Mistral-7B-v0.1", 3, 6)])
def test_init_params_draws_the_jax_stream(model, l, r):
    jcfg, tcfg = jreg.get_model_config(model), treg.get_model_config(model)
    total = treg.get_model_layers(model)
    if total != TOTAL:        # the 7B/8B widths are too slow here
        narrow = dict(hidden_size=16, intermediate_size=24,
                      num_attention_heads=4, vocab_size=50)
        jcfg = dataclasses.replace(jcfg, **narrow)
        tcfg = dataclasses.replace(tcfg, **narrow)
    jsc = JShardConfig(l, r, is_first=l == 1, is_last=r == total)
    sc = ShardConfig(l, r, is_first=l == 1, is_last=r == total)
    want = params_from_jax(jax.device_get(jllama.init_params(jcfg, jsc,
                                                             seed=4)))
    got = tllama.init_params(tcfg, sc, seed=4)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("sub", range(4))
def test_sublayer_params_match_jax(sub):
    """A one-sublayer shard holds exactly `SUBLAYER_PARAMS[sub]`, as the
    JAX package's table says."""
    layer = 4 + sub + 1                       # block 1's sublayer `sub`
    got = tllama.init_params(treg.get_model_config(LLAMA),
                             ShardConfig(layer, layer), seed=0)
    assert set(got["head"]) == set(tllama.SUBLAYER_PARAMS[sub]) \
        == set(jllama.SUBLAYER_PARAMS[sub])


def _hf_state_dict(cfg, seed, tied):
    """HF `LlamaForCausalLM` keys, nn.Linear kernels [out, in]."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.kv_heads * cfg.head_dim

    def r(*shape):
        return rng.normal(0, 0.05, size=shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": r(cfg.vocab_size, d),
          "model.norm.weight": 1 + r(d)}
    for i in range(cfg.num_hidden_layers):
        root = f"model.layers.{i}."
        for name, shape in (("input_layernorm", (d,)),
                            ("post_attention_layernorm", (d,))):
            sd[root + name + ".weight"] = 1 + r(*shape)
        for name, shape in (("self_attn.q_proj", (d, d)),
                            ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)),
                            ("self_attn.o_proj", (d, d)),
                            ("mlp.gate_proj", (it, d)),
                            ("mlp.up_proj", (it, d)),
                            ("mlp.down_proj", (d, it))):
            sd[root + name + ".weight"] = r(*shape)
    if not tied:
        sd["lm_head.weight"] = r(cfg.vocab_size, d)
    return sd


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("l,r", [(1, 8), (1, 4), (3, 8), (2, 6)])
def test_load_params_from_hf_state_dict(tied, l, r):
    cfg = treg.get_model_config(LLAMA)
    sd = _hf_state_dict(cfg, 7, tied)
    want = params_from_jax(jax.device_get(jllama.load_params(
        jreg.get_model_config(LLAMA), _jsc(l, r), sd)))
    got = tllama.load_params(cfg, _sc(l, r), sd)
    _assert_same_tree(got, want)
    if l == 1:
        np.testing.assert_array_equal(got["embeddings"]["wte"].numpy(),
                                      sd["model.embed_tokens.weight"])
    if r == TOTAL:
        head = sd["model.embed_tokens.weight" if tied else "lm_head.weight"]
        np.testing.assert_array_equal(got["final"]["head"]["w"].numpy(),
                                      head.T)


def test_registry_entries_match_jax():
    names = treg.get_model_names()
    assert names == jreg.get_model_names()
    for name in names:
        jcfg, tcfg = jreg.get_model_config(name), treg.get_model_config(name)
        for field in dataclasses.fields(tcfg):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
        assert treg.get_model_layers(name) == jreg.get_model_layers(name)
        assert treg.get_model_entry(name).weights_file == \
            jreg.get_model_entry(name).weights_file
    l3 = treg.get_model_config("meta-llama/Meta-Llama-3-8B")
    assert (l3.kv_heads, l3.head_dim, l3.rope_theta) == (8, 128, 500000.0)


# --- decoding -------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes(jparams):
    """(package, model, stages, mode) -> a DecodePipeline, built once."""
    cache = {}

    def get(pkg, model, stages, mode="fp"):
        key = (pkg, model, stages, mode)
        if key not in cache:
            bits, optin = MODES[mode]
            part = PARTITIONS[stages]
            jp = [jparams(model, l, r) for l, r in part]
            if pkg == "jax":
                cache[key] = jdec.DecodePipeline(
                    jllama.FAMILY, jreg.get_model_config(model), part, jp,
                    max_len=MAX_LEN, cache_bits=bits, attend_floor=FLOOR,
                    int8_decode_attend=optin)
            else:
                cache[key] = tdec.DecodePipeline(
                    tllama.FAMILY, treg.get_model_config(model), part,
                    [_tparams(p) for p in jp], max_len=MAX_LEN,
                    device="cpu", cache_bits=bits, attend_floor=FLOOR,
                    int8_decode_attend=optin)
        return cache[key]
    return get


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stages", [1, 2])
def test_greedy_tokens_match_jax(pipes, model, mode, stages):
    """6-token prompts and 12 new tokens: decode positions 6..16 cross the
    8 -> 16 -> 32 attend buckets, and the tiny Mistral's 4-token window
    (every step attends only its last 4 positions)."""
    ids = _ids(21, (3, PROMPT))
    want = np.asarray(pipes("jax", model, stages, mode).generate(ids, 12))
    got = pipes("torch", model, stages, mode).generate(ids, 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(v == 0 for v in _build.launch_counts.values())


@pytest.mark.parametrize("model,mode", [(LLAMA, "fp"), (MISTRAL, "int8")])
def test_beam_search_matches_jax(pipes, model, mode):
    ids = _ids(22, (2, PROMPT))
    want = np.asarray(pipes("jax", model, 2, mode).generate_beam(ids, 7,
                                                                 beams=3))
    got = pipes("torch", model, 2, mode).generate_beam(ids, 7,
                                                       beams=3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", MODELS)
def test_span_steps_match_jax(pipes, model):
    """A 5-token span at offset 6 (`extend`, the speculative verify and
    the chunked-prefill step) on fp caches: logits equal the JAX span's,
    and equal 5 serial single-token steps of the port."""
    ids, toks = _ids(23, (2, PROMPT)), _ids(24, (2, 5))
    jpipe, tpipe = pipes("jax", model, 2), pipes("torch", model, 2)
    _, jc = jpipe._prefill(jnp.asarray(ids, jnp.int32))
    want, _ = jpipe.extend(jnp.asarray(toks, jnp.int32), jc, PROMPT)
    _, tc = tpipe._prefill(torch.from_numpy(ids))
    got, _ = tpipe.extend(toks, tc, PROMPT)
    _close(got, want)
    _, tc = tpipe._prefill(torch.from_numpy(ids))
    serial = []
    for j in range(5):
        data = torch.from_numpy(toks[:, j:j + 1])
        for i, st in enumerate(tpipe.stages):
            data, tc[i] = tpipe._decode_step(st, data, tc[i], PROMPT + j)
        serial.append(data[:, 0])
    _close(got, torch.stack(serial, dim=1), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("model", MODELS)
def test_step_logits_match_full_forward(pipes, model):
    """Prefill and fp decode-step logits against the port's own forward
    over the whole sequence through the same two stages (kernel 3's route
    for Llama, the masked route past the window for Mistral)."""
    pipe = pipes("torch", model, 2)
    seq = torch.from_numpy(np.concatenate([_ids(25, (2, PROMPT)),
                                           _ids(26, (2, 7))], 1))
    cfg = treg.get_model_config(model)
    full = seq
    for (l, r), st in zip(PARTITIONS[2], pipe.stages):
        full = shard_apply(tllama.FAMILY, cfg, _sc(l, r), st["params"], full)
    data, caches = pipe._prefill(seq[:, :PROMPT])
    _close(data, full[:, :PROMPT])
    for t in range(PROMPT, seq.shape[1]):
        data = seq[:, t:t + 1]
        for i, st in enumerate(pipe.stages):
            data, caches[i] = pipe._decode_step(st, data, caches[i], t)
        _close(data[:, 0], full[:, t])


def test_prefix_reuse_matches_full_prompt(pipes):
    """Prompt caching on the Mistral window: a 6-token prefix prefilled
    once, the suffix run as one span at offset 6; tokens equal the whole
    prompt's."""
    pipe = pipes("torch", MISTRAL, 2)
    prefix, suffix = _ids(27, (1, 6)), _ids(28, (2, 4))
    full = np.concatenate([np.repeat(prefix, 2, axis=0), suffix], axis=1)
    want = pipe.generate(full, 9).numpy()
    got = pipe.generate(suffix, 9,
                        prefix=pipe.precompute_prefix(prefix)).numpy()
    np.testing.assert_array_equal(got, want[:, 6:])


@pytest.mark.parametrize("kv_heads", [2, 4])
def test_int8_steps_never_ask_the_kernel5_gate(jparams, monkeypatch,
                                               kv_heads):
    """A Llama step on an int8 cache takes the dequantize route without
    consulting `_use_int8_decode_kernel`, as the JAX package's Llama step
    never calls `_attention_core`: GQA (kv_heads 2) and MHA (kv_heads 4,
    Llama-2's shape) alike, with the kernel opt-in forced on."""
    def gate(*args, **kw):
        raise AssertionError("the kernel-5 gate was asked")

    monkeypatch.setattr(tdec, "_use_int8_decode_kernel", gate)
    tcfg = dataclasses.replace(treg.get_model_config(LLAMA),
                               num_kv_heads=kv_heads)
    jcfg = dataclasses.replace(jreg.get_model_config(LLAMA),
                               num_kv_heads=kv_heads)
    jp = jllama.init_params(jcfg, _jsc(1, TOTAL), seed=8)
    pipe = tdec.DecodePipeline(tllama.FAMILY, tcfg, [(1, 8)],
                               [_tparams(jp)], max_len=MAX_LEN, device="cpu",
                               cache_bits=8, attend_floor=FLOOR,
                               int8_decode_attend=1)
    assert pipe.int8_decode_optin == 1
    ids = _ids(29, (2, PROMPT))
    got = pipe.generate(ids, 6).numpy()
    want = np.asarray(jdec.DecodePipeline(
        jllama.FAMILY, jcfg, [(1, 8)], [jp], max_len=MAX_LEN, cache_bits=8,
        attend_floor=FLOOR, int8_decode_attend=1).generate(ids, 6))
    np.testing.assert_array_equal(got, want)


def test_caches_are_sized_at_kv_heads(pipes):
    """Dense caches and the paged arenas hold kv_heads (2), not the 4
    query heads."""
    cfg = treg.get_model_config(LLAMA)
    cache = tdec.init_cache(cfg, 2, 3, 16, cache_bits=8, device="cpu")
    assert cache["k"].shape == (2, 3, 16, 2, 8)
    assert cache["k_scale"].shape == (2, 3, 16, 2)
    pipe = pipes("torch", LLAMA, 2, "int8")
    pool = KvPagePool(pipe, 8, 4)
    for arena in pool._arena:
        assert arena["k"].shape == (1, 8, 4, 2, 8)       # [L, P, page, H, Dh]
        assert arena["v_scale"].shape == (1, 8, 4, 2)
