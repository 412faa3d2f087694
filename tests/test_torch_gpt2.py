"""The port's GPT-2 shards against the JAX package's, on the same weights.

- `init_params` draws the JAX package's numpy stream (equal per shard);
- `load_params` from an HF-layout npz (`GPT2LMHeadModel` keys and bare
  `GPT2Model` keys, head tied to `wte`) equals `params_from_jax` of the
  JAX package's stacked GPT-2 tree;
- the whole model and every sublayer cut of `pipeedge/test-tiny-gpt2`
  within rtol=1e-4, atol=1e-5 (f32): XLA and torch order the f32 sums of
  matmuls, LayerNorm statistics and softmax differently, so outputs agree
  to a few ulp per op, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import layers as jlayers
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu_torch.models import ShardConfig, edge_arity
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply

MODEL = "pipeedge/test-tiny-gpt2"
RTOL, ATOL = 1e-4, 1e-5
CFG = treg.get_model_config(MODEL)
TOTAL = treg.get_model_layers(MODEL)


def _jax_cfg(model=MODEL):
    from pipeedge_tpu.models import registry as jreg
    return jreg.get_model_config(model)


@pytest.fixture(scope="module")
def weights():
    return tgpt2.random_npz_weights(CFG, seed=5)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(0, CFG.vocab_size,
                                             size=(2, 10)).astype(np.int32)


def _sc(l, r, total=TOTAL):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == total)


def _jsc(l, r, total=TOTAL):
    return JShardConfig(l, r, is_first=l == 1, is_last=r == total)


def _jax_shard(weights, l, r):
    params = jgpt2.load_params(_jax_cfg(), _jsc(l, r), weights)
    return make_shard_fn(jgpt2.FAMILY, _jax_cfg(), _jsc(l, r)), params


def _torch_shard(jparams, l, r):
    params = params_from_jax(jax.device_get(jparams))
    return lambda data: shard_apply(tgpt2.FAMILY, CFG, _sc(l, r), params,
                                    data)


def _np(payload):
    if isinstance(payload, tuple):
        return tuple(np.asarray(t) for t in payload)
    return (np.asarray(payload),)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _to_torch(payload):
    if isinstance(payload, tuple):
        return tuple(torch.from_numpy(np.array(t)) for t in payload)
    return torch.from_numpy(np.array(payload))


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


def test_whole_model_matches_jax(weights, ids):
    jfn, jp = _jax_shard(weights, 1, TOTAL)
    want = jfn(jp, jnp.asarray(ids))
    got = _torch_shard(jp, 1, TOTAL)(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 10, CFG.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("cut", range(1, TOTAL))
def test_every_sublayer_cut_matches_jax(weights, ids, cut):
    jfn_a, jp_a = _jax_shard(weights, 1, cut)
    jfn_b, jp_b = _jax_shard(weights, cut + 1, TOTAL)
    tfn_a = _torch_shard(jp_a, 1, cut)
    tfn_b = _torch_shard(jp_b, cut + 1, TOTAL)
    j_mid = jfn_a(jp_a, jnp.asarray(ids))
    t_mid = tfn_a(torch.from_numpy(ids))
    assert len(_np(t_mid)) == edge_arity(cut)
    _close(t_mid, j_mid)
    _close(tfn_b(_to_torch(j_mid)), jfn_b(jp_b, j_mid))
    _close(tfn_b(t_mid), jfn_b(jp_b, j_mid))


@pytest.mark.parametrize("l,r", [(1, 8), (1, 4), (5, 8), (3, 6)])
@pytest.mark.parametrize("layout", ["lm_head", "bare"])
def test_load_params_equals_converted_jax_params(weights, l, r, layout):
    if layout == "bare":      # GPT2Model keys: no prefix, head tied to wte
        weights = {k.removeprefix("transformer."): v
                   for k, v in weights.items() if k != "lm_head.weight"}
    jp = jgpt2.load_params(_jax_cfg(), _jsc(l, r), weights)
    if "blocks" in jp:        # the JAX tree stacks full blocks
        assert not isinstance(jp["blocks"], (list, tuple))
    want = params_from_jax(jax.device_get(jp))
    got = tgpt2.load_params(CFG, _sc(l, r), weights)
    _assert_same_tree(got, want)
    if r == TOTAL:
        assert torch.equal(got["final"]["head"]["w"],
                           torch.from_numpy(np.array(
                               weights[[k for k in weights
                                        if k.endswith("wte.weight")][0]])).T)


def test_params_from_jax_unstacks_gpt2_blocks(weights):
    jp = jgpt2.load_params(_jax_cfg(), _jsc(1, TOTAL), weights)
    got = params_from_jax(jax.device_get(jp))
    assert set(got) == {"embeddings", "blocks", "final"}
    assert set(got["embeddings"]) == {"wte", "wpe"}
    assert set(got["final"]) == {"ln", "head"}
    assert isinstance(got["blocks"], list)
    assert len(got["blocks"]) == CFG.num_hidden_layers
    for i, blk in enumerate(got["blocks"]):
        np.testing.assert_array_equal(
            blk["mlp_up"]["w"].numpy(),
            weights[f"transformer.h.{i}.mlp.c_fc.weight"])


@pytest.mark.parametrize("model,l,r", [
    (MODEL, 1, 8), (MODEL, 1, 4), (MODEL, 6, 8), (MODEL, 2, 7),
    ("gpt2", 1, 24), ("gpt2", 25, 48)])
def test_init_params_draws_the_jax_stream(model, l, r):
    jcfg, tcfg = _jax_cfg(model), treg.get_model_config(model)
    if model != MODEL:        # gpt2 widths are too slow here: narrow copy
        narrow = dict(hidden_size=16, intermediate_size=24,
                      num_attention_heads=2, vocab_size=50,
                      max_position_embeddings=32)
        jcfg = dataclasses.replace(jcfg, **narrow)
        tcfg = dataclasses.replace(tcfg, **narrow)
    total = treg.get_model_layers(model)
    want = params_from_jax(jax.device_get(
        jgpt2.init_params(jcfg, _jsc(l, r, total), seed=0)))
    got = tgpt2.init_params(tcfg, _sc(l, r, total), seed=0)
    _assert_same_tree(got, want)


def test_registry_entries_match_jax():
    for name in ("gpt2", "gpt2-medium", MODEL):
        jcfg = _jax_cfg(name)
        tcfg = treg.get_model_config(name)
        for field in dataclasses.fields(tcfg):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
        assert tcfg.kv_heads == jcfg.kv_heads
        from pipeedge_tpu.models import registry as jreg
        assert treg.get_model_layers(name) == jreg.get_model_layers(name)


def test_moe_config_raises_naming_expert_module(monkeypatch):
    """An MoE config's routed FFN is `parallel/expert.py`'s: the dense
    HF-layout writer refuses it naming that module, `init_params` draws
    the router and expert params, and sublayer 2 calls `moe_ffn_delta`
    with GPT-2's activation."""
    from pipeedge_tpu_torch.parallel import expert
    moe = dataclasses.replace(CFG, n_experts=4, capacity_factor=4.0)
    with pytest.raises(ValueError, match="parallel/expert.py"):
        tgpt2.random_npz_weights(moe)
    params = tgpt2.init_params(moe, _sc(1, TOTAL))
    block = params["blocks"][0]
    assert set(block["moe"]) == {"router", "experts"}
    assert "mlp_up" not in block and "mlp_down" not in block
    calls = []
    real = expert.moe_ffn_delta

    def spy(*args, **kw):
        calls.append(kw["act"])
        return real(*args, **kw)

    monkeypatch.setattr(expert, "moe_ffn_delta", spy)
    delta, skip = tgpt2.sublayer(block, 2, torch.ones(1, 2, CFG.hidden_size),
                                 moe)
    assert calls == [tlayers.gelu_new] and delta.shape == skip.shape


def test_gelu_new_matches_jax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.gelu_new(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.gelu_new(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
