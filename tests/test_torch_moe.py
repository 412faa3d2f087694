"""The port's switch-MoE GPT-2 against the JAX package's, on one device.

The single-device cases of `tests/test_moe_family.py` and
`tests/test_expert.py`'s routing, on `pipeedge/test-tiny-moe` (4 experts,
capacity_factor 4: dropless) and on the same model at capacity_factor 1
(tokens dropped), weights from `moe_state_dict` (the same numpy stream
in both packages):

- `parallel/expert.py`: routing (experts, gates, kept slots in token
  order on equal gates), `moe_capacity`, `moe_ffn_delta` (gelu and
  gelu_new) and `reference_moe_ffn`, against JAX and against each other,
  within rtol = atol = 2e-5 (f32, as the JAX tests hold them);
- the whole forward and every split against JAX and against the whole
  (rtol=1e-4, atol=1e-5);
- greedy decode against the JAX `DecodePipeline` (fp cache, int8 on both
  attend routes), and, dropless, against greedy over the full forward;
- `load_params` and `params_from_jax` of the stacked [L, E, ...] expert
  leaves, `init_params`' stream, and the generate entry.
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
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.parallel import expert as jexpert
from pipeedge_tpu_torch import generate
from pipeedge_tpu_torch.models import ShardConfig, edge_arity
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel import expert as texpert

MODEL = "pipeedge/test-tiny-moe"
TOTAL = 8
RTOL, ATOL = 1e-4, 1e-5
# capacity factor -> its name in the test ids: 4.0 = dropless (the
# registry's), 1.0 = capacity-bounded (tokens dropped)
CAPACITY = {"dropless": 4.0, "bounded": 1.0}


def _cfgs(kind="dropless"):
    cf = CAPACITY[kind]
    return (dataclasses.replace(jreg.get_model_config(MODEL),
                                capacity_factor=cf),
            dataclasses.replace(treg.get_model_config(MODEL),
                                capacity_factor=cf))


def _sc(l, r):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)


def _jsc(l, r):
    return JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)


@pytest.fixture(scope="module")
def weights():
    return tgpt2.moe_state_dict(treg.get_model_config(MODEL), seed=3)


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


# --- parallel/expert.py ---------------------------------------------------

def _moe(seed=1, n_experts=4):
    cfg = jreg.get_model_config(MODEL)
    return (jexpert.init_moe_params(cfg, n_experts, seed=seed),
            texpert.init_moe_params(treg.get_model_config(MODEL), n_experts,
                                    seed=seed))


def test_init_moe_params_draw_the_jax_stream():
    jp, tp = _moe(seed=4, n_experts=8)
    _assert_same_tree(tp, params_from_jax(jax.device_get(jp)))


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_routing_matches_jax(capacity):
    """Experts, gates and kept slots equal JAX's; rows 8-15 repeat rows
    0-7, so equal gates compete for slots: the earlier token is kept
    first, as `lax.top_k` keeps it."""
    jp, tp = _moe(seed=2)
    x = np.random.default_rng(3).normal(size=(8, 32)).astype(np.float32)
    x = np.concatenate([x, x])
    je, jg, jk, jkept = jexpert._routing(jp["router"], jnp.asarray(x), 4,
                                         capacity)
    te, tg, tk, tkept = texpert._routing(tp["router"], torch.from_numpy(x),
                                         4, capacity)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept))
    # the kept slots name the same tokens (unkept slots are never read)
    np.testing.assert_array_equal(np.where(tkept.numpy(), tk.numpy(), -1),
                                  np.where(np.asarray(jkept), np.asarray(jk),
                                           -1))


@pytest.mark.parametrize("n", [1, 5, 16, 100])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_moe_capacity_matches_jax(n, cf):
    assert texpert.moe_capacity(n, 4, cf) == jexpert.moe_capacity(n, 4, cf)


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_moe_ffn_delta_matches_jax(act, cf):
    jp, tp = _moe(seed=1)
    x = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    want = jexpert.moe_ffn_delta(jp, jnp.asarray(x), 4, cf,
                                 act=getattr(jlayers, act))
    got = texpert.moe_ffn_delta(tp, torch.from_numpy(x), 4, cf,
                                act=getattr(tlayers, act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_moe_delta_matches_reference_ffn():
    """moe_ffn_delta == reference_moe_ffn - x (same routing, the experts
    in a loop), and the port's reference equals the JAX one."""
    jp, tp = _moe(seed=1)
    x = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    delta = texpert.moe_ffn_delta(tp, xt, 4, 1.25, act=tlayers.gelu)
    full = texpert.reference_moe_ffn(tp, xt, 4)
    np.testing.assert_allclose(delta.numpy(), (full - xt).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jexpert.reference_moe_ffn(
            jp, jnp.asarray(x), 4)), rtol=2e-5, atol=2e-5)


# --- the MoE GPT-2 shards -------------------------------------------------

def test_moe_state_dict_matches_jax(weights):
    want = jgpt2.moe_state_dict(jreg.get_model_config(MODEL), seed=3)
    assert set(weights) == set(want)
    for k in want:
        np.testing.assert_array_equal(weights[k], want[k])


@pytest.mark.parametrize("l,r", [(1, 8), (1, 4), (3, 8), (2, 6), (7, 8)])
def test_load_params_equals_converted_jax_params(weights, l, r):
    """The stacked [L, E, ...] expert leaves of the JAX tree (and [E, ...]
    in a partial head or tail block) carry across `params_from_jax`."""
    jcfg, tcfg = _cfgs()
    jp = jgpt2.load_params(jcfg, _jsc(l, r), weights)
    want = params_from_jax(jax.device_get(jp))
    got = tgpt2.load_params(tcfg, _sc(l, r), weights)
    _assert_same_tree(got, want)
    if "blocks" in got:
        assert got["blocks"][0]["moe"]["experts"]["mlp_up"]["w"].shape == \
            (4, 32, 64)


def test_init_params_draws_the_jax_stream():
    for name, (l, r) in ((MODEL, (1, 8)), (MODEL, (3, 6)),
                         ("pipeedge/gpt2-moe-8e", (1, 8))):
        jcfg, tcfg = jreg.get_model_config(name), treg.get_model_config(name)
        total = treg.get_model_layers(name)
        if total != TOTAL:    # gpt2-moe-8e's widths are too slow here
            narrow = dict(hidden_size=16, intermediate_size=24,
                          num_attention_heads=2, vocab_size=50,
                          max_position_embeddings=32)
            jcfg = dataclasses.replace(jcfg, **narrow)
            tcfg = dataclasses.replace(tcfg, **narrow)
        want = params_from_jax(jax.device_get(jgpt2.init_params(
            jcfg, JShardConfig(l, r, l == 1, r == total), seed=0)))
        got = tgpt2.init_params(tcfg, ShardConfig(l, r, l == 1, r == total),
                                seed=0)
        _assert_same_tree(got, want)


@pytest.mark.parametrize("sub", range(4))
def test_sublayer_params_match_jax(sub):
    """A one-sublayer shard of the MoE holds exactly
    `MOE_SUBLAYER_PARAMS[sub]` (the routed FFN all in sublayer 2), as the
    JAX package's table says; the dense table stays the dense shard's."""
    layer = 4 + sub + 1                       # block 1's sublayer `sub`
    got = tgpt2.init_params(treg.get_model_config(MODEL),
                            ShardConfig(layer, layer), seed=0)
    assert set(got.get("head", {})) == set(tgpt2.MOE_SUBLAYER_PARAMS[sub]) \
        == set(jgpt2.MOE_SUBLAYER_PARAMS[sub])
    dense = tgpt2.init_params(treg.get_model_config("pipeedge/test-tiny-gpt2"),
                              ShardConfig(layer, layer), seed=0)
    assert set(dense["head"]) == set(tgpt2.SUBLAYER_PARAMS[sub]) \
        == set(jgpt2.SUBLAYER_PARAMS[sub])


@pytest.mark.parametrize("kind", list(CAPACITY))
@pytest.mark.parametrize("partition", [
    [(1, 8)], [(1, 4), (5, 8)],
    [(1, 3), (4, 8)],     # cut after the MoE sublayer: a (delta, res) edge
    [(1, 7), (8, 8)]])
def test_forward_and_splits_match_jax(weights, kind, partition):
    jcfg, tcfg = _cfgs(kind)
    ids = _ids(7, (2, 9))
    whole = shard_apply(tgpt2.FAMILY, tcfg, _sc(1, 8),
                        tgpt2.load_params(tcfg, _sc(1, 8), weights),
                        torch.from_numpy(ids))
    jdata, tdata = jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    for l, r in partition:
        jp = jgpt2.load_params(jcfg, _jsc(l, r), weights)
        jdata = make_shard_fn(jgpt2.FAMILY, jcfg, _jsc(l, r))(jp, jdata)
        tdata = shard_apply(tgpt2.FAMILY, tcfg, _sc(l, r),
                            tgpt2.load_params(tcfg, _sc(l, r), weights),
                            tdata)
        if r < TOTAL:
            assert len(_np(tdata)) == edge_arity(r)
        _close(tdata, jdata)
    _close(tdata, whole)
    assert tuple(whole.shape) == (2, 9, 100)


# --- decoding -------------------------------------------------------------

# cache mode -> (cache_bits, int8 decode-attend opt-in)
MODES = {"fp": (0, 0), "int8": (8, 0), "int8_kernel": (8, 1)}


def _pipes(weights, kind, mode, partition=((1, 4), (5, 8))):
    jcfg, tcfg = _cfgs(kind)
    bits, optin = MODES[mode]
    partition = list(partition)
    jp = [jgpt2.load_params(jcfg, _jsc(l, r), weights) for l, r in partition]
    return (jdec.DecodePipeline(jgpt2.FAMILY, jcfg, partition, jp,
                                max_len=32, cache_bits=bits, attend_floor=8,
                                int8_decode_attend=optin),
            tdec.DecodePipeline(tgpt2.FAMILY, tcfg, partition,
                                [params_from_jax(jax.device_get(p))
                                 for p in jp], max_len=32, device="cpu",
                                cache_bits=bits, attend_floor=8,
                                int8_decode_attend=optin))


@pytest.mark.parametrize("kind,mode", [
    ("dropless", "fp"), ("dropless", "int8_kernel"), ("bounded", "fp"),
    ("bounded", "int8"), ("bounded", "int8_kernel")])
def test_greedy_decode_matches_jax(weights, kind, mode):
    """Same steps in both packages: a capacity-bounded model routes each
    step's tokens on their own in both, so tokens agree exactly."""
    jpipe, tpipe = _pipes(weights, kind, mode)
    ids = _ids(9, (3, 6))
    np.testing.assert_array_equal(tpipe.generate(ids, 10).numpy(),
                                  np.asarray(jpipe.generate(ids, 10)))


def test_dropless_decode_matches_forward_greedy(weights):
    """capacity_factor >= n_experts: routing is per token, so cached
    greedy decoding equals greedy over the full forward at each step."""
    _, tpipe = _pipes(weights, "dropless", "fp")
    _, tcfg = _cfgs()
    params = tgpt2.load_params(tcfg, _sc(1, 8), weights)
    ids = _ids(9, (2, 5))
    got = tpipe.generate(ids, 6).numpy()
    seq = np.array(ids)
    for _ in range(6):
        logits = shard_apply(tgpt2.FAMILY, tcfg, _sc(1, 8), params,
                             torch.from_numpy(seq)).numpy()
        seq = np.concatenate([seq, logits[:, -1].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(got, seq)


def test_beam_search_matches_jax(weights):
    jpipe, tpipe = _pipes(weights, "bounded", "fp")
    ids = _ids(10, (2, 6))
    np.testing.assert_array_equal(
        tpipe.generate_beam(ids, 6, beams=3).numpy(),
        np.asarray(jpipe.generate_beam(ids, 6, beams=3)))


def test_generate_entry_runs_the_tiny_moe(capsys):
    out = generate.main(["-m", MODEL, "-pt", "1,4,5,8", "-b", "2",
                         "--prompt-len", "6", "--new-tokens", "5",
                         "--kv-bits", "8", "--device", "cpu"])
    assert out.shape == (2, 11)
    text = capsys.readouterr().out
    assert "generated 2x5 tokens" in text and "kernel_launches=" in text


def test_random_npz_weights_refuses_moe_naming_moe_state_dict():
    with pytest.raises(ValueError, match="moe_state_dict"):
        tgpt2.random_npz_weights(treg.get_model_config(MODEL))
