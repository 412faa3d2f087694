"""The port's ViT shards against the JAX package's, on the same weights.

Every sublayer cut of `pipeedge/test-tiny-vit` (two stages [1, c] and
[c+1, 8], c = 1..7, so both payload arities cross the cut) and the whole
model run in both packages on weights converted with `params_from_jax`.
Tolerance rtol=1e-4, atol=1e-5 (f32): XLA and torch order the f32 sums of
matmuls, LayerNorm statistics and softmax differently, so outputs agree to
a few ulp per op, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import vit as jvit
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu_torch.models import ShardConfig, edge_arity, plan_shard
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply

MODEL = "pipeedge/test-tiny-vit"
RTOL, ATOL = 1e-4, 1e-5
CFG = treg.get_model_config(MODEL)
TOTAL = treg.get_model_layers(MODEL)


def _jax_cfg():
    from pipeedge_tpu.models import registry as jreg
    return jreg.get_model_config(MODEL)


@pytest.fixture(scope="module")
def weights():
    return tvit.random_npz_weights(CFG, seed=5)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(0).normal(size=(2, 3, 16, 16)).astype(np.float32)


def _sc(l, r):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)


def _jax_shard(weights, l, r):
    sc = JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)
    params = jvit.load_params(_jax_cfg(), sc, weights)
    return make_shard_fn(jvit.FAMILY, _jax_cfg(), sc), params


def _torch_shard(jparams, l, r):
    params = params_from_jax(jax.device_get(jparams))
    return lambda data: shard_apply(tvit.FAMILY, CFG, _sc(l, r), params, data)


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


@pytest.mark.parametrize("cut", range(1, TOTAL))
def test_every_sublayer_cut_matches_jax(weights, pixels, cut):
    jfn_a, jp_a = _jax_shard(weights, 1, cut)
    jfn_b, jp_b = _jax_shard(weights, cut + 1, TOTAL)
    tfn_a, tfn_b = _torch_shard(jp_a, 1, cut), _torch_shard(jp_b, cut + 1, TOTAL)
    j_mid = jfn_a(jp_a, jnp.asarray(pixels))
    t_mid = tfn_a(torch.from_numpy(pixels))
    assert len(_np(t_mid)) == edge_arity(cut)
    _close(t_mid, j_mid)
    # each second stage on the SAME (JAX-made) payload, then end to end
    _close(tfn_b(_to_torch(j_mid)), jfn_b(jp_b, j_mid))
    _close(tfn_b(t_mid), jfn_b(jp_b, j_mid))


def test_whole_model_matches_jax(weights, pixels):
    jfn, jp = _jax_shard(weights, 1, TOTAL)
    want = jfn(jp, jnp.asarray(pixels))
    got = _torch_shard(jp, 1, TOTAL)(torch.from_numpy(pixels))
    assert tuple(got.shape) == (2, CFG.num_labels)
    _close(got, want)


@pytest.mark.parametrize("l,r", [(1, 8), (1, 5), (3, 8), (2, 2)])
def test_load_params_equals_converted_jax_params(weights, l, r):
    _, jp = _jax_shard(weights, l, r)
    want = params_from_jax(jax.device_get(jp))
    got = tvit.load_params(CFG, _sc(l, r), weights)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("l,r", [(1, 8), (1, 21), (22, 48), (6, 11)])
def test_init_params_draws_the_jax_stream(l, r):
    model = "pipeedge/test-tiny-vit" if r <= 8 else "google/vit-base-patch16-224"
    from pipeedge_tpu.models import registry as jreg
    jcfg = jreg.get_model_config(model)
    tcfg = treg.get_model_config(model)
    if model != MODEL:   # ViT-B widths are too slow here: narrow copy
        import dataclasses
        jcfg = dataclasses.replace(jcfg, hidden_size=16, intermediate_size=24,
                                   num_attention_heads=2, num_labels=3)
        tcfg = dataclasses.replace(tcfg, hidden_size=16, intermediate_size=24,
                                   num_attention_heads=2, num_labels=3)
    total = treg.get_model_layers(model)
    jsc = JShardConfig(l, r, is_first=l == 1, is_last=r == total)
    want = params_from_jax(jax.device_get(jvit.init_params(jcfg, jsc, seed=3)))
    got = tvit.init_params(tcfg, ShardConfig(l, r, is_first=l == 1,
                                             is_last=r == total), seed=3)
    _assert_same_tree(got, want)


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


def test_plan_matches_jax_plan():
    from pipeedge_tpu.models import edge_arity as jarity
    from pipeedge_tpu.models import plan_shard as jplan

    def key(s):
        return None if s is None else (s.block_id, s.sub_start, s.sub_end)

    for l in range(1, 49):
        for r in range(l, 49):
            want = jplan(JShardConfig(l, r))
            got = plan_shard(ShardConfig(l, r))
            assert (key(got.head), got.full_ids, key(got.tail)) == (
                key(want.head), want.full_ids, key(want.tail))
        assert edge_arity(l) == jarity(l)
