"""The port's DeiT shards against the JAX package's, on the same weights.

DeiT at `facebook/deit-tiny-distilled-patch16-224` widths (D 192, 3
heads, 198 tokens at 224 px): layers 1-8 (the embeddings and two blocks)
and every cut inside them, and the last shard with the CLS head, in both
packages on torch-hub weights (fused qkv) converted with
`params_from_jax`. Tolerance rtol=1e-4, atol=1e-5 (f32), as for ViT
(tests/test_torch_models.py). Also: the loaders, the seeded init, the
HF converter and the registry entries the port shares with the JAX
package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import deit as jdeit
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu_torch.models import ShardConfig, edge_arity
from pipeedge_tpu_torch.models import deit as tdeit
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply

MODEL = "facebook/deit-tiny-distilled-patch16-224"
RTOL, ATOL = 1e-4, 1e-5
CFG = treg.get_model_config(MODEL)
JCFG = jreg.get_model_config(MODEL)
TOTAL = treg.get_model_layers(MODEL)

# the entries this slice adds to the port's registry
NEW_ENTRIES = ("bert-base-uncased", "bert-large-uncased",
               "textattack/bert-base-uncased-CoLA",
               "facebook/deit-base-distilled-patch16-224",
               "facebook/deit-small-distilled-patch16-224",
               "facebook/deit-tiny-distilled-patch16-224",
               "pipeedge/test-tiny-bert")


def hub_deit_weights(cfg, seed: int):
    """Random weights under the torch-hub DeiT keys (qkv fused [3D, D]),
    every bias and norm parameter random too."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size
    p, c = cfg.patch_size, cfg.num_channels

    def r(*shape, mean=0.0):
        return (mean + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"cls_token": r(1, 1, d), "dist_token": r(1, 1, d),
          "pos_embed": r(1, cfg.num_patches + 2, d),
          "patch_embed.proj.weight": r(d, c, p, p),
          "patch_embed.proj.bias": r(d),
          "norm.weight": r(d, mean=1.0), "norm.bias": r(d),
          "head.weight": r(cfg.num_labels, d), "head.bias": r(cfg.num_labels)}
    for i in range(cfg.num_hidden_layers):
        root = f"blocks.{i}."
        sd[root + "norm1.weight"] = r(d, mean=1.0)
        sd[root + "norm1.bias"] = r(d)
        sd[root + "attn.qkv.weight"] = r(3 * d, d)
        sd[root + "attn.qkv.bias"] = r(3 * d)
        sd[root + "attn.proj.weight"] = r(d, d)
        sd[root + "attn.proj.bias"] = r(d)
        sd[root + "norm2.weight"] = r(d, mean=1.0)
        sd[root + "norm2.bias"] = r(d)
        sd[root + "mlp.fc1.weight"] = r(it, d)
        sd[root + "mlp.fc1.bias"] = r(it)
        sd[root + "mlp.fc2.weight"] = r(d, it)
        sd[root + "mlp.fc2.bias"] = r(d)
    return sd


@pytest.fixture(scope="module")
def weights():
    return hub_deit_weights(CFG, seed=5)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(0).normal(
        size=(2, 3, 224, 224)).astype(np.float32)


def _sc(l, r, total=TOTAL):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == total)


def _jax_shard(weights, l, r):
    sc = JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)
    params = jdeit.load_params(JCFG, sc, weights)
    return make_shard_fn(jdeit.FAMILY, JCFG, sc), params


def _torch_shard(jparams, l, r):
    params = params_from_jax(jax.device_get(jparams))
    return lambda data: shard_apply(tdeit.FAMILY, CFG, _sc(l, r), params, data)


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


def test_layers_1_to_8_match_jax(weights, pixels):
    jfn, jp = _jax_shard(weights, 1, 8)
    want = jfn(jp, jnp.asarray(pixels))
    got = _torch_shard(jp, 1, 8)(torch.from_numpy(pixels))
    assert tuple(got.shape) == (2, 198, 192)
    _close(got, want)


@pytest.mark.parametrize("cut", range(1, 8))
def test_every_cut_inside_layers_1_to_8_matches_jax(weights, pixels, cut):
    jfn_a, jp_a = _jax_shard(weights, 1, cut)
    jfn_b, jp_b = _jax_shard(weights, cut + 1, 8)
    tfn_a, tfn_b = _torch_shard(jp_a, 1, cut), _torch_shard(jp_b, cut + 1, 8)
    j_mid = jfn_a(jp_a, jnp.asarray(pixels))
    t_mid = tfn_a(torch.from_numpy(pixels))
    assert len(_np(t_mid)) == edge_arity(cut)
    _close(t_mid, j_mid)
    _close(tfn_b(_to_torch(j_mid)), jfn_b(jp_b, j_mid))


def test_last_shard_cls_head_matches_jax(weights):
    """Layers 42-48 (a mid-block start, a (ctx, residual) payload in)
    through the final norm and the head on the CLS token only."""
    jfn, jp = _jax_shard(weights, 42, TOTAL)
    rng = np.random.default_rng(1)
    payload = tuple(rng.normal(size=(2, 198, 192)).astype(np.float32)
                    for _ in range(2))
    want = jfn(jp, tuple(jnp.asarray(t) for t in payload))
    tfn = _torch_shard(jp, 42, TOTAL)
    got = tfn(tuple(torch.from_numpy(t) for t in payload))
    assert tuple(got.shape) == (2, CFG.num_labels)
    _close(got, want)
    # the head reads the CLS token (row 0) only: zeroing the other rows
    # of the final hidden state leaves the logits as they are
    p = params_from_jax(jax.device_get(jp))
    hidden = shard_apply(tdeit.FAMILY, CFG, ShardConfig(42, TOTAL), p,
                         tuple(torch.from_numpy(t) for t in payload))
    hidden = torch.cat([hidden[:, :1], torch.zeros_like(hidden[:, 1:])], 1)
    assert torch.equal(tdeit.finalize(p["final"], hidden, CFG), got)


@pytest.mark.parametrize("l,r", [(1, 48), (1, 6), (7, 12), (41, 48)])
def test_load_params_equals_converted_jax_params(weights, l, r):
    jp = jdeit.load_params(JCFG, JShardConfig(l, r, is_first=l == 1,
                                              is_last=r == TOTAL), weights)
    want = params_from_jax(jax.device_get(jp))
    got = tdeit.load_params(CFG, _sc(l, r), weights)
    _assert_same_tree(got, want)


def test_load_params_splits_the_fused_qkv(weights):
    got = tdeit.load_params(CFG, _sc(1, 4), weights)
    qkv_w = weights["blocks.0.attn.qkv.weight"]
    qkv_b = weights["blocks.0.attn.qkv.bias"]
    d = CFG.hidden_size
    for i, name in enumerate(("q", "k", "v")):
        np.testing.assert_array_equal(got["blocks"][0][name]["w"].numpy(),
                                      qkv_w[i * d:(i + 1) * d].T)
        np.testing.assert_array_equal(got["blocks"][0][name]["b"].numpy(),
                                      qkv_b[i * d:(i + 1) * d])


@pytest.mark.parametrize("model,l,r", [
    (MODEL, 1, 8), (MODEL, 41, 48),
    ("facebook/deit-base-distilled-patch16-224", 1, 21),
    ("facebook/deit-base-distilled-patch16-224", 22, 48),
    ("facebook/deit-small-distilled-patch16-224", 6, 11)])
def test_init_params_draws_the_jax_stream(model, l, r):
    jcfg = jreg.get_model_config(model)
    tcfg = treg.get_model_config(model)
    if model != MODEL:   # base and small widths are slow here: narrow copy
        narrow = dict(hidden_size=16, intermediate_size=24,
                      num_attention_heads=2, num_labels=3)
        jcfg = dataclasses.replace(jcfg, **narrow)
        tcfg = dataclasses.replace(tcfg, **narrow)
    jsc = JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)
    want = params_from_jax(jax.device_get(jdeit.init_params(jcfg, jsc, seed=3)))
    got = tdeit.init_params(tcfg, _sc(l, r), seed=3)
    _assert_same_tree(got, want)
    if l == 1:
        assert tuple(got["embeddings"]["pos"].shape) == (1, 198, tcfg.hidden_size)


def test_random_npz_weights_load_as_init_params():
    cfg = dataclasses.replace(CFG, hidden_size=16, intermediate_size=24,
                              num_attention_heads=2, num_hidden_layers=2,
                              num_labels=3)
    weights = tdeit.random_npz_weights(cfg, seed=4)
    assert weights["attn.qkv.weight".join(("blocks.0.", ""))].shape == (48, 16)
    whole = tdeit.init_params(cfg, _sc(1, 8, 8), seed=4)
    _assert_same_tree(tdeit.load_params(cfg, _sc(1, 8, 8), weights), whole)


def test_hf_to_npz_weights_matches_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.DeiTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=16, patch_size=4, num_labels=5)
    torch.manual_seed(0)
    model = transformers.DeiTForImageClassificationWithTeacher(hf_cfg)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    cfg = dataclasses.replace(CFG, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64,
                              image_size=16, patch_size=4, num_labels=5)
    jcfg = dataclasses.replace(JCFG, hidden_size=32, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=64,
                               image_size=16, patch_size=4, num_labels=5)
    got = tdeit.hf_to_npz_weights(sd, cfg)
    want = jdeit.hf_to_npz_weights(sd, jcfg)
    assert set(got) == set(want) and "head.weight" in got
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    # and the converted checkpoint loads into the same shard params
    sc = _sc(1, 8, 8)
    jp = jdeit.load_params(jcfg, JShardConfig(1, 8, True, True), want)
    _assert_same_tree(tdeit.load_params(cfg, sc, got),
                      params_from_jax(jax.device_get(jp)))


@pytest.mark.parametrize("name", NEW_ENTRIES)
def test_registry_entry_matches_jax(name):
    got, want = treg.get_model_entry(name), jreg.get_model_entry(name)
    assert (got.layers, got.weights_file) == (want.layers, want.weights_file)
    assert got.family.FAMILY.name == want.family.FAMILY.name
    for field in dataclasses.fields(got.config):
        assert getattr(got.config, field.name) == \
            getattr(want.config, field.name), field.name


def test_registry_keeps_the_jax_order():
    ported = set(treg.get_model_names())
    assert set(NEW_ENTRIES) <= ported
    assert treg.get_model_names() == [n for n in jreg.get_model_names()
                                      if n in ported]


@pytest.mark.parametrize("bit", [0, 8])
def test_pipeline_matches_jax_pipeline(weights, pixels, bit, tmp_path):
    """The slice as a whole at deit-tiny widths: the port's two-stage host
    pipeline against the JAX package's on the same checkpoint. Raw edges:
    within f32 tolerance; 8 bits: within a tenth of the logits' own
    quantization error plus f32 noise (tests/test_torch_pipeline.py)."""
    from pipeedge_tpu.parallel.pipeline import HostPipeline as JHostPipeline
    from pipeedge_tpu.parallel.pipeline import PipelineStage as JPipelineStage
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    path = tmp_path / "deit-tiny.npz"
    np.savez(path, **weights)
    partition = [(1, 22), (23, TOTAL)]
    port = tpipe.build_pipeline(MODEL, partition, model_file=str(path),
                                device="cpu", quant_bits=[bit, 0])
    got, _ = port.run([torch.from_numpy(pixels)])

    def jax_run(part, bits):
        stages = []
        for i, (l, r) in enumerate(part):
            fn, params, _ = jreg.module_shard_factory(MODEL, str(path), l, r)
            stages.append(JPipelineStage(fn, params, jax.devices()[0],
                                         quant_bit=bits[i]))
        out, _ = JHostPipeline(stages).run([jnp.asarray(pixels)])
        return np.asarray(out[0])

    want = jax_run(partition, [bit, 0])
    if bit == 0:
        _close(got[0], want)
    else:
        quant_err = np.max(np.abs(want - jax_run([(1, TOTAL)], [0])))
        assert quant_err > 0
        assert np.max(np.abs(got[0].numpy() - want)) <= 0.1 * quant_err + 1e-5
