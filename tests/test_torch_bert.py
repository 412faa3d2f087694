"""The port's BERT shards against the JAX package's, on the same weights.

Every sublayer cut of `pipeedge/test-tiny-bert` (two stages [1, c] and
[c+1, 8], c = 1..7, so both payload arities cross the cut) and the whole
model run in both packages on the same int32 token ids, with weights
converted by `params_from_jax`. Tolerance rtol=1e-4, atol=1e-5 (f32), as
for ViT (tests/test_torch_models.py): XLA and torch order the f32 sums of
matmuls, LayerNorm statistics and softmax differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import bert as jbert
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu_torch.models import ShardConfig, edge_arity
from pipeedge_tpu_torch.models import bert as tbert
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply

MODEL = "pipeedge/test-tiny-bert"
RTOL, ATOL = 1e-4, 1e-5
CFG = treg.get_model_config(MODEL)
JCFG = jreg.get_model_config(MODEL)
TOTAL = treg.get_model_layers(MODEL)
SEQ = 12


def hf_bert_weights(cfg, seed: int, prefixed: bool):
    """Random weights under the HF `BertModel` keys, every bias and norm
    parameter random too; `prefixed` gives a classification checkpoint's
    `bert.` keys and `classifier.*`."""
    rng = np.random.default_rng(seed)
    d, it = cfg.hidden_size, cfg.intermediate_size

    def r(*shape, mean=0.0):
        return (mean + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": r(cfg.vocab_size, d),
          "embeddings.position_embeddings.weight": r(cfg.max_position_embeddings, d),
          "embeddings.token_type_embeddings.weight": r(cfg.type_vocab_size, d),
          "embeddings.LayerNorm.weight": r(d, mean=1.0),
          "embeddings.LayerNorm.bias": r(d),
          "pooler.dense.weight": r(d, d), "pooler.dense.bias": r(d)}
    for i in range(cfg.num_hidden_layers):
        root = f"encoder.layer.{i}."
        for key in ("query", "key", "value"):
            sd[root + f"attention.self.{key}.weight"] = r(d, d)
            sd[root + f"attention.self.{key}.bias"] = r(d)
        sd[root + "attention.output.dense.weight"] = r(d, d)
        sd[root + "attention.output.dense.bias"] = r(d)
        sd[root + "attention.output.LayerNorm.weight"] = r(d, mean=1.0)
        sd[root + "attention.output.LayerNorm.bias"] = r(d)
        sd[root + "intermediate.dense.weight"] = r(it, d)
        sd[root + "intermediate.dense.bias"] = r(it)
        sd[root + "output.dense.weight"] = r(d, it)
        sd[root + "output.dense.bias"] = r(d)
        sd[root + "output.LayerNorm.weight"] = r(d, mean=1.0)
        sd[root + "output.LayerNorm.bias"] = r(d)
    head = {"classifier.weight": r(cfg.num_labels, d),
            "classifier.bias": r(cfg.num_labels)}
    if prefixed:
        return {**{"bert." + k: v for k, v in sd.items()}, **head}
    return {**sd, **head}


@pytest.fixture(scope="module")
def weights():
    return hf_bert_weights(CFG, seed=5, prefixed=True)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size, size=(2, SEQ)).astype(np.int32)


def _sc(l, r, total=TOTAL):
    return ShardConfig(l, r, is_first=l == 1, is_last=r == total)


def _jax_shard(weights, l, r):
    sc = JShardConfig(l, r, is_first=l == 1, is_last=r == TOTAL)
    params = jbert.load_params(JCFG, sc, weights)
    return make_shard_fn(jbert.FAMILY, JCFG, sc), params


def _torch_shard(jparams, l, r):
    params = params_from_jax(jax.device_get(jparams))
    return lambda data: shard_apply(tbert.FAMILY, CFG, _sc(l, r), params, data)


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


@pytest.mark.parametrize("cut", range(1, TOTAL))
def test_every_sublayer_cut_matches_jax(weights, ids, cut):
    jfn_a, jp_a = _jax_shard(weights, 1, cut)
    jfn_b, jp_b = _jax_shard(weights, cut + 1, TOTAL)
    tfn_a, tfn_b = _torch_shard(jp_a, 1, cut), _torch_shard(jp_b, cut + 1, TOTAL)
    j_mid = jfn_a(jp_a, jnp.asarray(ids))
    t_mid = tfn_a(torch.from_numpy(ids))
    assert len(_np(t_mid)) == edge_arity(cut)
    _close(t_mid, j_mid)
    # each second stage on the SAME (JAX-made) payload, then end to end
    _close(tfn_b(_to_torch(j_mid)), jfn_b(jp_b, j_mid))
    _close(tfn_b(t_mid), jfn_b(jp_b, j_mid))


def test_whole_model_matches_jax(weights, ids):
    jfn, jp = _jax_shard(weights, 1, TOTAL)
    want = jfn(jp, jnp.asarray(ids))
    tfn = _torch_shard(jp, 1, TOTAL)
    got = tfn(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, CFG.num_labels)
    _close(got, want)
    # the ids' integer width does not matter to the gather
    assert torch.equal(tfn(torch.from_numpy(ids).long()), got)


def test_pooled_output_without_head_matches_jax(ids):
    """`bert-base-uncased` has no labels: the last shard returns the tanh
    pooler's output (narrow widths)."""
    jcfg = dataclasses.replace(jreg.get_model_config("bert-base-uncased"),
                               hidden_size=16, intermediate_size=24,
                               num_attention_heads=2, num_hidden_layers=2,
                               vocab_size=CFG.vocab_size,
                               max_position_embeddings=32)
    tcfg = dataclasses.replace(treg.get_model_config("bert-base-uncased"),
                               hidden_size=16, intermediate_size=24,
                               num_attention_heads=2, num_hidden_layers=2,
                               vocab_size=CFG.vocab_size,
                               max_position_embeddings=32)
    assert jcfg.num_labels == tcfg.num_labels == 0
    sc = JShardConfig(1, 8, is_first=True, is_last=True)
    jp = jbert.init_params(jcfg, sc, seed=2)
    want = make_shard_fn(jbert.FAMILY, jcfg, sc)(jp, jnp.asarray(ids))
    got = shard_apply(tbert.FAMILY, tcfg, _sc(1, 8, 8),
                      params_from_jax(jax.device_get(jp)),
                      torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 16)
    _close(got, want)


@pytest.mark.parametrize("prefixed", [True, False])
@pytest.mark.parametrize("l,r", [(1, 8), (1, 5), (3, 8), (2, 2)])
def test_load_params_equals_converted_jax_params(l, r, prefixed):
    weights = hf_bert_weights(CFG, seed=7, prefixed=prefixed)
    jp = jbert.load_params(JCFG, JShardConfig(l, r, is_first=l == 1,
                                              is_last=r == TOTAL), weights)
    want = params_from_jax(jax.device_get(jp))
    got = tbert.load_params(CFG, _sc(l, r), weights)
    _assert_same_tree(got, want)
    if r == TOTAL:
        assert "head" in got["final"]


@pytest.mark.parametrize("model,l,r", [
    (MODEL, 1, 8), (MODEL, 3, 6),
    ("textattack/bert-base-uncased-CoLA", 1, 21),
    ("textattack/bert-base-uncased-CoLA", 22, 48),
    ("bert-large-uncased", 90, 96)])
def test_init_params_draws_the_jax_stream(model, l, r):
    jcfg = jreg.get_model_config(model)
    tcfg = treg.get_model_config(model)
    if model != MODEL:   # base widths are too slow here: narrow copy
        narrow = dict(hidden_size=16, intermediate_size=24,
                      num_attention_heads=2, vocab_size=50,
                      max_position_embeddings=20)
        jcfg = dataclasses.replace(jcfg, **narrow)
        tcfg = dataclasses.replace(tcfg, **narrow)
    total = treg.get_model_layers(model)
    jsc = JShardConfig(l, r, is_first=l == 1, is_last=r == total)
    want = params_from_jax(jax.device_get(jbert.init_params(jcfg, jsc, seed=3)))
    got = tbert.init_params(tcfg, _sc(l, r, total), seed=3)
    _assert_same_tree(got, want)


def test_random_npz_weights_load_as_init_params():
    """The whole-model random checkpoint loads, through the prefixed-key
    branch of `load_params`, as `init_params` of the same seed, for any
    shard."""
    weights = tbert.random_npz_weights(CFG, seed=4)
    assert any(k.startswith("bert.") for k in weights)
    assert "classifier.weight" in weights
    whole = tbert.init_params(CFG, _sc(1, TOTAL), seed=4)
    _assert_same_tree(tbert.load_params(CFG, _sc(1, TOTAL), weights), whole)
    part = tbert.load_params(CFG, _sc(3, 6), weights)
    # layers 3-6: block 0's subs 2-3, then block 1's subs 0-1
    assert torch.equal(part["head"]["mlp_up"]["w"],
                       whole["blocks"][0]["mlp_up"]["w"])
    assert torch.equal(part["tail"]["q"]["w"], whole["blocks"][1]["q"]["w"])


# --- the slice as a whole: the port's host pipeline on BERT -----------------

def _pipes(tmp_path_factory, bits, partition):
    from pipeedge_tpu.parallel.pipeline import HostPipeline as JHostPipeline
    from pipeedge_tpu.parallel.pipeline import PipelineStage as JPipelineStage
    from pipeedge_tpu_torch.parallel import pipeline as tpipe
    path = tmp_path_factory.mktemp("w") / "tiny-bert.npz"
    np.savez(path, **hf_bert_weights(CFG, seed=11, prefixed=True))
    port = tpipe.build_pipeline(MODEL, partition, model_file=str(path),
                                device="cpu", quant_bits=bits)
    stages = []
    for i, (l, r) in enumerate(partition):
        fn, params, _ = jreg.module_shard_factory(MODEL, str(path), l, r,
                                                  stage=i)
        bit = 0 if bits is None or i == len(partition) - 1 else bits[i]
        stages.append(JPipelineStage(shard_fn=fn, params=params,
                                     device=jax.devices()[0], quant_bit=bit))
    return port, JHostPipeline(stages)


def _id_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=(2, SEQ)).astype(np.int32)
            for _ in range(n)]


def test_pipeline_raw_edges_equal_single_shard_and_jax(tmp_path_factory):
    ubatches = _id_batches(3, seed=1)
    single, _ = _pipes(tmp_path_factory, None, [(1, TOTAL)])[0].run(
        [torch.from_numpy(u) for u in ubatches])
    partition = [(1, 1), (2, 5), (6, 7), (8, 8)]    # incl. tuple edges
    port, jpipe = _pipes(tmp_path_factory, None, partition)
    got, _ = port.run([torch.from_numpy(u) for u in ubatches])
    want, _ = jpipe.run([jnp.asarray(u) for u in ubatches])
    for s, g, w in zip(single, got, want):
        assert torch.equal(g, s)
        _close(g, w)


# As tests/test_torch_pipeline.py: stage outputs of the two packages differ
# in the last bits, so a value on a codec rounding boundary may land one
# level apart; the bound is a tenth of the logits' own quantization error
# (JAX quantized vs JAX exact), plus f32 noise.
@pytest.mark.parametrize("bit", [4, 8])
def test_quantized_pipeline_logits_near_jax(tmp_path_factory, bit):
    ubatches = _id_batches(2, seed=2)
    _, jexact = _pipes(tmp_path_factory, None, [(1, TOTAL)])
    exact, _ = jexact.run([jnp.asarray(u) for u in ubatches])
    port, jpipe = _pipes(tmp_path_factory, [bit, 0], [(1, 4), (5, TOTAL)])
    want, _ = jpipe.run([jnp.asarray(u) for u in ubatches])
    got, _ = port.run([torch.from_numpy(u) for u in ubatches])
    for e, w, g in zip(exact, want, got):
        e, w, g = np.asarray(e), np.asarray(w), g.numpy()
        quant_err = np.max(np.abs(w - e))
        assert quant_err > 0
        assert np.max(np.abs(g - w)) <= 0.1 * quant_err + 1e-5
