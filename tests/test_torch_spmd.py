"""The port's SPMD pipeline against the JAX package.

`pipeedge_tpu_torch/parallel/spmd.py` drives a `(dp, stage[, tp|sp])`
mesh from one process on `[cpu] * n`; the JAX `build_spmd_pipeline` is
one `shard_map` program over the conftest's 8 CPU devices. Both read one
set of weights (seeded numpy arrays in each family's checkpoint keys,
through each package's `load_params`) and one seeded input. The cases
are those of `tests/test_spmd.py` (ViT, BERT, GPT-2 with tp and causal
sp ring), the MoE GPT-2 under dp (`tests/test_moe_family.py`) and the
SPMD half of the Llama tp case (`tests/test_llama.py`), at their tiny
configs and input seeds:

- exact cases are held to the JAX single-shard oracle (`make_shard_fn`
  over the whole model) at the JAX tests' rtol=2e-4, atol=2e-5 (2e-4 for
  GPT-2 and Llama, as there): `tests/test_spmd.py` is marked slow, so no
  JAX SPMD program runs for them;
- where quantization makes that oracle differ (uniform 8-bit edges, the
  mixed [8, 4, 0, 0] and [16, 0, 16, 0] edges, tp at --tp-quant-bits 8)
  the port is held to the JAX SPMD program (four compiles), within the
  tolerance each case states;
- the errors are the JAX package's, word for word; `-r [3, 1]` equals
  the identity order; a run is M x n stage-steps (valid ticks only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import bert as jbert
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import llama as jllama
from pipeedge_tpu.models import vit as jvit
from pipeedge_tpu.models.layers import TransformerConfig as JCfg
from pipeedge_tpu.models.registry import get_model_config as jmodel_config
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu.parallel import spmd as jspmd
from pipeedge_tpu.parallel import tensor as jtensor
from pipeedge_tpu_torch.models import ShardConfig as TShardConfig
from pipeedge_tpu_torch.models import bert as tbert
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import llama as tllama
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.models.layers import TransformerConfig as TCfg
from pipeedge_tpu_torch.models.registry import (
    get_model_config as tmodel_config)
from pipeedge_tpu_torch.parallel import mesh as tmesh
from pipeedge_tpu_torch.parallel import spmd as tspmd
from pipeedge_tpu_torch.parallel import tensor as ttensor

RTOL, ATOL = 2e-4, 2e-5
TINY4 = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
             intermediate_size=64)
VIT = dict(model_type="vit", **TINY4, num_labels=5, image_size=16,
           patch_size=4)
BERT = dict(model_type="bert", **TINY4, num_labels=3, vocab_size=100,
            max_position_embeddings=64)
GPT2 = dict(model_type="gpt2", **TINY4, layer_norm_eps=1e-5, vocab_size=100,
            max_position_embeddings=64)
MODULES = {"vit": (jvit, tvit), "bert": (jbert, tbert),
           "gpt2": (jgpt2, tgpt2), "llama": (jllama, tllama)}


def _llama_weights(cfg, seed=11):
    """A whole tiny Llama in the HF `LlamaForCausalLM` keys (untied head),
    seeded numpy."""
    rng = np.random.default_rng(seed)
    d, it, kv = cfg.hidden_size, cfg.intermediate_size, \
        cfg.kv_heads * cfg.head_dim

    def r(*shape, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"model.embed_tokens.weight": r(cfg.vocab_size, d),
          "model.norm.weight": r(d, mean=1.0),
          "lm_head.weight": r(cfg.vocab_size, d)}
    for i in range(cfg.num_hidden_layers):
        root = f"model.layers.{i}."
        sd[root + "input_layernorm.weight"] = r(d, mean=1.0)
        sd[root + "post_attention_layernorm.weight"] = r(d, mean=1.0)
        for name, n_out in (("q", d), ("k", kv), ("v", kv), ("o", d)):
            sd[root + f"self_attn.{name}_proj.weight"] = r(n_out, d)
        sd[root + "mlp.gate_proj.weight"] = r(it, d)
        sd[root + "mlp.up_proj.weight"] = r(it, d)
        sd[root + "mlp.down_proj.weight"] = r(d, it)
    return sd


@dataclasses.dataclass
class Model:
    """One tiny model in both packages, with its weights."""
    family: str
    jcfg: JCfg
    tcfg: TCfg
    weights: dict

    @property
    def mods(self):
        return MODULES[self.family]

    def _sc(self, pkg_cfg, l, r):
        total = 4 * self.tcfg.num_hidden_layers
        return pkg_cfg(l, r, is_first=l == 1, is_last=r == total)

    def tstages(self, partition):
        return [self.mods[1].load_params(
            self.tcfg, self._sc(TShardConfig, l, r), self.weights)
            for l, r in partition]

    def jstages(self, partition):
        return [self.mods[0].load_params(
            self.jcfg, self._sc(JShardConfig, l, r), self.weights)
            for l, r in partition]

    def oracle(self, inputs, split=1):
        """The JAX single-shard forward of every microbatch, each routed
        in `split` row groups (the dp shards' own routing)."""
        total = 4 * self.tcfg.num_hidden_layers
        sc = self._sc(JShardConfig, 1, total)
        params = self.mods[0].load_params(self.jcfg, sc, self.weights)
        fn = make_shard_fn(self.mods[0].FAMILY, self.jcfg, sc)
        return np.stack([np.concatenate([
            np.asarray(fn(params, jnp.asarray(part)))
            for part in np.split(u, split)]) for u in inputs])

    def port(self, partition, inputs, quant_bit=0, sp_kind="ring",
             **axes):
        mesh = tspmd.make_pipeline_mesh(len(partition), device="cpu",
                                        **axes)
        pipe = tspmd.build_spmd_pipeline(
            self.mods[1].FAMILY, self.tcfg, partition,
            self.tstages(partition), mesh, quant_bit=quant_bit,
            sp_kind=sp_kind)
        return pipe, pipe.run(torch.from_numpy(inputs)).numpy()

    def jax_spmd(self, partition, inputs, quant_bit=0, **axes):
        mesh = jspmd.make_pipeline_mesh(len(partition), **axes)
        pipe = jspmd.build_spmd_pipeline(
            self.mods[0].FAMILY, self.jcfg, partition,
            self.jstages(partition), mesh, quant_bit=quant_bit)
        return np.asarray(pipe.run(jnp.asarray(inputs)))


def _model(family, fields, weights):
    return Model(family, JCfg(**fields), TCfg(**fields), weights)


@pytest.fixture(scope="module")
def vit4():
    return _model("vit", VIT, tvit.random_npz_weights(TCfg(**VIT), seed=0))


@pytest.fixture(scope="module")
def bert4():
    return _model("bert", BERT,
                  tbert.random_npz_weights(TCfg(**BERT), seed=3))


@pytest.fixture(scope="module")
def gpt2_4():
    return _model("gpt2", GPT2,
                  tgpt2.random_npz_weights(TCfg(**GPT2), seed=5))


def _registry_model(family, name, weights_fn):
    jcfg, tcfg = jmodel_config(name), tmodel_config(name)
    return Model(family, jcfg, tcfg, weights_fn(tcfg))


@pytest.fixture(scope="module")
def llama():
    return _registry_model("llama", "pipeedge/test-tiny-llama",
                           _llama_weights)


@pytest.fixture(scope="module")
def moe():
    return _registry_model("gpt2", "pipeedge/test-tiny-moe",
                           lambda cfg: jgpt2.moe_state_dict(cfg, seed=3))


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ids(seed, shape, vocab=100):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def test_partition_to_blocks_validates():
    assert tspmd.partition_to_blocks([(1, 8), (9, 16)]) == [(0, 1), (2, 3)]
    with pytest.raises(ValueError) as want:
        jspmd.partition_to_blocks([(1, 6), (7, 16)])
    with pytest.raises(ValueError) as got:
        tspmd.partition_to_blocks([(1, 6), (7, 16)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("partition", [
    [(1, 4), (5, 8), (9, 12), (13, 16)],   # even 4-stage
    [(1, 8), (9, 12), (13, 16)],           # uneven: 2+1+1 blocks
    [(1, 16)],                             # single stage degenerate
])
def test_spmd_matches_single_shard(vit4, partition):
    inputs = _images(0, (6, 2, 3, 16, 16))
    _, got = vit4.port(partition, inputs)
    np.testing.assert_allclose(got, vit4.oracle(inputs), rtol=RTOL,
                               atol=ATOL)


def test_spmd_dp_stage_mesh(vit4):
    mesh = tspmd.make_pipeline_mesh(4, dp=2, device="cpu")
    assert mesh.shape == {"dp": 2, "stage": 4}
    inputs = _images(1, (5, 4, 3, 16, 16))
    _, got = vit4.port([(1, 4), (5, 8), (9, 12), (13, 16)], inputs, dp=2)
    np.testing.assert_allclose(got, vit4.oracle(inputs), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("axes", [
    dict(n_stages=4, dp=2), dict(n_stages=2, dp=2, tp=2),
    dict(n_stages=2, dp=2, sp=2), dict(n_stages=3, sp=2)])
def test_pipeline_mesh_lays_devices_out_as_jax(axes):
    """Logical position k of the port's mesh is device k of the JAX mesh,
    axis for axis; cell (d, s) holds the inner shards of that row."""
    jm = jspmd.make_pipeline_mesh(devices=jax.devices(), **axes)
    tm = tspmd.make_pipeline_mesh(devices=tmesh.devices_for(8, "cpu"),
                                  **axes)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.positions == [d.id for d in jm.devices.flat]
    inner = tm.inner
    for d in range(tm.dp):
        for s in range(tm.n_stages):
            assert tm.cell(d, s).size == inner


def test_spmd_quantized_edges(vit4):
    """Uniform 8-bit edges, against the JAX SPMD program. Both encode
    the same activations to within float round-off, so a code can move
    by one step where a value sits at a rounding boundary: a step is
    range / 255 of an item, so the logits may differ by about one step's
    effect, held at 2e-3 of max |logit| (measured: 5.5e-7)."""
    partition = [(1, 8), (9, 16)]
    inputs = _images(2, (3, 2, 3, 16, 16))
    pipe, exact = vit4.port(partition, inputs)
    pipe.stage_bits = (8, 0)
    assert pipe.quant_bit == 8
    q8 = pipe.run(torch.from_numpy(inputs)).numpy()
    assert np.max(np.abs(q8 - exact)) < np.max(np.abs(exact)) * 0.5
    assert not np.allclose(q8, exact)  # quantization actually happened
    want = vit4.jax_spmd(partition, inputs, quant_bit=8)
    np.testing.assert_allclose(q8, want, rtol=0,
                               atol=2e-3 * np.max(np.abs(want)))


def test_spmd_per_stage_quant_bits(vit4):
    """Mixed per-stage edge bits, each edge its own payload: against the
    JAX SPMD program's padded wire buffer at [8, 4, 0, 0] and [16, 0, 16,
    0], at 2e-3 of max |logit| (one code step's effect, as above;
    measured 5.7e-7 and 8.6e-5), and the JAX test's own bounds against the
    exact pipeline."""
    partition = [(1, 4), (5, 8), (9, 12), (13, 16)]
    inputs = _images(5, (5, 2, 3, 16, 16))
    _, exact = vit4.port(partition, inputs)
    pipe, mixed = vit4.port(partition, inputs, quant_bit=[8, 4, 0, 0])
    assert pipe.stage_bits == (8, 4, 0, 0)
    assert pipe.quant_bit == 0
    assert mixed.shape == exact.shape
    assert not np.allclose(mixed, exact)
    assert np.max(np.abs(mixed - exact)) < np.max(np.abs(exact))
    want = vit4.jax_spmd(partition, inputs, quant_bit=[8, 4, 0, 0])
    np.testing.assert_allclose(mixed, want, rtol=0,
                               atol=2e-3 * np.max(np.abs(want)))
    _, m16 = vit4.port(partition, inputs, quant_bit=[16, 0, 16, 0])
    np.testing.assert_allclose(m16, exact, rtol=0.05, atol=0.05)
    want16 = vit4.jax_spmd(partition, inputs, quant_bit=[16, 0, 16, 0])
    np.testing.assert_allclose(m16, want16, rtol=0,
                               atol=2e-3 * np.max(np.abs(want16)))


def test_spmd_stage_ranks_mesh(vit4):
    """-r rank order: stages at the listed logical devices, the same
    outputs as the identity order and the oracle; JAX's errors."""
    partition = [(1, 8), (9, 16)]
    devices = tmesh.devices_for(8, "cpu")
    mesh = tspmd.make_pipeline_mesh(2, devices=devices, stage_ranks=[3, 1])
    assert mesh.positions == [3, 1]
    assert mesh.shape == {"dp": 1, "stage": 2}
    pipe = tspmd.build_spmd_pipeline(tvit.FAMILY, vit4.tcfg, partition,
                                     vit4.tstages(partition), mesh)
    inputs = _images(6, (4, 2, 3, 16, 16))
    got = pipe.run(torch.from_numpy(inputs)).numpy()
    _, identity = vit4.port(partition, inputs)
    np.testing.assert_array_equal(got, identity)
    np.testing.assert_allclose(got, vit4.oracle(inputs), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(stage_ranks=[1, 1]), dict(dp=2, stage_ranks=[0, 1]),
    dict(stage_ranks=[0, 9]), dict(stage_ranks=[0]),
    dict(tp=2, sp=2), dict(dp=2, tp=4)])
def test_mesh_errors_are_jax_s(kwargs):
    with pytest.raises(ValueError) as want:
        jspmd.make_pipeline_mesh(2, devices=jax.devices(), **kwargs)
    with pytest.raises(ValueError) as got:
        tspmd.make_pipeline_mesh(2, devices=tmesh.devices_for(8, "cpu"),
                                 **kwargs)
    assert str(got.value) == str(want.value)


def test_spmd_bert(bert4):
    ids = _ids(4, (4, 2, 9))
    _, got = bert4.port([(1, 8), (9, 16)], ids)
    np.testing.assert_allclose(got, bert4.oracle(ids), rtol=RTOL, atol=ATOL)


def test_spmd_dp_stage_tp_mesh(vit4):
    """pp x dp x tp: blocks stage- and Megatron tp-sharded (two
    all-reduces a block), batch dp-sharded; exact edges at the oracle's
    tolerance, 8-bit edges at the JAX test's (0.1, 0.05)."""
    partition = [(1, 8), (9, 16)]
    inputs = _images(6, (4, 4, 3, 16, 16))
    expected = vit4.oracle(inputs)
    pipe, got = vit4.port(partition, inputs, quant_bit=8, dp=2, tp=2)
    assert pipe.mesh.shape == {"dp": 2, "stage": 2, "tp": 2}
    np.testing.assert_allclose(got, expected, rtol=0.1, atol=0.05)
    _, got_raw = vit4.port(partition, inputs, dp=2, tp=2)
    np.testing.assert_allclose(got_raw, expected, rtol=RTOL, atol=ATOL)


def test_spmd_tp_quantized_collectives(vit4):
    """tp at --tp-quant-bits 8 (every block's two all-reduces the 8-bit
    `qpsum` ring) against the JAX SPMD program at the same bits. A
    decode's 1-2 ulp against XLA can move a later hop's code by one step
    (`tests/test_torch_qcollectives.py`), so the logits are held at 2e-3
    of max |logit|, one code step's effect (measured: 4.2e-7); both within
    0.05 of the exact pipeline."""
    partition = [(1, 8), (9, 16)]
    inputs = _images(6, (2, 4, 3, 16, 16))
    _, exact = vit4.port(partition, inputs, dp=2, tp=2)
    ttensor.set_tp_quant_bits(8)
    jtensor.set_tp_quant_bits(8)
    try:
        _, got = vit4.port(partition, inputs, dp=2, tp=2)
        want = vit4.jax_spmd(partition, inputs, dp=2, tp=2)
    finally:
        ttensor.set_tp_quant_bits(0)
        jtensor.set_tp_quant_bits(0)
    assert not np.array_equal(got, exact)
    np.testing.assert_allclose(got, exact, rtol=0, atol=0.05)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-3 * np.max(np.abs(want)))


def test_spmd_bert_tp(bert4):
    ids = _ids(4, (4, 2, 9))
    _, got = bert4.port([(1, 8), (9, 16)], ids, dp=2, tp=2)
    np.testing.assert_allclose(got, bert4.oracle(ids), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sp_kind", ["ring", "ulysses"])
def test_spmd_dp_stage_sp_mesh(bert4, sp_kind):
    """pp x dp x sp: activations sequence-sharded within each stage (the
    edges carry the local chunks), the exact sp core per block, the last
    stage gathering for the pooler. S = 12 divides sp = 2."""
    ids = _ids(7 if sp_kind == "ring" else 9, (4 if sp_kind == "ring" else 3,
                                               4, 12))
    pipe, got = bert4.port([(1, 8), (9, 16)], ids, sp_kind=sp_kind, dp=2,
                           sp=2)
    assert pipe.mesh.shape == {"dp": 2, "stage": 2, "sp": 2}
    np.testing.assert_allclose(got, bert4.oracle(ids), rtol=RTOL, atol=ATOL)


def test_spmd_gpt2_sp_causal_ring(gpt2_4):
    ids = _ids(11, (3, 4, 12))
    _, got = gpt2_4.port([(1, 8), (9, 16)], ids, dp=2, sp=2)
    np.testing.assert_allclose(got, gpt2_4.oracle(ids), rtol=2e-4,
                               atol=2e-4)


def test_spmd_gpt2_tp(gpt2_4):
    ids = _ids(12, (4, 2, 9))
    _, got = gpt2_4.port([(1, 8), (9, 16)], ids, dp=2, tp=2)
    np.testing.assert_allclose(got, gpt2_4.oracle(ids), rtol=2e-4,
                               atol=2e-4)


def test_spmd_sp_seq_divisibility_error(vit4):
    """ViT: S = 17 tokens, indivisible by sp = 2: the JAX message."""
    partition = [(1, 8), (9, 16)]
    inputs = np.zeros((3, 2, 3, 16, 16), np.float32)
    jpipe = jspmd.build_spmd_pipeline(
        jvit.FAMILY, vit4.jcfg, partition, vit4.jstages(partition),
        jspmd.make_pipeline_mesh(2, sp=2))
    with pytest.raises(ValueError, match="sequence length 17") as want:
        jpipe.run(jnp.asarray(inputs))
    with pytest.raises(ValueError) as got:
        vit4.port(partition, inputs, sp=2)
    assert str(got.value) == str(want.value)


def test_moe_spmd_pipeline(moe):
    """MoE blocks under pp x dp: each dp cell routes its own tokens, so
    the oracle routes each half-batch on its own; tp and sp are refused
    with the JAX words."""
    partition = [(1, 4), (5, 8)]
    ids = _ids(8, (3, 4, 8))
    _, got = moe.port(partition, ids, dp=2)
    np.testing.assert_allclose(got, moe.oracle(ids, split=2), rtol=2e-4,
                               atol=2e-4)
    for axes in (dict(tp=2), dict(sp=2)):
        with pytest.raises(NotImplementedError) as want:
            jspmd.build_spmd_pipeline(
                jgpt2.FAMILY, moe.jcfg, partition, moe.jstages(partition),
                jspmd.make_pipeline_mesh(2, **axes))
        with pytest.raises(NotImplementedError) as got:
            moe.port(partition, ids, **axes)
        assert str(got.value) == str(want.value)


def test_llama_spmd_tp_pipeline(llama):
    """The SPMD half of the JAX Llama tp case: pp x tp (GQA kv heads
    split, one kv head per shard) against the single-shard forward."""
    ids = _ids(15, (3, 2, 9), llama.tcfg.vocab_size)
    _, got = llama.port([(1, 4), (5, 8)], ids, tp=2)
    np.testing.assert_allclose(got, llama.oracle(ids), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sp_kind", ["ring", "ulysses"])
def test_llama_spmd_sp_pipeline(llama, sp_kind):
    """Llama under sp, which the JAX SPMD program refuses (its attention
    hook cannot rotate at global positions): the port's `sp_block_step`
    rotates each chunk at its global positions before the core, so the
    pipeline equals the single-shard forward."""
    ids = _ids(16, (3, 2, 12), llama.tcfg.vocab_size)
    _, got = llama.port([(1, 4), (5, 8)], ids, sp_kind=sp_kind, sp=2)
    np.testing.assert_allclose(got, llama.oracle(ids), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("partition,n_mesh,axes,bits", [
    ([(1, 6), (7, 16)], 2, {}, 0),
    ([(1, 16)], 1, dict(tp=8), 0),
    ([(1, 8), (9, 16)], 2, {}, [8, 0, 0]),
    ([(1, 8), (9, 16)], 3, {}, 0),
], ids=["midblock", "tp_heads", "bits_length", "stage_axis"])
def test_build_errors_are_jax_s(vit4, partition, n_mesh, axes, bits):
    with pytest.raises(ValueError) as want:
        jspmd.build_spmd_pipeline(
            jvit.FAMILY, vit4.jcfg, partition, vit4.jstages(partition),
            jspmd.make_pipeline_mesh(n_mesh, **axes), quant_bit=bits)
    with pytest.raises(ValueError) as got:
        tspmd.build_spmd_pipeline(
            tvit.FAMILY, vit4.tcfg, partition, vit4.tstages(partition),
            tspmd.make_pipeline_mesh(n_mesh, device="cpu", **axes),
            quant_bit=bits)
    assert str(got.value) == str(want.value)


def test_run_is_the_valid_stage_steps(vit4):
    """A run of M microbatches through n stages is M x n stage-steps:
    every block runs once per microbatch (no fill or drain tick on
    garbage), and `forward(params, inputs)` is `run` on explicit
    parameters."""
    calls = []

    def counting(p, sub, data, cfg):
        calls.append(sub)
        return tvit.sublayer(p, sub, data, cfg)

    partition = [(1, 4), (5, 8), (9, 16)]
    family = dataclasses.replace(tvit.FAMILY, sublayer=counting)
    pipe = tspmd.build_spmd_pipeline(
        family, vit4.tcfg, partition, vit4.tstages(partition),
        tspmd.make_pipeline_mesh(3, device="cpu"))
    inputs = torch.from_numpy(_images(3, (5, 2, 3, 16, 16)))
    out = pipe.run(inputs)
    assert len(calls) == 5 * 4 * vit4.tcfg.num_hidden_layers
    with torch.no_grad():
        again = pipe.forward(pipe.params, inputs)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
