"""The port's Megatron tensor parallelism against the JAX package.

`pipeedge_tpu_torch/parallel/tensor.py` runs a block over a shard group
(`parallel/mesh.py ShardGroup`) on `[cpu] * n`; the JAX
`make_tp_block_fn` runs the same block under `shard_map` on n of the
conftest's 8 CPU devices. Both get one set of weights (JAX `init_params`
from a numpy seed, converted by `models/convert.py`) and one seeded
input:

- ViT, BERT, GPT-2 (causal) and Llama (GQA) at tp 2, 4 and 8 match the
  JAX block at rtol=2e-4, atol=2e-5, the JAX test's tolerance against the
  unsharded block (`tests/test_tensor_parallel.py`): row-parallel partial
  products are summed across shards, in another order than one matmul
  sums them, and the port's attention core is its own kernel's plain
  version where JAX uses einsums. They also match the port's unsharded
  block at that tolerance, and every shard holds the same output (the
  exact all-reduce gives each shard one sum);
- the split rules place 1/n of each column/row kernel on each shard;
- MoE configs are refused with the JAX words; the shard group's ring and
  collectives keep shard order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import bert as jbert
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import llama as jllama
from pipeedge_tpu.models import vit as jvit
from pipeedge_tpu.models.layers import TransformerConfig as JCfg
from pipeedge_tpu.parallel import tensor as jtp
from pipeedge_tpu_torch.models import bert as tbert
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import llama as tllama
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.layers import TransformerConfig as TCfg
from pipeedge_tpu_torch.parallel import mesh as tmesh
from pipeedge_tpu_torch.parallel import tensor as ttp

RTOL, ATOL = 2e-4, 2e-5
HIDDEN = 128

# family -> (JAX module, port module, config fields beyond the common ones)
FAMILIES = {
    "vit": (jvit, tvit, {}),
    "bert": (jbert, tbert, {"vocab_size": 50,
                            "max_position_embeddings": 64}),
    "gpt2": (jgpt2, tgpt2, {"vocab_size": 50, "max_position_embeddings": 64,
                            "layer_norm_eps": 1e-5}),
    # 16 query heads over 8 kv heads: GQA at every tp degree up to 8
    "llama": (jllama, tllama, {"num_attention_heads": 16, "num_kv_heads": 8,
                               "vocab_size": 50,
                               "max_position_embeddings": 64,
                               "layer_norm_eps": 1e-5}),
}


def _cfgs(family):
    fields = dict(model_type=family, hidden_size=HIDDEN, num_hidden_layers=1,
                  num_attention_heads=8, intermediate_size=256)
    fields.update(FAMILIES[family][2])
    return JCfg(**fields), TCfg(**fields)


def _block(family, seed=3):
    """(JAX block params, port block params) of one seeded block."""
    jcfg, _ = _cfgs(family)
    params = FAMILIES[family][0].init_params(jcfg, JShardConfig(1, 4),
                                             seed=seed)
    jblock = jax.tree_util.tree_map(lambda x: x[0], params["blocks"])
    tblock = params_from_jax(
        {"blocks": jax.device_get(params["blocks"])})["blocks"][0]
    return jblock, tblock


def _x(seed=0, s=9):
    return np.random.default_rng(seed).normal(
        size=(2, s, HIDDEN)).astype(np.float32)


def _group(n):
    return tmesh.ShardGroup(tmesh.devices_for(n, "cpu"))


def _unsharded(family, tblock, x):
    _, tcfg = _cfgs(family)
    data = torch.from_numpy(x)
    with torch.inference_mode():
        for sub in range(4):
            data = FAMILIES[family][1].sublayer(tblock, sub, data, tcfg)
    return data.numpy()


@pytest.mark.parametrize("n_tp", [2, 4, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_block_matches_jax(family, n_tp):
    jcfg, tcfg = _cfgs(family)
    jblock, tblock = _block(family)
    x = _x()
    mesh = Mesh(np.asarray(jax.devices()[:n_tp]), ("tp",))
    want = np.asarray(jtp.make_tp_block_fn(jcfg, mesh)(
        jtp.shard_block_params(jcfg, jblock, mesh), jnp.asarray(x)))
    group = _group(n_tp)
    got = ttp.make_tp_block_fn(tcfg, group)(
        ttp.shard_block_params(tcfg, tblock, group),
        group.replicate(torch.from_numpy(x)))
    assert len(got) == n_tp
    for shard in got[1:]:
        assert torch.equal(shard, got[0])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), _unsharded(family, tblock, x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family,n_tp,shapes", [
    ("vit", 4, {("q", "w"): (HIDDEN, 32), ("q", "b"): (32,),
                ("attn_out", "w"): (32, HIDDEN), ("attn_out", "b"): (HIDDEN,),
                ("mlp_up", "w"): (HIDDEN, 64), ("mlp_down", "w"): (64, HIDDEN),
                ("ln_before", "scale"): (HIDDEN,)}),
    ("llama", 8, {("k", "w"): (HIDDEN, 8), ("mlp_gate", "w"): (HIDDEN, 32),
                  ("mlp_down", "w"): (32, HIDDEN),
                  ("ln_after", "scale"): (HIDDEN,)}),
])
def test_tp_params_are_actually_sharded(family, n_tp, shapes):
    _, tcfg = _cfgs(family)
    _, tblock = _block(family)
    shards = ttp.shard_block_params(tcfg, tblock, _group(n_tp))
    for (name, leaf), shape in shapes.items():
        assert {tuple(s[name][leaf].shape) for s in shards} == {shape}
    # the column slices tile the unsharded kernel in shard order
    torch.testing.assert_close(
        torch.cat([s["q"]["w"] for s in shards], dim=1), tblock["q"]["w"],
        rtol=0, atol=0)
    # a split is its own storage, so the unsharded block can be freed
    assert shards[0]["q"]["w"].data_ptr() != tblock["q"]["w"].data_ptr()


def test_family_tp_plan_refuses_moe_in_the_jax_words():
    fields = dict(model_type="gpt2", hidden_size=32, num_hidden_layers=1,
                  num_attention_heads=4, intermediate_size=64, n_experts=4)
    with pytest.raises(NotImplementedError) as want:
        jtp.family_tp_plan(JCfg(**fields))
    with pytest.raises(NotImplementedError) as got:
        ttp.family_tp_plan(TCfg(**fields))
    assert str(got.value) == str(want.value)
    # the tp x ep plan: the dense family's attention table and activation
    specs, act = ttp.family_tp_ep_plan(TCfg(**fields))
    assert specs is ttp._VIT_PARAM_SPECS and act.__name__ == "gelu_new"
    with pytest.raises(ValueError) as got:
        ttp.family_tp_ep_plan(TCfg(**dict(fields, n_experts=0)))
    with pytest.raises(ValueError) as want:
        jtp.family_tp_ep_plan(JCfg(**dict(fields, n_experts=0)))
    assert str(got.value) == str(want.value)


def test_shard_group_ring_and_collectives_keep_shard_order():
    group = _group(4)
    xs = [torch.full((3,), float(i)) for i in range(4)]
    # ppermute perm [(i, i+1 mod n)]: shard j receives shard j-1's value
    assert [int(t[0]) for t in group.ring_forward(xs)] == [3, 0, 1, 2]
    assert group.axis_size("tp") == 4
    with pytest.raises(ValueError):
        group.axis_size("sp")
    summed = group.psum([torch.tensor([0.1]), torch.tensor([0.2]),
                         torch.tensor([0.3]), torch.tensor([0.4])])
    want = ((torch.tensor([0.1]) + 0.2) + 0.3) + 0.4
    assert all(torch.equal(s, want) for s in summed)
    tiled = group.all_gather(xs, dim=0)
    assert tiled[2].tolist() == [0.0] * 3 + [1.0] * 3 + [2.0] * 3 + [3.0] * 3
    stacked = group.all_gather(xs, dim=0, tiled=False)
    assert stacked[1].shape == (4, 3)
    assert [d.type for d in tmesh.devices_for(3, "cpu")] == ["cpu"] * 3
    with pytest.raises(ValueError):
        tmesh.devices_for(0, "cpu")


def test_tp_bits_gate_roundtrip_and_rejects_other_widths():
    assert ttp.get_tp_quant_bits() == 0
    ttp.set_tp_quant_bits(8)
    try:
        assert ttp.get_tp_quant_bits() == 8
    finally:
        ttp.set_tp_quant_bits(0)
    with pytest.raises(ValueError) as got:
        ttp.set_tp_quant_bits(3)
    with pytest.raises(ValueError) as want:
        jtp.set_tp_quant_bits(3)
    assert str(got.value) == str(want.value)


def test_tp_block_bf16_close_to_f32():
    """A bf16 block over the group stays within bf16 rounding of the f32
    one (the partial products accumulate in f32, as JAX's do)."""
    _, tcfg = _cfgs("vit")
    _, tblock = _block("vit")
    group = _group(2)
    x = torch.from_numpy(_x())
    fn = ttp.make_tp_block_fn(tcfg, group)
    f32 = fn(ttp.shard_block_params(tcfg, tblock, group), group.replicate(x))
    bf = {k: {kk: v.to(torch.bfloat16) for kk, v in d.items()}
          for k, d in tblock.items()}
    b16 = fn(ttp.shard_block_params(tcfg, bf, group),
             group.replicate(x.to(torch.bfloat16)))
    assert b16[0].dtype == torch.bfloat16
    scale = float(f32[0].abs().max())
    assert float((b16[0].float() - f32[0]).abs().max()) < 0.05 * scale


def test_tp_cfg_fields_are_the_jax_ones():
    """The port's config is the JAX one field for field, so each family's
    tp body reads the same hyperparameters."""
    assert [f.name for f in dataclasses.fields(TCfg)] == \
        [f.name for f in dataclasses.fields(JCfg)]
