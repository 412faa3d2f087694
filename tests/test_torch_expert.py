"""Expert parallelism and the collectives it rides on, against the JAX
package.

The cases of `tests/test_expert.py` on the port: the switch FFN with its
experts split over an ep `ShardGroup` of 2 and 4 CPU shards equals the
routing oracle (`reference_moe_ffn`) and the JAX `make_ep_ffn_fn` (on
the conftest's CPU devices) within rtol=1e-5, atol=1e-6, the JAX test's
tolerance; capacity overflow drops to the residual; the divisibility
refusal is JAX's word for word; an oversized capacity clamps. Beside
them: `ep_ffn_delta` against the single-device `moe_ffn_delta`, the
`shard_moe_params` layout (router shared, experts sliced), and the mesh
pieces the axes need (`ShardGroup.all_to_all` against JAX's tiled
`lax.all_to_all`, the `ShardGrid` layout).

The params come from `init_moe_params`, the same numpy stream in both
packages. Seeds are chosen without gate ties: `torch` and `lax` may break
a tie between two experts' probabilities differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipeedge_tpu.models.layers import TransformerConfig as JCfg
from pipeedge_tpu.models.layers import gelu as jgelu
from pipeedge_tpu.parallel import expert as jexpert
from pipeedge_tpu.utils import jax_compat
from pipeedge_tpu_torch.models.layers import TransformerConfig as TCfg
from pipeedge_tpu_torch.models.layers import gelu, gelu_new
from pipeedge_tpu_torch.parallel import expert as texpert
from pipeedge_tpu_torch.parallel.mesh import ShardGrid, ShardGroup, devices_for

FIELDS = dict(model_type="vit", hidden_size=32, num_hidden_layers=1,
              num_attention_heads=4, intermediate_size=64, num_labels=0,
              image_size=16, patch_size=4)
JCFG, TCFG = JCfg(**FIELDS), TCfg(**FIELDS)
RTOL, ATOL = 1e-5, 1e-6


def _group(n):
    return ShardGroup(devices_for(n, "cpu"), "ep")


def _jax_ep(n, params, x, n_experts, cf):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("ep",))
    fn = jexpert.make_ep_ffn_fn(JCFG, mesh, n_experts, capacity_factor=cf,
                                act=jgelu)
    return np.asarray(fn(jexpert.shard_moe_params(params, mesh),
                         jnp.asarray(x)))


def _assert_no_gate_ties(params, x):
    """Each token's best expert leads the next by more than float noise."""
    logits = torch.from_numpy(x).reshape(-1, x.shape[-1]) \
        @ params["router"]["w"] + params["router"]["b"]
    top2 = torch.softmax(logits, dim=-1).topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-5


def _port_ep(n, n_experts, seed, x, cf):
    group = _group(n)
    params = texpert.init_moe_params(TCFG, n_experts, seed=seed)
    _assert_no_gate_ties(params, x)
    fn = texpert.make_ep_ffn_fn(TCFG, group, n_experts, capacity_factor=cf,
                                act=gelu)
    got = fn(texpert.shard_moe_params(params, group), torch.from_numpy(x))
    want = texpert.reference_moe_ffn(params, torch.from_numpy(x), n_experts,
                                     capacity_factor=cf)
    return got.numpy(), want.numpy()


@pytest.mark.parametrize("n_ep", [2, 4])
def test_ep_ffn_matches_reference(n_ep):
    x = np.random.default_rng(2).normal(size=(2, 16, 32)).astype(np.float32)
    got, want = _port_ep(n_ep, 8, 1, x, 1.25)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jparams = jexpert.init_moe_params(JCFG, 8, seed=1)
    np.testing.assert_allclose(got, _jax_ep(n_ep, jparams, x, 8, 1.25),
                               rtol=RTOL, atol=ATOL)


def test_ep_capacity_drops_to_residual():
    """capacity = ceil(0.125 * 32 / 4) = 1 slot per expert: at most 4
    tokens change, every other passes through untouched."""
    x = np.random.default_rng(4).normal(size=(1, 32, 32)).astype(np.float32)
    got, want = _port_ep(2, 4, 3, x, 0.125)
    changed = (np.abs(got - x) > 1e-7).any(axis=-1).sum()
    assert 0 < changed <= 4, changed
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jparams = jexpert.init_moe_params(JCFG, 4, seed=3)
    np.testing.assert_allclose(got, _jax_ep(2, jparams, x, 4, 0.125),
                               rtol=RTOL, atol=ATOL)


def test_ep_requires_divisible_experts():
    with pytest.raises(ValueError, match="must divide") as port:
        texpert.make_ep_ffn_fn(TCFG, _group(4), n_experts=6, act=gelu)
    with pytest.raises(ValueError) as ref:
        jexpert.make_ep_ffn_fn(JCFG, Mesh(np.asarray(jax.devices()[:4]),
                                          ("ep",)), n_experts=6, act=jgelu)
    assert str(port.value) == str(ref.value)


def test_ep_capacity_clamps_to_token_count():
    """capacity_factor 8 over 2 experts asks for more slots than tokens:
    the capacity clamps to the token count."""
    x = np.random.default_rng(6).normal(size=(1, 16, 32)).astype(np.float32)
    got, want = _port_ep(2, 2, 5, x, 8.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jparams = jexpert.init_moe_params(JCFG, 2, seed=5)
    np.testing.assert_allclose(got, _jax_ep(2, jparams, x, 2, 8.0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_ep", [2, 4])
def test_ep_ffn_delta_equals_single_device(n_ep):
    """Every shard's delta equals `moe_ffn_delta`'s: the all-reduce adds
    one nonzero term per token (its expert's shard) to zeros."""
    group = _group(n_ep)
    params = texpert.init_moe_params(TCFG, 8, seed=7)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 6, 32)).astype(np.float32))
    want = texpert.moe_ffn_delta(params, x, 8, 1.25, act=gelu_new)
    got = texpert.ep_ffn_delta(group, texpert.shard_moe_params(params, group),
                               group.replicate(x), 8, 1.25, act=gelu_new)
    assert len(got) == n_ep
    for g in got:
        torch.testing.assert_close(g, want, rtol=RTOL, atol=ATOL)


def test_shard_moe_params_layout():
    """The router is whole on every shard (one tensor where shards share
    a device); shard i holds experts [2i, 2i + 2) of 8 as its own copy."""
    group = _group(4)
    params = texpert.init_moe_params(TCFG, 8, seed=0)
    shards = texpert.shard_moe_params(params, group)
    for i, sh in enumerate(shards):
        assert sh["router"]["w"] is params["router"]["w"]
        for name, leaf in sh["experts"].items():
            for k, v in leaf.items():
                whole = params["experts"][name][k]
                assert v.shape[0] == 2
                assert torch.equal(v, whole[2 * i:2 * i + 2])
                assert v.data_ptr() != whole.data_ptr()


@pytest.mark.parametrize("split,concat", [(2, 1), (1, 2)])
def test_all_to_all_matches_jax(split, concat):
    """`ShardGroup.all_to_all` is JAX's tiled `lax.all_to_all` over a
    4-device mesh: the global array, split by shard on `concat`'s axis
    going in, comes out split on `split`'s."""
    n = 4
    x = np.random.default_rng(9).normal(size=(2, 8, 8, 3)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    spec_in = P(*([None] * concat + ["sp"]))
    spec_out = P(*([None] * split + ["sp"]))
    want = np.asarray(jax.jit(jax_compat.shard_map(
        lambda v: jax.lax.all_to_all(v, "sp", split_axis=split,
                                     concat_axis=concat, tiled=True),
        mesh=mesh, in_specs=spec_in, out_specs=spec_out))(jnp.asarray(x)))
    group = ShardGroup(devices_for(n, "cpu"), "sp")
    parts = list(torch.from_numpy(x).chunk(n, dim=concat))
    got = torch.cat(group.all_to_all(parts, split, concat), dim=split)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        group.all_to_all([torch.zeros(1, 3)] * n, 1, 0)


def test_shard_grid_layout():
    """Cell (i, j) is device i * ep + j (`np.array(devices).reshape(tp,
    ep)`): ep column j's tp group holds devices j, j + ep, ...; tp row i's
    ep group devices i * ep .. i * ep + ep - 1."""
    devs = [f"cuda:{k}" for k in range(6)]
    grid = ShardGrid(devs, tp=2, ep=3)
    assert (grid.size, grid.axis_size("tp"), grid.axis_size("ep")) == (6, 2, 3)
    assert grid.cell(1, 2) == 5
    assert [str(d) for d in grid.tp_group(1).devices] == ["cuda:1", "cuda:4"]
    assert [str(d) for d in grid.ep_group(1).devices] == [
        "cuda:3", "cuda:4", "cuda:5"]
    assert (grid.tp_group(0).axis, grid.ep_group(0).axis) == ("tp", "ep")
    with pytest.raises(ValueError, match="axes"):
        grid.axis_size("sp")
    with pytest.raises(ValueError, match="needs 4 devices"):
        ShardGrid(devs, tp=2, ep=2)
