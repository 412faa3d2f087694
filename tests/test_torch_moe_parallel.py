"""Expert-parallel and tp x ep MoE decoding (`DecodePipeline(ep_mesh=,
tp_ep_mesh=)`, `generate --ep`, `--tp --ep`) against the JAX package.

`pipeedge/test-tiny-moe` (4 experts, 4 heads) in two stages, seeded
weights from the JAX `module_shard_factory` stream (converted by
`models/convert.py`), dropless (the registry's capacity_factor 4) and
capacity-bounded (1.0: tokens dropped). The port's ep shards are `[cpu]
* 2`, its tp x ep grid `[cpu] * 4` as 2 x 2; JAX runs the same meshes
on the conftest's CPU devices under `shard_map`.

- ep, fp and int8 caches: greedy tokens equal JAX's and the port's
  plain pipeline's; prefill and decode-step logits within rtol=2e-4,
  atol=2e-5 of JAX's (the ep all-reduce is exact: one nonzero term a
  token). With the int8 decode-attend opt-in every shard attends its own
  cache replica through kernel 5's wrapper (its plain version here).
- tp x ep, exact: tokens equal JAX's and plain; logits within the same
  tolerance (the tp all-reduce sums partial products across shards). At
  `set_tp_quant_bits(8)` in both packages: tokens equal JAX's, logits
  within 0.05 of max |logit| of JAX's (the qpsum codes may differ by
  one step on 1% of elements, `tests/test_torch_qcollectives.py`).
- cache layouts, the params' sharing on one device, the composition
  refusals word for word, the entries' tokens against the JAX entry's
  (`tools/generate.py`) on the same command line, and `--ep 2` with
  `--concurrent`, `--beams`, `--shared-prefix` or `--prefill-ubatch`
  equal to `--ep 1` with it.

Seeds are chosen without gate ties (`torch.topk` and `lax.top_k` may
break one differently).
"""
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.parallel import tensor as jtp
from pipeedge_tpu_torch import generate as tgenerate
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.layers import TransformerConfig
from pipeedge_tpu_torch.ops import decode_attention
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel import tensor as ttp
from pipeedge_tpu_torch.parallel.mesh import ShardGrid, ShardGroup, devices_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = "pipeedge/test-tiny-moe"
PARTITION = [(1, 4), (5, 8)]
MAX_LEN, PROMPT, NEW = 24, 6, 7
RTOL, ATOL = 2e-4, 2e-5
CAPACITY = {"dropless": 4.0, "bounded": 1.0}


@pytest.fixture(scope="module")
def jparams():
    return [jreg.module_shard_factory(MODEL, None, l, r, stage=i,
                                      unroll=False)[1]
            for i, (l, r) in enumerate(PARTITION)]


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(13).integers(0, 100, size=(3, PROMPT))


def _cfgs(cap):
    cf = CAPACITY[cap]
    return (dataclasses.replace(jreg.get_model_config(MODEL),
                                capacity_factor=cf),
            dataclasses.replace(treg.get_model_config(MODEL),
                                capacity_factor=cf))


def _jax_mesh(kind):
    devs = np.asarray(jax.devices()[:4])
    if kind == "ep":
        return {"ep_mesh": Mesh(devs[:2], ("ep",))}
    if kind == "tp_ep":
        return {"tp_ep_mesh": Mesh(devs.reshape(2, 2), ("tp", "ep"))}
    return {}


def _port_mesh(kind):
    if kind == "ep":
        return {"ep_mesh": ShardGroup(devices_for(2, "cpu"), "ep")}
    if kind == "tp_ep":
        return {"tp_ep_mesh": ShardGrid(devices_for(4, "cpu"), 2, 2)}
    return {}


def _jax_pipe(jparams, kind, cap="dropless", bits=0):
    jcfg, _ = _cfgs(cap)
    return jdec.DecodePipeline(
        jreg.get_model_entry(MODEL).family.FAMILY, jcfg, PARTITION, jparams,
        max_len=MAX_LEN, cache_bits=bits, **_jax_mesh(kind))


def _pipe(jparams, kind, cap="dropless", bits=0, optin=0):
    _, tcfg = _cfgs(cap)
    return tdec.DecodePipeline(
        treg.get_model_entry(MODEL).family.FAMILY, tcfg, PARTITION,
        [params_from_jax(jax.device_get(p)) for p in jparams],
        max_len=MAX_LEN, device="cpu", cache_bits=bits,
        int8_decode_attend=optin, **_port_mesh(kind))


def _step_logits(pipe, ids, tokens):
    """Prefill logits, then each decode step's on the given tokens."""
    data, caches = pipe._prefill(ids)
    out = [np.asarray(data)]
    for t in range(tokens.shape[1]):
        data = tokens[:, t:t + 1]
        for i, st in enumerate(pipe.stages):
            data, caches[i] = pipe._decode_step(st, data, caches[i],
                                                PROMPT + t)
        out.append(np.asarray(data))
    return out


def _assert_no_gate_ties(pipe, ids):
    """Every block's routing of the prompt has a clear best expert."""
    ties = []
    real = tdec.ep_ffn_delta

    def spy(group, ps, normed, n_experts, cf, act):
        w, b = ps[0]["router"]["w"], ps[0]["router"]["b"]
        probs = torch.softmax(normed[0].reshape(-1, w.shape[0]) @ w + b, -1)
        top2 = probs.topk(2, dim=-1).values
        ties.append(float((top2[:, 0] - top2[:, 1]).min()))
        return real(group, ps, normed, n_experts, cf, act=act)

    tdec.ep_ffn_delta = spy
    try:
        pipe._prefill(torch.from_numpy(ids))
    finally:
        tdec.ep_ffn_delta = real
    assert ties and min(ties) > 1e-5, ties


def _compare(pipe, jpipe, ids, plain, rtol=RTOL, atol=ATOL):
    want = np.asarray(jpipe.generate(ids, NEW))
    got = pipe.generate(ids, NEW).numpy()
    np.testing.assert_array_equal(got, want)
    if plain is not None:
        np.testing.assert_array_equal(got, plain.generate(ids, NEW).numpy())
    tokens = np.array(want[:, PROMPT:PROMPT + 3])
    for g, w in zip(_step_logits(pipe, torch.from_numpy(ids),
                                 torch.from_numpy(tokens)),
                    _step_logits(jpipe, ids, tokens)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("bits", [0, 8], ids=["fp", "int8"])
def test_ep_decode_matches_jax(jparams, ids, bits, cap):
    pipe = _pipe(jparams, "ep", cap, bits)
    _assert_no_gate_ties(pipe, ids)
    _compare(pipe, _jax_pipe(jparams, "ep", cap, bits), ids,
             _pipe(jparams, None, cap, bits))


def test_ep_int8_kernel_route_runs_per_shard(jparams, ids, monkeypatch):
    """With the opt-in, each ep shard's decode step attends its own cache
    replica through kernel 5's wrapper, over the whole window (ep steps
    take no bucket); the tokens equal the dequantize route's."""
    calls = []
    real = decode_attention.int8_decode_attention

    def spy(q, k, *args, **kw):
        calls.append((q.shape[2], k.shape[1]))
        return real(q, k, *args, **kw)

    monkeypatch.setattr(decode_attention, "int8_decode_attention", spy)
    got = _pipe(jparams, "ep", bits=8, optin=1).generate(ids, NEW)
    cfg = treg.get_model_config(MODEL)
    # 2 shards x the model's blocks x the decode steps
    assert calls == [(cfg.num_attention_heads, MAX_LEN)] * (
        2 * cfg.num_hidden_layers * (NEW - 1))
    assert torch.equal(got, _pipe(jparams, "ep", bits=8).generate(ids, NEW))


@pytest.mark.parametrize("cap", sorted(CAPACITY))
def test_tp_ep_decode_matches_jax(jparams, ids, cap):
    pipe = _pipe(jparams, "tp_ep", cap)
    _assert_no_gate_ties(pipe, ids)
    _compare(pipe, _jax_pipe(jparams, "tp_ep", cap), ids,
             _pipe(jparams, None, cap))


def test_tp_ep_quantized_matches_jax(jparams, ids):
    """At 8 quantized bits in both packages: tokens equal JAX's, logits
    within 0.05 of max |logit|; the knob really moves the logits."""
    exact = _step_logits(_pipe(jparams, "tp_ep"), torch.from_numpy(ids),
                         torch.zeros((3, 2), dtype=torch.long))
    ttp.set_tp_quant_bits(8)
    jtp.set_tp_quant_bits(8)
    try:
        pipe, jpipe = _pipe(jparams, "tp_ep"), _jax_pipe(jparams, "tp_ep")
        got = pipe.generate(ids, NEW).numpy()
        np.testing.assert_array_equal(got, np.asarray(jpipe.generate(ids,
                                                                     NEW)))
        tokens = np.zeros((3, 2), dtype=np.int64)
        quant = _step_logits(pipe, torch.from_numpy(ids),
                             torch.from_numpy(tokens))
        ref = _step_logits(jpipe, ids, tokens)
    finally:
        ttp.set_tp_quant_bits(0)
        jtp.set_tp_quant_bits(0)
    for g, w, e in zip(quant, ref, exact):
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) / scale < 0.05
        assert not np.array_equal(g, e)


def test_cache_layouts(jparams, ids):
    """ep: every shard holds the whole cache; tp x ep: cell (i, j) holds
    kv heads [i*kv/2, (i+1)*kv/2), the same rows as cell (i, 1 - j), and
    the tp slices join to the plain pipeline's cache."""
    cfg = treg.get_model_config(MODEL)
    _, plain = _pipe(jparams, None)._prefill(torch.from_numpy(ids))
    _, ep = _pipe(jparams, "ep")._prefill(torch.from_numpy(ids))
    _, grid = _pipe(jparams, "tp_ep")._prefill(torch.from_numpy(ids))
    for whole, ep_st, grid_st in zip(plain, ep, grid):
        assert len(ep_st) == 2 and len(grid_st) == 4
        for name, leaf in whole.items():
            for shard in ep_st:
                torch.testing.assert_close(shard[name], leaf, rtol=RTOL,
                                           atol=ATOL)
            assert all(c[name].shape[3] == cfg.kv_heads // 2
                       for c in grid_st)
            for i in range(2):
                assert torch.equal(grid_st[2 * i][name],
                                   grid_st[2 * i + 1][name])
            joined = torch.cat([grid_st[0][name], grid_st[2][name]], dim=3)
            torch.testing.assert_close(joined, leaf, rtol=RTOL, atol=ATOL)


def test_params_shared_on_one_device(jparams):
    """On `[cpu] * 4` the grid's cells share what they replicate: cells
    (i, 0) and (i, 1) one tp slice of the attention, cells (0, j) and
    (1, j) one expert slab, every cell the router; the ep shards share
    the whole attention."""
    grid = _pipe(jparams, "tp_ep").stages[0]["params"]["blocks"][0]
    assert grid[0]["q"]["w"] is grid[1]["q"]["w"]
    assert grid[0]["q"]["w"].data_ptr() != grid[2]["q"]["w"].data_ptr()
    up = [c["moe"]["experts"]["mlp_up"]["w"] for c in grid]
    assert up[0] is up[2] and up[1] is up[3] and up[0] is not up[1]
    assert up[0].shape[0] == 2
    assert len({id(c["moe"]["router"]["w"]) for c in grid}) == 1
    ep = _pipe(jparams, "ep").stages[0]["params"]["blocks"][0]
    assert ep[0]["q"]["w"] is ep[1]["q"]["w"]
    assert ep[0]["moe"]["experts"]["mlp_up"]["w"].shape[0] == 2


def _dense_cfg():
    fields = dict(model_type="gpt2", hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  vocab_size=100, max_position_embeddings=64)
    return (dataclasses.replace(jreg.get_model_config(MODEL), n_experts=0,
                                **fields),
            TransformerConfig(**fields))


def _same_error(port, ref, exc=ValueError):
    with pytest.raises(exc) as got:
        port()
    with pytest.raises(exc) as want:
        ref()
    assert str(got.value) == str(want.value)


def test_composition_refusals_are_jax_s(jparams):
    """The constructor's composition errors and the stage makers' MoE
    and divisibility refusals, word for word."""
    jcfg, tcfg = _cfgs("dropless")
    tp_params = [params_from_jax(jax.device_get(p)) for p in jparams]
    jfam = jreg.get_model_entry(MODEL).family.FAMILY
    tfam = treg.get_model_entry(MODEL).family.FAMILY
    jdevs = np.asarray(jax.devices()[:4])
    jm = {"mesh": Mesh(jdevs[:2], ("tp",)),
          "sp_mesh": Mesh(jdevs[:2], ("sp",)),
          "ep_mesh": Mesh(jdevs[:2], ("ep",)),
          "tp_ep_mesh": Mesh(jdevs.reshape(2, 2), ("tp", "ep"))}
    tm = {"mesh": ShardGroup(devices_for(2, "cpu")),
          "sp_mesh": ShardGroup(devices_for(2, "cpu"), "sp"),
          "ep_mesh": ShardGroup(devices_for(2, "cpu"), "ep"),
          "tp_ep_mesh": ShardGrid(devices_for(4, "cpu"), 2, 2)}
    cases = [("sp_mesh", "mesh"), ("sp_mesh", "cache_bits"),
             ("ep_mesh", "mesh"), ("ep_mesh", "sp_mesh"),
             ("tp_ep_mesh", "mesh"), ("tp_ep_mesh", "ep_mesh"),
             ("tp_ep_mesh", "sp_mesh"), ("tp_ep_mesh", "cache_bits")]
    for a, b in cases:
        def kw(meshes, a=a, b=b):
            out = {a: meshes[a]}
            out.update({"cache_bits": 8} if b == "cache_bits"
                       else {b: meshes[b]})
            return out
        _same_error(
            lambda: tdec.DecodePipeline(tfam, tcfg, PARTITION, tp_params,
                                        max_len=MAX_LEN, device="cpu",
                                        **kw(tm)),
            lambda: jdec.DecodePipeline(jfam, jcfg, PARTITION, jparams,
                                        max_len=MAX_LEN, **kw(jm)))
    jdense, tdense = _dense_cfg()
    sc_j = jreg.make_shard_config(MODEL, 1, 8)
    sc_t = treg.make_shard_config(MODEL, 1, 8)
    _same_error(lambda: tdec.make_ep_stage_fns(tfam, tdense, sc_t,
                                               tm["ep_mesh"]),
                lambda: jdec.make_ep_stage_fns(jfam, jdense, sc_j,
                                               jm["ep_mesh"], {}))
    _same_error(lambda: tdec.make_tp_ep_stage_fns(tfam, tdense, sc_t,
                                                  tm["tp_ep_mesh"]),
                lambda: jdec.make_tp_ep_stage_fns(jfam, jdense, sc_j,
                                                  jm["tp_ep_mesh"], {}))
    # 3 experts over ep 2; 3 heads over tp 2
    for field, value in (("n_experts", 3), ("num_attention_heads", 3)):
        jc = dataclasses.replace(jcfg, **{field: value})
        tc = dataclasses.replace(tcfg, **{field: value})
        _same_error(lambda: tdec.make_tp_ep_stage_fns(tfam, tc, sc_t,
                                                      tm["tp_ep_mesh"]),
                    lambda: jdec.make_tp_ep_stage_fns(jfam, jc, sc_j,
                                                      jm["tp_ep_mesh"], {}))
    jc = dataclasses.replace(jcfg, n_experts=3)
    tc = dataclasses.replace(tcfg, n_experts=3)
    _same_error(lambda: tdec.make_ep_stage_fns(tfam, tc, sc_t, tm["ep_mesh"]),
                lambda: jdec.make_ep_stage_fns(jfam, jc, sc_j, jm["ep_mesh"],
                                               {}))
    # the meshes are shard groups and grids, not JAX meshes
    with pytest.raises(TypeError, match="ShardGrid"):
        tdec.DecodePipeline(tfam, tcfg, PARTITION, tp_params,
                            max_len=MAX_LEN, device="cpu",
                            tp_ep_mesh=tm["ep_mesh"])


def _jax_entry_ids(argv, monkeypatch):
    """Row 0's continuation from the JAX entry's report line."""
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", ROOT / "tools" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main()
    line = re.search(r"sample continuation ids: (\[.*\])", out.getvalue())
    return eval(line.group(1))     # a printed list of ints


@pytest.mark.parametrize("mesh", [["--ep", "2"], ["--tp", "2", "--ep", "2"]],
                         ids=["ep", "tp_ep"])
def test_generate_entry_is_the_jax_entry_s(mesh, monkeypatch, capsys):
    """`generate --ep 2` and `--tp 2 --ep 2` on the CPU: row 0's tokens
    equal the JAX entry's on the same command line, every row equals the
    port's `--ep 1`, and the report names the mesh."""
    argv = ["-m", MODEL, "-pt", "1,4,5,8", "-b", "2", "--prompt-len", "6",
            "--new-tokens", "5"]
    got = tgenerate.main(argv + ["--device", "cpu"] + mesh)
    label = ", ep 2" if len(mesh) == 2 else ", tp 2 x ep 2"
    assert label in capsys.readouterr().out
    np.testing.assert_array_equal(
        got, tgenerate.main(argv + ["--device", "cpu"]))
    assert got[0, 6:].tolist() == _jax_entry_ids(argv + mesh, monkeypatch)


@pytest.mark.parametrize("extra", [
    ["--kv-bits", "8", "--concurrent", "2"], ["--beams", "2"],
    ["--shared-prefix", "3"], ["--prefill-ubatch", "1"]],
    ids=["concurrent", "beams", "shared_prefix", "prefill_ubatch"])
def test_generate_entry_ep_composes(extra):
    """`--ep 2` with the entry's other modes equals `--ep 1` with them
    (the per-shard caches are tiled, gathered and joined as lists)."""
    argv = ["-m", MODEL, "-pt", "1,4,5,8", "--device", "cpu", "-b", "2",
            "--prompt-len", "6", "--new-tokens", "5"] + extra
    np.testing.assert_array_equal(tgenerate.main(argv + ["--ep", "2"]),
                                  tgenerate.main(argv))
