"""Tensor-parallel decoding (`DecodePipeline(mesh=)`, `generate --tp`)
against the JAX package.

The tiny GPT-2 and the tiny Llama (GQA: 4 heads over 2 kv heads), two
stages, seeded weights (the JAX `module_shard_factory` stream, converted
by `models/convert.py`). The port runs tp 2 on `[cpu] * 2`, the JAX
`DecodePipeline(mesh=Mesh(2 CPU devices))` under `shard_map`:

- prefill and decode-step logits within rtol=2e-4, atol=2e-5 of JAX's
  (both sum the row-parallel products across the shards, each in its own
  matmul order), greedy tokens equal to JAX's and to the port's tp 1,
  with an fp cache and with an int8 cache (dequantize route: the JAX tp
  step attends that way);
- with the int8 decode-attend opt-in each shard's step attends through
  kernel 5's wrapper (its plain version here) over its own heads, and
  the tokens equal the dequantize route's;
- the cache is head-sharded: shard i holds heads [i*kv/2, (i+1)*kv/2);
- the `generate --tp` entry equals `--tp 1`, alone and composed, and its
  parse errors are the JAX entry's word for word.
"""
import importlib.util
import io
import pathlib
import sys
from contextlib import redirect_stderr

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch import generate as tgenerate
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.ops import decode_attention
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel.mesh import ShardGroup, devices_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ["pipeedge/test-tiny-gpt2", "pipeedge/test-tiny-llama"]
PARTITION = [(1, 4), (5, 8)]
MAX_LEN, FLOOR, PROMPT, NEW = 32, 8, 6, 9
RTOL, ATOL = 2e-4, 2e-5


def _jax_params(model):
    return [jreg.module_shard_factory(model, None, l, r, stage=i,
                                      unroll=False)[1]
            for i, (l, r) in enumerate(PARTITION)]


@pytest.fixture(scope="module")
def params():
    return {m: _jax_params(m) for m in MODELS}


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(31).integers(0, 100, size=(3, PROMPT))


def _jax_pipe(model, jparams, bits):
    return jdec.DecodePipeline(
        jreg.get_model_entry(model).family.FAMILY,
        jreg.get_model_config(model), PARTITION, jparams, max_len=MAX_LEN,
        cache_bits=bits, attend_floor=FLOOR,
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("tp",)))


def _pipe(model, jparams, bits, tp=2, optin=0):
    mesh = ShardGroup(devices_for(tp, "cpu")) if tp > 1 else None
    return tdec.DecodePipeline(
        treg.get_model_entry(model).family.FAMILY,
        treg.get_model_config(model), PARTITION,
        [params_from_jax(jax.device_get(p)) for p in jparams],
        max_len=MAX_LEN, device="cpu", cache_bits=bits, attend_floor=FLOOR,
        int8_decode_attend=optin, mesh=mesh)


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


@pytest.mark.parametrize("bits", [0, 8], ids=["fp", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_tp_decode_matches_jax(params, ids, model, bits):
    jpipe = _jax_pipe(model, params[model], bits)
    pipe = _pipe(model, params[model], bits)
    want = np.asarray(jpipe.generate(ids, NEW))
    got = pipe.generate(ids, NEW).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _pipe(model, params[model], bits, tp=1).generate(ids, NEW))
    tokens = np.array(want[:, PROMPT:PROMPT + 4])
    for g, w in zip(_step_logits(pipe, torch.from_numpy(ids),
                                 torch.from_numpy(tokens)),
                    _step_logits(jpipe, ids, tokens)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_int8_kernel_route_runs_per_shard(params, ids, monkeypatch):
    model = MODELS[0]
    heads = []
    real = decode_attention.int8_decode_attention

    def spy(q, *args, **kw):
        heads.append(q.shape[2])
        return real(q, *args, **kw)

    monkeypatch.setattr(decode_attention, "int8_decode_attention", spy)
    got = _pipe(model, params[model], 8, optin=1).generate(ids, NEW)
    cfg = treg.get_model_config(model)
    # one call per shard, per block of the model, per decode step
    assert heads == [cfg.num_attention_heads // 2] * (
        2 * cfg.num_hidden_layers * (NEW - 1))
    want = _pipe(model, params[model], 8).generate(ids, NEW)
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", MODELS)
def test_cache_is_head_sharded(params, ids, model):
    cfg = treg.get_model_config(model)
    pipe = _pipe(model, params[model], 8)
    _, caches = pipe._prefill(torch.from_numpy(ids))
    whole_pipe = _pipe(model, params[model], 8, tp=1)
    _, whole = whole_pipe._prefill(torch.from_numpy(ids))
    for stage, ref in zip(caches, whole):
        assert isinstance(stage, list) and len(stage) == 2
        for name, leaf in ref.items():
            assert all(s[name].shape[3] == cfg.kv_heads // 2 for s in stage)
            joined = torch.cat([s[name] for s in stage], dim=3)
            assert joined.shape == leaf.shape
            if name in ("k", "v"):
                # int8 codes: a 1-ulp difference in a row may move one code
                assert (joined.int() - leaf.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(joined, leaf, rtol=RTOL,
                                           atol=ATOL)


def _gen(extra, tp):
    return tgenerate.main(["-m", MODELS[0], "-pt", "1,4,5,8", "--device",
                           "cpu", "-b", "2", "--prompt-len", "6",
                           "--new-tokens", "5", "--tp", str(tp)] + extra)


@pytest.mark.parametrize("extra", [
    [], ["--kv-bits", "8"], ["--concurrent", "2"], ["--beams", "2"],
    ["--shared-prefix", "3"], ["--prefill-ubatch", "1"]],
    ids=["plain", "int8", "concurrent", "beams", "shared_prefix",
         "prefill_ubatch"])
def test_generate_entry_tp_equals_tp1(extra, capsys):
    got = _gen(extra, 2)
    assert ", tp 2" in capsys.readouterr().out
    np.testing.assert_array_equal(got, _gen(extra, 1))


def _error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


def _jax_generate():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", ROOT / "tools" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BASE = ["-m", MODELS[0], "-b", "2", "--prompt-len", "4", "--new-tokens",
        "2"]
COMPOSE = {
    "tp_dcn": ["--tp", "2", "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2",
               "-pt", "1,4,5,8"],
    "tp_spmd_wave": ["--tp", "2", "--spmd-wave"],
    "sp_with_tp": ["--tp", "2", "--sp", "2"],
    "sp_prompt_len": ["--sp", "3"],
    "shared_prefix_sp": ["--sp", "2", "--shared-prefix", "3"],
    "edge_bits_spmd_wave": ["--edge-bits", "8", "--spmd-wave",
                            "--beams", "2"],
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_tp_compose_errors_are_the_jax_entry_s(case, monkeypatch):
    argv = BASE + COMPOSE[case]
    got = _error(lambda: tgenerate.parse_args(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    assert got == _error(_jax_generate().main)


def test_tp_without_a_card_is_the_jax_device_error(monkeypatch):
    """The shards share the cards round-robin, so only a host without one
    is short of devices: the JAX entry's words at 0 visible."""
    argv = BASE + ["--tp", "2"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    got = _error(lambda: tgenerate.parse_args(argv))
    monkeypatch.setattr(jax, "devices", lambda *a: [])
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    assert got == _error(_jax_generate().main)
