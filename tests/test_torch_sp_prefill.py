"""Sequence-parallel prefill (`DecodePipeline(sp_mesh=)`, `generate --sp`)
against the JAX package.

The tiny GPT-2, the tiny Llama (4 heads over 2 kv heads) and the tiny
Mistral (the Llama block with a window of 4) in two stages, seeded
weights from the JAX `module_shard_factory` stream, a 16-token prompt
over sp 2 and 4 (`[cpu] * n` shards; JAX on the conftest's CPU devices),
ring and Ulysses:

- the prefill's logits within rtol=2e-4, atol=2e-5 of JAX's sp prefill
  and of the port's plain prefill; the gathered caches within the same
  tolerance; greedy tokens equal JAX's and the plain pipeline's. At sp 4
  the Mistral ring skips whole blocks (`_ring_steps(4, 4, 4) == 2`) and
  Ulysses takes the GQA pre-repeat (2 kv heads over 4 shards);
- the dropless MoE against plain; the capacity-bounded and no-hook
  refusals, and the divisibility errors, word for word;
- the executors, the paged KV plane and the speculative decoder's
  device rounds refusing what the JAX ones refuse (sp, ep, tp x ep);
- `generate --sp 2` equal to the JAX entry, and its parse errors.
"""
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch import generate as tgenerate
from pipeedge_tpu_torch.kv.pool import KvPagePool
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel import speculative
from pipeedge_tpu_torch.parallel.batcher import (ContinuousBatcher,
                                                 StageWorkerExecutor)
from pipeedge_tpu_torch.parallel.mesh import ShardGrid, ShardGroup, devices_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ["pipeedge/test-tiny-gpt2", "pipeedge/test-tiny-llama",
          "pipeedge/test-tiny-mistral"]
PARTITION = [(1, 4), (5, 8)]
MAX_LEN, PROMPT, NEW = 32, 16, 6
RTOL, ATOL = 2e-4, 2e-5


def _jax_params(model):
    return [jreg.module_shard_factory(model, None, l, r, stage=i,
                                      unroll=False)[1]
            for i, (l, r) in enumerate(PARTITION)]


@pytest.fixture(scope="module")
def params():
    return {m: _jax_params(m) for m in MODELS + ["pipeedge/test-tiny-moe"]}


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(23).integers(0, 100, size=(2, PROMPT))


def _jax_pipe(model, jparams, n=None, kind="ring", cfg=None):
    kw = ({} if n is None else
          {"sp_mesh": Mesh(np.asarray(jax.devices()[:n]), ("sp",)),
           "sp_kind": kind})
    return jdec.DecodePipeline(
        jreg.get_model_entry(model).family.FAMILY,
        cfg or jreg.get_model_config(model), PARTITION, jparams,
        max_len=MAX_LEN, **kw)


def _pipe(model, jparams, n=None, kind="ring", cfg=None):
    kw = ({} if n is None else
          {"sp_mesh": ShardGroup(devices_for(n, "cpu"), "sp"),
           "sp_kind": kind})
    return tdec.DecodePipeline(
        treg.get_model_entry(model).family.FAMILY,
        cfg or treg.get_model_config(model), PARTITION,
        [params_from_jax(jax.device_get(p)) for p in jparams],
        max_len=MAX_LEN, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_sp_prefill_matches_jax(params, ids, model, n, kind):
    pipe = _pipe(model, params[model], n, kind)
    jpipe = _jax_pipe(model, params[model], n, kind)
    plain = _pipe(model, params[model])
    assert pipe.sp_degree == n
    logits, caches = pipe._prefill(torch.from_numpy(ids))
    jlogits, jcaches = jpipe._prefill(ids)
    plogits, pcaches = plain._prefill(torch.from_numpy(ids))
    for want in (np.asarray(jlogits), plogits.numpy()):
        np.testing.assert_allclose(logits.numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    for got, jc, pc in zip(caches, jcaches, pcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(jc[name]), rtol=RTOL,
                                       atol=ATOL)
            torch.testing.assert_close(got[name], pc[name], rtol=RTOL,
                                       atol=ATOL)
    got = pipe.generate(ids, NEW).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpipe.generate(ids, NEW)))
    np.testing.assert_array_equal(got, plain.generate(ids, NEW).numpy())


def test_moe_sp_prefill_matches_plain(params, ids):
    """Dropless MoE (capacity_factor == n_experts) routes each token on
    its own gate, so chunk-local routing is exact; a capacity-bounded
    config refuses in JAX's words."""
    model = "pipeedge/test-tiny-moe"
    cfg = treg.get_model_config(model)
    assert cfg.capacity_factor >= cfg.n_experts
    want = _pipe(model, params[model]).generate(ids, NEW)
    for kind in ("ring", "ulysses"):
        got = _pipe(model, params[model], 2, kind).generate(ids, NEW)
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        want.numpy(),
        np.asarray(_jax_pipe(model, params[model], 2).generate(ids, NEW)))
    with pytest.raises(NotImplementedError, match="dropless") as port:
        _pipe(model, params[model], 2,
              cfg=dataclasses.replace(cfg, capacity_factor=1.25))
    with pytest.raises(NotImplementedError) as ref:
        _jax_pipe(model, params[model], 2, cfg=dataclasses.replace(
            jreg.get_model_config(model), capacity_factor=1.25))
    assert str(port.value) == str(ref.value)


def test_rope_family_without_hook_refuses(params):
    """A position-dependent family with no sp hook refuses, word for
    word."""
    model = "pipeedge/test-tiny-llama"
    tfam = dataclasses.replace(treg.get_model_entry(model).family.FAMILY,
                               sp_prefill_block_step=None)
    jfam = dataclasses.replace(jreg.get_model_entry(model).family.FAMILY,
                               sp_prefill_block_step=None)
    with pytest.raises(NotImplementedError, match="RoPE") as port:
        tdec.make_sp_prefill_fn(tfam, treg.get_model_config(model),
                                treg.make_shard_config(model, 1, 8),
                                ShardGroup(devices_for(2, "cpu"), "sp"))
    with pytest.raises(NotImplementedError) as ref:
        jdec.make_sp_prefill_fn(jfam, jreg.get_model_config(model),
                                jreg.make_shard_config(model, 1, 8),
                                Mesh(np.asarray(jax.devices()[:2]), ("sp",)))
    assert str(port.value) == str(ref.value)


def test_divisibility_errors_are_jax_s(params, ids):
    """generate, generate_beam and precompute_prefix refuse a length the
    sp degree does not divide, in JAX's words; ulysses refuses heads it
    does not divide."""
    model = MODELS[0]
    pipe = _pipe(model, params[model], 2)
    jpipe = _jax_pipe(model, params[model], 2)
    for call in (lambda p: p.generate(ids[:, :7], 3),
                 lambda p: p.generate_beam(ids[:, :7], 3, beams=2),
                 lambda p: p.precompute_prefix(ids[0, :5])):
        with pytest.raises(ValueError, match="not divisible by") as port:
            call(pipe)
        with pytest.raises(ValueError) as ref:
            call(jpipe)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="requires head count") as port:
        _pipe(model, params[model], 8, "ulysses")
    with pytest.raises(ValueError) as ref:
        _jax_pipe(model, params[model], 8, "ulysses")
    assert str(port.value) == str(ref.value)


def test_sp_prefix_and_beams(params, ids):
    """An sp pipeline's prefix handle and beam search equal the plain
    pipeline's (the prefix runs the sp prefill, the suffix a span)."""
    model = MODELS[1]
    pipe, plain = _pipe(model, params[model], 2), _pipe(model,
                                                        params[model])
    handle = pipe.precompute_prefix(ids[0, :8])
    want_handle = plain.precompute_prefix(ids[0, :8])
    rows = np.repeat(ids[:1, 8:], 2, axis=0)
    assert torch.equal(pipe.generate(rows, 4, prefix=handle),
                       plain.generate(rows, 4, prefix=want_handle))
    assert torch.equal(pipe.generate_beam(ids, 4, beams=2),
                       plain.generate_beam(ids, 4, beams=2))


def test_executors_and_paged_kv_refuse_mesh_pipelines(params):
    """The continuous batcher and the stage workers refuse an sp pipeline
    (JAX's words); the paged KV plane refuses ep, tp x ep and sp; the
    speculative decoder keeps ep and tp x ep rounds on the host."""
    sp_pipe = _pipe(MODELS[0], params[MODELS[0]], 2)
    with pytest.raises(ValueError, match="whole-pipeline pass"):
        ContinuousBatcher(sp_pipe)
    with pytest.raises(ValueError, match="whole-pipeline pass"):
        StageWorkerExecutor(sp_pipe)
    moe = "pipeedge/test-tiny-moe"
    tparams = [params_from_jax(jax.device_get(p)) for p in params[moe]]
    meshes = {"ep": {"ep_mesh": ShardGroup(devices_for(2, "cpu"), "ep")},
              "tp x ep": {"tp_ep_mesh": ShardGrid(devices_for(4, "cpu"),
                                                  2, 2)}}
    pipes = {kind: tdec.DecodePipeline(
        treg.get_model_entry(moe).family.FAMILY, treg.get_model_config(moe),
        PARTITION, tparams, max_len=MAX_LEN, device="cpu", **kw)
        for kind, kw in meshes.items()}
    for pipe in [sp_pipe] + list(pipes.values()):
        with pytest.raises(ValueError, match="tp/ep/sp mesh"):
            KvPagePool(pipe, n_pages=8)
    assert speculative._device_rounds_eligible(pipes["ep"]) \
        == "expert-parallel mesh"
    assert speculative._device_rounds_eligible(pipes["tp x ep"]) \
        == "tp x ep mesh"
    assert speculative._device_rounds_eligible(sp_pipe) is None


def _jax_generate():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", ROOT / "tools" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model", MODELS[:2])
def test_generate_entry_is_the_jax_entry_s(model, monkeypatch, capsys):
    """`generate --sp 2` on the CPU: row 0's tokens equal the JAX entry's
    on the same command line, every row the port's `--sp 1`."""
    argv = ["-m", model, "-pt", "1,4,5,8", "-b", "2", "--prompt-len", "8",
            "--new-tokens", "5"]
    got = tgenerate.main(argv + ["--device", "cpu", "--sp", "2"])
    assert ", sp 2" in capsys.readouterr().out
    np.testing.assert_array_equal(got, tgenerate.main(argv + ["--device",
                                                              "cpu"]))
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv + ["--sp", "2"])
    out = io.StringIO()
    with redirect_stdout(out):
        _jax_generate().main()
    line = re.search(r"sample continuation ids: (\[.*\])", out.getvalue())
    assert got[0, 8:].tolist() == eval(line.group(1))


def _error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


BASE = ["-m", MODELS[0], "-b", "2", "--prompt-len", "4", "--new-tokens",
        "2"]
COMPOSE = {
    "sp_with_ep": ["--ep", "2", "--sp", "2"],
    "sp_prompt_len": ["--sp", "3"],
    "shared_prefix_sp": ["--sp", "2", "--shared-prefix", "1"],
    "sp_dcn": ["--sp", "2", "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2",
               "-pt", "1,4,5,8"],
    "ep_spmd_wave": ["--ep", "2", "--spmd-wave"],
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_sp_ep_compose_errors_are_the_jax_entry_s(case, monkeypatch):
    argv = BASE + COMPOSE[case]
    got = _error(lambda: tgenerate.parse_args(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    assert got == _error(_jax_generate().main)


@pytest.mark.parametrize("flag", ["--sp", "--ep"])
def test_without_a_card_is_the_jax_device_error(flag, monkeypatch):
    """The shards share the cards round-robin, so only a host without
    one is short of devices: the JAX entry's words at 0 visible."""
    argv = BASE + [flag, "2"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    got = _error(lambda: tgenerate.parse_args(argv))
    monkeypatch.setattr(jax, "devices", lambda *a: [])
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    assert got == _error(_jax_generate().main)
