"""The port's speculative decoding (`pipeedge_tpu_torch/parallel/
speculative.py`) against the JAX package's and against plain greedy.

The counterparts of `tests/test_speculative.py` for GPT-2, on
`pipeedge/test-tiny-gpt2` (max_len 48, f32, fp caches) with an
independently seeded tiny GPT-2 as the draft, one set of HF-layout
weights per model loaded into both packages:

- greedy-exact: tokens equal the target's own greedy `generate` (the
  port's and the JAX package's) for gamma 1, 3 and 4 at batch 1 and 2,
  on a two-stage target too, with the prefix cache, and in paged mode
  (with both pools whole afterwards);
- a self-draft accepts everything; `extend` equals serial steps;
- host and device sync: the same tokens and acceptance, and
  `last_sync_count` equal to the JAX package's for the same generation;
- the refusals: vocabulary mismatch, capacity-bounded MoE, sync="device"
  on an ineligible draft (and "auto" falling back), the eligibility gate;
- the generate entry's `--draft-model` run and its refusal, word for
  word the JAX entry's.

The Llama/Mistral, MoE and tensor-parallel cases of the JAX file wait for
their models and meshes in the port (ROADMAP A5.5, A5.6 and A7).
"""
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.parallel.speculative import \
    SpeculativeDecoder as JSpeculativeDecoder
from pipeedge_tpu_torch import generate
from pipeedge_tpu_torch.kv import KvPagePool, PagedKvBackend
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel.speculative import (SpeculativeDecoder,
                                                     _device_rounds_eligible)
from pipeedge_tpu_torch.telemetry import metrics as prom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-gpt2"
CFG = treg.get_model_config(MODEL)
MAX_LEN = 48


def _pipes(seed, partition):
    """{"jax": ..., "torch": ...} pipelines over one set of weights."""
    weights = tgpt2.random_npz_weights(CFG, seed=seed)
    jcfg = jreg.get_model_config(MODEL)
    jparams = [jgpt2.load_params(jcfg, JShardConfig(l, r, is_first=l == 1,
                                                    is_last=r == 8), weights)
               for l, r in partition]
    tparams = [params_from_jax(jax.device_get(p)) for p in jparams]
    return {"jax": jdec.DecodePipeline(jgpt2.FAMILY, jcfg, partition,
                                       jparams, max_len=MAX_LEN),
            "torch": tdec.DecodePipeline(tgpt2.FAMILY, CFG, partition,
                                         tparams, max_len=MAX_LEN,
                                         device="cpu")}


@pytest.fixture(scope="module")
def pipes():
    """target (one stage), target in two stages, draft (one stage)."""
    return {"target": _pipes(3, [(1, 8)]),
            "target2": _pipes(3, [(1, 4), (5, 8)]),
            "draft": _pipes(4, [(1, 8)])}


def _ids(batch, prompt_len, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(batch, prompt_len))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("gamma", [1, 3, 4])
@pytest.mark.parametrize("batch", [1, 2])
def test_spec_greedy_exact_gpt2(pipes, gamma, batch):
    target, draft = pipes["target"], pipes["draft"]
    ids = _ids(batch, 8)
    want = _np(target["torch"].generate(ids, 12))
    np.testing.assert_array_equal(
        want, _np(target["jax"].generate(np.asarray(ids, np.int32), 12)))
    spec = SpeculativeDecoder(target["torch"], draft["torch"], gamma=gamma)
    np.testing.assert_array_equal(_np(spec.generate(ids, 12)), want)
    assert 0.0 <= spec.last_acceptance_rate <= 1.0


def test_spec_self_draft_accepts_everything(pipes):
    target = pipes["target"]["torch"]
    ids = _ids(2, 8)
    want = _np(target.generate(ids, 10))
    spec = SpeculativeDecoder(target, target, gamma=3)
    np.testing.assert_array_equal(_np(spec.generate(ids, 10)), want)
    assert spec.last_acceptance_rate == 1.0


def test_spec_multistage_target(pipes):
    target, draft = pipes["target2"]["torch"], pipes["draft"]["torch"]
    ids = _ids(2, 8)
    want = _np(target.generate(ids, 12))
    np.testing.assert_array_equal(
        want, _np(pipes["target"]["torch"].generate(ids, 12)))
    got = SpeculativeDecoder(target, draft, gamma=3).generate(ids, 12)
    np.testing.assert_array_equal(_np(got), want)


def test_extend_matches_serial_steps(pipes):
    """The verify primitive: one K-token extend gives the last-stage
    logits and cache rows of K serial decode steps (the JAX test's
    tolerance)."""
    target = pipes["target2"]["torch"]
    ids = torch.as_tensor(_ids(2, 8))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, CFG.vocab_size, size=(2, 4)))
    _, caches_a = target._prefill(ids)
    span_logits, caches_a = target.extend(toks, caches_a, 8)
    _, caches_b = target._prefill(ids)
    serial = []
    for j in range(4):
        data = toks[:, j:j + 1]
        for i, st in enumerate(target.stages):
            data, caches_b[i] = target._decode_step(st, data, caches_b[i],
                                                    8 + j)
        serial.append(data[:, 0])
    np.testing.assert_allclose(span_logits.numpy(),
                               torch.stack(serial, dim=1).numpy(),
                               rtol=2e-5, atol=2e-5)
    for ca, cb in zip(caches_a, caches_b):
        for key in ca:
            np.testing.assert_allclose(ca[key][:, :, :12].numpy(),
                                       cb[key][:, :, :12].numpy(),
                                       rtol=2e-5, atol=2e-5)


def test_spec_vocab_mismatch_refused(pipes):
    target = pipes["target"]["torch"]
    odd = SimpleNamespace(cfg=dataclasses.replace(CFG, vocab_size=101),
                          stages=[{}])
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecoder(target, odd)


def test_spec_capacity_bounded_moe_refused(pipes):
    target = pipes["target"]["torch"]
    moe = SimpleNamespace(cfg=dataclasses.replace(
        CFG, n_experts=4, capacity_factor=1.0), stages=[{}])
    with pytest.raises(ValueError, match="capacity-bounded"):
        SpeculativeDecoder(target, moe)


def test_prefix_cache_matches_full_prefill(pipes):
    """Prompt caching: precompute_prefix + suffix span == the whole
    prompt's prefill, token for token, in the port as in JAX; and the
    speculative decoder's prefix handle gives the full prompt's greedy
    tokens (a self-draft accepts everything)."""
    target, draft = pipes["target"]["torch"], pipes["draft"]["torch"]
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, CFG.vocab_size, size=(1, 6))
    suffix = rng.integers(0, CFG.vocab_size, size=(2, 4))
    full = np.concatenate([np.repeat(prefix, 2, axis=0), suffix], axis=1)
    want = _np(target.generate(full, 11))
    np.testing.assert_array_equal(
        _np(target.generate(suffix, 11,
                            prefix=target.precompute_prefix(prefix))),
        want[:, 6:])
    spec = SpeculativeDecoder(target, draft, gamma=3)
    got = spec.generate(suffix, 11, prefix=spec.precompute_prefix(prefix))
    np.testing.assert_array_equal(_np(got), want[:, 6:])
    spec2 = SpeculativeDecoder(target, target, gamma=2)
    got2 = spec2.generate(suffix, 11,
                          prefix=spec2.precompute_prefix(prefix))
    np.testing.assert_array_equal(_np(got2), want[:, 6:])
    assert spec2.last_acceptance_rate == 1.0


@pytest.mark.parametrize("gamma", [2, 4])
@pytest.mark.parametrize("prefixed", [False, True])
def test_sync_counts_match_jax(pipes, gamma, prefixed):
    """Host and device sync give the same tokens and acceptance, and the
    port's `last_sync_count` equals the JAX package's in each mode: 1 +
    rounds x (gamma + 1) on the host, 1 + 2 x rounds on the device."""
    ids = _ids(2, 8, seed=5)
    handles = {}
    if prefixed:
        prefix = _ids(1, 6, seed=6)
        ids = ids[:, :4]
    got = {}
    for pkg in ("jax", "torch"):
        cls = JSpeculativeDecoder if pkg == "jax" else SpeculativeDecoder
        for sync in ("host", "device"):
            spec = cls(pipes["target"][pkg], pipes["draft"][pkg],
                       gamma=gamma, sync=sync)
            kw = {}
            if prefixed:
                if (pkg, "h") not in handles:
                    handles[(pkg, "h")] = spec.precompute_prefix(
                        np.asarray(prefix, np.int32))
                kw["prefix"] = handles[(pkg, "h")]
            out = spec.generate(np.asarray(ids, np.int32), 12, **kw)
            got[(pkg, sync)] = (_np(out), spec.last_acceptance_rate,
                                spec.last_sync_count)
    for sync in ("host", "device"):
        t_out, t_rate, t_syncs = got[("torch", sync)]
        j_out, j_rate, j_syncs = got[("jax", sync)]
        np.testing.assert_array_equal(t_out, j_out)
        assert t_rate == j_rate and t_syncs == j_syncs, (sync, got)
    host, dev = got[("torch", "host")][2], got[("torch", "device")][2]
    rounds = (host - 1) // (gamma + 1)
    assert host == 1 + rounds * (gamma + 1) and dev == 1 + 2 * rounds
    assert dev < host


def test_device_rounds_auto_fallback_and_refusal(pipes):
    """'auto' picks device rounds for the port's one-device pipelines and
    host rounds for a draft with per-stage placement, which
    sync='device' refuses with the reason."""
    target, draft = pipes["target"]["torch"], pipes["draft"]["torch"]
    assert SpeculativeDecoder(target, draft, gamma=3).sync == "device"
    placed = SimpleNamespace(cfg=CFG, stages=[{"device": "cuda:1"}])
    assert SpeculativeDecoder(target, placed, gamma=2).sync == "host"
    with pytest.raises(ValueError, match="device placement"):
        SpeculativeDecoder(target, placed, gamma=2, sync="device")
    with pytest.raises(ValueError, match="sync must be"):
        SpeculativeDecoder(target, draft, sync="both")
    with pytest.raises(ValueError, match="gamma must be"):
        SpeculativeDecoder(target, draft, gamma=0)


def test_device_rounds_eligibility_gate():
    def pipe(**kw):
        base = dict(stages=[{"device": None}], mesh=None, ep_mesh=None,
                    tp_ep_mesh=None)
        base.update(kw)
        return SimpleNamespace(**base)

    assert _device_rounds_eligible(pipe()) is None
    assert _device_rounds_eligible(SimpleNamespace(stages=[{}])) is None
    assert "device placement" in _device_rounds_eligible(
        pipe(stages=[{"device": object()}]))
    assert "tensor-parallel" in _device_rounds_eligible(pipe(mesh=object()))
    assert "expert-parallel" in _device_rounds_eligible(
        pipe(ep_mesh=object()))
    assert "tp x ep" in _device_rounds_eligible(pipe(tp_ep_mesh=object()))


@pytest.mark.parametrize("sync", ["host", "device"])
def test_paged_spec_equals_dense_and_returns_pages(pipes, sync, monkeypatch):
    """Paged mode: target pages from the decode plane's pool, draft pages
    from a draft-layout pool, held while the rounds run (and listed live
    for the sweeps), the same tokens and acceptance as the dense caches,
    and both pools whole afterwards."""
    target, draft = pipes["target2"]["torch"], pipes["draft"]["torch"]
    ids = _ids(2, 8, seed=9)
    dense = SpeculativeDecoder(target, draft, gamma=3, sync=sync)
    want = _np(dense.generate(ids, 12))
    kv = PagedKvBackend(target, 32, 4, registry=prom.Registry())
    dpool = KvPagePool(draft, 32, 4, registry=prom.Registry())
    spec = SpeculativeDecoder(target, draft, gamma=3, sync=sync)
    spec.attach_paged(kv, dpool)
    seen = []
    real = target.extend

    def watching(tokens, caches, pos):
        seen.append((kv.pool.free_pages, dpool.free_pages,
                     spec.live_rids()))
        return real(tokens, caches, pos)

    monkeypatch.setattr(target, "extend", watching)
    got = _np(spec.generate(ids, 12, rid="r7"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _np(target.generate(ids, 12)))
    assert spec.last_acceptance_rate == dense.last_acceptance_rate
    assert spec.last_sync_count == dense.last_sync_count
    # 8 + 12 + gamma tokens -> 6 pages -> 8 per row, target and draft
    assert seen and all(t == 32 - 16 and d == 32 - 16 and live == {"r7"}
                        for t, d, live in seen)
    assert kv.pool.free_pages == 32 and dpool.free_pages == 32
    assert kv.pool.stats()["owners"] == 0 and spec.live_rids() == set()
    assert spec.sweep_orphans() == 0
    with pytest.raises(ValueError, match="dense prefix"):
        spec.generate(ids, 4, prefix=spec.precompute_prefix(ids[:1, :4]))
    with pytest.raises(ValueError, match="BOTH"):
        SpeculativeDecoder(target, draft).attach_paged(kv, None)


def test_generate_entry_speculative_equals_plain(capsys):
    common = ["-m", MODEL, "-b", "2", "--prompt-len", "8", "--new-tokens",
              "10", "--device", "cpu", "--max-len", "24"]
    plain = generate.main(common)
    out = capsys.readouterr().out
    spec = generate.main(common + ["--draft-model", MODEL, "--gamma", "3"])
    out = capsys.readouterr().out
    np.testing.assert_array_equal(spec, plain)
    line = next(ln for ln in out.splitlines() if ln.startswith("generated"))
    assert "speculative gamma=3" in line and "acceptance=1.00" in line
    assert "sync=device" in line


def _error_line(text):
    return [ln for ln in text.splitlines() if "error:" in ln][-1] \
        .split("error: ", 1)[1]


@pytest.mark.fleet
@pytest.mark.parametrize("flag", [["--kv-bits", "8"], ["--beams", "2"],
                                  ["--temperature", "0.5"],
                                  ["--prefill-ubatch", "2"]])
def test_generate_draft_refusals_match_jax(flag, capsys):
    """The port's entry refuses --draft-model with sampling, beams, a
    prefill micro-batch or an int8 cache in the JAX entry's words."""
    argv = ["-m", MODEL, "-b", "2", "--prompt-len", "4", "--new-tokens",
            "2", "--draft-model", MODEL] + flag
    with pytest.raises(SystemExit) as err:
        generate.parse_args(argv + ["--device", "cpu"])
    assert err.value.code == 2
    got = _error_line(capsys.readouterr().err)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "generate.py"),
                           *argv], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 2
    assert got == _error_line(proc.stderr)
