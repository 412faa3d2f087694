"""The port's SPMD wave decoder against the JAX package's decoders.

On the tiny GPT-2 of `tests/test_spmd_decode.py` (hidden 32, 3 blocks, 4
heads, vocab 100, 64 positions), weights drawn from a numpy seed
(`gpt2.random_npz_weights`) and loaded by both packages, the port's
through `params_from_jax`:

- the greedy wave equals the JAX host `DecodePipeline.generate` of each
  slot, over 3 equal stages and over an uneven 2-stage cut;
- the sampled wave equals the port's own `DecodePipeline.generate(seed=)`
  of each slot (torch's generator is not `jax.random`: ROADMAP §C);
- 16-bit edges are token-identical to raw ones, and the 8-bit wave equals
  the JAX `SpmdDecodePipeline(edge_bits=8)` token for token;
- one new token, and every validation error is the JAX wave's, word for
  word;
- prefix caching: the prefix-seeded wave equals the monolithic wave, each
  slot's host prefix generate (the port's and the JAX package's), sampled
  too; foreign handles are refused and `edge_bits` is part of the stamp;
- `SpmdSpeculativeDecoder`: a self-draft accepts every proposal, and a
  perturbed draft gives the wave's greedy tokens;
- the tiny Llama and Mistral waves equal the JAX host pipeline (the oracle
  of `tests/test_llama.py`);
- a wave is R x K stage-steps (only the valid (stage, tick) pairs run),
  and the stage mesh may be a `PipelineMesh`, a device list or left out.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import llama as jllama
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.models.layers import TransformerConfig as JConfig
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu.parallel.spmd_decode import \
    SpmdDecodePipeline as JSpmdDecodePipeline
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import llama as tllama
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.layers import TransformerConfig as TConfig
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.parallel import decode as tdec
from pipeedge_tpu_torch.parallel import spmd as tspmd
from pipeedge_tpu_torch.parallel.spmd_decode import (SpmdDecodePipeline,
                                                     SpmdSpeculativeDecoder)

TINY = dict(model_type="gpt2", hidden_size=32, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=64, layer_norm_eps=1e-5,
            vocab_size=100, max_position_embeddings=64)
JCFG, TCFG = JConfig(**TINY), TConfig(**TINY)
TOTAL = 12
THREE, TWO = [(1, 4), (5, 8), (9, 12)], [(1, 8), (9, 12)]
MAX_LEN = 32


@pytest.fixture(scope="module")
def weights():
    return tgpt2.random_npz_weights(TCFG, seed=7)


def _jparams(weights, partition):
    return [jgpt2.load_params(JCFG, JShardConfig(
        l, r, is_first=l == 1, is_last=r == TOTAL), weights)
        for l, r in partition]


def _tparams(weights, partition):
    return [params_from_jax(jax.device_get(p))
            for p in _jparams(weights, partition)]


def _wave(weights, partition, max_len=MAX_LEN, **kw):
    return SpmdDecodePipeline(tgpt2.FAMILY, TCFG, partition,
                              _tparams(weights, partition), max_len=max_len,
                              device="cpu", **kw)


def _host(weights, partition, max_len=MAX_LEN):
    return tdec.DecodePipeline(tgpt2.FAMILY, TCFG, partition,
                               _tparams(weights, partition), max_len=max_len,
                               device="cpu")


def _jhost(weights, partition, max_len=MAX_LEN):
    return jdec.DecodePipeline(jgpt2.FAMILY, JCFG, partition,
                               _jparams(weights, partition), max_len=max_len)


def _jwave(weights, partition, cfg=JCFG, n_devices=None, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:n_devices or len(partition)]),
                ("stage",))
    return JSpmdDecodePipeline(jgpt2.FAMILY, cfg, partition,
                               _jparams(weights, partition), mesh,
                               max_len=MAX_LEN, **kw)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 100, size=shape)


@pytest.mark.parametrize("partition", [THREE, TWO], ids=["three", "uneven"])
def test_greedy_wave_equals_jax_host_per_slot(weights, partition):
    """R = n_stages greedy slots through the wave == each slot solo
    through the JAX host `DecodePipeline`; no kernel launches on the CPU."""
    n = len(partition)
    ids = _ids(23, (n, 2, 7))
    launches = dict(_build.launch_counts)
    got = _wave(weights, partition).generate(ids, 6).numpy()
    assert got.shape == (n, 2, 13)
    host = _jhost(weights, partition)
    for r in range(n):
        np.testing.assert_array_equal(
            got[r], np.asarray(host.generate(ids[r], 6)), err_msg=f"slot {r}")
    assert _build.launch_counts == launches


def test_sampled_wave_equals_the_port_s_host_per_slot(weights):
    """Each sampled slot's stream is its solo host run with the same
    temperature, top-k and seed: one draw per picked token."""
    wave, host = _wave(weights, THREE), _host(weights, THREE)
    ids = _ids(31, (3, 2, 6))
    seeds = [5, 11, 2]
    got = wave.generate(ids, 5, temperature=0.9, top_k=7, seeds=seeds)
    for r in range(3):
        want = host.generate(ids[r], 5, temperature=0.9, top_k=7,
                             seed=seeds[r])
        torch.testing.assert_close(got[r], want, rtol=0, atol=0)
    # the default seeds are the slot indices
    got = wave.generate(ids, 4, temperature=0.7)
    for r in range(3):
        torch.testing.assert_close(
            got[r], host.generate(ids[r], 4, temperature=0.7, seed=r),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="seeds must have 3 entries"):
        wave.generate(ids, 2, temperature=0.9, seeds=[1])


def test_16_bit_edges_equal_raw_ones(weights):
    """16-bit prompt hops (the plain codec) are token-identical to raw
    ones on this model (their error is far below the argmax margins)."""
    ids = _ids(37, (3, 2, 7))
    want = _wave(weights, THREE).generate(ids, 5)
    got = _wave(weights, THREE, edge_bits=16).generate(ids, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="edge_bits must be one of"):
        _wave(weights, THREE, edge_bits=5)


def test_8_bit_wave_equals_the_jax_wave(weights):
    """The 8-bit prompt hops (kernels 1 and 2 on the card, their plain
    versions here) against the JAX `SpmdDecodePipeline(edge_bits=8)`,
    token for token."""
    ids = _ids(37, (3, 2, 7))
    got = _wave(weights, THREE, edge_bits=8).generate(ids, 5).numpy()
    want = np.asarray(_jwave(weights, THREE, edge_bits=8).generate(ids, 5))
    np.testing.assert_array_equal(got, want)
    assert got[:, :, :7].tolist() == ids.tolist()


def test_one_new_token_equals_the_jax_host(weights):
    partition = [(1, 4), (5, 12)]
    ids = _ids(29, (2, 1, 5))
    got = _wave(weights, partition).generate(ids, 1).numpy()
    host = _jhost(weights, partition)
    for r in range(2):
        np.testing.assert_array_equal(got[r],
                                      np.asarray(host.generate(ids[r], 1)))


MOE = dict(TINY, n_experts=4)
# case -> (constructor keywords, generate call or None, error type)
ERRORS = {
    "slots": ({}, lambda w, ids: w.generate(ids[:1], 2), ValueError),
    "new_tokens": ({}, lambda w, ids: w.generate(ids, 0), ValueError),
    "exceeds": ({}, lambda w, ids: w.generate(ids, 1000), ValueError),
    "seeds": ({}, lambda w, ids: w.generate(ids, 2, temperature=0.5,
                                            seeds=[1, 2, 3]), ValueError),
    "moe": ({"cfg": "moe"}, None, NotImplementedError),
    "stage_count": ({"devices": 3}, None, ValueError),
    "edge_bits": ({"edge_bits": 3}, None, ValueError),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_validation_errors_are_the_jax_wave_s(weights, case):
    """Each refusal of the port's wave is the JAX wave's, word for word
    (the JAX side raises before it compiles anything)."""
    kw, call, kind = ERRORS[case]
    partition = [(1, 4), (5, 12)]
    ids = _ids(29, (2, 1, 5))
    messages = []
    for pkg in ("jax", "torch"):
        with pytest.raises(kind) as exc:
            if pkg == "jax":
                wave = _jwave(weights, partition,
                              cfg=JConfig(**MOE) if "cfg" in kw else JCFG,
                              n_devices=kw.get("devices"),
                              **({"edge_bits": kw["edge_bits"]}
                                 if "edge_bits" in kw else {}))
            else:
                mesh = (tspmd.make_pipeline_mesh(kw["devices"], device="cpu")
                        if "devices" in kw else None)
                wave = SpmdDecodePipeline(
                    tgpt2.FAMILY, TConfig(**MOE) if "cfg" in kw else TCFG,
                    partition, _tparams(weights, partition), mesh,
                    max_len=MAX_LEN, device="cpu",
                    **({"edge_bits": kw["edge_bits"]}
                       if "edge_bits" in kw else {}))
            call(wave, ids)
        messages.append(str(exc.value))
    assert messages[1] == messages[0]


def test_prefix_wave_equals_monolithic_and_host_prefix(weights):
    """precompute_prefix + a suffix span wave == (a) the monolithic wave
    on prefix + suffix, (b) each slot's host prefix generate (the port's
    and the JAX package's), greedy; sampled, each slot's port host prefix
    generate with its seed."""
    wave, host = _wave(weights, THREE), _host(weights, THREE)
    prefix = _ids(41, (1, 5))
    suffix = _ids(42, (3, 2, 4))
    handle = wave.precompute_prefix(prefix)
    assert wave.stats == {"ticks": 3, "stage_steps": 3}   # one slot
    got = wave.generate(suffix, 6, prefix=handle)
    assert tuple(got.shape) == (3, 2, 10)                # prefix omitted
    full = np.concatenate([np.broadcast_to(prefix[None], (3, 2, 5)), suffix],
                          axis=2)
    torch.testing.assert_close(got, wave.generate(full, 6)[:, :, 5:],
                               rtol=0, atol=0)
    h_handle = host.precompute_prefix(prefix)
    jhost = _jhost(weights, THREE)
    j_handle = jhost.precompute_prefix(prefix)
    for r in range(3):
        torch.testing.assert_close(
            got[r], host.generate(suffix[r], 6, prefix=h_handle),
            rtol=0, atol=0)
        np.testing.assert_array_equal(
            got[r].numpy(),
            np.asarray(jhost.generate(suffix[r], 6, prefix=j_handle)))
    got_s = wave.generate(suffix, 5, temperature=0.8, seeds=[3, 4, 5],
                          prefix=handle)
    for r in range(3):
        torch.testing.assert_close(
            got_s[r], host.generate(suffix[r], 5, temperature=0.8,
                                    seed=3 + r, prefix=h_handle),
            rtol=0, atol=0)


def test_prefix_handles_are_checked(weights):
    wave = _wave(weights, THREE)
    handle = wave.precompute_prefix(_ids(41, (5,)))
    suffix = _ids(42, (3, 2, 4))
    bad = {k: v for k, v in handle.items() if k != "sig"}
    with pytest.raises(ValueError, match="precompute_prefix handle"):
        wave.generate(suffix, 4, prefix=bad)
    sig = list(handle["sig"])
    sig[2] += 16                                         # max_len
    with pytest.raises(ValueError, match="incompatible"):
        wave.generate(suffix, 4, prefix=dict(handle, sig=tuple(sig)))
    with pytest.raises(ValueError, match="non-empty suffix"):
        wave.generate(suffix[:, :, :0], 4, prefix=handle)
    with pytest.raises(ValueError, match="one sequence"):
        wave.precompute_prefix(_ids(41, (2, 5)))


def test_prefix_with_8_bit_edges(weights):
    """The suffix span wave rides the prefill wave's edge codec, so the
    8-bit prefix path equals the 8-bit monolithic wave; a raw-edge wave
    refuses the 8-bit handle (edge_bits is in the stamp)."""
    wave = _wave(weights, THREE, edge_bits=8)
    prefix = _ids(47, (1, 5))
    suffix = _ids(48, (3, 2, 4))
    handle = wave.precompute_prefix(prefix)
    got = wave.generate(suffix, 6, prefix=handle)
    full = np.concatenate([np.broadcast_to(prefix[None], (3, 2, 5)), suffix],
                          axis=2)
    torch.testing.assert_close(got, wave.generate(full, 6)[:, :, 5:],
                               rtol=0, atol=0)
    assert handle["sig"][-1] == 8
    with pytest.raises(ValueError, match="incompatible"):
        _wave(weights, THREE).generate(suffix, 4, prefix=handle)


def test_speculative_wave_equals_the_wave_s_greedy(weights):
    """Verify spans ride one span wave per round: a self-draft accepts
    every proposal; a perturbed draft (accept and reject rounds) gives
    the wave's greedy tokens."""
    wave = _wave(weights, THREE, max_len=40)
    whole = [(1, TOTAL)]
    ids = _ids(43, (3, 2, 6))
    want = wave.generate(ids, 8)
    draft = tdec.DecodePipeline(tgpt2.FAMILY, TCFG, whole,
                                _tparams(weights, whole), max_len=40,
                                device="cpu")
    spec = SpmdSpeculativeDecoder(wave, draft, gamma=3)
    torch.testing.assert_close(spec.generate(ids, 8), want, rtol=0, atol=0)
    assert spec.last_acceptance_rate == 1.0
    # noise at a quarter of the weights' 0.02 scale: some proposals of
    # every generation are rejected, some accepted
    rng = np.random.default_rng(7)
    noisy = {k: v + 0.005 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in weights.items()}
    draft2 = tdec.DecodePipeline(tgpt2.FAMILY, TCFG, whole,
                                 _tparams(noisy, whole), max_len=40,
                                 device="cpu")
    spec2 = SpmdSpeculativeDecoder(wave, draft2, gamma=2)
    torch.testing.assert_close(spec2.generate(ids, 8), want, rtol=0, atol=0)
    assert 0.0 < spec2.last_acceptance_rate < 1.0
    with pytest.raises(ValueError, match="gamma must be >= 1"):
        SpmdSpeculativeDecoder(wave, draft, gamma=0)
    other = dataclasses.replace(TCFG, vocab_size=101)
    draft.cfg, cfg = other, draft.cfg
    try:
        with pytest.raises(ValueError, match="share a vocabulary"):
            SpmdSpeculativeDecoder(wave, draft)
    finally:
        draft.cfg = cfg


@pytest.mark.parametrize("model", ["pipeedge/test-tiny-llama",
                                   "pipeedge/test-tiny-mistral"])
def test_llama_family_wave_equals_the_jax_host(model):
    """The Llama family rides the wave through its cached_block_step and
    decode/span embedding hooks: each slot equals the JAX host pipeline
    (the tiny Mistral's steps cross its 4-token window)."""
    partition = [(1, 4), (5, 8)]
    jcfg = jreg.get_model_config(model)
    jparams = [jllama.init_params(jcfg, JShardConfig(
        l, r, is_first=l == 1, is_last=r == 8), seed=3) for l, r in partition]
    wave = SpmdDecodePipeline(
        tllama.FAMILY, treg.get_model_config(model), partition,
        [params_from_jax(jax.device_get(p)) for p in jparams],
        max_len=MAX_LEN, device="cpu")
    host = jdec.DecodePipeline(jllama.FAMILY, jcfg, partition, jparams,
                               max_len=MAX_LEN)
    ids = _ids(9, (2, 2, 6))
    got = wave.generate(ids, 7).numpy()
    for r in range(2):
        np.testing.assert_array_equal(
            got[r], np.asarray(host.generate(ids[r], 7)), err_msg=f"slot {r}")


def test_walk_is_the_valid_stage_steps(weights):
    """A wave is R x K stage-steps: every block runs once per slot per
    wave (no fill or drain tick on garbage), over R + K - 1 prefill and
    (N - 1) R + K - 1 decode ticks."""
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return tdec._block_step(*args, **kw)

    family = dataclasses.replace(tgpt2.FAMILY, cached_block_step=counting)
    wave = SpmdDecodePipeline(family, TCFG, TWO, _tparams(weights, TWO),
                              max_len=MAX_LEN, device="cpu")
    new = 5
    want = _wave(weights, TWO).generate(_ids(3, (2, 2, 4)), new)
    got = wave.generate(_ids(3, (2, 2, 4)), new)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    r = k = 2
    assert len(calls) == r * 3 * new               # 3 blocks, N waves
    assert wave.stats == {"ticks": (r + k - 1) + (new - 1) * r + k - 1,
                          "stage_steps": r * k * new}


def test_mesh_forms_are_one_wave(weights):
    """The stage mesh may be given as a `PipelineMesh` of dp 1, a list of
    one device per stage, or left to `devices_for`: one wave; a mesh with
    a dp or an inner axis is refused."""
    ids = _ids(5, (2, 2, 4))
    params = _tparams(weights, TWO)
    outs = [SpmdDecodePipeline(tgpt2.FAMILY, TCFG, TWO, params, mesh,
                               max_len=MAX_LEN, device="cpu").generate(ids, 3)
            for mesh in (None, ["cpu", "cpu"],
                         tspmd.make_pipeline_mesh(2, device="cpu"))]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="over a \\('stage',\\) mesh"):
        SpmdDecodePipeline(tgpt2.FAMILY, TCFG, TWO, params,
                           tspmd.make_pipeline_mesh(2, dp=2, device="cpu"),
                           max_len=MAX_LEN)
