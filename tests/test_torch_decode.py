"""The port's KV-cache decoding against the JAX `DecodePipeline`.

On `pipeedge/test-tiny-gpt2` with one set of HF-layout random weights
(loaded by both packages), prompts of 6 tokens, max_len 32 and attend
floor 8, so the decode steps cross the 8 -> 16 -> 32 attend buckets:

- greedy tokens identical to the JAX pipeline's, over 1 and 2 stages,
  with an fp cache and with an int8 cache on both routes (dequantize-then-
  attend, and the decode-attention kernel: interpret mode in JAX, the
  plain version here);
- beam search identical;
- the port's own invariants: step logits equal the full-sequence forward
  (rtol=1e-4, atol=1e-5, f32: different matmul shapes sum in different
  orders), prefix reuse, chunked prefill and spans equal the plain path,
  sampling is deterministic per seed, and the validation errors.
"""
import jax
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch import generate as tgenerate
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models.convert import params_from_jax
from pipeedge_tpu_torch.models.shard import shard_apply
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.parallel import decode as tdec

MODEL = "pipeedge/test-tiny-gpt2"
CFG = treg.get_model_config(MODEL)
PARTITIONS = {1: [(1, 8)], 2: [(1, 4), (5, 8)]}
MAX_LEN, FLOOR, PROMPT = 32, 8, 6
RTOL, ATOL = 1e-4, 1e-5
# cache mode -> (cache_bits, int8 decode-attend opt-in)
MODES = {"fp": (0, 0), "int8": (8, 0), "int8_kernel": (8, 1)}


@pytest.fixture(scope="module")
def weights():
    return tgpt2.random_npz_weights(CFG, seed=1)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(21).integers(0, CFG.vocab_size,
                                              size=(3, PROMPT))


def _jax_stage_params(weights, partition):
    jcfg = jreg.get_model_config(MODEL)
    return [jgpt2.load_params(jcfg, JShardConfig(l, r, is_first=l == 1,
                                                 is_last=r == 8), weights)
            for l, r in partition]


def _jax_pipe(weights, stages, mode="fp"):
    bits, optin = MODES[mode]
    partition = PARTITIONS[stages]
    return jdec.DecodePipeline(
        jgpt2.FAMILY, jreg.get_model_config(MODEL), partition,
        _jax_stage_params(weights, partition), max_len=MAX_LEN,
        cache_bits=bits, attend_floor=FLOOR, int8_decode_attend=optin)


def _pipe(weights, stages, mode="fp", **kw):
    bits, optin = MODES[mode]
    partition = PARTITIONS[stages]
    params = [params_from_jax(jax.device_get(p))
              for p in _jax_stage_params(weights, partition)]
    return tdec.DecodePipeline(tgpt2.FAMILY, CFG, partition, params,
                               max_len=MAX_LEN, device="cpu",
                               cache_bits=bits, attend_floor=FLOOR,
                               int8_decode_attend=optin, **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stages", [1, 2])
def test_greedy_tokens_match_jax(weights, ids, stages, mode):
    new = 11                  # decode positions 6..15: buckets 8 and 16
    want = np.asarray(_jax_pipe(weights, stages, mode).generate(ids, new))
    pipe = _pipe(weights, stages, mode)
    got = pipe.generate(ids, new).numpy()
    np.testing.assert_array_equal(got, want)
    assert {pipe._read_len(p) for p in range(PROMPT, PROMPT + new - 1)} \
        == {8, 16}
    # CPU tensors run the plain versions: no kernel launched
    assert all(v == 0 for v in _build.launch_counts.values())


def test_beam_search_matches_jax(weights, ids):
    want = np.asarray(_jax_pipe(weights, 2).generate_beam(ids, 7, beams=3))
    got = _pipe(weights, 2).generate_beam(ids, 7, beams=3).numpy()
    np.testing.assert_array_equal(got, want)
    # width 1 is greedy
    pipe = _pipe(weights, 1)
    assert torch.equal(pipe.generate_beam(ids, 5, beams=1),
                       pipe.generate(ids, 5))


@pytest.mark.parametrize("stages", [1, 2])
def test_step_logits_match_full_forward(weights, ids, stages):
    """Prefill and decode-step logits against the port's own single-shard
    forward over the whole sequence (the causal fused attention)."""
    pipe = _pipe(weights, stages)
    seq = torch.from_numpy(np.concatenate(
        [ids, np.random.default_rng(2).integers(0, 100, size=(3, 5))], 1))
    params = tgpt2.load_params(CFG, treg.make_shard_config(MODEL, 1, 8),
                               weights)
    full = shard_apply(tgpt2.FAMILY, CFG, treg.make_shard_config(MODEL, 1, 8),
                       params, seq).numpy()
    data, caches = pipe._prefill(seq[:, :PROMPT])
    np.testing.assert_allclose(data.numpy(), full[:, :PROMPT], rtol=RTOL,
                               atol=ATOL)
    for t in range(PROMPT, seq.shape[1]):
        data = seq[:, t:t + 1]
        for i, st in enumerate(pipe.stages):
            data, caches[i] = pipe._decode_step(st, data, caches[i], t)
        np.testing.assert_allclose(data[:, 0].numpy(), full[:, t],
                                   rtol=RTOL, atol=ATOL)


def test_extend_equals_serial_steps(weights, ids):
    pipe = _pipe(weights, 2)
    span = torch.from_numpy(np.array([[5, 9, 13], [1, 2, 3], [7, 7, 7]]))
    _, caches = pipe._prefill(torch.from_numpy(ids))
    out, caches = pipe.extend(span, caches, PROMPT)
    _, serial = pipe._prefill(torch.from_numpy(ids))
    for j in range(span.shape[1]):
        data = span[:, j:j + 1]
        for i, st in enumerate(pipe.stages):
            data, serial[i] = pipe._decode_step(st, data, serial[i],
                                                PROMPT + j)
        np.testing.assert_allclose(out[:, j].numpy(), data[:, 0].numpy(),
                                   rtol=RTOL, atol=ATOL)
    for c, s in zip(caches, serial):
        np.testing.assert_allclose(c["k"].numpy(), s["k"].numpy(),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="max_len"):
        pipe.extend(span, caches, MAX_LEN - 2)


@pytest.mark.parametrize("stages", [1, 2])
def test_prefix_reuse_equals_plain_and_leaves_handle_intact(weights, stages):
    pipe = _pipe(weights, stages)
    ids = np.random.default_rng(4).integers(0, 100, size=(3, 8))
    ids[:, :5] = ids[0, :5]
    want = pipe.generate(ids, 6)
    handle = pipe.precompute_prefix(ids[0, :5])
    kept = [{k: v.clone() for k, v in c.items()} for c in handle["caches"]]
    for _ in range(2):        # a second use reads the same, untouched rows
        got = pipe.generate(ids[:, 5:], 6, prefix=handle)
        assert torch.equal(got, want[:, 5:])
    for c, k in zip(handle["caches"], kept):
        assert all(torch.equal(c[name], k[name]) for name in c)


def test_prefill_ubatch_equals_whole(weights, ids):
    for mode in ("fp", "int8"):
        pipe = _pipe(weights, 2, mode)
        assert torch.equal(pipe.generate(ids, 6, prefill_ubatch=1),
                           pipe.generate(ids, 6))
    with pytest.raises(ValueError, match="divisible"):
        pipe.generate(ids, 6, prefill_ubatch=2)
    with pytest.raises(ValueError, match="positive"):
        pipe._prefill(torch.from_numpy(ids), prefill_ubatch=0)


def test_cache_reorders_copy():
    cache = tdec.init_cache(CFG, 2, 2, 8, cache_bits=8)
    rows = torch.tensor([0, 0, 1])
    for out in (tdec._repeat_batch(cache, 1), tdec._repeat_batch(cache, 3),
                tdec._gather_batch(cache, rows)):
        assert set(out) == set(cache)
        for name, t in out.items():
            assert t.untyped_storage().data_ptr() != \
                cache[name].untyped_storage().data_ptr()
    assert tdec._gather_batch(cache, rows)["k"].shape[1] == 3
    assert tdec._repeat_batch(cache, 3)["k_scale"].shape == (2, 6, 8, 4)


def test_sampling_deterministic_per_seed(weights, ids):
    pipe = _pipe(weights, 1)
    a = pipe.generate(ids, 8, temperature=0.9, seed=1)
    assert torch.equal(a, pipe.generate(ids, 8, temperature=0.9, seed=1))
    assert not torch.equal(a, pipe.generate(ids, 8, temperature=0.9, seed=2))
    assert int(a.min()) >= 0 and int(a.max()) < CFG.vocab_size
    greedy = pipe.generate(ids, 8)
    assert torch.equal(pipe.generate(ids, 8, temperature=1.0, top_k=1,
                                     seed=3), greedy)
    beats = []
    pipe.generate(ids, 4, temperature=0.5, top_k=5,
                  step_callback=lambda step, tok: beats.append(
                      (step, tuple(tok.shape))))
    assert beats == [(s, (3,)) for s in range(4)]


def test_top_k_keeps_exactly_k():
    logits = torch.tensor([[3.0, 3.0, 3.0, 0.0, -1.0]] * 400)
    gen = torch.Generator().manual_seed(0)
    picks = tdec.make_token_picker(1.0, top_k=2)(logits, gen)
    assert set(picks.tolist()) <= {0, 1, 2} and len(set(picks.tolist())) <= 2


def test_helpers_match_jax():
    for pos_next in range(1, 65):
        assert tdec.attend_bucket(pos_next, 64, 8) == \
            jdec.attend_bucket(pos_next, 64, 8)
    for partition in ([(1, 21), (22, 48)], [(1, 2), (3, 46), (47, 48)],
                      [(1, 10), (11, 30), (31, 48)]):
        assert tdec.round_partition_to_blocks(partition, 48) == \
            jdec.round_partition_to_blocks(partition, 48)


def test_validation_errors(weights):
    entry = treg.get_model_entry(MODEL)
    params = tgpt2.init_params(CFG, treg.make_shard_config(MODEL, 1, 8))

    def make(partition=((1, 8),), stage_params=(params,), **kw):
        kw.setdefault("max_len", MAX_LEN)
        return tdec.DecodePipeline(entry.family.FAMILY, CFG, list(partition),
                                   list(stage_params), device="cpu", **kw)

    with pytest.raises(ValueError, match="cover"):
        make(partition=[(1, 4), (6, 8)], stage_params=[params, params])
    with pytest.raises(ValueError, match="block-aligned"):
        tdec.make_stage_fns(entry.family.FAMILY, CFG,
                            treg.make_shard_config(MODEL, 1, 6))
    with pytest.raises(ValueError, match="positions"):
        make(max_len=CFG.max_position_embeddings + 1)
    with pytest.raises(ValueError, match="attend_floor"):
        make(attend_floor=0)
    with pytest.raises(ValueError, match="cache_bits"):
        tdec.init_cache(CFG, 2, 1, 8, cache_bits=4)
    for mesh_arg in ("mesh", "sp_mesh", "ep_mesh", "tp_ep_mesh"):
        with pytest.raises(ValueError, match="ROADMAP A7"):
            make(**{mesh_arg: object()})
    with pytest.raises(TypeError):
        make(devices=["cpu"])
    with pytest.raises(ValueError, match="pos_next"):
        tdec.attend_bucket(65, 64)
    pipe = make()
    ids = np.zeros((2, 4), np.int64)
    with pytest.raises(ValueError, match="exceeds max_len"):
        pipe.generate(ids, MAX_LEN)
    with pytest.raises(ValueError, match="beams"):
        pipe.generate_beam(ids, 3, beams=0)
    assert torch.equal(pipe.generate(ids, 0), torch.from_numpy(ids))
    handle = pipe.precompute_prefix(ids[0])
    with pytest.raises(ValueError, match="non-empty suffix"):
        pipe.generate(ids[:, :0], 3, prefix=handle)
    with pytest.raises(ValueError, match="prefill-ubatch"):
        pipe.generate(ids, 3, prefix=handle, prefill_ubatch=1)
    with pytest.raises(ValueError, match="incompatible"):
        make(max_len=16).check_prefix(handle)
    with pytest.raises(ValueError, match="sig"):
        pipe.check_prefix({"caches": handle["caches"], "len": 4})
    with pytest.raises(ValueError, match="one sequence"):
        pipe.precompute_prefix(ids)


def test_generate_entry_cpu_prints_report(capsys):
    out = tgenerate.main([
        "-m", MODEL, "-pt", "1,4,5,8", "-b", "3", "--prompt-len", "6",
        "--new-tokens", "12", "--max-len", "32", "--attend-floor", "8",
        "--kv-bits", "8", "--device", "cpu"])
    assert out.shape == (3, 18)
    lines = capsys.readouterr().out.splitlines()
    report = [ln for ln in lines if ln.startswith("generated 3x12 tokens in")]
    assert len(report) == 1 and "tok/s (2 stages)" in report[0]
    sample = [ln for ln in lines if ln.startswith("sample continuation ids:")]
    assert sample == [f"sample continuation ids: {out[0, 6:].tolist()}"]
    launches = [ln for ln in lines if ln.startswith("kernel_launches=")]
    assert launches == ['kernel_launches={"decode_attention": 0, '
                        '"fused_attention": 0, "fused_decode": 0, '
                        '"fused_encode": 0, "int8_matmul": 0}']


@pytest.mark.parametrize("extra", [
    ["--beams", "2", "--temperature", "0.5"],
    ["--beams", "2", "--prefill-ubatch", "1"],
    ["--shared-prefix", "6"],
    ["-pt", "1,4,5"],
    ["--new-tokens", "0"],
])
def test_generate_entry_rejects_bad_flags(extra):
    with pytest.raises(SystemExit):
        tgenerate.parse_args(["-m", MODEL, "--prompt-len", "6", "--device",
                              "cpu", *extra])
