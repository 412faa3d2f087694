"""The port's host pipeline: its own single-shard oracle, and the JAX one.

- Raw edges: the pipeline's output equals the single-shard forward bit for
  bit (same ops on the same shapes on one device; the oracle of
  tests/test_pipeline.py).
- Quantized edges: the port's codec turns the JAX stage-0 payload into
  the JAX wire words exactly, and the port pipeline's logits stay within
  a stated bound of the JAX pipeline's (below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.ops import clamp as jclamp
from pipeedge_tpu.ops import quant as jquant
from pipeedge_tpu.parallel import pipeline as jpipe
from pipeedge_tpu.parallel.pipeline import HostPipeline as JHostPipeline
from pipeedge_tpu.parallel.pipeline import PipelineStage as JPipelineStage
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.ops import quant as tquant
from pipeedge_tpu_torch.parallel import pipeline as tpipe

MODEL = "pipeedge/test-tiny-vit"
CFG = treg.get_model_config(MODEL)
CUT = [(1, 5), (6, 8)]       # after sublayer 0 of block 1: a 2-tuple edge


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(CFG, seed=11))
    return str(path)


def _ubatches(n, seed, size=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(size, 3, 16, 16)).astype(np.float32)
            for _ in range(n)]


def _torch_pipe(weights_file, partition, bits=None):
    return tpipe.build_pipeline(MODEL, partition, model_file=weights_file,
                                device="cpu", quant_bits=bits)


def _jax_pipe(weights_file, partition, bits=None):
    dev = jax.devices()[0]
    stages = []
    for i, (l, r) in enumerate(partition):
        fn, params, _ = jreg.module_shard_factory(MODEL, weights_file, l, r,
                                                  stage=i)
        bit = 0 if bits is None or i == len(partition) - 1 else bits[i]
        stages.append(JPipelineStage(shard_fn=fn, params=params, device=dev,
                                     quant_bit=bit))
    return JHostPipeline(stages)


def test_raw_edges_equal_single_shard(weights_file):
    ubatches = [torch.from_numpy(u) for u in _ubatches(4, seed=0)]
    expected, _ = _torch_pipe(weights_file, [(1, 8)]).run(ubatches)
    partition = [(1, 1), (2, 5), (6, 7), (8, 8)]   # incl. tuple edges
    got, stats = _torch_pipe(weights_file, partition).run(ubatches)
    assert stats["microbatches"] == 4 and stats["throughput_items_sec"] > 0
    for e, g in zip(expected, got):
        assert torch.equal(g, e)


@pytest.mark.parametrize("bit", [4, 8])
def test_port_encodes_jax_stage_payload_word_for_word(weights_file, bit):
    x = jnp.asarray(_ubatches(1, seed=1)[0])
    fn, params, _ = jreg.module_shard_factory(MODEL, weights_file, *CUT[0])
    raw = JPipelineStage(fn, params, jax.devices()[0], quant_bit=0)(x)
    assert isinstance(raw, tuple) and len(raw) == 2
    # The JAX stage encodes inside its own program, where XLA's fusion may
    # move an activation by an ulp; the codec is compared on the payload
    # itself: the JAX pipeline's encode of stage 0's output, raw and
    # Banner-clamped (the clamp itself: tests/test_torch_quant.py).
    tensors = list(raw) + [jclamp.clamp_banner2019_laplace(t, bit)
                           for t in raw]
    for r in tensors:
        w = jpipe._encode_payload(r, bit, clamp=False)
        enc = tpipe._encode_payload(torch.from_numpy(np.array(r)), bit,
                                    clamp=False)
        np.testing.assert_array_equal(tquant.words_u32(enc),
                                      np.asarray(w.data))
        np.testing.assert_array_equal(enc.scale.numpy(), np.asarray(w.scale))
        np.testing.assert_array_equal(enc.shift.numpy(), np.asarray(w.shift))
        # and the port decodes the JAX wire words
        j_dec = np.asarray(jquant.tensor_decode_outerdim(w))
        t_dec = tpipe._decode_payload(tquant.QuantizedTensor(
            data=torch.from_numpy(np.array(w.data).view(np.int32)),
            scale=torch.from_numpy(np.array(w.scale)),
            shift=torch.from_numpy(np.array(w.shift)),
            shape=tuple(w.shape), bit=bit))
        np.testing.assert_allclose(t_dec.numpy(), j_dec, rtol=0, atol=2e-6)


# Stage outputs of the two packages differ in the last bits (f32 sum
# order), and a value that sits on a rounding boundary of the codec may
# then land one level apart: an error of scale / (2^b - 1) in one element
# of the edge. The bound is a tenth of the logits' own quantization error
# at that bitwidth (JAX quantized vs JAX exact), plus f32 noise.
@pytest.mark.parametrize("bit", [4, 8])
def test_quantized_pipeline_logits_near_jax(weights_file, bit):
    ubatches = _ubatches(2, seed=2)
    exact, _ = _jax_pipe(weights_file, [(1, 8)]).run(
        [jnp.asarray(u) for u in ubatches])
    want, _ = _jax_pipe(weights_file, CUT, bits=[bit]).run(
        [jnp.asarray(u) for u in ubatches])
    got, _ = _torch_pipe(weights_file, CUT, bits=[bit]).run(
        [torch.from_numpy(u) for u in ubatches])
    for e, w, g in zip(exact, want, got):
        e, w, g = np.asarray(e), np.asarray(w), g.numpy()
        quant_err = np.max(np.abs(w - e))
        assert quant_err > 0
        assert np.max(np.abs(g - w)) <= 0.1 * quant_err + 1e-5


def test_fifo_order_and_stats_keys(weights_file):
    pipe = _torch_pipe(weights_file, CUT, bits=[8])
    base = _ubatches(1, seed=3, size=1)[0]
    ubatches = [torch.from_numpy(base * (i + 1)) for i in range(6)]
    seen, edges = [], []
    pipe.ubatch_callback = lambda i, out: seen.append(i)
    pipe.edge_bytes_callback = lambda i, b: edges.append(b)
    results, stats = pipe.run(ubatches)
    assert seen == list(range(6))
    for key in ("latency_sec", "throughput_items_sec",
                "steady_state_throughput_items_sec", "latency_breakdown"):
        assert key in stats
    assert set(stats["latency_breakdown"]) == {"fill_ms", "steady_p50_ms",
                                               "steady_p99_ms"}
    n = 17 * CFG.hidden_size          # tokens x width per item
    per_tensor = tquant.packed_words(n, 8) * 4 + 8
    assert edges == [[2 * per_tensor]] * 6
    outs = [r.numpy() for r in results]
    for a, b in zip(outs, outs[1:]):
        assert not np.allclose(a, b)


def test_quant_bit_changes_between_runs(weights_file):
    pipe = _torch_pipe(weights_file, CUT, bits=[8])
    x = [torch.from_numpy(_ubatches(1, seed=4)[0])]
    out8, _ = pipe.run(x)
    pipe.stages[0].quant_bit = 4
    out4, _ = pipe.run(x)
    pipe.stages[0].quant_bit = 0
    out0, _ = pipe.run(x)
    assert not torch.equal(out8[0], out4[0])
    assert np.abs((out8[0] - out0[0]).numpy()).max() < \
        np.abs((out4[0] - out0[0]).numpy()).max()


def test_plan_microbatches_matches_jax():
    from pipeedge_tpu.parallel.pipeline import plan_microbatches as jplan
    for args in [(64, 2, 1e-3, 5e-3, None), (64, 4, 2e-3, 1e-4, 16),
                 (7, 3, 0.0, 1e-3, None)]:
        assert tpipe.plan_microbatches(*args) == jplan(*args)
