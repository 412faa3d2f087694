"""The port's quantized collectives against the JAX package.

`pipeedge_tpu_torch/ops/qcollectives.py` takes a shard group on
`[cpu] * n` and a per-shard list; the JAX functions run under
`shard_map(out_specs=P('tp'))` on n of the conftest's 8 CPU devices, so
both give every shard's own result. Inputs come from a numpy seed.

Tolerances, with their reasons:
- bits 0: the exact all-reduce sums f32 in shard order on both sides:
  equal. In bf16 each add rounds and XLA adds in its own order: within n
  half-ulps of the largest partial sum.
- bits 4/8: the encode is bit-identical to the JAX one on the same input
  and the CPU decode differs from XLA's by 1-2 ulp (`ROADMAP.md` §C), so
  each shard's result is within atol=2e-6 of JAX's scaled by the
  element's magnitude. A later ring hop re-encodes a decoded partial
  sum, and a 1-ulp difference there can move a code across a rounding
  boundary: such an element may differ by one quantization step of its
  block. At most 1% of the elements may, and every element of both
  packages stays within `qpsum_error_bound` of the exact sum.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipeedge_tpu.ops import qcollectives as jq
from pipeedge_tpu.utils import jax_compat
from pipeedge_tpu_torch import telemetry
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.ops import qcollectives as tq
from pipeedge_tpu_torch.parallel import mesh as tmesh
from pipeedge_tpu_torch.parallel import tensor as ttp
from pipeedge_tpu_torch.telemetry import report

ULP_ATOL = 2e-6


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _group(n):
    return tmesh.ShardGroup(tmesh.devices_for(n, "cpu"))


def _shards(n, m, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, m)) * scale
            ).astype(np.float32)


def _jax_qpsum(x, bit, **kw):
    n = x.shape[0]
    fn = jax.jit(jax_compat.shard_map(
        partial(jq.qpsum, axis_name="tp", bit=bit, **kw), mesh=_mesh(n),
        in_specs=P("tp"), out_specs=P("tp")))
    return np.asarray(fn(jnp.asarray(x).reshape((-1,) + x.shape[2:]))
                      ).reshape(x.shape)


def _port_qpsum(x, bit, dtype=torch.float32, **kw):
    n = x.shape[0]
    out = tq.qpsum(_group(n), [torch.from_numpy(x[i]).to(dtype)
                               for i in range(n)], bit, **kw)
    return np.stack([o.float().numpy() for o in out])


def _assert_codec_close(got, want, step):
    """Within ULP_ATOL x magnitude, except <= 1% of the elements within
    one quantization `step` (a code moved across a rounding boundary)."""
    diff = np.abs(got - want)
    loose = diff > ULP_ATOL * np.maximum(1.0, np.abs(want))
    assert loose.mean() <= 0.01, (loose.sum(), diff.max())
    assert diff.max() <= step + ULP_ATOL, diff.max()


CASES = {
    "aligned": dict(m=1024),
    "odd_length": dict(m=333),
    "clamped": dict(m=1000, clamp=True),
    "bf16": dict(m=512, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bit", [0, 4, 8])
def test_qpsum_matches_jax_per_shard(bit, n, case):
    spec = dict(CASES[case])
    m = spec.pop("m")
    dtype = spec.pop("dtype", "float32")
    x = _shards(n, m, seed=bit * 10 + n + m)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        want = _jax_qpsum(np.asarray(jnp.asarray(x, jnp.bfloat16)), bit,
                          **spec).astype(np.float32)
        got = _port_qpsum(x, bit, dtype=torch.bfloat16, **spec)
    else:
        want = _jax_qpsum(x, bit, **spec)
        got = _port_qpsum(x, bit, **spec)
    assert got.shape == want.shape == (n, m)
    absrange = float(max(x[i].max() - x[i].min() for i in range(n)))
    if bit == 0:
        if dtype == "bfloat16":
            # a bf16 all-reduce rounds each of its n - 1 adds, and XLA
            # adds in another order: n half-ulps of the largest partial
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=n * 2 ** -8 * float(np.abs(x).sum(axis=0).max()))
        else:
            np.testing.assert_array_equal(got, want)
        return
    levels = (1 << bit) - 1
    step = n * absrange / levels
    if dtype == "bfloat16":
        # the bf16 result rounds a value within the step: one bf16 ulp more
        step += 2 ** -7 * float(np.abs(want).max())
    _assert_codec_close(got, want, step)
    if not spec.get("clamp"):
        exact = x.sum(axis=0)
        bound = tq.qpsum_error_bound(absrange, bit, n)
        if dtype == "bfloat16":
            bound += 2 ** -7 * float(np.abs(exact).max())
        for res in (got, want):
            assert np.abs(res - exact[None]).max() <= bound


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "stacked"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bit", [0, 4, 8])
def test_qall_gather_matches_jax(bit, n, tiled):
    x = np.random.default_rng(bit + n).normal(size=(n, 3, 50)).astype(
        np.float32)
    fn = jax.jit(jax_compat.shard_map(
        partial(jq.qall_gather, axis_name="tp", bit=bit, axis=1,
                tiled=tiled), mesh=_mesh(n), in_specs=P("tp"),
        out_specs=P("tp")))
    want = np.asarray(fn(jnp.asarray(x.reshape(n * 3, 50))))
    out = tq.qall_gather(_group(n), [torch.from_numpy(x[i])
                                     for i in range(n)], bit, axis=1,
                         tiled=tiled)
    got = np.concatenate([o.numpy() for o in out])
    assert got.shape == want.shape
    if bit == 0:
        np.testing.assert_array_equal(got, want)
        return
    # each piece is decoded once from the JAX-identical encode: 1-2 ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP_ATOL)
    for i, shard in enumerate(out):
        # the local shard enters exact
        mine = shard.reshape(3, n, 50)[:, i] if tiled else shard[:, i]
        np.testing.assert_array_equal(mine.numpy(), x[i])


def test_qpsum_one_shard_and_invalid_bits():
    x = torch.arange(6.0)
    assert tq.qpsum(_group(1), [x], 8)[0] is x
    for fn in (tq.qpsum, tq.qall_gather):
        with pytest.raises(ValueError) as got:
            fn(_group(2), [x, x], 3)
        with pytest.raises(ValueError) as want:
            jq._check_bit(3)
        assert str(got.value) == str(want.value)


def test_qpsum_deterministic_and_own_chunk_unquantized():
    """Shard i reduces chunk (i + 1) % n: at n = 2 the other shard's
    addend arrives quantized once and the sum stays f32 on shard i, where
    the other shard receives that sum quantized once more."""
    from pipeedge_tpu_torch.ops import quant as tquant

    n, m = 2, 1024
    x = _shards(n, m, seed=4)
    first, second = _port_qpsum(x, 8), _port_qpsum(x, 8)
    np.testing.assert_array_equal(first, second)
    chunk = m // n

    def roundtrip(v):
        enc = tquant.tensor_encode_outerdim(
            torch.from_numpy(v).reshape(-1, tq.DEFAULT_BLOCK), 8)
        return tquant.tensor_decode_outerdim(enc).reshape(-1).numpy()

    for i in range(n):
        own = slice(((i + 1) % n) * chunk, ((i + 1) % n + 1) * chunk)
        want = roundtrip(x[(i - 1) % n, own]) + x[i, own]
        np.testing.assert_array_equal(first[i, own], want)
        np.testing.assert_array_equal(first[(i + 1) % n, own],
                                      roundtrip(want))


def _record_both(executions=3):
    """One qpsum at bits 4 and one stacked qall_gather at bits 8 through
    each package, folded by record_collectives; -> (port tally, port
    summary, port spans, port counter delta, the JAX three)."""
    out = []
    for mod, run in (
            (tq, lambda: (
                tq.qpsum(_group(2), [torch.from_numpy(r) for r in
                                     _shards(2, 512, seed=13)], 4),
                tq.qall_gather(_group(2), [torch.ones(1, 700)] * 2, 8,
                               tiled=False))),
            (jq, lambda: (
                _jax_qpsum(_shards(2, 512, seed=13), 4),
                np.asarray(jax.jit(jax_compat.shard_map(
                    partial(jq.qall_gather, axis_name="tp", bit=8,
                            tiled=False), mesh=_mesh(2), in_specs=P("tp"),
                    out_specs=P("tp")))(jnp.ones((2, 700))))))):
        mod.reset_trace_tally()
        run()
        tally = mod.trace_tally()
        before = mod.COLLECTIVE_BITS_TOTAL.total()
        if mod is tq:
            rec = telemetry.configure(rank=0)
        else:
            from pipeedge_tpu import telemetry as jtelemetry
            rec = jtelemetry.configure(rank=0)
        try:
            summary = mod.record_collectives(executions=executions, stage=1)
        finally:
            spans = rec.snapshot()
            (telemetry if mod is tq else jtelemetry).disable()
        out.append((tally, summary, spans,
                    mod.COLLECTIVE_BITS_TOTAL.total() - before))
        mod.reset_trace_tally()
    return out


def test_tally_spans_and_counter_match_jax():
    (t_tally, t_sum, t_spans, t_bits), (j_tally, j_sum, j_spans, j_bits) = \
        _record_both()
    keys = ("kind", "bit", "n_shards", "wire_bytes", "raw_bytes")
    assert sorted(tuple(t[k] for k in keys) for t in t_tally) == \
        sorted(tuple(t[k] for k in keys) for t in j_tally)
    assert all(t["calls"] == 1 for t in t_tally)
    assert {k: v for k, v in t_sum.items() if k != "calls"} == j_sum
    assert t_sum["calls"] == 2
    name = lambda spans: sorted(  # noqa: E731
        (s["name"], s["stage"]) for s in spans if s["cat"] == "collective")
    assert name(t_spans) == name(j_spans)
    assert t_bits == j_bits == t_sum["wire_bits_total"]
    # int4 psum: ~8x smaller than f32 minus the scale/shift metadata
    psum = next(t for t in t_tally if t["kind"] == "psum")
    assert 7.0 < psum["raw_bytes"] / psum["wire_bytes"] < 8.0


def test_repeated_calls_fold_into_one_site_per_footprint():
    """Eager calls tally per execution: two calls of one footprint are one
    site with calls=2, the bytes of both."""
    tq.reset_trace_tally()
    x = [torch.from_numpy(r) for r in _shards(2, 1024, seed=9)]
    tq.qpsum(_group(2), x, 8)
    tq.qpsum(_group(2), x, 8)
    (site,) = tq.trace_tally()
    assert site["calls"] == 2
    summary = tq.record_collectives()
    assert summary["sites"] == 1 and summary["calls"] == 2
    assert summary["wire_bits_total"] == 2 * 8 * site["wire_bytes"]
    tq.reset_trace_tally()
    assert tq.trace_tally() == []


def test_report_folds_the_recorded_spans():
    """`telemetry/report.py` (what `trace_report` prints) reads the spans
    this module records: by kind, per stage, bytes as recorded."""
    (_, t_sum, t_spans, _), _ = _record_both(executions=1)
    col = report.analyze_spans(t_spans)["collectives"]
    assert col["sites"] == 2
    assert col["wire_bytes"] * 8 == t_sum["wire_bits_total"]
    assert set(col["by_kind"]) == {"psum4", "all_gather8"}
    assert col["per_stage"]["stage1"]["wire_bytes"] == col["wire_bytes"]


def test_quantized_tp_block_close_to_exact():
    """The Megatron block with quantized all-reduces stays within 0.05 of
    the exact block (max |x| scale), and the gate really flips it."""
    model = "pipeedge/test-tiny-vit"
    cfg = registry.get_model_config(model)
    bp = registry.module_shard_factory(model, None, 1, 4,
                                       device="cpu")[1]["blocks"][0]
    group = _group(2)
    sharded = ttp.shard_block_params(cfg, bp, group)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 17, cfg.hidden_size)).astype(np.float32))
    fn = ttp.make_tp_block_fn(cfg, group)
    exact = fn(sharded, group.replicate(x))[0]
    tq.reset_trace_tally()
    ttp.set_tp_quant_bits(8)
    try:
        quant = fn(sharded, group.replicate(x))
    finally:
        ttp.set_tp_quant_bits(0)
    assert not torch.equal(exact, quant[0])
    scale = max(1.0, float(exact.abs().max()))
    assert float((exact - quant[0]).abs().max()) / scale < 0.05
    # two psum sites a block, one footprint: [2, 17, hidden]
    (site,) = tq.trace_tally()
    assert (site["kind"], site["bit"], site["calls"]) == ("psum", 8, 2)
    tq.reset_trace_tally()


def test_error_bound_is_the_jax_one():
    for bit in (4, 8):
        for n in (2, 4, 8):
            assert tq.qpsum_error_bound(1.5, bit, n) == \
                jq.qpsum_error_bound(1.5, bit, n)
    assert tq.qpsum_error_bound(1.0, 4, 4) > tq.qpsum_error_bound(1.0, 8, 4)
    assert tq.qpsum_error_bound(1.0, 8, 8) > tq.qpsum_error_bound(1.0, 8, 2)
