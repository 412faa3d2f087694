"""The port's profiler against the JAX package's.

On the tiny ViT, BERT and GPT-2, with the same weights (one npz, read by
both packages) and the same inputs (both profilers draw them from numpy
seed 0), each sublayer's `shape_in` and `shape_out` equal the JAX
profile's, the layer counts agree, and the port's `memory` on the CPU is
the parameter bytes exactly (the JAX profile's parameter part; the port
adds the allocator's peak only on the card). The output chained through
every layer in `--exhaustive` mode lies within rtol 1e-4 / atol 1e-5 of
the JAX chain (f32; XLA and torch sum in other orders, as in
`tests/test_torch_models.py`). Reusing identical layers gives the
exhaustive profile's shapes and memory. `validate_profile_results`
refuses what the JAX one refuses, and the CLI writes a file both
packages' `ProfilerResults.load` read.
"""
import numpy as np
import pytest
import torch
import yaml

from pipeedge_tpu import models as jmodels
from pipeedge_tpu import profiler as jprof
from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.sched import profiles as jprofiles
from pipeedge_tpu_torch import profiler as tprof
from pipeedge_tpu_torch.models import bert as tbert
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.sched import profiles as tprofiles

RTOL, ATOL = 1e-4, 1e-5
FAMILIES = {"pipeedge/test-tiny-vit": tvit, "pipeedge/test-tiny-bert": tbert,
            "pipeedge/test-tiny-gpt2": tgpt2}
BATCH = 2


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = {}
    for n, (model, family) in enumerate(FAMILIES.items()):
        path = tmp_path_factory.mktemp("w") / f"{model.split('/')[1]}.npz"
        np.savez(path, **family.random_npz_weights(
            treg.get_model_config(model), seed=20 + n))
        out[model] = str(path)
    return out


def _capture(monkeypatch, module, into):
    """Record every payload `module._measure_layer` returns."""
    real = module._measure_layer

    def measuring(fn, params, payload, iterations, warmup):
        t, mem, out = real(fn, params, payload, iterations, warmup)
        into.append((mem, out))
        return t, mem, out
    monkeypatch.setattr(module, "_measure_layer", measuring)


def _profiles(weights, model, monkeypatch, reuse):
    """(port results, JAX results, port outputs, JAX (memory, output)s)."""
    t_out, j_out = [], []
    _capture(monkeypatch, tprof, t_out)
    _capture(monkeypatch, jprof, j_out)
    layers = treg.get_model_layers(model)
    inputs = tprof.default_inputs(model, BATCH, device="cpu")
    got = tprof.profile_layers_individually(
        model, weights[model], inputs, 1, layers, warmup=True, iterations=2,
        reuse_identical=reuse, device="cpu")
    want = jprof.profile_layers_individually(
        model, weights[model], jprof.default_inputs(model, BATCH), 1, layers,
        warmup=True, iterations=2, reuse_identical=reuse)
    return got, want, t_out, j_out


@pytest.mark.parametrize("model", list(FAMILIES))
def test_default_inputs_equal_jax(model):
    got = tprof.default_inputs(model, BATCH, device="cpu")
    want = np.asarray(jprof.default_inputs(model, BATCH))
    assert got.dtype == (torch.int32 if want.dtype == np.int32
                         else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", list(FAMILIES))
def test_exhaustive_profile_equals_jax(weights, model, monkeypatch):
    got, want, t_out, j_out = _profiles(weights, model, monkeypatch,
                                        reuse=False)
    layers = treg.get_model_layers(model)
    assert len(got) == len(want) == layers
    assert [d["layer"] for d in got] == list(range(1, layers + 1))
    for g, w in zip(got, want):
        assert g["shape_in"] == w["shape_in"]
        assert g["shape_out"] == w["shape_out"]
        assert g["time"] > 0
    # the port's CPU memory is the parameter bytes; the JAX profile's is
    # the parameter bytes plus XLA's temp buffers
    layer_params = []
    for layer in range(1, layers + 1):
        _, params, _ = treg.module_shard_factory(model, weights[model], layer,
                                                 layer, device="cpu")
        layer_params.append(tprof.params_bytes(params))
    for layer in range(1, layers + 1):
        _, jparams, _ = jreg.module_shard_factory(model, weights[model],
                                                  layer, layer)
        assert layer_params[layer - 1] == jmodels.params_bytes(jparams)
    assert [d["memory"] for d in got] == [b / 1024 / 1024
                                          for b in layer_params]
    assert all(w["memory"] >= g["memory"] for g, w in zip(got, want))
    # the chain: every layer's output, the last one's too
    assert len(t_out) == len(j_out) == layers
    for (_, t), (_, j) in zip(t_out, j_out):
        t = t if isinstance(t, tuple) else (t,)
        j = j if isinstance(j, tuple) else (j,)
        assert len(t) == len(j)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("model", list(FAMILIES))
def test_reuse_identical_equals_exhaustive(weights, model, monkeypatch):
    measured = []
    _capture(monkeypatch, tprof, measured)
    inputs = tprof.default_inputs(model, BATCH, device="cpu")
    layers = treg.get_model_layers(model)
    reused = tprof.profile_layers_individually(
        model, weights[model], inputs, 1, layers, warmup=False, iterations=1,
        device="cpu")
    unique = len(measured)
    exhaustive = tprof.profile_layers_individually(
        model, weights[model], inputs, 1, layers, warmup=False, iterations=1,
        reuse_identical=False, device="cpu")
    # 8 layers, 2 blocks: layer 1 (embedding), kinds 1-3, kind 0 of block
    # 2, and layer 8 (the head) are the 6 distinct computations
    assert unique == 6 and len(measured) == unique + layers
    keys = ("layer", "shape_in", "shape_out", "memory")
    assert [[d[k] for k in keys] for d in reused] == \
        [[d[k] for k in keys] for d in exhaustive]


def _results(model="pipeedge/test-tiny-vit"):
    return {"model_name": model, "dtype": "float32", "batch_size": 2,
            "layers": 8, "profile_data": [{"layer": 2}, {"layer": 5}]}


@pytest.mark.parametrize("args", [
    ("pipeedge/test-tiny-vit", "float32", 2, 8, 6, 8),    # accepted
    ("pipeedge/test-tiny-vit", "float32", 2, 8, 1, 3),    # layer 2 again
    ("other", "float32", 2, 8, 6, 8),
    ("pipeedge/test-tiny-vit", "bfloat16", 2, 8, 6, 8),
    ("pipeedge/test-tiny-vit", "float32", 4, 8, 6, 8),
    ("pipeedge/test-tiny-vit", "float32", 2, 48, 6, 8)])
def test_validate_profile_results_equals_jax(args):
    outcomes = []
    for validate in (tprof.validate_profile_results,
                     jprof.validate_profile_results):
        try:
            validate(_results(), *args)
            outcomes.append(None)
        except AssertionError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


def test_cli_writes_what_both_packages_read(tmp_path):
    out = tmp_path / "profiler_results.yml"
    argv = ["-m", "pipeedge/test-tiny-bert", "-b", "2", "-i", "1",
            "--no-warmup", "-o", str(out), "--device", "cpu"]
    written = tprof.main(argv + ["-L", "5"])
    assert [d["layer"] for d in written["profile_data"]] == [1, 2, 3, 4, 5]
    # a second run adds the remaining layers to the same file
    tprof.main(argv + ["-l", "6", "-s", "64,32", "-s", "64,32"])
    with open(out) as f:
        raw = yaml.safe_load(f)
    assert [d["layer"] for d in raw["profile_data"]] == list(range(1, 9))
    assert all(isinstance(d["time"], float) for d in raw["profile_data"])
    for pkg in (tprofiles, jprofiles):
        res = pkg.ProfilerResults.load(str(out))
        assert (res.model_name, res.dtype, res.batch_size, res.layers) == \
            ("pipeedge/test-tiny-bert", "float32", 2, 8)
        assert res.model_entry() == jprofiles.ProfilerResults.load(
            str(out)).model_entry()
    with pytest.raises(AssertionError, match="already in existing"):
        tprof.main(argv + ["-L", "2"])


def test_cli_trace_writes_a_chrome_trace(tmp_path):
    tprof.main(["-m", "pipeedge/test-tiny-vit", "-b", "2", "-i", "1",
                "-L", "2", "-o", str(tmp_path / "p.yml"), "--device", "cpu",
                "--trace", str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "profiler_trace.json").stat().st_size > 0


def test_cli_without_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tprof.main(["-m", "pipeedge/test-tiny-vit", "-b", "2",
                    "-o", str(tmp_path / "p.yml")])
