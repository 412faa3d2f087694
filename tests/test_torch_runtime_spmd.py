"""The port's `runtime -c spmd` and `-r` against `runtime.py`.

The JAX runtime's SPMD cases (`tests/test_runtime.py`: the driver, the
mid-block fallback, GPT-2 host and spmd, the dp x tp and dp x sp meshes;
`tests/test_llama.py`: the Llama spmd run) run through the port's entry
in process with `--device cpu`, and each `--save-results` npz is held to
the port's own host driver at the same partition and weights: bit for
bit where both run the same functions in the same order (the stages'
blocks, exact edges), at rtol=2e-4, atol=2e-5 where a tp or sp mesh sums
or attends in another order. The parse errors that name spmd, and the
SPMD driver's run-time errors, are the JAX runtime's word for word; `-r`
places the host driver's and the SPMD driver's stages and leaves their
outputs as the identity order's.
"""
import io
import logging
import sys
from contextlib import redirect_stderr
from types import SimpleNamespace

import numpy as np
import pytest

import runtime as jruntime
from pipeedge_tpu_torch import runtime
from pipeedge_tpu_torch.models import bert, gpt2, registry, vit
from pipeedge_tpu_torch.parallel import tensor as tp

VIT = "pipeedge/test-tiny-vit"
BERT = "pipeedge/test-tiny-bert"
GPT2 = "pipeedge/test-tiny-gpt2"
LLAMA = "pipeedge/test-tiny-llama"
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded npz weights of each tiny model the cases run."""
    d = tmp_path_factory.mktemp("spmd-weights")
    out = {}
    for model, module in ((VIT, vit), (BERT, bert), (GPT2, gpt2)):
        path = d / f"{model.split('/')[1]}.npz"
        np.savez(path, **module.random_npz_weights(
            registry.get_model_config(model), seed=3))
        out[model] = str(path)
    return out


def _run(tmp_path, monkeypatch, name, argv, weights_file=None):
    """One in-process run of the port's entry; its saved results."""
    monkeypatch.chdir(tmp_path)          # the monitoring CSVs land here
    saved = tmp_path / f"{name}.npz"
    runtime.main(argv + (["-M", weights_file] if weights_file else [])
                 + ["--save-results", str(saved), "--device", "cpu"])
    with np.load(saved) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _host_and_spmd(tmp_path, monkeypatch, argv, spmd_extra=(),
                   weights_file=None, world=("0", "2")):
    host = _run(tmp_path, monkeypatch, "host", list(world) + argv,
                weights_file)
    spmd = _run(tmp_path, monkeypatch, "spmd",
                list(world) + argv + ["-c", "spmd"] + list(spmd_extra),
                weights_file)
    assert len(spmd) == len(host)
    return host, spmd


def test_spmd_driver(tmp_path, monkeypatch, weights, capsys):
    host, spmd = _host_and_spmd(
        tmp_path, monkeypatch, ["-m", VIT, "-pt", "1,4,5,8", "-b", "4",
                                "-u", "2"], weights_file=weights[VIT])
    for h, s in zip(host, spmd):
        np.testing.assert_array_equal(s, h)
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("latency_sec=") for ln in lines)
    assert any(ln.startswith("kernel_launches=") for ln in lines)
    assert "edge_bits=[0]" in lines


def test_spmd_falls_back_on_midblock_cut(tmp_path, monkeypatch, weights,
                                         caplog):
    caplog.set_level(logging.WARNING)
    host, spmd = _host_and_spmd(
        tmp_path, monkeypatch, ["-m", VIT, "-pt", "1,5,6,8", "-b", "4",
                                "-u", "2"], weights_file=weights[VIT])
    assert any(r.getMessage().endswith("; falling back to host driver")
               and "[1, 5] cuts mid-block" in r.getMessage()
               for r in caplog.records)
    for h, s in zip(host, spmd):
        np.testing.assert_array_equal(s, h)


def test_gpt2_host_and_spmd(tmp_path, monkeypatch, weights):
    """The causal decoder through both drivers: the 8-bit host run, then
    the SPMD driver equal to the exact host run."""
    argv = ["-m", GPT2, "-pt", "1,4,5,8", "-b", "4", "-u", "2"]
    q8 = _run(tmp_path, monkeypatch, "q8", ["0", "2"] + argv + ["-q", "8,0"],
              weights[GPT2])
    host, spmd = _host_and_spmd(tmp_path, monkeypatch, argv,
                                weights_file=weights[GPT2])
    for h, s, q in zip(host, spmd, q8):
        np.testing.assert_array_equal(s, h)
        assert np.all(np.isfinite(q)) and q.shape == h.shape


@pytest.mark.parametrize("quant", ["0,0", "8,0"])
def test_runtime_spmd_dp_tp_mesh(tmp_path, monkeypatch, weights, quant):
    """2 stages x dp 2 x tp 2 over 8 logical devices against the exact
    host driver: the exact edge at the tp tolerance, the 8-bit edge (no
    Banner clamp, as in JAX) within 0.1 of max |logit| (`chip_smoke.py`'s
    LOGIT_BOUND[8]; measured 0.033) and not equal to it."""
    argv = ["-m", VIT, "-b", "16", "-u", "4", "-pt", "1,4,5,8"]
    host = _run(tmp_path, monkeypatch, "host", ["0", "8"] + argv,
                weights[VIT])
    spmd = _run(tmp_path, monkeypatch, "spmd",
                ["0", "8"] + argv + ["-q", quant, "-c", "spmd", "--spmd-dp",
                                     "2", "--spmd-tp", "2"], weights[VIT])
    assert len(spmd) == len(host) == 4
    for h, s in zip(host, spmd):
        if quant == "0,0":
            np.testing.assert_allclose(s, h, rtol=RTOL, atol=ATOL)
        else:
            assert not np.array_equal(s, h)
            np.testing.assert_allclose(s, h, rtol=0,
                                       atol=0.1 * np.abs(h).max())


def test_runtime_spmd_tp_quant_bits(tmp_path, monkeypatch, weights,
                                    caplog):
    """--tp-quant-bits 8 on the tp mesh: the run's collectives folded
    once (the log line), the outputs within 0.05 of max |logit| of the
    exact host driver's (measured 0.0026)."""
    caplog.set_level(logging.INFO)
    argv = ["-m", VIT, "-b", "8", "-u", "4", "-pt", "1,4,5,8"]
    host, spmd = _host_and_spmd(
        tmp_path, monkeypatch, argv,
        ["--spmd-tp", "2", "--tp-quant-bits", "8"], weights[VIT],
        world=("0", "4"))
    assert tp.get_tp_quant_bits() == 0   # set for the run, then restored
    folds = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith(
                 "quantized collectives (--tp-quant-bits 8): ")]
    assert len(folds) == 1
    # 2 stages x 1 block x 2 all-reduces x 2 microbatches x 2 runs
    assert "'calls': 16" in folds[0]
    for h, s in zip(host, spmd):
        assert not np.array_equal(s, h)
        np.testing.assert_allclose(s, h, rtol=0, atol=0.05 * np.abs(h).max())


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_runtime_spmd_sp_mesh(tmp_path, monkeypatch, weights, kind):
    """Sequence parallelism inside the stages (BERT's 64 synthetic tokens
    over sp 2), each core against the host driver."""
    argv = ["-m", BERT, "-b", "8", "-u", "4", "-pt", "1,4,5,8"]
    host, spmd = _host_and_spmd(
        tmp_path, monkeypatch, argv,
        ["--spmd-sp", "2", "--spmd-sp-kind", kind], weights[BERT],
        world=("0", "4"))
    for h, s in zip(host, spmd):
        np.testing.assert_allclose(s, h, rtol=RTOL, atol=ATOL)


def test_llama_host_and_spmd(tmp_path, monkeypatch):
    """The runtime drivers treat Llama as any token model (seeded random
    stages: both drivers draw the same per-stage weights)."""
    host, spmd = _host_and_spmd(
        tmp_path, monkeypatch, ["-m", LLAMA, "-pt", "1,4,5,8", "-b", "4",
                                "-u", "2"])
    for h, s in zip(host, spmd):
        np.testing.assert_array_equal(s, h)


def test_rank_order_on_the_host_driver(tmp_path, monkeypatch, weights,
                                       caplog):
    """-r places the host driver's stages (logical device r % worldsize)
    and leaves the outputs as the identity order's."""
    caplog.set_level(logging.INFO)
    argv = ["0", "2", "-m", VIT, "-pt", "1,4,5,8", "-b", "4", "-u", "2"]
    identity = _run(tmp_path, monkeypatch, "id", argv, weights[VIT])
    swapped = _run(tmp_path, monkeypatch, "r10", argv + ["-r", "1,0"],
                   weights[VIT])
    assert "Scheduling: stage-to-rank mapping: [1, 0]" in [
        r.getMessage() for r in caplog.records]
    for a, b in zip(identity, swapped):
        np.testing.assert_array_equal(a, b)


def test_rank_order_on_the_spmd_driver(tmp_path, monkeypatch, weights,
                                       caplog):
    caplog.set_level(logging.INFO)
    argv = ["0", "4", "-m", VIT, "-pt", "1,4,5,8", "-b", "4", "-u", "2",
            "-c", "spmd"]
    identity = _run(tmp_path, monkeypatch, "id", argv, weights[VIT])
    placed = _run(tmp_path, monkeypatch, "r31", argv + ["-r", "3,1"],
                  weights[VIT])
    assert any(r.getMessage().endswith("at logical devices [3, 1]")
               for r in caplog.records)
    for a, b in zip(identity, placed):
        np.testing.assert_array_equal(a, b)


def _parse_error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["-c", "spmd", "--rebalance", "auto", "--measure-rounds", "2"],
    ["-c", "spmd", "--tp-quant-bits", "8"],
    ["-c", "spmd", "--stage-tp", "2"]],
    ids=["rebalance", "tp_quant_bits", "stage_tp"])
def test_spmd_parse_errors_are_the_jax_runtime_s(argv, monkeypatch):
    base = ["0", "2", "-m", VIT, "-pt", "1,4,5,8"]
    got = _parse_error(lambda: runtime.parse_args(base + argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py"] + base + argv)
    assert got == _parse_error(jruntime.main)
    assert "spmd" in got


@pytest.mark.parametrize("world,ranks,axes", [
    (8, [0, 1], dict(spmd_dp=2)),        # the identity order: it runs
    (8, [1, 0], dict(spmd_dp=2)),        # -r with a mesh axis
    (8, None, dict(spmd_tp=2, spmd_sp=2)),
    (8, None, dict(spmd_dp=4, spmd_tp=2)),  # 16 devices needed
    (8, [1, 9], {}),                     # 1 and 9 map to one device
], ids=["identity_with_dp", "ranks_with_dp", "tp_with_sp", "too_few",
        "non_distinct"])
def test_spmd_run_errors_are_the_jax_runtime_s(world, ranks, axes, monkeypatch,
                                                tmp_path):
    """The SPMD driver's checks, on the JAX runtime's `jax.devices()` (8
    on the conftest's CPU) and the port's 8 logical devices."""
    monkeypatch.chdir(tmp_path)
    args = SimpleNamespace(
        model_name=VIT, model_file=None, dtype="float32", worldsize=world,
        device="cpu", spmd_dp=1, spmd_tp=1, spmd_sp=1, spmd_sp_kind="ring",
        tp_quant_bits=0, batch_size=4, ubatch_size=2, save_results=None)
    for key, value in axes.items():
        setattr(args, key, value)
    layers, bits = [(1, 4), (5, 8)], [0, 0]
    stage_ranks = ranks or [0, 1]
    if ranks == [0, 1]:
        # the identity order combines with any axis: it runs
        runtime.run_pipeline_spmd(args, layers, bits, stage_ranks)
        return
    with pytest.raises(RuntimeError) as want:
        jruntime.run_pipeline_spmd(args, layers, bits, stage_ranks, [], [])
    with pytest.raises(RuntimeError) as got:
        runtime.run_pipeline_spmd(args, layers, bits, stage_ranks)
    assert str(got.value) == str(want.value)
