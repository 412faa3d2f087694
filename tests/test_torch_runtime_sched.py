"""The port's runtime schedules as `runtime.py` does.

On the CPU with the tiny ViT: the port's profiler, converters and
`sched-pipeline` make the schedule files, `python -m
pipeedge_tpu_torch.runtime 0 2 -sm/-sdt/-sd -H` runs the partition the
scheduler chose, and its `--save-results` npz equals the single-shard
forward bit for bit. `get_pipeline_sched` gives the JAX runtime's stage
layers, bits and ranks on the same files, `parse_yaml_sched` and the
resolution refuse what the JAX runtime refuses, with the same errors, and
`--rebalance auto` chooses the JAX runtime's microbatch split on the same
measured stats.
"""
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import runtime as jruntime
from pipeedge_tpu.sched import scheduler as jscheduler
from pipeedge_tpu_torch import profiler
from pipeedge_tpu_torch import profiler_results_to_device_types as to_types
from pipeedge_tpu_torch import profiler_results_to_models as to_models
from pipeedge_tpu_torch import runtime
from pipeedge_tpu_torch.models import registry, vit
from pipeedge_tpu_torch.sched import scheduler as tscheduler
from pipeedge_tpu_torch.sched import yaml_files

MODEL = "pipeedge/test-tiny-vit"


@pytest.fixture(scope="module")
def binaries():
    """Skips where the host has no C++ compiler (the port's build) or the
    JAX package's native build cannot be found or made."""
    if tscheduler.compiler() is None:
        pytest.skip("no C++ compiler on this host: the port cannot build "
                    "sched-pipeline")
    assert tscheduler.build_native() is not None
    if jscheduler.build_native() is None:
        pytest.skip("the JAX package's sched-pipeline is unbuilt and its "
                    "cmake build is unavailable")


@pytest.fixture(scope="module")
def sched_files(tmp_path_factory, binaries):
    """Weights, then the profile -> convert -> devices.yml loop."""
    d = tmp_path_factory.mktemp("sched")
    weights = d / "tiny-vit.npz"
    np.savez(weights, **vit.random_npz_weights(
        registry.get_model_config(MODEL), seed=3))
    results = d / "profiler_results.yml"
    profiler.main(["-m", MODEL, "-M", str(weights), "-b", "2", "-i", "2",
                   "-o", str(results), "--device", "cpu"])
    files = {"-sm": d / "models.yml", "-sdt": d / "device_types.yml",
             "-sd": d / "devices.yml", "-sd-numeric": d / "devices-num.yml"}
    to_models.main(["-i", str(results), "-o", str(files["-sm"])])
    to_types.main(["cpu", "-i", str(results), "-o", str(files["-sdt"]),
                   "-dtm", "1024", "-dtb", "3433227"])
    yaml_files.yaml_save({"cpu": ["host-a", "host-b"]}, str(files["-sd"]))
    yaml_files.yaml_save({"cpu": [0, 1]}, str(files["-sd-numeric"]))
    return weights, {k: str(v) for k, v in files.items()}


def _sched(pkg, files, hosts, devices="-sd", world=2):
    return pkg.get_pipeline_sched(world, hosts, None, None, None, MODEL, 2,
                                  files["-sm"], files["-sdt"], files[devices],
                                  dtype="float32")


@pytest.mark.parametrize("hosts,devices", [(["host-a", "host-b"], "-sd"),
                                           (None, "-sd-numeric"),
                                           (["0", "1"], "-sd-numeric")])
def test_schedule_equals_jax_runtime(sched_files, hosts, devices):
    _, files = sched_files
    got = _sched(runtime, files, hosts, devices)
    want = _sched(jruntime, files, hosts, devices)
    assert got == want
    layers, quant, ranks = got
    assert [l for a, b in layers for l in range(a, b + 1)] == \
        list(range(1, 9))
    assert quant == [0] * len(layers) and ranks == list(range(len(layers)))


def test_scheduled_run_equals_single_shard(sched_files, tmp_path,
                                           monkeypatch, capsys, caplog):
    weights, files = sched_files
    monkeypatch.chdir(tmp_path)        # the monitoring CSVs land here
    saved = tmp_path / "results.npz"
    caplog.set_level("INFO", logger="pipeedge_tpu_torch.runtime")
    runtime.main(["0", "2", "-m", MODEL, "-M", str(weights),
                  "-sm", files["-sm"], "-sdt", files["-sdt"],
                  "-sd", files["-sd"], "-H", "host-a,host-b", "-b", "8",
                  "-u", "2", "--measure-rounds", "2", "--save-results",
                  str(saved), "--device", "cpu"])
    layers, _, ranks = _sched(jruntime, files, ["host-a", "host-b"])
    logged = [r.getMessage() for r in caplog.records]
    assert f"Scheduling: stage-to-layer mapping: {layers}" in logged
    assert "Scheduling: stage-to-host mapping: " \
        f"{[['host-a', 'host-b'][r] for r in ranks]}" in logged
    assert any(ln.startswith("latency_sec=")
               for ln in capsys.readouterr().out.splitlines())
    inputs, _ = runtime.load_batches(MODEL, 8, 2, torch.device("cpu"),
                                     torch.float32)
    fn, params, _ = registry.module_shard_factory(MODEL, str(weights), 1, 8,
                                                  device="cpu")
    exact = [fn(params, x).numpy() for x in inputs]
    with np.load(saved) as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(got) == 2 * len(exact)      # both rounds, delivery order
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, exact[i % len(exact)])


@pytest.mark.parametrize("sched,hosts", [
    ([], ["a"]),                           # no viable schedule
    ([{"a": [1, 4]}, {"c": [5, 8]}], ["a", "b"]),   # host not listed
    ([{"a": [1, 8]}], None),               # no hosts, not an index
    ([{"7": [1, 8]}], None),               # no hosts: the name is the index
    ([{0: [1, 4]}, {1: [5, 8]}], ["0", "1"]),       # numeric names
])
def test_parse_yaml_sched_equals_jax(sched, hosts):
    outcomes = []
    for pkg in (runtime, jruntime):
        try:
            outcomes.append(pkg.parse_yaml_sched(sched, hosts))
        except (RuntimeError, ValueError) as exc:
            outcomes.append((type(exc), str(exc)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("kwargs", [
    dict(quant=[8, 0]),                    # quantization without -pt
    dict(rank_order=[1, 0]),               # rank order without -pt
    dict(hosts=["a", "b", "c"]),           # hosts != world size
])
def test_resolution_refusals_equal_jax(kwargs):
    args = dict(world_size=2, hosts=None, partition=None, quant=None,
                rank_order=None, model_name=MODEL, microbatch_size=2,
                s_models_file=None, s_dev_types_file=None, s_dev_file=None)
    args.update(kwargs)
    messages = []
    for pkg in (runtime, jruntime):
        with pytest.raises(RuntimeError) as exc:
            pkg.get_pipeline_sched(**args)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_partition_and_degenerate_cases_equal_jax():
    for world, partition, quant, order in ((2, [(1, 5), (6, 8)], [8, 0],
                                            [1, 0]),
                                           (3, [(1, 2), (3, 4), (5, 8)],
                                            None, None),
                                           (1, None, None, None)):
        args = (world, None, partition, quant, order, MODEL, 2, None, None,
                None)
        assert runtime.get_pipeline_sched(*args) == \
            jruntime.get_pipeline_sched(*args)


def test_no_files_raises_the_schedulers_error(binaries, tmp_path,
                                              monkeypatch):
    """More than one stage, no -pt and no files: both runtimes hand the
    scheduler its default file names, which do not exist here, and raise
    its failure (no 'no scheduler' refusal)."""
    monkeypatch.chdir(tmp_path)
    for pkg in (runtime, jruntime):
        with pytest.raises(subprocess.CalledProcessError):
            pkg.get_pipeline_sched(2, None, None, None, None, MODEL, 2, None,
                                   None, None)
    with pytest.raises(subprocess.CalledProcessError):
        runtime.main(["0", "2", "-m", MODEL, "--device", "cpu"])


class _Pipe(SimpleNamespace):
    pass


@pytest.mark.parametrize("stats,stages,max_ubatch", [
    ({"steady_mb_interval_s": 0.010, "host_dispatch_s_per_ubatch": 0.008},
     4, 32),
    ({"steady_mb_interval_s": 0.010, "host_dispatch_s_per_ubatch": 0.0},
     2, 32),
    ({"steady_mb_interval_s": 0.050, "host_dispatch_s_per_ubatch": 0.001},
     4, 8),
    ({"steady_mb_interval_s": 0.004, "host_dispatch_s_per_ubatch": 0.003},
     8, None),
    ({}, 2, 32),
])
def test_rebalance_auto_split_equals_jax(stats, stages, max_ubatch):
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(8, 3)).astype(np.float32) for _ in range(8)]
    labels = [rng.integers(0, 5, size=8) for _ in range(8)]
    port = _Pipe(stages=[None] * stages, max_inflight=2 * stages)
    jax = _Pipe(stages=[None] * stages, max_inflight=2 * stages)
    got_x, got_l = runtime.adapt_microbatches(
        port, stats, [torch.from_numpy(b) for b in batches], labels,
        max_ubatch=max_ubatch)
    want_x, want_l = jruntime._adapt_microbatches(jax, stats, batches, labels,
                                                  max_ubatch=max_ubatch)
    assert [len(x) for x in got_x] == [len(x) for x in want_x]
    assert port.max_inflight == jax.max_inflight
    np.testing.assert_array_equal(torch.cat(got_x).numpy(),
                                  np.concatenate([np.asarray(x)
                                                  for x in want_x]))
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)


def test_rebalance_auto_runs_and_keeps_every_item(tmp_path, monkeypatch):
    weights = tmp_path / "w.npz"
    np.savez(weights, **vit.random_npz_weights(
        registry.get_model_config(MODEL), seed=3))
    monkeypatch.chdir(tmp_path)
    saved = tmp_path / "results.npz"
    runtime.main(["0", "2", "-m", MODEL, "-M", str(weights), "-pt",
                  "1,4,5,8", "-b", "8", "-u", "2", "--measure-rounds", "3",
                  "--rebalance", "auto", "--save-results", str(saved),
                  "--device", "cpu"])
    inputs, _ = runtime.load_batches(MODEL, 8, 2, torch.device("cpu"),
                                     torch.float32)
    fn, params, _ = registry.module_shard_factory(MODEL, str(weights), 1, 8,
                                                  device="cpu")
    exact = torch.cat([fn(params, x) for x in inputs]).numpy()
    with np.load(saved) as z:
        got = np.concatenate([z[k] for k in sorted(
            z.files, key=lambda k: int(k.split("_")[1]))])
    # three rounds of every item, whatever the split (a split of other
    # sizes sums in other orders: f32 tolerance)
    assert got.shape == (3 * len(exact), exact.shape[1])
    for r in range(3):
        np.testing.assert_allclose(got[r * len(exact):(r + 1) * len(exact)],
                                   exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("argv,message", [
    (["--rebalance", "auto"], "--measure-rounds"),
    (["--dataset-name", "ImageNet"], "download"),
    (["--dataset-name", "CoLA"], "download"),
])
def test_cli_refusals(argv, message, capsys):
    with pytest.raises(SystemExit):
        runtime.parse_args(["0", "2", "-m", MODEL] + argv)
    assert message in capsys.readouterr().err


def test_identity_rank_order_is_accepted():
    args = runtime.parse_args(["0", "2", "-m", MODEL, "-pt", "1,4,5,8",
                               "-r", "0,1", "--device", "cpu"])
    assert runtime._schedule(args) == ([(1, 4), (5, 8)], [0, 0], [0, 1])
