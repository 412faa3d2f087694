"""The port's reverse-auction scheduler against the JAX package's.

`pipeedge_tpu_torch/sched/revauct.py` and the port's CLI
(`python -m pipeedge_tpu_torch.revauct`) on the inputs of
`tests/test_revauct.py`: bids, both bid filters, the greedy host-count
scheduler and the latency and throughput DAG schedulers equal the JAX
package's; the CLI prints the JAX CLI's schedule YAML, word for word, on
the same files (and on the card's own profiles).
"""
import os
import subprocess
import sys

import pytest
import yaml

from pipeedge_tpu.sched import revauct as jrev
from pipeedge_tpu.sched import yaml_types
from pipeedge_tpu_torch import revauct as tcli
from pipeedge_tpu_torch.sched import revauct as trev
from pipeedge_tpu_torch.sched import yaml_files as tyaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = os.path.join(REPO, "pipeedge_tpu_torch", "profiles", "h100")

DTYPE = 'torch.float32'
UB = 1


def _model(n, params_out=100, mem_mb=1.0):
    return {'layers': n, 'parameters_in': 100,
            'parameters_out': [params_out] * n, 'mem_MB': [mem_mb] * n}


def _dev_type(mem_mb, bw, time_s):
    return yaml_types.yaml_device_type(
        mem_mb, bw, {'m': [yaml_types.yaml_model_profile(DTYPE, UB, time_s)]})


def _all_links(types, bw):
    return {h: {o: {'bw_Mbps': bw} for o in types if o != h} for h in types}


def _bids_for(mod, model, dev_types, neighbors):
    out = {}
    for host, tname in dev_types.items():
        prof = tname['model_profiles']['m'][0]
        out[host] = (dict(mod.bid_latency(model, tname, prof, UB, DTYPE)),
                     neighbors.get(host, {}))
    return out


# the scheduler inputs of tests/test_revauct.py: (model, device types,
# neighbour links, scheduler, args)
_TYPES3 = {'a': _dev_type(250, 1000, [0.1] * 4),
           'b': _dev_type(250, 1000, [0.2] * 4),
           'c': _dev_type(250, 1000, [0.3] * 4)}
_SPLIT = {'h0': _dev_type(250, 1000, [0.1] * 4),
          'h1': _dev_type(250, 1000, [0.1] * 4),
          'h2': _dev_type(250, 1000, [0.1] * 4)}
_TPUT = {'h0': _dev_type(350, 1000, [0.1] * 4),
         'h1': _dev_type(350, 1000, [0.1] * 4)}
_FAST = {'fast': _dev_type(1024, 1000, [0.01, 0.01]),
         'slow': _dev_type(1024, 1000, [10.0, 10.0])}
CASES = {
    "greedy_host_count": (
        _model(4, mem_mb=100.0), _TYPES3, _all_links(_TYPES3, 1000),
        "greedy", ('a', 'a')),
    "latency_picks_fast_path": (
        _model(2, mem_mb=1.0), _FAST,
        {'fast': {'slow': {'bw_Mbps': 1000}},
         'slow': {'fast': {'bw_Mbps': 1000}}},
        "latency", ('fast', 'fast', ['fast', 'slow'], True, False, False)),
    "latency_splits_when_memory_forces": (
        _model(4, mem_mb=100.0), _SPLIT, _all_links(_SPLIT, 1000),
        "latency", ('h0', 'h0', ['h0', 'h1', 'h2'], False, False, False)),
    "throughput_minimizes_bottleneck": (
        _model(4, mem_mb=100.0), _TPUT, _all_links(_TPUT, 100000),
        "throughput", ('h0', 'h0', ['h0', 'h1'], True, False, False)),
    "strict_throughput_3": (
        _model(4, mem_mb=100.0), _SPLIT, _all_links(_SPLIT, 1000),
        "throughput", ('h0', 'h0', ['h0', 'h1', 'h2'], True, True, True)),
    "no_path": (
        _model(2, mem_mb=10000.0), {'h0': _dev_type(100, 1000, [0.1, 0.1])},
        {'h0': {}}, "latency", ('h0', 'h0', ['h0'], True, True, True)),
}


def _run(mod, case):
    model, types, links, kind, args = CASES[case]
    bids = _bids_for(mod, model, types, links)
    if kind == "greedy":
        return mod.sched_greedy_host_count(model, UB, DTYPE, bids, *args)
    src, dst, order, strict, first, last = args
    fn = (mod.sched_optimal_latency_dev_order if kind == "latency"
          else mod.sched_optimal_throughput_dev_order)
    return fn(model, UB, DTYPE, bids, src, dst, list(order),
              strict_order=strict, strict_first=first, strict_last=last)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedules_equal_jax(case):
    assert _run(trev, case) == _run(jrev, case)


@pytest.mark.parametrize("mem_mb", [250, 100000])
def test_bids_equal_jax(mem_mb):
    model = _model(4, mem_mb=100.0)
    dt = _dev_type(mem_mb, 1000, [0.1, 0.2, 0.3, 0.4])
    prof = dt['model_profiles']['m'][0]
    got = trev.bid_latency(model, dt, prof, UB)
    assert got == jrev.bid_latency(model, dt, prof, UB)
    assert got


def test_filters_equal_jax():
    model = _model(8)
    bids = {(0, 3): 1.0, (0, 7): 2.0, (1, 3): 0.5, (4, 7): 1.0, (4, 5): 0.6,
            (0, 5): 1.5}
    for chunk in (2, 4):
        assert trev.filter_bids_chunk(model, bids, chunk=chunk) == \
            jrev.filter_bids_chunk(model, bids, chunk=chunk)
    assert trev.filter_bids_largest(bids) == jrev.filter_bids_largest(bids)


def _write_fleet(tmp_path):
    """The CLI fleet of tests/test_revauct.py, heterogeneous."""
    n = 8
    hosts = ["c0", "c1", "c2"]
    models = {"pipeedge/test-tiny-vit": {
        "layers": n, "parameters_in": 768, "parameters_out": [1000] * n,
        "mem_MB": [50.0] * n}}
    types = {f"t-{h}": {"mem_MB": 300, "bw_Mbps": 10000, "model_profiles": {
        "pipeedge/test-tiny-vit": [{"dtype": DTYPE, "batch_size": 2,
                                    "time_s": [t] * n}]}}
             for h, t in zip(hosts, (0.01, 0.02, 0.04))}
    devs = {f"t-{h}": [h] for h in hosts}
    neighbors = {h: {o: {"bw_Mbps": 10000} for o in hosts if o != h}
                 for h in hosts}
    for fname, data in (("models.yml", models), ("device_types.yml", types),
                        ("devices.yml", devs),
                        ("device_neighbors_world.yml", neighbors)):
        with open(tmp_path / fname, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=None)


def _jax_cli(argv, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "revauct.py")]
                          + argv, capture_output=True, env=env, cwd=str(cwd),
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _port_cli(argv, cwd, capsys, monkeypatch):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    out = tcli.main(argv)
    return capsys.readouterr().out, out


SCHEDULERS = [["-sch", "throughput_ordered", "--no-strict-order"],
              ["-sch", "latency_ordered"], ["-sch", "greedy_host_count"],
              ["-sch", "throughput_ordered", "--filter-bids-chunk", "4"]]


@pytest.mark.parametrize("sched_args", SCHEDULERS,
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_cli_prints_jax_yaml(sched_args, tmp_path, capsys, monkeypatch):
    _write_fleet(tmp_path)
    argv = ["0", "3", "-m", "pipeedge/test-tiny-vit", "-u", "2",
            "--seed", "0"] + sched_args
    want = _jax_cli(argv, tmp_path)
    got, sched = _port_cli(argv, tmp_path, capsys, monkeypatch)
    assert got == want
    assert sched == yaml.safe_load(want)


def test_cli_h100_profiles_equal_jax(tmp_path, capsys, monkeypatch):
    """The card's own files (ViT-Large, -u 8): the throughput schedule is
    four stages of 24 sublayers covering [1, 96], as the JAX CLI prints."""
    argv = ["0", "4", "-m", "google/vit-large-patch16-224", "-u", "8",
            "--seed", "0", "-sch", "throughput_ordered",
            "-sm", os.path.join(H100, "models.yml"),
            "-sdt", os.path.join(H100, "device_types.yml"),
            "-sd", os.path.join(H100, "devices.yml"),
            "-sdnw", os.path.join(H100, "device_neighbors_world.yml")]
    want = _jax_cli(argv, tmp_path)
    got, sched = _port_cli(argv, tmp_path, capsys, monkeypatch)
    assert got == want
    stages = [layers for part in sched for layers in part.values() if layers]
    assert stages == [[1, 24], [25, 48], [49, 72], [73, 96]]


def test_neighbors_world_file_loads_like_pyyaml():
    path = os.path.join(H100, "device_neighbors_world.yml")
    got = tyaml.yaml_device_neighbors_world_load(path)
    with open(path) as f:
        assert got == yaml.safe_load(f)
    hosts = tyaml.yaml_devices_load(os.path.join(H100, "devices.yml"))["h100"]
    assert sorted(got) == sorted(hosts)
    types = tyaml.yaml_device_types_load(os.path.join(H100,
                                                      "device_types.yml"))
    for host, links in got.items():
        assert sorted(links) == sorted(set(hosts) - {host})
        assert {v["bw_Mbps"] for v in links.values()} == {
            types["h100"]["bw_Mbps"]}
    assert tyaml.yaml_device_neighbors_load(path) == got


def test_cli_refuses_dcn(capsys):
    """`--comm dcn` runs (tests/test_torch_revauct_dcn.py), but, as in the
    JAX CLI, not without this bidder's device type."""
    with pytest.raises(SystemExit) as exc:
        tcli.parse_args(["0", "2", "-c", "dcn"])
    assert exc.value.code == 2
    assert "--comm dcn requires --dev-type (this bidder's entry in its " \
        "local device_types file)" in capsys.readouterr().err
    args = tcli.parse_args(["1", "2", "-c", "dcn", "--dev-type", "t"])
    assert (args.comm, args.host, args.port) == ("dcn", "rank1", 29500)
