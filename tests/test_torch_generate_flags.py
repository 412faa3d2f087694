"""The entries' single-device flags: generate's `--concurrent`, `--monitor`
and `-sm/-sdt/-sd`, and the flags both entries refuse.

- Every composition error of `pipeedge_tpu_torch.generate` is the JAX
  entry's (`tools/generate.py`), word for word, on the same command line.
- The flags that need a layout the port does not run yet are refused at
  parse time, naming their ROADMAP item: `runtime.py`'s flags the port's
  runtime does not run (generate's table is empty); the multi-GPU flags
  the port runs (`--tp`, `--sp`, `--ep`, `--spmd-wave`, `--stage-tp`,
  `--tp-quant-bits`, `--spmd-dp/-tp/-sp/-sp-kind`) parse.
- `--concurrent N` on the tiny GPT-2: every request's tokens equal its
  solo run (fp and int8 caches, with and without a shared prefix).
- `--monitor` writes `new_tokens - 1` heartbeat rows to decode.csv.
- `-sm/-sdt/-sd`: the partition is the JAX entry's (its scheduler call,
  rounded to blocks) on the same profile files, and the pipeline runs it.
"""
import csv
import importlib.util
import io
import pathlib
import re
import sys
from contextlib import redirect_stderr

import numpy as np
import pytest
import yaml

from pipeedge_tpu.parallel import decode as jdecode
from pipeedge_tpu.sched import scheduler as jscheduler
from pipeedge_tpu_torch import generate, runtime
from pipeedge_tpu_torch.sched import scheduler as tscheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = "pipeedge/test-tiny-gpt2"
BASE = ["-m", TINY, "-b", "2", "--prompt-len", "4", "--new-tokens", "2"]


def _jax_generate():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", ROOT / "tools" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _error(fn):
    """The argparse error line a parser exit printed."""
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


COMPOSE = {
    "new_tokens": ["--new-tokens", "0"],
    "odd_partition": ["-pt", "1,4,5"],
    "beams_temperature": ["--beams", "2", "--temperature", "0.5"],
    "beams_monitor": ["--beams", "2", "--monitor"],
    "beams_prefill_ubatch": ["--beams", "2", "--prefill-ubatch", "1"],
    "shared_prefix_beams": ["--shared-prefix", "2", "--beams", "2"],
    "shared_prefix_range": ["--shared-prefix", "4"],
    "draft_concurrent": ["--draft-model", TINY, "--concurrent", "2"],
    "draft_monitor": ["--draft-model", TINY, "--monitor"],
    "draft_kv_bits": ["--draft-model", TINY, "--kv-bits", "8"],
    "concurrent_monitor": ["--concurrent", "2", "--monitor"],
    "concurrent_beams": ["--concurrent", "2", "--beams", "2"],
    "concurrent_prefill_ubatch": ["--concurrent", "2",
                                  "--prefill-ubatch", "1"],
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_compose_errors_are_the_jax_entry_s(case, monkeypatch):
    argv = BASE + COMPOSE[case]
    got = _error(lambda: generate.parse_args(argv + ["--device", "cpu"]))
    jgen = _jax_generate()
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    want = _error(jgen.main)
    assert got == want


GEN_REFUSED: dict = {}
# the flags that left the refused table, each with its value and the
# argument it reaches: they parse (the wave decoder itself runs in
# tests/test_torch_generate_spmd_wave.py)
GEN_PORTED = {"--sp": (["2"], 2), "--ep": (["2"], 2),
              "--spmd-wave": ([], True)}


@pytest.mark.parametrize("flag", sorted(GEN_PORTED) + sorted(GEN_REFUSED))
def test_generate_refuses_naming_the_item(flag):
    assert set(GEN_REFUSED) == set(generate.REFUSED)
    if flag in GEN_PORTED:
        value, want = GEN_PORTED[flag]
        args = generate.parse_args(BASE + [flag] + value
                                   + ["--device", "cpu"])
        assert getattr(args, flag[2:].replace("-", "_")) == want
        return
    msg = _error(lambda: generate.parse_args(
        BASE + [flag] + GEN_REFUSED[flag]))
    assert msg.startswith(f"{flag} is not ported to pipeedge_tpu_torch yet "
                          "(ROADMAP A7")


# the multi-GPU flags the port runs, with a value (the tensor-parallel
# decode itself runs in tests/test_torch_generate_tp.py, the stage fleet
# in tests/test_torch_stage_tp_dcn.py, --ep and --tp x --ep in
# tests/test_torch_moe_parallel.py, --sp in tests/test_torch_sp_prefill.py)
TP_FLAGS = {
    "generate --tp": (lambda: generate.parse_args(
        BASE + ["--tp", "2", "--device", "cpu"]), ("tp", 2)),
    "generate --sp": (lambda: generate.parse_args(
        BASE + ["--sp", "2", "--device", "cpu"]), ("sp", 2)),
    "generate --ep": (lambda: generate.parse_args(
        BASE + ["--tp", "2", "--ep", "2", "--device", "cpu"]), ("ep", 2)),
    "runtime --stage-tp": (lambda: runtime.parse_args(
        ["0", "2", "-c", "dcn", "-m", "pipeedge/test-tiny-vit",
         "-pt", "1,4,5,8", "--stage-tp", "2"]), ("stage_tp", 2)),
    "runtime --tp-quant-bits": (lambda: runtime.parse_args(
        ["0", "2", "-c", "dcn", "-m", "pipeedge/test-tiny-vit",
         "--stage-tp", "2", "--tp-quant-bits", "4"]), ("tp_quant_bits", 4)),
    # the SPMD driver's mesh axes (its runs: tests/test_torch_spmd.py and
    # tests/test_torch_runtime_spmd.py)
    "runtime --spmd-dp": (lambda: runtime.parse_args(
        ["0", "4", "-c", "spmd", "--spmd-dp", "2"]), ("spmd_dp", 2)),
    "runtime --spmd-tp": (lambda: runtime.parse_args(
        ["0", "4", "-c", "spmd", "--spmd-tp", "2", "--tp-quant-bits",
         "8"]), ("spmd_tp", 2)),
    "runtime --spmd-sp": (lambda: runtime.parse_args(
        ["0", "4", "-c", "spmd", "--spmd-sp", "2"]), ("spmd_sp", 2)),
    "runtime --spmd-sp-kind": (lambda: runtime.parse_args(
        ["0", "4", "-c", "spmd", "--spmd-sp", "2", "--spmd-sp-kind",
         "ulysses"]), ("spmd_sp_kind", "ulysses")),
}


@pytest.mark.parametrize("case", sorted(TP_FLAGS))
def test_tensor_parallel_flags_parse(case):
    """The tensor-parallel flags of both entries parse, are off the refused
    tables and reach the arguments."""
    parse, (dest, value) = TP_FLAGS[case]
    flag = case.split()[1]
    assert flag not in generate.REFUSED and flag not in runtime.REFUSED
    assert getattr(parse(), dest) == value


# generate's DCN flags, each with a value (the DCN fleet itself runs in
# tests/test_torch_generate_dcn.py)
GEN_DCN = {"--edge-bits": ["8", "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2"],
           "--dcn-addrs": ["127.0.0.1:1,127.0.0.1:2"],
           "--rank": ["1", "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2"]}


@pytest.mark.parametrize("flag", sorted(GEN_DCN))
def test_generate_parses_the_dcn_flags(flag):
    """Each DCN flag of the JAX entry parses and is off the refused
    table; the values reach the DCN path."""
    assert flag not in generate.REFUSED
    args = generate.parse_args(BASE + ["-pt", "1,4,5,8", flag]
                               + GEN_DCN[flag])
    assert args.dcn_addrs == "127.0.0.1:1,127.0.0.1:2"
    assert (args.rank, args.edge_bits) == (
        1 if flag == "--rank" else 0, 8 if flag == "--edge-bits" else 0)


def _refused_value(flag):
    kw = runtime.REFUSED[flag][0]
    if kw.get("action") == "store_true":
        return []
    return ["1"] if "type" in kw else ["x"]


@pytest.mark.parametrize("flag", sorted(runtime.REFUSED))
def test_runtime_refuses_naming_the_item(flag):
    msg = _error(lambda: runtime.parse_args(
        ["0", "2", flag] + _refused_value(flag)))
    assert msg.startswith(f"{flag} is not ported to pipeedge_tpu_torch yet "
                          "(ROADMAP A")


@pytest.mark.parametrize("argv,item", [
    (["--platform", "cpu"], "--device")])
def test_runtime_refuses_the_other_drivers(argv, item):
    assert item in _error(lambda: runtime.parse_args(["0", "2"] + argv))


# each flag of the DCN driver that the port runs, with a value (the
# rebalance and autoscale fleets run in tests/test_torch_rebalance_dcn.py
# and tests/test_torch_autoscale_dcn.py)
DCN_FLAGS = {"-c": ["dcn"], "-D": ["1"],
             "--dcn-addrs": ["127.0.0.1:1,127.0.0.1:2"], "-P": ["29700"],
             "--sched-timeout": ["5"], "--rounds": ["2"], "--wire-crc": [],
             "--heartbeat-interval": ["0.5"], "--heartbeat-miss": ["3"],
             "--stage-ckpt": ["ckpt"], "--stage-depth": ["1"],
             "--on-peer-death": ["abort"],
             "--on-peer-rejoin": ["heal"],
             "--on-peer-degraded": ["quarantine", "--rounds", "2"],
             "--degraded-threshold": ["0.3"], "--degraded-confirm": ["1"],
             "--degraded-readmit": ["3"],
             "--rebalance": ["auto", "--rounds", "2"],
             "--rebalance-threshold": ["0.2"],
             "--rebalance-cooldown": ["0"], "--rebalance-confirm": ["0"],
             "--autoscale-ranks": ["auto", "--on-peer-death", "failover",
                                   "--rounds", "2"],
             "--autoscale-min": ["1"], "--autoscale-max": ["3"],
             "--autoscale-confirm": ["1"], "--autoscale-cooldown": ["0.5"],
             "--autoscale-rank-high": ["0.3"],
             "--autoscale-rank-low": ["0.01"]}


@pytest.mark.parametrize("flag", sorted(DCN_FLAGS))
def test_runtime_parses_the_dcn_flags(flag):
    """Each DCN flag the port runs parses (with -c dcn) and is off the
    refused table; the multi-GPU flags that stay refused name A7."""
    assert flag not in runtime.REFUSED
    args = runtime.parse_args(["1", "2", "-c", "dcn", flag]
                              + DCN_FLAGS[flag])
    assert args.comm == "dcn" and args.rank == 1
    assert "--spmd-wave" not in generate.REFUSED


def test_runtime_parses_failover_with_the_fault_flags():
    """--on-peer-death failover parses, with the rejoin and gray-failure
    policies, at the JAX entry's defaults otherwise."""
    args = runtime.parse_args(
        ["0", "3", "-c", "dcn", "--on-peer-death", "failover",
         "--on-peer-rejoin", "heal", "--on-peer-degraded", "quarantine",
         "--rounds", "3"])
    assert (args.on_peer_death, args.on_peer_rejoin,
            args.on_peer_degraded) == ("failover", "heal", "quarantine")
    assert (args.degraded_threshold, args.degraded_confirm,
            args.degraded_readmit) == (0.4, 2, 2)
    assert runtime.parse_args(["0", "2", "-c", "dcn"]).on_peer_rejoin \
        == "spare"


@pytest.mark.parametrize("argv", [
    ["--on-peer-degraded", "quarantine"],
    ["-c", "dcn", "--on-peer-degraded", "quarantine"]])
def test_quarantine_compose_errors_are_the_jax_entry_s(argv, monkeypatch):
    import runtime as jruntime
    got = _error(lambda: runtime.parse_args(["0", "2"] + argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py", "0", "2"] + argv)
    assert got == _error(jruntime.main)


def test_runtime_takes_the_host_driver_aliases():
    for comm in ("host", "p2p", "rpc"):
        assert runtime.parse_args(["0", "2", "-c", comm]).comm == comm


def test_every_unported_runtime_flag_is_refused():
    """Each `runtime.py` flag is accepted or refused by the port's entry:
    none is unknown to it (argparse's "unrecognized arguments")."""
    pattern = re.compile(r'add_argument\("(--?[a-zA-Z][\w-]*)"')
    jax_flags = set(pattern.findall((ROOT / "runtime.py").read_text()))
    port_flags = set(pattern.findall(
        (ROOT / "pipeedge_tpu_torch" / "runtime.py").read_text()))
    assert not jax_flags - port_flags - set(runtime.REFUSED)


@pytest.mark.parametrize("kv_bits,shared,sampled",
                         [(0, 0, False), (8, 0, False), (0, 3, False),
                          (8, 0, True)],
                         ids=["fp", "int8", "shared_prefix", "int8_sampled"])
def test_concurrent_requests_equal_solo_runs(kv_bits, shared, sampled,
                                             capsys):
    """Request r of `--concurrent` equals the solo run with `--seed r`;
    sampled, the requests differ, so a batcher that swapped or mixed two
    live requests' caches or tokens would show."""
    argv = ["-m", TINY, "-pt", "1,4,5,8", "-b", "2", "--prompt-len", "6",
            "--new-tokens", "5", "--kv-bits", str(kv_bits), "--device",
            "cpu"] + (["--shared-prefix", str(shared)] if shared else []) \
        + (["--temperature", "0.8", "--top-k", "40"] if sampled else [])
    solos = [generate.main(argv + ["--seed", str(r)]) for r in range(3)]
    many = generate.main(argv + ["--concurrent", "3"])
    assert many.shape == (3,) + solos[0].shape
    for out, solo in zip(many, solos):
        np.testing.assert_array_equal(out, solo)
    if sampled:
        assert len({out.tobytes() for out in many}) == 3
    assert "continuous batching" in capsys.readouterr().out


def test_monitor_writes_new_tokens_minus_one_rows(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    new = 6
    generate.main(["-m", TINY, "-pt", "1,4,5,8", "-b", "2", "--prompt-len",
                   "4", "--new-tokens", str(new), "--device", "cpu",
                   "--monitor"])
    with open(tmp_path / "decode.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == new - 1
    assert all(int(r["Work"]) == 2 for r in rows)


@pytest.fixture(scope="module")
def profile_files(tmp_path_factory):
    """Synthetic profiles of the tiny GPT-2 (8 sublayers, f32, batch 2) on
    two devices, whose best cut (after sublayer 3) is not block-aligned."""
    if tscheduler.compiler() is None:
        pytest.skip("no C++ compiler on this host: the port cannot build "
                    "sched-pipeline")
    assert tscheduler.build_native() is not None
    if jscheduler.build_native() is None:
        pytest.skip("the JAX package's sched-pipeline is unbuilt and its "
                    "cmake build is unavailable")
    d = tmp_path_factory.mktemp("gen-sched")
    n = 8
    docs = {
        "models.yml": {TINY: {"layers": n, "parameters_in": 8,
                              "parameters_out": [8 * 32] * n,
                              "mem_MB": [1.0] * n}},
        "device_types.yml": {"dev": {
            "mem_MB": 1024, "bw_Mbps": 3433227, "model_profiles": {TINY: [{
                "dtype": "float32", "batch_size": 2,
                "time_s": [0.02, 0.02, 0.02, 0.01, 0.01, 0.01, 0.01,
                           0.01]}]}}},
        "devices.yml": {"dev": ["d0", "d1"]},
    }
    for name, doc in docs.items():
        with open(d / name, "w") as f:
            yaml.safe_dump(doc, f, default_flow_style=None)
    return {k: str(d / v) for k, v in (
        ("-sm", "models.yml"), ("-sdt", "device_types.yml"),
        ("-sd", "devices.yml"))}


def test_scheduled_partition_is_the_jax_entry_s(profile_files, capsys):
    sched = jscheduler.sched_pipeline(
        TINY, 2, 2, 2, dtype="float32",
        models_file=profile_files["-sm"],
        dev_types_file=profile_files["-sdt"],
        dev_file=profile_files["-sd"])
    raw = [tuple(int(v) for v in layers)
           for stage in sched for layers in stage.values()]
    want = jdecode.round_partition_to_blocks(raw, 8)
    assert raw != want        # the cut moved to a block boundary
    argv = ["-m", TINY, "-b", "2", "--prompt-len", "4", "--new-tokens", "2",
            "--device", "cpu"]
    for flag, path in profile_files.items():
        argv += [flag, path]
    got = generate.scheduled_partition(generate.parse_args(argv))
    assert got == want
    assert f"scheduler partition {raw} rounded to block-aligned {want}" \
        in capsys.readouterr().out
    out = generate.main(argv)
    assert out.shape == (2, 6)
    assert f"({len(want)} stages)" in capsys.readouterr().out
