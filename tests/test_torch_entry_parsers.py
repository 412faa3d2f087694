"""Two entry parsers against the JAX tools' on the same command lines.

- The profiler: `-w/--warmup` (on by default) and `--no-warmup` give the
  warm-up setting the JAX `profiler.py` profiles with, in either order.
- The runtime's driver-mode errors: `--stage-ckpt` and `--rounds` off
  the dcn driver, ';'-separated rounds off it, `--rounds 0` on every
  driver and `--rounds` with ';' rounds are the JAX entry's messages in
  its order (exit 2), and a rank other than 0 off the dcn driver logs the
  JAX warning and returns (exit 0), before any later check.
"""
import io
import logging
import sys
from contextlib import redirect_stderr

import pytest

import profiler as jprofiler
import runtime as jruntime
from pipeedge_tpu_torch import profiler as tprofiler
from pipeedge_tpu_torch import runtime as truntime

TINY_VIT = "pipeedge/test-tiny-vit"


class _Profiled(Exception):
    pass


@pytest.mark.parametrize("argv", [[], ["-w"], ["--warmup"], ["--no-warmup"],
                                  ["-w", "--no-warmup"],
                                  ["--no-warmup", "-w"]],
                         ids=["default", "w", "warmup", "no_warmup",
                              "w_then_no", "no_then_w"])
def test_profiler_warmup_flags_are_the_jax_tool_s(argv, tmp_path,
                                                   monkeypatch):
    base = ["-m", TINY_VIT, "-b", "1", "-o", str(tmp_path / "p.yml")]

    def profile(model, model_file, inputs, start, end, warmup, *a, **kw):
        raise _Profiled(warmup)

    monkeypatch.setattr(jprofiler.prof, "profile_layers_individually",
                        profile)
    monkeypatch.setattr(sys, "argv", ["profiler.py"] + base + argv)
    with pytest.raises(_Profiled) as exc:
        jprofiler.main()
    assert tprofiler.parse_args(base + argv).warmup is exc.value.args[0]


def _parse_error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


ROUNDS = "1,4,5,8;1,2,3,8"
# case -> (argv after "RANK 2 -m TINY_VIT", the message's first words)
ERRORS = {
    "stage_ckpt_host": (["0", "--stage-ckpt", "ckpt"],
                        "--stage-ckpt is a dcn-mode option"),
    "stage_ckpt_spmd": (["0", "-c", "spmd", "--stage-ckpt", "ckpt"],
                        "--stage-ckpt is a dcn-mode option"),
    # checked before the --rebalance auto errors
    "stage_ckpt_before_rebalance": (
        ["0", "--stage-ckpt", "ckpt", "--rebalance", "auto"],
        "--stage-ckpt is a dcn-mode option"),
    "rounds_semicolon_host": (["0", "-pt", ROUNDS],
                              "';'-separated re-schedule rounds require"),
    "rounds_zero_host": (["0", "--rounds", "0"], "--rounds must be >= 1"),
    "rounds_zero_spmd": (["0", "-c", "spmd", "--rounds", "0"],
                         "--rounds must be >= 1"),
    "rounds_zero_dcn": (["0", "-c", "dcn", "--rounds", "0"],
                        "--rounds must be >= 1"),
    "rounds_host": (["0", "--rounds", "2"], "--rounds requires --comm dcn"),
    "rounds_spmd": (["0", "-c", "spmd", "--rounds", "3"],
                    "--rounds requires --comm dcn"),
    "rounds_with_semicolons": (["0", "-c", "dcn", "--rounds", "2", "-pt",
                                ROUNDS], "--rounds cannot combine"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_driver_mode_errors_are_the_jax_runtime_s(case, monkeypatch):
    argv, words = ERRORS[case]
    argv = argv[:1] + ["2", "-m", TINY_VIT] + argv[1:]
    got = _parse_error(lambda: truntime.parse_args(argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py"] + argv)
    assert got == _parse_error(jruntime.main)
    assert got.startswith(words)


@pytest.mark.parametrize("argv", [["-c", "host"], ["-c", "spmd"],
                                  ["--rounds", "0"],
                                  ["--stage-tp", "2", "-pt", ROUNDS]],
                         ids=["host", "spmd", "rounds_zero",
                              "later_errors"])
def test_rank_1_off_dcn_warns_and_returns(argv, monkeypatch, caplog):
    """Only rank 0 runs a single-controller driver: another rank logs the
    JAX warning and returns (exit 0) before the rounds and later checks."""
    argv = ["1", "2", "-m", TINY_VIT] + argv
    caplog.set_level(logging.WARNING)
    assert truntime.main(argv) is None
    got = [r.getMessage() for r in caplog.records]
    caplog.clear()
    monkeypatch.setattr(sys, "argv", ["runtime.py"] + argv)
    assert jruntime.main() is None
    want = [r.getMessage() for r in caplog.records]
    assert got == want
    assert got[0].startswith("Single-controller runtime: only rank 0 runs; "
                             "rank 1 exits immediately")
