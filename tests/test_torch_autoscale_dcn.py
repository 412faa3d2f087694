"""`--autoscale-ranks` on the port's `-c dcn` driver, held to the JAX
package's.

- Decision parity: the port's `_consider_autoscale` and `runtime.py`'s,
  ticked on the same digest windows at each boundary, print the same
  `autoscale_decision` and `autoscale_rank` lines, rewrite the remaining
  rounds to the same schedules and bench the same ranks: scale-up onto
  an idle rank, scale-down by one stage, advise mode, the floor.
- Fleets (the tiny ViT, one process per rank, raw f32 edges): under up
  pressure a 2-stage fleet of 3 ranks expands onto rank 2 at the second
  boundary and runs 3 stages after it; under down pressure a 3-stage
  fleet contracts to 2 and benches the rank with the fewest layers.
  Every round's results equal round 0's bit for bit.
- The entry's composition errors are `runtime.py`'s, word for word.
"""
import argparse
import sys

import numpy as np
import pytest

import runtime as jrt
from pipeedge_tpu_torch import runtime as trt

from test_torch_dcn_runtime import _run_fleet
from test_torch_rebalance_dcn import MODEL, weights  # noqa: F401


def _args(**kw):
    base = dict(rank=0, autoscale_ranks="auto", autoscale_min=2,
                autoscale_max=0, autoscale_confirm=2,
                autoscale_cooldown=0.0, autoscale_rank_high=0.75,
                autoscale_rank_low=0.05, stage_tp=1)
    base.update(kw)
    return argparse.Namespace(**base)


def _window(acc, stage_ms, n=6):
    """Advance the cumulative per-rank digests `acc` by one window of `n`
    microbatches, stage i on rank i taking (dispatch, readback, emit) =
    stage_ms[i] ms; returns the boundary's snapshot."""
    snap = {}
    for i, parts in enumerate(stage_ms):
        for name, ms in zip(("dispatch", "readback", "emit"), parts):
            key = ("stage", name, i)
            c, ns = acc.get(key, (0, 0))
            acc[key] = (c + n, ns + int(ms * 1e6 * n))
        snap[i] = {k: v for k, v in acc.items() if k[2] == i}
    return snap


def _norm(sched):
    layers, quant, ranks = sched
    return ([list(p) for p in layers], list(quant), list(ranks))


@pytest.fixture
def clean_state():
    for mod in (jrt, trt):
        mod.dead_ranks.clear()
        mod.autoscaled_ranks.clear()
    yield
    for mod in (jrt, trt):
        mod.dead_ranks.clear()
        mod.autoscaled_ranks.clear()


# (world, first schedule, stage ms per microbatch, rounds, argument knobs)
CASES = {
    "up": (3, ([(1, 4), (5, 8)], [0, 0], [0, 1]), (20.0, 1.0, 1.0), 5,
           dict(autoscale_rank_high=0.01)),
    "down": (3, ([(1, 2), (3, 5), (6, 8)], [0, 0, 0], [0, 1, 2]),
             (1.0, 0.5, 0.5), 5, dict(autoscale_rank_low=0.01)),
    "down_to_floor": (4, ([(1, 2), (3, 4), (5, 6), (7, 8)], [0] * 4,
                          [0, 1, 2, 3]), (1.0, 0.5, 0.5), 7,
                      dict(autoscale_rank_low=0.01, autoscale_confirm=1)),
    "advise": (3, ([(1, 4), (5, 8)], [0, 0], [0, 1]), (20.0, 1.0, 1.0), 5,
               dict(autoscale_ranks="advise", autoscale_rank_high=0.01)),
    "steady": (3, ([(1, 4), (5, 8)], [0, 0], [0, 1]), (5.0, 1.0, 1.0), 5,
               dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consider_autoscale_equals_the_jax_decision(case, capsys,
                                                    clean_state):
    world, first, stage, rounds, knobs = CASES[case]
    args = _args(**knobs)
    sched_of = {}
    for mod in (jrt, trt):
        schedules = [first] * rounds
        state = {"prev_digests": {}, "controller": None}
        acc, lines = {}, []
        for idx in range(rounds - 1):
            sched = schedules[idx]
            cur = _window(acc, [stage] * len(sched[0]))
            capsys.readouterr()
            mod._consider_autoscale(None, args, state, sched, schedules,
                                    idx, world, idx, cur_digests=cur)
            lines.append(capsys.readouterr().out)
        sched_of[mod] = ([_norm(s) for s in schedules], lines,
                         sorted(mod.autoscaled_ranks))
    (jsched, jlines, jbench), (tsched, tlines, tbench) = \
        sched_of[jrt], sched_of[trt]
    assert tlines == jlines
    assert tsched == jsched
    assert tbench == jbench
    text = "".join(tlines)
    if case == "up":
        assert "autoscale_rank direction=up round=1 ranks=0,1,2" in text
        assert [len(s[0]) for s in tsched] == [2, 2, 3, 3, 3]
    elif case == "down":
        assert "autoscale_rank direction=down round=1 victim=1" in text
        assert tsched[-1] == ([[1, 4], [5, 8]], [0, 0], [0, 2])
        assert tbench == [1]
    elif case == "down_to_floor":
        assert [len(s[0]) for s in tsched][-1] == 2   # --autoscale-min
    else:
        assert "autoscale_rank" not in text
        assert all(s == _norm(first) for s in tsched)
    if case == "advise":
        assert "autoscale_decision" in text and "advised" in text


# -- fleets ---------------------------------------------------------------

def _autoscale_fleet(tmp_path, weights, partition, ranks, flags, rounds=4):
    opts = ["-c", "dcn", "-m", MODEL, "-M", weights, "-pt", partition,
            "-r", ranks, "-b", "16", "-u", "4", "--sched-timeout", "120",
            "--rounds", str(rounds), "--on-peer-death", "failover",
            "--autoscale-ranks", "auto", "--save-results", "r.npz"] + flags
    data, wouts, _ = _run_fleet(tmp_path, opts, 3, timeout=150,
                                env_extra={"OMP_NUM_THREADS": "1"})
    with np.load(tmp_path / "r.npz") as f:
        results = [f[f"arr_{i}"] for i in range(len(f.files))]
    assert len(results) == 4 * rounds
    first = results[:4]
    for k in range(1, rounds):
        for got, want in zip(results[4 * k:4 * (k + 1)], first):
            np.testing.assert_array_equal(got, want)
    return data.stdout + data.stderr, wouts


@pytest.mark.fleet
def test_up_pressure_expands_onto_the_idle_rank(tmp_path, weights):
    out, wouts = _autoscale_fleet(tmp_path, weights, "1,4,5,8", "0,1",
                                  ["--autoscale-rank-high", "0.000001"])
    assert "autoscale_decision" in out
    assert "autoscale_rank direction=up round=1 ranks=0,1,2" in out
    # rank 2 idled through rounds 0-1 and carries the third stage after
    assert "stage 2: layers" in wouts[1]


@pytest.mark.fleet
def test_down_pressure_contracts_and_benches(tmp_path, weights):
    out, wouts = _autoscale_fleet(
        tmp_path, weights, "1,2,3,5,6,8", "0,1,2",
        ["--autoscale-rank-low", "10", "--autoscale-rank-high", "20"])
    assert "autoscale_rank direction=down round=1 victim=1" in out
    assert "stage 1: layers [5, 8]" in wouts[1]   # rank 2, after


# -- the entry's composition errors -------------------------------------

@pytest.mark.parametrize("argv", [
    ["--autoscale-ranks", "auto"],
    ["-c", "dcn", "--autoscale-ranks", "auto"],
    ["-c", "dcn", "--autoscale-ranks", "auto", "--rounds", "2"],
    ["-c", "dcn", "--autoscale-ranks", "advise", "--rounds", "2",
     "--autoscale-min", "0"],
    ["-c", "dcn", "--autoscale-ranks", "advise", "--rounds", "2",
     "--autoscale-confirm", "0"]],
    ids=["host", "single_round", "auto_without_failover", "min", "confirm"])
def test_autoscale_compose_errors_are_the_jax_entry_s(argv, monkeypatch):
    from test_torch_generate_flags import _error
    got = _error(lambda: trt.parse_args(["0", "2"] + argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py", "0", "2"] + argv)
    assert got == _error(jrt.main)
