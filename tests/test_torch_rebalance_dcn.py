"""`--rebalance auto` on the port's `-c dcn` driver, held to the JAX
package's.

- Decision parity: the port's `_consider_rebalance` and
  `_estimates_from_digests`, fed the same recorded digest windows as
  `runtime.py`'s, return the same estimates and proposal (partition,
  gain and bottlenecks at rtol 1e-9) and print the same
  `rebalance_round=` line, boundary after boundary.
- Fleets (tests/test_rebalance.py's inputs: the tiny ViT over 2 ranks,
  3 rounds of 6 microbatches, threshold 0.02, cooldown 0). The JAX
  test's case, `delay@1:80` on rank 1's sends, runs with a JAX rank 1
  under a port data rank: the port re-cuts the delayed stage below 4
  layers at a round boundary, the merged trace counts the rebalance, and
  every round's results stay within f32 noise of round 0's. The port's
  own fleet, DeiT-tiny (48 sublayers of real compute on the CPU), is
  re-cut off a compute skew (`-pt 1,40,41,48`), every round's results
  equal to round 0's bit for bit (raw f32 edges); balanced
  (`-pt 1,24,25,48`), at the policy's default threshold, it never
  re-cuts.

Why the port's own fleet takes a compute skew: a send's delay is `emit`
time, which a re-cut cannot move (feedback.py: a per-microbatch cost the
stage keeps whatever its layers). The JAX package's stages dispatch the
tiny ViT in 50-70 ms a microbatch on this CPU, so taking layers off the
delayed stage still shortens it by ~20% (`CASES["jax_delay80"]`, the
means of a recorded JAX fleet). The port's dispatch it in ~3 ms: the
same policy then predicts a 1.5-4% gain for `delay@1:80` (recorded port
fleets; `CASES["port_delay80"]`), on the 0.02 threshold itself, so
whether a port-only fleet re-cuts would be a coin toss. The tiny ViT's
stages are also too cheap for a compute skew to stand out of a loaded
host's noise; DeiT-tiny's stages run 40-150 ms a microbatch. Balanced,
its data rank's stage (the embeddings, and the rank's feeding and
collecting) measures 2-4% slower than the other under load, which a
0.02 threshold rightly acts on (a re-cut to `-pt 1,23,24,48`); at the
default 0.10 the fleet holds its cut.
"""
import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest

import runtime as jrt
from pipeedge_tpu.sched import rebalance as jrebalance
from pipeedge_tpu_torch import runtime as trt
from pipeedge_tpu_torch.models import deit as tdeit
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.sched import rebalance as trebalance
from pipeedge_tpu_torch.telemetry import chrome_trace, report

from test_torch_dcn_runtime import REPO, _run_fleet

MODEL = "pipeedge/test-tiny-vit"
DEIT = "facebook/deit-tiny-distilled-patch16-224"
JAX = [sys.executable, os.path.join(REPO, "runtime.py"), "--platform", "cpu"]


# -- decision parity ----------------------------------------------------

def _cumulative(stage_ms, n, windows, drift=0.0):
    """Per-rank cumulative digests (stage i on rank i) at each of
    `windows` boundaries: `n` microbatches a window, `stage_ms[i]` =
    (dispatch, readback, emit) ms per microbatch, the k-th window
    stretched by `drift * k`."""
    out, acc = [], {}
    for k in range(windows):
        snap = {}
        for i, parts in enumerate(stage_ms):
            for name, ms in zip(("dispatch", "readback", "emit"), parts):
                key = ("stage", name, i)
                c, ns = acc.get(key, (0, 0))
                acc[key] = (c + n, ns + int(ms * (1 + drift * k) * 1e6 * n))
            snap[i] = {key: v for key, v in acc.items() if key[2] == i}
        out.append(snap)
    return out


# (stage ms per microbatch, partition, policy knobs, drift)
CASES = {
    # recorded: the port's 2-rank tiny-ViT fleet under delay@1:80
    "port_delay80": ([(3.14, 0.49, 0.72), (2.55, 0.57, 81.46)],
                     [(1, 4), (5, 8)], dict(threshold=0.02, cooldown=0), 0),
    # recorded: the JAX package's fleet under delay@1:80
    "jax_delay80": ([(69.59, 8.26, 0.78), (50.96, 4.00, 81.83)],
                    [(1, 4), (5, 8)], dict(threshold=0.02, cooldown=0), 0),
    "port_delay15": ([(3.1, 0.5, 0.7), (2.6, 0.6, 15.4)],
                     [(1, 4), (5, 8)], dict(threshold=0.02, cooldown=0), 0),
    "skewed_vit_base": ([(30.0, 1.0, 0.4), (1.0, 1.0, 0.4),
                         (8.0, 1.0, 0.4), (2.5, 1.0, 0.4)],
                        [(1, 40), (41, 42), (43, 46), (47, 48)],
                        dict(threshold=0.1, cooldown=1, confirm=0), 0.05),
    "balanced": ([(5.0, 0.5, 0.5), (5.1, 0.5, 0.5)], [(1, 4), (5, 8)],
                 dict(threshold=0.1), 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consider_rebalance_equals_the_jax_decision(case, capsys):
    stage_ms, partition, knobs, drift = CASES[case]
    jpol = jrebalance.RebalancePolicy(**knobs)
    tpol = trebalance.RebalancePolicy(**knobs)
    sched = (list(partition), [0] * len(partition),
             list(range(len(partition))))
    jprev, tprev = {}, {}
    applied = 0
    for rnd, cur in enumerate(_cumulative(stage_ms, 6, 4, drift)):
        jest = jrt._estimates_from_digests(cur, sched, dict(jprev))
        test = trt._estimates_from_digests(cur, sched, dict(tprev))
        assert (jest is None) == (test is None)
        if jest is not None:
            assert {k: dataclasses.asdict(v) for k, v in jest.items()} == \
                {k: dataclasses.asdict(v) for k, v in test.items()}
        capsys.readouterr()
        jprop = jrt._consider_rebalance(None, None, jpol, sched, jprev, rnd,
                                        cur_digests=cur)
        jout = capsys.readouterr().out
        tprop = trt._consider_rebalance(None, None, tpol, sched, tprev, rnd,
                                        cur_digests=cur)
        tout = capsys.readouterr().out
        assert jout == tout
        assert (jprop is None) == (tprop is None)
        if jprop is None:
            continue
        assert [tuple(p) for p in tprop.partition] == \
            [tuple(p) for p in jprop.partition]
        for attr in ("gain", "bottleneck_before_s", "bottleneck_after_s"):
            np.testing.assert_allclose(getattr(tprop, attr),
                                       getattr(jprop, attr), rtol=1e-9)
        assert tout.startswith(f"rebalance_round={rnd} partition=")
        applied += 1
        sched = ([tuple(p) for p in tprop.partition], sched[1], sched[2])
    # the windows stand for stages that stay as slow after a re-cut, so a
    # skew keeps being re-cut (cooldown and confirmation permitting)
    assert (applied > 0) == (case != "balanced")


def test_no_measurable_window_keeps_the_partition(capsys):
    """A failed sweep (None) or a window missing a stage moves nothing,
    in either package."""
    sched = ([(1, 4), (5, 8)], [0, 0], [0, 1])
    half = {0: _cumulative([(3, 1, 1)], 6, 1)[0][0]}
    for cur in (None, half):
        for mod, pol in ((jrt, jrebalance), (trt, trebalance)):
            assert mod._consider_rebalance(None, None, pol.RebalancePolicy(),
                                           sched, {}, 0,
                                           cur_digests=cur) is None
    assert "rebalance_round=" not in capsys.readouterr().out


# -- fleets ---------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(
        registry.get_model_config(MODEL), seed=21))
    return str(path)


@pytest.fixture(scope="module")
def deit_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "deit-tiny.npz"
    np.savez(path, **tdeit.random_npz_weights(
        registry.get_model_config(DEIT), seed=21))
    return str(path)


def _rebalance_fleet(tmp_path, weights, partition="1,4,5,8", delay_ms=None,
                     cmds=None, model=MODEL, threshold="0.02"):
    """tests/test_rebalance.py's fleet (2 ranks, 3 rounds of 6
    microbatches, one compute thread a rank) with rank 1's sends
    delayed; returns the data rank's output, every round's results and
    the merged trace's report."""
    trace = tmp_path / "trace.json"
    opts = ["-c", "dcn", "-m", model, "-M", weights, "-pt", partition,
            "-b", "24", "-u", "4", "--sched-timeout", "120", "--rounds", "3",
            "--rebalance", "auto", "--rebalance-threshold", threshold,
            "--rebalance-cooldown", "0", "--trace-spans", str(trace),
            "--save-results", "r.npz"]
    rank_env = {1: {"DCN_CHAOS": f"delay@1:{delay_ms}"}} if delay_ms else None
    data, _, _ = _run_fleet(tmp_path, opts, 2, timeout=150, cmds=cmds,
                            env_extra={"OMP_NUM_THREADS": "1"},
                            rank_env=rank_env)
    with np.load(tmp_path / "r.npz") as f:
        results = [f[f"arr_{i}"] for i in range(len(f.files))]
    with open(trace) as f:
        rep = report.analyze_spans(chrome_trace.trace_to_spans(json.load(f)))
    return data.stdout + data.stderr, results, rep


def _recut(out, total=8):
    part = re.search(r"rebalance_round=\d+ partition=(\d+),(\d+),(\d+),(\d+)",
                     out)
    assert part is not None, out
    l0, r0, l1, r1 = (int(v) for v in part.groups())
    assert (l0, r0 + 1, r1) == (1, l1, total)
    return r0 - l0 + 1, r1 - l1 + 1


def _rounds(results, n=6):
    assert len(results) == 3 * n
    return [results[k * n:(k + 1) * n] for k in range(3)]


@pytest.mark.fleet
def test_port_data_rank_recuts_a_delayed_jax_worker(tmp_path, weights):
    """tests/test_rebalance.py's case, `delay@1:80` on rank 1's sends,
    with a JAX rank 1 under a port data rank."""
    out, results, rep = _rebalance_fleet(tmp_path, weights, delay_ms=80,
                                         cmds={1: JAX})
    _, n1 = _recut(out)
    assert n1 < 4, f"slow stage kept {n1} layers: {out}"
    assert rep["rebalance_events"] >= 1 and rep["spans"] > 0
    first, *later = _rounds(results)
    for rnd in later:
        for got, want in zip(rnd, first):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.fleet
def test_skewed_port_fleet_is_recut_bit_identical(tmp_path, deit_weights):
    out, results, rep = _rebalance_fleet(tmp_path, deit_weights,
                                         partition="1,40,41,48", model=DEIT)
    n0, _ = _recut(out, total=48)
    assert n0 < 40, f"the heavy stage kept {n0} layers: {out}"
    assert rep["rebalance_events"] >= 1 and rep["bubble_pct"] is not None
    first, *later = _rounds(results)
    for rnd in later:
        for got, want in zip(rnd, first):
            np.testing.assert_array_equal(got, want)


@pytest.mark.fleet
def test_balanced_fleet_never_recuts(tmp_path, deit_weights):
    out, results, rep = _rebalance_fleet(tmp_path, deit_weights,
                                         partition="1,24,25,48", model=DEIT,
                                         threshold="0.10")
    assert "rebalance_round=" not in out
    assert rep["rebalance_events"] == 0
    assert len(results) == 18


# -- the entry's composition errors -------------------------------------

@pytest.mark.parametrize("argv", [
    ["-c", "dcn", "--rebalance", "auto"],
    ["-c", "dcn", "--rebalance", "auto", "-pt", "1,4,5,8;1,2,3,8"],
    ["-c", "dcn", "--rebalance", "auto", "--rounds", "2", "--stage-ckpt",
     "d"],
    ["--rebalance", "auto"]],
    ids=["single_round", "distinct_partitions", "stage_ckpt", "host"])
def test_rebalance_compose_errors_are_the_jax_entry_s(argv, monkeypatch):
    from test_torch_generate_flags import _error
    got = _error(lambda: trt.parse_args(["0", "2"] + argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py", "0", "2"] + argv)
    assert got == _error(jrt.main)
