"""`python -m pipeedge_tpu_torch.runtime -c dcn --stage-tp N
[--tp-quant-bits B]`: each rank's stage tensor-parallel over N shards.

The tiny ViT in 2 ranks, `-pt 1,4,5,8`, 2 shards a rank on the CPU, the
same seeded weights in every process (the JAX package's seed-0 stream,
drawn per shard):

- the fleet at `--tp-quant-bits 8` (exact edges) equals the port's
  single-process TP forward (`runtime._make_tp_stage` for each stage, in
  this process) bit for bit: the transport moves raw f32 frames;
- that forward at bits 0 matches the JAX package's single-shard forward
  at rtol=2e-4, atol=2e-5 with the same argmax (row-parallel products
  sum across shards in another order than one matmul), and at bits 8
  stays within 0.05 of max |logit| of it and differs from it;
- each rank folds its stage's quantized collectives into stage-tagged
  `collective` spans after each microbatch, which `trace_report`'s
  `collectives` section shows per stage, and prints 0 kernel launches
  (the plain versions);
- the parse errors are the JAX entry's word for word, and the run-time
  schedulers cut at whole blocks under `--stage-tp`.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu_torch import runtime
from pipeedge_tpu_torch.ops import qcollectives
from pipeedge_tpu_torch.parallel import tensor as ttp
from pipeedge_tpu_torch.sched import rebalance
from pipeedge_tpu_torch.utils import data as data_utils

from test_torch_dcn_runtime import _launches, _run_fleet

MODEL = "pipeedge/test-tiny-vit"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["-m", MODEL, "-b", "16", "-u", "4", "-pt", "1,4,5,8", "-q", "0,0",
          "--stage-tp", "2"]
PARTITION = [(1, 4), (5, 8)]


def _ubatches():
    return [x for x, _ in data_utils.batch_dataset(
        runtime.load_dataset(MODEL, 16), 4)]


def _tp_forward(bits):
    """Both stages through `_make_tp_stage` in this process."""
    args = runtime.parse_args(["0", "2", "-c", "dcn", "--device", "cpu"]
                              + COMMON)
    stages = [runtime._make_tp_stage(args, l, r, i, torch.float32, None,
                                     "cpu")[0]
              for i, (l, r) in enumerate(PARTITION)]
    ttp.set_tp_quant_bits(bits)
    try:
        out = []
        for x in _ubatches():
            data = torch.from_numpy(x)
            for fn in stages:
                data = fn({}, data)
            out.append(data.numpy())
    finally:
        ttp.set_tp_quant_bits(0)
        qcollectives.reset_trace_tally()
    return out


def _jax_forward():
    stages = [jreg.module_shard_factory(MODEL, None, l, r, stage=i)
              for i, (l, r) in enumerate(PARTITION)]
    out = []
    for x in _ubatches():
        data = x
        for fn, params, _ in stages:
            data = fn(params, data)
        out.append(np.asarray(data))
    return out


@pytest.mark.fleet
def test_stage_tp_fleet_equals_single_process_tp(tmp_path):
    data, wouts, _ = _run_fleet(
        tmp_path, ["-c", "dcn", "--tp-quant-bits", "8", "--save-results",
                   "tp.npz", "--trace-spans", "spans.json",
                   "--sched-timeout", "60"] + COMMON, world=2)
    assert "stage 0: 1 block(s) TP-split over 2 shards on cpu, cpu" \
        in data.stderr
    assert "stage 1: 1 block(s) TP-split over 2 shards" in wouts[0]
    for out, rank in ((data.stdout + data.stderr, 0), (wouts[0], 1)):
        assert f"rank {rank} stage {rank} quantized collectives " \
               "(--tp-quant-bits 8)" in out
        assert set(_launches(out, rank).values()) == {0}
    want = _tp_forward(8)
    with np.load(tmp_path / "tp.npz") as got:
        assert len(got.files) == len(want) == 4
        for k, w in zip(sorted(got.files, key=lambda f: int(
                f.split("_")[-1])), want):
            np.testing.assert_array_equal(got[k], w)
    rep = subprocess.run(
        [sys.executable, "-m", "pipeedge_tpu_torch.trace_report",
         str(tmp_path / "spans.json")], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert rep.returncode == 0, rep.stderr
    col = json.loads(rep.stdout.strip().splitlines()[-1])["collectives"]
    # 2 all-reduces a block, 1 block a stage, 4 microbatches: 8 calls of
    # one [4, 17, 32] footprint per stage (2176 floats: 2 chunks of 1280
    # after padding, 2 ring hops a call), folded once per microbatch
    assert set(col["per_stage"]) == {"stage0", "stage1"}
    assert col["by_kind"] == {"psum8": col["wire_bytes"]}
    call = 2 * qcollectives._enc_bytes_per_chunk(1280, 256, 8)
    for stage in ("stage0", "stage1"):
        assert col["per_stage"][stage] == {"sites": 4,
                                           "wire_bytes": 8 * call}


def test_single_process_tp_matches_jax():
    exact = _tp_forward(0)
    quant = _tp_forward(8)
    for got, q, want in zip(exact, quant, _jax_forward()):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert not np.array_equal(q, got)
        assert np.abs(q - got).max() <= 0.05 * np.abs(got).max()


def _error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


PARSE_ERRORS = {
    "quant_bits_without_tp": ["-c", "dcn", "--tp-quant-bits", "8"],
    "stage_tp_needs_dcn": ["--stage-tp", "2"],
    "stage_tp_divides_heads": ["-c", "dcn", "-m", MODEL, "--stage-tp", "3"],
    "stage_tp_block_aligned": ["-c", "dcn", "-m", MODEL, "--stage-tp", "2",
                               "-pt", "1,3,4,8"],
}


@pytest.mark.parametrize("case", sorted(PARSE_ERRORS))
def test_parse_errors_are_the_jax_entry_s(case, monkeypatch):
    import runtime as jruntime
    argv = PARSE_ERRORS[case]
    got = _error(lambda: runtime.parse_args(["0", "2"] + argv))
    monkeypatch.setattr(sys, "argv", ["runtime.py", "0", "2"] + argv)
    assert got == _error(jruntime.main)


def test_schedulers_cut_whole_blocks_under_stage_tp():
    args = runtime.parse_args(["0", "2", "-c", "dcn", "-m", MODEL,
                               "--stage-tp", "2"])
    assert runtime._stage_align(args) == 4
    assert runtime._stage_align(runtime.parse_args(["0", "2"])) == 1
    cuts, _ = rebalance.solve_partition([1.0] * 8 + [9.0] * 8, 2,
                                        align=runtime._stage_align(args))
    assert all(l % 4 == 1 and r % 4 == 0 for l, r in cuts)


def test_stage_tp_refuses_what_it_cannot_split():
    args = runtime.parse_args(["0", "2", "-c", "dcn", "-m", MODEL])
    args.stage_tp = 3
    with pytest.raises(RuntimeError, match="must divide attention heads"):
        runtime._make_tp_stage(args, 1, 4, 0, torch.float32, None, "cpu")
    args.stage_tp = 2
    with pytest.raises(RuntimeError, match="block-aligned"):
        runtime._make_tp_stage(args, 1, 3, 0, torch.float32, None, "cpu")
