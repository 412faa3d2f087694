"""`python -m pipeedge_tpu_torch.generate --spmd-wave` on the CPU.

The tiny GPT-2 in 2 stages, weights from a numpy seed in an HF-layout npz
that both packages load:

- the entry prints the JAX entry's two report lines (`tools/generate.py
  run_spmd_wave`): the same continuation ids on the same prompts and
  weights, and the same summary up to the timings;
- each slot's continuation equals the entry's solo run, greedy and
  sampled (slot r with `--seed` + r);
- `--edge-bits 8` runs the prompt hops through the codec, and
  `--draft-model` is ignored by the wave, as in the JAX entry;
- the composition errors of `--spmd-wave` are the JAX entry's, word for
  word.
"""
import importlib.util
import io
import pathlib
import re
import sys
from contextlib import redirect_stderr

import numpy as np
import pytest

from pipeedge_tpu_torch import generate
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry as treg

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = "pipeedge/test-tiny-gpt2"
PROMPT, NEW = 6, 5
ARGV = ["-m", MODEL, "-pt", "1,4,5,8", "-b", "2", "--prompt-len",
        str(PROMPT), "--new-tokens", str(NEW)]
SUMMARY = re.compile(r"generated 2x2x5 tokens in \d+\.\d{3}s = \d+\.\d "
                     r"tok/s \(2 stages, SPMD wave decode\)")


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "tiny-gpt2.npz"
    np.savez(path, **tgpt2.random_npz_weights(treg.get_model_config(MODEL),
                                              seed=5))
    return str(path)


def _jax_generate():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", ROOT / "tools" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(argv, capsys):
    out = generate.main(argv + ["--device", "cpu"])
    return out, capsys.readouterr().out.splitlines()


def test_entry_prints_the_jax_entry_s_lines(weights_file, capsys,
                                            monkeypatch):
    argv = ARGV + ["-M", weights_file, "--spmd-wave"]
    out, lines = _port(argv, capsys)
    assert out.shape == (2, 2, PROMPT + NEW)
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    _jax_generate().main()
    want = capsys.readouterr().out.splitlines()
    assert SUMMARY.fullmatch(lines[0]) and SUMMARY.fullmatch(want[0])
    assert lines[1] == want[1] == (
        f"sample continuation ids: {out[0, 0, PROMPT:].tolist()}")
    assert lines[2].startswith("kernel_launches=")


@pytest.mark.parametrize("sampling", [[], ["--temperature", "0.9",
                                           "--top-k", "7", "--seed", "3"]],
                         ids=["greedy", "sampled"])
def test_each_slot_equals_its_solo_run(weights_file, capsys, sampling):
    argv = ARGV + ["-M", weights_file] + sampling
    wave, _ = _port(argv + ["--spmd-wave"], capsys)
    seed = int(sampling[-1]) if sampling else 0
    for r in range(2):
        solo, _ = _port(argv + ["--seed", str(seed + r)], capsys)
        np.testing.assert_array_equal(wave[r], solo, err_msg=f"slot {r}")


def test_edge_bits_and_an_ignored_draft(weights_file, capsys):
    """8-bit prompt hops keep the prompts and stay in the vocabulary; a
    draft model leaves the wave's tokens as they are."""
    argv = ARGV + ["-M", weights_file, "--spmd-wave"]
    plain, _ = _port(argv, capsys)
    q8, lines = _port(argv + ["--edge-bits", "8"], capsys)
    assert SUMMARY.fullmatch(lines[0])
    np.testing.assert_array_equal(q8[:, :, :PROMPT], plain[:, :, :PROMPT])
    assert 0 <= q8.min() and q8.max() < 100
    drafted, lines = _port(argv + ["--draft-model", MODEL], capsys)
    assert SUMMARY.fullmatch(lines[0])
    np.testing.assert_array_equal(drafted, plain)


def _error(fn):
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


COMPOSE = {
    "concurrent": ["--spmd-wave", "--concurrent", "2"],
    "beams": ["--spmd-wave", "--beams", "2"],
    "monitor": ["--spmd-wave", "--monitor"],
    "kv_bits": ["--spmd-wave", "--kv-bits", "8"],
    "sp": ["--spmd-wave", "--sp", "2"],
    "prefill_ubatch": ["--spmd-wave", "--prefill-ubatch", "1"],
    "dcn": ["--spmd-wave", "--dcn-addrs", "127.0.0.1:1,127.0.0.1:2"],
    "shared_prefix": ["--spmd-wave", "--shared-prefix", "2"],
    "edge_bits_alone": ["--edge-bits", "8"],
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_compose_errors_are_the_jax_entry_s(case, monkeypatch):
    argv = ARGV + COMPOSE[case]
    got = _error(lambda: generate.parse_args(argv + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["generate.py"] + argv)
    assert got == _error(_jax_generate().main)
