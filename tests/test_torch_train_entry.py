"""The port's training entry, `python -m pipeedge_tpu_torch.train`, in
process on the CPU, against the JAX package's `tools/train.py`.

- 2 stages x dp 2 of the tiny GPT-2 with Adam, a checkpoint at the end
  and a second run that resumes from it (JAX's
  `test_train_cli_multistage_dp_resume`): the `step=` losses are the JAX
  tool's to the printed 4 decimals (its weights, data and `optax.adam`
  on the JAX single-device gradient, which its pipelined program equals:
  `tests/test_train.py`), and the final JSON line carries its keys;
- BERT sequence classification learns (JAX's `test_train_cli_bert`);
- `--mixed-precision -t bfloat16`, an odd `-pt`, a partition that does
  not cover the model and `--platform` are refused, the first three with
  the JAX tool's `p.error` texts.
"""
import json
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pipeedge_tpu.models import ShardConfig, registry
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu.parallel import train as jtrain

from pipeedge_tpu_torch import train as ttrain

REPO = Path(__file__).resolve().parents[1]
GPT2_DP = ["-m", "pipeedge/test-tiny-gpt2", "-pt", "1,4,5,8", "--dp", "2",
           "-b", "2", "-u", "2", "--seq-len", "8", "--optimizer", "adam",
           "--log-every", "1"]


def _losses(text: str):
    return [float(m) for m in re.findall(r"loss=([0-9.]+)", text)]


def _jax_tool(argv, monkeypatch, capsys):
    """tools/train.py's main on `argv` in this process: (stdout, exit
    code or None)."""
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    code = None
    try:
        runpy.run_path(str(REPO / "tools" / "train.py"), run_name="__main__")
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return out.out + out.err, code


def _port(argv, capsys):
    code = None
    try:
        ttrain.main([*argv, "--device", "cpu"])
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return out.out + out.err, code


def test_multistage_dp_resume_matches_jax_tool(tmp_path, monkeypatch,
                                               capsys):
    ck = str(tmp_path / "ck")
    first, code = _port(GPT2_DP + ["--ckpt-dir", ck, "--steps", "3"], capsys)
    assert code is None, first
    losses = _losses(first)
    assert len(losses) == 3 and losses[-1] < losses[0]

    second, code = _port(GPT2_DP + ["--ckpt-dir", ck, "--steps", "5"],
                         capsys)
    assert code is None, second
    assert "resumed from" in second and "step 3" in second
    more = _losses(second)
    assert len(more) == 2 and more[-1] < losses[0]
    summary = json.loads(second.strip().splitlines()[-1])
    assert summary["steps"] == 2
    assert summary["mesh"] == {"dp": 2, "stage": 2}
    assert set(summary) == {"steps", "final_loss", "images_or_seqs_per_step",
                            "wall_s", "steps_per_sec", "mesh", "remat",
                            "mixed_precision", "ckpt"}

    np.testing.assert_allclose(losses + more, _jax_losses(5), rtol=0,
                               atol=1.5e-4)


def _jax_losses(steps: int):
    """The JAX tool's losses for GPT2_DP: each stage drawn by
    `init_params(seed=0)`, the data from `default_rng(0)`, `optax.adam`
    on the gradient of the whole model's forward."""
    name, total = "pipeedge/test-tiny-gpt2", 8
    cfg = registry.get_model_config(name)
    mod = registry.get_model_entry(name).family
    first, last = (mod.init_params(cfg, ShardConfig(
        l, r, is_first=l == 1, is_last=r == total), seed=0)
        for l, r in ((1, 4), (5, 8)))
    params = {"embeddings": first["embeddings"], "final": last["final"],
              "blocks": jax.tree_util.tree_map(
                  lambda a, b: jnp.concatenate([a, b]), first["blocks"],
                  last["blocks"])}
    fn = make_shard_fn(mod.FAMILY, cfg, ShardConfig(1, total, is_first=True,
                                                    is_last=True))
    ids = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 2, 9)), jnp.int32)
    x, y = ids[..., :-1], ids[..., 1:]

    def loss(p):
        return jtrain.softmax_xent(jnp.stack([fn(p, u) for u in x]), y)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(1e-3)
    state, out = opt.init(params), []
    for _ in range(steps):
        val, grads = value_and_grad(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append(float(val))
    return out


def test_bert_learns(capsys):
    out, code = _port(["-m", "pipeedge/test-tiny-bert", "-pt", "1,4,5,8",
                       "-b", "2", "-u", "2", "--seq-len", "8", "--steps",
                       "3", "--log-every", "1"], capsys)
    assert code is None, out
    losses = _losses(out)
    assert len(losses) == 3 and losses[-1] < losses[0]


@pytest.mark.parametrize("argv", [
    ["--mixed-precision", "-t", "bfloat16"],
    ["-pt", "1,4,5"],
    ["-pt", "1,4,6,8"],
])
def test_parse_errors_match_jax_tool(argv, monkeypatch, capsys):
    got, code = _port(argv, capsys)
    assert code == 2
    want, want_code = _jax_tool(argv + ["--platform", "cpu"], monkeypatch,
                                capsys)
    assert want_code == 2
    error = want.strip().splitlines()[-1]
    assert error.startswith("train.py: error: ")
    assert got.strip().splitlines()[-1].split(": error: ", 1)[1] \
        == error.split(": error: ", 1)[1]


def test_platform_flag_is_refused(capsys):
    got, code = _port(["--platform", "cpu"], capsys)
    assert code == 2 and "--platform is the JAX package's backend switch" \
        in got
