"""The port's multi-process contexts against the JAX package.

Two gloo processes of `tests/torch_multihost_main.py` join one world
through `pipeedge_tpu_torch.comm.MultiHostContext` and run the legs of
`tests/multihost_spmd_main.py` over process-spanning meshes (4 CPU
positions each), plus a stage edge between the processes. Held, as the
JAX test holds its worker:

- both ranks print the same loss sequence, and it falls;
- the losses equal the JAX single-process oracle on this process's 8
  CPU devices at rtol 1e-4 (the JAX test's bound);
- the dp 2 x 4 pipeline's outputs equal the JAX `spmd` run of the same
  mesh at atol 1e-5; a 2-stage pipeline whose 'tp' axis crosses the
  processes equals the port's single-process run bit for bit, exact and
  with 8-bit collectives;
- the tp decode's tokens equal the JAX `DecodePipeline` over a 4-device
  'tp' mesh;
- the stage-crossing leg's outputs equal the port's single-process
  `SpmdPipeline` bit for bit, its losses the single-process steps' at
  rtol 1e-6; every rank's trained canonical copy of a part equals every
  other's that holds it.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_multihost_main.py")
N_STAGES, DP, BATCH = 4, 2, 4

pytestmark = pytest.mark.fleet  # every test here spawns OS processes


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' stdout and saved results (one run for the module)."""
    out_dir = tmp_path_factory.mktemp("multihost")
    with socket.create_server(("127.0.0.1", 0)) as s:
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, SCRIPT, str(r), "2", coord, str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
        assert f"MULTIHOST-OK rank={r} local=4 global=8" in out, out
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
               for r in range(2)]
    return outs, results


def _losses(out, key="train_losses"):
    return re.search(rf"{key}=\[([^\]]+)\]", out).group(1)


def _vit():
    from pipeedge_tpu.models import ShardConfig
    from pipeedge_tpu.models import vit as vit_mod
    from pipeedge_tpu.models.layers import TransformerConfig
    cfg = TransformerConfig(model_type="vit", hidden_size=32,
                            num_hidden_layers=N_STAGES,
                            num_attention_heads=4, intermediate_size=64,
                            num_labels=5, image_size=16, patch_size=4)
    total = 4 * N_STAGES
    partition = [(4 * i + 1, 4 * (i + 1)) for i in range(N_STAGES)]
    stage_params = [vit_mod.init_params(
        cfg, ShardConfig(l, r, is_first=l == 1, is_last=r == total),
        seed=0) for l, r in partition]
    return cfg, partition, stage_params


def _train_data():
    x = np.random.default_rng(7).normal(
        size=(N_STAGES + 1, BATCH, 3, 16, 16)).astype(np.float32)
    y = np.random.default_rng(8).integers(0, 5, size=(N_STAGES + 1, BATCH))
    return x, y


def test_ranks_agree_and_losses_fall(ranks):
    outs, results = ranks
    seqs = [_losses(out) for out in outs]
    assert seqs[0] == seqs[1], seqs
    losses = [float(v) for v in seqs[0].split(",")]
    assert losses[-1] < losses[0], losses
    stage = [_losses(out, "stage_losses") for out in outs]
    assert stage[0] == stage[1], stage
    assert all(r["backend"] == "gloo" for r in results)
    for key in ("out", "stage_out", "decode"):
        assert torch.equal(results[0][key], results[1][key]), key


def test_losses_match_jax_single_process_oracle(ranks):
    import jax.numpy as jnp
    import optax

    from pipeedge_tpu.models import vit as vit_mod
    from pipeedge_tpu.parallel import spmd
    from pipeedge_tpu.parallel import train as train_mod
    outs, _ = ranks
    losses = [float(v) for v in _losses(outs[0]).split(",")]
    cfg, partition, stage_params = _vit()
    mesh = spmd.make_pipeline_mesh(N_STAGES, dp=DP)
    pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                    stage_params, mesh)
    x, y = _train_data()
    t_inputs, t_labels = jnp.asarray(x), jnp.asarray(y, jnp.int32)
    step_fn, opt_state = train_mod.make_train_step(
        pipe, optax.sgd(0.05), t_inputs)
    params = pipe.params
    for want in losses:
        params, opt_state, loss = step_fn(params, opt_state, t_inputs,
                                          t_labels)
        np.testing.assert_allclose(want, float(loss), rtol=1e-4)


def test_pipeline_matches_jax_spmd(ranks):
    import jax.numpy as jnp

    from pipeedge_tpu.models import vit as vit_mod
    from pipeedge_tpu.parallel import spmd
    _, results = ranks
    cfg, partition, stage_params = _vit()
    mesh = spmd.make_pipeline_mesh(N_STAGES, dp=DP)
    pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                    stage_params, mesh,
                                    quant_bit=[8] * (N_STAGES - 1) + [0])
    inputs = np.random.default_rng(0).normal(
        size=(N_STAGES + 1, BATCH, 3, 16, 16)).astype(np.float32)
    want = np.asarray(pipe.run(jnp.asarray(inputs)))
    for r in results:
        assert r["out"].shape == want.shape
        np.testing.assert_allclose(r["out"].numpy(), want, atol=1e-5)


def test_decode_matches_jax_tp_decode(ranks):
    import jax
    from jax.sharding import Mesh

    from pipeedge_tpu.models import ShardConfig
    from pipeedge_tpu.models import gpt2 as gpt2_mod
    from pipeedge_tpu.models.layers import TransformerConfig
    from pipeedge_tpu.parallel import decode as dec_mod
    _, results = ranks
    cfg = TransformerConfig(
        model_type="gpt2", hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, layer_norm_eps=1e-5,
        vocab_size=48, max_position_embeddings=32)
    partition = [(1, 4), (5, 8)]
    params = [gpt2_mod.init_params(
        cfg, ShardConfig(l, r, is_first=l == 1, is_last=r == 8), seed=0)
        for l, r in partition]
    tp_mesh = Mesh(np.asarray(jax.devices()[:4]), ("tp",))
    pipe = dec_mod.DecodePipeline(gpt2_mod.FAMILY, cfg, partition, params,
                                  max_len=16, mesh=tp_mesh)
    want = np.asarray(pipe.generate(
        np.random.default_rng(3).integers(0, 48, size=(2, 5)),
        new_tokens=3))
    for r in results:
        np.testing.assert_array_equal(r["decode"].numpy(), want)


def test_stage_crossing_leg_matches_single_process(ranks):
    from pipeedge_tpu_torch.models import ShardConfig
    from pipeedge_tpu_torch.models import vit as vit_mod
    from pipeedge_tpu_torch.models.layers import TransformerConfig
    from pipeedge_tpu_torch.parallel import spmd
    from pipeedge_tpu_torch.parallel import train as train_mod
    outs, results = ranks
    cfg = TransformerConfig(model_type="vit", hidden_size=32,
                            num_hidden_layers=N_STAGES,
                            num_attention_heads=4, intermediate_size=64,
                            num_labels=5, image_size=16, patch_size=4)
    partition = [(4 * i + 1, 4 * (i + 1)) for i in range(N_STAGES)]

    def stages():
        return [vit_mod.init_params(cfg, ShardConfig(
            l, r, is_first=l == 1, is_last=r == 4 * N_STAGES), seed=0)
            for l, r in partition]

    mesh = spmd.make_pipeline_mesh(N_STAGES, device="cpu")
    pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                    stages(), mesh,
                                    quant_bit=[8] * (N_STAGES - 1) + [0])
    inputs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N_STAGES + 1, BATCH, 3, 16, 16)).astype(np.float32))
    want = pipe.run(inputs)
    for r in results:
        assert torch.equal(r["stage_out"], want)

    t_pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                      stages(), mesh)
    x, y = _train_data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    step_fn, opt_state = train_mod.make_train_step(
        t_pipe, lambda leaves: torch.optim.SGD(leaves, lr=0.05,
                                               momentum=0.9), x)
    params, losses = t_pipe.canonical, []
    for _ in range(3):
        params, opt_state, loss = step_fn(params, opt_state, x, y)
        losses.append(float(loss))
    for r in results:
        np.testing.assert_allclose(r["stage_losses"], losses, rtol=1e-6)
    # the processes' canonical copies hold stages 0-1 (and the embedding)
    # and stages 2-3 (and the head): together the single process's tree
    mine = [r["stage_params"] for r in results]
    assert [len(b) for b in mine[0]["blocks"]] == [1, 1, 0, 0]
    assert [len(b) for b in mine[1]["blocks"]] == [0, 0, 1, 1]
    assert "embed" in mine[0] and "final" not in mine[0]
    assert "final" in mine[1] and "embed" not in mine[1]
    joined = {"embed": mine[0]["embed"], "final": mine[1]["final"],
              "blocks": mine[0]["blocks"][:2] + mine[1]["blocks"][2:]}
    for a, b in zip(train_mod.tree_leaves(joined),
                    train_mod.tree_leaves(params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("key,bits", [("tp_out", 0), ("tp8_out", 8)])
def test_tp_axis_across_processes_matches_single_process(ranks, key, bits):
    from pipeedge_tpu_torch.models import ShardConfig
    from pipeedge_tpu_torch.models import vit as vit_mod
    from pipeedge_tpu_torch.models.layers import TransformerConfig
    from pipeedge_tpu_torch.parallel import spmd, tensor
    _, results = ranks
    cfg = TransformerConfig(model_type="vit", hidden_size=32,
                            num_hidden_layers=N_STAGES,
                            num_attention_heads=4, intermediate_size=64,
                            num_labels=5, image_size=16, patch_size=4)
    partition = [(1, 8), (9, 16)]
    stages = [vit_mod.init_params(cfg, ShardConfig(
        l, r, is_first=l == 1, is_last=r == 16), seed=0)
        for l, r in partition]
    pipe = spmd.build_spmd_pipeline(
        vit_mod.FAMILY, cfg, partition, stages,
        spmd.make_pipeline_mesh(2, tp=2, device="cpu"))
    inputs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N_STAGES + 1, BATCH, 3, 16, 16)).astype(np.float32))
    tensor.set_tp_quant_bits(bits)
    try:
        want = pipe.run(inputs)
    finally:
        tensor.set_tp_quant_bits(0)
    for r in results:
        assert torch.equal(r[key], want)


def test_dp_split_copies_stay_identical(ranks):
    from pipeedge_tpu_torch.parallel import train as train_mod
    _, results = ranks
    a, b = (r["train_params"] for r in results)
    leaves_a, leaves_b = (train_mod.tree_leaves(t) for t in (a, b))
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)
