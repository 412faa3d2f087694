"""The port's multi-process worker: one process per "host", joined into
one world by `MultiHostContext` (torch.distributed over gloo on the CPU).

Run by tests/test_torch_multihost.py as `python torch_multihost_main.py
RANK WORLD COORD_ADDR OUT_DIR`: each process contributes 4 positions on
the CPU, the global mesh spans 2 x 4 = 8 positions, and the legs of
`tests/multihost_spmd_main.py` run across the process boundary at its
sizes and seeds:

- the SPMD ViT pipeline, dp 2 x 4 stages, 8-bit edges (one dp row in
  each process), and the same model in 2 stages over a 'tp' axis that
  crosses the processes, exact and with 8-bit collectives;
- a GPT-2 tp decode over a 'tp' group of positions [0, 1, 4, 5], two in
  each process;
- 3 SGD steps over the process-spanning ('dp', 'stage') mesh;

plus a stage-crossing leg: dp 1 x 4 stages with stages 0-1 in process 0
and 2-3 in process 1, 8-bit edges forward, then 3 SGD steps (momentum
0.9) and a checkpoint round trip across that stage edge. Each rank writes its
results to OUT_DIR/rank<R>.pt; its last line is the JAX worker's
`MULTIHOST-OK ...` line.
"""
import os
import sys

import numpy as np
import torch

rank = int(sys.argv[1])
world = int(sys.argv[2])
coord = sys.argv[3]
out_dir = sys.argv[4]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pipeedge_tpu_torch.comm import (MultiHostContext,  # noqa: E402
                                     global_devices)
from pipeedge_tpu_torch.models import ShardConfig  # noqa: E402
from pipeedge_tpu_torch.models import gpt2 as gpt2_mod  # noqa: E402
from pipeedge_tpu_torch.models import vit as vit_mod  # noqa: E402
from pipeedge_tpu_torch.models.layers import TransformerConfig  # noqa: E402
from pipeedge_tpu_torch.parallel import decode as dec_mod  # noqa: E402
from pipeedge_tpu_torch.parallel import spmd, tensor  # noqa: E402
from pipeedge_tpu_torch.parallel import train as train_mod  # noqa: E402
from pipeedge_tpu_torch.parallel.mesh import ShardGroup  # noqa: E402


def vit_setup(n_stages):
    cfg = TransformerConfig(model_type="vit", hidden_size=32,
                            num_hidden_layers=n_stages,
                            num_attention_heads=4, intermediate_size=64,
                            num_labels=5, image_size=16, patch_size=4)
    total = 4 * cfg.num_hidden_layers
    partition = [(4 * i + 1, 4 * (i + 1)) for i in range(n_stages)]
    # the same seed everywhere, as the JAX worker: every process builds
    # every stage's parameters and places its own positions'
    stage_params = [vit_mod.init_params(
        cfg, ShardConfig(l, r, is_first=l == 1, is_last=r == total), seed=0)
        for l, r in partition]
    return cfg, partition, stage_params


def train(pipe, inputs, labels, momentum=0.0):
    step_fn, opt_state = train_mod.make_train_step(
        pipe, lambda leaves: torch.optim.SGD(leaves, lr=0.05,
                                             momentum=momentum), inputs)
    params, losses = pipe.canonical, []
    for _ in range(3):
        params, opt_state, loss = step_fn(params, opt_state, inputs, labels)
        losses.append(float(loss))
    return params, opt_state, losses


def main() -> None:
    with MultiHostContext(coord, world, rank, device="cpu") as ctx:
        devices = global_devices([torch.device("cpu")] * 4)
        n_local = sum(1 for p in devices if p.process == rank)
        n_global = len(devices)
        assert n_local == 4, n_local
        assert n_global == 4 * world, n_global
        result = {"backend": ctx.backend}

        dp, n_stages = 2, n_global // 2
        cfg, partition, stage_params = vit_setup(n_stages)
        mesh = spmd.make_pipeline_mesh(n_stages, dp=dp, devices=devices)
        pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                        stage_params, mesh,
                                        quant_bit=[8] * (n_stages - 1) + [0])
        batch = 2 * dp
        inputs = torch.from_numpy(np.random.default_rng(0).normal(
            size=(n_stages + 1, batch, 3, 16, 16)).astype(np.float32))
        out = pipe.run(inputs)
        assert out.shape == (n_stages + 1, batch, 5), out.shape
        result["out"] = out

        # the same model in 2 stages whose 'tp' axis crosses the processes
        # (each cell one position of each), exact and at 8-bit collectives
        tp_partition = [(1, 8), (9, 16)]
        total = 4 * cfg.num_hidden_layers
        tp_stages = [vit_mod.init_params(cfg, ShardConfig(
            l, r, is_first=l == 1, is_last=r == total), seed=0)
            for l, r in tp_partition]
        tp_pipe = spmd.build_spmd_pipeline(
            vit_mod.FAMILY, cfg, tp_partition, tp_stages,
            spmd.make_pipeline_mesh(2, tp=2, devices=[
                devices[0], devices[n_local], devices[1],
                devices[n_local + 1]]))
        result["tp_out"] = tp_pipe.run(inputs)
        tensor.set_tp_quant_bits(8)
        try:
            result["tp8_out"] = tp_pipe.run(inputs)
        finally:
            tensor.set_tp_quant_bits(0)

        # tensor-parallel KV-cache decoding over a PROCESS-SPANNING 'tp'
        # group: two positions of each process
        g_cfg = TransformerConfig(
            model_type="gpt2", hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, layer_norm_eps=1e-5,
            vocab_size=48, max_position_embeddings=32)
        g_partition = [(1, 4), (5, 8)]
        g_params = [gpt2_mod.init_params(
            g_cfg, ShardConfig(l, r, is_first=l == 1, is_last=r == 8),
            seed=0) for l, r in g_partition]
        picks = [0, 1, n_local, n_local + 1] if world > 1 else [0, 1, 2, 3]
        tp_mesh = ShardGroup([devices[i] for i in picks], "tp")
        g_pipe = dec_mod.DecodePipeline(gpt2_mod.FAMILY, g_cfg, g_partition,
                                        g_params, max_len=16, mesh=tp_mesh)
        g_out = g_pipe.generate(torch.from_numpy(
            np.random.default_rng(3).integers(0, 48, size=(2, 5))),
            new_tokens=3)
        assert g_out.shape == (2, 8), g_out.shape
        result["decode"] = g_out

        # training across the process boundary: the dp split (on fresh
        # parameters: a step updates the positions' tensors in place, and
        # on the CPU those are the stage parameters' own)
        t_pipe = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                          vit_setup(n_stages)[2], mesh)
        t_inputs = torch.from_numpy(np.random.default_rng(7).normal(
            size=(n_stages + 1, batch, 3, 16, 16)).astype(np.float32))
        t_labels = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.num_labels, size=(n_stages + 1, batch)))
        params, _, losses = train(t_pipe, t_inputs, t_labels)
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        result["train_losses"] = losses
        result["train_params"] = params

        # the stage-crossing leg: stages 0-1 here on process 0, 2-3 on
        # process 1 (PipeEdge's own layout: a stage edge between hosts)
        cut = [devices[0], devices[1], devices[n_local],
               devices[n_local + 1]]
        s_mesh = spmd.make_pipeline_mesh(n_stages, devices=cut)
        s_pipe = spmd.build_spmd_pipeline(
            vit_mod.FAMILY, cfg, partition, stage_params, s_mesh,
            quant_bit=[8] * (n_stages - 1) + [0])
        result["stage_out"] = s_pipe.run(inputs)
        s_train = spmd.build_spmd_pipeline(vit_mod.FAMILY, cfg, partition,
                                           vit_setup(n_stages)[2], s_mesh)
        # momentum, so the checkpoint carries optimizer state per leaf
        s_params, s_state, s_losses = train(s_train, t_inputs, t_labels,
                                            momentum=0.9)
        result["stage_losses"] = s_losses
        result["stage_params"] = s_params
        # a checkpoint across the stage edge: process 0 writes the whole
        # state, each process reads its own stages back
        ckpt = os.path.join(out_dir, "ckpt")
        train_mod.save_train_state(ckpt, s_params, s_state, 3)
        torch.distributed.barrier()
        back, back_state, step = train_mod.restore_train_state(
            ckpt, s_train.canonical, s_state)
        assert step == 3
        same = all(torch.equal(a, b) for a, b in zip(
            train_mod.tree_leaves(back), train_mod.tree_leaves(s_params)))
        assert same, "a restored leaf differs from the trained one"
        assert len(back_state["state"]) == len(s_state["state"])
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))

        loss_str = ",".join(f"{v:.6f}" for v in losses)
        stage_str = ",".join(f"{v:.6f}" for v in s_losses)
        print(f"MULTIHOST-OK rank={rank} local={n_local} global={n_global} "
              f"out={tuple(out.shape)} decode={tuple(g_out.shape)} "
              f"backend={ctx.backend} stage_losses=[{stage_str}] "
              f"train_losses=[{loss_str}]", flush=True)


if __name__ == "__main__":
    main()
