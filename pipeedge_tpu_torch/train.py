"""Pipeline-parallel training CLI over the SPMD pipeline.

The port of the repository's `tools/train.py`, on PyTorch. Builds the
port's SPMD pipeline (`parallel/spmd.py`) over a (dp, stage) mesh,
differentiates through it with autograd (`parallel/train.py`: kernel 3's
hand-written backward on the card) and runs an optimizer loop on seeded
synthetic data: classification (ViT/DeiT: images and labels), BERT
sequence classification (token ids and class labels), or causal LM
(GPT-2, its MoE, Llama, Mistral: next-token targets). `--ckpt-dir` saves
the whole training state (params, optimizer, step) with `torch.save` and
resumes from it. The flags, the data, the `step=` lines and the final
JSON line are the JAX tool's; `--device cuda|cpu` takes the place of its
`--platform` (`cpu` runs the kernels' plain versions). On one card every
mesh position is `cuda:0`.

Examples:
  python -m pipeedge_tpu_torch.train -m pipeedge/test-tiny-vit \\
      -pt 1,4,5,8 --dp 2 --steps 3 --device cpu
  python -m pipeedge_tpu_torch.train -m gpt2 -pt 1,24,25,48 --dp 2 \\
      --steps 100 --optimizer adam --ckpt-dir /tmp/gpt2_train --remat
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-m", "--model-name", default="pipeedge/test-tiny-vit")
    p.add_argument("-pt", "--partition", default=None,
                   help="comma-separated block-aligned layer bounds "
                        "(default: one stage)")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel mesh axis (batch shards)")
    p.add_argument("--steps", default=10, type=int)
    p.add_argument("-b", "--batch", default=4, type=int)
    p.add_argument("-u", "--ubatches", default=4, type=int,
                   help="microbatches per step (the pipeline's fill depth)")
    p.add_argument("--seq-len", default=32, type=int,
                   help="sequence length for LM families")
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("-t", "--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true",
                   help="per-block torch.utils.checkpoint (trades a "
                        "forward recompute for ~model-depth less "
                        "activation memory)")
    p.add_argument("--mixed-precision", action="store_true",
                   help="bf16 compute over f32 master weights (requires "
                        "-t float32: those params ARE the masters)")
    p.add_argument("--ckpt-dir", default=None,
                   help="save the training state here every --ckpt-every "
                        "steps and resume from it when present")
    p.add_argument("--ckpt-every", default=0, type=int,
                   help="0 = only at the end")
    p.add_argument("--log-every", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their "
                        "plain versions")
    p.add_argument("--platform", default=argparse.SUPPRESS,
                   help="the JAX package's backend switch; the port takes "
                        "--device")
    args = p.parse_args(argv)
    if args.mixed_precision and args.dtype != "float32":
        p.error("--mixed-precision keeps f32 master weights; use -t "
                "float32 (the bf16 cast is per-step, inside the program)")
    if hasattr(args, "platform"):
        p.error("--platform is the JAX package's backend switch; the port "
                "runs on --device cuda (default) or --device cpu")
    return p, args


def _partition(p, args, total: int):
    """The -pt flag as (first, last) sublayer pairs, refused in the JAX
    tool's words."""
    from .parallel.decode import validate_partition
    if not args.partition:
        return [(1, total)]
    nums = [int(x) for x in args.partition.split(",")]
    if len(nums) % 2:
        p.error(f"-pt needs an even count of layer bounds: {nums}")
    partition = list(zip(nums[::2], nums[1::2]))
    try:
        validate_partition(partition, total)
    except ValueError as exc:
        p.error(f"-pt: {exc} ({args.model_name} has {total} sublayers)")
    return partition


def setup(argv: Optional[Sequence[str]] = None):
    """Parse `argv` and build what the CLI trains: (args, pipe, inputs,
    labels), the seeded stages and synthetic batch on their devices."""
    p, args = parse_args(argv)
    import numpy as np
    import torch

    from .models import ShardConfig, registry
    from .parallel import spmd

    cfg = registry.get_model_config(args.model_name)
    total = registry.get_model_layers(args.model_name)
    partition = _partition(p, args, total)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    family_mod = registry.get_model_entry(args.model_name).family
    is_lm = cfg.model_type in ("gpt2", "llama")
    is_bert = cfg.model_type == "bert"
    if not is_lm and not is_bert and cfg.model_type not in ("vit", "deit"):
        p.error(f"training CLI covers classification (vit/deit), BERT "
                f"sequence classification, and LM (gpt2/llama) families; "
                f"got {cfg.model_type}")

    stage_params = [family_mod.init_params(
        cfg, ShardConfig(l, r, is_first=l == 1, is_last=r == total),
        dtype=dtype, seed=args.seed) for l, r in partition]
    n_stages = len(partition)
    mesh = spmd.make_pipeline_mesh(n_stages, dp=args.dp, device=args.device)
    pipe = spmd.build_spmd_pipeline(family_mod.FAMILY, cfg, partition,
                                    stage_params, mesh, remat=args.remat)
    del stage_params

    rng = np.random.default_rng(args.seed)
    if is_lm:
        seq = min(args.seq_len + 1, cfg.max_position_embeddings)
        ids = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(args.ubatches, args.batch, seq)))
        inputs, labels = ids[..., :-1], ids[..., 1:]
    elif is_bert:
        seq = min(args.seq_len, cfg.max_position_embeddings)
        inputs = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(args.ubatches, args.batch, seq)))
        labels = torch.from_numpy(rng.integers(
            0, max(cfg.num_labels, 1), size=(args.ubatches, args.batch)))
    else:
        inputs = torch.from_numpy(rng.normal(size=(
            args.ubatches, args.batch, 3, cfg.image_size,
            cfg.image_size))).to(dtype)
        labels = torch.from_numpy(rng.integers(
            0, max(cfg.num_labels, 1), size=(args.ubatches, args.batch)))
    inputs = inputs.to(mesh.cell(0, 0).devices[0])
    labels = labels.to(mesh.cell(0, n_stages - 1).devices[0])
    return args, pipe, inputs, labels


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the final JSON line's dict."""
    args, pipe, inputs, labels = setup(argv)
    import torch

    from .parallel import train

    opt = functools.partial(
        torch.optim.Adam if args.optimizer == "adam" else torch.optim.SGD,
        lr=args.lr)
    step_fn, opt_state = train.make_train_step(
        pipe, opt, inputs, mixed_precision=args.mixed_precision)
    params, start = pipe.canonical, 0
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir) \
            and os.listdir(args.ckpt_dir):   # a real checkpoint, not just
        params, opt_state, start = train.restore_train_state(  # a mkdir
            args.ckpt_dir, params, opt_state)
        print(f"resumed from {args.ckpt_dir} at step {start}", flush=True)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    sync()
    tik = time.monotonic()
    loss = None
    for i in range(start, args.steps):
        params, opt_state, loss = step_fn(params, opt_state, inputs, labels)
        if args.log_every and (i + 1) % args.log_every == 0:
            print(f"step={i + 1} loss={float(loss):.4f}", flush=True)
        if args.ckpt_dir and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            train.save_train_state(args.ckpt_dir, params, opt_state, i + 1)
    sync()
    wall = time.monotonic() - tik
    done = max(args.steps - start, 0)
    if args.ckpt_dir and done:
        # never write a checkpoint whose step count moves backward (a
        # --steps below the restored step trains nothing and must not
        # relabel step-`start` state as something earlier)
        train.save_train_state(args.ckpt_dir, params, opt_state,
                               start + done)
    summary = {
        "steps": done,
        "final_loss": round(float(loss), 4) if loss is not None else None,
        "images_or_seqs_per_step": args.ubatches * args.batch,
        "wall_s": round(wall, 2),
        "steps_per_sec": round(done / wall, 3) if wall > 0 and done else None,
        "mesh": dict(pipe.mesh.shape), "remat": args.remat,
        "mixed_precision": args.mixed_precision,
        "ckpt": args.ckpt_dir}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
