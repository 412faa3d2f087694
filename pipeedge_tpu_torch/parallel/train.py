"""Pipeline-parallel training over the SPMD pipeline.

Port of `pipeedge_tpu/parallel/train.py`. The JAX package differentiates
its one-program pipeline with `jax.grad` and updates with an optax
optimizer. Here autograd differentiates `SpmdPipeline.forward` (every
valid stage-step, the edges' device moves, the dp cells' rows) and a
`torch.optim` optimizer updates the result:

- **One canonical copy of each logical parameter.** The optimizer owns
  the pipeline's canonical tree (`SpmdPipeline.canonical`: `embed`,
  `final`, each stage's block list). Each step derives every mesh
  position's tensors from it inside the graph (`SpmdPipeline.place`:
  differentiable `.to(device)`, the tp split as slicing), so autograd sums
  the copies' gradients into the canonical leaf, as JAX's transposes
  do, and no position's copy is ever updated apart from the others.
- **The step updates in place.** `train_step(params, opt_state, inputs,
  labels)` writes the new values into `params`' tensors and returns them,
  with the optimizer state as a `state_dict()` (index-keyed, so it binds
  to whatever tree the next call passes) and the loss. On one card the
  canonical leaves are the positions' own tensors, so `pipe.run` sees the
  trained weights; on several cards or under tp `pipe.place(params)`
  gives them.
- **Kernels.** Kernel 3's backward is a kernel of its own
  (`ops/attention.py FusedAttentionFunction`); kernels 1, 2, 4 and 5 have
  none and raise under grad. Quantized stage edges are refused here, as
  in JAX, and training never enables int8 compute.
- **Ticks.** The backward walks the M x n valid stage-steps the forward
  ran; the JAX scan also differentiates its fill and drain ticks, whose
  outputs are masked away. The gradients are the same.

Scope, as in JAX: full-parameter training with softmax cross-entropy over
the model's head (classifier logits [M, B, C] or LM logits [M, B, S, V]).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import torch

from ..models.shard import params_to
from .spmd import SpmdPipeline

__all__ = ["make_train_step", "softmax_xent", "value_and_grad",
           "save_train_state", "restore_train_state", "tree_leaves",
           "tree_map"]

STATE_FILE = "train_state.pt"


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; `labels` are integer class ids with one fewer
    trailing axis than `logits` ([M, B] for classifiers, [M, B, S] for
    LM heads)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.to(logits.device).long()[..., None])
    return -picked.mean()


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree in a fixed order (dict keys
    sorted, lists in order): the optimizer's parameter order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree):
    """`tree` with `fn` applied to each tensor."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, item) for item in tree]
    return fn(tree)


def _floating(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if x.is_floating_point()]


def value_and_grad(pipe: SpmdPipeline, params: Dict, inputs: torch.Tensor,
                   labels: torch.Tensor, loss_fn=softmax_xent,
                   mixed_precision: bool = False):
    """(loss, grads): the loss of the pipeline over `params` (laid out as
    `pipe.canonical`) and the gradient of each of its float leaves, in
    `tree_leaves` order. A leaf the loss does not reach gets zeros, as
    JAX gives it."""
    leaves = _floating(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    compute = params
    if mixed_precision:   # the bf16 working copies, inside the graph
        compute, inputs = params_to((params, inputs), dtype=torch.bfloat16)
    loss = loss_fn(pipe.forward(pipe.place(compute), inputs), labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(pipe: SpmdPipeline, optimizer, example_inputs,
                    loss_fn=softmax_xent, mixed_precision: bool = False):
    """Build (train_step, opt_state) for an SPMD pipeline.

    `optimizer` builds a `torch.optim` optimizer over a parameter list,
    e.g. `functools.partial(torch.optim.Adam, lr=1e-3)`. `train_step(
    params, opt_state, inputs, labels) -> (params, opt_state, loss)` runs
    the pipelined forward, the backward through the edges and the update
    (module docstring); `params` is a tree laid out as `pipe.canonical`
    (the first call takes `pipe.canonical` itself). `example_inputs` fixes
    the microbatch shape ([M, B, ...raw input dims], the stacked layout
    `SpmdPipeline.run` takes).

    `mixed_precision=True` is the bf16-compute/f32-master recipe: the f32
    params stay the optimizer's master weights, each step's forward runs
    on a bfloat16 cast of them (and of float inputs), the gradients flow
    back through the cast into f32, and the update applies at full
    precision. The pipeline must hold f32 params: they are the masters.

    Returns opt_state initialized against the pipeline's canonical
    params."""
    if any(pipe.stage_bits[:-1]):
        raise ValueError(
            "quantized stage edges are not differentiable; build the "
            "training pipeline with quant_bit=0 (QuantPipe compression "
            "is an inference-edge feature)")
    example_shape = tuple(example_inputs.shape)
    masters = _floating(pipe.canonical)
    if mixed_precision:
        bad = [str(leaf.dtype).replace("torch.", "")
               for leaf in masters
               if leaf.dtype != torch.float32]
        if bad:
            raise ValueError(
                "mixed_precision keeps float32 MASTER weights and casts "
                "to bfloat16 per step; build the pipeline with float32 "
                f"params (found {sorted(set(bad))})")

    def train_step(params: Dict, opt_state: Dict, inputs: torch.Tensor,
                   labels: torch.Tensor):
        if tuple(inputs.shape) != example_shape:
            # the step is built for one microbatch schedule, as the JAX
            # step is compiled for one
            raise ValueError(
                f"inputs shape {tuple(inputs.shape)} != the compiled "
                f"step's {example_shape}; build a train step per "
                "input shape (make_train_step(pipe, opt, inputs))")
        loss, grads = value_and_grad(pipe, params, inputs, labels, loss_fn,
                                     mixed_precision)
        leaves = _floating(params)
        opt = optimizer(leaves)
        opt.load_state_dict(opt_state)
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad
        opt.step()
        for leaf in leaves:
            leaf.grad = None
        return params, opt.state_dict(), loss

    opt_state = optimizer(masters).state_dict()
    return train_step, opt_state


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Checkpoint a training run (params + optimizer state + step count)
    as one `torch.save` file in the directory `path` (the port's format:
    the JAX package writes an Orbax tree), replaced atomically."""
    os.makedirs(path, exist_ok=True)
    state = {"params": tree_map(lambda x: x.detach(), params),
             "opt_state": opt_state, "step": int(step)}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def restore_train_state(path: str, like_params, like_opt_state):
    """Restore `save_train_state`'s file into the structure, devices and
    dtypes of a freshly built run's `like_params` (`pipe.canonical`) and
    `like_opt_state` (`make_train_step`'s). Returns (params, opt_state,
    step); the optimizer state's tensors move to their parameters'
    devices at the next step."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)

    def restore(saved, like, where):
        if isinstance(like, dict) and isinstance(saved, dict) \
                and set(saved) == set(like):
            return {key: restore(saved[key], value, f"{where}.{key}")
                    for key, value in like.items()}
        if isinstance(like, (list, tuple)) \
                and isinstance(saved, (list, tuple)) \
                and len(saved) == len(like):
            return [restore(a, b, f"{where}[{i}]")
                    for i, (a, b) in enumerate(zip(saved, like))]
        if isinstance(like, torch.Tensor) and isinstance(saved, torch.Tensor) \
                and saved.shape == like.shape:
            return saved.to(like.device, like.dtype)
        raise ValueError(f"checkpoint at {path} does not match the run's "
                         f"parameters at {where}")

    params = restore(state["params"], like_params, "params")
    opt_state = state["opt_state"]
    groups = [len(g["params"]) for g in opt_state["param_groups"]]
    want = [len(g["params"]) for g in like_opt_state["param_groups"]]
    if groups != want:
        raise ValueError(f"checkpoint at {path} holds optimizer groups of "
                         f"{groups} parameters, the run {want}")
    return params, opt_state, int(state["step"])
