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

- **Across processes** (a mesh over `comm.global_devices()`): each
  process runs the stage-steps of its own positions and owns the
  canonical copy of the stages it runs. The forward gives every process
  the whole output (the others' rows received, outside its graph), so
  each computes the same loss, the global one, and its backward reaches
  only its own rows and the hops it crossed (`mesh.GradLinks`: a hop's
  gradient goes back along the edge). Each leaf's gradient is then
  summed over the processes that hold it, gathered and added in dp
  order, so every holder gets the same sum, and each process applies the
  same update to its own copy: the copies stay identical. A checkpoint
  is one file written by process 0, laid out as one process's would be
  (the other processes send it the stages it lacks); every process reads
  its own stages back from it.

Scope, as in JAX: full-parameter training with softmax cross-entropy over
the model's head (classifier logits [M, B, C] or LM logits [M, B, S, V]).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import torch

from ..models.shard import params_to
from .mesh import GradLinks
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
    links = GradLinks()
    loss = loss_fn(pipe.forward(pipe.place(compute), inputs, links=links),
                   labels)
    total = links.attach(loss)
    if total.requires_grad:
        grads = torch.autograd.grad(total, leaves + links.anchors,
                                    allow_unused=True,
                                    materialize_grads=True)[:len(leaves)]
    else:   # nothing of this process's reaches the loss
        grads = [torch.zeros_like(leaf) for leaf in leaves]
    links.wait()
    return loss.detach(), _sum_over_processes(pipe, params, list(grads))


def _parts(tree) -> List[tuple]:
    """(part, first, end) of each part of a canonical tree (`("blocks",
    s)`, `("embed",)`, `("final",)`) over its float leaves, in
    `tree_leaves` order (keys sorted: blocks, embed, final)."""
    out, i = [], 0
    for s, stage in enumerate(tree["blocks"]):
        k = len(_floating(stage))
        if k:
            out.append((("blocks", s), i, i + k))
        i += k
    for key in ("embed", "final"):
        if key in tree:
            k = len(_floating(tree[key]))
            out.append(((key,), i, i + k))
            i += k
    return out


def _holders(mesh, part: tuple) -> List[int]:
    """The processes that hold `part` of the canonical tree, in dp order
    (the order of the first dp cell each runs it in)."""
    n = mesh.n_stages
    if part == ("final",):
        order = [mesh.cell(d, n - 1).owners[0] for d in range(mesh.dp)]
    else:
        s = 0 if part == ("embed",) else part[1]
        order = [o for d in range(mesh.dp) for o in mesh.cell(d, s).owners]
    return list(dict.fromkeys(order))


def _sum_over_processes(pipe: SpmdPipeline, params: Dict,
                        grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each leaf's gradient summed over the processes that hold it, in dp
    order: every holder gathers the others' and adds them in that order,
    so all get the same sum (the single-process step sums the dp cells'
    gradients into one leaf)."""
    from ..comm.exchange import exchange
    mesh = pipe.mesh
    me = mesh.me
    parts = _parts(params)
    holders = {part: _holders(mesh, part) for part, _, _ in parts}
    shared = {p: [part for part, _, _ in parts if p in holders[part]]
              for p in mesh.processes if p != me}
    shared = {p: v for p, v in shared.items() if v}
    if not shared:
        return grads
    where = {part: (i, j) for part, i, j in parts}
    got = exchange({p: [grads[where[part][0]:where[part][1]]
                        for part in v] for p, v in shared.items()},
                   sorted(shared), mesh.local_device(), mesh.processes)
    theirs = {(p, part): g for p, v in shared.items()
              for part, g in zip(v, got[p])}
    out = list(grads)
    for part, i, j in parts:
        if len(holders[part]) < 2:
            continue
        for k in range(j - i):
            total = None
            for h in holders[part]:
                g = grads[i + k] if h == me else theirs[(h, part)][k]
                g = g.to(grads[i + k].device)
                total = g if total is None else total + g
            out[i + k] = total
    return out


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


def _spread() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_world_size() > 1


def _leaf_states(opt_state: Dict, first: int, end: int) -> list:
    return [opt_state["state"].get(k) for k in range(first, end)]


def _merge_on_first(params: Dict, opt_state: Dict):
    """Process 0's view of a training state spread over processes: every
    process sends process 0 its parts (and their leaves' optimizer
    states); process 0 assembles the tree one process would hold, with
    its optimizer state indexed over that tree's leaves."""
    import torch.distributed as dist

    from ..comm.exchange import exchange
    me, world = dist.get_rank(), dist.get_world_size()
    mine = {part: ((params["blocks"][part[1]] if part[0] == "blocks"
                    else params[part[0]]),
                   _leaf_states(opt_state, i, j))
            for part, i, j in _parts(params)}
    mine = tree_map(lambda x: x.detach().cpu()
                    if isinstance(x, torch.Tensor) else x, mine)
    if me != 0:
        exchange({0: mine}, [], "cpu", range(world))
        return None, None
    got = exchange({}, list(range(1, world)), "cpu", range(world))
    have = dict(mine)
    for p in range(1, world):
        for part, value in got[p].items():
            have.setdefault(part, value)
    full: Dict = {"blocks": [have[("blocks", s)][0]
                             if ("blocks", s) in have else []
                             for s in range(len(params["blocks"]))]}
    for key in ("embed", "final"):
        if (key,) in have:
            full[key] = have[(key,)][0]
    state = {}
    for part, i, _ in _parts(full):
        for k, leaf_state in enumerate(have[part][1]):
            if leaf_state is not None:
                state[i + k] = leaf_state
    groups = [dict(g, params=list(range(len(_floating(full)))))
              for g in opt_state["param_groups"]]
    return full, {"state": state, "param_groups": groups}


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Checkpoint a training run (params + optimizer state + step count)
    as one `torch.save` file in the directory `path` (the port's format:
    the JAX package writes an Orbax tree), replaced atomically. In a
    `torch.distributed` world the call is collective and process 0 writes
    the whole state (module docstring)."""
    if _spread():
        params, opt_state = _merge_on_first(params, opt_state)
        if params is None:
            return
    os.makedirs(path, exist_ok=True)
    state = {"params": tree_map(lambda x: x.detach(), params),
             "opt_state": opt_state, "step": int(step)}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _own_parts(state: Dict, like: Dict) -> Dict:
    """The saved state cut to the parts of `like` (a process's canonical
    tree across processes: its stages only), the optimizer state indexed
    over its leaves."""
    saved = state["params"]
    mine = {"blocks": [saved["blocks"][s] if stage else []
                       for s, stage in enumerate(like["blocks"])]}
    for key in ("embed", "final"):
        if key in like and key in saved:
            mine[key] = saved[key]
    where = {part: i for part, i, _ in _parts(saved)}
    opt = state["opt_state"]
    kept = {}
    for part, i, j in _parts(mine):
        for k in range(j - i):
            if where[part] + k in opt["state"]:
                kept[i + k] = opt["state"][where[part] + k]
    groups = [dict(g, params=list(range(len(_floating(mine)))))
              for g in opt["param_groups"]]
    return dict(state, params=mine,
                opt_state={"state": kept, "param_groups": groups})


def restore_train_state(path: str, like_params, like_opt_state):
    """Restore `save_train_state`'s file into the structure, devices and
    dtypes of a freshly built run's `like_params` (`pipe.canonical`) and
    `like_opt_state` (`make_train_step`'s). Returns (params, opt_state,
    step); the optimizer state's tensors move to their parameters'
    devices at the next step."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if isinstance(like_params, dict) and "blocks" in like_params \
            and isinstance(state["params"], dict):
        state = _own_parts(state, like_params)

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
