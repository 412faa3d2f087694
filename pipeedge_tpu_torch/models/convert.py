"""Parameters of the JAX package's shards, as the port's parameter dicts.

`params_from_jax(tree)` takes a shard's parameter tree as nested dicts of
numpy arrays (a caller holding JAX arrays passes them through
`jax.device_get` first; the port never sees JAX). The full blocks may be
stacked (one array per leaf, leading axis = block, the `lax.scan`
layout) or a tuple/list of per-block dicts (the unrolled layout); the
port always gets a list of per-block dicts. The trees of every family
carry across: the Llama blocks' leaves, and the MoE blocks' stacked
expert leaves ([L, E, ...] under `blocks`, [E, ...] in a partial head or
tail block).

`train_tree_from_jax(tree)` carries a JAX SPMD pipeline's training tree
(`pipe.params`: `embed`, `final`, `blocks` stacked [n_stages, max_b, ...]
and zero-padded, `n_blocks`) across as the port's canonical tree
(`SpmdPipeline.canonical`): each stage's real blocks as a list of
per-block dicts, through `params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _unstack(tree: Dict) -> List[Dict]:
    """Stacked block leaves [L, ...] -> a list of L per-block dicts."""
    def leaves(t):
        for v in t.values():
            if isinstance(v, dict):
                yield from leaves(v)
            else:
                yield v

    n = len(next(iter(leaves(tree))))

    def take(t, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}

    return [take(tree, i) for i in range(n)]


def params_from_jax(tree: Dict) -> Dict:
    """Convert a JAX shard parameter tree (numpy leaves) to port params."""
    out = {}
    for key, value in tree.items():
        if key == "blocks" and isinstance(value, dict):
            value = _unstack(value)
        out[key] = _tensors(value)
    return out


def train_tree_from_jax(tree: Dict) -> Dict:
    """Convert a JAX SPMD training tree (numpy leaves) to the port's
    canonical tree {embed, final, blocks: [[block dict] per stage]}, each
    stage's blocks cut to its `n_blocks` entry."""
    blocks = [params_from_jax({"blocks": stage})["blocks"][:int(n)]
              for stage, n in zip(_unstack(tree["blocks"]),
                                  np.asarray(tree["n_blocks"]))]
    return {"embed": _tensors(tree["embed"]), "final": _tensors(tree["final"]),
            "blocks": blocks}
