"""The switch-routed FFN of the MoE decoders, on one device and with its
experts split over an expert-parallel shard group.

Port of `pipeedge_tpu/parallel/expert.py`. Routing is Switch Transformer
top-1:

- router logits [T, E] -> softmax in f32 -> each token's expert and gate
  weight (its probability);
- each expert keeps the C highest-gate tokens assigned to it, C =
  ceil(capacity_factor * T / E) clamped to [1, T]; equal gates are kept
  in token order (a stable sort, as `lax.top_k` keeps them), and the
  overflow passes through unchanged;
- T is the token set of one call: a capacity-bounded model routes a
  decode step's tokens apart from the prompt's, so a cached step is not
  the full forward's computation unless capacity_factor >= n_experts.

`moe_ffn_delta` is what the GPT-2 MoE blocks add to the residual
(`models/gpt2.py` sublayer 2, `parallel/decode.py` `_block_tail`); the
experts run as two batched matmuls over [E, C] gathered token rows, the
torch counterpart of the JAX package's `vmap` over the expert axis.

Expert parallelism (`ep_ffn_delta`, `make_ep_ffn_fn`) runs over a
`parallel/mesh.py ShardGroup`, per-shard lists in and out, as the JAX
functions run per device under `shard_map`: every shard routes the whole
(replicated) token set, computes the rows of the global [E, C] tables
that belong to its E/n experts, and one exact all-reduce adds the
shards' deltas. Top-1 routing gives each token one expert, so the sum
adds one nonzero term per token and equals the single-device delta.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models.layers import TransformerConfig, gelu
from ..models.shard import params_to
from .tensor import split_leaf


def init_moe_params(cfg: TransformerConfig, n_experts: int,
                    seed: int = 0) -> Dict:
    """Router and per-expert MLP params (expert axis leading), f32, drawn
    from the JAX package's numpy stream (one seed, equal params)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def glorot(*shape):
        fan = shape[-2] + shape[-1]
        return torch.from_numpy(rng.normal(0, math.sqrt(2.0 / fan), shape)
                                ).float()

    return {
        "router": {"w": glorot(d, n_experts),
                   "b": torch.zeros((n_experts,))},
        "experts": {
            "mlp_up": {"w": glorot(n_experts, d, f),
                       "b": torch.zeros((n_experts, f))},
            "mlp_down": {"w": glorot(n_experts, f, d),
                         "b": torch.zeros((n_experts, d))},
        },
    }


def _routing(router: Dict, x: torch.Tensor, n_experts: int, capacity: int):
    """Top-1 routing with per-expert capacity over tokens x [T, D].

    Returns (expert of each token [T], gate [T] f32, keep [E, C] token
    indices, kept [E, C] validity)."""
    logits = torch.addmm(router["b"].to(x.dtype), x, router["w"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate, expert = probs.max(dim=-1)                       # [T]
    experts = torch.arange(n_experts, device=x.device)[:, None]
    assigned = torch.where(expert[None, :] == experts, gate[None, :],
                           torch.full_like(gate, -math.inf)[None, :])
    top_gate, keep = torch.sort(assigned, dim=-1, descending=True,
                                stable=True)
    top_gate, keep = top_gate[:, :capacity], keep[:, :capacity]
    return expert, gate, keep, torch.isfinite(top_gate)


def moe_capacity(n_tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity (the switch formula, clamped to [1, T])."""
    return max(1, min(n_tokens,
                      math.ceil(capacity_factor * n_tokens / n_experts)))


def _scatter_expert_deltas(experts: Dict, tokens: torch.Tensor,
                           gate: torch.Tensor, keep: torch.Tensor,
                           kept: torch.Tensor, act) -> torch.Tensor:
    """act(x @ up) @ down of each expert over its kept token rows, times
    the gate, zero in the unkept slots, added into the token rows."""
    dt = tokens.dtype
    xe = tokens[keep]                                      # [E, C, D]
    up = act(torch.baddbmm(experts["mlp_up"]["b"].to(dt)[:, None], xe,
                           experts["mlp_up"]["w"].to(dt)))
    ye = torch.baddbmm(experts["mlp_down"]["b"].to(dt)[:, None], up,
                       experts["mlp_down"]["w"].to(dt))
    deltas = torch.where(kept[..., None], ye * gate[keep][..., None],
                         torch.zeros((), dtype=torch.float32,
                                     device=tokens.device))
    return torch.zeros_like(tokens).index_add_(
        0, keep.reshape(-1), deltas.reshape(-1, tokens.shape[-1]).to(dt))


def moe_ffn_delta(params: Dict, normed: torch.Tensor, n_experts: int,
                  capacity_factor: float, *, act) -> torch.Tensor:
    """The switch-FFN delta over [B, S, D]: gate * expert(normed) for each
    kept token, zero for a capacity-dropped one. Pre-LN families add it to
    the raw residual. `act` has no default (GPT-2 passes `gelu_new`)."""
    b, s, d = normed.shape
    tokens = normed.reshape(-1, d)
    capacity = moe_capacity(tokens.shape[0], n_experts, capacity_factor)
    _, gate, keep, kept = _routing(params["router"], tokens, n_experts,
                                   capacity)
    delta = _scatter_expert_deltas(params["experts"], tokens, gate, keep,
                                   kept, act)
    return delta.reshape(b, s, d).to(normed.dtype)


def reference_moe_ffn(params: Dict, x: torch.Tensor, n_experts: int,
                      capacity_factor: float = 1.25) -> torch.Tensor:
    """Oracle: the same routing, each expert applied in a loop (exact
    GeLU), output = x + gate * expert(x) for kept tokens, x otherwise."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    capacity = moe_capacity(tokens.shape[0], n_experts, capacity_factor)
    _, gate, keep, kept = _routing(params["router"], tokens, n_experts,
                                   capacity)
    out = tokens.clone()
    ex = params["experts"]
    for e in range(n_experts):
        ids = keep[e][kept[e]]
        xe = tokens[ids]
        up = gelu(xe @ ex["mlp_up"]["w"][e] + ex["mlp_up"]["b"][e])
        ye = up @ ex["mlp_down"]["w"][e] + ex["mlp_down"]["b"][e]
        out[ids] = ye * gate[ids][:, None] + tokens[ids]
    return out.reshape(b, s, d)


def _ep_local(group, ps: Sequence[Dict], xs: Sequence[torch.Tensor], *,
              n_experts: int, capacity: int, act=gelu) -> List[torch.Tensor]:
    """The per-shard body of `make_ep_ffn_fn`: local experts, tokens
    replicated; each shard computes its experts' capacity slots and one
    all-reduce combines them. -> x + delta per shard."""
    b, s, d = xs[0].shape
    tokens = [x.reshape(-1, d) for x in xs]
    combined = _ep_routed_delta(group, ps, tokens, n_experts, capacity, act)
    return group.map(lambda i, t, c: (t + c).reshape(b, s, d), tokens,
                     combined)


def _ep_routed_delta(group, ps: Sequence[Dict],
                     tokens: Sequence[torch.Tensor], n_experts: int,
                     capacity: int, act) -> List[torch.Tensor]:
    """Route each shard's token rows [T, D] (the same set on every
    shard), then `_ep_delta_from_routing`."""
    def route(i, p, t):
        _, gate, keep, kept = _routing(p["router"], t, n_experts, capacity)
        return gate, keep, kept

    routed = group.map(route, ps, tokens)
    return _ep_delta_from_routing(group, ps, tokens, routed, n_experts, act)


def _ep_delta_from_routing(group, ps: Sequence[Dict],
                           tokens: Sequence[torch.Tensor], routed,
                           n_experts: int, act) -> List[torch.Tensor]:
    """Each shard's expert rows of the global routing tables (`routed[i]`
    = its (gate, keep, kept)) -> its local deltas (the shared
    `_scatter_expert_deltas`) -> an exact all-reduce over the group."""
    e_local = n_experts // group.size

    def local(i, p, t, r):
        gate, keep, kept = r
        rows = slice(i * e_local, (i + 1) * e_local)
        return _scatter_expert_deltas(p["experts"], t, gate, keep[rows],
                                      kept[rows], act)

    return group.psum(group.map(local, ps, tokens, routed))


def ep_ffn_delta(group, ps: Sequence[Dict], normed: Sequence[torch.Tensor],
                 n_experts: int, capacity_factor: float, *,
                 act) -> List[torch.Tensor]:
    """The expert-parallel `moe_ffn_delta` over `group`: `ps[i]` is shard
    i's MoE params (`shard_moe_params`), `normed[i]` its copy of the
    [B, S, D] activations. Equal to the single-device delta: top-1
    routing means the all-reduce adds one nonzero term per token."""
    b, s, d = normed[0].shape
    capacity = moe_capacity(b * s, n_experts, capacity_factor)
    tokens = [x.reshape(-1, d) for x in normed]
    delta = _ep_routed_delta(group, ps, tokens, n_experts, capacity, act)
    return group.map(lambda i, dl, x: dl.reshape(b, s, d).to(x.dtype),
                     delta, normed)


def make_ep_ffn_fn(cfg: TransformerConfig, group, n_experts: int,
                   capacity_factor: float = 1.25, *, act):
    """`fn(sharded_params, x) -> x`: the switch FFN with its experts split
    over `group` (`sharded_params` from `shard_moe_params`; `x` [B, S, D]
    replicated to every shard, the output read from shard 0). The
    capacity derives from the call's token count."""
    del cfg
    n = group.size
    if n_experts % n:
        raise ValueError(f"n_experts ({n_experts}) must divide by the ep "
                         f"axis size ({n})")

    @torch.inference_mode()
    def fn(sharded_params: Sequence[Dict], x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        capacity = moe_capacity(b * s, n_experts, capacity_factor)
        return _ep_local(group, sharded_params, group.replicate(x),
                         n_experts=n_experts, capacity=capacity, act=act)[0]

    return fn


def shard_moe_params(params: Dict, group) -> List[Dict]:
    """MoE params over `group`, one dict per shard: the router whole on
    every shard's device (shared by shards on one device), the expert
    slabs split on their leading axis (shard i holds experts [i*E/n,
    (i+1)*E/n))."""
    n = group.size
    return [{"router": params_to(params["router"], device=dev),
             "experts": {name: {k: split_leaf(v, 0, n, i, dev)
                                for k, v in leaf.items()}
                         for name, leaf in params["experts"].items()}}
            for i, dev in enumerate(group.devices)]
