"""Model sharding core: layer-range shard configs and partition arithmetic.

Port of `pipeedge_tpu/models/__init__.py`. A shard is a (static plan,
parameter dict, apply function) triple. Layers are 1-based and counted in
sublayers, 4 per transformer block (attention, attention-output+residual,
MLP-up, MLP-down+residual), so ViT-Base has 48. Any contiguous
`[layer_start, layer_end]` range is a valid shard, including mid-block
cuts, whose inter-stage payload is then a 2-tensor tuple.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

SUBLAYERS_PER_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Static description of a layer-range shard.

    Layers are 1-based and inclusive, counted in sublayers (4 per block).
    `is_first` adds the embedding layer; `is_last` adds the final norm and
    classifier head.
    """
    layer_start: int
    layer_end: int
    is_first: bool = False
    is_last: bool = False

    def __post_init__(self):
        if not 1 <= self.layer_start <= self.layer_end:
            raise ValueError(
                f"invalid layer range [{self.layer_start}, {self.layer_end}]")


@dataclasses.dataclass(frozen=True)
class BlockSlice:
    """One transformer block's part of a shard: sublayers [sub_start, sub_end]."""
    block_id: int   # 0-based transformer block index
    sub_start: int  # 0..3
    sub_end: int    # 0..3

    @property
    def is_full(self) -> bool:
        return self.sub_start == 0 and self.sub_end == 3

    def sublayers(self) -> range:
        return range(self.sub_start, self.sub_end + 1)


def block_slices(layer_start: int, layer_end: int) -> Tuple[BlockSlice, ...]:
    """Decompose a 1-based sublayer range into per-block slices:
    block = ceil(layer/4) - 1, sublayer = (layer-1) % 4."""
    slices = []
    layer_curr = layer_start
    while layer_curr <= layer_end:
        block_id = math.ceil(layer_curr / SUBLAYERS_PER_BLOCK) - 1
        sub_start = (layer_curr - 1) % SUBLAYERS_PER_BLOCK
        if block_id == math.ceil(layer_end / SUBLAYERS_PER_BLOCK) - 1:
            sub_end = (layer_end - 1) % SUBLAYERS_PER_BLOCK
        else:
            sub_end = SUBLAYERS_PER_BLOCK - 1
        slices.append(BlockSlice(block_id, sub_start, sub_end))
        layer_curr += sub_end - sub_start + 1
    return tuple(slices)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Execution plan for a shard: partial head block, full blocks, partial
    tail block."""
    head: Optional[BlockSlice]
    full_ids: Tuple[int, ...]
    tail: Optional[BlockSlice]


def plan_shard(shard_config: ShardConfig) -> ShardPlan:
    """Compute the head/full/tail plan for a layer range."""
    slices = block_slices(shard_config.layer_start, shard_config.layer_end)
    head = None
    tail = None
    if not slices[0].is_full:
        head = slices[0]
        slices = slices[1:]
    if slices and not slices[-1].is_full:
        tail = slices[-1]
        slices = slices[:-1]
    return ShardPlan(head=head, full_ids=tuple(s.block_id for s in slices),
                     tail=tail)


def edge_arity(layer_end: int) -> int:
    """Number of tensors in the payload leaving a shard ending at `layer_end`.

    A cut after sublayer 0 (attention) or 2 (MLP-up) leaves a (hidden,
    residual) 2-tuple in flight; after sublayer 1 or 3 the residual has
    been folded in and a single tensor flows.
    """
    sub = (layer_end - 1) % SUBLAYERS_PER_BLOCK
    return 2 if sub in (0, 2) else 1


def get_microbatch_size(shard_data, verify: bool = False) -> int:
    """Microbatch size of a shard payload."""
    if not isinstance(shard_data, (tuple, list)):
        shard_data = (shard_data,)
    ubatch_size = 0 if len(shard_data) == 0 else len(shard_data[0])
    if verify:
        for tensor in shard_data:
            if len(tensor) != ubatch_size:
                raise ValueError(f"payload tensors disagree on the "
                                 f"microbatch size: {len(tensor)} != "
                                 f"{ubatch_size}")
    return ubatch_size
