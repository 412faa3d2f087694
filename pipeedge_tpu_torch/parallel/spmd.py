"""SPMD pipeline: the whole stage graph driven as one program over a mesh.

Port of `pipeedge_tpu/parallel/spmd.py`. The JAX package compiles every
stage and every microbatch into one `shard_map` program over a `('dp',
'stage'[, 'tp'|'sp'])` mesh: a `lax.scan` over `M + n_stages - 1` ticks
in which each device runs its stage's blocks and the edges are
`ppermute`s. Here one process drives the same mesh
(`parallel/mesh.py PipelineMesh`), as `--stage-tp` drives a shard group:

- **The ticks.** The controller walks the fill/steady/drain schedule in
  tick order, and in each tick runs only the valid `(stage, tick)` pairs:
  stage s works on microbatch t - s when 0 <= t - s < M, so a run is M x
  n stage-steps, not the (M + n - 1) x n of the lock-step program. JAX
  runs its fill and drain ticks on garbage because lock-step devices
  would idle through them anyway (its comment at :425-432); shards that
  share a card run serially, so those ticks would cost real time here.
  The outputs are the same. Within a tick the stages run last to first,
  so each edge holds one payload, as the scan's carry does, and work
  enqueued on different cards overlaps.
- **Per-stage blocks.** Each stage keeps its own block list: no
  zero-padded stack and no `n_blocks` mask.
- **Edges.** The edge leaving stage i carries its own payload at
  `stage_bits[i]`: a `QuantizedTensor` through kernels 1 and 2
  (`ops/fused_quant.py`) at 4 and 8 bits, the plain codec at other widths
  (16, ...), the raw tensor at 0. The JAX package's mixed-bits `lax.switch`
  over a padded uint32 wire buffer exists only because SPMD shapes must
  match across devices, so it has no counterpart, and neither has its
  warning that mixed raw and quantized edges save no bandwidth: here
  every edge moves only its own bytes. As in JAX, the edges encode
  without the Banner clamp the host pipeline applies.
- **tp.** Each stage's blocks are Megatron-split over the cell's shards
  (`parallel/tensor.py family_tp_plan`): two all-reduces a block, the
  quantized `qpsum` under `--tp-quant-bits` (`tensor.set_tp_quant_bits`).
  Stage 0 embeds once and replicates; the last stage finalizes shard 0's
  copy, as JAX reads a replicated output.
- **sp.** Activations are sequence-sharded [b, S/sp, D]: stage 0 embeds a
  microbatch and keeps each shard's chunk, each block runs the family's
  `sp_block_step` (projection per shard, `resolve_sp_core(sp_kind)` over
  the cell, the rest per shard), the edges carry the chunks, and the last
  stage gathers them (`qall_gather` under `--tp-quant-bits`) for the
  head.
- **dp.** Each dp cell takes its rows of every microbatch (batch
  dimension / dp) and runs them on its own positions; an MoE stage routes
  each cell's tokens on their own, as each JAX dp shard does.
- **Across processes** (a mesh over `comm.global_devices()`, laid out
  process-major as the JAX mesh over `jax.devices()`): every process
  walks the same ticks and runs only the stage-steps of cells it owns a
  position of; a hop into another process's cell is a send on one side
  and a receive on the other (`PipelineMesh.hop`: an 8-bit edge moves
  kernel 1's words), and under grad its gradient goes back along the edge
  (`GradLinks`). The embedding runs on the first own shard of a stage-0
  cell, the head on shard 0's owner, and `run` gives every process the
  whole output: each sends the rows it finalized to the others.

Kernel launches of a run of M microbatches (each launch counted by its
wrapper): kernel 3 once per block per stage-step and per inner shard
(tp shards and Ulysses' local attend; the ring core streams in einsums
and launches none), so M x blocks x dp x inner in all; kernels 1 and 2
once per stage-step and inner shard on every edge at 4 or 8 bits, so M x
(quantized edges) x dp x inner each; plus the `qpsum`/`qall_gather`
rings' launches under `--tp-quant-bits`. The eager port tallies each
quantized collective call once (`ops/qcollectives.py`), where the JAX
runtime multiplies its traced sites by 2 x ticks x blocks. A training
step (`parallel/train.py`) adds kernel 3's backward once per forward
launch (`fused_attention_bwd`, M x blocks x dp x inner), and under
`remat` the backward re-runs each block's forward, so kernel 3's forward
launches twice per block per stage-step.

`SpmdPipeline.forward(params, inputs)` takes the parameters explicitly
(nothing in it runs under `inference_mode`), so a training step can
differentiate through it; `run(inputs)` is the inference call.
`canonical` is one copy of each logical parameter (embed, final and each
stage's block list, each stage's leaves on its first dp cell's shard 0),
read off the first dp cell's positions when training asks for it: their
own tensors without a tp split (no copy), the tp shards concatenated
under one (a new copy), so an inference pipeline holds no tree beside
`params`. `place(tree)` derives every position's tensors from such a
tree with differentiable moves and tp slices, so training updates the
canonical copy and autograd sums the positions' gradients into it. With
`remat` (the JAX name) and grad enabled, each block runs under
`torch.utils.checkpoint` (non-reentrant): the backward keeps only the
block boundaries and recomputes the rest; without grad nothing changes.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import block_slices
from ..models.layers import TransformerConfig
from ..models.shard import FamilySpec, params_to
from ..ops import fused_quant
from ..ops.quant import QuantizedTensor
from .mesh import GradLinks, PipelineMesh, devices_for

logger = logging.getLogger(__name__)

BlockRange = Tuple[int, int]


def partition_to_blocks(partition: Sequence[Tuple[int, int]]
                        ) -> List[BlockRange]:
    """Convert a sublayer partition to 0-based block ranges; reject
    mid-block cuts."""
    out = []
    for layer_start, layer_end in partition:
        slices = block_slices(layer_start, layer_end)
        if not all(s.is_full for s in slices):
            raise ValueError(
                f"SPMD pipeline requires block-aligned partitions; "
                f"[{layer_start}, {layer_end}] cuts mid-block (use the "
                f"host-driven pipeline for sublayer cuts)")
        out.append((slices[0].block_id, slices[-1].block_id))
    return out


def make_pipeline_mesh(n_stages: int, dp: int = 1, tp: int = 1, sp: int = 1,
                       devices: Optional[Sequence] = None,
                       stage_ranks: Optional[Sequence[int]] = None,
                       device="cuda") -> PipelineMesh:
    """Build a `('dp', 'stage'[, 'tp'|'sp'])` mesh over the logical
    `devices` (default `devices_for(need, device)`: on one card every
    position is `cuda:0`), laid out `(dp, stage, inner)` as the JAX mesh.
    tp and sp are mutually exclusive. `devices` may be
    `comm.global_devices()`, process-major, so that the mesh spans
    processes; in a `torch.distributed` world of W processes the default
    is each process's `need / W` positions (`devices_for`), process-major,
    as the JAX default `jax.devices()` spans every process.

    `stage_ranks[i]` places stage i at `devices[stage_ranks[i]]` (the
    runtime's `-r`); requires dp=tp=sp=1 and distinct ranks."""
    if tp > 1 and sp > 1:
        raise ValueError("tp and sp mesh axes are mutually exclusive")
    inner, inner_name = (tp, "tp") if tp > 1 else (sp, "sp")
    need = n_stages * dp * inner
    if devices is None:
        devices = _default_devices(need, device)
    if stage_ranks is not None:
        if dp != 1 or tp != 1 or sp != 1:
            raise ValueError("stage_ranks requires dp=1, tp=1 and sp=1")
        if len(stage_ranks) != n_stages:
            raise ValueError(f"stage_ranks length {len(stage_ranks)} != "
                             f"{n_stages} stages")
        if len(set(stage_ranks)) != n_stages:
            raise ValueError(f"stage_ranks must be distinct: {stage_ranks}")
        if max(stage_ranks) >= len(devices):
            raise ValueError(f"stage rank {max(stage_ranks)} out of range "
                             f"({len(devices)} devices)")
        return PipelineMesh([devices[r] for r in stage_ranks], 1, n_stages,
                            positions=stage_ranks)
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return PipelineMesh(devices[:need], dp, n_stages, inner, inner_name)


def _default_devices(need: int, device) -> list:
    """`devices_for(need, device)` in one process; in a world of W
    processes each one's `need / W` positions, process-major."""
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return devices_for(need, device)
    from ..comm import global_devices
    world = dist.get_world_size()
    if need % world:
        raise ValueError(f"{need} mesh positions do not split over "
                         f"{world} processes")
    return global_devices(devices_for(need // world, device))


def encode_edge(h: torch.Tensor, bit: int):
    """The edge payload of one shard's stage output at `bit`: kernel 1 at
    4 and 8 bits, the plain codec at other widths, the tensor at 0 (the
    SPMD pipeline's and the wave decoder's edges)."""
    return h if bit == 0 else fused_quant.encode_outerdim(h, bit)


def decode_edge(payload, dtype: torch.dtype) -> torch.Tensor:
    """The activation an edge payload carries, in the stage's dtype."""
    if isinstance(payload, QuantizedTensor):
        return fused_quant.decode_outerdim(payload).to(dtype)
    return payload


@dataclasses.dataclass
class SpmdPipeline:
    """An SPMD pipeline over a `PipelineMesh` (module docstring). Build
    with `build_spmd_pipeline`; `run(inputs)` takes stacked microbatches
    [M, B, ...raw input dims...] and returns [M, B, ...out...] on the
    first dp cell's last-stage device.

    `stage_bits[i]` quantizes the edge leaving stage i (the runtime's
    `-q`); the last entry, the result edge, is 0. It may be changed
    between runs. `params` (`build_spmd_pipeline`): `embed[d]` and
    `final[d]` on dp cell d's first and last stage's shard 0,
    `blocks[s][d][j][i]` block j of stage s on cell d's inner shard i."""
    family: FamilySpec
    cfg: TransformerConfig
    mesh: PipelineMesh
    n_stages: int
    params: Dict
    stage_bits: Tuple[int, ...] = (0,)
    sp_kind: str = "ring"   # sp attention core: 'ring' | 'ulysses'
    remat: bool = False     # checkpoint each block (training memory)

    @property
    def quant_bit(self) -> int:
        """Uniform edge bitwidth (0 when edges are mixed)."""
        bits = set(self.stage_bits[:-1] or (0,))
        return next(iter(bits)) if len(bits) == 1 else 0

    def run(self, inputs: torch.Tensor) -> torch.Tensor:
        """The output [M, B, ...], whole on every process of the mesh."""
        with torch.inference_mode():
            return self.forward(self.params, inputs)

    @property
    def canonical(self) -> Dict:
        """`embed`, `final` and `blocks[s][j]`, one copy each: the first
        dp cell's tensors (shard 0's), or under tp its shards merged onto
        shard 0's device, built anew at each read (module docstring).
        Across processes each process reads the first dp cell it owns a
        position of in each stage; a stage it owns none of has no blocks
        here (`[]`), and `embed` and `final` are there only when it runs
        the embedding or the head."""
        params, mesh = self.params, self.mesh
        tp = mesh.inner > 1 and mesh.inner_axis == "tp"
        blocks = []
        for s, cells in enumerate(params["blocks"]):
            d = next((d for d in range(mesh.dp) if mesh.cell(d, s).local),
                     None)
            if d is None:
                blocks.append([])
                continue
            group = mesh.cell(d, s)
            if tp:
                from .tensor import merge_block_params
                blocks.append([merge_block_params(
                    self.cfg, group._everyone(shards))
                    for shards in cells[d]])
            else:
                blocks.append([shards[group.local[0]]
                               for shards in cells[d]])
        out = {"blocks": blocks}
        for key in ("embed", "final"):
            mine = [p for p in params[key] if p is not None]
            if mine:
                out[key] = mine[0]
        return out

    def place(self, tree: Dict) -> Dict:
        """Every own position's parameters (the layout of `params`) from a
        tree laid out as `canonical`, inside the autograd graph."""
        n = self.n_stages
        stages = [{"blocks": blocks} for blocks in tree["blocks"]]
        if "embed" in tree:
            stages[0]["embeddings"] = tree["embed"]
        if "final" in tree:
            stages[n - 1]["final"] = tree["final"]
        return _place(self.cfg, stages, self.mesh)

    def forward(self, params: Dict, inputs: torch.Tensor,
                links: Optional[GradLinks] = None) -> torch.Tensor:
        """The pipeline over explicit `params` (the layout of
        `self.params`): every valid stage-step in tick order, each process
        running the stage-steps of its own positions. Returns the whole
        output on every process (the other processes' rows received, not
        in this process's graph). Under grad across processes, `links`
        collects the hops' ends (`mesh.GradLinks`), which the backward
        needs (`parallel/train.py value_and_grad`)."""
        mesh, n = self.mesh, self.n_stages
        n_ubatch, batch = inputs.shape[0], inputs.shape[1]
        if batch % mesh.dp:
            raise ValueError(f"microbatch size {batch} does not split over "
                             f"the dp mesh axis ({mesh.dp})")
        rows = batch // mesh.dp
        block_fn = self._block_fn()
        if self.remat and torch.is_grad_enabled():
            inner_fn = block_fn

            def block_fn(ps, xs, group):
                return checkpoint(inner_fn, ps, xs, group,
                                  use_reentrant=False)
        # edge s: what stage s receives next, per dp cell: (per-shard
        # payloads, activation dtype)
        edges: Dict[Tuple[int, int], tuple] = {}
        outputs: List[List[Optional[torch.Tensor]]] = [
            [None] * mesh.dp for _ in range(n_ubatch)]
        for t in range(n_ubatch + n - 1):
            for s in reversed(range(n)):
                m = t - s
                if not 0 <= m < n_ubatch:
                    continue
                for d in range(mesh.dp):
                    group = mesh.cell(d, s)
                    enc = [None] * mesh.inner
                    if group.local:
                        if s == 0:
                            xs = self._embed(
                                params["embed"][d], group,
                                inputs[m, d * rows:(d + 1) * rows])
                        else:
                            payloads, dtype = edges.pop((d, s))
                            xs = group.map(
                                lambda i, e: decode_edge(e, dtype), payloads)
                        for bp in params["blocks"][s][d]:
                            xs = block_fn(bp, xs, group)
                        if s == n - 1:
                            outputs[m][d] = self._finalize(
                                params["final"][d], xs, group)
                        else:
                            bit = self.stage_bits[s]
                            enc = group.map(
                                lambda i, h: encode_edge(h, bit), xs)
                            dtype = xs[group.local[0]].dtype
                    if s < n - 1 and (group.local
                                      or mesh.cell(d, s + 1).local):
                        tag = 1 + ((m * mesh.dp + d) * n + s) * mesh.inner
                        moved = mesh.hop(enc, d, s, tag=tag, links=links)
                        if mesh.cell(d, s + 1).local:
                            if not group.local:
                                dtype = self._stage_dtype(params, s + 1, d)
                            edges[(d, s + 1)] = (moved, dtype)
        return self._collect(outputs)

    def _stage_dtype(self, params: Dict, s: int, d: int) -> torch.dtype:
        """The activation dtype of stage s on cell d, read off its first
        floating parameter: what a quantized edge from another process
        decodes to (a raw edge carries its own)."""
        from .train import tree_leaves
        shard = next(p for p in params["blocks"][s][d][0] if p is not None)
        return next(x.dtype for x in tree_leaves(shard)
                    if x.is_floating_point())

    def _collect(self, outputs: List[List[Optional[torch.Tensor]]]
                 ) -> torch.Tensor:
        """[M, B, ...] from each (microbatch, dp cell)'s output, stacked
        on the first dp cell's last-stage device, or on this process's
        first position's when another process owns it: each process sends
        the outputs it finalized to every other (detached)."""
        from ..comm.exchange import exchange
        mesh, n = self.mesh, self.n_stages
        last = mesh.cell(0, n - 1)
        root = last.devices[0] if last.owns(0) else mesh.local_device()
        owner = [mesh.cell(d, n - 1).owners[0] for d in range(mesh.dp)]
        mine = [(m, d) for m in range(len(outputs))
                for d in range(mesh.dp) if owner[d] == mesh.me]
        peers = [p for p in mesh.processes if p != mesh.me]
        got = exchange({p: [outputs[m][d].detach() for m, d in mine]
                        for p in peers}, peers, root, mesh.processes)
        for p in peers:
            theirs = [(m, d) for m in range(len(outputs))
                      for d in range(mesh.dp) if owner[d] == p]
            for (m, d), out in zip(theirs, got[p]):
                outputs[m][d] = out
        return torch.stack([torch.cat([o.to(root) for o in row], dim=0)
                            for row in outputs])

    # -- the stage-step's parts ------------------------------------------

    def _block_fn(self):
        """`fn(block shards, xs, group) -> xs`: one block on a cell."""
        family, cfg, axis = self.family, self.cfg, self.mesh.inner_axis
        if self.mesh.inner > 1 and axis == "tp":
            from .tensor import family_tp_plan
            _, tp_local = family_tp_plan(cfg)
            return lambda ps, xs, group: tp_local(group, ps, xs, cfg)
        if self.mesh.inner > 1:
            from .sequence import resolve_sp_core
            core = resolve_sp_core(self.sp_kind, cfg.num_attention_heads,
                                   self.mesh.inner,
                                   window=cfg.sliding_window or None)
            return lambda ps, xs, group: family.sp_block_step(
                ps, xs, cfg, group, core)

        def block(ps, xs, group):
            x = xs[0]
            with group.on(0):
                for sub in range(4):
                    x = family.sublayer(ps[0], sub, x, cfg)
            return [x]
        return block

    def _embed(self, pe: Dict, group, raw: torch.Tensor) -> list:
        """Stage 0's input on each own inner shard: the embedding (on
        shard 0's device, or this process's first own shard's), whole on
        every tp shard, each sp shard's sequence chunk."""
        first = group.local[0]
        with group.on(first):
            full = self.family.embed(pe, raw.to(group.devices[first]),
                                     self.cfg)
        if self.mesh.inner > 1 and self.mesh.inner_axis == "sp":
            seq = full.shape[1]
            if seq % group.size:
                raise ValueError(f"sequence length {seq} must divide by "
                                 f"the sp mesh axis ({group.size})")
            return [c.contiguous().to(dev, non_blocking=True)
                    if group.owns(i) else None for i, (c, dev) in
                    enumerate(zip(full.chunk(group.size, dim=1),
                                  group.devices))]
        return group.replicate(full)

    def _finalize(self, pf: Dict, xs: list, group) -> torch.Tensor:
        """The last stage's head on shard 0: over the gathered sequence
        under sp (quantized under `--tp-quant-bits`), shard 0's copy
        otherwise. Across processes every owner of the cell takes part in
        the gather, and only shard 0's owner runs the head (None
        elsewhere)."""
        if self.mesh.inner > 1 and self.mesh.inner_axis == "sp":
            from .tensor import get_tp_quant_bits
            bits = get_tp_quant_bits()
            if bits:
                from ..ops import qcollectives
                hidden = qcollectives.qall_gather(group, xs, bits, axis=1,
                                                  tiled=True)[0]
            else:
                hidden = group.gather(xs, dim=1)
        else:
            hidden = xs[0]
        if not group.owns(0):
            return None
        with group.on(0):
            return self.family.finalize(pf, hidden, self.cfg)


def build_spmd_pipeline(family: FamilySpec, cfg: TransformerConfig,
                        partition: Sequence[Tuple[int, int]],
                        stage_params: Sequence[Dict], mesh: PipelineMesh,
                        quant_bit=0, sp_kind: str = "ring",
                        remat: bool = False) -> SpmdPipeline:
    """Assemble an `SpmdPipeline` from per-stage shard parameters.

    `stage_params[i]` is the parameter dict a family loader builds for
    stage i's block-aligned `ShardConfig` (stage 0 with 'embeddings', the
    last with 'final'). Each mesh position gets its stage's parameters on
    its device: moved (a tensor already there is shared, so positions on
    one card hold one copy) or, under tp, Megatron-split once per distinct
    device list.
    `remat` checkpoints each block under grad (module docstring).

    `quant_bit`: an int for every inter-stage edge, or a per-stage list
    whose entry i quantizes the edge leaving stage i (the runtime's `-q`;
    the last entry is the result edge and is forced to 0)."""
    n_stages = len(partition)
    if isinstance(quant_bit, (list, tuple)):
        if len(quant_bit) != n_stages:
            raise ValueError(f"quant_bit list length {len(quant_bit)} != "
                             f"{n_stages} stages")
        stage_bits = tuple(int(b) for b in quant_bit[:-1]) + (0,)
    else:
        stage_bits = (int(quant_bit),) * max(n_stages - 1, 0) + (0,)
    if mesh.shape["stage"] != n_stages:
        raise ValueError(f"mesh 'stage' axis {mesh.shape['stage']} != "
                         f"{n_stages} pipeline stages")
    partition_to_blocks(partition)  # validates block alignment
    for i, p in enumerate(stage_params):
        if "blocks" not in p:
            raise ValueError(f"stage {i} has no full blocks; SPMD pipeline "
                             f"requires block-aligned partitions")
    tp = mesh.shape.get("tp", 1)
    sp = mesh.shape.get("sp", 1)
    if tp > 1:
        if cfg.num_attention_heads % tp or cfg.intermediate_size % tp \
                or cfg.kv_heads % tp:
            raise ValueError(
                f"mesh tp={tp} must divide attention heads "
                f"({cfg.num_attention_heads}), kv heads ({cfg.kv_heads}), "
                f"and intermediate size ({cfg.intermediate_size})")
    if cfg.n_experts and (tp > 1 or sp > 1):
        # tp: expert kernels shard over 'ep', not the Megatron table; sp:
        # routing over a local sequence chunk changes the capacity
        # semantics (per-chunk instead of global top-C)
        raise NotImplementedError(
            "MoE blocks do not compose with the 'tp'/'sp' mesh axes")
    if sp > 1:
        if family.sp_block_step is None:
            raise NotImplementedError(
                f"the {family.name} family supplies no sp_block_step: its "
                "blocks cannot run sequence-parallel")
        from .sequence import resolve_sp_core
        resolve_sp_core(sp_kind, cfg.num_attention_heads, sp)
    logger.info("SPMD pipeline: %d stage(s) over %s, edge bits %s",
                n_stages, mesh.shape, list(stage_bits[:-1]))
    return SpmdPipeline(family=family, cfg=cfg, mesh=mesh, n_stages=n_stages,
                        params=_place(cfg, stage_params, mesh),
                        stage_bits=stage_bits, sp_kind=sp_kind, remat=remat)


def _place(cfg: TransformerConfig, stage_params: Sequence[Dict],
           mesh: PipelineMesh) -> Dict:
    """The parameters of every mesh position this process owns
    (`SpmdPipeline.params`; None where another process runs the cell, the
    embedding or the head)."""
    n = len(stage_params)
    tp_split = mesh.inner > 1 and mesh.inner_axis == "tp"
    if tp_split:
        from .tensor import shard_block_params
    out: Dict = {"embed": [], "final": [], "blocks": []}
    for d in range(mesh.dp):
        first, last = mesh.cell(d, 0), mesh.cell(d, n - 1)
        out["embed"].append(params_to(stage_params[0]["embeddings"],
                                      device=first.root)
                            if first.local else None)
        out["final"].append(params_to(stage_params[-1]["final"],
                                      device=last.devices[0])
                            if last.owns(0) else None)
    for s, p in enumerate(stage_params):
        split: Dict[tuple, List[List[Dict]]] = {}
        per_cell = []
        for d in range(mesh.dp):
            group = mesh.cell(d, s)
            if not group.local:
                per_cell.append(None)
                continue
            key = (tuple(group.devices), tuple(group.owners))
            if key not in split:
                if tp_split:
                    split[key] = [shard_block_params(cfg, bp, group)
                                  for bp in p["blocks"]]
                else:
                    split[key] = [[params_to(bp, device=dev)
                                   if group.owns(i) else None
                                   for i, dev in enumerate(group.devices)]
                                  for bp in p["blocks"]]
            per_cell.append(split[key])
        out["blocks"].append(per_cell)
    return out
