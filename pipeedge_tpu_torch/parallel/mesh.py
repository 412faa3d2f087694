"""The shard group: one named mesh axis over an explicit list of devices.

The port's counterpart of a one-axis `jax.sharding.Mesh` together with
`utils/jax_compat.shard_map` over it. JAX runs a tensor-parallel block as
one program per device under `shard_map`, with `psum` and `ppermute`
between them; here one process holds the N shards (a single controller)
and drives them in lock step, each shard's work on its own device:

- `map(fn, *per_shard_args)` runs `fn` once per shard, under that shard's
  device (`torch.cuda.device`), so its allocations and kernel launches go
  to that device and its current stream. Work on different cards runs
  concurrently: the host only enqueues it.
- `ring_forward(xs)` is `ppermute` with perm `[(i, i + 1 mod n)]`: shard
  i's value moves to shard i + 1's device (`Tensor.to(..., non_blocking=
  True)`, a peer-to-peer copy between cards, ordered against both
  devices' current streams by PyTorch; on one card the tensor itself).
- `psum` and `all_gather` are exact and deterministic: the shards' values
  meet on shard 0's device and are summed or concatenated in shard order,
  and every shard gets that one result (the same tensor for shards that
  share a device, so callers never write into a collective's result).
- `all_to_all(xs, split_dim, concat_dim)` is JAX's tiled `lax.all_to_all`:
  shard i gets chunk i of every shard's value, concatenated in shard
  order, each chunk moved by the ring's hop.

`PipelineMesh` is the SPMD pipeline's mesh (`parallel/spmd.py`):
logical positions laid out `(dp, stage, inner)` as the JAX
`make_pipeline_mesh` reshapes `jax.devices()`, each `(dp, stage)` cell's
inner axis a `ShardGroup` ('tp' or 'sp', one shard without one), and a
stage hop `Tensor.to(next stage's device, non_blocking=True)`: the ring's
idiom without the wrap-around, the tensor itself on one card.

`ShardGrid` is the two-axis mesh of the tp x ep composition: devices in
the JAX mesh's order (`np.array(devices).reshape(tp, ep)`), each ep
column a tp `ShardGroup` and each tp row an ep one. A shard that shares a
device with another shares its replicated tensors (`Tensor.to` a device
the tensor is on returns the tensor), so on one card a replicated weight
is held once.

Why one process and not a `torch.distributed` group: JAX's `--stage-tp`
is one process over its own local devices, and NCCL refuses two ranks on
one card ("Duplicate GPU detected"), so a process group could not run on
a one-card host at all. When more shards are asked for than the host has
cards, the shards share the cards round-robin (`devices_for`), as two
`-c dcn` ranks share one card. The CPU runs the same code on `[cpu] * n`.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.quant import QuantizedTensor

logger = logging.getLogger(__name__)


def devices_for(n: int, device) -> List[torch.device]:
    """The devices of an `n`-shard group on `device`'s kind: `cuda:i %
    device_count()` (logged when shards must share a card), or `[cpu] *
    n`."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"a shard group needs at least one shard, got {n}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"shard groups run on cuda or cpu, not {dev}")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("a cuda shard group needs a GPU; "
                           "torch.cuda.device_count() is 0")
    if n > count:
        logger.info("%d shards share %d card(s) round-robin", n, count)
    return [torch.device("cuda", i % count) for i in range(n)]


def _to(x, device: torch.device):
    """Move a tensor or a `QuantizedTensor` (the ring's encoded payload)."""
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(data=_to(x.data, device),
                               scale=_to(x.scale, device),
                               shift=_to(x.shift, device), shape=x.shape,
                               bit=x.bit)
    return x.to(device, non_blocking=True)


class ShardGroup:
    """One mesh axis named `axis` over `devices`, one shard per entry."""

    def __init__(self, devices: Sequence, axis: str = "tp"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        if any(d.type == "cuda" and d.index is None for d in self.devices):
            raise ValueError("give each cuda device its index")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        """`jax.lax.axis_size`: the shard count of this group's axis."""
        if axis != self.axis:
            raise ValueError(f"this group's axis is {self.axis!r}, "
                             f"not {axis!r}")
        return self.size

    def __repr__(self) -> str:
        return (f"ShardGroup({self.axis!r}, "
                f"{[str(d) for d in self.devices]})")

    def on(self, i: int):
        """The context that makes shard `i`'s device current."""
        dev = self.devices[i]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def map(self, fn: Callable, *per_shard_args) -> list:
        """[fn(i, *args_i) for each shard i] under shard i's device; each
        of `per_shard_args` is a list with one entry per shard."""
        for args in per_shard_args:
            if len(args) != self.size:
                raise ValueError(f"{len(args)} per-shard values for "
                                 f"{self.size} shards")
        out = []
        for i in range(self.size):
            with self.on(i):
                out.append(fn(i, *(a[i] for a in per_shard_args)))
        return out

    def replicate(self, x) -> list:
        """`x` on every shard's device (`P()` in_specs)."""
        return [_to(x, d) for d in self.devices]

    def ring_forward(self, xs: Sequence) -> list:
        """`ppermute(perm=[(i, i+1 mod n)])`: entry j of the result is
        shard j - 1's value, on shard j's device."""
        n = self.size
        return [_to(xs[(j - 1) % n], self.devices[j]) for j in range(n)]

    def _from_root(self, value) -> list:
        """`value` (on shard 0's device) on every shard's device, copied
        once per distinct device."""
        copies = {}
        out = []
        for d in self.devices:
            if d not in copies:
                copies[d] = _to(value, d)
            out.append(copies[d])
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Exact all-reduce: sum in shard order on shard 0's device."""
        root = self.devices[0]
        total = xs[0]
        for x in xs[1:]:
            total = total + _to(x, root)
        return self._from_root(total)

    def gather(self, xs: Sequence[torch.Tensor], dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
        """The shards' values on shard 0's device, in shard order:
        concatenated along `dim` (`tiled`) or stacked on a new axis."""
        root = self.devices[0]
        parts = [_to(x, root) for x in xs]
        return (torch.cat(parts, dim=dim) if tiled
                else torch.stack(parts, dim=dim))

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int = 0,
                   tiled: bool = True) -> List[torch.Tensor]:
        """Exact all-gather: `gather`'s result on every shard."""
        return self._from_root(self.gather(xs, dim=dim, tiled=tiled))

    def all_to_all(self, xs: Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> List[torch.Tensor]:
        """Tiled `lax.all_to_all`: each shard's value splits into n chunks
        along `split_dim`; shard i receives chunk i of every shard's value,
        concatenated along `concat_dim` in shard order, on its device."""
        n = self.size
        if xs[0].shape[split_dim] % n:
            raise ValueError(f"axis {split_dim} of {tuple(xs[0].shape)} "
                             f"does not split {n} ways")
        chunks = [x.chunk(n, dim=split_dim) for x in xs]
        return [torch.cat([_to(chunks[j][i], self.devices[i])
                           for j in range(n)], dim=concat_dim)
                for i in range(n)]


class ShardGrid:
    """The tp x ep mesh: `tp * ep` devices, cell (i, j) = `devices[i * ep
    + j]` (tp index i, ep index j), as `np.array(devices).reshape(tp, ep)`
    lays out the JAX mesh. Cells are listed in that order wherever a
    per-cell list is passed."""

    axes = ("tp", "ep")

    def __init__(self, devices: Sequence, tp: int, ep: int):
        if tp < 1 or ep < 1 or len(devices) != tp * ep:
            raise ValueError(f"a {tp} x {ep} grid needs {tp * ep} devices, "
                             f"got {len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.tp, self.ep = tp, ep
        # each ep column's tp group, each tp row's ep group
        self._columns = [ShardGroup(self.devices[j::ep], "tp")
                         for j in range(ep)]
        self._rows = [ShardGroup(self.devices[i * ep:(i + 1) * ep], "ep")
                      for i in range(tp)]

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        """`jax.lax.axis_size` of either axis."""
        if axis not in self.axes:
            raise ValueError(f"this grid's axes are {self.axes}, "
                             f"not {axis!r}")
        return self.tp if axis == "tp" else self.ep

    def __repr__(self) -> str:
        return (f"ShardGrid(tp={self.tp}, ep={self.ep}, "
                f"{[str(d) for d in self.devices]})")

    def cell(self, i: int, j: int) -> int:
        """The flat index of cell (tp i, ep j)."""
        return i * self.ep + j

    def tp_group(self, j: int) -> ShardGroup:
        """Ep column j's tp group: cells (0, j) .. (tp - 1, j)."""
        return self._columns[j]

    def ep_group(self, i: int) -> ShardGroup:
        """Tp row i's ep group: cells (i, 0) .. (i, ep - 1)."""
        return self._rows[i]

    def replicate(self, x) -> list:
        """`x` on every cell's device."""
        return [_to(x, d) for d in self.devices]


class PipelineMesh:
    """The `('dp', 'stage'[, inner])` mesh of an SPMD pipeline over
    `devices`, one per logical position in `(dp, stage, inner)` order;
    `positions[k]` names the logical device (the index into the caller's
    device list) of entry k, so `-r` shows where each stage went. `shape`
    lists the axes as the JAX mesh's does: the inner axis only when it has
    more than one shard."""

    def __init__(self, devices: Sequence, dp: int, n_stages: int,
                 inner: int = 1, inner_axis: str = "tp",
                 positions: Optional[Sequence[int]] = None):
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != dp * n_stages * inner:
            raise ValueError(f"a {dp} x {n_stages} x {inner} pipeline mesh "
                             f"needs {dp * n_stages * inner} devices, got "
                             f"{len(self.devices)}")
        self.dp, self.n_stages, self.inner = dp, n_stages, inner
        self.inner_axis = inner_axis
        self.positions = (list(range(len(self.devices))) if positions is None
                          else list(positions))
        self._cells = [[ShardGroup(self.devices[
            (d * n_stages + s) * inner:(d * n_stages + s + 1) * inner],
            inner_axis) for s in range(n_stages)] for d in range(dp)]

    @property
    def shape(self) -> dict:
        out = {"dp": self.dp, "stage": self.n_stages}
        if self.inner > 1:
            out[self.inner_axis] = self.inner
        return out

    def __repr__(self) -> str:
        return (f"PipelineMesh({self.shape}, "
                f"{[str(d) for d in self.devices]})")

    def cell(self, d: int, s: int) -> ShardGroup:
        """Dp cell d's stage s: its inner shards as a group."""
        return self._cells[d][s]

    def hop(self, xs: Sequence, d: int, s: int) -> list:
        """`ppermute` along 'stage' from s to s + 1 in dp cell d: inner
        shard i's value (a tensor or a `QuantizedTensor`) on stage s + 1's
        shard i's device."""
        return [_to(x, dev)
                for x, dev in zip(xs, self._cells[d][s + 1].devices)]
