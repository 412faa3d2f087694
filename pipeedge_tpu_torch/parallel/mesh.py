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

Positions and processes. A mesh's positions may belong to several
processes (`comm.MultiHostContext`, `comm.global_devices()`: each
entry a `Position(process, device)`; a plain device belongs to this
process). Each process runs the same program as one controller of its
own positions: `map` runs only the shards this process owns (the others'
entries are None), and every exchange above moves the values other
processes own through `torch.distributed` (`comm/exchange.py`,
point-to-point, one process group per set of processes, made once):

- a `QuantizedTensor` crosses as its words, scale and shift, so an 8-bit
  edge moves kernel 1's output, not floats;
- every process ends with exactly the values one controller holds on the
  same devices: `psum` receives every shard's value and sums them in
  shard order on the receiver (never `all_reduce`, whose order of
  summation is the backend's), and `gather`/`all_gather` give every
  process of the group the whole result, on its first own shard's device;
- under `gloo`, whose point-to-point operations take host memory, a CUDA
  tensor crosses through a pinned host buffer; under `nccl` directly.
  NCCL refuses two ranks on one card, so processes that share a card run
  `gloo` (`MultiHostContext` refuses the other);
- a stage hop across processes under grad sends its gradient back along
  the edge (`exchange.HopSend`/`HopRecv`, each hop its own message tag),
  so training works whether the process boundary cuts the dp axis or a
  stage edge. The other exchanges refuse grad.

Every process walks the same order of exchanges (the SPMD tick order),
so they meet in order. Within one process, shards beyond its cards
share them round-robin (`devices_for`), as two `-c dcn` ranks share one
card; the CPU runs the same code on `[cpu] * n`.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..comm import Position, process_index
from ..comm import exchange as ex
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


def split_positions(devices: Sequence) -> tuple:
    """(devices, owners) of a list whose entries are devices or
    `Position`s: a plain device belongs to this process."""
    me = process_index()
    devs, own = [], []
    for d in devices:
        if isinstance(d, Position):
            devs.append(torch.device(d.device))
            own.append(int(d.process))
        else:
            devs.append(torch.device(d))
            own.append(me)
    return devs, own


def _to(x, device: torch.device):
    """Move a tensor or a `QuantizedTensor` (the ring's encoded payload)."""
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(data=_to(x.data, device),
                               scale=_to(x.scale, device),
                               shift=_to(x.shift, device), shape=x.shape,
                               bit=x.bit)
    return x.to(device, non_blocking=True)


class GradLinks:
    """The cross-process hops of one forward under grad: `tokens` (the
    senders' empty outputs, which the loss must add), `anchors` (the
    receivers' empty leaves, whose gradients the backward must ask for)
    and the backward's sends still in flight, so that each process's
    backward sends and receives the gradients along the edges its forward
    crossed."""

    def __init__(self):
        self.tokens: List[torch.Tensor] = []
        self.anchors: List[torch.Tensor] = []
        self.pending: list = []     # (work, buffer) of each gradient sent

    def wait(self) -> None:
        """Wait for every gradient the backward sent."""
        while self.pending:
            work, _ = self.pending.pop()
            work.wait()

    def attach(self, loss: torch.Tensor) -> torch.Tensor:
        """`loss` plus the tokens (each sums to 0)."""
        for token in self.tokens:
            loss = loss + token.sum().to(loss.device)
        return loss


class ShardGroup:
    """One mesh axis named `axis` over `devices`, one shard per entry; an
    entry may be a `Position` of another process (module docstring)."""

    def __init__(self, devices: Sequence, axis: str = "tp"):
        self.devices, self.owners = split_positions(devices)
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        if any(d.type == "cuda" and d.index is None for d in self.devices):
            raise ValueError("give each cuda device its index")
        self.axis = axis
        self.me = process_index()
        self.local = [i for i, o in enumerate(self.owners) if o == self.me]
        self.processes = sorted(set(self.owners))

    @property
    def size(self) -> int:
        return len(self.devices)

    def owns(self, i: int) -> bool:
        """Whether this process runs shard `i`."""
        return self.owners[i] == self.me

    @property
    def root(self) -> torch.device:
        """Where this process's collective results land: shard 0's device,
        or its first own shard's when another process owns shard 0."""
        return self.devices[self.local[0] if self.local else 0]

    def axis_size(self, axis: str) -> int:
        """`jax.lax.axis_size`: the shard count of this group's axis."""
        if axis != self.axis:
            raise ValueError(f"this group's axis is {self.axis!r}, "
                             f"not {axis!r}")
        return self.size

    def __repr__(self) -> str:
        where = [str(d) if o == self.me else f"p{o}:{d}"
                 for d, o in zip(self.devices, self.owners)]
        return f"ShardGroup({self.axis!r}, {where})"

    def on(self, i: int):
        """The context that makes shard `i`'s device current."""
        dev = self.devices[i]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def map(self, fn: Callable, *per_shard_args) -> list:
        """[fn(i, *args_i) for each shard i this process owns] under shard
        i's device, None for the others'; each of `per_shard_args` is a
        list with one entry per shard."""
        for args in per_shard_args:
            if len(args) != self.size:
                raise ValueError(f"{len(args)} per-shard values for "
                                 f"{self.size} shards")
        out: list = [None] * self.size
        for i in self.local:
            with self.on(i):
                out[i] = fn(i, *(a[i] for a in per_shard_args))
        return out

    def replicate(self, x) -> list:
        """`x` on every own shard's device (`P()` in_specs)."""
        return [_to(x, d) if self.owns(i) else None
                for i, d in enumerate(self.devices)]

    def _exchange(self, sends: Dict[int, list], recv_from) -> Dict[int, list]:
        return ex.exchange(sends, recv_from, self.root, self.processes)

    def _peers(self) -> List[int]:
        return [p for p in self.processes if p != self.me]

    def _owned_by(self, p: int) -> List[int]:
        return [i for i, o in enumerate(self.owners) if o == p]

    def ring_forward(self, xs: Sequence) -> list:
        """`ppermute(perm=[(i, i+1 mod n)])`: entry j of the result is
        shard j - 1's value, on shard j's device (own shards only)."""
        n = self.size
        # per peer, the values in order of the sending shard k
        sends = {p: [xs[k] for k in self.local
                     if self.owners[(k + 1) % n] == p]
                 for p in self._peers()}
        froms = {p: sorted((j - 1) % n for j in self.local
                           if self.owners[(j - 1) % n] == p)
                 for p in self._peers()}
        got = self._exchange({p: v for p, v in sends.items() if v},
                             [p for p, ks in froms.items() if ks])
        prev = {k: xs[k] for k in self.local}
        for p, ks in froms.items():
            prev.update(zip(ks, got.get(p, [])))
        return [_to(prev[(j - 1) % n], self.devices[j]) if self.owns(j)
                else None for j in range(n)]

    def _from_root(self, value) -> list:
        """`value` (on this process's root) on every own shard's device,
        copied once per distinct device."""
        copies = {}
        out = []
        for i, d in enumerate(self.devices):
            if not self.owns(i):
                out.append(None)
                continue
            if d not in copies:
                copies[d] = _to(value, d)
            out.append(copies[d])
        return out

    def _everyone(self, xs: Sequence) -> list:
        """Every shard's value in shard order: this process's own, the
        others' received (on `root`)."""
        peers = self._peers()
        got = self._exchange({p: [xs[i] for i in self.local]
                              for p in peers}, peers)
        vals = list(xs)
        for p in peers:
            for i, v in zip(self._owned_by(p), got[p]):
                vals[i] = v
        return vals

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Exact all-reduce: sum in shard order (on shard 0's device, or
        across processes on each process's root)."""
        vals = self._everyone(xs)
        root = self.root
        total = _to(vals[0], root)
        for x in vals[1:]:
            total = total + _to(x, root)
        return self._from_root(total)

    def gather(self, xs: Sequence[torch.Tensor], dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
        """The shards' values on `root`, in shard order: concatenated
        along `dim` (`tiled`) or stacked on a new axis; every process of
        the group gets it."""
        root = self.root
        parts = [_to(x, root) for x in self._everyone(xs)]
        return (torch.cat(parts, dim=dim) if tiled
                else torch.stack(parts, dim=dim))

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int = 0,
                   tiled: bool = True) -> List[torch.Tensor]:
        """Exact all-gather: `gather`'s result on every own shard."""
        return self._from_root(self.gather(xs, dim=dim, tiled=tiled))

    def all_to_all(self, xs: Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> List[torch.Tensor]:
        """Tiled `lax.all_to_all`: each shard's value splits into n chunks
        along `split_dim`; shard i receives chunk i of every shard's value,
        concatenated along `concat_dim` in shard order, on its device."""
        n = self.size
        first = xs[self.local[0]]
        if first.shape[split_dim] % n:
            raise ValueError(f"axis {split_dim} of {tuple(first.shape)} "
                             f"does not split {n} ways")
        chunks = {j: xs[j].chunk(n, dim=split_dim) for j in self.local}
        peers = self._peers()
        got = self._exchange(
            {p: [chunks[j][i] for j in self.local
                 for i in self._owned_by(p)] for p in peers}, peers)
        for p in peers:
            it = iter(got[p])
            for j in self._owned_by(p):
                chunks[j] = [None] * n
                for i in self.local:
                    chunks[j][i] = next(it)
        return [torch.cat([_to(chunks[j][i], self.devices[i])
                           for j in range(n)], dim=concat_dim)
                if self.owns(i) else None for i in range(n)]


class ShardGrid:
    """The tp x ep mesh: `tp * ep` devices, cell (i, j) = `devices[i * ep
    + j]` (tp index i, ep index j), as `np.array(devices).reshape(tp, ep)`
    lays out the JAX mesh. Cells are listed in that order wherever a
    per-cell list is passed; an entry may be another process's
    `Position`."""

    axes = ("tp", "ep")

    def __init__(self, devices: Sequence, tp: int, ep: int):
        if tp < 1 or ep < 1 or len(devices) != tp * ep:
            raise ValueError(f"a {tp} x {ep} grid needs {tp * ep} devices, "
                             f"got {len(devices)}")
        self.devices, self.owners = split_positions(devices)
        self.tp, self.ep = tp, ep
        self.me = process_index()
        cells = [Position(o, d) for d, o in zip(self.devices, self.owners)]
        # each ep column's tp group, each tp row's ep group
        self._columns = [ShardGroup(cells[j::ep], "tp") for j in range(ep)]
        self._rows = [ShardGroup(cells[i * ep:(i + 1) * ep], "ep")
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

    @property
    def root(self) -> torch.device:
        """Cell (0, 0)'s device, or this process's first own cell's."""
        return self.devices[self.owners.index(self.me)
                            if self.me in self.owners else 0]

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
        """`x` on every own cell's device."""
        return [_to(x, d) if o == self.me else None
                for d, o in zip(self.devices, self.owners)]


class PipelineMesh:
    """The `('dp', 'stage'[, inner])` mesh of an SPMD pipeline over
    `devices`, one per logical position in `(dp, stage, inner)` order;
    `positions[k]` names the logical device (the index into the caller's
    device list) of entry k, so `-r` shows where each stage went. `shape`
    lists the axes as the JAX mesh's does: the inner axis only when it has
    more than one shard. An entry of `devices` may be another process's
    `Position` (`comm.global_devices()`); `processes` lists the processes
    of the mesh."""

    def __init__(self, devices: Sequence, dp: int, n_stages: int,
                 inner: int = 1, inner_axis: str = "tp",
                 positions: Optional[Sequence[int]] = None):
        self.devices, self.owners = split_positions(devices)
        if len(self.devices) != dp * n_stages * inner:
            raise ValueError(f"a {dp} x {n_stages} x {inner} pipeline mesh "
                             f"needs {dp * n_stages * inner} devices, got "
                             f"{len(self.devices)}")
        self.dp, self.n_stages, self.inner = dp, n_stages, inner
        self.inner_axis = inner_axis
        self.positions = (list(range(len(self.devices))) if positions is None
                          else list(positions))
        self.me = process_index()
        self.processes = sorted(set(self.owners))
        cells = [Position(o, d) for d, o in zip(self.devices, self.owners)]

        def span(d, s):
            return slice((d * n_stages + s) * inner,
                         (d * n_stages + s + 1) * inner)
        self._cells = [[ShardGroup(cells[span(d, s)], inner_axis)
                        for s in range(n_stages)] for d in range(dp)]

    @property
    def shape(self) -> dict:
        out = {"dp": self.dp, "stage": self.n_stages}
        if self.inner > 1:
            out[self.inner_axis] = self.inner
        return out

    def __repr__(self) -> str:
        where = [str(d) if o == self.me else f"p{o}:{d}"
                 for d, o in zip(self.devices, self.owners)]
        return f"PipelineMesh({self.shape}, {where})"

    def cell(self, d: int, s: int) -> ShardGroup:
        """Dp cell d's stage s: its inner shards as a group."""
        return self._cells[d][s]

    def local_device(self) -> torch.device:
        """This process's first position's device."""
        return self.devices[self.owners.index(self.me)]

    def hop(self, xs: Sequence, d: int, s: int, tag: int = 1,
            links: Optional[GradLinks] = None) -> list:
        """`ppermute` along 'stage' from s to s + 1 in dp cell d: inner
        shard i's value (a tensor or a `QuantizedTensor`) on stage s + 1's
        shard i's device, for the shards of s + 1 this process owns. A
        shard's value on another process is sent there; under grad its
        gradient comes back as message `tag + i` (`links` collects the
        hop's ends)."""
        src, dst = self._cells[d][s], self._cells[d][s + 1]
        me = self.me
        out = [_to(x, dev) if so == me and do == me else None
               for x, dev, so, do in zip(xs, dst.devices, src.owners,
                                         dst.owners)]
        crossing = [i for i in range(self.inner)
                    if (src.owners[i] == me) != (dst.owners[i] == me)
                    and me in (src.owners[i], dst.owners[i])]
        if not crossing:
            return out
        grad = links is not None and torch.is_grad_enabled()
        sends: Dict[int, list] = {}
        froms: Dict[int, list] = {}
        for i in crossing:
            if src.owners[i] == me:
                sends.setdefault(dst.owners[i], []).append(i)
            else:
                froms.setdefault(src.owners[i], []).append(i)
        group = ex.process_group(self.processes)
        payload = {}
        for p, idx in sends.items():
            # each value with whether its gradient must come back
            payload[p] = []
            for i in idx:
                x = xs[i]
                back = (grad and isinstance(x, torch.Tensor)
                        and x.requires_grad)
                if back:
                    links.tokens.append(ex.HopSend.apply(x, p, tag + i,
                                                         group))
                    x = x.detach()
                payload[p].append((x, back))
        root = dst.devices[dst.local[0]] if dst.local else self.local_device()
        got = ex.exchange(payload, sorted(froms), root, self.processes)
        for p, idx in froms.items():
            for i, (v, back) in zip(idx, got[p]):
                v = _to(v, dst.devices[i])
                if back:
                    if links is None:
                        raise RuntimeError(
                            "a hop sent under grad was received without "
                            "GradLinks: its gradient would never go back")
                    anchor = torch.empty(0, device=v.device,
                                         requires_grad=True)
                    links.anchors.append(anchor)
                    v = ex.HopRecv.apply(anchor, [v], p, tag + i, group,
                                         links.pending)
                out[i] = v
        return out
