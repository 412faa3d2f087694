"""Values crossing between processes: the meshes' transport.

`parallel/mesh.py`'s shard groups and pipeline meshes run one controller
per process (`comm.MultiHostContext`), and what one process's position
hands another's travels here, over `torch.distributed` point-to-point
operations:

- `exchange(sends, recv_from, device, processes)` moves one nested value
  to each peer (tensors, `QuantizedTensor`s, lists, tuples, dicts and
  small picklable leaves such as a dtype) and returns what each peer sent.
  A message is two: its size (one int64), then the pickled layout and
  the tensors' bytes in one buffer. Every process posts its sends and
  receives of a phase together (`batch_isend_irecv`), so the order in
  which processes reach an exchange cannot deadlock it; every process
  walks the same tick order, so exchanges meet in order.
- Under `gloo` (host memory only for point-to-point) a CUDA tensor is
  staged through a pinned host buffer here, and the receiver copies it to
  its device; under `nccl` the buffers stay on the card.
- `HopSend`/`HopRecv` carry a stage hop's gradient back under autograd:
  the sender's forward returns an empty token the caller adds to its
  loss, whose backward receives the gradient; the receiver's output's
  backward sends it. Each hop has its own tag, so the backward's sends
  and receives match whatever order each process's autograd engine runs
  them in. NCCL ignores tags, so a cross-process hop under grad is
  refused there.
- Subgroups: `process_group(processes)` is the default group when the
  processes are the whole world, else one `new_group` per process set,
  made once.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.quant import QuantizedTensor

_ALIGN = 16
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def process_group(processes: Sequence[int]):
    """The process group over `processes` (None: the default group, when
    they are the whole world); a subgroup is made once per set."""
    key = tuple(sorted(set(processes)))
    if len(key) == dist.get_world_size():
        return None
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key),
                                      use_local_synchronization=True)
    return _GROUPS[key]


def _on_gloo(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def _flatten(obj, tensors: list):
    """The layout of `obj` with each tensor replaced by its index."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("T", len(tensors) - 1)
    if isinstance(obj, QuantizedTensor):
        return ("Q", _flatten(obj.data, tensors),
                _flatten(obj.scale, tensors), _flatten(obj.shift, tensors),
                tuple(obj.shape), obj.bit)
    if isinstance(obj, (list, tuple)):
        return ("L" if isinstance(obj, list) else "U",
                [_flatten(x, tensors) for x in obj])
    if isinstance(obj, dict):
        return ("D", {k: _flatten(v, tensors) for k, v in obj.items()})
    return ("O", obj)


def _unflatten(layout, tensors: list):
    kind = layout[0]
    if kind == "T":
        return tensors[layout[1]]
    if kind == "Q":
        return QuantizedTensor(data=_unflatten(layout[1], tensors),
                               scale=_unflatten(layout[2], tensors),
                               shift=_unflatten(layout[3], tensors),
                               shape=layout[4], bit=layout[5])
    if kind == "L":
        return [_unflatten(x, tensors) for x in layout[1]]
    if kind == "U":
        return tuple(_unflatten(x, tensors) for x in layout[1])
    if kind == "D":
        return {k: _unflatten(v, tensors) for k, v in layout[1].items()}
    return layout[1]


def _pad(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _pack(obj, staged: bool, device) -> torch.Tensor:
    """One uint8 message: the pickled (layout, tensor metadata) padded to
    the alignment, then each tensor's bytes at an aligned offset."""
    tensors: list = []
    layout = _flatten(obj, tensors)
    meta, offset = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        meta.append((tuple(t.shape), t.dtype, offset, nbytes))
        offset += _pad(nbytes)
    head = pickle.dumps((layout, meta))
    head_len = _pad(len(head) + 8)
    where = torch.device("cpu") if staged else torch.device(device)
    buf = torch.empty(head_len + offset, dtype=torch.uint8, device=where,
                      pin_memory=staged and torch.device(device).type
                      == "cuda")
    prefix = len(head).to_bytes(8, "little") + head
    buf[:len(prefix)].copy_(torch.frombuffer(bytearray(prefix),
                                             dtype=torch.uint8))
    for t, (_, _, off, nbytes) in zip(tensors, meta):
        if nbytes:
            buf[head_len + off:head_len + off + nbytes].copy_(_bytes_of(t))
    return buf


def _unpack(buf: torch.Tensor, device):
    host = buf if buf.device.type == "cpu" else buf.cpu()
    n = int.from_bytes(bytes(host[:8].tolist()), "little")
    layout, meta = pickle.loads(bytes(host[8:8 + n].numpy()))
    head_len = _pad(n + 8)
    device = torch.device(device)
    tensors = []
    for shape, dtype, off, nbytes in meta:
        t = buf[head_len + off:head_len + off + nbytes].view(dtype)
        t = t.reshape(shape)
        if t.device != device:
            t = t.to(device, non_blocking=True)
        tensors.append(t)
    return _unflatten(layout, tensors)


def exchange(sends: Dict[int, Any], recv_from: Sequence[int], device,
             processes: Sequence[int]) -> Dict[int, Any]:
    """Send `sends[p]` to each peer p and receive one value from each
    peer in `recv_from`, landed on `device`; `processes` names the group
    (every process that takes part in this exchange anywhere)."""
    if not sends and not recv_from:
        return {}
    group = process_group(processes)
    staged = _on_gloo(group)
    wire = torch.device("cpu") if staged else torch.device(device)
    tensors: list = []
    for obj in sends.values():
        _flatten(obj, tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "this exchange between processes has no backward; under grad "
            "only a pipeline mesh's stage hop crosses processes")
    bufs = {p: _pack(obj, staged, device) for p, obj in sends.items()}
    sizes_out = {p: torch.tensor([b.numel()], dtype=torch.int64,
                                 device=wire) for p, b in bufs.items()}
    sizes_in = {p: torch.empty(1, dtype=torch.int64, device=wire)
                for p in recv_from}
    _run([dist.P2POp(dist.isend, sizes_out[p], p, group)
          for p in sorted(sizes_out)]
         + [dist.P2POp(dist.irecv, sizes_in[p], p, group)
            for p in sorted(sizes_in)])
    got = {p: torch.empty(int(sizes_in[p].item()), dtype=torch.uint8,
                          device=wire,
                          pin_memory=staged and torch.device(device).type
                          == "cuda")
           for p in recv_from}
    _run([dist.P2POp(dist.isend, bufs[p], p, group)
          for p in sorted(bufs)]
         + [dist.P2POp(dist.irecv, got[p], p, group)
            for p in sorted(got)])
    return {p: _unpack(buf, device) for p, buf in got.items()}


def _run(ops: list) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


# -- a stage hop's gradient, back across the processes ---------------------

def _check_tags(group) -> None:
    if not _on_gloo(group):
        raise NotImplementedError(
            "a stage hop between processes under grad needs tagged "
            "point-to-point messages (gloo); NCCL matches them in order, "
            "which the autograd engines of two processes need not share")


class HopSend(torch.autograd.Function):
    """The sending side of a cross-process hop under grad: `apply(x, peer,
    tag, group)` returns an empty token; the token's backward receives
    x's gradient from `peer` (message `tag`)."""

    @staticmethod
    def forward(ctx, x, peer, tag, group):  # pylint: disable=arguments-differ
        _check_tags(group)
        ctx.meta = (tuple(x.shape), x.dtype, x.device, peer, tag, group)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _):  # pylint: disable=arguments-differ
        shape, dtype, device, peer, tag, group = ctx.meta
        staged = device.type == "cuda"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else device,
                          pin_memory=staged)
        dist.recv(buf, src=peer, group=group, tag=tag)
        return (buf.to(device, non_blocking=True) if staged else buf,
                None, None, None)


class HopRecv(torch.autograd.Function):
    """The receiving side: `apply(anchor, box, peer, tag, group, pending)`
    returns the received tensor `box[0]` in the graph; its backward sends
    the gradient to `peer` (message `tag`) and leaves the send, with its
    buffer, on the list `pending` for the caller to wait for. `anchor` is
    an empty leaf that requires grad, so the engine runs this node when
    the caller asks for the anchor's gradient too."""

    @staticmethod
    def forward(ctx, anchor, box, peer, tag, group, pending):  # pylint: disable=arguments-differ
        _check_tags(group)
        ctx.meta = (peer, tag, group, pending)
        return box[0]

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        peer, tag, group, pending = ctx.meta
        out = grad.detach().contiguous()
        if out.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out)
            out = host
        pending.append((dist.isend(out, dst=peer, group=group, tag=tag),
                        out))
        return grad.new_zeros(0), None, None, None, None, None
