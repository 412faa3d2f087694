"""Transport of the port: command ids, contexts, the DCN transport, frames.

Port of `pipeedge_tpu/comm/`:

- here: the command ids (`CMD_STOP`, `CMD_SCHED`, `CMD_BID`, `CMD_DEAD`,
  `CMD_ADMIT`), the `DistContext` lifecycle base, the in-process
  `CommandPlane`, and the contexts of the meshes: `SliceContext` (one
  process over its local devices) and `MultiHostContext` (several
  processes joined by `torch.distributed`, the counterpart of
  `jax.distributed.initialize`), with `global_devices()`, the
  process-major list of every process's positions;
- `dcn`: PipeEdge's own transport, one process per rank over framed TCP
  (`DistDcnContext`, `DcnPipelineStage`);
- `wire`: the frames a stage output travels in (the device-encoded v2
  frame and the host-encoded v1 frame).

After `MultiHostContext.init()` the meshes of `parallel/mesh.py` take
`global_devices()` entries as their positions: each position belongs to
the process that listed it, each process runs only its own positions'
work, and values cross between processes through `torch.distributed`
(`parallel/mesh.py`'s module docstring says how).
"""
from __future__ import annotations

import logging
import queue
import socket
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

from ..utils.threads import make_lock

logger = logging.getLogger(__name__)

# Command identifiers (reference runtime.py:36-37)
CMD_STOP = 0
CMD_SCHED = 1
# reverse-auction bid request, answered on the transport's BIDS channel
CMD_BID = 2
# peer-death announcement (failover mode): payload is the dead rank id
CMD_DEAD = 3
# admission acknowledgment of a rejoined peer: payload is the current
# global round index
CMD_ADMIT = 4

DistCmdHandler = Callable[[int, Tuple[Any, ...]], None]


class DistContext:
    """Base lifecycle context (reference comm/__init__.py:7-32): holds
    world_size/rank, must be entered before use, reusable as a context
    manager."""

    def __init__(self, world_size: int = 1, rank: int = 0):
        self._world_size = world_size
        self._rank = rank
        self._initialized = False

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def initialized(self) -> bool:
        return self._initialized

    def init(self) -> None:
        """Initialize the context."""
        self._initialized = True

    def shutdown(self) -> None:
        """Shutdown the context."""
        self._initialized = False

    def __enter__(self):
        self.init()
        return self

    def __exit__(self, *args):
        self.shutdown()


class SliceContext(DistContext):
    """One process over its local devices: world = those devices.

    The JAX `SliceContext` snapshots `jax.local_devices()`; here `init()`
    snapshots `cuda:0 .. cuda:count-1`, or `[cpu]` when the caller asks
    for the CPU (`device="cpu"`), and starts the `CommandPlane`."""

    def __init__(self, cmd_handler: Optional[DistCmdHandler] = None,
                 device="cuda"):
        super().__init__(world_size=0, rank=0)
        self._device = device
        self.devices: list = []
        self.command_plane = CommandPlane(cmd_handler)

    def init(self) -> None:
        # snapshot the devices here, not in __init__: touching CUDA at
        # construction would initialize it before a MultiHostContext (or a
        # caller choosing the CPU) gets a chance to run
        self.devices = local_devices(self._device)
        self._world_size = len(self.devices)
        super().init()
        self.command_plane.start()

    def shutdown(self) -> None:
        self.command_plane.stop()
        super().shutdown()

    def cmd_broadcast(self, cmd: int, payload: Tuple[Any, ...] = ()) -> None:
        """Publish a command (reference p2p cmd_broadcast, p2p:72-85)."""
        self.command_plane.publish(cmd, payload)


def local_devices(device="cuda") -> list:
    """This process's devices of `device`'s kind: every visible card
    (`cuda:0 .. count-1`; raises when there is none), or `[cpu]`."""
    import torch
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"local devices are cuda or cpu, not {device}")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return [torch.device("cuda", i) for i in range(count)]


def default_backend(device="cuda") -> str:
    """`nccl` for CUDA devices, `gloo` for the CPU."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def nccl_card_clash(hosts: Sequence[str], device_count: int
                    ) -> Optional[str]:
    """Why an `nccl` group over ranks on `hosts` (rank order) cannot
    start, or None. Rank r takes card `cuda:(k % device_count)`, k its
    index among the ranks of its host; two ranks on one card are refused
    by NCCL ("Duplicate GPU detected")."""
    taken: dict = {}
    for rank, host in enumerate(hosts):
        k = sum(1 for h in hosts[:rank] if h == host)
        card = (host, k % max(device_count, 1))
        if card in taken:
            return (f"ranks {taken[card]} and {rank} would share card "
                    f"cuda:{card[1]} on host {host!r} ({device_count} "
                    f"card(s) there): NCCL refuses two ranks on one card "
                    f"(\"Duplicate GPU detected\"); pass backend=\"gloo\" "
                    f"to run them on one card")
        taken[card] = rank
    return None


class MultiHostContext(DistContext):
    """Several processes joined into one world by `torch.distributed`.

    The counterpart of the JAX context over `jax.distributed.initialize`:
    every process runs the same program; `init()` calls
    `init_process_group(backend, init_method="tcp://<coordinator>")`, and
    after it `global_devices()` lists every process's positions, which
    the meshes of `parallel/mesh.py` take. One process skips the group
    and logs, as the JAX context does. `backend` defaults to `nccl` on
    CUDA and `gloo` on the CPU; it is never switched: an `nccl` world
    whose ranks would share a card is refused with an error naming the
    card (NCCL cannot run it) before the group starts."""

    def __init__(self, coordinator_address: str, num_processes: int,
                 process_id: int, backend: Optional[str] = None,
                 device="cuda"):
        super().__init__(world_size=num_processes, rank=process_id)
        self._coordinator_address = coordinator_address
        self._device = device
        self._backend = backend
        self._store = None
        self.devices: list = []

    @property
    def backend(self) -> str:
        return self._backend or default_backend(self._device)

    def init(self) -> None:
        import torch.distributed as dist
        global _LOCAL  # pylint: disable=global-statement
        self.devices = local_devices(self._device)
        if self._world_size > 1:
            backend = self.backend
            logger.info("rank %d of %d: torch.distributed over %s at %s",
                        self._rank, self._world_size, backend,
                        self._coordinator_address)
            if backend == "nccl":
                self._check_cards()
                dist.init_process_group(
                    backend, store=self._store, world_size=self._world_size,
                    rank=self._rank)
            else:
                dist.init_process_group(
                    backend,
                    init_method=f"tcp://{self._coordinator_address}",
                    world_size=self._world_size, rank=self._rank)
        else:
            logger.info("single-process world: skipping torch.distributed")
        _LOCAL = list(self.devices)
        super().init()

    def _check_cards(self) -> None:
        """Rendezvous on the coordinator's store, learn every rank's host
        and refuse a card two ranks would share (`nccl_card_clash`)."""
        import torch
        import torch.distributed as dist
        host, port = self._coordinator_address.rsplit(":", 1)
        self._store = dist.TCPStore(host, int(port), self._world_size,
                                    is_master=self._rank == 0)
        self._store.set(f"pe_host/{self._rank}", socket.gethostname())
        hosts = [self._store.get(f"pe_host/{r}").decode()
                 for r in range(self._world_size)]
        # rank 0 serves the store: it waits until every rank has read the
        # hosts, so a refusal does not close the store under a reader
        self._store.add("pe_hosts_read", 1)
        deadline = time.monotonic() + 60.0
        while self._rank == 0 and time.monotonic() < deadline \
                and self._store.add("pe_hosts_read", 0) < self._world_size:
            time.sleep(0.01)
        count = torch.cuda.device_count()
        clash = nccl_card_clash(hosts, count)
        if clash:
            self._store = None
            raise RuntimeError(clash)
        # this rank's own card: NCCL runs one rank per card
        card = sum(1 for h in hosts[:self._rank] if h == hosts[self._rank])
        torch.cuda.set_device(card)
        self.devices = [torch.device("cuda", card)]

    def shutdown(self) -> None:
        import torch.distributed as dist
        global _LOCAL  # pylint: disable=global-statement
        if self._world_size > 1 and dist.is_initialized():
            dist.destroy_process_group()
        self._store = None
        _LOCAL = None
        super().shutdown()


# the devices of this process's MultiHostContext while it is up: the
# default `local` of global_devices()
_LOCAL: Optional[list] = None


class Position(NamedTuple):
    """A logical mesh position: the process that runs it and its device
    there (`global_devices()`)."""
    process: int
    device: Any


def process_index() -> int:
    """This process's rank in the `torch.distributed` world (0 without
    one): the owner id the meshes compare positions against."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def global_devices(local: Optional[Sequence] = None, device="cuda"
                   ) -> List[Position]:
    """Every process's positions, process-major (the counterpart of
    `jax.devices()` after `jax.distributed.initialize`): process p's
    `local` devices as `Position(p, device)`, learned by one
    `all_gather_object`. `local` defaults to the devices of the
    `MultiHostContext` that is up (its own card under `nccl`), else
    `local_devices(device)`. A process may list one device several times
    (two positions on one card, as shards share cards round-robin).
    Without a `torch.distributed` world, this process's own."""
    import torch
    import torch.distributed as dist
    if local is None:
        local = _LOCAL if _LOCAL is not None else local_devices(device)
    mine = [str(torch.device(d)) for d in local]
    if dist.is_initialized() and dist.get_world_size() > 1:
        every: list = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    return [Position(p, torch.device(d)) for p, devs in enumerate(every)
            for d in devs]


class CommandPlane:
    """Host-side command pub/sub: the reference's CommandThread without the
    network (p2p/__init__.py:298-331). Commands are dispatched to the handler
    on a background thread, so a schedule can arrive while the pipeline
    runs."""

    _SHUTDOWN = object()  # queue sentinel: everything before it is delivered

    def __init__(self, handler: Optional[DistCmdHandler] = None):
        self._handler = handler
        # each start()/stop() session gets its own queue: stop() swaps in a
        # fresh one under the lock, so the outgoing dispatch thread drains
        # exactly its own session's commands, while later publishes are
        # held for the next start()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        # set only by an in-handler stop(): the dispatch thread that is
        # still draining its session's queue and couldn't be joined there
        self._draining: Optional[threading.Thread] = None
        self._lock = make_lock("comm.dispatcher")

    def start(self) -> None:
        """Start the dispatch thread. If the previous session was stopped
        from inside its own handler, wait for that dispatcher to finish
        first so two sessions never dispatch concurrently."""
        while True:
            with self._lock:
                if self._thread is not None:
                    return
                draining = self._draining
                if draining is None or draining is threading.current_thread():
                    self._draining = None
                    self._thread = threading.Thread(
                        target=self._run, args=(self._queue,), daemon=True,
                        name="CommandPlane")
                    self._thread.start()
                    return
            draining.join()
            with self._lock:
                if self._draining is draining:
                    self._draining = None

    def stop(self) -> None:
        """Stop the dispatch thread after it drains already-published
        commands. Commands published after stop()'s cutoff are held for
        the next start(). Safe to call from several threads and from
        inside a command handler (the dispatch thread then finishes its
        queue and exits on its own)."""
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            self._thread = None
            self._queue.put(self._SHUTDOWN)  # FIFO: after all prior publishes
            self._queue = queue.Queue()
            self._draining = thread
        if thread is not threading.current_thread():
            thread.join()
            with self._lock:
                if self._draining is thread:
                    self._draining = None

    def publish(self, cmd: int, payload: Tuple[Any, ...] = ()) -> None:
        with self._lock:
            self._queue.put((cmd, payload))

    def _run(self, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is self._SHUTDOWN:
                return
            cmd, payload = item
            logger.debug("command plane: cmd=%d", cmd)
            if self._handler is not None:
                try:
                    self._handler(cmd, payload)
                except Exception:  # keep dispatching, like the reference
                    logger.exception("command handler failed (cmd=%d)", cmd)
