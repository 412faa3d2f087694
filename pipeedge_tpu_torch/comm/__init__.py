"""Transport of the port: command ids, contexts, the DCN transport, frames.

Port of `pipeedge_tpu/comm/`:

- here: the command ids (`CMD_STOP`, `CMD_SCHED`, `CMD_BID`, `CMD_DEAD`,
  `CMD_ADMIT`), the `DistContext` lifecycle base and the in-process
  `CommandPlane`;
- `dcn`: PipeEdge's own transport, one process per rank over framed TCP
  (`DistDcnContext`, `DcnPipelineStage`);
- `wire`: the frames a stage output travels in (the device-encoded v2
  frame and the host-encoded v1 frame).

The JAX package's `SliceContext` and `MultiHostContext` wrap
`jax.distributed`; their counterpart waits for ROADMAP A7 (multi-GPU).
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Optional, Tuple

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
