"""Thread utilities: lock factories, readers-writer lock, waitable counter.

Port copy of `pipeedge_tpu/utils/threads.py` (the reference's
`utils/threads.py`: RWLock, ThreadSafeCounter).

`make_lock`/`make_rlock`/`make_condition` are the port's lock
constructors: plain stdlib primitives normally, and NAMED
`analysis/lockdep.py` tracked locks when the lock-order witness is on
(env PIPEEDGE_LOCKDEP=1, read when this module is first imported), so a
witnessed run convicts lock-order inversions and blocking calls under a
lock. The name is the graph node: instances of one lock site share it
(``dcn.dead``), indexed sites embed the index (``dcn.conn[3]``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from ..analysis import lockdep


def make_lock(name: str) -> "threading.Lock":
    """A mutex for lock site `name`: tracked when the witness is on."""
    if lockdep.enabled():
        return lockdep.TrackedLock(lockdep.state(), name)
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock":
    """A re-entrant mutex for lock site `name` (witness-aware)."""
    if lockdep.enabled():
        return lockdep.TrackedRLock(lockdep.state(), name)
    return threading.RLock()


def make_condition(name: str) -> "threading.Condition":
    """A condition variable for lock site `name` (witness-aware): the
    tracked variant rides a `TrackedRLock`, and `wait()` releases the
    witness's held stack with the lock, so parking in a wait is not
    holding a lock across a blocking call."""
    if lockdep.enabled():
        return threading.Condition(
            lockdep.TrackedRLock(lockdep.state(), name))
    return threading.Condition()


class RWLock:
    """A readers-writer lock: many concurrent readers, exclusive writers."""

    def __init__(self, name: str = "rwlock"):
        self._cond = make_condition(name)
        self._readers = 0
        self._writer = False

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            while self._writer or self._readers > 0:
                self._cond.wait()
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def lock_read(self):
        """Context manager for read access."""
        self.acquire_read()
        try:
            yield self
        finally:
            self.release_read()

    @contextmanager
    def lock_write(self):
        """Context manager for exclusive write access."""
        self.acquire_write()
        try:
            yield self
        finally:
            self.release_write()


class ThreadSafeCounter:
    """A counter whose waiters can block until a threshold is reached
    (reference utils/threads.py:60-91; used to count pipeline results)."""

    def __init__(self, value: int = 0, name: str = "counter"):
        self._value = value
        self._cond = make_condition(name)

    @property
    def value(self) -> int:
        with self._cond:
            return self._value

    def add(self, quantity: int = 1) -> None:
        with self._cond:
            self._value += quantity
            self._cond.notify_all()

    def set(self, value: int) -> None:
        with self._cond:
            self._value = value
            self._cond.notify_all()

    def wait_gte(self, threshold: int, timeout: float = None) -> bool:
        """Block until value >= threshold; returns False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._value >= threshold,
                                       timeout=timeout)
