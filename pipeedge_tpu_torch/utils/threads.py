"""Thread utilities: lock factories, readers-writer lock, waitable counter.

Port copy of `pipeedge_tpu/utils/threads.py` (the reference's
`utils/threads.py`: RWLock, ThreadSafeCounter). The JAX package's lock
factories hand out tracked locks when its lock-order witness
(`analysis/lockdep.py`) is on; that analyzer is not ported, so here
`make_lock`, `make_rlock` and `make_condition` always return the plain
stdlib primitives. They keep their `name` argument, so call sites read as
in the JAX package.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


def make_lock(name: str) -> "threading.Lock":
    """A mutex for lock site `name`."""
    del name
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock":
    """A re-entrant mutex for lock site `name`."""
    del name
    return threading.RLock()


def make_condition(name: str) -> "threading.Condition":
    """A condition variable for lock site `name`."""
    del name
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
