"""Process-wide monitoring: the facade the runtime reports through.

Port of the repository's root `monitoring.py` (the facade over
`pipeedge_tpu.monitoring`), over the port's own `monitoring` package and
`utils/threads.py`. One shared `MonitorContext` per process, keys addable
at runtime, iterations that may start and finish on different calls or
different threads, with the state held by a single `_Session` object.
Module-level functions are the API; they delegate to the live session
under a readers-writer lock, and every call is a safe no-op when no
session is open, so late callers can keep reporting through a teardown.

`flush()` pushes all CSV logs to disk, and `finish()` is registered
atexit, so an exception exit still closes the logs.
"""
from contextlib import ExitStack, contextmanager
import atexit
import logging
import os
import threading
from typing import Optional, Union

from ..utils.threads import RWLock, make_lock
from . import MonitorContext, MonitorIterationContext

ENV_CSV_FILE_MODE: str = "CSV_FILE_MODE"
_DEFAULT_CSV_MODE = 'w'  # fresh logs each run; CSV_FILE_MODE=x refuses to
# clobber an existing file, =a appends across runs

PRINT_FIELDS_INSTANT = True
PRINT_FIELDS_WINDOW = True
PRINT_FIELDS_GLOBAL = True

logger = logging.getLogger(__name__)

# metric name -> (context getter suffix, unit template); '{work}'/'{acc}'
# expand to the key's registered display units
_SCOPE_METRICS = (
    ("Time", "time_s", "sec"),
    ("Rate", "heartrate", "microbatches/sec"),
    ("Work", "work", "{work}"),
    ("Perf", "perf", "{work}/sec"),
    ("Energy", "energy_j", "Joules"),
    ("Power", "power_w", "Watts"),
    ("Acc", "accuracy", "{acc}"),
    ("Acc Rate", "accuracy_rate", "{acc}/sec"),
)


class _Session:
    """Everything one init()..finish() span owns: the shared context, the
    per-key report locks and display units, and the in-flight iteration
    contexts of every (thread, key) pair."""

    def __init__(self, ctx: MonitorContext):
        self.ctx = ctx
        self.key_locks = {}
        self.units = {}      # key -> (work unit, acc unit)
        self.inflight = {}   # (thread ident, key) -> MonitorIterationContext

    def register(self, key: str, work_type: str, acc_type: str) -> None:
        self.key_locks[key] = make_lock(f"monitoring.key[{key}]")
        self.units[key] = (work_type, acc_type)

    def begin(self, key: str) -> MonitorIterationContext:
        slot = (threading.get_ident(), key)
        if slot in self.inflight:
            raise KeyError(f"{key}: this thread already has an open "
                           "iteration")
        ictx = MonitorIterationContext()
        self.inflight[slot] = ictx
        return ictx

    def take(self, key: str) -> MonitorIterationContext:
        slot = (threading.get_ident(), key)
        try:
            return self.inflight.pop(slot)
        except KeyError:
            raise KeyError(f"{key}: no open iteration on this thread") \
                from None

    def log_scope(self, key: str, scope: str) -> None:
        work_u, acc_u = self.units[key]
        title = scope.capitalize()
        for name, getter, unit in _SCOPE_METRICS:
            value = getattr(self.ctx, f"get_{scope}_{getter}")(key=key)
            unit = unit.format(work=work_u, acc=acc_u)
            logger.info("%s: %s %s: %s %s", key, title, name, value, unit)


_session: Optional[_Session] = None
_session_lock = RWLock("monitoring.session")


def init(key: str, window_size: int, work_type: str = 'items',
         acc_type: str = 'acc') -> None:
    """Open the process-wide monitoring session with its first key."""
    global _session  # pylint: disable=global-statement
    from .energy import default_energy_source
    mode = os.getenv(ENV_CSV_FILE_MODE, _DEFAULT_CSV_MODE)
    with _session_lock.lock_write():
        ctx = MonitorContext(key=key, window_size=window_size,
                             log_name=f"{key}.csv", log_mode=mode,
                             energy_source=default_energy_source())
        logger.info("Monitoring energy source: %s", ctx.energy_source)
        ctx.open()
        _session = _Session(ctx)
        _session.register(key, work_type, acc_type)


def finish() -> None:
    """Log global stats, close the CSV logs, end the session."""
    global _session  # pylint: disable=global-statement
    with _session_lock.lock_write():
        if _session is None:
            return
        if PRINT_FIELDS_GLOBAL:
            for key in _session.ctx.keys():
                _session.log_scope(key, "global")
        _session.ctx.close()
        _session = None


def flush() -> None:
    """Force every key's buffered CSV rows to disk: whatever happens next,
    the records up to this moment are on disk."""
    with _session_lock.lock_read():
        if _session is not None:
            _session.ctx.flush()


def add_key(key: str, work_type: str = 'items', acc_type: str = 'acc') -> None:
    """Register another monitored key on the open session."""
    with _session_lock.lock_write():
        if _session is None:
            return
        _session.ctx.add_heartbeat(key=key, log_name=f"{key}.csv")
        _session.register(key, work_type, acc_type)


def snapshot() -> dict:
    """The full (instant|window|global) getter matrix for every registered
    key as one dict (`MonitorContext.snapshot`), with each key's report
    lock held for its read so concurrent beats never tear a row; `{}` when
    no session is open."""
    with _session_lock.lock_read():
        if _session is None:
            return {}
        # hold every report lock (deterministic order; every other path
        # takes at most one, so no deadlock) for one consistent read
        with ExitStack() as stack:
            for key in sorted(_session.key_locks, key=str):
                stack.enter_context(_session.key_locks[key])
            return _session.ctx.snapshot()


@contextmanager
def get_locked_context(key: str):
    """Yield the session's `MonitorContext` with `key`'s report lock held
    (synchronized metric reads); yields None when no session is open."""
    with _session_lock.lock_read():
        if _session is None or key not in _session.key_locks:
            yield None
            return
        with _session.key_locks[key]:
            yield _session.ctx


def iteration_start(key: str) -> None:
    """Open an iteration for this thread on `key`."""
    with _session_lock.lock_read():
        if _session is None:
            return
        with _session.key_locks[key]:
            _session.ctx.iteration_start(iter_ctx=_session.begin(key))


def iteration_reset(key: str) -> None:
    """Forget `key`'s last shared beat: the next start-less
    `iteration(..., safe=False)` stamps a fresh baseline instead of
    recording the idle gap since the previous beat (e.g. between two
    rounds) as one giant iteration."""
    with _session_lock.lock_read():
        if _session is None:
            return
        with _session.key_locks[key]:
            _session.ctx.iteration_reset(key=key)


def iteration_abort(key: str) -> None:
    """Discard this thread's open iteration without emitting a heartbeat
    (e.g. a transfer that failed mid-way); no-op if none was started."""
    with _session_lock.lock_read():
        if _session is None:
            return
        with _session.key_locks[key]:
            _session.inflight.pop((threading.get_ident(), key), None)


def iteration(key: str, work: int = 1, accuracy: Union[int, float] = 0,
              safe: bool = True) -> None:
    """Complete an iteration: emit the heartbeat + CSV row, log instant
    fields each beat and window fields at each window boundary. With
    `safe=False` a missing start is tolerated — the shared per-key beat
    baseline turns the call into a beat-to-beat measurement."""
    with _session_lock.lock_read():
        if _session is None:
            return
        with _session.key_locks[key]:
            ctx = _session.ctx
            try:
                ictx = _session.take(key)
            except KeyError:
                if safe:
                    raise
                ictx = None
            ctx.iteration(key=key, work=work, accuracy=accuracy,
                          iter_ctx=ictx)
            tag = ctx.get_tag(key=key)
            if tag > 0:
                if PRINT_FIELDS_INSTANT:
                    _session.log_scope(key, "instant")
                if PRINT_FIELDS_WINDOW and \
                        (tag + 1) % ctx.get_window_size(key=key) == 0:
                    _session.log_scope(key, "window")


# an exception exit must still close the logs; finish() is idempotent, so
# an orderly main() calling it first costs nothing
atexit.register(finish)
