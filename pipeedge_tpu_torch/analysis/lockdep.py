"""Runtime lock-order witness (lockdep): cycles + blocking-under-lock.

Port of `pipeedge_tpu/analysis/lockdep.py`, stdlib-only as it is: the
same witness over the port's threads (the DCN transport's reader,
heartbeat and sender threads, the serving executors, the command plane).
A witnessed run sees the real acquisition orders, kernel-lockdep style:
one observed A->B ordering is enough to convict a later B->A.

Mechanics:

- `utils/threads.py`'s `make_lock`/`make_rlock`/`make_condition`
  factories return `TrackedLock`s when the witness is enabled (env
  PIPEEDGE_LOCKDEP=1, or `enable()` in-process), plain stdlib primitives
  otherwise, so the disabled path costs nothing.
- every successful acquire appends the lock's NAME to a per-thread held
  stack and records held->acquired edges into a global order graph, with
  a short witness stack captured the first time each edge is seen.
- `cycles()` runs Tarjan's SCC over the name graph: any SCC with more
  than one lock (or a self-edge between two instances of one name) is an
  order inversion that can deadlock.
- while enabled, `time.sleep` and blocking `queue.Queue.get/put` are
  wrapped to call `note_blocking`: executing one with any tracked lock
  held is recorded with the held set and a stack. Socket sends are not
  patched, so the transport's timings stay as they are.
- `report()`/`dump()` emit a one-JSON-line summary; with
  PIPEEDGE_LOCKDEP_OUT set, every witnessing process appends its line at
  exit (O_APPEND, one line per process: the ranks of a `-c dcn` fleet,
  which inherit the environment, land in the same file).

Per-name, not per-instance: `dcn.conn[3]` and `dcn.conn[5]` are distinct
names, but every `DistDcnContext`'s `dcn.dead` is ONE node: the order
law is a property of the code path, so a 2-rank run can convict an
ordering that only deadlocks at rank 40.

Stdlib-only: imported by `utils/threads.py` at module load.
"""
from __future__ import annotations

import atexit
import json
import os
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

ENV_LOCKDEP = "PIPEEDGE_LOCKDEP"
ENV_LOCKDEP_OUT = "PIPEEDGE_LOCKDEP_OUT"

# witness bookkeeping caps: the graph itself is tiny (lock names are
# static), but blocking-violation records carry stacks and a pathological
# loop could grow them without bound
_MAX_BLOCKING_RECORDS = 256
_STACK_DEPTH = 6

# frames from these files are witness plumbing, not evidence — dropped
# from captured stacks so the top frame names the caller's code
_SELF_FILES = ("lockdep.py", "threads.py")


def _caller_stack() -> List[str]:
    frames = traceback.extract_stack()
    out = []
    for f in frames:
        fname = os.path.basename(f.filename)
        if fname in _SELF_FILES:
            continue
        out.append(f"{fname}:{f.lineno}:{f.name}")
    return out[-_STACK_DEPTH:]


class LockdepState:
    """One witness: order graph + per-thread held stacks + violations.

    The global singleton (`enable()`) is the production path; tests build
    private instances so a deliberately constructed cycle never pollutes
    a witnessed run's report.
    """

    def __init__(self):
        # guards graph/violation mutation only; a leaf lock — nothing is
        # acquired and no blocking call runs while it is held, so the
        # witness itself can never participate in an order cycle
        self._mu = threading.Lock()
        self._held = threading.local()
        # (held_name, acquired_name) -> {count, thread, stack}
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._lock_names: set = set()
        self._threads_seen: set = set()
        self._blocking: List[dict] = []
        self._blocking_dropped = 0

    # -- per-thread held stack ----------------------------------------
    # entries are (name, instance id): re-entrancy is a property of ONE
    # lock object, but the order graph folds by name — so acquiring a
    # SECOND instance of the same name while the first is held records a
    # self-edge (name, name), the two-instances-one-site deadlock shape

    def _stack(self) -> List[Tuple[str, int]]:
        st = getattr(self._held, "names", None)
        if st is None:
            st = self._held.names = []
        return st

    def held(self) -> Tuple[str, ...]:
        """Lock names the CURRENT thread holds, outermost first."""
        return tuple(n for n, _ in self._stack())

    def note_acquire(self, name: str, oid: int = 0) -> None:
        st = self._stack()
        with self._mu:
            self._lock_names.add(name)
            self._threads_seen.add(threading.current_thread().name)
            for h, h_oid in st:
                if h == name and h_oid == oid:
                    continue     # re-entrant hold of THIS lock: not an edge
                rec = self._edges.get((h, name))
                if rec is None:
                    self._edges[(h, name)] = {
                        "count": 1,
                        "thread": threading.current_thread().name,
                        "stack": _caller_stack(),
                    }
                else:
                    rec["count"] += 1
        st.append((name, oid))

    def note_release(self, name: str, oid: int = 0) -> None:
        st = self._stack()
        # release order need not be LIFO (lock A, lock B, release A):
        # drop the most recent matching hold
        for i in range(len(st) - 1, -1, -1):
            if st[i] == (name, oid):
                del st[i]
                return

    def note_release_all(self, name: str, oid: int = 0) -> int:
        """Drop every recursion level of this lock (Condition.wait's full
        release); returns how many were held so restore can re-push."""
        st = self._stack()
        n = st.count((name, oid))
        if n:
            self._held.names = [s for s in st if s != (name, oid)]
        return n

    def note_blocking(self, desc: str) -> None:
        """A blocking call is starting on this thread: a violation iff any
        tracked lock is currently held."""
        st = self._stack()
        if not st:
            return
        with self._mu:
            if len(self._blocking) >= _MAX_BLOCKING_RECORDS:
                self._blocking_dropped += 1
                return
            self._blocking.append({
                "held": [n for n, _ in st],
                "call": desc,
                "thread": threading.current_thread().name,
                "stack": _caller_stack(),
            })

    # -- analysis ------------------------------------------------------

    def cycles(self) -> List[List[str]]:
        """Lock-name cycles in the observed order graph (Tarjan SCC):
        each returned list is one strongly-connected component of >= 2
        locks — an inversion some pair of threads can deadlock on — or a
        single name with a self-edge (two INSTANCES of one lock site
        nested, the shape note_acquire records when oids differ)."""
        with self._mu:
            adj: Dict[str, List[str]] = {}
            self_edges = set()
            for (a, b) in self._edges:
                if a == b:
                    self_edges.add(a)
                adj.setdefault(a, []).append(b)
                adj.setdefault(b, [])
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: set = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # iterative Tarjan: witness graphs are small but a DFS over
            # a long chain must not hit the recursion limit mid-report
            work = [(v, 0)]
            while work:
                node, pi = work.pop()
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                succs = adj.get(node, [])
                for i in range(pi, len(succs)):
                    w = succs[i]
                    if w not in index:
                        work.append((node, i + 1))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1 or comp[0] in self_edges:
                        sccs.append(sorted(comp))
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for v in list(adj):
            if v not in index:
                strongconnect(v)
        return sccs

    def edge_witnesses(self, names: List[str]) -> List[dict]:
        """The recorded witnesses for every edge between `names` — what a
        cycle report prints so the inversion is actionable."""
        wanted = set(names)
        with self._mu:
            return [dict(rec, held=a, acquired=b)
                    for (a, b), rec in self._edges.items()
                    if a in wanted and b in wanted]

    def report(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            return {
                "pid": os.getpid(),
                "locks": sorted(self._lock_names),
                "edges": len(self._edges),
                "threads": len(self._threads_seen),
                "cycles": cycles,
                "blocking_violations": list(self._blocking),
                "blocking_dropped": self._blocking_dropped,
            }

    def dump(self, path: str) -> dict:
        """Append the report as ONE JSON line (O_APPEND: concurrent fleet
        processes each land their own line intact)."""
        rep = self.report()
        rep["cycle_witnesses"] = [self.edge_witnesses(c)
                                  for c in rep["cycles"]]
        line = json.dumps(rep, separators=(",", ":")) + "\n"
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        return rep


class TrackedLock:
    """`threading.Lock` wrapper feeding the witness on acquire/release.

    Name, not instance, is the graph node (see module docstring). The
    wrapper adds two method calls and one list append per acquisition —
    only ever paid when the witness is enabled.
    """

    _factory = staticmethod(threading.Lock)

    def __init__(self, state: LockdepState, name: str):
        self._state = state
        self.name = name
        self._lk = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._state.note_acquire(self.name, id(self))
        return ok

    def release(self) -> None:
        self._lk.release()
        self._state.note_release(self.name, id(self))

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


class TrackedRLock(TrackedLock):
    """Re-entrant tracked lock, `threading.Condition`-compatible.

    Forwards the private wait protocol (`_is_owned`, `_release_save`,
    `_acquire_restore`) so `make_condition` can build a stdlib Condition
    on top: `wait()` fully releases the lock — and the witness's held
    stack — before parking, so time parked in a wait is correctly NOT
    "holding the lock across a blocking call".
    """

    _factory = staticmethod(threading.RLock)

    def _is_owned(self) -> bool:
        return self._lk._is_owned()

    def _release_save(self):
        token = self._lk._release_save()
        depth = self._state.note_release_all(self.name, id(self))
        return (token, depth)

    def _acquire_restore(self, saved) -> None:
        token, depth = saved
        self._lk._acquire_restore(token)
        for _ in range(max(depth, 1)):
            self._state.note_acquire(self.name, id(self))


# -- global witness ------------------------------------------------------

_STATE: Optional[LockdepState] = None
_orig_sleep = None
_orig_queue_get = None
_orig_queue_put = None


def enabled() -> bool:
    return _STATE is not None


def state() -> Optional[LockdepState]:
    return _STATE


def _patched_sleep(secs):
    st = _STATE
    if st is not None and secs > 0:
        st.note_blocking(f"time.sleep({secs:g})")
    return _orig_sleep(secs)


def _patched_queue_get(self, block=True, timeout=None):
    st = _STATE
    if st is not None and block:
        st.note_blocking("queue.Queue.get")
    return _orig_queue_get(self, block, timeout)


def _patched_queue_put(self, item, block=True, timeout=None):
    st = _STATE
    if st is not None and block:
        st.note_blocking("queue.Queue.put")
    return _orig_queue_put(self, item, block, timeout)


def enable(st: Optional[LockdepState] = None) -> LockdepState:
    """Switch the witness on process-wide (idempotent; `st` lets a test
    install a private state and restore the previous one after). Locks
    created BEFORE enabling stay untracked: enable first, before any
    module that creates a lock at import."""
    global _STATE, _orig_sleep, _orig_queue_get, _orig_queue_put
    prev = _STATE
    _STATE = st if st is not None else (prev or LockdepState())
    if _orig_sleep is None:
        _orig_sleep = time.sleep
        _orig_queue_get = queue.Queue.get
        _orig_queue_put = queue.Queue.put
        time.sleep = _patched_sleep
        queue.Queue.get = _patched_queue_get
        queue.Queue.put = _patched_queue_put
    return _STATE


def disable() -> None:
    """Switch the witness off and unpatch the blocking probes."""
    global _STATE, _orig_sleep, _orig_queue_get, _orig_queue_put
    _STATE = None
    if _orig_sleep is not None:
        time.sleep = _orig_sleep
        queue.Queue.get = _orig_queue_get
        queue.Queue.put = _orig_queue_put
        _orig_sleep = _orig_queue_get = _orig_queue_put = None


def _dump_at_exit() -> None:  # pragma: no cover - exercised by fleet runs
    out = os.getenv(ENV_LOCKDEP_OUT)
    if _STATE is not None and out:
        try:
            _STATE.dump(out)
        except OSError:
            pass


# env opt-in at import time: utils/threads.py imports this module before
# any lock of the port exists, so PIPEEDGE_LOCKDEP=1 witnesses EVERY
# process that imports pipeedge_tpu_torch, the `-c dcn` ranks included,
# which append their own report lines via PIPEEDGE_LOCKDEP_OUT
if os.getenv(ENV_LOCKDEP) == "1":
    enable()
    atexit.register(_dump_at_exit)
