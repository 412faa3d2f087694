"""SLO-aware admission control: request classes, token buckets, a bounded
EDF queue, and load shedding with a service-rate-derived Retry-After.

Port copy of `pipeedge_tpu/serving/admission.py`, word for word but for
this paragraph and the package imports.

The serving front end admits one HTTP handler thread per request; this
module decides — BEFORE any TPU work is dispatched — whether that request
runs now, waits, or is shed:

1. **Request classes** (`interactive` / `batch` / `best_effort`): each
   carries an optional sustained-rate token bucket and an optional
   default deadline. Classes are the unit of brownout shedding
   (serving/brownout.py) and of the per-class SLO report
   (tools/loadgen.py).
2. **Bounded EDF queue**: waiting requests are ordered by absolute
   deadline (earliest first — an interactive request with a 2 s deadline
   overtakes a batch request with a 60 s one). The queue is BOUNDED:
   when full, the latest-deadline entry is shed, so a surge converts to
   503s instead of an unbounded backlog of work that will miss its SLO
   anyway.
3. **Shedding with honest backpressure**: every shed carries a
   Retry-After computed from the observed completion rate
   (`ServiceRateEstimator`): backlog / rate, clamped — "come back when
   the queue you would join has drained", not a hard-coded constant.

Thread model: `admit()` blocks the calling handler thread until the
request is granted an execution slot or shed (`AdmissionShed`); the
caller MUST pair every successful admit with `release()`. All state is
guarded by one controller lock; grant events are per-ticket so a release
wakes exactly the next EDF head.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from ..telemetry import metrics as prom
from ..utils.threads import make_lock

# shed order under brownout is reverse priority: best_effort first
REQUEST_CLASSES = ("interactive", "batch", "best_effort")

# admission waits are short by design (the queue is bounded); buckets
# resolve the sub-second region the request-latency buckets blur
ADMISSION_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                             0.5, 1.0, 2.5, 5.0, 10.0)


@dataclass(frozen=True)
class ClassPolicy:
    """One request class's admission contract."""
    name: str
    priority: int                        # lower = more important
    rate: Optional[float] = None         # sustained admits/s (None = off)
    burst: float = 1.0                   # token-bucket capacity
    deadline_s: Optional[float] = None   # default deadline when the
    #                                      request carries none


def default_policies(rates: Optional[Dict[str, float]] = None,
                     deadlines_s: Optional[Dict[str, float]] = None,
                     ) -> Dict[str, ClassPolicy]:
    """The three standard classes, with optional per-class rate limits
    and default deadlines layered on (serve.py's CLI knobs)."""
    rates = rates or {}
    deadlines_s = deadlines_s or {}
    out = {}
    for pri, name in enumerate(REQUEST_CLASSES):
        rate = rates.get(name)
        if rate is not None and rate <= 0:
            # 0 must not silently mean "unlimited" — the opposite of the
            # operator's likely intent (use brownout/shed to block a class)
            raise ValueError(
                f"class {name!r}: rate must be > 0 (omit the class for "
                f"unlimited; shed it via brownout to block it)")
        out[name] = ClassPolicy(
            name=name, priority=pri, rate=rate,
            burst=max(1.0, rate) if rate is not None else 1.0,
            deadline_s=deadlines_s.get(name))
    return out


def parse_class_map(pairs: Optional[Iterable[str]],
                    what: str) -> Dict[str, float]:
    """`interactive=2.5`-style repeated CLI pairs -> {class: float}.
    Shared by tools/serve.py and tools/loadgen.py (each maps the
    ValueError onto its own error channel)."""
    out: Dict[str, float] = {}
    for item in pairs or ():
        name, sep, val = item.partition("=")
        if not sep or name not in REQUEST_CLASSES:
            raise ValueError(
                f"{what} expects CLASS=VALUE with CLASS one of "
                f"{sorted(REQUEST_CLASSES)}, got {item!r}")
        try:
            out[name] = float(val)
        except ValueError:
            raise ValueError(f"{what}: {val!r} is not a number") from None
    return out


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`.

    Not internally locked — the controller serializes access under its
    own lock; standalone use needs external synchronization. `now` is
    injectable for deterministic tests."""

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be > 0, got "
                             f"rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = time.monotonic() if now is None else now

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._tokens = min(self.burst,
                           self._tokens + max(0.0, now - self._t) * self.rate)
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


class EDFQueue:
    """Bounded earliest-deadline-first queue with shed-on-full.

    Entries are (deadline, item); `None` deadlines sort last (they can
    wait forever, so they are also the first candidates to shed). When
    the queue is full, `push` sheds the LATEST-deadline entry — the
    arrival itself when its deadline is the latest — and returns the
    shed item (None when nothing was shed). Lazy deletion supports
    `remove()` for waiters that give up (expiry/timeout) without an
    O(n) heap rebuild."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._heap: List[list] = []   # [key, seq, item, alive]
        self._seq = 0
        self._n = 0                   # alive entries

    @staticmethod
    def _key(deadline: Optional[float]) -> float:
        return math.inf if deadline is None else float(deadline)

    def __len__(self) -> int:
        return self._n

    def push(self, item, deadline: Optional[float]):
        """Insert; returns the shed item when the queue was full (possibly
        `item` itself), else None."""
        import heapq
        shed = None
        if self._n >= self.capacity:
            # shed the latest deadline: linear scan over a small bounded
            # heap beats maintaining a mirrored max-heap
            worst = None
            for e in self._heap:
                if e[3] and (worst is None or (e[0], e[1]) > (worst[0],
                                                              worst[1])):
                    worst = e
            if worst is not None and (worst[0], worst[1]) > (
                    self._key(deadline), self._seq):
                worst[3] = False
                self._n -= 1
                shed = worst[2]
            else:
                return item          # the arrival is the worst: shed it
        entry = [self._key(deadline), self._seq, item, True]
        self._seq += 1
        heapq.heappush(self._heap, entry)
        self._n += 1
        return shed

    def pop(self):
        """(item, deadline_key) with the earliest deadline, or None."""
        import heapq
        while self._heap:
            key, _, item, alive = heapq.heappop(self._heap)
            if alive:
                self._n -= 1
                return item, key
        return None

    def peek(self):
        """(item, deadline_key) of the earliest alive entry WITHOUT
        removing it (dead entries are drained in passing) — the
        token-budget grant loop inspects the head and leaves it in
        place when tokens are short, so the head keeps its position
        instead of being re-queued behind same-deadline arrivals."""
        import heapq
        while self._heap and not self._heap[0][3]:
            heapq.heappop(self._heap)
        if not self._heap:
            return None
        return self._heap[0][2], self._heap[0][0]

    def pop_expired(self, now: float) -> List[object]:
        """Remove and return every entry whose deadline has passed —
        work that would be shed the moment it was granted anyway."""
        import heapq
        out = []
        while self._heap and self._heap[0][0] < now:
            key, _, item, alive = heapq.heappop(self._heap)
            if alive:
                self._n -= 1
                out.append(item)
        return out

    def remove(self, item) -> bool:
        """Lazy-delete one entry (a waiter that timed out)."""
        for e in self._heap:
            if e[3] and e[2] is item:
                e[3] = False
                self._n -= 1
                return True
        return False

    def items(self) -> List[object]:
        """Alive entries in deadline order (non-destructive): the
        postmortem/debug view of who is waiting. O(n log n) over a small
        bounded heap."""
        return [e[2] for e in sorted(
            (e for e in self._heap if e[3]),
            key=lambda e: (e[0], e[1]))]


class ServiceRateEstimator:
    """EWMA of the completion rate, and the Retry-After it implies.

    Each completion updates an exponentially weighted mean of the
    inter-completion interval (half-life `halflife_s`); the service rate
    is its reciprocal. `retry_after(backlog)` answers "when will the
    backlog I would join have drained": (backlog + 1) / rate, clamped —
    the dynamic replacement for a hard-coded Retry-After constant."""

    def __init__(self, halflife_s: float = 10.0):
        self.halflife_s = float(halflife_s)
        self._last: Optional[float] = None
        self._ewma: Optional[float] = None
        self._n = 0

    def observe(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last is not None:
            dt = max(1e-6, now - self._last)
            if self._ewma is None:
                self._ewma = dt
            else:
                # per-sample decay scaled by the observed interval, so the
                # half-life is in SECONDS, not samples
                alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
                self._ewma += alpha * (dt - self._ewma)
        self._last = now
        self._n += 1

    def rate(self) -> Optional[float]:
        """Completions/s, None until two completions have been seen."""
        if self._ewma is None or self._ewma <= 0:
            return None
        return 1.0 / self._ewma

    def retry_after(self, backlog: int, fallback: float = 5.0,
                    lo: float = 0.5, hi: float = 60.0) -> float:
        r = self.rate()
        if r is None:
            return float(fallback)
        return float(min(hi, max(lo, (backlog + 1) / r)))


class AdmissionShed(RuntimeError):
    """The request was refused (rate limit / queue full / brownout /
    expired in queue): HTTP 503 with the carried Retry-After."""

    def __init__(self, request_class: str, reason: str, retry_after: float):
        super().__init__(
            f"request shed ({reason}) for class {request_class!r}; "
            f"retry after {retry_after:g}s")
        self.request_class = request_class
        self.reason = reason
        self.retry_after = retry_after


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it was EXECUTING: the
    executors cancelled it at a decode-step boundary (HTTP 504). Distinct
    from an in-queue expiry, which sheds with 503 + Retry-After (the work
    never started)."""

    def __init__(self, request_class: str, deadline_s: float):
        super().__init__(
            f"deadline exceeded for class {request_class!r} request "
            f"(budget {deadline_s:g}s); generation cancelled mid-flight")
        self.request_class = request_class
        self.deadline_s = deadline_s


SHED_REASONS = ("rate", "queue_full", "brownout", "expired", "shutdown",
                "budget")


class _Ticket:
    __slots__ = ("request_class", "deadline", "t_enq", "event",
                 "shed_reason", "granted", "rid", "tokens")

    def __init__(self, request_class: str, deadline: Optional[float],
                 t_enq: float, rid: Optional[str] = None,
                 tokens: int = 0):
        self.request_class = request_class
        self.deadline = deadline
        self.t_enq = t_enq
        self.event = threading.Event()
        self.shed_reason: Optional[str] = None
        self.granted = False
        # request id (trace context): queue-wait spans and the admission
        # snapshot in a postmortem bundle name WHO is waiting, not just
        # how many (docs/OBSERVABILITY.md request tracing)
        self.rid = rid
        # KV-token charge under a token budget (docs/SERVING.md paged
        # KV): held from grant to release
        self.tokens = int(tokens)


class AdmissionController:
    """Per-class admission with `concurrency` execution slots and a
    bounded EDF wait queue.

    `admit(cls, deadline)` blocks until granted or raises
    `AdmissionShed`; every grant MUST be paired with `release()`
    (completions feed the service-rate estimator that prices
    Retry-After). `set_shed_classes` is the brownout ladder's lever:
    listed classes shed at the door."""

    def __init__(self, concurrency: int, queue_capacity: int = 64,
                 policies: Optional[Dict[str, ClassPolicy]] = None,
                 registry: Optional[prom.Registry] = None,
                 rate_halflife_s: float = 10.0,
                 retry_after_fallback: float = 5.0,
                 token_budget: Optional[int] = None):
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got "
                             f"{token_budget}")
        self.policies = (default_policies() if policies is None
                         else dict(policies))
        self.concurrency = int(concurrency)
        self._free = int(concurrency)
        # the paged-KV admission unit (docs/SERVING.md): admission
        # charges each request's KV-token reservation (prompt +
        # max-new-tokens pages) against this budget; completion frees
        # it. None = slot-only admission (the dense-cache behavior).
        self.token_budget = (None if token_budget is None
                             else int(token_budget))
        self._tokens_free = self.token_budget
        self._queue = EDFQueue(queue_capacity)
        self._lock = make_lock("serving.admission")
        self._closed = False
        self._buckets = {
            name: TokenBucket(p.rate, p.burst)
            for name, p in self.policies.items() if p.rate is not None}
        self._shed_classes: frozenset = frozenset()
        self.estimator = ServiceRateEstimator(halflife_s=rate_halflife_s)
        self.retry_after_fallback = float(retry_after_fallback)
        reg = prom.REGISTRY if registry is None else registry
        self.m_shed = reg.counter(
            "pipeedge_requests_shed_total",
            "requests refused at admission, by class and reason "
            "(rate / queue_full / brownout / expired / shutdown)")
        # the full (class, reason) matrix renders from the first scrape
        for name in self.policies:
            for reason in SHED_REASONS:
                self.m_shed.declare(**{"class": name, "reason": reason})
        self.m_adm_latency = reg.histogram(
            "pipeedge_admission_latency_seconds",
            "time from arrival to execution-slot grant, by class",
            buckets=ADMISSION_LATENCY_BUCKETS)
        self.m_queue_depth = reg.gauge(
            "pipeedge_admission_queue_depth",
            "requests waiting in the EDF admission queue")
        self.m_queue_depth.set(0)
        self.m_tokens_free = reg.gauge(
            "pipeedge_admission_tokens_free",
            "unreserved KV tokens under the admission token budget "
            "(absent series when no budget is configured)")
        if self.token_budget is not None:
            self.m_tokens_free.set(self.token_budget)
        self.m_step_grants = reg.counter(
            "pipeedge_admission_step_grants_total",
            "queued tickets granted by a decode-step notify_step pass "
            "(iteration-level joins, not release-driven ones)")
        self.m_step_grants.declare()

    # -- policy helpers ---------------------------------------------------

    def policy(self, request_class: str) -> ClassPolicy:
        try:
            return self.policies[request_class]
        except KeyError:
            raise KeyError(
                f"unknown request class {request_class!r} (expected one "
                f"of {sorted(self.policies)})") from None

    def deadline_for(self, request_class: str,
                     deadline_s: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[float]:
        """Absolute (monotonic) deadline: the request's own budget when
        given, else the class default, else None."""
        now = time.monotonic() if now is None else now
        if deadline_s is None:
            deadline_s = self.policy(request_class).deadline_s
        if deadline_s is None:
            return None
        return now + float(deadline_s)

    def set_shed_classes(self, names: Iterable[str]) -> None:
        self._shed_classes = frozenset(names)

    @property
    def shed_classes(self) -> frozenset:
        return self._shed_classes

    # -- admission --------------------------------------------------------

    def _shed(self, request_class: str, reason: str,
              backlog: Optional[int] = None) -> AdmissionShed:
        if backlog is None:
            backlog = len(self._queue) + (self.concurrency - self._free)
        self.m_shed.inc(**{"class": request_class, "reason": reason})
        return AdmissionShed(request_class, reason,
                             self.retry_after(backlog))

    def retry_after(self, backlog: Optional[int] = None) -> float:
        """The dynamic Retry-After: queue-drain time at the observed
        service rate (fallback when no completions have been seen)."""
        if backlog is None:
            with self._lock:
                backlog = len(self._queue) + (self.concurrency - self._free)
        return self.estimator.retry_after(
            backlog, fallback=self.retry_after_fallback)

    def admit(self, request_class: str = "interactive",
              deadline: Optional[float] = None,
              now: Optional[float] = None,
              rid: Optional[str] = None,
              tokens: int = 0) -> _Ticket:
        """Block until granted an execution slot (EDF order) or shed.
        `deadline` is ABSOLUTE monotonic time (see `deadline_for`);
        `rid` request-tags the ticket for snapshots/postmortems.
        `tokens` is the request's KV-token reservation under a token
        budget (prompt + max-new-tokens pages, tools/serve.py): the
        grant requires both a slot AND the tokens, so concurrency is
        bounded by cache TOKENS, not request count."""
        now = time.monotonic() if now is None else now
        self.policy(request_class)          # KeyError -> caller's 400
        tokens = int(tokens) if self.token_budget is not None else 0
        ticket = _Ticket(request_class, deadline, now, rid=rid,
                         tokens=tokens)
        shed_waiter: Optional[_Ticket] = None
        with self._lock:
            if self._closed:
                raise self._shed(request_class, "shutdown")
            if request_class in self._shed_classes:
                raise self._shed(request_class, "brownout")
            if self.token_budget is not None \
                    and tokens > self.token_budget:
                # bigger than the WHOLE budget: waiting can never help
                raise self._shed(request_class, "budget")
            bucket = self._buckets.get(request_class)
            if bucket is not None and not bucket.try_take(now=now):
                raise self._shed(request_class, "rate")
            if deadline is not None and deadline <= now:
                raise self._shed(request_class, "expired")
            if self._free > 0 and not len(self._queue) \
                    and self._tokens_ok_locked(tokens):
                self._free -= 1
                self._take_tokens_locked(tokens)
                ticket.granted = True
            else:
                shed_item = self._queue.push(ticket, deadline)
                if shed_item is ticket:
                    raise self._shed(request_class, "queue_full")
                if shed_item is not None:
                    shed_waiter = shed_item
                    shed_waiter.shed_reason = "queue_full"
                self.m_queue_depth.set(len(self._queue))
        if shed_waiter is not None:
            self.m_shed.inc(**{"class": shed_waiter.request_class,
                               "reason": "queue_full"})
            shed_waiter.event.set()
        if ticket.granted:
            self.m_adm_latency.observe(0.0, **{"class": request_class})
            return ticket
        # queued: wait until a release grants us, our deadline passes, or
        # the controller closes
        while True:
            timeout = (None if ticket.deadline is None
                       else max(0.0, ticket.deadline - time.monotonic()))
            fired = ticket.event.wait(timeout)
            with self._lock:
                if ticket.granted:
                    break
                if ticket.shed_reason is not None:
                    # same backlog basis as a door shed (queue + in
                    # flight) so two 503s under the same load advertise
                    # the same Retry-After; the shed counter was already
                    # bumped by whoever displaced us
                    backlog = (len(self._queue)
                               + (self.concurrency - self._free))
                    raise AdmissionShed(ticket.request_class,
                                        ticket.shed_reason,
                                        self.estimator.retry_after(
                                            backlog,
                                            fallback=self.retry_after_fallback))
                if not fired:
                    # deadline passed while queued: withdraw ourselves
                    self._queue.remove(ticket)
                    self.m_queue_depth.set(len(self._queue))
                    raise self._shed(request_class, "expired")
        wait_s = time.monotonic() - ticket.t_enq
        self.m_adm_latency.observe(wait_s, **{"class": request_class})
        return ticket

    def _tokens_ok_locked(self, tokens: int) -> bool:
        return (self.token_budget is None
                or self._tokens_free >= tokens)

    def _take_tokens_locked(self, tokens: int) -> None:
        if self.token_budget is not None and tokens:
            self._tokens_free -= tokens
            self.m_tokens_free.set(self._tokens_free)

    def release(self, ticket: Optional[_Ticket] = None,
                completed: bool = True,
                now: Optional[float] = None) -> None:
        """Return an execution slot (and the ticket's token
        reservation) and grant the next EDF head(s). `completed=True`
        feeds the service-rate estimator (sheds and failures should not
        inflate the observed service rate)."""
        now = time.monotonic() if now is None else now
        to_wake: List[_Ticket] = []
        expired: List[_Ticket] = []
        with self._lock:
            self._free = min(self.concurrency, self._free + 1)
            if self.token_budget is not None and ticket is not None \
                    and ticket.tokens:
                self._tokens_free = min(self.token_budget,
                                        self._tokens_free + ticket.tokens)
                self.m_tokens_free.set(self._tokens_free)
            if completed:
                self.estimator.observe(now)
            self._grant_locked(now, to_wake, expired)
        for t in expired:
            self.m_shed.inc(**{"class": t.request_class,
                               "reason": "expired"})
            t.event.set()
        for t in to_wake:
            t.event.set()

    def notify_step(self, now: Optional[float] = None) -> None:
        """Re-run the grant pass at a decode-step boundary (the
        executors' `on_step` hook, tools/serve.py). Slots and tokens
        free when `release` runs, but a token-budget head-of-line wait
        can also unblock when the STEP-granular picture changes (an
        expired waiter sheds, a clamp lands); stepping the grant pass
        here makes admission joinable at iteration boundaries instead
        of request boundaries — and costs one short lock when nothing
        changed. Counted by `pipeedge_admission_step_grants_total`."""
        now = time.monotonic() if now is None else now
        to_wake: List[_Ticket] = []
        expired: List[_Ticket] = []
        with self._lock:
            if self._closed:
                return
            self._grant_locked(now, to_wake, expired)
        if to_wake:
            self.m_step_grants.inc(len(to_wake))
        for t in expired:
            self.m_shed.inc(**{"class": t.request_class,
                               "reason": "expired"})
            t.event.set()
        for t in to_wake:
            t.event.set()

    def _grant_locked(self, now: float, to_wake: List[_Ticket],
                      expired: List[_Ticket]) -> None:
        # in-queue entries whose deadline already passed are shed, not
        # granted: running them would only produce a mid-flight 504
        for t in self._queue.pop_expired(now):
            t.shed_reason = "expired"
            expired.append(t)
        while self._free > 0:
            nxt = self._queue.peek()
            if nxt is None:
                break
            t, _ = nxt
            if not self._tokens_ok_locked(t.tokens):
                # head-of-line under the token budget: the EDF head
                # stays IN PLACE (peek, not pop) waiting for token
                # releases — re-queueing would assign a fresh tie-break
                # seq and let same-deadline arrivals overtake it,
                # starving big-context requests under sustained small-
                # request load
                break
            self._queue.pop()          # the same head, under the lock
            self._free -= 1
            self._take_tokens_locked(t.tokens)
            t.granted = True
            to_wake.append(t)
        self.m_queue_depth.set(len(self._queue))

    # -- introspection / lifecycle ---------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self.concurrency - self._free

    def snapshot(self) -> dict:
        """Best-effort state for /healthz's `serving` block (and the
        admission slice of a postmortem bundle: `waiting` names the
        queued request ids in grant order)."""
        with self._lock:
            depth = len(self._queue)
            in_flight = self.concurrency - self._free
            waiting = [{"rid": t.rid, "class": t.request_class}
                       for t in self._queue.items()]
        rate = self.estimator.rate()
        out = {"queue_depth": depth, "in_flight": in_flight,
               "concurrency": self.concurrency,
               "queue_capacity": self._queue.capacity,
               "shed_classes": sorted(self._shed_classes),
               "waiting": waiting,
               "service_rate_rps": (None if rate is None
                                    else round(rate, 3)),
               "shed_total": int(self.m_shed.total())}
        if self.token_budget is not None:
            with self._lock:
                out["token_budget"] = self.token_budget
                out["tokens_free"] = self._tokens_free
        return out

    def close(self) -> None:
        """Shed every waiter (shutdown) and refuse new admissions."""
        waiters: List[_Ticket] = []
        with self._lock:
            self._closed = True
            while True:
                nxt = self._queue.pop()
                if nxt is None:
                    break
                t, _ = nxt
                t.shed_reason = "shutdown"
                waiters.append(t)
            self.m_queue_depth.set(0)
        for t in waiters:
            self.m_shed.inc(**{"class": t.request_class,
                               "reason": "shutdown"})
            t.event.set()
