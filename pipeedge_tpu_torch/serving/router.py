"""Front-end router for a fleet of decode replicas.

The port's copy of `pipeedge_tpu/serving/router.py` (pure Python: it
loads no model and never touches a card; it imports only the port's
telemetry, metrics and lock factory). One decode process is a single
point of failure: a replica crash loses every in-flight session. The
router keeps serving through any single replica failure:

- **ReplicaRegistry**: the routing table. Each replica carries an EWMA
  degradation score fed by `/healthz` polls (a failed poll is instant
  degradation 1.0, a slow one degrades linearly up to `latency_bad_s`)
  and walks healthy -> suspect -> dead with hysteresis
  (`suspect_threshold` > `readmit_threshold`), plus the administrative
  `drained` state. `fail_dead` consecutive poll failures convict
  outright, and a respawned replica readmits after `readmit`
  consecutive clean polls.
- **Prefix-aware routing**: `pick()` sends a prompt to the replica whose
  prefix trie already holds its leading pages (a sticky affinity map
  keyed on the prompt's leading tokens), falling back to
  least-in-flight. Affinity entries follow their pages when a drain
  migrates them (`reassign_affinity`).
- **DecodeRouter**: the proxy. Per-request timeout, bounded
  retry-with-backoff to a DIFFERENT replica on connection failure
  (convicting the failed replica at once), optional tail hedging for the
  interactive class, and mid-STREAM failover: a replica dying under a
  streaming request re-dispatches the whole request to a survivor and
  suppresses the step lines the client already saw (decode is
  deterministic on pinned seeds, so the continuation is token-identical).
  A graceful drain ships the drained replica's warm prefix pages to a
  survivor as `kv/ship.py` frames (`/kv/export` -> `/kv/import`), then
  detaches.

The registry is pure logic under one lock (testable without sockets);
all I/O (health polls, proxied requests, drain migration) happens
outside the lock on snapshots.
"""
from __future__ import annotations

import base64
import inspect
import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .. import telemetry
from ..telemetry import metrics as prom
from ..utils.threads import make_lock

logger = logging.getLogger(__name__)

REPLICA_HEALTHY = "healthy"
REPLICA_SUSPECT = "suspect"
REPLICA_DRAINED = "drained"
REPLICA_DEAD = "dead"

# numeric codes for the per-replica state gauge
STATE_CODES = {REPLICA_HEALTHY: 0, REPLICA_SUSPECT: 1,
               REPLICA_DRAINED: 2, REPLICA_DEAD: 3}

ROUTE_OUTCOMES = ("ok", "shed", "deadline", "error", "no_replica")

# Hop-propagation headers (the fleet observatory).
# The router mints the request id and carries it to the replica on
# RID_HEADER (per-attempt derived rids: `rid.tN` retries, `rid.hedge`
# hedge branch, `rid.foN` mid-stream failover replays) plus the hop
# index on HOP_HEADER; responses echo RID_HEADER (the BASE rid — the
# root of the derivation tree) and REPLICA_HEADER (which replica
# actually served) so a client complaint cross-references straight to
# a postmortem bundle without body parsing.
RID_HEADER = "X-PipeEdge-Rid"
HOP_HEADER = "X-PipeEdge-Hop"
REPLICA_HEADER = "X-PipeEdge-Replica"

# /metrics plane. Per-replica label matrices are pre-declared in
# `ReplicaRegistry.add`, when the fleet membership is known (PL501);
# the fixed-domain matrices are declared right here.
_M_REQUESTS = prom.REGISTRY.counter(
    "pipeedge_router_requests_total",
    "requests through the router, by terminal outcome")
_M_FAILOVERS = prom.REGISTRY.counter(
    "pipeedge_router_failovers_total",
    "requests re-dispatched to a different replica after a replica "
    "failure (connection error or mid-stream death)")
_M_RETRIES = prom.REGISTRY.counter(
    "pipeedge_router_retries_total",
    "route retries, by reason (connect = replica unreachable, "
    "shed = replica 503, try another)")
_M_HEDGES = prom.REGISTRY.counter(
    "pipeedge_router_hedges_total",
    "tail hedges fired, by which branch won")
_M_DRAINS = prom.REGISTRY.counter(
    "pipeedge_router_drains_total",
    "graceful replica drains orchestrated")
_M_MIGRATED = prom.REGISTRY.counter(
    "pipeedge_router_migrated_prefixes_total",
    "warm prefixes shipped replica-to-replica during drains "
    "(kv/ship.py codec)")
_M_STATE = prom.REGISTRY.gauge(
    "pipeedge_router_replica_state",
    "replica lifecycle state (0 healthy, 1 suspect, 2 drained, 3 dead)")
_M_SCORE = prom.REGISTRY.gauge(
    "pipeedge_router_replica_score",
    "EWMA health-poll degradation score per replica "
    "(0 = healthy, 1 = fully degraded)")
_M_INFLIGHT = prom.REGISTRY.gauge(
    "pipeedge_router_replica_inflight",
    "requests currently proxied to each replica")
for _o in ROUTE_OUTCOMES:
    _M_REQUESTS.declare(outcome=_o)
for _r in ("connect", "shed"):
    _M_RETRIES.declare(reason=_r)
for _w in ("primary", "hedge"):
    _M_HEDGES.declare(winner=_w)
_M_FAILOVERS.declare()
_M_DRAINS.declare()
_M_MIGRATED.declare()


class NoReplicaAvailable(RuntimeError):
    """Every replica is dead, drained, or already tried — the router's
    own shed (503 + Retry-After, PL403)."""

    def __init__(self, detail: str, retry_after: float = 1.0):
        super().__init__(detail)
        self.retry_after = float(retry_after)


class RouterPolicy:
    """The router's knobs. The health-score half mirrors
    `health/scorer.py`'s HealthPolicy (same hysteresis contract:
    `suspect_threshold` > `readmit_threshold`, scores between them
    change nothing); the routing half bounds how much work one request
    may cause (`route_retries` re-dispatches, exponential backoff)."""

    def __init__(self,
                 poll_interval_s: float = 0.5,
                 health_timeout_s: float = 2.0,
                 alpha: float = 0.5,
                 suspect_threshold: float = 0.4,
                 readmit_threshold: float = 0.2,
                 readmit: int = 2,
                 fail_dead: int = 3,
                 latency_bad_s: float = 1.0,
                 request_timeout_s: float = 120.0,
                 route_retries: int = 2,
                 backoff_s: float = 0.25,
                 backoff_max_s: float = 2.0,
                 hedge_ms: float = 0.0,
                 affinity_tokens: int = 32,
                 affinity_capacity: int = 512,
                 drain_timeout_s: float = 60.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 < readmit_threshold < suspect_threshold <= 1.0:
            raise ValueError(
                "need 0 < readmit_threshold < suspect_threshold <= 1, "
                f"got {readmit_threshold} / {suspect_threshold}")
        if readmit < 1 or fail_dead < 1:
            raise ValueError("readmit/fail_dead must be >= 1")
        if route_retries < 0:
            raise ValueError("route_retries must be >= 0")
        if latency_bad_s <= 0 or poll_interval_s <= 0:
            raise ValueError("latency_bad_s/poll_interval_s must be > 0")
        if hedge_ms < 0:
            raise ValueError("hedge_ms must be >= 0")
        self.poll_interval_s = float(poll_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.alpha = float(alpha)
        self.suspect_threshold = float(suspect_threshold)
        self.readmit_threshold = float(readmit_threshold)
        self.readmit = int(readmit)
        self.fail_dead = int(fail_dead)
        self.latency_bad_s = float(latency_bad_s)
        self.request_timeout_s = float(request_timeout_s)
        self.route_retries = int(route_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hedge_ms = float(hedge_ms)
        self.affinity_tokens = int(affinity_tokens)
        self.affinity_capacity = int(affinity_capacity)
        self.drain_timeout_s = float(drain_timeout_s)


class _Replica:
    """One replica's registry record (internal; guarded by the
    registry lock)."""

    __slots__ = ("name", "url", "state", "score", "fail_streak",
                 "ok_streak", "in_flight", "last_ok", "epoch")

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url
        self.state = REPLICA_HEALTHY
        self.score = 0.0
        self.fail_streak = 0     # consecutive failed polls
        self.ok_streak = 0       # consecutive clean polls toward readmit
        self.in_flight = 0
        self.last_ok = 0.0       # monotonic stamp of the last OK poll
        self.epoch = 0           # supervisor respawn incarnation


class ReplicaRegistry:
    """The routing table: replica lifecycle + prefix-affinity scoring.

    Pure logic under one lock — `observe()` folds one health poll,
    `pick()` chooses a route — so the whole decision matrix is
    unit-testable without a socket in sight (the router tests)."""

    def __init__(self, policy: Optional[RouterPolicy] = None):
        self.policy = policy or RouterPolicy()
        self._lock = make_lock("router.registry")
        self._replicas: Dict[str, _Replica] = {}
        # leading-token key -> replica name, LRU-bounded: the sticky
        # prefix-affinity map (shared: traffic keeps hitting the
        # replica whose trie holds the pages)
        self._affinity: "OrderedDict[Tuple[int, ...], str]" = OrderedDict()
        self.transitions: List[Tuple[str, str, str, str]] = []

    # -- membership -------------------------------------------------------

    def add(self, name: str, url: str,
            state: str = REPLICA_HEALTHY) -> None:
        """Register a replica. `state` is the entry state: the
        autoscaler adds a freshly spawned replica as REPLICA_SUSPECT so
        it is warm-up gated — `pick()` never prefers it over a healthy
        replica, and it only earns traffic through the same `readmit`
        consecutive-clean-poll confirmation a recovered replica does."""
        if state not in STATE_CODES:
            raise ValueError(f"unknown replica state {state!r}")
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            r = _Replica(name, url)
            r.state = state
            self._replicas[name] = r
            # PL501: this replica's label matrix exists from this instant
            _M_STATE.set(float(STATE_CODES[state]), replica=name)
            _M_SCORE.set(0.0, replica=name)
            _M_INFLIGHT.set(0.0, replica=name)
            if state != REPLICA_HEALTHY:
                self.transitions.append((name, "new", state, "added"))

    def remove(self, name: str) -> None:
        """Deregister a replica (autoscale scale-down, after its drain
        + migration completed). Its affinity entries must already have
        been reassigned; any stragglers are dropped so `pick()` never
        resolves to a ghost."""
        with self._lock:
            r = self._replicas.pop(name, None)
            if r is None:
                return
            for key in [k for k, v in self._affinity.items() if v == name]:
                del self._affinity[key]
            self.transitions.append((name, r.state, "removed", "scale-in"))
            # park the gauges at the dead code: the label matrix stays
            # declared (PL501) but reads as not-serving
            _M_STATE.set(float(STATE_CODES[REPLICA_DEAD]), replica=name)
            _M_INFLIGHT.set(0.0, replica=name)
        logger.info("replica %s: %s -> removed (scale-in)", name, r.state)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def url_of(self, name: str) -> str:
        with self._lock:
            return self._replicas[name].url

    def state_of(self, name: str) -> str:
        with self._lock:
            return self._replicas[name].state

    def score_of(self, name: str) -> float:
        with self._lock:
            return self._replicas[name].score

    # -- lifecycle --------------------------------------------------------

    def _move(self, r: _Replica, to: str, reason: str) -> str:
        frm = r.state
        r.state = to
        r.ok_streak = 0
        self.transitions.append((r.name, frm, to, reason))
        _M_STATE.set(float(STATE_CODES[to]), replica=r.name)
        logger.info("replica %s: %s -> %s (%s)", r.name, frm, to, reason)
        return to

    def observe(self, name: str, ok: bool,
                latency_s: Optional[float] = None,
                epoch: Optional[int] = None) -> Optional[str]:
        """Fold one health poll; returns the state transitioned TO, if
        this poll fired one. A failed poll is instant degradation 1.0; a
        clean one degrades linearly in its latency up to
        `latency_bad_s` (a replica that answers in 2x the anchor is as
        suspect as one that doesn't answer)."""
        pol = self.policy
        with self._lock:
            r = self._replicas[name]
            if epoch is not None:
                r.epoch = int(epoch)
            if ok:
                r.fail_streak = 0
                r.last_ok = time.monotonic()
                d = min(1.0, max(0.0, (latency_s or 0.0)
                                 / pol.latency_bad_s))
            else:
                r.fail_streak += 1
                d = 1.0
            r.score = (1.0 - pol.alpha) * r.score + pol.alpha * d
            _M_SCORE.set(r.score, replica=name)
            clean = ok and r.score <= pol.readmit_threshold
            r.ok_streak = r.ok_streak + 1 if clean else 0

            if not ok and r.fail_streak >= pol.fail_dead \
                    and r.state != REPLICA_DEAD:
                return self._move(r, REPLICA_DEAD,
                                  f"{r.fail_streak} consecutive poll "
                                  "failures")
            if r.state == REPLICA_HEALTHY:
                if r.score >= pol.suspect_threshold:
                    return self._move(r, REPLICA_SUSPECT,
                                      f"score {r.score:.3f} >= "
                                      f"{pol.suspect_threshold}")
                return None
            if r.state in (REPLICA_SUSPECT, REPLICA_DEAD):
                # hysteresis + confirmation: readmit needs `readmit`
                # consecutive clean polls BELOW the readmit threshold —
                # a score oscillating in the band changes nothing, and
                # a respawned process must prove itself before traffic
                if r.ok_streak >= pol.readmit:
                    return self._move(r, REPLICA_HEALTHY,
                                      f"{r.ok_streak} clean polls, score "
                                      f"{r.score:.3f}")
                return None
            return None     # drained: administrative, polls don't exit it

    def mark_failed(self, name: str) -> None:
        """Request-path hard failure (connection refused/reset): convict
        NOW — the poll loop would take `fail_dead` more windows to
        notice, and every routed request in between would fail too."""
        with self._lock:
            r = self._replicas[name]
            r.score = 1.0
            _M_SCORE.set(1.0, replica=name)
            if r.state != REPLICA_DEAD:
                self._move(r, REPLICA_DEAD, "request connection failure")

    def drain(self, name: str) -> bool:
        """Administratively stop routing to `name` (planned
        maintenance). Returns False when the replica is already dead —
        there is nothing graceful left to do."""
        with self._lock:
            r = self._replicas[name]
            if r.state == REPLICA_DEAD:
                return False
            if r.state != REPLICA_DRAINED:
                self._move(r, REPLICA_DRAINED, "drain requested")
            return True

    def undrain(self, name: str) -> None:
        """Lift a drain on a still-running external replica (supervised
        drains end in a respawn instead, which readmits via observe)."""
        with self._lock:
            r = self._replicas[name]
            if r.state == REPLICA_DRAINED:
                self._move(r, REPLICA_SUSPECT, "drain lifted; reproving")

    # -- routing ----------------------------------------------------------

    def _affinity_key(self, tokens: Sequence[int]) \
            -> Optional[Tuple[int, ...]]:
        if not tokens:
            return None
        return tuple(int(t) for t in
                     tokens[:self.policy.affinity_tokens])

    def pick(self, tokens: Optional[Sequence[int]] = None,
             exclude: Iterable[str] = ()) -> Optional[str]:
        """Choose a route: the prompt's affinity owner when it is
        routable, else the least-loaded routable replica (healthy
        first; suspect replicas only when no healthy one exists —
        degraded-but-alive beats shedding). Learns the affinity of a
        fresh prefix on the way out."""
        shut = set(exclude)
        with self._lock:
            healthy = [r for r in self._replicas.values()
                       if r.state == REPLICA_HEALTHY and r.name not in shut]
            pool = healthy or [
                r for r in self._replicas.values()
                if r.state == REPLICA_SUSPECT and r.name not in shut]
            if not pool:
                return None
            key = self._affinity_key(tokens) if tokens is not None else None
            if key is not None:
                owner = self._affinity.get(key)
                if owner is not None and any(r.name == owner
                                             for r in pool):
                    self._affinity.move_to_end(key)
                    return owner
            choice = min(pool, key=lambda r: (r.in_flight, r.name))
            if key is not None:
                self._affinity[key] = choice.name
                self._affinity.move_to_end(key)
                while len(self._affinity) > self.policy.affinity_capacity:
                    self._affinity.popitem(last=False)
            return choice.name

    def has_routable(self, exclude: Iterable[str] = ()) -> bool:
        """Whether `pick(exclude=...)` has a replica to choose (a healthy
        or suspect one outside `exclude`), without choosing it."""
        shut = set(exclude)
        with self._lock:
            return any(r.state in (REPLICA_HEALTHY, REPLICA_SUSPECT)
                       and r.name not in shut
                       for r in self._replicas.values())

    def affinity_owner(self, tokens: Sequence[int]) -> Optional[str]:
        key = self._affinity_key(tokens)
        with self._lock:
            return self._affinity.get(key) if key is not None else None

    def affinity_keys_of(self, name: str) -> List[Tuple[int, ...]]:
        """Every affinity key currently routed to `name` (the drain
        migration's work list — these prompts' pages are warm there)."""
        with self._lock:
            return [k for k, v in self._affinity.items() if v == name]

    def reassign_affinity(self, frm: str, to: str) -> int:
        """Point `frm`'s affinity entries at `to` (their pages just
        migrated there, or `frm` died and `to` will re-prefill them)."""
        with self._lock:
            moved = 0
            for k, v in self._affinity.items():
                if v == frm:
                    self._affinity[k] = to
                    moved += 1
            return moved

    def note_route(self, name: str) -> None:
        with self._lock:
            r = self._replicas[name]
            r.in_flight += 1
            _M_INFLIGHT.set(float(r.in_flight), replica=name)

    def done(self, name: str) -> None:
        with self._lock:
            r = self._replicas[name]
            r.in_flight = max(0, r.in_flight - 1)
            _M_INFLIGHT.set(float(r.in_flight), replica=name)

    def snapshot(self) -> Dict[str, dict]:
        """Per-replica state for the router's /healthz fleet block."""
        now = time.monotonic()
        with self._lock:
            return {r.name: {
                "url": r.url,
                "state": r.state,
                "score": round(r.score, 4),
                "in_flight": r.in_flight,
                "epoch": r.epoch,
                "fail_streak": r.fail_streak,
                "last_ok_age_s": (round(now - r.last_ok, 3)
                                  if r.last_ok else None),
            } for r in self._replicas.values()}


# -- HTTP plumbing (injectable for tests) ---------------------------------

def http_post_json(url: str, path: str, payload: dict,
                   timeout: float,
                   headers: Optional[Dict[str, str]] = None) \
        -> Tuple[int, dict, List[Tuple[str, str]]]:
    """POST one JSON body; returns (status, body, passthrough headers).
    HTTP error statuses are RETURNED (they are answers — a 503 shed
    must flow back to the client with its Retry-After); transport
    failures raise OSError for the caller's failover logic. `headers`
    adds per-request headers (the rid/hop propagation pair)."""
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(payload).encode(),
        headers=hdrs, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read() or b"{}")
            return resp.status, body, _passthrough(resp.headers)
    except urllib.error.HTTPError as exc:
        body = json.loads(exc.read() or b"{}")
        return exc.code, body, _passthrough(exc.headers)


def http_get_json(url: str, path: str, timeout: float) -> Tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"{url}{path}",
                                    timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _passthrough(headers) -> List[Tuple[str, str]]:
    out = []
    if headers is None:
        return out
    for h in ("Retry-After", RID_HEADER, REPLICA_HEADER):
        v = headers.get(h)
        if v is not None:
            out.append((h, v))
    return out


def _with_identity(headers: Iterable[Tuple[str, str]], rid: Optional[str],
                   replica: Optional[str]) -> List[Tuple[str, str]]:
    """Make the router authoritative for the identity echo: drop any
    replica-echoed rid/replica headers and append the BASE rid plus the
    replica that actually served (None skips that header)."""
    out = [(h, v) for h, v in headers
           if h not in (RID_HEADER, REPLICA_HEADER)]
    if rid is not None:
        out.append((RID_HEADER, rid))
    if replica is not None:
        out.append((REPLICA_HEADER, replica))
    return out


def _adapt_post_fn(fn: Callable) -> Callable:
    """Tolerate injected post fns written against the pre-observatory
    4-arg signature (url, path, payload, timeout): drop the `headers`
    kwarg when the fn cannot take it."""
    try:
        sig = inspect.signature(fn)
        takes_headers = any(
            p.name == "headers" or p.kind == p.VAR_KEYWORD
            for p in sig.parameters.values())
    except (TypeError, ValueError):      # builtins/C callables: assume new
        takes_headers = True
    if takes_headers:
        return fn

    def adapted(url, path, payload, timeout, headers=None):
        return fn(url, path, payload, timeout)
    return adapted


class _ReplicaStreamError(RuntimeError):
    """A replica surfaced a terminal {"error": ...} line mid-stream
    (its executor died under the request) — failover-eligible, but not
    a transport conviction."""


class DecodeRouter:
    """The proxy: routes, retries, hedges, fails over, drains.

    `post_fn`/`get_fn`/`stream_fn` are injectable so the decision logic
    tests without sockets; production uses the urllib defaults."""

    def __init__(self, replicas: Dict[str, str],
                 policy: Optional[RouterPolicy] = None,
                 supervisor=None,
                 post_fn: Optional[Callable] = None,
                 get_fn: Optional[Callable] = None):
        self.policy = policy or RouterPolicy()
        self.registry = ReplicaRegistry(self.policy)
        self.supervisor = supervisor
        self._post = (_adapt_post_fn(post_fn) if post_fn is not None
                      else http_post_json)
        self._get = get_fn or http_get_json
        # rid mint: the router is the root of every request's rid tree
        self._rid_lock = make_lock("router.rids")
        self._next_rid = 0
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        # replica-name -> supervisor rank (supervised fleets only):
        # lets a drain end in a respawn and the poll loop surface epochs
        self._ranks: Dict[str, int] = {}
        # router-side prefix registrations: router prefix id ->
        # {"tokens": [...], "replicas": {name: replica_prefix_id}}
        self._prefix_lock = make_lock("router.prefixes")
        self._prefixes: Dict[str, dict] = {}
        self._next_prefix = 0
        # latest raw /healthz body per replica (fleet block passthrough)
        self._health_lock = make_lock("router.health_cache")
        self._health: Dict[str, dict] = {}
        for name, url in replicas.items():
            self.registry.add(name, url)

    def bind_rank(self, name: str, rank: int) -> None:
        self._ranks[name] = int(rank)

    def mint_rid(self) -> str:
        """Router-minted request ids (`R<n>`): the root of the
        derivation tree `rid[.tN|.hedge|.foN]*` — distinct from the
        replica-local `q<n>` mint, which now only fires for direct
        (unrouted) requests."""
        with self._rid_lock:
            n = self._next_rid
            self._next_rid += 1
        return f"R{n}"

    @staticmethod
    def _clean_rid(raw: Optional[str]) -> Optional[str]:
        """Accept a caller-supplied rid if it is sane (printable,
        bounded — it lands in headers, logs, and span rings)."""
        if not raw or not isinstance(raw, str):
            return None
        rid = raw.strip()
        if not rid or len(rid) > 128 or not rid.isprintable():
            return None
        return rid

    # -- health poll loop -------------------------------------------------

    def start(self) -> None:
        self._poller = threading.Thread(target=self._poll_loop,
                                        daemon=True, name="router-poll")
        self._poller.start()

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5)

    def _poll_once(self) -> None:
        pol = self.policy
        sup_snap = self.supervisor.snapshot() if self.supervisor else {}
        for name, rec in self.registry.snapshot().items():
            t0 = time.monotonic()
            try:
                status, body = self._get(rec["url"], "/healthz",
                                         pol.health_timeout_s)
                ok = status == 200 and bool(body.get("ok", False))
            except (OSError, ValueError):
                ok, body = False, None
            latency = time.monotonic() - t0
            epoch = None
            rank = self._ranks.get(name)
            if rank is not None and str(rank) in sup_snap:
                epoch = sup_snap[str(rank)]["epoch"]
            self.registry.observe(name, ok, latency_s=latency,
                                  epoch=epoch)
            if body is not None:
                with self._health_lock:
                    self._health[name] = body

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.policy.poll_interval_s):
            with telemetry.span("router", "health_poll"):
                self._poll_once()

    # -- /healthz ---------------------------------------------------------

    def healthz(self) -> Tuple[int, dict]:
        fleet = self.registry.snapshot()
        with self._health_lock:
            for name, rec in fleet.items():
                body = self._health.get(name)
                if body is not None:
                    rec["draining"] = bool(body.get("draining", False))
                    rec["active"] = (body.get("stats") or {}).get(
                        "active")
        routable = any(rec["state"] in (REPLICA_HEALTHY, REPLICA_SUSPECT)
                       for rec in fleet.values())
        out = {"ok": routable, "role": "router", "fleet": fleet}
        if self.supervisor is not None:
            out["workers"] = self.supervisor.snapshot()
        return (200 if routable else 503), out

    def health_snapshot(self) -> Dict[str, dict]:
        """Copy of the latest raw /healthz body per replica — the fleet
        collector mines it for nested scrape targets (prefill-worker
        observability URLs a replica reports under
        serving.kv.prefill.workers)."""
        with self._health_lock:
            return dict(self._health)

    def scrape_targets(self) -> Dict[str, str]:
        """The fleet collector's CURRENT target set: every registered
        replica, plus any prefill-worker observability endpoints the
        replicas report in their health bodies."""
        targets = {name: rec["url"]
                   for name, rec in self.registry.snapshot().items()}
        for name, body in self.health_snapshot().items():
            workers = ((((body.get("serving") or {}).get("kv") or {})
                        .get("prefill") or {}).get("workers") or {})
            if not isinstance(workers, dict):
                continue
            for rank, rec in workers.items():
                url = (rec or {}).get("http_url")
                if url:
                    targets[f"{name}.pf{rank}"] = url
        return targets

    # -- the routed request path ------------------------------------------

    @staticmethod
    def _route_tokens(payload: dict) -> Optional[List[int]]:
        ids = payload.get("ids")
        if not ids:
            return None
        row = ids[0] if isinstance(ids[0], list) else ids
        return row if row and all(isinstance(t, int) for t in row) \
            else None

    def _prepare(self, name: str, payload: dict) -> dict:
        """Per-attempt payload rewrite: a router-level prefix_id becomes
        the TARGET replica's prefix id (registered there lazily — and
        re-registered on the failover target when the first choice
        died)."""
        rp = payload.get("prefix_id")
        if rp is None:
            return payload
        with self._prefix_lock:
            entry = self._prefixes.get(rp)
        if entry is None:
            # not ours: pass through (a raw replica id still works on
            # a single-replica fleet; anything else 400s at the replica)
            return payload
        replica_pid = entry["replicas"].get(name)
        if replica_pid is None:
            status, body, _ = self._post(
                self.registry.url_of(name), "/prefix",
                {"ids": entry["tokens"]}, self.policy.request_timeout_s)
            if status != 200:
                raise OSError(f"prefix registration on {name} failed "
                              f"({status}): {body.get('error')}")
            replica_pid = body["prefix_id"]
            with self._prefix_lock:
                entry["replicas"][name] = replica_pid
        out = dict(payload)
        out["prefix_id"] = replica_pid
        return out

    def register_prefix(self, ids: Sequence[int]) -> Tuple[str, int]:
        """Router-level /prefix: remember the tokens; replicas get the
        registration lazily at first routed use (and again on
        failover targets)."""
        tokens = [int(t) for t in ids]
        with self._prefix_lock:
            pid = f"rp{self._next_prefix}"
            self._next_prefix += 1
            self._prefixes[pid] = {"tokens": tokens, "replicas": {}}
        return pid, len(tokens)

    def _prefix_tokens(self, payload: dict) -> Optional[List[int]]:
        rp = payload.get("prefix_id")
        if rp is not None:
            with self._prefix_lock:
                entry = self._prefixes.get(rp)
            if entry is not None:
                return list(entry["tokens"])
        return self._route_tokens(payload)

    def dispatch(self, payload: dict, path: str = "/generate") \
            -> Tuple[int, dict, List[Tuple[str, str]]]:
        """Route one non-streaming request: bounded
        retry-with-backoff to a DIFFERENT replica on transport failure
        (the failed one is convicted immediately), one shed-retry hop
        on a replica 503 (another replica may have capacity). Terminal
        outcomes land in pipeedge_router_requests_total."""
        rid = self._clean_rid(payload.get("rid")) or self.mint_rid()
        if self.policy.hedge_ms > 0 \
                and payload.get("class", "interactive") == "interactive" \
                and not payload.get("stream"):
            return self._dispatch_hedged(payload, path, rid=rid)
        return self._dispatch_plain(payload, path, exclude=(), rid=rid)

    def _dispatch_plain(self, payload: dict, path: str,
                        exclude: Iterable[str],
                        rid: Optional[str] = None) \
            -> Tuple[int, dict, List[Tuple[str, str]]]:
        pol = self.policy
        rid = rid or self._clean_rid(payload.get("rid")) or self.mint_rid()
        tokens = self._prefix_tokens(payload)
        tried = list(exclude)
        backoff = pol.backoff_s
        retries_left = pol.route_retries
        attempt = 0
        while True:
            name = self.registry.pick(tokens, exclude=tried)
            if name is None:
                _M_REQUESTS.inc(outcome="no_replica")
                return 503, {"error": "no routable replica",
                             "no_replica": True}, \
                    _with_identity([("Retry-After", "1")], rid, None)
            # attempt 0 rides the base rid; every re-dispatch derives a
            # child (`rid.tN`) so the logical request stays one tree
            arid = rid if attempt == 0 else f"{rid}.t{attempt}"
            self.registry.note_route(name)
            try:
                body = self._prepare(name, payload)
                if "rid" in body:
                    body = {k: v for k, v in body.items() if k != "rid"}
                with telemetry.span("router", f"dispatch:{name}",
                                    rid=arid):
                    status, out, headers = self._post(
                        self.registry.url_of(name), path, body,
                        pol.request_timeout_s,
                        headers={RID_HEADER: arid,
                                 HOP_HEADER: str(attempt)})
            except OSError as exc:
                self.registry.mark_failed(name)
                tried.append(name)
                if retries_left <= 0:
                    _M_REQUESTS.inc(outcome="error")
                    return 503, {"error": f"replica {name} unreachable "
                                          f"({exc}); retries exhausted"}, \
                        _with_identity([("Retry-After", "1")], rid, None)
                retries_left -= 1
                attempt += 1
                _M_RETRIES.inc(reason="connect")
                _M_FAILOVERS.inc()
                time.sleep(backoff)
                backoff = min(backoff * 2, pol.backoff_max_s)
                continue
            finally:
                self.registry.done(name)
            if status == 503 and retries_left > 0 \
                    and self.registry.has_routable(tried + [name]):
                # shed here does not mean shed everywhere: spend one
                # retry on a different routable replica before surfacing
                # it (a dead or drained one would turn the shed into
                # "no routable replica")
                tried.append(name)
                retries_left -= 1
                attempt += 1
                _M_RETRIES.inc(reason="shed")
                continue
            _M_REQUESTS.inc(outcome=self._outcome(status, out))
            headers = _with_identity(headers, rid, name)
            if status == 503 and not any(h == "Retry-After"
                                         for h, _ in headers):
                headers = list(headers) + [("Retry-After", "1")]
            return status, out, headers

    @staticmethod
    def _outcome(status: int, body: dict) -> str:
        if status == 200:
            return "ok"
        if status == 503:
            return "shed"
        if status == 504:
            return "deadline"
        return "error"

    def _dispatch_hedged(self, payload: dict, path: str,
                         rid: Optional[str] = None) \
            -> Tuple[int, dict, List[Tuple[str, str]]]:
        """Tail hedging for the interactive class: if the primary has
        not answered within `hedge_ms`, duplicate the request to a
        second replica and take whichever answers first — decode is
        deterministic, so either answer is THE answer. The hedge branch
        rides the derived rid `rid.hedge` (its own retries nest:
        `rid.hedge.t1`)."""
        rid = rid or self._clean_rid(payload.get("rid")) or self.mint_rid()
        tokens = self._prefix_tokens(payload)
        primary = self.registry.pick(tokens)
        if primary is None:
            _M_REQUESTS.inc(outcome="no_replica")
            return 503, {"error": "no routable replica",
                         "no_replica": True}, \
                _with_identity([("Retry-After", "1")], rid, None)
        results: "queue.Queue" = queue.Queue()

        def run(branch: str, exclude: Iterable[str]) -> None:
            brid = rid if branch == "primary" else f"{rid}.hedge"
            try:
                results.put((branch,
                             self._dispatch_plain(payload, path, exclude,
                                                  rid=brid)))
            except BaseException as exc:   # noqa: BLE001 — joined below
                results.put((branch, exc))

        t1 = threading.Thread(target=run, args=("primary", ()),
                              daemon=True, name="router-hedge-primary")
        t1.start()
        try:
            branch, result = results.get(
                timeout=self.policy.hedge_ms / 1e3)
        except queue.Empty:
            hedge_target = self.registry.pick(tokens, exclude=[primary])
            if hedge_target is not None:
                t2 = threading.Thread(target=run,
                                      args=("hedge", [primary]),
                                      daemon=True,
                                      name="router-hedge-secondary")
                t2.start()
            branch, result = results.get()
            _M_HEDGES.inc(winner=branch)
        if isinstance(result, BaseException):
            raise result
        status, out, headers = result
        # whichever branch won, the client is told the BASE rid — the
        # resolvable root of the whole hedge tree
        served = next((v for h, v in headers if h == REPLICA_HEADER),
                      None)
        return status, out, _with_identity(headers, rid, served)

    def stream(self, payload: dict):
        """Route one STREAMING request; yields ("status", code,
        headers) first, then ("line", obj) x-ndjson lines. Mid-stream
        replica death re-dispatches the whole request to a survivor
        and suppresses the first `emitted` step lines — deterministic
        decode makes the continuation token-identical (the re-prefill
        recovery path; a drained replica's pages migrate instead).

        Rid derivation: the first dispatch rides the base rid, each
        failover replay derives `rid.foN`, each shed-retry hop
        `rid.tN`. The 200 status (with X-PipeEdge-Rid/-Replica
        headers) is held until the first line actually reaches the
        client, so a pre-first-byte failover names the SURVIVOR in the
        response headers; once streaming has begun the terminal line
        carries `replica` instead (headers are already on the wire)."""
        pol = self.policy
        rid = self._clean_rid(payload.get("rid")) or self.mint_rid()
        tokens = self._prefix_tokens(payload)
        tried: List[str] = []
        emitted = 0
        started = False     # 200 headers already yielded to the client
        retries_left = pol.route_retries
        backoff = pol.backoff_s
        failovers = 0
        shed_hops = 0
        while True:
            name = self.registry.pick(tokens, exclude=tried)
            if name is None:
                _M_REQUESTS.inc(outcome="no_replica")
                if not started:
                    yield ("status", 503,
                           _with_identity([("Retry-After", "1")], rid,
                                          None))
                yield ("line", {"error": "no routable replica",
                                "no_replica": True, "rid": rid})
                return
            if failovers == 0 and shed_hops == 0:
                arid = rid
            elif failovers > 0:
                arid = f"{rid}.fo{failovers}"
            else:
                arid = f"{rid}.t{shed_hops}"
            self.registry.note_route(name)
            failure = None
            try:
                body = self._prepare(name, payload)
                if "rid" in body:
                    body = {k: v for k, v in body.items() if k != "rid"}
                skip = emitted
                terminal = False
                with telemetry.span("router", f"stream:{name}",
                                    rid=arid):
                    for kind, item in self._stream_from(
                            name, body, rid=arid,
                            hop=failovers + shed_hops):
                        if kind == "refusal":
                            code, headers, rbody = item
                            if code == 503 and retries_left > 0 \
                                    and self.registry.has_routable(
                                        tried + [name]):
                                # shed here != shed everywhere: spend a
                                # retry on a different replica first
                                failure = "shed"
                                break
                            if not started:
                                headers = _with_identity(headers, rid,
                                                         name)
                                if code == 503 and not any(
                                        h == "Retry-After"
                                        for h, _ in headers):
                                    headers = list(headers) + [
                                        ("Retry-After", "1")]
                                yield ("status", code, headers)
                                started = True
                            yield ("line", rbody)
                            _M_REQUESTS.inc(
                                outcome=self._outcome(code, rbody))
                            terminal = True
                            break
                        if kind == "ok":
                            # hold the 200 until the first line: a
                            # failover before first byte then names
                            # the survivor in the response headers
                            continue
                        obj = item
                        if "step" in obj:
                            if skip > 0:
                                # this replica is replaying a failed-
                                # over request from step 0: the client
                                # already has these tokens
                                skip -= 1
                                continue
                            emitted += 1
                            if not started:
                                yield ("status", 200,
                                       _with_identity([], rid, name))
                                started = True
                            yield ("line", obj)
                        elif "error" in obj:
                            raise _ReplicaStreamError(
                                str(obj.get("error")))
                        else:
                            # the terminal line: annotate who actually
                            # served and the base rid (replayed streams
                            # already sent headers naming the first
                            # replica)
                            obj = dict(obj)
                            obj["replica"] = name
                            # the BASE rid, not this leg's derived one:
                            # the client resolves the whole tree from it
                            obj["rid"] = rid
                            if not started:
                                yield ("status", 200,
                                       _with_identity([], rid, name))
                                started = True
                            yield ("line", obj)
                            _M_REQUESTS.inc(outcome="ok")
                            terminal = True
                            break
                if terminal:
                    return
                if failure is None:
                    # the iterator ended with no terminal line: the
                    # socket dropped mid-body (replica death)
                    raise OSError("stream truncated")
            except OSError:
                self.registry.mark_failed(name)
                failure = "connect"
            except _ReplicaStreamError:
                failure = "connect"
            finally:
                self.registry.done(name)
            tried.append(name)
            if retries_left <= 0:
                _M_REQUESTS.inc(outcome="error")
                if not started:
                    yield ("status", 503,
                           _with_identity([("Retry-After", "1")], rid,
                                          None))
                yield ("line", {"error": f"replica {name} failed; "
                                         "retries exhausted",
                                "rid": rid})
                return
            retries_left -= 1
            _M_RETRIES.inc(reason=failure)
            if failure == "connect":
                failovers += 1
                _M_FAILOVERS.inc()
            else:
                shed_hops += 1
            time.sleep(backoff)
            backoff = min(backoff * 2, pol.backoff_max_s)

    def _stream_from(self, name: str, payload: dict,
                     rid: Optional[str] = None, hop: int = 0):
        """One replica's streaming response: ("refusal", (code,
        headers, body)) for a pre-stream non-200 (shed/400 — complete
        and terminal), else ("ok", None) then ("line", obj) per
        x-ndjson line. Transport failures raise OSError into
        stream()'s failover arm. `rid`/`hop` propagate on the request
        headers (the per-attempt derived rid)."""
        url = self.registry.url_of(name)
        hdrs = {"Content-Type": "application/json"}
        if rid is not None:
            hdrs[RID_HEADER] = rid
            hdrs[HOP_HEADER] = str(hop)
        req = urllib.request.Request(
            f"{url}/generate", data=json.dumps(payload).encode(),
            headers=hdrs, method="POST")
        try:
            resp = urllib.request.urlopen(
                req, timeout=self.policy.request_timeout_s)
        except urllib.error.HTTPError as exc:
            try:
                body = json.loads(exc.read() or b"{}")
            except ValueError:
                body = {"error": f"replica {name} answered {exc.code}"}
            yield ("refusal", (exc.code, _passthrough(exc.headers),
                               body))
            return
        with resp:
            if resp.status != 200:
                yield ("refusal", (resp.status,
                                   _passthrough(resp.headers), {}))
                return
            yield ("ok", None)
            for raw in resp:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    yield ("line", json.loads(raw))
                except ValueError as exc:
                    raise OSError(f"malformed stream line from {name}: "
                                  f"{raw[:80]!r}") from exc

    # -- graceful drain + KV migration ------------------------------------

    def drain_replica(self, name: str, migrate: bool = True,
                      respawn: bool = True) -> dict:
        """Planned maintenance: stop routing to `name`, let its
        in-flight requests finish, ship its warm prefix pages to a
        survivor over the kv/ship.py codec, then detach (supervised
        replicas are restarted — the respawn readmits with epoch+1;
        external ones stay drained). `respawn=False` is the autoscale
        scale-in half: the drained replica is NOT restarted — the
        caller retires its supervisor rank and removes it from the
        registry once this returns."""
        pol = self.policy
        if not self.registry.drain(name):
            return {"drained": False, "error": f"replica {name} is dead"}
        _M_DRAINS.inc()
        with telemetry.span("router", f"drain:{name}"):
            url = self.registry.url_of(name)
            try:
                self._post(url, "/drain", {}, pol.request_timeout_s)
            except OSError:
                self.registry.mark_failed(name)
                return {"drained": False,
                        "error": f"replica {name} died during drain"}
            deadline = time.monotonic() + pol.drain_timeout_s
            while time.monotonic() < deadline:
                try:
                    _, body = self._get(url, "/healthz",
                                        pol.health_timeout_s)
                except (OSError, ValueError):
                    break
                active = (body.get("stats") or {}).get("active", 0)
                if not active:
                    break
                time.sleep(0.2)
            migrated = 0
            target = self.registry.pick()
            if migrate and target is not None:
                migrated = self._migrate_prefixes(name, target)
                self.registry.reassign_affinity(name, target)
            if respawn and self.supervisor is not None \
                    and name in self._ranks:
                self.supervisor.restart(self._ranks[name])
        return {"drained": True, "migrated_prefixes": migrated,
                "target": target}

    # -- autoscale membership actuators -----------------------------------

    def add_replica(self, name: str, url: str,
                    rank: Optional[int] = None) -> None:
        """Scale-out actuator: register a freshly spawned replica
        warm-up gated (REPLICA_SUSPECT — it earns traffic through the
        readmit confirmation, never before its first clean polls)."""
        self.registry.add(name, url, state=REPLICA_SUSPECT)
        if rank is not None:
            self.bind_rank(name, rank)

    def remove_replica(self, name: str) -> dict:
        """Scale-in actuator: graceful drain + KV-prefix migration,
        then deregister without respawn. Returns the drain result with
        `removed` set; a replica that dies mid-drain is still removed
        (it was leaving anyway — `mark_failed` already convicted it)."""
        out = self.drain_replica(name, migrate=True, respawn=False)
        self.registry.remove(name)
        with self._health_lock:
            self._health.pop(name, None)
        rank = self._ranks.pop(name, None)
        out["removed"] = True
        out["rank"] = rank
        return out

    def _migrate_prefixes(self, frm: str, to: str) -> int:
        """Ship `frm`'s warm prefixes to `to`: every router-registered
        prefix `frm` holds plus every affinity key routed there (the
        shared: workload's warm pages). Best-effort per prefix — a
        failed export falls back to re-prefill on first use."""
        pol = self.policy
        src, dst = self.registry.url_of(frm), self.registry.url_of(to)
        work: Dict[Tuple[int, ...], List[int]] = {}
        with self._prefix_lock:
            for entry in self._prefixes.values():
                if frm in entry["replicas"]:
                    work[tuple(entry["tokens"])] = list(entry["tokens"])
        for key in self.registry.affinity_keys_of(frm):
            work.setdefault(key, list(key))
        migrated = 0
        for tokens in work.values():
            try:
                status, body, _ = self._post(
                    src, "/kv/export", {"ids": tokens},
                    pol.request_timeout_s)
                if status != 200 or not body.get("pages"):
                    continue
                status, body, _ = self._post(
                    dst, "/kv/import",
                    {"ids": tokens, "blob": body["blob"]},
                    pol.request_timeout_s)
                if status == 200 and body.get("installed_pages", 0) >= 0:
                    migrated += 1
                    _M_MIGRATED.inc()
            except OSError as exc:
                logger.warning("prefix migration %s -> %s failed: %s",
                               frm, to, exc)
        return migrated


def encode_ship_blob(frames) -> str:
    """kv/ship.py tensor frames -> the JSON-safe base64 form the
    /kv/export|import endpoints carry."""
    from ..kv import ship
    return base64.b64encode(ship.frames_to_bytes(frames)).decode()


def decode_ship_blob(blob: str):
    from ..kv import ship
    return ship.frames_from_bytes(base64.b64decode(blob))
