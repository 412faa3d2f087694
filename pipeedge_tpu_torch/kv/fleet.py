"""Cross-process prefill fleet: leases, fault-tolerant KV shipping.

Port of `pipeedge_tpu/kv/fleet.py`, the same protocol frame for frame, so
a JAX worker serves a port fleet and a port worker serves a JAX fleet.
The in-process `PrefillFleet` (`kv/disagg.py`) runs both fleets in one
process; this module puts the prefill fleet in separate processes
(`python -m pipeedge_tpu_torch.prefill_worker` ranks over the port's DCN
sockets, `comm/dcn.py`) and makes the ship edge survive the faults the
chaos grammar throws at it:

- **Lease/ack protocol**: every prompt pass is tracked per request. The
  decode side (`RemotePrefillFleet.prefill`) registers a LEASE (lease id
  + attempt number + deadline), sends it to a live prefill rank, and
  waits; the worker (`PrefillWorkerLoop`) runs the prompt pass and acks
  with the ship bundle (`kv/ship.py` wire-v2 frames, CRC when armed). A
  lease not acked within its deadline is RE-DISPATCHED to a surviving
  rank.
- **Fault matrix**: ship timeout -> re-dispatch; CRC failure on decode
  (`wire.WireCorruptError`) -> bounded re-ship (the prompt pass is
  deterministic, so a re-run IS a resend); prefill-peer death (stream
  error or missed heartbeats) -> in-flight leases on that rank resolve
  at once as failed and re-dispatch; every path exhausted ->
  `PrefillUnavailable`, which the serving layer turns into COLOCATED
  prefill (the decode executor runs the prompt pass itself, with the
  same tokens).
- **Zombie fencing**: acks carry (lease id, attempt). A late ack for a
  lease that was re-dispatched, completed or abandoned is dropped and
  counted, never installed. Below it sits the DCN epoch fence: frames
  from a dead incarnation never reach the reply queue.
- **Readmission**: a restarted worker comes back with `DCN_EPOCH` + 1
  and JOINs (`announce_join`); the fleet's rejoin handler puts the rank
  back in rotation (`serve.py --disaggregate process` respawns dead
  workers).

The protocol rides `send_tensors`/`recv_tensors` data frames on three
dedicated channels (below `comm/dcn.py`'s `CHANNEL_ROUND_PARITY`):

    decode -> worker  CH_LEASE   [lease_hdr, ids]
    decode -> worker  CH_CANCEL  [cancel_hdr]
    worker -> decode  CH_SHIP    [ack_hdr, *encode_kv_ship(...) frames]

`lease_hdr` = int64 [LEASE_MAGIC, lease_id, attempt, ship_bits, crc,
deadline_ms]; `ack_hdr` = int64 [ACK_MAGIC, lease_id, attempt, status].
CRC verification happens where the bytes are consumed (`decode_kv_ship`
verifies each stage frame's trailer), so a corrupt ship surfaces as a
typed error on the decode side.

On the card: the worker's prompt pass and its 8-bit ship encode (the
codec's encode kernel) run on its own card context; the decode side's
`decode_kv_ship(..., device=)` decodes on the decode process's card (the
codec's decode kernel at 8 bits), on the default stream the executors
install on.
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import DeviceLike, resolve_device, telemetry
from ..comm import wire
from ..telemetry import metrics as prom
from ..utils.threads import make_lock
from . import ship

logger = logging.getLogger(__name__)

# ship-plane data channels (comm/dcn.py CHANNEL_*: 0 data, 1 results,
# 2 feed, 3 bids are taken; base_channel folds mod 8, so these must
# stay below CHANNEL_ROUND_PARITY). Cancels ride their OWN channel:
# a cancel queued behind pending leases on CH_LEASE would arrive only
# after the stale lease it exists to stop had already run
CH_LEASE = 4
CH_SHIP = 5
CH_CANCEL = 6

LEASE_MAGIC = -11
ACK_MAGIC = -12
CANCEL_MAGIC = -13
ACK_OK = 0
ACK_ERROR = 1

# lease outcomes the per-fleet counter tracks (pre-declared, PL501)
LEASE_OUTCOMES = ("shipped", "redispatched", "corrupt_retry", "fallback")


class PrefillUnavailable(RuntimeError):
    """No prefill rank could complete this prompt pass (every live rank
    timed out, died, or shipped corrupt frames past the retry budget —
    or none is live at all). The serving layer degrades the request to
    COLOCATED prefill: the decode executor runs the prompt pass itself,
    so the request survives with identical tokens, paying only the p99
    isolation the split existed to buy."""


def lease_header(lease_id: int, attempt: int, ship_bits: int,
                 crc: bool, deadline_ms: float) -> np.ndarray:
    return np.asarray([LEASE_MAGIC, int(lease_id), int(attempt),
                       int(ship_bits), int(bool(crc)),
                       int(max(0, deadline_ms))], np.int64)


def parse_lease_header(t) -> dict:
    hdr = np.asarray(t)
    if not (hdr.ndim == 1 and hdr.size >= 6 and hdr.dtype.kind == "i"
            and int(hdr[0]) == LEASE_MAGIC):
        raise ValueError("not a prefill lease frame (bad magic header)")
    return {"lease_id": int(hdr[1]), "attempt": int(hdr[2]),
            "ship_bits": int(hdr[3]), "crc": bool(hdr[4]),
            "deadline_ms": int(hdr[5])}


def cancel_header(lease_id: int) -> np.ndarray:
    return np.asarray([CANCEL_MAGIC, int(lease_id)], np.int64)


def parse_cancel_header(t) -> int:
    hdr = np.asarray(t)
    if not (hdr.ndim == 1 and hdr.size >= 2 and hdr.dtype.kind == "i"
            and int(hdr[0]) == CANCEL_MAGIC):
        raise ValueError("not a prefill lease cancel (bad magic header)")
    return int(hdr[1])


def ack_header(lease_id: int, attempt: int, status: int) -> np.ndarray:
    return np.asarray([ACK_MAGIC, int(lease_id), int(attempt),
                       int(status)], np.int64)


def parse_ack_header(t) -> dict:
    hdr = np.asarray(t)
    if not (hdr.ndim == 1 and hdr.size >= 4 and hdr.dtype.kind == "i"
            and int(hdr[0]) == ACK_MAGIC):
        raise ValueError("not a prefill ship ack (bad magic header)")
    return {"lease_id": int(hdr[1]), "attempt": int(hdr[2]),
            "status": int(hdr[3])}


class _Lease:
    """One tracked prompt pass: the decode-side record an ack resolves.
    `attempt` is the fence — an ack carrying any other attempt number is
    a zombie (the lease was since re-dispatched or abandoned)."""

    __slots__ = ("lease_id", "attempt", "rank", "rid", "event",
                 "tensors", "error")

    def __init__(self, lease_id: int, attempt: int, rank: int, rid):
        self.lease_id = lease_id
        self.attempt = attempt
        self.rank = rank
        self.rid = rid
        self.event = threading.Event()
        self.tensors: Optional[List[np.ndarray]] = None
        self.error: Optional[str] = None


class RemotePrefillFleet:
    """Decode-side client of a cross-process prefill fleet.

    Owns the ship edge over an externally-constructed `DistDcnContext`
    (this process is the decode rank; `ranks` are the prefill workers).
    Interface-compatible with the in-process `PrefillFleet`:
    `prefill(ids, rid) -> ship handle` — but every call is a LEASE that
    survives worker death, ship timeout, and wire corruption, degrading
    to `PrefillUnavailable` (colocated fallback) only when every rank
    and retry is exhausted.

    `lease_timeout_s` is the per-dispatch ack deadline; `max_attempts`
    bounds total dispatches per prompt (re-dispatches + corrupt
    re-ships). `flight_note(event, **fields)` is the serving layer's
    flight-recorder hook (kept as a callable so kv/ never imports the
    recorder). `device` is where shipped handles are decoded: the decode
    pipeline's device (`cuda` unless told otherwise)."""

    def __init__(self, ctx, ranks: Sequence[int], dtype,
                 ship_bits: int = 0, crc: Optional[bool] = None,
                 lease_timeout_s: float = 30.0, max_attempts: int = 3,
                 max_concurrent: Optional[int] = None,
                 heartbeat_interval: float = 0.0,
                 heartbeat_miss: int = 5,
                 registry: Optional[prom.Registry] = None,
                 flight_note: Optional[Callable] = None,
                 device: DeviceLike = None):
        if ship_bits not in (0, 8):
            raise ValueError(f"ship_bits must be 0 or 8, got {ship_bits}")
        if not ranks:
            raise ValueError("a prefill fleet needs at least one rank")
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.ctx = ctx
        self.ranks = tuple(int(r) for r in ranks)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.ship_bits = int(ship_bits)
        self.crc = wire.crc_enabled() if crc is None else bool(crc)
        self.lease_timeout_s = float(lease_timeout_s)
        self.max_attempts = int(max_attempts)
        # a lease dispatch must never out-dial its own deadline: a
        # worker killed before it EVER connected has no fast-refused
        # path in _ensure_conn, and the default 60s connect budget
        # would wedge the dispatching thread far past the lease — the
        # workers' listeners come up before their model build, so a
        # healthy fleet always dials in milliseconds anyway
        ctx.CONNECT_TIMEOUT = min(ctx.CONNECT_TIMEOUT,
                                  max(5.0, self.lease_timeout_s))
        self.flight_note = flight_note
        self._lock = make_lock("kv.fleet")
        self._live = set(self.ranks)
        self._leases: Dict[int, _Lease] = {}
        self._next_lease = 0
        self._rr = 0
        self._stop = threading.Event()
        # in-flight bound: workers process leases serially, so anything
        # past ~2 per rank only queues in socket buffers
        self._slots = threading.Semaphore(
            max_concurrent if max_concurrent is not None
            else 2 * len(self.ranks))
        reg = prom.REGISTRY if registry is None else registry
        self.m_leases = reg.counter(
            "pipeedge_kv_prefill_leases_total",
            "prefill lease dispatches by outcome (shipped = acked + "
            "installed; redispatched = timeout/death moved it to "
            "another rank; corrupt_retry = CRC failure triggered a "
            "re-ship; fallback = exhausted, degraded to colocated "
            "prefill — docs/FAULT_TOLERANCE.md disaggregated serving)")
        for outcome in LEASE_OUTCOMES:
            self.m_leases.declare(outcome=outcome)
        self.m_corrupt = reg.counter(
            "pipeedge_kv_ship_corrupt_total",
            "shipped KV bundles that failed CRC verification on decode")
        self.m_corrupt.declare()
        self.m_zombie = reg.counter(
            "pipeedge_kv_zombie_ships_dropped_total",
            "ship acks dropped by the lease fence (unknown lease or "
            "stale attempt: the lease was re-dispatched, completed, or "
            "abandoned before this ack arrived)")
        self.m_zombie.declare()
        self.m_live = reg.gauge(
            "pipeedge_kv_prefill_ranks_live",
            "prefill ranks currently in dispatch rotation")
        self.m_live.set(len(self._live))
        ctx.register_peer_death_handler(self._on_peer_death)
        ctx.register_peer_rejoin_handler(self._on_peer_rejoin)
        # PR 6 transport-path negotiation on the LEASE edge (decode ->
        # worker): colocated test fleets get the in-process hand-off,
        # real worker processes land on zerocopy/socket_v2 — best
        # effort, the socket truth stands when a worker is slow to
        # answer (exactly runtime.py's per-round stance)
        for r in self.ranks:
            try:
                self.ctx.negotiate_edge_path(r, timeout=5.0)
            except Exception as exc:   # noqa: BLE001 — queue.Empty /
                # OSError / a worker mid-build: keep the socket path
                logger.info("lease edge ->r%d: path handshake skipped "
                            "(%s)", r, exc)
        if heartbeat_interval > 0:
            ctx.start_heartbeat(self.ranks, interval=heartbeat_interval,
                                miss_threshold=heartbeat_miss)
        # one ack reader per worker rank: a dead rank's reader idles
        # (ConnectionError -> backoff) and resumes after a rejoin
        self._readers = [
            threading.Thread(target=self._ack_loop, args=(r,),
                             daemon=True, name=f"kv-ship-ack-r{r}")
            for r in self.ranks]
        for t in self._readers:
            t.start()

    # -- membership -------------------------------------------------------

    def _note(self, event: str, **fields) -> None:
        if self.flight_note is not None:
            try:
                self.flight_note(event, **fields)
            except Exception:   # noqa: BLE001 — observability must never
                pass            # fail the data path

    def _on_peer_death(self, rank: int) -> None:
        if rank not in self.ranks:
            return
        stranded: List[_Lease] = []
        with self._lock:
            self._live.discard(rank)
            self.m_live.set(len(self._live))
            stranded = [ls for ls in self._leases.values()
                        if ls.rank == rank and not ls.event.is_set()]
        logger.warning("prefill rank %d died; %d in-flight lease(s) "
                       "re-dispatching", rank, len(stranded))
        self._note("prefill_rank_dead", rank=rank,
                   stranded=len(stranded))
        # resolve stranded leases as failed NOW: their waiters re-dispatch
        # immediately instead of burning the full lease timeout
        for ls in stranded:
            ls.error = f"prefill rank {rank} died"
            ls.event.set()

    def _on_peer_rejoin(self, rank: int, epoch: int) -> None:
        if rank not in self.ranks:
            return
        with self._lock:
            self._live.add(rank)
            self.m_live.set(len(self._live))
        logger.info("prefill rank %d readmitted (epoch %d)", rank, epoch)
        self._note("prefill_rank_readmitted", rank=rank, epoch=epoch)

    def live_ranks(self) -> frozenset:
        with self._lock:
            return frozenset(self._live)

    def _pick_rank(self, avoid: Optional[int] = None) -> int:
        """Round-robin over live ranks, skipping `avoid` (the rank that
        just failed this lease) when any alternative exists."""
        with self._lock:
            live = sorted(self._live)
            if not live:
                raise PrefillUnavailable(
                    "no live prefill rank (all "
                    f"{len(self.ranks)} worker(s) dead)")
            pool = [r for r in live if r != avoid] or live
            self._rr += 1
            return pool[self._rr % len(pool)]

    # -- the ack plane ----------------------------------------------------

    def _ack_loop(self, rank: int) -> None:
        while not self._stop.is_set():
            try:
                tensors = self.ctx.recv_tensors(rank, timeout=0.5,
                                                channel=CH_SHIP)
            except queue_mod.Empty:
                continue
            except (ConnectionError, OSError):
                # rank dead: idle until a rejoin revives the queue
                if self._stop.wait(0.5):
                    return
                continue
            try:
                ack = parse_ack_header(tensors[0])
            except (ValueError, IndexError):
                logger.error("malformed ship ack from rank %d dropped",
                             rank)
                continue
            self._resolve(ack, tensors[1:])

    def _resolve(self, ack: dict, tensors: List[np.ndarray]) -> None:
        """Deliver an ack to its lease — or fence it: an unknown lease
        id or a stale attempt number means the lease moved on (re-
        dispatched, completed, abandoned) and this ack is a ZOMBIE that
        must never install."""
        with self._lock:
            ls = self._leases.get(ack["lease_id"])
            stale = ls is None or ls.attempt != ack["attempt"] \
                or ls.event.is_set()
        if stale:
            self.m_zombie.inc()
            logger.warning(
                "zombie ship ack dropped (lease %d attempt %d)",
                ack["lease_id"], ack["attempt"])
            self._note("zombie_ship_dropped", lease=ack["lease_id"],
                       attempt=ack["attempt"])
            return
        if ack["status"] != ACK_OK:
            ls.error = f"prefill rank {ls.rank} errored the lease"
        else:
            ls.tensors = tensors
        ls.event.set()

    # -- the lease path ---------------------------------------------------

    def prefill(self, ids, rid: Optional[str] = None) -> dict:
        """One tracked prompt pass: returns the decode-side install
        handle (`PagedKvBackend.admit`'s `shipped=`), or raises
        `PrefillUnavailable` after every rank/retry is exhausted — the
        caller's cue to run the prompt pass colocated."""
        ids_t = np.asarray(ids, np.int64)
        srid = None if rid is None else str(rid)
        with self._lock:
            self._next_lease += 1
            lease_id = self._next_lease
        last_rank: Optional[int] = None
        with self._slots:
            for attempt in range(1, self.max_attempts + 1):
                try:
                    rank = self._pick_rank(avoid=last_rank)
                except PrefillUnavailable:
                    # the whole fleet is dead: degrade immediately —
                    # burning the remaining attempts against nothing
                    # would just stretch the request's first-token time
                    self.m_leases.inc(outcome="fallback")
                    self._note("prefill_fallback", rid=srid,
                               lease=lease_id, reason="no_live_rank")
                    raise
                ls = _Lease(lease_id, attempt, rank, srid)
                with self._lock:
                    self._leases[lease_id] = ls
                try:
                    status, handle = self._dispatch_once(ls, ids_t)
                finally:
                    with self._lock:
                        self._leases.pop(lease_id, None)
                if status == "ok":
                    self.m_leases.inc(outcome="shipped")
                    return handle
                last_rank = rank
                if attempt < self.max_attempts:
                    # outcome counted HERE, where the retry actually
                    # happens — the FINAL failed attempt re-dispatches
                    # nothing and must not inflate the counter
                    self.m_leases.inc(
                        outcome="corrupt_retry" if status == "corrupt"
                        else "redispatched")
        self.m_leases.inc(outcome="fallback")
        self._note("prefill_fallback", rid=srid, lease=lease_id,
                   attempts=self.max_attempts)
        raise PrefillUnavailable(
            f"prefill lease {lease_id} exhausted {self.max_attempts} "
            f"attempt(s) (last rank {last_rank})")

    def _dispatch_once(self, ls: _Lease, ids_t: np.ndarray) \
            -> tuple:
        """One lease dispatch: send, await ack, decode. Returns
        `("ok", handle)`, `("corrupt", None)` (CRC failure — a re-ship
        can recover it), or `("failed", None)` (timeout / death /
        worker error / malformed); the caller decides whether another
        attempt follows and counts the outcome accordingly."""
        hdr = lease_header(ls.lease_id, ls.attempt, self.ship_bits,
                           self.crc, self.lease_timeout_s * 1e3)
        with telemetry.span("kv", f"lease:r{ls.rank}", rid=ls.rid):
            try:
                self.ctx.send_tensors(ls.rank, [hdr, ids_t],
                                      channel=CH_LEASE)
            except (ConnectionError, OSError) as exc:
                logger.warning("lease %d send to rank %d failed: %s",
                               ls.lease_id, ls.rank, exc)
                return "failed", None
            if not ls.event.wait(self.lease_timeout_s):
                logger.warning(
                    "lease %d timed out on rank %d after %.1fs",
                    ls.lease_id, ls.rank, self.lease_timeout_s)
                self._note("prefill_lease_timeout", rank=ls.rank,
                           lease=ls.lease_id, rid=ls.rid)
                # best-effort cancel: if the stale lease is still
                # queued at the worker (a fault window backs leases
                # up), it must be SKIPPED there, not fully executed
                # into a zombie ack — capacity is scarcest exactly then
                try:
                    self.ctx.send_tensors(
                        ls.rank, [cancel_header(ls.lease_id)],
                        channel=CH_CANCEL)
                except (ConnectionError, OSError):
                    pass       # rank gone: nothing left to cancel
                return "failed", None
        if ls.error is not None:
            return "failed", None
        try:
            with ship.device_stream(self.device):
                return "ok", ship.decode_kv_ship(ls.tensors, self.dtype,
                                                 device=self.device)
        except wire.WireCorruptError as exc:
            # wire corruption made it past the transport (or CRC is the
            # only integrity layer on this edge): bounded re-ship — the
            # prompt pass is deterministic, so a re-run IS a resend
            self.m_corrupt.inc()
            logger.warning("lease %d ship from rank %d corrupt (%s); "
                           "re-shipping", ls.lease_id, ls.rank, exc)
            self._note("ship_corrupt", rank=ls.rank, lease=ls.lease_id)
            return "corrupt", None
        except (ValueError, IndexError) as exc:
            logger.error("lease %d ship from rank %d malformed: %s",
                         ls.lease_id, ls.rank, exc)
            return "failed", None

    def snapshot(self) -> dict:
        with self._lock:
            live = sorted(self._live)
            in_flight = sum(1 for ls in self._leases.values()
                            if not ls.event.is_set())
        return {
            "ranks": list(self.ranks),
            "live": live,
            "dead": sorted(set(self.ranks) - set(live)),
            "in_flight": in_flight,
            "leases": {o: int(self.m_leases.value(outcome=o))
                       for o in LEASE_OUTCOMES},
            "ship_corrupt_total": int(self.m_corrupt.value()),
            "zombies_dropped_total": int(self.m_zombie.value()),
        }

    def close(self) -> None:
        self._stop.set()
        # fail pending waiters fast (their retries will see no live rank)
        with self._lock:
            pending = list(self._leases.values())
            self._live.clear()
            self.m_live.set(0)
        for ls in pending:
            ls.error = "prefill fleet closed"
            ls.event.set()
        self.ctx.stop_heartbeat()
        for t in self._readers:
            t.join(timeout=5)


class PrefillWorkerLoop:
    """The worker side of the lease protocol: recv lease -> prompt pass
    -> ship ack. One loop, serial prompt passes (concurrency is the
    number of worker RANKS; a process-wide pool would just contend for
    the same host dispatch thread). `python -m
    pipeedge_tpu_torch.prefill_worker` drives it as a standalone process;
    tests drive it in-process on its own context (the same frames either
    way)."""

    def __init__(self, pipe, ctx, decode_rank: int = 0):
        if pipe.cache_bits:
            raise ValueError("the prefill fleet ships fp KV rows; int8 "
                             "CACHES don't ship (quantize the wire with "
                             "ship bits instead)")
        self.pipe = pipe
        self.ctx = ctx
        self.decode_rank = int(decode_rank)
        self._stop = threading.Event()
        self._ship_path: Optional[str] = None
        self.leases_served = 0
        self.leases_cancelled = 0
        # cancelled lease ids, bounded: a cancel can arrive BEFORE its
        # lease (separate channels have no cross-ordering), so the set
        # must persist — and must not grow without bound
        self._cancelled: set = set()
        self._cancel_order: deque = deque(maxlen=256)

    def stop(self) -> None:
        self._stop.set()

    def _drain_cancels(self) -> None:
        """Pull every pending cancel off CH_CANCEL (non-blocking): the
        decode side cancels a lease it re-dispatched elsewhere, and a
        stale lease still queued here must be SKIPPED — running it
        would burn a full prompt pass into a zombie ack exactly when a
        fault window has made prefill capacity scarce."""
        while True:
            try:
                tensors = self.ctx.recv_tensors(self.decode_rank,
                                                timeout=0.0,
                                                channel=CH_CANCEL)
            except (queue_mod.Empty, ConnectionError, OSError):
                return
            try:
                lease_id = parse_cancel_header(tensors[0])
            except (ValueError, IndexError):
                continue
            if len(self._cancel_order) == self._cancel_order.maxlen:
                self._cancelled.discard(self._cancel_order[0])
            self._cancel_order.append(lease_id)
            self._cancelled.add(lease_id)

    def run(self) -> None:
        """Serve leases until stopped or the decode rank dies."""
        while not self._stop.is_set():
            try:
                tensors = self.ctx.recv_tensors(self.decode_rank,
                                                timeout=0.5,
                                                channel=CH_LEASE)
            except queue_mod.Empty:
                continue
            except (ConnectionError, OSError):
                logger.info("prefill worker: decode rank %d gone; "
                            "exiting", self.decode_rank)
                return
            try:
                lease = parse_lease_header(tensors[0])
                ids = np.asarray(tensors[1], np.int64)
                if ids.ndim != 2:
                    raise ValueError(f"lease ids must be [B, S], got "
                                     f"shape {ids.shape}")
            except (ValueError, IndexError) as exc:
                logger.error("malformed lease frame dropped: %s", exc)
                continue
            self._drain_cancels()
            if lease["lease_id"] in self._cancelled:
                self.leases_cancelled += 1
                logger.info("prefill lease %d cancelled before "
                            "execution; skipped", lease["lease_id"])
                continue
            t0 = time.monotonic()
            try:
                with ship.device_stream(self.pipe.device):
                    with telemetry.span("kv",
                                        f"prefill:l{lease['lease_id']}"):
                        out, caches = self.pipe._prefill(
                            self.pipe._ids(ids))
                        logits = out[:, -1]
                    frames = ship.encode_kv_ship(
                        caches, ids.shape[1], logits,
                        bits=lease["ship_bits"], crc=lease["crc"])
                reply = [ack_header(lease["lease_id"], lease["attempt"],
                                    ACK_OK)] + frames
            except Exception as exc:   # noqa: BLE001 — a poisoned prompt
                # (or a kernel that fails on the card) must ack as an
                # ERROR, not silence: silence costs the decode side a full
                # lease timeout per attempt
                logger.exception("prefill lease %d failed: %s",
                                 lease["lease_id"], exc)
                reply = [ack_header(lease["lease_id"], lease["attempt"],
                                    ACK_ERROR)]
            if self._ship_path is None:
                # PR 6 path negotiation on the SHIP edge (worker ->
                # decode), once, before the first ack: the decode rank
                # is provably up by now (it sent this lease)
                try:
                    self._ship_path = self.ctx.negotiate_edge_path(
                        self.decode_rank, timeout=5.0)
                except Exception as exc:   # noqa: BLE001 — keep socket
                    self._ship_path = "socket_v2"
                    logger.info("ship edge ->r%d: path handshake "
                                "skipped (%s)", self.decode_rank, exc)
            try:
                self.ctx.send_tensors(self.decode_rank, reply,
                                      channel=CH_SHIP)
            except (ConnectionError, OSError):
                logger.warning("ship ack for lease %d undeliverable "
                               "(decode rank gone?)", lease["lease_id"])
                continue
            self.leases_served += 1
            logger.info("prefill lease %d served in %.3fs",
                        lease["lease_id"], time.monotonic() - t0)
