"""Flight recorder: an always-on bounded ring of request-tagged events
that can explain any slow request AFTER the fact.

Port copy of `pipeedge_tpu/telemetry/flight.py` (the JAX package's
triggers and bundle keys).

The span plane (telemetry/__init__.py) answers "why was the fleet slow"
when a `--trace-spans` run was armed ahead of time; production incidents
do not schedule themselves. This module keeps a cheap, always-on,
fixed-size per-rank ring of request-tagged events (admits, sheds,
deadline expiries, brownout transitions, failover lifecycle, feed/ack
progress) and, when something goes wrong, dumps a **postmortem bundle**:
the event ring, a slice of the span ring scoped to the offending request
(when span recording is on), and whatever context the caller attaches
(admission/brownout snapshots, microbatch-ledger state).

Triggers (docs/OBSERVABILITY.md):
- `deadline` — a request expired mid-flight (HTTP 504, tools/serve.py)
- `shed`     — admission refused a request (503; cooldown-limited so a
               shed storm writes one bundle, not thousands)
- `failover` — a degraded window opened / a rank died (runtime.py,
               tools/serve.py POST /degraded)
- `slo`      — the brownout ladder crossed its SLO-breach rung
- `gray`     — the peer-health plane quarantined a gray-failing rank
               (pipeedge_tpu/health/, docs/FAULT_TOLERANCE.md)
- `poison`   — the NaN/Inf activation guard tripped at a stage boundary
               (PIPEEDGE_NAN_GUARD=1, pipeedge_tpu/health/guard.py)
- `manual`   — POST /debug/dump (never cooldown-limited)

Dumps are JSON files under `PIPEEDGE_POSTMORTEM_DIR` (default
`postmortems/`), written atomically (tmp + rename) OUTSIDE the ring lock,
counted on `pipeedge_postmortems_written_total{trigger}` (matrix
pre-declared — pipelint PL501) and surfaced on /healthz (`flight` block:
written total + last bundle path). `tools/trace_report.py --request`
reads a bundle directly: its `spans` slice is the same span-dict shape a
merged trace decodes to.

Module-level surface mirrors the span plane's (`note()` / `maybe_dump()`
route to a lazily-created process singleton), so probes cost one global
read when nothing ever dumps.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..utils.threads import make_lock
from . import metrics as prom
from . import recorder as span_recorder

logger = logging.getLogger(__name__)

ENV_POSTMORTEM_DIR = "PIPEEDGE_POSTMORTEM_DIR"
DEFAULT_POSTMORTEM_DIR = "postmortems"
DEFAULT_CAPACITY = 4096
DEFAULT_COOLDOWN_S = 5.0

TRIGGERS = ("deadline", "shed", "failover", "slo", "slo_burn", "gray",
            "poison", "manual")

_POSTMORTEMS = prom.REGISTRY.counter(
    "pipeedge_postmortems_written_total",
    "postmortem bundles written by the flight recorder, by trigger")
for _t in TRIGGERS:
    _POSTMORTEMS.declare(trigger=_t)


def rid_tree_member(span_rid: Optional[str], rid: str) -> bool:
    """True when `span_rid` belongs to `rid`'s derivation tree: the rid
    itself or any dot-suffixed descendant (`rid.t2`, `rid.hedge.t1`,
    `rid.fo1`, `rid.replay` — the router/executor derivation grammar,
    docs/OBSERVABILITY.md). One logical request resolves as one tree."""
    if not isinstance(span_rid, str):
        return False
    return span_rid == rid or span_rid.startswith(rid + ".")


def trace_slice(spans: Sequence[dict], rid: Optional[str]) -> List[dict]:
    """The bundle's span slice: every span in `rid`'s derivation tree
    (retry/hedge/failover-replay children included), plus the spans
    sharing a microbatch id with one of them (the wire/ledger hops
    recorded before the trace context reached them). `rid=None` keeps
    the whole list (a fleet-wide postmortem wants everything)."""
    if rid is None:
        return list(spans)
    mine = [s for s in spans if rid_tree_member(s.get("rid"), rid)]
    mbs = {s.get("mb") for s in mine if s.get("mb") is not None}
    out = list(mine)
    if mbs:
        out += [s for s in spans
                if not rid_tree_member(s.get("rid"), rid)
                and s.get("mb") in mbs]
    out.sort(key=lambda s: (int(s.get("t0", 0)), str(s.get("cat", "")),
                            str(s.get("name", ""))))
    return out


class FlightRecorder:
    """Fixed-size drop-oldest ring of `(t_ns, kind, rid, detail)` events.

    `note()` is the hot-path entry: one short lock + one deque append —
    always on, never blocking on I/O (the same discipline as
    SpanRecorder.record). `dump()` snapshots under the lock and writes
    the bundle file OUTSIDE it."""

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_CAPACITY,
                 out_dir: Optional[str] = None,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.rank = int(rank)
        self.out_dir = (out_dir if out_dir is not None
                        else os.getenv(ENV_POSTMORTEM_DIR,
                                       DEFAULT_POSTMORTEM_DIR))
        self.cooldown_s = float(cooldown_s)
        self.dropped = 0
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = make_lock("telemetry.flight")
        self._seq = 0
        self._last_path: Optional[str] = None
        # per-trigger stamp of the last bundle (the cooldown basis) and
        # events suppressed by it since (honesty counter in the bundle)
        self._last_dump: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}

    # -- hot path -------------------------------------------------------

    def note(self, kind: str, rid: Optional[str] = None, **detail) -> None:
        """Append one event (request-tagged when `rid` is given). Detail
        values must be JSON-serializable."""
        evt = (time.monotonic_ns(), str(kind),
               None if rid is None else str(rid), detail or None)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(evt)

    # -- introspection --------------------------------------------------

    def events(self, rid: Optional[str] = None) -> List[dict]:
        """Ring snapshot (oldest first), optionally request-filtered."""
        with self._lock:
            rows = list(self._ring)
        out = []
        for t, kind, evt_rid, detail in rows:
            if rid is not None and evt_rid != rid:
                continue
            d = {"t_ns": t, "kind": kind, "rid": evt_rid}
            if detail:
                d.update(detail)
            out.append(d)
        return out

    def last_path(self) -> Optional[str]:
        with self._lock:
            return self._last_path

    def written_total(self) -> int:
        return int(_POSTMORTEMS.total())

    # -- postmortem bundles ---------------------------------------------

    def would_dump(self, trigger: str) -> bool:
        """Whether `maybe_dump(trigger)` would fire right now (cooldown
        check only, no state change). Callers with an EXPENSIVE context
        to assemble gate on this first — a shed storm must not pay a
        snapshot per suppressed dump. Racy by design: losing the race
        just builds one context that gets suppressed."""
        if trigger == "manual":
            return True
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(trigger)
            return last is None or now - last >= self.cooldown_s

    def maybe_dump(self, trigger: str, rid: Optional[str] = None,
                   context: Optional[dict] = None) -> Optional[str]:
        """Dump a bundle unless `trigger` fired within its cooldown
        (manual dumps are never suppressed). Returns the bundle path, or
        None when suppressed. Never raises: a postmortem failing to
        write must not take the serving path down with it."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown trigger {trigger!r} "
                             f"(expected one of {TRIGGERS})")
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(trigger)
            if trigger != "manual" and last is not None \
                    and now - last < self.cooldown_s:
                self._suppressed[trigger] = \
                    self._suppressed.get(trigger, 0) + 1
                return None
            self._last_dump[trigger] = now
        try:
            return self._dump(trigger, rid, context)
        except Exception:  # noqa: BLE001 — the contract: a postmortem
            # failing to write (disk full, unserializable context value)
            # must never take the serving path down with it; dumps run
            # inside 504/shed handlers
            logger.warning("flight recorder: postmortem dump failed",
                           exc_info=True)
            return None

    def _dump(self, trigger: str, rid: Optional[str],
              context: Optional[dict]) -> str:
        with self._lock:
            rows = list(self._ring)
            seq = self._seq
            self._seq += 1
            suppressed = dict(self._suppressed)
        rec = span_recorder()
        spans = trace_slice(rec.snapshot(), rid) if rec is not None else []
        events = []
        for t, kind, evt_rid, detail in rows:
            d = {"t_ns": t, "kind": kind, "rid": evt_rid}
            if detail:
                d.update(detail)
            events.append(d)
        bundle = {
            "bundle": "pipeedge-postmortem",
            "trigger": trigger,
            "rid": rid,
            "rank": self.rank,
            "seq": seq,
            "t_mono_ns": time.monotonic_ns(),
            "events": events,
            "events_dropped": self.dropped,
            "suppressed_dumps": suppressed,
            "spans": spans,
            "context": context or {},
        }
        os.makedirs(self.out_dir, exist_ok=True)
        name = f"postmortem-r{self.rank}-{seq:04d}-{trigger}.json"
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf8") as f:
            # default=str: an odd value in an event detail or context
            # (numpy scalar, exception object) degrades to its repr
            # instead of losing the whole bundle
            json.dump(bundle, f, separators=(",", ":"), sort_keys=True,
                      default=str)
        os.replace(tmp, path)
        _POSTMORTEMS.inc(trigger=trigger)
        with self._lock:
            self._last_path = path
        return path


_recorder: Optional[FlightRecorder] = None
_recorder_lock = make_lock("telemetry.flight_singleton")


def configure(rank: int = 0, capacity: int = DEFAULT_CAPACITY,
              out_dir: Optional[str] = None,
              cooldown_s: float = DEFAULT_COOLDOWN_S) -> FlightRecorder:
    """(Re)build the process singleton with explicit settings — what
    tools/serve.py's --postmortem-dir and runtime.py's per-rank setup
    call. Probes that ran before configure() keep their events only in
    the replaced recorder (fresh ring, same instrumentation)."""
    global _recorder  # pylint: disable=global-statement
    with _recorder_lock:
        _recorder = FlightRecorder(rank=rank, capacity=capacity,
                                   out_dir=out_dir, cooldown_s=cooldown_s)
        return _recorder


def recorder() -> FlightRecorder:
    """The process singleton (lazily created — the recorder is ALWAYS on;
    only dumps are conditional)."""
    global _recorder  # pylint: disable=global-statement
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
            rec = _recorder
    return rec


def note(kind: str, rid: Optional[str] = None, **detail) -> None:
    recorder().note(kind, rid=rid, **detail)


def maybe_dump(trigger: str, rid: Optional[str] = None,
               context: Optional[dict] = None) -> Optional[str]:
    return recorder().maybe_dump(trigger, rid=rid, context=context)
