"""Fleet-wide microbatch tracing: span recorder, clock alignment, wire codec.

Port copy of `pipeedge_tpu/telemetry/__init__.py`, word for word but
for this paragraph and the package imports. Spans time the host clock;
they claim no device time.

The reference ships only wall-clock offline profiling and per-rank heartbeat
CSVs (SURVEY.md §5.1) — nothing answers *why* a pipeline round was slow:
which stage bubbled, which edge's wire time dominated, where a failover
stalled the fleet. This subsystem is the missing correlation layer:

- `SpanRecorder`: a fixed-size per-rank ring buffer of
  `(category, name, rank, stage, mb, t_start_ns, t_end_ns, rid)` records,
  `time.monotonic_ns()`-stamped, drop-oldest under pressure — a `record()`
  NEVER blocks the hot send/dispatch threads it instruments. `rid` is the
  request id of the span's `TraceContext` (request-scoped tracing), None
  when untraced.
- module-level `configure()` / `span()` / `record()`: the instrumentation
  surface. Recording is OFF by default; when off, `span()` returns a shared
  no-op context manager, so the hot-path cost of a disabled probe is one
  global read and one attribute call (see `tools/trace_report.py`'s
  `span_overhead_pct` self-measurement for the enabled cost).
- `spans_to_wire` / `spans_from_wire`: span buffers as a single uint8
  ndarray (UTF-8 JSON), the only payload type the DCN command channel
  carries — how a peer's buffer travels in a `_MSG_SPANS` reply
  (comm/dcn.py `collect_spans`).
- `estimate_clock_offset`: NTP-style offset from request/reply timestamp
  quadruples, so every rank's `monotonic_ns` spans merge onto the
  collector's timeline (chrome_trace.py).

Span categories in use (docs/OBSERVABILITY.md has the full reference):
`wire` (socket send/recv), `stage` (DCN stage dispatch/readback; host
pipeline per-stage dispatch/retire), `compute` (the jitted shard step),
`quant` (wire encode/decode), `feed`/`results` (data-rank microbatch
lifecycle), `runtime` (schedule rounds), `failover` (detection→recovery),
`rejoin` (JOIN admission → heal-to-full-capacity), `health` (gray-failure
lifecycle transitions, pipeedge_tpu/health/), `serve` (HTTP request
lifecycle).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.threads import make_lock

ENV_SPAN_CAPACITY = "PIPEEDGE_SPAN_CAPACITY"
DEFAULT_SPAN_CAPACITY = 32768

# dict-record field order (also the ring tuple layout). `rid` — the
# request id of the trace context a span belongs to — sits LAST so the
# wire codec stays compatible with pre-request-tracing rows: a 7-field
# row decodes with rid absent (untraced), an 8-field row read by an old
# decoder simply drops the tail (zip truncates).
_FIELDS = ("cat", "name", "rank", "stage", "mb", "t0", "t1", "rid")

# categories folded into the cumulative digest (sched/rebalance.py's
# sensor): bounded name sets only — feed/results names embed microbatch
# ids and would grow the digest without bound
DIGEST_CATEGORIES = frozenset(("stage", "compute", "wire", "quant"))

# a digest maps (cat, name, stage) -> (count, total_ns), CUMULATIVE since
# the recorder was configured — consumers difference two digests to get a
# per-round window (feedback.diff_digests), so the fixed-size ring's
# drop-oldest behavior never corrupts the numbers
Digest = Dict[Tuple[str, str, Optional[int]], Tuple[int, int]]


class SpanRecorder:
    """Fixed-size ring of completed spans (drop-oldest under pressure).

    `record()` is the only hot-path entry: two clock reads happen in the
    caller (`_Span`), so the recorder itself is one short lock + one deque
    append — it never blocks on I/O, never allocates beyond the tuple, and
    overflow silently drops the OLDEST span (the ring keeps the most recent
    window, which is the one a post-mortem wants) while counting drops.
    """

    def __init__(self, rank: int = 0, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(os.getenv(ENV_SPAN_CAPACITY,
                                     str(DEFAULT_SPAN_CAPACITY)))
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.rank = rank
        self.capacity = capacity
        self.dropped = 0
        self._ring: deque = deque(maxlen=capacity)
        # cumulative (cat, name, stage) -> [count, total_ns] rollup for
        # DIGEST_CATEGORIES spans; what a lightweight per-round collection
        # (dcn.collect_digest) ships instead of the full ring
        self._digest: Dict[Tuple[str, str, Optional[int]], List[int]] = {}
        self._lock = make_lock("telemetry.span_ring")

    def record(self, cat: str, name: str, t0: int, t1: int,
               stage: Optional[int] = None, mb: Optional[int] = None,
               rid: Optional[str] = None) -> None:
        if rid is None:
            ctx = current_trace()
            if ctx is not None:
                rid = ctx.rid
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append((cat, name, self.rank, stage, mb, t0, t1,
                               rid))
            if cat in DIGEST_CATEGORIES:
                cell = self._digest.get((cat, name, stage))
                if cell is None:
                    self._digest[(cat, name, stage)] = [1, t1 - t0]
                else:
                    cell[0] += 1
                    cell[1] += t1 - t0

    def span(self, cat: str, name: str, stage: Optional[int] = None,
             mb: Optional[int] = None,
             rid: Optional[str] = None) -> "_Span":
        """Context manager recording [enter, exit] as one span."""
        return _Span(self, cat, name, stage, mb, rid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[dict]:
        """Copy the ring as a list of span dicts (oldest first)."""
        with self._lock:
            rows = list(self._ring)
        return [dict(zip(_FIELDS, r)) for r in rows]

    def drain(self) -> List[dict]:
        """Snapshot AND clear the ring (per-round collection)."""
        with self._lock:
            rows = list(self._ring)
            self._ring.clear()
        return [dict(zip(_FIELDS, r)) for r in rows]

    def digest(self) -> "Digest":
        """Cumulative duration rollup of every DIGEST_CATEGORIES span this
        recorder ever saw: (cat, name, stage) -> (count, total_ns). Unlike
        the ring it never drops, so two digests difference cleanly into a
        per-round window (telemetry/feedback.py)."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._digest.items()}


class _Span:
    """Live span: stamps monotonic_ns on enter/exit, records on exit."""

    __slots__ = ("_rec", "_cat", "_name", "_stage", "_mb", "_rid", "_t0")

    def __init__(self, rec, cat, name, stage, mb, rid=None):
        self._rec = rec
        self._cat = cat
        self._name = name
        self._stage = stage
        self._mb = mb
        self._rid = rid

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._cat, self._name, self._t0,
                         time.monotonic_ns(), self._stage, self._mb,
                         rid=self._rid)
        return False


class _NullSpan:
    """Shared no-op context manager: the disabled-probe fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_recorder: Optional[SpanRecorder] = None


def configure(rank: int = 0, capacity: Optional[int] = None) -> SpanRecorder:
    """Enable span recording process-wide (idempotent per process: a second
    call replaces the recorder — fresh ring, same instrumentation)."""
    global _recorder  # pylint: disable=global-statement
    _recorder = SpanRecorder(rank=rank, capacity=capacity)
    return _recorder


def disable() -> None:
    """Drop the recorder: probes revert to the no-op fast path."""
    global _recorder  # pylint: disable=global-statement
    _recorder = None


def recorder() -> Optional[SpanRecorder]:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def span(cat: str, name: str, stage: Optional[int] = None,
         mb: Optional[int] = None, rid: Optional[str] = None):
    """Instrumentation probe: a recording span when configured, the shared
    no-op otherwise. Safe on any thread. `rid` tags the span with a
    request id; None picks up the calling thread's current trace context
    (set_trace / trace_scope) at record time."""
    rec = _recorder
    if rec is None:
        return _NULL_SPAN
    return _Span(rec, cat, name, stage, mb, rid)


def record(cat: str, name: str, t0: int, t1: int,
           stage: Optional[int] = None, mb: Optional[int] = None,
           rid: Optional[str] = None) -> None:
    """Record a pre-timed span (e.g. failover detection→recovery, whose
    endpoints live on different threads); no-op when disabled."""
    rec = _recorder
    if rec is not None:
        rec.record(cat, name, t0, t1, stage=stage, mb=mb, rid=rid)


# -- request-scoped trace context (docs/OBSERVABILITY.md) ----------------

class TraceContext:
    """Compact per-request trace identity, threaded end-to-end: minted at
    admission (tools/serve.py) or per microbatch at the data rank's feed
    (runtime.py), carried through the executors, and across DCN frames
    (`comm/dcn.py` `_MSG_TENSORS_TRACED`) so every rank's spans inherit
    the request id fleet-wide.

    Fields: `rid` (the request id — the correlation key every span
    carries), `cls` (request class, docs/SERVING.md), `deadline_ms`
    (remaining budget at mint time, forensic), `parent` (the minting
    span/site, so a timeline names its origin)."""

    __slots__ = ("rid", "cls", "deadline_ms", "parent")

    def __init__(self, rid: str, cls: str = "interactive",
                 deadline_ms: Optional[float] = None,
                 parent: Optional[str] = None):
        self.rid = str(rid)
        self.cls = str(cls)
        self.deadline_ms = (None if deadline_ms is None
                            else float(deadline_ms))
        self.parent = None if parent is None else str(parent)

    def to_dict(self) -> dict:
        d = {"rid": self.rid, "cls": self.cls}
        if self.deadline_ms is not None:
            d["deadline_ms"] = self.deadline_ms
        if self.parent is not None:
            d["parent"] = self.parent
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceContext":
        return cls(d["rid"], d.get("cls", "interactive"),
                   d.get("deadline_ms"), d.get("parent"))

    def to_wire(self) -> np.ndarray:
        """One uint8 ndarray (UTF-8 JSON) — the optional leading tensor a
        traced DCN frame carries (comm/dcn.py)."""
        blob = json.dumps(self.to_dict(), separators=(",", ":")).encode()
        return np.frombuffer(blob, np.uint8)

    @classmethod
    def from_wire(cls, arr) -> Optional["TraceContext"]:
        """Inverse of `to_wire`. Tolerant by contract: an empty,
        truncated, or otherwise undecodable blob means UNTRACED (None),
        never a dead reader thread — a frame without a valid context is
        still a valid frame."""
        try:
            blob = bytes(np.asarray(arr, np.uint8))
            if not blob:
                return None
            d = json.loads(blob)
            if not isinstance(d, dict) or "rid" not in d:
                return None
            return cls.from_dict(d)
        except Exception:  # noqa: BLE001 — any malformed blob = untraced
            return None

    def __repr__(self):
        return (f"TraceContext(rid={self.rid!r}, cls={self.cls!r}, "
                f"deadline_ms={self.deadline_ms}, parent={self.parent!r})")


_TRACE_TLS = threading.local()


def set_trace(ctx: Optional[TraceContext]) -> None:
    """Set (or clear, with None) the calling thread's current trace
    context: spans recorded on this thread without an explicit `rid`
    inherit it."""
    _TRACE_TLS.ctx = ctx


def current_trace() -> Optional[TraceContext]:
    return getattr(_TRACE_TLS, "ctx", None)


class trace_scope:
    """`with trace_scope(ctx):` — install `ctx` as the thread's current
    trace context for the block, restoring the previous one on exit
    (exception paths included). Reentrant; None is a valid ctx (an
    explicitly-untraced block)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._prev = current_trace()
        set_trace(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        set_trace(self._prev)
        return False


# -- wire codec (DCN command-channel payloads are ndarrays only) ---------

def spans_to_wire(spans: Sequence[dict]) -> np.ndarray:
    """Span dicts -> one uint8 ndarray (UTF-8 JSON) for a command frame."""
    blob = json.dumps([[s.get(f) for f in _FIELDS] for s in spans],
                      separators=(",", ":")).encode()
    return np.frombuffer(blob, np.uint8)


def spans_from_wire(arr: np.ndarray) -> List[dict]:
    """Inverse of `spans_to_wire`; tolerates an empty reply (no recorder
    on the peer)."""
    blob = bytes(np.asarray(arr, np.uint8))
    if not blob:
        return []
    return [dict(zip(_FIELDS, row)) for row in json.loads(blob)]


def digest_to_wire(digest: "Digest") -> np.ndarray:
    """Digest -> one uint8 ndarray (UTF-8 JSON rows
    [cat, name, stage, count, total_ns]) for a command frame — the
    kilobyte-scale payload a per-round rebalance collection ships instead
    of the megabyte-scale full ring."""
    rows = [[cat, name, stage, int(n), int(ns)]
            for (cat, name, stage), (n, ns) in sorted(
                digest.items(), key=lambda kv: (kv[0][0], kv[0][1],
                                                -1 if kv[0][2] is None
                                                else kv[0][2]))]
    blob = json.dumps(rows, separators=(",", ":")).encode()
    return np.frombuffer(blob, np.uint8)


def digest_from_wire(arr: np.ndarray) -> "Digest":
    """Inverse of `digest_to_wire`; tolerates an empty reply (no recorder
    on the peer)."""
    blob = bytes(np.asarray(arr, np.uint8))
    if not blob:
        return {}
    return {(cat, name, stage): (int(n), int(ns))
            for cat, name, stage, n, ns in json.loads(blob)}


# -- clock alignment -----------------------------------------------------

def estimate_clock_offset(samples: Sequence[Tuple[int, int, int, int]]) -> int:
    """NTP-style peer-clock offset from `(t0, t1, t2, t3)` quadruples:
    local send, peer receive, peer reply, local receive (all ns, each on
    its own monotonic clock).

    Returns theta = peer_clock - local_clock (ns), taken from the
    minimum-round-trip sample — the one whose network legs were most
    symmetric, hence the tightest bound (classic NTP filter). Map a peer
    timestamp onto the local timeline with `t_local = t_peer - theta`;
    the residual error is bounded by half that sample's RTT.
    """
    if not samples:
        raise ValueError("need at least one timestamp sample")
    best = min(samples, key=lambda s: (s[3] - s[0]) - (s[2] - s[1]))
    t0, t1, t2, t3 = best
    return ((t1 - t0) + (t2 - t3)) // 2


def round_segments(spans: Sequence[dict]) -> List[Tuple[int, int]]:
    """Merged [t0, t1] interval per named `runtime` round span, sorted by
    start. Microbatch ids restart at 0 every schedule round (re-schedule
    rounds replay the same batch; --measure-rounds reruns it), so any
    consumer correlating spans BY mb id must segment the timeline by these
    intervals first — every rank records its own round span, hence the
    per-name merge."""
    by_name = {}
    for s in spans:
        if s.get("cat") != "runtime":
            continue
        t0, t1 = int(s["t0"]), int(s["t1"])
        cur = by_name.get(s["name"])
        by_name[s["name"]] = ((t0, t1) if cur is None
                              else (min(cur[0], t0), max(cur[1], t1)))
    return sorted(by_name.values())


def segment_index(segments: Sequence[Tuple[int, int]], t: int) -> int:
    """Index of the last segment starting at or before `t` (-1 if none):
    which round a span belongs to."""
    idx = -1
    for i, (t0, _) in enumerate(segments):
        if t0 <= t:
            idx = i
        else:
            break
    return idx


def align_spans(spans: Sequence[dict], offset_ns: int) -> List[dict]:
    """Shift a peer's spans onto the collector's timeline
    (`t_local = t_peer - offset_ns`, see `estimate_clock_offset`)."""
    out = []
    for s in spans:
        s = dict(s)
        s["t0"] = int(s["t0"]) - offset_ns
        s["t1"] = int(s["t1"]) - offset_ns
        out.append(s)
    return out
