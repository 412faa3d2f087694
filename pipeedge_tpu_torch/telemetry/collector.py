"""SLO burn-rate engine and the per-process scrape helpers.

Port of the part of `pipeedge_tpu/telemetry/collector.py` that a
single-replica server calls, copied word for word:

- **BurnRateEngine**: multi-window error-budget burn rates from the
  per-class outcome counters. burn = (bad fraction over the window) /
  (1 - objective); 1.0 means the error budget is being consumed exactly
  at the sustainable rate. Exported as the pre-declared
  `pipeedge_slo_burn_rate{class,window}` gauge matrix and edge-triggered
  into the flight recorder's `slo_burn` postmortem trigger when the fast
  window breaches.
- **debug_spans_payload / parse_prom_text**: the per-process
  `GET /debug/spans` ring-drain body and the minimal Prometheus text
  parser.

`FleetCollector` (the router's scrape loop and `GET /fleet`) goes with
the router (ROADMAP A5.2b).
"""
from __future__ import annotations

import os
import re
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import recorder as _recorder_fn
from . import metrics as prom
from ..utils.threads import make_lock

REQUEST_CLASSES = ("interactive", "batch", "best_effort")
BURN_WINDOWS = ("short", "long")

# the per-class outcome family the burn rates read, by its exposition name
CLASS_FAMILY = "pipeedge_requests_by_class_total"

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})? '
    r'(?P<value>[-+0-9.eEinfa]+)$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>[^"]*)"')


def parse_prom_text(text: str,
                    families: Optional[Sequence[str]] = None
                    ) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Prometheus text format 0.0.4 -> {family: [(labels, value)]}.
    Histogram child series (`_bucket`/`_sum`/`_count`) key under their
    child name; `families` (when given) filters to names of interest.
    Unparseable lines are skipped — a scrape must never throw on one
    odd line."""
    want = set(families) if families is not None else None
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        if want is not None and name not in want:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {lm.group("k"): lm.group("v")
                  for lm in _LABEL_RE.finditer(m.group("labels") or "")}
        out.setdefault(name, []).append((labels, value))
    return out


def debug_spans_payload(drain: bool = True) -> dict:
    """The per-process GET /debug/spans body: span rows (drained from
    the ring by default — a federating trace_report wants each span
    exactly once), plus monotonic stamps bracketing the read so the
    caller can feed `estimate_clock_offset` one (t0, t1, t2, t3)
    quadruple per fetch."""
    t_in = time.monotonic_ns()
    rec = _recorder_fn()
    if rec is None:
        spans: List[dict] = []
        rank = 0
        dropped = 0
    else:
        spans = rec.drain() if drain else rec.snapshot()
        rank = rec.rank
        dropped = rec.dropped
    return {"pid": os.getpid(), "rank": rank, "enabled": rec is not None,
            "dropped": dropped, "drained": bool(drain),
            "t_recv_ns": t_in, "t_send_ns": time.monotonic_ns(),
            "spans": spans}


class BurnRateEngine:
    """Error-budget burn rates over a short (fast, paging) and a long
    (slow, confirmation) window, per request class.

    `update()` takes CUMULATIVE per-class (good, total) counts; the
    engine keeps a bounded sample ring and differences against the
    sample closest to each window's start. Gauges are pre-declared for
    the full class x window matrix (PL501). `on_breach(cls, burn)`
    fires EDGE-TRIGGERED when a class's fast-window burn first exceeds
    `threshold` (re-arming once it recovers) — one postmortem bundle
    per overload episode, not one per tick."""

    def __init__(self, objective: float = 0.99,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0,
                 threshold: float = 10.0,
                 classes: Sequence[str] = REQUEST_CLASSES,
                 registry: Optional[prom.Registry] = None,
                 on_breach: Optional[Callable[[str, float], None]] = None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1): {objective}")
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.threshold = float(threshold)
        self.classes = tuple(classes)
        self.on_breach = on_breach
        self._lock = make_lock("telemetry.burn")
        # (t, {cls: (good, total)}) oldest-first; bounded by slow window
        self._samples: deque = deque()
        self._breached: set = set()
        reg = registry if registry is not None else prom.REGISTRY
        self.gauge = reg.gauge(
            "pipeedge_slo_burn_rate",
            "error-budget burn rate by request class and window "
            "(1.0 = consuming budget exactly at the sustainable rate; "
            "fast-window breach > threshold triggers an slo_burn "
            "postmortem bundle)")
        for cls in self.classes:
            for window in BURN_WINDOWS:
                # zeroing IS the declaration for a gauge: the full
                # class x window matrix renders from the first scrape
                self.gauge.set(0.0, **{"class": cls, "window": window})

    @staticmethod
    def counts_from_families(
            families: Dict[str, List[Tuple[Dict[str, str], float]]],
            classes: Sequence[str] = REQUEST_CLASSES
    ) -> Dict[str, Tuple[float, float]]:
        """Parsed /metrics families -> {cls: (good, total)} cumulative,
        from the per-class outcome counter (outcome == ok is good)."""
        out = {cls: [0.0, 0.0] for cls in classes}
        for labels, value in families.get(CLASS_FAMILY, ()):
            cls = labels.get("class")
            if cls not in out:
                continue
            out[cls][1] += value
            if labels.get("outcome") == "ok":
                out[cls][0] += value
        return {cls: (g, t) for cls, (g, t) in out.items()}

    @staticmethod
    def counts_from_counter(counter,
                            classes: Sequence[str] = REQUEST_CLASSES
                            ) -> Dict[str, Tuple[float, float]]:
        """A live {class, outcome} Counter instrument (the replica-local
        path — no scrape hop) -> {cls: (good, total)} cumulative."""
        out = {cls: [0.0, 0.0] for cls in classes}
        for key, value in counter.values().items():
            labels = dict(key)
            cls = labels.get("class")
            if cls not in out:
                continue
            out[cls][1] += value
            if labels.get("outcome") == "ok":
                out[cls][0] += value
        return {cls: (g, t) for cls, (g, t) in out.items()}

    def _baseline(self, now: float, window_s: float) -> Optional[tuple]:
        """Newest sample at or before the window start (falling back to
        the oldest sample when history is shorter than the window)."""
        base = None
        for t, counts in self._samples:
            if t <= now - window_s:
                base = (t, counts)
            else:
                break
        if base is None and self._samples:
            base = self._samples[0]
        return base

    def update(self, counts: Dict[str, Tuple[float, float]],
               now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Feed one cumulative sample; returns {cls: {window: burn}}
        and updates the gauge matrix. Fires `on_breach` outside the
        lock for classes newly over threshold on the fast window."""
        now = time.monotonic() if now is None else float(now)
        fired: List[Tuple[str, float]] = []
        burns: Dict[str, Dict[str, float]] = {}
        with self._lock:
            self._samples.append((now, dict(counts)))
            # keep one sample older than the slow window as its baseline
            while len(self._samples) >= 2 \
                    and self._samples[1][0] <= now - self.slow_window_s:
                self._samples.popleft()
            for window, window_s in (("short", self.fast_window_s),
                                     ("long", self.slow_window_s)):
                base = self._baseline(now, window_s)
                for cls in self.classes:
                    good, total = counts.get(cls, (0.0, 0.0))
                    bg, bt = (base[1].get(cls, (0.0, 0.0))
                              if base else (0.0, 0.0))
                    d_total = total - bt
                    d_bad = d_total - (good - bg)
                    burn = ((d_bad / d_total) / self.budget
                            if d_total > 0 else 0.0)
                    burns.setdefault(cls, {})[window] = burn
            over = {cls for cls in self.classes
                    if burns[cls]["short"] > self.threshold}
            fired = [(cls, burns[cls]["short"])
                     for cls in sorted(over - self._breached)]
            self._breached = over
        for cls, per_window in burns.items():
            for window, burn in per_window.items():
                self.gauge.set(round(burn, 6),
                               **{"class": cls, "window": window})
        if self.on_breach is not None:
            for cls, burn in fired:
                self.on_breach(cls, burn)
        return burns
