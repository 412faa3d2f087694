"""Fleet collector + SLO burn-rate engine.

The port's copy of `pipeedge_tpu/telemetry/collector.py`, word for word
but for this docstring. It makes the routed fleet observable as ONE
system:

- **FleetCollector**: the router-side scraper. Periodically pulls
  `/metrics` from every registered replica into a bounded in-memory
  time-series ring, and aggregates the rings into the `GET /fleet` body:
  per-class goodput / shed / queue-depth, per-replica health with
  windowed deltas, and the union of latency exemplars re-rendered
  through the `parse_exemplars` exposition contract (round trip:
  `parse_exemplars(fleet["exemplars_text"], family)` yields the same
  rows). Scraping is plain text-format parsing: the collector consumes
  the same surface any external Prometheus would.
- **BurnRateEngine**: multi-window error-budget burn rates from the
  per-class outcome counters. burn = (bad fraction over the window) /
  (1 - objective); 1.0 means the error budget is being consumed exactly
  at the sustainable rate. Exported as the pre-declared
  `pipeedge_slo_burn_rate{class,window}` gauge matrix and edge-triggered
  into the flight recorder's `slo_burn` postmortem trigger when the fast
  window breaches.
- **debug_spans_payload / parse_prom_text**: the per-process
  `GET /debug/spans` ring-drain body (span rows + a peer monotonic
  stamp for the clock-offset estimator) and the minimal Prometheus text
  parser the scrape path rides.

Everything is injectable (fetch_fn, targets_fn, now=) so the whole
plane unit-tests without sockets; `serve.py --role router` wires the
real HTTP.
"""
from __future__ import annotations

import os
import re
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import recorder as _recorder_fn
from . import metrics as prom
from ..utils.threads import make_lock

REQUEST_CLASSES = ("interactive", "batch", "best_effort")
BURN_WINDOWS = ("short", "long")

# the families /fleet aggregates, by their exposition names
CLASS_FAMILY = "pipeedge_requests_by_class_total"
LATENCY_FAMILY = "pipeedge_serve_request_latency_seconds"
QUEUE_FAMILY = "pipeedge_admission_queue_depth"
BROWNOUT_FAMILY = "pipeedge_brownout_level"

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


def render_exemplar_lines(family: str,
                          rows: Sequence[dict]) -> List[str]:
    """`{le, trace_id, value}` rows -> `# EXEMPLAR` exposition lines in
    the exact shape `metrics.parse_exemplars` parses back — the /fleet
    union keeps the contract the per-replica /metrics established."""
    lines = []
    for row in rows:
        lines.append(
            f'# EXEMPLAR {family}_bucket{{le="{row["le"]}"}} '
            f'{{trace_id="{row["trace_id"]}"}} '
            f'{prom._fmt(float(row["value"]))}')
    return lines


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


def http_fetch_text(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


class FleetCollector:
    """The router's scrape loop + aggregation surface.

    `targets_fn()` returns the CURRENT {name: base_url} scrape set
    (replicas come and go — membership is re-read every tick), and
    each target's parsed /metrics lands in a per-target bounded ring
    (`history` samples). `fleet_snapshot()` is the GET /fleet body."""

    def __init__(self, targets_fn: Callable[[], Dict[str, str]],
                 interval_s: float = 1.0,
                 history: int = 120,
                 timeout_s: float = 2.0,
                 fetch_fn: Optional[Callable[[str, float], str]] = None,
                 burn: Optional[BurnRateEngine] = None,
                 classes: Sequence[str] = REQUEST_CLASSES):
        self.targets_fn = targets_fn
        self.interval_s = float(interval_s)
        self.history = int(history)
        self.timeout_s = float(timeout_s)
        self.fetch = fetch_fn or http_fetch_text
        self.burn = burn
        self.classes = tuple(classes)
        self._lock = make_lock("telemetry.collector")
        self._rings: Dict[str, deque] = {}
        self._urls: Dict[str, str] = {}
        self._scrapes = 0
        self._errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.m_scrapes = prom.REGISTRY.counter(
            "pipeedge_fleet_scrapes_total",
            "fleet collector scrape attempts, by result")
        for res in ("ok", "error"):
            self.m_scrapes.declare(result=res)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-collector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:        # noqa: BLE001 — scrape must not die
                self._errors += 1

    # -- scraping ---------------------------------------------------------

    def scrape_once(self, now: Optional[float] = None) -> int:
        """Scrape every current target once; returns how many answered."""
        now = time.monotonic() if now is None else float(now)
        targets = dict(self.targets_fn())
        ok = 0
        for name, url in targets.items():
            sample = {"t": now, "ok": False, "families": {},
                      "exemplars": []}
            try:
                text = self.fetch(f"{url}/metrics", self.timeout_s)
                sample["families"] = parse_prom_text(
                    text, families=(CLASS_FAMILY, QUEUE_FAMILY,
                                    BROWNOUT_FAMILY))
                sample["exemplars"] = prom.parse_exemplars(
                    text, LATENCY_FAMILY)
                sample["ok"] = True
                ok += 1
                self.m_scrapes.inc(result="ok")
            except (OSError, ValueError):
                self._errors += 1
                self.m_scrapes.inc(result="error")
            with self._lock:
                ring = self._rings.get(name)
                if ring is None:
                    ring = deque(maxlen=self.history)
                    self._rings[name] = ring
                ring.append(sample)
                self._urls[name] = url
                self._scrapes += 1
        if self.burn is not None:
            self.burn.update(self._fleet_counts(), now=now)
        return ok

    def _fleet_counts(self) -> Dict[str, Tuple[float, float]]:
        """Latest cumulative per-class (good, total) summed across all
        targets' most recent good sample."""
        totals = {cls: [0.0, 0.0] for cls in self.classes}
        with self._lock:
            rings = {n: list(r) for n, r in self._rings.items()}
        for samples in rings.values():
            latest = next((s for s in reversed(samples) if s["ok"]), None)
            if latest is None:
                continue
            counts = BurnRateEngine.counts_from_families(
                latest["families"], classes=self.classes)
            for cls, (g, t) in counts.items():
                totals[cls][0] += g
                totals[cls][1] += t
        return {cls: (g, t) for cls, (g, t) in totals.items()}

    # -- aggregation ------------------------------------------------------

    def fleet_snapshot(self, now: Optional[float] = None) -> dict:
        """The GET /fleet body: per-class fleet aggregates, per-replica
        health + windowed deltas, the exemplar union (round-trippable
        through `parse_exemplars`), and the burn-rate matrix."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            rings = {n: list(r) for n, r in self._rings.items()}
            urls = dict(self._urls)
            scrapes, errors = self._scrapes, self._errors
        classes = {cls: {"goodput_rps": 0.0, "shed_rps": 0.0,
                         "requests_total": 0.0, "ok_total": 0.0,
                         "window_attainment": None}
                   for cls in self.classes}
        replicas = {}
        exemplar_union: Dict[str, dict] = {}
        queue_depth = 0.0
        brownout_level = 0
        cls_window: Dict[str, List[float]] = {
            cls: [0.0, 0.0, 0.0] for cls in self.classes}  # dok, dtot, dshed
        for name, samples in rings.items():
            latest = next((s for s in reversed(samples) if s["ok"]), None)
            rec = {"url": urls.get(name),
                   "ok": bool(samples and samples[-1]["ok"]),
                   "samples": len(samples),
                   "age_s": (round(now - samples[-1]["t"], 3)
                             if samples else None)}
            if latest is None:
                rec["requests"] = {}
                replicas[name] = rec
                continue
            counts = BurnRateEngine.counts_from_families(
                latest["families"], classes=self.classes)
            for cls, (g, t) in counts.items():
                classes[cls]["ok_total"] += g
                classes[cls]["requests_total"] += t
            for labels, value in latest["families"].get(QUEUE_FAMILY, ()):
                queue_depth += value
            # the fleet's brownout rung is the MAX across targets: one
            # replica shedding work is enough to order autoscale
            # scale-down behind brownout (serving/autoscale.py)
            for labels, value in latest["families"].get(
                    BROWNOUT_FAMILY, ()):
                brownout_level = max(brownout_level, int(value))
            # windowed deltas: latest good sample vs the oldest good one
            oldest = next((s for s in samples if s["ok"]), None)
            window_s = max(1e-9, latest["t"] - oldest["t"]) \
                if oldest is not latest else None
            rec["requests"] = {cls: round(t, 1)
                               for cls, (_, t) in counts.items()}
            if window_s is not None:
                base = BurnRateEngine.counts_from_families(
                    oldest["families"], classes=self.classes)
                goodput = {}
                for cls in self.classes:
                    dg = counts[cls][0] - base[cls][0]
                    dt = counts[cls][1] - base[cls][1]
                    goodput[cls] = round(dg / window_s, 3)
                    w = cls_window[cls]
                    w[0] += dg
                    w[1] += dt
                    w[2] += (dt - dg)
                    classes[cls]["goodput_rps"] += dg / window_s
                    classes[cls]["shed_rps"] += (dt - dg) / window_s
                rec["window_s"] = round(window_s, 3)
                rec["goodput_rps"] = goodput
            for row in latest["exemplars"]:
                cur = exemplar_union.get(row["le"])
                if cur is None or row["value"] > cur["value"]:
                    exemplar_union[row["le"]] = dict(row)
            replicas[name] = rec
        for cls in self.classes:
            dok, dtot, _ = cls_window[cls]
            classes[cls]["window_attainment"] = \
                round(dok / dtot, 4) if dtot > 0 else None
            classes[cls]["goodput_rps"] = round(
                classes[cls]["goodput_rps"], 3)
            classes[cls]["shed_rps"] = round(classes[cls]["shed_rps"], 3)
        union_rows = [exemplar_union[le]
                      for le in sorted(exemplar_union,
                                       key=lambda s: float(
                                           s.replace("+Inf", "inf")))]
        out = {
            "interval_s": self.interval_s,
            "history": self.history,
            "scrapes": scrapes,
            "scrape_errors": errors,
            "targets": urls,
            "replicas": replicas,
            "classes": classes,
            "queue_depth": queue_depth,
            "brownout_level": brownout_level,
            "latency_family": LATENCY_FAMILY,
            "exemplars": union_rows,
            "exemplars_text": "\n".join(render_exemplar_lines(
                LATENCY_FAMILY, union_rows)),
        }
        if self.burn is not None:
            out["slo"] = {
                "objective": self.burn.objective,
                "threshold": self.burn.threshold,
                "windows_s": {"short": self.burn.fast_window_s,
                              "long": self.burn.slow_window_s},
                "burn_rate": self.burn.update(self._fleet_counts(),
                                              now=now),
            }
        return out
