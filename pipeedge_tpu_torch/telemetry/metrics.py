"""Minimal Prometheus-text-format metrics registry (stdlib only).

Port copy of `pipeedge_tpu/telemetry/metrics.py`: the family names,
label sets and text format are the JAX package's, so a dashboard over
the JAX server reads the port's.

The /metrics plane of the serving surface (tools/serve.py) and anything
else that wants scrapeable counters: no client library ships in the
container, and the text exposition format is simple enough to emit
directly (https://prometheus.io/docs/instrumenting/exposition_formats/).

Supported instrument types: Counter (monotonic), Gauge (set), Histogram
(cumulative buckets + _sum/_count). All are label-aware — a label-set is a
frozen sorted tuple of (key, value) pairs — and thread-safe under one
registry lock (instrument updates are a dict update + float add; the lock
is never held across I/O).

`REGISTRY` is the process default; `get_or_create` makes module-level
instrument declaration idempotent (serve restarts its service object
without restarting the process in tests).
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.threads import make_lock

DEFAULT_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                           1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers bare, floats compact."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return f"{v:.10g}"


def _escape(v: str) -> str:
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = make_lock(f"metrics.{name}")

    def _key(self, labels: dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def declare(self, **labels) -> None:
        """Pre-register a label set at 0 so the series renders before its
        first increment (scrapers see the full per-edge matrix up front)."""
        key = self._key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label set — the headline number for a labeled
        counter (e.g. sheds across all (class, reason) pairs)."""
        with self._lock:
            return sum(self._values.values())

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Snapshot of every (label-set, value) pair."""
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_label_str(k)} {_fmt(v)}" for k, v in items]


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(self._key(labels))

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_label_str(k)} {_fmt(v)}" for k, v in items]


class Histogram(_Instrument):
    kind = "histogram"

    # horizon after which a retained exemplar is considered stale and any
    # fresh observation replaces it (the "per bucket window" semantics:
    # within a window the MAX-latency observation's trace id is kept)
    DEFAULT_EXEMPLAR_WINDOW_S = 60.0

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 exemplar_window_s: Optional[float] = None):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # label key -> (per-bucket counts, sum, count)
        self._series: Dict[Tuple, list] = {}
        # label key -> bucket index -> [value, trace_id, t] — the trace id
        # of the worst (max-value) observation in the current window, so a
        # p99 spike on a dashboard links straight to the request trace
        # that caused it (docs/OBSERVABILITY.md exemplar semantics). The
        # index len(buckets) is the +Inf overflow bucket.
        self.exemplar_window_s = (self.DEFAULT_EXEMPLAR_WINDOW_S
                                  if exemplar_window_s is None
                                  else float(exemplar_window_s))
        self._exemplars: Dict[Tuple, Dict[int, list]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                now: Optional[float] = None, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = s
            counts, _, _ = s
            # per-bucket (non-cumulative) storage; render() cumulates
            idx = len(self.buckets)          # +Inf overflow by default
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    idx = i
                    break
            s[1] += float(value)
            s[2] += 1
            if exemplar is not None:
                now = time.monotonic() if now is None else now
                ex = self._exemplars.setdefault(key, {})
                cur = ex.get(idx)
                # retain the max-latency observation of the window; a
                # stale (rolled-over) exemplar loses to ANY fresh one
                if cur is None or value >= cur[0] \
                        or now - cur[2] > self.exemplar_window_s:
                    ex[idx] = [float(value), str(exemplar), now]

    def exemplars(self, now: Optional[float] = None,
                  **labels) -> Dict[str, dict]:
        """Current (unexpired) exemplars for one label set:
        `{le: {"value", "trace_id", "age_s"}}` with `le` the bucket's
        upper bound as a string ("+Inf" for the overflow bucket). The
        /healthz-facing view; /metrics renders the same data as
        `# EXEMPLAR` comment lines."""
        now = time.monotonic() if now is None else now
        out: Dict[str, dict] = {}
        with self._lock:
            ex = self._exemplars.get(self._key(labels), {})
            items = [(i, list(v)) for i, v in ex.items()]
        for i, (value, trace_id, t) in sorted(items):
            if now - t > self.exemplar_window_s:
                continue
            le = ("+Inf" if i >= len(self.buckets)
                  else _fmt(self.buckets[i]))
            out[le] = {"value": round(value, 6), "trace_id": trace_id,
                       "age_s": round(max(0.0, now - t), 3)}
        return out

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s[2] if s else 0

    def snapshot(self, **labels) -> Tuple[List[int], int]:
        """Copy of (per-bucket counts, total observation count) for one
        label set — the raw material for WINDOWED percentiles: diff two
        snapshots and feed the delta to `percentile_from_counts` (the
        brownout governor's p95-over-the-last-interval read)."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if s is None:
                return [0] * len(self.buckets), 0
            return list(s[0]), s[2]

    def percentile(self, q: float, **labels) -> Optional[float]:
        """All-time nearest-bucket-upper-bound percentile (None when the
        series has no observations)."""
        counts, n = self.snapshot(**labels)
        return percentile_from_counts(self.buckets, counts, n, q)

    def render(self) -> List[str]:
        # ONE lock acquisition captures both the bucket counts and the
        # exemplar table: a concurrent observe() between two separate
        # acquisitions could roll an exemplar over mid-render, making
        # the rendered counts and `# EXEMPLAR` lines disagree (dropped
        # or duplicated lines under a racing scrape). Formatting — the
        # slow part — happens outside the lock on the copies.
        now = time.monotonic()
        with self._lock:
            items = sorted((k, (list(s[0]), s[1], s[2]))
                           for k, s in self._series.items())
            exemplars = {k: [(i, list(v))
                             for i, v in sorted(self._exemplars
                                                .get(k, {}).items())]
                         for k, _ in items}
        lines = []
        for key, (counts, total, n) in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                lk = key + (("le", _fmt(bound)),)
                lines.append(f"{self.name}_bucket{_label_str(lk)} {cum}")
            lk = key + (("le", "+Inf"),)
            lines.append(f"{self.name}_bucket{_label_str(lk)} {n}")
            lines.append(f"{self.name}_sum{_label_str(key)} {_fmt(total)}")
            lines.append(f"{self.name}_count{_label_str(key)} {n}")
            # exemplars as COMMENT lines: the exposition stays valid
            # Prometheus text format 0.0.4 (every parser skips '#' lines
            # that are not HELP/TYPE), while the p99-spike -> trace-id
            # link is still one grep away (OpenMetrics-shaped payload)
            for idx, (value, trace_id, t) in exemplars.get(key, ()):
                if now - t > self.exemplar_window_s:
                    continue
                le = ("+Inf" if idx >= len(self.buckets)
                      else _fmt(self.buckets[idx]))
                lk = key + (("le", le),)
                lines.append(
                    f"# EXEMPLAR {self.name}_bucket{_label_str(lk)} "
                    f'{{trace_id="{_escape(trace_id)}"}} '
                    f"{_fmt(value)}")
        return lines

    def _key(self, labels: dict):
        if "le" in labels:
            raise ValueError("'le' is reserved for histogram buckets")
        return super()._key(labels)


class Registry:
    """Named instrument collection rendering to Prometheus text format."""

    def __init__(self):
        self._lock = make_lock("metrics.registry")
        self._instruments: Dict[str, _Instrument] = {}

    def register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            cur = self._instruments.get(inst.name)
            if cur is not None:
                raise ValueError(f"metric already registered: {inst.name}")
            self._instruments[inst.name] = inst
        return inst

    def get_or_create(self, cls, name: str, help_text: str, **kwargs):
        """Idempotent declaration: the existing instrument when the name is
        taken (must be the same type), else a fresh registration."""
        with self._lock:
            cur = self._instruments.get(name)
            if cur is not None:
                if not isinstance(cur, cls):
                    raise ValueError(
                        f"metric {name} already registered as {cur.kind}")
                return cur
            inst = cls(name, help_text, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help_text: str) -> Counter:
        return self.get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str) -> Gauge:
        return self.get_or_create(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self.get_or_create(Histogram, name, help_text,
                                  buckets=buckets)

    def render(self, extra: Iterable[str] = ()) -> str:
        """The full exposition document (trailing newline included, as the
        format requires). `extra` lines (already formatted) append at the
        end — e.g. the monitoring-snapshot gauges."""
        with self._lock:
            insts = [self._instruments[k]
                     for k in sorted(self._instruments)]
        out: List[str] = []
        for inst in insts:
            out.append(f"# HELP {inst.name} {inst.help}")
            out.append(f"# TYPE {inst.name} {inst.kind}")
            out.extend(inst.render())
        out.extend(extra)
        return "\n".join(out) + "\n"


REGISTRY = Registry()


def percentile_from_counts(buckets: Sequence[float], counts: Sequence[int],
                           n: int, q: float) -> Optional[float]:
    """Nearest-bucket-upper-bound percentile from a (possibly differenced)
    histogram window: the smallest bucket bound whose cumulative count
    covers rank q. `n` may exceed sum(counts) — observations above the
    last finite bucket live only in the total — in which case a rank
    falling into that overflow returns +inf (honestly 'worse than every
    bound', which is exactly what an overload watermark wants to see).
    Returns None for an empty window."""
    if n <= 0:
        return None
    rank = q / 100.0 * n
    cum = 0
    for bound, c in zip(buckets, counts):
        cum += c
        if cum >= rank:
            return float(bound)
    return float("inf")


_EXEMPLAR_RE = None


def parse_exemplars(text: str, family: str) -> List[dict]:
    """The client side of the `# EXEMPLAR` exposition contract: parse a
    rendered /metrics document back into `{le, trace_id, value}` rows for
    one histogram family — how the benchkit serve recipe lifts the
    p99-bucket -> trace-id links off a live server into its trajectory
    record (value is the observation in the instrument's native unit,
    seconds for latency histograms)."""
    global _EXEMPLAR_RE  # pylint: disable=global-statement
    import re
    if _EXEMPLAR_RE is None:
        _EXEMPLAR_RE = re.compile(
            r'^# EXEMPLAR (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
            r'\{(?P<labels>[^}]*)\} '
            r'\{trace_id="(?P<trace_id>[^"]*)"\} '
            r'(?P<value>[-+0-9.eEinf]+)$')
    out: List[dict] = []
    for line in text.splitlines():
        m = _EXEMPLAR_RE.match(line)
        if m is None or m.group("name") != f"{family}_bucket":
            continue
        le = None
        for pair in m.group("labels").split(","):
            if pair.startswith('le="'):
                le = pair[4:-1]
        if le is None:
            continue
        out.append({"le": le, "trace_id": m.group("trace_id"),
                    "value": float(m.group("value"))})
    return out


def render_monitoring_snapshot(snapshot: dict,
                               prefix: str = "pipeedge_monitor") -> List[str]:
    """Monitoring's `snapshot()` matrix (key -> scope -> metric -> value)
    as gauge lines — the bridge that lets /metrics expose every monitoring
    key without reaching into the per-key getter matrix one call at a time
    (monitoring.snapshot() is the one synchronized read)."""
    lines = []
    names = set()
    rows = []
    for key in sorted(snapshot):
        scopes = snapshot[key]
        for scope in ("instant", "window", "global"):
            for metric, value in sorted(scopes.get(scope, {}).items()):
                name = f"{prefix}_{metric}"
                names.add(name)
                rows.append((name, key, scope, value))
    for name in sorted(names):
        lines.append(f"# HELP {name} monitoring snapshot metric")
        lines.append(f"# TYPE {name} gauge")
        for n, key, scope, value in rows:
            if n == name:
                lines.append(
                    f'{name}{{key="{key}",scope="{scope}"}} '
                    f"{_fmt(float(value))}")
    return lines
