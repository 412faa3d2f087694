"""Heartbeat-based monitoring: keyed work/energy/accuracy windows + CSV logs.

Port copy of `pipeedge_tpu/monitoring/__init__.py` (the reference's
`monitoring/__init__.py` MonitorContext), with its two native dependencies
replaced as there:

- `apphb.Heartbeat` -> an in-module ring-buffer heartbeat (per-beat
  duration/work/energy/accuracy; instant = last beat, window = last
  `window_size` beats, global = everything).
- `energymon` -> a pluggable `EnergySource`. The default source reads the
  host's RAPL counters (`energy.py`) and is None where there are none, and
  then every energy/power metric reads 0, the reference's fallback when
  the energymon library is missing. The card's own power is not metered.

Semantics: the (instant | window | global) x (time | heartrate | work |
perf | energy | power | accuracy | accuracy-rate) getter matrix, per-beat
CSV rows with rates normalized to /s and W, reusable-context-manager
behavior, and a pickling block.

CSV logs are held-open file handles (one per key), with every row flushed
and an explicit `flush()` hook, so a run that dies mid-way leaves complete
records.
"""
from __future__ import annotations

import csv
import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Optional, Union

_NS_PER_S = 1_000_000_000


class EnergySource:
    """Interface for an energy meter; `get_uj()` returns cumulative microjoules."""

    def init(self) -> None:  # pragma: no cover - interface
        pass

    def finish(self) -> None:  # pragma: no cover - interface
        pass

    def get_uj(self) -> int:  # pragma: no cover - interface
        return 0

    def get_source(self) -> str:  # pragma: no cover - interface
        return "None"


@dataclasses.dataclass
class MonitorIterationContext:
    """In-flight iteration state — clients should not modify."""
    t_ns_last: Optional[int] = None
    e_uj_last: Optional[int] = None


@dataclasses.dataclass
class _Beat:
    duration_ns: int
    work: Union[int, float]
    energy_uj: int
    accuracy: Union[int, float]


class _Heartbeat:
    """Ring-buffer heartbeat with instant/window/global aggregation."""

    def __init__(self, window_size: int):
        assert window_size > 0
        self.window_size = window_size
        self._window = deque(maxlen=window_size)
        self._totals = _Beat(0, 0, 0, 0)
        self.count = 0

    def beat(self, duration_ns, work, energy_uj, accuracy):
        b = _Beat(duration_ns, work, energy_uj, accuracy)
        self._window.append(b)
        self._totals.duration_ns += duration_ns
        self._totals.work += work
        self._totals.energy_uj += energy_uj
        self._totals.accuracy += accuracy
        self.count += 1

    def _scope(self, scope: str):
        if scope == "instant":
            if not self._window:
                return _Beat(0, 0, 0, 0), 0
            return self._window[-1], 1
        if scope == "window":
            agg = _Beat(0, 0, 0, 0)
            for b in self._window:
                agg.duration_ns += b.duration_ns
                agg.work += b.work
                agg.energy_uj += b.energy_uj
                agg.accuracy += b.accuracy
            return agg, len(self._window)
        return self._totals, self.count

    def time_ns(self, scope): return self._scope(scope)[0].duration_ns

    def heartrate(self, scope):
        agg, n = self._scope(scope)
        return n * _NS_PER_S / agg.duration_ns if agg.duration_ns else 0.0

    def work(self, scope): return self._scope(scope)[0].work

    def perf(self, scope):
        agg, _ = self._scope(scope)
        return agg.work * _NS_PER_S / agg.duration_ns if agg.duration_ns else 0.0

    def energy_uj(self, scope): return self._scope(scope)[0].energy_uj

    def power_w(self, scope):
        agg, _ = self._scope(scope)
        # uJ/ns == 1000 W
        return agg.energy_uj * 1000 / agg.duration_ns if agg.duration_ns else 0.0

    def accuracy(self, scope): return self._scope(scope)[0].accuracy

    def accuracy_rate(self, scope):
        agg, _ = self._scope(scope)
        return agg.accuracy * _NS_PER_S / agg.duration_ns if agg.duration_ns else 0.0


_CSV_HEADER = ["Tag", "Time (ns)", "Heart Rate (/s)", "Work",
               "Performance (/s)", "Energy (uJ)", "Power (W)", "Accuracy",
               "Accuracy Rate (/s)"]


def _format_record(record):
    """High-precision floats, never exponential (as the reference writes them)."""
    return [f"{r:.15f}" if isinstance(r, float) else r for r in record]


@dataclasses.dataclass
class _KeyedState:
    hbt: _Heartbeat
    log_name: Optional[str] = None
    log_mode: str = "x"
    iter_ctx: MonitorIterationContext = dataclasses.field(
        default_factory=MonitorIterationContext)
    tag: int = 0
    # held-open CSV handle (opened by MonitorContext.open/add_heartbeat):
    # rows append to it without a reopen per beat, and every row is flushed
    # so a crashed process's post-mortem log never loses its tail
    log_file: Optional[Any] = None


class MonitorContext:
    """Top-level monitoring interface (reusable context manager, not reentrant).

    Parameters mirror the reference (monitoring/__init__.py:98-114), with
    `energy_source` (an `EnergySource` or None) replacing the energymon
    library name/getter pair.
    """

    def __init__(self, key: Any = None, window_size: int = 1,
                 log_name: Optional[str] = None, log_mode: str = "x",
                 energy_source: Optional[EnergySource] = None):
        self._initialized = False
        self._key = key
        self._states = {key: _KeyedState(_Heartbeat(window_size), log_name, log_mode)}
        self._em = energy_source

    def keys(self) -> tuple:
        return tuple(self._states.keys())

    def add_heartbeat(self, key: Any = None, window_size: Optional[int] = None,
                      log_name: Optional[str] = None,
                      log_mode: Optional[str] = None) -> None:
        """Add a heartbeat for a new key (monitoring/__init__.py:120-148)."""
        if key in self._states:
            raise ValueError(f"key already in use: {key}")
        if window_size is None:
            window_size = self.get_window_size(key=self._key)
        if log_mode is None:
            log_mode = self._states[self._key].log_mode
        self._states[key] = _KeyedState(_Heartbeat(window_size), log_name, log_mode)
        if self._initialized:
            self._log_header(self._states[key])

    def _log_header(self, state: _KeyedState) -> None:
        if state.log_name is not None:
            state.log_file = open(state.log_name, mode=state.log_mode,
                                  encoding="utf8")
            csv.writer(state.log_file, delimiter=",",
                       quoting=csv.QUOTE_MINIMAL).writerow(_CSV_HEADER)
            state.log_file.flush()

    def open(self) -> None:
        if self._initialized:
            raise RuntimeError("Monitor is already open")
        if self._em is not None:
            self._em.init()
        self._initialized = True
        for state in self._states.values():
            self._log_header(state)

    def flush(self) -> None:
        """Push buffered CSV rows to the OS — the fleet-abort / failover
        hook that makes post-mortem records survive whatever comes next."""
        for state in self._states.values():
            if state.log_file is not None and not state.log_file.closed:
                state.log_file.flush()

    def close(self) -> None:
        self._initialized = False
        for state in self._states.values():
            if state.log_file is not None and not state.log_file.closed:
                state.log_file.close()
            state.log_file = None
        if self._em is not None:
            self._em.finish()

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("Monitor is not open")

    def iteration_start(self, key: Any = None,
                        iter_ctx: Optional[MonitorIterationContext] = None) -> None:
        """Begin a measurement (monitoring/__init__.py:170-187)."""
        self._check_init()
        if iter_ctx is None:
            iter_ctx = self._states[key].iter_ctx
        iter_ctx.t_ns_last = time.monotonic_ns()
        iter_ctx.e_uj_last = 0 if self._em is None else self._em.get_uj()

    def iteration_reset(self, key: Any = None) -> None:
        """Forget the key's shared last-beat baseline: the next
        start-less `iteration` becomes a fresh first beat instead of
        recording the idle gap since the previous beat as one giant
        iteration (beat-to-beat consumers crossing an idle boundary,
        e.g. a DCN re-schedule round)."""
        self._check_init()
        iter_ctx = self._states[key].iter_ctx
        iter_ctx.t_ns_last = None
        iter_ctx.e_uj_last = None

    def iteration(self, key: Any = None, work: int = 1,
                  accuracy: Union[int, float] = 1,
                  iter_ctx: Optional[MonitorIterationContext] = None) -> None:
        """Complete a measurement and emit a heartbeat + CSV row
        (monitoring/__init__.py:189-226)."""
        self._check_init()
        t_ns = time.monotonic_ns()
        e_uj = 0 if self._em is None else self._em.get_uj()
        state = self._states[key]
        if iter_ctx is None:
            iter_ctx = state.iter_ctx
        # calling without a prior start makes this call the start
        if iter_ctx.t_ns_last is not None:
            state.hbt.beat(t_ns - iter_ctx.t_ns_last, work,
                           e_uj - iter_ctx.e_uj_last, accuracy)
            state.tag += 1
            if state.log_file is not None and not state.log_file.closed:
                hbt = state.hbt
                rec = [state.tag - 1, hbt.time_ns("instant"),
                       hbt.heartrate("instant"), hbt.work("instant"),
                       hbt.perf("instant"), hbt.energy_uj("instant"),
                       hbt.power_w("instant"), hbt.accuracy("instant"),
                       hbt.accuracy_rate("instant")]
                csv.writer(state.log_file, delimiter=",",
                           quoting=csv.QUOTE_MINIMAL
                           ).writerow(_format_record(rec))
                state.log_file.flush()
        iter_ctx.t_ns_last = t_ns
        iter_ctx.e_uj_last = e_uj

    # getter matrix: (instant | window | global) x 8 metrics
    def get_instant_time_s(self, key=None): return self._states[key].hbt.time_ns("instant") / _NS_PER_S
    def get_instant_heartrate(self, key=None): return self._states[key].hbt.heartrate("instant")
    def get_instant_work(self, key=None): return self._states[key].hbt.work("instant")
    def get_instant_perf(self, key=None): return self._states[key].hbt.perf("instant")
    def get_instant_energy_j(self, key=None): return self._states[key].hbt.energy_uj("instant") / 1e6
    def get_instant_power_w(self, key=None): return self._states[key].hbt.power_w("instant")
    def get_instant_accuracy(self, key=None): return self._states[key].hbt.accuracy("instant")
    def get_instant_accuracy_rate(self, key=None): return self._states[key].hbt.accuracy_rate("instant")

    def get_window_time_s(self, key=None): return self._states[key].hbt.time_ns("window") / _NS_PER_S
    def get_window_heartrate(self, key=None): return self._states[key].hbt.heartrate("window")
    def get_window_work(self, key=None): return self._states[key].hbt.work("window")
    def get_window_perf(self, key=None): return self._states[key].hbt.perf("window")
    def get_window_energy_j(self, key=None): return self._states[key].hbt.energy_uj("window") / 1e6
    def get_window_power_w(self, key=None): return self._states[key].hbt.power_w("window")
    def get_window_accuracy(self, key=None): return self._states[key].hbt.accuracy("window")
    def get_window_accuracy_rate(self, key=None): return self._states[key].hbt.accuracy_rate("window")

    def get_global_time_s(self, key=None): return self._states[key].hbt.time_ns("global") / _NS_PER_S
    def get_global_heartrate(self, key=None): return self._states[key].hbt.heartrate("global")
    def get_global_work(self, key=None): return self._states[key].hbt.work("global")
    def get_global_perf(self, key=None): return self._states[key].hbt.perf("global")
    def get_global_energy_j(self, key=None): return self._states[key].hbt.energy_uj("global") / 1e6
    def get_global_power_w(self, key=None): return self._states[key].hbt.power_w("global")
    def get_global_accuracy(self, key=None): return self._states[key].hbt.accuracy("global")
    def get_global_accuracy_rate(self, key=None): return self._states[key].hbt.accuracy_rate("global")

    # the 8 metrics of the getter matrix, as (name, per-scope accessor)
    _SNAPSHOT_METRICS = (
        ("time_s", lambda h, s: h.time_ns(s) / _NS_PER_S),
        ("heartrate", lambda h, s: h.heartrate(s)),
        ("work", lambda h, s: h.work(s)),
        ("perf", lambda h, s: h.perf(s)),
        ("energy_j", lambda h, s: h.energy_uj(s) / 1e6),
        ("power_w", lambda h, s: h.power_w(s)),
        ("accuracy", lambda h, s: h.accuracy(s)),
        ("accuracy_rate", lambda h, s: h.accuracy_rate(s)),
    )

    def snapshot(self) -> dict:
        """The whole (instant | window | global) x metric getter matrix for
        every key as ONE dict — `{key: {scope: {metric: value}, "tag": n,
        "window_size": n}}` — so telemetry/metrics exporters read the
        monitoring state in one call instead of reaching into the per-key
        getters one at a time."""
        out = {}
        for key, state in self._states.items():
            hbt = state.hbt
            entry: dict = {
                scope: {name: fn(hbt, scope)
                        for name, fn in self._SNAPSHOT_METRICS}
                for scope in ("instant", "window", "global")}
            entry["tag"] = state.tag
            entry["window_size"] = hbt.window_size
            out[key] = entry
        return out

    def get_tag(self, key: Any = None) -> int:
        """The next tag (== completed heartbeat count)."""
        return self._states[key].tag

    def get_window_size(self, key: Any = None) -> int:
        return self._states[key].hbt.window_size

    @property
    def initialized(self) -> bool:
        return self._initialized

    @property
    def energy_source(self) -> str:
        return "None" if self._em is None else self._em.get_source()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *args):
        self.close()

    def __del__(self):
        if self._initialized:
            warnings.warn("unclosed monitor", category=ResourceWarning, source=self)
            self.close()

    def __getstate__(self):
        raise TypeError(f"Cannot pickle {self.__class__.__name__!r} object")
