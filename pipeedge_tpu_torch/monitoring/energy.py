"""Concrete energy sources for the monitoring subsystem.

Port copy of `pipeedge_tpu/monitoring/energy.py`. The reference meters
energy through the `energymon` native library, with a graceful fallback
when it is missing or not permitted. The equivalent here is the Linux
powercap/RAPL sysfs counters, which cover the host CPU package(s).
`default_energy_source()` keeps the reference's fallback contract: it
returns None (all energy/power metrics read 0) when no readable counter
exists, which is the common case inside a container.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional

from . import EnergySource

logger = logging.getLogger(__name__)

_POWERCAP_ROOT = "/sys/class/powercap"


class RaplEnergySource(EnergySource):
    """Cumulative microjoules from powercap RAPL package domains.

    Sums every readable top-level `intel-rapl:<n>/energy_uj` counter and
    handles counter wraparound via `max_energy_range_uj` (the counters are
    typically 32-bit-ish and wrap within hours under load).
    """

    def __init__(self, root: str = _POWERCAP_ROOT):
        self._root = root
        self._domains: List[str] = []
        self._ranges: List[int] = []
        self._last: List[int] = []
        self._wrap_uj: List[int] = []

    def init(self) -> None:
        pattern = os.path.join(self._root, "intel-rapl:[0-9]*")
        for d in sorted(glob.glob(pattern)):
            if not os.path.basename(d).count(":") == 1:
                continue  # skip subdomains like intel-rapl:0:0
            path = os.path.join(d, "energy_uj")
            try:
                with open(path, encoding="ascii") as f:
                    first = int(f.read().strip())
            except (OSError, ValueError):
                continue  # unreadable (permissions) or malformed
            try:
                with open(os.path.join(d, "max_energy_range_uj"),
                          encoding="ascii") as f:
                    rng = int(f.read().strip())
            except (OSError, ValueError):
                rng = 0
            self._domains.append(path)
            self._ranges.append(rng)
            self._last.append(first)
            self._wrap_uj.append(0)
        if not self._domains:
            raise RuntimeError(f"no readable RAPL domains under {self._root}")

    def finish(self) -> None:
        self._domains = []

    def get_uj(self) -> int:
        total = 0
        for i, path in enumerate(self._domains):
            try:
                with open(path, encoding="ascii") as f:
                    now = int(f.read().strip())
            except (OSError, ValueError):
                # Transient read failure: report the last known value so the
                # cumulative total never goes backwards (a dropped domain
                # would make this iteration's delta hugely negative).
                total += self._last[i] + self._wrap_uj[i]
                continue
            if now < self._last[i]:
                # Counter wrapped. When the range is unreadable (rng==0),
                # the best wrap estimate is the last observed value.
                self._wrap_uj[i] += self._ranges[i] if self._ranges[i] > 0 \
                    else self._last[i]
            self._last[i] = now
            total += now + self._wrap_uj[i]
        return total

    def get_source(self) -> str:
        return f"RAPL({len(self._domains)} domains)" if self._domains \
            else "RAPL(uninitialized)"


def default_energy_source(root: str = _POWERCAP_ROOT) \
        -> Optional[EnergySource]:
    """A working `RaplEnergySource`, or None when the host exposes no
    readable counters (the reference's graceful fallback)."""
    src = RaplEnergySource(root)
    try:
        src.init()
    except RuntimeError as exc:
        logger.info("energy metering unavailable: %s", exc)
        return None
    src.finish()
    return RaplEnergySource(root)
