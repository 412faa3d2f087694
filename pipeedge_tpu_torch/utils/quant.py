"""Adaptive quantization bitwidth policies (QuantPipe).

Port copy of `pipeedge_tpu/utils/quant.py` (the reference's
`utils/quant.py`):
- `constrain_max_bitwidth`: largest bitwidth meeting a data-movement time
  constraint given *discrete* packing (only integer values per uint32 word
  pack, so e.g. bit=7 compresses no better than bit=8);
- `AdaptiveBitwidthPerformanceController`: maps a performance target to a
  (bitwidth1, bitwidth2, iterations-in-bitwidth1) window split, modeling
  speedup as max_bit/bit (POET-style rate splitting, after Hoffmann et al.).

Host-side numpy and plain Python: these run between pipeline windows and
set a stage's `quant_bit` for the next microbatches.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..ops.quant import compression_factor
from .controller import AdaptiveIntegralXupController

# Largest bitwidths in [2, 32] with unique discrete compression factors
# (reference runtime.py:177-179): 32/b changes only at divisors.
BITWIDTHS = [b for b in range(32, 1, -1)
             if int(compression_factor(b)) > int(compression_factor(b + 1))]


def constrain_max_bitwidth(t_max: float, d_size: float, d_speed: float,
                           bw_max: int) -> int:
    """Largest bitwidth whose *discrete* compression meets the time constraint.

    Returns 0 if even full compression cannot satisfy it. Units of `d_size`
    and `d_speed` must agree (e.g. Mbit and Mbit/s).
    """
    bitwidths = np.arange(bw_max, -1, -1, dtype=int)
    # discrete packing: effective scale = 1 / floor(32/bit); bitwidth 0 -> 0
    scales = np.concatenate([
        1.0 / np.floor(32.0 / bitwidths[:-1].astype(float)).astype(int),
        [0.0]])
    scale = np.inf if d_size == 0 else d_speed * t_max / d_size
    return int(bitwidths[scale >= scales][0])


class AdaptiveBitwidthPerformanceController(AdaptiveIntegralXupController):
    """Compute bitwidths meeting a data-movement performance constraint.

    Speedup model: xup(b) = max_bitwidth / b (perfect packing, no metadata
    overhead). The controller picks the two adjacent achievable speedups
    bracketing the target and splits the window between them.
    """

    def __init__(self, perf_constraint: float, bitwidths: List[int],
                 bitwidth_start: int):
        self._bitwidths = sorted(bitwidths, reverse=True)
        self._speedups = [self._bitwidths[0] / b for b in self._bitwidths]
        u_0 = self._bitwidths[0] / bitwidth_start
        super().__init__(perf_constraint, u_0, u_max=self._speedups[-1])

    def __call__(self, perf_measured: float, window_len: int) -> Tuple[int, int, int]:
        """Returns (bitwidth1, bitwidth2, iterations to spend in bitwidth1
        during the next window)."""
        xup_targ = super().__call__(perf_measured)
        idx_slow = max(0, len([s for s in self._speedups if s <= xup_targ]) - 1)
        idx_fast = min(idx_slow + 1, len(self._speedups) - 1)
        xup_slow = self._speedups[idx_slow]
        xup_fast = self._speedups[idx_fast]
        # Window split x solving 1/target = x/slow + (1-x)/fast:
        if math.isclose(xup_slow, xup_fast):
            frac = 0.0
        else:
            frac = (xup_slow * (xup_fast - xup_targ)) / \
                   (xup_targ * (xup_fast - xup_slow))
        return (self._bitwidths[idx_slow], self._bitwidths[idx_fast],
                round(window_len * frac))
