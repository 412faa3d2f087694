"""Opt-in NaN/Inf activation guard at stage boundaries.

Port copy of `pipeedge_tpu/health/guard.py`; the finiteness check reads
`torch` tensors (and numpy arrays) where the JAX package reads its
arrays.

A poisoned microbatch — a NaN or Inf produced by a numerics bug, a
corrupted frame that slipped past integrity checks, or a degrading
accelerator — propagates silently: every downstream stage happily
multiplies garbage, and the failure surfaces as wrong answers, not an
error. With `PIPEEDGE_NAN_GUARD=1` the runtime checks activations at
stage boundaries and converts the first poisoned payload into a NAMED
error (`PoisonedActivationError`), a flight-recorder postmortem bundle
(trigger `poison`), and a `pipeedge_poisoned_microbatches_total` bump —
the microbatch dies loudly at the boundary where the poison appeared.

Opt-in because the check is a host sync (`torch.isfinite(...).all()`
forces the value): the steady-state overlap the DCN stage split buys
(docs/DCN_WIRE.md) is exactly what a per-microbatch sync spends. Turn it
on when chasing a numerics incident, leave it off on the hot path.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from ..telemetry import flight
from ..telemetry import metrics as prom

logger = logging.getLogger(__name__)

ENV_NAN_GUARD = "PIPEEDGE_NAN_GUARD"

_POISONED = prom.REGISTRY.counter(
    "pipeedge_poisoned_microbatches_total",
    "microbatches whose activations failed the NaN/Inf guard at a stage "
    "boundary (PIPEEDGE_NAN_GUARD=1)")


class PoisonedActivationError(RuntimeError):
    """A stage-boundary activation contained NaN/Inf (the named error the
    guard raises instead of letting garbage propagate downstream)."""

    def __init__(self, where: str, mb: Optional[int] = None,
                 rid: Optional[str] = None):
        self.where = where
        self.mb = mb
        self.rid = rid
        at = f" (mb={mb}" + (f", rid={rid})" if rid else ")") \
            if mb is not None or rid else ""
        super().__init__(
            f"poisoned activations (NaN/Inf) at {where}{at}; postmortem "
            "bundle written — see pipeedge_poisoned_microbatches_total")


def nan_guard_enabled() -> bool:
    return os.getenv(ENV_NAN_GUARD, "0") == "1"


def check_finite(payload, where: str, mb: Optional[int] = None,
                 rid: Optional[str] = None):
    """Pass `payload` (tensor or tuple; torch tensors or numpy arrays) through the
    guard: returns it unchanged when finite or when the guard is off,
    raises `PoisonedActivationError` otherwise — after bumping the
    counter, noting the event on the flight ring, and writing a
    postmortem bundle (never cooldown-starved into silence: the raise
    itself still happens when the dump is suppressed)."""
    if not nan_guard_enabled():
        return payload
    import torch

    tensors = payload if isinstance(payload, tuple) else (payload,)
    for t in tensors:
        if getattr(t, "dtype", None) is None:
            continue
        t = torch.as_tensor(t)
        if not (t.is_floating_point() or t.is_complex()):
            continue    # integer/bool payloads (token ids) cannot poison
        if bool(torch.isfinite(t).all()):
            continue
        _POISONED.inc()
        flight.note("poisoned", rid=rid, where=where, mb=mb)
        flight.maybe_dump("poison", rid=rid,
                          context={"where": where, "mb": mb})
        logger.error("NaN guard: poisoned activations at %s (mb=%s)",
                     where, mb)
        raise PoisonedActivationError(where, mb=mb, rid=rid)
    return payload
