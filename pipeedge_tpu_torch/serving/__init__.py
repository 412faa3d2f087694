"""Overload protection for the serving plane.

Port of `pipeedge_tpu/serving/__init__.py`, limited to the two modules
the single-replica server needs:

- `admission`: per-class token-bucket rate limits, a bounded
  earliest-deadline-first admission queue, load shedding with a
  Retry-After computed from the observed service rate, deadline
  bookkeeping, and a KV TOKEN budget (pure arithmetic; the server passes
  it no pages until the paged KV plane is ported, ROADMAP A5.3a)
  (`AdmissionController`).
- `brownout`: a watermark-driven degradation ladder that steps through
  disable-speculative -> clamp new_tokens -> evict cold KV pages ->
  shed best-effort -> shed batch, and steps back down with hysteresis
  (`BrownoutLadder`).

Deadline propagation itself lives in the executors
(`parallel/batcher.py`). The replica router is `serving/router.py`
(imported as such); the autoscaler waits for ROADMAP A5.2c.
"""
from .admission import (AdmissionController, AdmissionShed, ClassPolicy,
                        DeadlineExceeded, EDFQueue, REQUEST_CLASSES,
                        ServiceRateEstimator, TokenBucket, default_policies,
                        parse_class_map)
from .brownout import BrownoutLadder, LEVEL_NAMES, Watermarks

__all__ = [
    "AdmissionController", "AdmissionShed", "BrownoutLadder",
    "ClassPolicy", "DeadlineExceeded", "EDFQueue", "LEVEL_NAMES",
    "REQUEST_CLASSES", "ServiceRateEstimator", "TokenBucket", "Watermarks",
    "default_policies", "parse_class_map",
]
