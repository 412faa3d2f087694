"""Overload protection for the serving plane.

Port of `pipeedge_tpu/serving/__init__.py`:

- `admission`: per-class token-bucket rate limits, a bounded
  earliest-deadline-first admission queue, load shedding with a
  Retry-After computed from the observed service rate, deadline
  bookkeeping, and a KV TOKEN budget charged with each request's page
  reservation under `--kv-pages` (`AdmissionController`).
- `brownout`: a watermark-driven degradation ladder that steps through
  disable-speculative -> clamp new_tokens -> evict cold KV pages ->
  shed best-effort -> shed batch, and steps back down with hysteresis
  (`BrownoutLadder`).
- `autoscale`: the closed capacity loop over the routed fleet
  (`--autoscale {off,advise,auto}`): a governor-ticked
  `CapacityController` with confirm/dwell hysteresis, a flap damper,
  scale-down ordered behind brownout, and dry-run `held` transitions.

Deadline propagation itself lives in the executors
(`parallel/batcher.py`). The replica router is `serving/router.py`
(imported as such).
"""
from .admission import (AdmissionController, AdmissionShed, ClassPolicy,
                        DeadlineExceeded, EDFQueue, REQUEST_CLASSES,
                        ServiceRateEstimator, TokenBucket, default_policies,
                        parse_class_map)
from .autoscale import (AutoscaleRunner, CapacityController,  # noqa: F401
                        CapacityPolicy)
from .brownout import BrownoutLadder, LEVEL_NAMES, Watermarks

__all__ = [
    "AdmissionController", "AdmissionShed", "AutoscaleRunner",
    "BrownoutLadder", "CapacityController", "CapacityPolicy",
    "ClassPolicy", "DeadlineExceeded", "EDFQueue", "LEVEL_NAMES",
    "REQUEST_CLASSES", "ServiceRateEstimator", "TokenBucket", "Watermarks",
    "default_policies", "parse_class_map",
]
