"""Runtime tracing: a `torch.profiler` session and named host regions.

Port of `pipeedge_tpu/utils/tracing.py`:

- `trace(out_dir)`: context manager capturing one `torch.profiler`
  session (CPU activity, and CUDA activity where the host has a card),
  exported on exit as a Chrome trace, `out_dir/trace.json` (Perfetto or
  chrome://tracing open it). The device events name each kernel, so the
  hand-written ones show under their own names.
- `annotate(name)`: a named host region on that timeline
  (`torch.profiler.record_function`), used by the pipeline driver to
  label each stage's dispatch. With no session open it is a null
  context, so an untraced run makes no profiler call per dispatch.

As in the JAX module, a profiler that cannot start (another session is
open, a bad path) is warned about and the run carries on without a
trace, leaving an open session as it was; the caller that needs the
trace checks that the file exists.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(out_dir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace into `out_dir/trace.json` (no-op when
    `out_dir` is None or empty)."""
    if not out_dir:
        yield
        return
    if torch.autograd._profiler_enabled():
        # another session is open: starting this one would end it
        logger.warning("trace capture unavailable (a profiler session is "
                       "already open); continuing without")
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof.__enter__()
    except (OSError, RuntimeError) as exc:  # bad path / profiler busy
        logger.warning("trace capture unavailable (%s); continuing without",
                       exc)
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            path = os.path.join(out_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
            logger.info("trace written to %s (open in Perfetto)", path)
        except (OSError, RuntimeError) as exc:
            logger.warning("trace stop failed: %s", exc)


def annotate(name: str):
    """Named region on the profiler timeline (host side; the device work
    it launches is linked to it in the trace); a null context when no
    profiler session is open."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
