"""Deterministic fault injection for the DCN transport (chaos harness).

Port of `pipeedge_tpu/comm/chaos.py`: the same grammar, counting and
actions, so one `DCN_CHAOS` spec means the same fault in a port rank and
in a JAX rank. The fault-tolerance layer (liveness plane, mid-run
failover, replay) is only trustworthy if its failure modes can be
reproduced on demand. This module injects faults at exact, countable
points in a rank's send stream, so a chaos run is bit-for-bit repeatable:
"kill rank 1 at microbatch 3" means the same thing on every run.

Faults are configured per PROCESS through the `DCN_CHAOS` env var — the
launcher (tests, `python -m pipeedge_tpu_torch.chaos_dcn`) targets a rank
by setting the variable only in that rank's environment. Grammar
(`;`-separated actions):

    kill@K          exit the process (os._exit, status 137) immediately
                    before its K-th tensor-frame send (1-based)
    hang@K          SIGSTOP the whole process before its K-th send —
                    sockets stay open, heartbeats stop: the hung-rank
                    case only the liveness plane can catch
    drop@K          silently swallow the K-th tensor-frame send
    delay@K:MS      sleep MS milliseconds before every tensor-frame send
                    from the K-th on (slow-link / straggler simulation)
    restart@K:MS    kill@K, then RE-EXEC the same command line MS
                    milliseconds later with DCN_EPOCH incremented and the
                    chaos spec cleared — the transient-crash-and-recover
                    case the elastic membership plane (JOIN handshake,
                    `--on-peer-rejoin`) re-admits
    flap@K:MS       drop every open connection (data, command, accepted)
                    before the K-th send and stay silent for MS ms, then
                    resume — a network blip. Survivable without failover
                    when every rank's DCN_RECONNECT_GRACE exceeds MS;
                    with grace 0 the fleet treats it as a death (and,
                    because the flapped rank keeps its epoch, its
                    post-fence frames are dropped as stale)
    slow@K:MS       persistent gray degradation: MS ms added to every
                    send from the K-th on, FOREVER — the throttled-TPU /
                    degrading-NIC straggler the peer-health plane
                    (`--on-peer-degraded`) must detect.
                    `slow@K-J:MS` bounds it to sends K..J inclusive (the
                    "chaos clears" case probation readmission needs)
    jitter@K:MS     like slow, but the per-send delay is uniform random
                    in [0, MS] — deterministic per process via
                    DCN_CHAOS_SEED (default 0). `jitter@K-J:MS` bounds it
    corrupt@K       flip one bit in the K-th send's largest payload
                    tensor AFTER any frame checksum was computed
                    (comm/dcn.py applies it below the integrity layer),
                    so PIPEEDGE_WIRE_CRC verification sees genuine wire
                    corruption; without CRC the garbage propagates —
                    what the NaN guard exists to catch

Counting is over `send_tensors` calls on the wrapped context (command and
heartbeat frames are not counted — they are the recovery machinery under
test). For a pipeline stage, one send == one microbatch, so `@K` indexes
microbatches directly.
"""
from __future__ import annotations

import logging
import os
import signal
import socket as socket_mod
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.threads import make_lock

ENV_CHAOS = "DCN_CHAOS"
ENV_CHAOS_SEED = "DCN_CHAOS_SEED"   # jitter determinism (default 0)

logger = logging.getLogger(__name__)


@dataclass
class ChaosAction:
    kind: str            # kill | hang | drop | delay | restart | flap |
    # slow | jitter | corrupt
    at_send: int         # 1-based send index the action arms at
    delay_ms: float = 0.0
    until_send: Optional[int] = None   # slow/jitter: last affected send
    # (inclusive); None = the degradation persists forever
    fired: bool = False  # slow/jitter: arming logged (harnesses stamp
    # the fault instant off that one log line, like kill/hang/drop do)


@dataclass
class ChaosSpec:
    actions: List[ChaosAction] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        actions = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                kind, _, where = part.partition("@")
                kind = kind.strip().lower()
                if kind in ("delay", "restart", "flap"):
                    at, _, ms = where.partition(":")
                    actions.append(ChaosAction(kind, int(at),
                                               delay_ms=float(ms or 0)))
                elif kind in ("slow", "jitter"):
                    at, _, ms = where.partition(":")
                    at, _, until = at.partition("-")
                    actions.append(ChaosAction(
                        kind, int(at), delay_ms=float(ms or 0),
                        until_send=int(until) if until else None))
                elif kind in ("kill", "hang", "drop", "corrupt"):
                    actions.append(ChaosAction(kind, int(where)))
                else:
                    raise ValueError(f"unknown chaos action {kind!r}")
            except ValueError as exc:
                raise ValueError(
                    f"bad {ENV_CHAOS} clause {part!r}: {exc} (grammar: "
                    "kill@K | hang@K | drop@K | delay@K:MS | "
                    "restart@K:MS | flap@K:MS | slow@K[-J]:MS | "
                    "jitter@K[-J]:MS | corrupt@K)") from None
        return cls(actions)


class _ChaosSender:
    """Wraps a context's `send_tensors`, applying the spec's actions at
    their exact send indices. Thread-safe: a stage's send thread and the
    data rank's feed thread may share one context."""

    def __init__(self, ctx, spec: ChaosSpec):
        self._ctx = ctx
        self._inner = ctx.send_tensors
        self._spec = spec
        self._lock = make_lock("chaos.sender")
        self._count = 0
        # jitter determinism: one seeded stream per process (the spec is
        # per-process, so replaying the same seed replays the delays)
        import random
        self._rng = random.Random(int(os.getenv(ENV_CHAOS_SEED, "0")))

    def __call__(self, dst, tensors, channel=0, trace=None):
        with self._lock:
            self._count += 1
            n = self._count
        for act in self._spec.actions:
            if act.kind == "delay" and n >= act.at_send:
                time.sleep(act.delay_ms / 1e3)
            elif act.kind in ("slow", "jitter") and n >= act.at_send \
                    and (act.until_send is None or n <= act.until_send):
                if not act.fired:
                    # one arming line at the FAULT instant (the
                    # per-send sleeps are silent): what chaos_dcn.py
                    # stamps fault-to-quarantine latency against
                    act.fired = True
                    logger.error("chaos: %s arming at send %d "
                                 "(%.0f ms/send%s)", act.kind, n,
                                 act.delay_ms,
                                 "" if act.until_send is None
                                 else f" through send {act.until_send}")
                ms = (act.delay_ms if act.kind == "slow"
                      else self._rng.uniform(0.0, act.delay_ms))
                time.sleep(ms / 1e3)
            elif n == act.at_send:
                if act.kind == "corrupt":
                    # one-shot flag the transport consumes BELOW its
                    # integrity layer (dcn._send_tensors_once): the bit
                    # flips after any checksum was computed and after the
                    # resend cache captured the clean frame — genuine
                    # wire corruption, recoverable by a resend
                    logger.error("chaos: corrupting send %d (one bit "
                                 "flip)", n)
                    self._ctx._corrupt_next_send = True
                if act.kind == "kill":
                    logger.error("chaos: killing this process before "
                                 "send %d", n)
                    os._exit(137)
                if act.kind == "restart":
                    _restart(n, act.delay_ms)
                if act.kind == "hang":
                    logger.error("chaos: SIGSTOPping this process before "
                                 "send %d", n)
                    os.kill(os.getpid(), signal.SIGSTOP)
                if act.kind == "drop":
                    logger.warning("chaos: dropping send %d", n)
                    return
                if act.kind == "flap":
                    _flap(self._ctx, n, act.delay_ms)
        return self._inner(dst, tensors, channel=channel, trace=trace)


def _restart(n: int, delay_ms: float) -> None:
    """kill@K followed by a delayed re-exec of the SAME command line: the
    replacement process starts `delay_ms` later with DCN_EPOCH incremented
    (a genuinely new incarnation the JOIN handshake can admit) and the
    chaos spec cleared (the restarted rank must not crash again). The
    relauncher is a detached child so it survives this process's exit;
    stdout/stderr are inherited, so a harness reading this rank's pipe
    also sees the new incarnation's lines.

    The command line is the interpreter's own (`sys.orig_argv`), so a
    rank started as `python -m pipeedge_tpu_torch.runtime ...` comes back
    the same way: `sys.argv[0]` would name the file `runtime.py`, whose
    package-relative imports fail when it runs as a script."""
    import subprocess
    import sys

    from . import dcn

    epoch = int(os.getenv(dcn.ENV_EPOCH, "0")) + 1
    env = dict(os.environ)
    env.pop(ENV_CHAOS, None)
    env[dcn.ENV_EPOCH] = str(epoch)
    argv = [sys.executable] + list(sys.orig_argv[1:])
    logger.error("chaos: killing this process before send %d; re-exec "
                 "as epoch %d in %.0f ms", n, epoch, delay_ms)
    subprocess.Popen(
        [sys.executable, "-c",
         "import subprocess, sys, time; time.sleep(float(sys.argv[1])); "
         "sys.exit(subprocess.call(sys.argv[2:]))",
         str(delay_ms / 1e3)] + argv,
        env=env, start_new_session=True)
    os._exit(137)


def _flap(ctx, n: int, delay_ms: float) -> None:
    """Drop every open connection on `ctx` (peers see the break; this
    rank's readers see their sockets die), stay silent for `delay_ms`,
    then return — the pending send redials. The listener stays bound, so
    peers inside a reconnect-grace window revive the rank on redial."""
    logger.error("chaos: flapping before send %d (all connections "
                 "dropped for %.0f ms)", n, delay_ms)
    with ctx._conns_lock:
        conns = (list(ctx._conns.values()) + list(ctx._cmd_conns.values())
                 + list(ctx._accepted))
        ctx._conns.clear()
        ctx._cmd_conns.clear()
        ctx._accepted.clear()
    for c in conns:
        try:
            c.shutdown(socket_mod.SHUT_RDWR)
        except OSError:
            pass
        try:
            c.close()
        except OSError:
            pass
    time.sleep(delay_ms / 1e3)
    logger.warning("chaos: flap over; connections will redial")


def maybe_install(ctx) -> Optional[ChaosSpec]:
    """Install the `DCN_CHAOS` spec (if any) onto `ctx` by wrapping its
    `send_tensors`. Returns the parsed spec, or None when the env var is
    unset. Call once, after the context is constructed."""
    raw = os.getenv(ENV_CHAOS)
    if not raw:
        return None
    spec = ChaosSpec.parse(raw)
    ctx.send_tensors = _ChaosSender(ctx, spec)
    logger.warning("chaos: installed %s", raw)
    return spec
