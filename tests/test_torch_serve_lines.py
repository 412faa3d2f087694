"""A router's output lines each leave in one write.

A router's threads print at once: the supervisor's pump tees a retired
replica's last line (`[replica r1] kernel_launches={...}`) just as
`retire_rank`, on the autoscaler's thread, reports the exit. `print`
writes a line's text and its newline apart, so the teed line could land
between them and no longer start a line, and a reader keyed on its
prefix would miss it. Every line of `serve.py`'s supervisor goes through
`utils.emit_line`, one write per line, which these tests hold.
"""
import io
import sys

import pytest

from pipeedge_tpu_torch import serve
from pipeedge_tpu_torch.utils import emit_line

pytestmark = pytest.mark.fleet

# a worker that prints its ready line, then its last line on SIGTERM
WORKER = ("import signal, sys, time\n"
          "def bye(*_):\n"
          "    sys.stdout.write('kernel_launches={\"decode_attention\": 3}\\n')\n"
          "    sys.stdout.flush()\n"
          "    sys.exit(0)\n"
          "signal.signal(signal.SIGTERM, bye)\n"
          "print('ready', flush=True)\n"
          "time.sleep(60)\n")


class _Writes(io.TextIOBase):
    """A stdout that keeps each write apart."""

    def __init__(self):
        self.writes = []

    def write(self, s):
        self.writes.append(s)
        return len(s)

    def flush(self):
        pass


class _Sup(serve.WorkerSupervisor):
    LABEL = "test worker"
    TAG = "test"

    def _argv(self, rank):
        return [sys.executable, "-c", WORKER]

    def _is_ready(self, rank, line):
        return line.startswith("ready")


def _lines_of(writes):
    return [w for w in writes if w]


def test_emit_line_writes_one_line_per_call(monkeypatch):
    out = _Writes()
    monkeypatch.setattr(sys, "stdout", out)
    emit_line("autoscale_drain replica=r1 rank=1 migrated=0")
    emit_line("[replica r1] kernel_launches={}\n")
    assert out.writes == ["autoscale_drain replica=r1 rank=1 migrated=0\n",
                          "[replica r1] kernel_launches={}\n"]


def test_retired_worker_last_line_is_whole(monkeypatch):
    out = _Writes()
    monkeypatch.setattr(sys, "stdout", out)
    sup = _Sup([0], respawn=False)
    try:
        sup.wait_ready(timeout=60)
        rank = sup.add_rank()
        assert rank == 1
        sup.wait_ready(timeout=60)
        assert sup.retire_rank(1)
    finally:
        sup.stop()
    writes = _lines_of(out.writes)
    # every write is one whole line
    assert all(w.endswith("\n") and w.count("\n") == 1 for w in writes), \
        writes
    assert "[test r1] kernel_launches={\"decode_attention\": 3}\n" in writes
    assert "test worker rank 1 retired (epoch=0)\n" in writes
    assert "[test r0] kernel_launches={\"decode_attention\": 3}\n" in writes
