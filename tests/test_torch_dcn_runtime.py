"""`python -m pipeedge_tpu_torch.runtime -c dcn`: one process per rank.

The cases of tests/test_dcn_runtime.py against the port's entry, each
fleet under its own time limit (every process is killed at the end):
a quantized edge, the adaptive policy, a peer's death aborting the
fleet (dropped connection, and missed heartbeats), the 4-process fleet
with an idle rank, live re-scheduling over two rounds. Besides those: a
fleet at bit 0 equals the port's `-c host` run exactly, per-stage
checkpoints (`--stage-ckpt`) give the same results as the whole archive,
and the data rank merges every rank's spans (`--trace-spans`).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.utils import checkpoint as ckpt_utils

pytestmark = pytest.mark.fleet   # every test here spawns OS processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-vit"
PORT = [sys.executable, "-m", "pipeedge_tpu_torch.runtime"]


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _addrs(world):
    return ",".join(f"127.0.0.1:{p}" for p in _free_ports(world))


def _env(extra=None):
    return dict(os.environ, PYTHONPATH=REPO, **(extra or {}))


class _OutReader:
    """Drain a subprocess's output on a thread, so a test can poll it."""

    def __init__(self, proc):
        self.proc = proc
        self.lines = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def wait_for(self, needle, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if any(needle in line for line in self.lines):
                return True
            if self.proc.poll() is not None:
                self._thread.join(timeout=5)
                return any(needle in line for line in self.lines)
            time.sleep(0.05)
        return False

    def text(self):
        self._thread.join(timeout=5)
        return "".join(self.lines)


def _run_fleet(tmp_path, opts, world, env_extra=None, per_rank_dirs=False,
               timeout=90, cmds=None, rank_env=None):
    """Launch a `world`-rank fleet (workers in the background, the data
    rank in the foreground) and collect every rank's output. `cmds[r]`
    overrides rank r's command (a JAX rank in a mixed fleet), and
    `rank_env[r]` adds to rank r's environment (a fault armed in one
    rank). Returns (data CompletedProcess, [worker output by rank], rank
    dirs)."""
    argv = opts + ["--dcn-addrs", _addrs(world)]
    env = _env(env_extra)
    dirs = []
    for r in range(world):
        d = tmp_path / f"rank{r}" if per_rank_dirs else tmp_path
        d.mkdir(exist_ok=True)
        dirs.append(d)
    cmd = (cmds or {}).get
    # each worker's output goes to a file: a pipe nobody drains while the
    # data rank runs would stall a worker once its logging filled it
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    workers = []
    for r in range(1, world):
        with open(logs[r], "w") as log:
            workers.append(subprocess.Popen(
                (cmd(r) or PORT + ["--device", "cpu"]) + [str(r), str(world)]
                + argv, cwd=dirs[r],
                env=dict(env, **(rank_env or {}).get(r, {})), stdout=log,
                stderr=subprocess.STDOUT))
    try:
        data = subprocess.run(
            (cmd(0) or PORT + ["--device", "cpu"]) + ["0", str(world)] + argv,
            cwd=dirs[0], env=env, capture_output=True, text=True,
            timeout=timeout)
        for w in workers:
            w.wait(timeout=30)
    finally:
        for w in workers:
            w.kill()
            w.wait()
    wouts = [logs[r].read_text() for r in range(1, world)]
    for r, (w, wout) in enumerate(zip(workers, wouts), start=1):
        assert w.returncode == 0, f"rank {r}:\n{wout}"
    assert data.returncode == 0, data.stdout + data.stderr
    return data, wouts, dirs


def _launches(out, rank):
    line = [ln for ln in out.splitlines()
            if ln.startswith(f"rank={rank} kernel_launches=")]
    assert len(line) == 1, out
    return json.loads(line[0].split("=", 2)[2])


def test_two_process_dcn_runtime_quantized_edge(tmp_path):
    data, wouts, _ = _run_fleet(
        tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "16", "-u", "4",
                   "-pt", "1,4,5,8", "-q", "8,0", "-r", "0,1",
                   "--sched-timeout", "60"], world=2)
    assert "latency_sec=" in data.stdout
    assert "round=0 latency_sec=" in data.stdout
    assert f"======= {MODEL} stage 1: layers [5, 8] on cpu" in wouts[0]
    assert "empty CMD_SCHED; shutting down" in wouts[0]
    # the plain versions on the CPU: no kernel launched on either rank
    assert set(_launches(data.stdout, 0).values()) == {0}
    assert set(_launches(wouts[0], 1).values()) == {0}


def test_two_process_dcn_adaptive_quant(tmp_path):
    data, wouts, dirs = _run_fleet(
        tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "24", "-u", "4",
                   "-pt", "1,4,5,8", "-q", "8,0", "-r", "0,1",
                   "--sched-timeout", "60"], world=2,
        env_extra={"ADAPTIVE_QUANT": "HEURISTIC", "SEND_CONSTRAINT": "100",
                   "WINDOW_SIZE": "3"}, per_rank_dirs=True)
    assert "Adaptive quantization" in data.stdout + data.stderr
    assert (dirs[0] / "send.csv").exists()
    assert (dirs[1] / "recv.csv").exists()


def _launch(tmp_path, rank, world, opts):
    return subprocess.Popen(PORT + ["--device", "cpu", str(rank), str(world)]
                            + opts, cwd=tmp_path, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.mark.parametrize("heartbeat", [False, True],
                         ids=["dropped_connection", "missed_heartbeats"])
def test_peer_death_aborts_fleet(tmp_path, heartbeat):
    """Kill a middle stage mid-run: the whole fleet stops well before
    --sched-timeout, every survivor exiting non-zero and naming the dead
    rank. With heartbeats the victim is frozen (SIGSTOP, its sockets stay
    open), which only the missed beats can catch."""
    opts = ["-c", "dcn", "-m", MODEL, "-b", "20000", "-u", "4",
            "-pt", "1,2,3,5,6,8", "-q", "0,0,0", "-r", "0,1,2",
            "--dcn-addrs", _addrs(3), "--sched-timeout", "120"]
    if heartbeat:
        opts += ["--heartbeat-interval", "0.3", "--heartbeat-miss", "3"]
    victim, survivor = _launch(tmp_path, 1, 3, opts), \
        _launch(tmp_path, 2, 3, opts)
    victim_out, survivor_out = _OutReader(victim), _OutReader(survivor)
    data = _launch(tmp_path, 0, 3, opts)
    data_out = _OutReader(data)
    try:
        assert victim_out.wait_for("stage 1: layers", 60), victim_out.text()
        assert data_out.wait_for("send: Instant", 60), data_out.text()
        tik = time.monotonic()
        if heartbeat:
            victim.send_signal(signal.SIGSTOP)
        else:
            victim.kill()
        data.wait(timeout=60)
        survivor.wait(timeout=60)
        elapsed = time.monotonic() - tik
    finally:
        for proc in (victim, survivor, data):
            proc.kill()
            proc.wait()
    assert data.returncode not in (None, 0), data_out.text()
    assert "rank 1 died" in data_out.text(), data_out.text()
    assert survivor.returncode not in (None, 0), survivor_out.text()
    assert "rank 1 died" in survivor_out.text(), survivor_out.text()
    assert elapsed < 30, elapsed


def test_four_process_idle_rank_adaptive_quant(tmp_path):
    data, wouts, dirs = _run_fleet(
        tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "32", "-u", "4",
                   "-pt", "1,2,3,5,6,8", "-q", "8,4,0", "-r", "0,1,2",
                   "--sched-timeout", "60"], world=4,
        env_extra={"ADAPTIVE_QUANT": "HEURISTIC", "SEND_CONSTRAINT": "100",
                   "WINDOW_SIZE": "3"}, per_rank_dirs=True)
    assert "latency_sec=" in data.stdout
    assert "stage 1: layers [3, 5]" in wouts[0]
    assert "stage 2: layers [6, 8]" in wouts[1]
    assert "not in schedule; idling" in wouts[2]
    assert "Adaptive quantization" in data.stdout + data.stderr
    assert "Adaptive quantization" in wouts[0]
    assert (dirs[0] / "send.csv").exists()
    assert (dirs[1] / "send.csv").exists()
    assert (dirs[2] / "recv.csv").exists()


def test_live_reschedule_two_rounds(tmp_path):
    data, wouts, _ = _run_fleet(
        tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "16", "-u", "4",
                   "-pt", "1,4,5,8;1,2,3,8", "-q", "8,0;4,0", "-r", "0,1",
                   "--sched-timeout", "60"], world=2)
    assert data.stdout.count("\nlatency_sec=") + data.stdout.startswith(
        "latency_sec=") == 2, data.stdout
    assert "re-schedule: broadcasting round 1" in data.stdout + data.stderr
    assert "stage 1: layers [5, 8]" in wouts[0]
    assert "stage 1: layers [3, 8]" in wouts[0]
    assert "empty CMD_SCHED; shutting down" in wouts[0]
    assert wouts[0].count("rank=1 round=") == 2


def test_bit0_fleet_equals_host_run(tmp_path):
    """At bit 0 the fleet's results are the host driver's, bit for bit:
    the same stages on the same inputs, the frames carrying raw f32."""
    common = ["-m", MODEL, "-b", "16", "-u", "4", "-pt", "1,3,4,8",
              "-q", "0,0"]
    _run_fleet(tmp_path, ["-c", "dcn", "--save-results", "dcn.npz"] + common,
               world=2)
    host = subprocess.run(PORT + ["0", "2", "--device", "cpu",
                                  "--save-results", "host.npz"] + common,
                          cwd=tmp_path, env=_env(), capture_output=True,
                          text=True, timeout=60)
    assert host.returncode == 0, host.stderr
    with np.load(tmp_path / "dcn.npz") as d, \
            np.load(tmp_path / "host.npz") as h:
        assert len(d.files) == len(h.files) == 4
        for k in h.files:
            np.testing.assert_array_equal(d[k], h[k])


def test_stage_checkpoints_and_merged_spans(tmp_path):
    """Each rank restores only its own stage from `--stage-ckpt` and the
    results equal the whole archive's; a checkpoint cut for another
    partition is refused; `--trace-spans` at the data rank merges both
    ranks' spans."""
    cfg = registry.get_model_config(MODEL)
    npz = tmp_path / "w.npz"
    np.savez(npz, **tvit.random_npz_weights(cfg, seed=3))
    ckpt = tmp_path / "ckpt"
    dirs = ckpt_utils.save_stage_checkpoints(MODEL, str(npz), str(ckpt),
                                             [(1, 4), (5, 8)])
    with np.load(os.path.join(dirs[1], "params.npz")) as stage1:
        assert not any(k.startswith("embedding") for k in stage1.files)
    common = ["-c", "dcn", "-m", MODEL, "-b", "8", "-u", "4",
              "-pt", "1,4,5,8", "-q", "0,0"]
    spans = tmp_path / "spans.json"
    _run_fleet(tmp_path, common + ["-M", str(npz), "--save-results",
                                   "whole.npz", "--trace-spans", str(spans)],
               world=2)
    _run_fleet(tmp_path, common + ["--stage-ckpt", str(ckpt),
                                   "--save-results", "staged.npz"], world=2)
    with np.load(tmp_path / "whole.npz") as w, \
            np.load(tmp_path / "staged.npz") as s:
        for k in w.files:
            np.testing.assert_array_equal(s[k], w[k])
    events = json.loads(spans.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert {e.get("pid") for e in events if e.get("ph") == "X"} >= {0, 1}
    with pytest.raises(ValueError, match="does not match"):
        ckpt_utils.check_stage_compatible(str(ckpt), MODEL, 1, (4, 8))


def test_multi_round_shifting_fleet(tmp_path):
    """Three rounds on one 4-rank fleet where the partition, rank order,
    stage count and idle set all change: round 2 runs single-stage on a
    rank idle in round 1, round 3 swaps round 1's rank order (the data
    rank then hosts the last stage), adaptive quantization throughout."""
    data, wouts, _ = _run_fleet(
        tmp_path, ["-c", "dcn", "-m", MODEL, "-b", "24", "-u", "4",
                   "-pt", "1,4,5,8;1,8;1,4,5,8", "-q", "8,0;0;4,0",
                   "-r", "0,1;2;1,0", "--sched-timeout", "60"], world=4,
        env_extra={"ADAPTIVE_QUANT": "HEURISTIC", "SEND_CONSTRAINT": "100",
                   "WINDOW_SIZE": "3"}, per_rank_dirs=True)
    assert data.stdout.count("throughput_items_sec") == 6, data.stdout
    for wout in wouts:
        assert "Traceback" not in wout, wout
    assert "not in schedule; idling" in wouts[1]
    assert "stage 0: layers [1, 8]" in wouts[1]
    assert "stage 0: layers [1, 4]" in wouts[0]
    assert "stage 1: layers [5, 8]" in data.stdout + data.stderr
    assert wouts[2].count("not in schedule; idling") == 3
