"""The chaos harness's serving targets on the port's router fleet
(`python -m pipeedge_tpu_torch.chaos_dcn --target router-fleet|autoscale
--device cpu`, the tiny GPT-2), each held to the gates of
`tools/chaos_dcn.py`'s `run_router_fleet` and `run_autoscale`, at the
port harness's defaults (the commands its docstring gives).

- router-fleet: a replica of two is SIGKILLed mid shared-prefix burst;
  nothing is lost or errored, the router failed over at least once, the
  victim respawned with the next epoch and was readmitted healthy, no
  page leaked, no fleet process is left. The failover gate needs a
  request in flight on the victim when the kill lands. At the JAX
  tool's load (3 req/s, 4 new tokens) a tiny-GPT-2 request on this CPU
  ends in milliseconds: the JAX harness then kills an idle replica and
  fails its own gate with 0 failovers, as the port's would. So the
  port's burst is 20 req/s of 24 new tokens (`--qps`'s default and
  `BURST_NEW_TOKENS`), and its harness picks the victim from the
  replicas' own `/healthz` (`stats.active`) at the kill instead of the
  router's polled copy.
- autoscale (--expect scale): the 1-replica floor under the seeded
  `ramp:2:30:0.4` arrival (the JAX tool's `ramp:1:8:0.4`, and
  `ramp:2:16:0.4`, never queue such a replica here; at a plateau of 40 a
  loaded host's replica misses its health polls and the router answers
  "no routable replica"); the controller scales up once while the ramp
  still offers load and drains back to the floor after it, nothing lost,
  errored or leaked.
- autoscale --expect steady: a flat 1 req/s against the 1-replica floor;
  the controller ticks and decides nothing, the fleet stays at the
  floor, nothing is lost, errored or leaked.
"""
import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = [sys.executable, "-m", "pipeedge_tpu_torch.chaos_dcn",
           "--device", "cpu"]


def _harness(tmp_path, *args):
    proc = subprocess.run(HARNESS + list(args), capture_output=True,
                          text=True, timeout=240, cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    return proc.returncode, record, proc.stderr


def test_router_fleet_survives_a_replica_kill(tmp_path):
    rc, rec, err = _harness(tmp_path, "--target", "router-fleet",
                            "--expect", "router", "--duration", "6",
                            "--verbose")
    assert rc == 0, (rec, err[-4000:])
    assert rec["errors"] == rec["lost"] == rec["pages_leaked"] == 0
    assert rec["failovers"] >= 1 and rec["readmitted"]
    victim = rec["victim"]
    assert rec["replica_epochs"][victim] == 1
    assert set(rec["replica_states"].values()) == {"healthy"}
    assert rec["survivors"] == []


def test_autoscale_steady_decides_nothing(tmp_path):
    rc, rec, err = _harness(tmp_path, "--target", "autoscale",
                            "--expect", "steady", "--duration", "6")
    assert rc == 0, (rec, err[-4000:])
    assert rec["ticks"] > 0 and sum(rec["decisions"].values()) == 0
    assert rec["final_size"] == rec["floor"] == 1 and rec["spawns"] == 0
    assert rec["errors"] == rec["lost"] == rec["pages_leaked"] == 0
    assert rec["survivors"] == []


def test_autoscale_ramp_scales_up_and_back(tmp_path):
    rc, rec, err = _harness(tmp_path, "--target", "autoscale")
    assert rc == 0, (json.dumps(rec), err[-4000:])
    assert rec["expect"] == "scale" and rec["ramp"] == {
        "lo": 2.0, "hi": 30.0, "hold": 0.4}
    assert rec["spawns"] == 1 and rec["spawn_epochs"] == [0]
    assert rec["time_to_scale_up_s"] < 8.0 and rec["drained"]
    assert rec["decisions"]["applied"] >= 2
    assert rec["final_size"] == rec["floor"] == 1
    assert rec["errors"] == rec["lost"] == rec["pages_leaked"] == 0
    assert rec["survivors"] == []
