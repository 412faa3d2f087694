"""Chaos acceptance for the port's DCN fault plane: loopback fleets of
`python -m pipeedge_tpu_torch.runtime -c dcn --device cpu` on the tiny
ViT, one fault armed in one rank (`DCN_CHAOS`), run through the port's
harness (`python -m pipeedge_tpu_torch.chaos_dcn`), as
tests/test_chaos_dcn.py runs the JAX package's.

Here: a killed last stage fails over to the spare, every microbatch
delivered once and bit-identical to an unfaulted fleet's; with no spare
the fleet aborts naming the dead rank. The restart/heal case is in
test_torch_chaos_heal.py, the gray straggler in test_torch_chaos_gray.py,
the mixed JAX/port fleets in test_torch_chaos_mixed.py; the JAX file's
`slow` matrix is ported `slow` below.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = [sys.executable, "-m", "pipeedge_tpu_torch.chaos_dcn",
           "--device", "cpu"]

pytestmark = pytest.mark.fleet   # every test spawns OS-process fleets


class Case:
    """One harness run: its JSON record, exit code, and each rank's
    output lines and saved results."""

    def __init__(self, proc, workdir):
        self.rc = proc.returncode
        self.stdout, self.stderr = proc.stdout, proc.stderr
        self.record = json.loads(proc.stdout.strip().splitlines()[-1])
        self.workdir = workdir
        self.out = {}
        for d in sorted(workdir.glob("rank*")):
            log = d / "out.log"
            self.out[int(d.name[4:])] = (log.read_text() if log.exists()
                                         else "")

    def results(self):
        with np.load(self.workdir / "results.npz") as f:
            return [f[f"arr_{i}"] for i in range(len(f.files))]

    def why(self):
        """The record, and each rank's lines but the monitoring ones."""
        logs = {r: "\n".join(ln for ln in o.splitlines()
                             if "monitoring" not in ln)
                for r, o in self.out.items()}
        return (json.dumps(self.record) + "\n" + self.stderr[-3000:] + "\n"
                + "\n".join(f"--- rank {r}\n{o[-12000:]}"
                            for r, o in logs.items()))


def chaos(tmp_path, *args, timeout=240, env=None):
    """Run the harness with `args` (each rank in tmp_path/rank<r>, the
    data rank saving every delivered result; every rank computes on one
    thread, so the fleet's ranks do not oversubscribe the host's cores)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        HARNESS + ["--workdir", str(tmp_path), "--save-results",
                   str(tmp_path / "results.npz"), *args],
        capture_output=True, text=True, timeout=timeout, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 **(env or {})))
    return Case(proc, tmp_path)


# the data rank fails over on its own detection of the death, or on a
# survivor's CMD_DEAD that reached it first: either line shows the route
FAILOVER_LINES = ("entering failover", "announced dead (failover)")


def failed_over(log):
    """Whether a data rank's log shows it entered failover, by either
    route."""
    return any(line in log for line in FAILOVER_LINES)


def assert_equal_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_kill_stage_fails_over_bit_identical(tmp_path):
    """Kill the last stage at its 3rd result send: the spare takes stage 1
    over, the unacknowledged microbatches replay, and every result is
    delivered once, in order, equal bit for bit to an unfaulted fleet's
    (spare substitution keeps the partition)."""
    fault = chaos(tmp_path / "fault", "--world", "3", "--chaos", "kill@3")
    assert fault.rc == 0, fault.why()
    data = fault.out[0]
    assert failed_over(data) and "moves rank 1 -> 2" in data
    assert "replaying" in data and "unacknowledged" in data
    assert "chaos: killing this process before send 3" in fault.out[1]
    assert "stage 1: layers [5, 8]" in fault.out[2]
    rec = fault.record
    assert rec["completed"] and rec["replayed"] >= 1
    assert rec["detect_s"] > 0 and rec["recover_s"] > 0
    assert rec["survivors"] == []
    clean = chaos(tmp_path / "clean", "--world", "3", "--chaos", "")
    assert clean.rc == 0, clean.why()
    assert not failed_over(clean.out[0])
    assert len(clean.results()) == 6
    assert_equal_results(fault.results(), clean.results())


def test_no_spare_capacity_aborts_naming_rank(tmp_path):
    """Failover with nothing to fail over to: the fleet aborts, naming the
    dead rank (the pre-failover semantics)."""
    case = chaos(tmp_path, "--world", "2", "--chaos", "kill@2", "-b", "16",
                 "--expect", "abort")
    assert case.rc == 0, case.why()
    assert case.record["aborted"] and case.record["data_rc"] not in (0, None)
    data = case.out[0]
    assert "no spare capacity" in data and "rank 1 died" in data
    assert case.record["survivors"] == []


def test_harness_refuses_the_unported_targets(capsys):
    """serve-disagg stays refused; the serving fleet's targets parse, on
    the tiny GPT-2 and with their own --expect defaults, and refuse
    another target's --expect (tests/test_torch_chaos_serving.py runs
    them)."""
    from pipeedge_tpu_torch import chaos_dcn
    with pytest.raises(SystemExit) as exc:
        chaos_dcn.parse_args(["--target", "serve-disagg"])
    assert exc.value.code == 2
    assert "--target serve-disagg is not ported to pipeedge_tpu_torch " \
           "yet (ROADMAP A5.3b" in capsys.readouterr().err
    for target, expect in (("router-fleet", "router"),
                           ("autoscale", "scale")):
        args = chaos_dcn.parse_args(["--target", target])
        assert (args.model_name, args.expect) == ("pipeedge/test-tiny-gpt2",
                                                  expect)
    for target, wrong in (("router-fleet", "scale"), ("autoscale", "heal"),
                          ("runtime", "steady")):
        with pytest.raises(SystemExit):
            chaos_dcn.parse_args(["--target", target, "--expect", wrong])
        assert f"--target {target} takes --expect" \
            in capsys.readouterr().err
    with pytest.raises(SystemExit):
        chaos_dcn.parse_args(["--victim", "0"])
    assert "--victim 0 is the data rank" in capsys.readouterr().err


# -- the JAX file's slow matrix ------------------------------------------

@pytest.mark.slow
def test_restart_spare_mode_keeps_substitution(tmp_path):
    """--on-peer-rejoin spare: the restarted rank is re-admitted as idle
    capacity but its old stage stays on the substitute — no heal line,
    results exactly once."""
    case = chaos(tmp_path, "--world", "4", "--chaos", "restart@3:1500",
                 "--rounds", "6", "-b", "64", "--on-peer-rejoin", "spare")
    assert case.rc == 0, case.why()
    data = case.out[0]
    assert "rejoin_rank=1" in data and "heal_round=" not in data
    assert "moves rank 1 -> 2" in data
    assert len(case.results()) == 6 * 16


@pytest.mark.slow
def test_flap_survived_with_grace(tmp_path):
    """flap@K:MS inside every rank's reconnect grace: a blip, not a
    death — no failover, no rejoin, results exactly once."""
    case = chaos(tmp_path, "--world", "3", "--chaos", "flap@2:400",
                 "-b", "16", "--reconnect-grace", "5",
                 env={"DCN_SEND_RETRIES": "3"})
    assert case.rc == 0, case.why()
    assert not failed_over(case.out[0])
    assert "rejoin_rank=" not in case.out[0]
    assert len(case.results()) == 4


@pytest.mark.slow
def test_hang_detected_by_heartbeat(tmp_path):
    """SIGSTOP a stage rank: its sockets stay open, so only the liveness
    plane can see it — then failover proceeds as for a closed socket."""
    case = chaos(tmp_path, "--world", "3", "--chaos", "hang@3",
                 "--heartbeat-interval", "0.5", "--heartbeat-miss", "8")
    assert case.rc == 0, case.why()
    assert "moves rank 1 -> 2" in case.out[0]
    fleet = "".join(case.out.values())
    assert "missed" in fleet and "heartbeats" in fleet


@pytest.mark.slow
def test_delay_is_survived_without_failover(tmp_path):
    case = chaos(tmp_path, "--world", "3", "--chaos", "delay@1:150",
                 "-b", "16")
    assert case.rc == 0, case.why()
    assert "latency_sec=" in case.out[0]
    assert not failed_over(case.out[0])


@pytest.mark.slow
def test_corrupt_frame_recovered_with_crc(tmp_path):
    """corrupt@K flips a bit below the checksum: with PIPEEDGE_WIRE_CRC on
    every rank the consumer asks for the clean resend, and the results
    equal an unfaulted fleet's."""
    crc = {"PIPEEDGE_WIRE_CRC": "1"}
    fault = chaos(tmp_path / "fault", "--world", "3", "--chaos",
                  "corrupt@2", "-q", "8,0", env=crc)
    clean = chaos(tmp_path / "clean", "--world", "3", "--chaos", "",
                  "-q", "8,0", env=crc)
    for case in (fault, clean):
        assert case.rc == 0, case.why()
    assert "corrupting send 2" in fault.out[1]
    assert_equal_results(fault.results(), clean.results())
