"""Gray failure on a port fleet: an 80 ms-per-send straggler (`slow@2:80`
on the last stage) never misses a beat, but the data rank's peer-health
plane (`--on-peer-degraded quarantine`: the span digests of every stage,
the heartbeat round trips, the send retries, folded into
`health/scorer.py`) confirms it and benches it at a round boundary
(`quarantine_rank=1`); the next round's re-plan moves its stage to a
spare with no replay (the round had drained), and every round delivers
its whole batch. The case of tests/test_gray_failures.py's straggler,
without its bounded chaos and readmission (the JAX case races, ROADMAP
§C)."""
import pytest

from test_torch_chaos_dcn import assert_equal_results, chaos

pytestmark = pytest.mark.fleet

ROUNDS = 4


def test_straggler_quarantined(tmp_path):
    case = chaos(tmp_path, "--world", "4", "--chaos", "slow@2:80",
                 "--rounds", str(ROUNDS), "--on-peer-degraded", "quarantine",
                 "--heartbeat-interval", "0.5", "--heartbeat-miss", "8",
                 "--expect", "quarantine")
    assert case.rc == 0, case.why()
    data = case.out[0]
    assert "quarantine_rank=1" in data, case.why()
    assert "moves rank 1 -> 2" in data
    # a planned bench, not a death: nothing replayed
    assert "unacknowledged microbatch" not in data
    assert "chaos: slow arming at send 2" in case.out[1]
    assert case.record["quarantine_s"] > 0
    assert case.record["survivors"] == []
    # every round delivered its whole batch, each equal to the first
    rounds = [ln for ln in data.splitlines() if " round=" in ln
              and "latency_sec=" in ln]
    assert len(rounds) == ROUNDS, case.why()
    got = case.results()
    assert len(got) == ROUNDS * 6
    for k in range(1, ROUNDS):
        assert_equal_results(got[6 * k:6 * (k + 1)], got[:6])
