"""Restart -> failover -> rejoin -> heal on a port fleet (the case of
tests/test_chaos_dcn.py::test_chaos_restart_rejoins_and_heals).

The last stage dies at its 3rd send and re-execs 1.5 s later as epoch 1
(`restart@3:1500`). The fleet fails over to a spare and replays; the new
incarnation passes the JOIN handshake (one `rejoin_rank=1 epoch=1` line
at the data rank); with `--on-peer-rejoin heal` the pre-failure
placement comes back at the next round boundary (`heal_round=...
ranks=0,1`), and every round delivers its microbatches exactly once.

A heal can only land at a boundary that follows the JOIN, and the new
incarnation needs the restart delay plus an interpreter's start (torch
included, ~6 s on an idle 8-core host) to send it. The JAX case's fleet
(3 rounds of 16 items) ends before that, so its rejoin came after the
last boundary, or after the run (its restarted rank then waited for a
schedule that never came). Here the spare that carries stage 1 until the
heal is slower than the rank it replaces, as an edge fleet's spare often
is: 250 ms per send (`--arm 2=delay@1:250`), so each round it carries
lasts at least 16 x 0.25 s and the JOIN lands mid-run, however loaded
the host. Once healed, the rounds run at rank 1's speed again.
"""
import pytest

from test_torch_chaos_dcn import assert_equal_results, chaos

pytestmark = pytest.mark.fleet

ROUNDS, BATCH, UBATCH = 6, 64, 4
ARGS = ["--world", "4", "--chaos", "restart@3:1500", "--arm",
        "2=delay@1:250", "--rounds", str(ROUNDS), "-b", str(BATCH), "-u",
        str(UBATCH), "--on-peer-rejoin", "heal", "--expect", "heal"]


def test_restart_rejoins_and_heals(tmp_path):
    case = chaos(tmp_path, *ARGS)
    assert case.rc == 0, case.why()
    data, victim = case.out[0], case.out[1]
    # the failover leg ran (the spare took the stage over)
    assert "moves rank 1 -> 2" in data, case.why()
    # the restarted incarnation was admitted exactly once...
    assert data.count("rejoin_rank=1") == 1, case.why()
    assert "rejoin_rank=1 epoch=1 was_dead=1" in data
    # ...and the heal restored the pre-failure placement
    heal = [ln for ln in data.splitlines() if "heal_round=" in ln]
    assert len(heal) == 1 and "ranks=0,1" in heal[0], case.why()
    assert "time_to_full_capacity_s=" in heal[0]
    # the victim really died and came back as epoch 1
    assert "chaos: killing this process" in victim
    assert "re-exec as epoch 1" in victim and "JOIN announced" in victim
    rec = case.record
    assert rec["rejoin_s"] > 0 and rec["heal_s"] is not None
    assert rec["time_to_full_capacity_s"] > 0 and rec["replayed"] >= 1
    assert rec["survivors"] == []
    # every round's microbatches exactly once, in order: each round equals
    # the first (the same batch on the same cut)
    got = case.results()
    per_round = BATCH // UBATCH
    assert len(got) == ROUNDS * per_round
    for k in range(1, ROUNDS):
        assert_equal_results(got[k * per_round:(k + 1) * per_round],
                             got[:per_round])


@pytest.mark.slow
def test_restart_heal_bit_identical(tmp_path):
    """The healed run's outputs equal a fault-free run's bit for bit."""
    fault = chaos(tmp_path / "fault", *ARGS)
    clean = chaos(tmp_path / "clean", *ARGS[:2], "--chaos", "",
                  *ARGS[6:-2])
    assert fault.rc == 0, fault.why()
    assert clean.rc == 0, clean.why()
    assert_equal_results(fault.results(), clean.results())
