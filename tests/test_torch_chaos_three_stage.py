"""A death in a cut of three stages (the port's fault plane): 4 ranks,
the tiny ViT cut `-pt 1,2,3,5,6,8 -r 0,1,2`, rank 3 the spare, 3 rounds.

Killing the last stage (rank 2) mid-round leaves the middle stage (rank
1) alive with the cut-off round's frames: on the link from the data
rank's stage 0 and on its own send queue. Frames left there would park a
surviving worker's reader in a later round, as they parked the data
rank's before `DistDcnContext.drop_queued`. The guard: the kill in round
0 and in round 1 each fail over to the spare, replay what was not
acknowledged, and every result is delivered once, in order, equal bit
for bit to an unfaulted fleet's of the same cut (spare substitution
keeps the partition).
"""
import pytest

from test_torch_chaos_dcn import assert_equal_results, chaos, failed_over

pytestmark = pytest.mark.fleet

CUT = ["--world", "4", "-pt", "1,2,3,5,6,8", "-r", "0,1,2", "--victim",
       "2", "--rounds", "3"]


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    case = chaos(tmp_path_factory.mktemp("clean"), *CUT, "--chaos", "")
    assert case.rc == 0, case.why()
    assert not failed_over(case.out[0])
    assert len(case.results()) == 18
    return case.results()


@pytest.mark.parametrize("send", [3, 8], ids=["round0", "round1"])
def test_last_of_three_stages_fails_over_bit_identical(send, clean,
                                                       tmp_path):
    case = chaos(tmp_path, *CUT, "--chaos", f"kill@{send}")
    assert case.rc == 0, case.why()
    data = case.out[0]
    assert failed_over(data) and "moves rank 2 -> 3" in data, case.why()
    assert "unacknowledged microbatch" in data
    assert f"chaos: killing this process before send {send}" in case.out[2]
    assert "stage 2: layers [6, 8]" in case.out[3]
    rec = case.record
    assert rec["completed"] and rec["replayed"] >= 1
    assert rec["survivors"] == []
    assert_equal_results(case.results(), clean)
