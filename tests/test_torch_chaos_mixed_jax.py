"""Failover in a mixed fleet, the other way: a JAX data rank with a port
victim and a port spare (see test_torch_chaos_mixed.py). The port's
stage strips and re-attaches the JAX data rank's microbatch ids, dies at
its 3rd result send, and the port spare replays the rest; every result
is held to the unfaulted all-JAX fleet with the mixed-fleet bound."""
import pytest

from test_torch_chaos_dcn import failed_over
from test_torch_chaos_mixed import assert_near_jax_fleet, failover_fleet
# the fixtures too (the unfaulted all-JAX fleet and the exact forward)
from test_torch_dcn_mixed import (  # noqa: F401
    JAX, PORT_CPU, exact, jax_fleet, weights)

pytestmark = pytest.mark.fleet


def test_jax_data_rank_fails_over_a_port_victim(weights, jax_fleet, exact,
                                                tmp_path):
    outs, got = failover_fleet(tmp_path, weights, [JAX, PORT_CPU, PORT_CPU])
    assert failed_over(outs[0]) and "moves rank 1 -> 2" in outs[0]
    assert "chaos: killing this process before send 3" in outs[1]
    assert "stage 1: layers [5, 8]" in outs[2]
    assert_near_jax_fleet(got, jax_fleet, exact)
